"""The four forward kernels as ``torch.library`` operators: ``torch.ops.blle``.

* ``gram_pass(x, wqk, bqk, dwqk, bdwqk) -> [B, C*C + 2C]`` fp32 (K2 with its
  reduction: each image's gram, then its sums of q^2 and of k^2);
* ``apply_pass(x, apply, wv, bv, dwv, bdwv, bproj, wp1, bp1, dwf, bdwf, wp2,
  bp2) -> [B,H,W,C]`` in x's dtype (K3);
* ``apply_pass_pipelined(...)``, the same arguments and result (K3P);
* ``selective_scan_fwd(u, dt, A, B, C, D) -> [B,L,D]`` in u's dtype (S1
  without saved states).

The weights are ``BlockWeights``' fields (``fused_block.GRAM_FIELDS``,
``APPLY_FIELDS``): the wrappers in ``kernels/fused_block.py`` and
``kernels/ssm_scan.py`` unpack them and call these operators, so a graph
traced by ``torch.export`` holds the hand kernels as ``blle`` nodes instead of
dropping them. Each operator has

* a CUDA implementation: the kernel function of its module (which checks
  its inputs, launches, counts the launch on the wrapper and raises on a
  CUDA error);
* a CPU implementation: the plain twin (``fused_block.*_plain``;
  ``ops.ssm.selective_scan`` in chunks of ``ssm_scan.TWIN_CHUNK``);
* a fake implementation giving the output's shape and dtype (the plans and
  workspaces are chosen on the host inside the CUDA implementation, at run
  time);
* a flop formula for ``torch.utils.flop_counter.FlopCounterMode``: the
  products its twin computes, which is what the counter counts when the
  twin runs under it.

The operators are defined with ``torch.library.Library.define`` / ``impl``
rather than ``torch.library.custom_op``, whose dispatch costs several times
as much host time a call. None is differentiable: training goes through
``FusedTransformerBlockFn`` and ``SelectiveScanFn``. Importing the
``kernels`` package registers them; a process that loads an exported
program needs that import and nothing else of the port.
"""

from __future__ import annotations

import types

import torch
from torch.utils.flop_counter import register_flop_formula

from bayer_low_light_image_enhancement_tpu_torch.kernels import fused_block as fb
from bayer_low_light_image_enhancement_tpu_torch.kernels import ssm_scan as ssk
from bayer_low_light_image_enhancement_tpu_torch.ops import ssm

_LIB = torch.library.Library("blle", "DEF")
_APPLY_ARGS = "Tensor x, Tensor apply, " + ", ".join(f"Tensor {n}" for n in fb.APPLY_FIELDS)
_LIB.define("gram_pass(Tensor x, " + ", ".join(f"Tensor {n}" for n in fb.GRAM_FIELDS)
            + ") -> Tensor")
_LIB.define(f"apply_pass({_APPLY_ARGS}) -> Tensor")
_LIB.define(f"apply_pass_pipelined({_APPLY_ARGS}) -> Tensor")
_LIB.define("selective_scan_fwd(Tensor u, Tensor dt, Tensor A, Tensor B, Tensor C, Tensor D)"
            " -> Tensor")


def _weights(fields, tensors) -> types.SimpleNamespace:
    """The twins read a pass's weights by field name."""
    return types.SimpleNamespace(**dict(zip(fields, tensors)))


def _gram_twin(x, *tensors):
    gram, qss, kss = fb.gram_pass_plain(x, _weights(fb.GRAM_FIELDS, tensors))
    return torch.cat([gram.flatten(1), qss, kss], 1)


def _apply_twin(x, apply, *tensors):
    return fb.apply_pass_plain(x, apply, _weights(fb.APPLY_FIELDS, tensors)).contiguous()


def _scan_twin(u, dt, A, B, C, D):
    return ssm.selective_scan(u, dt, A, B, C, D, chunk_size=ssk.TWIN_CHUNK).contiguous()


def _scan_kernel(u, dt, A, B, C, D):
    return ssk._fwd_kernel(u, dt, A, B, C, D, False)


for _name, _cpu, _cuda in (
    ("gram_pass", _gram_twin, fb._gram_pass_kernel),
    ("apply_pass", _apply_twin, fb._apply_pass_kernel),
    ("apply_pass_pipelined", _apply_twin, fb._apply_pass_pipelined_kernel),
    ("selective_scan_fwd", _scan_twin, _scan_kernel),
):
    _LIB.impl(_name, _cpu, "CPU")
    _LIB.impl(_name, _cuda, "CUDA")


@torch.library.register_fake("blle::gram_pass", lib=_LIB)
def _gram_fake(x, *tensors):
    c = x.shape[-1]
    return x.new_empty((x.shape[0], c * c + 2 * c), dtype=torch.float32)


def _same_as_first(x, *tensors):
    return x.new_empty(x.shape)


for _name in ("apply_pass", "apply_pass_pipelined", "selective_scan_fwd"):
    torch.library.register_fake(f"blle::{_name}", _same_as_first, lib=_LIB)


def gram_pass_flops(b: int, h: int, w: int, c: int) -> int:
    """K2's products: the [q|k] 1x1, the depthwise 3x3 on 2C channels and
    the gram over all pixels."""
    n = b * h * w
    return 2 * n * c * 2 * c + 2 * n * 9 * 2 * c + 2 * n * c * c


def apply_pass_flops(b: int, h: int, w: int, c: int) -> int:
    """K3's (and K3P's) products at FFN width 2C: the v 1x1, its depthwise
    3x3, v @ apply, the FFN's two 1x1s and its depthwise 3x3."""
    n, ch = b * h * w, 2 * c
    return 2 * n * c * c + 2 * n * 9 * c + 2 * n * c * c + 4 * n * c * ch + 2 * n * 9 * ch


def selective_scan_flops(b: int, L: int, d: int, n: int) -> int:
    """S1's products: y = C . h over the N states at every (b, t, d)."""
    return 2 * b * L * d * n


@register_flop_formula(torch.ops.blle.gram_pass)
def _gram_flop(x_shape, *_, **__) -> int:
    return gram_pass_flops(*x_shape)


@register_flop_formula([torch.ops.blle.apply_pass, torch.ops.blle.apply_pass_pipelined])
def _apply_flop(x_shape, *_, **__) -> int:
    return apply_pass_flops(*x_shape)


@register_flop_formula(torch.ops.blle.selective_scan_fwd)
def _scan_flop(u_shape, dt_shape, a_shape, *_, **__) -> int:
    return selective_scan_flops(*u_shape, a_shape[1])
