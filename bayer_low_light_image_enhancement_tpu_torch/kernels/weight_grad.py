"""The weight-grad pass of the fused-block backward at C >= 96: out[g] =
a[g]^T b[g] summed over all pixels, on the tensor cores (``wgmma``).

Part of the port of the TPU kernels ``_bwd1_kernel`` / ``_bwd2_kernel``
(``bayer_low_light_image_enhancement_tpu/kernels/fused_block_bwd.py``): there
the weight grads stayed resident in output blocks across a sequential grid.
At C >= 96 B1's accumulators do not fit on chip, so B1 and B2
(``kernels/fused_block_bwd.py``) write the products' operands once per pixel
and this pass contracts them: a [G, K, M] and b [G, K, N] bf16, K the pixels
with the channels contiguous, -> [G, M, N] fp32 (B1: d_apply per image, dwp1,
dwp2; B2: [dwqk|dwv]).

``plan`` splits each product's K over blocks (``csrc/weight_grad.cu``: one
64x64 output tile and one K slice per block, fixed-order sum of the slices),
so the result depends only on the shapes: it is deterministic.
``weight_grad`` runs the plain twin on CPU tensors and the kernel on CUDA
tensors, or raises; ``weight_grad.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import List, Sequence, Tuple

import torch

from bayer_low_light_image_enhancement_tpu_torch.kernels import _build

MAX_PROBLEMS = 4  # products in one launch (csrc/weight_grad.cu kMaxProblems)
TILE = 64  # output tile rows and columns of a block
K_STEP = 64  # pixels a block stages at a time
MIN_SLICE = 256  # least pixels a block contracts
TARGET_BLOCKS = 1024  # blocks a launch aims for, over all its products

Pair = Tuple[torch.Tensor, torch.Tensor]


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class Split:
    """One product's share of a launch: ``slices`` K slices of ``kslice``
    pixels (a multiple of K_STEP; the last one ragged), its partials at
    ``ws_offset`` floats of the workspace ([G, slices, M, N]) and its first
    block ``first_block``."""

    slices: int
    kslice: int
    ws_offset: int
    first_block: int
    blocks: int


def plan(shapes: Sequence[Tuple[int, int, int, int]]) -> Tuple[List[Split], int, int]:
    """Split each (G, K, M, N) product over blocks: -> (splits, workspace
    floats, blocks of the launch). Each product gets about an even share of
    TARGET_BLOCKS, in at most ceil(K / MIN_SLICE) slices."""
    if not 1 <= len(shapes) <= MAX_PROBLEMS:
        raise ValueError(f"1 to {MAX_PROBLEMS} products per launch, got {len(shapes)}")
    splits, ws, first = [], 0, 0
    for g, k, m, n in shapes:
        tiles = g * _cdiv(m, TILE) * _cdiv(n, TILE)
        s = max(1, min(_cdiv(k, MIN_SLICE), _cdiv(TARGET_BLOCKS, tiles * len(shapes))))
        kslice = _cdiv(_cdiv(k, s), K_STEP) * K_STEP
        s = _cdiv(k, kslice)
        splits.append(Split(s, kslice, ws, first, tiles * s))
        ws += g * s * m * n
        first += tiles * s
    return splits, ws, first


def weight_grad_plain(pairs: Sequence[Pair]) -> List[torch.Tensor]:
    """The twin: [a[g]^T b[g] for each (a, b)] in fp32."""
    return [torch.einsum("gkm,gkn->gmn", a.float(), b.float()) for a, b in pairs]


def _check(a: torch.Tensor, b: torch.Tensor, out: torch.Tensor) -> None:
    if a.dim() != 3 or b.dim() != 3 or a.shape[:2] != b.shape[:2]:
        raise ValueError(f"a [G,K,M] and b [G,K,N] must share G and K: {tuple(a.shape)}, "
                         f"{tuple(b.shape)}")
    g, _, m = a.shape
    n = b.shape[2]
    if m % 8 or n % 8:
        raise ValueError(f"M and N must be multiples of 8, got {m}, {n}")
    for t, name in ((a, "a"), (b, "b")):
        if t.dtype != torch.bfloat16 or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be bf16, contiguous and 16-byte aligned")
    if (out.dtype != torch.float32 or tuple(out.shape) != (g, m, n) or not out.is_contiguous()
            or out.data_ptr() % 16 or out.device != a.device or b.device != a.device):
        raise ValueError(f"out must be a contiguous fp32 [{g},{m},{n}] on {a.device}")


def weight_grad(pairs: Sequence[Pair], outs: Sequence[torch.Tensor] | None = None):
    """[a[g]^T b[g] for each (a, b)] fp32, written into ``outs`` if given.
    CPU: the twin. CUDA: one launch of the kernel for all pairs, or raise."""
    if not pairs[0][0].is_cuda:
        res = weight_grad_plain(pairs)
        if outs is None:
            return res
        for o, r in zip(outs, res):
            o.copy_(r)
        return list(outs)
    return _weight_grad_kernel(pairs, outs)


def _weight_grad_kernel(pairs: Sequence[Pair], outs: Sequence[torch.Tensor] | None):
    if outs is None:
        outs = [torch.empty((a.shape[0], a.shape[2], b.shape[2]), dtype=torch.float32,
                            device=a.device) for a, b in pairs]
    for (a, b), o in zip(pairs, outs):
        _check(a, b, o)
    shapes = [(a.shape[0], a.shape[1], a.shape[2], b.shape[2]) for a, b in pairs]
    splits, ws_floats, _ = plan(shapes)
    ws = torch.empty(ws_floats, dtype=torch.float32, device=pairs[0][0].device)
    table = []
    for (a, b), o, (g, k, m, n), sp in zip(pairs, outs, shapes, splits):
        table += [a.data_ptr(), b.data_ptr(), ws.data_ptr() + 4 * sp.ws_offset, o.data_ptr(),
                  g, k, m, n, sp.slices, sp.kslice, sp.first_block]
    lib = _build.library()
    err = lib.blle_weight_grad((ctypes.c_longlong * len(table))(*table), len(pairs),
                               _build.stream_of(pairs[0][0]))
    _build.check(err, "weight-grad pass")
    weight_grad.launches += 1
    return list(outs)


weight_grad.launches = 0
