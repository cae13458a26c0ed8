"""Standalone fused channel attention (A1).

Port of the retired TPU kernel ``attic/fused_attention.py::
fused_channel_attention``, which no model of the JAX package calls: the
function of ``models.common.ChannelAttention`` on NHWC x, without LayerNorm
or residual,

  x [B,H,W,C] -> proj(softmax_head(norm(q)^T norm(k) * T) applied to v),

where q, k, v = dw3x3(conv1x1(x)) with the 1x1 output zero-padded for the
depthwise conv. On the card it is four launches (``csrc/fused_attention.cu``)
with no torch arithmetic between them:

  1-2. A1's gram pass (K2's tile kernel without the LayerNorm, then K2's
       reduction; twin ``attention_gram_plain``): per image the gram q^T k
       and the sums of q^2 and k^2, fp32;
  3.   the finalise kernel (``attention_finalize``; twin
       ``fused_block.finalize_attention``):
       normalisation, temperature, per-head softmax and the projection
       folded into ``apply`` [B, C, C], bf16;
  4.   A1's apply pass (K3's first kernel without LN1, at its stage 2; twin
       ``attention_apply_plain``): v per tile, then v @ apply + b_proj.

The gram and apply kernels run on the grids of ``fused_block.plan_for``
(kinds "attn_gram" and "attn_apply"). ``params`` is the state dict of
``models.common.ChannelAttention`` (``qkv.weight``, ``qkv_dwconv.weight``,
``project_out.weight``, ``temperature``, ...); the kernel arguments made from
it are cached per weight version (``arg_cache``).
``fused_channel_attention_plain`` is the fp32 twin; the wrapper runs it on a
CPU tensor and launches A1 on a CUDA tensor, or raises.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Tuple

import torch

from bayer_low_light_image_enhancement_tpu_torch.kernels import _build, fused_block
from bayer_low_light_image_enhancement_tpu_torch.kernels.arg_cache import ArgCache
from bayer_low_light_image_enhancement_tpu_torch.kernels.fused_block import (
    _dw3x3,
    bf16,
    check_kernel_input,
    f32,
    finalize_attention,
    gram_workspace_floats,
    require,
)


@dataclasses.dataclass(frozen=True)
class AttentionWeights:
    """A ChannelAttention's weights (fp32): matrices [in, out], depthwise
    taps [9, channels] (row di*3+dj)."""

    wqk: torch.Tensor    # [C, 2C]
    bqk: torch.Tensor    # [2C]
    dwqk: torch.Tensor   # [9, 2C]
    bdwqk: torch.Tensor  # [2C]
    wv: torch.Tensor     # [C, C]
    bv: torch.Tensor     # [C]
    dwv: torch.Tensor    # [9, C]
    bdwv: torch.Tensor   # [C]
    wproj: torch.Tensor  # [C, C]
    bproj: torch.Tensor  # [C]
    temperature: torch.Tensor  # [heads]

    def tensors(self):
        return [getattr(self, f.name) for f in dataclasses.fields(self)]


def attention_weights(params: Mapping[str, torch.Tensor]) -> AttentionWeights:
    p = {k: v.float() for k, v in params.items()}
    c = p["project_out.weight"].shape[0]
    wqkv = p["qkv.weight"][:, :, 0, 0].t()  # [C, 3C]
    bqkv = p["qkv.bias"]
    taps = p["qkv_dwconv.weight"].reshape(3 * c, 9).t()  # [9, 3C]
    bdw = p["qkv_dwconv.bias"]
    return AttentionWeights(
        wqk=wqkv[:, : 2 * c], bqk=bqkv[: 2 * c], dwqk=taps[:, : 2 * c], bdwqk=bdw[: 2 * c],
        wv=wqkv[:, 2 * c :], bv=bqkv[2 * c :], dwv=taps[:, 2 * c :], bdwv=bdw[2 * c :],
        wproj=p["project_out.weight"][:, :, 0, 0].t(), bproj=p["project_out.bias"],
        temperature=p["temperature"].reshape(-1),
    )


# ----------------------------------------------------------------------------
# Plain PyTorch twins (fp32)
# ----------------------------------------------------------------------------


def attention_gram_plain(
    x: torch.Tensor, w: AttentionWeights
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x [B,H,W,C] -> (gram [B,C,C], sum q^2 [B,C], sum k^2 [B,C]), fp32."""
    c = x.shape[-1]
    qk = _dw3x3(x.float() @ w.wqk + w.bqk, w.dwqk, w.bdwqk)
    q, k = qk[..., :c], qk[..., c:]
    return torch.einsum("bhwc,bhwd->bcd", q, k), (q * q).sum((1, 2)), (k * k).sum((1, 2))


def attention_apply_plain(x: torch.Tensor, apply: torch.Tensor,
                          w: AttentionWeights) -> torch.Tensor:
    """x [B,H,W,C], apply [B,C,C] -> v @ apply + b_proj [B,H,W,C], fp32."""
    v = _dw3x3(x.float() @ w.wv + w.bv, w.dwv, w.bdwv)
    return torch.einsum("bhwc,bcd->bhwd", v, apply.float()) + w.bproj


def fused_channel_attention_plain(
    x: torch.Tensor, params: Mapping[str, torch.Tensor], num_heads: int
) -> torch.Tensor:
    """A1's twin on any device: x [B,H,W,C] -> [B,H,W,C] fp32."""
    w = attention_weights(params)
    gram, qss, kss = attention_gram_plain(x, w)
    apply = finalize_attention(gram, qss, kss, w.temperature, w.wproj, num_heads)
    return attention_apply_plain(x, apply, w)


# ----------------------------------------------------------------------------
# Kernel wrapper
# ----------------------------------------------------------------------------

# The ChannelAttention weights A1's arguments are made from.
_PARAM_KEYS = ("qkv.weight", "qkv.bias", "qkv_dwconv.weight", "qkv_dwconv.bias",
               "project_out.weight", "project_out.bias", "temperature")
_ARGS = ArgCache()


def _kernel_args(params: Mapping[str, torch.Tensor]):
    """The gram pass's [wqk bf16, bqk, dwqk, bdwqk], the finalise's
    [temperature, wproj] and the apply pass's [wv bf16, bv, dwv, bdwv,
    bproj] (fp32 unless bf16), checked on the weights' device; made once per
    weight version (``arg_cache``)."""

    def make():
        w = attention_weights(params)
        c, heads = w.bv.shape[0], w.temperature.shape[0]
        gram = [bf16(w.wqk), f32(w.bqk), f32(w.dwqk), f32(w.bdwqk)]
        fin = [f32(w.temperature), f32(w.wproj)]
        app = [bf16(w.wv), f32(w.bv), f32(w.dwv), f32(w.bdwv), f32(w.bproj)]
        shapes = [(c, 2 * c), (2 * c,), (9, 2 * c), (2 * c,), (heads,), (c, c),
                  (c, c), (c,), (9, c), (c,), (c,)]
        for i, (t, shape) in enumerate(zip(gram + fin + app, shapes)):
            require(t, f"attention argument {i}", shape, w.wv.device)
        return gram, fin, app

    return _ARGS.get([params[k] for k in _PARAM_KEYS], make)


def fused_channel_attention(
    x: torch.Tensor, params: Mapping[str, torch.Tensor], num_heads: int
) -> torch.Tensor:
    """ChannelAttention on x [B,H,W,C] -> [B,H,W,C] in x's dtype.

    CPU: the plain twin. CUDA: kernel A1 (gram pass, finalise, apply pass)
    on bf16 x, or raise. Inference only: raises when grad is enabled on an
    input that requires grad."""
    if not x.is_cuda:
        return fused_channel_attention_plain(x, params, num_heads).to(x.dtype)
    return _fused_channel_attention_kernel(x, params, num_heads)


def _fused_channel_attention_kernel(x, params, num_heads):
    check_kernel_input(x, *(params[k] for k in _PARAM_KEYS))
    b, h, wd, c = x.shape
    gram, fin, app = _kernel_args(params)
    if gram[0].shape[0] != c or gram[0].device != x.device:
        raise ValueError(f"attention weights of width {gram[0].shape[0]} on {gram[0].device} "
                         f"do not fit x {tuple(x.shape)} on {x.device}")
    if fin[0].shape[0] != num_heads or c % num_heads:
        raise ValueError(f"num_heads={num_heads} does not fit the weights' "
                         f"{fin[0].shape[0]} temperatures and C={c}")
    xk = x.to(torch.bfloat16).contiguous()
    dev, stream, lib = x.device.index or 0, _build.stream_of(x), _build.library()
    # fused_block.plan_for by attribute: a test forces plans by replacing it.
    gplan = fused_block.plan_for("attn_gram", b, h, wd, c, dev)
    nws = gram_workspace_floats(b, h, wd, c, gplan)
    scratch = torch.empty(nws + b * (c * c + 2 * c), dtype=torch.float32, device=x.device)
    sums = scratch.data_ptr() + 4 * nws  # [B, C*C + 2C] after the workspace
    apply = torch.empty((b, c, c), dtype=torch.bfloat16, device=x.device)
    out = torch.empty_like(xk)
    err = lib.blle_attn_gram(xk.data_ptr(), *(t.data_ptr() for t in gram), scratch.data_ptr(),
                             sums, b, h, wd, c, gplan.ctas, stream)
    _build.check(err, "fused attention gram pass")
    _launch_finalize(sums, *(t.data_ptr() for t in fin), apply.data_ptr(), b, c, num_heads,
                     stream)
    err = lib.blle_attn_apply(xk.data_ptr(), apply.data_ptr(), *(t.data_ptr() for t in app),
                              out.data_ptr(), b, h, wd, c,
                              fused_block.plan_for("attn_apply", b, h, wd, c, dev).ctas, stream)
    _build.check(err, "fused attention apply pass")
    fused_channel_attention.launches += 1
    return out.to(x.dtype)


fused_channel_attention.launches = 0


def _launch_finalize(sums, temperature, wproj, apply, b, c, num_heads, stream) -> None:
    """Launch A1's finalise kernel on device pointers (checked by the
    caller), or raise."""
    err = _build.library().blle_attn_finalize(sums, temperature, wproj, apply, b, c, num_heads,
                                              stream)
    _build.check(err, "fused attention finalise")


def attention_finalize(sums: torch.Tensor, temperature: torch.Tensor, wproj: torch.Tensor,
                       num_heads: int) -> torch.Tensor:
    """A1's finalise kernel alone, through the launch A1 makes: sums
    [B, C*C + 2C] fp32 (the gram, then the sums of q^2 and k^2),
    temperature [heads], wproj [C, C] ([in, out]) -> apply [B, C, C] bf16
    (twin: ``finalize_attention``). CUDA only, or raise."""
    b, c = sums.shape[0], wproj.shape[0]
    args = [f32(sums), f32(temperature.reshape(-1)), f32(wproj)]
    for t, name, shape in zip(args, ("sums", "temperature", "wproj"),
                              ((b, c * c + 2 * c), (num_heads,), (c, c))):
        require(t, name, shape, sums.device)
    if not sums.is_cuda:
        raise ValueError("the finalise kernel takes CUDA tensors")
    apply = torch.empty((b, c, c), dtype=torch.bfloat16, device=sums.device)
    _launch_finalize(*(t.data_ptr() for t in args), apply.data_ptr(), b, c, num_heads,
                     _build.stream_of(sums))
    return apply
