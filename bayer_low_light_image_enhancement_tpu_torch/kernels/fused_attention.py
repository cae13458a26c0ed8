"""Standalone fused channel attention (A1).

Port of the retired TPU kernel ``attic/fused_attention.py::
fused_channel_attention``, which no model of the JAX package calls: the
function of ``models.common.ChannelAttention`` on NHWC x, without LayerNorm
or residual,

  x [B,H,W,C] -> proj(softmax_head(norm(q)^T norm(k) * T) applied to v),

where q, k, v = dw3x3(conv1x1(x)) with the 1x1 output zero-padded for the
depthwise conv. It runs as K2 and K3 run the block (``fused_block``):

  1. A1's gram pass (K2's tile code without the LayerNorm; twin
     ``attention_gram_plain``): per image the gram q^T k and the sums of q^2
     and k^2, fp32;
  2. ``fused_block.finalize_attention``, plain torch on [C, C];
  3. A1's apply pass (twin ``attention_apply_plain``): v per tile, then
     v @ apply + b_proj.

``params`` is the state dict of ``models.common.ChannelAttention``
(``qkv.weight``, ``qkv_dwconv.weight``, ``project_out.weight``,
``temperature``, ...). ``fused_channel_attention_plain`` is the fp32 twin;
the wrapper runs it on a CPU tensor and launches A1
(``csrc/fused_attention.cu``) on a CUDA tensor, or raises.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Tuple

import torch

from bayer_low_light_image_enhancement_tpu_torch.kernels import _build
from bayer_low_light_image_enhancement_tpu_torch.kernels.fused_block import (
    _dw3x3,
    bf16,
    check_kernel_input,
    f32,
    finalize_attention,
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
    w = attention_weights(params)
    check_kernel_input(x, *w.tensors())
    b, h, wd, c = x.shape
    xk = x.to(torch.bfloat16).contiguous()
    lib = _build.library()
    gargs = [bf16(w.wqk), f32(w.bqk), f32(w.dwqk), f32(w.bdwqk)]
    for t, s in zip(gargs, ((c, 2 * c), (2 * c,), (9, 2 * c), (2 * c,))):
        require(t, "attention gram argument", s, x.device)
    ws = torch.empty(lib.blle_attn_gram_workspace_floats(b, h, wd, c), dtype=torch.float32,
                     device=x.device)
    sums = torch.empty((b, c * c + 2 * c), dtype=torch.float32, device=x.device)
    err = lib.blle_attn_gram(xk.data_ptr(), *(t.data_ptr() for t in gargs), ws.data_ptr(),
                             sums.data_ptr(), b, h, wd, c, _build.stream_of(x))
    _build.check(err, "fused attention gram pass")
    gram = sums[:, : c * c].reshape(b, c, c)
    apply = finalize_attention(gram, sums[:, c * c : c * c + c], sums[:, c * c + c :],
                               w.temperature, w.wproj, num_heads)
    aargs = [bf16(apply), bf16(w.wv), f32(w.bv), f32(w.dwv), f32(w.bdwv), f32(w.bproj)]
    for t, s in zip(aargs, ((b, c, c), (c, c), (c,), (9, c), (c,), (c,))):
        require(t, "attention apply argument", s, x.device)
    out = torch.empty_like(xk)
    err = lib.blle_attn_apply(xk.data_ptr(), *(t.data_ptr() for t in aargs), out.data_ptr(),
                              b, h, wd, c, _build.stream_of(x))
    _build.check(err, "fused attention apply pass")
    fused_channel_attention.launches += 1
    return out.to(x.dtype)


fused_channel_attention.launches = 0
