"""Fused TransformerBlock forward: LN + channel attention + ConvFFN (K2, K3).

Port of ``bayer_low_light_image_enhancement_tpu/kernels/fused_block.py``.
One block runs as

  1. ``gram_pass`` (K2): LN1 (affine folded into the 1x1) -> [q|k] 1x1 ->
     dw3x3 -> per image the gram ``q^T k`` over all pixels plus the sums of
     q^2 and k^2, in fp32;
  2. ``finalize_attention``: plain torch on [C, C] (XLA on the TPU too):
     F.normalize, temperature, per-head softmax, folded into the projection;
  3. ``apply_pass`` (K3): LN1 -> v -> ``y = x + v @ apply + b_proj`` -> LN2
     -> 1x1 -> dw3x3 -> exact GELU -> 1x1 -> + y.

Each pass has a plain PyTorch twin (``*_plain``) computing the same function
in fp32. The wrappers run the twin on a CPU tensor; on a CUDA tensor they
launch the kernel (``csrc/fused_block.cu``) or raise. The pass wrappers are
not differentiable themselves: ``fused_transformer_block`` with grad
enabled goes through ``fused_block_bwd.FusedTransformerBlockFn``, whose
backward runs the kernels B1/B2 (``csrc/fused_block_bwd.cu``).

``params`` is the state dict of ``models.common.TransformerBlock`` (the
reference's names: ``norm1.body.weight``, ``attn.qkv.weight``, ...).
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Tuple

import torch
import torch.nn.functional as F

from bayer_low_light_image_enhancement_tpu_torch.kernels import _build
from bayer_low_light_image_enhancement_tpu_torch.ops.conv import conv2d

# Channel widths the CUDA kernels are instantiated for: every RawFormer
# level with C <= 256 (S: 32..256, B: 48..192, L: 64..256).
KERNEL_WIDTHS = (32, 48, 64, 96, 128, 192, 256)


@dataclasses.dataclass(frozen=True)
class BlockWeights:
    """A TransformerBlock's weights with the LN affines folded in (fp32).

    Matrices are [in, out]; depthwise taps are [9, channels] (row di*3+dj).
    """

    wqk: torch.Tensor    # [C, 2C]  LN1 affine folded
    bqk: torch.Tensor    # [2C]
    dwqk: torch.Tensor   # [9, 2C]
    bdwqk: torch.Tensor  # [2C]
    wv: torch.Tensor     # [C, C]   LN1 affine folded
    bv: torch.Tensor     # [C]
    dwv: torch.Tensor    # [9, C]
    bdwv: torch.Tensor   # [C]
    wproj: torch.Tensor  # [C, C]
    bproj: torch.Tensor  # [C]
    temperature: torch.Tensor  # [heads]
    wp1: torch.Tensor    # [C, Ch]  LN2 affine folded
    bp1: torch.Tensor    # [Ch]
    dwf: torch.Tensor    # [9, Ch]
    bdwf: torch.Tensor   # [Ch]
    wp2: torch.Tensor    # [Ch, C]
    bp2: torch.Tensor    # [C]

    def tensors(self):
        return [getattr(self, f.name) for f in dataclasses.fields(self)]


def fold_block_params(params: Mapping[str, torch.Tensor]) -> BlockWeights:
    """Fold the LN affines into the consuming 1x1 convs (exact in fp32):
    ``(xhat * w + b) @ W + bias == xhat @ (diag(w) W) + (b @ W + bias)``."""
    p = {k: v.float() for k, v in params.items()}
    c = p["attn.project_out.weight"].shape[0]
    wqkv = p["attn.qkv.weight"][:, :, 0, 0].t()  # [C, 3C]
    bqkv = p["attn.qkv.bias"]
    taps = p["attn.qkv_dwconv.weight"].reshape(3 * c, 9).t()  # [9, 3C]
    bdw = p["attn.qkv_dwconv.bias"]
    ln1w, ln1b = p["norm1.body.weight"], p["norm1.body.bias"]
    ln2w, ln2b = p["norm2.body.weight"], p["norm2.body.bias"]
    wp1 = p["ffn.pointwise1.weight"][:, :, 0, 0].t()  # [C, Ch]
    ch = wp1.shape[1]
    return BlockWeights(
        wqk=ln1w[:, None] * wqkv[:, : 2 * c],
        bqk=ln1b @ wqkv[:, : 2 * c] + bqkv[: 2 * c],
        dwqk=taps[:, : 2 * c],
        bdwqk=bdw[: 2 * c],
        wv=ln1w[:, None] * wqkv[:, 2 * c :],
        bv=ln1b @ wqkv[:, 2 * c :] + bqkv[2 * c :],
        dwv=taps[:, 2 * c :],
        bdwv=bdw[2 * c :],
        wproj=p["attn.project_out.weight"][:, :, 0, 0].t(),
        bproj=p["attn.project_out.bias"],
        temperature=p["attn.temperature"].reshape(-1),
        wp1=ln2w[:, None] * wp1,
        bp1=ln2b @ wp1 + p["ffn.pointwise1.bias"],
        dwf=p["ffn.depthwise.weight"].reshape(ch, 9).t(),
        bdwf=p["ffn.depthwise.bias"],
        wp2=p["ffn.pointwise2.weight"][:, :, 0, 0].t(),
        bp2=p["ffn.pointwise2.bias"],
    )


# ----------------------------------------------------------------------------
# Plain PyTorch twins (fp32)
# ----------------------------------------------------------------------------


def _ln_hat(x: torch.Tensor) -> torch.Tensor:
    """Channel LayerNorm without affine: biased variance, eps 1e-5."""
    mu = x.mean(-1, keepdim=True)
    d = x - mu
    return d * torch.rsqrt((d * d).mean(-1, keepdim=True) + 1e-5)


def _dw3x3(z: torch.Tensor, taps: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Depthwise 3x3, zero padding, on NHWC; taps [9, F]."""
    f = z.shape[-1]
    return conv2d(z, taps.reshape(3, 3, 1, f), bias, groups=f)


def gram_pass_plain(
    x: torch.Tensor, w: BlockWeights
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x [B,H,W,C] -> (gram [B,C,C], sum q^2 [B,C], sum k^2 [B,C]), fp32."""
    c = x.shape[-1]
    qk = _dw3x3(_ln_hat(x.float()) @ w.wqk + w.bqk, w.dwqk, w.bdwqk)
    q, k = qk[..., :c], qk[..., c:]
    gram = torch.einsum("bhwc,bhwd->bcd", q, k)
    return gram, (q * q).sum((1, 2)), (k * k).sum((1, 2))


def attention_out_plain(x: torch.Tensor, apply: torch.Tensor, w: BlockWeights) -> torch.Tensor:
    """The first residual's output y = x + v @ apply + b_proj (fp32)."""
    xf = x.float()
    v = _dw3x3(_ln_hat(xf) @ w.wv + w.bv, w.dwv, w.bdwv)
    return xf + torch.einsum("bhwc,bcd->bhwd", v, apply.float()) + w.bproj


def ffn_out_plain(y: torch.Tensor, w: BlockWeights) -> torch.Tensor:
    """The second residual's output y + FFN(LN2(y)) (fp32)."""
    t = _ln_hat(y) @ w.wp1 + w.bp1
    f = F.gelu(_dw3x3(t, w.dwf, w.bdwf))
    return y + f @ w.wp2 + w.bp2


def apply_pass_plain(x: torch.Tensor, apply: torch.Tensor, w: BlockWeights) -> torch.Tensor:
    """x [B,H,W,C], apply [B,C,C] -> block output [B,H,W,C] in x's dtype."""
    return ffn_out_plain(attention_out_plain(x, apply, w), w).to(x.dtype)


def finalize_attention(
    gram: torch.Tensor,
    qss: torch.Tensor,
    kss: torch.Tensor,
    temperature: torch.Tensor,
    wproj: torch.Tensor,
    num_heads: int,
) -> torch.Tensor:
    """[C, C] finalise: per-head normalised softmax folded into the output
    projection. gram [B,C,C], qss/kss [B,C] -> apply [B,C,C] (fp32) with
    ``out_tokens = v_tokens @ apply (+ proj bias)``."""
    c = gram.shape[-1]
    ch = c // num_heads
    head = torch.arange(c, device=gram.device) // ch
    mask = torch.where(head[:, None] == head[None, :], 0.0, float("-inf"))
    trow = temperature.float().repeat_interleave(ch)  # [C]
    # torch F.normalize: x / max(|x|, eps), eps=1e-12.
    qinv = 1.0 / torch.sqrt(qss.float()).clamp_min(1e-12)
    kinv = 1.0 / torch.sqrt(kss.float()).clamp_min(1e-12)
    attn = gram.float() * qinv[:, :, None] * kinv[:, None, :]
    attn = torch.softmax(attn * trow[None, :, None] + mask, dim=-1)
    # apply[c', d] = sum_c attn[c, c'] wproj[c, d]
    return torch.einsum("bcx,cd->bxd", attn, wproj.float())


# ----------------------------------------------------------------------------
# Kernel wrappers
# ----------------------------------------------------------------------------


def require(t: torch.Tensor, name: str, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def check_block_input(x: torch.Tensor, w: BlockWeights, *grad_inputs: torch.Tensor) -> None:
    """What every fused-block kernel takes: x [B,H,W,C] bf16, contiguous, C
    in KERNEL_WIDTHS, FFN hidden 2C. A kernel wrapper is not differentiable:
    it raises when grad is enabled on an input (x, ``grad_inputs`` or a
    weight) that requires grad."""
    if x.dim() != 4 or not 0 < x.shape[0] <= 65535 or x.shape[1] * x.shape[2] == 0:
        raise ValueError(f"x must be [B, H, W, C] with 1 <= B <= 65535, H, W > 0; "
                         f"got {tuple(x.shape)}")
    c = x.shape[-1]
    if c not in KERNEL_WIDTHS:
        raise ValueError(f"no kernel for C={c}; widths: {KERNEL_WIDTHS}")
    if w.wp1.shape[1] != 2 * c:
        raise ValueError(f"kernel needs FFN hidden width 2C, got {w.wp1.shape[1]}")
    if torch.is_grad_enabled() and any(
        t.requires_grad for t in (x, *grad_inputs, *w.tensors())
    ):
        raise RuntimeError(
            "a fused-block kernel wrapper is not differentiable: train through "
            "fused_transformer_block (FusedTransformerBlockFn) or call under "
            "torch.no_grad()"
        )
    if x.dtype != torch.bfloat16:
        raise TypeError(f"x is {x.dtype}; the kernels take bfloat16")
    require(x, "x", x.shape, x.device)


def bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).contiguous()


def f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32).contiguous()


def gram_pass(x: torch.Tensor, w: BlockWeights):
    """Pass A. x [B,H,W,C] -> (gram [B,C,C], qss [B,C], kss [B,C]), fp32.

    CPU: the plain twin. CUDA: kernel K2 on bf16 x, or raise."""
    if not x.is_cuda:
        return gram_pass_plain(x, w)
    return _gram_pass_kernel(x, w)


def _gram_pass_kernel(x: torch.Tensor, w: BlockWeights):
    check_block_input(x, w)
    b, h, wd, c = x.shape
    lib = _build.library()
    args = [bf16(w.wqk), f32(w.bqk), f32(w.dwqk), f32(w.bdwqk)]
    for t, n, s in zip(args, ("wqk", "bqk", "dwqk", "bdwqk"),
                       ((c, 2 * c), (2 * c,), (9, 2 * c), (2 * c,))):
        require(t, n, s, x.device)
    ws = torch.empty(lib.blle_gram_workspace_floats(b, h, wd, c), dtype=torch.float32,
                     device=x.device)
    out = torch.empty((b, c * c + 2 * c), dtype=torch.float32, device=x.device)
    err = lib.blle_gram_pass(
        x.data_ptr(), *(t.data_ptr() for t in args), ws.data_ptr(), out.data_ptr(),
        b, h, wd, c, _build.stream_of(x),
    )
    _build.check(err, "fused_block gram pass")
    gram_pass.launches += 1
    return out[:, : c * c].reshape(b, c, c), out[:, c * c : c * c + c], out[:, c * c + c :]


gram_pass.launches = 0


def apply_pass(x: torch.Tensor, apply: torch.Tensor, w: BlockWeights) -> torch.Tensor:
    """Pass B. x [B,H,W,C], apply [B,C,C] -> [B,H,W,C] in x's dtype.

    CPU: the plain twin. CUDA: kernel K3 on bf16 x (apply rounded to bf16),
    or raise."""
    if not x.is_cuda:
        return apply_pass_plain(x, apply, w)
    return _apply_pass_kernel(x, apply, w)


def _apply_pass_kernel(x: torch.Tensor, apply: torch.Tensor, w: BlockWeights) -> torch.Tensor:
    check_block_input(x, w, apply)
    b, h, wd, c = x.shape
    ch = 2 * c
    args = [
        bf16(apply), bf16(w.wv), f32(w.bv), f32(w.dwv), f32(w.bdwv), f32(w.bproj),
        bf16(w.wp1), f32(w.bp1), f32(w.dwf), f32(w.bdwf), bf16(w.wp2), f32(w.bp2),
    ]
    shapes = [(b, c, c), (c, c), (c,), (9, c), (c,), (c,),
              (c, ch), (ch,), (9, ch), (ch,), (ch, c), (c,)]
    for i, (t, s) in enumerate(zip(args, shapes)):
        require(t, f"apply-pass argument {i}", s, x.device)
    out = torch.empty_like(x)
    err = _build.library().blle_apply_pass(
        x.data_ptr(), *(t.data_ptr() for t in args), out.data_ptr(),
        b, h, wd, c, _build.stream_of(x),
    )
    _build.check(err, "fused_block apply pass")
    apply_pass.launches += 1
    return out


apply_pass.launches = 0


def fused_transformer_block(
    x: torch.Tensor, params: Mapping[str, torch.Tensor], num_heads: int
) -> torch.Tensor:
    """One TransformerBlock on x [B, H, W, C] -> [B, H, W, C] (x's dtype).

    On CUDA the kernels compute in bf16 whatever x's dtype (as the TPU
    kernel does); on the CPU the fp32 twins run. With grad enabled on x or
    a parameter the block runs through ``FusedTransformerBlockFn`` (the same
    forward, B1/B2 backward); otherwise K2 and K3 are called directly."""
    w = fold_block_params(params)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, *w.tensors())):
        # Imported here: fused_block_bwd imports this module.
        from bayer_low_light_image_enhancement_tpu_torch.kernels.fused_block_bwd import (
            FusedTransformerBlockFn,
        )

        return FusedTransformerBlockFn.apply(x, num_heads, *w.tensors())
    xk = x.to(torch.bfloat16).contiguous() if x.is_cuda else x
    gram, qss, kss = gram_pass(xk, w)
    apply = finalize_attention(gram, qss, kss, w.temperature, w.wproj, num_heads)
    return apply_pass(xk, apply, w).to(x.dtype)


def fused_transformer_block_plain(
    x: torch.Tensor, params: Mapping[str, torch.Tensor], num_heads: int
) -> torch.Tensor:
    """The whole block through the twins, on any device (fp32 inside)."""
    w = fold_block_params(params)
    gram, qss, kss = gram_pass_plain(x, w)
    apply = finalize_attention(gram, qss, kss, w.temperature, w.wproj, num_heads)
    return apply_pass_plain(x, apply, w)
