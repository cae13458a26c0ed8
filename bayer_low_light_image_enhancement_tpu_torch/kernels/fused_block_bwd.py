"""Fused TransformerBlock backward (B1, B2) and its ``autograd.Function``.

Port of ``bayer_low_light_image_enhancement_tpu/kernels/fused_block_bwd.py``.
Training runs each TransformerBlock as ``FusedTransformerBlockFn``:

* forward: K2 (gram pass) -> ``finalize_attention`` -> K3 or K3P (the apply
  pass ``select_apply_pass`` picks), as inference does; it saves x, the folded weights and the [C, C]-sized
  ``gram, qss, kss, apply`` (remat-grade memory: nothing pixel-sized beyond
  x itself);
* backward:
  1. ``bwd1`` (B1): recomputes v, y and the FFN from x and from dy forms dx2
     (the grad at the first residual's output), d_apply and the FFN / LN2 /
     projection-bias grads;
  2. ``finalize_backward``: torch autograd through the [C, C]
     ``finalize_attention`` (the JAX ``jax.vjp``), giving d_gram, d_qss,
     d_kss and the temperature and projection grads;
  3. ``bwd2`` (B2): recomputes q, k and the pre-dw z's, forms dq, dk, dv and
     emits dx and the attention-branch grads.

All grads are those of the LN-affine-folded ``BlockWeights``; autograd then
carries them through ``fold_block_params`` to the module's parameters.

Each pass has a plain twin (``*_plain``, fp32, torch autograd of the
forward twins). The wrappers ``bwd1``/``bwd2`` run the twin on a CPU tensor
and launch the CUDA kernel (``csrc/fused_block_bwd.cu``) on a CUDA tensor,
or raise; ``bwd1.launches``/``bwd2.launches`` count the launches.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import torch

from bayer_low_light_image_enhancement_tpu_torch.kernels import _build
from bayer_low_light_image_enhancement_tpu_torch.kernels.fused_block import (
    BlockWeights,
    attention_out_plain,
    bf16,
    check_block_input,
    f32,
    ffn_out_plain,
    finalize_attention,
    gram_pass,
    gram_pass_plain,
    require,
    select_apply_pass,
)

# BlockWeights fields whose grads each pass emits (the rest, temperature
# and wproj, come from finalize_backward).
B1_FIELDS = ("wp1", "bp1", "dwf", "bdwf", "wp2", "bp2", "bproj")
B2_FIELDS = ("wqk", "bqk", "dwqk", "bdwqk", "wv", "bv", "dwv", "bdwv")

Grads = Dict[str, torch.Tensor]


def _const(t: torch.Tensor) -> torch.Tensor:
    """A detached fp32 copy (also of an inference-mode tensor, which autograd
    may not save)."""
    return t.detach().to(torch.float32, copy=True)


def _leaves(w: BlockWeights, names: Sequence[str]) -> Tuple[BlockWeights, Grads]:
    """w with the named fields as fresh fp32 leaves requiring grad, the rest
    as constants."""
    leaves = {n: _const(getattr(w, n)).requires_grad_() for n in names}
    rest = {f.name: _const(getattr(w, f.name)) for f in dataclasses.fields(w)
            if f.name not in leaves}
    return BlockWeights(**rest, **leaves), leaves


# ----------------------------------------------------------------------------
# Plain PyTorch twins (fp32)
# ----------------------------------------------------------------------------


def bwd1_plain(
    x: torch.Tensor, dy: torch.Tensor, apply: torch.Tensor, w: BlockWeights
) -> Tuple[torch.Tensor, torch.Tensor, Grads]:
    """B1's twin: (x, dy [B,H,W,C], apply [B,C,C]) -> (dx2 [B,H,W,C],
    d_apply [B,C,C], grads of B1_FIELDS), fp32."""
    with torch.enable_grad():
        wl, leaves = _leaves(w, B1_FIELDS)
        ap = _const(apply).requires_grad_()
        y = attention_out_plain(_const(x), ap, wl)
        out = ffn_out_plain(y, wl)
        dx2, d_apply, *g = torch.autograd.grad(out, [y, ap, *leaves.values()], dy.float())
    return dx2, d_apply, dict(zip(leaves, g))


def bwd2_plain(
    x: torch.Tensor,
    dx2: torch.Tensor,
    apply: torch.Tensor,
    d_gram: torch.Tensor,
    d_qss: torch.Tensor,
    d_kss: torch.Tensor,
    w: BlockWeights,
) -> Tuple[torch.Tensor, Grads]:
    """B2's twin: -> (dx [B,H,W,C], grads of B2_FIELDS), fp32. dx holds the
    residual dx2 plus everything that reaches x through q, k and v."""
    with torch.enable_grad():
        wl, leaves = _leaves(w, B2_FIELDS)
        xf = _const(x).requires_grad_()
        gram, qss, kss = gram_pass_plain(xf, wl)
        y = attention_out_plain(xf, _const(apply), wl)
        total = ((gram * _const(d_gram)).sum() + (qss * _const(d_qss)).sum()
                 + (kss * _const(d_kss)).sum() + (y * _const(dx2)).sum())
        dx, *g = torch.autograd.grad(total, [xf, *leaves.values()])
    return dx, dict(zip(leaves, g))


def finalize_backward(
    gram: torch.Tensor,
    qss: torch.Tensor,
    kss: torch.Tensor,
    temperature: torch.Tensor,
    wproj: torch.Tensor,
    d_apply: torch.Tensor,
    num_heads: int,
) -> Tuple[torch.Tensor, ...]:
    """Autograd through ``finalize_attention`` (plain torch on [C, C]):
    d_apply -> (d_gram, d_qss, d_kss, d_temperature, d_wproj)."""
    with torch.enable_grad():
        ins = [_const(t).requires_grad_() for t in (gram, qss, kss, temperature, wproj)]
        apply = finalize_attention(*ins, num_heads)
        return torch.autograd.grad(apply, ins, d_apply)


def fused_block_backward_plain(
    x: torch.Tensor,
    dy: torch.Tensor,
    w: BlockWeights,
    residuals: Sequence[torch.Tensor],
    num_heads: int,
) -> Tuple[torch.Tensor, Grads]:
    """The whole block backward through the twins, on any device (fp32):
    (x, dy, folded weights, (gram, qss, kss, apply)) -> (dx, grads of every
    BlockWeights field)."""
    gram, qss, kss, apply = residuals
    dx2, d_apply, g1 = bwd1_plain(x, dy, apply, w)
    d_gram, d_qss, d_kss, d_temp, d_wproj = finalize_backward(
        gram, qss, kss, w.temperature, w.wproj, d_apply, num_heads)
    dx, g2 = bwd2_plain(x, dx2, apply, d_gram, d_qss, d_kss, w)
    return dx, {**g1, **g2, "temperature": d_temp, "wproj": d_wproj}


# ----------------------------------------------------------------------------
# Kernel wrappers
# ----------------------------------------------------------------------------


def _require_like(t: torch.Tensor, x: torch.Tensor, name: str) -> torch.Tensor:
    t = t.to(torch.bfloat16).contiguous()
    require(t, name, x.shape, x.device)
    return t


def bwd1(x: torch.Tensor, dy: torch.Tensor, apply: torch.Tensor, w: BlockWeights):
    """B1: -> (dx2 [B,H,W,C] in x's dtype, d_apply [B,C,C] fp32, grads of
    B1_FIELDS fp32). CPU: the plain twin. CUDA: the kernel on bf16 x, or
    raise."""
    if not x.is_cuda:
        dx2, d_apply, g = bwd1_plain(x, dy, apply, w)
        return dx2.to(x.dtype), d_apply, g
    return _bwd1_kernel(x, dy, apply, w)


def _bwd1_kernel(x, dy, apply, w):
    check_block_input(x, w, dy, apply)
    b, h, wd, c = x.shape
    ch = 2 * c
    dy = _require_like(dy, x, "dy")
    args = [
        bf16(apply), bf16(w.wv), f32(w.bv), f32(w.dwv), f32(w.bdwv), f32(w.bproj),
        bf16(w.wp1), f32(w.bp1), f32(w.dwf), f32(w.bdwf), bf16(w.wp2.t()), bf16(w.wp1.t()),
    ]
    shapes = [(b, c, c), (c, c), (c,), (9, c), (c,), (c,),
              (c, ch), (ch,), (9, ch), (ch,), (c, ch), (ch, c)]
    for i, (t, s) in enumerate(zip(args, shapes)):
        require(t, f"B1 argument {i}", s, x.device)
    lib = _build.library()
    ws = torch.empty(lib.blle_bwd1_workspace_floats(b, h, wd, c), dtype=torch.float32,
                     device=x.device)
    dx2 = torch.empty_like(x)
    d_apply = torch.empty((b, c, c), dtype=torch.float32, device=x.device)
    dw = torch.empty(lib.blle_bwd1_grad_floats(c), dtype=torch.float32, device=x.device)
    err = lib.blle_bwd1(
        x.data_ptr(), dy.data_ptr(), *(t.data_ptr() for t in args), ws.data_ptr(),
        dx2.data_ptr(), d_apply.data_ptr(), dw.data_ptr(), b, h, wd, c, _build.stream_of(x),
    )
    _build.check(err, "fused_block backward pass B1")
    bwd1.launches += 1
    # Layout of dw (csrc/fused_block_bwd.cu Bwd1Cfg, without d_apply).
    sizes = [c * ch, ch * c, 9 * ch, ch, ch, c, c]
    wp1, wp2, dwf, bdwf, bp1, bp2, bproj = torch.split(dw[: sum(sizes)], sizes)
    g = dict(wp1=wp1.view(c, ch), wp2=wp2.view(ch, c), dwf=dwf.view(9, ch), bdwf=bdwf,
             bp1=bp1, bp2=bp2, bproj=bproj)
    return dx2, d_apply, g


bwd1.launches = 0


def bwd2(x, dx2, apply, d_gram, d_qss, d_kss, w: BlockWeights):
    """B2: -> (dx [B,H,W,C] in x's dtype, grads of B2_FIELDS fp32). CPU: the
    plain twin. CUDA: the kernel on bf16 x and dx2 (d_gram, apply rounded to
    bf16), or raise."""
    if not x.is_cuda:
        dx, g = bwd2_plain(x, dx2, apply, d_gram, d_qss, d_kss, w)
        return dx.to(x.dtype), g
    return _bwd2_kernel(x, dx2, apply, d_gram, d_qss, d_kss, w)


def _bwd2_kernel(x, dx2, apply, d_gram, d_qss, d_kss, w):
    check_block_input(x, w, dx2, apply, d_gram, d_qss, d_kss)
    b, h, wd, c = x.shape
    dx2 = _require_like(dx2, x, "dx2")
    args = [
        bf16(apply.transpose(1, 2)), bf16(d_gram.transpose(1, 2)), bf16(d_gram),
        f32(torch.cat([d_qss, d_kss], 1)),
        bf16(w.wqk), f32(w.bqk), f32(w.dwqk), f32(w.bdwqk),
        bf16(w.wv), f32(w.bv), f32(w.dwv), f32(w.bdwv),
        bf16(torch.cat([w.wqk, w.wv], 1).t()),
    ]
    shapes = [(b, c, c), (b, c, c), (b, c, c), (b, 2 * c),
              (c, 2 * c), (2 * c,), (9, 2 * c), (2 * c,),
              (c, c), (c,), (9, c), (c,), (3 * c, c)]
    for i, (t, s) in enumerate(zip(args, shapes)):
        require(t, f"B2 argument {i}", s, x.device)
    lib = _build.library()
    ws = torch.empty(lib.blle_bwd2_workspace_floats(b, h, wd, c), dtype=torch.float32,
                     device=x.device)
    dx = torch.empty_like(x)
    dw = torch.empty(lib.blle_bwd2_grad_floats(c), dtype=torch.float32, device=x.device)
    err = lib.blle_bwd2(
        x.data_ptr(), dx2.data_ptr(), *(t.data_ptr() for t in args), ws.data_ptr(),
        dx.data_ptr(), dw.data_ptr(), b, h, wd, c, _build.stream_of(x),
    )
    _build.check(err, "fused_block backward pass B2")
    bwd2.launches += 1
    # Layout of dw (Bwd2Cfg): dW [C,3C] | ddw [9,3C] | dbdw [3C] | db [3C].
    sizes = [3 * c * c, 27 * c, 3 * c, 3 * c]
    dw_, ddw, dbdw, db = torch.split(dw[: sum(sizes)], sizes)
    dw_, ddw = dw_.view(c, 3 * c), ddw.view(9, 3 * c)
    g = dict(wqk=dw_[:, : 2 * c], wv=dw_[:, 2 * c :], dwqk=ddw[:, : 2 * c], dwv=ddw[:, 2 * c :],
             bqk=db[: 2 * c], bv=db[2 * c :], bdwqk=dbdw[: 2 * c], bdwv=dbdw[2 * c :])
    return dx, g


bwd2.launches = 0


def fused_block_backward(
    x: torch.Tensor,
    dy: torch.Tensor,
    w: BlockWeights,
    residuals: Sequence[torch.Tensor],
    num_heads: int,
) -> Tuple[torch.Tensor, Grads]:
    """B1 -> finalize backward -> B2 (kernels on CUDA, twins on the CPU):
    -> (dx in x's dtype, grads of every BlockWeights field, fp32)."""
    gram, qss, kss, apply = residuals
    dx2, d_apply, g1 = bwd1(x, dy, apply, w)
    d_gram, d_qss, d_kss, d_temp, d_wproj = finalize_backward(
        gram, qss, kss, w.temperature, w.wproj, d_apply, num_heads)
    dx, g2 = bwd2(x, dx2, apply, d_gram, d_qss, d_kss, w)
    return dx, {**g1, **g2, "temperature": d_temp, "wproj": d_wproj}


class FusedTransformerBlockFn(torch.autograd.Function):
    """One TransformerBlock, forward K2 -> finalize -> K3 or K3P, backward B1
    -> finalize backward -> B2. Inputs: x [B,H,W,C], num_heads, apply_kernel
    ("tiled" or "pipelined", see ``select_apply_pass``), then the
    ``BlockWeights`` tensors in field order. On CUDA the kernels compute in
    bf16 whatever x's dtype; on the CPU the fp32 twins run."""

    @staticmethod
    def forward(ctx, x, num_heads, apply_kernel, *tensors):
        apply_fn = select_apply_pass(x.shape[-1], apply_kernel)
        w = BlockWeights(*tensors)
        xk = x.to(torch.bfloat16).contiguous() if x.is_cuda else x
        gram, qss, kss = gram_pass(xk, w)
        apply = finalize_attention(gram, qss, kss, w.temperature, w.wproj, num_heads)
        y = apply_fn(xk, apply, w)
        ctx.save_for_backward(xk, gram, qss, kss, apply, *tensors)
        ctx.num_heads, ctx.x_dtype = num_heads, x.dtype
        return y.to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        xk, gram, qss, kss, apply, *tensors = ctx.saved_tensors
        w = BlockWeights(*tensors)
        dx, g = fused_block_backward(xk, dy, w, (gram, qss, kss, apply), ctx.num_heads)
        return (dx.to(ctx.x_dtype), None, None,
                *(g[f.name].to(t.dtype) for f, t in zip(dataclasses.fields(w), tensors)))
