"""Fused TransformerBlock forward: LN + channel attention + ConvFFN (K2, K3).

Port of ``bayer_low_light_image_enhancement_tpu/kernels/fused_block.py``.
One block runs as

  1. ``gram_pass`` (K2): LN1 (affine folded into the 1x1) -> [q|k] 1x1 ->
     dw3x3 -> per image the gram ``q^T k`` over all pixels plus the sums of
     q^2 and k^2, in fp32;
  2. ``finalize_attention``: plain torch on [C, C] (XLA on the TPU too):
     F.normalize, temperature, per-head softmax, folded into the projection;
  3. ``apply_pass`` (K3): LN1 -> v -> ``y = x + v @ apply + b_proj`` -> LN2
     -> 1x1 -> dw3x3 -> exact GELU -> 1x1 -> + y (two kernels a call, y
     passed between them in a bf16 buffer); or, with
     ``apply_kernel="pipelined"``, ``apply_pass_pipelined`` (K3P, the port of
     the JAX package's v6 kernel): the same function, software-pipelined
     (``csrc/apply_pipelined.cuh``). K3P takes the power-of-two widths; the
     others keep K3, as the JAX package keeps its tiled kernel there.

Each pass has a plain PyTorch twin (``*_plain``) computing the same function
in fp32. The wrappers call the passes' ``torch.library`` operators
(``torch.ops.blle.gram_pass``, ``apply_pass``, ``apply_pass_pipelined``;
``kernels/ops.py``), so that ``torch.export`` keeps them in its graph: on a
CPU tensor the operator runs the twin; on a CUDA tensor it launches the
kernel (``csrc/fused_block.cu``) or raises. The pass wrappers are not
differentiable themselves: ``fused_transformer_block`` with grad
enabled goes through ``fused_block_bwd.FusedTransformerBlockFn``, whose
backward runs the kernels B1/B2 (``csrc/fused_block_bwd.cu``).

``tile_config`` / ``block_plan`` mirror the kernels' plans in
``csrc/block_tiles.cuh`` (tile shape, threads, shared memory, persistent
CTAs, launches; ``gram_workspace_floats``): the CPU tests check them at every
width, the card tests against the library's ``blle_block_kernel_info``.

``params`` is the state dict of ``models.common.TransformerBlock`` (the
reference's names: ``norm1.body.weight``, ``attn.qkv.weight``, ``attn.temperature``
or ``attn.log_temperature``, ...).

Band mode (``bands`` > 1, inference only; ``models/fused_apply.py``): x holds
each frame as ``bands`` H-bands riding the batch axis, batch-major per frame,
and the block computes the frame's block: the passes take each band with 2
halo rows a side from its neighbour bands (``ops.conv.band_halo``), the 1x1
outputs that feed a dw3x3 are zeroed outside the frame's ``frame_h`` rows,
the gram counts each frame pixel once, and the wrapper sums a frame's band
partials before one ``finalize_attention`` a frame (the JAX kernel's
``bands`` / ``frame_h``). ``gram_pass_banded`` (K2) and
``apply_pass_banded`` (K3, y written on the band's rows -1 .. hb so that its
second kernel finds its halo) go through ``torch.ops.blle.gram_pass_banded``
/ ``apply_pass_banded``; K3P's gate needs ``bands == 1``, so a pipelined
block runs K3 in band mode. K2 and K3 (band mode or not) also take the
WIDE_WIDTHS, RawFormer-B's and -L's bottleneck, so that band mode runs every
TransformerBlock of a RawFormer on the kernels, as the JAX package's band
mode does: there the operators run a chain of whole-call kernels
(``kernels/wide_block.py``: LayerNorm, wgmma GEMMs, depthwise passes and the
weight-grad pass for the gram) instead of the tile kernels; the other
kernels (K3P, B1/B2, A1, T1) stop at KERNEL_WIDTHS.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Mapping, Tuple

import torch
import torch.nn.functional as F

from bayer_low_light_image_enhancement_tpu_torch.kernels import _build, wide_block
from bayer_low_light_image_enhancement_tpu_torch.kernels.wide_block import WIDE_WIDTHS
from bayer_low_light_image_enhancement_tpu_torch.ops.conv import band_halo, conv2d

# Channel widths every fused-block kernel (K2, K3, B1/B2, A1, T1) is
# instantiated for: every RawFormer level with C <= 256 (S: 32..256, B:
# 48..192, L: 64..256).
KERNEL_WIDTHS = (32, 48, 64, 96, 128, 192, 256)
# K2 and K3 also take RawFormer-B's and -L's bottleneck widths, WIDE_WIDTHS
# (``kernels/wide_block.py``), which band mode runs on them as the JAX
# package's band mode does; BLOCK_WIDTHS are K2's and K3's widths.
BLOCK_WIDTHS = KERNEL_WIDTHS + WIDE_WIDTHS

# The apply-pass kernels a block can select, and the widths K3P takes: the
# JAX package's v5/v6 gate as far as it means anything off the TPU (a
# power-of-two C, so 1/C folds exactly into the bf16 mean); its lane-packing
# and DMA conditions are TPU layout.
APPLY_KERNELS = ("tiled", "pipelined")
PIPELINED_WIDTHS = (32, 64, 128, 256)


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

    def gram_tensors(self):
        """The weights K2 reads, in ``GRAM_FIELDS`` order."""
        return [getattr(self, n) for n in GRAM_FIELDS]

    def apply_tensors(self):
        """The weights K3 and K3P read, in ``APPLY_FIELDS`` order."""
        return [getattr(self, n) for n in APPLY_FIELDS]


# The BlockWeights fields each pass reads: the arguments of its operator
# after x (and K3's apply), in this order.
GRAM_FIELDS = ("wqk", "bqk", "dwqk", "bdwqk")
APPLY_FIELDS = ("wv", "bv", "dwv", "bdwv", "bproj", "wp1", "bp1", "dwf", "bdwf", "wp2", "bp2")


def attention_temperature(params: Mapping[str, torch.Tensor], prefix: str = "") -> torch.Tensor:
    """The per-head temperature of a ChannelAttention's params (names under
    ``prefix``): ``temperature`` as stored, or ``exp(log_temperature)``,
    differentiable in either. Shape as stored ([heads, 1, 1])."""
    t = params.get(f"{prefix}temperature")
    return params[f"{prefix}log_temperature"].exp() if t is None else t


def fold_block_params(params: Mapping[str, torch.Tensor]) -> BlockWeights:
    """Fold the LN affines into the consuming 1x1 convs (exact in fp32):
    ``(xhat * w + b) @ W + bias == xhat @ (diag(w) W) + (b @ W + bias)``.
    A block with ``attn.log_temperature`` gets its exponential here, in
    torch, so that the block's autograd.Function carries the temperature's
    gradient on to ``log_temperature``."""
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
        temperature=attention_temperature(p, "attn.").reshape(-1),
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


def _frame_rows(b: int, rows: int, first: int, hb: int, bands: int, device) -> torch.Tensor:
    """[b, rows]: the frame row of row i of each band image whose row 0 is
    band row ``first`` (image j is band j % bands, hb rows a band)."""
    band = torch.arange(b, device=device) % bands
    return band[:, None] * hb + first + torch.arange(rows, device=device)[None, :]


def _frame_mask(b: int, rows: int, first: int, hb: int, bands: int, frame_h: int,
                device) -> torch.Tensor:
    """[b, rows, 1, 1] fp32: 1 where the row lies in the frame [0, frame_h)."""
    fr = _frame_rows(b, rows, first, hb, bands, device)
    return ((fr >= 0) & (fr < frame_h)).float()[:, :, None, None]


def _dw3x3_rows(z: torch.Tensor, taps: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Depthwise 3x3 on NHWC, unpadded along H (the rows are given), zero
    padding along W: [B, R, W, F] -> [B, R - 2, W, F]; taps [9, F]."""
    f = z.shape[-1]
    y = F.conv2d(z.permute(0, 3, 1, 2), taps.t().reshape(f, 1, 3, 3), bias, padding=(0, 1),
                 groups=f)
    return y.permute(0, 2, 3, 1)


def check_band_input(xh: torch.Tensor, bands: int, frame_h: int) -> int:
    """A band pass's x: [B, hb + 4, W, C] with 2 halo rows a side, B a
    multiple of ``bands`` and 1 <= frame_h <= bands * hb; returns hb."""
    if xh.dim() != 4 or xh.shape[1] < 5:
        raise ValueError(f"a band pass takes x [B, hb + 4, W, C] with hb >= 1, got "
                         f"{tuple(xh.shape)}")
    hb = xh.shape[1] - 4
    if bands < 1 or xh.shape[0] % bands:
        raise ValueError(f"batch {xh.shape[0]} not divisible by bands {bands}")
    if not 1 <= frame_h <= bands * hb:
        raise ValueError(f"frame_h {frame_h} outside [1, bands * hb = {bands * hb}]")
    return hb


def gram_pass_banded_plain(xh: torch.Tensor, w: BlockWeights, bands: int, frame_h: int
                           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Band mode's pass A: xh [B, hb + 4, W, C] (``band_halo(x, 2, bands)``)
    -> each band's partial (gram [B,C,C], sum q^2 [B,C], sum k^2 [B,C]) over
    its own rows inside the frame, fp32; a frame's bands sum to the frame's
    ``gram_pass_plain``."""
    b, _, _, c = xh.shape
    hb = check_band_input(xh, bands, frame_h)
    z = (_ln_hat(xh.float()) @ w.wqk + w.bqk) * _frame_mask(b, hb + 4, -2, hb, bands, frame_h,
                                                            xh.device)
    qk = _dw3x3_rows(z[:, 1: hb + 3], w.dwqk, w.bdwqk)
    qk = qk * _frame_mask(b, hb, 0, hb, bands, frame_h, xh.device)
    q, k = qk[..., :c], qk[..., c:]
    gram = torch.einsum("bhwc,bhwd->bcd", q, k)
    return gram, (q * q).sum((1, 2)), (k * k).sum((1, 2))


def apply_pass_banded_plain(xh: torch.Tensor, apply: torch.Tensor, w: BlockWeights, bands: int,
                            frame_h: int) -> torch.Tensor:
    """Band mode's pass B: xh [B, hb + 4, W, C], apply [B,C,C] (each band
    its frame's) -> the band's block output [B, hb, W, C] in xh's dtype
    (fp32 inside): y on the band's rows -1 .. hb, then the FFN at its own
    rows, each pre-dw 1x1 zeroed outside the frame."""
    b = xh.shape[0]
    hb = check_band_input(xh, bands, frame_h)
    xf = xh.float()
    v = (_ln_hat(xf) @ w.wv + w.bv) * _frame_mask(b, hb + 4, -2, hb, bands, frame_h, xh.device)
    v = _dw3x3_rows(v, w.dwv, w.bdwv)
    y = xf[:, 1: hb + 3] + torch.einsum("bhwc,bcd->bhwd", v, apply.float()) + w.bproj
    t = (_ln_hat(y) @ w.wp1 + w.bp1) * _frame_mask(b, hb + 2, -1, hb, bands, frame_h, xh.device)
    f = F.gelu(_dw3x3_rows(t, w.dwf, w.bdwf))
    return (y[:, 1: hb + 1] + f @ w.wp2 + w.bp2).to(xh.dtype)


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
# The kernels' plans (csrc/block_tiles.cuh)
# ----------------------------------------------------------------------------

# The block kernels at every width: K2, K3's two kernels (up to y, from y),
# A1's gram pass (K2 without LayerNorm) and A1's apply pass (K3's first
# kernel without LayerNorm, at its stage 2); then K3P ("pipe") at
# PIPELINED_WIDTHS. _INFO_KIND is each one's kind in blle_block_kernel_info.
BLOCK_KINDS = ("gram", "apply1", "apply2", "attn_gram", "attn_apply")
PIPE = "pipe"
_INFO_KIND = {"gram": 0, "apply1": 1, "apply2": 2, "attn_gram": 3, PIPE: 4, "attn_apply": 5}
SMEM_PER_SM, SMEM_PER_BLOCK = 233472, 232448  # bytes, one H100 SM / block


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _r16(n: int) -> int:
    return _cdiv(n, 16) * 16


def _a128(n: int) -> int:
    return _cdiv(n, 128) * 128


@dataclasses.dataclass(frozen=True)
class TileConfig:
    """One block kernel's shape at one width: own-pixel tile th x tw (plus a
    1-pixel halo), threads a CTA, dynamic shared memory bytes, and the gram's
    channel splits (K2 runs splits^2 channel blocks)."""

    th: int
    tw: int
    threads: int
    smem: int
    splits: int = 1


def tile_config(kind: str, c: int) -> TileConfig:
    """``GramCfg`` / ``Apply1Cfg`` / ``Apply2Cfg`` of block_tiles.cuh at width
    c (A1's two passes have K2's and K3 phase 1's): weights resident in
    shared memory at c <= 64, else streamed through two chunk slots; the
    depthwise taps and the biases resident; 256 threads where two CTAs fit
    an SM, else 512. "pipe" is ``PipeCfg`` of apply_pipelined.cuh
    (``_pipe_config``). The WIDE_WIDTHS have no tile kernel: their plan is
    ``wide_block.wide_plan``."""
    if kind == PIPE:
        return _pipe_config(c)
    if kind not in BLOCK_KINDS:
        raise ValueError(f"kind must be one of {BLOCK_KINDS + (PIPE,)}, got {kind!r}")
    if c not in KERNEL_WIDTHS:
        raise ValueError(f"no kernel for C={c}; widths: {KERNEL_WIDTHS}")
    res, splits, ldx = c <= 64, 1, c + 8
    if kind in ("gram", "attn_gram"):
        th, tw = 4 if c == 256 else 8, 16 if c in (32, 96) else 8
        splits = 2 if c >= 192 else 1
        n2 = 2 * c // splits
        nc = n2 if n2 <= 96 else 64
        p, rp = th * tw, _r16((th + 2) * (tw + 2))
        slot = _a128(c * ((n2 if res else nc) + 8) * 2)
        parts = [2 * _a128(rp * ldx * 2), slot if res else 2 * slot, _a128(rp * (nc + 8) * 4),
                 _a128(p * (n2 + 8) * 2), _a128(11 * n2 * 4)]
    elif kind in ("apply1", "attn_apply"):
        th, tw = 4 if c == 256 else 8, 16 if c <= 48 else 8
        nc = c if c <= 96 else 64
        p, rp = th * tw, _r16((th + 2) * (tw + 2))
        parts = [2 * _a128(rp * ldx * 2), 2 * _a128(c * ((c if res else nc) + 8) * 2),
                 _a128(rp * (nc + 8) * 4), _a128(p * ldx * 2), _a128(12 * c * 4)]
    else:
        th, tw, ch = 4 if c >= 192 else 8, 16 if c == 32 else 8, 2 * c
        nc = 32 if c == 32 else ch if ch <= 96 else 64
        kc = ch if res else 64
        p, rp = th * tw, _r16((th + 2) * (tw + 2))
        w1, w2 = _a128(c * ((ch if res else nc) + 8) * 2), _a128(kc * (c + 8) * 2)
        parts = [2 * _a128(rp * ldx * 2), w1 + w2 if res else 2 * max(w1, w2),
                 _a128(rp * (nc + 8) * 4), _a128(p * (ch + 8) * 2), _a128((11 * ch + c) * 4)]
    smem = sum(parts)
    threads = 256 if 2 * (smem + 1024) <= SMEM_PER_SM else 512
    return TileConfig(th, tw, threads, smem, splits)


def _pipe_config(c: int) -> TileConfig:
    """K3P's ``PipeCfg`` at width c in PIPELINED_WIDTHS: 512 threads (two
    groups of 8 warps, one a phase); tiles of 8 x 16, 8 x 8, 4 x 8, 4 x 4 at
    C = 32, 64, 128, 256; the window (2-pixel halo) in two buffers at C = 32,
    else one; weights resident at C <= 64, else each phase's streamed through
    two slots of 64-channel chunks (32 at C = 256); the taps in shared memory
    except at C = 256; two y slots of the 1-pixel ring."""
    if c not in PIPELINED_WIDTHS:
        raise ValueError(f"no K3P for C={c}; widths: {PIPELINED_WIDTHS}")
    th, tw, ch = (8 if c <= 64 else 4), {32: 16, 64: 8, 128: 8, 256: 4}[c], 2 * c
    res, kw, wins, taps = c <= 64, 32 if c == 256 else 64, 2 if c == 32 else 1, c != 256
    nc1, nc2 = (c, 64) if res else (kw, kw)
    r2p, r1p, p, ldx = _r16((th + 4) * (tw + 4)), _r16((th + 2) * (tw + 2)), th * tw, c + 8
    slot = max(_a128(c * (kw + 8) * 2), _a128(kw * ldx * 2))
    w1 = 2 * _a128(c * ldx * 2) if res else 2 * slot
    w2 = _a128(c * (ch + 8) * 2) + _a128(ch * ldx * 2) if res else 2 * slot
    parts = [wins * _a128(r2p * ldx * 2), _a128(r2p * (nc1 + 8) * 4), w1,
             _a128(((9 * c if taps else 0) + 3 * c) * 4), 2 * _a128(r1p * ldx * 2),
             _a128(p * ldx * 2), _a128(r1p * (nc2 + 8) * 4), _a128(p * (ch + 8) * 2), w2,
             _a128(((9 * ch if taps else 0) + 2 * ch + c) * 4)]
    return TileConfig(th, tw, 512, sum(parts))


@dataclasses.dataclass(frozen=True)
class BlockPlan:
    """A block kernel's launch at one shape: ``tiles`` per image, ``blocks``
    channel blocks (K2), ``ctas`` persistent CTAs (K2: per image and block;
    K3: over the whole call), ``launches`` kernels."""

    config: TileConfig
    tiles: int
    blocks: int
    ctas: int
    launches: int


def block_plan(kind: str, b: int, h: int, w: int, c: int, resident: int) -> BlockPlan:
    """The launch the C library makes for ``kind`` on x [b, h, w, c], given
    the CTAs the card holds at once (``resident``: the occupancy API's blocks
    per SM times the SMs). K2 spreads them over the b x splits^2 (image,
    block) pairs and adds its reduction launch; each K3 kernel and K3P take
    at most one CTA per tile of the call."""
    cfg = tile_config(kind, c)
    tiles = _cdiv(h, cfg.th) * _cdiv(w, cfg.tw)
    if kind in ("gram", "attn_gram"):
        blocks = cfg.splits ** 2
        return BlockPlan(cfg, tiles, blocks, max(1, min(tiles, resident // (b * blocks))), 2)
    return BlockPlan(cfg, tiles, 1, min(b * tiles, resident), 1)


def gram_workspace_floats(b: int, h: int, w: int, c: int, plan: BlockPlan) -> int:
    """K2's workspace: one partial [cb^2 + 2 cb] per CTA of each (image,
    channel block), cb = c / splits."""
    cb = c // plan.config.splits
    return b * plan.blocks * plan.ctas * (cb * cb + 2 * cb)


@functools.lru_cache(maxsize=None)
def kernel_info(kind: str, c: int) -> Tuple[int, int, int, int, int]:
    """The library's plan of ``kind`` at width c on the current card: (th,
    tw, threads, shared-memory bytes, blocks per SM)."""
    info = (ctypes.c_longlong * 5)()
    _build.check(_build.library().blle_block_kernel_info(_INFO_KIND[kind], c, info),
                 f"block kernel info ({kind}, C={c})")
    return tuple(info)


def resident_ctas(kind: str, c: int, device_index: int = 0) -> int:
    """CTAs of ``kind`` the card holds at once: blocks per SM x SMs."""
    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    return kernel_info(kind, c)[4] * sms


@functools.lru_cache(maxsize=1024)
def plan_for(kind: str, b: int, h: int, w: int, c: int, device_index: int) -> BlockPlan:
    """The plan the wrappers launch (``block_plan`` at the card's residency),
    cached per shape: the wrappers' host time counts at the deep levels."""
    return block_plan(kind, b, h, w, c, resident_ctas(kind, c, device_index))


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


def check_kernel_input(x: torch.Tensor, *grad_inputs: torch.Tensor,
                       widths: Tuple[int, ...] = KERNEL_WIDTHS) -> None:
    """What every kernel of the fused blocks (and A1, T1) takes: x [B,H,W,C]
    with C in ``widths`` (KERNEL_WIDTHS; K2 and K3 pass BLOCK_WIDTHS). A
    kernel wrapper is not differentiable: it raises when grad is enabled on
    x or ``grad_inputs`` and one requires grad."""
    if x.dim() != 4 or not 0 < x.shape[0] <= 65535 or x.shape[1] * x.shape[2] == 0:
        raise ValueError(f"x must be [B, H, W, C] with 1 <= B <= 65535, H, W > 0; "
                         f"got {tuple(x.shape)}")
    if x.shape[-1] not in widths:
        raise ValueError(f"no kernel for C={x.shape[-1]}; widths: {widths}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, *grad_inputs)):
        raise RuntimeError(
            "a fused-block kernel wrapper is not differentiable: train through "
            "fused_transformer_block (FusedTransformerBlockFn) or call under "
            "torch.no_grad()"
        )


def check_pass_input(x: torch.Tensor, *tensors: torch.Tensor,
                     widths: Tuple[int, ...] = KERNEL_WIDTHS) -> None:
    """``check_kernel_input`` over x and a pass's tensors, and x bf16,
    contiguous and 16-byte aligned."""
    check_kernel_input(x, *tensors, widths=widths)
    if x.dtype != torch.bfloat16:
        raise TypeError(f"x is {x.dtype}; the kernels take bfloat16")
    require(x, "x", x.shape, x.device)


def check_block_input(x: torch.Tensor, w: BlockWeights, *grad_inputs: torch.Tensor) -> None:
    """``check_pass_input`` over the whole block's weights, and FFN hidden
    width 2C."""
    if w.wp1.shape[1] != 2 * x.shape[-1]:
        raise ValueError(f"kernel needs FFN hidden width 2C, got {w.wp1.shape[1]}")
    check_pass_input(x, *grad_inputs, *w.tensors())


def bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).contiguous()


def f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32).contiguous()


def gram_pass(x: torch.Tensor, w: BlockWeights):
    """Pass A. x [B,H,W,C] -> (gram [B,C,C], qss [B,C], kss [B,C]), fp32,
    views of ``torch.ops.blle.gram_pass``'s one [B, C*C + 2C] output.

    CPU: the plain twin. CUDA: kernel K2 on bf16 x, or raise."""
    b, c = x.shape[0], x.shape[-1]
    out = torch.ops.blle.gram_pass(x, *w.gram_tensors())
    return out[:, : c * c].reshape(b, c, c), out[:, c * c : c * c + c], out[:, c * c + c :]


def _gram_args(c: int, device, *tensors: torch.Tensor):
    """K2's checked device weights from the ``GRAM_FIELDS`` tensors."""
    args = [bf16(tensors[0]), f32(tensors[1]), f32(tensors[2]), f32(tensors[3])]
    for t, n, s in zip(args, GRAM_FIELDS, ((c, 2 * c), (2 * c,), (9, 2 * c), (2 * c,))):
        require(t, n, s, device)
    return args


def _gram_pass_kernel(x: torch.Tensor, *tensors: torch.Tensor) -> torch.Tensor:
    """K2 on x and the ``GRAM_FIELDS`` tensors -> [B, C*C + 2C] fp32: each
    image's gram, then its sums of q^2 and of k^2."""
    check_pass_input(x, *tensors, widths=BLOCK_WIDTHS)
    b, h, wd, c = x.shape
    args = _gram_args(c, x.device, *tensors)
    if c in WIDE_WIDTHS:
        out = wide_block.gram_pass_wide(x, *args)
        gram_pass.launches += 1
        return out
    lib = _build.library()
    plan = plan_for("gram", b, h, wd, c, x.device.index or 0)
    ws = torch.empty(gram_workspace_floats(b, h, wd, c, plan), dtype=torch.float32,
                     device=x.device)
    out = torch.empty((b, c * c + 2 * c), dtype=torch.float32, device=x.device)
    err = lib.blle_gram_pass(
        x.data_ptr(), *(t.data_ptr() for t in args), ws.data_ptr(), out.data_ptr(),
        b, h, wd, c, plan.ctas, _build.stream_of(x),
    )
    _build.check(err, "fused_block gram pass")
    gram_pass.launches += 1
    return out


gram_pass.launches = 0


def apply_pass(x: torch.Tensor, apply: torch.Tensor, w: BlockWeights) -> torch.Tensor:
    """Pass B. x [B,H,W,C], apply [B,C,C] -> [B,H,W,C] in x's dtype.

    CPU: the plain twin. CUDA: kernel K3 on bf16 x (apply rounded to bf16),
    or raise. Through ``torch.ops.blle.apply_pass``."""
    return torch.ops.blle.apply_pass(x, apply, *w.apply_tensors())


def _apply_pass_args(x: torch.Tensor, apply: torch.Tensor, *tensors: torch.Tensor):
    """The checked device arguments of K3 / K3P after x, from apply and the
    ``APPLY_FIELDS`` tensors."""
    check_pass_input(x, apply, *tensors, widths=BLOCK_WIDTHS)
    b, h, wd, c = x.shape
    ch = 2 * c
    wv, bv, dwv, bdwv, bproj, wp1, bp1, dwf, bdwf, wp2, bp2 = tensors
    args = [
        bf16(apply), bf16(wv), f32(bv), f32(dwv), f32(bdwv), f32(bproj),
        bf16(wp1), f32(bp1), f32(dwf), f32(bdwf), bf16(wp2), f32(bp2),
    ]
    shapes = [(b, c, c), (c, c), (c,), (9, c), (c,), (c,),
              (c, ch), (ch,), (9, ch), (ch,), (ch, c), (c,)]
    for i, (t, s) in enumerate(zip(args, shapes)):
        require(t, f"apply-pass argument {i}", s, x.device)
    return args


def _apply_pass_kernel(x: torch.Tensor, apply: torch.Tensor,
                       *tensors: torch.Tensor) -> torch.Tensor:
    args = _apply_pass_args(x, apply, *tensors)
    if x.shape[-1] in WIDE_WIDTHS:
        out = wide_block.apply_pass_wide(x, *args)
        apply_pass.launches += 1
        return out
    ybuf, out = torch.empty_like(x), torch.empty_like(x)
    grids = [plan_for(k, *x.shape, x.device.index or 0).ctas for k in ("apply1", "apply2")]
    err = _build.library().blle_apply_pass(
        x.data_ptr(), *(t.data_ptr() for t in args), ybuf.data_ptr(), out.data_ptr(),
        *x.shape, *grids, _build.stream_of(x),
    )
    _build.check(err, "fused_block apply pass")
    apply_pass.launches += 1
    return out


apply_pass.launches = 0


def apply_pass_pipelined(x: torch.Tensor, apply: torch.Tensor, w: BlockWeights) -> torch.Tensor:
    """Pass B, software-pipelined: the function of ``apply_pass``.

    CPU: the plain twin (``apply_pass_plain``). CUDA: kernel K3P on bf16 x
    (apply rounded to bf16; y carried between its phases in bf16) for C in
    PIPELINED_WIDTHS, or raise. Through ``torch.ops.blle.apply_pass_pipelined``."""
    return torch.ops.blle.apply_pass_pipelined(x, apply, *w.apply_tensors())


def _apply_pass_pipelined_kernel(x: torch.Tensor, apply: torch.Tensor,
                                 *tensors: torch.Tensor) -> torch.Tensor:
    if x.dim() == 4 and x.shape[-1] not in PIPELINED_WIDTHS:
        raise ValueError(f"K3P takes C in {PIPELINED_WIDTHS}, got {x.shape[-1]}")
    args = _apply_pass_args(x, apply, *tensors)
    out = torch.empty_like(x)
    grid = plan_for(PIPE, *x.shape, x.device.index or 0).ctas
    err = _build.library().blle_apply_pipelined(
        x.data_ptr(), *(t.data_ptr() for t in args), out.data_ptr(),
        *x.shape, grid, _build.stream_of(x),
    )
    _build.check(err, "fused_block pipelined apply pass")
    apply_pass_pipelined.launches += 1
    return out


apply_pass_pipelined.launches = 0


def gram_pass_banded(xh: torch.Tensor, w: BlockWeights, bands: int, frame_h: int):
    """Band mode's pass A on xh [B, hb + 4, W, C] -> each band's partial
    (gram [B,C,C], qss [B,C], kss [B,C]), fp32, views of
    ``torch.ops.blle.gram_pass_banded``'s [B, C*C + 2C] output.

    CPU: the plain twin. CUDA: kernel K2 in band mode on bf16 xh, or raise."""
    b, c = xh.shape[0], xh.shape[-1]
    out = torch.ops.blle.gram_pass_banded(xh, *w.gram_tensors(), bands, frame_h)
    return out[:, : c * c].reshape(b, c, c), out[:, c * c: c * c + c], out[:, c * c + c:]


def _gram_pass_banded_kernel(xh: torch.Tensor, *args) -> torch.Tensor:
    """K2 in band mode on xh and the ``GRAM_FIELDS`` tensors, then bands
    and frame_h -> [B, C*C + 2C] fp32, each band's partial."""
    *tensors, bands, frame_h = args
    check_pass_input(xh, *tensors, widths=BLOCK_WIDTHS)
    hb = check_band_input(xh, bands, frame_h)
    b, _, wd, c = xh.shape
    wargs = _gram_args(c, xh.device, *tensors)
    if c in WIDE_WIDTHS:
        out = wide_block.gram_pass_wide(xh, *wargs, bands=bands, frame_h=frame_h)
        gram_pass_banded.launches += 1
        gram_pass_banded_wide.launches += 1
        return out
    plan = plan_for("gram", b, hb, wd, c, xh.device.index or 0)
    ws = torch.empty(gram_workspace_floats(b, hb, wd, c, plan), dtype=torch.float32,
                     device=xh.device)
    out = torch.empty((b, c * c + 2 * c), dtype=torch.float32, device=xh.device)
    err = _build.library().blle_gram_pass_banded(
        xh.data_ptr(), *(t.data_ptr() for t in wargs), ws.data_ptr(), out.data_ptr(),
        b, hb, wd, c, plan.ctas, bands, frame_h, _build.stream_of(xh),
    )
    _build.check(err, "fused_block gram pass (band mode)")
    gram_pass_banded.launches += 1
    return out


gram_pass_banded.launches = 0


def apply_pass_banded(xh: torch.Tensor, apply: torch.Tensor, w: BlockWeights, bands: int,
                      frame_h: int) -> torch.Tensor:
    """Band mode's pass B: xh [B, hb + 4, W, C], apply [B,C,C] -> [B, hb, W,
    C] in xh's dtype.

    CPU: the plain twin. CUDA: kernel K3 in band mode on bf16 xh (apply
    rounded to bf16), or raise. Through ``torch.ops.blle.apply_pass_banded``."""
    return torch.ops.blle.apply_pass_banded(xh, apply, *w.apply_tensors(), bands, frame_h)


def _apply_pass_banded_kernel(xh: torch.Tensor, apply: torch.Tensor, *args) -> torch.Tensor:
    *tensors, bands, frame_h = args
    wargs = _apply_pass_args(xh, apply, *tensors)
    hb = check_band_input(xh, bands, frame_h)
    b, _, wd, c = xh.shape
    if c in WIDE_WIDTHS:
        out = wide_block.apply_pass_wide(xh, *wargs, bands=bands, frame_h=frame_h)
        apply_pass_banded.launches += 1
        apply_pass_banded_wide.launches += 1
        return out
    ybuf = torch.empty((b, hb + 2, wd, c), dtype=xh.dtype, device=xh.device)
    out = torch.empty((b, hb, wd, c), dtype=xh.dtype, device=xh.device)
    dev = xh.device.index or 0
    grids = (plan_for("apply1", b, hb + 2, wd, c, dev).ctas,
             plan_for("apply2", b, hb, wd, c, dev).ctas)
    err = _build.library().blle_apply_pass_banded(
        xh.data_ptr(), *(t.data_ptr() for t in wargs), ybuf.data_ptr(), out.data_ptr(),
        b, hb, wd, c, *grids, bands, frame_h, _build.stream_of(xh),
    )
    _build.check(err, "fused_block apply pass (band mode)")
    apply_pass_banded.launches += 1
    return out


apply_pass_banded.launches = 0


class WideLaunches:
    """The launches a band-mode wrapper makes at the WIDE_WIDTHS, counted
    beside its own ``launches`` where it launches (the interface of a
    wrapper's count: ``__name__``, ``launches``), so that a run can show
    that B's and L's bottleneck went through the kernels."""

    def __init__(self, name: str):
        self.__name__, self.launches = name, 0


gram_pass_banded_wide = WideLaunches("gram_pass_banded_wide")
apply_pass_banded_wide = WideLaunches("apply_pass_banded_wide")


def check_apply_kernel(apply_kernel: str) -> None:
    if apply_kernel not in APPLY_KERNELS:
        raise ValueError(f"apply_kernel must be one of {APPLY_KERNELS}, got {apply_kernel!r}")


def select_apply_pass(c: int, apply_kernel: str):
    """The apply-pass wrapper a block of width c runs: K3P for "pipelined"
    at a width in PIPELINED_WIDTHS, K3 otherwise (the JAX package's gate)."""
    check_apply_kernel(apply_kernel)
    if apply_kernel == "pipelined" and c in PIPELINED_WIDTHS:
        return apply_pass_pipelined
    return apply_pass


def _banded_sums(t: torch.Tensor, bands: int) -> torch.Tensor:
    """Each frame's sum of its bands' partials (fp32)."""
    return t.reshape(t.shape[0] // bands, bands, *t.shape[1:]).sum(1)


def _banded_block(x: torch.Tensor, w: BlockWeights, num_heads: int, bands: int, frame_h,
                  gram_fn, apply_fn) -> torch.Tensor:
    """Band mode's block on x [B, hb, W, C] through the passes ``gram_fn`` /
    ``apply_fn`` (the kernels' wrappers or the twins): the halo'd bands, a
    frame's partials summed, one finalise a frame, its apply on each band."""
    fh = bands * x.shape[1] if frame_h is None else frame_h
    xh = band_halo(x, 2, bands)
    gram, qss, kss = (_banded_sums(t, bands) for t in gram_fn(xh, w, bands, fh))
    apply = finalize_attention(gram, qss, kss, w.temperature, w.wproj, num_heads)
    return apply_fn(xh, apply.repeat_interleave(bands, 0), w, bands, fh)


def fused_transformer_block(
    x: torch.Tensor, params: Mapping[str, torch.Tensor], num_heads: int,
    apply_kernel: str = "tiled", bands: int = 1, frame_h=None,
) -> torch.Tensor:
    """One TransformerBlock on x [B, H, W, C] -> [B, H, W, C] (x's dtype).

    On CUDA the kernels compute in bf16 whatever x's dtype (as the TPU
    kernel does); on the CPU the fp32 twins run. ``apply_kernel`` picks the
    apply pass (``select_apply_pass``): "tiled" (K3) or "pipelined" (K3P).
    With grad enabled on x or a parameter the block runs through
    ``FusedTransformerBlockFn`` (the same forward, B1/B2 backward);
    otherwise K2 and the apply pass are called directly.

    ``bands`` > 1: band mode (the module docstring), inference only: x holds
    B / bands frames of ``frame_h`` rows (default bands * H), band b % bands
    of each; K2 and K3 in band mode whatever ``apply_kernel``."""
    if bands != 1:
        check_apply_kernel(apply_kernel)
        w = fold_block_params(params)
        if torch.is_grad_enabled() and any(t.requires_grad for t in (x, *w.tensors())):
            raise RuntimeError("band streaming is an inference path: call the block under "
                               "torch.no_grad() or torch.inference_mode()")
        xk = x.to(torch.bfloat16).contiguous() if x.is_cuda else x.contiguous()
        return _banded_block(xk, w, num_heads, bands, frame_h, gram_pass_banded,
                             apply_pass_banded).to(x.dtype)
    apply_fn = select_apply_pass(x.shape[-1], apply_kernel)
    w = fold_block_params(params)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, *w.tensors())):
        # Imported here: fused_block_bwd imports this module.
        from bayer_low_light_image_enhancement_tpu_torch.kernels.fused_block_bwd import (
            FusedTransformerBlockFn,
        )

        return FusedTransformerBlockFn.apply(x, num_heads, apply_kernel, *w.tensors())
    xk = x.to(torch.bfloat16).contiguous() if x.is_cuda else x
    gram, qss, kss = gram_pass(xk, w)
    apply = finalize_attention(gram, qss, kss, w.temperature, w.wproj, num_heads)
    return apply_fn(xk, apply, w).to(x.dtype)


def fused_transformer_block_plain(
    x: torch.Tensor, params: Mapping[str, torch.Tensor], num_heads: int,
    apply_kernel: str = "tiled", bands: int = 1, frame_h=None,
) -> torch.Tensor:
    """The whole block through the twins, on any device (fp32 inside); every
    ``apply_kernel`` computes this same function. ``bands`` > 1: band mode
    through the band twins."""
    check_apply_kernel(apply_kernel)
    w = fold_block_params(params)
    if bands != 1:
        return _banded_block(x, w, num_heads, bands, frame_h, gram_pass_banded_plain,
                             apply_pass_banded_plain)
    gram, qss, kss = gram_pass_plain(x, w)
    apply = finalize_attention(gram, qss, kss, w.temperature, w.wproj, num_heads)
    return apply_pass_plain(x, apply, w)
