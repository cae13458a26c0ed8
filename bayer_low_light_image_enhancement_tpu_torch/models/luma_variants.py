"""Luma-MHSA RawFormer: token self-attention guided by luminance.

Port of the luminance-aware MHSA half of
``bayer_low_light_image_enhancement_tpu/models/luma_variants.py``: a
RawFormer-shaped U-Net whose blocks are *token* self-attention (over pixel
tokens, not channels) with luma FiLM conditioning (gamma / beta from a
conv net over pooled luma) and a centred inverse-luma query bias scaled by
a learned ``alpha``. The luma comes from 3x3 CFA extraction convs over the
full mosaic, min-max normalised per image, and is average-pooled to every
stage's resolution. The decoder's ``proj2`` / ``proj3`` take the
consistent concat widths dim*4 / dim*2 (the reference declares dim*6 /
dim*3, which its own forward cannot reach).

Token attention holds [B, heads, N, N] scores, N the stage's pixel count:
at a 512x512 input the first stage's N is 65536. ``LuminanceAwareMHSA``
computes them in chunks of query rows, at most ``chunk_bytes`` of fp32
scores a chunk (each row's softmax is complete within the row, so the
result is the same function); with grad enabled each chunk is recomputed
in backward (``torch.utils.checkpoint``), so the scores are never all
kept. ``chunk_bytes = None`` computes them whole. The products are plain
fp32 matmuls as in the JAX package; no hand kernel runs in this model.

Contract: input [B, 1, H, W] RAW mosaic, H and W divisible by 16, output
[B, 3, H, W] fp32, both NCHW; nothing is clamped inside the model.

``SimpleFLCAUNet``, the file's other model (raw-domain), is a conv U-Net
over packed planes [B, 4, H, W] -> [B, 4, H, W] (NCHW, H and W divisible
by 8) with a token transformer (``TokenTransformer``: flax's
``MultiHeadDotProductAttention`` on ``token_attention`` in the compute
dtype, in chunks) and an additive FLCA at every scale.

Spatially sharded inference (the configs' ``spatial_axis``;
``parallel/tiled.make_tiled_forward`` binds the axes to every module with
a ``spatial`` attribute): the token attentions are gather-kv, their
queries local and their keys / values gathered along every sharded axis
(attention does not depend on the order of the keys), so each rank's
scores cover the whole image's keys; the luma's min / max and the
inverse-luma mean cross the spatial groups; the convs, the 3x3 box of the
inverse luma and the 15-tap box split exchange halos (or gather the axis
where the halo exceeds the shard); the luma pools and ``max_pool2`` stay
local (a shard's H and W are multiples of 16 mosaic pixels, 8 packed).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
import torch.utils.checkpoint

from bayer_low_light_image_enhancement_tpu_torch.compat import jax_params
from bayer_low_light_image_enhancement_tpu_torch.models.common import (
    Conv2d,
    ConvFFN,
    Downsample,
    LayerNorm2d,
    Linear,
    Upsample2x,
    reset_parameters_,
)
from bayer_low_light_image_enhancement_tpu_torch.models.registry import register_model
from bayer_low_light_image_enhancement_tpu_torch.ops.conv import (
    conv2d,
    conv2d_nchw,
    gather_spatial,
    global_max,
    global_mean,
    global_min,
)
from bayer_low_light_image_enhancement_tpu_torch.ops.flca import (
    frequency_split,
    nchw,
    nhwc,
    resize_bilinear,
)
from bayer_low_light_image_enhancement_tpu_torch.ops.luma import BT601, bayer_luma_chroma

# fp32 scores of one chunk of query rows, at most (see the module doc).
ATTN_CHUNK_BYTES = 1 << 30

# 3x3 CFA extraction taps per pattern: positions of the nonzero weights in
# the 3x3 kernel for each of r / g / b.
_CFA_TAPS = {
    "rggb": {"r": [((0, 0), 1.0)], "g": [((0, 1), 0.5), ((1, 0), 0.5)], "b": [((1, 1), 1.0)]},
    "bggr": {"b": [((0, 0), 1.0)], "g": [((0, 1), 0.5), ((1, 0), 0.5)], "r": [((1, 1), 1.0)]},
    "grbg": {"g": [((0, 0), 0.5), ((1, 1), 0.5)], "r": [((0, 1), 1.0)], "b": [((1, 0), 1.0)]},
    "gbrg": {"g": [((0, 0), 0.5), ((1, 1), 0.5)], "b": [((0, 1), 1.0)], "r": [((1, 0), 1.0)]},
}


def bayer_luma_cfa(mosaic: torch.Tensor, pattern: str = "rggb",
                   spatial_axis=None) -> torch.Tensor:
    """[B, 1, H, W] mosaic -> [B, 1, H, W] fp32 luma: a 3x3 CFA conv (stride
    1, zero padding 1) to r, g, b, their BT.601 sum, min-max normalised per
    image (over the spatial groups of a bound ``spatial_axis``). As in the
    reference the taps are the same at every pixel, whatever its CFA
    phase."""
    taps = _CFA_TAPS[pattern.lower()]
    kernel = torch.zeros(3, 3, 1, 3)  # HWIO
    for ci, ch in enumerate("rgb"):
        for (i, j), wgt in taps[ch]:
            kernel[i, j, 0, ci] = wgt
    rgb = conv2d(mosaic.float().permute(0, 2, 3, 1), kernel.to(mosaic.device),
                 spatial_axis=spatial_axis)
    luma = (rgb * torch.tensor(BT601, device=mosaic.device)).sum(-1, keepdim=True)
    lo = global_min(luma, (1, 2, 3), spatial_axis)
    hi = global_max(luma, (1, 2, 3), spatial_axis)
    return ((luma - lo) / (hi - lo + 1e-6)).permute(0, 3, 1, 2)


def avg_pool(x: torch.Tensor, k: int) -> torch.Tensor:
    """Non-overlapping k x k mean of NCHW x, computed in fp32, in x's dtype."""
    return F.avg_pool2d(x.float(), k, k).to(x.dtype)


class LumaCond(nn.Module):
    """FiLM gamma / beta [B, inner, H, W] from luma [B, 1, H, W]: two 3x3
    convs + ReLU (``net.0`` / ``net.2``), then 1x1 ``gamma`` and ``beta``."""

    def __init__(self, inner: int, *, device=None, dtype=torch.float32,
                 compute_dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype, compute_dtype=compute_dtype)
        hidden = max(16, inner // 2)
        self.net = nn.Sequential(Conv2d(1, hidden, 3, **kw), nn.ReLU(),
                                 Conv2d(hidden, hidden, 3, **kw), nn.ReLU())
        self.gamma = Conv2d(hidden, inner, 1, **kw)
        self.beta = Conv2d(hidden, inner, 1, **kw)

    def forward(self, luma: torch.Tensor):
        h = self.net(luma)
        return self.gamma(h), self.beta(h)


def token_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    chunk_bytes: Optional[int], fp32_scores: bool = True) -> torch.Tensor:
    """softmax(q k^T / sqrt(dh)) v over [B, heads, N, dh] queries and [B,
    heads, M, dh] keys / values (M = N but on a gather-kv rank) -> q's
    shape in v's dtype. Query rows go in chunks of at most ``chunk_bytes``
    of scores (a chunk's rows are M long; None: one chunk), each
    recomputed in backward when grad is
    enabled; the chunks take k and v in fp32 and cast them for their
    products, so that their gradients sum over the chunks in fp32 (a bf16
    sum over hundreds of chunks would lose the gradient's low bits that one
    product keeps). ``torch.softmax`` subtracts each row's max, and its
    gradient is that of the JAX package's softmax with the max under
    ``stop_gradient`` (a shift of a row does not change its softmax).

    ``fp32_scores=True`` (the luma MHSA): q is scaled in fp32 before its
    product (one rounding apart from scaling the scores), the scores and
    the softmax are fp32, the softmax is cast to v's dtype for the product
    with v. ``fp32_scores=False`` is flax 0.12.3's
    ``dot_product_attention`` (``MultiHeadDotProductAttention``'s default,
    ``force_fp32_for_softmax`` False) in the compute dtype, q's: q is
    divided by sqrt(dh) rounded to that dtype (``jnp.sqrt(depth).astype``),
    the scores come out of the product in it, the softmax takes and gives
    it (``jax.nn.softmax(w).astype(dtype)``), and the product with v is in
    it too."""
    b, heads, n, dh = q.shape
    ft = torch.promote_types(q.dtype, torch.float32)  # fp32 (fp64 for fp64 inputs)
    if fp32_scores:
        st = ft
        qs = q.to(ft) * dh ** -0.5
    else:
        st = q.dtype
        qs = q / torch.tensor(math.sqrt(dh), dtype=torch.float64).to(st)
    kt, vf = k.to(ft).transpose(-1, -2).contiguous(), v.to(ft).contiguous()

    def rows(qc, kt, vf):
        return torch.softmax(qc @ kt.to(st), dim=-1).to(v.dtype) @ vf.to(v.dtype)

    if chunk_bytes is None:
        return rows(qs, kt, vf)
    step = max(1, chunk_bytes // (b * heads * k.shape[2] * qs.element_size()))
    recompute = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    parts = []
    for i in range(0, n, step):
        qc = qs[:, :, i:i + step]
        parts.append(torch.utils.checkpoint.checkpoint(rows, qc, kt, vf, use_reentrant=False)
                     if recompute else rows(qc, kt, vf))
    return torch.cat(parts, dim=2)


class LuminanceAwareMHSA(nn.Module):
    """Token MHSA with luma FiLM on q, k and v and the centred inverse-luma
    query bias ``alpha * (box3x3(1 - luma) - mean)``; ``chunk_bytes``: see
    ``token_attention``. Bound (``spatial``), gather-kv: k and v are
    gathered along the sharded axes, the bias mean crosses the spatial
    groups and the box exchanges halos."""

    spatial = None

    def __init__(self, dim: int, num_heads: int = 8, *, device=None, dtype=torch.float32,
                 compute_dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype, compute_dtype=compute_dtype)
        self.num_heads, self.dh = num_heads, dim // num_heads
        inner = num_heads * self.dh
        self.to_qkv = Conv2d(dim, inner * 3, 1, **kw)
        self.luma_cond = LumaCond(inner, **kw)
        self.alpha = nn.Parameter(torch.zeros((), device=device, dtype=dtype))
        self.proj = Conv2d(inner, dim, 1, **kw)
        self.chunk_bytes = ATTN_CHUNK_BYTES

    def forward(self, x: torch.Tensor, luma: torch.Tensor) -> torch.Tensor:
        b, _, h, w = x.shape
        n, heads, dh = h * w, self.num_heads, self.dh

        def tokens(t):  # NCHW (channels_last) -> [B, heads, N, dh]
            return t.permute(0, 2, 3, 1).reshape(b, n, heads, dh).transpose(1, 2)

        q, k, v = (tokens(t) for t in self.to_qkv(x).chunk(3, dim=1))
        g, bta = (tokens(t) for t in self.luma_cond(luma))
        q, k, v = g * q + bta, g * k + bta, g * v + bta

        sp = self.spatial
        inv = 1.0 - luma
        box = torch.full((1, 1, 3, 3), 1.0 / 9.0, device=x.device)
        inv = conv2d_nchw(inv.float(), box, spatial_axis=sp).to(inv.dtype)
        inv = (inv - global_mean(inv, (1, 2, 3), sp, nchw=True)).reshape(b, n)
        q = q + self.alpha.to(q.dtype) * inv[:, None, :, None]
        k, v = gather_spatial(k, sp, 2), gather_spatial(v, sp, 2)

        out = token_attention(q, k, v, self.chunk_bytes)  # [B, heads, N, dh]
        out = out.transpose(1, 2).reshape(b, h, w, heads * dh).permute(0, 3, 1, 2)
        return self.proj(out)


class LumaMHSABlock(nn.Module):
    """Pre-LN residual block: ``x + attn(norm1(x), luma)`` then
    ``+ ffn(norm2(.))``."""

    def __init__(self, dim: int, num_heads: int = 8, ffn_expansion: int = 2,
                 *, device=None, dtype=torch.float32, compute_dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype, compute_dtype=compute_dtype)
        self.compute_dtype = compute_dtype
        self.norm1 = LayerNorm2d(dim, device=device, dtype=dtype)
        self.attn = LuminanceAwareMHSA(dim, num_heads, **kw)
        self.norm2 = LayerNorm2d(dim, device=device, dtype=dtype)
        self.ffn = ConvFFN(dim, dim * ffn_expansion, **kw)

    def forward(self, x: torch.Tensor, luma: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        x = x + self.attn(self.norm1(x).to(cd), luma)
        return x + self.ffn(self.norm2(x).to(cd))


@dataclasses.dataclass(frozen=True)
class LumaMHSAConfig:
    inp_channels: int = 1
    out_channels: int = 3
    dim: int = 48
    num_heads: Tuple[int, int, int, int] = (8, 8, 8, 8)
    ffn_expansion: int = 2
    bayer_pattern: str = "rggb"
    dtype: torch.dtype = torch.float32        # compute
    param_dtype: torch.dtype = torch.float32  # storage
    # Mesh axes of spatially sharded inference (parallel/tiled.py): None,
    # the H axis name, or an (h, w) pair of names.
    spatial_axis: Optional[object] = None


class LumaMHSARawFormer(nn.Module):
    state_dict_from_jax = staticmethod(jax_params.luma_mhsa_state_dict_from_jax)
    spatial = None  # the bound axes of a sharded rank (the luma's min / max)

    def __init__(self, config: LumaMHSAConfig = LumaMHSAConfig(), device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.config = cfg = config
        kw = dict(device=device, dtype=cfg.param_dtype, compute_dtype=cfg.dtype)
        d, h = cfg.dim, cfg.num_heads

        def block(dim, heads):
            return LumaMHSABlock(dim, heads, cfg.ffn_expansion, **kw)

        self.embedding = Conv2d(cfg.inp_channels * 4, d, 3, **kw)
        self.enc1, self.down1 = block(d, h[0]), Downsample(d, **kw)
        self.enc2, self.down2 = block(d * 2, h[1]), Downsample(d * 2, **kw)
        self.enc3, self.down3 = block(d * 4, h[2]), Downsample(d * 4, **kw)
        self.bottleneck = block(d * 8, h[3])
        self.up1, self.proj1 = Upsample2x(d * 8, d * 4, **kw), Conv2d(d * 8, d * 4, 1, **kw)
        self.dec1 = block(d * 4, h[2])
        self.up2, self.proj2 = Upsample2x(d * 4, d * 2, **kw), Conv2d(d * 4, d * 2, 1, **kw)
        self.dec2 = block(d * 2, h[1])
        self.up3, self.proj3 = Upsample2x(d * 2, d, **kw), Conv2d(d * 2, d, 1, **kw)
        self.dec3 = block(d, h[0])
        self.output = nn.Sequential(Conv2d(d, cfg.out_channels * 4, 3, **kw))
        reset_parameters_(self, generator or torch.Generator().manual_seed(0))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.config.dtype
        luma = bayer_luma_cfa(x, self.config.bayer_pattern, self.spatial).to(cd)
        lumas = {s: avg_pool(luma, s) for s in (2, 4, 8, 16)}
        x = F.pixel_unshuffle(x.to(cd), 2).contiguous(memory_format=torch.channels_last)
        x1 = self.enc1(self.embedding(x), lumas[2])
        x2 = self.enc2(self.down1(x1), lumas[4])
        x3 = self.enc3(self.down2(x2), lumas[8])
        xb = self.bottleneck(self.down3(x3), lumas[16])
        y = self.dec1(self.proj1(torch.cat([self.up1(xb), x3], 1)), lumas[8])
        y = self.dec2(self.proj2(torch.cat([self.up2(y), x2], 1)), lumas[4])
        y = self.dec3(self.proj3(torch.cat([self.up3(y), x1], 1)), lumas[2])
        return F.pixel_shuffle(self.output(y), 2).float()


def _build(device=None, generator: Optional[torch.Generator] = None, **kw) -> LumaMHSARawFormer:
    return LumaMHSARawFormer(LumaMHSAConfig(**kw), device=device, generator=generator)


register_model("luma_mhsa_rawformer", _build)


# ---------------------------------------------------------------------------
# The flax token attention and the simple FLCA U-Net (raw-domain).
# ---------------------------------------------------------------------------


class TokenMHA(nn.Module):
    """flax ``nn.MultiHeadDotProductAttention(num_heads, qkv_features=dim)``
    over [B, N, C] tokens, held as torch ``nn.MultiheadAttention``'s
    parameters, the reference's names: ``in_proj_weight`` [3C, C] (rows
    q | k | v), ``in_proj_bias``, ``out_proj``. The heads split the
    projected channels head-major, as flax's (heads, head_dim) features
    do. Computes in ``compute_dtype``; the attention is ``token_attention``
    with flax's dtypes (``fp32_scores=False``) in chunks of at most
    ``chunk_bytes`` of scores. ``forward(t, kv)`` projects q from ``t`` and
    k / v from ``kv`` (flax's ``attn(inputs_q, inputs_kv)``, gather-kv on
    a sharded rank); ``kv`` None is ``t``."""

    def __init__(self, dim: int, num_heads: int, *, device=None, dtype=torch.float32,
                 compute_dtype=torch.float32):
        super().__init__()
        self.num_heads, self.compute_dtype = num_heads, compute_dtype
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim, device=device, dtype=dtype))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * dim, device=device, dtype=dtype))
        self.out_proj = Linear(dim, dim, device=device, dtype=dtype, compute_dtype=compute_dtype)
        self.chunk_bytes = ATTN_CHUNK_BYTES

    def reset_parameters_from(self, generator: torch.Generator) -> None:
        """The q / k / v projections' U(+-1/sqrt(dim)), as a Linear's."""
        bound = self.in_proj_weight.shape[1] ** -0.5
        for p in (self.in_proj_weight, self.in_proj_bias):
            p.copy_(torch.empty(p.shape).uniform_(-bound, bound, generator=generator))

    def forward(self, t: torch.Tensor, kv: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, n, c = t.shape
        cd, heads = self.compute_dtype, self.num_heads
        w, bias = self.in_proj_weight.to(cd), self.in_proj_bias.to(cd)
        if kv is None:
            qkv = F.linear(t.to(cd), w, bias)
            q, k, v = qkv.reshape(b, n, 3, heads, c // heads).permute(2, 0, 3, 1, 4)
        else:
            q = F.linear(t.to(cd), w[:c], bias[:c]).reshape(b, n, heads, c // heads).transpose(1, 2)
            k, v = F.linear(kv.to(cd), w[c:], bias[c:]).reshape(
                b, kv.shape[1], 2, heads, c // heads).permute(2, 0, 3, 1, 4)
        out = token_attention(q, k, v, self.chunk_bytes, fp32_scores=False)
        return self.out_proj(out.transpose(1, 2).reshape(b, n, c))


class TokenTransformer(nn.Module):
    """Token MHSA + MLP over the pixels of NCHW x, pre-LN: ``t + s attn(ln1
    t)``, then ``+ s mlp(ln2 .)`` (LayerNorms in fp32, eps 1e-5; the MLP
    ``mlp.0`` -> exact GELU in fp32 -> ``mlp.2``, ``mlp_ratio`` x wide).
    The JAX package's three token blocks: ``SimpleTokenTransformer``
    (s = 1, ``norm1`` / ``norm2``), ``flca_unet.TokenTransformerBlock``
    (``residual_scale`` s = 0.2, ``norms=("ln1", "ln2")``) and
    ``lumachroma_transformer.LocalEnhanceTransformer`` (``local=True``: a
    3x3 depthwise conv of x -> GELU, ``local_enhance.0``, added after the
    attention). Bound (``spatial``), gather-kv: the attention's keys and
    values come from the normalised tokens gathered along the sharded
    axes, its queries from this rank's."""

    spatial = None

    def __init__(self, dim: int, num_heads: int = 4, mlp_ratio: float = 4.0,
                 residual_scale: float = 1.0, norms: Tuple[str, str] = ("norm1", "norm2"),
                 local: bool = False,
                 *, device=None, dtype=torch.float32, compute_dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype, compute_dtype=compute_dtype)
        self.norms, self.scale = norms, residual_scale
        setattr(self, norms[0], nn.LayerNorm(dim, eps=1e-5, device=device, dtype=dtype))
        self.attn = TokenMHA(dim, num_heads, **kw)
        setattr(self, norms[1], nn.LayerNorm(dim, eps=1e-5, device=device, dtype=dtype))
        hidden = int(dim * mlp_ratio)
        self.mlp = nn.Sequential(Linear(dim, hidden, **kw), nn.GELU(), Linear(hidden, dim, **kw))
        self.local_enhance = (nn.Sequential(Conv2d(dim, dim, 3, groups=dim, **kw), nn.GELU())
                              if local else None)
        self.compute_dtype = compute_dtype

    def _norm(self, i: int, t: torch.Tensor) -> torch.Tensor:
        ln = getattr(self, self.norms[i])
        return F.layer_norm(t.float(), ln.normalized_shape, ln.weight.float(), ln.bias.float(),
                            ln.eps).to(self.compute_dtype)

    def _scaled(self, a: torch.Tensor) -> torch.Tensor:
        return a if self.scale == 1.0 else a * self.scale

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        t = x.permute(0, 2, 3, 1).reshape(b, h * w, c)
        tn = self._norm(0, t)
        kv = None if self.spatial is None else gather_spatial(tn, self.spatial, 1)
        t = t + self._scaled(self.attn(tn, kv))
        if self.local_enhance is not None:
            loc = self.local_enhance[0](x)
            t = t + F.gelu(loc.float()).to(loc.dtype).permute(0, 2, 3, 1).reshape(b, h * w, c)
        m = self.mlp[0](self._norm(1, t))
        m = self.mlp[2](F.gelu(m.float()).to(m.dtype))
        t = t + self._scaled(m)
        return t.reshape(b, h, w, c).permute(0, 3, 1, 2)


def guidance_at(feat: torch.Tensor, y: torch.Tensor, cr: torch.Tensor, cb: torch.Tensor,
                spatial_axis=None):
    """The [B, 1, H, W] guidance planes bilinearly resized to ``feat``'s
    resolution (fp32 resize; the sharded one of ``ops/flca.py`` on a bound
    ``spatial_axis``) and cast to its dtype."""
    hf, wf = feat.shape[-2:]
    return tuple(nchw(resize_bilinear(nhwc(t), hf, wf, spatial_axis)).to(feat.dtype)
                 for t in (y, cr, cb))


class SimpleFLCA(nn.Module):
    """FLCA with a 15-tap box split, additive:
    ``feat (1 + sigmoid(low)) + feat tanh(high) + feat sigmoid(chroma)``,
    the three maps from 3x3 convs with bias (``low_attn.0``, ...), each
    activation in fp32; ``spatial``: the bound axes of a sharded rank."""

    spatial = None

    def __init__(self, c: int, *, device=None, dtype=torch.float32, compute_dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype, compute_dtype=compute_dtype)
        self.low_attn = nn.Sequential(Conv2d(1, c, 3, **kw))
        self.high_attn = nn.Sequential(Conv2d(1, c, 3, **kw))
        self.chroma_attn = nn.Sequential(Conv2d(2, c, 3, **kw))

    def forward(self, feat, y, cr, cb):
        y, cr, cb = guidance_at(feat, y, cr, cb, self.spatial)
        y_low, y_high = frequency_split(y, 15, self.spatial)
        low_a = torch.sigmoid(self.low_attn(y_low).float()).to(feat.dtype)
        high_a = torch.tanh(self.high_attn(y_high).float()).to(feat.dtype)
        chroma_a = torch.sigmoid(self.chroma_attn(torch.cat([cr, cb], 1)).float()).to(feat.dtype)
        return feat * (1.0 + low_a) + feat * high_a + feat * chroma_a


def conv_block(cin: int, cout: int, kw) -> nn.Sequential:
    """The reference's ``Sequential(conv3x3, ReLU, conv3x3, ReLU)``."""
    return nn.Sequential(Conv2d(cin, cout, 3, **kw), nn.ReLU(), Conv2d(cout, cout, 3, **kw),
                         nn.ReLU())


def max_pool2(x: torch.Tensor) -> torch.Tensor:
    """2 x 2 max pool, stride 2, VALID (an odd last row / column dropped)."""
    return F.max_pool2d(x, 2, 2)


@dataclasses.dataclass(frozen=True)
class SimpleFLCAUNetConfig:
    in_ch: int = 4
    out_ch: int = 4
    base_ch: int = 32
    heads: int = 4
    dtype: torch.dtype = torch.float32        # compute
    param_dtype: torch.dtype = torch.float32  # storage
    # Mesh axes of spatially sharded inference (parallel/tiled.py).
    spatial_axis: Optional[object] = None


class SimpleFLCAUNet(nn.Module):
    """Conv blocks and max pools over packed planes, a token transformer and
    a SimpleFLCA at every scale (full packed resolution included), the
    bottleneck at base * 4 (the JAX package's consistent width); luma not
    normalised. Input and output NCHW [B, 4, H, W] (H, W divisible by 8),
    fp32 out, no residual."""

    state_dict_from_jax = staticmethod(jax_params.simple_flca_unet_state_dict_from_jax)

    def __init__(self, config: SimpleFLCAUNetConfig = SimpleFLCAUNetConfig(), device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.config = cfg = config
        kw = dict(device=device, dtype=cfg.param_dtype, compute_dtype=cfg.dtype)
        c = cfg.base_ch
        widths = {1: c, 2: 2 * c, 3: 4 * c}
        for i, wd in widths.items():
            setattr(self, f"enc{i}", conv_block(cfg.in_ch if i == 1 else wd // 2, wd, kw))
            setattr(self, f"trans{i}", TokenTransformer(wd, cfg.heads, **kw))
            setattr(self, f"flca{i}", SimpleFLCA(wd, **kw))
        self.bottleneck = TokenTransformer(4 * c, cfg.heads, **kw)
        self.flca_bottleneck = SimpleFLCA(4 * c, **kw)
        for i, wd in widths.items():
            setattr(self, f"up{i}", Upsample2x(4 * c if i == 3 else 2 * wd, wd, **kw))
            setattr(self, f"dec{i}", conv_block(2 * wd, wd, kw))
        self.final = Conv2d(c, cfg.out_ch, 1, **kw)
        reset_parameters_(self, generator or torch.Generator().manual_seed(0))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.config.dtype
        x = x.to(cd).contiguous(memory_format=torch.channels_last)
        guide = tuple(nchw(t).to(cd) for t in bayer_luma_chroma(nhwc(x).float(), normalize=False))
        e1 = self.flca1(self.trans1(self.enc1(x)), *guide)
        e2 = self.flca2(self.trans2(self.enc2(max_pool2(e1))), *guide)
        e3 = self.flca3(self.trans3(self.enc3(max_pool2(e2))), *guide)
        bneck = self.flca_bottleneck(self.bottleneck(max_pool2(e3)), *guide)
        d3 = self.dec3(torch.cat([self.up3(bneck), e3], 1))
        d2 = self.dec2(torch.cat([self.up2(d3), e2], 1))
        d1 = self.dec1(torch.cat([self.up1(d2), e1], 1))
        return self.final(d1).float()


def _build_simple(device=None, generator: Optional[torch.Generator] = None,
                  **kw) -> SimpleFLCAUNet:
    return SimpleFLCAUNet(SimpleFLCAUNetConfig(**kw), device=device, generator=generator)


register_model("simple_flca_unet", _build_simple, raw_domain=True)
