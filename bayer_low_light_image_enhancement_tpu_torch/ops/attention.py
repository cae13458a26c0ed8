"""Restormer-style transposed (channel) attention.

Port of ``bayer_low_light_image_enhancement_tpu/ops/attention.py``.
Attention runs over the channel axis: q, k, v are split head-major
(``'b (head c) h w'``), q and k are L2-normalised along the tokens, and the
map ``q @ k^T`` is only [c, c] per head. The normalisation is taken out of
the gram: ``normalize(q) @ normalize(k)^T == (q @ k^T) / (|q_i| |k_j|)``
with torch ``F.normalize``'s ``max(|x|, 1e-12)``. Token reductions run in
fp32 whatever the compute dtype (fp64 for fp64 inputs). An image of more
than ``ROW_SUM_TOKENS`` tokens sums each image row's tokens first, then the
rows: one fp32 product over a full frame's millions of tokens accumulates
rounding that every output pixel shares (on a 2832x4240 frame's first
stage, up to 8.5e-5 against an fp64 gram on an H100; 7.8e-8 by rows), and a
row's partial is the same on every spatial layout (below), so sharded and
monolithic sums differ only in how the row partials are added. Crop-sized
images keep the single product.

Spatial sharding: the gram and both sums of squares are reductions over
every token of the image, so on a spatially sharded rank they are local
partials, summed (one all-reduce of the three, in fp32) over the sharded
axes' groups before the normalisation and the softmax; ``attn @ v`` is then
local.

This is the plain reference for the attention half of the fused block
(``kernels/fused_block.py``).
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from bayer_low_light_image_enhancement_tpu_torch.core.precision import wide
from bayer_low_light_image_enhancement_tpu_torch.ops.conv import reduce_axis_names


ROW_SUM_TOKENS = 1 << 17  # the most tokens an image sums in one product


def channel_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    temperature: torch.Tensor,
    num_heads: int,
    spatial_axis=None,
    bands: int = 1,
) -> torch.Tensor:
    """q, k, v: [B, H, W, C] (after the qkv and depthwise convs) -> [B, H, W, C].

    ``temperature``: per-head scale, any shape with ``num_heads`` elements.
    ``spatial_axis``: the bound spatial axes of a sharded rank
    (``ops/conv.spatial_axes``), whose groups the token sums cross.
    ``bands``: band mode (``models/fused_apply.py``): the batch holds each
    frame as ``bands`` H-bands, batch-major per frame, and the token sums
    cross a frame's bands (the frame's token count picks the row sums).
    """
    b, h, w, c = q.shape
    ch = c // num_heads
    n = h * w

    def heads_first(t):
        # [B,H,W,C] -> [B, heads, c_per_head, N], head-major channel split.
        return t.reshape(b, n, num_heads, ch).permute(0, 2, 3, 1)

    def rows(t):
        # [B,H,W,C] -> [B, heads, H, c_per_head, W]: each image row's tokens.
        return wide(t.reshape(b, h, w, num_heads, ch).permute(0, 3, 1, 4, 2))

    vh = heads_first(v)
    axes = reduce_axis_names(spatial_axis, (1, 2))
    if n * bands * math.prod(ax.size for ax in axes) > ROW_SUM_TOKENS:
        qr, kr = rows(q), rows(k)
        gram = (qr @ kr.transpose(-1, -2)).sum(2)  # [B, heads, c, c]
        q_ss, k_ss = (qr * qr).sum(-1).sum(2), (kr * kr).sum(-1).sum(2)
    else:
        qf, kf = wide(heads_first(q)), wide(heads_first(k))
        gram = qf @ kf.transpose(-1, -2)  # [B, heads, c, c]
        q_ss, k_ss = (qf * qf).sum(-1), (kf * kf).sum(-1)
    if axes:
        sums = torch.cat([gram.flatten(), q_ss.flatten(), k_ss.flatten()])
        for ax in axes:
            dist.all_reduce(sums, group=ax.group)
        gram, q_ss, k_ss = (t.view_as(r) for t, r in zip(
            sums.split([gram.numel(), q_ss.numel(), k_ss.numel()]), (gram, q_ss, k_ss)))
    if bands > 1:
        gram, q_ss, k_ss = (
            t.reshape(b // bands, bands, *t.shape[1:]).sum(1).repeat_interleave(bands, 0)
            for t in (gram, q_ss, k_ss))
    q_inv = 1.0 / torch.sqrt(q_ss).clamp_min(1e-12)
    k_inv = 1.0 / torch.sqrt(k_ss).clamp_min(1e-12)
    attn = gram * q_inv[..., :, None] * k_inv[..., None, :]
    attn = attn * temperature.reshape(1, num_heads, 1, 1).to(gram.dtype)
    attn = torch.softmax(attn, dim=-1)

    out = (attn.to(vh.dtype) @ vh).to(v.dtype)  # [B, heads, c, N]
    return out.permute(0, 3, 1, 2).reshape(b, h, w, c)
