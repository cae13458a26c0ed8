"""Restormer-style transposed (channel) attention.

Port of ``bayer_low_light_image_enhancement_tpu/ops/attention.py``.
Attention runs over the channel axis: q, k, v are split head-major
(``'b (head c) h w'``), q and k are L2-normalised along the tokens, and the
map ``q @ k^T`` is only [c, c] per head. The normalisation is taken out of
the gram: ``normalize(q) @ normalize(k)^T == (q @ k^T) / (|q_i| |k_j|)``
with torch ``F.normalize``'s ``max(|x|, 1e-12)``. Token reductions run in
fp32 whatever the compute dtype (fp64 for fp64 inputs).

This is the plain reference for the attention half of the fused block
(``kernels/fused_block.py``).
"""

from __future__ import annotations

import torch

from bayer_low_light_image_enhancement_tpu_torch.core.precision import wide


def channel_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    temperature: torch.Tensor,
    num_heads: int,
) -> torch.Tensor:
    """q, k, v: [B, H, W, C] (after the qkv and depthwise convs) -> [B, H, W, C].

    ``temperature``: per-head scale, any shape with ``num_heads`` elements.
    """
    b, h, w, c = q.shape
    ch = c // num_heads
    n = h * w

    def heads_first(t):
        # [B,H,W,C] -> [B, heads, c_per_head, N], head-major channel split.
        return t.reshape(b, n, num_heads, ch).permute(0, 2, 3, 1)

    qf = wide(heads_first(q))
    kf = wide(heads_first(k))
    vh = heads_first(v)

    gram = qf @ kf.transpose(-1, -2)  # [B, heads, c, c]
    q_inv = 1.0 / torch.sqrt((qf * qf).sum(-1)).clamp_min(1e-12)
    k_inv = 1.0 / torch.sqrt((kf * kf).sum(-1)).clamp_min(1e-12)
    attn = gram * q_inv[..., :, None] * k_inv[..., None, :]
    attn = attn * temperature.reshape(1, num_heads, 1, 1).to(qf.dtype)
    attn = torch.softmax(attn, dim=-1)

    out = (attn.to(vh.dtype) @ vh).to(v.dtype)  # [B, heads, c, N]
    return out.permute(0, 3, 1, 2).reshape(b, h, w, c)
