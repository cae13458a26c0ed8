"""NHWC convolution primitives with optional halo exchange across ranks.

Port of ``bayer_low_light_image_enhancement_tpu/ops/conv.py``: NHWC input,
HWIO kernel, torch ``padding=(eff_k-1)//2`` semantics (symmetric zero
padding, also for strided convs), and the global reductions
``global_mean``, ``global_max`` and ``global_min``.

Spatially sharded execution (full-resolution tiled inference,
``parallel/tiled.py``): each rank holds a contiguous block of rows (and of
columns on a 2-D mesh), and ``spatial_axis`` is the JAX package's spec with
bound axes in place of names: None, one ``core.mesh.BoundAxis`` (H), or an
(h, w) pair of them (either may be None). A stride-1 conv exchanges its
``(eff_k-1)//2`` boundary rows with the neighbouring ranks and runs
unpadded along the sharded axis; the image edges receive zeros, which is
the monolithic zero pad, so sharded and unsharded results agree in fp32.
The exchange follows the port's rule of collectives (``core/mesh.py``):
every rank writes its two edge strips into a zeroed
``[n_shards, 2, halo, ...]`` buffer, one all-reduce sums it (a sum of zeros
and one value is exact), and each rank reads its neighbours' strips. Global
reductions take their local partial and reduce it over the sharded axes'
groups. Everything here is inference: the collectives carry no grad.

Band mode, the single-card full-frame forward (``models/fused_apply.py``),
gives a conv its halo rows from the neighbouring bands of the same frame
instead (``band_halo``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from bayer_low_light_image_enhancement_tpu_torch.utils.profiling import span


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.2) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope)


def spatial_axes(spatial_axis) -> tuple:
    """Normalise a spatial-sharding spec to (h_axis, w_axis): None, one
    bound axis (H), or an (h_axis, w_axis) pair (either may be None)."""
    if spatial_axis is None:
        return None, None
    if isinstance(spatial_axis, (tuple, list)) and not hasattr(spatial_axis, "group"):
        h_ax = spatial_axis[0] if len(spatial_axis) > 0 else None
        w_ax = spatial_axis[1] if len(spatial_axis) > 1 else None
        return h_ax, w_ax
    return spatial_axis, None


def reduce_axis_names(spatial_axis, axes: Tuple[int, ...], nchw: bool = False) -> tuple:
    """The bound axes a reduction over tensor ``axes`` must also cross: H and
    W are dims 1 and 2 of NHWC, 2 and 3 of NCHW (``nchw``)."""
    h_ax, w_ax = spatial_axes(spatial_axis)
    h_dim, w_dim = (2, 3) if nchw else (1, 2)
    return tuple(a for a, d in ((h_ax, h_dim), (w_ax, w_dim)) if a is not None and d in axes)


def gather_axis(t: torch.Tensor, axis, dim: int) -> torch.Tensor:
    """Every rank's equal-sized block of ``t`` along ``dim``, concatenated
    in the axis' rank order, on every rank of ``axis`` (an all-reduce of a
    zeroed full tensor holding this rank's block in place)."""
    if axis is None:
        return t
    size = t.shape[dim]
    shape = list(t.shape)
    shape[dim] = size * axis.size
    full = t.new_zeros(shape)
    full.narrow(dim, axis.index * size, size).copy_(t)
    dist.all_reduce(full, group=axis.group)
    return full


def gather_spatial(t: torch.Tensor, spatial_axis, axis: int) -> torch.Tensor:
    """All-gather ``t`` along every sharded spatial axis, stacking into
    tensor dim ``axis`` (the token dim for gather-kv attention, which is
    permutation-invariant in keys)."""
    for ax in spatial_axes(spatial_axis):
        t = gather_axis(t, ax, axis)
    return t


def halo_pad(x: torch.Tensor, halo: int, spatial_axis, dim: int = 1) -> torch.Tensor:
    """Exchange ``halo`` boundary slices along tensor dim ``dim`` (rows
    are dim 1 of NHWC, 2 of NCHW) with the neighbouring ranks of bound axis
    ``spatial_axis``: returns x with the received strips stacked before and
    after it (zeros at the image edges). Needs ``halo`` <= x.shape[dim]."""
    if halo <= 0:
        return x
    n, i, size = spatial_axis.size, spatial_axis.index, x.shape[dim]
    strip = list(x.shape)
    strip[dim] = halo
    buf = x.new_zeros([n, 2] + strip)
    buf[i, 0].copy_(x.narrow(dim, 0, halo))
    buf[i, 1].copy_(x.narrow(dim, size - halo, halo))
    dist.all_reduce(buf, group=spatial_axis.group)
    # My top halo is the previous rank's bottom strip, my bottom halo the
    # next rank's top strip; the image edges get zeros.
    shape = list(x.shape)
    shape[dim] = size + 2 * halo
    out = torch.empty(shape, dtype=x.dtype, device=x.device, memory_format=_format_of(x))
    if i > 0:
        out.narrow(dim, 0, halo).copy_(buf[i - 1, 1])
    else:
        out.narrow(dim, 0, halo).zero_()
    out.narrow(dim, halo, size).copy_(x)
    if i < n - 1:
        out.narrow(dim, halo + size, halo).copy_(buf[i + 1, 0])
    else:
        out.narrow(dim, halo + size, halo).zero_()
    return out


def band_halo(x: torch.Tensor, r: int, bands: int, nchw: bool = False) -> torch.Tensor:
    """Band mode's halo (``models/fused_apply.py``): x holds each frame as
    ``bands`` H-bands riding the batch axis, batch-major per frame (image b
    is band b % bands of its frame), NHWC [B, hb, ...] or, with ``nchw``,
    channels-last NCHW [B, C, hb, W]. Returns each band with ``r`` rows a
    side from its neighbour bands and zeros at its frame's own top and
    bottom, the monolithic frame's zero pad: [B, hb + 2r, ...] (NCHW
    channels-last with ``nchw``); a halo deeper than a band (a deep level's
    bands can be one row tall) takes rows from the bands beyond. Each row
    is copied once. The JAX package's ``models/fused_apply._band_halo``.
    The copies run under the span ``lle.bands.halo``, once a call."""
    if nchw:
        return band_halo(x.permute(0, 2, 3, 1), r, bands).permute(0, 3, 1, 2)
    b, h, rest = x.shape[0], x.shape[1], tuple(x.shape[2:])
    if b % bands:
        raise ValueError(f"batch {b} not divisible by bands {bands}")
    with span("lle.bands.halo"):
        xb = x.reshape(b // bands, bands, h, *rest)
        out = x.new_empty((b // bands, bands, h + 2 * r) + rest)
        out[:, :, r: r + h] = xb
        for d in range(1, -(-r // h) + 1):
            # Halo rows from the band d away: the top's [lo, hi), the bottom's
            # [blo, bhi); the bands with none d away (all but n) get zeros.
            lo, hi = max(0, r - d * h), r - (d - 1) * h
            blo, bhi = r + d * h, min(r + (d + 1) * h, h + 2 * r)
            n = max(bands - d, 0)
            out[:, bands - n:, lo:hi] = xb[:, :n, h - (hi - lo):]
            out[:, :bands - n, lo:hi] = 0
            out[:, :n, blo:bhi] = xb[:, bands - n:, :bhi - blo]
            out[:, n:, blo:bhi] = 0
        return out.reshape(b, h + 2 * r, *rest)


def _format_of(x: torch.Tensor) -> torch.memory_format:
    """channels_last for a 4-D tensor held so (the port's activations),
    else the contiguous format."""
    cl = torch.channels_last
    if x.dim() == 4 and not x.is_contiguous() and x.is_contiguous(memory_format=cl):
        return cl
    return torch.contiguous_format


def conv2d_nchw(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
                stride: int = 1, groups: int = 1, dilation: int = 1,
                spatial_axis=None) -> torch.Tensor:
    """NCHW x OIHW conv with torch ``padding=(eff_k-1)//2`` semantics,
    ``eff_k = dilation*(k-1)+1``, in x's dtype.

    Along a sharded axis it exchanges the full ``(eff_k-1)//2`` halo, trims
    it to the (pt, pb) rows the local outputs consume and runs unpadded
    there. Where the halo is not smaller than the local extent (tiny
    bottleneck maps) it gathers the whole axis, convolves it padded, and
    slices this rank's outputs back out."""
    kh, kw = weight.shape[2], weight.shape[3]
    effs = (dilation * (kh - 1) + 1, dilation * (kw - 1) + 1)
    pads = [(e - 1) // 2 for e in effs]
    slice_back = []  # (dim, axis, local output size) of gathered axes
    for j, ax in enumerate(spatial_axes(spatial_axis)):
        if ax is None:
            continue
        dim, eff_k = 2 + j, effs[j]
        size, halo = x.shape[dim], (eff_k - 1) // 2
        if halo >= size:
            slice_back.append((dim, ax, size // stride if stride > 1 else size))
            x = gather_axis(x, ax, dim)
            continue
        if size % stride:
            raise ValueError(f"sharded conv needs local extent {size} divisible by "
                             f"stride {stride}")
        # Output o consumes rows [o*s - pt, o*s - pt + eff_k); the last local
        # output reaches pb = eff_k - stride - pt rows past the shard (a
        # negative pb trims unused bottom rows).
        pt = halo
        pb = eff_k - stride - pt
        x = halo_pad(x, halo, ax, dim).narrow(dim, halo - pt, pt + size + pb)
        pads[j] = 0
    y = F.conv2d(x, weight.to(x.dtype), None if bias is None else bias.to(x.dtype),
                 stride=stride, padding=tuple(pads), dilation=dilation, groups=groups)
    for dim, ax, size in slice_back:
        y = y.narrow(dim, ax.index * size, size)
    return y


def conv2d(
    x: torch.Tensor,
    kernel: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    stride: int = 1,
    groups: int = 1,
    spatial_axis=None,
    dilation: int = 1,
) -> torch.Tensor:
    """[B, H, W, Cin] x (kh, kw, Cin/groups, Cout) -> [B, H', W', Cout],
    with halo exchange along the axes ``spatial_axis`` binds.

    The output dtype is the input's; the kernel and bias are cast to it.
    """
    y = conv2d_nchw(x.permute(0, 3, 1, 2), kernel.permute(3, 2, 0, 1), bias, stride=stride,
                    groups=groups, dilation=dilation, spatial_axis=spatial_axis)
    return y.permute(0, 2, 3, 1)


def _reduce(m: torch.Tensor, axes, op) -> torch.Tensor:
    for ax in axes:
        m = m.contiguous()
        dist.all_reduce(m, op=op, group=ax.group)
    return m


def global_mean(x: torch.Tensor, dims: Tuple[int, ...], spatial_axis=None,
                nchw: bool = False) -> torch.Tensor:
    """Mean over ``dims``, kept as size-1 dims (x's dtype); over the ranks
    too where H / W (NHWC dims 1 / 2, NCHW's 2 / 3 with ``nchw``) are
    sharded (every shard holds as many elements, so the mean of the shards'
    means is the global mean)."""
    axes = reduce_axis_names(spatial_axis, dims, nchw)
    m = _reduce(x.mean(dim=dims, keepdim=True), axes, dist.ReduceOp.SUM)
    for ax in axes:
        m = m / ax.size
    return m


def global_max(x: torch.Tensor, dims: Tuple[int, ...], spatial_axis=None,
               nchw: bool = False) -> torch.Tensor:
    """Max over ``dims``, kept as size-1 dims; over the ranks too where
    sharded."""
    return _reduce(x.amax(dim=dims, keepdim=True), reduce_axis_names(spatial_axis, dims, nchw),
                   dist.ReduceOp.MAX)


def global_min(x: torch.Tensor, dims: Tuple[int, ...], spatial_axis=None,
               nchw: bool = False) -> torch.Tensor:
    """Min over ``dims``, kept as size-1 dims; over the ranks too where
    sharded."""
    return _reduce(x.amin(dim=dims, keepdim=True), reduce_axis_names(spatial_axis, dims, nchw),
                   dist.ReduceOp.MIN)
