"""Spatially sharded full-resolution inference (halo-exchange tiling).

Port of ``bayer_low_light_image_enhancement_tpu/parallel/tiled.py``. One
frame is split over the mesh's ``spatial`` axis by rows, or over
``spatial`` x ``spatial_w`` as a 2-D grid; each rank holds a contiguous
block and runs the model on it:

* convs exchange their ``(eff_k-1)//2`` boundary rows (and columns)
  with the neighbouring ranks, the image edges receiving zeros, which is
  the monolithic zero pad; strided and dilated convs too, and a conv whose
  halo exceeds the shard (a deep stage's 15- or 31-tap box filter)
  gathers the axis and slices its block back (``ops/conv.py``);
* token-global reductions are local partials combined over the spatial
  groups: channel attention's gram and q / k sums of squares
  (``ops/attention.py``), the SE pools, the luma max (and luma-MHSA's
  min), InstanceNorm's means, the pyramid FLCA's band means and the
  colour anchors (``global_mean`` / ``global_max`` / ``global_min``);
* the bilinear guidance resizes of the FLCA / TrueColor family and the
  raw-domain U-Nets gather their 1-3 channel maps along the sharded axes,
  resize them whole and slice the block back (``ops/flca.py``);
* token attention (luma-MHSA's at every stage, the raw-domain U-Nets'
  token blocks) is gather-kv: queries local, keys and values gathered
  along every sharded axis (``models/luma_variants.py``);
* the RawFormer-WFB FFT islands gather their input along H
  (``ops/fft.FEB``) and its Mamba scans run sequence-parallel over the H
  ranks (``ops/ssm.py``);
* pixel-local work stays local: pixel_unshuffle, the Haar DWT, the
  pools, the transposed-conv upsamples, KANLinear, the colour correction.

In fp32 the result equals the monolithic forward. The collectives are
all-reduces (``core/mesh.py``), so the same code runs on NCCL across cards,
on gloo on the CPU, and on gloo with several ranks sharing one card.

Sharded TransformerBlocks take the module path and sharded Mamba scans the
twin: the hand kernels K2 / K3 / K3P compute a whole block's gram on one
device and S1 takes no incoming state (the JAX package's
``models/fused_apply._fusable`` and ``ops/ssm.MambaBlock`` routes), so the
tiled forward launches none of them.

Every registry model has a spatial half (its config's ``spatial_axis``):
by H and by H x W, RawFormer-WFB by H only. Constraints: each rank's
block of the input has H (and W) divisible by 16 (the [B, H, W, 1] mosaic:
one pixel_unshuffle and three downsamples; 32 for RawFormer-WFB, whose
stages halve once more through the Haar DWT; the raw-domain models'
[B, H, W, 4] packed planes: four stride-2 convs or three pools): use
``pad_to_tile`` for arbitrary frames. Token attention holds every key on
every rank: a rank's attention work is the monolithic one's over the
ranks, still quadratic in the frame's tokens.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from bayer_low_light_image_enhancement_tpu_torch.core.mesh import (
    AXES,
    axis_rank,
    axis_size,
    bind_axis,
)
from bayer_low_light_image_enhancement_tpu_torch.models.common import bind_spatial
from bayer_low_light_image_enhancement_tpu_torch.ops.conv import gather_axis, spatial_axes


def pad_to_tile(x: np.ndarray, n_shards: int, multiple: int = 16) -> Tuple[np.ndarray, int]:
    """Pad H of [B, H, W, C] with zero rows so that it divides into
    ``n_shards`` shards of a multiple of ``multiple`` rows each.

    Returns (padded, original_h)."""
    h = x.shape[1]
    pad = (-h) % (n_shards * multiple)
    if pad:
        x = np.pad(x, ((0, 0), (0, pad), (0, 0), (0, 0)))
    return x, h


def shard_image(x, mesh, spatial_axis: str = AXES.spatial,
                spatial_w_axis: Optional[str] = None):
    """This rank's block of the [B, H, W, C] frame ``x`` (numpy or torch):
    H split over ``spatial_axis`` in rank order and, with ``spatial_w_axis``,
    W over that axis (varying fastest in the mesh)."""
    n = axis_size(mesh, spatial_axis)
    h = x.shape[1] // n
    i = axis_rank(mesh, spatial_axis)
    x = x[:, i * h:(i + 1) * h]
    if spatial_w_axis is not None:
        m = axis_size(mesh, spatial_w_axis)
        w = x.shape[2] // m
        j = axis_rank(mesh, spatial_w_axis)
        x = x[:, :, j * w:(j + 1) * w]
    return x


class TiledForward(nn.Module):
    """``model`` (any model whose config has ``spatial_axis``) bound to the
    spatial axes of ``mesh``: called on this rank's [B, h, w, C] block
    (NHWC, ``shard_image``), it returns the whole output on every rank,
    gathered by all-reduce (the JAX package's result is fully replicated):
    [B, H, W, 3] RGB of a RAW -> RGB model, [B, H, W, 4] planes of a
    raw-domain one. Eval mode, no grad."""

    def __init__(self, model: nn.Module, mesh, spatial_axis: str, spatial_w_axis: Optional[str],
                 clip01: bool):
        super().__init__()
        want = spatial_axes(getattr(model.config, "spatial_axis", None))
        if want != (spatial_axis, spatial_w_axis):
            raise ValueError(
                f"the model's spatial_axis {model.config.spatial_axis!r} does not name the "
                f"axes of this tiled forward ({spatial_axis!r}, {spatial_w_axis!r}); build "
                "it with the same spatial_axis")
        self.model = model.eval()
        self.config = model.config
        self.clip01 = clip01
        self.axes = (bind_axis(mesh, spatial_axis), bind_axis(mesh, spatial_w_axis))
        bind_spatial(model, self.axes if spatial_w_axis else self.axes[0])

    def forward(self, x_local: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            y = self.model(x_local.permute(0, 3, 1, 2))
            if self.clip01:
                y = y.clamp(0.0, 1.0)
            y = y.permute(0, 2, 3, 1)
            h_ax, w_ax = self.axes
            return gather_axis(gather_axis(y, h_ax, 1), w_ax, 2)


def make_tiled_forward(model: nn.Module, mesh, spatial_axis: str = AXES.spatial,
                       spatial_w_axis: Optional[str] = None, clip01: bool = True) -> TiledForward:
    """Bind ``model`` (built with ``spatial_axis=<axis>`` or ``(h_axis,
    w_axis)`` in its config, on every rank, with the same weights) to the
    spatial groups of ``mesh`` and return its tiled forward: ``fn(x_local)``
    with x_local this rank's [B, h, w, C] block, h (and w, if sharded)
    divisible by 16 (32 for RawFormer-WFB), -> the whole [B, H, W, 3] RGB
    or [B, H, W, 4] planes (clipped to [0, 1] with ``clip01``) on every
    rank."""
    return TiledForward(model, mesh, spatial_axis, spatial_w_axis, clip01)
