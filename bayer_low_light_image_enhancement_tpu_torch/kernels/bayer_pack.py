"""Fused Bayer decode + normalise + amplify + clamp + RGGB pack (kernel K1).

Port of ``bayer_low_light_image_enhancement_tpu/kernels/bayer_pack.py``.
The CUDA kernel (``csrc/bayer_pack.cu``) reads the uint16 mosaic once and
writes the packed [B, H/2, W/2, 4] NHWC planes (R, G1, G2, B) once, doing
the 2x2 gather itself (the TPU version left that relayout to XLA).

On a CPU tensor the wrapper runs the plain twin, ``bayer_pack_normalize_plain``
(``normalize_sid`` + ``pack_bayer``); on a CUDA tensor it launches the kernel
or raises.
"""

from __future__ import annotations

import dataclasses

import torch

from bayer_low_light_image_enhancement_tpu_torch.kernels import _build
from bayer_low_light_image_enhancement_tpu_torch.ops.bayer import normalize_sid, pack_bayer

BLACK_LEVEL = 512.0
WHITE_LEVEL = 16383.0
_OUT_DTYPES = (torch.bfloat16, torch.float32)


def bayer_pack_normalize_plain(
    mosaic: torch.Tensor,
    ratio: torch.Tensor,
    out_dtype: torch.dtype = torch.float32,
    clamp01: bool = False,
) -> torch.Tensor:
    """Plain PyTorch twin of the kernel: [B, H, W] uint16 + [B] -> [B, H/2, W/2, 4]."""
    ratio = torch.as_tensor(ratio, dtype=torch.float32, device=mosaic.device)
    if mosaic.dtype == torch.uint16:
        # uint16 tensors support few ops: decode the codes through int16 bits.
        mosaic = mosaic.view(torch.int16).to(torch.int32) & 0xFFFF
    x = normalize_sid(mosaic[..., None], ratio.reshape(-1, 1, 1, 1), BLACK_LEVEL, WHITE_LEVEL)
    x = pack_bayer(x, "RGGB")
    if clamp01:
        x = x.clamp_max(1.0)
    return x.to(out_dtype)


def bayer_pack_normalize(
    mosaic: torch.Tensor,
    ratio: torch.Tensor,
    out_dtype: torch.dtype = torch.float32,
    clamp01: bool = False,
) -> torch.Tensor:
    """[B, H, W] uint16 mosaic + [B] ratio -> [B, H/2, W/2, 4] (R, G1, G2, B).

    Codes are read unsigned (hot pixels >= 32768 stay large and clip to the
    white level), clipped to [512, 16383], scaled by 1/(16383-512+1e-6),
    multiplied by the image's ratio and, with ``clamp01``, capped at 1 (the
    model's own input clamp folded into the same pass).
    """
    if mosaic.dim() != 3:
        raise ValueError(f"mosaic must be [B, H, W], got {tuple(mosaic.shape)}")
    b, h, w = mosaic.shape
    if h % 2 or w % 2:
        raise ValueError(f"mosaic dims {(h, w)} must be even")
    if not mosaic.is_cuda:
        return bayer_pack_normalize_plain(mosaic, ratio, out_dtype, clamp01)
    return _bayer_pack_kernel(mosaic, ratio, out_dtype, clamp01)


# The launch geometry of csrc/bayer_pack.cu (``pack_geometry`` there): a
# group is 4 packed pixels of one packed row (8 codes of each of its two
# mosaic rows); a thread takes GROUPS_PER_THREAD groups ``tx`` apart.
GROUPS_PER_THREAD, MAX_TX, BLOCK_THREADS, MAX_GRID_Y = 2, 512, 128, 65535


@dataclasses.dataclass(frozen=True)
class PackGeometry:
    """K1's launch at [B, H, W]: blocks of tx x ty threads (ty packed rows a
    block), a grid of gx column blocks by gy row blocks; the rows beyond
    gy * ty are walked by a grid-stride loop."""

    tx: int
    ty: int
    gx: int
    gy: int
    rows: int    # B * H/2 packed rows
    groups: int  # groups a packed row: ceil(W/2 / 4)


def pack_geometry(b: int, h: int, w: int) -> PackGeometry:
    """The geometry the C library launches for a [b, h, w] mosaic."""
    rows, groups = b * (h // 2), (w // 2 + 3) // 4
    need = -(-groups // GROUPS_PER_THREAD) if groups > GROUPS_PER_THREAD else 1
    gx = -(-need // MAX_TX)
    tx = -(-(-(-need // gx)) // 32) * 32
    ty = 1 if tx >= BLOCK_THREADS else BLOCK_THREADS // tx
    return PackGeometry(tx, ty, gx, min(-(-rows // ty), MAX_GRID_Y), rows, groups)


def pack_rows(geo: PackGeometry, by: int, y: int):
    """The packed rows thread row y of block row by walks (the kernel's
    grid-stride loop)."""
    return range(by * geo.ty + y, geo.rows, geo.gy * geo.ty)


def pack_groups(geo: PackGeometry, bx: int, x: int):
    """The groups thread x of block column bx takes in each of its rows."""
    g0 = bx * GROUPS_PER_THREAD * geo.tx + x
    return [g for g in (g0 + k * geo.tx for k in range(GROUPS_PER_THREAD)) if g < geo.groups]


def _bayer_pack_kernel(mosaic, ratio, out_dtype, clamp01):
    b, h, w = mosaic.shape
    if mosaic.dtype != torch.uint16:
        raise TypeError(f"mosaic must be uint16, got {mosaic.dtype}")
    if out_dtype not in _OUT_DTYPES:
        raise TypeError(f"out_dtype must be one of {_OUT_DTYPES}, got {out_dtype}")
    if not mosaic.is_contiguous():
        raise ValueError("mosaic must be contiguous")
    if b * (h // 2) >= 2 ** 31:
        raise ValueError(f"mosaic {(b, h, w)} has 2^31 packed rows or more")
    if type(ratio) is not torch.Tensor:
        ratio = torch.as_tensor(ratio, device=mosaic.device)
    if ratio.dtype != torch.float32 or ratio.shape != (b,) or ratio.device != mosaic.device:
        raise ValueError(f"ratio must be float32 [{b}] on {mosaic.device}")
    ratio = ratio.contiguous()
    out = torch.empty((b, h // 2, w // 2, 4), dtype=out_dtype, device=mosaic.device)
    if out.numel():
        err = _build.library().blle_bayer_pack(
            mosaic.data_ptr(), ratio.data_ptr(), out.data_ptr(), b, h, w,
            int(out_dtype == torch.bfloat16), int(clamp01), _build.stream_of(mosaic),
        )
        _build.check(err, "bayer_pack")
        bayer_pack_normalize.launches += 1
    return out


bayer_pack_normalize.launches = 0


def make_raw_u16_forward(model: torch.nn.Module, dtype: torch.dtype = torch.bfloat16):
    """Compose the pack kernel with a model forward.

    ``model(x, prepacked=True)`` must accept the packed NCHW [B, 4, H/2, W/2]
    planes (``models/rawformer.py``). The pack kernel decodes the uint16
    mosaic, normalises, amplifies, clamps and emits ``dtype`` in one pass; the
    NHWC result is handed to the model as a free channels_last NCHW view.
    """

    def forward(mosaic: torch.Tensor, ratio: torch.Tensor) -> torch.Tensor:
        x4 = bayer_pack_normalize(mosaic, ratio, out_dtype=dtype, clamp01=True)
        return model(x4.permute(0, 3, 1, 2), prepacked=True)

    return forward
