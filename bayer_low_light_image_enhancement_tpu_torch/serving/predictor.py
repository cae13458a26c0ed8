"""Predictor: the RAW -> RGB inference API.

Port of ``bayer_low_light_image_enhancement_tpu/serving/predictor.py``:

* ``__call__`` takes frames of any size ([H,W], [H,W,1] or [B,H,W,1], RAW in
  [0,1]*ratio), pads to a multiple of ``pad_to`` (16 for RawFormer and the
  FLCA / TrueColor families, 32 for RawFormer-WFB) with zeros, which enter
  the FLCA / TrueColor models' global statistics as in the JAX package,
  crops the output back and clips it to [0, 1];
* ``raw_u16`` takes the production input, a uint16 RGGB mosaic ([H,W] or
  [B,H,W]) and its exposure ratio, through the fused pack kernel and the
  prepacked model entry (RawFormer; a model without one, every other
  family, raises TypeError);
* ``codes`` takes integer sensor codes in ``__call__``'s frame shapes and
  decodes them on the device, for any model: SID uint16 mosaics and their
  ratio as ``raw_u16`` does where the model has a prepacked entry, else
  through ``ops.bayer.normalize_sid``; MCR uint8 codes and their
  amplification through ``normalize_mcr``;
* weights come from a ``state_dict``, another module, a reference ``.pth``
  (``from_torch``) or the JAX package's variables (``from_jax_params``:
  RawFormer, FLCA-RawFormer, multi-level FLCA, TrueColor / BayerTORGB and
  luma-MHSA params, or RawFormer-WFB and WavKAN params and batch_stats).

The model runs on ``device``, the card unless the caller asks for the CPU.
Inputs and outputs are numpy arrays (outputs NHWC fp32). On CUDA every
TransformerBlock with C <= 256 (in band mode, every TransformerBlock) runs
the fused kernels (``models/common.TransformerBlock``), with the apply pass
``apply_kernel``
selects ("tiled": K3; "pipelined": K3P at the power-of-two widths), and
every Mamba scan the kernel S1.
"""

from __future__ import annotations

import inspect
from typing import Any, Mapping, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from bayer_low_light_image_enhancement_tpu_torch.kernels.bayer_pack import (
    make_raw_u16_forward,
)
from bayer_low_light_image_enhancement_tpu_torch.models.common import set_apply_kernel
from bayer_low_light_image_enhancement_tpu_torch.ops.bayer import normalize_mcr, normalize_sid


class Predictor:
    def __init__(
        self,
        model: nn.Module,
        weights: Union[Mapping[str, torch.Tensor], nn.Module, None] = None,
        device: Union[str, torch.device] = "cuda",
        pad_to: int = 16,
        apply_kernel: str = "tiled",
    ):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError('Predictor: no CUDA device; pass device="cpu" to serve on the CPU')
        if isinstance(weights, nn.Module):
            weights = weights.state_dict()
        if weights is not None:
            model.load_state_dict(weights)
        self.pad_to = pad_to
        set_apply_kernel(model, apply_kernel)
        self.model = model.to(self.device).eval()
        self._prepacked = "prepacked" in inspect.signature(self.model.forward).parameters
        self._u16_forward = make_raw_u16_forward(self.model, dtype=model.config.dtype)

    # ------------------------------------------------------------------
    @classmethod
    def from_torch(cls, model: nn.Module, pth_path: str, **kw) -> "Predictor":
        """Load a reference ``.pth`` (a bare state_dict or the reference's
        ``{'state_dict': ...}`` wrapper, ``module.`` prefixes stripped)."""
        ckpt = torch.load(pth_path, map_location="cpu", weights_only=True)
        state = ckpt.get("state_dict", ckpt)
        state = {k.removeprefix("module."): v for k, v in state.items()}
        return cls(model, state, **kw)

    @classmethod
    def from_jax_params(cls, model: nn.Module, params_np: Mapping[str, Any], **kw) -> "Predictor":
        """Load the JAX package's variables (numpy leaves) of the model's
        family: a RawFormer, FLCA-RawFormer, multi-level FLCA, TrueColor
        (BayerTORGB) or luma-MHSA params tree, or for a ``RawFormerWFB`` or
        ``WavKANRawFormer`` model its ``{"params", "batch_stats"}``."""
        from bayer_low_light_image_enhancement_tpu_torch.compat import jax_params as jp

        # Each family names its importer; RawFormer's is the default.
        carry = getattr(type(model), "state_dict_from_jax", jp.state_dict_from_jax)
        return cls(model, carry(params_np), **kw)

    # ------------------------------------------------------------------
    def _pads(self, h: int, w: int):
        return (-h) % self.pad_to, (-w) % self.pad_to

    @staticmethod
    def _finish(y: torch.Tensor, h: int, w: int, squeeze: bool) -> np.ndarray:
        y = y[:, :, :h, :w].permute(0, 2, 3, 1).clamp(0.0, 1.0)
        y = y.float().cpu().numpy()
        return y[0] if squeeze else y

    @staticmethod
    def _frames(a: np.ndarray):
        """[H,W], [H,W,1] or [B,H,W,1] -> ([B,H,W,1], whether to squeeze)."""
        squeeze = a.ndim < 4
        x = a[..., None] if a.ndim == 2 else a
        x = x[None] if x.ndim == 3 else x
        if x.ndim != 4 or x.shape[-1] != 1:
            raise ValueError(f"expected [H,W], [H,W,1] or [B,H,W,1], got {a.shape}")
        return np.ascontiguousarray(x), squeeze

    def _padded(self, x: torch.Tensor) -> torch.Tensor:
        """[B,H,W,1] on the device -> [B,1,H',W'] zero-padded to ``pad_to``."""
        ph, pw = self._pads(*x.shape[1:3])
        return F.pad(x.permute(0, 3, 1, 2), (0, pw, 0, ph))

    def __call__(self, raw: np.ndarray) -> np.ndarray:
        """RAW mosaic in [0,1]*ratio -> RGB in [0,1]; shape-preserving."""
        x, squeeze = self._frames(np.asarray(raw, np.float32))
        h, w = x.shape[1:3]
        x = self._padded(torch.from_numpy(x).to(self.device))
        with torch.inference_mode():
            y = self.model(x)
        return self._finish(y, h, w, squeeze)

    def codes(self, codes: np.ndarray, scale, decode: str = "sid") -> np.ndarray:
        """Integer sensor codes in ``__call__``'s frame shapes + per-image
        scale (scalar or [B]) -> RGB in [0,1], decoded on the device:
        ``decode="sid"`` takes uint16 mosaic codes and the exposure ratio
        (through ``raw_u16``'s pack kernel where the model has a prepacked
        entry, else ``normalize_sid``), ``"mcr"`` uint8 codes and the
        amplification (``normalize_mcr``). The codes are zero-padded to
        ``pad_to`` (code 0 decodes to 0 in all three) and the output cropped
        back."""
        dtypes = {"sid": np.uint16, "mcr": np.uint8}
        if decode not in dtypes:
            raise ValueError(f"decode must be one of {sorted(dtypes)}, got {decode!r}")
        c = np.asarray(codes)
        if c.dtype != dtypes[decode]:
            raise TypeError(f"{decode} codes must be {np.dtype(dtypes[decode])}, got {c.dtype}")
        x, squeeze = self._frames(c)
        if decode == "sid" and self._prepacked:
            return self._packed_forward(x[..., 0], scale, squeeze)
        b, h, w = x.shape[:3]
        s = torch.as_tensor(np.asarray(scale, np.float32).reshape(-1)).to(self.device)
        s = s.expand(b).reshape(b, 1, 1, 1)
        with torch.inference_mode():
            if decode == "sid":
                # uint16 tensors support few ops: move and pad the codes as int16 bits.
                t = self._padded(torch.from_numpy(x.view(np.int16)).to(self.device))
                x = normalize_sid(t.to(torch.int32) & 0xFFFF, s)
            else:
                x = normalize_mcr(self._padded(torch.from_numpy(x).to(self.device)), s)
            y = self.model(x)
        return self._finish(y, h, w, squeeze)

    def raw_u16(self, mosaic: np.ndarray, ratio) -> np.ndarray:
        """uint16 RGGB mosaic [H,W] or [B,H,W] + exposure ratio (scalar or
        [B]) -> RGB [.., H, W, 3] in [0,1].

        The mosaic is zero-padded to a multiple of ``pad_to`` (code 0
        decodes to black) and the output cropped back. Raises TypeError for
        a model without a prepacked entry (every model but RawFormer)."""
        if not self._prepacked:
            raise TypeError(f"{type(self.model).__name__} has no prepacked entry: raw_u16 serves "
                            "RawFormer; serve this model through __call__ or codes")
        m = np.asarray(mosaic)
        if m.dtype != np.uint16:
            raise TypeError(f"mosaic must be uint16, got {m.dtype}")
        squeeze = m.ndim == 2
        if squeeze:
            m = m[None]
        if m.ndim != 3:
            raise ValueError(f"expected [H,W] or [B,H,W], got {np.shape(mosaic)}")
        return self._packed_forward(m, ratio, squeeze)

    def _packed_forward(self, m: np.ndarray, ratio, squeeze: bool) -> np.ndarray:
        """uint16 [B,H,W] + ratio -> RGB through the pack kernel and the
        prepacked model."""
        b, h, w = m.shape
        r = torch.as_tensor(np.asarray(ratio, np.float32).reshape(-1)).to(self.device)
        r = r.expand(b).contiguous() if r.numel() == 1 else r
        # uint16 tensors support few ops: move and pad the codes as int16 bits.
        m16 = torch.from_numpy(np.ascontiguousarray(m).view(np.int16)).to(self.device)
        ph, pw = self._pads(h, w)
        m16 = F.pad(m16, (0, pw, 0, ph)).contiguous()
        with torch.inference_mode():
            y = self._u16_forward(m16.view(torch.uint16), r)
        return self._finish(y, h, w, squeeze)
