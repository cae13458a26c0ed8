"""Predictor: the RAW -> RGB inference API.

Port of ``bayer_low_light_image_enhancement_tpu/serving/predictor.py``:

* ``__call__`` takes frames of any size ([H,W], [H,W,1] or [B,H,W,1], RAW in
  [0,1]*ratio), pads to a multiple of ``pad_to`` (16 for RawFormer, 32 for
  RawFormer-WFB), crops the output back and clips it to [0, 1];
* ``raw_u16`` takes the production input, a uint16 RGGB mosaic ([H,W] or
  [B,H,W]) and its exposure ratio, through the fused pack kernel and the
  prepacked model entry (RawFormer; a model without one raises TypeError);
* weights come from a ``state_dict``, another module, a reference ``.pth``
  (``from_torch``) or the JAX package's RawFormer params tree
  (``from_jax_params``).

The model runs on ``device``, the card unless the caller asks for the CPU.
Inputs and outputs are numpy arrays (outputs NHWC fp32). On CUDA every
TransformerBlock with C <= 256 runs the fused kernels
(``models/common.TransformerBlock``), with the apply pass ``apply_kernel``
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
        """Load the JAX package's RawFormer params tree (numpy leaves)."""
        from bayer_low_light_image_enhancement_tpu_torch.compat.jax_params import (
            state_dict_from_jax,
        )

        return cls(model, state_dict_from_jax(params_np), **kw)

    # ------------------------------------------------------------------
    def _pads(self, h: int, w: int):
        return (-h) % self.pad_to, (-w) % self.pad_to

    @staticmethod
    def _finish(y: torch.Tensor, h: int, w: int, squeeze: bool) -> np.ndarray:
        y = y[:, :, :h, :w].permute(0, 2, 3, 1).clamp(0.0, 1.0)
        y = y.float().cpu().numpy()
        return y[0] if squeeze else y

    def __call__(self, raw: np.ndarray) -> np.ndarray:
        """RAW mosaic in [0,1]*ratio -> RGB in [0,1]; shape-preserving."""
        x = torch.from_numpy(np.asarray(raw, np.float32))
        squeeze = x.dim() < 4
        if x.dim() == 2:
            x = x[..., None]
        if x.dim() == 3:
            x = x[None]
        if x.dim() != 4 or x.shape[-1] != 1:
            raise ValueError(f"expected [H,W], [H,W,1] or [B,H,W,1], got {np.shape(raw)}")
        h, w = x.shape[1:3]
        ph, pw = self._pads(h, w)
        x = F.pad(x.to(self.device).permute(0, 3, 1, 2), (0, pw, 0, ph))
        with torch.inference_mode():
            y = self.model(x)
        return self._finish(y, h, w, squeeze)

    def raw_u16(self, mosaic: np.ndarray, ratio) -> np.ndarray:
        """uint16 RGGB mosaic [H,W] or [B,H,W] + exposure ratio (scalar or
        [B]) -> RGB [.., H, W, 3] in [0,1].

        The mosaic is zero-padded to a multiple of ``pad_to`` (code 0
        decodes to black) and the output cropped back. Raises TypeError for
        a model without a prepacked entry (RawFormer-WFB)."""
        if "prepacked" not in inspect.signature(self.model.forward).parameters:
            raise TypeError(f"{type(self.model).__name__} has no prepacked entry: raw_u16 serves "
                            "RawFormer; serve this model through __call__")
        m = np.asarray(mosaic)
        if m.dtype != np.uint16:
            raise TypeError(f"mosaic must be uint16, got {m.dtype}")
        squeeze = m.ndim == 2
        if squeeze:
            m = m[None]
        if m.ndim != 3:
            raise ValueError(f"expected [H,W] or [B,H,W], got {np.shape(mosaic)}")
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
