"""Serving artifacts through ``torch.export``: a model without its code.

Port of ``bayer_low_light_image_enhancement_tpu/serving/export.py``, which
serialises a jitted forward to StableHLO. Here the forward ``[B,H,W,1] fp32
RAW -> model -> clip to [0, 1] -> [B,H,W,3] fp32 RGB`` is traced under
``torch.no_grad()`` by ``torch.export.export`` into an ``ExportedProgram``
(graph plus weights) and saved. A serving process loads it with no model
class, no checkpoint and no registry lookup; it needs only the
``torch.ops.blle`` operators, which importing ``kernels`` registers, so the
graph's hand kernels (K2, K3 or K3P, S1) run as they do in ``Predictor``.

The graph is traced on one device and stays there: on CUDA the blocks cast
their input to bf16 and call the kernels; on the CPU they run the fp32
twins. An artifact made on the card therefore serves only on a card (its
``meta.json`` says which device), and the exported ``fold_block_params`` /
``finalize_attention`` run at every call as they do eagerly.

Artifact format: a zip holding
  * ``model.pt2`` -- ``torch.export.save`` of the program;
  * ``meta.json`` -- ``format_version``, ``input_shape``, ``input_dtype``,
    ``clip01``, ``device``, the ``blle`` operators in the graph (``ops``),
    and what the caller adds (the CLI: ``model``).

A raw-domain model (packed [B,H,W,4] planes in and out) has no RAW -> RGB
artifact and is refused, as the JAX function's (B,H,W,1) spec cannot serve
it either. ``cli/export_cli.py`` is the command-line surface.
"""

from __future__ import annotations

import io
import json
import zipfile
from typing import Any, Callable, Mapping, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn as nn

# Registers the torch.ops.blle operators that an exported graph calls.
import bayer_low_light_image_enhancement_tpu_torch.kernels  # noqa: F401

_META_NAME = "meta.json"
_BLOB_NAME = "model.pt2"
FORMAT_VERSION = 1


class _Served(nn.Module):
    """[B,H,W,1] fp32 RAW -> [B,H,W,3] fp32 RGB (clipped to [0, 1] with
    ``clip01``), as ``Predictor`` finishes a forward."""

    def __init__(self, model: nn.Module, clip01: bool):
        super().__init__()
        self.model, self.clip01 = model, clip01

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # [B,1,H,W] with NCHW strides, as Predictor hands it over. The
        # permuted view's strides are ambiguous at C = 1: export's fake
        # tensors then take the clamped input as channels-last where the
        # eager run does not, and leave out the model's channels-last copy
        # (the whole graph would run NCHW, in other kernels).
        b, h, w, _ = x.shape
        y = self.model(x.reshape(b, 1, h, w)).permute(0, 2, 3, 1)
        return (y.clamp(0.0, 1.0) if self.clip01 else y).float()


def _device(device) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError('no CUDA device: pass device="cpu" for a CPU artifact')
    return dev


def export_artifact(
    model: nn.Module,
    weights: Union[Mapping[str, torch.Tensor], nn.Module, None],
    path: str,
    batch: int = 1,
    height: int = 512,
    width: int = 512,
    device: Union[str, torch.device, None] = None,
    clip01: bool = True,
    meta_extra: Optional[dict] = None,
) -> dict:
    """Export ``model`` with ``weights`` (a ``state_dict``, another module,
    or None for the model's own) for [batch, height, width, 1] fp32 input
    on ``device`` (the card unless the caller asks for the CPU; raises
    without one), as a self-contained artifact at ``path``. Returns the
    meta dict."""
    if getattr(getattr(model, "config", None), "in_ch", 1) != 1:
        raise ValueError(f"{type(model).__name__} is a raw-domain model (packed [B,H,W,"
                         f"{model.config.in_ch}] planes in and out); an artifact serves "
                         "[B,H,W,1] RAW mosaics -> RGB")
    dev = _device(device)
    if isinstance(weights, nn.Module):
        weights = weights.state_dict()
    if weights is not None:
        model.load_state_dict(weights)
    served = _Served(model.to(dev).eval(), clip01)
    example = torch.zeros((batch, height, width, 1), device=dev)
    with torch.no_grad():
        program = torch.export.export(served, (example,))
    blob = io.BytesIO()
    torch.export.save(program, blob)
    ops = sorted({str(n.target).removesuffix(".default") for n in program.graph.nodes
                  if n.op == "call_function" and str(n.target).startswith("blle.")})
    meta = {
        "format_version": FORMAT_VERSION,
        "input_shape": [batch, height, width, 1],
        "input_dtype": "float32",
        "clip01": clip01,
        "device": str(example.device),
        "ops": ops,
        **(meta_extra or {}),
    }
    with zipfile.ZipFile(path, "w", compression=zipfile.ZIP_DEFLATED) as zf:
        zf.writestr(_META_NAME, json.dumps(meta, indent=2))
        zf.writestr(_BLOB_NAME, blob.getvalue(), compress_type=zipfile.ZIP_STORED)
    return meta


def load_artifact(path: str, device: Union[str, torch.device, None] = None
                  ) -> Tuple[Callable[[np.ndarray], np.ndarray], dict]:
    """Load an artifact -> (callable taking numpy [B,H,W,1] fp32 and
    returning numpy [B,H,W,3] fp32, meta). ``device`` defaults to the
    artifact's own; another device raises ValueError (the graph's device
    is fixed at export), and a CUDA artifact raises RuntimeError without a
    card. The callable raises ValueError on another input shape."""
    with zipfile.ZipFile(path) as zf:
        meta = json.loads(zf.read(_META_NAME))
        if meta.get("format_version", 0) > FORMAT_VERSION:
            raise ValueError(f"artifact format {meta['format_version']} too new "
                             f"(this loader reads up to {FORMAT_VERSION})")
        blob = zf.read(_BLOB_NAME)
    want = torch.device(meta["device"])
    dev = _device(want if device is None else device)
    if (dev.type, dev.index or 0) != (want.type, want.index or 0):
        raise ValueError(f"the artifact was exported for {want} and serves only there, "
                         f"not on {dev}")
    module = torch.export.load(io.BytesIO(blob)).module()
    expected = tuple(meta["input_shape"])

    def call(x) -> np.ndarray:
        x = np.asarray(x, np.float32)
        if x.shape != expected:
            raise ValueError(f"artifact expects input {expected}, got {x.shape}")
        with torch.no_grad():
            y = module(torch.from_numpy(np.ascontiguousarray(x)).to(dev))
        return y.cpu().numpy()

    return call, meta
