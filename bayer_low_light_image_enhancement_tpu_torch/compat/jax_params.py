"""Carry weights from the JAX package's params tree into the port.

The inverse of the JAX package's ``compat/torch_import.
import_rawformer_state_dict``: it takes the flax params tree as numpy
arrays and returns a ``state_dict`` in the reference's PyTorch names, which
``models.rawformer.RawFormer`` loads.

* conv kernel HWIO (kh, kw, I/g, O)        -> OIHW (O, I/g, kh, kw)
  (depthwise (3, 3, 1, C) -> (C, 1, 3, 3) by the same transpose)
* Upsample2x 1x1 kernel (1, 1, I, 4O), column o*4 + di*2 + dj
                                             -> ConvTranspose2d (I, O, 2, 2)
* attention temperature (heads,)            -> (heads, 1, 1)
* LayerNorm weight / bias                   -> ``norm*.body.*``
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _conv(p: Mapping[str, Any], prefix: str, out: Dict[str, torch.Tensor]) -> None:
    out[f"{prefix}.weight"] = _t(np.transpose(np.asarray(p["kernel"]), (3, 2, 0, 1)))
    if "bias" in p:
        out[f"{prefix}.bias"] = _t(p["bias"])


def transformer_block_state_dict(p: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """One TransformerBlock's JAX params -> ``models.common.TransformerBlock``
    state_dict (names relative to the block)."""
    out: Dict[str, torch.Tensor] = {}
    for norm in ("norm1", "norm2"):
        out[f"{norm}.body.weight"] = _t(p[norm]["weight"])
        out[f"{norm}.body.bias"] = _t(p[norm]["bias"])
    attn = p["attn"]
    out["attn.temperature"] = _t(np.asarray(attn["temperature"]).reshape(-1, 1, 1))
    for name in ("qkv", "qkv_dwconv", "project_out"):
        _conv(attn[name], f"attn.{name}", out)
    for name in ("pointwise1", "depthwise", "pointwise2"):
        _conv(p["ffn"][name], f"ffn.{name}", out)
    return out


def state_dict_from_jax(params_np: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX RawFormer params (``{"params": {...}}`` or the inner dict, numpy
    leaves) -> the port's RawFormer ``state_dict``."""
    p = params_np.get("params", params_np)
    out: Dict[str, torch.Tensor] = {}
    _conv(p["embedding"], "embedding", out)
    for k in range(1, 8):
        s = p[f"conv_tran{k}"]
        base = f"conv_tran{k}"
        _conv(s["conv"], f"{base}.conv", out)
        for name, v in transformer_block_state_dict(s["transformer"]).items():
            out[f"{base}.Transformer.{name}"] = v
        _conv(s["channel_reduce"], f"{base}.channel_reduce", out)
        _conv(s["conv_out"], f"{base}.Conv_out", out)
    for j in range(1, 4):
        _conv(p[f"down{j}"]["conv"], f"down{j}.body.0", out)
        up = np.asarray(p[f"up{j}"]["kernel"])  # (1, 1, I, 4O)
        i, o4 = up.shape[2], up.shape[3]
        out[f"up{j}.weight"] = _t(up.reshape(i, o4 // 4, 2, 2))
        out[f"up{j}.bias"] = _t(p[f"up{j}"]["bias"])
        _conv(p[f"channel_reduce{j}"], f"channel_reduce{j}", out)
    _conv(p["conv_out"], "conv_out", out)
    return out
