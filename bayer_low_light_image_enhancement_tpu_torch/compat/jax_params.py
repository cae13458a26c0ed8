"""Carry weights from the JAX package's params tree into the port.

The inverses of the JAX package's ``compat/torch_import.
import_rawformer_state_dict`` and ``import_wfb_state_dict``: they take the
JAX variables as numpy arrays and return a ``state_dict`` in the
reference's PyTorch names, which ``models.rawformer.RawFormer`` and
``models.wfb.RawFormerWFB`` load.

* conv kernel HWIO (kh, kw, I/g, O)        -> OIHW (O, I/g, kh, kw)
  (depthwise (3, 3, 1, C) -> (C, 1, 3, 3) by the same transpose)
* Upsample2x 1x1 kernel (1, 1, I, 4O), column o*4 + di*2 + dj
                                             -> ConvTranspose2d (I, O, 2, 2)
* attention temperature (heads,)            -> (heads, 1, 1)
* LayerNorm weight / bias                   -> ``norm*.body.*``
* Dense kernel (I, O)                       -> Linear weight (O, I)
* Mamba conv1d kernel (d_conv, 1, D)        -> Conv1d weight (D, 1, d_conv)
* BatchNorm scale / bias + batch_stats mean / var
                                             -> ``bn.weight`` / ``bn.bias`` /
                                                ``bn.running_mean`` / ``bn.running_var``
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
    for k in range(1, 8):
        base = f"conv_tran{k}"
        for name, v in transformer_block_state_dict(p[base]["transformer"]).items():
            out[f"{base}.Transformer.{name}"] = v
    _unet(p, out)
    return out


def _unet(p: Mapping[str, Any], out: Dict[str, torch.Tensor]) -> None:
    """The U-Net around the stages' transformer branches (RawFormer, WFB)."""
    _conv(p["embedding"], "embedding", out)
    for k in range(1, 8):
        base = f"conv_tran{k}"
        _conv(p[base]["conv"], f"{base}.conv", out)
        _conv(p[base]["channel_reduce"], f"{base}.channel_reduce", out)
        _conv(p[base]["conv_out"], f"{base}.Conv_out", out)
    for j in range(1, 4):
        _conv(p[f"down{j}"]["conv"], f"down{j}.body.0", out)
        up = np.asarray(p[f"up{j}"]["kernel"])  # (1, 1, I, 4O)
        i, o4 = up.shape[2], up.shape[3]
        out[f"up{j}.weight"] = _t(up.reshape(i, o4 // 4, 2, 2))
        out[f"up{j}.bias"] = _t(p[f"up{j}"]["bias"])
        _conv(p[f"channel_reduce{j}"], f"channel_reduce{j}", out)
    _conv(p["conv_out"], "conv_out", out)
    return out


def _dense(p: Mapping[str, Any], prefix: str, out: Dict[str, torch.Tensor]) -> None:
    out[f"{prefix}.weight"] = _t(np.asarray(p["kernel"]).T)
    if "bias" in p:
        out[f"{prefix}.bias"] = _t(p["bias"])


def _layernorm2d(p: Mapping[str, Any], prefix: str, out: Dict[str, torch.Tensor]) -> None:
    out[f"{prefix}.body.weight"] = _t(p["weight"])
    out[f"{prefix}.body.bias"] = _t(p["bias"])


def _feb(p: Mapping[str, Any], prefix: str, out: Dict[str, torch.Tensor]) -> None:
    _conv(p["fpre"], f"{prefix}.fpre", out)
    for ours, ref in (("process1_0", "process1.0"), ("process1_1", "process1.2"),
                      ("process2_0", "process2.0"), ("process2_1", "process2.2")):
        _conv(p[ours], f"{prefix}.{ref}", out)


def _process_block(p: Mapping[str, Any], prefix: str, out: Dict[str, torch.Tensor]) -> None:
    _feb(p["frequency_process"], f"{prefix}.frequency_process", out)
    _conv(p["cat"], f"{prefix}.cat", out)


def _ffab(p: Mapping[str, Any], prefix: str, out: Dict[str, torch.Tensor]) -> None:
    _conv(p["conv0_pre"], f"{prefix}.conv0.0", out)
    _process_block(p["conv0"], f"{prefix}.conv0.1", out)
    for name in ("conv1", "conv2", "conv3"):
        _process_block(p[name], f"{prefix}.{name}", out)
    for name in ("conv4", "conv5", "convout"):
        _process_block(p[f"{name}_pb"], f"{prefix}.{name}.0", out)
        _conv(p[f"{name}_reduce"], f"{prefix}.{name}.1", out)


def _wm(p: Mapping[str, Any], prefix: str, out: Dict[str, torch.Tensor]) -> None:
    _conv(p["convb_0"], f"{prefix}.convb.0", out)
    _conv(p["convb_1"], f"{prefix}.convb.2", out)
    out[f"{prefix}.ln.weight"] = _t(p["ln"]["scale"])
    out[f"{prefix}.ln.bias"] = _t(p["ln"]["bias"])
    m = p["model1"]
    for name in ("in_proj", "x_proj", "dt_proj", "out_proj"):
        _dense(m[name], f"{prefix}.model1.{name}", out)
    out[f"{prefix}.model1.conv1d.weight"] = _t(np.transpose(np.asarray(m["conv1d_kernel"]),
                                                            (2, 1, 0)))
    out[f"{prefix}.model1.conv1d.bias"] = _t(m["conv1d_bias"])
    out[f"{prefix}.model1.A_log"] = _t(m["A_log"])
    out[f"{prefix}.model1.D"] = _t(m["D"])
    _conv(p["smooth"], f"{prefix}.smooth", out)


def _gated_ffn(p: Mapping[str, Any], stats: Mapping[str, Any], prefix: str,
               out: Dict[str, torch.Tensor]) -> None:
    for name in ("project_in", "dwconv", "project_out"):
        _conv(p[name], f"{prefix}.{name}", out)
    for name in ("rep_conv1", "rep_conv2"):
        base, bn, st = f"{prefix}.{name}", p[name]["bn"], stats[name]["bn"]
        _conv(p[name]["c"], f"{base}.c", out)
        out[f"{base}.bn.weight"], out[f"{base}.bn.bias"] = _t(bn["scale"]), _t(bn["bias"])
        out[f"{base}.bn.running_mean"] = _t(st["mean"])
        out[f"{base}.bn.running_var"] = _t(st["var"])
        out[f"{base}.bn.num_batches_tracked"] = torch.tensor(0)


def _wmb(p: Mapping[str, Any], stats: Mapping[str, Any], prefix: str,
         out: Dict[str, torch.Tensor]) -> None:
    _layernorm2d(p["norm1"], f"{prefix}.norm1", out)
    _layernorm2d(p["norm2"], f"{prefix}.norm2", out)
    for name in ("conv1", "depth_conv", "conv2"):
        _conv(p["illu"][name], f"{prefix}.illu.{name}", out)
    _ffab(p["ffab"], f"{prefix}.ffab", out)
    _wm(p["mb"], f"{prefix}.mb", out)
    _gated_ffn(p["ffn"], stats["ffn"], f"{prefix}.ffn", out)


def wfb_state_dict_from_jax(variables_np: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX RawFormerWFB variables (``{"params", "batch_stats"}``, numpy
    leaves) -> the port's RawFormerWFB ``state_dict``."""
    p, stats = variables_np["params"], variables_np["batch_stats"]
    out: Dict[str, torch.Tensor] = {}
    for k in range(1, 8):
        base = f"conv_tran{k}"
        _wmb(p[base]["Transformer"], stats[base]["Transformer"], f"{base}.Transformer", out)
    _unet(p, out)
    return out
