"""Carry weights from the JAX package's params tree into the port.

The inverses of the JAX package's ``compat/torch_import.
import_rawformer_state_dict``, ``import_wfb_state_dict``,
``import_flca_state_dict``, ``import_multilvl_flca_state_dict`` and
``import_truecolor_state_dict``: they take the JAX variables as numpy
arrays and return a ``state_dict`` in the reference's PyTorch names, which
the port's RawFormer, RawFormerWFB, FLCARawFormer, MultiLvlFLCARawFormer
and TrueColorRawFormer load.

* conv kernel HWIO (kh, kw, I/g, O)        -> OIHW (O, I/g, kh, kw)
  (depthwise (3, 3, 1, C) -> (C, 1, 3, 3) by the same transpose)
* Upsample2x 1x1 kernel (1, 1, I, 4O), column o*4 + di*2 + dj
                                             -> ConvTranspose2d (I, O, 2, 2)
* attention temperature or log_temperature (heads,) -> (heads, 1, 1)
* FLCA balances alpha / beta / gamma ()     -> () (likewise the colour
  correction's gamma, ``gamma_param`` in BayerTORGB)
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


def channel_attention_state_dict(p: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """One ChannelAttention's JAX params -> ``models.common.ChannelAttention``
    state_dict (names relative to the module), the params of
    ``kernels.fused_attention.fused_channel_attention``. A block of
    ``log_temperature=True`` carries ``log_temperature`` instead of
    ``temperature``."""
    name = "log_temperature" if "log_temperature" in p else "temperature"
    out = {name: _t(np.asarray(p[name]).reshape(-1, 1, 1))}
    for name in ("qkv", "qkv_dwconv", "project_out"):
        _conv(p[name], name, out)
    return out


def stage_tail_state_dict(p: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A ConvTransformer's JAX ``conv`` / ``channel_reduce`` / ``conv_out``
    params -> the port's ``conv.*`` / ``channel_reduce.*`` / ``Conv_out.*``
    (names relative to the stage), the params of
    ``kernels.fused_stage.fused_stage_tail``."""
    out: Dict[str, torch.Tensor] = {}
    for jax_name, name in (("conv", "conv"), ("channel_reduce", "channel_reduce"),
                           ("conv_out", "Conv_out")):
        _conv(p[jax_name], name, out)
    return out


def transformer_block_state_dict(p: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """One TransformerBlock's JAX params -> ``models.common.TransformerBlock``
    state_dict (names relative to the block)."""
    out: Dict[str, torch.Tensor] = {}
    for norm in ("norm1", "norm2"):
        out[f"{norm}.body.weight"] = _t(p[norm]["weight"])
        out[f"{norm}.body.bias"] = _t(p[norm]["bias"])
    for name, v in channel_attention_state_dict(p["attn"]).items():
        out[f"attn.{name}"] = v
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
    for k in range(1, 8):
        base = f"conv_tran{k}"
        for name, v in stage_tail_state_dict(p[base]).items():
            out[f"{base}.{name}"] = v
    _skeleton(p, out)


def _skeleton(p: Mapping[str, Any], out: Dict[str, torch.Tensor],
              down: str = "body.0") -> None:
    """The U-Net around the stages: embedding, ``down{j}.<down>``, ``up{j}``,
    ``channel_reduce{j}``, ``conv_out``."""
    _conv(p["embedding"], "embedding", out)
    for j in range(1, 4):
        _conv(p[f"down{j}"]["conv"], f"down{j}.{down}", out)
        up = np.asarray(p[f"up{j}"]["kernel"])  # (1, 1, I, 4O)
        i, o4 = up.shape[2], up.shape[3]
        out[f"up{j}.weight"] = _t(up.reshape(i, o4 // 4, 2, 2))
        out[f"up{j}.bias"] = _t(p[f"up{j}"]["bias"])
        _conv(p[f"channel_reduce{j}"], f"channel_reduce{j}", out)
    _conv(p["conv_out"], "conv_out", out)


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
    if "batch_stats" not in variables_np:
        raise ValueError('RawFormer-WFB loads its {"params", "batch_stats"} variables')
    p, stats = variables_np["params"], variables_np["batch_stats"]
    out: Dict[str, torch.Tensor] = {}
    for k in range(1, 8):
        base = f"conv_tran{k}"
        _wmb(p[base]["Transformer"], stats[base]["Transformer"], f"{base}.Transformer", out)
    _unet(p, out)
    return out


def _se(p: Mapping[str, Any], prefix: str, out: Dict[str, torch.Tensor]) -> None:
    """SE gate: the reference's Sequential, convs at indices 1 and 3."""
    _conv(p["fc1"], f"{prefix}.1", out)
    _conv(p["fc2"], f"{prefix}.3", out)


def _flca(p: Mapping[str, Any], prefix: str, out: Dict[str, torch.Tensor]) -> None:
    for name in ("low_attn", "high_attn", "chroma_attn"):
        _conv(p[name], f"{prefix}.{name}.0", out)
    _se(p["se"], f"{prefix}.se", out)
    for name in ("alpha", "beta", "gamma"):
        out[f"{prefix}.{name}"] = _t(p[name])


def _flca_pyramid(p: Mapping[str, Any], prefix: str, out: Dict[str, torch.Tensor]) -> None:
    levels = sum(1 for k in p if k.startswith("low_attn_"))
    for l in range(levels):
        _conv(p[f"low_attn_{l}"], f"{prefix}.low_attn.{l}.0", out)
        _conv(p[f"high_attn_{l}"], f"{prefix}.high_attn.{l}.0", out)
        _conv(p[f"freq_gate_{l}"], f"{prefix}.freq_gate_head.{l}", out)
    _conv(p["chroma_attn"], f"{prefix}.chroma_attn.0", out)
    _conv(p["chroma_gate"], f"{prefix}.chroma_gate", out)
    _se(p["se"], f"{prefix}.se", out)
    _conv(p["res_proj_0"], f"{prefix}.res_proj.0", out)
    _conv(p["res_proj_1"], f"{prefix}.res_proj.2", out)


def _enhanced_flca(p: Mapping[str, Any], prefix: str, out: Dict[str, torch.Tensor]) -> None:
    for name in ("color_attention", "low_attn", "high_attn"):
        _conv(p[name], f"{prefix}.{name}.0", out)
    _se(p["se"], f"{prefix}.se", out)
    if "res_proj_0" in p:
        _conv(p["res_proj_0"], f"{prefix}.res_proj.0", out)
        _conv(p["res_proj_1"], f"{prefix}.res_proj.2", out)


def _bayer_processor(p: Mapping[str, Any], prefix: str, out: Dict[str, torch.Tensor]) -> None:
    """Both wirings: the same names, other ``demosaic_refine`` shapes."""
    out[f"{prefix}.wb_gains"] = _t(p["wb_gains"])
    out[f"{prefix}.color_matrix"] = _t(p["color_matrix"])
    for name in ("demosaic_refine", "chroma_extractor"):
        _conv(p[f"{name}_0"], f"{prefix}.{name}.0", out)
        _conv(p[f"{name}_1"], f"{prefix}.{name}.2", out)


def _color_correction(p: Mapping[str, Any], prefix: str, out: Dict[str, torch.Tensor],
                      bounded: bool) -> None:
    """The bounded (BayerTORGB) correction stores its gamma as ``gamma_param``."""
    gamma = "gamma_param" if bounded else "gamma"
    out[f"{prefix}.{gamma}"] = _t(np.asarray(p["gamma"]).reshape(()))
    for name in ("color_transform", "tone_curve"):
        _conv(p[f"{name}_0"], f"{prefix}.{name}.0", out)
        _conv(p[f"{name}_1"], f"{prefix}.{name}.2", out)


def _guided_stages(p: Mapping[str, Any], out: Dict[str, torch.Tensor], flca) -> None:
    """The seven guided stages: ``FLCA`` (through ``flca``), ``Transformer``,
    ``channel_reduce``, ``Conv_out``."""
    for k in range(1, 8):
        base = f"conv_tran{k}"
        flca(p[base]["FLCA"], f"{base}.FLCA", out)
        for name, v in transformer_block_state_dict(p[base]["Transformer"]).items():
            out[f"{base}.Transformer.{name}"] = v
        _conv(p[base]["channel_reduce"], f"{base}.channel_reduce", out)
        _conv(p[base]["Conv_out"], f"{base}.Conv_out", out)


def flca_state_dict_from_jax(params_np: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX FLCARawFormer params (numpy leaves) -> the port's
    ``models.flca_rawformer.FLCARawFormer`` ``state_dict``."""
    p = params_np.get("params", params_np)
    out: Dict[str, torch.Tensor] = {}
    _guided_stages(p, out, _flca)
    _skeleton(p, out)
    return out


def multilvl_flca_state_dict_from_jax(params_np: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX MultiLvlFLCARawFormer params -> the port's
    ``models.multilvl_flca.MultiLvlFLCARawFormer`` ``state_dict`` (its
    downsamples are bare Sequentials: ``down{j}.0``)."""
    p = params_np.get("params", params_np)
    out: Dict[str, torch.Tensor] = {}
    _guided_stages(p, out, _flca_pyramid)
    _skeleton(p, out, down="0")
    return out


def truecolor_state_dict_from_jax(params_np: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX TrueColorRawFormer params (canonical or BayerTORGB, told apart by
    the pyramid FLCA's ``res_proj``) -> the port's
    ``models.truecolor.TrueColorRawFormer`` ``state_dict``. The BayerTORGB
    colour correction stores its gamma as ``gamma_param``."""
    p = params_np.get("params", params_np)
    out: Dict[str, torch.Tensor] = {}
    _bayer_processor(p["bayer_processor"], "bayer_processor", out)
    _guided_stages(p, out, _enhanced_flca)
    _skeleton(p, out)
    bounded = "res_proj_0" in p["conv_tran1"]["FLCA"]
    _color_correction(p["color_correction"], "color_correction", out, bounded)
    return out
