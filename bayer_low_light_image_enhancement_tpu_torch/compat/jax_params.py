"""Carry weights from the JAX package's params tree into the port.

The inverses of the JAX package's ``compat/torch_import.
import_rawformer_state_dict``, ``import_wfb_state_dict``,
``import_flca_state_dict``, ``import_multilvl_flca_state_dict``,
``import_truecolor_state_dict``, ``import_luma_mhsa_state_dict``,
``import_wavkan_state_dict``, ``import_flca_unet_state_dict`` /
``import_unet_luma_dwt_state_dict``, ``import_simple_flca_unet_state_dict``
and ``import_lumachroma_transformer_state_dict``: they take the JAX
variables as numpy arrays and return a ``state_dict`` in the reference's
PyTorch names, which the port's RawFormer, RawFormerWFB, FLCARawFormer,
MultiLvlFLCARawFormer, TrueColorRawFormer, LumaMHSARawFormer,
WavKANRawFormer, TransformerFLCAUNet, SimpleFLCAUNet and
BayerLumaChromaTransformer load.

* conv kernel HWIO (kh, kw, I/g, O)        -> OIHW (O, I/g, kh, kw)
  (depthwise (3, 3, 1, C) -> (C, 1, 3, 3) by the same transpose)
* Upsample2x 1x1 kernel (1, 1, I, 4O), column o*4 + di*2 + dj
                                             -> ConvTranspose2d (I, O, 2, 2)
* attention temperature or log_temperature (heads,) -> (heads, 1, 1)
  (WavKAN's as ``attn.scale``)
* FLCA balances alpha / beta / gamma ()     -> () (likewise the colour
  correction's gamma, ``gamma_param`` in BayerTORGB)
* LayerNorm weight / bias                   -> ``norm*.body.*``
* Dense kernel (I, O)                       -> Linear weight (O, I)
* MultiHeadDotProductAttention query / key / value kernels (C, heads, hd)
  and biases (heads, hd)                    -> ``in_proj_weight`` [3C, C] /
                                               ``in_proj_bias`` [3C];
  out kernel (heads, hd, C)                 -> ``out_proj.weight`` [C, C]
* flax LayerNorm scale / bias               -> ``weight`` / ``bias``
* Mamba conv1d kernel (d_conv, 1, D)        -> Conv1d weight (D, 1, d_conv)
* KANLinear scale / translation / wavelet_weights / weight (out, in)
                                             -> the same (out, in)
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
        _upsample(p[f"up{j}"], f"up{j}", out)
        _conv(p[f"channel_reduce{j}"], f"channel_reduce{j}", out)
    _conv(p["conv_out"], "conv_out", out)


def _upsample(p: Mapping[str, Any], prefix: str, out: Dict[str, torch.Tensor]) -> None:
    """Upsample2x's 1x1 kernel (1, 1, I, 4O) -> ConvTranspose2d (I, O, 2, 2)."""
    up = np.asarray(p["kernel"])
    i, o4 = up.shape[2], up.shape[3]
    out[f"{prefix}.weight"] = _t(up.reshape(i, o4 // 4, 2, 2))
    out[f"{prefix}.bias"] = _t(p["bias"])


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
        _conv(p[name]["c"], f"{prefix}.{name}.c", out)
        _batchnorm(p[name]["bn"], stats[name]["bn"], f"{prefix}.{name}.bn", out)


def _batchnorm(p: Mapping[str, Any], stats: Mapping[str, Any], prefix: str,
               out: Dict[str, torch.Tensor]) -> None:
    out[f"{prefix}.weight"], out[f"{prefix}.bias"] = _t(p["scale"]), _t(p["bias"])
    out[f"{prefix}.running_mean"] = _t(stats["mean"])
    out[f"{prefix}.running_var"] = _t(stats["var"])
    out[f"{prefix}.num_batches_tracked"] = torch.tensor(0)


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


def _luma_mhsa(p: Mapping[str, Any], prefix: str, out: Dict[str, torch.Tensor]) -> None:
    """A LuminanceAwareMHSA: ``to_qkv``, ``luma_cond.net.0`` / ``.net.2`` /
    ``gamma`` / ``beta``, the scalar ``alpha``, ``proj``."""
    _conv(p["to_qkv"], f"{prefix}.to_qkv", out)
    for ours, ref in (("net0", "net.0"), ("net1", "net.2"), ("gamma", "gamma"), ("beta", "beta")):
        _conv(p["luma_cond"][ours], f"{prefix}.luma_cond.{ref}", out)
    out[f"{prefix}.alpha"] = _t(np.asarray(p["alpha"]).reshape(()))
    _conv(p["proj"], f"{prefix}.proj", out)


def luma_mhsa_state_dict_from_jax(params_np: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX LumaMHSARawFormer params -> the port's
    ``models.luma_variants.LumaMHSARawFormer`` ``state_dict`` (the
    reference's names: ``attn.luma_cond.net.0`` / ``.net.2``, ``attn.alpha``,
    ``output.0``)."""
    p = params_np.get("params", params_np)
    out: Dict[str, torch.Tensor] = {}
    _conv(p["embedding"], "embedding", out)
    for name in ("enc1", "enc2", "enc3", "bottleneck", "dec1", "dec2", "dec3"):
        blk = p[name]
        _layernorm2d(blk["norm1"], f"{name}.norm1", out)
        _luma_mhsa(blk["attn"], f"{name}.attn", out)
        _layernorm2d(blk["norm2"], f"{name}.norm2", out)
        for ffn in ("pointwise1", "depthwise", "pointwise2"):
            _conv(blk["ffn"][ffn], f"{name}.ffn.{ffn}", out)
    for j in range(1, 4):
        _conv(p[f"down{j}"]["conv"], f"down{j}.body.0", out)
        _upsample(p[f"up{j}"], f"up{j}", out)
        _conv(p[f"proj{j}"], f"proj{j}", out)
    _conv(p["output_conv"], "output.0", out)
    return out


def _kan_linear(p: Mapping[str, Any], stats: Mapping[str, Any], prefix: str,
                out: Dict[str, torch.Tensor]) -> None:
    """A KANLinear: its [out, in] matrices as they are, its BatchNorm."""
    for name in ("scale", "translation", "wavelet_weights", "weight"):
        out[f"{prefix}.{name}"] = _t(p[name])
    _batchnorm(p["bn"], stats["bn"], f"{prefix}.bn", out)


def _kan_stage(p: Mapping[str, Any], stats: Mapping[str, Any], prefix: str,
               out: Dict[str, torch.Tensor]) -> None:
    """A KANConvTransformer in the reference's names (``transformer.attn.qkv.0``
    / ``.1``, ``transformer.attn.scale``, ``transformer.ffn.net.0`` / ``.1`` /
    ``.3``, ``reduce``, ``out.0``)."""
    t = f"{prefix}.transformer"
    _conv(p["conv"], f"{prefix}.conv", out)
    _layernorm2d(p["norm1"], f"{t}.norm1", out)
    _kan_linear(p["attn"]["qkv_kan"], stats["attn"]["qkv_kan"], f"{t}.attn.qkv.0", out)
    _conv(p["attn"]["qkv_dwconv"], f"{t}.attn.qkv.1", out)
    out[f"{t}.attn.scale"] = _t(np.asarray(p["attn"]["temperature"]).reshape(-1, 1, 1))
    _kan_linear(p["attn"]["proj"], stats["attn"]["proj"], f"{t}.attn.proj", out)
    _layernorm2d(p["norm2"], f"{t}.norm2", out)
    _kan_linear(p["ffn"]["kan1"], stats["ffn"]["kan1"], f"{t}.ffn.net.0", out)
    _conv(p["ffn"]["dwconv"], f"{t}.ffn.net.1", out)
    _kan_linear(p["ffn"]["kan2"], stats["ffn"]["kan2"], f"{t}.ffn.net.3", out)
    _kan_linear(p["reduce"], stats["reduce"], f"{prefix}.reduce", out)
    _conv(p["out_conv"], f"{prefix}.out.0", out)


def wavkan_state_dict_from_jax(variables_np: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX WavKANRawFormer variables (``{"params", "batch_stats"}``, numpy
    leaves) -> the port's ``models.wavkan.WavKANRawFormer`` ``state_dict``."""
    if "batch_stats" not in variables_np:
        raise ValueError('WavKAN-RawFormer loads its {"params", "batch_stats"} variables')
    p, stats = variables_np["params"], variables_np["batch_stats"]
    out: Dict[str, torch.Tensor] = {}
    _conv(p["embed"], "embed", out)
    for i in range(3):
        _kan_stage(p[f"enc{i}"], stats[f"enc{i}"], f"encoder.{i}", out)
        _conv(p[f"down{i}_conv"], f"downsamples.{i}.net.0", out)
        _kan_stage(p[f"dec{i}"], stats[f"dec{i}"], f"decoder.{i}", out)
        _upsample(p[f"up{i}"], f"upsamples.{i}", out)
    _kan_stage(p["bottleneck"], stats["bottleneck"], "bottleneck", out)
    _conv(p["out_conv"], "output.0", out)
    return out


def _token_transformer(p: Mapping[str, Any], prefix: str, out: Dict[str, torch.Tensor],
                       norms=("norm1", "norm2")) -> None:
    """A JAX token transformer (``ln1`` / ``attn`` / ``ln2`` / ``mlp1`` /
    ``mlp2``, and ``local_dw`` in the local-enhance one) -> the reference's
    names: ``norms``, ``attn.in_proj_weight`` [3C, C] (the q / k / v kernels
    (C, heads, hd) transposed and stacked), ``attn.in_proj_bias``,
    ``attn.out_proj`` (the out kernel (heads, hd, C) as [C, C]),
    ``mlp.0`` / ``mlp.2``, ``local_enhance.0``."""
    for jax_name, name in zip(("ln1", "ln2"), norms):
        out[f"{prefix}.{name}.weight"] = _t(p[jax_name]["scale"])
        out[f"{prefix}.{name}.bias"] = _t(p[jax_name]["bias"])
    a = p["attn"]
    qkv = [np.asarray(a[n]["kernel"]) for n in ("query", "key", "value")]
    out[f"{prefix}.attn.in_proj_weight"] = _t(np.concatenate(
        [k.reshape(k.shape[0], -1).T for k in qkv], 0))
    out[f"{prefix}.attn.in_proj_bias"] = _t(np.concatenate(
        [np.asarray(a[n]["bias"]).reshape(-1) for n in ("query", "key", "value")]))
    wo = np.asarray(a["out"]["kernel"])
    out[f"{prefix}.attn.out_proj.weight"] = _t(wo.reshape(-1, wo.shape[-1]).T)
    out[f"{prefix}.attn.out_proj.bias"] = _t(a["out"]["bias"])
    _dense(p["mlp1"], f"{prefix}.mlp.0", out)
    _dense(p["mlp2"], f"{prefix}.mlp.2", out)
    if "local_dw" in p:
        _conv(p["local_dw"], f"{prefix}.local_enhance.0", out)


def _resca(p: Mapping[str, Any], prefix: str, out: Dict[str, torch.Tensor]) -> None:
    """A ResCA: the ResBlock's raw ``conv1_kernel`` / ``conv1_bias`` and its
    ``conv2`` as ``rb.body.0`` / ``.2``, the SE gate."""
    rb = p["rb"]
    _conv({"kernel": rb["conv1_kernel"], "bias": rb["conv1_bias"]}, f"{prefix}.rb.body.0", out)
    _conv(rb["conv2"], f"{prefix}.rb.body.2", out)
    _se(p["se"], f"{prefix}.se", out)


def flca_unet_state_dict_from_jax(params_np: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX TransformerFLCAUNet params, either guidance (the pool and the DWT
    FLCA share their names; ``enh_conv`` / ``enh_out`` mark "dwt") -> the
    port's ``models.flca_unet.TransformerFLCAUNet`` ``state_dict``."""
    p = params_np.get("params", params_np)
    out: Dict[str, torch.Tensor] = {}
    for i in (1, 2, 3):
        e, pre = p[f"enc{i}"], f"enc{i}"
        _conv(e["in_conv"], f"{pre}.in_conv", out)
        for j in range(sum(k.startswith("block") for k in e)):
            _resca(e[f"block{j}"], f"{pre}.blocks.{j}", out)
        _flca(e["flca"], f"{pre}.flca", out)
        _conv(e["down"], f"{pre}.down", out)
        d, pre = p[f"dec{i}"], f"dec{i}"
        _upsample(d["up"], f"{pre}.up", out)
        _conv(d["fuse_conv"], f"{pre}.fuse.0", out)
        _resca(d["resca1"], f"{pre}.fuse.2", out)
        _resca(d["resca2"], f"{pre}.fuse.3", out)
    _conv(p["down_bott"], "down_bott", out)
    _token_transformer(p["trans"], "trans", out, norms=("ln1", "ln2"))
    _upsample(p["up_bott"], "up_bott", out)
    _conv(p["tail_conv"], "tail.0", out)
    _conv(p["tail_out"], "tail.2", out)
    if "enh_conv" in p:
        _conv(p["enh_conv"], "enhTail.0", out)
        _conv(p["enh_out"], "enhTail.2", out)
    return out


def simple_flca_unet_state_dict_from_jax(params_np: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX SimpleFLCAUNet params -> the port's
    ``models.luma_variants.SimpleFLCAUNet`` ``state_dict`` (conv blocks as
    ``enc{i}.0`` / ``.2``, the FLCAs' convs with bias)."""
    p = params_np.get("params", params_np)
    out: Dict[str, torch.Tensor] = {}
    for i in (1, 2, 3):
        for blk in (f"enc{i}", f"dec{i}"):
            _conv(p[blk]["conv1"], f"{blk}.0", out)
            _conv(p[blk]["conv2"], f"{blk}.2", out)
        _token_transformer(p[f"trans{i}"], f"trans{i}", out)
        _upsample(p[f"up{i}"], f"up{i}", out)
    _token_transformer(p["bottleneck"], "bottleneck", out)
    for name in ("flca1", "flca2", "flca3", "flca_bottleneck"):
        for attn in ("low_attn", "high_attn", "chroma_attn"):
            _conv(p[name][attn], f"{name}.{attn}.0", out)
    _conv(p["final"], "final", out)
    return out


def lumachroma_state_dict_from_jax(params_np: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX BayerLumaChromaTransformer params -> the port's
    ``models.lumachroma_transformer.BayerLumaChromaTransformer``
    ``state_dict`` (InstanceNorm blocks' convs at ``.0`` / ``.3``, the
    bottleneck as ``bottleneck.conv_down`` / ``trans`` / ``flca`` /
    ``conv_up``)."""
    p = params_np.get("params", params_np)
    out: Dict[str, torch.Tensor] = {}

    def flca(q, prefix):
        for name in ("low_attn", "high_attn", "chroma_attn"):
            _conv(q[name], f"{prefix}.{name}.0", out)
        _conv(q["refine"], f"{prefix}.refine", out)

    for i in (1, 2, 3):
        e = f"enc{i}"
        _conv(p[f"{e}_in"], f"{e}.in_conv", out)
        j = 0
        while f"{e}_block{j}" in p:
            _conv(p[f"{e}_block{j}"]["conv1"], f"{e}.blocks.{j}.0", out)
            _conv(p[f"{e}_block{j}"]["conv2"], f"{e}.blocks.{j}.3", out)
            j += 1
        _token_transformer(p[f"{e}_trans"], f"{e}.trans", out)
        flca(p[f"{e}_flca"], f"{e}.flca")
        _conv(p[f"{e}_down"], f"{e}.down", out)
        d = f"dec{i}"
        _upsample(p[f"{d}_up"], f"{d}.up", out)
        _conv(p[f"{d}_fuse1"], f"{d}.fuse.0", out)
        _conv(p[f"{d}_fuse2"], f"{d}.fuse.3", out)
    _conv(p["bott_down"], "bottleneck.conv_down", out)
    _token_transformer(p["bott_trans"], "bottleneck.trans", out)
    flca(p["bott_flca"], "bottleneck.flca")
    _upsample(p["bott_up"], "bottleneck.conv_up", out)
    _conv(p["tail_conv"], "tail.0", out)
    _conv(p["tail_out"], "tail.2", out)
    if "res_proj" in p:
        _conv(p["res_proj"], "res_proj", out)
    return out
