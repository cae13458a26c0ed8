"""Fused ConvTransformer stage tail (T1).

Port of the retired TPU kernel ``attic/fused_stage.py::fused_stage_tail``,
which no model of the JAX package calls: the three convs a ConvTransformer
stage wraps around its TransformerBlock, on NHWC x (the stage input) and t
(the block's output),

  conv = lrelu(conv3x3(x) + b_c)
  y    = conv @ Wr[:C] + t @ Wr[C:] + b_r      (the concat folded into the
                                                split reduce weight)
  out  = lrelu(conv3x3(y) + b_o)

with SAME zero padding and slope 0.2. ``params`` holds the port's
``ConvTransformer`` names ``conv.*``, ``channel_reduce.*``, ``Conv_out.*``
(other keys, such as the block's, are ignored). ``fused_stage_tail_plain``
is the fp32 twin; the wrapper runs it on a CPU tensor and launches T1
(``csrc/fused_stage.cu``) on a CUDA tensor, or raises.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import torch
import torch.nn.functional as F

from bayer_low_light_image_enhancement_tpu_torch.kernels import _build
from bayer_low_light_image_enhancement_tpu_torch.kernels.fused_block import (
    bf16,
    check_kernel_input,
    f32,
    require,
)


@dataclasses.dataclass(frozen=True)
class TailWeights:
    """A stage tail's weights (fp32): 3x3 taps [9, in, out] (tap di*3+dj),
    the reduce weight's halves [in, out]."""

    wc: torch.Tensor   # [9, C, C]
    bc: torch.Tensor   # [C]
    wr1: torch.Tensor  # [C, C]  applied to conv
    wr2: torch.Tensor  # [C, C]  applied to t
    br: torch.Tensor   # [C]
    wo: torch.Tensor   # [9, C, C]
    bo: torch.Tensor   # [C]

    def tensors(self):
        return [getattr(self, f.name) for f in dataclasses.fields(self)]


def tail_weights(params: Mapping[str, torch.Tensor]) -> TailWeights:
    p = {k: params[k].float() for k in ("conv.weight", "conv.bias", "channel_reduce.weight",
                                        "channel_reduce.bias", "Conv_out.weight",
                                        "Conv_out.bias")}
    c = p["conv.weight"].shape[0]

    def taps(k):  # OIHW -> [9, in, out]
        return k.permute(2, 3, 1, 0).reshape(9, c, c)

    wr = p["channel_reduce.weight"][:, :, 0, 0].t()  # [2C, C]
    return TailWeights(wc=taps(p["conv.weight"]), bc=p["conv.bias"], wr1=wr[:c], wr2=wr[c:],
                       br=p["channel_reduce.bias"], wo=taps(p["Conv_out.weight"]),
                       bo=p["Conv_out.bias"])


def _conv3x3(z: torch.Tensor, taps: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Full 3x3 conv, zero padding, on NHWC; taps [9, in, out]."""
    c_in, c_out = taps.shape[1:]
    w = taps.reshape(3, 3, c_in, c_out).permute(3, 2, 0, 1)
    return F.conv2d(z.permute(0, 3, 1, 2), w, bias, padding=1).permute(0, 2, 3, 1)


def fused_stage_tail_plain(x: torch.Tensor, t: torch.Tensor,
                           params: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """T1's twin on any device: x, t [B,H,W,C] -> [B,H,W,C] fp32."""
    w = tail_weights(params)
    conv = F.leaky_relu(_conv3x3(x.float(), w.wc, w.bc), 0.2)
    y = conv @ w.wr1 + t.float() @ w.wr2 + w.br
    return F.leaky_relu(_conv3x3(y, w.wo, w.bo), 0.2)


def fused_stage_tail(x: torch.Tensor, t: torch.Tensor,
                     params: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """The stage tail on x, t [B,H,W,C] -> [B,H,W,C] in x's dtype.

    CPU: the plain twin. CUDA: kernel T1 on bf16 x and t, or raise.
    Inference only: raises when grad is enabled on an input that requires
    grad."""
    if not x.is_cuda:
        return fused_stage_tail_plain(x, t, params).to(x.dtype)
    return _fused_stage_tail_kernel(x, t, params)


def _fused_stage_tail_kernel(x, t, params):
    w = tail_weights(params)
    check_kernel_input(x, t, *w.tensors())
    b, h, wd, c = x.shape
    xk, tk = x.to(torch.bfloat16).contiguous(), t.to(torch.bfloat16).contiguous()
    require(tk, "t", x.shape, x.device)
    args = [bf16(w.wc), f32(w.bc), bf16(w.wr1), bf16(w.wr2), f32(w.br), bf16(w.wo), f32(w.bo)]
    for i, (v, s) in enumerate(zip(args, ((9, c, c), (c,), (c, c), (c, c), (c,), (9, c, c),
                                          (c,)))):
        require(v, f"stage tail argument {i}", s, x.device)
    out = torch.empty_like(xk)
    err = _build.library().blle_stage_tail(
        xk.data_ptr(), tk.data_ptr(), *(v.data_ptr() for v in args), out.data_ptr(),
        b, h, wd, c, _build.stream_of(x))
    _build.check(err, "fused stage tail")
    fused_stage_tail.launches += 1
    return out.to(x.dtype)


fused_stage_tail.launches = 0
