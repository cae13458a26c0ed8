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
(``csrc/fused_stage.cu``: two kernels split at y, each on 8 x 16-pixel
tiles with the weights in shared memory, wgmma at C = 128, 192, 256) on a
CUDA tensor, or raises. ``tail_config`` / ``tail_plan`` mirror the kernels'
plans; ``module_tail`` is the library path T1 is timed beside.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Mapping, Tuple

import torch
import torch.nn.functional as F

from bayer_low_light_image_enhancement_tpu_torch.kernels import _build
from bayer_low_light_image_enhancement_tpu_torch.kernels.arg_cache import ArgCache
from bayer_low_light_image_enhancement_tpu_torch.kernels.fused_block import (
    KERNEL_WIDTHS,
    SMEM_PER_BLOCK,
    SMEM_PER_SM,
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


_TAIL_KEYS = ("conv.weight", "conv.bias", "channel_reduce.weight", "channel_reduce.bias",
              "Conv_out.weight", "Conv_out.bias")


def tail_weights(params: Mapping[str, torch.Tensor]) -> TailWeights:
    p = {k: params[k].float() for k in _TAIL_KEYS}
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


def module_tail(stage: torch.nn.Module, x4: torch.Tensor, t4: torch.Tensor) -> torch.Tensor:
    """The same tail through a ``ConvTransformer`` module's own layers (cuDNN
    convs, LeakyReLUs, the concat and the reduce) on NCHW x4, t4: the library
    path T1 is timed beside. The wrapper never calls it."""
    act = F.leaky_relu
    conv = act(stage.conv(x4), 0.2)
    return act(stage.Conv_out(stage.channel_reduce(torch.cat([conv, t4], 1))), 0.2)


# ----------------------------------------------------------------------------
# T1's plan (csrc/fused_stage.cu): two kernels, "conv" (x, t -> y) and "out"
# (y -> out), each on 8 x 16-pixel tiles of the call walked by a persistent
# grid.
# ----------------------------------------------------------------------------

TAIL_KINDS = ("conv", "out")
TAIL_TH, TAIL_TW, TAIL_THREADS = 8, 16, 256


def _a128(n: int) -> int:
    return -(-n // 128) * 128


@dataclasses.dataclass(frozen=True)
class TailConfig:
    """One T1 kernel's shape at one width (``TailCfg`` of fused_stage.cu):
    tile th x tw own pixels (a 1-pixel halo around), threads, shared memory
    bytes, CTAs an SM it is sized for; its weights resident in shared memory
    or streamed in chunks of ``kc`` K rows through ``slots`` cp.async slots;
    ``windows`` window buffers (2: the next tile's prefetched); ``vx``: conv
    kept over the dead x window (the conv kernel at C = 256); ``wgmma``: the
    products on wgmma (A from registers, swizzled weight chunks: C = 128,
    192, 256), else mma.sync."""

    th: int
    tw: int
    threads: int
    smem: int
    per_sm: int
    resident: bool
    kc: int
    slots: int
    windows: int
    vx: bool
    wgmma: bool


def _tail_smem(c: int, kind: int, windows: int, vx: bool, slots: int) -> int:
    ld, kc = c + 8, c if c <= 64 else 96 if c == 96 else 64
    head = windows * _a128(180 * ld * 2) + ((1 if vx else 2) * _a128(128 * ld * 2) if kind == 0
                                            else 0)
    if c <= 64:
        return head + _a128((11 if kind == 0 else 9) * c * ld * 2)
    if c % 64 == 0:  # wgmma: ring barriers, then unpadded slots from a 1024-byte boundary
        return head + 64 + 1024 + slots * kc * c * 2
    return head + slots * _a128(kc * ld * 2)


def _per_sm(smem: int) -> int:
    return 2 if 2 * (smem + 1024) <= SMEM_PER_SM else 1


@functools.lru_cache(maxsize=None)
def tail_config(kind: str, c: int) -> TailConfig:
    """``TailCfg`` at width c: weights resident at c <= 64; conv over the x
    window only where t, conv and two slots do not fit beside one window;
    three slots where they fit, else two; two windows where they fit
    without losing a CTA an SM; wgmma at c = 128, 192, 256."""
    if kind not in TAIL_KINDS:
        raise ValueError(f"kind must be one of {TAIL_KINDS}, got {kind!r}")
    if c not in KERNEL_WIDTHS:
        raise ValueError(f"no kernel for C={c}; widths: {KERNEL_WIDTHS}")
    k, res = TAIL_KINDS.index(kind), c <= 64
    kc = c if res else 96 if c == 96 else 64
    vx = k == 0 and _tail_smem(c, k, 1, False, 2) > SMEM_PER_BLOCK
    slots = 0 if res else 3 if _tail_smem(c, k, 1, vx, 3) <= SMEM_PER_BLOCK else 2
    two = _tail_smem(c, k, 2, vx, slots)
    windows = 2 if (not vx and two <= SMEM_PER_BLOCK
                    and _per_sm(two) == _per_sm(_tail_smem(c, k, 1, vx, slots))) else 1
    smem = _tail_smem(c, k, windows, vx, slots)
    return TailConfig(TAIL_TH, TAIL_TW, TAIL_THREADS, smem, _per_sm(smem), res, kc, slots,
                      windows, vx, c > 64 and c % 64 == 0)


@dataclasses.dataclass(frozen=True)
class TailPlan:
    """T1's launches at one shape: ``tiles`` over the call (B x tiles an
    image), each kernel's persistent CTAs (at most one per tile)."""

    conv: TailConfig
    out: TailConfig
    tiles: int
    ctas_conv: int
    ctas_out: int


def tail_plan(b: int, h: int, w: int, c: int, resident_conv: int, resident_out: int) -> TailPlan:
    """The launch for x [b, h, w, c], given the CTAs of each kernel the card
    holds at once (blocks per SM times the SMs)."""
    tiles = b * -(-h // TAIL_TH) * -(-w // TAIL_TW)
    return TailPlan(tail_config("conv", c), tail_config("out", c), tiles,
                    min(tiles, resident_conv), min(tiles, resident_out))


@functools.lru_cache(maxsize=None)
def tail_kernel_info(kind: str, c: int) -> Tuple[int, ...]:
    """The library's plan of T1's ``kind`` kernel at width c on the current
    card: (th, tw, threads, shared-memory bytes, blocks per SM, resident,
    kc, slots, windows, vx, wgmma)."""
    info = (ctypes.c_longlong * 11)()
    _build.check(_build.library().blle_stage_tail_info(TAIL_KINDS.index(kind), c, info),
                 f"stage tail info ({kind}, C={c})")
    return tuple(info)


@functools.lru_cache(maxsize=1024)
def plan_for(b: int, h: int, w: int, c: int, device_index: int) -> TailPlan:
    """The plan the wrapper launches (``tail_plan`` at the card's
    residency), cached per shape."""
    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    return tail_plan(b, h, w, c, tail_kernel_info("conv", c)[4] * sms,
                     tail_kernel_info("out", c)[4] * sms)


def fused_stage_tail(x: torch.Tensor, t: torch.Tensor,
                     params: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """The stage tail on x, t [B,H,W,C] -> [B,H,W,C] in x's dtype.

    CPU: the plain twin. CUDA: kernel T1 on bf16 x and t, or raise.
    Inference only: raises when grad is enabled on an input that requires
    grad."""
    if not x.is_cuda:
        return fused_stage_tail_plain(x, t, params).to(x.dtype)
    return _fused_stage_tail_kernel(x, t, params)


# T1's kernel arguments, made once per version of the six source tensors.
_ARGS = ArgCache()


def _kernel_args(params: Mapping[str, torch.Tensor]):
    """[w1, bc, br, w2, bo] as T1 takes them: w1 the [11 C, C] bf16 rows of
    conv's taps [9, C, C], then the reduce weight's halves wr1 and wr2; w2
    Conv_out's taps [9 C, C] bf16; fp32 biases. Made once per weight version
    (``arg_cache``)."""

    def make():
        w = tail_weights(params)
        c = w.bc.shape[0]
        w1 = bf16(torch.cat([w.wc.reshape(9 * c, c), w.wr1, w.wr2]))
        return [w1, f32(w.bc), f32(w.br), bf16(w.wo.reshape(9 * c, c)), f32(w.bo)]

    return _ARGS.get([params[k] for k in _TAIL_KEYS], make)


def _fused_stage_tail_kernel(x, t, params):
    src = [params[k] for k in _TAIL_KEYS]
    check_kernel_input(x, t, *src)
    b, h, wd, c = x.shape
    xk, tk = x.to(torch.bfloat16).contiguous(), t.to(torch.bfloat16).contiguous()
    require(tk, "t", x.shape, x.device)
    args = _kernel_args(params)
    for i, (v, s) in enumerate(zip(args, ((11 * c, c), (c,), (c,), (9 * c, c), (c,)))):
        require(v, f"stage tail argument {i}", s, x.device)
    plan = plan_for(b, h, wd, c, x.device.index or 0)
    ybuf, out = torch.empty_like(xk), torch.empty_like(xk)
    err = _build.library().blle_stage_tail(
        xk.data_ptr(), tk.data_ptr(), *(v.data_ptr() for v in args), ybuf.data_ptr(),
        out.data_ptr(), b, h, wd, c, plan.ctas_conv, plan.ctas_out, _build.stream_of(x))
    _build.check(err, "fused stage tail")
    fused_stage_tail.launches += 1
    return out.to(x.dtype)


fused_stage_tail.launches = 0
