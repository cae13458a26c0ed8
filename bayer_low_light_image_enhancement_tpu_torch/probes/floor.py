"""The probe ladders (P): stripped and cut copies of the apply pass, timed.

Port of the JAX package's TPU probes ``benchmarks/probe_floor.py``,
``benchmarks/exp_dma_floor.py``, ``benchmarks/exp_dma_bw.py`` and
``benchmarks/bisect_b5.py``, which no model calls.

* The floor ladder (``floor_probe``, ``csrc/probes_floor.cu``) moves K3's
  windows (C = 32, TW = 8, a 2-pixel halo) by one of ``STRATEGIES`` and does
  one of ``LEVELS`` of work on them, at tile heights ``TILE_HEIGHTS``:
  strategies "plain" (thread loads of the halo window, one tile per block),
  "center" (the own pixels only: a movement yardstick, not a valid result at
  level "v"), "async" / "async4" (a persistent grid with a 2- or 4-deep
  cp.async window ring), "tma" (a persistent grid, each window one TMA box
  of a 4-D tensor map over x, zeros past the image, in a 4-slot ring on
  mbarriers fed by one producer thread: the counterpart of the TPU rung
  "dma"); levels "c" (copy the own pixels out), "m" (+ 6 chained
  [pixels, C] x [C, C] products), "v" (product, dw3x3, 3 products, dw3x3,
  GELU, 2 products). ``copy_ms`` times the one PyTorch call of level "c"'s
  function, ``Tensor.copy_``, the card's practical copy rate.
* The bisect ladder (``bisect_probe``, ``csrc/probes_bisect.cu``) cuts the
  production apply kernels, K3 or K3P, after stage 1-4 (``STAGES``); stage 5
  is the production kernel. Each stage's tensor at every pixel is the
  output: 1 the v 1x1 (LN1(x) @ wv + bv), 2 the attention output
  v @ apply + b_proj, 3 y, 4 the first C channels of the FFN expand, 5 the
  block output. K3 runs as two kernels split at y: its stages 1-3 cut the
  first kernel (window, LN1, v 1x1 | + dw3x3, apply | + residual: the first
  kernel whole), stage 4 is the first kernel whole plus the second (y
  window, LN2, expand) cut before its dw3x3, and 5 both whole; K3P's stages
  cut its one kernel.

Each wrapper runs its plain twin on a CPU tensor (fp32) and its kernel on a
CUDA tensor, or raises. ``run_floor_ladder`` / ``run_bisect_ladder`` time the
ladders on the card (CUDA events) and hold every rung that computes a result
against its twin.
"""

from __future__ import annotations

from typing import Dict, Iterable, List

import torch
import torch.nn.functional as F

from bayer_low_light_image_enhancement_tpu_torch.kernels import _build
from bayer_low_light_image_enhancement_tpu_torch.utils.profiling import cuda_time_ms
from bayer_low_light_image_enhancement_tpu_torch.kernels.fused_block import (
    PIPELINED_WIDTHS,
    BlockWeights,
    _apply_pass_args,
    _dw3x3,
    _ln_hat,
    apply_pass_plain,
    bf16,
    check_apply_kernel,
    f32,
    finalize_attention,
    fold_block_params,
    gram_pass_plain,
    require,
    select_apply_pass,
)

STRATEGIES = ("plain", "center", "async", "async4", "tma")
LEVELS = ("c", "m", "v")
TILE_HEIGHTS = (4, 8, 16)
STAGES = (1, 2, 3, 4, 5)
FLOOR_C = 32  # the floor ladder's width: RawFormer-S level 1


# ----------------------------------------------------------------------------
# Floor ladder
# ----------------------------------------------------------------------------


def floor_probe_plain(x: torch.Tensor, w: torch.Tensor, dw: torch.Tensor,
                      level: str) -> torch.Tensor:
    """The floor ladder's twin (fp32): x [B,H,W,C], w [C,C], dw taps [9,C]
    -> level "c": x; "m": x @ w six times; "v": the whole-image chain
    x @ w -> dw3x3 -> (@ w) x 3 -> dw3x3 -> GELU -> (@ w) x 2, zero padding."""
    y = x.float()
    w = w.float()
    zero = torch.zeros(y.shape[-1], device=y.device)
    if level == "c":
        return y
    if level == "m":
        for _ in range(6):
            y = y @ w
        return y
    y = _dw3x3(y @ w, dw.float(), zero)
    y = _dw3x3(y @ w @ w @ w, dw.float(), zero)
    return F.gelu(y) @ w @ w


def check_floor_args(strategy: str, level: str, th: int) -> None:
    if strategy not in STRATEGIES:
        raise ValueError(f"strategy must be one of {STRATEGIES}, got {strategy!r}")
    if level not in LEVELS:
        raise ValueError(f"level must be one of {LEVELS}, got {level!r}")
    if th not in TILE_HEIGHTS:
        raise ValueError(f"th must be one of {TILE_HEIGHTS}, got {th!r}")


def floor_probe(x: torch.Tensor, w: torch.Tensor, dw: torch.Tensor, strategy: str = "plain",
                level: str = "c", th: int = 8) -> torch.Tensor:
    """One rung of the floor ladder: x [B,H,W,32] -> [B,H,W,32] in x's dtype.

    CPU: the twin (the whole-image result, whatever the strategy). CUDA: the
    probe kernel on bf16 x, or raise."""
    check_floor_args(strategy, level, th)
    if not x.is_cuda:
        return floor_probe_plain(x, w, dw, level).to(x.dtype)
    if x.dim() != 4 or x.shape[-1] != FLOOR_C or x.dtype != torch.bfloat16:
        raise ValueError(f"the floor probe takes bf16 [B, H, W, {FLOOR_C}], got "
                         f"{x.dtype} {tuple(x.shape)}")
    require(x, "x", x.shape, x.device)
    wk, dwk = bf16(w), f32(dw)
    require(wk, "w", (FLOOR_C, FLOOR_C), x.device)
    require(dwk, "dw", (9, FLOOR_C), x.device)
    out = torch.empty_like(x)
    err = _build.library().blle_probe_floor(
        x.data_ptr(), wk.data_ptr(), dwk.data_ptr(), out.data_ptr(), *x.shape,
        STRATEGIES.index(strategy), LEVELS.index(level), th, _build.stream_of(x))
    _build.check(err, f"floor probe {strategy}/{level} th={th}")
    floor_probe.launches += 1
    floor_probe.launches_by_strategy[strategy] += 1
    return out


floor_probe.launches = 0
floor_probe.launches_by_strategy = dict.fromkeys(STRATEGIES, 0)


# ----------------------------------------------------------------------------
# Bisect ladder
# ----------------------------------------------------------------------------


def bisect_probe_plain(x: torch.Tensor, apply: torch.Tensor, w: BlockWeights,
                       stage: int) -> torch.Tensor:
    """The bisect ladder's twin (fp32): the prefix of ``apply_pass_plain``'s
    maths up to ``stage`` (module docstring), [B,H,W,C]."""
    if stage not in STAGES:
        raise ValueError(f"stage must be one of {STAGES}, got {stage!r}")
    if stage == 5:
        return apply_pass_plain(x, apply, w).float()
    xf = x.float()
    z = _ln_hat(xf) @ w.wv + w.bv
    if stage == 1:
        return z
    att = torch.einsum("bhwc,bcd->bhwd", _dw3x3(z, w.dwv, w.bdwv), apply.float()) + w.bproj
    if stage == 2:
        return att
    y = xf + att
    if stage == 3:
        return y
    return (_ln_hat(y) @ w.wp1 + w.bp1)[..., : x.shape[-1]]


def bisect_probe(x: torch.Tensor, apply: torch.Tensor, w: BlockWeights, stage: int,
                 apply_kernel: str = "tiled") -> torch.Tensor:
    """One rung of the bisect ladder: x [B,H,W,C], apply [B,C,C] -> the
    stage's tensor [B,H,W,C] in x's dtype.

    CPU: the twin. CUDA: the apply kernel ``select_apply_pass`` picks for
    ``apply_kernel``, cut after ``stage`` (stage 5: the production kernel's
    own wrapper, counted there), on bf16 x; C in {32, 64, 128, 256}."""
    check_apply_kernel(apply_kernel)
    if stage not in STAGES:
        raise ValueError(f"stage must be one of {STAGES}, got {stage!r}")
    if not x.is_cuda:
        return bisect_probe_plain(x, apply, w, stage).to(x.dtype)
    c = x.shape[-1]
    if c not in PIPELINED_WIDTHS:
        raise ValueError(f"the bisect ladder is built for C in {PIPELINED_WIDTHS}, got {c}")
    apply_fn = select_apply_pass(c, apply_kernel)
    if stage == 5:
        return apply_fn(x, apply, w)
    args = _apply_pass_args(x, apply, *w.apply_tensors())
    ybuf, out = torch.empty_like(x), torch.empty_like(x)
    err = _build.library().blle_probe_apply_cut(
        x.data_ptr(), *(t.data_ptr() for t in args), ybuf.data_ptr(), out.data_ptr(), *x.shape,
        stage, int(apply_kernel == "pipelined"), _build.stream_of(x))
    _build.check(err, f"bisect probe stage {stage} ({apply_kernel})")
    bisect_probe.launches += 1
    return out


bisect_probe.launches = 0


# ----------------------------------------------------------------------------
# The ladders on the card
# ----------------------------------------------------------------------------


def _rel_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    return ((got.float() - ref).abs().max() / ref.abs().max().clamp_min(1e-30)).item()


def run_floor_ladder(shape=(8, 256, 256, FLOOR_C), strategies: Iterable[str] = STRATEGIES,
                     levels: Iterable[str] = LEVELS, ths: Iterable[int] = TILE_HEIGHTS,
                     iters: int = 20, seed: int = 0) -> List[Dict]:
    """Every (th, strategy, level) rung on the card: its ms, effective GB/s
    (x read once and the output written once over its time) and its error
    of the twin's max (None for "center" at level "v", which has no twin)."""
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(shape, generator=g).to(dev, torch.bfloat16)
    c = shape[-1]
    w = (torch.randn(c, c, generator=g) / c ** 0.5).to(dev, torch.bfloat16)
    dw = (torch.randn(9, c, generator=g) / 3.0).to(dev)
    refs = {lv: floor_probe_plain(x, w, dw, lv) for lv in levels}
    rows = []
    for th in ths:
        for strategy in strategies:
            for level in levels:
                out = floor_probe(x, w, dw, strategy, level, th)
                torch.cuda.synchronize()
                err = None if (strategy, level) == ("center", "v") else _rel_err(out, refs[level])
                ms = cuda_time_ms(lambda: floor_probe(x, w, dw, strategy, level, th), iters)
                rows.append(dict(strategy=strategy, level=level, th=th, ms=ms,
                                 gbs=2 * x.numel() * 2 / (ms * 1e-3) / 1e9, err=err))
    return rows


def copy_ms(shape=(8, 256, 256, FLOOR_C), iters: int = 20, seed: int = 0) -> float:
    """ms of ``out.copy_(x)`` on a bf16 x of ``shape`` on the card (CUDA
    events): the library call of level "c"'s function."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(shape, generator=g).to("cuda", torch.bfloat16)
    out = torch.empty_like(x)
    return cuda_time_ms(lambda: out.copy_(x), iters)


def block_weights(c: int, seed: int, device) -> BlockWeights:
    """Seeded RawFormer-like block weights (torch's default conv init, LN
    affines and temperatures moved off 1) at width c, folded."""
    from bayer_low_light_image_enhancement_tpu_torch.models import common

    gen = torch.Generator().manual_seed(seed)
    blk = common.TransformerBlock(c, 8, 2)
    common.reset_parameters_(blk, gen)
    with torch.no_grad():
        for name, p in blk.named_parameters():
            if "norm" in name or "temperature" in name:
                p.add_(torch.empty(p.shape).uniform_(-0.3, 0.3, generator=gen))
    w = fold_block_params({k: v.detach() for k, v in blk.named_parameters()})
    return BlockWeights(*(t.to(device) for t in w.tensors()))


def run_bisect_ladder(shapes=((8, 256, 256, 32), (8, 128, 128, 64), (8, 64, 64, 128),
                              (8, 32, 32, 256)),
                      apply_kernels: Iterable[str] = ("tiled", "pipelined"),
                      stages: Iterable[int] = STAGES, iters: int = 10,
                      seed: int = 0) -> List[Dict]:
    """Every (shape, apply kernel, stage) rung on the card: ms, effective
    GB/s (x read once and the output written once) and the error of the
    twin's max."""
    dev = torch.device("cuda")
    rows = []
    for shape in shapes:
        c = shape[-1]
        w = block_weights(c, seed + c, dev)
        g = torch.Generator().manual_seed(seed + 1)
        x = torch.randn(shape, generator=g).to(dev, torch.bfloat16)
        apply = finalize_attention(*gram_pass_plain(x, w), w.temperature, w.wproj, 8)
        refs = {s: bisect_probe_plain(x, apply, w, s) for s in stages}
        for kind in apply_kernels:
            for stage in stages:
                out = bisect_probe(x, apply, w, stage, kind)
                torch.cuda.synchronize()
                ms = cuda_time_ms(lambda: bisect_probe(x, apply, w, stage, kind), iters)
                rows.append(dict(shape=tuple(shape), apply_kernel=kind, stage=stage, ms=ms,
                                 gbs=2 * x.numel() * 2 / (ms * 1e-3) / 1e9,
                                 err=_rel_err(out, refs[stage])))
        del x, refs
    return rows
