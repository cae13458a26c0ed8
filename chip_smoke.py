#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one CUDA card

Phases (any failed check raises and the script exits non-zero):

1. environment: torch / CUDA versions, the card's name and power limit;
2. build: nvcc compiles ``bayer_low_light_image_enhancement_tpu_torch/csrc``;
3. each kernel against its plain PyTorch twin on the card, at the shapes the
   RawFormer-S serving path gives it (batch 8 @ 512x512 and one 2832x4240
   frame), with the tolerances below; then the backward kernels B1/B2
   against their twins at the training shapes (batch 8 @ 512x512);
4. serving: RawFormer-S (dim 32, heads 8/8/8/8, FFN 2, seeded random
   weights, bf16 compute) answers 3 requests of 8 uint16 mosaics at 512x512
   through ``Predictor.raw_u16`` and two float frames (2832x4240, 1000x1500)
   through ``Predictor.__call__``; the launch counters must show every
   kernel ran (and no backward kernel), and the kernel path must match the
   twin path;
4b. training: RawFormer-S (fp32 params, bf16 compute) takes Adam steps on
   synthetic batch-8 @ 512x512 crops fed by ``Loader`` +
   ``prefetch_to_device`` through ``Trainer.train_step``; the counters must
   show K2, K3, B1 and B2 7 times per step, the first steps must match a
   twin-path trainer, 20 steps on one batch must lower its loss, and
   ``eval_step`` must give finite PSNRs;
5. timing with CUDA events after warmup: each kernel against its twin, the
   batch-8 forward, the full-resolution frame, and the train step at batch
   8 and 16 @ 512x512 on the kernel and the twin path (with peak memory);
6. RawFormer-WFB: the selective-scan kernels S1 (with and without saved
   states) and S2 against their twins at the four distinct scan shapes of
   WFB-48 at batch 2 @ 512x512 (b = 3 high bands x 2 images); WFB-48
   (seeded random weights, bf16 compute) serves 3 batch-2 @ 512x512 float
   requests through ``Predictor.__call__`` (pad_to 32) against the twin
   path, and one 2832x4240 frame; it trains through ``Trainer`` on
   synthetic crops (``Loader`` + ``prefetch_to_device``), kernel path
   against twin path at batch 2 @ 256x256, 20 steps on one batch, and the
   step timed at batch 8 @ 512x512; the counters must show S1 7 times per
   forward (S2 never) when serving and S1 with states and S2 7 times per
   train step; S1 / S2 and the WFB forward and step are timed.
7. the pipelined apply pass K3P and the retired kernels A1 (standalone
   channel attention) and T1 (stage tail, on the stage's own t from
   ``fused_transformer_block``) against their twins at the block shapes of
   phase 3 (inside phase 3); RawFormer-S serves 3 batch-8 @ 512x512 uint16
   requests and one 2832x4240 uint16 frame through
   ``Predictor(model, apply_kernel="pipelined").raw_u16`` (K3P 7 times and
   K3 never per forward, against the twin path) and takes one train step at
   batch 8 @ 512x512 with ``set_apply_kernel(model, "pipelined")`` (K3P in
   the forward, B1/B2 in the backward, first loss against the tiled path's);
   K3P is timed beside K3, A1 beside the ChannelAttention module, T1 beside
   the module tail (cuDNN convs, LeakyReLUs, concat, reduce);
8. the probe ladders: the floor ladder (load strategies x levels x tile
   heights) at [8,256,256,32] and the bisect ladder (K3 and K3P cut after
   each stage) at the four RawFormer-S block shapes, every rung that
   computes a result against its twin, ms and effective GB/s per rung.

Every kernel row carries its bound: the larger of the bytes it must move
(each input read once, each output written once) over 3.35 TB/s and its
operations over the peak rate of their unit (bf16 tensor cores 989
TFLOP/s, fp32 67 TFLOP/s, exp on the SFU 16 per SM per clock at 132 SMs x
1.98 GHz), computed from this run's shapes. The line before the last is the
JSON kernel table; the last line is ``{"ok": true, "device": {...}}``.
Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import re
import subprocess
import sys
import time

import numpy as np
import torch

# Tolerances, stated before the run:
# K1 bf16 output (values <= 1 with clamp01) vs the fp32 twin: bf16 rounding.
K1_TOL = 4e-3
# K2 compared on the attention cosines gram / (|q| |k|), which lie in
# [-1, 1] (q and k are rounded to bf16 before the gram on the card).
K2_COS_TOL = 2e-2
# K3 and the whole block, bf16 kernel vs fp32 twin on the same bf16 input:
# |err| <= atol + rtol * |ref| as in tests/test_fused_block.py.
BLOCK_RTOL = BLOCK_ATOL = 2.5e-2
# End to end, kernel path vs twin path (both with bf16 convs): RGB in [0, 1].
E2E_MAX_TOL, E2E_MEAN_TOL = 5e-2, 5e-3
# B1/B2, each output leaf (dx2, d_apply, dx, every folded-weight grad): the
# kernel's max error relative to the fp32 twin's leaf max must be within
# max(3 x the bf16 twin's, BWD_FLOOR) (tests/test_fused_bwd.py's yardstick;
# the bf16 twin is the fp32 twin under torch.autocast(bfloat16)).
BWD_FLOOR = 2e-2
# Training, kernel path vs twin path from the same init on the same batch:
# loss relative, params after two Adam steps (the first at lr 0) absolute.
TRAIN_LOSS_RTOL, TRAIN_PARAM_ATOL = 2e-2, 5e-4
# S1 on bf16 inputs vs the fp32 twin on the same inputs: y within its bf16
# output rounding, |err| <= SCAN_RTOL |ref| + SCAN_ATOL_REL max|ref|; the
# saved fp32 states within STATE_TOL of their max.
SCAN_RTOL, SCAN_ATOL_REL, STATE_TOL = 8e-3, 1e-3, 1e-4
# S2 vs the explicit backward twin: each leaf within SCAN_BWD_TOL of its max
# (fp32 sums over up to 6 x 16384 terms, taken in another order).
SCAN_BWD_TOL = 1e-3
# WFB training, kernel path vs twin path (bf16 activations; only the scan
# differs): the first-step grad of every parameter outside the FEB
# frequency islands within max(3 x the twin path's own change when its
# input is nudged by half a bf16 ulp, WFB_GRAD_FLOOR) of the twin's leaf
# max; the median over all leaves within WFB_GRAD_MEDIAN_TOL. The FEB
# leaves are only logged: their phase (an atan2 with a branch cut) turns
# rounding-level input changes into large grad changes (the log shows the
# nudged twin's own change, FEB vs other leaves), so no single nudge bounds
# them. BN running stats within WFB_BN_TOL of their max; loss and params as
# TRAIN_*.
WFB_GRAD_FLOOR, WFB_GRAD_MEDIAN_TOL, WFB_BN_TOL = 2e-2, 2e-2, 1e-2
# A1 and T1 (bf16 kernels vs fp32 twins on the same bf16 inputs) are held to
# the block rule. The probe rungs: level "c" copies exactly; every other rung
# that computes a result (all but "center" at level "v") within PROBE_TOL of
# its twin's max (bf16 rounding between chained products).
PROBE_TOL = 3e-2
# WFB-48 at batch 2 @ 512^2: the scan's (b, L, d_inner) at stages 1-4
# (stages 5-7 repeat 3-1); b = 3 high bands x 2 images, N = 32.
SCAN_SHAPES = [(6, 16384, 96), (6, 4096, 192), (6, 1024, 384), (6, 256, 768)]

BATCH_SHAPES = [(8, 256, 256, 32), (8, 128, 128, 64), (8, 64, 64, 128), (8, 32, 32, 256)]
FULLRES_SHAPES = [(1, 1416, 2120, 32), (1, 177, 265, 256)]
PACK_SHAPES = [(8, 512, 512), (1, 2832, 4240)]
TPU = "bayer_low_light_image_enhancement_tpu/kernels/"
PKG = "bayer_low_light_image_enhancement_tpu_torch/"

# Peak rates of one H100 SXM (NVIDIA data sheet; exp: MUFU.EX2 throughput of
# compute capability 9.0 in the CUDA C++ Programming Guide, 16 per SM per
# clock, 132 SMs at the 1980 MHz boost clock).
HBM_BYTES_PER_S, TC_BF16, FP32, SFU = 3.35e12, 989e12, 67e12, 16 * 132 * 1.98e9


def bound(nbytes: float, tc: float = 0.0, fp32: float = 0.0, sfu: float = 0.0):
    """(least ms, "bytes" or "operations"): bytes over the memory rate
    against the slowest unit's operations over its peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(tc / TC_BF16, fp32 / FP32, sfu / SFU)
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def block_counts(kind: str, b: int, h: int, w: int, c: int) -> dict:
    """Bytes and operations K2 / K3 / B1 / B2 need at [b, h, w, c] bf16: x
    (and dy / dx2) read once, outputs written once, the [C, C] tensors; the
    1x1 and gram products on the tensor cores (B1 / B2: only the backward
    products, twice the forward's, no recompute), the depthwise convs,
    LayerNorms and GELU in fp32."""
    p = b * h * w
    if kind == "gram":
        return dict(nbytes=p * c * 2 + b * c * c * 4 + 8 * b * c + 4 * c * c,
                    tc=2.0 * p * c * 2 * c + 2.0 * p * c * c, fp32=48.0 * p * c)
    if kind == "apply":
        return dict(nbytes=2 * p * c * 2 + b * c * c * 2 + 10 * c * c,
                    tc=12.0 * p * c * c, fp32=110.0 * p * c)
    if kind == "bwd1":
        return dict(nbytes=3 * p * c * 2 + b * c * c * 6 + 10 * c * c, tc=20.0 * p * c * c,
                    fp32=72.0 * p * c)
    return dict(nbytes=3 * p * c * 2 + b * c * c * 8 + 6 * c * c, tc=16.0 * p * c * c,
                fp32=108.0 * p * c)


def tail_counts(b: int, h: int, w: int, c: int) -> dict:
    """T1 at [b, h, w, c] bf16: x and t read once, the output written once,
    the weights; two 3x3 convs (9 C^2 MACs a pixel each) and the split
    reduce (2 C^2) on the tensor cores, bias and LeakyReLU in fp32."""
    p = b * h * w
    return dict(nbytes=3 * p * c * 2 + 22 * c * c * 2 + 12 * c, tc=40.0 * p * c * c,
                fp32=6.0 * p * c)


def attention_counts(b: int, h: int, w: int, c: int) -> dict:
    """A1 at [b, h, w, c] bf16: x read once, the output written once; the
    qkv 1x1, the gram and the apply on the tensor cores, the depthwise conv
    of 3C channels in fp32."""
    p = b * h * w
    return dict(nbytes=2 * p * c * 2 + b * c * c * 4 + 8 * c * c,
                tc=10.0 * p * c * c, fp32=60.0 * p * c)


def stage_counts(stage: int, b: int, h: int, w: int, c: int) -> dict:
    """The bisect rung cut after ``stage`` at [b, h, w, c]: x read once, the
    stage's tensor written once; the products and fp32 work of the stages up
    to it (stage 5 is the apply pass, block_counts("apply"))."""
    p = b * h * w
    tc = (0.0, 2.0, 4.0, 4.0, 8.0, 12.0)[stage] * p * c * c
    fp32 = (0.0, 10.0, 30.0, 32.0, 42.0, 110.0)[stage] * p * c
    return dict(nbytes=2 * p * c * 2 + b * c * c * 2 + 10 * c * c, tc=tc, fp32=fp32)


def floor_counts(level: str, b: int, h: int, w: int, c: int) -> dict:
    """The floor rung at ``level``: x read once, the output written once; 6
    products at "m" and "v", the two depthwise convs and GELU at "v"."""
    p = b * h * w
    return dict(nbytes=2 * p * c * 2, tc=0.0 if level == "c" else 12.0 * p * c * c,
                fp32=60.0 * p * c if level == "v" else 0.0)


def scan_counts(b: int, L: int, d: int, n: int, in_bytes: int, backward: bool) -> dict:
    """Bytes and operations of the scan: u, dt (dy) [b, L, d] and B, C
    [b, L, n] in, y (or du, ddt, dB, dC, dA, dD fp32) out, the backward's
    saved states [b, ceil(L/32), d, n] fp32 in; per (b, t, d, n) one exp and
    the fp32 arithmetic of the recurrence (forward 6 flops: dt A, a h + .,
    (dt u) B, C h + .; backward 18: h again, lam, its products and sums)."""
    bld, bln = b * L * d, b * L * n
    if backward:
        nbytes = ((3 * bld + 2 * bln) * in_bytes + 4 * b * -(-L // 32) * d * n
                  + 4 * (2 * bld + 2 * bln + 2 * d * n + 2 * d))
        return dict(nbytes=nbytes, fp32=18.0 * bld * n, sfu=float(bld * n))
    return dict(nbytes=(3 * bld + 2 * bln) * in_bytes + 4 * (d * n + d),
                fp32=6.0 * bld * n, sfu=float(bld * n))


def log(*a):
    print(*a, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def ptxas_summary(build_log: str):
    """One line per compiled kernel: registers, barriers, stack and spills,
    from nvcc's -Xptxas -v output."""
    name, spill = None, ""
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            # Itanium mangling: <length><identifier>, then the template args;
            # the length may follow digits of the namespace hash.
            mangled, name = m.group(1), m.group(1)
            for k in re.finditer(r"(?<=\d)(?=([a-z]\w*?_kernel))", mangled):
                ident = k.group(1)
                if re.search(r"\d+$", mangled[: k.start()]).group().endswith(str(len(ident))):
                    rest, args = mangled[k.start() + len(ident):], []
                    pos = 1 if rest.startswith("I") else len(rest)
                    while t := re.match(r"Li(\d+)E|Lb(\d)E|(f)|13__nv_(bfloat16)", rest[pos:]):
                        i, b_, f_, h_ = t.groups()
                        args.append(i or h_ or ("float" if f_ else
                                                "true" if b_ == "1" else "false"))
                        pos += t.end()
                    name = ident + (f"<{','.join(args)}>" if args else "")
                    break
            spill = ""
        elif "spill" in line:
            spill = line.strip()
        elif name and "Used" in line and "registers" in line:
            yield f"{name}: {line.split(':', 1)[1].strip()}; {spill}"
            name = None


def u16_to_device(a: np.ndarray) -> torch.Tensor:
    """uint16 numpy -> CUDA uint16 tensor (moved as int16 bits)."""
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int16)).cuda().view(torch.uint16)


def mosaics(rng, shape) -> np.ndarray:
    """Sensor-like codes below white, with 0.1% hot pixels >= 32768."""
    m = rng.integers(0, 17000, shape, dtype=np.uint16)
    hot = rng.random(shape) < 1e-3
    m[hot] = rng.integers(32768, 65536, int(hot.sum()), dtype=np.uint16)
    return m


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from bayer_low_light_image_enhancement_tpu_torch.kernels import _build
    from bayer_low_light_image_enhancement_tpu_torch.kernels import bayer_pack as bp
    from bayer_low_light_image_enhancement_tpu_torch.data import (
        Loader,
        SyntheticBayerDataset,
        prefetch_to_device,
    )
    from bayer_low_light_image_enhancement_tpu_torch.kernels import fused_attention as fa
    from bayer_low_light_image_enhancement_tpu_torch.kernels import fused_block as fb
    from bayer_low_light_image_enhancement_tpu_torch.kernels import fused_block_bwd as fbb
    from bayer_low_light_image_enhancement_tpu_torch.kernels import fused_stage as fs
    from bayer_low_light_image_enhancement_tpu_torch.kernels import ssm_scan as ssk
    from bayer_low_light_image_enhancement_tpu_torch.models import common, get_model
    from bayer_low_light_image_enhancement_tpu_torch.ops import ssm
    from bayer_low_light_image_enhancement_tpu_torch.probes import floor as probes
    from bayer_low_light_image_enhancement_tpu_torch.serving import Predictor
    from bayer_low_light_image_enhancement_tpu_torch.train import TrainConfig, Trainer
    from bayer_low_light_image_enhancement_tpu_torch.utils.profiling import cuda_time_ms

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)

    # 1. environment --------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    card = smi[0].strip()
    log(f"torch {torch.__version__}  CUDA {torch.version.cuda}  python {sys.version.split()[0]}")
    log(f"devices: {torch.cuda.device_count()}  {torch.cuda.get_device_name(0)}")

    # 2. build --------------------------------------------------------------
    t0 = time.perf_counter()
    so = _build.build()
    _build.library()
    log(f"build: {time.perf_counter() - t0:.1f} s -> {so.name}")
    for line in ptxas_summary(open(f"{so}.log").read()):
        log("  ptxas:", line)

    # 3. kernels against twins ------------------------------------------------
    errs = {"bayer_pack": 0.0, "fused_block_gram": 0.0, "fused_block_apply": 0.0,
            "fused_block_bwd1": 0.0, "fused_block_bwd2": 0.0,
            "fused_block_apply_pipelined": 0.0, "fused_attention": 0.0, "fused_stage_tail": 0.0}

    def held_to_block_rule(name, what, got, ref):
        """Log and check got against ref under atol = rtol = BLOCK_*; keep the
        max abs err as errs[name] (name None: not a kernel row)."""
        d = (got.float() - ref.float()).abs()
        bad = (d > BLOCK_ATOL + BLOCK_RTOL * ref.float().abs()).sum().item()
        log(f"{what}: max abs err {d.max().item():.3e}, mean {d.mean().item():.3e}, "
            f"{bad} elements outside atol=rtol={BLOCK_ATOL}")
        check(bad == 0, f"{what}: kernel disagrees with its twin")
        if name:
            errs[name] = max(errs[name], d.max().item())

    def attn_params(c):
        return {k.removeprefix("attn."): v for k, v in blocks[c].named_parameters()
                if k.startswith("attn.")}

    def tail_params(c):
        return {k: v.detach() for k, v in tails[c].state_dict().items()
                if not k.startswith("Transformer.")}
    with torch.inference_mode():
        for shape in PACK_SHAPES:
            m = u16_to_device(mosaics(rng, shape))
            r = torch.from_numpy(rng.uniform(1.0, 300.0, shape[0]).astype(np.float32)).cuda()
            got = bp.bayer_pack_normalize(m, r, torch.bfloat16, clamp01=True)
            ref = bp.bayer_pack_normalize_plain(m, r, torch.float32, clamp01=True)
            e = (got.float() - ref).abs().max().item()
            got32 = bp.bayer_pack_normalize(m, r, torch.float32, clamp01=False)
            ref32 = bp.bayer_pack_normalize_plain(m, r, torch.float32, clamp01=False)
            e32 = ((got32 - ref32).abs() / ref32.abs().clamp_min(1.0)).max().item()
            log(f"K1 bayer_pack {shape}: bf16+clamp max abs err {e:.3e} (tol {K1_TOL}); "
                f"fp32 rel err {e32:.3e} (tol 1e-5)")
            check(e <= K1_TOL and e32 <= 1e-5, f"K1 disagrees with its twin at {shape}")
            errs["bayer_pack"] = max(errs["bayer_pack"], e)

        gen = torch.Generator().manual_seed(1)
        tail_gen = torch.Generator().manual_seed(2)
        blocks, tails = {}, {}
        for fn in (fa.fused_channel_attention, fs.fused_stage_tail):
            fn.launches = 0
        for shape in BATCH_SHAPES + FULLRES_SHAPES:
            b, h, w, c = shape
            if c not in tails:
                tails[c] = common.ConvTransformer(c, 8, 2, device=dev,
                                                  compute_dtype=torch.bfloat16)
                common.reset_parameters_(tails[c], tail_gen)
            if c not in blocks:
                blk = common.TransformerBlock(c, 8, 2, device=dev)
                common.reset_parameters_(blk, gen)
                with torch.no_grad():  # non-trivial LN affines and temperatures
                    for name, p in blk.named_parameters():
                        if "norm" in name or "temperature" in name:
                            p.add_(torch.empty(p.shape).uniform_(-0.3, 0.3, generator=gen).to(dev))
                blocks[c] = blk
            params = dict(blocks[c].named_parameters())
            wts = fb.fold_block_params(params)
            x = torch.randn(shape, generator=gen).to(dev, torch.bfloat16)

            g, qs, ks = fb.gram_pass(x, wts)
            g0, qs0, ks0 = fb.gram_pass_plain(x, wts)
            cos = g / torch.sqrt(qs[:, :, None] * ks[:, None, :])
            cos0 = g0 / torch.sqrt(qs0[:, :, None] * ks0[:, None, :])
            e_cos = (cos - cos0).abs().max().item()
            e_ss = max(((qs - qs0).abs() / qs0).max().item(), ((ks - ks0).abs() / ks0).max().item())
            log(f"K2 gram {shape}: cosine max abs err {e_cos:.3e} (tol {K2_COS_TOL}); "
                f"sum-of-squares rel err {e_ss:.3e} (tol {K2_COS_TOL})")
            check(e_cos <= K2_COS_TOL and e_ss <= K2_COS_TOL, f"K2 disagrees with its twin at {shape}")
            errs["fused_block_gram"] = max(errs["fused_block_gram"], e_cos)

            apply = fb.finalize_attention(g0, qs0, ks0, wts.temperature, wts.wproj, 8)
            ref = fb.apply_pass_plain(x, apply, wts)
            held_to_block_rule("fused_block_apply", f"K3 apply {shape}",
                               fb.apply_pass(x, apply, wts), ref)
            full = fb.fused_transformer_block(x, params, 8)
            held_to_block_rule(None, f"K2+K3 block {shape}", full,
                               fb.fused_transformer_block_plain(x, params, 8))
            held_to_block_rule("fused_block_apply_pipelined", f"K3P apply {shape}",
                               fb.apply_pass_pipelined(x, apply, wts), ref)
            held_to_block_rule("fused_attention", f"A1 attention {shape}",
                               fa.fused_channel_attention(x, attn_params(c), 8),
                               fa.fused_channel_attention_plain(x, attn_params(c), 8))
            t = full.to(torch.bfloat16)  # the stage's own transformer-branch output
            held_to_block_rule("fused_stage_tail", f"T1 stage tail {shape}",
                               fs.fused_stage_tail(x, t, tail_params(c)),
                               fs.fused_stage_tail_plain(x, t, tail_params(c)))
            del x, g, g0, ref, full, t
        torch.cuda.synchronize()
    aux_launches = {"fused_attention": fa.fused_channel_attention.launches,
                    "fused_stage_tail": fs.fused_stage_tail.launches}
    check(min(aux_launches.values()) == len(BATCH_SHAPES + FULLRES_SHAPES),
          f"A1 / T1 did not launch once per shape: {aux_launches}")

    def backward_leaves(x, dy, wts, run):
        """dx2, d_apply, dx and every folded-weight grad of B1 -> finalize
        backward -> B2, each pass through run(1 or 2, *args)."""
        gram, qss, kss = fb.gram_pass_plain(x, wts)
        apply = fb.finalize_attention(gram, qss, kss, wts.temperature, wts.wproj, 8)
        dx2, d_apply, g1 = run(1, x, dy, apply, wts)
        d = fbb.finalize_backward(gram, qss, kss, wts.temperature, wts.wproj, d_apply, 8)
        dx, g2 = run(2, x, dx2.to(torch.bfloat16), apply, *d[:3], wts)
        return {"dx2": dx2, "d_apply": d_apply, "dx": dx, **g1, **g2}

    def kernels(k, *args):
        return (fbb.bwd1 if k == 1 else fbb.bwd2)(*args)

    def twins(k, *args):
        return (fbb.bwd1_plain if k == 1 else fbb.bwd2_plain)(*args)

    def bf16_twins(k, *args):
        with torch.autocast("cuda", torch.bfloat16):
            return twins(k, *args)

    bwd_inputs = {}
    with torch.no_grad():
        for shape in BATCH_SHAPES:
            c = shape[-1]
            wts = fb.fold_block_params({k: v.detach() for k, v in blocks[c].named_parameters()})
            x = torch.randn(shape, generator=gen).to(dev, torch.bfloat16)
            dy = (0.05 * torch.randn(shape, generator=gen)).to(dev, torch.bfloat16)
            bwd_inputs[shape] = (x, dy, wts)
            got = backward_leaves(x, dy, wts, kernels)
            ref = backward_leaves(x, dy, wts, twins)
            noisy = backward_leaves(x, dy, wts, bf16_twins)
            rel = {}  # leaf -> (kernel, bf16 twin) max error / fp32 twin leaf max
            for name, r in ref.items():
                scale = r.float().abs().max().item() + 1e-8
                rel[name] = tuple((t[name].float() - r.float()).abs().max().item() / scale
                                  for t in (got, noisy))
            bad = [f"{n} {ek:.3e} (bf16 twin {e16:.3e})" for n, (ek, e16) in rel.items()
                   if ek > max(3 * e16, BWD_FLOOR)]
            worst = max(rel, key=lambda n: rel[n][0])
            e1 = (got["dx2"].float() - ref["dx2"].float()).abs().max().item()
            e2 = (got["dx"].float() - ref["dx"].float()).abs().max().item()
            log(f"B1/B2 {shape}: worst leaf {worst} rel err {rel[worst][0]:.3e} (bf16 twin "
                f"{rel[worst][1]:.3e}, floor {BWD_FLOOR}); dx2 max abs err {e1:.3e}, dx {e2:.3e}")
            log("  per leaf, kernel / bf16 twin error relative to the fp32 leaf max: "
                + ", ".join(f"{n} {ek:.2e}/{e16:.2e}" for n, (ek, e16) in rel.items()))
            check(not bad, f"B1/B2 disagree with their twins at {shape}: {bad}")
            errs["fused_block_bwd1"] = max(errs["fused_block_bwd1"], e1)
            errs["fused_block_bwd2"] = max(errs["fused_block_bwd2"], e2)
            del got, ref, noisy
        torch.cuda.synchronize()

    # 4. serving --------------------------------------------------------------
    model = get_model("rawformer_s", device=dev, generator=torch.Generator().manual_seed(0),
                      dtype=torch.bfloat16)
    pred = Predictor(model, device=dev)
    requests = [(mosaics(rng, (8, 512, 512)),
                 rng.uniform(50.0, 300.0, 8).astype(np.float32)) for _ in range(3)]
    frames = []
    for hw in ((2832, 4240), (1000, 1500)):
        raw = mosaics(rng, hw).astype(np.float32)
        frames.append(np.clip((raw - 512.0) / (16383.0 - 512.0), 0.0, None) * 100.0)
    counters = (bp.bayer_pack_normalize, fb.gram_pass, fb.apply_pass, fb.apply_pass_pipelined,
                fbb.bwd1, fbb.bwd2, ssk.selective_scan_fwd, ssk.selective_scan_bwd)
    torch.cuda.synchronize()
    for fn in counters:
        fn.launches = 0
    t0 = time.perf_counter()
    outs = [pred.raw_u16(m, r) for m, r in requests] + [pred(f) for f in frames]
    serve_s = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counters}
    log(f"served 3 x 8 x 512^2 u16 requests + 2 frames in {serve_s:.2f} s; launches {launches}")
    forwards = len(requests) + len(frames)
    check(launches["bayer_pack_normalize"] == len(requests), "K1 did not run once per u16 request")
    check(launches["gram_pass"] == 7 * forwards, "K2 did not run 7 times per forward")
    check(launches["apply_pass"] == 7 * forwards, "K3 did not run 7 times per forward")
    check(launches["apply_pass_pipelined"] == 0, "K3P ran on the tiled path")
    check(launches["bwd1"] == launches["bwd2"] == 0, "a backward kernel ran while serving")
    check(launches["selective_scan_fwd"] == 0, "a scan kernel ran in RawFormer-S")
    for (m, _), y in zip(requests, outs):
        check(y.shape == m.shape + (3,), f"bad output shape {y.shape}")
    for f, y in zip(frames, outs[len(requests):]):
        check(y.shape == f.shape + (3,), f"bad output shape {y.shape}")
    for y in outs:
        check(bool(np.isfinite(y).all()) and y.min() >= 0.0 and y.max() <= 1.0,
              "output not finite in [0, 1]")

    @contextlib.contextmanager
    def twin_blocks():
        saved = common.fused_transformer_block
        common.fused_transformer_block = fb.fused_transformer_block_plain
        try:
            yield
        finally:
            common.fused_transformer_block = saved

    m0, r0 = requests[0]
    md, rd = u16_to_device(m0), torch.from_numpy(r0).to(dev)
    with torch.inference_mode(), twin_blocks():
        x4 = bp.bayer_pack_normalize_plain(md, rd, torch.float32, clamp01=True)
        twin = model(x4.permute(0, 3, 1, 2), prepacked=True).clamp(0, 1)
    twin = twin.permute(0, 2, 3, 1).float().cpu().numpy()
    d = np.abs(outs[0] - twin)
    log(f"kernel path vs twin path, 8 x 512^2: max abs err {d.max():.3e} (tol {E2E_MAX_TOL}), "
        f"mean {d.mean():.3e} (tol {E2E_MEAN_TOL})")
    check(d.max() <= E2E_MAX_TOL and d.mean() <= E2E_MEAN_TOL, "kernel path disagrees with twin path")

    # 4a. serving with the pipelined apply pass: a model of the same seed
    # (Predictor sets the apply kernel on the model it is given).
    pmodel = get_model("rawformer_s", device=dev, generator=torch.Generator().manual_seed(0),
                       dtype=torch.bfloat16)
    ppred = Predictor(pmodel, device=dev, apply_kernel="pipelined")
    frame_u16 = (mosaics(rng, (2832, 4240)), 100.0)
    torch.cuda.synchronize()
    for fn in counters:
        fn.launches = 0
    t0 = time.perf_counter()
    pouts = [ppred.raw_u16(m, r) for m, r in requests + [frame_u16]]
    pserve_s = time.perf_counter() - t0
    pipe_launches = {fn.__name__: fn.launches for fn in counters}
    log(f"pipelined path served 3 x 8 x 512^2 u16 requests + one 2832x4240 u16 frame in "
        f"{pserve_s:.2f} s; launches {pipe_launches}")
    pforwards = len(requests) + 1
    check(pipe_launches["apply_pass_pipelined"] == 7 * pforwards,
          "K3P did not run 7 times per forward")
    check(pipe_launches["apply_pass"] == 0, "K3 ran on the pipelined path")
    check(pipe_launches["gram_pass"] == 7 * pforwards
          and pipe_launches["bayer_pack_normalize"] == pforwards,
          "K1 / K2 did not run on the pipelined path")
    check(pipe_launches["bwd1"] == pipe_launches["bwd2"] == 0, "a backward kernel ran while serving")
    for (m, _), y in zip(requests + [frame_u16], pouts):
        check(y.shape == m.shape + (3,) and bool(np.isfinite(y).all()) and y.min() >= 0.0
              and y.max() <= 1.0, f"pipelined output not finite in [0, 1] of shape {m.shape}")
    d = np.abs(pouts[0] - twin)
    log(f"pipelined kernel path vs twin path, 8 x 512^2: max abs err {d.max():.3e} (tol "
        f"{E2E_MAX_TOL}), mean {d.mean():.3e} (tol {E2E_MEAN_TOL})")
    check(d.max() <= E2E_MAX_TOL and d.mean() <= E2E_MEAN_TOL,
          "pipelined kernel path disagrees with twin path")

    # 4b. training ------------------------------------------------------------
    train_ds = SyntheticBayerDataset(num_images=8, full_size=(576, 576), patch_size=512,
                                     training=True)
    loader = Loader(train_ds, 8, seed=0, num_threads=8)

    def device_batches(n):
        """n synthetic batch-8 @ 512^2 crops through Loader + prefetch_to_device."""
        out = []
        while len(out) < n:
            out += list(prefetch_to_device(((i, g) for i, g, _ in loader), dev))
        return out[:n]

    def rawformer_s():
        return get_model("rawformer_s", device=dev, generator=torch.Generator().manual_seed(0),
                         dtype=torch.bfloat16)

    # The CLI's default lr. The second step is the first at a nonzero lr; Adam
    # moves each param by about lr, so params can differ by at most ~2 lr.
    train_cfg = TrainConfig(base_lr=1e-4, warmup_epochs=1, steps_per_epoch=1)
    trainer = Trainer(rawformer_s(), train_cfg)
    steps = device_batches(3)
    torch.cuda.synchronize()
    for fn in counters:
        fn.launches = 0
    train_losses = [float(trainer.train_step(b)) for b in steps]
    torch.cuda.synchronize()
    train_launches = {fn.__name__: fn.launches for fn in counters}
    log(f"trained RawFormer-S 3 steps at batch 8 @ 512^2: losses {train_losses}; "
        f"launches {train_launches}")
    for name in ("gram_pass", "apply_pass", "bwd1", "bwd2"):
        check(train_launches[name] == 7 * len(steps), f"{name} did not run 7 times per train step")
    check(all(np.isfinite(train_losses)), "non-finite training loss")

    fixed = steps[0]
    kern, twin = Trainer(rawformer_s(), train_cfg), Trainer(rawformer_s(), train_cfg)
    runs = []
    for tr, ctx in ((kern, contextlib.nullcontext), (twin, twin_blocks)):
        with ctx():
            losses = [float(tr.train_step(fixed))]
            grads = {n: p.grad.float().clone() for n, p in tr.model.named_parameters()}
            losses.append(float(tr.train_step(fixed)))
        runs.append((losses, grads))
    (kern_losses, kern_grads), (twin_losses, twin_grads) = runs
    grad_err = {n: ((kern_grads[n] - g).abs().max() / (g.abs().max() + 1e-12)).item()
                for n, g in twin_grads.items()}
    worst = max(grad_err, key=grad_err.get)
    dp = max((a.detach().float() - b.detach().float()).abs().max().item()
             for a, b in zip(kern.model.parameters(), twin.model.parameters()))
    dl = abs(kern_losses[0] - twin_losses[0]) / abs(twin_losses[0])
    log(f"train step kernel path vs twin path: losses {kern_losses} vs {twin_losses} "
        f"(first rel err {dl:.3e}, tol {TRAIN_LOSS_RTOL}); first-step grads, worst leaf "
        f"{worst} {grad_err[worst]:.3e} relative to the twin's leaf max, median "
        f"{float(np.median(list(grad_err.values()))):.3e}; params after 2 Adam steps max abs "
        f"diff {dp:.3e} (tol {TRAIN_PARAM_ATOL})")
    check(dl <= TRAIN_LOSS_RTOL, "train loss disagrees with the twin path")
    check(dp <= TRAIN_PARAM_ATOL, "params after Adam steps disagree with the twin path")
    del twin
    for _ in range(18):
        kern_losses.append(float(kern.train_step(fixed)))
    log(f"20 steps on one batch: loss {kern_losses[0]:.5f} -> {kern_losses[-1]:.5f}")
    check(kern_losses[-1] < kern_losses[0], "20 steps on one batch did not lower its loss")
    val = SyntheticBayerDataset(num_images=4, full_size=(512, 512), patch_size=512,
                                training=False, seed=1)
    vin, vgt, _ = next(iter(Loader(val, 4, shuffle=False, drop_last=False)))
    _, val_psnr = kern.eval_step((torch.from_numpy(vin).to(dev), torch.from_numpy(vgt).to(dev)))
    log(f"eval_step per-image PSNR: {val_psnr.tolist()}")
    check(val_psnr.shape == (4,) and bool(torch.isfinite(val_psnr).all()), "eval PSNR not finite")
    del kern

    # 4c. one train step with the pipelined apply pass, from the same init on
    # the same batch as the tiled kernel path's first step.
    pm = rawformer_s()
    common.set_apply_kernel(pm, "pipelined")
    ptrain = Trainer(pm, train_cfg)
    torch.cuda.synchronize()
    for fn in counters:
        fn.launches = 0
    ploss = float(ptrain.train_step(fixed))
    torch.cuda.synchronize()
    ptrain_launches = {fn.__name__: fn.launches for fn in counters}
    dl = abs(ploss - kern_losses[0]) / abs(kern_losses[0])
    log(f"pipelined train step at batch 8 @ 512^2: loss {ploss} vs tiled {kern_losses[0]} (rel "
        f"err {dl:.3e}, tol {TRAIN_LOSS_RTOL}); launches {ptrain_launches}")
    for name in ("gram_pass", "apply_pass_pipelined", "bwd1", "bwd2"):
        check(ptrain_launches[name] == 7, f"{name} did not run 7 times in the pipelined step")
    check(ptrain_launches["apply_pass"] == 0, "K3 ran in the pipelined train step")
    check(dl <= TRAIN_LOSS_RTOL, "pipelined train loss disagrees with the tiled path")
    del ptrain, pm

    # 5. timing ---------------------------------------------------------------
    times = {}
    with torch.inference_mode():
        for shape in PACK_SHAPES:
            m = u16_to_device(mosaics(rng, shape))
            r = torch.full((shape[0],), 100.0, device=dev)
            k = cuda_time_ms(lambda: bp.bayer_pack_normalize(m, r, torch.bfloat16, True), 20)
            p = cuda_time_ms(lambda: bp.bayer_pack_normalize_plain(m, r, torch.bfloat16, True), 20)
            gbs = m.numel() * 4 / (k * 1e-3) / 1e9
            bk1, by1 = bound(nbytes=m.numel() * 4 + 4 * shape[0], fp32=4.0 * m.numel())
            log(f"time K1 {shape}: kernel {k:.4f} ms ({gbs:.0f} GB/s), twin {p:.4f} ms, "
                f"bound {bk1:.4f} ms by {by1}")
            times.setdefault("bayer_pack", (k, p))
        for shape in BATCH_SHAPES + FULLRES_SHAPES:
            c = shape[-1]
            params = dict(blocks[c].named_parameters())
            wts = fb.fold_block_params(params)
            x = torch.randn(shape, device=dev).to(torch.bfloat16)
            g0, qs0, ks0 = fb.gram_pass_plain(x, wts)
            apply = fb.finalize_attention(g0, qs0, ks0, wts.temperature, wts.wproj, 8)
            n = 10
            ka = cuda_time_ms(lambda: fb.gram_pass(x, wts), n)
            pa = cuda_time_ms(lambda: fb.gram_pass_plain(x, wts), n)
            kb = cuda_time_ms(lambda: fb.apply_pass(x, apply, wts), n)
            pb = cuda_time_ms(lambda: fb.apply_pass_plain(x, apply, wts), n)
            kf = cuda_time_ms(lambda: fb.fused_transformer_block(x, params, 8), n)
            pf = cuda_time_ms(lambda: fb.fused_transformer_block_plain(x, params, 8), n)
            (b2, y2), (b3, y3) = (bound(**block_counts(kind, *shape)) for kind in ("gram", "apply"))
            log(f"time block {shape}: K2 {ka:.3f} ms (twin {pa:.3f}, bound {b2:.4f} by {y2}), K3 "
                f"{kb:.3f} ms (twin {pb:.3f}, bound {b3:.4f} by {y3}), whole block {kf:.3f} ms "
                f"(twin {pf:.3f})")
            times.setdefault("fused_block_gram", (ka, pa))
            times.setdefault("fused_block_apply", (kb, pb))

            # K3P beside K3 (in turns: K3, K3P, K3P, K3), A1 beside its twin
            # and the ChannelAttention module, T1 beside its twin and the
            # module tail (cuDNN convs + LeakyReLU + concat + reduce).
            kb0 = cuda_time_ms(lambda: fb.apply_pass(x, apply, wts), n)
            kp = [cuda_time_ms(lambda: fb.apply_pass_pipelined(x, apply, wts), n) for _ in "12"]
            kb1 = cuda_time_ms(lambda: fb.apply_pass(x, apply, wts), n)
            kp, kb3 = sum(kp) / 2, (kb0 + kb1) / 2
            log(f"time K3P {shape}: {kp:.3f} ms (K3 in the same turns {kb3:.3f} ms, twin "
                f"{pb:.3f}, bound {b3:.4f} by {y3})")
            ap = attn_params(c)
            amod = common.ChannelAttention(c, 8, device=dev, compute_dtype=torch.bfloat16)
            amod.load_state_dict(blocks[c].attn.state_dict())
            x4 = x.permute(0, 3, 1, 2)  # NCHW view of the NHWC tensor (channels_last)
            k1 = cuda_time_ms(lambda: fa.fused_channel_attention(x, ap, 8), n)
            p1 = cuda_time_ms(lambda: fa.fused_channel_attention_plain(x, ap, 8), n)
            m1 = cuda_time_ms(lambda: amod(x4), n)
            ba, ya = bound(**attention_counts(*shape))
            log(f"time A1 {shape}: {k1:.3f} ms (twin {p1:.3f}, ChannelAttention module bf16 "
                f"{m1:.3f}, bound {ba:.4f} by {ya})")
            tp, stg = tail_params(c), tails[c]
            t = fb.fused_transformer_block(x, params, 8)
            t4 = t.permute(0, 3, 1, 2)
            act = torch.nn.functional.leaky_relu

            def module_tail():
                conv = act(stg.conv(x4), 0.2)
                return act(stg.Conv_out(stg.channel_reduce(torch.cat([conv, t4], 1))), 0.2)

            k2 = cuda_time_ms(lambda: fs.fused_stage_tail(x, t, tp), n)
            p2 = cuda_time_ms(lambda: fs.fused_stage_tail_plain(x, t, tp), n)
            m2 = cuda_time_ms(module_tail, n)
            bt, yt = bound(**tail_counts(*shape))
            log(f"time T1 {shape}: {k2:.3f} ms (twin {p2:.3f}, module tail bf16 {m2:.3f}, bound "
                f"{bt:.4f} by {yt})")
            times.setdefault("fused_block_apply_pipelined", (kp, pb))
            times.setdefault("fused_attention", (k1, p1))
            times.setdefault("fused_stage_tail", (k2, p2))
            del x, g0, t, t4, x4
        md = u16_to_device(requests[0][0])
        rd = torch.from_numpy(requests[0][1]).to(dev)
        fwd = cuda_time_ms(lambda: pred._u16_forward(md, rd), 20, warmup=5)
        with twin_blocks():
            fwd_twin = cuda_time_ms(lambda: pred._u16_forward(md, rd), 5)
        pfwd = cuda_time_ms(lambda: ppred._u16_forward(md, rd), 20, warmup=5)
        mp = 8 * 512 * 512 / 1e6
        log(f"time RawFormer-S u16 forward, batch 8 @ 512^2: {fwd:.3f} ms, {mp / fwd * 1e3:.1f} MP/s "
            f"(twin blocks: {fwd_twin:.3f} ms; pipelined apply pass: {pfwd:.3f} ms)")
        xf = torch.from_numpy(frames[0]).to(dev)[None, None]
        full = cuda_time_ms(lambda: model(xf), 3, warmup=1)
        pfull = cuda_time_ms(lambda: pmodel(xf), 3, warmup=1)
        log(f"time RawFormer-S full-res frame 2832x4240: {full:.3f} ms, "
            f"{2832 * 4240 / 1e6 / full * 1e3:.1f} MP/s (pipelined apply pass: {pfull:.3f} ms)")
        log(f"peak device memory: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    with torch.no_grad():  # not inference mode: the twins differentiate with autograd
        for shape in BATCH_SHAPES:
            x, dy, wts = bwd_inputs[shape]
            g0, qs0, ks0 = fb.gram_pass_plain(x, wts)
            apply = fb.finalize_attention(g0, qs0, ks0, wts.temperature, wts.wproj, 8)
            dx2, d_apply, _ = fbb.bwd1(x, dy, apply, wts)
            d = fbb.finalize_backward(g0, qs0, ks0, wts.temperature, wts.wproj, d_apply, 8)
            k1 = cuda_time_ms(lambda: fbb.bwd1(x, dy, apply, wts), 10)
            p1 = cuda_time_ms(lambda: fbb.bwd1_plain(x, dy, apply, wts), 5)
            k2 = cuda_time_ms(lambda: fbb.bwd2(x, dx2, apply, *d[:3], wts), 10)
            p2 = cuda_time_ms(lambda: fbb.bwd2_plain(x, dx2, apply, *d[:3], wts), 5)
            (bb1, yb1), (bb2, yb2) = (bound(**block_counts(kind, *shape))
                                      for kind in ("bwd1", "bwd2"))
            log(f"time backward {shape}: B1 {k1:.3f} ms (twin {p1:.3f}, bound {bb1:.4f} by {yb1}), "
                f"B2 {k2:.3f} ms (twin {p2:.3f}, bound {bb2:.4f} by {yb2})")
            times.setdefault("fused_block_bwd1", (k1, p1))
            times.setdefault("fused_block_bwd2", (k2, p2))
        del bwd_inputs

    for bs in (8, 16):
        batch = tuple(torch.cat([a, b]) for a, b in zip(*device_batches(2))) if bs == 16 \
            else device_batches(1)[0]
        for path in ("kernel", "pipelined", "twin") if bs == 8 else ("kernel", "twin"):
            ctx = twin_blocks() if path == "twin" else contextlib.nullcontext()
            with ctx:
                tm = rawformer_s()
                if path == "pipelined":
                    common.set_apply_kernel(tm, "pipelined")
                tr = Trainer(tm, train_cfg)
                tr.train_step(batch)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                ms = cuda_time_ms(lambda: tr.train_step(batch), 5, warmup=2)
                peak = torch.cuda.max_memory_allocated() / 2**30
            log(f"time train step RawFormer-S batch {bs} @ 512^2, {path} path: {ms:.3f} ms "
                f"({bs * 512 * 512 / 1e6 / ms * 1e3:.1f} MP/s), peak device memory {peak:.2f} GiB")
            del tr, tm
            torch.cuda.empty_cache()

    # 6. RawFormer-WFB ----------------------------------------------------------
    # 6a. S1 / S2 against their twins at the WFB-48 batch-2 @ 512^2 scan shapes.
    def scan_inputs(b, L, d, seed):
        """bf16 u, dt, B, C, dy and fp32 A, D as a random Mamba block makes
        them: dt softplus of N(-2.5, 1), A near -(1..32)."""
        g = torch.Generator(device=dev).manual_seed(seed)
        r = lambda *shape: torch.randn(*shape, generator=g, device=dev)  # noqa: E731
        u, B, C, dy = r(b, L, d), r(b, L, 32), r(b, L, 32), 0.1 * r(b, L, d)
        dt = torch.nn.functional.softplus(r(b, L, d) - 2.5)
        A = -torch.arange(1, 33, device=dev, dtype=torch.float32).repeat(d, 1) * torch.exp(
            0.1 * r(d, 32))
        D = 1.0 + 0.1 * r(d)
        u, dt, B, C, dy = (t.to(torch.bfloat16) for t in (u, dt, B, C, dy))
        return (u, dt, A, B, C, D), dy

    def max_rel(got, ref):
        return ((got.float() - ref.float()).abs().max() / ref.float().abs().max()).item()

    errs.update({"ssm_scan_fwd": 0.0, "ssm_scan_bwd": 0.0})
    scan_args = {}
    with torch.no_grad():
        for b, L, d in SCAN_SHAPES:
            args, dy = scan_inputs(b, L, d, seed=L)
            scan_args[(b, L, d)] = (args, dy)
            y = ssk.selective_scan_fwd(*args)
            y_s, states = ssk.selective_scan_fwd(*args, save_states=True)
            y_ref, st_ref = ssm.selective_scan(*args, chunk_size=ssk.FWD_CHUNK,
                                               state_every=ssk.STATE_EVERY)
            y_ref = ssm.selective_scan(*(t.float() for t in args), chunk_size=ssk.FWD_CHUNK)
            err = (y.float() - y_ref).abs()
            scale = y_ref.abs().max().item()
            bad = (err > SCAN_RTOL * y_ref.abs() + SCAN_ATOL_REL * scale).sum().item()
            e_st = max_rel(states, st_ref)
            log(f"S1 scan [{b},{L},{d},32] bf16: y max abs err {err.max().item():.3e} (max|y| "
                f"{scale:.3e}), {bad} elements outside {SCAN_RTOL}|ref| + {SCAN_ATOL_REL} "
                f"max|ref|; "
                f"with states: y identical {torch.equal(y, y_s)}, states err {e_st:.3e} of their "
                f"max (tol {STATE_TOL})")
            check(bad == 0 and torch.equal(y, y_s) and e_st <= STATE_TOL,
                  f"S1 disagrees with its twin at {(b, L, d)}")
            errs["ssm_scan_fwd"] = max(errs["ssm_scan_fwd"], err.max().item())
            got = ssk.selective_scan_bwd(*args, dy, states)
            want = ssm.selective_scan_bwd_ref(*args, dy)
            rel = {n: max_rel(g_, w_) for n, g_, w_ in
                   zip(("du", "ddt", "dA", "dB", "dC", "dD"), got, want)}
            e_du = (got[0] - want[0]).abs().max().item()
            log(f"S2 scan backward [{b},{L},{d},32]: per leaf error of its max "
                + ", ".join(f"{n} {e:.2e}" for n, e in rel.items())
                + f" (tol {SCAN_BWD_TOL}); du max abs err {e_du:.3e}")
            check(max(rel.values()) <= SCAN_BWD_TOL, f"S2 disagrees with its twin at {(b, L, d)}")
            errs["ssm_scan_bwd"] = max(errs["ssm_scan_bwd"], e_du)
            del y, y_s, states, y_ref, st_ref, got, want
        torch.cuda.synchronize()

    # 6b. serving: WFB-48 through Predictor.__call__ (pad_to 32).
    def rawformer_wfb():
        return get_model("rawformer_wfb", device=dev, generator=torch.Generator().manual_seed(0),
                         dtype=torch.bfloat16)

    wfb = rawformer_wfb()
    wpred = Predictor(wfb, device=dev, pad_to=32)
    wreqs = []
    for _ in range(3):
        raw = mosaics(rng, (2, 512, 512, 1)).astype(np.float32)
        wreqs.append(np.clip((raw - 512.0) / (16383.0 - 512.0), 0.0, None)
                     * rng.uniform(50.0, 300.0, (2, 1, 1, 1)).astype(np.float32))
    torch.cuda.synchronize()
    for fn in counters:
        fn.launches = 0
    t0 = time.perf_counter()
    wouts = [wpred(x) for x in wreqs] + [wpred(frames[0])]
    wserve_s = time.perf_counter() - t0
    wfb_launches = {fn.__name__: fn.launches for fn in counters}
    log(f"RawFormer-WFB-48 served 3 x 2 x 512^2 float requests + one 2832x4240 frame in "
        f"{wserve_s:.2f} s; launches {wfb_launches}")
    check(wfb_launches["selective_scan_fwd"] == 7 * len(wouts),
          "S1 did not run 7 times per forward")
    check(sum(wfb_launches.values()) == wfb_launches["selective_scan_fwd"],
          "another kernel ran while serving RawFormer-WFB")
    for y, shape in zip(wouts, [x.shape[:3] for x in wreqs] + [frames[0].shape]):
        check(y.shape == shape + (3,) and bool(np.isfinite(y).all()),
              f"WFB output not finite of shape {shape + (3,)}")
    common.set_fused_blocks(wfb, False)
    wtwin = wpred(wreqs[0])
    common.set_fused_blocks(wfb, True)
    d = np.abs(wouts[0] - wtwin)
    log(f"WFB kernel path vs twin path, 2 x 512^2: max abs err {d.max():.3e} (tol {E2E_MAX_TOL}), "
        f"mean {d.mean():.3e} (tol {E2E_MEAN_TOL})")
    check(d.max() <= E2E_MAX_TOL and d.mean() <= E2E_MEAN_TOL,
          "WFB kernel path disagrees with the twin path")

    # 6c. training: Trainer on synthetic crops, kernel path vs twin path.
    small_ds = SyntheticBayerDataset(num_images=2, full_size=(320, 320), patch_size=256,
                                     training=True)
    small = list(prefetch_to_device(((i, g) for i, g, _ in Loader(small_ds, 2, seed=0)), dev))[0]
    kern = Trainer(rawformer_wfb(), train_cfg)
    twin = Trainer(rawformer_wfb(), dataclasses.replace(train_cfg, fused_blocks=False))
    runs = []
    for tr in (kern, twin):
        torch.cuda.synchronize()
        for fn in counters:
            fn.launches = 0
        losses = [float(tr.train_step(small))]
        grads = {n: p.grad.float().clone() for n, p in tr.model.named_parameters()
                 if p.grad is not None}
        losses.append(float(tr.train_step(small)))
        torch.cuda.synchronize()
        runs.append((losses, grads, {fn.__name__: fn.launches for fn in counters}))
    (kern_losses, kern_grads, wfb_train_launches), (twin_losses, twin_grads, twin_launches) = runs
    log(f"WFB train steps at batch 2 @ 256^2: launches kernel path {wfb_train_launches}, "
        f"twin path {twin_launches}")
    check(wfb_train_launches["selective_scan_fwd"] == wfb_train_launches["selective_scan_bwd"]
          == 7 * 2, "S1 with states and S2 did not run 7 times per train step")
    check(sum(twin_launches.values()) == 0, "a kernel ran on the twin path")
    nudged = Trainer(rawformer_wfb(), dataclasses.replace(train_cfg, fused_blocks=False))
    nudged.train_step((small[0] * (1.0 + 2.0 ** -9), small[1]))
    yard = {n: ((p.grad.float() - twin_grads[n]).abs().max()
                / (twin_grads[n].abs().max() + 1e-12)).item()
            for n, p in nudged.model.named_parameters() if p.grad is not None}
    del nudged
    grad_err = {n: ((kern_grads[n] - g).abs().max() / (g.abs().max() + 1e-12)).item()
                for n, g in twin_grads.items()}
    held = [n for n in grad_err if "frequency_process" not in n]
    worst = max(held, key=lambda n: grad_err[n] / max(3 * yard[n], WFB_GRAD_FLOOR))
    bad = [n for n in held if grad_err[n] > max(3 * yard[n], WFB_GRAD_FLOOR)]
    feb_worst = max((n for n in grad_err if n not in held), key=grad_err.get)
    log("WFB nudged twin vs twin, first-step grads: largest change of a FEB leaf "
        f"{max(yard[n] for n in yard if n not in held):.3e}, of another leaf "
        f"{max(yard[n] for n in held):.3e} (of the twin's leaf max)")
    median = float(np.median(list(grad_err.values())))
    sk, st = kern.model.state_dict(), twin.model.state_dict()
    dp = max((sk[n].float() - st[n].float()).abs().max().item() for n, _ in
             kern.model.named_parameters())
    dbn = max(((sk[n] - st[n]).abs().max() / st[n].abs().max()).item() for n in sk
              if "running" in n)
    dl = abs(kern_losses[0] - twin_losses[0]) / abs(twin_losses[0])
    log(f"WFB train step kernel path vs twin path: losses {kern_losses} vs {twin_losses} (first "
        f"rel err {dl:.3e}, tol {TRAIN_LOSS_RTOL}); first-step grads of the twin's leaf max, "
        f"outside the FEB islands worst against its yardstick {worst} {grad_err[worst]:.3e} "
        f"(nudged twin {yard[worst]:.3e}, floor {WFB_GRAD_FLOOR}); FEB worst {feb_worst} "
        f"{grad_err[feb_worst]:.3e} (nudged twin {yard[feb_worst]:.3e}, not held); median "
        f"{median:.3e} (tol {WFB_GRAD_MEDIAN_TOL}), nudged "
        f"twin median {float(np.median(list(yard.values()))):.3e}; params after 2 Adam steps "
        f"max abs diff {dp:.3e} (tol "
        f"{TRAIN_PARAM_ATOL}); BN running stats {dbn:.3e} of their max (tol {WFB_BN_TOL})")
    check(dl <= TRAIN_LOSS_RTOL, "WFB train loss disagrees with the twin path")
    check(not bad and median <= WFB_GRAD_MEDIAN_TOL,
          f"WFB grads disagree with the twin path: {bad}")
    check(dp <= TRAIN_PARAM_ATOL, "WFB params after Adam steps disagree with the twin path")
    check(dbn <= WFB_BN_TOL, "WFB BatchNorm running stats disagree with the twin path")
    twin_ms = cuda_time_ms(lambda: twin.train_step(small), 3, warmup=1)
    del twin
    small_ms = cuda_time_ms(lambda: kern.train_step(small), 3, warmup=1)  # steps 3-6
    for _ in range(20 - 6):
        kern_losses.append(float(kern.train_step(small)))
    log(f"WFB 20 steps on one batch: loss {kern_losses[0]:.5f} -> {kern_losses[-1]:.5f}")
    check(kern_losses[-1] < kern_losses[0], "20 WFB steps on one batch did not lower its loss")
    log(f"time WFB-48 train step batch 2 @ 256^2: kernel path {small_ms:.3f} ms, twin path "
        f"{twin_ms:.3f} ms")
    del kern
    torch.cuda.empty_cache()

    # 6d. timing: S1 / S2 vs twins with their bounds, the WFB forward and step.
    bounds = {}
    with torch.no_grad():
        for (b, L, d), (args, dy) in scan_args.items():
            _, states = ssk.selective_scan_fwd(*args, save_states=True)
            n_it = 20 if L >= 4096 else 50
            k = cuda_time_ms(lambda: ssk.selective_scan_fwd(*args), n_it)
            kst = cuda_time_ms(lambda: ssk.selective_scan_fwd(*args, save_states=True), n_it)
            p = cuda_time_ms(lambda: ssm.selective_scan(*args, chunk_size=ssk.FWD_CHUNK), 3, 1)
            kb = cuda_time_ms(lambda: ssk.selective_scan_bwd(*args, dy, states), n_it)
            pb = cuda_time_ms(lambda: ssm.selective_scan_bwd_ref(*args, dy), 2, 1)
            bf, byf = bound(**scan_counts(b, L, d, 32, 2, backward=False))
            bb, byb = bound(**scan_counts(b, L, d, 32, 2, backward=True))
            log(f"time scan [{b},{L},{d},32] bf16: S1 {k:.4f} ms (with states {kst:.4f}; twin "
                f"{p:.3f}; bound {bf:.4f} by {byf}), S2 {kb:.4f} ms (twin {pb:.3f}; bound "
                f"{bb:.4f} by {byb})")
            times.setdefault("ssm_scan_fwd", (k, p))
            times.setdefault("ssm_scan_bwd", (kb, pb))
            bounds.setdefault("ssm_scan_fwd", (bf, byf))
            bounds.setdefault("ssm_scan_bwd", (bb, byb))
            del states
    del scan_args
    xw = torch.from_numpy(wreqs[0]).to(dev).permute(0, 3, 1, 2).contiguous()
    with torch.inference_mode():
        fwd = cuda_time_ms(lambda: wfb(xw), 10, warmup=3)
        common.set_fused_blocks(wfb, False)
        fwd_twin = cuda_time_ms(lambda: wfb(xw), 3, warmup=1)
        common.set_fused_blocks(wfb, True)
        xf = torch.nn.functional.pad(torch.from_numpy(frames[0]).to(dev)[None, None],
                                     (0, 16, 0, 16))
        torch.cuda.reset_peak_memory_stats()
        full = cuda_time_ms(lambda: wfb(xf), 3, warmup=1)
        full_peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"time RawFormer-WFB-48 forward, batch 2 @ 512^2: {fwd:.3f} ms, "
        f"{2 * 512 * 512 / 1e6 / fwd * 1e3:.1f} MP/s (twin scan: {fwd_twin:.3f} ms); one "
        f"2832x4240 frame (padded to 2848x4256): {full:.3f} ms, peak {full_peak:.2f} GiB")
    del wfb, wpred
    torch.cuda.empty_cache()
    for bs in (8, 4, 2):
        try:
            batch = device_batches(1)[0]
            batch = tuple(t[:bs] for t in batch)
            tr = Trainer(rawformer_wfb(), train_cfg)
            tr.train_step(batch)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ms = cuda_time_ms(lambda: tr.train_step(batch), 3, warmup=1)
            peak = torch.cuda.max_memory_allocated() / 2**30
        except torch.cuda.OutOfMemoryError:
            log(f"WFB-48 train step at batch {bs} @ 512^2: out of device memory")
            tr = batch = None
            torch.cuda.empty_cache()
            continue
        log(f"time train step RawFormer-WFB-48 batch {bs} @ 512^2, kernel path: {ms:.3f} ms "
            f"({bs * 512 * 512 / 1e6 / ms * 1e3:.1f} MP/s), peak device memory {peak:.2f} GiB")
        break
    del tr
    torch.cuda.empty_cache()

    # 8. the probe ladders ------------------------------------------------------
    del pmodel, ppred
    torch.cuda.empty_cache()
    for fn in (probes.floor_probe, probes.bisect_probe, fb.apply_pass, fb.apply_pass_pipelined):
        fn.launches = 0
    t0 = time.perf_counter()
    floor_rows = probes.run_floor_ladder(BATCH_SHAPES[0], iters=10)
    for r in floor_rows:
        err = "-" if r["err"] is None else f"{r['err']:.2e}"
        bf_, byf_ = bound(**floor_counts(r["level"], *BATCH_SHAPES[0]))
        log(f"probe floor {list(BATCH_SHAPES[0])} {r['strategy']:6s} {r['level']} th={r['th']:2d}: "
            f"{r['ms']:.4f} ms, {r['gbs']:.1f} GB/s, err {err} (bound {bf_:.4f} by {byf_})")
        if r["err"] is not None:
            check(r["err"] <= (0.0 if r["level"] == "c" else PROBE_TOL),
                  f"floor probe {r['strategy']}/{r['level']} th={r['th']} disagrees with its twin")
    bisect_rows = probes.run_bisect_ladder(BATCH_SHAPES, iters=10)
    for r in bisect_rows:
        bs_, bys_ = bound(**stage_counts(r["stage"], *r["shape"]))
        log(f"probe bisect {list(r['shape'])} {r['apply_kernel']:9s} stage {r['stage']}: "
            f"{r['ms']:.4f} ms, {r['gbs']:.1f} GB/s, err {r['err']:.2e} (bound {bs_:.4f} by "
            f"{bys_})")
        check(r["err"] <= PROBE_TOL, f"bisect probe {r} disagrees with its twin")
    probe_launches = {"probe_floor": probes.floor_probe.launches,
                      "probe_bisect": probes.bisect_probe.launches}
    log(f"probe ladders in {time.perf_counter() - t0:.1f} s; launches {probe_launches} (stage 5 "
        f"rungs: K3 {fb.apply_pass.launches}, K3P {fb.apply_pass_pipelined.launches})")
    with torch.no_grad():  # the twins' times for the table's rows
        g = torch.Generator().manual_seed(0)
        x = torch.randn(BATCH_SHAPES[0], generator=g).to(dev, torch.bfloat16)
        w = (torch.randn(32, 32, generator=g) / 32 ** 0.5).to(dev, torch.bfloat16)
        dw = (torch.randn(9, 32, generator=g) / 3.0).to(dev)
        floor_twin = cuda_time_ms(lambda: probes.floor_probe_plain(x, w, dw, "c"), 10)
        wts = probes.block_weights(32, 32, dev)
        apply = fb.finalize_attention(*fb.gram_pass_plain(x, wts), wts.temperature, wts.wproj, 8)
        bisect_twin = cuda_time_ms(lambda: probes.bisect_probe_plain(x, apply, wts, 1), 10)
        del x, apply
    floor_row = next(r for r in floor_rows if (r["strategy"], r["level"], r["th"]) == ("plain", "c", 8))
    bisect_row = next(r for r in bisect_rows if r["shape"] == BATCH_SHAPES[0]
                      and (r["apply_kernel"], r["stage"]) == ("tiled", 1))
    times["probe_floor"] = (floor_row["ms"], floor_twin)
    times["probe_bisect"] = (bisect_row["ms"], bisect_twin)
    errs["probe_floor"] = max(r["err"] for r in floor_rows if r["err"] is not None)
    errs["probe_bisect"] = max(r["err"] for r in bisect_rows)
    bounds["probe_floor"] = bound(**floor_counts("c", *BATCH_SHAPES[0]))
    bounds["probe_bisect"] = bound(**stage_counts(1, *BATCH_SHAPES[0]))

    for name, kind in (("fused_block_gram", "gram"), ("fused_block_apply", "apply"),
                       ("fused_block_bwd1", "bwd1"), ("fused_block_bwd2", "bwd2"),
                       ("fused_block_apply_pipelined", "apply")):
        bounds[name] = bound(**block_counts(kind, *BATCH_SHAPES[0]))
    bounds["fused_attention"] = bound(**attention_counts(*BATCH_SHAPES[0]))
    bounds["fused_stage_tail"] = bound(**tail_counts(*BATCH_SHAPES[0]))
    b, h, w = PACK_SHAPES[0]
    bounds["bayer_pack"] = bound(nbytes=b * h * w * 4 + 4 * b, fp32=4.0 * b * h * w)

    rows = [
        ("bayer_pack", PKG + "csrc/bayer_pack.cu", TPU + "bayer_pack.py:34",
         launches["bayer_pack_normalize"]),
        ("fused_block_gram", PKG + "csrc/fused_block.cu", TPU + "fused_block.py:406",
         launches["gram_pass"]),
        ("fused_block_apply", PKG + "csrc/fused_block.cu", TPU + "fused_block.py:683",
         launches["apply_pass"]),
        ("fused_block_bwd1", PKG + "csrc/fused_block_bwd.cu", TPU + "fused_block_bwd.py:194",
         train_launches["bwd1"]),
        ("fused_block_bwd2", PKG + "csrc/fused_block_bwd.cu", TPU + "fused_block_bwd.py:318",
         train_launches["bwd2"]),
        ("ssm_scan_fwd", PKG + "csrc/ssm_scan.cu",
         TPU + "ssm_scan.py:92, " + TPU + "ssm_scan.py:272", wfb_launches["selective_scan_fwd"]),
        ("ssm_scan_bwd", PKG + "csrc/ssm_scan.cu", TPU + "ssm_scan.py:299",
         wfb_train_launches["selective_scan_bwd"]),
        ("fused_block_apply_pipelined", PKG + "csrc/apply_pipelined.cuh", TPU + "fused_block.py:494",
         pipe_launches["apply_pass_pipelined"]),
        ("fused_attention", PKG + "csrc/fused_attention.cu", "attic/fused_attention.py:67",
         aux_launches["fused_attention"]),
        ("fused_stage_tail", PKG + "csrc/fused_stage.cu", "attic/fused_stage.py:75",
         aux_launches["fused_stage_tail"]),
        ("probe_floor", PKG + "csrc/probes_floor.cu",
         "benchmarks/probe_floor.py:60, benchmarks/exp_dma_floor.py:113, "
         "benchmarks/exp_dma_floor.py:125, benchmarks/exp_dma_floor.py:147, "
         "benchmarks/exp_dma_bw.py:83",
         probe_launches["probe_floor"]),
        ("probe_bisect", PKG + "csrc/probes_bisect.cu", "benchmarks/bisect_b5.py:106",
         probe_launches["probe_bisect"]),
    ]
    log("kernel table: times and bounds of bayer_pack at [8,512,512] u16, fused_block_*, "
        "fused_attention, fused_stage_tail and the probes at [8,256,256,32] bf16 (probe_floor: "
        "the plain/c/th=8 rung; probe_bisect: K3 cut after stage 1), ssm_scan_* at "
        "[6,16384,96,32] bf16 (ssm_scan_fwd without states); launches of K1-K3 from RawFormer-S "
        "serving, of K3P from its pipelined serving, of B1/B2 from its training, of "
        "ssm_scan_fwd from WFB serving, of ssm_scan_bwd from WFB training, of A1, T1 and the "
        "probes from their own experiments (no model calls them); max_abs_err of B1/B2 on "
        "dx2 / dx, of ssm_scan_fwd on y, of ssm_scan_bwd on du, of the probes relative to "
        "the twin's max; no single PyTorch call computes any of these functions (library_ms "
        "null)")
    log(card)
    log(json.dumps({"kernels": [
        {"name": n, "route": "cuda", "source": s, "replaces": r, "launches": l,
         "max_abs_err": errs[n], "ms": times[n][0], "plain_ms": times[n][1],
         "bound_ms": bounds[n][0], "bound_by": bounds[n][1], "library_ms": None}
        for n, s, r, l in rows
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
