#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one CUDA card

Phases (any failed check raises and the script exits non-zero):

1. environment: torch / CUDA versions, the card's name and power limit;
2. build: nvcc compiles ``bayer_low_light_image_enhancement_tpu_torch/csrc``;
3. each kernel against its plain PyTorch twin on the card, at the shapes the
   RawFormer-S serving path gives it (batch 8 @ 512x512 and one 2832x4240
   frame), with the tolerances below;
4. serving: RawFormer-S (dim 32, heads 8/8/8/8, FFN 2, seeded random
   weights, bf16 compute) answers 3 requests of 8 uint16 mosaics at 512x512
   through ``Predictor.raw_u16`` and two float frames (2832x4240, 1000x1500)
   through ``Predictor.__call__``; the launch counters must show every
   kernel ran, and the kernel path must match the twin path;
5. timing with CUDA events after warmup: each kernel against its twin, the
   batch-8 forward and the full-resolution frame.

The line before the last is the JSON kernel table; the last line is
``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
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

BATCH_SHAPES = [(8, 256, 256, 32), (8, 128, 128, 64), (8, 64, 64, 128), (8, 32, 32, 256)]
FULLRES_SHAPES = [(1, 1416, 2120, 32), (1, 177, 265, 256)]
PACK_SHAPES = [(8, 512, 512), (1, 2832, 4240)]
TPU = "bayer_low_light_image_enhancement_tpu/kernels/"
PKG = "bayer_low_light_image_enhancement_tpu_torch/"


def log(*a):
    print(*a, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def cuda_time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of fn() over iters calls, CUDA events, after warmup."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def ptxas_summary(build_log: str):
    """One line per compiled kernel: registers, barriers, stack and spills,
    from nvcc's -Xptxas -v output."""
    name, spill = None, ""
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            k = re.search(r"\d+([a-z][a-z_]*?_kernel)(?:ILi(\d+)E|I(f)E|I13__nv_(bfloat16)E)?",
                          m.group(1))
            arg = next(filter(None, k.groups()[1:]), None)
            name = k.group(1) + (f"<{'float' if arg == 'f' else arg}>" if arg else "")
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
    from bayer_low_light_image_enhancement_tpu_torch.kernels import fused_block as fb
    from bayer_low_light_image_enhancement_tpu_torch.models import common, get_model
    from bayer_low_light_image_enhancement_tpu_torch.serving import Predictor

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
    errs = {"bayer_pack": 0.0, "fused_block_gram": 0.0, "fused_block_apply": 0.0}
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
        blocks = {}
        for shape in BATCH_SHAPES + FULLRES_SHAPES:
            b, h, w, c = shape
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
            out = fb.apply_pass(x, apply, wts).float()
            ref = fb.apply_pass_plain(x, apply, wts).float()
            d = (out - ref).abs()
            bad = (d > BLOCK_ATOL + BLOCK_RTOL * ref.abs()).sum().item()
            log(f"K3 apply {shape}: max abs err {d.max().item():.3e}, mean {d.mean().item():.3e}, "
                f"{bad} elements outside atol=rtol={BLOCK_ATOL}")
            check(bad == 0, f"K3 disagrees with its twin at {shape}")
            errs["fused_block_apply"] = max(errs["fused_block_apply"], d.max().item())

            full = fb.fused_transformer_block(x, params, 8).float()
            full0 = fb.fused_transformer_block_plain(x, params, 8).float()
            d = (full - full0).abs()
            bad = (d > BLOCK_ATOL + BLOCK_RTOL * full0.abs()).sum().item()
            log(f"K2+K3 block {shape}: max abs err {d.max().item():.3e}, mean {d.mean().item():.3e}, "
                f"{bad} elements outside atol=rtol={BLOCK_ATOL}")
            check(bad == 0, f"fused block disagrees with its twin at {shape}")
            del x, g, g0, out, ref, full, full0, d
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
    counters = (bp.bayer_pack_normalize, fb.gram_pass, fb.apply_pass)
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

    # 5. timing ---------------------------------------------------------------
    times = {}
    with torch.inference_mode():
        for shape in PACK_SHAPES:
            m = u16_to_device(mosaics(rng, shape))
            r = torch.full((shape[0],), 100.0, device=dev)
            k = cuda_time_ms(lambda: bp.bayer_pack_normalize(m, r, torch.bfloat16, True), 20)
            p = cuda_time_ms(lambda: bp.bayer_pack_normalize_plain(m, r, torch.bfloat16, True), 20)
            gbs = m.numel() * 4 / (k * 1e-3) / 1e9
            log(f"time K1 {shape}: kernel {k:.4f} ms ({gbs:.0f} GB/s), twin {p:.4f} ms")
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
            log(f"time block {shape}: K2 {ka:.3f} ms (twin {pa:.3f}), K3 {kb:.3f} ms "
                f"(twin {pb:.3f}), whole block {kf:.3f} ms (twin {pf:.3f})")
            times.setdefault("fused_block_gram", (ka, pa))
            times.setdefault("fused_block_apply", (kb, pb))
            del x, g0
        md = u16_to_device(requests[0][0])
        rd = torch.from_numpy(requests[0][1]).to(dev)
        fwd = cuda_time_ms(lambda: pred._u16_forward(md, rd), 20, warmup=5)
        with twin_blocks():
            fwd_twin = cuda_time_ms(lambda: pred._u16_forward(md, rd), 5)
        mp = 8 * 512 * 512 / 1e6
        log(f"time RawFormer-S u16 forward, batch 8 @ 512^2: {fwd:.3f} ms, {mp / fwd * 1e3:.1f} MP/s "
            f"(twin blocks: {fwd_twin:.3f} ms)")
        xf = torch.from_numpy(frames[0]).to(dev)[None, None]
        full = cuda_time_ms(lambda: model(xf), 3, warmup=1)
        log(f"time RawFormer-S full-res frame 2832x4240: {full:.3f} ms, "
            f"{2832 * 4240 / 1e6 / full * 1e3:.1f} MP/s")
        log(f"peak device memory: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    rows = [
        ("bayer_pack", PKG + "csrc/bayer_pack.cu", TPU + "bayer_pack.py:34",
         launches["bayer_pack_normalize"]),
        ("fused_block_gram", PKG + "csrc/fused_block.cu", TPU + "fused_block.py:406",
         launches["gram_pass"]),
        ("fused_block_apply", PKG + "csrc/fused_block.cu", TPU + "fused_block.py:683",
         launches["apply_pass"]),
    ]
    log("kernel table times: bayer_pack at [8,512,512] u16, fused_block_* at [8,256,256,32] bf16")
    log(card)
    log(json.dumps({"kernels": [
        {"name": n, "route": "cuda", "source": s, "replaces": r, "launches": l,
         "max_abs_err": errs[n], "ms": times[n][0], "plain_ms": times[n][1]}
        for n, s, r, l in rows
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
