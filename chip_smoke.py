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
   8 and 16 @ 512x512 on the kernel and the twin path (with peak memory).

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
# B1/B2, each output leaf (dx2, d_apply, dx, every folded-weight grad): the
# kernel's max error relative to the fp32 twin's leaf max must be within
# max(3 x the bf16 twin's, BWD_FLOOR) (tests/test_fused_bwd.py's yardstick;
# the bf16 twin is the fp32 twin under torch.autocast(bfloat16)).
BWD_FLOOR = 2e-2
# Training, kernel path vs twin path from the same init on the same batch:
# loss relative, params after two Adam steps (the first at lr 0) absolute.
TRAIN_LOSS_RTOL, TRAIN_PARAM_ATOL = 2e-2, 5e-4

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
            # Itanium mangling: <length><identifier>, then the template args;
            # the length may follow digits of the namespace hash.
            mangled, name = m.group(1), m.group(1)
            for k in re.finditer(r"(?<=\d)(?=([a-z]\w*?_kernel))", mangled):
                ident = k.group(1)
                if re.search(r"\d+$", mangled[: k.start()]).group().endswith(str(len(ident))):
                    t = re.match(r"ILi(\d+)E|I(f)E|I13__nv_(bfloat16)E",
                                 mangled[k.start() + len(ident):])
                    arg = next(filter(None, t.groups()), None) if t else None
                    name = ident + (f"<{'float' if arg == 'f' else arg}>" if arg else "")
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
    from bayer_low_light_image_enhancement_tpu_torch.kernels import fused_block as fb
    from bayer_low_light_image_enhancement_tpu_torch.kernels import fused_block_bwd as fbb
    from bayer_low_light_image_enhancement_tpu_torch.models import common, get_model
    from bayer_low_light_image_enhancement_tpu_torch.serving import Predictor
    from bayer_low_light_image_enhancement_tpu_torch.train import TrainConfig, Trainer

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
            "fused_block_bwd1": 0.0, "fused_block_bwd2": 0.0}
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
    counters = (bp.bayer_pack_normalize, fb.gram_pass, fb.apply_pass, fbb.bwd1, fbb.bwd2)
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
    check(launches["bwd1"] == launches["bwd2"] == 0, "a backward kernel ran while serving")
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
            log(f"time backward {shape}: B1 {k1:.3f} ms (twin {p1:.3f}), B2 {k2:.3f} ms "
                f"(twin {p2:.3f})")
            times.setdefault("fused_block_bwd1", (k1, p1))
            times.setdefault("fused_block_bwd2", (k2, p2))
        del bwd_inputs

    for bs in (8, 16):
        batch = tuple(torch.cat([a, b]) for a, b in zip(*device_batches(2))) if bs == 16 \
            else device_batches(1)[0]
        for path in ("kernel", "twin"):
            ctx = twin_blocks() if path == "twin" else contextlib.nullcontext()
            with ctx:
                tr = Trainer(rawformer_s(), train_cfg)
                tr.train_step(batch)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                ms = cuda_time_ms(lambda: tr.train_step(batch), 5, warmup=2)
                peak = torch.cuda.max_memory_allocated() / 2**30
            log(f"time train step RawFormer-S batch {bs} @ 512^2, {path} path: {ms:.3f} ms "
                f"({bs * 512 * 512 / 1e6 / ms * 1e3:.1f} MP/s), peak device memory {peak:.2f} GiB")
            del tr
            torch.cuda.empty_cache()

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
    ]
    log("kernel table: times of bayer_pack at [8,512,512] u16, fused_block_* at "
        "[8,256,256,32] bf16; launches of K1-K3 from serving, of B1/B2 from training; "
        "max_abs_err of B1/B2 on dx2 / dx")
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
