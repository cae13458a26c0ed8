"""Time kernels and train steps for several checkouts of the port on one
card, in turns.

    python -m bayer_low_light_image_enhancement_tpu_torch.utils.time_trees \\
        ROOT [ROOT ...] [--what bwd,step,scan,block,pipe,wgrad,pack,tail,attn,floor,wide] \
        [--turns 2]

Each ROOT is a directory that holds a copy of the package (``.`` for this
checkout; another commit unpacked by ``git archive`` into an ignored
directory, say). Two calls to a machine may land on two cards, so versions
are compared only within one run: the roots run in the order given, then
in reverse (``A B B A`` for two roots and two turns), each in a process of
its own that imports the package from its root and builds that root's
kernels. Per root and turn it prints

* ``bwd``: B1 and B2 as whole wrapper calls (every launch, the weight-grad
  pass included; CUDA events, 10 calls after 3, twice) at the RawFormer-S
  block shapes of batch 8 @ 512^2, seeded random weights and inputs;
* ``step``: ``Trainer.train_step`` of RawFormer-S at batch 8 and 16 @ 512^2
  (CUDA events over 5 steps after 2, three times);
* ``scan``: S1 (``selective_scan_fwd``) without states at the scan shapes
  of a WFB-48 batch-2 @ 512^2 forward (b = 3 bands x 2), then S2
  (``selective_scan_bwd``) and S1 with states at those of a batch-8 @
  512^2 train step (b = 3 x 8; N = 32; seeded bf16 inputs as a random
  Mamba block makes them), each as whole wrapper calls (10 calls after 3,
  twice) and each of its kernels by its device time per call
  (``torch.profiler`` over 5 calls); then the WFB-48 forward at batch 2 @
  512^2 (CUDA events over 10 calls after 3, twice) and
  ``Trainer.train_step`` at batch 8 @ 512^2 (3 steps after 1, twice);
* ``block``: K2 (``gram_pass``) and K3 (``apply_pass``) as whole wrapper
  calls at the six block shapes of RawFormer-S serving (batch 8 @ 512^2 and
  the 2832x4240 frame's first and deepest levels; 20 calls after 3, three
  times: at the deep levels the calls can be bound by the host),
  the whole fused block (K2 + ``finalize_attention`` + K3) beside the bf16
  unfused ``TransformerBlock`` module path (``fused = False``: cuDNN convs,
  the library-path yardstick), K2's and K3's kernels by their device time
  per call (``torch.profiler`` over 5 calls), then the RawFormer-S u16
  forward at batch 8 @ 512^2 (20 calls after 5, twice) and one 2832x4240
  frame (3 after 1, twice);
* ``pipe``: K3P (``apply_pass_pipelined``) beside K3 (``apply_pass``) as
  whole wrapper calls at the six block shapes of ``block`` (in turns: K3,
  K3P, K3P, K3, K3, K3P; 20 calls after 3 each), then each one's kernels by
  device time per call (``torch.profiler`` over 5 calls), and the bisect
  ladder's rungs of both (``probes.floor.bisect_probe``, stages 1-5) by the
  device time of their apply kernels;
* ``wgrad``: the weight-grad pass (``weight_grad``) on every launch the
  RawFormer-S train step hands it at batch 8 and 16 (C = 128 and 256): B2's
  product beside one bf16 ``torch.matmul`` of the same operands, B1's three
  products (one launch) beside three; in turns (pass, matmuls, matmuls,
  pass; 20 calls after 3 each), then the pass's kernels by device time;
* ``pack``: K1 (``bayer_pack_normalize``, bf16 out with the clamp, as
  ``Predictor.raw_u16`` calls it) at [8,512,512] and [1,2832,4240], seeded
  codes: whole calls (CUDA events over 20 calls after 3, three times), the
  host's ms a call (200 calls enqueued back to back: the wrapper, its
  ``torch.empty`` alone, the C entry point alone) and its kernel by device
  time per call (``torch.profiler`` over 5 calls), beside the bound by bytes;
* ``tail``: T1 (``fused_stage_tail``) at the six block shapes of ``block``
  on a seeded ``ConvTransformer``'s weights, bf16 x and t: whole calls
  (20 after 3, three times), each of its kernels by device time per call,
  beside the bf16 module tail (``fused_stage.module_tail``: the module's
  cuDNN convs, LeakyReLUs, concat and reduce; read where the tree has it)
  timed the same way, the bound and T1's plan (where the tree has one);
* ``attn``: A1 (``fused_channel_attention``, 8 heads) at the six block
  shapes of ``block`` on a seeded ``ChannelAttention``'s weights, bf16 x:
  whole calls (20 after 3, three times), the host's ms a call (200 calls
  enqueued back to back) and each of its kernels by device time per call,
  beside the bf16 ``ChannelAttention`` module on the NCHW
  view of x (as ``chip_smoke.py`` builds it), timed the same way, and the
  bound;
* ``floor``: the floor ladder's level-c rungs (``probes.floor.floor_probe``)
  of every strategy the tree has at tile heights 4, 8 and 16 on a seeded
  [8,256,256,32] bf16 x, whole calls (20 after 3, three times) and by
  device time per call, beside ``out.copy_(x)`` (the one PyTorch call of
  level c's function) timed the same way, and the bound by bytes;
* ``wide``: K2 and K3 at RawFormer-B's and -L's banded bottleneck, [8, 23,
  272, C] for C = 384 and 512 (one Sony frame's 8 bands; seeded
  ``probes.floor.block_weights``, bf16 x), plain (``gram_pass`` /
  ``apply_pass`` on the 8 bands as images) and in band mode
  (``gram_pass_banded`` / ``apply_pass_banded`` on the halo'd bands, the
  frame 184 rows): whole wrapper calls (20 after 3, three times) and each
  one's kernels by device time per call; the whole banded block
  (``fused_transformer_block(bands=8)``: the halo copy, K2, the frame sums,
  the finalise, K3) beside the bf16 band-aware module-path block
  (``fused = False``), 20 calls after 3, three times; then RawFormer-B and
  -L (seeded, bf16) on a 2944x4352 mosaic in 8 bands
  (``make_banded_forward``, as the eval CLI's band route runs a Sony frame)
  and monolithic, 3 calls after 1, twice.

A card is required: there is no CPU fallback.
"""

from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys

BATCH_SHAPES = [(8, 256, 256, 32), (8, 128, 128, 64), (8, 64, 64, 128), (8, 32, 32, 256)]
FULLRES_SHAPES = [(1, 1416, 2120, 32), (1, 177, 265, 256)]
SCAN_SERVE_SHAPES = [(6, 16384, 96), (6, 4096, 192), (6, 1024, 384), (6, 256, 768)]
SCAN_TRAIN_SHAPES = [(24, 16384, 96), (24, 4096, 192), (24, 1024, 384), (24, 256, 768)]


def _scan_inputs(b, L, d, dev):
    """bf16 u, dt, B, C, dy and fp32 A, D as a random Mamba block makes
    them (dt softplus of N(-2.5, 1), A near -(1..32)), seeded by L."""
    import torch

    g = torch.Generator(device=dev).manual_seed(L)
    r = lambda *shape: torch.randn(*shape, generator=g, device=dev)  # noqa: E731
    u, B, C, dy = r(b, L, d), r(b, L, 32), r(b, L, 32), 0.1 * r(b, L, d)
    dt = torch.nn.functional.softplus(r(b, L, d) - 2.5)
    A = -torch.arange(1, 33, device=dev, dtype=torch.float32).repeat(d, 1) * torch.exp(
        0.1 * r(d, 32))
    D = 1.0 + 0.1 * r(d)
    u, dt, B, C, dy = (t.to(torch.bfloat16) for t in (u, dt, B, C, dy))
    return (u, dt, A, B, C, D), dy


def _child(root: str, what: str) -> None:
    """Measure the package found under ``root``. Run as a script, this file's
    directory leads sys.path, where utils/logging.py would shadow the
    standard library's: it goes first."""
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [q for q in sys.path if os.path.abspath(q or ".") != here]
    sys.path.insert(0, os.path.abspath(root))
    import torch

    from bayer_low_light_image_enhancement_tpu_torch.kernels import _build
    from bayer_low_light_image_enhancement_tpu_torch.kernels import fused_block as fb
    from bayer_low_light_image_enhancement_tpu_torch.kernels import fused_block_bwd as fbb
    from bayer_low_light_image_enhancement_tpu_torch.models import common, get_model
    from bayer_low_light_image_enhancement_tpu_torch.train import TrainConfig, Trainer
    from bayer_low_light_image_enhancement_tpu_torch.utils.profiling import cuda_time_ms

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")

    def kernels(fn):
        """{kernel name: device ms per call of ``fn``} (the profiler over 5
        calls)."""
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                fn()
            torch.cuda.synchronize()
        out = {}
        for e in prof.key_averages():
            us = getattr(e, "self_device_time_total", None)
            us = getattr(e, "self_cuda_time_total", 0) if us is None else us
            if us > 0:
                kernel = re.sub(r"^.*?(\w+_kernel)\b.*$", r"\1", e.key)
                out[kernel] = out.get(kernel, 0.0) + us / 1e3 / 5
        return out

    def host_ms(fn, n=200):
        """Host ms a call of ``fn`` enqueued n times back to back (best of 3)."""
        import time

        best = float("inf")
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            best = min(best, (time.perf_counter() - t0) / n * 1e3)
            torch.cuda.synchronize()
        return best

    def split(tag, name, fn):
        """Each kernel of ``fn`` by its device time per call."""
        for kernel, ms in kernels(fn).items():
            print(f"{root} {tag}:   {name} kernel {kernel} {ms:.4f} ms a call", flush=True)

    if "bwd" in what:
        for shape in BATCH_SHAPES:
            c = shape[-1]
            gen = torch.Generator().manual_seed(c)
            blk = common.TransformerBlock(c, 8, 2, device=dev)
            common.reset_parameters_(blk, gen)
            wts = fb.fold_block_params({k: v.detach() for k, v in blk.named_parameters()})
            x = torch.randn(shape, generator=gen).to(dev, torch.bfloat16)
            dy = (0.05 * torch.randn(shape, generator=gen)).to(dev, torch.bfloat16)
            with torch.no_grad():
                gram, qss, kss = fb.gram_pass_plain(x, wts)
                apply = fb.finalize_attention(gram, qss, kss, wts.temperature, wts.wproj, 8)
                dx2, d_apply, _ = fbb.bwd1(x, dy, apply, wts)
                d = fbb.finalize_backward(gram, qss, kss, wts.temperature, wts.wproj, d_apply, 8)
                b1 = [cuda_time_ms(lambda: fbb.bwd1(x, dy, apply, wts), 10) for _ in "12"]
                b2 = [cuda_time_ms(lambda: fbb.bwd2(x, dx2, apply, *d[:3], wts), 10) for _ in "12"]
            print(f"{root} {list(shape)}: B1 {b1[0]:.3f} {b1[1]:.3f} ms, B2 {b2[0]:.3f} "
                  f"{b2[1]:.3f} ms", flush=True)
    if "step" in what:
        for bs in (8, 16):
            g = torch.Generator(device=dev).manual_seed(0)
            x = torch.rand(bs, 512, 512, 1, generator=g, device=dev)
            gt = torch.rand(bs, 512, 512, 3, generator=g, device=dev)
            model = get_model("rawformer_s", device=dev, dtype=torch.bfloat16,
                              generator=torch.Generator().manual_seed(0))
            tr = Trainer(model, TrainConfig(base_lr=1e-4, warmup_epochs=1, steps_per_epoch=1))
            ms = [cuda_time_ms(lambda: tr.train_step((x, gt)), 5, warmup=2) for _ in "123"]
            print(f"{root} train step batch {bs}: " + " ".join(f"{t:.3f}" for t in ms) + " ms",
                  flush=True)
            del tr, model
            torch.cuda.empty_cache()
    if "block" in what:
        from bayer_low_light_image_enhancement_tpu_torch.serving import Predictor

        for shape in BATCH_SHAPES + FULLRES_SHAPES:
            c = shape[-1]
            gen = torch.Generator().manual_seed(c)
            blk = common.TransformerBlock(c, 8, 2, device=dev, compute_dtype=torch.bfloat16)
            common.reset_parameters_(blk, gen)
            params = {k: v.detach() for k, v in blk.named_parameters()}
            wts = fb.fold_block_params(params)
            x = torch.randn(shape, generator=gen).to(dev, torch.bfloat16)
            x4 = x.permute(0, 3, 1, 2)  # NCHW view of the NHWC tensor (channels_last)
            blk.fused = False
            with torch.inference_mode():
                gram, qss, kss = fb.gram_pass_plain(x, wts)
                apply = fb.finalize_attention(gram, qss, kss, wts.temperature, wts.wproj, 8)
                k2 = [cuda_time_ms(lambda: fb.gram_pass(x, wts), 20) for _ in "123"]
                k3 = [cuda_time_ms(lambda: fb.apply_pass(x, apply, wts), 20) for _ in "123"]
                whole = [cuda_time_ms(lambda: fb.fused_transformer_block(x, params, 8), 20)
                         for _ in "123"]
                mod = [cuda_time_ms(lambda: blk(x4), 20) for _ in "123"]
            ms = lambda t: " ".join(f"{v:.4f}" for v in t)  # noqa: E731
            print(f"{root} block {list(shape)}: K2 {ms(k2)} ms, K3 {ms(k3)} ms, whole block "
                  f"{ms(whole)} ms, bf16 module path {ms(mod)} ms", flush=True)
            with torch.inference_mode():
                split(f"block {list(shape)}", "K2", lambda: fb.gram_pass(x, wts))
                split(f"block {list(shape)}", "K3", lambda: fb.apply_pass(x, apply, wts))
            del x, x4, blk
        model = get_model("rawformer_s", device=dev, dtype=torch.bfloat16,
                          generator=torch.Generator().manual_seed(0))
        pred = Predictor(model, device=dev)
        g = torch.Generator().manual_seed(0)
        m = torch.randint(0, 17000, (8, 512, 512), generator=g, dtype=torch.int32)
        m = m.to(torch.int16).to(dev).view(torch.uint16)
        r = torch.full((8,), 100.0, device=dev)
        xf = torch.rand(1, 1, 2832, 4240, generator=g).to(dev)
        with torch.inference_mode():
            fwd = [cuda_time_ms(lambda: pred._u16_forward(m, r), 20, warmup=5) for _ in "12"]
            frame = [cuda_time_ms(lambda: model(xf), 3, warmup=1) for _ in "12"]
        print(f"{root} RawFormer-S u16 forward batch 8 @ 512^2: {fwd[0]:.3f} {fwd[1]:.3f} ms; "
              f"2832x4240 frame: {frame[0]:.3f} {frame[1]:.3f} ms", flush=True)
        del model, pred, xf
        torch.cuda.empty_cache()
    if "pipe" in what:
        from bayer_low_light_image_enhancement_tpu_torch.probes import floor as pf

        for shape in BATCH_SHAPES + FULLRES_SHAPES:
            c = shape[-1]
            gen = torch.Generator().manual_seed(c)
            blk = common.TransformerBlock(c, 8, 2, device=dev, compute_dtype=torch.bfloat16)
            common.reset_parameters_(blk, gen)
            wts = fb.fold_block_params({k: v.detach() for k, v in blk.named_parameters()})
            x = torch.randn(shape, generator=gen).to(dev, torch.bfloat16)
            tag = f"pipe {list(shape)}"
            with torch.inference_mode():
                apply = fb.finalize_attention(*fb.gram_pass_plain(x, wts), wts.temperature,
                                              wts.wproj, 8)
                k3 = lambda: fb.apply_pass(x, apply, wts)  # noqa: E731
                k3p = lambda: fb.apply_pass_pipelined(x, apply, wts)  # noqa: E731
                t = [cuda_time_ms(k3, 20), cuda_time_ms(k3p, 20), cuda_time_ms(k3p, 20),
                     cuda_time_ms(k3, 20), cuda_time_ms(k3, 20), cuda_time_ms(k3p, 20)]
                print(f"{root} {tag}: K3P {t[1]:.4f} {t[2]:.4f} {t[5]:.4f} ms, K3 {t[0]:.4f} "
                      f"{t[3]:.4f} {t[4]:.4f} ms", flush=True)
                split(tag, "K3", k3)
                split(tag, "K3P", k3p)
                # The bisect ladder's rungs (each kernel cut after stage 1-4,
                # stage 5 whole) by the device time of their apply kernels.
                rungs = {kind: [sum(ms for k, ms in kernels(
                    lambda: pf.bisect_probe(x, apply, wts, stage, kind)).items() if "apply" in k)
                    for stage in (1, 2, 3, 4, 5)] for kind in ("tiled", "pipelined")}
                print(f"{root} {tag}: bisect device ms, stages 1-5: K3 "
                      + " ".join(f"{v:.4f}" for v in rungs["tiled"]) + ", K3P "
                      + " ".join(f"{v:.4f}" for v in rungs["pipelined"]), flush=True)
            del x, blk
    if "wgrad" in what:
        from bayer_low_light_image_enhancement_tpu_torch.kernels import weight_grad as wgk

        def operand(g, k, n, gen, scale=1.0):
            return (scale * torch.randn(g, k, n, generator=gen, device=dev)).to(torch.bfloat16)

        for bs in (8, 16):
            for _, h, w, c in BATCH_SHAPES:
                if c < 96:
                    continue
                p = bs * h * w
                gen = torch.Generator(device=dev).manual_seed(c + bs)
                b2 = [(operand(1, p, c, gen), operand(1, p, 3 * c, gen, 0.05))]
                b1 = [(operand(bs, h * w, c, gen), operand(bs, h * w, c, gen, 0.05)),
                      (operand(1, p, c, gen), operand(1, p, 2 * c, gen, 0.05)),
                      (operand(1, p, 2 * c, gen), operand(1, p, c, gen, 0.05))]
                for name, pairs in (("B2's product", b2), ("B1's three products", b1)):
                    dims = ", ".join(f"({a.shape[0]}, {a.shape[1]}, {a.shape[2]}, {b.shape[2]})"
                                     for a, b in pairs)
                    mm = lambda: [torch.matmul(a.mT, b) for a, b in pairs]  # noqa: E731
                    with torch.no_grad():
                        t = [cuda_time_ms(lambda: wgk.weight_grad(pairs), 20),
                             cuda_time_ms(mm, 20), cuda_time_ms(mm, 20),
                             cuda_time_ms(lambda: wgk.weight_grad(pairs), 20)]
                    print(f"{root} weight-grad pass, batch {bs}, {name} {dims}: pass {t[0]:.4f} "
                          f"{t[3]:.4f} ms, torch.matmul bf16 {t[1]:.4f} {t[2]:.4f} ms "
                          f"({len(pairs)} call{'s' if len(pairs) > 1 else ''})", flush=True)
                    split(f"wgrad batch {bs} {name} {dims}", "pass",
                          lambda: wgk.weight_grad(pairs))
                del b1, b2
    if "pack" in what:
        from bayer_low_light_image_enhancement_tpu_torch.kernels import bayer_pack as bp

        for b, h, w in ((8, 512, 512), (1, 2832, 4240)):
            g = torch.Generator().manual_seed(h)
            m = torch.randint(0, 17000, (b, h, w), generator=g, dtype=torch.int32)
            m = m.to(torch.int16).to(dev).view(torch.uint16)
            r = torch.full((b,), 100.0, device=dev)
            fn = lambda: bp.bayer_pack_normalize(m, r, torch.bfloat16, True)  # noqa: E731
            with torch.inference_mode():
                k1 = [cuda_time_ms(fn, 20) for _ in "123"]
            bound = (b * h * w * 4 + 4 * b) / 3.35e12 * 1e3
            print(f"{root} pack [{b},{h},{w}]: K1 whole call " + " ".join(f"{t:.4f}" for t in k1)
                  + f" ms, bound {bound:.4f} ms (bytes)", flush=True)
            # The host's share: ms a call on the host clock over 200 calls
            # enqueued back to back (the device is faster than the host here),
            # for the wrapper, its output allocation alone and the C entry
            # point alone on a preallocated output.
            out = fn()
            lib, stream = _build.library(), _build.stream_of(m)
            ptrs = (m.data_ptr(), r.data_ptr(), out.data_ptr())
            raw = lambda: lib.blle_bayer_pack(*ptrs, b, h, w, 1, 1, stream)  # noqa: E731
            empty = lambda: torch.empty(out.shape, dtype=out.dtype, device=dev)  # noqa: E731
            with torch.inference_mode():
                host = {name: host_ms(f) for name, f in (("wrapper", fn), ("torch.empty", empty),
                                                         ("C entry point", raw))}
            print(f"{root} pack [{b},{h},{w}]: host ms a call, " + ", ".join(
                f"{k} {v:.4f}" for k, v in host.items()), flush=True)
            with torch.inference_mode():
                split(f"pack [{b},{h},{w}]", "K1", fn)
            del m, out
    if "tail" in what:
        from bayer_low_light_image_enhancement_tpu_torch.kernels import fused_stage as fs

        for shape in BATCH_SHAPES + FULLRES_SHAPES:
            b, h, w, c = shape
            gen = torch.Generator().manual_seed(c)
            stage = common.ConvTransformer(c, 8, 2, device=dev, compute_dtype=torch.bfloat16)
            common.reset_parameters_(stage, gen)
            params = {k: v.detach() for k, v in stage.state_dict().items()
                      if not k.startswith("Transformer.")}
            x = torch.randn(shape, generator=gen).to(dev, torch.bfloat16)
            t = torch.randn(shape, generator=gen).to(dev, torch.bfloat16)
            x4, t4 = x.permute(0, 3, 1, 2), t.permute(0, 3, 1, 2)
            tag = f"tail {list(shape)}"
            fn = lambda: fs.fused_stage_tail(x, t, params)  # noqa: E731
            mod = getattr(fs, "module_tail", None)
            with torch.inference_mode():
                t1 = [cuda_time_ms(fn, 20) for _ in "123"]
                mt = [cuda_time_ms(lambda: mod(stage, x4, t4), 20) for _ in "123"] if mod else []
            p = b * h * w  # chip_smoke.py's tail_counts over its peak rates
            bound = max((3 * p * c * 2 + 22 * c * c * 2 + 12 * c) / 3.35e12,
                        40.0 * p * c * c / 989e12) * 1e3
            ms = lambda v: " ".join(f"{t:.4f}" for t in v) if v else "n/a"  # noqa: E731
            print(f"{root} {tag}: T1 whole call {ms(t1)} ms, bf16 module tail {ms(mt)} ms, bound "
                  f"{bound:.4f} ms", flush=True)
            if hasattr(fs, "tail_plan"):
                plan = fs.plan_for(b, h, w, c, dev.index or 0)
                print(f"{root} {tag}: plan {plan}", flush=True)
            with torch.inference_mode():
                split(tag, "T1", fn)
                if mod:
                    split(tag, "module tail", lambda: mod(stage, x4, t4))
            del x, t, x4, t4, stage
    if "attn" in what:
        from bayer_low_light_image_enhancement_tpu_torch.kernels import fused_attention as fa

        for shape in BATCH_SHAPES + FULLRES_SHAPES:
            b, h, w, c = shape
            gen = torch.Generator().manual_seed(c)
            amod = common.ChannelAttention(c, 8, device=dev, compute_dtype=torch.bfloat16)
            common.reset_parameters_(amod, gen)
            params = {k: v.detach() for k, v in amod.state_dict().items()}
            x = torch.randn(shape, generator=gen).to(dev, torch.bfloat16)
            x4 = x.permute(0, 3, 1, 2)  # NCHW view of the NHWC tensor (channels_last)
            tag = f"attn {list(shape)}"
            fn = lambda: fa.fused_channel_attention(x, params, 8)  # noqa: E731
            with torch.inference_mode():
                a1 = [cuda_time_ms(fn, 20) for _ in "123"]
                mod = [cuda_time_ms(lambda: amod(x4), 20) for _ in "123"]
            p = b * h * w  # chip_smoke.py's attention_counts at 8 heads over its peak rates
            bound = max((2 * p * c * 2 + b * c * c * 2 + 8 * c * c) / 3.35e12,
                        (8.0 + 2.0 / 8) * p * c * c / 989e12, 60.0 * p * c / 67e12) * 1e3
            ms = lambda v: " ".join(f"{t:.4f}" for t in v)  # noqa: E731
            with torch.inference_mode():
                host = host_ms(fn)
            print(f"{root} {tag}: A1 whole call {ms(a1)} ms (host {host:.4f} ms a call), bf16 "
                  f"ChannelAttention module {ms(mod)} ms, bound {bound:.4f} ms", flush=True)
            with torch.inference_mode():
                split(tag, "A1", fn)
                split(tag, "module", lambda: amod(x4))
            del x, x4, amod
    if "floor" in what:
        from bayer_low_light_image_enhancement_tpu_torch.probes import floor as pf

        shape = (8, 256, 256, 32)
        g = torch.Generator().manual_seed(0)
        x = torch.randn(shape, generator=g).to(dev, torch.bfloat16)
        w = (torch.randn(32, 32, generator=g) / 32 ** 0.5).to(dev, torch.bfloat16)
        dw = (torch.randn(9, 32, generator=g) / 3.0).to(dev)
        out = torch.empty_like(x)
        bound = 2 * x.numel() * 2 / 3.35e12 * 1e3
        rungs = [(f"{s} th={th}", lambda s=s, th=th: pf.floor_probe(x, w, dw, s, "c", th))
                 for th in (4, 8, 16) for s in pf.STRATEGIES]
        for name, fn in rungs + [("copy_", lambda: out.copy_(x))]:
            with torch.no_grad():
                t = [cuda_time_ms(fn, 20) for _ in "123"]
                dev_ms = sum(kernels(fn).values())
            gbs = 2 * x.numel() * 2 / (min(t) * 1e-3) / 1e9
            print(f"{root} floor {list(shape)} c {name}: whole call "
                  + " ".join(f"{v:.4f}" for v in t) + f" ms ({gbs:.0f} GB/s at the best), "
                  f"device {dev_ms:.4f} ms a call, bound {bound:.4f} ms (bytes)", flush=True)
        del x, out
    if "wide" in what:
        from bayer_low_light_image_enhancement_tpu_torch.models.fused_apply import (
            make_banded_forward,
        )
        from bayer_low_light_image_enhancement_tpu_torch.ops.conv import band_halo
        from bayer_low_light_image_enhancement_tpu_torch.probes import floor as pf

        ms = lambda v: " ".join(f"{t:.4f}" for t in v)  # noqa: E731
        for c in (384, 512):
            b, hb, w = 8, 23, 272
            tag = f"wide [{b},{hb},{w},{c}]"
            wts = pf.block_weights(c, 18 + c, dev)
            gen = torch.Generator().manual_seed(c)
            x = torch.randn(b, hb, w, c, generator=gen).to(dev, torch.bfloat16)
            xh = band_halo(x, 2, b)
            with torch.inference_mode():
                apply = fb.finalize_attention(*fb.gram_pass_plain(x, wts), wts.temperature,
                                              wts.wproj, 8)
                sums = [t.sum(0, keepdim=True) for t in fb.gram_pass_banded_plain(xh, wts, b,
                                                                                 b * hb)]
                bapply = fb.finalize_attention(*sums, wts.temperature, wts.wproj, 8).repeat(
                    b, 1, 1)
                calls = {"K2": lambda: fb.gram_pass(x, wts),
                         "K3": lambda: fb.apply_pass(x, apply, wts),
                         "K2 band": lambda: fb.gram_pass_banded(xh, wts, b, b * hb),
                         "K3 band": lambda: fb.apply_pass_banded(xh, bapply, wts, b, b * hb)}
                for name, fn in calls.items():
                    t = [cuda_time_ms(fn, 20) for _ in "123"]
                    print(f"{root} {tag}: {name} {ms(t)} ms", flush=True)
                    split(tag, name, fn)
            blk = common.TransformerBlock(c, 8, 2, device=dev, dtype=torch.bfloat16,
                                          compute_dtype=torch.bfloat16)
            common.reset_parameters_(blk, torch.Generator().manual_seed(18 + c))
            params = dict(blk.named_parameters())
            common.bind_bands(blk, b)
            blk.fused = False
            xn = x.permute(0, 3, 1, 2)
            with torch.inference_mode():
                whole = [cuda_time_ms(lambda: fb.fused_transformer_block(x, params, 8, bands=b),
                                      20) for _ in "123"]
                mod = [cuda_time_ms(lambda: blk(xn), 20) for _ in "123"]
            print(f"{root} {tag}: whole banded block {ms(whole)} ms, bf16 band-aware module-path "
                  f"block {ms(mod)} ms", flush=True)
            del x, xh, xn, blk, params
        xp = torch.rand(1, 1, 2944, 4352, generator=torch.Generator().manual_seed(0)).to(dev)
        for size in ("B", "L"):
            model = get_model(f"rawformer_{size.lower()}", device=dev, dtype=torch.bfloat16,
                              generator=torch.Generator().manual_seed(0)).eval()
            fwd = make_banded_forward(model, 8)
            with torch.inference_mode():
                band = [cuda_time_ms(lambda: fwd(xp), 3, warmup=1) for _ in "12"]
                mono = [cuda_time_ms(lambda: model(xp), 3, warmup=1) for _ in "12"]
            print(f"{root} RawFormer-{size} 2944x4352 frame: banded (8 bands) {ms(band)} ms, "
                  f"monolithic {ms(mono)} ms", flush=True)
            del model, fwd
            torch.cuda.empty_cache()
    if "scan" in what:
        from bayer_low_light_image_enhancement_tpu_torch.kernels import ssm_scan as ssk

        with torch.no_grad():
            for b, L, d in SCAN_SERVE_SHAPES:
                args, _ = _scan_inputs(b, L, d, dev)
                tag = f"scan [{b},{L},{d},32]"
                s1 = [cuda_time_ms(lambda: ssk.selective_scan_fwd(*args), 10) for _ in "12"]
                print(f"{root} {tag}: S1 {s1[0]:.4f} {s1[1]:.4f} ms", flush=True)
                split(tag, "S1", lambda: ssk.selective_scan_fwd(*args))
                del args
            for b, L, d in SCAN_TRAIN_SHAPES:
                args, dy = _scan_inputs(b, L, d, dev)
                tag = f"scan [{b},{L},{d},32]"
                _, states = ssk.selective_scan_fwd(*args, save_states=True)
                s2 = [cuda_time_ms(lambda: ssk.selective_scan_bwd(*args, dy, states), 10)
                      for _ in "12"]
                s1 = [cuda_time_ms(lambda: ssk.selective_scan_fwd(*args, save_states=True), 10)
                      for _ in "12"]
                print(f"{root} {tag}: S2 {s2[0]:.4f} {s2[1]:.4f} ms, S1 with states {s1[0]:.4f} "
                      f"{s1[1]:.4f} ms", flush=True)
                split(tag, "S1 with states",
                      lambda: ssk.selective_scan_fwd(*args, save_states=True))
                split(tag, "S2", lambda: ssk.selective_scan_bwd(*args, dy, states))
                del args, dy, states
        model = get_model("rawformer_wfb", device=dev, dtype=torch.bfloat16,
                          generator=torch.Generator().manual_seed(0))
        g = torch.Generator(device=dev).manual_seed(0)
        xw = torch.rand(2, 1, 512, 512, generator=g, device=dev)
        with torch.inference_mode():
            ms = [cuda_time_ms(lambda: model(xw), 10, warmup=3) for _ in "12"]
        print(f"{root} WFB-48 forward batch 2: " + " ".join(f"{t:.3f}" for t in ms) + " ms",
              flush=True)
        x = torch.rand(8, 512, 512, 1, generator=g, device=dev)
        gt = torch.rand(8, 512, 512, 3, generator=g, device=dev)
        tr = Trainer(model, TrainConfig(base_lr=1e-4, warmup_epochs=1, steps_per_epoch=1))
        ms = [cuda_time_ms(lambda: tr.train_step((x, gt)), 3, warmup=1) for _ in "12"]
        print(f"{root} WFB-48 train step batch 8: " + " ".join(f"{t:.3f}" for t in ms) + " ms",
              flush=True)
        del tr, model
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("roots", nargs="+", help="directories holding a copy of the package")
    p.add_argument("--what", default="bwd,step",
                   help="any of bwd, step, scan, block, pipe, wgrad, pack, tail, attn, floor, "
                        "wide (comma-separated)")
    p.add_argument("--turns", type=int, default=2, help="passes over the roots, alternating order")
    p.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.child:
        _child(args.roots[0], args.what)
        return 0
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    except FileNotFoundError:
        smi = None
    if smi is None or smi.returncode != 0:
        print("time_trees needs a CUDA card", file=sys.stderr)
        return 2
    print(smi.stdout.strip().splitlines()[0], flush=True)
    for turn in range(args.turns):
        for root in args.roots if turn % 2 == 0 else args.roots[::-1]:
            proc = subprocess.run([sys.executable, os.path.abspath(__file__), root, "--child",
                                   "--what", args.what], cwd=os.getcwd())
            if proc.returncode != 0:
                return proc.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
