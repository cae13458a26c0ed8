"""Whole frames, one client in a closed loop.

Each request is one uint16 Bayer mosaic of ``height`` x ``width`` and its
exposure ratio, held in host memory as a client holds it, sent through
``Predictor(make_banded_forward(model, pick_bands(H')), pad_to).raw_u16``
(H' the height padded to ``pad_to``: the eval CLI's single-card route for
whole frames) and answered with the numpy RGB. A request's time runs from
the call to the returned array: pad, host -> device, the pack kernel, the
banded forward, crop and clamp, device -> host. The client sends the next
request when the answer is back, cycling a pool of ``pool`` distinct
captures made from the seed.

Mix parameters: height, width, pad_to, pool, warmup (requests before the
window), sample (answers of the window held to the reference, drawn from
the seed), trace_requests (the traced window's length in requests).

Set-up warms the one shape the cell sends; the window then runs for the
run's seconds, and a traced run for ``trace_requests`` requests under the
profiler. After the window the program is freed and the reference (fp32,
TF32 off) serves the sampled requests' captures, and once more under
autocast to the configuration's compute dtype (the plain forward that
rounds as the configuration states). Each answer is compared whole: its
largest and its mean absolute difference from the fp32 RGB, each over the
same difference of the plain answer.
"""

import gc
import random
import time

import numpy as np
import torch

from port_bench import counts, program, tracing
from port_bench.harness import Record
from port_bench.reference import decode, fp32
from port_bench.traffic.sid_synth import captures


class Reservoir:
    """A uniform sample of ``k`` of the window's answers, drawn from the
    seed as they come, holding no more than ``k``."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng, self.n, self.items = k, random.Random(seed), 0, []

    def offer(self, item) -> None:
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = self.rng.randrange(self.n + 1)
            if j < self.k:
                self.items[j] = item
        self.n += 1


def frame_gaps(got: np.ndarray, want: torch.Tensor, plain: torch.Tensor) -> dict:
    """The answer's largest and mean absolute difference from the
    reference's RGB (``_abs``, reported), and each over the same difference
    of ``plain``, the reference at the configuration's compute dtype
    (``_rel``, compared): how the answer rounds against a plain forward
    that rounds as the configuration states. The weights' and the frame's
    sensitivity to rounding scale both alike, so the relative numbers stay
    steady from seed to seed where the absolute ones do not."""
    d = (torch.from_numpy(got).to(want.device) - want).abs_()
    e = (plain - want).abs_()
    out = {"rgb_max_abs": float(d.max()), "rgb_mean_abs": float(d.double().mean())}
    out["rgb_max_rel"] = out["rgb_max_abs"] / float(e.max())
    out["rgb_mean_rel"] = out["rgb_mean_abs"] / float(e.double().mean())
    return out


def build(cell, seed, device, clock):
    """The served model, its Predictor on the cell's route, and the pool of
    captures; returns (predictor, mosaics, ratios)."""
    from bayer_low_light_image_enhancement_tpu_torch.models.fused_apply import (
        make_banded_forward, pick_bands)
    from bayer_low_light_image_enhancement_tpu_torch.serving import Predictor

    mix = cell.traffic
    clock.mark("import")
    if device == "cuda":
        torch.cuda.init()
        torch.empty(1, device=device)
    clock.mark("device init")
    model = program.port_model(cell.config, seed, device)
    clock.mark("weights")
    mosaics, ratios = captures(seed, mix["pool"], mix["height"], mix["width"], device,
                               with_gt=False)
    clock.mark("traffic")
    hp = -(-mix["height"] // mix["pad_to"]) * mix["pad_to"]
    pred = Predictor(make_banded_forward(model, pick_bands(hp)), device=device,
                     pad_to=mix["pad_to"])
    return pred, mosaics, ratios


def run(cell, seed, seconds, trace, device, clock):
    mix, config = cell.traffic, cell.config
    h, w, pad = mix["height"], mix["width"], mix["pad_to"]
    hp, wp = -(-h // pad) * pad, -(-w // pad) * pad
    pred, mosaics, ratios = build(cell, seed, device, clock)

    def request(i):
        k = i % len(mosaics)
        return k, pred.raw_u16(mosaics[k], float(ratios[k]))

    for i in range(mix["warmup"]):
        request(i)
    program.sync(device)
    clock.mark("warm-up")

    rec = Record(chips=1,
                 flops_per_unit=counts.rawformer_flops(
                     config["dim"], tuple(config["num_heads"]), config["ffn_expansion"],
                     (1, 1, hp, wp)))
    sample = Reservoir(mix["sample"], seed)
    hooks = timer = None
    if trace:
        hooks = program.BlockHooks(pred.model, config, 2, backward=False)
        timer = program.CallTimer(pred.model, device)
        request(0)  # counts each block shape once, outside the window
        hooks.least.clear()
        timer.inside.clear()
    rec.setup_s = clock.since_start()
    with tracing.traced(trace) as held:
        t_open = time.perf_counter()
        i = 0
        while True:
            t0 = time.perf_counter()
            rec.attempted += 1
            try:
                with torch.autograd.profiler.record_function("bench::request"):
                    k, out = request(i)
            except RuntimeError as e:  # a request that fails is counted, not retried
                rec.failed += 1
                rec.notes.append(f"request {i} failed: {e}")
                if rec.failed >= 3:
                    break
            else:
                t1 = time.perf_counter()
                rec.latencies_s.append(t1 - t0)
                rec.units += 1
                sample.offer((i, k, out))
            i += 1
            now = time.perf_counter()
            if (i >= mix["trace_requests"]) if trace else (now - t_open >= seconds):
                break
        rec.window_s = now - t_open
    rec.mpix = rec.units * h * w / 1e6
    if device == "cuda":
        rec.peak_bytes = torch.cuda.max_memory_allocated()
    if trace:
        rec.trace = tracing.summarize(held.trace)
        rec.trace_units = rec.units
        rec.block_calls = hooks.least
        rec.host_s = [r - m for r, m in zip(rec.latencies_s, timer.inside)]
        hooks.remove()
        timer.remove()

    del pred, held
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    compare(rec, config, seed, device, mosaics, ratios, pad, sample.items, cell.cell["limits"])
    return rec


def reference_answer(ref, mosaic: np.ndarray, ratio: float, pad: int, device,
                     compute=None) -> torch.Tensor:
    """The reference's RGB for one capture: in fp32, or with ``compute``
    (a dtype) under autocast to it, the plain mixed-precision forward."""
    codes = torch.from_numpy(mosaic.view(np.int16)).to(device)
    if compute is None:
        return decode.serve_frame(ref, codes, ratio, pad)
    with torch.autocast(torch.device(device).type, dtype=compute):
        return decode.serve_frame(ref, codes, ratio, pad).float()


def plain_dtype(config):
    return program.DTYPES[config["compute_dtype"]]


def compare(rec, config, seed, device, mosaics, ratios, pad, items, limits) -> None:
    """The sampled answers against the reference's and the plain answers on
    the same captures; the numbers the cell's limits name are compared, the
    others reported."""
    worst = {}
    with fp32():
        ref = program.reference_model(config, seed, device).eval()
        want, plain = {}, {}
        for i, k, out in items:
            if k not in want:
                args = (ref, mosaics[k], float(ratios[k]), pad, device)
                want[k] = reference_answer(*args)
                plain[k] = reference_answer(*args, plain_dtype(config))
            for name, v in frame_gaps(out, want[k], plain[k]).items():
                worst[name] = max(worst.get(name, 0.0), v)
    for name, limit in limits.items():
        rec.checks[name] = {"value": worst.pop(name), "limit": limit}
    rec.notes.append(f"compared requests {[i for i, _, _ in items]} of {rec.units}; "
                     + ", ".join(f"{k} {v!r}" for k, v in worst.items()))

