"""Profiling and timing: where the device time goes, step timers, traces.

The counterpart of ``bayer_low_light_image_enhancement_tpu/utils/profiling.py``
for the port:

* ``span(name)``: the port's named phases (``lle.predictor.*``,
  ``lle.trainer.*``, ``lle.loader.stage``, ``lle.bands.halo``) as
  ``record_function`` ranges while a ``torch.profiler`` records, so that
  they land in its trace on the device's clock; a shared null context,
  a flag read, when none does;
* ``trace(log_dir)``: a ``torch.profiler`` trace of the block, written
  where TensorBoard or Perfetto opens it;
* ``AverageMeter`` (the reference's running mean) and ``StepTimer`` (host
  clock, the result's device synchronised in ``stop``);
* ``timed_scan``: seconds a call over back-to-back calls between two
  synchronisations, the port's answer to the asynchronous dispatch that
  JAX's version folds into a ``lax.scan``;
* ``cost_analysis``: the operations of one call
  (``torch.utils.flop_counter.FlopCounterMode``), where JAX reads XLA's;
* ``profile`` runs a callable after warmup under ``torch.profiler`` and
  returns the host-clock time per call, the device time per call (the sum
  of every kernel's time), the device's busy share (the union of the
  kernels' intervals over every stream, over the host time), the kernels
  by device time and the ``lle.`` spans by host time (``cuda_time_ms``
  times a callable with CUDA events); the CLI prints them for a registry
  model at random weights:

    python -m bayer_low_light_image_enhancement_tpu_torch.utils.profiling \\
        --model rawformer_wfb --batch 2 --size 512 --mode forward
    ... --mode train --batch 8

``profile``, ``cuda_time_ms`` and the CLI need a card: there is no CPU
fallback. The others run on either.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import torch
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

SPAN_PREFIX = "lle."
_OFF = contextlib.nullcontext()


def span(name: str):
    """A named phase of the port (``name`` starts with ``lle.``): a
    ``record_function`` range while a profiler records, nested in the
    thread's open ranges; else the shared null context, at the cost of one
    flag read."""
    if not torch.autograd.profiler._is_profiler_enabled:
        return _OFF
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the block (host, and the card where there is one) and write
    the trace into ``log_dir`` (``*.pt.trace.json``, for TensorBoard's
    profiler plugin or Perfetto)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)) as prof:
        yield prof


class AverageMeter:
    """Running mean/count (the reference's correctdataloader.py:13-24)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0
        self.avg = 0.0

    def update(self, val: float, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / max(1, self.count)


def synchronize(result: Any) -> None:
    """Wait for the card that holds a tensor of ``result`` (any nesting of
    tuples, lists and dicts); nothing for host tensors."""
    for t in tree_leaves(result):
        if isinstance(t, torch.Tensor) and t.is_cuda:
            torch.cuda.synchronize(t.device)
            return


class StepTimer:
    """Host-clock step timing; ``stop(result)`` waits for ``result``'s card
    first, so that the step's device work is inside the time."""

    def __init__(self):
        self.meter = AverageMeter()
        self._t0: Optional[float] = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, result=None) -> float:
        if result is not None:
            synchronize(result)
        dt = time.perf_counter() - (self._t0 or time.perf_counter())
        self.meter.update(dt)
        return dt


def timed_scan(fn: Callable, args: Sequence, steps: int = 20, reps: int = 3) -> float:
    """Seconds a call of ``fn(*args)``: after one warmup call, ``reps``
    times ``steps`` back-to-back calls between two synchronisations of the
    result's card (the host clock then covers the device work, whatever
    the dispatch queues); the mean over all calls."""
    synchronize(fn(*args))
    total = 0.0
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(steps):
            out = fn(*args)
        synchronize(out)
        total += time.perf_counter() - t0
    return total / (steps * reps)


def cost_analysis(fn: Callable, *args) -> Dict[str, float]:
    """The operations of ``fn(*args)`` by ``FlopCounterMode``: {"flops": the
    total, and each counted operator's name: its share}, as floats (torch's
    convention: matmul and convolution products; the ``torch.ops.blle``
    kernels by their formulas)."""
    with FlopCounterMode(display=False) as counter:
        fn(*args)
    out = {"flops": float(counter.get_total_flops())}
    out.update({str(op): float(n) for op, n in counter.get_flop_counts()["Global"].items()})
    return out


def cuda_time_ms(fn: Callable[[], object], iters: int, warmup: int = 3) -> float:
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


def covered_us(intervals: Sequence[Tuple[float, float]]) -> float:
    """Length of the union of ``intervals`` (overlaps, as kernels on two
    streams, count once)."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def profile(fn: Callable[[], object], steps: int = 5, warmup: int = 3) -> Dict[str, object]:
    """Profile ``steps`` calls of ``fn`` after ``warmup``: -> {"host_ms",
    "device_ms" (kernel time summed), "busy" (the union of the kernels'
    intervals over the host time), "kernels": [(name, ms per call, calls
    per call)], "spans": [(``lle.`` span, host ms per call, calls per
    call)]}."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3 / steps
    per_kernel: Dict[str, List[float]] = collections.defaultdict(lambda: [0.0, 0])
    per_span: Dict[str, List[float]] = collections.defaultdict(lambda: [0.0, 0])
    intervals = []
    for e in prof.events():
        ms = e.time_range.elapsed_us() / 1e3 / steps
        # GPU-side user annotations (Optimizer.step, ...) span kernels already counted.
        if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation:
            per_kernel[e.name][0] += ms
            per_kernel[e.name][1] += 1 / steps
            intervals.append((e.time_range.start, e.time_range.end))
        elif e.device_type == torch.autograd.DeviceType.CPU and e.name.startswith(SPAN_PREFIX):
            per_span[e.name][0] += ms
            per_span[e.name][1] += 1 / steps
    kernels: List[Tuple[str, float, float]] = sorted(
        ((k, v[0], v[1]) for k, v in per_kernel.items()), key=lambda r: -r[1])
    spans = sorted(((k, v[0], v[1]) for k, v in per_span.items()), key=lambda r: -r[1])
    busy_ms = covered_us(intervals) / 1e3 / steps
    return {"host_ms": host_ms, "device_ms": sum(r[1] for r in kernels),
            "busy": busy_ms / host_ms, "kernels": kernels, "spans": spans}


def main(argv=None) -> None:
    from bayer_low_light_image_enhancement_tpu_torch.models import get_model
    from bayer_low_light_image_enhancement_tpu_torch.train import TrainConfig, Trainer

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model", default="rawformer_wfb")
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--mode", default="forward", choices=["forward", "train"])
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--top", type=int, default=30)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profiling needs a CUDA card")
    dev = torch.device("cuda")
    model = get_model(args.model, device=dev, dtype=torch.bfloat16,
                      generator=torch.Generator().manual_seed(0))
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.rand(args.batch, 1, args.size, args.size, generator=g, device=dev)
    if args.mode == "forward":
        model.eval()

        def fn():
            with torch.inference_mode():
                return model(x)
    else:
        trainer = Trainer(model, TrainConfig(warmup_epochs=1, steps_per_epoch=1))
        gt = torch.rand(args.batch, args.size, args.size, 3, generator=g, device=dev)

        def fn():
            return trainer.train_step((x.permute(0, 2, 3, 1), gt))
    r = profile(fn, args.steps)
    print(f"{torch.cuda.get_device_name(0)}; {args.model} {args.mode} batch {args.batch} @ "
          f"{args.size}^2: host {r['host_ms']:.3f} ms per call, device {r['device_ms']:.3f} ms "
          f"(busy {100 * r['busy']:.1f}%) in {sum(c for _, _, c in r['kernels']):.0f} kernels")
    for name, ms, calls in r["kernels"][: args.top]:
        print(f"  {ms:9.3f} ms {calls:7.1f}x  {name[:110]}")
    print("spans (host ms per call):")
    for name, ms, calls in r["spans"]:
        print(f"  {ms:9.3f} ms {calls:7.1f}x  {name}")


if __name__ == "__main__":
    main()
