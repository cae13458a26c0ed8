"""Where the device time goes: ``torch.profiler`` over a model's forward or
train step on one CUDA card.

The counterpart of ``bayer_low_light_image_enhancement_tpu/utils/profiling.py``
for the port. ``profile`` runs a callable after warmup under
``torch.profiler`` and returns the host-clock time per call, the device
time per call (the sum of every kernel's self time), the device's busy
share and the kernels by device time (``cuda_time_ms`` times a callable
with CUDA events); the CLI prints them for a registry model at random
weights:

    python -m bayer_low_light_image_enhancement_tpu_torch.utils.profiling \\
        --model rawformer_wfb --batch 2 --size 512 --mode forward
    ... --mode train --batch 8

A card is required: there is no CPU fallback.
"""

from __future__ import annotations

import argparse
import collections
import time
from typing import Callable, Dict, List, Tuple

import torch


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


def profile(fn: Callable[[], object], steps: int = 5, warmup: int = 3) -> Dict[str, object]:
    """Profile ``steps`` calls of ``fn`` after ``warmup``: -> {"host_ms",
    "device_ms", "busy", "kernels": [(name, ms per call, calls per call)]}."""
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
    for e in prof.events():
        # GPU-side user annotations (Optimizer.step, ...) span kernels already counted.
        if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation:
            per_kernel[e.name][0] += e.time_range.elapsed_us() / 1e3 / steps
            per_kernel[e.name][1] += 1 / steps
    kernels: List[Tuple[str, float, float]] = sorted(
        ((k, v[0], v[1]) for k, v in per_kernel.items()), key=lambda r: -r[1])
    device_ms = sum(r[1] for r in kernels)
    return {"host_ms": host_ms, "device_ms": device_ms, "busy": device_ms / host_ms,
            "kernels": kernels}


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


if __name__ == "__main__":
    main()
