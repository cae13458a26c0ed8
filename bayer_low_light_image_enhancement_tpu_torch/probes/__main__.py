"""Run the probe ladders on one CUDA card and print a row per rung.

    python -m bayer_low_light_image_enhancement_tpu_torch.probes \
        [--ladder floor,bisect] [--shape 8,256,256,32] [--th 4,8,16] \
        [--strategies plain,center,async,async4,tma] [--levels c,m,v] \
        [--widths 32,64,128,256] [--apply_kernels tiled,pipelined] \
        [--stages 1,2,3,4,5] [--iters 20]

The floor ladder runs at --shape (C must be 32), with ``Tensor.copy_`` of
the same tensor beside level c; the bisect ladder at
batch and size --shape's B and H x W for C = 32, halving H and W for each
doubling of C (the RawFormer-S levels). The last line is the rows as JSON.
Exits with 2 on a bad argument or without a card.
"""

from __future__ import annotations

import argparse
import json
import math
import sys

import torch

from bayer_low_light_image_enhancement_tpu_torch.probes.floor import (
    FLOOR_C,
    LEVELS,
    STAGES,
    STRATEGIES,
    TILE_HEIGHTS,
    copy_ms,
    run_bisect_ladder,
    run_floor_ladder,
)
from bayer_low_light_image_enhancement_tpu_torch.kernels.fused_block import (
    APPLY_KERNELS,
    PIPELINED_WIDTHS,
)


def _list(kind, choices):
    def parse(text):
        try:
            items = [kind(t) for t in text.split(",") if t]
        except ValueError:
            raise argparse.ArgumentTypeError(f"not a list of {kind.__name__}: {text!r}")
        bad = [t for t in items if t not in choices]
        if not items or bad:
            raise argparse.ArgumentTypeError(f"{bad or text!r}: choose from {choices}")
        return items
    return parse


def _shape(text):
    try:
        shape = tuple(int(t) for t in text.split(","))
    except ValueError:
        shape = ()
    if len(shape) != 4 or min(shape) < 1 or shape[-1] != FLOOR_C:
        raise argparse.ArgumentTypeError(f"--shape must be B,H,W,{FLOOR_C}, got {text!r}")
    return shape


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m bayer_low_light_image_enhancement_tpu_torch.probes",
        description="Time the apply pass's floor and bisect ladders on one CUDA card.")
    p.add_argument("--ladder", type=_list(str, ("floor", "bisect")), default=["floor", "bisect"])
    p.add_argument("--shape", type=_shape, default=(8, 256, 256, FLOOR_C),
                   help="floor ladder shape, and the bisect ladder's C=32 level")
    p.add_argument("--th", type=_list(int, TILE_HEIGHTS), default=list(TILE_HEIGHTS))
    p.add_argument("--strategies", type=_list(str, STRATEGIES), default=list(STRATEGIES))
    p.add_argument("--levels", type=_list(str, LEVELS), default=list(LEVELS))
    p.add_argument("--widths", type=_list(int, PIPELINED_WIDTHS), default=list(PIPELINED_WIDTHS))
    p.add_argument("--apply_kernels", type=_list(str, APPLY_KERNELS), default=list(APPLY_KERNELS))
    p.add_argument("--stages", type=_list(int, STAGES), default=list(STAGES))
    p.add_argument("--iters", type=int, default=20)
    return p


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    if args.iters < 1:
        parser().error("--iters must be at least 1")
    if not torch.cuda.is_available():
        print("probes: no CUDA device; the ladders time the card's kernels", file=sys.stderr)
        return 2
    rows = []
    if "floor" in args.ladder:
        for r in run_floor_ladder(args.shape, args.strategies, args.levels, args.th, args.iters):
            err = "-" if r["err"] is None else f"{r['err']:.2e}"
            print(f"floor {r['strategy']:7s} {r['level']} th={r['th']:2d}: {r['ms']:.4f} ms "
                  f"{r['gbs']:7.1f} GB/s  err {err}", flush=True)
            rows.append({"ladder": "floor", **r})
        if "c" in args.levels:
            ms = copy_ms(args.shape, args.iters)
            gbs = 4 * math.prod(args.shape) / (ms * 1e-3) / 1e9
            print(f"floor copy_   c: {ms:.4f} ms {gbs:7.1f} GB/s", flush=True)
            rows.append({"ladder": "floor", "strategy": "copy_", "level": "c", "ms": ms,
                         "gbs": gbs})
    if "bisect" in args.ladder:
        b, h, w, _ = args.shape
        shapes = [(b, h * 32 // c, w * 32 // c, c) for c in args.widths]
        for r in run_bisect_ladder(shapes, args.apply_kernels, args.stages, args.iters):
            print(f"bisect {list(r['shape'])} {r['apply_kernel']:9s} stage {r['stage']}: "
                  f"{r['ms']:.4f} ms {r['gbs']:7.1f} GB/s  err {r['err']:.2e}", flush=True)
            rows.append({"ladder": "bisect", **r})
    print(json.dumps(rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
