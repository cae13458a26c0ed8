"""Time B1/B2 and the RawFormer-S train step for several checkouts of the
port on one card, in turns.

    python -m bayer_low_light_image_enhancement_tpu_torch.utils.time_trees \\
        ROOT [ROOT ...] [--what bwd,step] [--turns 2]

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
  (CUDA events over 5 steps after 2, three times).

A card is required: there is no CPU fallback.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

BATCH_SHAPES = [(8, 256, 256, 32), (8, 128, 128, 64), (8, 64, 64, 128), (8, 32, 32, 256)]


def _child(root: str, what: str) -> None:
    """Measure the package found under ``root``. Run as a script, this file's
    directory leads sys.path, where utils/logging.py would shadow the
    standard library's: it goes first."""
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [q for q in sys.path if os.path.abspath(q or ".") != here]
    sys.path.insert(0, os.path.abspath(root))
    import torch

    from bayer_low_light_image_enhancement_tpu_torch.kernels import fused_block as fb
    from bayer_low_light_image_enhancement_tpu_torch.kernels import fused_block_bwd as fbb
    from bayer_low_light_image_enhancement_tpu_torch.models import common, get_model
    from bayer_low_light_image_enhancement_tpu_torch.train import TrainConfig, Trainer
    from bayer_low_light_image_enhancement_tpu_torch.utils.profiling import cuda_time_ms

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
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


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("roots", nargs="+", help="directories holding a copy of the package")
    p.add_argument("--what", default="bwd,step", help="bwd, step or both (comma-separated)")
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
