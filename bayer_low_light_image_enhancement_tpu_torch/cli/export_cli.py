"""Export CLI of the PyTorch port: checkpoint -> serving artifact.

    python -m bayer_low_light_image_enhancement_tpu_torch.cli.export_cli \\
        --model_size S --ckpt <train save_dir>/SID/weights \\
        --height 2832 --width 4240 --out rawformer_s.zip
    ... --pth RawFormer_S_SID.pth       # a reference checkpoint instead
    ... --model rawformer_wfb           # another RAW -> RGB model of the registry
    ... --device cpu                    # a CPU artifact (no card)

Port of ``bayer_low_light_image_enhancement_tpu/cli/export_cli.py``, with
its flags and ``--device`` in place of ``--platforms``: the model from
``train_cli.build_model`` (raw-domain names exit with its message), the
weights through ``test_cli.load_predictor`` (the port's checkpoints, a
``.pth``; a JAX orbax directory exits naming ``tools/orbax_to_torch.py``),
the seeded random init with a warning when neither is given, and
``serving.export.export_artifact`` on the card (the default; it exits
without one) or the CPU. Load the artifact with
``serving.load_artifact(path)``.
"""

from __future__ import annotations

import argparse

import torch

from bayer_low_light_image_enhancement_tpu_torch.cli.test_cli import load_predictor
from bayer_low_light_image_enhancement_tpu_torch.cli.train_cli import build_model
from bayer_low_light_image_enhancement_tpu_torch.serving.export import export_artifact


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Export a serving artifact (PyTorch, one GPU)")
    p.add_argument("--model_size", default="S", choices=["S", "B", "L"])
    p.add_argument("--model", default=None, help="registry model name; overrides --model_size")
    p.add_argument("--ckpt", default=None, help="checkpoint directory of the port's train CLI")
    p.add_argument("--pth", default=None, help="PyTorch .pth checkpoint (reference names)")
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--fp32", action="store_true")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="the device the artifact serves on: the card (default) or the CPU")
    p.add_argument("--out", required=True, help="output artifact path")
    return p


def main(argv=None) -> dict:
    """Export; returns the artifact's meta."""
    args = build_parser().parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available; pass --device cpu for "
                         "a CPU artifact")
    model = build_model(args, "cpu", seed=0)
    args.pad_to = 16  # load_predictor's field; export_artifact does not pad
    pred = load_predictor(args, model, "cpu")
    if not (args.pth or args.ckpt):
        print("WARNING: no --ckpt/--pth given; exporting with random init")
    meta = export_artifact(
        pred.model, None, args.out, batch=args.batch, height=args.height, width=args.width,
        device=args.device,
        meta_extra={"model": args.model or f"rawformer_{args.model_size.lower()}"},
    )
    print(f"exported {args.out}: {meta}")
    return meta


if __name__ == "__main__":
    main()
