"""Evaluation CLI of the PyTorch port (one CUDA card, or the CPU).

    python -m bayer_low_light_image_enhancement_tpu_torch.cli.test_cli \\
        --dataset SID --data_root <root> --cache_dir <npz cache> \\
        --ckpt <train save_dir>/SID/weights --save_dir result --save_images
    ... --pth RawFormer_S_SID.pth       # a reference checkpoint instead
    ... --model flca_rawformer          # another family of the registry
    ... --device cpu                    # no card

Port of ``bayer_low_light_image_enhancement_tpu/cli/test_cli.py`` (the
reference's ``test.py``), with its flags and ``--device``: full-resolution
batch-1 inference over the test split, the Bayer channel fixes, per-image
PSNR / SSIM on the uint8 images (computed on the device), JPEG dumps named
with their metrics (``--save_images``, where ``imageio`` imports) and a CSV
at ``<save_dir>/<dataset>/csv/test_metrics.csv``.

On the card SID mosaics and MCR PNGs travel as their integer codes unless
``--no_compact_h2d`` and ``Predictor.codes`` decodes them there (RawFormer's
SID codes through kernel K1 and the prepacked model, any other model's
through ``ops.bayer.normalize_sid``; MCR codes through ``normalize_mcr``).
On the CPU frames are decoded on the host,
as the JAX CLI does off the TPU. ``--ckpt`` reads the port's own
checkpoints (``train.checkpoint.CheckpointManager``); an orbax directory
of the JAX package needs JAX to read, so it exits with a message.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from bayer_low_light_image_enhancement_tpu_torch.cli.train_cli import build_model, build_split
from bayer_low_light_image_enhancement_tpu_torch.models.common import set_fused_blocks
from bayer_low_light_image_enhancement_tpu_torch.serving.predictor import Predictor
from bayer_low_light_image_enhancement_tpu_torch.train.checkpoint import CheckpointManager
from bayer_low_light_image_enhancement_tpu_torch.train.metrics import psnr, ssim
from bayer_low_light_image_enhancement_tpu_torch.utils.logging import MetricsLogger


def correct_bayer_channels(rgb: np.ndarray, pattern: str = "RGGB") -> np.ndarray:
    """Channel permutation per CFA pattern (the reference's ``test.py:17-29``)."""
    pattern = pattern.upper()
    if pattern == "BGGR":
        return rgb[..., [2, 1, 0]]
    if pattern == "GBRG":
        return rgb[..., [1, 0, 2]]
    if pattern == "GRBG":
        return rgb[..., [0, 2, 1]]
    return rgb


def auto_correct_rb(rgb: np.ndarray) -> np.ndarray:
    """Swap R/B if red is darker than blue (the reference's ``test.py:31-40``)."""
    if rgb[..., 0].mean() < rgb[..., 2].mean():
        return rgb[..., [2, 1, 0]]
    return rgb


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Evaluate RawFormer on SID/MCR (PyTorch, one GPU)")
    p.add_argument("--dataset", default="SID", choices=["SID", "MCR", "synthetic"])
    p.add_argument("--model_size", default="S", choices=["S", "B", "L"])
    p.add_argument("--model", default=None,
                   help="registry model name (rawformer_s|b|l, rawformer_wfb, flca_rawformer, "
                   "multilvl_flca_rawformer, truecolor_rawformer, bayertorgb_rawformer); "
                   "overrides --model_size")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="evaluate on the card (default) or on the CPU")
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--patch_size", type=int, default=512, help="(synthetic dataset size)")
    p.add_argument("--bayer_pattern", default="RGGB")
    p.add_argument("--data_root", default=".")
    p.add_argument("--cache_dir", default=None)
    p.add_argument("--save_dir", default="result")
    p.add_argument("--ckpt", default=None, help="checkpoint directory of the port's train CLI")
    p.add_argument("--pth", default=None, help="PyTorch .pth checkpoint (reference names)")
    p.add_argument("--fp32", action="store_true")
    p.add_argument("--save_images", action="store_true")
    p.add_argument("--pad_to", type=int, default=16, help="pad H/W to multiple")
    p.add_argument("--no_compact_h2d", action="store_true",
                   help="ship fp32 frames instead of the uint16 / uint8 codes decoded on the "
                   "device (the compact path runs on the card only)")
    p.add_argument("--spatial_chips", type=int, default=1,
                   help="shard frames over N devices along H (1 here)")
    p.add_argument("--spatial_w_chips", type=int, default=1,
                   help="shard frames over M devices along W (1 here)")
    p.add_argument("--no_fused", action="store_true",
                   help="run TransformerBlocks through the module path and Mamba scans "
                   "through the twin instead of the kernels")
    return p


def load_predictor(args, model, device) -> Predictor:
    """A Predictor of ``model`` with the weights ``--pth`` / ``--ckpt`` name
    (the seeded random init when neither is given)."""
    kw = dict(device=device, pad_to=args.pad_to)
    if args.pth:
        pred = Predictor.from_torch(model, args.pth, **kw)
        print(f"imported torch checkpoint {args.pth}")
        return pred
    if args.ckpt:
        if not os.path.isdir(args.ckpt):
            raise SystemExit(f"no checkpoint found in {args.ckpt}")
        state, step = CheckpointManager(args.ckpt).restore(map_location="cpu")
        if state is None:
            if any(e.isdigit() for e in os.listdir(args.ckpt)):
                raise SystemExit(
                    f"{args.ckpt} holds orbax checkpoints of the JAX package, which cannot be "
                    "read without JAX: convert one to a torch state_dict where JAX is "
                    "installed (the orbax -> torch converter, ROADMAP.md A3) and pass it as "
                    "--pth")
            raise SystemExit(f"no checkpoint found in {args.ckpt}")
        pred = Predictor(model, state["trainer"]["model"], **kw)
        print(f"restored checkpoint step {step}")
        return pred
    return Predictor(model, **kw)


def main(argv=None):
    """Evaluate; returns the per-image ``psnr``, ``ssim`` and host-clock
    ``seconds`` (sample, forward, metrics), and the ``pad_to`` used."""
    args = build_parser().parse_args(argv)
    if args.spatial_chips > 1 or args.spatial_w_chips > 1:
        raise SystemExit("--spatial_chips / --spatial_w_chips: the port evaluates on one "
                         "device; spatial sharding over several GPUs is a later slice")
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available; pass --device cpu to "
                         "evaluate on the CPU")
    device = torch.device(args.device)
    val_ds = build_split(args, training=False)
    model = build_model(args, "cpu", seed=0)
    if args.no_fused:
        set_fused_blocks(model, False)
    if args.model == "rawformer_wfb":
        # WFB needs H/W divisible by 32: space_to_depth, three downsamples
        # and the in-stage Haar DWT halving.
        args.pad_to = max(args.pad_to, 32)
    pred = load_predictor(args, model, device)

    # Compact H2D on the card: ship the integer codes and decode them there.
    compact = (not args.no_compact_h2d and device.type == "cuda"
               and hasattr(val_ds, "device_normalize"))
    decode = "mcr" if args.dataset == "MCR" else "sid"
    if compact:
        val_ds.device_normalize = True

    save_images_dir = os.path.join(args.save_dir, args.dataset, "images")
    save_csv = os.path.join(args.save_dir, args.dataset, "csv", "test_metrics.csv")
    imageio = None
    if args.save_images:
        try:
            import imageio.v2 as imageio
        except ImportError:
            print("imageio is not installed: --save_images writes no JPEGs")
        else:
            os.makedirs(save_images_dir, exist_ok=True)

    rng = np.random.default_rng(0)
    psnrs, ssims, seconds = [], [], []
    for idx in range(len(val_ds)):
        t0 = time.perf_counter()
        inp, gt, ratio = val_ds.sample(idx, rng)
        out = pred.codes(inp, ratio, decode) if compact else pred(inp)

        pred_u8 = (np.clip(out, 0, 1) * 255).astype(np.uint8)
        gt_u8 = (np.clip(gt, 0, 1) * 255).astype(np.uint8)
        pred_u8 = auto_correct_rb(correct_bayer_channels(pred_u8, args.bayer_pattern))
        gt_u8 = auto_correct_rb(correct_bayer_channels(gt_u8, args.bayer_pattern))

        # The reference computes PSNR / SSIM on the uint8 arrays: move them as
        # such and take the metrics on the device.
        p_dev = torch.from_numpy(np.ascontiguousarray(pred_u8)).to(device).float()
        g_dev = torch.from_numpy(np.ascontiguousarray(gt_u8)).to(device).float()
        p, s = float(psnr(p_dev, g_dev)), float(ssim(p_dev, g_dev))
        seconds.append(time.perf_counter() - t0)
        psnrs.append(p)
        ssims.append(s)
        print(f"image:{idx}\tPSNR:{p:.4f}\tSSIM:{s:.4f}")

        if imageio is not None:
            imageio.imwrite(os.path.join(save_images_dir, f"{idx}_gt.jpg"), gt_u8)
            imageio.imwrite(
                os.path.join(save_images_dir, f"{idx}_psnr_{p:.4f}_ssim_{s:.4f}.jpg"), pred_u8)

    print(f"Average PSNR: {np.mean(psnrs):.4f}, Average SSIM: {np.mean(ssims):.4f}")
    MetricsLogger().write_metrics_csv(save_csv, psnrs, ssims)
    return {"psnr": psnrs, "ssim": ssims, "seconds": seconds, "pad_to": args.pad_to}


if __name__ == "__main__":
    main()
