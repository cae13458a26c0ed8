"""Evaluation CLI of the PyTorch port (one CUDA card, or the CPU).

    python -m bayer_low_light_image_enhancement_tpu_torch.cli.test_cli \\
        --dataset SID --data_root <root> --cache_dir <npz cache> \\
        --ckpt <train save_dir>/SID/weights --save_dir result --save_images
    ... --pth RawFormer_S_SID.pth       # a reference checkpoint instead
    ... --model flca_rawformer          # another family of the registry
    ... --device cpu                    # no card
    ... --spatial_chips 4 [--spatial_w_chips 2]   # one frame over N x M ranks

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
of the JAX package needs JAX to read, so it exits with a message naming
``tools/orbax_to_torch.py``, which converts one.

``--spatial_chips N --spatial_w_chips M`` evaluate each frame tiled over a
(1, N, M, 1) mesh (``parallel/tiled.py``): the CLI starts N x M ranks of
itself (one card each on NCCL; gloo processes with ``--device cpu``), or
runs as the rank ``torchrun`` made. Every rank reads the frame, runs its
block, and receives the whole RGB; rank 0 prints the metrics and writes the
CSV and the JPEGs. Frames are padded to ``max(pad_to, h_mult * N, 16 *
M)``, h_mult 32 for RawFormer-WFB and 16 otherwise. Every RAW -> RGB
model of the registry shards by H and by H x W, RawFormer-WFB by H only; a
2-D mesh builds the model with the (``spatial``, ``spatial_w``) pair, so
that its resizes, reductions and token attention cross both axes (the JAX
CLI builds the zoo models with the H axis alone, ROADMAP C17).

On one card, a canonical RawFormer S/B/L frame (no ``--model``) of H >= 1024
at batch 1 on the kernel path runs banded (``models/fused_apply.py``): H
padded to a multiple of 128 and cut into ``pick_bands(H)`` bands riding the
batch axis, the JAX CLI's route (``band_count``). Every other frame keeps the
monolithic forward.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn as nn

from bayer_low_light_image_enhancement_tpu_torch.cli.train_cli import build_model, build_split
from bayer_low_light_image_enhancement_tpu_torch.core import mesh as meshlib
from bayer_low_light_image_enhancement_tpu_torch.models.common import set_fused_blocks
from bayer_low_light_image_enhancement_tpu_torch.models.fused_apply import (
    make_banded_forward,
    pick_bands,
)
from bayer_low_light_image_enhancement_tpu_torch.parallel.tiled import (
    make_tiled_forward,
    shard_image,
)
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
                   "multilvl_flca_rawformer, truecolor_rawformer, bayertorgb_rawformer, "
                   "luma_mhsa_rawformer, wavkan_rawformer); overrides --model_size")
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
                   help="shard full-resolution frames over N ranks along H (halo-exchange "
                   "tiling; 1 = monolithic)")
    p.add_argument("--spatial_w_chips", type=int, default=1,
                   help="additionally shard frames along W over M ranks (2D spatial mesh of "
                   "spatial_chips x spatial_w_chips; every model but rawformer_wfb, whose "
                   "raster-order SSM shards along H only)")
    p.add_argument("--no_fused", action="store_true",
                   help="run TransformerBlocks through the module path and Mamba scans "
                   "through the twin instead of the kernels")
    # The rendezvous of the ranks this CLI starts itself (torchrun's: env://),
    # and where rank 0 writes its results for the launcher.
    p.add_argument("--rendezvous", default=None, help=argparse.SUPPRESS)
    p.add_argument("--result_file", default=None, help=argparse.SUPPRESS)
    return p


def load_predictor(args, model, device, show=print) -> Predictor:
    """A Predictor of ``model`` with the weights ``--pth`` / ``--ckpt`` name
    (the seeded random init when neither is given)."""
    kw = dict(device=device, pad_to=args.pad_to)
    if args.pth:
        pred = Predictor.from_torch(model, args.pth, **kw)
        show(f"imported torch checkpoint {args.pth}")
        return pred
    if args.ckpt:
        if not os.path.isdir(args.ckpt):
            raise SystemExit(f"no checkpoint found in {args.ckpt}")
        state, step = CheckpointManager(args.ckpt).restore(map_location="cpu")
        if state is None:
            if any(e.isdigit() for e in os.listdir(args.ckpt)):
                raise SystemExit(
                    f"{args.ckpt} holds orbax checkpoints of the JAX package, which cannot be "
                    "read without JAX: convert them where JAX is installed with "
                    f"`python tools/orbax_to_torch.py --ckpt {args.ckpt} --out <dir> "
                    "[--model NAME | --model_size S]` and pass --ckpt <dir>")
            raise SystemExit(f"no checkpoint found in {args.ckpt}")
        pred = Predictor(model, state["trainer"]["model"], **kw)
        show(f"restored checkpoint step {step}")
        return pred
    return Predictor(model, **kw)


MODULE = "bayer_low_light_image_enhancement_tpu_torch.cli.test_cli"

# The band route's pad and smallest padded height (the JAX CLI's).
BAND_PAD, BAND_MIN_H = 128, 1024


def band_count(args, shape, device) -> int:
    """The bands the single-card full-frame route cuts a frame of ``shape``
    ([B, H, W, 1], [H, W, 1] or [H, W]) into, 1 for the monolithic forward:
    ``pick_bands`` of H padded to a multiple of max(pad_to, 128) for a
    canonical RawFormer S/B/L (no ``--model``) on the card's kernel path (not
    ``--no_fused``, not ``--device cpu``, no spatial mesh) at batch 1 where
    that height is at least 1024 (the JAX CLI's route)."""
    if (args.model is not None or args.no_fused or torch.device(device).type != "cuda"
            or args.spatial_chips * args.spatial_w_chips != 1):
        return 1
    b, h = (shape[0], shape[1]) if len(shape) == 4 else (1, shape[0])
    pad = max(args.pad_to, BAND_PAD)
    hp = -(-h // pad) * pad
    return pick_bands(hp) if b == 1 and hp >= BAND_MIN_H else 1


class TiledFrames(nn.Module):
    """A tiled forward (``parallel/tiled.py``) as a model of whole frames:
    [B, 1, H, W] in, this rank's block through the tiled forward, the whole
    [B, 3, H, W] RGB out, so that ``Predictor`` pads, decodes and crops as
    for one device."""

    def __init__(self, tiled, mesh, w_axis):
        super().__init__()
        self.tiled, self.mesh, self.w_axis = tiled, mesh, w_axis
        self.config = tiled.config

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        local = shard_image(x.permute(0, 2, 3, 1), self.mesh, meshlib.AXES.spatial, self.w_axis)
        return self.tiled(local.contiguous()).permute(0, 3, 1, 2)


def spatial_layout(args):
    """The spatial mesh axis names of ``--spatial_chips`` / ``--spatial_w_chips``
    -> (model spatial_axis, W axis or None), or (None, None) for one rank;
    exits with the JAX CLI's messages for a bad count and for WFB over W."""
    n, m = args.spatial_chips, args.spatial_w_chips
    if n < 1 or m < 1:
        raise SystemExit(f"--spatial_chips {n} --spatial_w_chips {m}: want counts >= 1")
    if n * m == 1:
        return None, None
    if m > 1 and args.model == "rawformer_wfb":
        raise SystemExit("--spatial_w_chips: rawformer_wfb is H-shardable only (its selective "
                         "scan needs raster-contiguous tokens); use --spatial_chips")
    axes = meshlib.AXES
    if m > 1:
        return (axes.spatial, axes.spatial_w), axes.spatial_w
    return axes.spatial, None


def launch_ranks(argv, world: int) -> dict:
    """Start ``world`` ranks of this CLI (torchrun's rank variables, a file
    rendezvous in a temporary directory), wait for them and return rank 0's
    results; exits with a message when one fails."""
    with tempfile.TemporaryDirectory() as tmp:
        result = f"{tmp}/result.json"
        cmd = [sys.executable, "-m", MODULE, *argv, "--rendezvous", f"file://{tmp}/rendezvous",
               "--result_file", result]
        try:
            meshlib.run_ranks(cmd, world)
        except RuntimeError as e:
            raise SystemExit(f"evaluation over {world} ranks failed: {e}") from None
        with open(result) as f:
            return json.load(f)


def main(argv=None):
    """Evaluate; returns the per-image ``psnr``, ``ssim`` and host-clock
    ``seconds`` (sample, forward, metrics), and the ``pad_to`` used (rank
    0's, from the ranks this CLI starts for a spatial mesh)."""
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    spatial_axis, w_axis = spatial_layout(args)
    world = args.spatial_chips * args.spatial_w_chips
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available; pass --device cpu to "
                         "evaluate on the CPU")
    model = build_model(args, "cpu", seed=0, spatial_axis=spatial_axis)
    launched = "WORLD_SIZE" in os.environ
    if launched and world != int(os.environ["WORLD_SIZE"]):
        raise SystemExit(f"--spatial_chips {args.spatial_chips} x --spatial_w_chips "
                         f"{args.spatial_w_chips} = {world} ranks, but "
                         f"{os.environ['WORLD_SIZE']} were started")
    if world > 1 and not launched:
        if args.device == "cuda":
            try:
                meshlib.mesh_shape(torch.cuda.device_count(), data=1, spatial=args.spatial_chips,
                                   spatial_w=args.spatial_w_chips)
            except ValueError as e:
                raise SystemExit(f"--spatial_chips {args.spatial_chips} --spatial_w_chips "
                                 f"{args.spatial_w_chips}: {e}") from None
        return launch_ranks(argv, world)
    mesh, device = None, torch.device(args.device)
    if world > 1:
        device = meshlib.initialize_multihost(args.rendezvous, device_type=args.device)
        mesh = meshlib.create_mesh(data=1, spatial=args.spatial_chips,
                                   spatial_w=args.spatial_w_chips)
    try:
        return evaluate(args, model, device, mesh, w_axis)
    finally:
        if mesh is not None:
            torch.distributed.destroy_process_group()


def evaluate(args, model, device, mesh, w_axis) -> dict:
    """The evaluation loop on this rank (the whole run without a mesh)."""
    show = print if meshlib.rank() == 0 else (lambda *a, **k: None)
    val_ds = build_split(args, training=False)
    if args.no_fused:
        set_fused_blocks(model, False)
    if mesh is not None:
        # WFB halves each stage again through its in-stage Haar DWT, so its
        # per-shard H must be a multiple of 32 (16 for the rest).
        h_mult = 32 if args.model == "rawformer_wfb" else 16
        args.pad_to = max(args.pad_to, h_mult * args.spatial_chips, 16 * args.spatial_w_chips)
    if args.model == "rawformer_wfb":
        # WFB needs H/W divisible by 32: space_to_depth, three downsamples
        # and the in-stage Haar DWT halving.
        args.pad_to = max(args.pad_to, 32)
    pred = load_predictor(args, model, device, show)
    if mesh is not None:
        tiled = make_tiled_forward(pred.model, mesh, meshlib.AXES.spatial, w_axis)
        pred = Predictor(TiledFrames(tiled, mesh, w_axis), device=device, pad_to=args.pad_to)

    # Compact H2D on the card: ship the integer codes and decode them there.
    compact = (not args.no_compact_h2d and device.type == "cuda"
               and hasattr(val_ds, "device_normalize"))
    decode = "mcr" if args.dataset == "MCR" else "sid"
    if compact:
        val_ds.device_normalize = True

    save_images_dir = os.path.join(args.save_dir, args.dataset, "images")
    save_csv = os.path.join(args.save_dir, args.dataset, "csv", "test_metrics.csv")
    imageio = None
    if args.save_images and meshlib.rank() == 0:
        try:
            import imageio.v2 as imageio
        except ImportError:
            show("imageio is not installed: --save_images writes no JPEGs")
        else:
            os.makedirs(save_images_dir, exist_ok=True)

    rng = np.random.default_rng(0)
    psnrs, ssims, seconds = [], [], []
    banded = {}  # bands -> the Predictor of the banded forward
    for idx in range(len(val_ds)):
        t0 = time.perf_counter()
        inp, gt, ratio = val_ds.sample(idx, rng)
        k = band_count(args, inp.shape, device)
        if k > 1 and k not in banded:
            banded[k] = Predictor(make_banded_forward(pred.model, k), device=device,
                                  pad_to=max(args.pad_to, BAND_PAD))
        fwd = banded[k] if k > 1 else pred
        out = fwd.codes(inp, ratio, decode) if compact else fwd(inp)

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
        show(f"image:{idx}\tPSNR:{p:.4f}\tSSIM:{s:.4f}")

        if imageio is not None:
            imageio.imwrite(os.path.join(save_images_dir, f"{idx}_gt.jpg"), gt_u8)
            imageio.imwrite(
                os.path.join(save_images_dir, f"{idx}_psnr_{p:.4f}_ssim_{s:.4f}.jpg"), pred_u8)

    show(f"Average PSNR: {np.mean(psnrs):.4f}, Average SSIM: {np.mean(ssims):.4f}")
    result = {"psnr": psnrs, "ssim": ssims, "seconds": seconds, "pad_to": args.pad_to}
    if meshlib.rank() == 0:
        MetricsLogger().write_metrics_csv(save_csv, psnrs, ssims)
        if args.result_file:
            with open(args.result_file, "w") as f:
                json.dump(result, f)
    return result


if __name__ == "__main__":
    main()
