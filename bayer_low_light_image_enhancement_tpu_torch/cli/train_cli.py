"""Training CLI of the PyTorch port (one CUDA card, or the CPU).

    python -m bayer_low_light_image_enhancement_tpu_torch.cli.train_cli \\
        --dataset synthetic --model_size S --patch_size 512 --batch_size 16
    ... --model rawformer_wfb --batch_size 8          # RawFormer-WFB
    ... --device cpu                                  # no card

The argparse surface of ``bayer_low_light_image_enhancement_tpu/cli/
train_cli.py``, with its training semantics: epoch loop, per-epoch
validation PSNR on the uint8 grid, best and every-``save_every``-epochs
checkpoints, ``--resume``, text log + TensorBoard scalars under
``<save_dir>/<dataset>/``. What this slice does not have yet exits with a
message: the SID / MCR loaders, the C++ batch engine (``--loader native``)
and more than one device. It trains on the card unless ``--device cpu``
asks for the CPU, and exits with a message when no card is present.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from bayer_low_light_image_enhancement_tpu_torch.data import (
    Loader,
    SyntheticBayerDataset,
    prefetch_to_device,
)
from bayer_low_light_image_enhancement_tpu_torch.models import RawFormer, RawFormerConfig, get_model
from bayer_low_light_image_enhancement_tpu_torch.train.checkpoint import (
    BestTracker,
    CheckpointManager,
)
from bayer_low_light_image_enhancement_tpu_torch.train.trainer import TrainConfig, Trainer
from bayer_low_light_image_enhancement_tpu_torch.utils.logging import MetricsLogger


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train RawFormer on SID/MCR (PyTorch, one GPU)")
    p.add_argument("--dataset", default="SID", choices=["SID", "MCR", "synthetic"])
    p.add_argument("--model_size", default="S", choices=["S", "B", "L"])
    p.add_argument("--model", default=None,
                   help="registry model name (e.g. rawformer_b, rawformer_wfb); overrides "
                   "--model_size")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="train on the card (default) or on the CPU")
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--patch_size", type=int, default=512)
    p.add_argument("--epochs", type=int, default=3000)
    p.add_argument("--base_lr", type=float, default=1e-4)
    p.add_argument("--loss", default="charbonnier", choices=["charbonnier", "l1", "mse", "sid_color"])
    p.add_argument("--num_chips", type=int, default=-1, help="-1 = all devices (one here)")
    p.add_argument("--tensor_chips", type=int, default=1, help="tensor-parallel degree (1 here)")
    p.add_argument("--data_root", default=".")
    p.add_argument("--cache_dir", default=None, help="decoded-ARW npz cache (SID)")
    p.add_argument("--save_dir", default="result")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--fp32", action="store_true", help="disable bf16 compute")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--remat", action="store_true", help="rematerialise forward in backward")
    p.add_argument("--no_fused_train", action="store_true",
                   help="run TransformerBlocks through the module path and Mamba scans "
                   "through the twin instead of the kernels (K2/K3 + B1/B2, S1 + S2)")
    p.add_argument("--val_every", type=int, default=1)
    p.add_argument("--save_every", type=int, default=50)
    p.add_argument("--loader", default="auto", choices=["auto", "python", "native"],
                   help="training batch producer (the port has the Python thread-pool Loader)")
    p.add_argument("--device_prefetch", type=int, default=2,
                   help="batches staged on the device ahead of the step (0 = synchronous)")
    p.add_argument("--no_compact_h2d", action="store_true",
                   help="accepted for the JAX CLI's surface; the Python loader ships fp32")
    return p


def check_supported(args) -> None:
    """Exit with a message for what this slice of the port does not have."""
    if args.dataset in ("SID", "MCR"):
        raise SystemExit(f"--dataset {args.dataset}: the SID/MCR loaders are not ported yet "
                         "(a later slice); use --dataset synthetic")
    if args.loader == "native":
        raise SystemExit("--loader native: the C++ batch engine is not ported yet; "
                         "use --loader python")
    if args.num_chips not in (-1, 1) or args.tensor_chips != 1:
        raise SystemExit("the port trains on one device: --num_chips and --tensor_chips "
                         "other than 1 come with multi-GPU training (a later slice)")
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available; pass --device cpu to "
                         "train on the CPU")


def build_datasets(args):
    train = SyntheticBayerDataset(
        num_images=16, full_size=(args.patch_size * 2, args.patch_size * 2 + 64),
        patch_size=args.patch_size, training=True,
    )
    val = SyntheticBayerDataset(
        num_images=4, full_size=(args.patch_size, args.patch_size),
        patch_size=args.patch_size, training=False, seed=1,
    )
    return train, val


def build_model(args, device):
    dtype = torch.float32 if args.fp32 else torch.bfloat16
    gen = torch.Generator().manual_seed(args.seed)
    if args.model:
        return get_model(args.model, device=device, generator=gen, dtype=dtype)
    return RawFormer(RawFormerConfig.from_size(args.model_size, dtype=dtype), device=device,
                     generator=gen)


def main(argv=None):
    args = build_parser().parse_args(argv)
    check_supported(args)
    device = torch.device(args.device)

    train_ds, val_ds = build_datasets(args)
    train_loader = Loader(train_ds, args.batch_size, shuffle=True, seed=args.seed)
    print("training batch producer: python")
    val_loader = Loader(val_ds, min(args.batch_size, len(val_ds)), shuffle=False,
                        drop_last=False)
    steps_per_epoch = max(1, len(train_loader))

    model = build_model(args, device)
    trainer = Trainer(model, TrainConfig(
        base_lr=args.base_lr, total_epochs=args.epochs, steps_per_epoch=steps_per_epoch,
        loss=args.loss, remat=args.remat, fused_blocks=not args.no_fused_train,
    ))

    save_root = f"{args.save_dir}/{args.dataset}"
    ckpt = CheckpointManager(f"{save_root}/weights")
    logger = MetricsLogger(f"{save_root}/log.txt", f"{save_root}/tb")
    best = BestTracker()

    start_epoch = 0
    if args.resume:
        state, step = ckpt.restore(map_location=device)
        if state is not None:
            trainer.load_state_dict(state["trainer"])
            best.best_psnr, best.best_epoch = state["best_psnr"], state["best_epoch"]
            start_epoch = int(step) + 1
            print(f"resumed from epoch {step}")

    def snapshot():
        return {"trainer": trainer.state_dict(), "best_psnr": best.best_psnr,
                "best_epoch": best.best_epoch}

    for epoch in range(start_epoch, args.epochs + 1):
        t0 = time.time()
        losses = []
        batches = ((inp, gt) for inp, gt, _ in train_loader)
        if args.device_prefetch > 0:
            batches = prefetch_to_device(batches, device, size=args.device_prefetch)
        else:
            batches = (tuple(torch.from_numpy(a).to(device) for a in b) for b in batches)
        for batch in batches:
            losses.append(trainer.train_step(batch))
        epoch_loss = float(torch.stack(losses).sum()) if losses else 0.0

        avg_psnr = np.nan
        if epoch % args.val_every == 0:
            psnrs = []
            for inp, gt, _ in val_loader:
                _, per_image = trainer.eval_step((torch.from_numpy(inp).to(device),
                                                  torch.from_numpy(gt).to(device)))
                psnrs.extend(per_image.cpu().tolist())
            avg_psnr = float(np.mean(psnrs)) if psnrs else np.nan
            if best.update(epoch, avg_psnr):
                ckpt.save(epoch, snapshot(), metrics={"psnr": avg_psnr})

        if epoch % args.save_every == 0 or epoch == args.epochs:
            ckpt.save(epoch, snapshot())

        dt = time.time() - t0
        logger.log_epoch(epoch, args.epochs, dt, epoch_loss, avg_psnr, best.best_psnr,
                         best.best_epoch)
        logger.log_scalars(epoch, {
            "valid_PSNR": avg_psnr, "best_PSNR": best.best_psnr, "best_epoch": best.best_epoch,
            "epoch_time": dt, "epoch_loss": epoch_loss, "epoch_LR": trainer.lr,
        })
        print(f"epoch {epoch}/{args.epochs} loss={epoch_loss:.4f} psnr={avg_psnr:.3f} "
              f"best={best.best_psnr:.3f}@{best.best_epoch} ({dt:.1f}s)", flush=True)

    ckpt.wait()
    logger.close()


if __name__ == "__main__":
    main()
