"""Training CLI of the PyTorch port (CUDA cards, or the CPU).

    python -m bayer_low_light_image_enhancement_tpu_torch.cli.train_cli \\
        --dataset synthetic --model_size S --patch_size 512 --batch_size 16
    ... --model rawformer_wfb --batch_size 8          # RawFormer-WFB
    ... --model truecolor_rawformer                   # or flca_rawformer, ...
    ... --device cpu                                  # no card
    ... --dataset SID --data_root <root> --cache_dir <npz cache>
    ... --num_chips 4 --tensor_chips 2                # 8 ranks, one a card
    torchrun --nproc_per_node 8 -m bayer_low_light_image_enhancement_tpu_torch.cli.train_cli \\
        ... --num_chips 4 --tensor_chips 2            # the same, started by torchrun

The argparse surface of ``bayer_low_light_image_enhancement_tpu/cli/
train_cli.py``, with its training semantics: SID (``<data_root>/Sony/
{short,long}``, ARW through ``data.raw``'s npz cache), MCR
(``<data_root>/Mono_Colored_RAW_Paired_DATASET/random_path_list/
{train,test}/*.npy`` path lists) or synthetic data; the batch producer
(``--loader``: the native C++ engine when the training split is in RAM,
with compact 16-bit batches decoded on the device unless
``--no_compact_h2d``, else the Python ``Loader``); epoch loop, per-epoch
validation PSNR on the uint8 grid, best and every-``save_every``-epochs
checkpoints, ``--resume``, text log + TensorBoard scalars under
``<save_dir>/<dataset>/``. It trains on the card unless ``--device cpu``
asks for the CPU, and exits with a message when no card is present.

``--num_chips N --tensor_chips T`` train over a (data N, tensor T) mesh
(``core/mesh.py``, ``train/trainer.py``): N x T ranks, one a card (NCCL;
with ``--device cpu`` gloo processes on the CPU), started here or by
``torchrun``; ``--num_chips -1`` takes every visible card // T.
``--batch_size`` is the global batch: each data rank loads and trains its
rows of it, and N shrinks to the largest count that divides it, with the
JAX CLI's note. Rank 0 alone writes the checkpoints (the single-device
format), the text log and TensorBoard; every rank restores on
``--resume``.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

import numpy as np
import torch

from bayer_low_light_image_enhancement_tpu_torch.data import (
    Loader,
    MCRDataset,
    SIDDataset,
    SyntheticBayerDataset,
    discover_sid_pairs,
    prefetch_to_device,
)
from bayer_low_light_image_enhancement_tpu_torch.core import mesh as meshlib
from bayer_low_light_image_enhancement_tpu_torch.data import native
from bayer_low_light_image_enhancement_tpu_torch.data.pipeline import to_device
from bayer_low_light_image_enhancement_tpu_torch.models import RawFormer, RawFormerConfig, get_model
from bayer_low_light_image_enhancement_tpu_torch.models.registry import is_raw_domain
from bayer_low_light_image_enhancement_tpu_torch.train.checkpoint import (
    BestTracker,
    CheckpointManager,
)
from bayer_low_light_image_enhancement_tpu_torch.train.trainer import TrainConfig, Trainer
from bayer_low_light_image_enhancement_tpu_torch.utils.logging import MetricsLogger


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train RawFormer on SID/MCR (PyTorch, CUDA)")
    p.add_argument("--dataset", default="SID", choices=["SID", "MCR", "synthetic"])
    p.add_argument("--model_size", default="S", choices=["S", "B", "L"])
    p.add_argument("--model", default=None,
                   help="registry model name (rawformer_s|b|l, rawformer_wfb, flca_rawformer, "
                   "multilvl_flca_rawformer, truecolor_rawformer, bayertorgb_rawformer); "
                   "overrides --model_size")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="train on the card (default) or on the CPU")
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--patch_size", type=int, default=512)
    p.add_argument("--epochs", type=int, default=3000)
    p.add_argument("--base_lr", type=float, default=1e-4)
    p.add_argument("--loss", default="charbonnier", choices=["charbonnier", "l1", "mse", "sid_color"])
    p.add_argument("--num_chips", type=int, default=-1,
                   help="data-parallel ranks (one card each; -1 = all visible cards // "
                   "--tensor_chips, 1 on the CPU); the global batch is split over them")
    p.add_argument("--tensor_chips", type=int, default=1,
                   help="tensor-parallel degree: Megatron column/row sharding of the "
                   "transformer blocks over a `tensor` mesh axis (parallel/tensor.py); "
                   "composes with data parallelism (num_chips counts data-parallel groups)")
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
                   help="training batch producer: the C++ engine (native) when the training "
                   "split is in RAM (auto), or the Python thread-pool Loader")
    p.add_argument("--device_prefetch", type=int, default=2,
                   help="batches staged on the device ahead of the step (0 = synchronous)")
    p.add_argument("--no_compact_h2d", action="store_true",
                   help="ship fp32 batches instead of the 16-bit compact transfer (uint16 "
                   "mosaic codes + ratio + uint16 GT decoded on the device; native loader only)")
    # The rendezvous of the ranks this CLI starts itself (torchrun's: env://).
    p.add_argument("--rendezvous", default=None, help=argparse.SUPPRESS)
    return p


def check_supported(args) -> tuple:
    """The (data, tensor) ranks to train on, with the JAX CLI's rules: -1 =
    every visible card // --tensor_chips (1 on the CPU, or torchrun's ranks
    // T); the data count shrinks to the largest that divides --batch_size,
    with a note. Exits with the JAX mesh error when the ranks need more
    cards than there are, and with a message without a card."""
    if args.tensor_chips < 1 or args.num_chips == 0 or args.num_chips < -1:
        raise SystemExit(f"--num_chips {args.num_chips} --tensor_chips {args.tensor_chips}: "
                         "want --num_chips -1 or >= 1 and --tensor_chips >= 1")
    tp, launched = args.tensor_chips, "WORLD_SIZE" in os.environ
    cards = torch.cuda.device_count() if args.device == "cuda" else None
    if launched:
        avail = int(os.environ["WORLD_SIZE"]) // tp
    else:
        avail = 1 if cards is None else cards // tp
    n = args.num_chips if args.num_chips != -1 else avail
    if n >= 1 and args.batch_size % n != 0:
        n = max(d for d in range(1, n + 1) if args.batch_size % d == 0)
        if args.rendezvous is None and os.environ.get("RANK", "0") == "0":  # once a run
            print(f"note: batch_size {args.batch_size} not divisible by device count; "
                  f"using {n} data-parallel chip(s)")
    if launched and n * tp != int(os.environ["WORLD_SIZE"]):
        raise SystemExit(f"--num_chips {n} x --tensor_chips {tp} = {n * tp} ranks, but "
                         f"{os.environ['WORLD_SIZE']} were started")
    if cards is not None and not launched and n >= 1:
        try:
            meshlib.mesh_shape(cards, data=n, tensor=tp)
        except ValueError as e:
            raise SystemExit(f"--num_chips {n} --tensor_chips {tp}: {e}") from None
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available; pass --device cpu to "
                         "train on the CPU")
    return n, tp


MCR_LISTS = "Mono_Colored_RAW_Paired_DATASET/random_path_list"


def build_split(args, training: bool):
    """The training (``training``) or test split of ``args.dataset``;
    exits with a message when a SID / MCR split is empty."""
    split = "train" if training else "test"
    if args.dataset == "SID":
        shorts, longs = discover_sid_pairs(args.data_root, split)
        if not shorts:
            ids = "0*, 2*" if training else "1*"
            raise SystemExit(f"--dataset SID: no SID {split} pairs under "
                             f"{args.data_root}/Sony/short ({ids}_00_0.1s.ARW)")
        return SIDDataset(shorts, longs, args.patch_size, training, args.cache_dir)
    if args.dataset == "MCR":
        lists = f"{args.data_root}/{MCR_LISTS}/{split}/{split}"
        if not os.path.exists(f"{lists}_c_path.npy"):
            raise SystemExit(f"--dataset MCR: no {split} path list {lists}_c_path.npy")
        raws = np.load(f"{lists}_c_path.npy", allow_pickle=True).tolist()
        rgbs = np.load(f"{lists}_rgb_path.npy", allow_pickle=True).tolist()
        return MCRDataset(raws, rgbs, args.patch_size, training)
    if training:
        return SyntheticBayerDataset(
            num_images=16, full_size=(args.patch_size * 2, args.patch_size * 2 + 64),
            patch_size=args.patch_size, training=True,
        )
    return SyntheticBayerDataset(
        num_images=4, full_size=(args.patch_size, args.patch_size),
        patch_size=args.patch_size, training=False, seed=1,
    )


def build_datasets(args):
    """(train, val) datasets of ``args.dataset``."""
    return build_split(args, True), build_split(args, False)


def build_train_loader(args, train_ds, part: int = 0, parts: int = 1):
    """The training batch producer and its kind: "native-compact" (the C++
    engine's ``(raw_u16, ratio, gt_u16)`` triples), "native" (its fp32
    ``(raw, gt)`` pairs) or "python" (``Loader``'s ``(mosaic, gt, ratio)``).
    ``--loader auto`` takes the engine where it can build and the training
    split is in RAM; ``--loader native`` exits with a message where not.
    Either producer yields data rank ``part`` of ``parts``'s rows of each
    global batch."""
    if args.loader in ("auto", "native"):
        compact = not args.no_compact_h2d
        sampler = native.sampler_for_dataset(train_ds, seed=args.seed, compact=compact)
        if sampler is not None:
            loader = native.NativeLoader(train_ds, sampler, args.batch_size, seed=args.seed,
                                         part=part, parts=parts)
            return loader, "native-compact" if compact else "native"
        if args.loader == "native":
            why = native._build_error or ("it takes a RAM-resident SID or synthetic training "
                                          "split with frames of at least patch_size + 2")
            raise SystemExit(f"--loader native: the C++ batch engine is unavailable ({why})")
    return Loader(train_ds, args.batch_size, shuffle=True, seed=args.seed, part=part,
                  parts=parts), "python"


LOADER_LABELS = {"native-compact": "native (compact 16-bit H2D)", "native": "native",
                 "python": "python"}


def build_model(args, device, seed: int):
    """The model ``--model`` names (through the registry), else RawFormer of
    ``--model_size``; exits with the JAX CLI's message for a raw-domain
    (enhancement-domain) model."""
    dtype = torch.float32 if args.fp32 else torch.bfloat16
    gen = torch.Generator().manual_seed(seed)
    if args.model:
        if is_raw_domain(args.model):
            raise SystemExit(
                f"model {args.model!r} is an enhancement-domain model "
                "(packed Bayer planes -> enhanced planes, [B,H,W,4] -> "
                "[B,H,W,4]); the RAW->RGB train/eval protocol does not "
                "apply — the reference only smoke-tests these "
                "(Transformer_FLCA_UNet.py:265-273). Use a RAW->RGB model "
                "or drive it via the Python API."
            )
        return get_model(args.model, device=device, generator=gen, dtype=dtype)
    return RawFormer(RawFormerConfig.from_size(args.model_size, dtype=dtype), device=device,
                     generator=gen)


MODULE = "bayer_low_light_image_enhancement_tpu_torch.cli.train_cli"


def launch_ranks(argv, world: int) -> None:
    """Start ``world`` ranks of this CLI (torchrun's rank variables, a
    file rendezvous in a temporary directory) and wait for them; exits with
    a message when one fails."""
    with tempfile.TemporaryDirectory() as tmp:
        cmd = [sys.executable, "-m", MODULE, *argv, "--rendezvous", f"file://{tmp}/rendezvous"]
        try:
            meshlib.run_ranks(cmd, world)
        except RuntimeError as e:
            raise SystemExit(f"training over {world} ranks failed: {e}") from None


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    n_data, tp = check_supported(args)
    world = n_data * tp
    if world > 1 and "WORLD_SIZE" not in os.environ:
        launch_ranks(argv, world)
        return
    mesh, device = None, torch.device(args.device)
    if world > 1:
        device = meshlib.initialize_multihost(args.rendezvous, device_type=args.device)
        mesh = meshlib.create_mesh(data=n_data, tensor=tp)
    try:
        train(args, mesh, device)
    finally:
        if mesh is not None:
            torch.distributed.destroy_process_group()


def train(args, mesh, device) -> None:
    """The epoch loop on this rank (the whole run without a mesh)."""
    part = meshlib.axis_rank(mesh, meshlib.AXES.data)
    parts = meshlib.axis_size(mesh, meshlib.AXES.data)
    show = print if meshlib.rank() == 0 else (lambda *a, **k: None)

    train_ds, val_ds = build_datasets(args)
    train_loader, loader_kind = build_train_loader(args, train_ds, part, parts)
    show(f"training batch producer: {LOADER_LABELS[loader_kind]}")
    val_loader = Loader(val_ds, max(1, min(args.batch_size, len(val_ds))), shuffle=False,
                        drop_last=False, part=part, parts=parts)
    steps_per_epoch = max(1, len(train_loader))

    model = build_model(args, device, args.seed)
    trainer = Trainer(model, TrainConfig(
        base_lr=args.base_lr, total_epochs=args.epochs, steps_per_epoch=steps_per_epoch,
        loss=args.loss, remat=args.remat, fused_blocks=not args.no_fused_train,
    ), mesh=mesh)

    save_root = f"{args.save_dir}/{args.dataset}"
    ckpt = CheckpointManager(f"{save_root}/weights")
    logger = MetricsLogger(f"{save_root}/log.txt", f"{save_root}/tb")  # rank 0 writes
    best = BestTracker()

    start_epoch = 0
    if args.resume:
        state, step = ckpt.restore(map_location=device)
        if state is not None:
            trainer.load_state_dict(state["trainer"])
            best.best_psnr, best.best_epoch = state["best_psnr"], state["best_epoch"]
            start_epoch = int(step) + 1
            show(f"resumed from epoch {step}")

    def save(epoch, metrics=None):
        # Every rank takes the snapshot (it gathers the tensor shards); rank 0 writes it.
        ckpt.save(epoch, {"trainer": trainer.state_dict(), "best_psnr": best.best_psnr,
                          "best_epoch": best.best_epoch}, metrics=metrics)

    for epoch in range(start_epoch, args.epochs + 1):
        t0 = time.time()
        losses = []
        if loader_kind == "python":
            batches = ((inp, gt) for inp, gt, _ in train_loader)
        else:
            # The engine's (raw, gt) pairs, or its compact triples, which
            # Trainer.train_step decodes on the device: handed over whole.
            batches = iter(train_loader)
        if args.device_prefetch > 0:
            batches = prefetch_to_device(batches, device, size=args.device_prefetch)
        else:
            batches = (tuple(to_device(a, device) for a in b) for b in batches)
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
                save(epoch, metrics={"psnr": avg_psnr})

        if epoch % args.save_every == 0 or epoch == args.epochs:
            save(epoch)

        dt = time.time() - t0
        logger.log_epoch(epoch, args.epochs, dt, epoch_loss, avg_psnr, best.best_psnr,
                         best.best_epoch)
        logger.log_scalars(epoch, {
            "valid_PSNR": avg_psnr, "best_PSNR": best.best_psnr, "best_epoch": best.best_epoch,
            "epoch_time": dt, "epoch_loss": epoch_loss, "epoch_LR": trainer.lr,
        })
        show(f"epoch {epoch}/{args.epochs} loss={epoch_loss:.4f} psnr={avg_psnr:.3f} "
             f"best={best.best_psnr:.3f}@{best.best_epoch} ({dt:.1f}s)", flush=True)

    ckpt.wait()
    logger.close()


if __name__ == "__main__":
    main()
