"""Training steps on compact uint16 crops, on one card.

Each step is ``Trainer.train_step`` (``TrainConfig``'s defaults: the
kernel path, Charbonnier, the NaN guard, Adam under the warmup-cosine
schedule) on a batch of ``rows`` crops of ``crop`` x ``crop``: raw uint16
[B, p, p, 1], ratio [B], gt uint16 [B, p, p, 3]. The batches come from a
pool of ``pool_batches`` batches of distinct captures made from the seed,
cycled, and reach the card through ``prefetch_to_device`` from pinned host
memory, as the train CLI's loader hands them.

Set-up builds the one trainer, drives it through ``first_steps`` steps on
the pool's first batches (their rows all differ) and keeps what the
comparison needs: each step's loss, each leaf's norm of the first
gradient as Adam holds it (its first moment after one step over 1 - beta1)
and of the parameters' change over those steps. The same trainer then runs
the window: steps until the run's seconds have passed, or ``trace_steps``
steps under the profiler. After the window the reference runs the first
steps on the same batches from the same weights, ``ref_block_rows`` rows
at a time.

Mix parameters: crop, rows, pool_batches, first_steps, trace_steps,
ref_block_rows.
"""

import gc
import itertools
import time

import numpy as np
import torch

from port_bench import counts, program, tracing
from port_bench.harness import Record
from port_bench.reference import fp32
from port_bench.reference.train import BETAS, run_steps
from port_bench.traffic.sid_synth import captures

# A leaf whose reference gradient is below this share of the median leaf's
# moves under Adam by rounding alone: it is left out of the leaf gaps.
NOUGHT = 1e-3


def leaf_gap(prog: dict, ref: dict, keep) -> tuple:
    """The worst leaf's gap between the program's norm and the reference's,
    over the larger of the reference's norm of that leaf and the median
    leaf's; (gap, leaf)."""
    med = float(np.median([ref[n] for n in keep]))
    gaps = {n: abs(prog[n] - ref[n]) / max(ref[n], med) for n in keep}
    leaf = max(gaps, key=gaps.get)
    return gaps[leaf], leaf


def train_gaps(prog: dict, ref: dict) -> dict:
    """The numbers compared: the steps' worst relative loss gap and the
    worst leaf's gap of the first gradient's and of the change's norms."""
    med = float(np.median(list(ref["grad_norms"].values())))
    keep = [n for n, g in ref["grad_norms"].items() if g >= NOUGHT * med]
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"]))
    grad, grad_leaf = leaf_gap(prog["grad_norms"], ref["grad_norms"], keep)
    change, change_leaf = leaf_gap(prog["change_norms"], ref["change_norms"], keep)
    return {"loss_gap": loss, "grad_leaf_gap": grad, "change_leaf_gap": change,
            "leaves": (grad_leaf, change_leaf, len(ref["grad_norms"]) - len(keep))}


def batch_pool(mix, seed, device):
    n, p = mix["rows"], mix["crop"]
    raw, ratio, gt = captures(seed, mix["pool_batches"] * n, p, p, device, with_gt=True)
    return [(raw[j * n:(j + 1) * n, ..., None], ratio[j * n:(j + 1) * n], gt[j * n:(j + 1) * n])
            for j in range(mix["pool_batches"])]


def first_steps(trainer, feed, steps: int):
    """The set-up's steps on the trainer that the window goes on with: the
    losses and each leaf's norm of the first gradient and of the change."""
    named = list(trainer.model.named_parameters())
    start = {n: p.detach().clone() for n, p in named}
    losses, grads = [], None
    for s in range(steps):
        losses.append(float(trainer.train_step(next(feed))))
        if s == 0:
            st = trainer.optimizer.state
            grads = {n: float(st[p]["exp_avg"].norm()) / (1 - BETAS[0]) if p in st else 0.0
                     for n, p in named}
    change = {n: float((p.detach() - start[n]).norm()) for n, p in named}
    return {"losses": losses, "grad_norms": grads, "change_norms": change}


def run(cell, seed, seconds, trace, device, clock):
    from bayer_low_light_image_enhancement_tpu_torch.data.pipeline import prefetch_to_device
    from bayer_low_light_image_enhancement_tpu_torch.train.trainer import TrainConfig, Trainer

    mix, config = cell.traffic, cell.config
    clock.mark("import")
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.init()
    torch.empty(1, device=dev)
    clock.mark("device init")
    model = program.port_model(config, seed, dev)
    trainer = Trainer(model, TrainConfig())
    clock.mark("weights")
    batches = batch_pool(mix, seed, dev)
    feed = prefetch_to_device(itertools.cycle(batches), dev)
    clock.mark("traffic")
    prog = first_steps(trainer, feed, mix["first_steps"])
    program.sync(dev)
    clock.mark("warm-up")

    rec = Record(flops_per_unit=counts.rawformer_flops(
        config["dim"], tuple(config["num_heads"]), config["ffn_expansion"],
        (mix["rows"], 1, mix["crop"], mix["crop"]), backward=True))
    hooks = program.BlockHooks(model, config, 2, backward=True) if trace else None
    if hooks is not None:
        trainer.train_step(next(feed))  # counts each block shape once, outside the window
        hooks.least.clear()
    program.sync(dev)
    if dev.type == "cuda":
        rec.peak_bytes = torch.cuda.max_memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    rec.setup_s = clock.since_start()
    with tracing.traced(trace) as held:
        t_open = time.perf_counter()
        while not (rec.units >= mix["trace_steps"] if trace
                   else time.perf_counter() - t_open >= seconds):
            rec.attempted += 1
            with torch.autograd.profiler.record_function("bench::step"):
                trainer.train_step(next(feed))
            rec.units += 1
        program.sync(dev)
        rec.window_s = time.perf_counter() - t_open
    rec.mpix = rec.units * mix["rows"] * mix["crop"] ** 2 / 1e6
    if dev.type == "cuda":
        rec.window_peak_bytes = torch.cuda.max_memory_allocated(dev)
        rec.peak_bytes = max(rec.peak_bytes, rec.window_peak_bytes)
    if trace:
        rec.trace, rec.trace_units = tracing.summarize(held.trace), rec.units
        rec.block_calls = hooks.least
        hooks.remove()
    del trainer, model, feed, held
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    compare(rec, config, seed, dev, batches[:mix["first_steps"]], prog, mix, cell.cell["limits"])
    return rec


def reference_steps(config, seed, dev, batches, block_rows):
    """The reference's steps on the ``batches`` from the run's
    weights, made again from the seed."""
    def t(a):
        a = np.ascontiguousarray(a)
        return torch.from_numpy(a.view(np.int16) if a.dtype == np.uint16 else a).to(dev)

    with fp32():
        model = program.reference_model(config, seed, dev).train()
        return run_steps(model, [tuple(t(a) for a in b) for b in batches], block_rows)


def compare(rec, config, seed, dev, batches, prog, mix, limits) -> None:
    """The set-up's steps against the reference's; the numbers the cell's
    limits name are compared, the others reported."""
    ref = reference_steps(config, seed, dev, batches, mix["ref_block_rows"])
    gaps = train_gaps(prog, ref)
    grad_leaf, change_leaf, left_out = gaps.pop("leaves")
    for name, limit in limits.items():
        rec.checks[name] = {"value": gaps[name], "limit": limit}
    rec.notes.append(f"losses {prog['losses']} reference {ref['losses']} (gap "
                     f"{gaps['loss_gap']!r}); worst leaves: gradient {grad_leaf}, change "
                     f"{change_leaf}; {left_out} leaves left out (reference gradient under "
                     f"{NOUGHT} of the median leaf's)")
