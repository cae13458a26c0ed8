"""The reference training step: decode, forward, clamp, Charbonnier loss,
backward, the NaN guard, Adam under the warmup-cosine schedule.

The forward and backward run in blocks of rows whose losses are weighted
by their share of the batch, so the summed gradient is the whole batch's
while only one block's activations are alive. Adam is written out (torch's
defaults: betas 0.9 / 0.999, eps 1e-8, bias-corrected); the lr of an update
is the schedule at the number of updates applied before it (0 at the
first, as the reference's GradualWarmupScheduler).
"""

import math
from dataclasses import dataclass, field
from typing import Dict, List

import torch

from port_bench.reference.decode import codes_to_float, decode_sid

BETAS = (0.9, 0.999)
EPS = 1e-8
CHARBONNIER_EPS = 1e-3


def warmup_cosine(count: int, base_lr: float = 1e-4, warmup_epochs: int = 20,
                  total_epochs: int = 3000, eta_min: float = 1e-5,
                  steps_per_epoch: int = 1) -> float:
    """lr after ``count`` applied updates: linear 0 -> base_lr over the
    warmup epochs, then cosine to eta_min over ``total_epochs``."""
    epoch = float(count // steps_per_epoch)
    if epoch <= warmup_epochs:
        return base_lr * epoch / warmup_epochs
    t = min(epoch - warmup_epochs, float(total_epochs))
    return eta_min + (base_lr - eta_min) * 0.5 * (1.0 + math.cos(math.pi * t / total_epochs))


@dataclass
class AdamState:
    params: Dict[str, torch.Tensor]
    m: Dict[str, torch.Tensor] = field(default_factory=dict)
    v: Dict[str, torch.Tensor] = field(default_factory=dict)
    applied: int = 0


def adam_update(state: AdamState, grads: Dict[str, torch.Tensor], lr: float) -> None:
    t = state.applied + 1
    b1, b2 = BETAS
    with torch.no_grad():
        for name, p in state.params.items():
            g = grads[name]
            m = state.m.setdefault(name, torch.zeros_like(p))
            v = state.v.setdefault(name, torch.zeros_like(p))
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = (v / (1 - b2 ** t)).sqrt_().add_(EPS)
            p.sub_(lr * (m / (1 - b1 ** t)) / denom)
    state.applied = t


def train_step(model, state: AdamState, raw: torch.Tensor, ratio: torch.Tensor,
               gt: torch.Tensor, block_rows: int, schedule=warmup_cosine):
    """One step on the compact batch (raw uint16 [B, H, W, 1], ratio [B],
    gt uint16 [B, H, W, 3], on the model's device). Returns (loss, the
    gradients by name); the update is skipped when the loss or the global
    grad norm is not finite."""
    b = raw.shape[0]
    total = float(gt.numel())
    grads = {n: torch.zeros_like(p) for n, p in state.params.items()}
    loss = torch.zeros((), dtype=torch.float32, device=raw.device)
    for lo in range(0, b, block_rows):
        sl = slice(lo, lo + block_rows)
        for p in state.params.values():
            p.grad = None
        x = decode_sid(raw[sl, ..., 0], ratio[sl])
        target = codes_to_float(gt[sl]) / 65535.0
        pred = model(x).clamp(0.0, 1.0).permute(0, 2, 3, 1)
        d = pred - target
        part = torch.sqrt(d * d + CHARBONNIER_EPS ** 2).sum() / total
        part.backward()
        loss += part.detach()
        with torch.no_grad():
            for n, p in state.params.items():
                if p.grad is not None:
                    grads[n] += p.grad
    norm = torch.sqrt(sum(g.square().sum() for g in grads.values()))
    if bool(torch.isfinite(loss) & torch.isfinite(norm)):
        adam_update(state, grads, schedule(state.applied))
    for p in state.params.values():
        p.grad = None
    return loss, grads


def run_steps(model, batches: List[tuple], block_rows: int):
    """The reference's steps on ``batches`` from the model's weights as
    loaded: the losses, each leaf's norm of the first step's gradient and
    of the parameters' change over all the steps."""
    params = dict(model.named_parameters())
    start = {n: p.detach().clone() for n, p in params.items()}
    state = AdamState(params)
    losses, first = [], None
    for raw, ratio, gt in batches:
        loss, grads = train_step(model, state, raw, ratio, gt, block_rows)
        losses.append(float(loss))
        if first is None:
            first = {n: float(g.norm()) for n, g in grads.items()}
    change = {n: float((p.detach() - start[n]).norm()) for n, p in params.items()}
    return {"losses": losses, "grad_norms": first, "change_norms": change}
