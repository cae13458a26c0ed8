"""Learning-rate schedule: linear warmup -> cosine decay, per epoch.

Port of ``bayer_low_light_image_enhancement_tpu/train/schedule.py``: the
lr ramps linearly 0 -> ``base_lr`` over ``warmup_epochs`` (epoch 0 trains
at lr 0, as the reference's GradualWarmupScheduler does), then follows
cosine annealing to ``eta_min`` with period ``total_epochs``. The argument
is the number of optimizer updates applied so far (a skipped NaN batch does
not advance it); ``steps_per_epoch`` makes the lr a staircase in it.
"""

from __future__ import annotations

import math
from typing import Callable


def warmup_cosine_schedule(
    base_lr: float = 1e-4,
    warmup_epochs: int = 20,
    total_epochs: int = 3000,
    eta_min: float = 1e-5,
    steps_per_epoch: int = 1,
) -> Callable[[int], float]:
    # The JAX schedule divides 0 by 0 at epoch 0 when warmup_epochs is 0 and
    # returns NaN (ROADMAP queue C); refuse that configuration instead.
    if warmup_epochs < 1:
        raise ValueError(f"warmup_epochs must be >= 1, got {warmup_epochs}")

    def schedule(count: int) -> float:
        epoch = float(int(count) // steps_per_epoch)
        if epoch <= warmup_epochs:
            return base_lr * epoch / warmup_epochs
        t = min(epoch - warmup_epochs, float(total_epochs))
        return eta_min + (base_lr - eta_min) * 0.5 * (1.0 + math.cos(math.pi * t / total_epochs))

    return schedule
