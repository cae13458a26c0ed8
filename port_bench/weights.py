"""Seeded weights, made on the device in one draw and handed by name to
both the port and the reference.

One ``torch.rand`` of every parameter's elements on a generator seeded
from ``--seed`` (on the run's device), then each leaf is a slice mapped to
its range:

* a weight of two dimensions or more: U(+-gain / sqrt(fan_in)), fan_in the
  elements of one output channel (torch's convention), ``gain`` from the
  configuration (sqrt(3) keeps the activations' variance through a layer);
* any other leaf: U(lo, hi) from the configuration's ``ranges``, the first
  name suffix that matches, else ``default_range``.

The same seed gives the same weights on the same kind of device.
"""

from typing import Dict, Iterable, Tuple

import torch

SEED_MASK = (1 << 63) - 1


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed) & SEED_MASK)


def make_weights(shapes: Iterable[Tuple[str, torch.Size]], seed: int, device, init: dict,
                 salt: int = 0) -> Dict[str, torch.Tensor]:
    """name -> fp32 tensor on ``device`` for each (name, shape)."""
    shapes = list(shapes)
    total = sum(int(torch.Size(s).numel()) for _, s in shapes)
    flat = torch.rand(total, generator=generator(seed * 7919 + salt, device), device=device)
    flat = flat.mul_(2.0).sub_(1.0)  # U(-1, 1)
    gain = float(init.get("gain", 1.0))
    ranges = init.get("ranges", {})
    default = init.get("default_range", [-0.1, 0.1])
    out, at = {}, 0
    for name, shape in shapes:
        n = int(torch.Size(shape).numel())
        u = flat[at:at + n].view(shape)
        at += n
        if len(shape) >= 2:
            fan_in = n // shape[0]
            out[name] = u * (gain / fan_in ** 0.5)
            continue
        lo, hi = next((r for suffix, r in ranges.items() if name.endswith(suffix)), default)
        out[name] = u * ((hi - lo) / 2.0) + (hi + lo) / 2.0
    return out
