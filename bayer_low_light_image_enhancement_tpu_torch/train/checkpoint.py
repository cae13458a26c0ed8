"""Checkpointing with ``torch.save`` and best-PSNR tracking.

Port of ``bayer_low_light_image_enhancement_tpu/train/checkpoint.py``
(orbax there): ``model_best`` on PSNR improvement and periodic snapshots,
keyed by epoch; a restore brings back params, the Adam moments AND the step
counts (the reference's resume drops the optimizer moments; both packages
keep them). Each checkpoint is one file ``<directory>/<step>.pt``, written
to a temporary name and renamed, so a crash never leaves a torn file.
Saves are synchronous; ``wait`` exists for the JAX package's interface.
In a multi-process run (``core/mesh.py``) global rank 0 alone writes;
every rank may restore.
The port reads no orbax checkpoint of the JAX package; the converter
``tools/orbax_to_torch.py`` (run where JAX is installed) writes one in this
layout.
"""

from __future__ import annotations

import json
import math
import os
import re
from typing import Any, List, Optional, Tuple

import torch

from bayer_low_light_image_enhancement_tpu_torch.core.mesh import rank

_NAME = re.compile(r"^(\d+)\.pt$")


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: Optional[int] = None):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"{step}.pt")

    def all_steps(self) -> List[int]:
        return sorted(int(m.group(1)) for m in map(_NAME.match, os.listdir(self.directory)) if m)

    def save(self, step: int, state: Any, metrics: Optional[dict] = None) -> None:
        """Write ``state`` (tensors are stored as they are; pass CPU or CUDA
        ones) as checkpoint ``step``; a step saved already is kept. Only
        global rank 0 writes (a no-op on the other ranks)."""
        if rank() != 0 or step in self.all_steps():
            return  # already saved this epoch (e.g. best + periodic coincide)
        path = self._path(step)
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save({"state": state, "metrics": metrics or {}}, tmp)
        os.replace(tmp, path)
        if metrics:
            clean = {k: (None if isinstance(v, float) and not math.isfinite(v) else v)
                     for k, v in metrics.items()}
            with open(os.path.join(self.directory, f"{step}.json"), "w") as f:
                json.dump(clean, f)
        if self.max_to_keep is not None:
            for old in self.all_steps()[: -self.max_to_keep]:
                os.remove(self._path(old))
                if os.path.exists(os.path.join(self.directory, f"{old}.json")):
                    os.remove(os.path.join(self.directory, f"{old}.json"))

    def restore(self, step: Optional[int] = None,
                map_location: Any = None) -> Tuple[Optional[Any], Optional[int]]:
        """-> (state, step) of checkpoint ``step`` (the latest by default), or
        (None, None) when there is none."""
        if step is None:
            step = self.latest_step()
        if step is None:
            return None, None
        blob = torch.load(self._path(step), map_location=map_location, weights_only=False)
        return blob["state"], step

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def wait(self) -> None:
        """Saves are synchronous: nothing to wait for."""


class BestTracker:
    """Tracks the best validation PSNR and its epoch."""

    def __init__(self):
        self.best_psnr = -math.inf
        self.best_epoch = -1

    def update(self, epoch: int, psnr: float) -> bool:
        if psnr > self.best_psnr:
            self.best_psnr = float(psnr)
            self.best_epoch = int(epoch)
            return True
        return False
