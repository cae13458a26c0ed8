"""Metrics logging: one interface for the reference's sinks.

Port of ``bayer_low_light_image_enhancement_tpu/utils/logging.py``:
  * an append-mode text log with the reference's epoch line format;
  * TensorBoard scalars through ``torch.utils.tensorboard`` when it imports
    (it needs the ``tensorboard`` package); otherwise a warning, once, and
    the text log goes on.
  * the evaluation CLI's per-image PSNR/SSIM CSV (``write_metrics_csv``).

In a multi-process run (``core/mesh.py``) only global rank 0 opens the
text log and TensorBoard; on the other ranks the logger writes nothing.
"""

from __future__ import annotations

import datetime
import os
import warnings
from typing import Dict, Optional, Sequence

from bayer_low_light_image_enhancement_tpu_torch.core.mesh import rank


class MetricsLogger:
    def __init__(self, log_file: Optional[str] = None, tensorboard_dir: Optional[str] = None):
        if rank() != 0:
            log_file = tensorboard_dir = None
        self._log_f = None
        if log_file:
            os.makedirs(os.path.dirname(os.path.abspath(log_file)), exist_ok=True)
            self._log_f = open(log_file, "a")
            self._log_f.write(f"\nTraining start time: {datetime.datetime.now().isoformat()}\n")
        self._tb = None
        if tensorboard_dir:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(tensorboard_dir)
            except ImportError:
                warnings.warn(
                    f"tensorboard_dir={tensorboard_dir!r} requested but torch.utils.tensorboard "
                    "is not importable; TensorBoard logging is disabled (text logging "
                    "unaffected).",
                    RuntimeWarning,
                    stacklevel=2,
                )

    def log_epoch(self, epoch: int, total_epochs: int, epoch_time: float, loss: float,
                  avg_psnr: float, best_psnr: float, best_epoch: int) -> None:
        line = (
            f"Epoch {epoch}/{total_epochs} | Time: {epoch_time:.2f}s | "
            f"Loss: {loss:.4f} | Avg PSNR: {avg_psnr:.4f} | "
            f"Best PSNR: {best_psnr:.4f} (Epoch {best_epoch})\n"
        )
        if self._log_f:
            self._log_f.write(line)
            self._log_f.flush()

    def log_scalars(self, step: int, scalars: Dict[str, float]) -> None:
        if self._tb is not None:
            for name, value in scalars.items():
                self._tb.add_scalar(name, float(value), step)
            self._tb.flush()

    def write_metrics_csv(self, path: str, psnr_values: Sequence[float],
                          ssim_values: Sequence[float]) -> None:
        """One ``psnr,ssim`` row per image (4 decimals); makes the directory."""
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            for p, s in zip(psnr_values, ssim_values):
                f.write(f"{p:.4f},{s:.4f}\n")

    def close(self) -> None:
        if self._log_f:
            self._log_f.write(f"Training finished at: {datetime.datetime.now().isoformat()}\n")
            self._log_f.close()
            self._log_f = None
        if self._tb is not None:
            self._tb.close()
            self._tb = None
