"""Single-GPU training of the registry's RAW -> RGB models.

Port of ``bayer_low_light_image_enhancement_tpu/train/trainer.py`` without
the device mesh (one card). One train step: decode the batch, forward with
fp32 parameters and bf16 compute (the model config's ``dtype``), clamp the
prediction to [0, 1], loss in fp32, backward, optional global-norm clip,
Adam. On the card TransformerBlocks run the fused kernels forward (K2/K3)
and backward (B1/B2), and Mamba scans the scan kernels (S1 with states
forward, S2 backward); ``fused_blocks=False`` sends both to their module /
twin paths. BatchNorm (WFB, WavKAN) runs in train mode in ``train_step`` and
updates its running stats also on a NaN-skipped batch, as in the JAX
trainer; ``eval_step`` uses the running stats.

Batches are channels-last like the JAX package's: input [B, H, W, 1]
mosaic, target [B, H, W, 3]; the model itself is NCHW.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.utils.checkpoint

from bayer_low_light_image_enhancement_tpu_torch.data.synthetic import BLACK_LEVEL, WHITE_LEVEL
from bayer_low_light_image_enhancement_tpu_torch.models.common import (
    reset_parameters_,
    set_fused_blocks,
)
from bayer_low_light_image_enhancement_tpu_torch.train.losses import get_loss
from bayer_low_light_image_enhancement_tpu_torch.train.metrics import psnr_uint8
from bayer_low_light_image_enhancement_tpu_torch.train.schedule import warmup_cosine_schedule


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    base_lr: float = 1e-4
    warmup_epochs: int = 20
    total_epochs: int = 3000
    eta_min: float = 1e-5
    steps_per_epoch: int = 1
    loss: str = "charbonnier"
    grad_clip: Optional[float] = None
    # Skip the update on a non-finite loss or grad (the reference's NaN-batch
    # skip): params, Adam moments and the applied-update count stay as they
    # were; only the reported loss comes from the bad batch.
    nan_guard: bool = True
    # Recompute the forward during backward (torch.utils.checkpoint). Ignored
    # for models with BatchNorm, as in the JAX trainer: a recomputed forward
    # would update the running stats twice.
    remat: bool = False
    # TransformerBlocks and Mamba scans through the kernels (K2/K3 + B1/B2,
    # S1 + S2 on the card; their twins on the CPU). False: the module path
    # and the scan twin.
    fused_blocks: bool = True


def _u16_to_f32(t: torch.Tensor) -> torch.Tensor:
    """uint16 codes (as uint16 or int16 bits) -> fp32 values 0..65535."""
    return (t.view(torch.int16).to(torch.int32) & 0xFFFF).to(torch.float32)


def decode_batch(batch: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Accept a decoded ``(inp_f32, gt_f32)`` pair or the compact triple
    ``(raw_u16 [B,p,p,1], ratio [B], gt_u16 [B,p,p,3])`` and return
    ``(inp, gt)`` in fp32, with the JAX package's expressions: clip the codes
    to [black, white], normalise, multiply by the ratio; GT / 65535."""
    if len(batch) == 2:
        return batch[0].float(), batch[1].float()
    raw16, ratio, gt16 = batch
    x = _u16_to_f32(raw16).clamp(BLACK_LEVEL, WHITE_LEVEL)
    scale = 1.0 / (WHITE_LEVEL - BLACK_LEVEL + 1e-6)
    inp = (x - BLACK_LEVEL) * scale * ratio.float()[:, None, None, None]
    return inp, _u16_to_f32(gt16) * (1.0 / 65535.0)


def make_optimizer(params, cfg: TrainConfig) -> torch.optim.Adam:
    """Adam with torch's defaults (betas 0.9 / 0.999, eps 1e-8), as the
    reference; the lr is set from the schedule before every update."""
    return torch.optim.Adam(params, lr=cfg.base_lr, betas=(0.9, 0.999), eps=1e-8)


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over all tensors (fp32)."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm([t.float() for t in tensors])))


def clip_by_global_norm_(tensors: Sequence[torch.Tensor], max_norm: float,
                         norm: torch.Tensor) -> None:
    """optax.clip_by_global_norm: leave the tensors unchanged when their
    global norm is below ``max_norm``, else scale them by max_norm / norm."""
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_(list(tensors), scale)


class Trainer:
    """Owns the optimizer and the step counts of one model on one device.

    ``step`` counts train_step calls; ``applied`` counts the updates that
    were applied (a NaN-skipped batch advances only ``step``). The lr of the
    next update is ``schedule(applied)``."""

    def __init__(self, model: nn.Module, cfg: TrainConfig = TrainConfig(),
                 loss_fn: Optional[Callable] = None):
        self.model = model
        self.cfg = cfg
        self.loss_fn = loss_fn or get_loss(cfg.loss)
        self.schedule = warmup_cosine_schedule(cfg.base_lr, cfg.warmup_epochs, cfg.total_epochs,
                                               cfg.eta_min, cfg.steps_per_epoch)
        set_fused_blocks(model, cfg.fused_blocks)
        self.has_batchnorm = any(isinstance(m, nn.modules.batchnorm._BatchNorm)
                                 for m in model.modules())
        self.optimizer = make_optimizer(model.parameters(), cfg)
        self.step = 0
        self.applied = 0

    def init(self, generator: Optional[torch.Generator] = None) -> "Trainer":
        """Re-initialise the parameters (torch's conv init from ``generator``)
        and reset the optimizer and the step counts."""
        reset_parameters_(self.model, generator or torch.Generator().manual_seed(0))
        self.optimizer = make_optimizer(self.model.parameters(), self.cfg)
        self.step = self.applied = 0
        return self

    @property
    def lr(self) -> float:
        """The lr of the next applied update."""
        return self.schedule(self.applied)

    def _forward(self, inp: torch.Tensor) -> torch.Tensor:
        x = inp.permute(0, 3, 1, 2)
        if self.cfg.remat and not self.has_batchnorm:
            pred = torch.utils.checkpoint.checkpoint(self.model, x, use_reentrant=False)
        else:
            pred = self.model(x)
        return pred.permute(0, 2, 3, 1)

    def train_step(self, batch: Sequence[torch.Tensor]) -> torch.Tensor:
        """One step on a batch already on the model's device; returns the
        loss (0-dim fp32 tensor)."""
        inp, gt = decode_batch(batch)
        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        pred = self._forward(inp).clamp(0.0, 1.0)  # the reference clamps before the loss
        loss = self.loss_fn(pred, gt)
        loss.backward()
        grads = [p.grad for p in self.model.parameters() if p.grad is not None]
        ok = True
        if self.cfg.nan_guard or self.cfg.grad_clip is not None:
            norm = global_norm(grads)
        if self.cfg.nan_guard:
            ok = bool(torch.isfinite(loss) & torch.isfinite(norm))
        if ok:
            if self.cfg.grad_clip is not None:
                clip_by_global_norm_(grads, self.cfg.grad_clip, norm)
            for group in self.optimizer.param_groups:
                group["lr"] = self.lr
            self.optimizer.step()
            self.applied += 1
        self.step += 1
        return loss.detach()

    @torch.inference_mode()
    def eval_step(self, batch: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
        """(inp, gt, ...) -> (pred clamped to [0, 1], per-image PSNR on the
        uint8 grid [B]). Runs under inference mode (the K2/K3 and S1 path),
        BatchNorm on its running stats."""
        inp, gt = batch[0].float(), batch[1].float()
        self.model.eval()
        pred = self._forward(inp).float().clamp(0.0, 1.0)
        return pred, torch.stack([psnr_uint8(p, g) for p, g in zip(pred, gt)])

    def state_dict(self) -> dict:
        return {"model": self.model.state_dict(), "optimizer": self.optimizer.state_dict(),
                "step": self.step, "applied": self.applied}

    def load_state_dict(self, state: dict) -> None:
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.step, self.applied = int(state["step"]), int(state["applied"])
