"""Training: losses, the lr schedule, metrics, the Trainer and checkpoints."""

from bayer_low_light_image_enhancement_tpu_torch.train.checkpoint import (
    BestTracker,
    CheckpointManager,
)
from bayer_low_light_image_enhancement_tpu_torch.train.losses import (
    charbonnier_loss,
    get_loss,
    l1_loss,
)
from bayer_low_light_image_enhancement_tpu_torch.train.metrics import psnr, ssim
from bayer_low_light_image_enhancement_tpu_torch.train.schedule import warmup_cosine_schedule
from bayer_low_light_image_enhancement_tpu_torch.train.trainer import TrainConfig, Trainer

__all__ = [
    "BestTracker",
    "CheckpointManager",
    "TrainConfig",
    "Trainer",
    "charbonnier_loss",
    "get_loss",
    "l1_loss",
    "psnr",
    "ssim",
    "warmup_cosine_schedule",
]
