"""Training of the registry's RAW -> RGB models on one GPU or over a mesh.

Port of ``bayer_low_light_image_enhancement_tpu/train/trainer.py``. One
train step: decode the batch, forward with fp32 parameters and bf16 compute
(the model config's ``dtype``), clamp the prediction to [0, 1], loss in
fp32, backward, optional global-norm clip, Adam. On the card
TransformerBlocks run the fused kernels forward (K2/K3) and backward
(B1/B2), and Mamba scans the scan kernels (S1 with states forward, S2
backward); ``fused_blocks=False`` sends both to their module / twin paths.
BatchNorm (WFB, WavKAN) runs in train mode in ``train_step`` and updates its
running stats also on a NaN-skipped batch, as in the JAX trainer;
``eval_step`` uses the running stats.

Over a mesh (``core/mesh.create_mesh``; one process per rank) the trainer
computes what the JAX trainer computes over its ``data`` x ``tensor`` mesh:

* the parameters are broadcast from rank 0; with ``tensor`` > 1 the
  transformer blocks are sharded Megatron-style (``parallel/tensor.py``);
* with ``data`` > 1 the model runs inside ``DistributedDataParallel`` over
  the data group (the gradient all-reduce, grads averaged), each rank on its
  rows of the global batch (``shard_batch``), and every BatchNorm takes the
  global batch's statistics (``ops/rep_conv.set_batchnorm_group``); the
  kernels keep running on this path;
* the reported loss is the global batch's mean; the global grad norm (clip
  and NaN guard) counts each parameter element once: a sharded leaf's squares
  are summed over the tensor group, a replicated leaf counted once; the NaN
  guard so decides once, the same on every rank (one host sync a step, as on
  one card);
* ``eval_step`` returns the global batch's predictions and PSNRs;
* ``state_dict`` is the unsharded single-device state (shards gathered), so
  a checkpoint resumes under any layout and loads into ``Predictor``.

Batches are channels-last like the JAX package's: input [B, H, W, 1]
mosaic, target [B, H, W, 3]; the model itself is NCHW.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.utils.checkpoint

from bayer_low_light_image_enhancement_tpu_torch.core import mesh as meshlib
from bayer_low_light_image_enhancement_tpu_torch.data.synthetic import BLACK_LEVEL, WHITE_LEVEL
from bayer_low_light_image_enhancement_tpu_torch.models.common import (
    reset_parameters_,
    set_fused_blocks,
)
from bayer_low_light_image_enhancement_tpu_torch.ops.rep_conv import set_batchnorm_group
from bayer_low_light_image_enhancement_tpu_torch.train.losses import get_loss
from bayer_low_light_image_enhancement_tpu_torch.train.metrics import psnr_uint8
from bayer_low_light_image_enhancement_tpu_torch.train.schedule import warmup_cosine_schedule
from bayer_low_light_image_enhancement_tpu_torch.utils.profiling import span


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


def global_norm(tensors: Sequence[torch.Tensor], sharded: Sequence[torch.Tensor] = (),
                group=None) -> torch.Tensor:
    """sqrt of the sum of squares over all tensors (fp32). Under tensor
    parallelism ``tensors`` are the replicated leaves (counted once) and
    ``sharded`` this rank's shards, whose squares are summed over ``group``:
    every element of the unsharded parameters counts once."""
    tensors, sharded = list(tensors), list(sharded)
    if group is None:
        return torch.linalg.vector_norm(
            torch.stack(torch._foreach_norm([t.float() for t in tensors + sharded])))
    zero = torch.zeros((), device=(tensors + sharded)[0].device)

    def squares(ts):
        return sum((t.float().square().sum() for t in ts), zero)

    part = squares(sharded)
    dist.all_reduce(part, group=group)
    return torch.sqrt(squares(tensors) + part)


def clip_by_global_norm_(tensors: Sequence[torch.Tensor], max_norm: float,
                         norm: torch.Tensor) -> None:
    """optax.clip_by_global_norm: leave the tensors unchanged when their
    global norm is below ``max_norm``, else scale them by max_norm / norm."""
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_(list(tensors), scale)


class _Forward(nn.Module):
    """The model on an NCHW batch, recomputed in backward when ``remat``:
    the module ``DistributedDataParallel`` wraps, so that a recompute runs
    inside its forward."""

    def __init__(self, model: nn.Module, remat: bool):
        super().__init__()
        self.model = model
        self.remat = remat

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.remat:
            return torch.utils.checkpoint.checkpoint(self.model, x, use_reentrant=False)
        return self.model(x)


class Trainer:
    """Owns the optimizer and the step counts of one model on one device, or
    of this rank's part of it over ``mesh`` (see the module doc).

    ``step`` counts train_step calls; ``applied`` counts the updates that
    were applied (a NaN-skipped batch advances only ``step``). The lr of the
    next update is ``schedule(applied)``."""

    def __init__(self, model: nn.Module, cfg: TrainConfig = TrainConfig(), mesh=None,
                 loss_fn: Optional[Callable] = None):
        self.model = model
        self.cfg = cfg
        self.mesh = mesh
        self.loss_fn = loss_fn or get_loss(cfg.loss)
        self.schedule = warmup_cosine_schedule(cfg.base_lr, cfg.warmup_epochs, cfg.total_epochs,
                                               cfg.eta_min, cfg.steps_per_epoch)
        set_fused_blocks(model, cfg.fused_blocks)
        self.has_batchnorm = any(isinstance(m, nn.modules.batchnorm._BatchNorm)
                                 for m in model.modules())
        self.data_size = meshlib.axis_size(mesh, meshlib.AXES.data)
        self.data_rank = meshlib.axis_rank(mesh, meshlib.AXES.data)
        self.data_group = meshlib.data_group(mesh)
        self.layout = None  # parallel.tensor.TensorLayout under tensor parallelism
        self._sharded = set()
        if mesh is not None:
            meshlib.broadcast_module_(model)
            group = meshlib.tensor_group(mesh)
            if group is not None:
                from bayer_low_light_image_enhancement_tpu_torch.parallel.tensor import shard_model

                self.layout = shard_model(model, group)
                self._sharded = {id(p) for n, p in model.named_parameters()
                                 if n in self.layout.specs}
                if self.layout.replicated and meshlib.rank() == 0:
                    print(f"tensor={self.layout.tp}: blocks kept replicated (heads or hidden "
                          f"width not divisible): {', '.join(self.layout.replicated)}")
            set_batchnorm_group(model, self.data_group)
        self._net = _Forward(model, cfg.remat and not self.has_batchnorm)
        self._run = self._net
        if self.data_group is not None:
            self._run = nn.parallel.DistributedDataParallel(
                self._net, process_group=self.data_group)
        self.optimizer = make_optimizer(model.parameters(), cfg)
        self.step = 0
        self.applied = 0

    def init(self, generator: Optional[torch.Generator] = None) -> "Trainer":
        """Re-initialise the parameters (torch's conv init from ``generator``)
        and reset the optimizer and the step counts. Under a mesh every rank
        then takes rank 0's parameters; a tensor-sharded model cannot be
        re-initialised (initialise the model before the Trainer)."""
        if self.layout is not None:
            raise ValueError("Trainer.init: the model is sharded over the tensor axis; "
                             "initialise it before building the Trainer")
        reset_parameters_(self.model, generator or torch.Generator().manual_seed(0))
        if self.mesh is not None:
            meshlib.broadcast_module_(self.model)
        self.optimizer = make_optimizer(self.model.parameters(), self.cfg)
        self.step = self.applied = 0
        return self

    @property
    def lr(self) -> float:
        """The lr of the next applied update."""
        return self.schedule(self.applied)

    def shard_batch(self, batch: Sequence) -> tuple:
        """This rank's rows of a global batch (arrays or tensors): rows
        [r B / n, (r + 1) B / n) for data rank r of n, the same on every
        tensor rank; the batch itself without a data axis."""
        if self.data_size == 1:
            return tuple(batch)
        lo, hi = meshlib.row_range(len(batch[0]), self.data_rank, self.data_size)
        return tuple(a[lo:hi] for a in batch)

    def _forward(self, inp: torch.Tensor, run=None) -> torch.Tensor:
        pred = (self._net if run is None else run)(inp.permute(0, 3, 1, 2))
        return pred.permute(0, 2, 3, 1)

    def _grad_norm(self, params_grads) -> torch.Tensor:
        if self.layout is None:
            return global_norm([g for _, g in params_grads])
        return global_norm([g for p, g in params_grads if id(p) not in self._sharded],
                           [g for p, g in params_grads if id(p) in self._sharded],
                           self.layout.group)

    def train_step(self, batch: Sequence[torch.Tensor]) -> torch.Tensor:
        """One step on a batch already on the model's device (this rank's
        rows under a mesh); returns the loss (0-dim fp32 tensor; the global
        batch's mean under a mesh).

        Its phases are ``utils.profiling.span`` ranges under
        ``lle.trainer.step``: decode, forward (zero_grad, forward, clamp,
        loss), backward, guard (the loss's all-reduce, the global norm and
        the NaN guard's blocking read; only where the guard or the clip
        runs) and update (clip, lr, Adam)."""
        with span("lle.trainer.step"):
            with span("lle.trainer.decode"):
                inp, gt = decode_batch(batch)
            with span("lle.trainer.forward"):
                self.model.train()
                self.optimizer.zero_grad(set_to_none=True)
                # the reference clamps before the loss
                pred = self._forward(inp, self._run).clamp(0.0, 1.0)
                loss = self.loss_fn(pred, gt)
            with span("lle.trainer.backward"):
                loss.backward()
            loss = loss.detach()
            pg = [(p, p.grad) for p in self.model.parameters() if p.grad is not None]
            ok = True
            guarded = self.cfg.nan_guard or self.cfg.grad_clip is not None
            with span("lle.trainer.guard") if guarded else contextlib.nullcontext():
                if self.data_group is not None:
                    dist.all_reduce(loss, group=self.data_group)
                    loss = loss / self.data_size
                if guarded:
                    norm = self._grad_norm(pg)
                if self.cfg.nan_guard:
                    ok = bool(torch.isfinite(loss) & torch.isfinite(norm))
            if ok:
                with span("lle.trainer.update"):
                    if self.cfg.grad_clip is not None:
                        clip_by_global_norm_([g for _, g in pg], self.cfg.grad_clip, norm)
                    for group in self.optimizer.param_groups:
                        group["lr"] = self.lr
                    self.optimizer.step()
                self.applied += 1
            self.step += 1
            return loss

    @torch.inference_mode()
    def eval_step(self, batch: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
        """(inp, gt, ...) -> (pred clamped to [0, 1], per-image PSNR on the
        uint8 grid [B]). Runs under inference mode (the K2/K3 and S1 path),
        BatchNorm on its running stats. Under a mesh ``batch`` is this rank's
        rows (any count, zero included) and the result is the global batch's,
        on every rank."""
        inp, gt = batch[0].float(), batch[1].float()
        self.model.eval()
        if len(inp):
            pred = self._forward(inp).float().clamp(0.0, 1.0)
            psnr = torch.stack([psnr_uint8(p, g) for p, g in zip(pred, gt)])
        else:
            pred = inp.new_zeros((0, *inp.shape[1:3], 3))
            psnr = inp.new_zeros((0,))
        return meshlib.gather_rows(pred, self.data_group), meshlib.gather_rows(psnr, self.data_group)

    def state_dict(self) -> dict:
        """The single-device state: under tensor parallelism the shards of the
        parameters and of Adam's moments are gathered (a collective: every
        rank of the mesh calls it)."""
        model, opt = self.model.state_dict(), self.optimizer.state_dict()
        if self.layout is not None:
            from bayer_low_light_image_enhancement_tpu_torch.parallel.tensor import gather_state

            model = gather_state(model, self.layout)
            opt = self._optimizer_state(opt, gather_state)
        return {"model": model, "optimizer": opt, "step": self.step, "applied": self.applied}

    def load_state_dict(self, state: dict) -> None:
        """Load a single-device state (any layout's checkpoint); under tensor
        parallelism this rank takes its shards."""
        model, opt = state["model"], state["optimizer"]
        if self.layout is not None:
            from bayer_low_light_image_enhancement_tpu_torch.parallel.tensor import shard_state

            model = shard_state(model, self.layout)
            opt = self._optimizer_state(opt, shard_state)
        self.model.load_state_dict(model)
        self.optimizer.load_state_dict(opt)
        self.step, self.applied = int(state["step"]), int(state["applied"])

    def _optimizer_state(self, opt: dict, convert) -> dict:
        """Adam's state with each sharded parameter's moments passed through
        ``convert`` (gather_state or shard_state) under the parameter's name."""
        names = [n for n, _ in self.model.named_parameters()]
        state = {}
        for i, st in opt["state"].items():
            name = names[int(i)]
            state[i] = {k: (convert({name: v}, self.layout)[name] if k != "step" else v)
                        for k, v in st.items()}
        return {**opt, "state": state}
