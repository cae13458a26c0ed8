"""Ranks of the port's multi-process tests (no JAX: a rank imports only
torch and the port).

A test writes a job file (``write_job``) and starts ``world`` processes of
this script on it (``run_job``): each joins a gloo group through a
``file://`` rendezvous beside the job, builds the job's mesh and model,
loads the job's weights, and trains or evaluates on its rows of the job's
global batches; each rank writes its result to ``<job>.rank<r>.pt``, which
``run_job`` returns.

Jobs (``kind``):
  * "train": ``Trainer(model, cfg, mesh)`` steps on ``shard_batch`` of each
    batch; the result holds the reported losses, the first step's grads
    (this rank's, as they are), ``applied``, the state after the steps
    (``Trainer.state_dict``: unsharded) and ``eval_step`` of the last batch;
    with ``resume``, that single-device state loaded into the trainer and
    one more step on the last batch (``resumed``);
  * "forward": the model, sharded by ``Trainer`` over the mesh, on the whole
    first batch in eval mode (no grad);
  * "mesh": ``create_mesh`` over the world for each layout of the job,
    recording each mesh's shape and group sizes or the error.
"""

import sys
from pathlib import Path

REPO = str(Path(__file__).resolve().parent.parent)
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import torch  # noqa: E402
import torch.nn as nn  # noqa: E402

from bayer_low_light_image_enhancement_tpu_torch.core import mesh as meshlib  # noqa: E402
from bayer_low_light_image_enhancement_tpu_torch.models.common import Conv2d  # noqa: E402
from bayer_low_light_image_enhancement_tpu_torch.ops.rep_conv import GatedFeedForward  # noqa: E402


class BNNet(nn.Module):
    """A small BatchNorm model: 3x3 conv -> the WFB gated FFN (two
    train-mode BatchNorms) -> 3x3 conv to RGB. Names follow the JAX
    twin in tests/test_torch_ddp.py (``embed``, ``ffn``, ``out``)."""

    def __init__(self, dim: int = 6):
        super().__init__()
        self.embed = Conv2d(1, dim, 3)
        self.ffn = GatedFeedForward(dim)
        self.out = Conv2d(dim, 3, 3)

    def forward(self, x):
        return self.out(self.ffn(self.embed(x)))


def build_model(spec):
    """("rawformer" | "wfb" | "bnnet", config kwargs) -> the port model."""
    kind, kw = spec
    if kind == "rawformer":
        from bayer_low_light_image_enhancement_tpu_torch.models import RawFormer, RawFormerConfig

        return RawFormer(RawFormerConfig(**kw))
    if kind == "wfb":
        from bayer_low_light_image_enhancement_tpu_torch.models import (
            RawFormerWFB,
            RawFormerWFBConfig,
        )

        return RawFormerWFB(RawFormerWFBConfig(**kw))
    if kind == "bnnet":
        return BNNet(**kw)
    raise ValueError(kind)


def write_job(path, **job):
    torch.save(job, path)
    return path


def run_job(path, world: int, timeout: float = 240.0):
    """Run ``world`` ranks of this script on job ``path`` -> their results."""
    path = Path(path)
    rdzv = path.with_suffix(".rdzv")
    rdzv.unlink(missing_ok=True)
    meshlib.run_ranks([sys.executable, __file__, str(path), f"file://{rdzv}"], world,
                      env={"OMP_NUM_THREADS": "1"}, timeout=timeout)
    return [torch.load(f"{path}.rank{r}.pt", weights_only=False) for r in range(world)]


def _train(job, mesh):
    from bayer_low_light_image_enhancement_tpu_torch.train import TrainConfig, Trainer

    model = build_model(job["model"])
    model.load_state_dict(job["state"])
    trainer = Trainer(model, TrainConfig(**job["cfg"]), mesh=mesh)
    out = {"losses": [], "rows": [], "replicated": trainer.layout and trainer.layout.replicated}
    for i, batch in enumerate(job["batches"]):
        local = trainer.shard_batch(batch)
        out["rows"].append(len(local[0]))
        out["losses"].append(float(trainer.train_step(local)))
        if i == 0:
            out["grads"] = {n: p.grad.clone() for n, p in model.named_parameters()
                            if p.grad is not None}
    out["applied"], out["step"] = trainer.applied, trainer.step
    out["local_state"] = {k: v.clone() for k, v in model.state_dict().items()}
    out["state"] = trainer.state_dict()
    if "resume" in job:  # load a single-device state, then one more step
        trainer.load_state_dict(job["resume"])
        trainer.train_step(trainer.shard_batch(job["batches"][-1]))
        out["resumed"] = trainer.state_dict()
    if job.get("eval", True):
        last = job["batches"][-1]
        out["eval"] = trainer.eval_step(trainer.shard_batch(last))
    return out


def _forward(job, mesh):
    from bayer_low_light_image_enhancement_tpu_torch.train import TrainConfig, Trainer

    model = build_model(job["model"])
    model.load_state_dict(job["state"])
    trainer = Trainer(model, TrainConfig(**job["cfg"]), mesh=mesh)
    model.eval()
    with torch.no_grad():
        y = model(job["batches"][0][0].permute(0, 3, 1, 2))
    return {"out": y.permute(0, 2, 3, 1).clone(),
            "replicated": trainer.layout and trainer.layout.replicated}


def _mesh(job):
    import torch.distributed as dist

    out = []
    for layout in job["layouts"]:
        try:
            m = meshlib.create_mesh(**layout)
        except ValueError as e:
            out.append(("error", str(e)))
            continue
        groups = {a: (dist.get_world_size(g) if (g := meshlib.axis_group(m, a)) else 1)
                  for a in meshlib.MESH_AXES}
        out.append(("mesh", tuple(m.mesh.shape), m.mesh_dim_names,
                    {a: meshlib.axis_rank(m, a) for a in meshlib.MESH_AXES}, groups,
                    m.mesh.flatten().tolist()))
    return out


def main(path, rendezvous):
    torch.set_num_threads(1)
    job = torch.load(path, weights_only=False)
    meshlib.initialize_multihost(rendezvous, device_type="cpu")
    rank = meshlib.rank()
    try:
        if job["kind"] == "mesh":
            out = _mesh(job)
        else:
            mesh = meshlib.create_mesh(**job["mesh"])
            out = (_train if job["kind"] == "train" else _forward)(job, mesh)
        torch.save(out, f"{path}.rank{rank}.pt")
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(*sys.argv[1:3])
