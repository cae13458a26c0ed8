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
    recording each mesh's shape and group sizes or the error;
  * "tiled_ops": each case of the job (an op of ``ops/conv.py``,
    ``ops/attention.py`` or ``ops/ssm.py``, or ``parallel/tiled.shard_image``)
    on this rank's block of its inputs, over the spatial axes of the case's
    layout ("h": ``spatial`` = world; "hw": ``spatial`` x ``spatial_w`` =
    2 x world / 2); the result is the list of this rank's outputs;
  * "tiled": each case's model (``build_model`` with the case's
    ``spatial_axis``) holding the case's state, through
    ``parallel/tiled.make_tiled_forward`` on this rank's block of the case's
    frame: the whole output every rank receives (and of a model with a
    ``conv_out``, that conv's whole output, the head's input), and how
    often the fused block wrapper and the scan kernel wrapper were called
    (0 by design);
  * "tiled_zoo": a "tiled" job's cases (``models``) and, beside them, the
    cases of a "tiled_ops" job (``ops``), in one spawn.
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
    """("rawformer" | "wfb" | "bnnet" | a registry name, config kwargs) ->
    the port model."""
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
    from bayer_low_light_image_enhancement_tpu_torch.models import get_model

    return get_model(kind, **kw)


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


LAYOUTS = {"h": ("spatial", None), "hw": ("spatial", "spatial_w")}


def tiled_mesh(layout):
    """The (1, spatial, spatial_w, 1) mesh of a tiled case's layout over the
    world, and its (h, w) axis names."""
    world = meshlib.world_size()
    h, w = LAYOUTS[layout]
    mesh = (meshlib.create_mesh(data=1, spatial=world) if w is None
            else meshlib.create_mesh(data=1, spatial=2, spatial_w=world // 2))
    return mesh, h, w


def _tiled_op(case, cache):
    from bayer_low_light_image_enhancement_tpu_torch.ops import attention, conv, ssm
    from bayer_low_light_image_enhancement_tpu_torch.parallel.tiled import shard_image

    layout = case.get("layout", "h")
    if layout not in cache:
        cache[layout] = tiled_mesh(layout)
    mesh, h, w = cache[layout]
    axes = (meshlib.bind_axis(mesh, h), meshlib.bind_axis(mesh, w))
    spec = axes if w else axes[0]
    a = {k: torch.from_numpy(v) if hasattr(v, "shape") else v for k, v in case["args"].items()}

    def local(t):
        return shard_image(t, mesh, h, w).contiguous()

    op = case["op"]
    if op == "conv2d":
        return conv.conv2d(local(a["x"]), a["w"], a.get("b"), stride=a.get("stride", 1),
                           groups=a.get("groups", 1), dilation=a.get("dilation", 1),
                           spatial_axis=spec)
    if op in ("global_mean", "global_max", "global_min"):
        xl = local(a["x"])  # the reduction broadcast back to the block
        return getattr(conv, op)(xl, a["dims"], spec).expand_as(xl).contiguous()
    if op == "channel_attention":
        attention.ROW_SUM_TOKENS = a.get("row_sum_tokens", attention.ROW_SUM_TOKENS)
        return attention.channel_attention(local(a["q"]), local(a["k"]), local(a["v"]),
                                           a["temperature"], a["heads"], spec)
    if op == "selective_scan":
        return ssm.selective_scan(local(a["u"]), local(a["delta"]), a["A"], local(a["B"]),
                                  local(a["C"]), a["D"], chunk_size=a["chunk_size"],
                                  axis_name=axes[0])
    if op == "mamba":
        block = ssm.MambaBlock(a["d_model"], d_state=a["d_state"])
        block.load_state_dict(a["state"])
        block.axis_name = axes[0]
        with torch.no_grad():
            return block(local(a["x"]))
    if op == "module":  # Downsample / Upsample2x, bound like a tiled model's
        from bayer_low_light_image_enhancement_tpu_torch.models import common

        m = (common.Downsample(a["cin"]) if a["kind"] == "downsample"
             else common.Upsample2x(a["cin"], a["cout"]))
        m.load_state_dict(a["state"])
        common.bind_spatial(m, spec)
        with torch.no_grad():
            y = m(local(a["x"]).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last))
        return y.permute(0, 2, 3, 1).contiguous()
    if op == "resize_bilinear":  # to the whole frame's (h, w), this rank's block
        from bayer_low_light_image_enhancement_tpu_torch.ops.flca import resize_bilinear

        sizes = [ax.size if ax else 1 for ax in axes]
        return resize_bilinear(local(a["x"]), a["h"] // sizes[0], a["w"] // sizes[1], spec)
    if op == "bayer_luma_chroma":
        from bayer_low_light_image_enhancement_tpu_torch.ops.luma import bayer_luma_chroma

        return torch.cat(bayer_luma_chroma(local(a["x"]), spatial_axis=spec), -1)
    if op in ("instance_norm", "frequency_split", "token_transformer"):  # NCHW modules
        xl = local(a["x"]).permute(0, 3, 1, 2)
        if op == "instance_norm":
            from bayer_low_light_image_enhancement_tpu_torch.models.lumachroma_transformer import (
                instance_norm,
            )

            y = instance_norm(xl, spatial_axis=spec)
        elif op == "frequency_split":
            from bayer_low_light_image_enhancement_tpu_torch.ops.flca import frequency_split

            y = torch.cat(frequency_split(xl, a["k"], spec), 1)
        else:
            from bayer_low_light_image_enhancement_tpu_torch.models import common, luma_variants

            m = luma_variants.TokenTransformer(a["dim"], a["heads"])
            m.load_state_dict(a["state"])
            common.bind_spatial(m, spec)
            with torch.no_grad():
                y = m(xl)
        return y.permute(0, 2, 3, 1).contiguous()
    if op in ("haar_dwt_stack", "haar_iwt_stack"):
        from bayer_low_light_image_enhancement_tpu_torch.ops import dwt

        return getattr(dwt, op)(local(a["x"]))
    if op == "gather_spatial":
        return conv.gather_spatial(local(a["x"]), spec, 1)
    if op == "shard_image":
        return local(a["x"])
    raise ValueError(op)


def _tiled(job):
    from bayer_low_light_image_enhancement_tpu_torch.kernels import ssm_scan
    from bayer_low_light_image_enhancement_tpu_torch.models import common
    from bayer_low_light_image_enhancement_tpu_torch.ops.conv import gather_axis
    from bayer_low_light_image_enhancement_tpu_torch.parallel.tiled import (
        make_tiled_forward,
        shard_image,
    )

    calls = {"fused_block": 0, "ssm_kernel": 0}

    def counting(name, fn):
        def wrapper(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)
        return wrapper

    common.fused_transformer_block = counting("fused_block", common.fused_transformer_block)
    ssm_scan.selective_scan = counting("ssm_kernel", ssm_scan.selective_scan)
    out, meshes = [], {}
    for case in job["cases"]:
        if case["layout"] not in meshes:
            meshes[case["layout"]] = tiled_mesh(case["layout"])
        mesh, h, w = meshes[case["layout"]]
        kind, kw = case["model"]
        model = build_model((kind, dict(kw, spatial_axis=(h, w) if w else h)))
        model.load_state_dict(case["state"])
        fn = make_tiled_forward(model, mesh, h, w)
        heads = []
        if hasattr(model, "conv_out"):
            model.conv_out.register_forward_hook(lambda m, i, o: heads.append(
                gather_axis(gather_axis(o, fn.axes[0], 2), fn.axes[1], 3)))
        for k in calls:
            calls[k] = 0
        y = fn(torch.from_numpy(shard_image(case["x"], mesh, h, w)))
        out.append({"out": y.clone(), "calls": dict(calls)})
        if heads:
            out[-1]["head"] = heads[0].permute(0, 2, 3, 1).contiguous()
    return out


def main(path, rendezvous):
    torch.set_num_threads(1)
    job = torch.load(path, weights_only=False)
    meshlib.initialize_multihost(rendezvous, device_type="cpu")
    rank = meshlib.rank()
    try:
        if job["kind"] == "mesh":
            out = _mesh(job)
        elif job["kind"] == "tiled_ops":
            cache = {}
            out = [_tiled_op(case, cache) for case in job["cases"]]
        elif job["kind"] == "tiled":
            out = _tiled(job)
        elif job["kind"] == "tiled_zoo":
            cache = {}
            out = {"models": _tiled(job), "ops": [_tiled_op(c, cache) for c in job["ops"]]}
        else:
            mesh = meshlib.create_mesh(**job["mesh"])
            out = (_train if job["kind"] == "train" else _forward)(job, mesh)
        torch.save(out, f"{path}.rank{rank}.pt")
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(*sys.argv[1:3])
