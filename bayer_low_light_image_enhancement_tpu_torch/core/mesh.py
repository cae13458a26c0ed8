"""Process groups and the device mesh of multi-GPU training.

Port of ``bayer_low_light_image_enhancement_tpu/core/mesh.py``. The JAX
package lays its devices out as a ``jax.sharding.Mesh`` with named axes and
lets XLA insert the collectives; here every rank is one process with one
card (or a CPU process under gloo), the mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with the same axis names, and
the port's modules call their collectives themselves: the gradient
all-reduce of ``DistributedDataParallel`` over ``data``, the BatchNorm
statistics over ``data`` (``ops/rep_conv.BatchNorm2d``), the Megatron
pair over ``tensor`` (``parallel/tensor.py``), and the halo exchanges and
token-global sums of tiled inference over ``spatial`` / ``spatial_w``
(``parallel/tiled.py``, ``ops/conv.py``).

Axes, in mesh order (``data`` varies slowest, ``tensor`` fastest):
  * ``data``      — batch data parallelism;
  * ``spatial``   — image-height sharding of full-resolution inference;
  * ``spatial_w`` — image-width sharding (2-D spatial meshes);
  * ``tensor``    — Megatron tensor parallelism of the transformer blocks.

The port's own collectives are ``all_reduce`` and ``broadcast`` only (a
gather is an all-reduce into a zeroed full tensor), so the same code runs on
NCCL across cards, on gloo on the CPU, and on gloo with several ranks
sharing one card.
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import time
from typing import Mapping, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class AxisNames:
    data: str = "data"
    spatial: str = "spatial"      # image H sharding
    spatial_w: str = "spatial_w"  # image W sharding (2D spatial meshes)
    tensor: str = "tensor"        # channel sharding (tensor parallelism)


AXES = AxisNames()
MESH_AXES = (AXES.data, AXES.spatial, AXES.spatial_w, AXES.tensor)


def mesh_shape(num_devices: int, data: int = -1, spatial: int = 1, spatial_w: int = 1,
               tensor: int = 1) -> Tuple[int, int, int, int]:
    """The (data, spatial, spatial_w, tensor) shape ``create_mesh`` lays
    over ``num_devices`` ranks, with the JAX package's rules and errors:
    ``data=-1`` takes every rank the inner axes leave; a mesh larger than
    the ranks raises."""
    inner = spatial * spatial_w * tensor
    if data == -1:
        if num_devices % inner != 0:
            raise ValueError(f"{num_devices} devices not divisible by spatial*tensor={inner}")
        data = num_devices // inner
    if data * inner > num_devices:
        raise ValueError(f"mesh {data}x{spatial}x{spatial_w}x{tensor} needs {data * inner} "
                         f"devices, have {num_devices}")
    return data, spatial, spatial_w, tensor


def create_mesh(data: int = -1, spatial: int = 1, spatial_w: int = 1, tensor: int = 1):
    """A ``DeviceMesh`` with dims (data, spatial, spatial_w, tensor) over the
    first ``data * spatial * spatial_w * tensor`` ranks of the initialised
    process group (``initialize_multihost``); ``tensor`` varies fastest. Its
    device type is "cuda" where a card is present, else "cpu"."""
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError("create_mesh needs an initialised process group "
                           "(core.mesh.initialize_multihost)")
    shape = mesh_shape(dist.get_world_size(), data, spatial, spatial_w, tensor)
    ranks = torch.arange(int(torch.tensor(shape).prod())).reshape(shape)
    return DeviceMesh("cuda" if torch.cuda.is_available() else "cpu", ranks,
                      mesh_dim_names=MESH_AXES)


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         device_type: str = "cuda") -> torch.device:
    """Join the process group of a multi-process run (one call per process,
    before ``create_mesh``) and return this rank's device.

    ``coordinator_address``: "host:port" (TCP), a URL ("tcp://...",
    "file://..."), or None for ``torchrun``'s environment (MASTER_ADDR /
    MASTER_PORT). ``num_processes`` / ``process_id`` default to WORLD_SIZE /
    RANK. On the card each rank takes card LOCAL_RANK (modulo the cards) and
    the group runs on NCCL when each rank of the host owns its own card,
    else on gloo (ranks sharing a card); ``device_type="cpu"`` runs gloo on
    the CPU."""
    world = int(os.environ["WORLD_SIZE"]) if num_processes is None else num_processes
    rank = int(os.environ["RANK"]) if process_id is None else process_id
    if coordinator_address is None:
        init = "env://"
    elif "://" in coordinator_address:
        init = coordinator_address
    else:
        init = f"tcp://{coordinator_address}"
    if device_type == "cuda":
        cards = torch.cuda.device_count()
        if cards == 0:
            raise RuntimeError("initialize_multihost: no CUDA device is available")
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        device = torch.device("cuda", local_rank % cards)
        torch.cuda.set_device(device)
        backend = "nccl" if local_world <= cards else "gloo"
    elif device_type == "cpu":
        device, backend = torch.device("cpu"), "gloo"
    else:
        raise ValueError(f"device_type {device_type!r}: want 'cuda' or 'cpu'")
    dist.init_process_group(backend, init_method=init, world_size=world, rank=rank)
    return device


# ---------------------------------------------------------------------------
# Queries (the counterparts of the JAX package's data_sharding / replicated).

def axis_size(mesh, axis: str) -> int:
    """The size of ``axis`` (1 without a mesh)."""
    return 1 if mesh is None else mesh.size(MESH_AXES.index(axis))


def axis_rank(mesh, axis: str) -> int:
    """This rank's coordinate along ``axis`` (0 without a mesh)."""
    return 0 if mesh is None else mesh.get_local_rank(axis)


def axis_group(mesh, axis: str):
    """The process group along ``axis`` that holds this rank, or None
    without a mesh or where the axis has size 1 (nothing to reduce)."""
    if axis_size(mesh, axis) == 1:
        return None
    return mesh.get_group(axis)


def data_group(mesh):
    return axis_group(mesh, AXES.data)


def tensor_group(mesh):
    return axis_group(mesh, AXES.tensor)


def spatial_group(mesh):
    return axis_group(mesh, AXES.spatial)


def spatial_w_group(mesh):
    return axis_group(mesh, AXES.spatial_w)


class BoundAxis(NamedTuple):
    """A mesh axis as a module of the port sees it: the process group
    along the axis that holds this rank, the axis size, and this rank's
    coordinate on it. The counterpart of a JAX mesh-axis name inside
    ``shard_map`` (``lax.axis_size`` / ``lax.axis_index``)."""

    group: object
    size: int
    index: int


def bind_axis(mesh, axis: Optional[str]) -> Optional[BoundAxis]:
    """The ``BoundAxis`` of mesh axis ``axis`` for this rank, or None for
    no axis or one of size 1 (nothing crosses it)."""
    if axis is None or axis_size(mesh, axis) == 1:
        return None
    return BoundAxis(mesh.get_group(axis), axis_size(mesh, axis), axis_rank(mesh, axis))


def rank() -> int:
    """This process's global rank (0 without a process group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def row_range(batch: int, index: int, parts: int) -> Tuple[int, int]:
    """Rows [start, stop) of part ``index`` of ``parts`` of a ``batch``-row
    batch: [i B / n, (i + 1) B / n), the JAX package's data sharding when n
    divides B, and contiguous, covering every row once, when it does not."""
    return index * batch // parts, (index + 1) * batch // parts


# ---------------------------------------------------------------------------
# Collectives.

class _SumOver(torch.autograd.Function):
    """Sum over a group in forward; the sum of the grads in backward (each
    rank's loss reaches every rank's input through the sum)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        g = grad.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def sum_over(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable all-reduce (sum) of ``x`` over ``group``."""
    return _SumOver.apply(x, group)


def gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """Concatenate every rank's rows of ``x`` (dim 0, any row counts, zero
    included) in rank order, on every rank of ``group``: two all-reduces,
    one of the row counts and one of a zeroed full tensor holding this
    rank's rows in place (the sum of zeros is exact)."""
    if group is None:
        return x
    n, me = dist.get_world_size(group), dist.get_rank(group)
    counts = torch.zeros(n, dtype=torch.int64, device=x.device)
    counts[me] = x.shape[0]
    dist.all_reduce(counts, group=group)
    counts = counts.tolist()
    start = sum(counts[:me])
    full = torch.zeros((sum(counts), *x.shape[1:]), dtype=x.dtype, device=x.device)
    full[start:start + x.shape[0]] = x
    dist.all_reduce(full, group=group)
    return full


def broadcast_module_(module: torch.nn.Module, src: int = 0) -> None:
    """Copy global rank ``src``'s parameters and buffers into every rank's
    ``module`` (one broadcast each, in registration order)."""
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, src=src)


# ---------------------------------------------------------------------------
# Launching ranks.

def run_ranks(argv: Sequence[str], world: int, env: Optional[Mapping[str, str]] = None,
              timeout: Optional[float] = None, poll: float = 0.2) -> None:
    """Start ``world`` processes of ``argv`` with torchrun's rank variables
    (RANK, LOCAL_RANK, WORLD_SIZE, LOCAL_WORLD_SIZE) and ``env``, and wait
    for them. When one fails (or ``timeout`` seconds pass) the others are
    killed and RuntimeError names the first failed rank and its exit code."""
    procs = []
    for r in range(world):
        e = dict(os.environ, **(env or {}), RANK=str(r), LOCAL_RANK=str(r),
                 WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(world))
        procs.append(subprocess.Popen(list(argv), env=e))
    t0 = time.monotonic()
    failed = None
    try:
        while failed is None:
            codes = [p.poll() for p in procs]
            bad = [(r, c) for r, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                failed = bad[0]
            elif all(c == 0 for c in codes):
                return
            elif timeout is not None and time.monotonic() - t0 > timeout:
                failed = (None, "timeout")
            else:
                time.sleep(poll)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    who = "the ranks timed out" if failed[0] is None else f"rank {failed[0]} exited {failed[1]}"
    raise RuntimeError(f"{who} (of {world}: {' '.join(argv[:3])} ...)")

