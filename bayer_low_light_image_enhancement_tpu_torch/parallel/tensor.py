"""Megatron tensor parallelism of the transformer blocks over the mesh's
``tensor`` axis.

Port of ``bayer_low_light_image_enhancement_tpu/parallel/tensor.py``. The
JAX package annotates the parameters with shardings and XLA's partitioner
inserts the collectives; here each tensor rank holds its shards of every
``TransformerBlock`` (``models/common.py``) and the block calls them:

* column-parallel: ``attn.qkv`` and ``attn.qkv_dwconv``, split by head for
  q, k and v each, so that a rank owns whole heads and their
  ``temperature`` / ``log_temperature``; ``ffn.pointwise1`` and
  ``ffn.depthwise`` by hidden channel. Their input passes ``copy_to_group``
  (identity forward, all-reduce backward).
* row-parallel: ``attn.project_out`` and ``ffn.pointwise2`` take the
  rank's input channels; ``reduce_from_group`` (all-reduce forward,
  identity backward) sums their partial outputs in fp32, and the bias,
  replicated, is added after the sum.

Everything else is replicated; the conjugate pair keeps the replicated
parameters' grads equal on every tensor rank. A block whose heads or hidden
width the degree does not divide stays replicated (the counterpart of the
JAX rules' per-leaf fallback), and ``shard_model`` names it. Sharded blocks
run the module path: the hand kernels K2 / K3 and B1 / B2 compute a whole
block, across the row-parallel sum, so they cannot run a shard of one
(replicated blocks keep them). The other layers the JAX rules match by name
(WavKAN's ``qkv_dwconv``, the WFB gated FFN's ``project_out``) stay
replicated: the JAX annotation of them changes no number.

Checkpoints hold the unsharded layout: ``gather_state`` all-reduces each
shard, placed in a zeroed full tensor, over the tensor group;
``shard_state`` takes a rank's shards of a full state.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from bayer_low_light_image_enhancement_tpu_torch.kernels.fused_block import attention_temperature
from bayer_low_light_image_enhancement_tpu_torch.models.common import Conv2d, TransformerBlock
from bayer_low_light_image_enhancement_tpu_torch.ops.attention import channel_attention

class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        g = grad.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """Identity in forward; all-reduce of the grad over ``group`` in backward
    (the input of a column-parallel layer)."""
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """All-reduce over ``group`` in forward; identity in backward (the output
    of a row-parallel layer)."""
    return _ReduceFromGroup.apply(x, group)


def _divisible(block: TransformerBlock, tp: int) -> bool:
    return (block.num_heads % tp == 0
            and block.ffn.pointwise1.out_channels % tp == 0)


def _block_specs(prefix: str, block: TransformerBlock) -> Dict[str, int]:
    names = {f"attn.{m}.{p}": 0 for m in ("qkv", "qkv_dwconv") for p in ("weight", "bias")}
    names.update({f"ffn.{m}.{p}": 0 for m in ("pointwise1", "depthwise")
                  for p in ("weight", "bias")})
    names["attn.project_out.weight"] = names["ffn.pointwise2.weight"] = 1
    for t in ("temperature", "log_temperature"):
        if t in block.attn._parameters:
            names[f"attn.{t}"] = 0
    return {f"{prefix}{k}": d for k, d in names.items()}


def tensor_specs(model: nn.Module, tp: int) -> Dict[str, int]:
    """name -> the dim its parameter is split along over ``tp`` tensor ranks,
    for every sharded parameter of the unsharded ``model`` (absent names are
    replicated). In torch's layouts: a column-parallel conv's OIHW weight
    and its bias on dim 0 (the JAX kernel's last dim), a row-parallel
    weight on dim 1 (the JAX kernel's dim -2), a temperature on its head
    dim 0."""
    if tp <= 1:
        return {}
    specs = {}
    for name, m in model.named_modules():
        if isinstance(m, TransformerBlock) and _divisible(m, tp):
            specs.update(_block_specs(f"{name}.", m))
    return specs


def _parts(name: str) -> int:
    """3 for the q / k / v halves of the qkv convs (each split by head), 1
    for a parameter split as one piece."""
    return 3 if name.split(".")[-2] in ("qkv", "qkv_dwconv") else 1


def shard_index(name: str, full: int, tp: int, rank: int) -> torch.Tensor:
    """The indices, along its split dim, of tensor rank ``rank``'s shard of
    parameter ``name`` whose split dim has ``full`` entries."""
    parts = _parts(name)
    size = full // parts
    chunk = size // tp
    return torch.cat([torch.arange(p * size + rank * chunk, p * size + (rank + 1) * chunk)
                      for p in range(parts)])


def _shard(name: str, t: torch.Tensor, dim: int, tp: int, rank: int) -> torch.Tensor:
    idx = shard_index(name, t.shape[dim], tp, rank).to(t.device)
    return t.index_select(dim, idx).contiguous()


class ShardedAttention(nn.Module):
    """A ChannelAttention's shard: this rank's heads of q, k and v, their
    temperatures, and project_out's input columns (bias replicated)."""

    def __init__(self, attn: nn.Module, prefix: str, group, tp: int, rank: int):
        super().__init__()
        self.group = group
        self.num_heads = attn.num_heads // tp
        self.compute_dtype = attn.qkv.compute_dtype
        cd, dim = self.compute_dtype, attn.qkv.in_channels
        local = 3 * dim // tp
        kw = dict(device=attn.qkv.weight.device, dtype=attn.qkv.weight.dtype, compute_dtype=cd)
        for t in ("temperature", "log_temperature"):
            if t in attn._parameters:
                setattr(self, t, nn.Parameter(_shard(f"{prefix}{t}", attn._parameters[t].data,
                                                     0, tp, rank)))
        self.qkv = Conv2d(dim, local, 1, **kw)
        self.qkv_dwconv = Conv2d(local, local, 3, groups=local, **kw)
        self.project_out = Conv2d(dim // tp, dim, 1, **kw)
        with torch.no_grad():
            for m in ("qkv", "qkv_dwconv"):
                for p in ("weight", "bias"):
                    getattr(getattr(self, m), p).copy_(_shard(
                        f"{prefix}{m}.{p}", getattr(getattr(attn, m), p).data, 0, tp, rank))
            self.project_out.weight.copy_(_shard(f"{prefix}project_out.weight",
                                                 attn.project_out.weight.data, 1, tp, rank))
            self.project_out.bias.copy_(attn.project_out.bias.data)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        qkv = self.qkv_dwconv(self.qkv(x)).permute(0, 2, 3, 1)
        q, k, v = qkv.chunk(3, dim=-1)
        out = channel_attention(q, k, v, attention_temperature(self._parameters), self.num_heads)
        part = F.conv2d(out.permute(0, 3, 1, 2).to(cd), self.project_out.weight.to(cd))
        y = reduce_from_group(part.float(), self.group)
        return (y + self.project_out.bias.float()[:, None, None]).to(cd)


class ShardedFFN(nn.Module):
    """A ConvFFN's shard: this rank's hidden channels of pointwise1 and
    depthwise, and pointwise2's input columns (bias replicated)."""

    def __init__(self, ffn: nn.Module, prefix: str, group, tp: int, rank: int):
        super().__init__()
        self.group = group
        self.compute_dtype = cd = ffn.pointwise1.compute_dtype
        dim, hidden = ffn.pointwise1.in_channels, ffn.pointwise1.out_channels // tp
        kw = dict(device=ffn.pointwise1.weight.device, dtype=ffn.pointwise1.weight.dtype,
                  compute_dtype=cd)
        self.pointwise1 = Conv2d(dim, hidden, 1, **kw)
        self.depthwise = Conv2d(hidden, hidden, 3, groups=hidden, **kw)
        self.pointwise2 = Conv2d(hidden, dim, 1, **kw)
        with torch.no_grad():
            for m in ("pointwise1", "depthwise"):
                for p in ("weight", "bias"):
                    getattr(getattr(self, m), p).copy_(_shard(
                        f"{prefix}{m}.{p}", getattr(getattr(ffn, m), p).data, 0, tp, rank))
            self.pointwise2.weight.copy_(_shard(f"{prefix}pointwise2.weight",
                                                ffn.pointwise2.weight.data, 1, tp, rank))
            self.pointwise2.bias.copy_(ffn.pointwise2.bias.data)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        h = self.depthwise(self.pointwise1(x))
        h = F.gelu(h.float()).to(h.dtype)
        part = F.conv2d(h, self.pointwise2.weight.to(cd))
        y = reduce_from_group(part.float(), self.group)
        return (y + self.pointwise2.bias.float()[:, None, None]).to(cd)


class TensorParallelBlock(nn.Module):
    """A TransformerBlock whose attention and FFN are sharded over the
    tensor group; the parameters keep the block's names and order (only the
    sharded ones are smaller). The module path always: see the module doc."""

    def __init__(self, block: TransformerBlock, prefix: str, group, tp: int, rank: int):
        super().__init__()
        self.group = group
        self.compute_dtype = block.compute_dtype
        self.norm1 = block.norm1
        self.attn = ShardedAttention(block.attn, f"{prefix}attn.", group, tp, rank)
        self.norm2 = block.norm2
        self.ffn = ShardedFFN(block.ffn, f"{prefix}ffn.", group, tp, rank)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        x = x + self.attn(copy_to_group(self.norm1(x).to(cd), self.group))
        return x + self.ffn(copy_to_group(self.norm2(x).to(cd), self.group))


@dataclasses.dataclass
class TensorLayout:
    """What ``shard_model`` did: the sharded parameters' split dims
    (``tensor_specs`` of the unsharded model), the blocks it kept
    replicated, and the group, degree and this rank's coordinate."""

    specs: Dict[str, int]
    replicated: List[str]
    group: object
    tp: int
    rank: int


def shard_model(model: nn.Module, group) -> TensorLayout:
    """Replace every TransformerBlock of ``model`` whose heads and hidden
    width the group's size divides by its TensorParallelBlock shard (in
    place; the model must hold the same unsharded weights on every rank of
    ``group``). Blocks the degree does not divide stay replicated and are
    listed in the returned layout."""
    tp, rank = dist.get_world_size(group), dist.get_rank(group)
    specs = tensor_specs(model, tp)
    replicated = []
    for name, m in list(model.named_modules()):
        if not isinstance(m, TransformerBlock):
            continue
        if not _divisible(m, tp):
            replicated.append(f"{name} (heads {m.num_heads}, hidden "
                              f"{m.ffn.pointwise1.out_channels})")
            continue
        parent_name, _, attr = name.rpartition(".")
        parent = model.get_submodule(parent_name) if parent_name else model
        setattr(parent, attr, TensorParallelBlock(m, f"{name}.", group, tp, rank))
    return TensorLayout(specs, replicated, group, tp, rank)


def gather_state(state: Mapping[str, torch.Tensor], layout: TensorLayout) -> Dict[str, torch.Tensor]:
    """A sharded model's ``state_dict`` -> the unsharded one, on every rank
    of the tensor group: each shard placed at its indices in a zeroed full
    tensor, summed over the group."""
    out = {}
    for name, t in state.items():
        dim = layout.specs.get(name)
        if dim is None:
            out[name] = t
            continue
        shape = list(t.shape)
        shape[dim] *= layout.tp
        full = torch.zeros(shape, dtype=t.dtype, device=t.device)
        idx = shard_index(name, shape[dim], layout.tp, layout.rank).to(t.device)
        full.index_copy_(dim, idx, t)
        dist.all_reduce(full, group=layout.group)
        out[name] = full
    return out


def shard_state(state: Mapping[str, torch.Tensor], layout: TensorLayout) -> Dict[str, torch.Tensor]:
    """An unsharded ``state_dict`` -> this rank's shards of it."""
    return {name: (t if name not in layout.specs
                   else _shard(name, t, layout.specs[name], layout.tp, layout.rank))
            for name, t in state.items()}
