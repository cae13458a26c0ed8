"""The weight-grad pass of the fused-block backward at C >= 96: out[g] =
a[g]^T b[g] summed over all pixels, on the tensor cores (``wgmma``).

Part of the port of the TPU kernels ``_bwd1_kernel`` / ``_bwd2_kernel``
(``bayer_low_light_image_enhancement_tpu/kernels/fused_block_bwd.py``): there
the weight grads stayed resident in output blocks across a sequential grid.
At C >= 96 B1's accumulators do not fit on chip, so B1 and B2
(``kernels/fused_block_bwd.py``) write the products' operands once per pixel
and this pass contracts them: a [G, K, M] and b [G, K, N] bf16, K the pixels
with the channels contiguous, -> [G, M, N] fp32 (B1: d_apply per image, dwp1,
dwp2; B2: [dwqk|dwv]).

``plan`` lays a launch out (``csrc/weight_grad.cu``): 128 x ``tn`` output
tiles, each over ``slices`` contiguous K slices, consecutive slices of a
tile in clusters of ``cluster`` CTAs that sum their tiles on chip in rank
order; where K takes more than one cluster, the clusters' partials go to a
workspace and the last cluster to finish a tile sums them in order (an
arrival counter per tile and rank says which is last: it picks who sums,
never the order). The grid is one wave at the card's residency (the
occupancy API's clusters, ``blle_weight_grad_info``), so the result depends
only on the shapes and the card: reruns are bitwise equal. The workspace
and the counters (zero between launches) are one buffer each per device,
kept between calls: launches on one stream run in order.
``weight_grad`` runs the plain twin on CPU tensors and the kernel on CUDA
tensors, or raises; ``weight_grad.launches`` counts calls that launched the
kernel.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Callable, List, Sequence, Tuple

import torch

from bayer_low_light_image_enhancement_tpu_torch.kernels import _build

MAX_PROBLEMS = 4  # products in one launch (csrc/weight_grad.cu kMaxProblems)
TILE_M = 128  # output rows of a CTA (kTm)
TILE_NS = (64, 128, 192, 256)  # output columns of a CTA, one per launch
K_STEP = 64  # pixels a stage (kKs); slices are whole stages
CLUSTERS = (8, 4, 2, 1)  # CTAs a cluster, largest first
MIN_STAGES = 4  # a tile's K is split no finer than this many stages a CTA
STAGES, THREADS = 4, 256  # ring slots and threads of a CTA (kStages, kWgThreads)
BOX = 64 * K_STEP * 2  # bytes of one TMA box: 64 channels x 64 pixels (kBox)

Pair = Tuple[torch.Tensor, torch.Tensor]
Shape = Tuple[int, int, int, int]  # (G, K, M, N)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class Split:
    """One product's share of a launch: each of its ``tiles`` output tiles
    over ``slices`` K slices (a multiple of the cluster), its clusters'
    partials at ``ws_offset`` floats of the workspace ([G, slices /
    cluster, M, N]) and its arrival counters at ``count_offset`` ([tiles,
    cluster]; neither where one cluster covers K), its first CTA
    ``first_block``."""

    slices: int
    tiles: int
    ws_offset: int
    count_offset: int
    first_block: int
    blocks: int


@dataclasses.dataclass(frozen=True)
class Plan:
    tn: int
    cluster: int
    splits: Tuple[Split, ...]
    ws_floats: int
    counters: int
    blocks: int


def tile_n(shapes: Sequence[Shape]) -> int:
    """The launch's output-tile width: for each product the narrowest of
    TILE_NS that covers N in as few tiles as 256 does; the widest of those."""
    return max(min(t for t in TILE_NS if _cdiv(n, t) == _cdiv(n, 256)) for _, _, _, n in shapes)


def slice_bounds(k: int, slices: int, s: int) -> Tuple[int, int]:
    """Pixels [k0, k1) of slice s: stages [st s / S, st (s + 1) / S) of the
    st = ceil(K / K_STEP), clipped to K (the kernel's split)."""
    st = _cdiv(k, K_STEP)
    return st * s // slices * K_STEP, min(k, st * (s + 1) // slices * K_STEP)


def layout(shapes: Sequence[Shape], tn: int, cluster: int, slices: Sequence[int]) -> Plan:
    """The launch for given slices a tile: CTAs and partials back to back."""
    if not 1 <= len(shapes) <= MAX_PROBLEMS:
        raise ValueError(f"1 to {MAX_PROBLEMS} products per launch, got {len(shapes)}")
    splits, ws, counters, first = [], 0, 0, 0
    for (g, k, m, n), s in zip(shapes, slices):
        if s % cluster or not 1 <= s <= _cdiv(k, K_STEP):
            raise ValueError(f"{s} slices of K = {k} in clusters of {cluster}")
        tiles = g * _cdiv(m, TILE_M) * _cdiv(n, tn)
        splits.append(Split(s, tiles, ws, counters, first, tiles * s))
        if s > cluster:
            ws += g * (s // cluster) * m * n
            counters += tiles * cluster
        first += tiles * s
    return Plan(tn, cluster, tuple(splits), ws, counters, first)


def smem_bytes(tn: int) -> int:
    """A CTA's dynamic shared memory (``wg_smem``): the ring of 64-pixel
    stages of A (128 columns) and B (tn) or the fp32 epilogue tile (rows
    padded by 8), the larger, aligned to 1024 bytes, then the stages'
    barriers and a flag."""
    return 1024 + max(STAGES * (TILE_M + tn) // 64 * BOX, TILE_M * (tn + 8) * 4) + STAGES * 8 + 16


def plan(shapes: Sequence[Shape], resident: Callable[[int, int], int]) -> Plan:
    """Lay out one launch of the products (G, K, M, N); ``resident(tn,
    cluster)`` is the clusters the card holds at once. The cluster is the
    largest that gives every tile one cluster within a wave without an
    empty slice; then, while the wave has room, the product whose CTAs carry
    the most stages (the first on a tie) gets one more cluster a tile, as
    long as each CTA keeps MIN_STAGES stages."""
    if not 1 <= len(shapes) <= MAX_PROBLEMS:
        raise ValueError(f"1 to {MAX_PROBLEMS} products per launch, got {len(shapes)}")
    tn = tile_n(shapes)
    units = [g * _cdiv(m, TILE_M) * _cdiv(n, tn) for g, _, m, n in shapes]
    stages = [_cdiv(k, K_STEP) for _, k, _, _ in shapes]
    cl = next((c for c in CLUSTERS if c <= min(stages) and sum(units) <= resident(tn, c)), 1)
    budget, used, per = resident(tn, cl), sum(units), [1] * len(shapes)
    while True:
        fits = [i for i, u in enumerate(units) if used + u <= budget
                and _cdiv(stages[i], cl * (per[i] + 1)) >= MIN_STAGES]
        if not fits:
            break
        i = max(fits, key=lambda j: (_cdiv(stages[j], cl * per[j]), -j))
        per[i] += 1
        used += units[i]
    return layout(shapes, tn, cl, [cl * p for p in per])


@functools.lru_cache(maxsize=None)
def kernel_info(tn: int, cluster: int) -> Tuple[int, int, int, int]:
    """The library's (shared-memory bytes, threads, ring stages, clusters
    the card holds at once) for 128 x tn tiles in clusters of ``cluster``."""
    info = (ctypes.c_longlong * 4)()
    _build.check(_build.library().blle_weight_grad_info(tn, cluster, info),
                 f"weight-grad kernel info (tn={tn}, cluster={cluster})")
    return tuple(info)


_BUFFERS = {}  # (device, "ws" or "count") -> the buffer, kept between calls


def _buffer(device: torch.device, kind: str, n: int) -> int:
    """The address of at least n fp32 of workspace ("ws") or int32 arrival
    counters ("count", zeros that every launch leaves zero) on ``device``."""
    buf = _BUFFERS.get((device, kind))
    if buf is None or buf.numel() < n:
        n = max(n, 1 << 20 if kind == "ws" else 4096)
        buf = _BUFFERS[device, kind] = (torch.empty(n, dtype=torch.float32, device=device)
                                        if kind == "ws" else
                                        torch.zeros(n, dtype=torch.int32, device=device))
    return buf.data_ptr()


@functools.lru_cache(maxsize=256)
def plan_for(shapes: Tuple[Shape, ...]) -> Plan:
    """The plan the wrapper launches: ``plan`` at the current card's
    residency, cached per shape set."""
    return plan(shapes, lambda tn, cl: kernel_info(tn, cl)[3])


def weight_grad_plain(pairs: Sequence[Pair]) -> List[torch.Tensor]:
    """The twin: [a[g]^T b[g] for each (a, b)] in fp32."""
    return [torch.einsum("gkm,gkn->gmn", a.float(), b.float()) for a, b in pairs]


def _check(a: torch.Tensor, b: torch.Tensor, out: torch.Tensor) -> Shape:
    """(G, K, M, N), or raise unless a [G,K,M], b [G,K,N] bf16 and out
    [G,M,N] fp32 are contiguous and 16-byte aligned on one device with M, N
    multiples of 8."""
    g = gb = 0
    if a.dim() == 3 and b.dim() == 3:
        (g, k, m), (gb, kb, n) = a.shape, b.shape
    if (g < 1 or gb != g or kb != k or m % 8 or n % 8 or a.dtype != torch.bfloat16
            or b.dtype != torch.bfloat16 or out.dtype != torch.float32
            or out.shape != (g, m, n) or not a.is_contiguous() or not b.is_contiguous()
            or not out.is_contiguous() or (a.data_ptr() | b.data_ptr() | out.data_ptr()) % 16
            or b.get_device() != a.get_device() or out.get_device() != a.get_device()):
        raise ValueError(f"a [G,K,M] and b [G,K,N] bf16, out [G,M,N] fp32, contiguous, M and N "
                         f"multiples of 8, on one device: {tuple(a.shape)} {a.dtype} {a.device}, "
                         f"{tuple(b.shape)} {b.dtype} {b.device}, {tuple(out.shape)} {out.dtype} "
                         f"{out.device}")
    return g, k, m, n


def weight_grad(pairs: Sequence[Pair], outs: Sequence[torch.Tensor] | None = None):
    """[a[g]^T b[g] for each (a, b)] fp32, written into ``outs`` if given.
    CPU: the twin. CUDA: one launch of the kernel for all pairs, or raise."""
    if not pairs[0][0].is_cuda:
        res = weight_grad_plain(pairs)
        if outs is None:
            return res
        for o, r in zip(outs, res):
            o.copy_(r)
        return list(outs)
    return _weight_grad_kernel(pairs, outs)


def _weight_grad_kernel(pairs: Sequence[Pair], outs: Sequence[torch.Tensor] | None):
    if outs is None:
        outs = [torch.empty((a.shape[0], a.shape[2], b.shape[2]), dtype=torch.float32,
                            device=a.device) for a, b in pairs]
    shapes = tuple(_check(a, b, o) for (a, b), o in zip(pairs, outs))
    p = plan_for(shapes)
    ws = cnt = 0
    if p.ws_floats:
        dev = pairs[0][0].device
        ws, cnt = _buffer(dev, "ws", p.ws_floats), _buffer(dev, "count", p.counters)
    table = (ctypes.c_longlong * (11 * len(pairs)))()
    for i, ((a, b), o, (g, k, m, n), sp) in enumerate(zip(pairs, outs, shapes, p.splits)):
        table[11 * i: 11 * i + 11] = (a.data_ptr(), b.data_ptr(), ws and ws + 4 * sp.ws_offset,
                                      o.data_ptr(), cnt and cnt + 4 * sp.count_offset, g, k, m, n,
                                      sp.slices, sp.first_block)
    err = _build.library().blle_weight_grad(table, len(pairs), p.tn, p.cluster,
                                            _build.stream_of(pairs[0][0]))
    _build.check(err, "weight-grad pass")
    weight_grad.launches += 1
    return list(outs)


weight_grad.launches = 0
