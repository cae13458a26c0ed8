"""Selective scan forward (S1) and backward (S2) and their ``autograd.Function``.

Port of ``bayer_low_light_image_enhancement_tpu/kernels/ssm_scan.py``:

* ``selective_scan_fwd`` (S1): y of the scan; with ``save_states`` also the
  fp32 state entering every ``STATE_EVERY`` steps (the training forward,
  TPU ``_ssm_fwd_states_kernel``; without it the inference forward, TPU
  ``_ssm_kernel``); ``fwd_plan`` cuts L into chunks only where the (b, d)
  walks alone leave the card short of warps, so it is one launch with one
  exp per element wherever they fill it;
* ``selective_scan_bwd`` (S2): du, ddt, dA, dB, dC, dD from dy and those
  states (TPU ``_ssm_bwd_kernel``);
* ``SelectiveScanFn``: forward S1 with states, backward S2;
* ``selective_scan``: what ``ops.ssm.MambaBlock`` calls, the Function when
  grad is needed, else S1 alone.

Both wrappers run their plain twin from ``ops/ssm.py`` on a CPU tensor and
launch the CUDA kernels (``csrc/ssm_scan.cu``) on a CUDA tensor, or raise;
S1 without states does so as the ``torch.library`` operator
``torch.ops.blle.selective_scan_fwd`` (``kernels/ops.py``), which
``torch.export`` keeps in its graph;
``selective_scan_fwd.launches`` and ``selective_scan_bwd.launches`` count
the launches. u, dt, B, C (and dy) go to the kernels in u's dtype (bf16 or
fp32); A and D in fp32; the recurrence is fp32.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from bayer_low_light_image_enhancement_tpu_torch.kernels import _build
from bayer_low_light_image_enhancement_tpu_torch.ops import ssm

TWIN_CHUNK = 128  # L-chunk of the CPU twin (any multiple of STATE_EVERY: exact maths)
BWD_CHUNK = 128   # L-chunk per block of the backward (multiple of STATE_EVERY)
STATE_EVERY = 32  # kSub in csrc/ssm_scan.cu
MAX_STATE = 32    # S2: one lane per state n; S1: 8 lanes of FWD_STATES_PER_LANE states
FWD_WARPS = 8     # warps per forward block (kFwdWarps)
FWD_STATES_PER_LANE = 4  # kSpl: a (b, d) walk of S1 takes 8 lanes, a warp walks 4
FWD_ONE_CHUNK = 2  # one chunk while the walks fill 1 / FWD_ONE_CHUNK of the resident warps
FWD_WAVES = 4     # else chunks for FWD_WAVES x the resident warps in each pass
BWD_WARPS = 4     # warps per backward block (kBwdWarps)
BWD_DGROUP_MAX = 40  # channels per backward block at most (its shared memory grows with them)
BWD_WAVES = 2     # backward blocks to aim for, in multiples of those the card holds at once
_IN_DTYPES = (torch.float32, torch.bfloat16)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class BwdPlan:
    """The backward's grid: (chunks, ``groups``, B) blocks of ``BWD_WARPS``
    warps; a block walks ``chunk`` steps of ``dgroup`` channels, each warp
    ``per_warp`` of them (a ragged last group leaves some warps fewer)."""

    chunk: int
    dgroup: int
    per_warp: int
    groups: int
    blocks: int


@dataclasses.dataclass(frozen=True)
class FwdPlan:
    """S1's L-chunks: ``chunks`` of ``chunk`` steps (the last may be
    shorter)."""

    chunk: int
    chunks: int

    @property
    def launches(self) -> int:
        """Kernels a call: 1 for one chunk, else 2."""
        return 1 if self.chunks == 1 else 2


def fwd_plan(bsz: int, L: int, d: int, resident: int) -> FwdPlan:
    """S1's chunks for u [bsz, L, d], given the warps the card holds at
    once (``resident``: SMs x the occupancy API's blocks per SM x
    ``FWD_WARPS``). One chunk (one launch, one exp per element) while the
    (b, d) walks alone give at least 1 / ``FWD_ONE_CHUNK`` of them; else
    the fewest chunks whose nc - 1 chunks in each pass give
    ``FWD_WAVES`` x ``resident`` (both passes run nc - 1 chunks, so nc = 2
    would walk as long as nc = 1 and is asked for only by rounding at small
    L). Chunks are multiples of ``STATE_EVERY`` steps."""
    warps = _cdiv(bsz * d, FWD_STATES_PER_LANE)
    if FWD_ONE_CHUNK * warps >= resident:
        nc = 1
    else:
        nc = 1 + _cdiv(FWD_WAVES * resident, warps)
    chunk = _cdiv(_cdiv(L, nc), STATE_EVERY) * STATE_EVERY
    nc = _cdiv(L, chunk)
    return FwdPlan(chunk, nc)


def fwd_scratch_floats(bsz: int, d: int, n: int, plan: FwdPlan) -> int:
    """The fp32 scratch S1 needs: the end states [B, chunks - 1, D, N] and
    sums of dt [B, chunks - 1, D] of every chunk but the last (none for one
    chunk)."""
    return bsz * (plan.chunks - 1) * d * (n + 1)


@functools.lru_cache(maxsize=None)
def fwd_resident(device_index: int, in_bf16: bool) -> int:
    """S1 warps the card holds at once: its SMs x the occupancy API's blocks
    per SM x ``FWD_WARPS``."""
    per_sm = _build.library().blle_ssm_fwd_blocks_per_sm(int(in_bf16))
    if per_sm < 1:
        raise RuntimeError(f"S1 cannot be resident (occupancy API: {per_sm})")
    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    return per_sm * FWD_WARPS * sms


def bwd_plan(bsz: int, L: int, d: int, resident: int) -> BwdPlan:
    """S2's grid for u [bsz, L, d], given the blocks the card holds at once
    (``resident``: SMs x the occupancy API's blocks per SM). The (chunk,
    batch) rows take all channels in as few groups as ``BWD_DGROUP_MAX``
    allows (each group past the first costs a [B, L, N] partial of dB and
    of dC and a summing pass), with more groups while the grid is short of
    ``BWD_WAVES`` x ``resident`` blocks, down to one channel per warp."""
    rows = bsz * _cdiv(L, BWD_CHUNK)
    groups = max(_cdiv(d, BWD_DGROUP_MAX),
                 min(_cdiv(d, BWD_WARPS), _cdiv(BWD_WAVES * resident, rows)))
    per_warp = _cdiv(_cdiv(d, groups), BWD_WARPS)
    groups = _cdiv(d, per_warp * BWD_WARPS)
    return BwdPlan(BWD_CHUNK, per_warp * BWD_WARPS, per_warp, groups, rows * groups)


def bwd_workspace_floats(bsz: int, L: int, d: int, n: int, plan: BwdPlan) -> int:
    """The fp32 workspace S2 needs (``BwdLayout`` in csrc/ssm_scan.cu): the
    chunk carries [B, chunks, D, N] and sums of dt [B, chunks, D], the dA and
    dD partials of the same shapes, and with several d-groups the dB and dC
    partials [groups, B, L, N] each."""
    rows = bsz * _cdiv(L, plan.chunk) * d
    part = plan.groups * bsz * L * n if plan.groups > 1 else 0
    return 2 * rows * (n + 1) + 2 * part


@functools.lru_cache(maxsize=None)
def bwd_resident(device_index: int, in_bf16: bool) -> int:
    """Backward blocks the card holds at once at ``BWD_DGROUP_MAX``
    channels per block: its SMs x the occupancy API's blocks per SM."""
    per_sm = _build.library().blle_ssm_bwd_blocks_per_sm(BWD_DGROUP_MAX, int(in_bf16))
    if per_sm < 1:
        raise RuntimeError(f"S2 cannot be resident at {BWD_DGROUP_MAX} channels a block "
                           f"(occupancy API: {per_sm})")
    return per_sm * torch.cuda.get_device_properties(device_index).multi_processor_count


def _check(u, dt, A, B, C, D, **more):
    """Shapes, devices and the input dtype the kernels take; ``more`` maps
    a name to (tensor, expected shape)."""
    if u.dim() != 3 or A.dim() != 2:
        raise ValueError(f"u must be [B, L, D] and A [D, N], got {tuple(u.shape)}, "
                         f"{tuple(A.shape)}")
    bsz, L, d = u.shape
    n = A.shape[1]
    if not 1 <= n <= MAX_STATE:
        raise ValueError(f"the kernels take 1 <= N <= {MAX_STATE} states, got {n}")
    if u.dtype not in _IN_DTYPES:
        raise TypeError(f"u is {u.dtype}; the kernels take {_IN_DTYPES}")
    want = {"dt": (dt, (bsz, L, d)), "A": (A, (d, n)), "B": (B, (bsz, L, n)),
            "C": (C, (bsz, L, n)), "D": (D, (d,))}
    want.update(more)
    for name, (t, shape) in want.items():
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
        if t.device != u.device:
            raise ValueError(f"{name} is on {t.device}, expected {u.device}")


def _as(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return t.detach().to(dtype).contiguous()


def selective_scan_fwd(u, dt, A, B, C, D, save_states: bool = False):
    """S1: -> y [B, L, D] in u's dtype, and with ``save_states`` also the
    states [B, ceil(L / STATE_EVERY), D, N] (fp32; the compute dtype on the
    CPU). CPU: the chunked twin. CUDA: the kernel, or raise. Without
    ``save_states`` through ``torch.ops.blle.selective_scan_fwd``."""
    if not save_states:
        return torch.ops.blle.selective_scan_fwd(u, dt, A, B, C, D)
    if not u.is_cuda:
        return ssm.selective_scan(u, dt, A, B, C, D, chunk_size=TWIN_CHUNK,
                                  state_every=STATE_EVERY)
    return _fwd_kernel(u, dt, A, B, C, D, True)


def _fwd_kernel(u, dt, A, B, C, D, save_states):
    _check(u, dt, A, B, C, D)
    bsz, L, d = u.shape
    n = A.shape[1]
    t = u.dtype
    u, dt, B, C = (_as(x, t) for x in (u, dt, B, C))
    A, D = _as(A, torch.float32), _as(D, torch.float32)
    plan = fwd_plan(bsz, L, d, fwd_resident(u.device.index, t == torch.bfloat16))
    f32 = dict(dtype=torch.float32, device=u.device)
    y = torch.empty_like(u)
    states = (torch.empty((bsz, -(-L // STATE_EVERY), d, n), **f32) if save_states else None)
    hend = sdt = None
    if plan.chunks > 1:  # the end states [B, chunks - 1, D, N], then the sums of dt
        scratch = torch.empty(fwd_scratch_floats(bsz, d, n, plan), **f32)
        hend = scratch.data_ptr()
        sdt = hend + 4 * bsz * (plan.chunks - 1) * d * n
    err = _build.library().blle_ssm_fwd(
        u.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(), D.data_ptr(),
        y.data_ptr(), None if states is None else states.data_ptr(), hend, sdt, bsz, L, d, n,
        plan.chunk, int(t == torch.bfloat16), _build.stream_of(u),
    )
    _build.check(err, "selective scan forward S1")
    selective_scan_fwd.launches += 1
    return (y, states) if save_states else y


selective_scan_fwd.launches = 0


def selective_scan_bwd(u, dt, A, B, C, D, dy, states):
    """S2: dy [B, L, D] and the states of ``selective_scan_fwd(...,
    save_states=True)`` -> (du, ddt, dA, dB, dC, dD), fp32 (the compute dtype
    on the CPU). CPU: the explicit backward twin, which recomputes its own
    states. CUDA: the kernel, or raise."""
    if not u.is_cuda:
        return ssm.selective_scan_bwd_ref(u, dt, A, B, C, D, dy)
    return _bwd_kernel(u, dt, A, B, C, D, dy, states)


def _bwd_kernel(u, dt, A, B, C, D, dy, states):
    bsz, L, d = u.shape
    n = A.shape[1]
    _check(u, dt, A, B, C, D, dy=(dy, (bsz, L, d)),
           states=(states, (bsz, -(-L // STATE_EVERY), d, n)))
    t = u.dtype
    u, dt, B, C, dy = (_as(x, t) for x in (u, dt, B, C, dy))
    A, D, states = (_as(x, torch.float32) for x in (A, D, states))
    plan = bwd_plan(bsz, L, d, bwd_resident(u.device.index, t == torch.bfloat16))
    lib = _build.library()
    f32 = dict(dtype=torch.float32, device=u.device)
    ws = torch.empty(bwd_workspace_floats(bsz, L, d, n, plan), **f32)
    du, ddt = torch.empty((bsz, L, d), **f32), torch.empty((bsz, L, d), **f32)
    dA, dD = torch.empty((d, n), **f32), torch.empty((d,), **f32)
    dB, dC = torch.empty((bsz, L, n), **f32), torch.empty((bsz, L, n), **f32)
    err = lib.blle_ssm_bwd(
        *(x.data_ptr() for x in (u, dt, A, B, C, D, dy, states, du, ddt, dA, dB, dC, dD, ws)),
        bsz, L, d, n, plan.chunk, plan.dgroup, int(t == torch.bfloat16), _build.stream_of(u),
    )
    _build.check(err, "selective scan backward S2")
    selective_scan_bwd.launches += 1
    return du, ddt, dA, dB, dC, dD


selective_scan_bwd.launches = 0


class SelectiveScanFn(torch.autograd.Function):
    """The scan with forward S1 (saving the states) and backward S2 (on the
    CPU: the twins). Inputs u, dt, A, B, C, D as ``selective_scan_fwd``."""

    @staticmethod
    def forward(ctx, u, dt, A, B, C, D):
        y, states = selective_scan_fwd(u, dt, A, B, C, D, save_states=True)
        ctx.save_for_backward(u, dt, A, B, C, D, states)
        return y

    @staticmethod
    def backward(ctx, dy):
        u, dt, A, B, C, D, states = ctx.saved_tensors
        grads = selective_scan_bwd(u, dt, A, B, C, D, dy, states)
        return tuple(g.to(x.dtype) for g, x in zip(grads, (u, dt, A, B, C, D)))


def selective_scan(u, dt, A, B, C, D) -> torch.Tensor:
    """y of the scan: ``SelectiveScanFn`` when grad is enabled and an input
    requires it, else ``selective_scan_fwd`` (no states)."""
    if torch.is_grad_enabled() and any(x.requires_grad for x in (u, dt, A, B, C, D)):
        return SelectiveScanFn.apply(u, dt, A, B, C, D)
    return selective_scan_fwd(u, dt, A, B, C, D)

