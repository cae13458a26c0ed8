"""Selective scan forward (S1) and backward (S2) and their ``autograd.Function``.

Port of ``bayer_low_light_image_enhancement_tpu/kernels/ssm_scan.py``:

* ``selective_scan_fwd`` (S1): y of the scan; with ``save_states`` also the
  fp32 state entering every ``STATE_EVERY`` steps (the training forward,
  TPU ``_ssm_fwd_states_kernel``; without it the inference forward, TPU
  ``_ssm_kernel``);
* ``selective_scan_bwd`` (S2): du, ddt, dA, dB, dC, dD from dy and those
  states (TPU ``_ssm_bwd_kernel``);
* ``SelectiveScanFn``: forward S1 with states, backward S2;
* ``selective_scan``: what ``ops.ssm.MambaBlock`` calls, the Function when
  grad is needed, else S1 alone.

Both wrappers run their plain twin from ``ops/ssm.py`` on a CPU tensor and
launch the CUDA kernels (``csrc/ssm_scan.cu``) on a CUDA tensor, or raise;
``selective_scan_fwd.launches`` and ``selective_scan_bwd.launches`` count
the launches. u, dt, B, C (and dy) go to the kernels in u's dtype (bf16 or
fp32); A and D in fp32; the recurrence is fp32.
"""

from __future__ import annotations

import torch

from bayer_low_light_image_enhancement_tpu_torch.kernels import _build
from bayer_low_light_image_enhancement_tpu_torch.ops import ssm

FWD_CHUNK = 128   # L-chunk per block of the forward (multiple of STATE_EVERY)
BWD_CHUNK = 128   # L-chunk per block of the backward (multiple of STATE_EVERY)
STATE_EVERY = 32  # kSub in csrc/ssm_scan.cu
MAX_STATE = 32    # one lane per state n
_WARPS = 8        # channels per forward block = d-group granularity (kScanWarps)
_BLOCKS_TARGET = 4 * 132  # backward blocks to aim for: 4 per SM of an H100
_DGROUP_MAX = 256  # channels per backward block (shared memory ~ 65 floats each)
_IN_DTYPES = (torch.float32, torch.bfloat16)


def bwd_dgroup(bsz: int, L: int, d: int) -> int:
    """Channels per backward block: all of them when the (chunk, batch) grid
    alone fills the card, else fewer, so that about ``_BLOCKS_TARGET`` blocks
    run; a multiple of 8, at most ``_DGROUP_MAX``."""
    rows = bsz * -(-L // BWD_CHUNK)
    groups = min(-(-d // _WARPS), max(1, -(-_BLOCKS_TARGET // rows)))
    dgroup = -(-(-(-d // groups)) // _WARPS) * _WARPS
    return min(dgroup, _DGROUP_MAX)


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
    CPU). CPU: the chunked twin. CUDA: the kernel, or raise."""
    if not u.is_cuda:
        return ssm.selective_scan(u, dt, A, B, C, D, chunk_size=FWD_CHUNK,
                                  state_every=STATE_EVERY if save_states else None)
    return _fwd_kernel(u, dt, A, B, C, D, save_states)


def _fwd_kernel(u, dt, A, B, C, D, save_states):
    _check(u, dt, A, B, C, D)
    bsz, L, d = u.shape
    n = A.shape[1]
    t = u.dtype
    u, dt, B, C = (_as(x, t) for x in (u, dt, B, C))
    A, D = _as(A, torch.float32), _as(D, torch.float32)
    nc = -(-L // FWD_CHUNK)
    f32 = dict(dtype=torch.float32, device=u.device)
    y = torch.empty_like(u)
    states = (torch.empty((bsz, -(-L // STATE_EVERY), d, n), **f32) if save_states else None)
    hbuf = torch.empty((bsz, nc, d, n), **f32)
    sbuf = torch.empty((bsz, nc, d), **f32)
    err = _build.library().blle_ssm_fwd(
        u.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(), D.data_ptr(),
        y.data_ptr(), None if states is None else states.data_ptr(), hbuf.data_ptr(),
        sbuf.data_ptr(), bsz, L, d, n, FWD_CHUNK, int(t == torch.bfloat16), _build.stream_of(u),
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
    dgroup = bwd_dgroup(bsz, L, d)
    lib = _build.library()
    f32 = dict(dtype=torch.float32, device=u.device)
    ws = torch.empty(lib.blle_ssm_bwd_workspace_floats(bsz, L, d, n, BWD_CHUNK, dgroup), **f32)
    du, ddt = torch.empty((bsz, L, d), **f32), torch.empty((bsz, L, d), **f32)
    dA, dD = torch.empty((d, n), **f32), torch.empty((d,), **f32)
    dB, dC = torch.empty((bsz, L, n), **f32), torch.empty((bsz, L, n), **f32)
    err = lib.blle_ssm_bwd(
        *(x.data_ptr() for x in (u, dt, A, B, C, D, dy, states, du, ddt, dA, dB, dC, dD, ws)),
        bsz, L, d, n, BWD_CHUNK, dgroup, int(t == torch.bfloat16), _build.stream_of(u),
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

