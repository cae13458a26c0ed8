"""Selective state-space (Mamba-style) sequence op and the Mamba block.

Port of ``bayer_low_light_image_enhancement_tpu/ops/ssm.py``. Per batch b,
channel d and state n:

    a_t = exp(dt_t A),   h_t = a_t h_{t-1} + dt_t u_t B_t,   y_t = C_t . h_t + D u_t

This module holds the plain PyTorch twins of the scan kernels
(``kernels/ssm_scan.py``, ``csrc/ssm_scan.cu``):

* ``selective_scan``: the forward, chunked over L with the [B, D, N] state
  carried across chunks; inside a chunk an inclusive Hillis-Steele scan of
  the composition monoid ``(a2, b2) o (a1, b1) = (a1 a2, a2 b1 + b2)`` over
  [B, Lc, D, N] (the monoid of the TPU kernel's ``_discretize`` +
  ``_hs_fwd``). With ``state_every`` it also returns the state entering
  every ``state_every``-step sub-chunk, as the forward kernel saves them.
* ``selective_scan_bwd_ref``: the explicit backward, the reverse-scan
  adjoint of the TPU kernel ``_ssm_bwd_kernel``: per chunk from the last, h
  is recomputed from the chunk's entry state and
  ``lam_t = C_t dy_t + a_{t+1} lam_{t+1}`` is scanned backwards with the
  carry from the chunk to the right; it returns du, ddt, dA, dB, dC, dD.
* ``selective_scan_ref``: the sequential recurrence, for the tests.

The recurrence runs in fp32 whatever the input dtype (fp64 for fp64 inputs,
so that ``torch.autograd.gradcheck`` can run on the twins); y comes back in
u's dtype.

``MambaBlock`` is mamba_ssm's layer (in_proj -> causal depthwise conv1d ->
SiLU -> x_proj -> dt_proj + softplus -> scan -> SiLU(z) gate -> out_proj)
with the reference's parameter names; its scan goes to the kernel wrapper
``kernels.ssm_scan.selective_scan`` (the kernels on the card, these twins on
the CPU) unless ``fused`` is False.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F


def _compute_dtype(*ts: torch.Tensor) -> torch.dtype:
    return torch.float64 if any(t.dtype == torch.float64 for t in ts) else torch.float32


def _monoid_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Inclusive scan over dim 1 of ``h_t = a_t h_{t-1} + b_t`` from h = 0
    (Hillis-Steele, log2(L) passes); returns h."""
    k, lc = 1, a.shape[1]
    while k < lc:
        b = torch.cat([b[:, :k], a[:, k:] * b[:, :-k] + b[:, k:]], 1)
        a = torch.cat([a[:, :k], a[:, k:] * a[:, :-k]], 1)
        k *= 2
    return b


def _discretize(u, dt, A, B):
    """a = exp(dt A), b = (dt u) B -> [B, Lc, D, N] each."""
    a = torch.exp(dt[..., None] * A)
    b = (dt * u)[..., None] * B[:, :, None, :]
    return a, b


def _scan_chunk(u, dt, A, B, C, h0):
    """One chunk from state h0 [B, D, N] -> (y [B, Lc, D] without the D
    skip, h [B, Lc, D, N])."""
    a, b = _discretize(u, dt, A, B)
    b = torch.cat([b[:, :1] + a[:, :1] * h0[:, None], b[:, 1:]], 1)
    h = _monoid_scan(a, b)
    return torch.einsum("bldn,bln->bld", h, C), h


def selective_scan(
    u: torch.Tensor,       # [B, L, D]
    delta: torch.Tensor,   # [B, L, D] positive step sizes
    A: torch.Tensor,       # [D, N]
    B: torch.Tensor,       # [B, L, N]
    C: torch.Tensor,       # [B, L, N]
    D: Optional[torch.Tensor] = None,  # [D]
    chunk_size: int = 256,
    state_every: Optional[int] = None,
):
    """Chunked selective scan -> y [B, L, D] in u's dtype; with
    ``state_every`` (a divisor of ``chunk_size``) also the states entering
    every ``state_every`` steps, [B, ceil(L / state_every), D, N]."""
    if state_every is not None and chunk_size % state_every:
        raise ValueError(f"chunk_size {chunk_size} is not a multiple of {state_every}")
    ct = _compute_dtype(u, delta, A, B, C)
    bsz, L, d = u.shape
    uf, dtf, Af, Bf, Cf = (t.to(ct) for t in (u, delta, A, B, C))
    h = torch.zeros(bsz, d, A.shape[1], dtype=ct, device=u.device)
    ys, states = [], []
    for t0 in range(0, L, chunk_size):
        sl = slice(t0, t0 + chunk_size)
        y, hc = _scan_chunk(uf[:, sl], dtf[:, sl], Af, Bf[:, sl], Cf[:, sl], h)
        if state_every is not None:
            states += [h] + [hc[:, j - 1] for j in range(state_every, hc.shape[1], state_every)]
        h = hc[:, -1]
        ys.append(y)
    y = torch.cat(ys, 1)
    if D is not None:
        y = y + uf * D.to(ct)
    if state_every is None:
        return y.to(u.dtype)
    return y.to(u.dtype), torch.stack(states, 1)


def selective_scan_bwd_ref(u, delta, A, B, C, D, dy, chunk_size: int = 64):
    """The explicit backward of ``selective_scan``: dy [B, L, D] ->
    (du, ddt, dA, dB, dC, dD) in the compute dtype (dD None without D).

    Per chunk, last first: h from the chunk's entry state, then the reverse
    scan ``lam_t = C_t dy_t + a_{t+1} lam_{t+1}`` with ``mu = a_first
    lam_first`` carried into the chunk to the left."""
    ct = _compute_dtype(u, delta, A, B, C, dy)
    uf, dtf, Af, Bf, Cf, dyf = (t.to(ct) for t in (u, delta, A, B, C, dy))
    L = u.shape[1]
    _, entries = selective_scan(uf, dtf, Af, Bf, Cf, None, chunk_size, state_every=chunk_size)
    mu = torch.zeros_like(entries[:, 0])
    du, ddt, dB, dC = [], [], [], []
    dA = torch.zeros_like(Af)
    for c in reversed(range(entries.shape[1])):
        sl = slice(c * chunk_size, min(L, (c + 1) * chunk_size))
        u_c, dt_c, B_c, C_c, dy_c = uf[:, sl], dtf[:, sl], Bf[:, sl], Cf[:, sl], dyf[:, sl]
        h_in = entries[:, c]
        a, _ = _discretize(u_c, dt_c, Af, B_c)
        _, h = _scan_chunk(u_c, dt_c, Af, B_c, C_c, h_in)
        h_prev = torch.cat([h_in[:, None], h[:, :-1]], 1)
        src = C_c[:, :, None, :] * dy_c[..., None]
        src = torch.cat([src[:, :-1], src[:, -1:] + mu[:, None]], 1)
        alpha = torch.cat([a[:, 1:], torch.ones_like(a[:, :1])], 1)
        lam = _monoid_scan(alpha.flip(1), src.flip(1)).flip(1)
        mu = a[:, 0] * lam[:, 0]
        dtu = (lam * B_c[:, :, None, :]).sum(-1)             # dL/d(dt u)  [B, Lc, D]
        g = lam * h_prev * a                                  # dL/d(dt A)  [B, Lc, D, N]
        dA = dA + (g * dt_c[..., None]).sum((0, 1))
        du.append(dtu * dt_c + (0.0 if D is None else dy_c * D.to(ct)))
        ddt.append(dtu * u_c + (g * Af).sum(-1))
        dB.append((lam * (dt_c * u_c)[..., None]).sum(2))
        dC.append((h * dy_c[..., None]).sum(2))
    dD = None if D is None else (dyf * uf).sum((0, 1))
    cat = lambda xs: torch.cat(xs[::-1], 1)  # noqa: E731
    return cat(du), cat(ddt), dA, cat(dB), cat(dC), dD


def selective_scan_ref(u, delta, A, B, C, D=None):
    """Sequential recurrence (for the tests) -> y in u's dtype."""
    ct = _compute_dtype(u, delta, A, B, C)
    uf, dtf, Af, Bf, Cf = (t.to(ct) for t in (u, delta, A, B, C))
    h = torch.zeros(u.shape[0], u.shape[2], A.shape[1], dtype=ct, device=u.device)
    ys = []
    for t in range(u.shape[1]):
        a = torch.exp(dtf[:, t, :, None] * Af)
        h = a * h + (dtf[:, t] * uf[:, t])[..., None] * Bf[:, t, None]
        ys.append(torch.einsum("bdn,bn->bd", h, Cf[:, t]))
    y = torch.stack(ys, 1)
    if D is not None:
        y = y + uf * D.to(ct)
    return y.to(u.dtype)


class MambaBlock(nn.Module):
    """mamba_ssm.Mamba's layer: [B, L, d_model] -> [B, L, d_model].

    ``dt_rank = ceil(d_model / 16)``; in_proj and x_proj without bias,
    dt_proj with; a causal depthwise conv1d of width ``d_conv`` (left zero
    pad); ``A = -exp(A_log)`` and ``D`` in fp32. Projections and the conv run
    in ``compute_dtype``; the scan in fp32 with y in ``compute_dtype``.
    ``fused`` routes the scan to the kernel wrapper (on by default; on CPU
    tensors the twins run either way), False to the twin everywhere."""

    def __init__(self, d_model: int, d_state: int = 32, d_conv: int = 4, expand: int = 2,
                 *, device=None, dtype=torch.float32, compute_dtype=torch.float32):
        super().__init__()
        d_inner = expand * d_model
        self.d_state, self.d_conv = d_state, d_conv
        self.dt_rank = math.ceil(d_model / 16)
        self.compute_dtype = compute_dtype
        kw = dict(device=device, dtype=dtype)
        self.in_proj = nn.Linear(d_model, 2 * d_inner, bias=False, **kw)
        self.conv1d = nn.Conv1d(d_inner, d_inner, d_conv, groups=d_inner, bias=True, **kw)
        self.x_proj = nn.Linear(d_inner, self.dt_rank + 2 * d_state, bias=False, **kw)
        self.dt_proj = nn.Linear(self.dt_rank, d_inner, bias=True, **kw)
        a = torch.arange(1, d_state + 1, dtype=torch.float32, device=device).repeat(d_inner, 1)
        self.A_log = nn.Parameter(torch.log(a))
        self.D = nn.Parameter(torch.ones(d_inner, device=device))
        self.out_proj = nn.Linear(d_inner, d_model, bias=False, **kw)
        self.fused = True

    def _linear(self, m: nn.Linear, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        return F.linear(x.to(cd), m.weight.to(cd), None if m.bias is None else m.bias.to(cd))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        xi, z = self._linear(self.in_proj, x).chunk(2, dim=-1)
        xc = F.conv1d(F.pad(xi.transpose(1, 2), (self.d_conv - 1, 0)), self.conv1d.weight.to(cd),
                      self.conv1d.bias.to(cd), groups=xi.shape[-1])
        xc = F.silu(xc.transpose(1, 2))
        dt, B, C = torch.split(self._linear(self.x_proj, xc),
                               [self.dt_rank, self.d_state, self.d_state], dim=-1)
        dt = F.softplus(self._linear(self.dt_proj, dt))
        A = -torch.exp(self.A_log.float())
        if self.fused:
            from bayer_low_light_image_enhancement_tpu_torch.kernels import ssm_scan

            y = ssm_scan.selective_scan(xc, dt, A, B, C, self.D.float())
        else:
            y = selective_scan(xc, dt, A, B, C, self.D.float())
        y = y * F.silu(z)
        return self._linear(self.out_proj, y)
