"""The port's selective scan and Mamba block against the JAX package (CPU):
the chunked forward twin against the JAX sequential and chunked scans and
the Pallas kernel (interpret mode), its saved states, causality, the
explicit backward twin against ``jax.grad`` and torch autograd,
``SelectiveScanFn`` under ``gradcheck``, and ``MambaBlock`` forward and
grads on carried params. fp32 tolerances: 2e-5 on y (as
tests/test_ssm_pallas.py), 1e-4 of each grad leaf's max."""

import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from bayer_low_light_image_enhancement_tpu.kernels.ssm_scan import selective_scan_pallas
from bayer_low_light_image_enhancement_tpu.ops import ssm as jssm
from bayer_low_light_image_enhancement_tpu_torch.kernels import ssm_scan as ks
from bayer_low_light_image_enhancement_tpu_torch.ops import ssm

torch.set_num_threads(2)

RNG = np.random.default_rng(31)


def case(b, L, d, n, seed=0):
    """u, dt, A, B, C, D, dy as float32 numpy (softplus-like dt, negative A)."""
    g = np.random.default_rng(seed)
    u = g.standard_normal((b, L, d)) * 0.5
    dt = g.uniform(0.05, 0.6, (b, L, d))
    A = -np.exp(g.standard_normal((d, n)) * 0.3)
    B, C = g.standard_normal((b, L, n)) * 0.5, g.standard_normal((b, L, n)) * 0.5
    D, dy = g.standard_normal(d) * 0.3, g.standard_normal((b, L, d))
    return [a.astype(np.float32) for a in (u, dt, A, B, C, D, dy)]


def to_t(arrays):
    return [torch.from_numpy(a) for a in arrays]


def to_j(arrays):
    return [jnp.asarray(a) for a in arrays]


# tests/test_ssm_pallas.py's shapes: multi-chunk carry, ragged L (200 in
# chunks of 128), D > 128 (130).
@pytest.mark.parametrize("b,L,d,n,chunk", [(2, 64, 24, 8, 16), (1, 200, 96, 32, 128),
                                           (2, 96, 130, 32, 64)])
def test_forward_twin_matches_jax_scans(b, L, d, n, chunk):
    *args, _ = case(b, L, d, n, seed=L)
    want = np.asarray(jssm.selective_scan_ref(*to_j(args)))
    chunked = jax.jit(functools.partial(jssm.selective_scan, chunk_size=chunk))
    for name, jy in (("chunked", chunked(*to_j(args))),
                     ("pallas", selective_scan_pallas(*to_j(args), chunk=chunk))):
        np.testing.assert_allclose(np.asarray(jy), want, rtol=2e-5, atol=2e-5, err_msg=name)
    for name, y in (("twin", ssm.selective_scan(*to_t(args), chunk_size=chunk)),
                    ("wrapper", ks.selective_scan_fwd(*to_t(args))),
                    ("sequential", ssm.selective_scan_ref(*to_t(args)))):
        np.testing.assert_allclose(y.numpy(), want, rtol=2e-5, atol=2e-5, err_msg=name)


def test_saved_states_are_the_prefix_states():
    """The state saved for sub-chunk k is the recurrence's state after the
    first k * STATE_EVERY steps (a float64 numpy loop)."""
    u, dt, A, B, C, D, _ = args = case(2, 100, 6, 5, seed=4)
    y, states = ks.selective_scan_fwd(*to_t(args[:6]), save_states=True)
    assert states.shape == (2, 4, 6, 5)
    h = np.zeros((2, 6, 5))
    for t in range(100):
        if t % ks.STATE_EVERY == 0:
            np.testing.assert_allclose(states[:, t // ks.STATE_EVERY].numpy(), h, rtol=2e-5,
                                       atol=2e-5)
        h = np.exp(dt[:, t, :, None] * A) * h + (dt[:, t] * u[:, t])[..., None] * B[:, t, None]
    np.testing.assert_allclose(y.numpy(), ks.selective_scan_fwd(*to_t(args[:6])).numpy())


def test_causality():
    u, dt, A, B, C, D, _ = to_t(case(1, 64, 16, 8, seed=5))
    u2 = u.clone()
    u2[:, 40:] += 100.0
    y1, y2 = (ssm.selective_scan(x, dt, A, B, C, D, chunk_size=16) for x in (u, u2))
    torch.testing.assert_close(y1[:, :40], y2[:, :40], rtol=1e-5, atol=1e-5)
    assert (y1[:, 40:] - y2[:, 40:]).abs().max() > 1e-3


def leaf_errors(got, want):
    return {name: float(np.abs(np.asarray(g) - np.asarray(w)).max() / np.abs(np.asarray(w)).max())
            for name, g, w in zip(("du", "ddt", "dA", "dB", "dC", "dD"), got, want)}


# tests/test_ssm_train.py's shapes: one chunk, a 4-chunk carry, ragged L,
# several D blocks; chunk 16 in the backward twin.
@pytest.mark.parametrize("b,L,d,n", [(2, 16, 8, 4), (2, 64, 8, 4), (1, 37, 10, 4), (1, 32, 24, 4)])
def test_backward_twin_matches_jax_grad_and_autograd(b, L, d, n):
    *args, dy = case(b, L, d, n, seed=b * L + d)
    got = ssm.selective_scan_bwd_ref(*to_t(args), torch.from_numpy(dy), chunk_size=16)

    def loss(*a):
        return jnp.sum(jssm.selective_scan_ref(*a) * jnp.asarray(dy))

    want = jax.grad(loss, argnums=tuple(range(6)))(*to_j(args))
    errs = leaf_errors([g.numpy() for g in got], want)
    assert max(errs.values()) < 1e-4, errs
    leaves = [t.requires_grad_() for t in to_t(args)]
    auto = torch.autograd.grad(ssm.selective_scan(*leaves, chunk_size=16), leaves,
                               torch.from_numpy(dy))
    errs = leaf_errors([g.numpy() for g in got], [a.numpy() for a in auto])
    assert max(errs.values()) < 1e-4, errs


def test_selective_scan_fn_gradcheck():
    """SelectiveScanFn on CPU tensors (forward twin with states, explicit
    backward twin) in float64; 70 steps span two backward-twin chunks."""
    leaves = [torch.from_numpy(a.astype(np.float64)).requires_grad_()
              for a in case(1, 70, 2, 3, seed=9)[:6]]
    assert torch.autograd.gradcheck(ks.SelectiveScanFn.apply, leaves)


def mamba_state_dict(p):
    """JAX MambaBlock params -> the port's MambaBlock state_dict."""
    t = lambda a: torch.from_numpy(np.array(a, np.float32))  # noqa: E731
    sd = {f"{k}.weight": t(np.asarray(p[k]["kernel"]).T)
          for k in ("in_proj", "x_proj", "dt_proj", "out_proj")}
    sd.update({"dt_proj.bias": t(p["dt_proj"]["bias"]), "A_log": t(p["A_log"]), "D": t(p["D"]),
               "conv1d.weight": t(np.transpose(np.asarray(p["conv1d_kernel"]), (2, 1, 0))),
               "conv1d.bias": t(p["conv1d_bias"])})
    return sd


@pytest.mark.parametrize("fused", [True, False])
def test_mamba_block_matches_jax(fused):
    """Forward and the grads of every parameter and of x, against the JAX
    MambaBlock (XLA scan) on carried params; ``fused`` routes the scan
    through SelectiveScanFn (twins on the CPU), else the twin's autograd."""
    d_model, L = 24, 50
    x = RNG.standard_normal((2, L, d_model)).astype(np.float32)
    dy = RNG.standard_normal((2, L, d_model)).astype(np.float32)
    jm = jssm.MambaBlock(d_model=d_model)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    g = np.random.default_rng(1)

    def fill(path, s):  # fan-in-scaled kernels, A_log near log(1..N), D near 1
        name = jax.tree_util.keystr(path)
        v = g.uniform(-1.0, 1.0, s.shape) / np.sqrt(np.prod(s.shape[:-1]))
        if "A_log" in name:
            v = np.log(np.arange(1, s.shape[1] + 1)) + 0.2 * v
        elif "D" in name:
            v = 1.0 + 0.5 * v
        return v.astype(np.float32)

    params = jax.tree_util.tree_map_with_path(fill, shapes)

    def loss(p, xx):
        return jnp.sum(jm.apply({"params": p}, xx) * jnp.asarray(dy))

    want_y = np.asarray(jax.jit(jm.apply)({"params": params}, jnp.asarray(x)))
    want_gp, want_gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(params, jnp.asarray(x))

    port = ssm.MambaBlock(d_model)
    port.load_state_dict(mamba_state_dict(params))
    port.fused = fused
    xt = torch.from_numpy(x).requires_grad_()
    before = ks.selective_scan_fwd.launches
    y = port(xt)
    np.testing.assert_allclose(y.detach().numpy(), want_y, rtol=1e-4, atol=1e-5)
    (y * torch.from_numpy(dy)).sum().backward()
    assert ks.selective_scan_fwd.launches == before  # CPU tensors: the twins, no kernel
    want = mamba_state_dict(want_gp)
    want["dt_proj.bias"] = torch.from_numpy(np.array(want_gp["dt_proj"]["bias"]))
    for name, p in port.named_parameters():
        w = want[name].numpy()
        err = np.abs(p.grad.numpy() - w).max() / np.abs(w).max()
        assert err < 1e-4, (name, err)
    err = np.abs(xt.grad.numpy() - np.asarray(want_gx)).max() / np.abs(np.asarray(want_gx)).max()
    assert err < 1e-4, err


def test_kernel_wrappers_refuse_bad_inputs():
    """The checks that guard the CUDA entry points, reachable without a card."""
    u, dt, A, B, C, D, _ = to_t(case(1, 8, 4, 40))
    with pytest.raises(ValueError, match="N <= 32"):
        ks._check(u, dt, A, B, C, D)
    u, dt, A, B, C, D, _ = to_t(case(1, 8, 4, 8))
    with pytest.raises(ValueError, match="shape"):
        ks._check(u, dt[:, :4], A, B, C, D)
    with pytest.raises(TypeError):
        ks._check(u.double(), dt, A, B, C, D)


# S2's plan on an H100 at two resident blocks per SM (132 x 2): (B, L, D)
# -> (channels per block, per warp, groups, blocks). The WFB-48 scan shapes
# at batch 2 (b = 6) and 8 (b = 24) @ 512^2, then the card tests' ragged ones.
@pytest.mark.parametrize("shape,want", [
    ((24, 16384, 96), (32, 8, 3, 9216)), ((24, 4096, 192), (40, 10, 5, 3840)),
    ((24, 1024, 384), (40, 10, 10, 1920)), ((24, 256, 768), (40, 10, 20, 960)),
    ((6, 16384, 96), (32, 8, 3, 2304)), ((6, 4096, 192), (40, 10, 5, 960)),
    ((6, 1024, 384), (36, 9, 11, 528)), ((6, 256, 768), (20, 5, 39, 468)),
    ((1, 77, 13), (4, 1, 4, 4)), ((2, 300, 20), (4, 1, 5, 30)), ((3, 1000, 40), (4, 1, 10, 240)),
])
def test_backward_plan(shape, want):
    """Few groups (at most BWD_DGROUP_MAX channels a block), more while the
    grid is short of BWD_WAVES x the resident blocks; the groups cover D
    with a ragged last one."""
    bsz, L, d = shape
    plan = ks.bwd_plan(bsz, L, d, resident=2 * 132)
    assert (plan.dgroup, plan.per_warp, plan.groups, plan.blocks) == want
    assert plan.chunk == ks.BWD_CHUNK and plan.chunk % ks.STATE_EVERY == 0
    assert plan.dgroup == plan.per_warp * ks.BWD_WARPS <= ks.BWD_DGROUP_MAX
    assert (plan.groups - 1) * plan.dgroup < d <= plan.groups * plan.dgroup
    assert plan.blocks == bsz * -(-L // plan.chunk) * plan.groups


def test_backward_plan_follows_occupancy():
    """A card that holds fewer blocks at once gets fewer, wider groups."""
    wide = ks.bwd_plan(6, 1024, 384, resident=132)
    narrow = ks.bwd_plan(6, 1024, 384, resident=4 * 132)
    assert wide.groups < narrow.groups and wide.dgroup > narrow.dgroup
    assert ks.bwd_plan(24, 16384, 96, resident=1).groups == 3  # BWD_DGROUP_MAX caps the width


@pytest.mark.parametrize("shape,n,want", [
    ((24, 16384, 96), 32, 2 * 24 * 128 * 96 * 33 + 2 * 3 * 24 * 16384 * 32),
    ((1, 77, 13), 8, 2 * 1 * 1 * 13 * 9 + 2 * 4 * 77 * 8),
    ((8, 16384, 32), 32, 2 * 8 * 128 * 32 * 33),  # one group: no dB / dC partials
])
def test_backward_workspace_floats(shape, n, want):
    """What the wrapper allocates for S2: chunk carries, sums of dt, dA and
    dD partials, and dB / dC partials only with several groups."""
    plan = ks.bwd_plan(*shape, resident=2 * 132)
    assert ks.bwd_workspace_floats(*shape, n, plan) == want


# S1's plan on an H100 at two resident 8-warp blocks per SM (132 x 2 x 8
# warps): (B, L, D) -> (chunk, chunks, launches). The WFB-48 scan shapes at
# batch 2 (b = 6) and 8 (b = 24) @ 512^2, then the card tests' ragged ones.
H100_FWD_RESIDENT = 132 * 2 * 8


@pytest.mark.parametrize("shape,want", [
    ((6, 16384, 96), (288, 57, 2)), ((6, 4096, 192), (160, 26, 2)),
    ((6, 1024, 384), (64, 16, 2)), ((6, 256, 768), (256, 1, 1)),
    ((24, 16384, 96), (1024, 16, 2)), ((24, 4096, 192), (4096, 1, 1)),
    ((24, 1024, 384), (1024, 1, 1)), ((24, 256, 768), (256, 1, 1)),
    ((1, 77, 13), (32, 3, 2)), ((2, 20, 24), (32, 1, 1)), ((3, 1000, 44), (32, 32, 2)),
])
def test_forward_plan(shape, want):
    """One chunk where the (b, d) walks fill the card; else enough chunks
    for FWD_WAVES x the resident warps in each pass; chunks a multiple of
    STATE_EVERY that cover L."""
    bsz, L, d = shape
    plan = ks.fwd_plan(bsz, L, d, resident=H100_FWD_RESIDENT)
    assert (plan.chunk, plan.chunks, plan.launches) == want
    assert plan.chunk % ks.STATE_EVERY == 0
    assert (plan.chunks - 1) * plan.chunk < L <= plan.chunks * plan.chunk


def test_forward_plan_one_chunk_where_the_walks_fill_the_card():
    """Walks that fill 1 / FWD_ONE_CHUNK of the resident warps: one chunk
    and one launch, whatever L."""
    for L in (32, 1000, 16384, 100000):
        walks = ks.FWD_STATES_PER_LANE * -(-H100_FWD_RESIDENT // ks.FWD_ONE_CHUNK)
        plan = ks.fwd_plan(1, L, walks, resident=H100_FWD_RESIDENT)
        assert (plan.chunks, plan.launches) == (1, 1) and plan.chunk >= L
        plan = ks.fwd_plan(1, L, walks - ks.FWD_STATES_PER_LANE, resident=H100_FWD_RESIDENT)
        assert plan.chunks > 1 or L <= ks.STATE_EVERY


def test_forward_plan_follows_occupancy():
    """A card that holds more warps at once gets more chunks (never 2 where
    L allows 3), down to one sub-chunk a chunk."""
    for shape in [(6, 16384, 96), (24, 16384, 96), (6, 1024, 384)]:
        chunks = [ks.fwd_plan(*shape, resident=132 * 8 * k).chunks for k in (1, 2, 4, 8, 64)]
        assert chunks == sorted(chunks) and chunks[-1] > chunks[0], chunks
        assert 2 not in chunks
    assert ks.fwd_plan(6, 1024, 384, resident=10 ** 9).chunk == ks.STATE_EVERY


@pytest.mark.parametrize("shape,n,want", [
    ((6, 16384, 96), 32, 6 * 56 * 96 * 33), ((24, 256, 768), 32, 0), ((1, 77, 13), 8, 2 * 13 * 9),
])
def test_forward_scratch_floats(shape, n, want):
    """What the wrapper allocates for S1: the end states and sums of dt of
    every chunk but the last; nothing for one chunk."""
    plan = ks.fwd_plan(*shape, resident=H100_FWD_RESIDENT)
    assert ks.fwd_scratch_floats(shape[0], shape[2], n, plan) == want
