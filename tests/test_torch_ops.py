"""Port ops (bayer_low_light_image_enhancement_tpu_torch.ops) against the JAX
package's ops on the same inputs, fp32, CPU."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from bayer_low_light_image_enhancement_tpu import ops as jops
from bayer_low_light_image_enhancement_tpu.ops import bayer as jbayer
from bayer_low_light_image_enhancement_tpu_torch import ops as tops

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)


def rng(seed):
    return np.random.default_rng(seed)


def both(fn_t, fn_j, *arrays, **kw):
    """Run the port and the JAX op on the same numpy inputs."""
    got = fn_t(*(torch.from_numpy(a) for a in arrays), **kw)
    want = fn_j(*(jnp.asarray(a) for a in arrays), **kw)
    return got.detach().numpy(), np.asarray(want)


@pytest.mark.parametrize("r", [2, 4])
def test_space_to_depth(r):
    x = rng(1).standard_normal((2, 8, 12, 3)).astype(np.float32)
    got, want = both(tops.space_to_depth, jops.space_to_depth, x, r=r)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("r", [2, 4])
def test_depth_to_space(r):
    x = rng(2).standard_normal((2, 3, 5, 3 * r * r)).astype(np.float32)
    got, want = both(tops.depth_to_space, jops.depth_to_space, x, r=r)
    np.testing.assert_array_equal(got, want)


def test_space_to_depth_rejects_indivisible():
    with pytest.raises(ValueError):
        tops.space_to_depth(torch.zeros(1, 5, 4, 1), 2)


@pytest.mark.parametrize("bias_free", [False, True])
@pytest.mark.parametrize("affine", [False, True])
def test_channel_layernorm(bias_free, affine):
    g = rng(3)
    x = (g.standard_normal((2, 5, 7, 16)) * 3 + 1).astype(np.float32)
    w = g.standard_normal(16).astype(np.float32) if affine else None
    b = g.standard_normal(16).astype(np.float32) if affine else None
    got = tops.channel_layernorm(
        torch.from_numpy(x), None if w is None else torch.from_numpy(w),
        None if b is None else torch.from_numpy(b), bias_free=bias_free)
    want = jops.channel_layernorm(
        jnp.asarray(x), None if w is None else jnp.asarray(w),
        None if b is None else jnp.asarray(b), bias_free=bias_free)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize(
    "k,cin,cout,stride,groups,dilation",
    [
        (3, 4, 8, 1, 1, 1),
        (1, 8, 6, 1, 1, 1),
        (3, 8, 4, 2, 1, 1),   # strided: torch symmetric padding, not SAME
        (3, 12, 12, 1, 12, 1),  # depthwise
        (3, 4, 4, 1, 1, 2),   # dilated
    ],
)
def test_conv2d(k, cin, cout, stride, groups, dilation):
    g = rng(4)
    x = g.standard_normal((2, 10, 14, cin)).astype(np.float32)
    w = g.standard_normal((k, k, cin // groups, cout)).astype(np.float32) * 0.3
    b = g.standard_normal(cout).astype(np.float32)
    got = tops.conv2d(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
                      stride=stride, groups=groups, dilation=dilation)
    want = jops.conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                       stride=stride, groups=groups, dilation=dilation)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_leaky_relu():
    x = rng(5).standard_normal((3, 4, 5, 6)).astype(np.float32)
    got, want = both(tops.leaky_relu, jops.leaky_relu, x)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("heads,c", [(1, 8), (2, 8), (4, 16)])
def test_channel_attention(heads, c):
    g = rng(6)
    q, k, v = (g.standard_normal((2, 6, 5, c)).astype(np.float32) for _ in range(3))
    t = (1 + g.uniform(-0.5, 0.5, heads)).astype(np.float32)
    got = tops.channel_attention(*(torch.from_numpy(a) for a in (q, k, v, t)), heads)
    want = jops.channel_attention(*(jnp.asarray(a) for a in (q, k, v, t)), heads)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_cfa_patterns_match():
    assert tops.CFA_PATTERNS == jbayer.CFA_PATTERNS


@pytest.mark.parametrize("pattern", ["RGGB", "BGGR", "GRBG", "GBRG"])
def test_pack_bayer(pattern):
    x = rng(7).standard_normal((2, 8, 10, 1)).astype(np.float32)
    got, want = both(tops.pack_bayer, jbayer.pack_bayer, x, pattern=pattern)
    np.testing.assert_array_equal(got, want)


def test_normalize_sid():
    g = rng(8)
    m = g.integers(0, 17000, (2, 6, 8, 1)).astype(np.uint16)
    m[0, 0, 0, 0] = 40000  # hot pixel above the white level
    ratio = g.uniform(1, 300, (2, 1, 1, 1)).astype(np.float32)
    got = tops.normalize_sid(torch.from_numpy(m.astype(np.int32)), torch.from_numpy(ratio))
    want = jbayer.normalize_sid(jnp.asarray(m), jnp.asarray(ratio))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_normalize_mcr():
    g = rng(9)
    raw = g.integers(0, 256, (2, 6, 8, 1)).astype(np.uint8)
    got = tops.normalize_mcr(torch.from_numpy(raw), 4.0)
    want = jbayer.normalize_mcr(jnp.asarray(raw), 4.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
