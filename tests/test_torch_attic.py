"""The standalone channel attention (A1) and stage tail (T1) twins against
the JAX package's retired kernels ``attic/fused_attention.py`` and
``attic/fused_stage.py`` (Pallas in interpret mode) and against the fp32
JAX modules. The CUDA kernels against their twins are in
tests/test_torch_cuda.py."""

import pathlib
import sys

import numpy as np
import pytest
import torch
import flax.linen as nn
import jax
import jax.numpy as jnp

from bayer_low_light_image_enhancement_tpu.models.common import ChannelAttention as JaxAttention
from bayer_low_light_image_enhancement_tpu.models.common import ConvTransformer as JaxStage
from bayer_low_light_image_enhancement_tpu_torch.compat.jax_params import (
    channel_attention_state_dict,
    stage_tail_state_dict,
)
from bayer_low_light_image_enhancement_tpu_torch.kernels import fused_attention as fa
from bayer_low_light_image_enhancement_tpu_torch.kernels import fused_stage as fs

torch.set_num_threads(2)

SHAPES = [(2, 16, 16, 32), (1, 16, 24, 64)]


def attic(name):
    """A module of the repository's attic/ (the port never imports it)."""
    path = str(pathlib.Path(__file__).resolve().parents[1] / "attic")
    if path not in sys.path:
        sys.path.insert(0, path)
    return __import__(name)


class Given(nn.Module):
    """A ConvTransformer branch that returns the t it is given."""

    @nn.compact
    def __call__(self, x, t):
        return t


def inputs(shape, seed):
    g = np.random.default_rng(seed)
    x = g.standard_normal(shape).astype(np.float32)
    t = g.standard_normal(shape).astype(np.float32)
    # bf16-representable, so the bf16 kernels and the fp32 paths see one input
    rb = lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)  # noqa: E731
    return rb(x), rb(t)


def attention_params(c, heads, seed):
    p = JaxAttention(num_heads=heads).init(jax.random.PRNGKey(seed), jnp.zeros((1, 8, 8, c)))
    p = jax.tree.map(np.asarray, p["params"])
    p["temperature"] = p["temperature"] + np.random.default_rng(seed).uniform(
        -0.5, 0.5, heads).astype(np.float32)
    return p


def stage_params(c, seed):
    p = JaxStage(inner=Given).init(jax.random.PRNGKey(seed), jnp.zeros((1, 8, 8, c)),
                                   jnp.zeros((1, 8, 8, c)))
    return jax.tree.map(np.asarray, p["params"])


@pytest.mark.parametrize("shape", SHAPES)
def test_attention_twin_matches_attic_kernel_and_module(shape):
    c, heads = shape[-1], 4
    p = attention_params(c, heads, seed=c)
    x, _ = inputs(shape, seed=c)
    kern = attic("fused_attention").fused_channel_attention(
        jnp.asarray(x, jnp.bfloat16), p["qkv"]["kernel"], p["qkv"]["bias"],
        p["qkv_dwconv"]["kernel"], p["qkv_dwconv"]["bias"], p["project_out"]["kernel"],
        p["project_out"]["bias"], jnp.asarray(p["temperature"]), heads)
    kern = np.asarray(kern, np.float32)
    module = np.asarray(JaxAttention(num_heads=heads).apply({"params": p}, jnp.asarray(x)))
    got = fa.fused_channel_attention(torch.from_numpy(x), channel_attention_state_dict(p),
                                     heads).numpy()
    assert got.shape == shape
    assert np.abs(got - kern).max() <= 2e-2 * np.abs(kern).max()
    np.testing.assert_allclose(got, module, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("shape", SHAPES)
def test_stage_tail_twin_matches_attic_kernel_and_module(shape):
    c = shape[-1]
    p = stage_params(c, seed=c + 1)
    x, t = inputs(shape, seed=c + 1)
    kern = attic("fused_stage").fused_stage_tail(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(t, jnp.bfloat16), p)
    kern = np.asarray(kern, np.float32)
    module = np.asarray(JaxStage(inner=Given).apply({"params": p}, jnp.asarray(x),
                                                    jnp.asarray(t)))
    got = fs.fused_stage_tail(torch.from_numpy(x), torch.from_numpy(t),
                              stage_tail_state_dict(p)).numpy()
    assert got.shape == shape
    assert np.abs(got - kern).max() <= 2e-2 * np.abs(kern).max()
    np.testing.assert_allclose(got, module, rtol=1e-4, atol=1e-4)


def test_port_modules_agree_with_twins():
    """The port's own ChannelAttention and ConvTransformer (module path)
    compute what the A1 and T1 twins compute, on their state dicts."""
    from bayer_low_light_image_enhancement_tpu_torch.models import common

    gen = torch.Generator().manual_seed(4)
    stage = common.ConvTransformer(32, 4, 2)
    common.reset_parameters_(stage, gen)
    sd = {k: v.detach() for k, v in stage.state_dict().items()}
    x = torch.randn(2, 32, 10, 12, generator=gen).contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        t = stage.Transformer(x)
        attn = stage.Transformer.attn(x)
        tail = stage(x)
    nhwc = lambda a: a.permute(0, 2, 3, 1)  # noqa: E731
    asd = {k.removeprefix("Transformer.attn."): v for k, v in sd.items()
           if k.startswith("Transformer.attn.")}
    torch.testing.assert_close(fa.fused_channel_attention_plain(nhwc(x), asd, 4), nhwc(attn),
                               rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(fs.fused_stage_tail_plain(nhwc(x), nhwc(t), sd), nhwc(tail),
                               rtol=1e-5, atol=1e-5)


def test_wrappers_run_twins_on_cpu():
    p = attention_params(32, 2, seed=7)
    sp = stage_params(32, seed=7)
    x, t = (torch.from_numpy(a) for a in inputs((1, 6, 7, 32), seed=7))
    before = (fa.fused_channel_attention.launches, fs.fused_stage_tail.launches)
    sd = channel_attention_state_dict(p)
    assert torch.equal(fa.fused_channel_attention(x, sd, 2),
                       fa.fused_channel_attention_plain(x, sd, 2))
    tsd = stage_tail_state_dict(sp)
    assert torch.equal(fs.fused_stage_tail(x, t, tsd), fs.fused_stage_tail_plain(x, t, tsd))
    got = fs.fused_stage_tail(x.bfloat16(), t.bfloat16(), tsd)
    assert got.dtype == torch.bfloat16
    assert (fa.fused_channel_attention.launches, fs.fused_stage_tail.launches) == before
