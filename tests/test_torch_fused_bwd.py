"""The port's fused-block backward (kernels/fused_block_bwd.py) against the
JAX package on the CPU: the plain twins against ``jax.grad`` of the JAX fp32
TransformerBlock, one case against the JAX Pallas backward in interpret
mode, and the autograd.Function against plain autograd. The CUDA kernels
B1/B2 against their twins are in tests/test_torch_cuda.py."""

import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from bayer_low_light_image_enhancement_tpu.kernels.fused_block_bwd import (
    fused_transformer_block_train,
)
from bayer_low_light_image_enhancement_tpu.models.common import TransformerBlock as JaxBlock
from bayer_low_light_image_enhancement_tpu_torch.compat.jax_params import (
    transformer_block_state_dict,
)
from bayer_low_light_image_enhancement_tpu_torch.kernels import fused_block as fb
from bayer_low_light_image_enhancement_tpu_torch.kernels import fused_block_bwd as fbb
from bayer_low_light_image_enhancement_tpu_torch.models import common

torch.set_num_threads(2)


def jax_block(c, heads, seed, dtype=jnp.float32):
    """A JAX TransformerBlock and numpy params with non-trivial LN affines
    and temperatures."""
    module = JaxBlock(num_heads=heads, dtype=dtype)
    p = jax.jit(module.init)(jax.random.PRNGKey(seed), jnp.zeros((1, 8, 8, c)))["params"]
    p = jax.tree.map(np.asarray, p)
    g = np.random.default_rng(seed)
    for n in ("norm1", "norm2"):
        p[n] = {k: v + g.uniform(-0.3, 0.3, v.shape).astype(np.float32) for k, v in p[n].items()}
    p["attn"]["temperature"] = p["attn"]["temperature"] + g.uniform(-0.5, 0.5, heads).astype(np.float32)
    return module, p


def inputs(shape, seed):
    g = np.random.default_rng(seed)
    return (g.standard_normal(shape).astype(np.float32),
            g.standard_normal(shape).astype(np.float32))


def jax_grads(fn, params, x, dy):
    """d/d(params, x) of sum(fn(params, x) * dy), as the port's state dict
    (the JAX grad tree through transformer_block_state_dict) and dx."""
    loss = lambda p, xx: jnp.sum(fn(p, xx).astype(jnp.float32) * dy)
    gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(jax.tree.map(jnp.asarray, params), x)
    return transformer_block_state_dict(jax.tree.map(np.asarray, gp)), np.asarray(gx, np.float32)


def port_grads(params_np, x, dy, heads, block=fb.fused_transformer_block):
    """The same grads through the port (the autograd.Function on the CPU)."""
    sd = {k: v.clone().requires_grad_() for k, v in transformer_block_state_dict(params_np).items()}
    xt = torch.from_numpy(x).requires_grad_()
    (block(xt, sd, heads) * torch.from_numpy(dy)).sum().backward()
    return {k: v.grad for k, v in sd.items()}, xt.grad.numpy()


def rel_err(a, ref):
    ref = np.asarray(ref, np.float32)
    return np.abs(np.asarray(a, np.float32) - ref).max() / (np.abs(ref).max() + 1e-8)


@pytest.mark.parametrize("b,h,w,c,heads", [(2, 9, 7, 16, 4), (1, 11, 13, 32, 8)])
def test_block_backward_twin_matches_jax_fp32(b, h, w, c, heads):
    module, params = jax_block(c, heads, seed=c + h)
    x, dy = inputs((b, h, w, c), seed=w)
    want, want_dx = jax_grads(lambda p, xx: module.apply({"params": p}, xx), params, x, dy)
    got, got_dx = port_grads(params, x, dy, heads)
    assert set(got) == set(want)
    for name in want:
        assert rel_err(got[name].numpy(), want[name].numpy()) <= 1e-4, name
    assert rel_err(got_dx, want_dx) <= 1e-4


def test_twin_matches_jax_pallas_backward_interpret():
    """The JAX Pallas backward (bf16, interpret mode) against the port's fp32
    twin, each leaf within max(3 x the JAX bf16 block's error, 2e-2) of it
    (the yardstick of tests/test_fused_bwd.py)."""
    heads = 8
    m32, params = jax_block(64, heads, seed=4)
    m16 = JaxBlock(num_heads=heads, dtype=jnp.bfloat16)
    x, dy = inputs((4, 13, 10, 64), seed=5)
    xb = jnp.asarray(x, jnp.bfloat16)
    ref, ref_dx = port_grads(params, x, dy, heads)
    kern, kern_dx = jax_grads(lambda p, xx: fused_transformer_block_train(xx, p, heads, 8),
                              params, xb, dy)
    noisy, noisy_dx = jax_grads(lambda p, xx: m16.apply({"params": p}, xx), params, xb, dy)
    for name in ref:
        ek, e16 = rel_err(kern[name].numpy(), ref[name]), rel_err(noisy[name].numpy(), ref[name])
        assert ek <= max(3 * e16, 2e-2), (name, ek, e16)
    assert rel_err(kern_dx, ref_dx) <= max(3 * rel_err(noisy_dx, ref_dx), 2e-2)


def test_function_matches_plain_autograd_on_cpu():
    _, params = jax_block(16, 4, seed=9)
    x, dy = inputs((2, 10, 9, 16), seed=9)
    got, got_dx = port_grads(params, x, dy, 4)
    want, want_dx = port_grads(params, x, dy, 4, block=fb.fused_transformer_block_plain)
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=name)
    np.testing.assert_allclose(got_dx, want_dx, rtol=1e-5, atol=1e-5)


def test_backward_wrappers_run_twins_on_cpu():
    _, params = jax_block(8, 2, seed=2)
    w = fb.fold_block_params(transformer_block_state_dict(params))
    x, dy = (torch.from_numpy(a) for a in inputs((1, 6, 5, 8), seed=2))
    gram, qss, kss = fb.gram_pass_plain(x, w)
    apply = fb.finalize_attention(gram, qss, kss, w.temperature, w.wproj, 2)
    before = (fbb.bwd1.launches, fbb.bwd2.launches)
    dx2, d_apply, g1 = fbb.bwd1(x, dy, apply, w)
    dx2_p, d_apply_p, g1_p = fbb.bwd1_plain(x, dy, apply, w)
    assert torch.equal(dx2, dx2_p) and torch.equal(d_apply, d_apply_p)
    assert sorted(g1) == sorted(fbb.B1_FIELDS)
    d = fbb.finalize_backward(gram, qss, kss, w.temperature, w.wproj, d_apply, 2)
    dx, g2 = fbb.bwd2(x, dx2, apply, *d[:3], w)
    assert torch.equal(dx, fbb.bwd2_plain(x, dx2, apply, *d[:3], w)[0])
    assert sorted(g2) == sorted(fbb.B2_FIELDS)
    assert (fbb.bwd1.launches, fbb.bwd2.launches) == before
    # Every folded weight gets its grad, shaped like the weight.
    dxw, g = fbb.fused_block_backward(x, dy, w, (gram, qss, kss, apply), 2)
    dxp, gp = fbb.fused_block_backward_plain(x, dy, w, (gram, qss, kss, apply), 2)
    assert torch.equal(dxw, dx) and torch.equal(dxp, dx)
    for f in dataclasses.fields(w):
        assert g[f.name].shape == getattr(w, f.name).shape, f.name
        assert torch.equal(g[f.name], gp[f.name]), f.name


def test_port_block_module_grads_fused_vs_module_path():
    """TransformerBlock's parameters (norm*.body.*, attn.*, ffn.*) get the
    same grads through the fused route as through the module path."""
    blk = common.TransformerBlock(16, 4, 2)
    common.reset_parameters_(blk, torch.Generator().manual_seed(1))
    with torch.no_grad():
        for name, p in blk.named_parameters():
            if "norm" in name or "temperature" in name:
                p.add_(torch.empty(p.shape).uniform_(-0.3, 0.3, generator=torch.Generator().manual_seed(2)))
    x = torch.randn(2, 16, 7, 9, generator=torch.Generator().manual_seed(3))
    x = x.contiguous(memory_format=torch.channels_last)
    grads = []
    for fused in (True, False):
        common.set_fused_blocks(blk, fused)
        blk.zero_grad()
        (blk(x) ** 2).sum().backward()
        grads.append({k: v.grad.clone() for k, v in blk.named_parameters()})
    assert all(g is not None for g in grads[0].values()) and len(grads[0]) == 17
    for name in grads[0]:
        np.testing.assert_allclose(grads[0][name].numpy(), grads[1][name].numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=name)
