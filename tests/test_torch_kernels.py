"""Port kernels' plain twins against the JAX package's kernels (Pallas in
interpret mode on the CPU, as tests/test_kernels.py and
tests/test_fused_block.py run them). The CUDA kernels against their twins
are in tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from bayer_low_light_image_enhancement_tpu.kernels import bayer_pack as jbp
from bayer_low_light_image_enhancement_tpu.kernels import fused_block as jfb
from bayer_low_light_image_enhancement_tpu.models.common import TransformerBlock as JaxBlock
from bayer_low_light_image_enhancement_tpu_torch.compat.jax_params import (
    transformer_block_state_dict,
)
from bayer_low_light_image_enhancement_tpu_torch.kernels import bayer_pack as bp
from bayer_low_light_image_enhancement_tpu_torch.kernels import fused_block as fb
from bayer_low_light_image_enhancement_tpu_torch.models import common

torch.set_num_threads(2)

# bf16 kernel vs fp32 reference, as tests/test_fused_block.py.
BF16_TOL = dict(rtol=2.5e-2, atol=2.5e-2)


def mosaic(seed, shape):
    g = np.random.default_rng(seed)
    m = g.integers(0, 17000, shape, dtype=np.uint16)
    m.reshape(-1)[:: 97] = 40000  # hot pixels: codes >= 32768 decode unsigned
    return m, g.uniform(1.0, 300.0, shape[0]).astype(np.float32)


# ---------------------------------------------------------------------------
# K1: Bayer pack
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("clamp01", [False, True])
@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_pack_twin_matches_jax_kernel(clamp01, out_dtype):
    m, r = mosaic(1, (2, 16, 24))
    got = bp.bayer_pack_normalize(torch.from_numpy(m), torch.from_numpy(r),
                                  getattr(torch, out_dtype), clamp01)
    want = jbp.bayer_pack_normalize(jnp.asarray(m), jnp.asarray(r),
                                    out_dtype=getattr(jnp, out_dtype), clamp01=clamp01)
    assert got.dtype == getattr(torch, out_dtype) and got.shape == (2, 8, 12, 4)
    # The kernel multiplies by 1/(white-black+1e-6) where the twin divides:
    # fp32 rounding apart, or one bf16 ulp after rounding.
    tol = dict(rtol=1e-5, atol=1e-5) if out_dtype == "float32" else dict(rtol=8e-3, atol=1e-5)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)


def test_pack_twin_matches_jax_xla():
    m, r = mosaic(2, (2, 8, 12))
    got = bp.bayer_pack_normalize(torch.from_numpy(m), torch.from_numpy(r))
    want = jbp.bayer_pack_normalize_xla(jnp.asarray(m), jnp.asarray(r))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_pack_channel_order_and_hot_pixels():
    m = np.zeros((1, 4, 4), np.uint16)
    m[:, 0::2, 0::2], m[:, 0::2, 1::2] = 1000, 2000  # R, G1
    m[:, 1::2, 0::2], m[:, 1::2, 1::2] = 3000, 40000  # G2, B (hot)
    out = bp.bayer_pack_normalize(torch.from_numpy(m), torch.tensor([1.0])).numpy()
    scale = 1.0 / (16383.0 - 512.0 + 1e-6)
    np.testing.assert_allclose(out[0, 0, 0], [(1000 - 512) * scale, (2000 - 512) * scale,
                                              (3000 - 512) * scale, 1.0], rtol=1e-6)


def test_pack_wrapper_runs_twin_on_cpu():
    m, r = mosaic(3, (1, 4, 6))
    before = bp.bayer_pack_normalize.launches
    got = bp.bayer_pack_normalize(torch.from_numpy(m), torch.from_numpy(r))
    want = bp.bayer_pack_normalize_plain(torch.from_numpy(m), torch.from_numpy(r))
    assert torch.equal(got, want)
    assert bp.bayer_pack_normalize.launches == before
    with pytest.raises(ValueError):
        bp.bayer_pack_normalize(torch.zeros((1, 3, 4), dtype=torch.uint16), torch.ones(1))


# ---------------------------------------------------------------------------
# K2/K3: fused TransformerBlock
# ---------------------------------------------------------------------------


def jax_block(c, heads, seed, dtype=jnp.float32, shape=(1, 8, 8)):
    """A JAX TransformerBlock with non-trivial LN affines and temperatures:
    (module, params as jax arrays, the port's state dict of the same)."""
    module = JaxBlock(num_heads=heads, dtype=dtype)
    p = module.init(jax.random.PRNGKey(seed), jnp.zeros(shape + (c,)))["params"]
    p = jax.tree.map(np.asarray, p)
    g = np.random.default_rng(seed)
    for n in ("norm1", "norm2"):
        p[n] = {k: v + g.uniform(-0.3, 0.3, v.shape).astype(np.float32) for k, v in p[n].items()}
    p["attn"]["temperature"] = p["attn"]["temperature"] + g.uniform(-0.5, 0.5, heads).astype(np.float32)
    return module, jax.tree.map(jnp.asarray, p), transformer_block_state_dict(p)


@pytest.mark.parametrize(
    "b,h,w,c,heads",
    [(2, 16, 16, 16, 4), (1, 19, 13, 8, 2)],  # 19x13: ragged tiles, odd W
)
def test_fused_twin_matches_jax_kernel(b, h, w, c, heads):
    _, params, sd = jax_block(c, heads, seed=c + h)
    x = np.random.default_rng(h).standard_normal((b, h, w, c)).astype(np.float32) * 0.5
    want = jfb.fused_transformer_block(jnp.asarray(x, jnp.bfloat16), params, heads)
    got = fb.fused_transformer_block(torch.from_numpy(x).bfloat16(), sd, heads)
    assert got.dtype == torch.bfloat16 and got.shape == (b, h, w, c)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **BF16_TOL)


def test_gram_twin_matches_jax_kernel():
    _, params, sd = jax_block(16, 4, seed=5)
    x = np.random.default_rng(5).standard_normal((2, 12, 20, 16)).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    gram, qss, kss = jfb.gram_pass(xb, params, 4)
    g, qs, ks = fb.gram_pass(torch.from_numpy(np.asarray(xb, np.float32)),
                             fb.fold_block_params(sd))
    # Compare as attention cosines gram / (|q| |k|) in [-1, 1].
    cos = lambda g, q, k: np.asarray(g) / np.sqrt(np.asarray(q)[:, :, None] * np.asarray(k)[:, None, :])
    np.testing.assert_allclose(cos(g, qs, ks), cos(gram, qss, kss), atol=2e-2)
    np.testing.assert_allclose(qs.numpy(), np.asarray(qss), rtol=2e-2)
    np.testing.assert_allclose(ks.numpy(), np.asarray(kss), rtol=2e-2)


@pytest.mark.parametrize("b,h,w,c,heads", [(2, 9, 12, 16, 4), (1, 7, 5, 8, 2)])
def test_fused_twin_matches_jax_module_fp32(b, h, w, c, heads):
    module, params, sd = jax_block(c, heads, seed=b * h)
    x = np.random.default_rng(w).standard_normal((b, h, w, c)).astype(np.float32)
    want = module.apply({"params": params}, jnp.asarray(x))
    got = fb.fused_transformer_block(torch.from_numpy(x), sd, heads)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_port_block_module_paths_agree():
    """The port's TransformerBlock: fused route (the twin on the CPU) and the
    module route compute the same block."""
    blk = common.TransformerBlock(16, 4, 2)
    common.reset_parameters_(blk, torch.Generator().manual_seed(3))
    x = torch.randn(2, 16, 6, 10, generator=torch.Generator().manual_seed(4))
    x = x.contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        fused = blk(x)
        cd = blk.compute_dtype
        y = x + blk.attn(blk.norm1(x).to(cd))
        plain = y + blk.ffn(blk.norm2(y).to(cd))
    np.testing.assert_allclose(fused.numpy(), plain.numpy(), rtol=1e-5, atol=1e-5)


def test_finalize_attention_matches_jax():
    g = np.random.default_rng(6)
    b, c, heads = 2, 16, 4
    q = g.standard_normal((b, 30, c)).astype(np.float32)
    k = g.standard_normal((b, 30, c)).astype(np.float32)
    gram = np.einsum("bpc,bpd->bcd", q, k)
    qss, kss = (q * q).sum(1), (k * k).sum(1)
    t = g.uniform(0.5, 1.5, heads).astype(np.float32)
    wproj = g.standard_normal((c, c)).astype(np.float32)
    args = (gram, qss, kss, t, wproj)
    got = fb.finalize_attention(*(torch.from_numpy(a) for a in args), heads)
    want = jfb.finalize_attention(*(jnp.asarray(a) for a in args), heads)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_block_wrappers_run_twins_on_cpu():
    _, _, sd = jax_block(8, 2, seed=7)
    w = fb.fold_block_params(sd)
    x = torch.randn(1, 5, 6, 8)
    before = (fb.gram_pass.launches, fb.apply_pass.launches)
    g = fb.gram_pass(x, w)
    for a, b in zip(g, fb.gram_pass_plain(x, w)):
        assert torch.equal(a, b)
    apply = fb.finalize_attention(*g, w.temperature, w.wproj, 2)
    assert torch.equal(fb.apply_pass(x, apply, w), fb.apply_pass_plain(x, apply, w))
    assert (fb.gram_pass.launches, fb.apply_pass.launches) == before
