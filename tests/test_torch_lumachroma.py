"""The port's BayerLumaChromaTransformer (``lumachroma_transformer``)
against the JAX package on the same weights and inputs (CPU, fp32): the
instance norm, the multi-kernel FLCA, the local-enhance token
transformer, the InstanceNorm conv block, the model at 32x32 and at the
odd 20x20 (re-alignment; 31-tap box filters over a 2x2 bottleneck) and its
Charbonnier grads against ``jax.grad``, the weight carry round trip
through the JAX importer, the registry at full width; and the shared token
attention in flax's dtypes, chunked against whole in fp64 (output and every
grad) with no scores saved for backward."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayer_low_light_image_enhancement_tpu.compat.torch_import import (
    import_lumachroma_transformer_state_dict,
)
from bayer_low_light_image_enhancement_tpu.models import lumachroma_transformer as jlc
from bayer_low_light_image_enhancement_tpu.train.losses import charbonnier_loss as jax_charbonnier
from bayer_low_light_image_enhancement_tpu_torch.compat import jax_params as jp
from bayer_low_light_image_enhancement_tpu_torch.models import get_model
from bayer_low_light_image_enhancement_tpu_torch.models import lumachroma_transformer as lc
from bayer_low_light_image_enhancement_tpu_torch.models import luma_variants as lv
from bayer_low_light_image_enhancement_tpu_torch.train.losses import charbonnier_loss

from torch_parity import TOL, assert_grads_match, carried, jax_variables, n, round_trip, t

torch.set_num_threads(2)

RNG = np.random.default_rng(71)
X = RNG.uniform(0, 1.5, (2, 32, 32, 4)).astype(np.float32)
X_ODD = RNG.uniform(0, 1.5, (1, 20, 20, 4)).astype(np.float32)
KW = dict(base=8, num_blocks=2, heads=2)


def test_instance_norm():
    """Against JAX on channels offset from zero, and in bf16 back in bf16."""
    x = (RNG.standard_normal((2, 6, 7, 5)) * 0.5 + 2.0).astype(np.float32)
    np.testing.assert_allclose(n(lc.instance_norm(t(x))),
                               np.asarray(jlc.instance_norm(jnp.asarray(x))), **TOL)
    assert lc.instance_norm(t(x).bfloat16()).dtype == torch.bfloat16


def test_multi_kernel_flca():
    feat = RNG.standard_normal((2, 5, 6, 8)).astype(np.float32)
    guide = [RNG.uniform(-0.5, 1, (2, 10, 12, 1)).astype(np.float32) for _ in range(3)]
    jm = jlc.MultiKernelFLCA()
    v = jax_variables(jm, jnp.asarray(feat), *map(jnp.asarray, guide))
    m = lc.MultiKernelFLCA(8)
    sd = {}
    for name in ("low_attn", "high_attn", "chroma_attn"):
        jp._conv(v["params"][name], f"{name}.0", sd)
    jp._conv(v["params"]["refine"], "refine", sd)
    m.load_state_dict(sd)
    np.testing.assert_allclose(n(m(t(feat), *map(t, guide))),
                               np.asarray(jm.apply(v, feat, *guide)), **TOL)


@pytest.mark.parametrize("chunk_bytes", [None, 2 * 2 * 42 * 4 * 4])
def test_local_enhance_transformer(chunk_bytes):
    x = RNG.standard_normal((2, 6, 7, 16)).astype(np.float32)
    jm = jlc.LocalEnhanceTransformer(num_heads=2)
    v = jax_variables(jm, jnp.asarray(x))
    m = lv.TokenTransformer(16, 2, local=True)
    m.load_state_dict(carried(jp._token_transformer, v["params"]))
    m.attn.chunk_bytes = chunk_bytes
    np.testing.assert_allclose(n(m(t(x))), np.asarray(jm.apply(v, jnp.asarray(x))), **TOL)


def test_in_conv_block():
    x = RNG.standard_normal((2, 6, 7, 8)).astype(np.float32)
    jm = jlc.INConvBlock(8)
    v = jax_variables(jm, jnp.asarray(x))
    block = lc.in_conv_block(8, 8, {})
    sd = {}
    jp._conv(v["params"]["conv1"], "0", sd)
    jp._conv(v["params"]["conv2"], "3", sd)
    block.load_state_dict(sd)
    np.testing.assert_allclose(n(lc.in_conv_forward(block, t(x))),
                               np.asarray(jm.apply(v, jnp.asarray(x))), **TOL)


def flax_qkv(b=1, heads=2, tokens=64, dh=4, dtype=np.float32):
    return [torch.from_numpy(RNG.standard_normal((b, heads, tokens, dh)).astype(dtype))
            .requires_grad_() for _ in "qkv"]


def test_flax_attention_chunked_matches_whole_in_fp64():
    """Output and every grad of the flax-dtype attention (``fp32_scores``
    False), in 7-row chunks recomputed in backward against whole, within
    1e-6 of each leaf's max."""
    runs = []
    q, k, v = flax_qkv(b=2, tokens=45, dtype=np.float64)
    w = torch.linspace(-1, 1, q.numel(), dtype=torch.float64).reshape(q.shape)
    for chunk_bytes in (None, 2 * 2 * 45 * 8 * 7):
        for x in (q, k, v):
            x.grad = None
        out = lv.token_attention(q, k, v, chunk_bytes, fp32_scores=False)
        assert out.dtype == torch.float64
        (out * w).sum().backward()
        runs.append((out.detach(), {s: x.grad.clone() for s, x in zip("qkv", (q, k, v))}))
    (y0, g0), (y1, g1) = runs
    np.testing.assert_allclose(y1.numpy(), y0.numpy(), rtol=1e-6, atol=1e-6)
    assert_grads_match(g1, g0)


@pytest.mark.parametrize("chunk_bytes", [None, 1 * 2 * 64 * 4 * 16])
def test_flax_attention_keeps_no_scores_when_chunked(chunk_bytes):
    """With grad enabled the chunked flax-dtype attention (4 chunks of 16
    query rows) saves no scores, not even one chunk's; the whole one saves
    its [1, 2, 64, 64] softmax."""
    q, k, v = flax_qkv()
    saved = []

    def pack(x):
        saved.append(x.numel())
        return x

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda x: x):
        out = lv.token_attention(q, k, v, chunk_bytes, fp32_scores=False)
    if chunk_bytes is None:
        assert 1 * 2 * 64 * 64 in saved
    else:
        assert max(saved) < 2 * 16 * 64
    out.sum().backward()
    assert all(torch.isfinite(x.grad).all() for x in (q, k, v))


def test_flax_attention_dtypes_in_bf16():
    """In bf16 the scores, the softmax and the product with v are bf16 (the
    query divided by sqrt(dh) rounded to bf16, as flax does), the luma
    MHSA's fp32-score form differs from it."""
    q, k, v = (x.detach().bfloat16() for x in flax_qkv(dh=12))
    got = lv.token_attention(q, k, v, None, fp32_scores=False)
    assert got.dtype == torch.bfloat16
    scale = torch.tensor(12 ** 0.5).bfloat16()
    assert scale.item() == 3.46875
    scores = (q / scale) @ k.transpose(-1, -2)
    assert scores.dtype == torch.bfloat16
    want = torch.softmax(scores, -1) @ v
    assert torch.equal(got, want)
    assert not torch.equal(lv.token_attention(q, k, v, None), got)


# ----------------------------------------------------------------------------
# the model
# ----------------------------------------------------------------------------


@pytest.fixture(scope="module")
def family():
    """(JAX model, its perturbed init variables, the port's model with them)."""
    jmodel = jlc.BayerLumaChromaTransformer(jlc.LumaChromaTransformerConfig(**KW))
    v = jax_variables(jmodel, jnp.asarray(X), jit=True)
    model = get_model("lumachroma_transformer", **KW)
    model.load_state_dict(jp.lumachroma_state_dict_from_jax(v))
    return jmodel, v, model


@pytest.mark.parametrize("x", [X, X_ODD], ids=["32x32", "20x20"])
def test_model_matches_jax(family, x):
    jmodel, v, model = family
    with torch.no_grad():
        got = model(t(x))
    assert got.dtype == torch.float32 and got.shape == t(x).shape
    np.testing.assert_allclose(n(got), np.asarray(jax.jit(jmodel.apply)(v, jnp.asarray(x))),
                               **TOL)


# The biases of the convs an instance norm follows: it removes each
# channel's mean, so their grads are zero up to rounding.
IN_FED_BIAS = re.compile(r"(blocks\.\d+|fuse)\.[03]\.bias$")


def test_grads_match_jax(family):
    """Every parameter's grad of the Charbonnier loss of the clamped output
    against ``jax.grad``, through the carry, within 1e-4 of its leaf's max;
    the input's grad too. The IN-fed biases' grads, zero up to rounding in
    both, are held below 1e-6 of the largest grad."""
    jmodel, v, model = family
    gt = RNG.uniform(0, 1, X.shape).astype(np.float32)

    def loss(params, x):
        return jax_charbonnier(jnp.clip(jmodel.apply({"params": params}, x), 0.0, 1.0),
                               jnp.asarray(gt))

    gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(v["params"], jnp.asarray(X))
    want = jp.lumachroma_state_dict_from_jax(jax.tree.map(np.asarray, gp))
    model.zero_grad()
    xt = t(X).requires_grad_()
    charbonnier_loss(model(xt).clamp(0.0, 1.0), t(gt)).backward()
    got = {k: p.grad for k, p in model.named_parameters()}
    zero = sorted(k for k in got if IN_FED_BIAS.search(k))
    assert len(zero) == 2 * (2 * 3 + 3)  # two convs in each IN block and decoder stage
    scale = max(g.abs().max().item() for g in want.values())
    for k in zero:
        assert max(got[k].abs().max().item(), want[k].abs().max().item()) <= 1e-6 * scale, k
    held = lambda d: {k: g for k, g in d.items() if k not in zero}  # noqa: E731
    assert_grads_match({**held(got), "x": xt.grad}, {**held(want), "x": t(np.asarray(gx))},
                       tol=1e-4)


def test_state_dict_round_trips_through_the_jax_importer(family):
    _, v, model = family
    round_trip(model, lambda sd: import_lumachroma_transformer_state_dict(sd, 2, 2), v)


def test_registry_builds_full_width():
    m = get_model("lumachroma_transformer", generator=torch.Generator().manual_seed(3))
    cfg = m.config
    assert (cfg.base, cfg.num_blocks, cfg.freq_kernels, cfg.heads) == (48, 2, (7, 15, 31), 4)
    assert m.enc1.trans.attn.in_proj_weight.shape == (3 * 48, 48)
    assert m.bottleneck.trans.attn.num_heads == 4 and m.enc3.flca.high_attn[0].in_channels == 3
    assert "enc1.trans.local_enhance.0.weight" in m.state_dict()
    assert "res_proj.weight" not in m.state_dict()
    assert "res_proj.weight" in get_model("lumachroma_transformer", in_ch=4, out_ch=3,
                                          base=8).state_dict()
