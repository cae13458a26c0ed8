"""The port's luma-MHSA RawFormer against the JAX package on the same
weights and inputs (CPU, fp32): the CFA luma extraction for every pattern,
the average pool, the luma FiLM net, the token attention and the whole
model, the weight carry round trip through the JAX importer,
``Predictor.from_jax_params`` on a ragged frame, the chunked attention
against the unchunked one (output and grads), and the train and eval CLIs
with ``--model luma_mhsa_rawformer``."""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayer_low_light_image_enhancement_tpu.compat.torch_import import import_luma_mhsa_state_dict
from bayer_low_light_image_enhancement_tpu.models import luma_variants as jlv
from bayer_low_light_image_enhancement_tpu.serving import Predictor as JaxPredictor
from bayer_low_light_image_enhancement_tpu_torch.cli import test_cli, train_cli
from bayer_low_light_image_enhancement_tpu_torch.compat import jax_params as jp
from bayer_low_light_image_enhancement_tpu_torch.data import synthetic
from bayer_low_light_image_enhancement_tpu_torch.models import get_model
from bayer_low_light_image_enhancement_tpu_torch.models import luma_variants as lv
from bayer_low_light_image_enhancement_tpu_torch.models.common import set_chunk_bytes
from bayer_low_light_image_enhancement_tpu_torch.serving import Predictor

from torch_parity import (
    HEADS,
    TOL,
    assert_grads_match,
    carried,
    jax_variables,
    n,
    round_trip,
    t,
)

torch.set_num_threads(2)

RNG = np.random.default_rng(41)
X = RNG.uniform(0, 1.5, (2, 32, 48, 1)).astype(np.float32)


@pytest.mark.parametrize("pattern", ["rggb", "bggr", "grbg", "gbrg"])
def test_bayer_luma_cfa(pattern):
    x = RNG.uniform(0, 2, (2, 10, 14, 1)).astype(np.float32)
    got = lv.bayer_luma_cfa(t(x), pattern.upper())
    assert got.shape == (2, 1, 10, 14) and got.dtype == torch.float32
    np.testing.assert_allclose(n(got), np.asarray(jlv.bayer_luma_cfa(jnp.asarray(x), pattern)),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("k", [2, 4, 16])
def test_avg_pool(k):
    x = RNG.uniform(0, 1, (2, 32, 48, 1)).astype(np.float32)
    np.testing.assert_allclose(n(lv.avg_pool(t(x), k)), np.asarray(jlv.avg_pool(jnp.asarray(x), k)),
                               rtol=1e-6, atol=1e-6)
    assert lv.avg_pool(t(x).bfloat16(), k).dtype == torch.bfloat16


def test_luma_cond():
    luma = RNG.uniform(0, 1, (2, 6, 7, 1)).astype(np.float32)
    v = jax_variables(jlv.LumaCond(8), jnp.asarray(luma))
    want = jlv.LumaCond(8).apply(v, jnp.asarray(luma))
    m = lv.LumaCond(8)
    sd = {}
    for ours, ref in (("net0", "net.0"), ("net1", "net.2"), ("gamma", "gamma"), ("beta", "beta")):
        jp._conv(v["params"][ours], ref, sd)
    m.load_state_dict(sd)
    for g, w in zip(m(t(luma)), want):
        np.testing.assert_allclose(n(g), np.asarray(w), **TOL)


def mhsa_pair(c=16, heads=2, hw=(6, 10)):
    """(JAX LuminanceAwareMHSA, its variables, the port's module with them,
    x, luma); alpha is moved off zero by ``jax_variables``."""
    x = RNG.standard_normal((2, *hw, c)).astype(np.float32)
    luma = RNG.uniform(0, 1, (2, *hw, 1)).astype(np.float32)
    jm = jlv.LuminanceAwareMHSA(num_heads=heads)
    v = jax_variables(jm, jnp.asarray(x), jnp.asarray(luma))
    m = lv.LuminanceAwareMHSA(c, heads)
    m.load_state_dict(carried(jp._luma_mhsa, v["params"]))
    return jm, v, m, x, luma


@pytest.mark.parametrize("chunk_bytes", [None, 2 * 2 * 60 * 4 * 7])
def test_luminance_aware_mhsa(chunk_bytes):
    """The module against JAX whole and in chunks of 7 query rows (the last
    one ragged: 60 tokens)."""
    jm, v, m, x, luma = mhsa_pair()
    assert m.alpha.item() != 0.0
    m.chunk_bytes = chunk_bytes
    want = jm.apply(v, jnp.asarray(x), jnp.asarray(luma))
    np.testing.assert_allclose(n(m(t(x), t(luma))), np.asarray(want), **TOL)


def test_chunked_attention_matches_unchunked():
    """Output and every grad of the module, chunked in 5-row chunks
    (recomputed in backward) against whole, within 1e-6 of each leaf's max.
    In fp64, so that the chunks' other summation order stays far below the
    bar also for ``alpha``, whose grad is a sum over the centred
    inverse-luma map and cancels to ~1e-6 of its terms."""
    _, _, m, x, luma = mhsa_pair(hw=(8, 9))
    m = m.to(torch.float64)
    for mod in m.modules():
        if hasattr(mod, "compute_dtype"):
            mod.compute_dtype = torch.float64
    runs = []
    for chunk_bytes in (None, 2 * 2 * 72 * 4 * 5):
        m.chunk_bytes = chunk_bytes
        m.zero_grad()
        xt, lt = (t(a).double().requires_grad_() for a in (x, luma))
        y = m(xt, lt)
        assert y.dtype == torch.float64
        (y * torch.linspace(-1, 1, y.numel(), dtype=y.dtype).reshape(y.shape)).sum().backward()
        runs.append((y.detach(), {"x": xt.grad, "luma": lt.grad,
                                  **{k: p.grad.clone() for k, p in m.named_parameters()}}))
    (y0, g0), (y1, g1) = runs
    np.testing.assert_allclose(y1.numpy(), y0.numpy(), rtol=1e-6, atol=1e-6)
    assert_grads_match(g1, g0)


@pytest.mark.parametrize("chunk_bytes", [None, 1 * 2 * 64 * 4 * 16])
def test_token_attention_keeps_no_scores_when_chunked(chunk_bytes):
    """With grad enabled, the chunked attention (4 chunks of 16 query rows)
    saves no scores for backward, not even one chunk's: each chunk is
    recomputed there. The whole attention saves its [1, 2, 64, 64]
    softmax. Both give the same output and grads."""
    q, k, v = (torch.from_numpy(RNG.standard_normal((1, 2, 64, 4)).astype(np.float32))
               .requires_grad_() for _ in "qkv")
    saved = []

    def pack(x):
        saved.append(x.numel())
        return x

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda x: x):
        out = lv.token_attention(q, k, v, chunk_bytes)
    scores = 1 * 2 * 64 * 64
    if chunk_bytes is None:
        assert scores in saved
    else:
        assert max(saved) < 2 * 16 * 64
    out.backward(torch.ones_like(out))
    grads = [x.grad.clone() for x in (q, k, v)]
    for x in (q, k, v):
        x.grad = None
    whole = lv.token_attention(q, k, v, None)
    whole.backward(torch.ones_like(whole))
    np.testing.assert_allclose(out.detach().numpy(), whole.detach().numpy(), rtol=1e-6, atol=1e-6)
    assert_grads_match(dict(zip("qkv", grads)), {s: x.grad for s, x in zip("qkv", (q, k, v))})


# ----------------------------------------------------------------------------
# the model
# ----------------------------------------------------------------------------


@pytest.fixture(scope="module")
def family():
    """(JAX model, its perturbed init variables, the port's model with them)."""
    jmodel = jlv.LumaMHSARawFormer(jlv.LumaMHSAConfig(dim=8, num_heads=HEADS))
    v = jax_variables(jmodel, jnp.asarray(X))
    model = get_model("luma_mhsa_rawformer", dim=8, num_heads=HEADS)
    model.load_state_dict(jp.luma_mhsa_state_dict_from_jax(v))
    return jmodel, v, model


@pytest.mark.parametrize("chunk_bytes", [None, lv.ATTN_CHUNK_BYTES, 4096])
def test_model_matches_jax(family, chunk_bytes):
    jmodel, v, model = family
    set_chunk_bytes(model, chunk_bytes)
    with torch.no_grad():
        got = model(t(X))
    set_chunk_bytes(model, lv.ATTN_CHUNK_BYTES)
    assert got.dtype == torch.float32 and got.shape == (2, 3, 32, 48)
    np.testing.assert_allclose(n(got), np.asarray(jmodel.apply(v, jnp.asarray(X))), **TOL)


def test_state_dict_round_trips_through_the_jax_importer(family):
    _, v, model = family
    round_trip(model, import_luma_mhsa_state_dict, v)


def test_predictor_from_jax_params_on_a_ragged_frame(family):
    jmodel, v, _ = family
    x = RNG.uniform(0, 1.5, (37, 45)).astype(np.float32)
    pred = Predictor.from_jax_params(get_model("luma_mhsa_rawformer", dim=8, num_heads=HEADS), v,
                                     device="cpu")
    assert pred.pad_to == 16
    got = pred(x)
    assert got.shape == (37, 45, 3)
    np.testing.assert_allclose(got, JaxPredictor(jmodel, v)(x), **TOL)
    with pytest.raises(TypeError, match="no prepacked entry"):
        pred.raw_u16(np.zeros((32, 32), np.uint16), 100.0)


def test_registry_builds_full_width():
    m = get_model("luma_mhsa_rawformer", generator=torch.Generator().manual_seed(3))
    assert m.config.dim == 48 and m.config.num_heads == (8, 8, 8, 8)
    assert [m.proj2.in_channels, m.proj3.in_channels] == [48 * 4, 48 * 2]
    assert m.enc1.attn.luma_cond.gamma.out_channels == 48
    assert "output.0.weight" in m.state_dict() and "enc1.attn.luma_cond.net.2.weight" in \
        m.state_dict()


def test_train_and_eval_cli(tmp_path, monkeypatch, capsys):
    """One epoch of ``--model luma_mhsa_rawformer`` (dim 48) at batch 2 @
    32^2 on a tiny SID tree, then the eval CLI from its checkpoint."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)  # ~10 s to import
    root = str(tmp_path / "sid")
    cache = os.path.join(root, "cache")
    synthetic.write_sid_tree(root, cache, {"train": [(40, 56), (36, 52)], "test": [(32, 48)]},
                             np.random.default_rng(43))
    with pytest.warns(RuntimeWarning, match="TensorBoard"):
        train_cli.main(["--dataset", "SID", "--data_root", root, "--cache_dir", cache,
                        "--model", "luma_mhsa_rawformer", "--patch_size", "32", "--batch_size",
                        "2", "--epochs", "1", "--loader", "python", "--save_dir",
                        str(tmp_path / "run"), "--device", "cpu"])
    assert "epoch 1/1 loss=" in capsys.readouterr().out
    got = test_cli.main(["--dataset", "SID", "--data_root", root, "--cache_dir", cache,
                         "--model", "luma_mhsa_rawformer", "--ckpt",
                         str(tmp_path / "run" / "SID" / "weights"), "--device", "cpu",
                         "--save_dir", str(tmp_path / "eval")])
    out = capsys.readouterr().out
    assert "restored checkpoint step" in out and "image:0\tPSNR:" in out
    assert got["pad_to"] == 16 and len(got["psnr"]) == 1 and np.isfinite(got["psnr"]).all()
