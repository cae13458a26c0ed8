"""The port's TrueColor family against the JAX package on the same weights
and inputs (CPU, fp32): BayerProcessor (both wirings), ColorCorrection
(plain and bounded), EnhancedFLCA (1 and 2 levels), a ``log_temperature``
TransformerBlock (fused twin, module path, JAX, and the gradient through the
block's autograd.Function), TrueColorRawFormer and its BayerTORGB variant
(fused twin path and module path), the weight carry round trip through the
JAX importer, ``Predictor.from_jax_params`` on a ragged frame, and one epoch
of the train CLI."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayer_low_light_image_enhancement_tpu.compat.torch_import import import_truecolor_state_dict
from bayer_low_light_image_enhancement_tpu.models import truecolor as jtc
from bayer_low_light_image_enhancement_tpu.models.common import (
    TransformerBlock as JaxTransformerBlock,
)
from bayer_low_light_image_enhancement_tpu.ops import isp as jisp
from bayer_low_light_image_enhancement_tpu.serving import Predictor as JaxPredictor
from bayer_low_light_image_enhancement_tpu_torch.cli import train_cli
from bayer_low_light_image_enhancement_tpu_torch.compat import jax_params as jp
from bayer_low_light_image_enhancement_tpu_torch.data import synthetic
from bayer_low_light_image_enhancement_tpu_torch.kernels import fused_block as fb
from bayer_low_light_image_enhancement_tpu_torch.models import get_model
from bayer_low_light_image_enhancement_tpu_torch.models.common import (
    TransformerBlock,
    set_fused_blocks,
)
from bayer_low_light_image_enhancement_tpu_torch.ops import isp
from bayer_low_light_image_enhancement_tpu_torch.serving import Predictor

from torch_parity import (
    HEADS,
    TOL,
    carried,
    jax_apply_with_head,
    jax_variables,
    n,
    t,
    torch_run_with_head,
)

torch.set_num_threads(2)

RNG = np.random.default_rng(29)


@pytest.mark.parametrize("positive_gains", [False, True])
def test_bayer_processor(positive_gains):
    planes = RNG.uniform(0, 1, (2, 12, 16, 4)).astype(np.float32)
    jm = jisp.BayerProcessor(positive_gains=positive_gains)
    v = jax_variables(jm, jnp.asarray(planes))
    want = jm.apply(v, jnp.asarray(planes))
    m = isp.BayerProcessor(positive_gains)
    m.load_state_dict(carried(jp._bayer_processor, v["params"]))
    got = m(t(planes))
    assert [g.shape[1] for g in got] == [1, 1, 1, 3]
    for g, w in zip(got, want):
        np.testing.assert_allclose(n(g), np.asarray(w), **TOL)


@pytest.mark.parametrize("bounded", [False, True])
def test_color_correction(bounded):
    x = RNG.uniform(-0.1, 1.1, (2, 10, 12, 3)).astype(np.float32)
    jm = jisp.ColorCorrection(bounded=bounded)
    v = jax_variables(jm, jnp.asarray(x))
    want = jm.apply(v, jnp.asarray(x))
    m = isp.ColorCorrection(3, bounded)
    m.load_state_dict(carried(lambda p, pre, out: jp._color_correction(p, pre, out, bounded),
                              v["params"]))
    assert hasattr(m, "gamma_param") == bounded
    np.testing.assert_allclose(n(m(t(x))), np.asarray(want), **TOL)


@pytest.mark.parametrize("levels", [1, 2])
@pytest.mark.parametrize("feat_hw,guide_hw", [((8, 8), (16, 16)), ((5, 7), (13, 17))])
def test_enhanced_flca(levels, feat_hw, guide_hw):
    feat = RNG.standard_normal((2, *feat_hw, 16)).astype(np.float32)
    y = RNG.uniform(0, 1, (2, *guide_hw, 1)).astype(np.float32)
    cr, cb = (RNG.normal(0, 0.2, (2, *guide_hw, 1)).astype(np.float32) for _ in range(2))
    g = (y, cr, cb, RNG.uniform(0, 1, (2, *guide_hw, 3)).astype(np.float32))
    args = [jnp.asarray(a) for a in (feat, *g)]
    jm = jisp.EnhancedFLCA(levels=levels)
    v = jax_variables(jm, *args)
    want = jm.apply(v, *args)
    m = isp.EnhancedFLCA(16, levels)
    m.load_state_dict(carried(jp._enhanced_flca, v["params"]))
    np.testing.assert_allclose(n(m(t(feat), *map(t, g))), np.asarray(want), **TOL)


def test_log_temperature_block():
    """A ``log_temperature`` block: the fused twin against the module path
    and JAX's TransformerBlock(log_temperature=True), and the gradient with
    respect to ``log_temperature`` through the block's autograd.Function
    against autograd through the module path."""
    x = RNG.standard_normal((2, 9, 11, 16)).astype(np.float32)
    jm = JaxTransformerBlock(num_heads=2, log_temperature=True)
    v = jax_variables(jm, jnp.asarray(x))
    want = np.asarray(jm.apply(v, jnp.asarray(x)))
    blk = TransformerBlock(16, 2, 2, log_temperature=True)
    blk.load_state_dict(jp.transformer_block_state_dict(v["params"]))
    assert "attn.log_temperature" in dict(blk.named_parameters())
    xt = t(x)
    dy = torch.from_numpy(RNG.standard_normal((2, 16, 9, 11)).astype(np.float32))
    grads = {}
    for fused in (True, False):
        blk.fused = fused
        blk.zero_grad()
        y = blk(xt)
        np.testing.assert_allclose(n(y), want, **TOL)
        (y * dy).sum().backward()
        grads[fused] = blk.attn.log_temperature.grad.clone()
    with torch.no_grad():
        twin = fb.fused_transformer_block(xt.permute(0, 2, 3, 1), dict(blk.named_parameters()), 2)
    np.testing.assert_allclose(twin.numpy(), want, **TOL)
    assert grads[False].abs().max() > 1e-3
    torch.testing.assert_close(grads[True], grads[False], rtol=1e-4, atol=1e-5)


FAMILIES = {"truecolor_rawformer": False, "bayertorgb_rawformer": True}
X = RNG.uniform(0, 1.5, (2, 32, 48, 1)).astype(np.float32)


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def family(request):
    """(name, JAX model, its perturbed init variables, the port's model with
    them carried over)."""
    name = request.param
    jmodel = jtc.TrueColorRawFormer(jtc.TrueColorConfig(dim=8, num_heads=HEADS,
                                                        bayertorgb=FAMILIES[name]))
    v = jax_variables(jmodel, jnp.asarray(X))
    model = get_model(name, dim=8, num_heads=HEADS)
    model.load_state_dict(jp.truecolor_state_dict_from_jax(v))
    return name, jmodel, v, model


@pytest.mark.parametrize("fused", [True, False])
def test_model_matches_jax(family, fused):
    name, jmodel, v, model = family
    want, want_head = jax_apply_with_head(jmodel, v, jnp.asarray(X))
    set_fused_blocks(model, fused)
    got, head = torch_run_with_head(model, t(X))
    set_fused_blocks(model, True)
    assert got.dtype == torch.float32 and got.shape == (2, 3, 32, 48)
    # The head's input too: it sees every stage where the output may not (at
    # init the TrueColor colour correction is near saturation).
    np.testing.assert_allclose(n(head), want_head, **TOL)
    np.testing.assert_allclose(n(got), want, **TOL)


def test_state_dict_round_trips_through_the_jax_importer(family):
    name, _, v, model = family
    sd = {k: p.numpy() for k, p in model.state_dict().items()}
    assert ("conv_tran1.FLCA.res_proj.0.weight" in sd) == FAMILIES[name]
    assert ("color_correction.gamma_param" in sd) == FAMILIES[name]
    back = import_truecolor_state_dict(sd)["params"]
    want = jax.tree_util.tree_flatten_with_path(v["params"])[0]
    got = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [(p, np.shape(a)) for p, a in got] == [(p, np.shape(a)) for p, a in want]
    for (_, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_predictor_from_jax_params_on_a_ragged_frame(family):
    name, jmodel, v, _ = family
    x = RNG.uniform(0, 1.5, (37, 45)).astype(np.float32)
    pred = Predictor.from_jax_params(get_model(name, dim=8, num_heads=HEADS), v, device="cpu")
    got = pred(x)
    assert got.shape == (37, 45, 3)
    np.testing.assert_allclose(got, JaxPredictor(jmodel, v)(x), **TOL)
    with pytest.raises(TypeError, match="no prepacked entry"):
        pred.raw_u16(np.zeros((32, 32), np.uint16), 100.0)


def test_train_cli_one_epoch(tmp_path, monkeypatch, capsys):
    """One epoch of ``--model truecolor_rawformer`` (dim 48) at batch 2 @
    32^2 on a tiny SID tree, validation at its full test frame."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)  # ~10 s to import
    root = str(tmp_path / "sid")
    synthetic.write_sid_tree(root, os.path.join(root, "cache"),
                             {"train": [(40, 56), (36, 52)], "test": [(32, 48)]},
                             np.random.default_rng(33))
    with pytest.warns(RuntimeWarning, match="TensorBoard"):
        train_cli.main(["--dataset", "SID", "--data_root", root, "--cache_dir",
                        os.path.join(root, "cache"), "--model", "truecolor_rawformer",
                        "--patch_size", "32", "--batch_size", "2", "--epochs", "1",
                        "--loader", "python", "--save_dir", str(tmp_path / "run"),
                        "--device", "cpu"])
    out = capsys.readouterr().out
    assert "epoch 1/1 loss=" in out
    log = (tmp_path / "run" / "SID" / "log.txt").read_text()
    assert "Epoch 0/1" in log and "Epoch 1/1" in log
    assert os.listdir(tmp_path / "run" / "SID" / "weights")
