"""The port's FLCA family against the JAX package on the same weights and
inputs (CPU, fp32): the luma / chroma extraction, the bilinear resize, the
SE gate, FLCA and FLCAPyramid, the colour anchors, FLCA-RawFormer and the
multi-level FLCA RawFormer (fused twin path and module path), the weight
carry round trip through the JAX importers, ``Predictor.from_jax_params``
on a ragged frame, and the eval CLI on a tiny SID tree."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayer_low_light_image_enhancement_tpu.compat.torch_import import (
    import_flca_state_dict,
    import_multilvl_flca_state_dict,
)
from bayer_low_light_image_enhancement_tpu.models import flca_rawformer as jfr
from bayer_low_light_image_enhancement_tpu.models import multilvl_flca as jml
from bayer_low_light_image_enhancement_tpu.ops import flca as jflca
from bayer_low_light_image_enhancement_tpu.ops.luma import BT709 as JBT709
from bayer_low_light_image_enhancement_tpu.ops.luma import bayer_luma_chroma as jluma
from bayer_low_light_image_enhancement_tpu.serving import Predictor as JaxPredictor
from bayer_low_light_image_enhancement_tpu_torch.cli import test_cli, train_cli
from bayer_low_light_image_enhancement_tpu_torch.compat import jax_params as jp
from bayer_low_light_image_enhancement_tpu_torch.data import synthetic
from bayer_low_light_image_enhancement_tpu_torch.models import get_model
from bayer_low_light_image_enhancement_tpu_torch.models import multilvl_flca as ml
from bayer_low_light_image_enhancement_tpu_torch.models import registry
from bayer_low_light_image_enhancement_tpu_torch.models.common import set_fused_blocks
from bayer_low_light_image_enhancement_tpu_torch.models.flca_rawformer import (
    FLCARawFormer,
    FLCARawFormerConfig,
)
from bayer_low_light_image_enhancement_tpu_torch.ops import flca
from bayer_low_light_image_enhancement_tpu_torch.ops.luma import BT709, bayer_luma_chroma
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

RNG = np.random.default_rng(23)


def guidance(b, h, w):
    y = RNG.uniform(0, 1, (b, h, w, 1)).astype(np.float32)
    cr, cb = (RNG.normal(0, 0.2, (b, h, w, 1)).astype(np.float32) for _ in range(2))
    return y, cr, cb


# ----------------------------------------------------------------------------
# ops
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("weights", ["bt601", "bt709"])
def test_bayer_luma_chroma(normalize, weights):
    planes = RNG.uniform(0, 2, (2, 6, 10, 4)).astype(np.float32)
    kw = {} if weights == "bt601" else {"weights": BT709}
    assert BT709 == JBT709
    got = bayer_luma_chroma(torch.from_numpy(planes), normalize=normalize, **kw)
    want = jluma(jnp.asarray(planes), normalize=normalize, **kw)
    for g, w in zip(got, want):
        assert g.shape == (2, 6, 10, 1)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("src,dst", [((16, 16), (8, 8)), ((8, 12), (16, 24)), ((9, 11), (9, 11)),
                                     ((13, 17), (7, 9)), ((5, 7), (9, 13))])
def test_resize_bilinear(src, dst):
    x = RNG.standard_normal((2, *src, 3)).astype(np.float32)
    got = flca.resize_bilinear(torch.from_numpy(x), *dst)
    np.testing.assert_allclose(got.numpy(), np.asarray(jflca.resize_bilinear(jnp.asarray(x), *dst)),
                               rtol=1e-5, atol=1e-5)
    assert flca.resize_bilinear(torch.from_numpy(x).bfloat16(), *dst).dtype == torch.bfloat16


def test_squeeze_excite():
    x = RNG.standard_normal((2, 6, 7, 16)).astype(np.float32)
    v = jax_variables(jflca.SqueezeExcite(), jnp.asarray(x))
    want = jflca.SqueezeExcite().apply(v, jnp.asarray(x))
    m = flca.SqueezeExcite(16)
    m.load_state_dict(carried(jp._se, v["params"]))
    np.testing.assert_allclose(n(m(t(x))), np.asarray(want), **TOL)


@pytest.mark.parametrize("feat_hw,guide_hw", [((8, 8), (16, 16)), ((5, 7), (13, 17))])
def test_flca(feat_hw, guide_hw):
    feat = RNG.standard_normal((2, *feat_hw, 16)).astype(np.float32)
    g = guidance(2, *guide_hw)
    args = [jnp.asarray(a) for a in (feat, *g)]
    v = jax_variables(jflca.FLCA(), *args)
    want = jflca.FLCA().apply(v, *args)
    m = flca.FLCA(16)
    m.load_state_dict(carried(jp._flca, v["params"]))
    assert m.alpha.shape == ()
    np.testing.assert_allclose(n(m(t(feat), *map(t, g))), np.asarray(want), **TOL)


@pytest.mark.parametrize("feat_hw,guide_hw", [((8, 8), (16, 16)), ((5, 7), (13, 17))])
def test_flca_pyramid(feat_hw, guide_hw):
    feat = RNG.standard_normal((2, *feat_hw, 16)).astype(np.float32)
    g = guidance(2, *guide_hw)
    args = [jnp.asarray(a) for a in (feat, *g)]
    v = jax_variables(jflca.FLCAPyramid(), *args)
    want = jflca.FLCAPyramid().apply(v, *args)
    m = flca.FLCAPyramid(16)
    m.load_state_dict(carried(jp._flca_pyramid, v["params"]))
    np.testing.assert_allclose(n(m(t(feat), *map(t, g))), np.asarray(want), **TOL)


def test_color_anchor_correction_and_consistency_loss():
    out = RNG.uniform(0, 1, (2, 8, 10, 3)).astype(np.float32)
    packed = RNG.uniform(0, 1, (2, 4, 5, 4)).astype(np.float32)
    got = ml.color_anchor_correction(torch.from_numpy(out), torch.from_numpy(packed))
    want = jml.color_anchor_correction(jnp.asarray(out), jnp.asarray(packed))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ml.demosaic_from_packed(torch.from_numpy(packed)).numpy(),
                               np.asarray(jml.demosaic_from_packed(jnp.asarray(packed))))
    loss = ml.color_consistency_loss(torch.from_numpy(out), torch.from_numpy(packed))
    want = jml.color_consistency_loss(jnp.asarray(out), jnp.asarray(packed))
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-5, atol=1e-8)


# ----------------------------------------------------------------------------
# models
# ----------------------------------------------------------------------------

FAMILIES = {
    "flca_rawformer": (jfr.FLCARawFormer, jfr.FLCARawFormerConfig, jp.flca_state_dict_from_jax,
                       import_flca_state_dict),
    "multilvl_flca_rawformer": (jml.MultiLvlFLCARawFormer, jml.MultiLvlFLCAConfig,
                                jp.multilvl_flca_state_dict_from_jax,
                                import_multilvl_flca_state_dict),
}


# The models' input: JAX's init runs the forward op by op, compiling each
# primitive for its shapes, which the forward on the same shape then reuses.
X = RNG.uniform(0, 1.5, (2, 32, 48, 1)).astype(np.float32)


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def family(request):
    """(name, JAX model, its perturbed init variables, the port's model with
    them carried over)."""
    name = request.param
    jmodel_cls, jcfg, carry, _ = FAMILIES[name]
    jmodel = jmodel_cls(jcfg(dim=8, num_heads=HEADS))
    v = jax_variables(jmodel, jnp.asarray(X))
    model = get_model(name, dim=8, num_heads=HEADS)
    model.load_state_dict(carry(v))
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
    importer = FAMILIES[name][3]
    sd = {k: p.numpy() for k, p in model.state_dict().items()}
    back = importer(sd)["params"]
    want = jax.tree_util.tree_flatten_with_path(v["params"])[0]
    got = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [(p, np.shape(a)) for p, a in got] == [(p, np.shape(a)) for p, a in want]
    for (_, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_predictor_from_jax_params_on_a_ragged_frame(family):
    name, jmodel, v, _ = family
    x = RNG.uniform(0, 1.5, (37, 45)).astype(np.float32)
    pred = Predictor.from_jax_params(get_model(name, dim=8, num_heads=HEADS), v, device="cpu")
    assert pred.pad_to == 16
    got = pred(x)
    assert got.shape == (37, 45, 3)
    np.testing.assert_allclose(got, JaxPredictor(jmodel, v)(x), **TOL)
    with pytest.raises(TypeError, match="no prepacked entry"):
        pred.raw_u16(np.zeros((32, 32), np.uint16), 100.0)


@pytest.mark.parametrize("name", ["flca_rawformer", "multilvl_flca_rawformer",
                                  "truecolor_rawformer", "bayertorgb_rawformer"])
def test_predictor_from_torch_loads_reference_names(name, tmp_path):
    """A ``.pth`` in the reference's wrapper (``module.`` prefixes) loads
    through ``Predictor.from_torch`` with no renaming."""
    src = get_model(name, dim=8, num_heads=HEADS, generator=torch.Generator().manual_seed(7))
    path = tmp_path / "model_best.pth"
    torch.save({"epoch": 1, "state_dict": {"module." + k: v for k, v in src.state_dict().items()}},
               path)
    pred = Predictor.from_torch(get_model(name, dim=8, num_heads=HEADS), str(path), device="cpu")
    x = RNG.uniform(0, 1, (1, 32, 32, 1)).astype(np.float32)
    np.testing.assert_array_equal(pred(x), Predictor(src, device="cpu")(x))


def test_registry_builds_full_width():
    m = get_model("flca_rawformer", generator=torch.Generator().manual_seed(3))
    assert m.config.dim == 48 and m.config.num_heads == (8, 8, 8, 8)
    assert [m.conv_tran1.Transformer.attn.qkv.in_channels,
            m.conv_tran4.Transformer.attn.qkv.in_channels] == [48, 384]
    assert get_model("multilvl_flca_rawformer").config.ffn_expansion == 2
    assert "down1.0.weight" in get_model("multilvl_flca_rawformer", dim=8,
                                         num_heads=HEADS).state_dict()


def test_eval_cli_flca_on_a_sid_tree(tmp_path, capsys):
    root = str(tmp_path / "sid")
    synthetic.write_sid_tree(root, os.path.join(root, "cache"),
                             {"train": [(40, 56)], "test": [(32, 48), (30, 46)]},
                             np.random.default_rng(31))
    got = test_cli.main(["--dataset", "SID", "--data_root", root, "--cache_dir",
                         os.path.join(root, "cache"), "--model", "flca_rawformer",
                         "--device", "cpu", "--save_dir", str(tmp_path / "eval")])
    out = capsys.readouterr().out
    assert "image:0\tPSNR:" in out and "image:1\tPSNR:" in out and "Average PSNR" in out
    assert got["pad_to"] == 16 and len(got["psnr"]) == 2 and np.isfinite(got["psnr"]).all()
    assert (tmp_path / "eval" / "SID" / "csv" / "test_metrics.csv").exists()


def test_cli_refuses_a_raw_domain_model(monkeypatch):
    """A builder registered with ``raw_domain=True`` is refused by the CLIs'
    ``build_model`` with the JAX message, before it is built; the registry's
    raw-domain models are the JAX package's four."""
    monkeypatch.setattr(registry, "_REGISTRY", dict(registry._REGISTRY))
    monkeypatch.setattr(registry, "_RAW_DOMAIN", set(registry._RAW_DOMAIN))
    registry.register_model("raw_domain_probe", lambda **kw: pytest.fail("built"),
                            raw_domain=True)
    assert registry.is_raw_domain("raw_domain_probe")
    assert [m for m in registry.list_models() if registry.is_raw_domain(m)] == [
        "flca_unet", "lumachroma_transformer", "raw_domain_probe", "simple_flca_unet",
        "unet_luma_dwt"]
    args = train_cli.build_parser().parse_args(["--model", "raw_domain_probe", "--device", "cpu"])
    with pytest.raises(SystemExit, match="enhancement-domain model"):
        train_cli.build_model(args, "cpu", 0)
    args.model = "multilvl_flca_rawformer"
    assert isinstance(train_cli.build_model(args, "cpu", 0), ml.MultiLvlFLCARawFormer)
    assert isinstance(get_model("flca_rawformer", dim=8, num_heads=HEADS), FLCARawFormer)
    assert FLCARawFormerConfig().dim == 48
