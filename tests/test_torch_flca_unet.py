"""The port's Transformer-FLCA U-Net (``flca_unet``, ``unet_luma_dwt``)
against the JAX package on the same weights and inputs (CPU, fp32): the box
frequency split at 3 / 7 / 15 / 31 taps, the pool FLCA, ResCA at both
dilations, the token transformer (whole and in query-row chunks), both
models at 32x32 and at the odd 20x20 (bilinear re-alignment, a 2x2
bottleneck) and their Charbonnier grads against ``jax.grad``, the weight
carry round trip through the JAX importers, the registry at full width,
and the train and eval CLIs of both packages refusing the raw-domain
models."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayer_low_light_image_enhancement_tpu.cli import train_cli as jax_train_cli
from bayer_low_light_image_enhancement_tpu.compat.torch_import import (
    import_flca_unet_state_dict,
    import_unet_luma_dwt_state_dict,
)
from bayer_low_light_image_enhancement_tpu.models import flca_unet as jfu
from bayer_low_light_image_enhancement_tpu.train.losses import charbonnier_loss as jax_charbonnier
from bayer_low_light_image_enhancement_tpu_torch.cli import test_cli, train_cli
from bayer_low_light_image_enhancement_tpu_torch.compat import jax_params as jp
from bayer_low_light_image_enhancement_tpu_torch.models import flca_unet as fu
from bayer_low_light_image_enhancement_tpu_torch.models import get_model
from bayer_low_light_image_enhancement_tpu_torch.models.common import set_chunk_bytes
from bayer_low_light_image_enhancement_tpu_torch.models.luma_variants import (
    ATTN_CHUNK_BYTES,
    TokenTransformer,
)
from bayer_low_light_image_enhancement_tpu_torch.train.losses import charbonnier_loss

from torch_parity import TOL, assert_grads_match, carried, jax_variables, n, round_trip, t

torch.set_num_threads(2)

RNG = np.random.default_rng(61)
X = RNG.uniform(0, 1.5, (2, 32, 32, 4)).astype(np.float32)
X_ODD = RNG.uniform(0, 1.5, (1, 20, 20, 4)).astype(np.float32)
KW = dict(base=8, blocks=(2, 2, 2), heads=2)
RAW_DOMAIN = ["flca_unet", "unet_luma_dwt", "simple_flca_unet", "lumachroma_transformer"]


@pytest.mark.parametrize("k", [3, 7, 15, 31])
def test_frequency_split(k):
    x = RNG.standard_normal((2, 9, 13, 3)).astype(np.float32)
    want = jfu.frequency_split(jnp.asarray(x), k)
    for g, w in zip(fu.frequency_split(t(x), k), want):
        np.testing.assert_allclose(n(g), np.asarray(w), rtol=1e-6, atol=1e-6)


def guidance(hw=(10, 12)):
    """Feature map (C = 8, at half the guidance resolution: the resize path)
    and luma / chroma planes, NHWC numpy."""
    feat = RNG.standard_normal((2, hw[0] // 2, hw[1] // 2, 8)).astype(np.float32)
    y, cr, cb = (RNG.uniform(-0.5, 1, (2, *hw, 1)).astype(np.float32) for _ in range(3))
    return feat, y, cr, cb


def test_pool_flca():
    args = guidance()
    jm = jfu.PoolFLCA()
    v = jax_variables(jm, *map(jnp.asarray, args))
    m = fu.PoolFLCA(8)
    m.load_state_dict(carried(jp._flca, v["params"]))
    assert m.alpha.item() != 1.0
    np.testing.assert_allclose(n(m(*map(t, args))), np.asarray(jm.apply(v, *args)), **TOL)


@pytest.mark.parametrize("dilation", [1, 2])
def test_resca(dilation):
    x = RNG.standard_normal((2, 7, 9, 8)).astype(np.float32)
    jm = jfu.ResCA(dilation=dilation)
    v = jax_variables(jm, jnp.asarray(x))
    m = fu.ResCA(8, dilation)
    m.load_state_dict(carried(jp._resca, v["params"]))
    np.testing.assert_allclose(n(m(t(x))), np.asarray(jm.apply(v, jnp.asarray(x))), **TOL)


@pytest.mark.parametrize("chunk_bytes", [None, 2 * 2 * 63 * 4 * 5])
def test_token_transformer_block(chunk_bytes):
    """The 0.2-scaled token block whole and in chunks of 5 query rows (63
    tokens: the last chunk ragged)."""
    x = RNG.standard_normal((2, 7, 9, 16)).astype(np.float32)
    jm = jfu.TokenTransformerBlock(num_heads=2)
    v = jax_variables(jm, jnp.asarray(x))
    m = TokenTransformer(16, 2, residual_scale=0.2, norms=("ln1", "ln2"))
    m.load_state_dict(carried(lambda p, pre, out: jp._token_transformer(p, pre, out,
                                                                       ("ln1", "ln2")),
                              v["params"]))
    m.attn.chunk_bytes = chunk_bytes
    np.testing.assert_allclose(n(m(t(x))), np.asarray(jm.apply(v, jnp.asarray(x))), **TOL)


# ----------------------------------------------------------------------------
# the models
# ----------------------------------------------------------------------------


@pytest.fixture(scope="module", params=["pool", "dwt"])
def family(request):
    """(JAX model, its perturbed init variables, the port's model with them)."""
    jmodel = jfu.TransformerFLCAUNet(jfu.FLCAUNetConfig(guidance=request.param, **KW))
    v = jax_variables(jmodel, jnp.asarray(X), jit=True)
    model = get_model("flca_unet" if request.param == "pool" else "unet_luma_dwt", **KW)
    model.load_state_dict(jp.flca_unet_state_dict_from_jax(v))
    return jmodel, v, model


@pytest.mark.parametrize("x", [X, X_ODD], ids=["32x32", "20x20"])
def test_model_matches_jax(family, x):
    jmodel, v, model = family
    with torch.no_grad():
        got = model(t(x))
    assert got.dtype == torch.float32 and got.shape == t(x).shape
    np.testing.assert_allclose(n(got), np.asarray(jax.jit(jmodel.apply)(v, jnp.asarray(x))),
                               **TOL)


def test_grads_match_jax(family):
    """Every parameter's grad of the Charbonnier loss of the clamped output
    (the trainer's loss) against ``jax.grad``, through the carry, within
    1e-4 of its leaf's max; the input's grad too."""
    jmodel, v, model = family
    gt = RNG.uniform(0, 1, X.shape).astype(np.float32)

    def loss(params, x):
        pred = jnp.clip(jmodel.apply({"params": params}, x), 0.0, 1.0)
        return jax_charbonnier(pred, jnp.asarray(gt))

    gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(v["params"], jnp.asarray(X))
    want = jp.flca_unet_state_dict_from_jax(jax.tree.map(np.asarray, gp))
    model.zero_grad()
    xt = t(X).requires_grad_()
    charbonnier_loss(model(xt).clamp(0.0, 1.0), t(gt)).backward()
    got = {k: p.grad for k, p in model.named_parameters()}
    assert_grads_match({**got, "x": xt.grad}, {**want, "x": t(np.asarray(gx))}, tol=1e-4)


def test_state_dict_round_trips_through_the_jax_importer(family):
    jmodel, v, model = family
    dwt = jmodel.config.guidance == "dwt"
    importer = import_unet_luma_dwt_state_dict if dwt else import_flca_unet_state_dict
    round_trip(model, lambda sd: importer(sd, num_blocks=2, heads=2), v)
    assert ("enhTail.0.weight" in model.state_dict()) == dwt


def test_registry_builds_full_width():
    for name in ("flca_unet", "unet_luma_dwt"):
        m = get_model(name, generator=torch.Generator().manual_seed(3))
        assert m.config.base == 48 and m.config.blocks == (3, 3, 3) and m.config.heads == 4
        assert m.trans.attn.in_proj_weight.shape == (3 * 192, 192)
        assert len(m.enc1.blocks) == 3 and m.enc2.blocks[1].rb.body[0].dilation == (2, 2)
        assert m.enc3.down.stride == (2, 2) and m.enc3.down.padding == (1, 1)
        assert ("enhTail.2.weight" in m.state_dict()) == (name == "unet_luma_dwt")
    with pytest.raises(ValueError, match="guidance"):
        fu.TransformerFLCAUNet(fu.FLCAUNetConfig(guidance="haar"))


def test_chunked_model_matches_whole(family):
    """The 20x20 input's 2x2 bottleneck attention one query row a chunk
    against whole."""
    _, _, model = family
    with torch.no_grad():
        whole = model(t(X_ODD))
        set_chunk_bytes(model, 64)  # one query row a chunk
        chunked = model(t(X_ODD))
        set_chunk_bytes(model, ATTN_CHUNK_BYTES)
    np.testing.assert_allclose(chunked.numpy(), whole.numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", RAW_DOMAIN)
def test_train_clis_refuse_raw_domain_models(name, tmp_path):
    """Both packages' train CLIs, and the port's eval CLI (it builds through
    the train CLI's ``build_model``), exit for a raw-domain name."""
    args = ["--dataset", "synthetic", "--model", name, "--patch_size", "32", "--save_dir",
            str(tmp_path)]
    train = args + ["--batch_size", "2", "--loader", "python"]
    with pytest.raises(SystemExit, match="enhancement-domain"):
        train_cli.main(train + ["--device", "cpu"])
    with pytest.raises(SystemExit, match="enhancement-domain"):
        test_cli.main(args + ["--device", "cpu"])
    with pytest.raises(SystemExit, match="enhancement-domain"):
        jax_train_cli.main(train)
