"""The port's simple FLCA U-Net (``simple_flca_unet``) against the JAX
package on the same weights and inputs (CPU, fp32): the additive FLCA, the
token transformer at full residual (whole and chunked), the max pool at odd
sizes, the model and its Charbonnier grads against ``jax.grad``, the weight
carry round trip through the JAX importer, the registry (its 14 names are
the JAX package's), and a 3-step lockstep of the port's ``Trainer`` with
the JAX ``Trainer`` on packed (input, target) pairs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayer_low_light_image_enhancement_tpu import list_models as jax_list_models
from bayer_low_light_image_enhancement_tpu.compat.torch_import import (
    import_simple_flca_unet_state_dict,
)
from bayer_low_light_image_enhancement_tpu.models import luma_variants as jlv
from bayer_low_light_image_enhancement_tpu.train import trainer as jtrainer
from bayer_low_light_image_enhancement_tpu.train.losses import charbonnier_loss as jax_charbonnier
from bayer_low_light_image_enhancement_tpu_torch.compat import jax_params as jp
from bayer_low_light_image_enhancement_tpu_torch.models import get_model, list_models
from bayer_low_light_image_enhancement_tpu_torch.models import luma_variants as lv
from bayer_low_light_image_enhancement_tpu_torch.models.registry import is_raw_domain
from bayer_low_light_image_enhancement_tpu_torch.train import TrainConfig, Trainer
from bayer_low_light_image_enhancement_tpu_torch.train.losses import charbonnier_loss

from torch_parity import TOL, assert_grads_match, carried, jax_variables, n, round_trip, t

torch.set_num_threads(2)

RNG = np.random.default_rng(81)
X = RNG.uniform(0, 1.5, (2, 32, 32, 4)).astype(np.float32)
KW = dict(base_ch=8, heads=2)


def test_simple_flca():
    feat = RNG.standard_normal((2, 5, 6, 8)).astype(np.float32)
    guide = [RNG.uniform(-0.5, 1, (2, 10, 12, 1)).astype(np.float32) for _ in range(3)]
    jm = jlv.SimpleFLCA()
    v = jax_variables(jm, jnp.asarray(feat), *map(jnp.asarray, guide))
    m = lv.SimpleFLCA(8)
    sd = {}
    for name in ("low_attn", "high_attn", "chroma_attn"):
        jp._conv(v["params"][name], f"{name}.0", sd)
    m.load_state_dict(sd)
    np.testing.assert_allclose(n(m(t(feat), *map(t, guide))),
                               np.asarray(jm.apply(v, feat, *guide)), **TOL)


@pytest.mark.parametrize("chunk_bytes", [None, 2 * 2 * 63 * 4 * 8])
def test_simple_token_transformer(chunk_bytes):
    x = RNG.standard_normal((2, 7, 9, 16)).astype(np.float32)
    jm = jlv.SimpleTokenTransformer(num_heads=4)
    v = jax_variables(jm, jnp.asarray(x))
    m = lv.TokenTransformer(16, 4)
    m.load_state_dict(carried(jp._token_transformer, v["params"]))
    m.attn.chunk_bytes = chunk_bytes
    np.testing.assert_allclose(n(m(t(x))), np.asarray(jm.apply(v, jnp.asarray(x))), **TOL)


@pytest.mark.parametrize("hw", [(8, 8), (7, 9)])
def test_max_pool2(hw):
    x = RNG.standard_normal((2, *hw, 3)).astype(np.float32)
    got = lv.max_pool2(t(x))
    assert got.shape[-2:] == (hw[0] // 2, hw[1] // 2)
    np.testing.assert_array_equal(n(got), np.asarray(jlv.max_pool2(jnp.asarray(x))))


@pytest.fixture(scope="module")
def family():
    """(JAX model, its perturbed init variables, the port's model with them)."""
    jmodel = jlv.SimpleFLCAUNet(jlv.SimpleFLCAUNetConfig(**KW))
    v = jax_variables(jmodel, jnp.asarray(X), jit=True)
    model = get_model("simple_flca_unet", **KW)
    model.load_state_dict(jp.simple_flca_unet_state_dict_from_jax(v))
    return jmodel, v, model


@pytest.mark.parametrize("hw", [(32, 32), (24, 40)])
def test_model_matches_jax(family, hw):
    jmodel, v, model = family
    x = X[:, :hw[0], :hw[1]]
    with torch.no_grad():
        got = model(t(x))
    assert got.dtype == torch.float32 and got.shape == t(x).shape
    np.testing.assert_allclose(n(got), np.asarray(jax.jit(jmodel.apply)(v, jnp.asarray(x))),
                               **TOL)


def test_grads_match_jax(family):
    """Every parameter's grad of the Charbonnier loss of the clamped output
    against ``jax.grad``, through the carry, within 1e-4 of its leaf's max;
    the input's grad too."""
    jmodel, v, model = family
    gt = RNG.uniform(0, 1, X.shape).astype(np.float32)

    def loss(params, x):
        return jax_charbonnier(jnp.clip(jmodel.apply({"params": params}, x), 0.0, 1.0),
                               jnp.asarray(gt))

    gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(v["params"], jnp.asarray(X))
    want = jp.simple_flca_unet_state_dict_from_jax(jax.tree.map(np.asarray, gp))
    model.zero_grad()
    xt = t(X).requires_grad_()
    charbonnier_loss(model(xt).clamp(0.0, 1.0), t(gt)).backward()
    got = {k: p.grad for k, p in model.named_parameters()}
    assert_grads_match({**got, "x": xt.grad}, {**want, "x": t(np.asarray(gx))}, tol=1e-4)


def test_state_dict_round_trips_through_the_jax_importer(family):
    _, v, model = family
    round_trip(model, lambda sd: import_simple_flca_unet_state_dict(sd, heads=2), v)


def test_registry_matches_the_jax_package():
    assert list_models() == sorted(jax_list_models())
    raw = [m for m in list_models() if is_raw_domain(m)]
    assert raw == ["flca_unet", "lumachroma_transformer", "simple_flca_unet", "unet_luma_dwt"]
    m = get_model("simple_flca_unet", generator=torch.Generator().manual_seed(3))
    assert (m.config.base_ch, m.config.heads) == (32, 4)
    assert [m.trans1.attn.in_proj_weight.shape[1], m.bottleneck.attn.in_proj_weight.shape[1]] \
        == [32, 128]
    assert m.up3.in_channels == 128 and m.dec1[0].in_channels == 64


def test_trainer_lockstep_with_jax_trainer(family):
    """Three Adam steps (lr 0 in the first warmup epoch, then the warmup's
    next lr) from the same weights on packed (input, target) pairs: per-step
    loss within 2e-4 relative, final params within 1e-2 of each leaf's
    scale, as the RawFormer lockstep."""
    jmodel, v, _ = family
    cfg = dict(base_lr=1e-3, warmup_epochs=2, total_epochs=50, steps_per_epoch=1)
    jt = jtrainer.Trainer(jmodel, jtrainer.TrainConfig(**cfg))
    state = jtrainer.TrainState.create({"params": jax.tree.map(jnp.asarray, v["params"])}, jt.tx)
    model = get_model("simple_flca_unet", **KW)
    model.load_state_dict(jp.simple_flca_unet_state_dict_from_jax(v))
    trainer = Trainer(model, TrainConfig(**cfg))
    batches = [(RNG.uniform(0, 1.5, X.shape).astype(np.float32),
                RNG.uniform(0, 1, X.shape).astype(np.float32)) for _ in range(2)]
    got, want = [], []
    for s in range(3):
        x, y = batches[s % 2]
        got.append(float(trainer.train_step((torch.from_numpy(x), torch.from_numpy(y)))))
        state, loss = jt.train_step(state, (jnp.asarray(x), jnp.asarray(y)))
        want.append(float(loss))
    rel = np.abs(np.array(got) - want) / np.abs(want)
    assert rel.max() < 2e-4, rel
    assert trainer.applied == trainer.step == 3
    final = jp.simple_flca_unet_state_dict_from_jax(jax.tree.map(np.asarray,
                                                                 jax.device_get(state.params)))
    start = jp.simple_flca_unet_state_dict_from_jax(v)
    moved = 0.0
    for name, p in model.state_dict().items():
        ref = final[name].numpy()
        scale = max(np.abs(ref).max(), 1e-3)
        assert np.abs(p.numpy() - ref).max() / scale < 1e-2, name
        moved = max(moved, np.abs(ref - start[name].numpy()).max())
    assert moved > 1e-4  # the params did move
