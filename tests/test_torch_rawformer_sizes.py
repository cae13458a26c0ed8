"""RawFormer-B and -L (dim 48 / 64, heads 8, FFN 2) at their real widths
against the JAX package on the CPU: the weights carried across by
``compat.state_dict_from_jax`` and back, the fp32 forward against the JAX
``RawFormer.from_size``, two ``Trainer`` steps in lockstep with the JAX
``Trainer``, the train CLI's model against the JAX model's parameter count,
and the routing the card relies on (every block of width <= FUSE_CMAX on the
fused-block wrapper, the 384 / 512-wide bottleneck on the module path).

Inputs are 2 x 32x32 mosaics made with numpy from a seed. One JAX params
tree a size (``jax.eval_shape`` of the init, filled from a seed: no init
compile) is shared by the file's tests through a module fixture.
"""

import argparse

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from bayer_low_light_image_enhancement_tpu.compat.torch_import import import_rawformer_state_dict
from bayer_low_light_image_enhancement_tpu.models.rawformer import (
    RawFormer as JaxRawFormer,
    RawFormerConfig as JaxRawFormerConfig,
)
from bayer_low_light_image_enhancement_tpu.train import trainer as jtrainer
from bayer_low_light_image_enhancement_tpu.utils.flops import count_params
from bayer_low_light_image_enhancement_tpu_torch.cli import train_cli
from bayer_low_light_image_enhancement_tpu_torch.compat import state_dict_from_jax
from bayer_low_light_image_enhancement_tpu_torch.models import RawFormer, RawFormerConfig, common
from bayer_low_light_image_enhancement_tpu_torch.train.trainer import TrainConfig, Trainer

torch.set_num_threads(2)

SIZES = ["B", "L"]
WIDTHS = {"B": 48, "L": 64}


def filled_params(model, seed):
    """Params of the JAX model's structure (``jax.eval_shape``: no compile),
    filled from a seed: U(+-1/sqrt(fan_in)) kernels, U(+-0.2) biases, LN
    affines and temperatures near 1."""
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 1)))
    g = np.random.default_rng(seed)

    def fill(path, s):
        name = jax.tree_util.keystr(path)
        bound = 1.0 / np.sqrt(np.prod(s.shape[:-1])) if "kernel" in name else 0.2
        v = g.uniform(-bound, bound, s.shape)
        if "temperature" in name or ("norm" in name and "weight" in name):
            v = v + 1.0
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module", params=SIZES)
def size_pair(request):
    """(size, JAX model, its params tree, the port's fp32 model on them, the
    jitted JAX apply)."""
    size = request.param
    jmodel = JaxRawFormer(JaxRawFormerConfig.from_size(size))
    params = filled_params(jmodel, seed=24 + WIDTHS[size])
    port = RawFormer(RawFormerConfig.from_size(size))
    port.load_state_dict(state_dict_from_jax(params))
    return size, jmodel, params, port.eval(), jax.jit(jmodel.apply)


def mosaics(seed, scale=1.0):
    """Two 32x32 mosaics in [0, scale), NHWC."""
    return (np.random.default_rng(seed).uniform(0, 1, (2, 32, 32, 1)) * scale).astype(np.float32)


def test_sizes_are_the_published_widths(size_pair):
    size, jmodel, _, port, _ = size_pair
    assert jmodel.config.dim == port.config.dim == WIDTHS[size]
    assert tuple(jmodel.config.num_heads) == tuple(port.config.num_heads) == (8, 8, 8, 8)
    assert port.config.ffn_expansion == 2


def test_weight_carry_round_trip(size_pair):
    """JAX params -> state_dict_from_jax -> the JAX package's own importer
    gives back the identical tree."""
    _, _, params, port, _ = size_pair
    back = import_rawformer_state_dict({k: v.numpy() for k, v in port.state_dict().items()})
    flat = jax.tree_util.tree_leaves_with_path(params)
    back = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat) == len(back)
    for path, leaf in flat:
        np.testing.assert_array_equal(np.asarray(back[path]), leaf, err_msg=str(path))


@pytest.mark.parametrize("scale", [1.0, 300.0])  # [0, 1] and ratio-amplified input
def test_forward_matches_jax_fp32(size_pair, scale):
    _, _, params, port, japply = size_pair
    x = mosaics(7, scale)
    want = np.asarray(japply(params, jnp.asarray(x)))
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert got.shape == (2, 32, 32, 3)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_trainer_lockstep_with_jax_trainer(size_pair):
    """Two Adam steps (the first at the warmup's lr 0, the second at the base
    lr) from the same weights on two batches: each loss within 2e-4
    relative, the params after within 1e-2 of each leaf's scale
    (tests/test_torch_train.py's bars)."""
    size, jmodel, params, _, _ = size_pair
    cfg = dict(base_lr=1e-3, warmup_epochs=1, total_epochs=50, steps_per_epoch=1)
    jt = jtrainer.Trainer(jmodel, jtrainer.TrainConfig(**cfg))
    state = jtrainer.TrainState.create({"params": jax.tree.map(jnp.asarray, params["params"])},
                                       jt.tx)
    start = state_dict_from_jax(params)
    model = RawFormer(RawFormerConfig.from_size(size))
    model.load_state_dict(start)
    trainer = Trainer(model, TrainConfig(**cfg))
    g = np.random.default_rng(5)
    batches = [(g.uniform(0, 3, (2, 32, 32, 1)).astype(np.float32),
                g.uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)) for _ in range(2)]
    got, want = [], []
    for x, y in batches:
        got.append(float(trainer.train_step((torch.from_numpy(x), torch.from_numpy(y)))))
        state, loss = jt.train_step(state, (jnp.asarray(x), jnp.asarray(y)))
        want.append(float(loss))
    rel = np.abs(np.array(got) - want) / np.abs(want)
    assert rel.max() < 2e-4, rel
    assert trainer.applied == trainer.step == 2
    final = state_dict_from_jax(jax.tree.map(np.asarray, jax.device_get(state.params)))
    moved = 0.0
    for name, p in model.state_dict().items():
        ref = final[name].numpy()
        scale = max(np.abs(ref).max(), 1e-3)
        assert np.abs(p.numpy() - ref).max() / scale < 1e-2, name
        moved = max(moved, np.abs(ref - start[name].numpy()).max())
    assert moved > 0.5 * cfg["base_lr"]  # the second step moved the params


@pytest.mark.parametrize("fp32", [False, True])
def test_train_cli_model_has_the_jax_parameter_count(size_pair, fp32):
    """``train_cli.build_model`` (the eval and export CLIs' too) of
    ``--model_size B|L``: the JAX model's parameter count, fp32 params either
    way (--fp32 only sets the compute dtype), the published widths."""
    size, _, params, _, _ = size_pair
    args = argparse.Namespace(model=None, model_size=size, fp32=fp32)
    model = train_cli.build_model(args, "cpu", seed=0)
    assert sum(p.numel() for p in model.parameters()) == count_params(params)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert model.config.dim == WIDTHS[size]
    assert model.config.dtype == (torch.float32 if fp32 else torch.bfloat16)


@pytest.mark.parametrize("grad", [False, True])
def test_blocks_route_as_on_the_card(size_pair, grad, monkeypatch):
    """Crop serving (no grad) and training (grad) route the blocks of width
    <= FUSE_CMAX (dim, 2 dim, 4 dim, 4 dim, 2 dim, dim) through the fused
    block wrapper (K2 / K3, and B1 / B2 in backward, on the card) and the
    8 dim-wide bottleneck through the module path's ChannelAttention once,
    as JAX ``models/fused_apply.py`` routes them; the gradient reaches every
    parameter."""
    size, _, _, port, _ = size_pair
    d = WIDTHS[size]
    fused, attn = [], []
    wrapped = common.fused_transformer_block

    def spy(x, params, heads, **kw):
        fused.append(x.shape[-1])
        return wrapped(x, params, heads, **kw)

    monkeypatch.setattr(common, "fused_transformer_block", spy)
    hooks = [m.register_forward_hook(lambda m, i, o: attn.append(i[0].shape[1]))
             for m in port.modules() if isinstance(m, common.ChannelAttention)]
    x = torch.from_numpy(mosaics(3)).permute(0, 3, 1, 2)
    try:
        with torch.set_grad_enabled(grad):
            y = port(x)
            if grad:
                y.square().mean().backward()
    finally:
        for h in hooks:
            h.remove()
    assert fused == [d, 2 * d, 4 * d, 4 * d, 2 * d, d]
    assert max(fused) <= common.FUSE_CMAX < 8 * d
    assert attn == [8 * d]
    if grad:
        assert all(p.grad is not None and bool(torch.isfinite(p.grad).all())
                   for p in port.parameters())
        port.zero_grad(set_to_none=True)
