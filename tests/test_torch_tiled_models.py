"""Spatially sharded inference of whole models on the CPU
(``parallel/tiled.py``): four gloo ranks (``tests/torch_dist_workers.py``,
job kind "tiled") run RawFormer at dim 8 H-sharded over 4 ranks and over a
2 x 2 mesh, and RawFormer-WFB at dim 8 H-sharded over 4 ranks, each rank
receiving the whole output; held against the port's monolithic forward
and the JAX package's monolithic forward on the same weights (JAX
variables carried by ``compat``), and the RawFormer H case against JAX's
own ``make_tiled_forward`` over 4 of the conftest's 8 CPU devices, at the
bar of tests/test_sharding.py (fp32, rtol 1e-4, atol 1e-5). Every rank's
tiled forward calls the fused block wrapper and the scan kernel wrapper no
time (sharded blocks take the module path, sharded scans the twin). Also
the refusals: WFB over W, WFB's reference token layout under sharding,
and a tiled forward over other axes than the model's; and every registry
name builds with a spatial_axis and loads the monolithic state. The rest
of the zoo tiles in tests/test_torch_tiled_zoo_*.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_workers as workers
from torch_parity import SMALL, filled_variables
from bayer_low_light_image_enhancement_tpu.core.mesh import create_mesh
from bayer_low_light_image_enhancement_tpu.models import get_model as jax_get_model
from bayer_low_light_image_enhancement_tpu.models.rawformer import (
    RawFormer as JaxRawFormer,
    RawFormerConfig as JaxRawFormerConfig,
)
from bayer_low_light_image_enhancement_tpu.parallel import tiled as jtiled
from bayer_low_light_image_enhancement_tpu_torch.compat import jax_params as jp
from bayer_low_light_image_enhancement_tpu_torch.models import (
    RawFormer,
    RawFormerConfig,
    get_model,
    list_models,
)
from bayer_low_light_image_enhancement_tpu_torch.models.wfb import WM
from bayer_low_light_image_enhancement_tpu_torch.parallel import tiled

torch.set_num_threads(2)

TOL = dict(rtol=1e-4, atol=1e-5)
WORLD = 4
HEADS = (2, 2, 2, 2)
RNG = np.random.default_rng(29)


def frame(h, w):
    return RNG.uniform(0, 1, (1, h, w, 1)).astype(np.float32)


def rawformer_case(name, layout, x):
    jmodel = JaxRawFormer(JaxRawFormerConfig(dim=8, num_heads=HEADS))
    variables = filled_variables(jmodel, jnp.asarray(x[:, :16, :16]))
    want = np.clip(np.asarray(jax.jit(jmodel.apply)(variables, jnp.asarray(x))), 0.0, 1.0)
    state = jp.state_dict_from_jax(variables["params"])
    return dict(name=name, layout=layout, model=("rawformer", dict(dim=8, num_heads=HEADS)),
                state=state, x=x), want, variables


def wfb_case(x):
    jmodel = jax_get_model("rawformer_wfb", dim=8)
    variables = filled_variables(jmodel, jnp.asarray(x[:, :32, :32]))
    want = np.clip(np.asarray(jax.jit(jmodel.apply)(variables, jnp.asarray(x))), 0.0, 1.0)
    return dict(name="wfb_h", layout="h", model=("wfb", dict(dim=8)),
                state=jp.wfb_state_dict_from_jax(variables), x=x), want, variables


def port_monolithic(case):
    kind, kw = case["model"]
    model = workers.build_model((kind, kw))
    model.load_state_dict(case["state"])
    model.eval()
    with torch.no_grad():
        y = model(torch.from_numpy(case["x"]).permute(0, 3, 1, 2)).clamp(0.0, 1.0)
    return y.permute(0, 2, 3, 1).numpy()


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """The three cases' JAX monolithic outputs, JAX's own tiled output of
    the RawFormer H case, the port's monolithic outputs and every rank's
    tiled output (one spawn)."""
    h_case, h_want, h_vars = rawformer_case("rawformer_h", "h", frame(64, 32))
    hw_case, hw_want, _ = rawformer_case("rawformer_hw", "hw", frame(32, 64))
    w_case, w_want, _ = wfb_case(frame(128, 32))
    cases = [h_case, hw_case, w_case]
    mesh = create_mesh(data=1, spatial=WORLD, devices=jax.devices()[:WORLD])
    jsharded = JaxRawFormer(JaxRawFormerConfig(dim=8, num_heads=HEADS, spatial_axis="spatial"))
    fn = jtiled.make_tiled_forward(jsharded, mesh)
    jax_tiled = np.asarray(fn(h_vars, jtiled.shard_image(jnp.asarray(h_case["x"]), mesh)))
    path = tmp_path_factory.mktemp("tiled") / "job.pt"
    ranks = workers.run_job(workers.write_job(path, kind="tiled", cases=cases), WORLD)
    return {c["name"]: dict(jax=want, port=port_monolithic(c), ranks=[r[i] for r in ranks])
            for i, (c, want) in enumerate(zip(cases, (h_want, hw_want, w_want)))}, jax_tiled


CASES = ["rawformer_h", "rawformer_hw", "wfb_h"]


@pytest.mark.parametrize("name", CASES)
def test_tiled_matches_the_port_monolithic_forward(results, name):
    by_name, _ = results
    r = by_name[name]
    for i, got in enumerate(r["ranks"]):
        np.testing.assert_allclose(got["out"].numpy(), r["port"], **TOL, err_msg=f"rank {i}")


@pytest.mark.parametrize("name", CASES)
def test_tiled_matches_the_jax_monolithic_forward(results, name):
    by_name, _ = results
    r = by_name[name]
    np.testing.assert_allclose(r["port"], r["jax"], **TOL)
    for i, got in enumerate(r["ranks"]):
        np.testing.assert_allclose(got["out"].numpy(), r["jax"], **TOL, err_msg=f"rank {i}")


def test_tiled_matches_jax_make_tiled_forward(results):
    by_name, jax_tiled = results
    for i, got in enumerate(by_name["rawformer_h"]["ranks"]):
        np.testing.assert_allclose(got["out"].numpy(), jax_tiled, **TOL, err_msg=f"rank {i}")


@pytest.mark.parametrize("name", CASES)
def test_tiled_forward_launches_no_kernel(results, name):
    """The fused block wrapper (K2 / K3 / K3P) and the scan kernel wrapper
    (S1) are not called on the tiled path: sharded blocks take the module
    path and sharded scans the twin."""
    by_name, _ = results
    for got in by_name[name]["ranks"]:
        assert got["calls"] == {"fused_block": 0, "ssm_kernel": 0}


def test_wfb_refuses_w_sharding():
    with pytest.raises(ValueError, match="H-axis only"):
        get_model("rawformer_wfb", dim=8, spatial_axis=("spatial", "spatial_w"))
    with pytest.raises(ValueError, match="H-axis only"):
        WM(8, spatial_axis=("spatial", "spatial_w"))
    jmodel = jax_get_model("rawformer_wfb", dim=8, spatial_axis=("spatial", "spatial_w"))
    with pytest.raises(ValueError, match="H-axis only"):
        jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 1)))


def test_wfb_refuses_the_reference_token_layout_under_sharding():
    with pytest.raises(ValueError, match="natural token layout"):
        get_model("rawformer_wfb", dim=8, spatial_axis="spatial", ref_token_layout=True)
    with pytest.raises(ValueError, match="natural token layout"):
        WM(8, ref_token_layout=True, spatial_axis="spatial")
    get_model("rawformer_wfb", dim=8, ref_token_layout=True)  # unsharded: allowed


@pytest.mark.parametrize("name", list_models())
def test_every_model_builds_sharded_and_loads_the_monolithic_state(name):
    """All 14 registry names take spatial_axis (WFB by H alone: its W
    refusal is tested above); the parameter names and shapes do not depend
    on it."""
    axes = "spatial" if name == "rawformer_wfb" else ("spatial", "spatial_w")
    mono = get_model(name, **SMALL[name])
    sharded = get_model(name, spatial_axis=axes, **SMALL[name])
    sharded.load_state_dict(mono.state_dict())
    assert sharded.config.spatial_axis == axes


@pytest.mark.parametrize("size", ["s", "b", "l"])
def test_sharded_model_loads_the_monolithic_state(size):
    """The parameter names and shapes do not depend on spatial_axis."""
    mono = get_model(f"rawformer_{size}")
    sharded = get_model(f"rawformer_{size}", spatial_axis=("spatial", "spatial_w"))
    sharded.load_state_dict(mono.state_dict())
    assert sharded.config.spatial_axis == ("spatial", "spatial_w")


def test_tiled_forward_refuses_other_axes_than_the_model():
    with pytest.raises(ValueError, match="does not name the axes"):
        tiled.make_tiled_forward(RawFormer(RawFormerConfig(dim=8, num_heads=HEADS)), None)
    model = RawFormer(RawFormerConfig(dim=8, num_heads=HEADS, spatial_axis="spatial"))
    with pytest.raises(ValueError, match="does not name the axes"):
        tiled.make_tiled_forward(model, None, spatial_w_axis="spatial_w")
