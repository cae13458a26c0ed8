"""The port's RawFormer and Predictor against the JAX package on the same
weights and inputs (CPU): weight carry in both directions, the full model in
fp32, the uint16 serving path in bf16, and padding/cropping of odd frames."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from bayer_low_light_image_enhancement_tpu.compat.torch_import import import_rawformer_state_dict
from bayer_low_light_image_enhancement_tpu.kernels.bayer_pack import (
    make_raw_u16_forward as jax_make_raw_u16_forward,
)
from bayer_low_light_image_enhancement_tpu.models.fused_apply import make_fused_forward
from bayer_low_light_image_enhancement_tpu.models.rawformer import (
    RawFormer as JaxRawFormer,
    RawFormerConfig as JaxRawFormerConfig,
)
from bayer_low_light_image_enhancement_tpu.serving import Predictor as JaxPredictor
from bayer_low_light_image_enhancement_tpu_torch.compat import state_dict_from_jax
from bayer_low_light_image_enhancement_tpu_torch.models import (
    RawFormer,
    RawFormerConfig,
    get_model,
    list_models,
)
from bayer_low_light_image_enhancement_tpu_torch.serving import Predictor

torch.set_num_threads(2)

RNG = np.random.default_rng(17)


def jax_model_and_params(dim, heads, dtype=jnp.float32, seed=0):
    """A JAX RawFormer and a params tree of its init's structure and shapes
    (``jax.eval_shape``: tracing only, no compile), filled from a seed:
    U(+-1/sqrt(fan_in)) kernels and biases like torch's conv init, LN affines
    and temperatures near 1 / 0 but not at them."""
    model = JaxRawFormer(JaxRawFormerConfig(dim=dim, num_heads=(heads,) * 4, dtype=dtype))
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 1)))
    g = np.random.default_rng(seed)

    def fill(path, s):
        name = jax.tree_util.keystr(path)
        if "kernel" in name:
            bound = 1.0 / np.sqrt(np.prod(s.shape[:-1]))
        else:
            bound = 0.2
        v = g.uniform(-bound, bound, s.shape)
        if "temperature" in name or ("norm" in name and "weight" in name):
            v = v + 1.0
        return v.astype(np.float32)

    return model, jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module")
def fp32_pair():
    """dim-16 JAX RawFormer and the port's, on the same weights."""
    jmodel, params = jax_model_and_params(16, 4)
    port = RawFormer(RawFormerConfig(dim=16, num_heads=(4, 4, 4, 4)))
    port.load_state_dict(state_dict_from_jax(params))
    return jax.jit(jmodel.apply), params, port.eval()


def test_weight_carry_round_trip(fp32_pair):
    """JAX params tree -> state_dict_from_jax -> the JAX package's own .pth
    importer gives back the identical tree."""
    _, params, port = fp32_pair
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    back = import_rawformer_state_dict(sd)
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_b[path]), leaf, err_msg=str(path))


def test_state_dict_names_match_reference_oracle():
    from torch_oracle import RawFormerOracle

    port = RawFormer(RawFormerConfig(dim=8, num_heads=(2, 2, 2, 2)))
    oracle = RawFormerOracle(dim=8, num_heads=(2, 2, 2, 2))
    assert {k: v.shape for k, v in port.state_dict().items()} == {
        k: v.shape for k, v in oracle.state_dict().items()
    }


@pytest.mark.parametrize("scale", [1.0, 300.0])  # [0,1] and ratio-amplified input
def test_full_model_matches_jax_fp32(fp32_pair, scale):
    japply, params, port = fp32_pair
    x = (RNG.uniform(0, 1, (1, 32, 32, 1)) * scale).astype(np.float32)
    want = np.asarray(japply(params, jnp.asarray(x)))
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_predictor_odd_frame_matches_jax_predictor():
    jmodel, params = jax_model_and_params(8, 2, seed=1)
    port = RawFormer(RawFormerConfig(dim=8, num_heads=(2, 2, 2, 2)))
    pred = Predictor.from_jax_params(port, params, device="cpu")
    jpred = JaxPredictor(jmodel, jax.tree.map(jnp.asarray, params), use_fused=False)
    x = RNG.uniform(0, 2, (37, 45)).astype(np.float32)
    got = pred(x)
    assert got.shape == (37, 45, 3)
    np.testing.assert_allclose(got, jpred(x), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(pred(x[..., None]), got)
    with pytest.raises(ValueError):
        pred(np.zeros((1, 32, 32, 3), np.float32))


def test_predictor_raw_u16_matches_jax_fused_bf16():
    """The production input path: uint16 mosaic + ratio -> pack -> prepacked
    bf16 model, against the JAX fused forward (Pallas in interpret mode)."""
    jmodel, params = jax_model_and_params(8, 2, dtype=jnp.bfloat16, seed=2)
    port = RawFormer(RawFormerConfig(dim=8, num_heads=(2, 2, 2, 2), dtype=torch.bfloat16))
    pred = Predictor.from_jax_params(port, params, device="cpu")
    mosaic = RNG.integers(0, 17000, (2, 32, 32), dtype=np.uint16)
    ratio = np.array([100.0, 300.0], np.float32)
    fwd = jax.jit(jax_make_raw_u16_forward(make_fused_forward(jmodel), dtype=jnp.bfloat16))
    want = np.asarray(fwd(jax.tree.map(jnp.asarray, params), jnp.asarray(mosaic),
                          jnp.asarray(ratio)), np.float32)
    got = pred.raw_u16(mosaic, ratio)
    assert got.shape == (2, 32, 32, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, np.clip(want, 0, 1), rtol=0.05, atol=2e-2)


def test_predictor_raw_u16_pads_and_crops():
    port = RawFormer(RawFormerConfig(dim=8, num_heads=(2, 2, 2, 2)))
    pred = Predictor(port, device="cpu")
    mosaic = RNG.integers(0, 17000, (20, 34), dtype=np.uint16)
    got = pred.raw_u16(mosaic, 50.0)
    assert got.shape == (20, 34, 3)
    padded = np.zeros((32, 48), np.uint16)
    padded[:20, :34] = mosaic
    np.testing.assert_allclose(got, pred.raw_u16(padded, 50.0)[:20, :34], rtol=1e-6, atol=1e-6)
    with pytest.raises(TypeError):
        pred.raw_u16(mosaic.astype(np.int32), 50.0)


def test_from_torch_pth_round_trip(tmp_path):
    """A reference-style .pth ({'state_dict'}, 'module.' prefixes) loads."""
    src = RawFormer(RawFormerConfig(dim=8, num_heads=(2, 2, 2, 2)),
                    generator=torch.Generator().manual_seed(5))
    path = tmp_path / "model_best.pth"
    torch.save({"epoch": 1, "state_dict": {"module." + k: v for k, v in src.state_dict().items()}},
               path)
    pred = Predictor.from_torch(RawFormer(RawFormerConfig(dim=8, num_heads=(2, 2, 2, 2))), str(path),
                                device="cpu")
    x = RNG.uniform(0, 1, (1, 32, 32, 1)).astype(np.float32)
    np.testing.assert_array_equal(pred(x), Predictor(src, device="cpu")(x))


def test_registry_and_seeded_init():
    assert list_models() == ["bayertorgb_rawformer", "flca_rawformer", "flca_unet",
                             "luma_mhsa_rawformer", "lumachroma_transformer",
                             "multilvl_flca_rawformer", "rawformer_b", "rawformer_l",
                             "rawformer_s", "rawformer_wfb", "simple_flca_unet",
                             "truecolor_rawformer", "unet_luma_dwt", "wavkan_rawformer"]
    a = get_model("rawformer_s", generator=torch.Generator().manual_seed(0))
    b = get_model("rawformer_s", generator=torch.Generator().manual_seed(0))
    assert a.config.dim == 32 and get_model("rawformer_l").config.dim == 64
    for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)


def test_port_imports_no_jax():
    code = (
        "import sys, bayer_low_light_image_enhancement_tpu_torch as p\n"
        "import bayer_low_light_image_enhancement_tpu_torch.serving\n"
        "import bayer_low_light_image_enhancement_tpu_torch.compat\n"
        "import bayer_low_light_image_enhancement_tpu_torch.kernels.fused_block\n"
        "import bayer_low_light_image_enhancement_tpu_torch.kernels.fused_block_bwd\n"
        "import bayer_low_light_image_enhancement_tpu_torch.kernels.ssm_scan\n"
        "import bayer_low_light_image_enhancement_tpu_torch.models.wfb\n"
        "import bayer_low_light_image_enhancement_tpu_torch.utils.profiling\n"
        "import bayer_low_light_image_enhancement_tpu_torch.train\n"
        "import bayer_low_light_image_enhancement_tpu_torch.data\n"
        "import bayer_low_light_image_enhancement_tpu_torch.utils.logging\n"
        "import bayer_low_light_image_enhancement_tpu_torch.cli.train_cli\n"
        "import bayer_low_light_image_enhancement_tpu_torch.cli.test_cli\n"
        "import bayer_low_light_image_enhancement_tpu_torch.data.native\n"
        "import bayer_low_light_image_enhancement_tpu_torch.data.mcr\n"
        "import bayer_low_light_image_enhancement_tpu_torch.data.raw\n"
        "import bayer_low_light_image_enhancement_tpu_torch.ops.luma\n"
        "import bayer_low_light_image_enhancement_tpu_torch.ops.flca\n"
        "import bayer_low_light_image_enhancement_tpu_torch.ops.isp\n"
        "import bayer_low_light_image_enhancement_tpu_torch.models.flca_rawformer\n"
        "import bayer_low_light_image_enhancement_tpu_torch.models.multilvl_flca\n"
        "import bayer_low_light_image_enhancement_tpu_torch.models.truecolor\n"
        "import bayer_low_light_image_enhancement_tpu_torch.kernels.ops\n"
        "import bayer_low_light_image_enhancement_tpu_torch.serving.export\n"
        "import bayer_low_light_image_enhancement_tpu_torch.cli.export_cli\n"
        "import bayer_low_light_image_enhancement_tpu_torch.utils.flops\n"
        "import bayer_low_light_image_enhancement_tpu_torch.utils.debug\n"
        "import bayer_low_light_image_enhancement_tpu_torch.core.mesh\n"
        "import bayer_low_light_image_enhancement_tpu_torch.parallel.tensor\n"
        "import bayer_low_light_image_enhancement_tpu_torch.parallel.tiled\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m.split('.')[0] == 'bayer_low_light_image_enhancement_tpu']\n"
        "assert not bad, bad\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], check=True, cwd=root, timeout=120)
