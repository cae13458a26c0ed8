"""Band mode, the port's single-card full-frame forward, against the JAX
package (CPU): ``band_halo`` against JAX ``_band_halo``, ``pick_bands``, the
band-mode block twin against JAX ``fused_transformer_block(bands=)`` (Pallas
in interpret mode) and against the port's monolithic twin, the banded
RawFormer against the JAX monolithic forward on the same weights (twins and
the module path), the band operators, the errors and the eval CLI's route.
The kernels in band mode against their twins are in tests/test_torch_cuda.py.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayer_low_light_image_enhancement_tpu.kernels import fused_block as jfb
from bayer_low_light_image_enhancement_tpu.models.fused_apply import _band_halo as jax_band_halo
from bayer_low_light_image_enhancement_tpu.models.fused_apply import pick_bands as jax_pick_bands
from bayer_low_light_image_enhancement_tpu.models.rawformer import (
    RawFormer as JaxRawFormer,
    RawFormerConfig as JaxRawFormerConfig,
)
from bayer_low_light_image_enhancement_tpu.models.common import TransformerBlock as JaxBlock
from bayer_low_light_image_enhancement_tpu_torch.cli import test_cli
from bayer_low_light_image_enhancement_tpu_torch.compat import state_dict_from_jax
from bayer_low_light_image_enhancement_tpu_torch.compat.jax_params import (
    transformer_block_state_dict,
)
from bayer_low_light_image_enhancement_tpu_torch.core.mesh import BoundAxis
from bayer_low_light_image_enhancement_tpu_torch.kernels import fused_block as fb
from bayer_low_light_image_enhancement_tpu_torch.kernels import ops
from bayer_low_light_image_enhancement_tpu_torch.models import RawFormer, RawFormerConfig, common
from bayer_low_light_image_enhancement_tpu_torch.models.fused_apply import (
    band_halo,
    make_banded_forward,
    pick_bands,
)

torch.set_num_threads(2)

# The JAX kernel computes in bf16: its tests' bar (tests/test_fused_block.py).
BF16_TOL = dict(rtol=2.5e-2, atol=2.5e-2)
# fp32 against fp32: the repo's model bar, and the port's twins against each other.
TOL = dict(rtol=1e-4, atol=1e-4)
TWIN_TOL = dict(rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# band_halo, pick_bands
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("r", [1, 2])
@pytest.mark.parametrize("bands", [2, 4, 8])
@pytest.mark.parametrize("hb", [1, 3])  # one-row bands: the halo spans several
def test_band_halo_matches_jax(r, bands, hb):
    x = np.random.default_rng(bands * 10 + hb).standard_normal((2 * bands, hb, 5, 3))
    x = x.astype(np.float32)
    got = band_halo(torch.from_numpy(x), r, bands)
    want = np.asarray(jax_band_halo(jnp.asarray(x), r, bands))
    assert got.shape == (2 * bands, hb + 2 * r, 5, 3)
    np.testing.assert_array_equal(got.numpy(), want)
    # The channels-last NCHW form is the NHWC one, permuted.
    nchw = torch.from_numpy(x).permute(0, 3, 1, 2)
    np.testing.assert_array_equal(band_halo(nchw, r, bands, nchw=True).permute(0, 2, 3, 1).numpy(),
                                  want)


def test_pick_bands_matches_jax():
    for h in range(1, 4097):
        assert pick_bands(h) == jax_pick_bands(h), h
    assert pick_bands(2944) == 8 and pick_bands(1040) == 5 and pick_bands(100) == 1


# ---------------------------------------------------------------------------
# The band-mode block
# ---------------------------------------------------------------------------


def jax_block(c, heads, seed):
    """A JAX TransformerBlock's params with non-trivial LN affines and
    temperatures, and the port's state dict of the same."""
    module = JaxBlock(num_heads=heads)
    p = module.init(jax.random.PRNGKey(seed), jnp.zeros((1, 8, 8, c)))["params"]
    p = jax.tree.map(np.asarray, p)
    g = np.random.default_rng(seed)
    for n in ("norm1", "norm2"):
        p[n] = {k: v + g.uniform(-0.3, 0.3, v.shape).astype(np.float32) for k, v in p[n].items()}
    p["attn"]["temperature"] = p["attn"]["temperature"] + g.uniform(-0.5, 0.5, heads).astype(
        np.float32)
    return jax.tree.map(jnp.asarray, p), transformer_block_state_dict(p)


def test_band_block_twin_matches_jax_kernel():
    """[4, 16, 48, 32] as 4 bands of one 64-row frame: the port's band twin
    against the JAX band kernel (interpret mode, bf16 inside). C = 32: JAX
    band mode needs 128-aligned packed lanes (4 bands x 32)."""
    params, sd = jax_block(32, 8, seed=21)
    x = np.random.default_rng(21).standard_normal((4, 16, 48, 32)).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    want = jfb.fused_transformer_block(xb, params, 8, bands=4)
    got = fb.fused_transformer_block(torch.from_numpy(np.asarray(xb, np.float32)), sd, 8,
                                     bands=4)
    assert got.shape == (4, 16, 48, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32), **BF16_TOL)


def port_block(c, heads, seed):
    blk = common.TransformerBlock(c, heads, 2)
    g = torch.Generator().manual_seed(seed)
    common.reset_parameters_(blk, g)
    with torch.no_grad():
        for name, p in blk.named_parameters():
            if "norm" in name or "temperature" in name:
                p.add_(torch.empty(p.shape).uniform_(-0.3, 0.3, generator=g))
    return {k: v.detach() for k, v in blk.named_parameters()}


@pytest.mark.parametrize("frames,bands,hb,w,c,frame_h", [
    (1, 4, 6, 10, 16, None),
    (2, 3, 5, 7, 32, None),
    (1, 8, 1, 9, 16, None),   # one-row bands: the 2-row halo spans two bands
    (2, 4, 5, 6, 16, 17),     # a frame of 17 rows in 4 bands of 5: 3 rows past it
])
def test_band_block_matches_monolithic_twin(frames, bands, hb, w, c, frame_h):
    """The band-mode block (its operators' twins on the CPU) against the
    port's monolithic twin on the frame, fp32: the frame's rows past
    ``frame_h`` hold noise that must not reach the frame's rows."""
    sd = port_block(c, 4, seed=hb * 7 + c)
    fh = bands * hb if frame_h is None else frame_h
    g = np.random.default_rng(fh)
    frame = torch.from_numpy(g.standard_normal((frames, bands * hb, w, c)).astype(np.float32))
    xb = frame.reshape(frames * bands, hb, w, c)
    want = fb.fused_transformer_block(frame[:, :fh].contiguous(), sd, 4)
    for fn in (fb.fused_transformer_block, fb.fused_transformer_block_plain):
        got = fn(xb, sd, 4, bands=bands, frame_h=frame_h)
        assert got.shape == xb.shape and got.dtype == torch.float32
        got = got.reshape(frames, bands * hb, w, c)[:, :fh]
        np.testing.assert_allclose(got.numpy(), want.numpy(), **TWIN_TOL)


def test_band_partials_sum_to_the_frame_gram():
    """Each band's partial counts its own frame rows once: a frame's bands
    sum to the monolithic gram and sums of squares."""
    sd = port_block(16, 4, seed=3)
    w = fb.fold_block_params(sd)
    frame = torch.randn(2, 24, 11, 16, generator=torch.Generator().manual_seed(3))
    xh = band_halo(frame.reshape(8, 6, 11, 16), 2, 4)
    gram, qss, kss = fb.gram_pass_banded(xh, w, 4, 24)
    for got, want in zip((gram, qss, kss), fb.gram_pass_plain(frame, w)):
        got = got.reshape(2, 4, *got.shape[1:]).sum(1)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-4)


def band_op_cases():
    sd = port_block(16, 4, seed=9)
    w = fb.fold_block_params(sd)
    g = torch.Generator().manual_seed(9)
    xh = band_halo(torch.randn(4, 5, 7, 16, generator=g), 2, 2)
    apply = torch.randn(4, 16, 16, generator=g) / 16
    return {
        "gram_pass_banded": (xh, *w.gram_tensors(), 2, 10),
        "apply_pass_banded": (xh, apply, *w.apply_tensors(), 2, 9),
    }


@pytest.mark.parametrize("name", ["gram_pass_banded", "apply_pass_banded"])
def test_band_opcheck_on_cpu(name):
    op = getattr(torch.ops.blle, name).default
    args = band_op_cases()[name]
    torch.library.opcheck(op, args)
    out = op(*args)
    want = {"gram_pass_banded": (4, 16 * 16 + 32), "apply_pass_banded": (4, 5, 7, 16)}[name]
    assert tuple(out.shape) == want


def test_band_flop_formulas_count_what_the_twins_compute():
    from torch.utils.flop_counter import FlopCounterMode

    def counted(fn, *args):
        with FlopCounterMode(display=False) as m:
            fn(*args)
        return m.get_total_flops()

    cases = band_op_cases()
    xh = cases["gram_pass_banded"][0]
    shape = tuple(xh.shape)
    w = fb.fold_block_params(port_block(16, 4, seed=9))
    assert counted(fb.gram_pass_banded_plain, xh, w, 2, 10) == ops.gram_pass_banded_flops(*shape)
    assert counted(torch.ops.blle.gram_pass_banded, *cases["gram_pass_banded"]) \
        == ops.gram_pass_banded_flops(*shape)
    apply = cases["apply_pass_banded"][1]
    assert counted(fb.apply_pass_banded_plain, xh, apply, w, 2, 9) \
        == ops.apply_pass_banded_flops(*shape)
    assert counted(torch.ops.blle.apply_pass_banded, *cases["apply_pass_banded"]) \
        == ops.apply_pass_banded_flops(*shape)


def test_band_inputs_are_checked():
    w = fb.fold_block_params(port_block(16, 4, seed=1))
    with pytest.raises(ValueError, match="not divisible by bands"):
        fb.gram_pass_banded_plain(torch.zeros(3, 8, 4, 16), w, 2, 8)
    with pytest.raises(ValueError, match="frame_h"):
        fb.gram_pass_banded_plain(torch.zeros(4, 8, 4, 16), w, 2, 9)
    with pytest.raises(ValueError, match="hb \\+ 4"):
        fb.gram_pass_banded_plain(torch.zeros(4, 4, 4, 16), w, 2, 1)


# ---------------------------------------------------------------------------
# The banded RawFormer
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def rawformer_pair():
    """A dim-16 JAX RawFormer's params (filled from a seed over the init's
    shapes), its monolithic fp32 forward on a [1, 128, 48] mosaic, and the
    port's model on the same weights."""
    jmodel = JaxRawFormer(JaxRawFormerConfig(dim=16, num_heads=(2, 2, 2, 2)))
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 1)))
    g = np.random.default_rng(5)

    def fill(path, s):
        name = jax.tree_util.keystr(path)
        bound = 1.0 / np.sqrt(np.prod(s.shape[:-1])) if "kernel" in name else 0.2
        v = g.uniform(-bound, bound, s.shape)
        if "temperature" in name or ("norm" in name and "weight" in name):
            v = v + 1.0
        return v.astype(np.float32)

    params = jax.tree_util.tree_map_with_path(fill, shapes)
    x = np.random.default_rng(6).uniform(0, 1, (1, 128, 48, 1)).astype(np.float32)
    want = np.asarray(jax.jit(jmodel.apply)(params, jnp.asarray(x)))
    port = RawFormer(RawFormerConfig(dim=16, num_heads=(2, 2, 2, 2)))
    port.load_state_dict(state_dict_from_jax(params))
    return port.eval(), torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(), want


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("bands", [4, 8])
def test_banded_rawformer_matches_jax_monolithic(rawformer_pair, bands, fused):
    """8 bands of 16 mosaic rows: the bottleneck's bands are one row tall.
    ``fused`` False: the band-aware module path of B / L's wide blocks."""
    port, x, want = rawformer_pair
    common.set_fused_blocks(port, fused)
    try:
        with torch.inference_mode():
            got = make_banded_forward(port, bands)(x)
    finally:
        common.set_fused_blocks(port, True)
    assert got.shape == (1, 3, 128, 48)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, **TOL)
    # Unbound again: the model's own forward is the monolithic one.
    assert all(m.bands == 1 for m in port.modules() if hasattr(m, "bands"))


def test_banded_prepacked_matches_the_model(rawformer_pair):
    port, x, _ = rawformer_pair
    planes = torch.nn.functional.pixel_unshuffle(x.clamp(0, 1), 2)
    planes = planes.contiguous(memory_format=torch.channels_last)
    with torch.inference_mode():
        want = port(planes, prepacked=True)
        got = make_banded_forward(port, 4)(planes, prepacked=True)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TWIN_TOL)


def test_banded_forward_errors(rawformer_pair):
    port, x, _ = rawformer_pair
    fwd = make_banded_forward(port, 4)
    with pytest.raises(RuntimeError, match="band streaming is an inference path"):
        fwd(x)
    with torch.inference_mode():
        with pytest.raises(ValueError, match="does not split into 4 equal bands"):
            fwd(x[:, :, :120])
        with pytest.raises(ValueError, match="does not split into 3 equal bands"):
            make_banded_forward(port, 3)(x)
        common.bind_spatial(port, BoundAxis(None, 2, 0))
        try:
            with pytest.raises(ValueError, match="cannot nest spatial sharding"):
                fwd(x)
        finally:
            common.bind_spatial(port, None)
    with pytest.raises(ValueError, match="bands must be >= 1"):
        make_banded_forward(port, 0)
    sd = port_block(16, 2, seed=2)
    xr = torch.zeros(4, 8, 8, 16, requires_grad=True)
    with pytest.raises(RuntimeError, match="band streaming is an inference path"):
        fb.fused_transformer_block(xr, sd, 2, bands=2)


# ---------------------------------------------------------------------------
# The eval CLI's route
# ---------------------------------------------------------------------------


def cli_args(**kw):
    base = dict(model=None, no_fused=False, spatial_chips=1, spatial_w_chips=1, pad_to=16)
    return types.SimpleNamespace(**{**base, **kw})


@pytest.mark.parametrize("kw,shape,device,want", [
    ({}, (2848, 4256, 1), "cuda", 8),        # the Sony frame: padded to 2944 = 8 x 368
    ({}, (1, 2848, 4256, 1), "cuda", 8),
    ({}, (2848, 4256), "cuda", 8),
    ({}, (1000, 1500, 1), "cuda", 8),        # pads to 1024 = 8 x 128
    ({}, (896, 1500, 1), "cuda", 1),         # pads to 896 < 1024
    ({}, (2, 2848, 4256, 1), "cuda", 1),     # batch 2
    ({}, (2848, 4256, 1), "cpu", 1),
    ({"model": "rawformer_s"}, (2848, 4256, 1), "cuda", 1),
    ({"model": "flca_rawformer"}, (2848, 4256, 1), "cuda", 1),
    ({"no_fused": True}, (2848, 4256, 1), "cuda", 1),
    ({"spatial_chips": 2}, (2848, 4256, 1), "cuda", 1),
    ({"pad_to": 160}, (1040, 1500, 1), "cuda", 7),  # pads to 1120 = 7 x 160
])
def test_band_count(kw, shape, device, want):
    assert test_cli.band_count(cli_args(**kw), shape, device) == want


def test_eval_cli_band_route_on_cpu(tmp_path, monkeypatch):
    """The route forced on the CPU (a 2-band count for every frame): the
    banded Predictor pads to 128 and gives the monolithic CLI's metrics at
    that pad."""
    base = ["--dataset", "synthetic", "--patch_size", "32", "--fp32", "--device", "cpu",
            "--save_dir", str(tmp_path)]
    mono = test_cli.main(base + ["--pad_to", "128"])
    built = []
    real = test_cli.make_banded_forward

    def banded(model, k):
        built.append(k)
        return real(model, k)

    monkeypatch.setattr(test_cli, "band_count", lambda args, shape, device: 2)
    monkeypatch.setattr(test_cli, "make_banded_forward", banded)
    got = test_cli.main(base)
    assert built == [2]
    np.testing.assert_allclose(got["psnr"], mono["psnr"], rtol=0, atol=1e-3)
    np.testing.assert_allclose(got["ssim"], mono["ssim"], rtol=0, atol=1e-5)
