"""K2 / K3 at the wide widths, C = 384 and 512 (RawFormer-B's and -L's
bottleneck), and band mode running every TransformerBlock of a RawFormer on
them, against the JAX package (CPU): the port's band twin against JAX
``fused_transformer_block(bands=)`` (Pallas in interpret mode) and against
the port's monolithic twin, banded RawFormer-B / -L widths (dim 48 and 64)
against the JAX monolithic forward, the blocks band mode routes to the
kernels, and the wide plans of ``tile_config`` / ``block_plan``. The kernels
at these widths against their twins are in tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayer_low_light_image_enhancement_tpu.kernels import fused_block as jfb
from bayer_low_light_image_enhancement_tpu.models.common import TransformerBlock as JaxBlock
from bayer_low_light_image_enhancement_tpu.models.rawformer import (
    RawFormer as JaxRawFormer,
    RawFormerConfig as JaxRawFormerConfig,
)
from bayer_low_light_image_enhancement_tpu_torch.compat import state_dict_from_jax
from bayer_low_light_image_enhancement_tpu_torch.compat.jax_params import (
    transformer_block_state_dict,
)
from bayer_low_light_image_enhancement_tpu_torch.kernels import fused_block as fb
from bayer_low_light_image_enhancement_tpu_torch.kernels import ops
from bayer_low_light_image_enhancement_tpu_torch.models import RawFormer, RawFormerConfig, common
from bayer_low_light_image_enhancement_tpu_torch.models.fused_apply import (
    band_halo,
    make_banded_forward,
)

torch.set_num_threads(2)

# The JAX kernel computes in bf16: its tests' bar (tests/test_fused_block.py).
BF16_TOL = dict(rtol=2.5e-2, atol=2.5e-2)
# fp32 against fp32: the repo's model bar, and the port's twins against each other.
TOL = dict(rtol=1e-4, atol=1e-4)
TWIN_TOL = dict(rtol=1e-5, atol=1e-5)
H100_SMS = 132


def cdiv(a, b):
    return -(-a // b)


# ---------------------------------------------------------------------------
# The band-mode block at C = 384 and 512
# ---------------------------------------------------------------------------


def jax_block(c, seed):
    """An 8-head JAX TransformerBlock's params with non-trivial LN affines
    and temperatures, and the port's state dict of the same."""
    module = JaxBlock(num_heads=8)
    p = module.init(jax.random.PRNGKey(seed), jnp.zeros((1, 8, 8, c)))["params"]
    p = jax.tree.map(np.asarray, p)
    g = np.random.default_rng(seed)
    for n in ("norm1", "norm2"):
        p[n] = {k: v + g.uniform(-0.3, 0.3, v.shape).astype(np.float32) for k, v in p[n].items()}
    p["attn"]["temperature"] = p["attn"]["temperature"] + g.uniform(-0.5, 0.5, 8).astype(
        np.float32)
    return jax.tree.map(jnp.asarray, p), transformer_block_state_dict(p)


@pytest.fixture(scope="module", params=[(384, None), (384, 7), (512, None), (512, 6)],
                ids=["384", "384-frame7", "512", "512-frame6"])
def wide_block(request):
    """[2, 4, 8, C] as 2 bands of one frame of 8 rows (``frame_h`` rows of
    it real: 7 or 6 leave rows of noise past the frame): the JAX band
    kernel's output in interpret mode, the input (bf16 values) and the
    port's state dict."""
    c, frame_h = request.param
    params, sd = jax_block(c, seed=c + (frame_h or 0))
    x = np.random.default_rng(c).standard_normal((2, 4, 8, c)).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    want = jfb.fused_transformer_block(xb, params, 8, bands=2, frame_h=frame_h)
    return c, frame_h, np.asarray(xb, np.float32), sd, np.asarray(want, np.float32)


def test_wide_band_twin_matches_jax_kernel(wide_block):
    c, frame_h, x, sd, want = wide_block
    got = fb.fused_transformer_block(torch.from_numpy(x), sd, 8, bands=2, frame_h=frame_h)
    assert got.shape == (2, 4, 8, c)
    fh = 8 if frame_h is None else frame_h
    # Rows past the frame are the JAX kernel's as well as the port's own
    # business: compare the frame's rows.
    np.testing.assert_allclose(got.numpy().reshape(1, 8, 8, c)[:, :fh],
                               want.reshape(1, 8, 8, c)[:, :fh], **BF16_TOL)


def test_wide_band_twin_matches_monolithic_twin(wide_block):
    """The same inputs: the band twin (both ``fused_transformer_block`` on
    the CPU and ``fused_transformer_block_plain``) against the port's
    monolithic twin on the frame's rows, fp32."""
    c, frame_h, x, sd, _ = wide_block
    fh = 8 if frame_h is None else frame_h
    frame = torch.from_numpy(x).reshape(1, 8, 8, c)
    want = fb.fused_transformer_block(frame[:, :fh].contiguous(), sd, 8)
    for fn in (fb.fused_transformer_block, fb.fused_transformer_block_plain):
        got = fn(torch.from_numpy(x), sd, 8, bands=2, frame_h=frame_h)
        assert got.shape == (2, 4, 8, c) and got.dtype == torch.float32
        np.testing.assert_allclose(got.reshape(1, 8, 8, c)[:, :fh].numpy(), want.numpy(),
                                   **TWIN_TOL)


def port_weights(c, seed):
    """A seeded port TransformerBlock's folded weights (8 heads)."""
    blk = common.TransformerBlock(c, 8, 2)
    common.reset_parameters_(blk, torch.Generator().manual_seed(seed))
    return fb.fold_block_params({k: v.detach() for k, v in blk.named_parameters()})


@pytest.mark.parametrize("c", fb.WIDE_WIDTHS)
def test_wide_band_partials_sum_to_the_frame_gram(c):
    w = port_weights(c, seed=1)
    frame = torch.randn(1, 12, 5, c, generator=torch.Generator().manual_seed(c))
    xh = band_halo(frame.reshape(3, 4, 5, c), 2, 3)
    gram, qss, kss = fb.gram_pass_banded(xh, w, 3, 12)
    for got, want in zip((gram, qss, kss), fb.gram_pass_plain(frame, w)):
        np.testing.assert_allclose(got.sum(0, keepdim=True).numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-3)


@pytest.mark.parametrize("name", ["gram_pass_banded", "apply_pass_banded", "gram_pass",
                                  "apply_pass"])
@pytest.mark.parametrize("c", fb.WIDE_WIDTHS)
def test_wide_opcheck_and_flops_on_cpu(c, name):
    """The four operators take the wide widths (opcheck, the output's
    shape), and each flop formula counts what its twin computes there."""
    from torch.utils.flop_counter import FlopCounterMode

    w = port_weights(c, seed=2)
    g = torch.Generator().manual_seed(c)
    xh = band_halo(torch.randn(4, 3, 5, c, generator=g), 2, 2)
    apply = torch.randn(4, c, c, generator=g) / c
    args, twin, formula, want = {
        "gram_pass_banded": ((xh, *w.gram_tensors(), 2, 6),
                             lambda: fb.gram_pass_banded_plain(xh, w, 2, 6),
                             ops.gram_pass_banded_flops, (4, c * c + 2 * c)),
        "apply_pass_banded": ((xh, apply, *w.apply_tensors(), 2, 5),
                              lambda: fb.apply_pass_banded_plain(xh, apply, w, 2, 5),
                              ops.apply_pass_banded_flops, (4, 3, 5, c)),
        "gram_pass": ((xh, *w.gram_tensors()), lambda: fb.gram_pass_plain(xh, w),
                      ops.gram_pass_flops, (4, c * c + 2 * c)),
        "apply_pass": ((xh, apply, *w.apply_tensors()),
                       lambda: fb.apply_pass_plain(xh, apply, w), ops.apply_pass_flops,
                       (4, 7, 5, c)),
    }[name]
    op = getattr(torch.ops.blle, name).default
    torch.library.opcheck(op, args)
    assert tuple(op(*args).shape) == want
    with FlopCounterMode(display=False) as m:
        twin()
    assert m.get_total_flops() == formula(*xh.shape)


# ---------------------------------------------------------------------------
# Banded RawFormer-B / -L widths against the JAX monolithic forward
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=[48, 64], ids=["dim48", "dim64"])
def wide_rawformer(request):
    """A RawFormer of dim 48 (B's widths: 48 .. 384) or 64 (L's: 64 .. 512),
    heads (8, 8, 8, 8), its JAX params filled from a seed over the init's
    shapes, the JAX monolithic fp32 forward on a [1, 128, 48] mosaic, and the
    port's model on the same weights."""
    dim = request.param
    cfg = dict(dim=dim, num_heads=(8, 8, 8, 8))
    jmodel = JaxRawFormer(JaxRawFormerConfig(**cfg))
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 1)))
    g = np.random.default_rng(dim)

    def fill(path, s):
        name = jax.tree_util.keystr(path)
        bound = 1.0 / np.sqrt(np.prod(s.shape[:-1])) if "kernel" in name else 0.2
        v = g.uniform(-bound, bound, s.shape)
        if "temperature" in name or ("norm" in name and "weight" in name):
            v = v + 1.0
        return v.astype(np.float32)

    params = jax.tree_util.tree_map_with_path(fill, shapes)
    x = np.random.default_rng(dim + 1).uniform(0, 1, (1, 128, 48, 1)).astype(np.float32)
    want = np.asarray(jax.jit(jmodel.apply)(params, jnp.asarray(x)))
    port = RawFormer(RawFormerConfig(**cfg))
    port.load_state_dict(state_dict_from_jax(params))
    return dim, port.eval(), torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(), want


def test_wide_banded_rawformer_matches_jax_monolithic(wide_rawformer):
    """4 bands of 32 mosaic rows (the bottleneck's bands 2 rows tall): every
    block, the 8 x dim bottleneck included, through the band twins."""
    _, port, x, want = wide_rawformer
    with torch.inference_mode():
        got = make_banded_forward(port, 4)(x)
    assert got.shape == (1, 3, 128, 48)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, **TOL)


def test_band_mode_fuses_every_block(wide_rawformer, monkeypatch):
    """In band mode all seven TransformerBlocks reach
    ``fused_transformer_block`` (the bottleneck's 8 x dim too) and no
    attention module runs; the monolithic forward still sends the 8 x dim
    bottleneck (above FUSE_CMAX) to the module path."""
    dim, port, x, _ = wide_rawformer
    fused, attn = [], []
    real = common.fused_transformer_block

    def counting(x_nhwc, *args, **kw):
        fused.append((x_nhwc.shape[-1], kw.get("bands", 1)))
        return real(x_nhwc, *args, **kw)

    def run(fn):
        fused.clear(), attn.clear()
        with torch.inference_mode():
            fn(x)
        return list(fused), list(attn)

    monkeypatch.setattr(common, "fused_transformer_block", counting)
    hooks = [m.register_forward_hook(lambda mod, i, o: attn.append(i[0].shape[1]))
             for m in port.modules() if isinstance(m, common.ChannelAttention)]
    try:
        banded = run(make_banded_forward(port, 4))
        mono = run(port)
    finally:
        for h in hooks:
            h.remove()
    levels = [dim, 2 * dim, 4 * dim, 8 * dim, 4 * dim, 2 * dim, dim]
    assert banded == ([(c, 4) for c in levels], [])
    assert mono == ([(c, 1) for c in levels if c != 8 * dim], [8 * dim])


# ---------------------------------------------------------------------------
# The wide plans (csrc/block_tiles.cuh GramCfg / Apply1Cfg / Apply2Cfg)
# ---------------------------------------------------------------------------

SHAPES = [(1, 3, 5), (2, 19, 13), (8, 23, 272), (8, 27, 272), (1, 184, 272), (3, 11, 29)]


@pytest.mark.parametrize("c", fb.WIDE_WIDTHS)
@pytest.mark.parametrize("kind", ["gram", "apply1", "apply2"])
def test_wide_tile_configs_fit_an_h100_block(kind, c):
    """Within 232,448 bytes of shared memory (the plans of the other widths'
    staging would ask 314-504 KB here), one 512-thread CTA an SM, tiles of
    whole m16 rows, the gram in 2 x 2 blocks of 192 channels at 384 and
    4 x 4 of 128 at 512."""
    cfg = fb.tile_config(kind, c)
    assert cfg.smem <= fb.SMEM_PER_BLOCK < 2 * (cfg.smem + 1024)
    assert cfg.threads == 512
    assert (cfg.th * cfg.tw) % 16 == 0
    assert cfg.splits == ({384: 2, 512: 4}[c] if kind == "gram" else 1)
    want = {("gram", 384): 4, ("gram", 512): 6, ("apply1", 384): 6, ("apply1", 512): 4,
            ("apply2", 384): 8, ("apply2", 512): 6}[kind, c]
    assert (cfg.th, cfg.tw) == (want, 8)


@pytest.mark.parametrize("c", fb.WIDE_WIDTHS)
def test_wide_widths_are_k2_k3_only(c):
    """A1, K3P and the other kernels keep KERNEL_WIDTHS: their plans and
    input checks refuse the wide widths, which K2 / K3's accept."""
    for kind in ("attn_gram", "attn_apply"):
        with pytest.raises(ValueError, match="no kernel"):
            fb.tile_config(kind, c)
    with pytest.raises(ValueError, match="no K3P"):
        fb.tile_config(fb.PIPE, c)
    x = torch.zeros(1, 4, 4, c)
    with pytest.raises(ValueError, match="no kernel"):
        fb.check_kernel_input(x)
    fb.check_kernel_input(x, widths=fb.BLOCK_WIDTHS)
    assert c not in fb.KERNEL_WIDTHS and c in fb.BLOCK_WIDTHS


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("kind", ["gram", "apply1", "apply2"])
@pytest.mark.parametrize("c", fb.WIDE_WIDTHS)
def test_wide_plans_cover_the_image_once(c, kind, shape):
    """The tiles cover H and W with less than one tile to spare; the CTAs'
    runs partition the tiles they walk in order, none idle; K2's workspace
    holds one [cb, cb] block and its 2 cb sums per CTA of each (image,
    block)."""
    b, h, w = shape
    for resident in (1, 3, H100_SMS):
        plan = fb.block_plan(kind, b, h, w, c, resident)
        cfg = plan.config
        th, tw = cdiv(h, cfg.th), cdiv(w, cfg.tw)
        assert plan.tiles == th * tw
        assert th * cfg.th >= h > (th - 1) * cfg.th and tw * cfg.tw >= w > (tw - 1) * cfg.tw
        walked = plan.tiles if kind == "gram" else b * plan.tiles
        assert 1 <= plan.ctas <= walked
        runs = [(walked * i // plan.ctas, walked * (i + 1) // plan.ctas)
                for i in range(plan.ctas)]
        assert all(r0 < r1 for r0, r1 in runs) and runs[-1][1] == walked
        if kind == "gram":
            cb = c // cfg.splits
            assert plan.blocks == cfg.splits ** 2 and plan.launches == 2
            assert plan.ctas == max(1, min(plan.tiles, resident // (b * plan.blocks)))
            assert fb.gram_workspace_floats(b, h, w, c, plan) == \
                b * plan.blocks * plan.ctas * (cb * cb + 2 * cb)
        else:
            assert plan.ctas == min(walked, resident) and plan.launches == 1
