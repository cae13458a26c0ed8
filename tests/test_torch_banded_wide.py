"""K2 / K3 at the wide widths, C = 384 and 512 (RawFormer-B's and -L's
bottleneck), and band mode running every TransformerBlock of a RawFormer on
them, against the JAX package (CPU): the port's band twin against JAX
``fused_transformer_block(bands=)`` (Pallas in interpret mode) and against
the port's monolithic twin, banded RawFormer-B / -L widths (dim 48 and 64)
against the JAX monolithic forward, the blocks band mode routes to the
kernels, the plans of the wide chain (``kernels/wide_block.wide_plan``) and
the chain through its kernels' twins against the block twins. The kernels
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
from bayer_low_light_image_enhancement_tpu_torch.kernels import weight_grad as wgk
from bayer_low_light_image_enhancement_tpu_torch.kernels import wide_block as wb
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
# The wide chain's plans (kernels/wide_block.wide_plan, csrc/wide_block.cu)
# ---------------------------------------------------------------------------

SHAPES = [(1, 3, 5), (2, 19, 13), (8, 23, 272), (8, 27, 272), (1, 184, 272), (3, 11, 29)]


@pytest.mark.parametrize("c", fb.WIDE_WIDTHS)
@pytest.mark.parametrize("kind", ["layernorm", "gemm", "dw3x3"])
def test_wide_kernel_configs_fit_an_h100_block(kind, c):
    """Within 232,448 bytes of shared memory, one 288-thread GEMM CTA an SM
    (a ring of 4 stages of a 128 x 64 A box and tn / 64 B boxes of 64 x 64,
    1024-byte aligned), tile widths that divide every product's N at c; the
    LayerNorm's lanes and the dw pass's 128-channel groups cover C whole
    (q and k split on a group boundary)."""
    if kind == "gemm":
        for n in (c, 2 * c):
            tn = wb.tile_n(n)
            assert n % tn == 0 and tn in wb.GEMM_TILE_NS
            stage = wb.GEMM_TILE_M * wb.GEMM_K_STEP * 2 + tn // 64 * 64 * wb.GEMM_K_STEP * 2
            smem = wb.gemm_smem(tn)
            assert smem == 1024 + wb.GEMM_STAGES * stage + 2 * wb.GEMM_STAGES * 8
            assert smem <= fb.SMEM_PER_BLOCK < 2 * (smem + 1024)
            assert stage % 1024 == 0 and wb.GEMM_THREADS == 2 * 128 + 32
        assert c % wb.GEMM_K_STEP == 0 and (2 * c) % wb.GEMM_K_STEP == 0
    elif kind == "layernorm":
        assert c % (32 * 4) == 0 and c // 128 <= 4  # 4-channel units a lane, <= 16 values
    else:
        for f in (c, 2 * c):
            assert f % wb.DW_CHANNELS == 0
        assert c % wb.DW_CHANNELS == 0  # q / k never share a channel group


@pytest.mark.parametrize("c", fb.WIDE_WIDTHS)
def test_wide_widths_are_k2_k3_only(c):
    """A1, K3P and the other kernels keep KERNEL_WIDTHS: their plans and
    input checks refuse the wide widths, which K2 / K3's accept; the tile
    kernels' plans refuse them too (K2 / K3 run the wide chain there)."""
    for kind in fb.BLOCK_KINDS:
        with pytest.raises(ValueError, match="no kernel"):
            fb.tile_config(kind, c)
    with pytest.raises(ValueError, match="no K3P"):
        fb.tile_config(fb.PIPE, c)
    x = torch.zeros(1, 4, 4, c)
    with pytest.raises(ValueError, match="no kernel"):
        fb.check_kernel_input(x)
    fb.check_kernel_input(x, widths=fb.BLOCK_WIDTHS)
    assert c not in fb.KERNEL_WIDTHS and c in fb.BLOCK_WIDTHS


def _band_rows(b, bands, hb, first, rows):
    """[b, rows]: frame row of buffer row r of band image j, counted from
    the band's first own row (j % bands) * hb, its buffer starting at band
    row ``first``."""
    return np.array([[(j % bands) * hb + first + r for r in range(rows)] for j in range(b)])


def _check_product(g, b, rows, w, k, n):
    """A product over b images of rows x w pixels covers every pixel once
    in 128-row tiles and every column in tiles of tn."""
    assert g.g * g.m == b * rows * w and (g.rows, g.w, g.k, g.n) == (rows, w, k, n)
    mt = cdiv(g.m, wb.GEMM_TILE_M)
    assert mt * wb.GEMM_TILE_M >= g.m > (mt - 1) * wb.GEMM_TILE_M
    assert g.tiles == g.g * mt * (n // g.tn) and n % g.tn == 0
    assert g.flops == 2 * b * rows * w * k * n


def _check_dw(d, b, rz, ro, w, f, dz):
    """A dw pass reads z rows r + dz - 1 .. r + dz + 1 for its ro rows, at
    most one row past z's on either side (the zero pad of a whole image),
    and its CTAs cover its output with less than one CTA to spare."""
    assert (d.b, d.rz, d.ro, d.w, d.f, d.dz) == (b, rz, ro, w, f, dz)
    assert -1 <= d.dz - 1 and d.ro + d.dz <= d.rz
    nr, ncg = cdiv(ro, wb.DW_ROWS), cdiv(w, wb.DW_COLS)
    assert d.nx == nr * ncg
    assert nr * wb.DW_ROWS >= ro > (nr - 1) * wb.DW_ROWS
    assert ncg * wb.DW_COLS >= w > (ncg - 1) * wb.DW_COLS


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("kind", ["gram", "apply", "gram_band", "apply_band"])
@pytest.mark.parametrize("c", fb.WIDE_WIDTHS)
def test_wide_plans_cover_the_image_once(c, kind, shape):
    """Each pass of the chain reads the rows the next needs and covers every
    pixel once: LayerNorm rows inside x, each product's A the previous
    pass's output, its tiles covering M and N, the dw passes' rows and
    CTAs, the frame masks of band mode (z zero outside the frame, y on band
    rows -1 .. hb), the shapes handed to the weight-grad pass and the
    scratch the wrapper allocates."""
    b, h, w = shape
    band = kind.endswith("band")
    bands = b if band else 0
    fh = max(1, b * h - 2) if band else 0
    p = wb.wide_plan(kind.split("_")[0], b, h, w, c, bands, fh)
    hin, dz = (h + 4, 1) if band else (h, 0)
    assert (p.b, p.hin, p.h, p.w, p.c) == (b, hin, h, w, c)
    for first, rows in p.ln:
        assert 0 <= first < first + rows <= max(hin, h + 2 if band else h)
    sizes = {name: (shape_, dt) for name, shape_, dt in p.scratch}
    if p.kind == "gram":
        ((first, rows),), (gz,), (d,) = p.ln, p.gemms, p.dws
        assert (first, rows) == ((1, h + 2) if band else (0, h))
        _check_product(gz, b, rows, w, c, 2 * c)
        assert not gz.batched and gz.res_rows == 0
        _check_dw(d, b, rows, h, w, 2 * c, dz)
        assert d.epi == "qk"
        assert p.gram == (b, h * w, c, c)
        assert sizes["q"][0] == sizes["k"][0] == (b, h, w, c)
        assert sizes["partials"][0] == (b, d.nx, 2 * c) and sizes["gram"][0] == (b, c, c)
        zf, cf = gz.frame, d.frame
        if band:
            np.testing.assert_array_equal(zf.rows_of(b, rows).numpy(),
                                          _band_rows(b, bands, h, -1, rows))
            np.testing.assert_array_equal(cf.rows_of(b, h).numpy(), _band_rows(b, bands, h, 0, h))
            assert zf.frame_h == cf.frame_h == fh
        else:
            assert bool(zf.mask(b, rows).all()) and bool(cf.mask(b, h).all())
    else:
        ((f1, r1), (f2, r2)), (gv, gy, gt, go), (dv, df) = p.ln, p.gemms, p.dws
        ry = h + 2 if band else h
        assert (f1, r1, f2, r2) == (0, hin, 0, ry)
        _check_product(gv, b, hin, w, c, c)
        _check_dw(dv, b, hin, ry, w, c, dz)
        _check_product(gy, b, ry, w, c, c)
        assert gy.batched and gy.g == b and (gy.res_rows, gy.res_dr) == (hin, dz)
        _check_product(gt, b, ry, w, c, 2 * c)
        _check_dw(df, b, ry, h, w, 2 * c, dz)
        _check_product(go, b, h, w, 2 * c, c)
        assert not go.batched and (go.res_rows, go.res_dr) == (ry, dz)
        assert (dv.epi, df.epi) == ("v", "gelu") and p.gram is None
        assert sizes["f"][0] == (b, h, w, 2 * c) and sizes["y"][0] == (b, ry, w, c)
        if band:
            np.testing.assert_array_equal(gv.frame.rows_of(b, hin).numpy(),
                                          _band_rows(b, bands, h, -2, hin))
            np.testing.assert_array_equal(gt.frame.rows_of(b, ry).numpy(),
                                          _band_rows(b, bands, h, -1, ry))
    f32 = {"z", "zv", "t", "partials", "gram"}
    assert all((dt == torch.float32) == (name in f32) for name, (_, dt) in sizes.items())
    assert p.scratch_bytes() == sum(int(np.prod(s)) * (4 if dt == torch.float32 else 2)
                                    for s, dt in sizes.values())


@pytest.mark.parametrize("c", fb.WIDE_WIDTHS)
def test_wide_frame_masks_are_the_twins(c):
    """The plan's frame masks are the band twins' (``fused_block._frame_mask``)
    and the scratch of the Sony frame's banded bottleneck is what the chain
    moves: ~0.4 GB for K2 and ~0.67 GB for K3 at 512."""
    b, h, w, bands, fh = 8, 5, 7, 4, 17
    for kind in ("gram", "apply"):
        p = wb.wide_plan(kind, b, h, w, c, bands, fh)
        for g in p.gemms:
            if g.frame is not None:
                torch.testing.assert_close(
                    g.frame.mask(b, g.rows),
                    fb._frame_mask(b, g.rows, g.frame.first, h, bands, fh, None))
    k2 = wb.wide_plan("gram", 8, 23, 272, c, 8, 184).scratch_bytes()
    k3 = wb.wide_plan("apply", 8, 23, 272, c, 8, 184).scratch_bytes()
    px = 8 * 272
    assert k2 == px * (25 * c * (2 + 8) + 23 * c * 4) + 8 * 102 * 2 * c * 4 + 8 * c * c * 4
    assert k3 == px * (27 * c * 6 + 25 * c * (2 * 3 + 8) + 23 * 2 * c * 2)
    if c == 512:
        assert 0.38e9 < k2 < 0.4e9 and 0.66e9 < k3 < 0.68e9


def test_wide_plans_refuse_bad_calls():
    with pytest.raises(ValueError, match="kind"):
        wb.wide_plan("apply2", 1, 4, 4, 384)
    with pytest.raises(ValueError, match="no wide kernel"):
        wb.wide_plan("gram", 1, 4, 4, 256)
    with pytest.raises(ValueError, match="band mode"):
        wb.wide_plan("gram", 3, 4, 4, 384, bands=2, frame_h=4)
    with pytest.raises(ValueError, match="band mode"):
        wb.wide_plan("apply", 2, 4, 4, 512, bands=2, frame_h=9)
    with pytest.raises(ValueError, match="no GEMM tile"):
        wb.tile_n(320)


# ---------------------------------------------------------------------------
# The chain through its kernels' twins against the block twins (CPU)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("band", [False, True], ids=["plain", "band"])
@pytest.mark.parametrize("c", fb.WIDE_WIDTHS)
def test_wide_chain_matches_the_block_twins(c, band):
    """``gram_pass_wide`` / ``apply_pass_wide`` on CPU tensors (each kernel's
    twin, rounded where the kernel rounds) against the fp32 block twins on
    the same bf16 inputs, at phase 3's bars: the gram's cosines and the sums
    of squares within 2e-2, the block output within the bf16 bar."""
    w = port_weights(c, seed=c + band)
    g = torch.Generator().manual_seed(c + 3)
    bands, fh = (3, 8) if band else (0, 0)
    x = torch.randn(3, 3, 7, c, generator=g).bfloat16()
    xk = band_halo(x, 2, bands) if band else x
    gw = [fb.bf16(w.wqk), w.bqk, w.dwqk, w.bdwqk]
    out = wb.gram_pass_wide(xk, *gw, bands=bands, frame_h=fh)
    gram = out[:, : c * c].reshape(3, c, c)
    qs, ks = out[:, c * c: c * c + c], out[:, c * c + c:]
    want = (fb.gram_pass_banded_plain(xk.float(), w, bands, fh) if band
            else fb.gram_pass_plain(xk.float(), w))
    if band:
        gram, qs, ks = (t.sum(0, keepdim=True) for t in (gram, qs, ks))
        want = [t.sum(0, keepdim=True) for t in want]
    g0, q0, k0 = want
    cos = gram / torch.sqrt(qs[:, :, None] * ks[:, None, :])
    cos0 = g0 / torch.sqrt(q0[:, :, None] * k0[:, None, :])
    torch.testing.assert_close(cos, cos0, rtol=0, atol=2e-2)
    torch.testing.assert_close(qs, q0, rtol=2e-2, atol=0)
    torch.testing.assert_close(ks, k0, rtol=2e-2, atol=0)
    apply = fb.finalize_attention(g0, q0, k0, w.temperature, w.wproj, 8)
    if band:
        apply = apply.repeat_interleave(3, 0)
    aw = [fb.bf16(apply), fb.bf16(w.wv), w.bv, w.dwv, w.bdwv, w.bproj, fb.bf16(w.wp1), w.bp1,
          w.dwf, w.bdwf, fb.bf16(w.wp2), w.bp2]
    y = wb.apply_pass_wide(xk, *aw, bands=bands, frame_h=fh)
    y0 = (fb.apply_pass_banded_plain(xk.float(), apply, w, bands, fh) if band
          else fb.apply_pass_plain(xk.float(), apply, w))
    assert y.shape == x.shape and y.dtype == torch.bfloat16
    torch.testing.assert_close(y.float(), y0, **BF16_TOL)


def test_wide_chain_counts_no_launch_on_the_cpu():
    """On CPU tensors every wrapper of the chain runs its twin and counts
    nothing; the gram's weight-grad pass likewise."""
    w = port_weights(384, seed=5)
    before = [f.launches for f in wb.WRAPPERS] + [wgk.weight_grad.launches]
    wb.gram_pass_wide(torch.randn(1, 3, 4, 384).bfloat16(), fb.bf16(w.wqk), w.bqk, w.dwqk,
                      w.bdwqk)
    assert [f.launches for f in wb.WRAPPERS] + [wgk.weight_grad.launches] == before
