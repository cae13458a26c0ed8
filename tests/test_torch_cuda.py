"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Every test here is marked ``cuda`` and skips without a card (the kernels
have no CPU mode). The file imports nothing of JAX, so it also runs on a
machine without it:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from bayer_low_light_image_enhancement_tpu_torch.kernels import bayer_pack as bp
from bayer_low_light_image_enhancement_tpu_torch.kernels import fused_block as fb
from bayer_low_light_image_enhancement_tpu_torch.kernels import fused_block_bwd as fbb
from bayer_low_light_image_enhancement_tpu_torch.kernels import weight_grad as wg
from bayer_low_light_image_enhancement_tpu_torch.models import RawFormer, RawFormerConfig, common
from bayer_low_light_image_enhancement_tpu_torch.serving import Predictor

torch.set_num_threads(2)

pytestmark = pytest.mark.cuda

# bf16 kernel vs fp32 twin on the same bf16 input, as tests/test_fused_block.py.
BF16_TOL = dict(rtol=2.5e-2, atol=2.5e-2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def u16(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int16)).to(device).view(torch.uint16)


@pytest.mark.parametrize("shape", [(2, 16, 64), (1, 6, 20)])  # vector and scalar paths
def test_pack_kernel_matches_twin(cuda, shape):
    g = np.random.default_rng(8)
    m = g.integers(0, 65536, shape, dtype=np.uint16)  # hot pixels included
    md, rd = u16(m, cuda), torch.from_numpy(g.uniform(1, 300, shape[0]).astype(np.float32)).to(cuda)
    before = bp.bayer_pack_normalize.launches
    got = bp.bayer_pack_normalize(md, rd, torch.bfloat16, clamp01=True)
    assert bp.bayer_pack_normalize.launches == before + 1
    want = bp.bayer_pack_normalize_plain(md, rd, torch.float32, clamp01=True)
    torch.testing.assert_close(got.float(), want, rtol=0, atol=4e-3)
    got = bp.bayer_pack_normalize(md, rd, torch.float32)
    torch.testing.assert_close(got, bp.bayer_pack_normalize_plain(md, rd), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", ["ragged_width", "unaligned_view", "frame"])
def test_pack_kernel_edge_cases(cuda, case):
    """K1 at a row width with W % 8 != 0 (the element-wise path), from a view
    one element into its storage (an unaligned pointer: the element-wise
    path) and at a 2832 x 4240 frame (a 288-thread block a packed row)."""
    shape = {"ragged_width": (3, 10, 1042), "unaligned_view": (2, 6, 64),
             "frame": (1, 2832, 4240)}[case]
    g = np.random.default_rng(11)
    n = int(np.prod(shape))
    flat = u16(g.integers(0, 65536, n + 1, dtype=np.uint16), cuda)
    md = (flat[1:] if case == "unaligned_view" else flat[:n]).view(shape)
    assert (md.data_ptr() % 16 != 0) == (case == "unaligned_view")
    rd = torch.from_numpy(g.uniform(1, 300, shape[0]).astype(np.float32)).to(cuda)
    before = bp.bayer_pack_normalize.launches
    got = bp.bayer_pack_normalize(md, rd, torch.bfloat16, clamp01=True)
    got32 = bp.bayer_pack_normalize(md, rd, torch.float32)
    assert bp.bayer_pack_normalize.launches == before + 2
    want = bp.bayer_pack_normalize_plain(md, rd, torch.float32, clamp01=True)
    torch.testing.assert_close(got.float(), want, rtol=0, atol=4e-3)
    torch.testing.assert_close(got32, bp.bayer_pack_normalize_plain(md, rd), rtol=1e-5, atol=1e-5)


def test_pack_geometry_matches_the_library(cuda):
    """kernels/bayer_pack.pack_geometry is the launch the C library makes."""
    import ctypes

    from bayer_low_light_image_enhancement_tpu_torch.kernels import _build

    info = (ctypes.c_longlong * 5)()
    for shape in [(8, 512, 512), (1, 2832, 4240), (2, 6, 20), (1, 10, 2), (70000, 8, 2),
                  (1, 2, 8200)]:
        assert _build.library().blle_bayer_pack_info(*shape, info) == 0
        geo = bp.pack_geometry(*shape)
        assert tuple(info) == (geo.tx, geo.ty, geo.gx, geo.gy, bp.GROUPS_PER_THREAD), shape


@pytest.mark.parametrize("c", fb.KERNEL_WIDTHS)
def test_block_kernels_match_twins(cuda, c):
    blk = common.TransformerBlock(c, 8, 2, device=cuda)
    common.reset_parameters_(blk, torch.Generator().manual_seed(c))
    params = dict(blk.named_parameters())
    x = torch.randn(2, 19, 13, c, device=cuda).to(torch.bfloat16)  # ragged tiles
    w = fb.fold_block_params(params)
    with torch.inference_mode():
        g, qs, ks = fb.gram_pass(x, w)
        g0, qs0, ks0 = fb.gram_pass_plain(x, w)
        cos = g / torch.sqrt(qs[:, :, None] * ks[:, None, :])
        cos0 = g0 / torch.sqrt(qs0[:, :, None] * ks0[:, None, :])
        torch.testing.assert_close(cos, cos0, rtol=0, atol=2e-2)
        torch.testing.assert_close(qs, qs0, rtol=2e-2, atol=0)
        got = fb.fused_transformer_block(x, params, 8).float()
        want = fb.fused_transformer_block_plain(x, params, 8).float()
    torch.testing.assert_close(got, want, **BF16_TOL)


def check_block_pass_kernels(x, w, tol=BF16_TOL):
    """K2 (cosines, sums of squares) and K3 against their twins on x, each
    wrapper counted once per call."""
    before = (fb.gram_pass.launches, fb.apply_pass.launches)
    with torch.inference_mode():
        g, qs, ks = fb.gram_pass(x, w)
        g0, qs0, ks0 = fb.gram_pass_plain(x, w)
        apply = fb.finalize_attention(g0, qs0, ks0, w.temperature, w.wproj, 8)
        got = fb.apply_pass(x, apply, w).float()
        want = fb.apply_pass_plain(x, apply, w).float()
    torch.cuda.synchronize()
    assert (fb.gram_pass.launches, fb.apply_pass.launches) == (before[0] + 1, before[1] + 1)
    cos = g / torch.sqrt(qs[:, :, None] * ks[:, None, :])
    cos0 = g0 / torch.sqrt(qs0[:, :, None] * ks0[:, None, :])
    torch.testing.assert_close(cos, cos0, rtol=0, atol=2e-2)
    torch.testing.assert_close(qs, qs0, rtol=2e-2, atol=0)
    torch.testing.assert_close(ks, ks0, rtol=2e-2, atol=0)
    torch.testing.assert_close(got, want, **tol)


# B = 1 with H and W below one tile, a tall narrow image, and several tiles
# with ragged edges in both directions.
@pytest.mark.parametrize("hw", [(1, 3, 5), (1, 40, 7), (3, 11, 29)])
@pytest.mark.parametrize("c", fb.KERNEL_WIDTHS)
def test_block_pass_kernels_on_ragged_shapes(cuda, c, hw):
    from bayer_low_light_image_enhancement_tpu_torch.probes import floor as pf

    w = pf.block_weights(c, c + 1, cuda)
    g = torch.Generator().manual_seed(c)
    x = torch.randn(*hw, c, generator=g).to(cuda, torch.bfloat16)
    check_block_pass_kernels(x, w)


def force_block_plan(monkeypatch, regime):
    """Make every K2 / K3 launch use one CTA ("one"), three ("three") or one
    CTA per tile ("per_tile") whatever the card's residency."""
    import dataclasses

    real = fb.plan_for

    def plan(kind, b, h, w, c, device_index):
        p = real(kind, b, h, w, c, device_index)
        tiles = p.tiles if kind in ("gram", "attn_gram") else b * p.tiles
        ctas = {"one": 1, "three": min(3, tiles), "per_tile": tiles}[regime]
        return dataclasses.replace(p, ctas=ctas)

    monkeypatch.setattr(fb, "plan_for", plan)


@pytest.mark.parametrize("regime", ["one", "three", "per_tile"])
@pytest.mark.parametrize("c", [32, 48, 96, 192, 256])
def test_block_pass_kernels_under_forced_plans(cuda, monkeypatch, c, regime):
    """Each CTA walks a run of tiles (across images in K3) and carries its
    gram share over it: any grid gives the same function."""
    from bayer_low_light_image_enhancement_tpu_torch.probes import floor as pf

    force_block_plan(monkeypatch, regime)
    w = pf.block_weights(c, c + 2, cuda)
    g = torch.Generator().manual_seed(c + 2)
    x = torch.randn(2, 21, 18, c, generator=g).to(cuda, torch.bfloat16)
    check_block_pass_kernels(x, w)


@pytest.mark.parametrize("c", fb.KERNEL_WIDTHS)
def test_gram_kernel_reruns_are_bitwise_equal(cuda, c):
    """K2's partials are summed in a fixed order without atomics."""
    from bayer_low_light_image_enhancement_tpu_torch.probes import floor as pf

    w = pf.block_weights(c, c + 3, cuda)
    x = torch.randn(2, 37, 23, c, device=cuda).to(torch.bfloat16)
    with torch.inference_mode():
        first, second = fb.gram_pass(x, w), fb.gram_pass(x, w)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_block_plans_match_the_library(cuda):
    """The Python mirror of each kernel's plan (tile, threads, shared
    memory) agrees with the library's, every kernel is resident, and the
    gram workspace of the wrapper's plan equals the library's own."""
    from bayer_low_light_image_enhancement_tpu_torch.kernels import _build

    lib = _build.library()
    for kind in fb.BLOCK_KINDS:
        for c in fb.KERNEL_WIDTHS:
            cfg = fb.tile_config(kind, c)
            th, tw, threads, smem, per_sm = fb.kernel_info(kind, c)
            assert (th, tw, threads, smem) == (cfg.th, cfg.tw, cfg.threads, cfg.smem), (kind, c)
            assert per_sm >= 1, (kind, c)
    for b, h, w, c in [(8, 256, 256, 32), (8, 32, 32, 256), (1, 177, 265, 256),
                       (1, 1416, 2120, 32), (2, 19, 13, 48), (1, 3, 5, 192)]:
        plan = fb.plan_for("gram", b, h, w, c, 0)
        assert fb.gram_workspace_floats(b, h, w, c, plan) == \
            lib.blle_gram_workspace_floats(b, h, w, c)


def test_block_kernels_refuse_grad_and_unsupported_widths(cuda):
    """The pass wrappers are not differentiable (training goes through
    FusedTransformerBlockFn); widths without a kernel raise."""
    blk = common.TransformerBlock(32, 8, 2, device=cuda)
    x = torch.randn(1, 8, 8, 32, device=cuda).to(torch.bfloat16)
    with pytest.raises(RuntimeError, match="not differentiable"):
        fb.gram_pass(x, fb.fold_block_params(dict(blk.named_parameters())))
    blk16 = common.TransformerBlock(16, 8, 2, device=cuda)
    with torch.inference_mode(), pytest.raises(ValueError, match="no kernel"):
        fb.fused_transformer_block(x[..., :16].contiguous(), dict(blk16.named_parameters()), 8)


def yardstick_errors(kernel, fp32, bf16):
    """Per-leaf max error of the kernel and of the bf16 twin, both relative to
    the fp32 twin's leaf max (the method of tests/test_fused_bwd.py)."""
    out = {}
    for name, ref in fp32.items():
        s = ref.float().abs().max().item() + 1e-8
        out[name] = ((kernel[name].float() - ref.float()).abs().max().item() / s,
                     (bf16[name].float() - ref.float()).abs().max().item() / s)
    return out


def backward_leaves(x, dy, wts, heads, run):
    """dx2, d_apply, dx and every folded-weight grad of B1 -> finalize ->
    B2, with ``run(pass, *args)`` choosing kernel or twin for each pass."""
    gram, qss, kss = fb.gram_pass_plain(x, wts)
    apply = fb.finalize_attention(gram, qss, kss, wts.temperature, wts.wproj, heads)
    dx2, d_apply, g1 = run(1, x, dy, apply, wts)
    dgr, dqs, dks, _, _ = fbb.finalize_backward(gram, qss, kss, wts.temperature, wts.wproj,
                                                d_apply, heads)
    dx, g2 = run(2, x, dx2.to(torch.bfloat16), apply, dgr, dqs, dks, wts)
    return {"dx2": dx2, "d_apply": d_apply, "dx": dx, **g1, **g2}


def kernel_run(k, *args):
    return (fbb.bwd1 if k == 1 else fbb.bwd2)(*args)


def twin_run(k, *args):
    return (fbb.bwd1_plain if k == 1 else fbb.bwd2_plain)(*args)


def bf16_twin_run(k, *args):
    with torch.autocast("cuda", torch.bfloat16):
        return twin_run(k, *args)


def backward_case(shape, seed, device):
    """Folded weights of a width-C TransformerBlock (non-trivial LN affines
    and temperatures), bf16 x and dy of ``shape`` on ``device``."""
    c = shape[-1]
    gen = torch.Generator().manual_seed(seed)
    blk = common.TransformerBlock(c, 8, 2, device=device)
    common.reset_parameters_(blk, gen)
    with torch.no_grad():
        for name, p in blk.named_parameters():
            if "norm" in name or "temperature" in name:
                p.add_(torch.empty(p.shape).uniform_(-0.3, 0.3, generator=gen).to(device))
    wts = fb.fold_block_params({k: v.detach() for k, v in blk.named_parameters()})
    x = torch.randn(shape, generator=gen).to(device, torch.bfloat16)
    dy = (0.1 * torch.randn(shape, generator=gen)).to(device, torch.bfloat16)
    return x, dy, wts


def check_backward_against_twins(x, dy, wts):
    """B1 and B2 launch once each (and the weight-grad pass once for each in
    the split regime); each leaf within max(3 x the bf16 twin's error, 2e-2)
    of the fp32 twin."""
    split = fbb.weight_grad_regime(x.shape[-1]) == "split"
    before = (fbb.bwd1.launches, fbb.bwd2.launches, wg.weight_grad.launches)
    got = backward_leaves(x, dy, wts, 8, kernel_run)
    assert (fbb.bwd1.launches, fbb.bwd2.launches, wg.weight_grad.launches) == (
        before[0] + 1, before[1] + 1, before[2] + 2 * split)
    errs = yardstick_errors(got, backward_leaves(x, dy, wts, 8, twin_run),
                            backward_leaves(x, dy, wts, 8, bf16_twin_run))
    bad = {n: e for n, e in errs.items() if not e[0] <= max(3 * e[1], 2e-2)}
    assert not bad, bad


@pytest.mark.parametrize("c", fb.KERNEL_WIDTHS)
def test_backward_kernels_match_twins(cuda, c):
    """B1 and B2 against their fp32 twins on ragged tiles, each leaf within
    max(3 x the bf16 twin's error, 2e-2) of the fp32 twin."""
    x, dy, wts = backward_case((2, 19, 13, c), c + 1, cuda)
    check_backward_against_twins(x, dy, wts)


# Fewer tiles than blocks (one 8x8 image at C = 256: 4 tiles of 4x4); many
# tiles per block with ragged edges (C = 32: 8x16 tiles; C = 128: 4x8).
@pytest.mark.parametrize("shape", [(1, 8, 8, 256), (4, 72, 40, 32), (4, 202, 168, 32),
                                   (2, 66, 70, 128)])
def test_backward_kernels_edge_shapes(cuda, shape):
    x, dy, wts = backward_case(shape, shape[1], cuda)
    check_backward_against_twins(x, dy, wts)


@pytest.mark.parametrize("c", fb.KERNEL_WIDTHS)
def test_backward_kernels_are_deterministic(cuda, c):
    """Two launches on the same inputs give bitwise-equal dx2, d_apply, dx
    and weight grads (fixed-order sums, no atomics)."""
    x, dy, wts = backward_case((2, 37, 29, c), c, cuda)
    gram, qss, kss = fb.gram_pass_plain(x, wts)
    apply = fb.finalize_attention(gram, qss, kss, wts.temperature, wts.wproj, 8)
    first, second = (fbb.bwd1(x, dy, apply, wts) for _ in "12")
    d = fbb.finalize_backward(gram, qss, kss, wts.temperature, wts.wproj, first[1], 8)
    dx2 = first[0].to(torch.bfloat16)
    third, fourth = (fbb.bwd2(x, dx2, apply, *d[:3], wts) for _ in "12")
    for a, b in ((first, second), (third, fourth)):
        for u, v in zip(a[:-1], b[:-1]):
            assert torch.equal(u, v)
        assert a[-1].keys() == b[-1].keys()
        for name in a[-1]:
            assert torch.equal(a[-1][name], b[-1][name]), name


@pytest.mark.parametrize("shapes", [[(2, 1000, 96, 96), (1, 2000, 96, 192), (1, 2000, 192, 96)],
                                    [(1, 4099, 256, 768)], [(1, 5, 8, 16)],
                                    [(3, 777, 40, 200), (1, 130, 8, 8)]])
def test_weight_grad_kernel_matches_twin(cuda, shapes):
    """The weight-grad pass (one launch for all products; ragged K, M and N
    of 96, off the 64-channel grid) against its fp32 twin: bf16 products
    are exact in fp32, so only the order of the sums differs."""
    pairs = weight_grad_pairs(shapes, cuda, seed=len(shapes))
    before = wg.weight_grad.launches
    got = wg.weight_grad(pairs)
    assert wg.weight_grad.launches == before + 1
    for o, r in zip(got, wg.weight_grad_plain(pairs)):
        torch.testing.assert_close(o, r, rtol=1e-5, atol=1e-3)


def weight_grad_pairs(shapes, device, seed, scale=1.0):
    gen = torch.Generator().manual_seed(seed)
    return [(torch.randn(g, k, m, generator=gen).mul_(scale).to(device, torch.bfloat16),
             torch.randn(g, k, n, generator=gen).mul_(scale).to(device, torch.bfloat16))
            for g, k, m, n in shapes]


def assert_products_close(got, pairs):
    """Each product within 1e-4 of its twin's largest value: fp32 sums over
    up to 65536 pixels in two orders (chip_smoke.py's WG_TOL)."""
    for o, r in zip(got, wg.weight_grad_plain(pairs)):
        err = (o - r).abs().max().item()
        assert err <= 1e-4 * r.abs().max().item(), (tuple(r.shape), err)


# The launches of the training path: B1's three products and B2's one at the
# RawFormer-S widths of 128 and 256, batch 8 and 16 @ 512^2.
MAIN_PATH_PRODUCTS = [
    [(8, 4096, 128, 128), (1, 32768, 128, 256), (1, 32768, 256, 128)],
    [(1, 32768, 128, 384)],
    [(8, 1024, 256, 256), (1, 8192, 256, 512), (1, 8192, 512, 256)],
    [(1, 8192, 256, 768)],
    [(16, 4096, 128, 128), (1, 65536, 128, 256), (1, 65536, 256, 128)],
    [(1, 16384, 256, 768)],
]


@pytest.mark.parametrize("shapes", MAIN_PATH_PRODUCTS + [
    [(1, 300, 96, 96), (2, 500, 192, 96), (1, 129, 8, 768), (1, 64, 384, 8)]])
def test_weight_grad_kernel_on_the_launches_b1_b2_make(cuda, shapes):
    """The 1-, 3- and 4-product launches at full size, G > 1 included."""
    pairs = weight_grad_pairs(shapes, cuda, seed=sum(s[1] for s in shapes))
    assert_products_close(wg.weight_grad(pairs), pairs)


def forced_plan(regime):
    """A plan of `regime` in place of wg.plan_for: every tile in one slice
    ("one_slice"), in one cluster of up to 8 ("one_cluster"), or in
    clusters of 2 with up to 16 slices ("many_clusters")."""

    def plan_for(shapes):
        stages = min(-(-k // wg.K_STEP) for _, k, _, _ in shapes)
        if regime == "one_slice":
            cl, slices = 1, [1] * len(shapes)
        elif regime == "one_cluster":
            cl = max(c for c in wg.CLUSTERS if c <= stages)
            slices = [cl] * len(shapes)
        else:
            cl = 2 if stages >= 2 else 1
            slices = [max(cl, min(16, -(-k // wg.K_STEP)) // cl * cl) for _, k, _, _ in shapes]
        return wg.layout(shapes, wg.tile_n(shapes), cl, slices)

    return plan_for


@pytest.mark.parametrize("regime", ["one_slice", "one_cluster", "many_clusters"])
@pytest.mark.parametrize("shapes", [[(2, 1000, 96, 96), (1, 2000, 96, 192), (1, 2000, 192, 96)],
                                    [(1, 4099, 256, 768)], [(3, 777, 40, 200)]])
def test_weight_grad_kernel_under_forced_plans(cuda, monkeypatch, regime, shapes):
    """Any split of K over slices and clusters gives the same function."""
    monkeypatch.setattr(wg, "plan_for", forced_plan(regime))
    pairs = weight_grad_pairs(shapes, cuda, seed=7)
    assert_products_close(wg.weight_grad(pairs), pairs)


@pytest.mark.parametrize("shapes", MAIN_PATH_PRODUCTS[:2] + [[(3, 777, 40, 200)]])
def test_weight_grad_reruns_are_bitwise_equal(cuda, shapes):
    """Fixed-order sums on chip and across clusters, no atomics."""
    pairs = weight_grad_pairs(shapes, cuda, seed=11)
    first, second = wg.weight_grad(pairs), wg.weight_grad(pairs)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("tn", wg.TILE_NS)
def test_weight_grad_plan_matches_the_library(cuda, tn):
    """The Python mirror against blle_weight_grad_info (shared memory,
    threads, ring stages; a wave of clusters that shrinks as clusters grow)
    and blle_weight_grad_workspace_floats on the main path's plans."""
    import ctypes

    from bayer_low_light_image_enhancement_tpu_torch.kernels import _build

    infos = {cl: wg.kernel_info(tn, cl) for cl in wg.CLUSTERS}
    for cl, (smem, threads, stages, clusters) in infos.items():
        assert (smem, threads, stages) == (wg.smem_bytes(tn), wg.THREADS, wg.STAGES)
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        assert 1 <= clusters * cl <= sms * (fb.SMEM_PER_SM // smem), (cl, clusters)
    assert infos[1][3] >= infos[2][3] >= infos[4][3] >= infos[8][3]
    for shapes in MAIN_PATH_PRODUCTS:
        p = wg.plan_for(tuple(shapes))
        rows = [v for (g, k, m, n), sp in zip(shapes, p.splits) for v in (g, k, m, n, sp.slices)]
        got = _build.library().blle_weight_grad_workspace_floats(
            (ctypes.c_longlong * len(rows))(*rows), len(shapes), p.cluster)
        assert got == p.ws_floats


def scan_inputs(b, L, d, n, dtype, seed):
    g = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(g.standard_normal(s).astype(np.float32))  # noqa: E731
    u, B, C = 0.5 * f(b, L, d), 0.5 * f(b, L, n), 0.5 * f(b, L, n)
    dt = torch.from_numpy(g.uniform(0.02, 0.6, (b, L, d)).astype(np.float32))
    A = -torch.from_numpy(g.uniform(0.2, 2.0, (d, n)).astype(np.float32))
    D, dy = 0.3 * f(d), f(b, L, d)
    return [t.to(dtype) for t in (u, dt)] + [A] + [t.to(dtype) for t in (B, C)] + [D, dy.to(dtype)]


# Ragged shapes: L not a multiple of the 128-step chunk or the 32-step
# sub-chunk, D not a multiple of the 4-warp block, N below 32; the forced
# d-groups (channels per block) make a warp walk several channels and leave
# some warps without one.
SCAN_CASES = [((2, 300, 20, 32), None), ((1, 77, 13, 8), None), ((3, 1000, 40, 32), 16),
              ((2, 515, 96, 32), 96)]


def force_dgroup(monkeypatch, ks, dgroup):
    """Make S2's plan take ``dgroup`` channels per block (a multiple of
    BWD_WARPS), whatever the card's occupancy."""
    def plan(bsz, L, d, resident):
        per_warp = dgroup // ks.BWD_WARPS
        groups = -(-d // dgroup)
        return ks.BwdPlan(ks.BWD_CHUNK, dgroup, per_warp, groups,
                          bsz * -(-L // ks.BWD_CHUNK) * groups)
    monkeypatch.setattr(ks, "bwd_plan", plan)


def check_scan_backward(ks, ssm, args, dy, states):
    """S2 launches once and each leaf is within 1e-3 of the twin's leaf max
    (fp32 sums in another order); returns S2's grads."""
    before = ks.selective_scan_bwd.launches
    grads = ks.selective_scan_bwd(*args, dy, states)
    torch.cuda.synchronize()
    assert ks.selective_scan_bwd.launches == before + 1
    want = ssm.selective_scan_bwd_ref(*args, dy)
    for name, got, ref in zip(("du", "ddt", "dA", "dB", "dC", "dD"), grads, want):
        assert got.dtype == torch.float32 and got.shape == ref.shape, name
        err = (got - ref).abs().max().item() / ref.abs().max().item()
        assert err <= 1e-3, (name, err)
    return grads


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,dgroup", SCAN_CASES)
def test_scan_kernels_match_twins(cuda, monkeypatch, shape, dgroup, dtype):
    """S1 (with and without states) against the chunked twin, S2 against the
    explicit backward twin on the same (rounded) inputs. fp32: y and states
    within 1e-4 of their max; bf16: y within its output rounding
    (8e-3 |ref| + 1e-3 max|ref|). S2: each leaf within 1e-3 of its max (fp32
    sums in another order)."""
    from bayer_low_light_image_enhancement_tpu_torch.kernels import ssm_scan as ks
    from bayer_low_light_image_enhancement_tpu_torch.ops import ssm

    if dgroup is not None:
        force_dgroup(monkeypatch, ks, dgroup)
    *args, dy = [t.to(cuda) for t in scan_inputs(*shape, dtype, seed=sum(shape))]
    before = ks.selective_scan_fwd.launches
    y = ks.selective_scan_fwd(*args)
    y2, states = ks.selective_scan_fwd(*args, save_states=True)
    torch.cuda.synchronize()
    assert ks.selective_scan_fwd.launches == before + 2
    assert torch.equal(y, y2) and y.dtype == dtype
    y_ref, st_ref = ssm.selective_scan(*args, chunk_size=ks.TWIN_CHUNK, state_every=ks.STATE_EVERY)
    y_ref = ssm.selective_scan(*[t.float() for t in args])
    scale = y_ref.abs().max().item()
    if dtype == torch.float32:
        assert (y - y_ref).abs().max().item() <= 1e-4 * scale
    else:
        assert bool(((y.float() - y_ref).abs() <= 8e-3 * y_ref.abs() + 1e-3 * scale).all())
    assert (states - st_ref).abs().max().item() <= 1e-4 * st_ref.abs().max().item()
    check_scan_backward(ks, ssm, args, dy, states)


# S2's own cases: a warp walks an odd number of channels (3 of the first
# group's 12) and the ragged second group (1 channel) leaves three warps
# without one; one channel per warp; a b = 24 training shape of WFB-48
# (stage 4 at batch 8 @ 512^2) under the card's own plan.
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,dgroup", [((1, 333, 13, 32), 12), ((2, 160, 9, 32), 4),
                                          ((24, 256, 768, 32), None)])
def test_scan_backward_matches_twin(cuda, monkeypatch, shape, dgroup, dtype):
    from bayer_low_light_image_enhancement_tpu_torch.kernels import ssm_scan as ks
    from bayer_low_light_image_enhancement_tpu_torch.ops import ssm

    if dgroup is not None:
        force_dgroup(monkeypatch, ks, dgroup)
    *args, dy = [t.to(cuda) for t in scan_inputs(*shape, dtype, seed=sum(shape) + 1)]
    _, states = ks.selective_scan_fwd(*args, save_states=True)
    check_scan_backward(ks, ssm, args, dy, states)


@pytest.mark.parametrize("shape", [(3, 1000, 40, 32), (2, 4096, 192, 32)])
def test_scan_backward_is_deterministic(cuda, shape):
    """Two S2 launches on the same inputs give bitwise-equal grads
    (fixed-order sums, no atomics); with several d-groups at the first
    shape, one at the second."""
    from bayer_low_light_image_enhancement_tpu_torch.kernels import ssm_scan as ks

    *args, dy = [t.to(cuda) for t in scan_inputs(*shape, torch.bfloat16, seed=3)]
    _, states = ks.selective_scan_fwd(*args, save_states=True)
    first, second = (ks.selective_scan_bwd(*args, dy, states) for _ in "12")
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def force_fwd_chunks(monkeypatch, ks, chunks):
    """Make S1's plan cut L into ``chunks`` chunks (of a multiple of
    STATE_EVERY steps; None: as many as there are sub-chunks), whatever the
    card's occupancy."""
    def plan(bsz, L, d, resident):
        want = -(-L // ks.STATE_EVERY) if chunks is None else chunks
        chunk = -(-(-(-L // want)) // ks.STATE_EVERY) * ks.STATE_EVERY
        return ks.FwdPlan(chunk, -(-L // chunk))
    monkeypatch.setattr(ks, "fwd_plan", plan)


# S1's own cases: ragged L (77, 333, 1000) and L < 32, N < 32 (8, 13), D
# not a multiple of the 32-channel tile (13, 20, 44), under each plan regime:
# one chunk (one launch), two chunks, and one chunk per 32-step sub-chunk.
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("chunks", [1, 2, None])
@pytest.mark.parametrize("shape", [(2, 333, 20, 8), (1, 77, 13, 13), (3, 1000, 44, 32),
                                   (2, 20, 24, 32)])
def test_scan_forward_plans_match_twin(cuda, monkeypatch, shape, chunks, dtype):
    """y within 1e-4 of its max (fp32) or its output rounding (bf16) and the
    states within 1e-4 of their max, y identical with and without states,
    bitwise-equal reruns, and S2 on these states within 1e-3 of each leaf's
    max."""
    from bayer_low_light_image_enhancement_tpu_torch.kernels import ssm_scan as ks
    from bayer_low_light_image_enhancement_tpu_torch.ops import ssm

    force_fwd_chunks(monkeypatch, ks, chunks)
    *args, dy = [t.to(cuda) for t in scan_inputs(*shape, dtype, seed=sum(shape) + 7)]
    before = ks.selective_scan_fwd.launches
    y = ks.selective_scan_fwd(*args)
    y2, states = ks.selective_scan_fwd(*args, save_states=True)
    y3, states3 = ks.selective_scan_fwd(*args, save_states=True)
    torch.cuda.synchronize()
    assert ks.selective_scan_fwd.launches == before + 3
    assert torch.equal(y, y2) and torch.equal(y2, y3) and torch.equal(states, states3)
    y_ref, st_ref = ssm.selective_scan(*args, chunk_size=ks.TWIN_CHUNK,
                                       state_every=ks.STATE_EVERY)
    y_ref = ssm.selective_scan(*[t.float() for t in args])
    scale = y_ref.abs().max().item()
    if dtype == torch.float32:
        assert (y - y_ref).abs().max().item() <= 1e-4 * scale
    else:
        assert bool(((y.float() - y_ref).abs() <= 8e-3 * y_ref.abs() + 1e-3 * scale).all())
    assert states.shape == st_ref.shape
    assert (states - st_ref).abs().max().item() <= 1e-4 * st_ref.abs().max().item()
    check_scan_backward(ks, ssm, args, dy, states)


def test_scan_forward_plan_matches_the_library(cuda):
    """S1 is resident at both input types, and the card's plan at the
    WFB-48 scan shapes keeps one chunk where the walks fill the card."""
    from bayer_low_light_image_enhancement_tpu_torch.kernels import _build
    from bayer_low_light_image_enhancement_tpu_torch.kernels import ssm_scan as ks

    lib = _build.library()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for bf16 in (0, 1):
        assert lib.blle_ssm_fwd_blocks_per_sm(bf16) >= 1
        resident = ks.fwd_resident(torch.cuda.current_device(), bool(bf16))
        assert resident >= sms * ks.FWD_WARPS
        for bsz, L, d in [(24, 16384, 96), (6, 16384, 96), (6, 256, 768), (1, 77, 13)]:
            plan = ks.fwd_plan(bsz, L, d, resident)
            assert plan.chunk % ks.STATE_EVERY == 0 and plan.chunks == -(-L // plan.chunk)
            if ks.FWD_ONE_CHUNK * -(-bsz * d // ks.FWD_STATES_PER_LANE) >= resident:
                assert plan.chunks == 1 and plan.launches == 1
            else:
                assert plan.chunks != 2 or L <= 2 * ks.STATE_EVERY


def test_scan_backward_plan_and_workspace_match_the_library(cuda):
    """The wrapper's workspace size agrees with the C layout, and the plan's
    groups fit the kernel's shared memory at every training shape."""
    from bayer_low_light_image_enhancement_tpu_torch.kernels import _build
    from bayer_low_light_image_enhancement_tpu_torch.kernels import ssm_scan as ks

    lib = _build.library()
    resident = ks.bwd_resident(torch.cuda.current_device(), True)
    assert resident >= torch.cuda.get_device_properties(0).multi_processor_count
    for bsz, L, d in [(24, 16384, 96), (24, 4096, 192), (24, 1024, 384), (24, 256, 768),
                      (6, 16384, 96), (1, 77, 13), (3, 1000, 40)]:
        for n in (8, 32):
            plan = ks.bwd_plan(bsz, L, d, resident)
            assert lib.blle_ssm_bwd_blocks_per_sm(plan.dgroup, 1) >= 1
            assert ks.bwd_workspace_floats(bsz, L, d, n, plan) == \
                lib.blle_ssm_bwd_workspace_floats(bsz, L, d, n, plan.chunk, plan.dgroup)


def test_raw_u16_serving_matches_cpu_twin_path(cuda):
    """RawFormer-S on the card (kernels, bf16) against the same weights on
    the CPU (twins, fp32), through Predictor.raw_u16 on a ragged frame."""
    gen = torch.Generator().manual_seed(3)
    gpu = RawFormer(RawFormerConfig.from_size("S", dtype=torch.bfloat16), device=cuda, generator=gen)
    cpu = RawFormer(RawFormerConfig.from_size("S"))
    cpu.load_state_dict(gpu.state_dict())
    m = np.random.default_rng(9).integers(0, 17000, (2, 70, 90), dtype=np.uint16)
    before = (fb.gram_pass.launches, fb.apply_pass.launches)
    got = Predictor(gpu).raw_u16(m, [60.0, 200.0])
    assert (fb.gram_pass.launches, fb.apply_pass.launches) == (before[0] + 7, before[1] + 7)
    want = Predictor(cpu, device="cpu").raw_u16(m, [60.0, 200.0])
    assert got.shape == (2, 70, 90, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-2)


def held_grads(kern, twin, nudged, bf16, floor=2e-2):
    """Per-leaf first-step grad error of the kernel path, relative to the
    twin path's leaf max, against its yardsticks: the twin path's own change
    when its input is nudged by half a bf16 ulp, and the error of the twin
    path under autocast(bfloat16) (the rounding the kernels add inside the
    blocks). -> (errors, leaves outside max(3 x either yardstick, floor))."""
    rel = lambda g, ref: ((g - ref).abs().max() / (ref.abs().max() + 1e-12)).item()  # noqa: E731
    err = {n: rel(kern[n], g) for n, g in twin.items()}
    yard = {n: max(rel(nudged[n], g), rel(bf16[n], g)) for n, g in twin.items()}
    return err, [n for n in err if err[n] > max(3 * yard[n], floor)]


def test_train_step_kernel_path_matches_twin_path(cuda, monkeypatch):
    """A bf16 train step of a dim-32 RawFormer through K2/K3 + B1/B2 against
    the same step with the blocks on their fp32 twins: loss within 2e-2
    relative; the first-step grad of every parameter within max(3 x the twin
    path's change under a half-ulp input nudge, 3 x the twin path's error
    under autocast(bfloat16), 2e-2) of the twin's leaf max, the median
    within 2e-2. The params after the second step (the first at
    a nonzero lr: step 1 runs at the warmup's lr 0) are within 5e-4: Adam
    moves each by about lr = 1e-4 whatever its grad, so that bound is a
    ceiling Adam's step size sets, not a test of the grads."""
    from bayer_low_light_image_enhancement_tpu_torch.train import TrainConfig, Trainer

    g = np.random.default_rng(4)
    batch = (torch.from_numpy(g.uniform(0, 2, (2, 64, 64, 1)).astype(np.float32)).to(cuda),
             torch.from_numpy(g.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)).to(cuda))
    nudged = (batch[0] * (1.0 + 2.0 ** -9), batch[1])
    cfg = TrainConfig(warmup_epochs=1, steps_per_epoch=1)
    runs = []
    for twin, inputs, bf16 in ((False, batch, False), (True, batch, False),
                               (True, nudged, False), (True, batch, True)):
        if twin:
            monkeypatch.setattr(common, "fused_transformer_block", fb.fused_transformer_block_plain)
        model = RawFormer(RawFormerConfig(dim=32, dtype=torch.bfloat16), device=cuda,
                          generator=torch.Generator().manual_seed(0))
        trainer = Trainer(model, cfg)
        before = [f.launches for f in (fb.gram_pass, fb.apply_pass, fbb.bwd1, fbb.bwd2)]
        with torch.autocast("cuda", torch.bfloat16, enabled=bf16):
            losses = [float(trainer.train_step(inputs))]
            grads = {n: p.grad.float().clone() for n, p in model.named_parameters()}
            losses.append(float(trainer.train_step(inputs)))
        launched = [f.launches - b for f, b in
                    zip((fb.gram_pass, fb.apply_pass, fbb.bwd1, fbb.bwd2), before)]
        assert launched == ([0] * 4 if twin else [14] * 4)
        runs.append((losses, grads, torch.cat([p.detach().flatten() for p in model.parameters()])))
    (lk, gk, pk), (lt, gt, pt), (_, gn, _), (_, g16, _) = runs
    np.testing.assert_allclose(lk, lt, rtol=2e-2)
    err, bad = held_grads(gk, gt, gn, g16)
    assert not bad, {n: err[n] for n in bad}
    assert float(np.median(list(err.values()))) <= 2e-2
    torch.testing.assert_close(pk, pt, rtol=0, atol=5e-4)


def test_wfb_serving_matches_cpu_twin_path(cuda):
    """RawFormer-WFB (dim 8) on the card (S1, bf16) against the same weights
    on the CPU (scan twin, fp32), through Predictor(pad_to=32) on a ragged
    frame; S1 runs 7 times per forward, S2 never."""
    from bayer_low_light_image_enhancement_tpu_torch.kernels import ssm_scan as ks
    from bayer_low_light_image_enhancement_tpu_torch.models import RawFormerWFB, RawFormerWFBConfig

    gen = torch.Generator().manual_seed(5)
    gpu = RawFormerWFB(RawFormerWFBConfig(dim=8, dtype=torch.bfloat16), device=cuda, generator=gen)
    cpu = RawFormerWFB(RawFormerWFBConfig(dim=8))
    cpu.load_state_dict(gpu.state_dict())
    x = np.random.default_rng(6).uniform(0, 2, (2, 70, 90, 1)).astype(np.float32)
    before = (ks.selective_scan_fwd.launches, ks.selective_scan_bwd.launches)
    got = Predictor(gpu, pad_to=32)(x)
    assert (ks.selective_scan_fwd.launches, ks.selective_scan_bwd.launches) == (
        before[0] + 7, before[1])
    want = Predictor(cpu, device="cpu", pad_to=32)(x)
    assert got.shape == (2, 70, 90, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-2)


def test_wfb_train_step_kernel_path_matches_twin_path(cuda):
    """Two bf16 train steps (the first at the warmup's lr 0) of a dim-16
    RawFormer-WFB through S1 with states + S2 against the same steps with
    the scan on its twin (fused_blocks=False): S1 and S2 run 7 times per
    step; loss within 2e-2 relative; the first-step grad of every parameter
    outside the FEB frequency islands within max(3 x the twin path's own
    change when its input is nudged by half a bf16 ulp, 2e-2) of the twin's
    leaf max, the median over all leaves within 2e-2 (chip_smoke.py's WFB
    rule: the FEB leaves are printed, not held per leaf, since their phase,
    an atan2 with a branch cut, turns rounding-level input changes into
    large grad changes); params within 5e-4 (Adam moves each by about lr
    whatever its grad: a ceiling, not a test of the grads), BN running stats
    within 1e-2 of their max."""
    from bayer_low_light_image_enhancement_tpu_torch.kernels import ssm_scan as ks
    from bayer_low_light_image_enhancement_tpu_torch.models import RawFormerWFB, RawFormerWFBConfig
    from bayer_low_light_image_enhancement_tpu_torch.train import TrainConfig, Trainer

    g = np.random.default_rng(7)
    batch = (torch.from_numpy(g.uniform(0, 2, (2, 64, 64, 1)).astype(np.float32)).to(cuda),
             torch.from_numpy(g.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)).to(cuda))
    nudged = (batch[0] * (1.0 + 2.0 ** -9), batch[1])
    runs = []
    for fused, inputs in ((True, batch), (False, batch), (False, nudged)):
        model = RawFormerWFB(RawFormerWFBConfig(dim=16, dtype=torch.bfloat16), device=cuda,
                             generator=torch.Generator().manual_seed(0))
        trainer = Trainer(model, TrainConfig(warmup_epochs=1, steps_per_epoch=1,
                                             fused_blocks=fused))
        before = (ks.selective_scan_fwd.launches, ks.selective_scan_bwd.launches)
        losses = [float(trainer.train_step(inputs))]
        grads = {n: p.grad.float().clone() for n, p in model.named_parameters()
                 if p.grad is not None}
        losses.append(float(trainer.train_step(inputs)))
        launched = (ks.selective_scan_fwd.launches - before[0],
                    ks.selective_scan_bwd.launches - before[1])
        assert launched == ((14, 14) if fused else (0, 0))
        runs.append((losses, grads, model.state_dict()))
    (lk, gk, sk), (lt, gt, st), (_, gn, _) = runs
    np.testing.assert_allclose(lk, lt, rtol=2e-2)
    assert gk.keys() == gt.keys() == gn.keys() and gt
    rel = lambda a, ref: ((a - ref).abs().max() / (ref.abs().max() + 1e-12)).item()  # noqa: E731
    err = {n: rel(gk[n], ref) for n, ref in gt.items()}
    yard = {n: rel(gn[n], ref) for n, ref in gt.items()}
    held = [n for n in err if "frequency_process" not in n]
    feb = [n for n in err if n not in held]
    assert held
    if feb:
        worst = max(feb, key=err.get)
        print(f"FEB leaves (not held): worst {worst} {err[worst]:.3e} of the twin's leaf max "
              f"(nudged twin {yard[worst]:.3e})")
    bad = {n: (err[n], yard[n]) for n in held if err[n] > max(3 * yard[n], 2e-2)}
    assert not bad, bad
    assert float(np.median(list(err.values()))) <= 2e-2
    for name, v in sk.items():
        if name.endswith("num_batches_tracked"):
            assert torch.equal(v, st[name])
        elif "running" in name:
            assert (v - st[name]).abs().max() <= 1e-2 * st[name].abs().max(), name
        else:
            torch.testing.assert_close(v, st[name], rtol=0, atol=5e-4, msg=name)


def folded_block(c, seed, device):
    """A dim-c block's params (non-trivial LN affines and temperatures) and
    their folded weights."""
    gen = torch.Generator().manual_seed(seed)
    blk = common.TransformerBlock(c, 8, 2, device=device)
    common.reset_parameters_(blk, gen)
    with torch.no_grad():
        for name, p in blk.named_parameters():
            if "norm" in name or "temperature" in name:
                p.add_(torch.empty(p.shape).uniform_(-0.3, 0.3, generator=gen).to(device))
    params = {k: v.detach() for k, v in blk.named_parameters()}
    return params, fb.fold_block_params(params)


@pytest.mark.parametrize("c", fb.PIPELINED_WIDTHS)
def test_pipelined_apply_kernel_matches_twin(cuda, c):
    """K3P against the apply pass's twin (and beside K3) on ragged tiles; one
    launch per call."""
    params, w = folded_block(c, c + 11, cuda)
    x = torch.randn(3, 21, 14, c, generator=torch.Generator().manual_seed(c)).to(cuda, torch.bfloat16)
    with torch.inference_mode():
        apply = fb.finalize_attention(*fb.gram_pass_plain(x, w), w.temperature, w.wproj, 8)
        before = fb.apply_pass_pipelined.launches
        got = fb.apply_pass_pipelined(x, apply, w)
        torch.cuda.synchronize()
        assert fb.apply_pass_pipelined.launches == before + 1
        want = fb.apply_pass_plain(x, apply, w)
        tiled = fb.apply_pass(x, apply, w)
    torch.testing.assert_close(got.float(), want.float(), **BF16_TOL)
    torch.testing.assert_close(got.float(), tiled.float(), **BF16_TOL)


def check_pipelined_kernel(x, params_seed, cuda):
    """K3P against the apply pass's twin on x, one launch per call; returns
    its output."""
    c = x.shape[-1]
    _, w = folded_block(c, params_seed, cuda)
    with torch.inference_mode():
        apply = fb.finalize_attention(*fb.gram_pass_plain(x, w), w.temperature, w.wproj, 8)
        before = fb.apply_pass_pipelined.launches
        got = fb.apply_pass_pipelined(x, apply, w)
        torch.cuda.synchronize()
        assert fb.apply_pass_pipelined.launches == before + 1
        want = fb.apply_pass_plain(x, apply, w)
    torch.testing.assert_close(got.float(), want.float(), **BF16_TOL)
    return got


# B = 1 below one tile, a tall narrow image, ragged tiles in both directions
# across several images.
@pytest.mark.parametrize("hw", [(1, 3, 5), (1, 40, 7), (3, 11, 29)])
@pytest.mark.parametrize("c", fb.PIPELINED_WIDTHS)
def test_pipelined_kernel_on_ragged_shapes(cuda, c, hw):
    x = torch.randn(*hw, c, generator=torch.Generator().manual_seed(c + 3)).to(cuda, torch.bfloat16)
    check_pipelined_kernel(x, c + 5, cuda)


@pytest.mark.parametrize("regime", ["one", "three", "per_tile"])
@pytest.mark.parametrize("c", fb.PIPELINED_WIDTHS)
def test_pipelined_kernel_under_forced_plans(cuda, monkeypatch, c, regime):
    """One CTA walks every tile (across images and the y ring's wrap), three
    CTAs, one CTA a tile: any grid gives the same function."""
    force_block_plan(monkeypatch, regime)
    x = torch.randn(2, 21, 18, c, generator=torch.Generator().manual_seed(c + 4)).to(
        cuda, torch.bfloat16)
    check_pipelined_kernel(x, c + 6, cuda)


@pytest.mark.parametrize("c", fb.PIPELINED_WIDTHS)
def test_pipelined_kernel_reruns_are_bitwise_equal(cuda, c):
    x = torch.randn(2, 19, 23, c, generator=torch.Generator().manual_seed(c + 7)).to(
        cuda, torch.bfloat16)
    assert torch.equal(check_pipelined_kernel(x, c + 8, cuda), check_pipelined_kernel(x, c + 8, cuda))


def test_pipelined_plan_matches_the_library(cuda):
    """K3P's Python plan (fused_block.tile_config(PIPE): tile, threads, shared
    memory) agrees with blle_block_kernel_info's kind 4 at every pipelined
    width, and one CTA fits an SM."""
    for c in fb.PIPELINED_WIDTHS:
        cfg = fb.tile_config(fb.PIPE, c)
        th, tw, threads, smem, per_sm = fb.kernel_info(fb.PIPE, c)
        assert (th, tw, threads, smem) == (cfg.th, cfg.tw, cfg.threads, cfg.smem), c
        assert per_sm == 1, c


def test_pipelined_gate_routes_by_width(cuda):
    """With apply_kernel="pipelined" the power-of-two widths launch K3P and
    48/96/192 keep K3 (the JAX package's gate); K3P refuses the others."""
    for c in fb.KERNEL_WIDTHS:
        params, w = folded_block(c, c, cuda)
        x = torch.randn(1, 9, 10, c, device=cuda).to(torch.bfloat16)
        before = (fb.apply_pass.launches, fb.apply_pass_pipelined.launches)
        with torch.inference_mode():
            got = fb.fused_transformer_block(x, params, 8, apply_kernel="pipelined").float()
            want = fb.fused_transformer_block_plain(x, params, 8).float()
        pipelined = c in fb.PIPELINED_WIDTHS
        assert (fb.apply_pass.launches - before[0], fb.apply_pass_pipelined.launches - before[1]) \
            == ((0, 1) if pipelined else (1, 0)), c
        torch.testing.assert_close(got, want, **BF16_TOL)
        if not pipelined:
            with torch.inference_mode(), pytest.raises(ValueError, match="K3P takes"):
                fb.apply_pass_pipelined(x, torch.zeros(1, c, c, device=cuda), w)


@pytest.mark.parametrize("c", [32, 48, 128, 256])  # each tile configuration of A1 and T1
def test_attention_and_stage_tail_kernels_match_twins(cuda, c):
    """A1 against the ChannelAttention twin and T1 against the stage-tail
    twin on ragged tiles, bf16 kernel vs fp32 twin."""
    from bayer_low_light_image_enhancement_tpu_torch.kernels import fused_attention as fa
    from bayer_low_light_image_enhancement_tpu_torch.kernels import fused_stage as fs

    gen = torch.Generator().manual_seed(c + 3)
    stage = common.ConvTransformer(c, 8, 2, device=cuda)
    common.reset_parameters_(stage, gen)
    sd = {k: v.detach() for k, v in stage.state_dict().items()}
    attn = {k.removeprefix("Transformer.attn."): v for k, v in sd.items()
            if k.startswith("Transformer.attn.")}
    x = torch.randn(2, 19, 13, c, generator=gen).to(cuda, torch.bfloat16)
    t = torch.randn(2, 19, 13, c, generator=gen).to(cuda, torch.bfloat16)
    before = (fa.fused_channel_attention.launches, fs.fused_stage_tail.launches)
    with torch.inference_mode():
        a = fa.fused_channel_attention(x, attn, 8)
        s = fs.fused_stage_tail(x, t, sd)
        torch.cuda.synchronize()
        a0 = fa.fused_channel_attention_plain(x, attn, 8)
        s0 = fs.fused_stage_tail_plain(x, t, sd)
    assert (fa.fused_channel_attention.launches, fs.fused_stage_tail.launches) == (
        before[0] + 1, before[1] + 1)
    torch.testing.assert_close(a.float(), a0, **BF16_TOL)
    torch.testing.assert_close(s.float(), s0, **BF16_TOL)


def attention_case(c, shape, seed, device):
    """A seeded dim-c ChannelAttention's weights (8 heads, temperatures off
    1) and bf16 x of ``shape``."""
    gen = torch.Generator().manual_seed(seed)
    attn = common.ChannelAttention(c, 8, device=device)
    common.reset_parameters_(attn, gen)
    sd = {k: v.detach() for k, v in attn.state_dict().items()}
    with torch.no_grad():
        sd["temperature"].add_(torch.empty(8, 1, 1).uniform_(-0.3, 0.3, generator=gen).to(device))
    x = torch.randn(*shape, c, generator=gen).to(device, torch.bfloat16)
    return x, sd


def check_attention(x, sd, heads=8):
    """A1 against its twin (bf16 kernel vs fp32 twin, the block rule), one
    launch a call."""
    from bayer_low_light_image_enhancement_tpu_torch.kernels import fused_attention as fa

    before = fa.fused_channel_attention.launches
    with torch.inference_mode():
        got = fa.fused_channel_attention(x, sd, heads)
        torch.cuda.synchronize()
        want = fa.fused_channel_attention_plain(x, sd, heads)
    assert fa.fused_channel_attention.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    torch.testing.assert_close(got.float(), want, **BF16_TOL)
    return got


# The finalise's bf16 apply against the fp32 twin: one bf16 rounding of the
# value (at most one bf16 step, 2^-8 of it, where the two fp32 sums fall on
# either side of a rounding boundary), and 1e-6 for values near zero.
FINALIZE_TOL = dict(rtol=2.0 ** -8, atol=1e-6)


@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("c", fb.KERNEL_WIDTHS)
def test_attention_finalise_kernel_matches_twin(cuda, c, b):
    """A1's finalise kernel (the heads' diagonal blocks of the gram only, a
    softmax row's max and sum first, column blocks of wproj) against
    finalize_attention at 1, 2, 4 and 8 heads (ch = C down to C / 8)."""
    from bayer_low_light_image_enhancement_tpu_torch.kernels import fused_attention as fa

    g = np.random.default_rng(c + b)
    q = torch.from_numpy(g.standard_normal((b, 64, c)).astype(np.float32)).to(cuda)
    k = torch.from_numpy(g.standard_normal((b, 64, c)).astype(np.float32)).to(cuda)
    gram = torch.einsum("bpc,bpd->bcd", q, k)
    qss, kss = (q * q).sum(1), (k * k).sum(1)
    sums = torch.cat([gram.reshape(b, c * c), qss, kss], dim=1).contiguous()
    wproj = torch.from_numpy((g.standard_normal((c, c)) / np.sqrt(c)).astype(np.float32)).to(cuda)
    for heads in (1, 2, 4, 8):
        temperature = torch.from_numpy(g.uniform(0.5, 3.0, heads).astype(np.float32)).to(cuda)
        got = fa.attention_finalize(sums, temperature, wproj, heads)
        want = fb.finalize_attention(gram, qss, kss, temperature, wproj, heads)
        assert got.dtype == torch.bfloat16 and got.shape == (b, c, c)
        torch.testing.assert_close(got.float(), want, **FINALIZE_TOL, msg=f"heads {heads}")


# 1 x 1, 1 x W, an image below one tile, ragged tiles over two images,
# several tiles a CTA.
@pytest.mark.parametrize("shape", [(1, 1, 1), (1, 1, 37), (1, 5, 9), (2, 19, 13), (1, 40, 70)])
@pytest.mark.parametrize("c", fb.KERNEL_WIDTHS)
def test_attention_kernel_at_every_width(cuda, c, shape):
    x, sd = attention_case(c, shape, c + len(shape), cuda)
    check_attention(x, sd)


@pytest.mark.parametrize("regime", ["one", "three", "per_tile"])
@pytest.mark.parametrize("c", [32, 48, 96, 192, 256])
def test_attention_kernel_under_forced_plans(cuda, monkeypatch, c, regime):
    """A1's gram and apply kernels walk runs of tiles (the apply pass across
    images): any grid gives the same function."""
    force_block_plan(monkeypatch, regime)
    x, sd = attention_case(c, (3, 21, 35), c + 5, cuda)
    check_attention(x, sd)


@pytest.mark.parametrize("c", [32, 128, 256])
def test_attention_reruns_are_bitwise_equal(cuda, c):
    """No atomics: the gram partials are summed in a fixed order."""
    x, sd = attention_case(c, (2, 33, 50), c + 7, cuda)
    assert torch.equal(check_attention(x, sd), check_attention(x, sd))


def test_attention_weights_are_remade_after_an_in_place_update(cuda):
    """A1's kernel arguments are cached per tensor and _version: an in-place
    change of a weight is seen by the next call."""
    x, sd = attention_case(64, (1, 20, 20), 3, cuda)
    before = check_attention(x, sd)
    with torch.no_grad():
        sd["project_out.weight"].mul_(-1.0)
    after = check_attention(x, sd)
    assert not torch.equal(before, after)


def test_attention_kernel_on_weights_made_in_inference_mode(cuda):
    """Inference tensors keep no version counter: A1 remakes their
    arguments on every call, so an in-place update is still seen."""
    with torch.inference_mode():
        x, sd = attention_case(128, (1, 20, 30), 5, cuda)
        before = check_attention(x, sd)
        sd["qkv.weight"].mul_(-1.0)
        after = check_attention(x, sd)
    assert not torch.equal(before, after)


def test_attention_plans_match_the_library(cuda):
    """A1's apply plan (K3 phase 1's geometry, blle_block_kernel_info's kind
    5) and its gram workspace agree with the C library."""
    from bayer_low_light_image_enhancement_tpu_torch.kernels import _build

    for c in fb.KERNEL_WIDTHS:
        cfg = fb.tile_config("attn_apply", c)
        th, tw, threads, smem, per_sm = fb.kernel_info("attn_apply", c)
        assert (th, tw, threads, smem) == (cfg.th, cfg.tw, cfg.threads, cfg.smem), c
        assert per_sm >= 1 and per_sm == fb.kernel_info("apply1", c)[4], c
    lib = _build.library()
    for b, h, w, c in [(8, 256, 256, 32), (8, 32, 32, 256), (1, 177, 265, 256), (2, 19, 13, 48)]:
        plan = fb.plan_for("attn_gram", b, h, w, c, 0)
        assert fb.gram_workspace_floats(b, h, w, c, plan) == \
            lib.blle_attn_gram_workspace_floats(b, h, w, c)


@pytest.mark.parametrize("level", ["c", "m", "v"])
def test_tma_floor_rung_matches_twin(cuda, level):
    """The floor ladder's TMA rung at every tile height on an image whose
    tiles outnumber the resident CTAs several times over (each CTA's walk
    wraps the 4-slot window ring), ragged in both directions."""
    from bayer_low_light_image_enhancement_tpu_torch.probes import floor as pf

    g = torch.Generator().manual_seed(13)
    x = torch.randn(4, 300, 301, 32, generator=g).to(cuda, torch.bfloat16)
    w = (torch.randn(32, 32, generator=g) / 32 ** 0.5).to(cuda, torch.bfloat16)
    dw = (torch.randn(9, 32, generator=g) / 3).to(cuda)
    ref = pf.floor_probe_plain(x, w, dw, level)
    for th in pf.TILE_HEIGHTS:
        out = pf.floor_probe(x, w, dw, "tma", level, th).float()
        err = ((out - ref).abs().max() / ref.abs().max()).item()
        assert err <= (0 if level == "c" else 3e-2), (level, th, err)


def stage_tail_case(c, shape, seed, device):
    """A seeded dim-c ConvTransformer's weights and bf16 x, t of ``shape``."""
    gen = torch.Generator().manual_seed(seed)
    stage = common.ConvTransformer(c, 8, 2, device=device)
    common.reset_parameters_(stage, gen)
    sd = {k: v.detach() for k, v in stage.state_dict().items()
          if not k.startswith("Transformer.")}
    x = torch.randn(*shape, c, generator=gen).to(device, torch.bfloat16)
    t = torch.randn(*shape, c, generator=gen).to(device, torch.bfloat16)
    return x, t, sd


def check_stage_tail(x, t, sd):
    """T1 against its twin (bf16 kernel vs fp32 twin, the block rule), one
    launch a call."""
    from bayer_low_light_image_enhancement_tpu_torch.kernels import fused_stage as fs

    before = fs.fused_stage_tail.launches
    with torch.inference_mode():
        got = fs.fused_stage_tail(x, t, sd)
        torch.cuda.synchronize()
        want = fs.fused_stage_tail_plain(x, t, sd)
    assert fs.fused_stage_tail.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    torch.testing.assert_close(got.float(), want, **BF16_TOL)
    return got


# 1 x 1, 1 x W, an image smaller than one 8 x 16 tile, ragged tiles in both
# directions over two images, several tiles a CTA.
@pytest.mark.parametrize("shape", [(1, 1, 1), (1, 1, 37), (1, 5, 9), (2, 19, 13), (1, 40, 70)])
@pytest.mark.parametrize("c", fb.KERNEL_WIDTHS)
def test_stage_tail_kernel_at_every_width(cuda, c, shape):
    x, t, sd = stage_tail_case(c, shape, c + len(shape), cuda)
    check_stage_tail(x, t, sd)


@pytest.mark.parametrize("regime", ["one", "three", "per_tile"])
@pytest.mark.parametrize("c", [32, 48, 64, 96, 192, 256])
def test_stage_tail_kernel_under_forced_plans(cuda, monkeypatch, c, regime):
    """Each CTA walks a run of tiles across images, the weight ring flowing
    over tile boundaries: any grid gives the same function."""
    import dataclasses

    from bayer_low_light_image_enhancement_tpu_torch.kernels import fused_stage as fs

    real = fs.plan_for

    def plan(b, h, w, c_, device_index):
        p = real(b, h, w, c_, device_index)
        ctas = {"one": 1, "three": min(3, p.tiles), "per_tile": p.tiles}[regime]
        return dataclasses.replace(p, ctas_conv=ctas, ctas_out=ctas)

    monkeypatch.setattr(fs, "plan_for", plan)
    x, t, sd = stage_tail_case(c, (3, 21, 35), c + 5, cuda)
    check_stage_tail(x, t, sd)


@pytest.mark.parametrize("c", [32, 128, 256])
def test_stage_tail_reruns_are_bitwise_equal(cuda, c):
    """No atomics: each output is summed in one fixed order."""
    x, t, sd = stage_tail_case(c, (2, 33, 50), c + 7, cuda)
    first = check_stage_tail(x, t, sd)
    assert torch.equal(first, check_stage_tail(x, t, sd))


def test_stage_tail_weights_are_remade_after_an_in_place_update(cuda):
    """The wrapper's bf16 weights are cached per tensor and _version: an
    in-place change of a weight is seen by the next call."""
    x, t, sd = stage_tail_case(64, (1, 20, 20), 3, cuda)
    before = check_stage_tail(x, t, sd)
    with torch.no_grad():
        sd["Conv_out.weight"].mul_(-1.0)
    after = check_stage_tail(x, t, sd)
    assert not torch.equal(before, after)


def test_stage_tail_kernel_on_weights_made_in_inference_mode(cuda):
    """Inference tensors keep no version counter: T1 remakes their bf16
    weights on every call, so an in-place update is still seen."""
    with torch.inference_mode():
        x, t, sd = stage_tail_case(128, (1, 20, 30), 5, cuda)
        before = check_stage_tail(x, t, sd)
        sd["conv.weight"].mul_(-1.0)
        after = check_stage_tail(x, t, sd)
    assert not torch.equal(before, after)


def test_tail_plans_match_the_library(cuda):
    """kernels/fused_stage.tail_config is each T1 kernel's TailCfg in the C
    library, and the card holds as many CTAs an SM as it is sized for."""
    from bayer_low_light_image_enhancement_tpu_torch.kernels import fused_stage as fs

    for c in fb.KERNEL_WIDTHS:
        for kind in fs.TAIL_KINDS:
            cfg = fs.tail_config(kind, c)
            assert fs.tail_kernel_info(kind, c) == (
                cfg.th, cfg.tw, cfg.threads, cfg.smem, cfg.per_sm, int(cfg.resident), cfg.kc,
                cfg.slots, cfg.windows, int(cfg.vx), int(cfg.wgmma)), (kind, c)


def test_probe_ladders_match_twins(cuda):
    """Every floor rung that computes a result (all but "center" at level
    "v") and every bisect stage of K3 and K3P against their twins, on ragged
    tiles."""
    from bayer_low_light_image_enhancement_tpu_torch.probes import floor as pf

    g = torch.Generator().manual_seed(12)
    x = torch.randn(2, 37, 21, 32, generator=g).to(cuda, torch.bfloat16)
    w = (torch.randn(32, 32, generator=g) / 32 ** 0.5).to(cuda, torch.bfloat16)
    dw = (torch.randn(9, 32, generator=g) / 3).to(cuda)
    for level in pf.LEVELS:
        ref = pf.floor_probe_plain(x, w, dw, level)
        for th in pf.TILE_HEIGHTS:
            for strategy in pf.STRATEGIES:
                out = pf.floor_probe(x, w, dw, strategy, level, th).float()
                if (strategy, level) != ("center", "v"):
                    err = ((out - ref).abs().max() / ref.abs().max()).item()
                    assert err <= (0 if level == "c" else 3e-2), (strategy, level, th, err)
    for c in fb.PIPELINED_WIDTHS:
        w = pf.block_weights(c, c, cuda)
        x = torch.randn(2, 15, 18, c, generator=g).to(cuda, torch.bfloat16)
        apply = fb.finalize_attention(*fb.gram_pass_plain(x, w), w.temperature, w.wproj, 8)
        for kind in fb.APPLY_KERNELS:
            for stage in pf.STAGES:
                got = pf.bisect_probe(x, apply, w, stage, kind).float()
                torch.testing.assert_close(got, pf.bisect_probe_plain(x, apply, w, stage),
                                           **BF16_TOL, msg=f"{kind} stage {stage} C={c}")


def test_pipelined_serving_and_training(cuda):
    """RawFormer-S served through Predictor(apply_kernel="pipelined") runs
    K3P 7 times and K3 never per forward and matches the CPU twin path; two
    train steps with set_apply_kernel(model, "pipelined") match the tiled
    path's losses and params."""
    from bayer_low_light_image_enhancement_tpu_torch.train import TrainConfig, Trainer

    gen = torch.Generator().manual_seed(3)
    gpu = RawFormer(RawFormerConfig.from_size("S", dtype=torch.bfloat16), device=cuda, generator=gen)
    cpu = RawFormer(RawFormerConfig.from_size("S"))
    cpu.load_state_dict(gpu.state_dict())
    m = np.random.default_rng(9).integers(0, 17000, (2, 70, 90), dtype=np.uint16)
    before = (fb.apply_pass.launches, fb.apply_pass_pipelined.launches)
    got = Predictor(gpu, apply_kernel="pipelined").raw_u16(m, [60.0, 200.0])
    assert (fb.apply_pass.launches - before[0], fb.apply_pass_pipelined.launches - before[1]) == (0, 7)
    want = Predictor(cpu, device="cpu").raw_u16(m, [60.0, 200.0])
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-2)

    g = np.random.default_rng(4)
    batch = (torch.from_numpy(g.uniform(0, 2, (2, 64, 64, 1)).astype(np.float32)).to(cuda),
             torch.from_numpy(g.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)).to(cuda))
    runs = []
    for kind in ("pipelined", "tiled"):
        model = RawFormer(RawFormerConfig(dim=32, dtype=torch.bfloat16), device=cuda,
                          generator=torch.Generator().manual_seed(0))
        common.set_apply_kernel(model, kind)
        trainer = Trainer(model, TrainConfig(warmup_epochs=1, steps_per_epoch=1))
        before = [f.launches for f in (fb.apply_pass, fb.apply_pass_pipelined, fbb.bwd1, fbb.bwd2)]
        losses = [float(trainer.train_step(batch)) for _ in range(2)]
        launched = [f.launches - b for f, b in
                    zip((fb.apply_pass, fb.apply_pass_pipelined, fbb.bwd1, fbb.bwd2), before)]
        assert launched == ([0, 14, 14, 14] if kind == "pipelined" else [14, 0, 14, 14])
        runs.append((losses, torch.cat([p.detach().flatten() for p in model.parameters()])))
    (lp, pp), (lt, pt) = runs
    np.testing.assert_allclose(lp, lt, rtol=2e-2)
    torch.testing.assert_close(pp, pt, rtol=0, atol=5e-4)


def test_compact_native_batches_decode_on_the_card(cuda):
    """The native engine's compact triples through ``prefetch_to_device``
    (uint16 pinned and moved as int16 bits) decode on the card to the CPU
    decode of the same triple (the same fp32 expressions; tolerance 1e-6)."""
    from bayer_low_light_image_enhancement_tpu_torch.data import SyntheticBayerDataset, native
    from bayer_low_light_image_enhancement_tpu_torch.data.pipeline import (
        prefetch_to_device,
        to_tensor,
    )
    from bayer_low_light_image_enhancement_tpu_torch.train.trainer import decode_batch

    ds = SyntheticBayerDataset(num_images=4, full_size=(72, 80), patch_size=64)
    sampler = native.sampler_for_dataset(ds, seed=2, compact=True)
    loader = native.NativeLoader(ds, sampler, 2, seed=2)
    host = list(loader)
    loader._epoch = 0
    moved = list(prefetch_to_device(iter(loader), cuda))
    assert len(host) == len(moved) == 2
    for h, d in zip(host, moved):
        assert d[0].dtype == d[2].dtype == torch.uint16 and d[0].is_cuda
        for got, want in zip(decode_batch(d), decode_batch([to_tensor(a) for a in h])):
            torch.testing.assert_close(got.cpu(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("decode", ["sid", "mcr"])
def test_predictor_codes_on_the_card_match_host_decode(cuda, decode):
    """``Predictor.codes`` (integer codes decoded on the card, zero codes in
    the pad) against ``__call__`` of the host-decoded frame, RawFormer-S
    bf16 on a frame off the 16-pixel grid: the serving tolerance of
    ``chip_smoke.py`` (max 5e-2, mean 5e-3 on RGB in [0, 1])."""
    from bayer_low_light_image_enhancement_tpu_torch.models import get_model

    g = np.random.default_rng(21)
    model = get_model("rawformer_s", device=cuda, dtype=torch.bfloat16)
    pred = Predictor(model, device=cuda)
    if decode == "sid":
        codes = g.integers(0, 17000, (2, 90, 132, 1), dtype=np.uint16)
        scale = np.array([100.0, 300.0], np.float32)
        host = (np.clip(codes.astype(np.float32), 512.0, 16383.0) - 512.0) / (
            16383.0 - 512.0 + 1e-6) * scale[:, None, None, None]
    else:
        codes = g.integers(0, 256, (2, 90, 132, 1), dtype=np.uint8)
        scale = np.array([48.18, 15.98], np.float32)
        host = codes.astype(np.float32) / 255.0 * scale[:, None, None, None]
    before, k1 = fb.gram_pass.launches, bp.bayer_pack_normalize.launches
    got = pred.codes(codes, scale, decode)
    assert fb.gram_pass.launches == before + 7 and got.shape == (2, 90, 132, 3)
    # RawFormer's SID codes go through K1 and the prepacked entry
    assert bp.bayer_pack_normalize.launches == k1 + (decode == "sid")
    d = np.abs(got - pred(host))
    assert d.max() <= 5e-2 and d.mean() <= 5e-3, (d.max(), d.mean())


@pytest.mark.parametrize("c", [48, 96, 192])
def test_log_temperature_block_kernels_match_twin(cuda, c):
    """K2 / K3 on a block that stores ``attn.log_temperature`` (the BayerTORGB
    blocks' widths at dim 48) against the twin, and against a block storing
    ``temperature`` = exp(log_temperature) with the same other weights."""
    blk = common.TransformerBlock(c, 8, 2, log_temperature=True, device=cuda)
    common.reset_parameters_(blk, torch.Generator().manual_seed(c + 1))
    with torch.no_grad():
        blk.attn.log_temperature.uniform_(-0.5, 0.5)
    params = dict(blk.named_parameters())
    plain = dict(params)
    plain["attn.temperature"] = plain.pop("attn.log_temperature").exp()
    x = torch.randn(2, 19, 13, c, device=cuda).to(torch.bfloat16)
    before = (fb.gram_pass.launches, fb.apply_pass.launches)
    with torch.inference_mode():
        got = fb.fused_transformer_block(x, params, 8).float()
        same = fb.fused_transformer_block(x, plain, 8).float()
        want = fb.fused_transformer_block_plain(x, params, 8).float()
    torch.cuda.synchronize()
    assert (fb.gram_pass.launches, fb.apply_pass.launches) == (before[0] + 2, before[1] + 2)
    torch.testing.assert_close(got, want, **BF16_TOL)
    torch.testing.assert_close(got, same, rtol=0, atol=0)


ZOO = ["flca_rawformer", "multilvl_flca_rawformer", "truecolor_rawformer",
       "bayertorgb_rawformer"]


@pytest.mark.parametrize("name", ZOO)
def test_flca_truecolor_serving_kernel_path_matches_module_path(cuda, name):
    """Each FLCA / TrueColor model at dim 48 (bf16) through Predictor on 2 x
    64x64: K2 and K3 6 times a forward (C = 48, 96, 192; the C = 384 block
    takes the module path), K1 never; the RGB at the serving bar of
    ``chip_smoke.py`` and the head's input within the same fractions of its
    largest magnitude, against ``set_fused_blocks(model, False)``, after
    BayerTORGB's colour correction is moved off saturation as
    ``chip_smoke.py`` does; ``raw_u16`` raises TypeError."""
    from bayer_low_light_image_enhancement_tpu_torch.models import get_model
    from chip_smoke import spread_color_correction

    model = get_model(name, device=cuda, dtype=torch.bfloat16,
                      generator=torch.Generator().manual_seed(4))
    pred = Predictor(model)
    x = np.random.default_rng(12).uniform(0, 1.5, (2, 64, 64, 1)).astype(np.float32)
    common.set_fused_blocks(model, False)
    spread_color_correction(model, lambda: pred(x))
    common.set_fused_blocks(model, True)
    heads = []
    model.conv_out.register_forward_hook(lambda m, i, o: heads.append(o.float()))
    before = (fb.gram_pass.launches, fb.apply_pass.launches, bp.bayer_pack_normalize.launches)
    got = pred(x)
    assert (fb.gram_pass.launches, fb.apply_pass.launches,
            bp.bayer_pack_normalize.launches) == (before[0] + 6, before[1] + 6, before[2])
    common.set_fused_blocks(model, False)
    want = pred(x)
    assert fb.gram_pass.launches == before[0] + 6
    assert got.shape == (2, 64, 64, 3) and np.isfinite(got).all()
    d = np.abs(got - want)
    assert d.max() <= 5e-2 and d.mean() <= 5e-3, (d.max(), d.mean())
    if hasattr(model, "color_correction"):  # the TrueColor RGB is not clipped
        assert (want <= 0).mean() + (want >= 1).mean() < 1e-2
    dh, scale = (heads[0] - heads[1]).abs(), float(heads[1].abs().max())
    assert float(dh.max()) <= 5e-2 * scale and float(dh.mean()) <= 5e-3 * scale
    with pytest.raises(TypeError, match="no prepacked entry"):
        pred.raw_u16(np.zeros((64, 64), np.uint16), 100.0)


def zoo_counters():
    return (bp.bayer_pack_normalize, fb.gram_pass, fb.apply_pass, fb.apply_pass_pipelined,
            wg.weight_grad, fbb.bwd1, fbb.bwd2)


def test_bayertorgb_train_step_kernel_path_matches_twin_path(cuda):
    """A bf16 train step of ``bayertorgb_rawformer`` at dim 48 on a synthetic
    batch 2 @ 128^2 (its colour correction moved off saturation) through
    K2/K3 + B1/B2 and the weight-grad pass against the same step with the
    blocks on their fp32 twins, by ``chip_smoke.py`` phase 11's rule
    (``held_train_step``): the loss within 2e-2 relative; every first-step
    grad leaf, the ``log_temperature`` leaves among them, within max(3 x the
    nudged twin's change, 3 x the bf16 twin's error, 2e-2) of the twin's
    leaf max, the median within max(2e-2, 1.5 x the bf16 twin's median); the
    launches of one step derived from the model's kernel blocks (K2, K3, B1,
    B2 once a block: 6; the weight-grad pass twice a block of width >= 96:
    8)."""
    from bayer_low_light_image_enhancement_tpu_torch.models import get_model
    from bayer_low_light_image_enhancement_tpu_torch.train import TrainConfig
    from chip_smoke import (
        MEDIAN_YARD,
        fused_block_widths,
        held_train_step,
        spread_color_correction,
        synthetic_batch,
    )

    batch = synthetic_batch(cuda, 2, 128)
    base = get_model("bayertorgb_rawformer", device=cuda, dtype=torch.bfloat16,
                     generator=torch.Generator().manual_seed(15))
    common.set_fused_blocks(base, False)
    with torch.no_grad():
        spread_color_correction(base, lambda: base(batch[0].permute(0, 3, 1, 2)))
    common.set_fused_blocks(base, True)
    widths = fused_block_widths(base)
    assert widths == [48, 96, 192, 192, 96, 48]
    assert sum("log_temperature" in n for n, _ in base.named_parameters()) == 7

    def make():
        m = get_model("bayertorgb_rawformer", device=cuda, dtype=torch.bfloat16)
        m.load_state_dict(base.state_dict())
        return m

    _, losses, got = held_train_step(make, TrainConfig(warmup_epochs=1, steps_per_epoch=1), batch,
                                     zoo_counters(), "bayertorgb_rawformer",
                                     median_yard=MEDIAN_YARD)
    assert got == {"bayer_pack_normalize": 0, "gram_pass": 6, "apply_pass": 6,
                   "apply_pass_pipelined": 0, "weight_grad": 8, "bwd1": 6, "bwd2": 6}
    assert np.isfinite(losses).all()


@pytest.mark.parametrize("shape", [(2, 64, 64, 96), (2, 32, 32, 192)])
def test_backward_kernels_at_the_flca_training_shapes(cuda, shape):
    """B1 + B2 and the weight-grad pass (twice: B1's products, B2's) at the
    blocks of an FLCA / TrueColor train step at dim 48, batch 2 @ 256^2 (C =
    96 and 192), against the twins: each leaf within max(3 x the bf16 twin's
    error, 2e-2) of the fp32 twin."""
    assert fbb.weight_grad_regime(shape[-1]) == "split"
    x, dy, wts = backward_case(shape, shape[-1] + 7, cuda)
    check_backward_against_twins(x, dy, wts)


@pytest.mark.parametrize("name", ["luma_mhsa_rawformer", "wavkan_rawformer"])
def test_plain_zoo_chunked_matches_unchunked_on_the_card(cuda, name):
    """``luma_mhsa_rawformer`` / ``wavkan_rawformer`` at dim 16 on 2 x 64x64,
    the token attention / KAN layers in 4 KiB chunks (recomputed in
    backward) against unchunked, no hand kernel launched: serving in bf16
    at ``chip_smoke.py``'s bar; one train step in fp32 compute by phase
    12's rule (``held_chunk_step``: the first loss within 2e-2 relative,
    every grad leaf within max(3 x the nudged run's change, 2e-2) of its
    leaf max, the median within 2e-2, the BatchNorm running stats within
    1e-2 of their max). In fp32 the chunks change only the order of fp32
    sums; in bf16 WavKAN's train-mode grads move by more than their own
    size under a half-ulp input nudge (phase 12 holds them on its yardstick)."""
    from bayer_low_light_image_enhancement_tpu_torch.models import get_model
    from bayer_low_light_image_enhancement_tpu_torch.train import TrainConfig
    from chip_smoke import held_chunk_step

    g = np.random.default_rng(16)
    x = g.uniform(0, 1.5, (2, 64, 64, 1)).astype(np.float32)
    batch = (torch.from_numpy(x).to(cuda),
             torch.from_numpy(g.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)).to(cuda))
    counters = zoo_counters()
    before = [f.launches for f in counters]

    def make(chunk_bytes=None, dtype=torch.bfloat16):
        m = get_model(name, device=cuda, dtype=dtype, dim=16,
                      generator=torch.Generator().manual_seed(16))
        common.set_chunk_bytes(m, chunk_bytes)
        return m

    outs = [Predictor(make(c))(x) for c in (None, 4096)]
    assert [f.launches for f in counters] == before
    d = np.abs(outs[0] - outs[1])
    assert np.isfinite(outs[1]).all() and d.max() <= 5e-2 and d.mean() <= 5e-3, (d.max(), d.mean())
    held_chunk_step(lambda chunk=None: make(chunk, torch.float32),
                    TrainConfig(warmup_epochs=1, steps_per_epoch=1), batch, counters, name,
                    other=4096)


@pytest.mark.parametrize("name", ["flca_rawformer", "bayertorgb_rawformer"])
def test_kernels_hold_on_the_blocks_own_inputs(cuda, name):
    """C12: one bf16 train step of the model at dim 48 on a synthetic batch
    2 @ 128^2 (BayerTORGB's colour correction moved off saturation), each
    kernel block's (x, dy, weights) captured by hooks
    (``chip_smoke.capture_blocks``); K2 / K3 and B1 / B2 with the weight-grad
    pass held on those inputs at C = 48, 96 and 192 by
    ``check_backward_against_twins``'s per-leaf rule
    (``chip_smoke.hold_captured_blocks``: K2's cosines and sums of squares,
    K3's output and every backward leaf within max(3 x the bf16 twin's
    error, 2e-2) of the fp32 twin's leaf max)."""
    from bayer_low_light_image_enhancement_tpu_torch.models import get_model
    from bayer_low_light_image_enhancement_tpu_torch.train import TrainConfig, Trainer
    from chip_smoke import (
        capture_blocks,
        hold_captured_blocks,
        spread_color_correction,
        synthetic_batch,
    )

    batch = synthetic_batch(cuda, 2, 128)
    model = get_model(name, device=cuda, dtype=torch.bfloat16,
                      generator=torch.Generator().manual_seed(12))
    common.set_fused_blocks(model, False)
    with torch.no_grad():
        spread_color_correction(model, lambda: model(batch[0].permute(0, 3, 1, 2)))
    common.set_fused_blocks(model, True)
    tr = Trainer(model, TrainConfig(warmup_epochs=1, steps_per_epoch=1))
    captured = capture_blocks(model, lambda: tr.train_step(batch))
    assert [x.shape[-1] for x, *_ in captured] == [48, 96, 192, 192, 96, 48]
    assert all(dy.shape == x.shape and dy.abs().max().item() > 0 for x, dy, *_ in captured)
    hold_captured_blocks(captured, name)


RAW_DOMAIN_DIM16 = {"flca_unet": dict(base=16), "unet_luma_dwt": dict(base=16),
                    "simple_flca_unet": dict(base_ch=16), "lumachroma_transformer": dict(base=16)}


@pytest.mark.parametrize("name", sorted(RAW_DOMAIN_DIM16))
def test_raw_domain_chunked_matches_unchunked_on_the_card(cuda, name):
    """A raw-domain model at width 16 on packed 2 x 64x64 planes, its token
    attention in 4 KiB chunks (recomputed in backward) against unchunked,
    no hand kernel launched: serving in bf16 at ``chip_smoke.py``'s bar
    scaled to the output's largest magnitude (packed planes are not in
    [0, 1]); one train step in fp32 compute by phase 13's rule
    (``held_chunk_step``: the first loss within 2e-2 relative, every grad
    leaf within max(3 x the nudged run's change, 2e-2) of its leaf max, the
    median within 2e-2)."""
    from bayer_low_light_image_enhancement_tpu_torch.models import get_model
    from bayer_low_light_image_enhancement_tpu_torch.train import TrainConfig
    from chip_smoke import held_chunk_step

    g = np.random.default_rng(17)
    x = torch.from_numpy(g.uniform(0, 1.5, (2, 64, 64, 4)).astype(np.float32)).to(cuda)
    batch = (x, torch.from_numpy(g.uniform(0, 1, (2, 64, 64, 4)).astype(np.float32)).to(cuda))
    counters = zoo_counters()
    before = [f.launches for f in counters]

    def make(chunk_bytes=None, dtype=torch.bfloat16):
        m = get_model(name, device=cuda, dtype=dtype, generator=torch.Generator().manual_seed(17),
                      **RAW_DOMAIN_DIM16[name])
        common.set_chunk_bytes(m, chunk_bytes)
        return m

    with torch.inference_mode():
        outs = [make(c)(x.permute(0, 3, 1, 2)) for c in (None, 4096)]
    assert [f.launches for f in counters] == before
    assert outs[0].shape == (2, 4, 64, 64) and torch.isfinite(outs[1]).all()
    d, scale = (outs[0] - outs[1]).abs(), outs[0].abs().max().item()
    assert d.max().item() <= 5e-2 * scale and d.mean().item() <= 5e-3 * scale, (d.max(), scale)
    held_chunk_step(lambda chunk=None: make(chunk, torch.float32),
                    TrainConfig(warmup_epochs=1, steps_per_epoch=1), batch, counters, name,
                    other=4096)


def test_export_round_trip_on_the_card(cuda, tmp_path):
    """RawFormer-S (seed 0, bf16 compute) exported on the card and loaded
    back through ``load_artifact``: within 1e-3 of ``Predictor`` on the same
    frames (the same kernels on the same inputs), K2 and K3 7 times a
    forward and no other kernel; the artifact refuses the CPU."""
    from bayer_low_light_image_enhancement_tpu_torch.kernels import ssm_scan as ssk
    from bayer_low_light_image_enhancement_tpu_torch.serving import export_artifact, load_artifact

    model = RawFormer(RawFormerConfig.from_size("S", dtype=torch.bfloat16), device=cuda,
                      generator=torch.Generator().manual_seed(0))
    pred = Predictor(model, device=cuda)
    path = str(tmp_path / "rawformer_s.zip")
    meta = export_artifact(model, None, path, 2, 64, 96, device=cuda)
    assert meta["ops"] == ["blle.apply_pass", "blle.gram_pass"] and meta["device"] == "cuda:0"
    fn, _ = load_artifact(path)
    x = np.random.default_rng(3).uniform(0, 1.5, (2, 64, 96, 1)).astype(np.float32)
    counters = zoo_counters() + (ssk.selective_scan_fwd, ssk.selective_scan_bwd)
    before = [f.launches for f in counters]
    y = fn(x)
    torch.cuda.synchronize()
    got = {f.__name__: f.launches - b for f, b in zip(counters, before) if f.launches != b}
    assert got == {"gram_pass": 7, "apply_pass": 7}
    np.testing.assert_allclose(y, pred(x), rtol=0, atol=1e-3)
    with pytest.raises(ValueError, match="exported for cuda"):
        load_artifact(path, device="cpu")


@pytest.mark.parametrize("name", ["gram_pass", "apply_pass", "apply_pass_pipelined",
                                  "selective_scan_fwd"])
def test_opcheck_on_the_card(cuda, name):
    """``torch.library.opcheck`` of each ``torch.ops.blle`` operator on CUDA
    inputs (ragged tiles; a scan of two chunks of sub-chunks)."""
    g = torch.Generator().manual_seed(21)
    blk = common.TransformerBlock(64, 8, 2, device=cuda)
    common.reset_parameters_(blk, g)
    w = fb.fold_block_params({k: v.detach() for k, v in blk.named_parameters()})
    x = torch.randn(2, 19, 13, 64, generator=g).to(cuda, torch.bfloat16)
    apply = fb.finalize_attention(*fb.gram_pass_plain(x, w), w.temperature, w.wproj, 8)
    u = torch.randn(2, 200, 40, generator=g).to(cuda, torch.bfloat16)
    dt = torch.rand(2, 200, 40, generator=g).mul(0.1).to(cuda, torch.bfloat16)
    A = -torch.rand(40, 16, generator=g).add(0.5).to(cuda)
    bm, cm = (torch.randn(2, 200, 16, generator=g).to(cuda, torch.bfloat16) for _ in "bc")
    args = {"gram_pass": (x, *w.gram_tensors()),
            "apply_pass": (x, apply, *w.apply_tensors()),
            "apply_pass_pipelined": (x, apply, *w.apply_tensors()),
            "selective_scan_fwd": (u, dt, A, bm, cm, torch.ones(40, device=cuda))}[name]
    torch.library.opcheck(getattr(torch.ops.blle, name).default, args)


# ---------------------------------------------------------------------------
# Band mode: K2 and K3 on H-bands with neighbour-band halos
# ---------------------------------------------------------------------------

# (frames, bands, band rows, W, frame_h): ragged tiles; one-row bands (the
# 2-row halo spans two bands); a frame of 17 rows in 4 bands of 5.
BAND_CASES = [(1, 4, 6, 13, None), (2, 3, 1, 9, None), (1, 4, 5, 18, 17)]


def band_frame_cosines(g, qs, ks, frames, bands):
    """A frame's gram cosines from its bands' partials."""
    g, qs, ks = (t.reshape(frames, bands, *t.shape[1:]).sum(1) for t in (g, qs, ks))
    return g / torch.sqrt(qs[:, :, None] * ks[:, None, :]), qs, ks


def check_band_pass_kernels(x, w, bands, frame_h, frames):
    """K2 and K3 in band mode against their twins on the halo'd bands of x,
    each wrapper counted once per call."""
    from bayer_low_light_image_enhancement_tpu_torch.ops.conv import band_halo

    fh = bands * x.shape[1] if frame_h is None else frame_h
    xh = band_halo(x, 2, bands)
    before = (fb.gram_pass_banded.launches, fb.apply_pass_banded.launches)
    with torch.inference_mode():
        got = fb.gram_pass_banded(xh, w, bands, fh)
        want = fb.gram_pass_banded_plain(xh, w, bands, fh)
        sums = [fb._banded_sums(t, bands) for t in want]
        apply = fb.finalize_attention(*sums, w.temperature, w.wproj, 8)
        apply = apply.repeat_interleave(bands, 0)
        y = fb.apply_pass_banded(xh, apply, w, bands, fh).float()
        y0 = fb.apply_pass_banded_plain(xh, apply, w, bands, fh).float()
    torch.cuda.synchronize()
    assert (fb.gram_pass_banded.launches, fb.apply_pass_banded.launches) == \
        (before[0] + 1, before[1] + 1)
    cos, qs, ks = band_frame_cosines(*got, frames, bands)
    cos0, qs0, ks0 = band_frame_cosines(*want, frames, bands)
    torch.testing.assert_close(cos, cos0, rtol=0, atol=2e-2)
    torch.testing.assert_close(qs, qs0, rtol=2e-2, atol=0)
    torch.testing.assert_close(ks, ks0, rtol=2e-2, atol=0)
    assert y.shape == x.shape
    torch.testing.assert_close(y, y0, **BF16_TOL)


@pytest.mark.parametrize("case", BAND_CASES)
@pytest.mark.parametrize("c", fb.KERNEL_WIDTHS)
def test_band_pass_kernels_match_twins(cuda, c, case):
    from bayer_low_light_image_enhancement_tpu_torch.probes import floor as pf

    frames, bands, hb, wd, frame_h = case
    w = pf.block_weights(c, c + 5, cuda)
    g = torch.Generator().manual_seed(c + hb)
    x = torch.randn(frames * bands, hb, wd, c, generator=g).to(cuda, torch.bfloat16)
    check_band_pass_kernels(x, w, bands, frame_h, frames)


@pytest.mark.parametrize("regime", ["one", "three", "per_tile"])
@pytest.mark.parametrize("c", [32, 96, 256])
def test_band_pass_kernels_under_forced_plans(cuda, monkeypatch, c, regime):
    from bayer_low_light_image_enhancement_tpu_torch.probes import floor as pf

    force_block_plan(monkeypatch, regime)
    w = pf.block_weights(c, c + 6, cuda)
    g = torch.Generator().manual_seed(c + 6)
    x = torch.randn(2 * 4, 7, 19, c, generator=g).to(cuda, torch.bfloat16)
    check_band_pass_kernels(x, w, 4, None, 2)


@pytest.mark.parametrize("c", fb.KERNEL_WIDTHS)
def test_band_block_matches_the_monolithic_kernel_path(cuda, c):
    """The banded block on the bands of two frames against the monolithic
    kernel path on the frames (both bf16 kernels) and the band twin."""
    blk = common.TransformerBlock(c, 8, 2, device=cuda)
    common.reset_parameters_(blk, torch.Generator().manual_seed(c + 7))
    params = dict(blk.named_parameters())
    frames = torch.randn(2, 4 * 9, 11, c, device=cuda).to(torch.bfloat16)
    xb = frames.reshape(8, 9, 11, c)
    with torch.inference_mode():
        got = fb.fused_transformer_block(xb, params, 8, bands=4).float()
        mono = fb.fused_transformer_block(frames, params, 8).float().reshape(8, 9, 11, c)
        twin = fb.fused_transformer_block_plain(xb, params, 8, bands=4).float()
    torch.testing.assert_close(got, twin, **BF16_TOL)
    torch.testing.assert_close(got, mono, **BF16_TOL)


@pytest.mark.parametrize("c", fb.KERNEL_WIDTHS)
def test_band_kernels_at_one_band_are_todays_kernels(cuda, c):
    """One band a frame, its halo the zero pad: the band kernels give K2's
    and K3's results bitwise (the masks reduce to the image's, every pixel
    is computed as before), and ``bands=1`` is today's block."""
    from bayer_low_light_image_enhancement_tpu_torch.ops.conv import band_halo
    from bayer_low_light_image_enhancement_tpu_torch.probes import floor as pf

    w = pf.block_weights(c, c + 8, cuda)
    x = torch.randn(2, 21, 17, c, device=cuda).to(torch.bfloat16)
    xh = band_halo(x, 2, 1)
    with torch.inference_mode():
        for a, b in zip(fb.gram_pass_banded(xh, w, 1, 21), fb.gram_pass(x, w)):
            assert torch.equal(a, b)
        g0, qs0, ks0 = fb.gram_pass_plain(x, w)
        apply = fb.finalize_attention(g0, qs0, ks0, w.temperature, w.wproj, 8)
        assert torch.equal(fb.apply_pass_banded(xh, apply, w, 1, 21), fb.apply_pass(x, apply, w))
        blk = common.TransformerBlock(c, 8, 2, device=cuda)
        params = dict(blk.named_parameters())
        assert torch.equal(fb.fused_transformer_block(x, params, 8, bands=1),
                           fb.fused_transformer_block(x, params, 8))


@pytest.mark.parametrize("name", ["gram_pass_banded", "apply_pass_banded"])
def test_band_opcheck_on_the_card(cuda, name):
    from bayer_low_light_image_enhancement_tpu_torch.ops.conv import band_halo

    g = torch.Generator().manual_seed(22)
    blk = common.TransformerBlock(64, 8, 2, device=cuda)
    common.reset_parameters_(blk, g)
    w = fb.fold_block_params({k: v.detach() for k, v in blk.named_parameters()})
    xh = band_halo(torch.randn(4, 7, 13, 64, generator=g).to(cuda, torch.bfloat16), 2, 2)
    apply = torch.randn(4, 64, 64, generator=g).div(64).to(cuda)
    args = {"gram_pass_banded": (xh, *w.gram_tensors(), 2, 13),
            "apply_pass_banded": (xh, apply, *w.apply_tensors(), 2, 14)}[name]
    torch.library.opcheck(getattr(torch.ops.blle, name).default, args)


@pytest.mark.parametrize("size", ["S", "B", "L"])
def test_banded_rawformer_on_the_card(cuda, size):
    """``make_banded_forward`` of a seeded RawFormer on a 256 x 192 mosaic in
    4 bands against the monolithic kernel path at the serving bar: K2 / K3
    in band mode at all 7 blocks (B's 384-wide and L's 512-wide bottleneck
    included, one wide launch each), no other block kernel and no attention
    module (the module path)."""
    from bayer_low_light_image_enhancement_tpu_torch.models import get_model
    from bayer_low_light_image_enhancement_tpu_torch.models.fused_apply import make_banded_forward

    model = get_model(f"rawformer_{size.lower()}", device=cuda, dtype=torch.bfloat16,
                      generator=torch.Generator().manual_seed(3)).eval()
    x = torch.rand(1, 1, 256, 192, generator=torch.Generator().manual_seed(4)).to(cuda)
    counters = (fb.gram_pass, fb.apply_pass, fb.apply_pass_pipelined, fb.gram_pass_banded,
                fb.apply_pass_banded, fb.gram_pass_banded_wide, fb.apply_pass_banded_wide)
    attn = []
    hooks = [m.register_forward_hook(lambda *a: attn.append(1))
             for m in model.modules() if isinstance(m, common.ChannelAttention)]
    try:
        with torch.inference_mode():
            mono = model(x)
            before, attn_mono = [f.launches for f in counters], len(attn)
            got = make_banded_forward(model, 4)(x)
            torch.cuda.synchronize()
    finally:
        for h in hooks:
            h.remove()
    launched = {f.__name__: f.launches - b for f, b in zip(counters, before) if f.launches != b}
    wide = {} if size == "S" else {"gram_pass_banded_wide": 1, "apply_pass_banded_wide": 1}
    assert launched == {"gram_pass_banded": 7, "apply_pass_banded": 7, **wide}
    assert len(attn) == attn_mono == (0 if size == "S" else 1)
    d = (got - mono).abs()
    assert got.shape == mono.shape and d.max().item() <= 5e-2 and d.mean().item() <= 5e-3


@pytest.mark.parametrize("size", ["B", "L"])
def test_rawformer_sizes_serve_crops_on_the_kernels(cuda, size):
    """RawFormer-B / -L (``chip_smoke.py`` phase 19's seeded model, bf16
    compute) on 2 uint16 64^2 mosaics through ``Predictor.raw_u16``: K1 once,
    K2 / K3 six times (the blocks of width <= 256), no other kernel and one
    module-path attention (the 8 dim-wide bottleneck); against the twin path
    (K1's and the blocks' fp32 twins) at the serving bar (max 5e-2, mean
    5e-3)."""
    from chip_smoke import (
        counted,
        kernel_counters,
        module_attention_widths,
        serving_bar,
        size_model,
        sizes_counters,
        twin_u16_forward,
    )

    model = size_model(size, cuda)
    pred = Predictor(model, device=cuda)
    g = np.random.default_rng(24)
    m = g.integers(0, 17000, (2, 64, 64), dtype=np.uint16)
    ratio = g.uniform(50.0, 300.0, 2).astype(np.float32)
    (got, launched), attn = module_attention_widths(model, lambda: counted(
        sizes_counters(kernel_counters()), lambda: pred.raw_u16(m, ratio)))
    want = dict.fromkeys(launched, 0)
    want.update(bayer_pack_normalize=1, gram_pass=6, apply_pass=6)
    assert launched == want
    assert attn == [8 * model.config.dim]
    assert got.shape == (2, 64, 64, 3) and np.isfinite(got).all()
    serving_bar(got, twin_u16_forward(model, u16(m, cuda), torch.from_numpy(ratio).to(cuda)),
                f"RawFormer-{size} kernel path vs twin path")


@pytest.mark.parametrize("size", ["B", "L"])
def test_rawformer_sizes_train_step_on_the_kernels(cuda, size):
    """A bf16 train step of RawFormer-B / -L (phase 19's seeded model) on a
    synthetic batch 2 @ 64^2 through K2 / K3 + B1 / B2 and the weight-grad
    pass against the same step with the blocks on their fp32 twins, by
    ``chip_smoke.held_train_step`` with phase 11's MEDIAN_YARD (the loss
    within 2e-2 relative; every first-step grad leaf within max(3 x the
    nudged twin's change, 3 x the bf16 twin's error, 2e-2) of the twin's
    leaf max, the median within max(2e-2, 1.5 x the bf16 twin's); the params
    after two Adam steps within 5e-4); per step K2 / K3 / B1 / B2 six times
    and the weight-grad pass eight times (twice a block of width >= 96),
    nothing else (the bottleneck on the module path)."""
    from bayer_low_light_image_enhancement_tpu_torch.train import TrainConfig
    from chip_smoke import (
        MEDIAN_YARD,
        held_train_step,
        kernel_counters,
        size_model,
        sizes_counters,
        synthetic_batch,
    )

    batch = synthetic_batch(cuda, 2, 64)
    _, losses, got = held_train_step(lambda: size_model(size, cuda),
                                     TrainConfig(warmup_epochs=1, steps_per_epoch=1), batch,
                                     sizes_counters(kernel_counters()), f"RawFormer-{size}",
                                     median_yard=MEDIAN_YARD)
    want = dict.fromkeys(got, 0)
    want.update(gram_pass=6, apply_pass=6, bwd1=6, bwd2=6, weight_grad=8)
    assert got == want
    assert np.isfinite(losses).all()


# ---------------------------------------------------------------------------
# K2 / K3 at the wide widths, C = 384 and 512 (kernels/wide_block.py,
# csrc/wide_block.cu: LayerNorm, wgmma GEMMs, dw passes, the gram through
# the weight-grad pass)
# ---------------------------------------------------------------------------

# Ragged tiles (a sub-tile image, several tiles ragged both ways) and the
# Sony frame's banded bottleneck, [8, 23, 272, C].
WIDE_SHAPES = [(1, 3, 5), (2, 19, 13), (3, 11, 29), (8, 23, 272)]


@pytest.mark.parametrize("shape", WIDE_SHAPES)
@pytest.mark.parametrize("c", fb.WIDE_WIDTHS)
def test_wide_block_pass_kernels_match_twins(cuda, c, shape):
    from bayer_low_light_image_enhancement_tpu_torch.probes import floor as pf

    w = pf.block_weights(c, c + 11, cuda)
    x = torch.randn(*shape, c, generator=torch.Generator().manual_seed(c)).to(cuda, torch.bfloat16)
    check_block_pass_kernels(x, w)


@pytest.mark.parametrize("case", BAND_CASES + [(1, 8, 23, 272, None)])
@pytest.mark.parametrize("c", fb.WIDE_WIDTHS)
def test_wide_band_pass_kernels_match_twins(cuda, c, case):
    from bayer_low_light_image_enhancement_tpu_torch.probes import floor as pf

    frames, bands, hb, wd, frame_h = case
    w = pf.block_weights(c, c + 12, cuda)
    g = torch.Generator().manual_seed(c + hb)
    x = torch.randn(frames * bands, hb, wd, c, generator=g).to(cuda, torch.bfloat16)
    check_band_pass_kernels(x, w, bands, frame_h, frames)


def force_gemm_ctas(monkeypatch, regime):
    """Make every wide GEMM run on one CTA ("one"), three ("three") or one
    CTA per tile ("per_tile") whatever the card's residency."""
    from bayer_low_light_image_enhancement_tpu_torch.kernels import wide_block as wb

    monkeypatch.setattr(wb, "gemm_ctas", lambda g, d: {"one": 1, "three": min(3, g.tiles),
                                                        "per_tile": g.tiles}[regime])


@pytest.mark.parametrize("regime", ["one", "three", "per_tile"])
@pytest.mark.parametrize("c", fb.WIDE_WIDTHS)
def test_wide_kernels_under_forced_plans(cuda, monkeypatch, c, regime):
    """The GEMMs' persistent CTAs: one walking every tile (its ring's
    barriers through many phases, the producer running ahead across
    tiles), three, one a tile: plain and band mode give the same
    function."""
    from bayer_low_light_image_enhancement_tpu_torch.probes import floor as pf

    force_gemm_ctas(monkeypatch, regime)
    w = pf.block_weights(c, c + 13, cuda)
    g = torch.Generator().manual_seed(c + 13)
    check_block_pass_kernels(torch.randn(2, 21, 18, c, generator=g).to(cuda, torch.bfloat16), w)
    xb = torch.randn(2 * 4, 7, 19, c, generator=g).to(cuda, torch.bfloat16)
    check_band_pass_kernels(xb, w, 4, None, 2)


@pytest.mark.parametrize("c", fb.WIDE_WIDTHS)
def test_wide_kernel_reruns_are_bitwise_equal(cuda, c):
    """K2's partials are summed in a fixed order; K3 has no reduction."""
    from bayer_low_light_image_enhancement_tpu_torch.ops.conv import band_halo
    from bayer_low_light_image_enhancement_tpu_torch.probes import floor as pf

    w = pf.block_weights(c, c + 14, cuda)
    x = torch.randn(8, 23, 37, c, device=cuda).to(torch.bfloat16)
    xh = band_halo(x, 2, 8)
    apply = torch.randn(8, c, c, device=cuda) / c
    with torch.inference_mode():
        for fn in (lambda: fb.gram_pass(x, w), lambda: fb.gram_pass_banded(xh, w, 8, 184)):
            for a, b in zip(fn(), fn()):
                assert torch.equal(a, b)
        assert torch.equal(fb.apply_pass(x, apply, w), fb.apply_pass(x, apply, w))
        assert torch.equal(fb.apply_pass_banded(xh, apply, w, 8, 184),
                           fb.apply_pass_banded(xh, apply, w, 8, 184))


@pytest.mark.parametrize("c", fb.WIDE_WIDTHS)
def test_wide_band_kernels_at_one_band_are_the_plain_kernels(cuda, c):
    """One band a frame, its halo the zero pad: the band kernels give the
    plain K2's and K3's results bitwise."""
    from bayer_low_light_image_enhancement_tpu_torch.ops.conv import band_halo
    from bayer_low_light_image_enhancement_tpu_torch.probes import floor as pf

    w = pf.block_weights(c, c + 15, cuda)
    x = torch.randn(2, 21, 17, c, device=cuda).to(torch.bfloat16)
    xh = band_halo(x, 2, 1)
    with torch.inference_mode():
        for a, b in zip(fb.gram_pass_banded(xh, w, 1, 21), fb.gram_pass(x, w)):
            assert torch.equal(a, b)
        g0, qs0, ks0 = fb.gram_pass_plain(x, w)
        apply = fb.finalize_attention(g0, qs0, ks0, w.temperature, w.wproj, 8)
        assert torch.equal(fb.apply_pass_banded(xh, apply, w, 1, 21), fb.apply_pass(x, apply, w))


@pytest.mark.parametrize("c", fb.WIDE_WIDTHS)
def test_wide_band_block_matches_the_monolithic_kernel_path(cuda, c):
    """The banded block at C = 384 / 512 on the bands of two frames against
    the plain kernels on the frames and the band twin."""
    blk = common.TransformerBlock(c, 8, 2, device=cuda)
    common.reset_parameters_(blk, torch.Generator().manual_seed(c + 16))
    params = dict(blk.named_parameters())
    frames = torch.randn(2, 4 * 9, 11, c, device=cuda).to(torch.bfloat16)
    xb = frames.reshape(8, 9, 11, c)
    with torch.inference_mode():
        got = fb.fused_transformer_block(xb, params, 8, bands=4).float()
        mono = fb.fused_transformer_block(frames, params, 8).float().reshape(8, 9, 11, c)
        twin = fb.fused_transformer_block_plain(xb, params, 8, bands=4).float()
    torch.testing.assert_close(got, twin, **BF16_TOL)
    torch.testing.assert_close(got, mono, **BF16_TOL)


def test_wide_plans_match_the_library(cuda):
    """The wide GEMM's Python plan (shared memory, threads, ring stages) is
    the library's at both tile widths and one CTA of it is resident; the
    tile kernels' plans and workspaces are refused at the wide widths (K2 /
    K3 run the wide chain there), as is A1's gram."""
    import ctypes

    from bayer_low_light_image_enhancement_tpu_torch.kernels import _build
    from bayer_low_light_image_enhancement_tpu_torch.kernels import wide_block as wb

    lib = _build.library()
    for tn in wb.GEMM_TILE_NS:
        smem, threads, stages, per_sm = wb.gemm_info(tn)
        assert (smem, threads, stages) == (wb.gemm_smem(tn), wb.GEMM_THREADS, wb.GEMM_STAGES)
        assert per_sm == 1
    info = (ctypes.c_longlong * 5)()
    for c in fb.WIDE_WIDTHS:
        for kind in range(4):
            assert lib.blle_block_kernel_info(kind, c, info) != 0
        assert lib.blle_gram_workspace_floats(8, 23, 272, c) == -1


def wide_weights(c, seed, cuda):
    """A wide block's folded weights as the chain takes them."""
    from bayer_low_light_image_enhancement_tpu_torch.probes import floor as pf

    w = pf.block_weights(c, seed, cuda)
    return w, [fb.bf16(w.wqk), fb.f32(w.bqk), fb.f32(w.dwqk), fb.f32(w.bdwqk)]


# Plain and band-mode calls of the chain: (b, h, w, bands, frame_h); the
# Sony frame's banded bottleneck last.
WIDE_CHAIN_CASES = [(1, 3, 5, 0, 0), (3, 11, 29, 0, 0), (4, 1, 9, 4, 3), (8, 23, 272, 8, 184)]


@pytest.mark.parametrize("case", WIDE_CHAIN_CASES)
@pytest.mark.parametrize("c", fb.WIDE_WIDTHS)
def test_wide_layernorm_kernel_matches_twin(cuda, c, case):
    """The LayerNorm pass on every row range the chain asks for, against
    its twin (bf16 out: within one bf16 step of the output's magnitude)."""
    from bayer_low_light_image_enhancement_tpu_torch.kernels import wide_block as wb

    b, h, w, bands, fh = case
    x = torch.randn(b, h + 4, w, c, generator=torch.Generator().manual_seed(c + h)).to(
        cuda, torch.bfloat16)
    before = wb.layernorm_rows.launches
    for first, rows in [(0, h + 4), (1, h + 2), (2, h)]:
        got = wb.layernorm_rows(x, first, rows)
        want = wb.layernorm_rows_plain(x, first, rows)
        assert got.shape == (b, rows, w, c) and got.dtype == torch.bfloat16
        torch.testing.assert_close(got.float(), want.float(), rtol=1e-2, atol=1e-2)
    assert wb.layernorm_rows.launches == before + 3


@pytest.mark.parametrize("case", WIDE_CHAIN_CASES)
@pytest.mark.parametrize("c", fb.WIDE_WIDTHS)
def test_wide_gemm_kernel_matches_twin(cuda, c, case):
    """Every product of a K2 and a K3 call (z with the frame mask, the
    batched v @ apply[b], the residual epilogues; M off the 128-row tile)
    against torch in fp32 on the same bf16 operands: z within fp32
    accumulation error, the bf16 outputs within one bf16 step."""
    from bayer_low_light_image_enhancement_tpu_torch.kernels import wide_block as wb

    b, h, w, bands, fh = case
    g = torch.Generator().manual_seed(c + w)
    for kind in ("gram", "apply"):
        for gm in wb.wide_plan(kind, b, h, w, c, bands, fh).gemms:
            a = torch.randn(gm.g * gm.m * gm.k, generator=g).to(cuda, torch.bfloat16)
            bshape = ((gm.g,) if gm.batched else ()) + (gm.k, gm.n)
            bm = (torch.randn(bshape, generator=g) / 16).to(cuda, torch.bfloat16)
            bias = torch.randn(gm.n, generator=g).to(cuda)
            imgs = gm.g * gm.m // (gm.rows * gm.w)
            res = (torch.randn(imgs, gm.res_rows, gm.w, gm.n, generator=g).to(cuda, torch.bfloat16)
                   if gm.res_rows else None)
            before = wb.gemm.launches
            got = wb.gemm(a, bm, bias, gm, res)
            assert wb.gemm.launches == before + 1
            want = wb.gemm_plain(a, bm, bias, gm, res)
            assert got.shape == want.shape and got.dtype == want.dtype
            if res is None:
                torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
            else:
                torch.testing.assert_close(got.float(), want.float(), rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("epi", ["qk", "v", "gelu"])
@pytest.mark.parametrize("case", WIDE_CHAIN_CASES)
@pytest.mark.parametrize("c", [384, 512])
def test_wide_dw_kernel_matches_twin(cuda, c, case, epi):
    """The dw passes of the chain (q / k with the counted-row mask and the
    partial sums of squares, v, GELU) against their twins."""
    from bayer_low_light_image_enhancement_tpu_torch.kernels import wide_block as wb

    b, h, w, bands, fh = case
    g = torch.Generator().manual_seed(c + h + len(epi))
    kind = "gram" if epi == "qk" else "apply"
    for d in wb.wide_plan(kind, b, h, w, c, bands, fh).dws:
        if d.epi != epi:
            continue
        z = torch.randn(d.b, d.rz, d.w, d.f, generator=g).to(cuda)
        taps = (torch.randn(9, d.f, generator=g) / 3).to(cuda)
        bias = torch.randn(d.f, generator=g).to(cuda)
        before = wb.dw3x3.launches
        got, want = wb.dw3x3(z, taps, bias, d), wb.dw3x3_plain(z, taps, bias, d)
        assert wb.dw3x3.launches == before + 1
        if epi != "qk":
            got, want = (got,), (want,)
        for a, r in zip(got, want):
            assert a.shape == r.shape and a.dtype == r.dtype
            torch.testing.assert_close(a.float(), r.float(), rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("c", fb.WIDE_WIDTHS)
def test_wide_gram_through_the_weight_grad_pass(cuda, c):
    """The gram as K2 takes it: q and k [B, pixels, C] through
    ``weight_grad`` against q^T k in fp32, then ``gram_finish`` placing it
    and summing the dw pass's partials in order, against its twin."""
    from bayer_low_light_image_enhancement_tpu_torch.kernels import weight_grad as wgk
    from bayer_low_light_image_enhancement_tpu_torch.kernels import wide_block as wb

    g = torch.Generator().manual_seed(c + 19)
    q, k = (torch.randn(8, 23 * 272, c, generator=g).to(cuda, torch.bfloat16) for _ in range(2))
    before = wgk.weight_grad.launches
    gram = wgk.weight_grad([(q, k)])[0]
    assert wgk.weight_grad.launches == before + 1
    want = torch.einsum("gkm,gkn->gmn", q.float(), k.float())
    torch.testing.assert_close(gram, want, rtol=1e-4, atol=1e-2)
    part = torch.randn(8, 102, 2 * c, generator=g).to(cuda)
    before = wb.gram_finish.launches
    out = wb.gram_finish(gram, part)
    assert wb.gram_finish.launches == before + 1
    torch.testing.assert_close(out, wb.gram_finish_plain(gram, part), rtol=1e-6, atol=1e-3)
    assert torch.equal(out[:, : c * c], gram.reshape(8, -1))


@pytest.mark.parametrize("c", fb.WIDE_WIDTHS)
def test_wide_chain_launches(cuda, c):
    """One wide K2 call launches LayerNorm, a GEMM, a dw pass, the
    weight-grad pass and the finish once each; one K3 call LayerNorm twice,
    four GEMMs, two dw passes; nothing else of the block kernels."""
    from bayer_low_light_image_enhancement_tpu_torch.kernels import weight_grad as wgk
    from bayer_low_light_image_enhancement_tpu_torch.kernels import wide_block as wb

    w, _ = wide_weights(c, c + 20, cuda)
    x = torch.randn(2, 9, 11, c, device=cuda).to(torch.bfloat16)
    counters = (*wb.WRAPPERS, wgk.weight_grad, fb.gram_pass, fb.apply_pass)

    def launched(fn):
        before = [f.launches for f in counters]
        with torch.inference_mode():
            out = fn()
        torch.cuda.synchronize()
        return out, {f.__name__: f.launches - b for f, b in zip(counters, before)}

    (gram, qs, ks), got = launched(lambda: fb.gram_pass(x, w))
    assert got == {"layernorm_rows": 1, "gemm": 1, "dw3x3": 1, "gram_finish": 1,
                   "weight_grad": 1, "gram_pass": 1, "apply_pass": 0}
    apply = fb.finalize_attention(gram, qs, ks, w.temperature, w.wproj, 8)
    _, got = launched(lambda: fb.apply_pass(x, apply, w))
    assert got == {"layernorm_rows": 2, "gemm": 4, "dw3x3": 2, "gram_finish": 0,
                   "weight_grad": 0, "gram_pass": 0, "apply_pass": 1}


@pytest.mark.parametrize("name", ["gram_pass", "apply_pass", "gram_pass_banded",
                                  "apply_pass_banded"])
@pytest.mark.parametrize("c", fb.WIDE_WIDTHS)
def test_wide_opcheck_on_the_card(cuda, c, name):
    from bayer_low_light_image_enhancement_tpu_torch.ops.conv import band_halo
    from bayer_low_light_image_enhancement_tpu_torch.probes import floor as pf

    g = torch.Generator().manual_seed(c + 17)
    w = pf.block_weights(c, c + 17, cuda)
    x = torch.randn(4, 7, 13, c, generator=g).to(cuda, torch.bfloat16)
    xh = band_halo(x, 2, 2)
    apply = torch.randn(4, c, c, generator=g).div(c).to(cuda)
    args = {"gram_pass": (x, *w.gram_tensors()),
            "apply_pass": (x, apply, *w.apply_tensors()),
            "gram_pass_banded": (xh, *w.gram_tensors(), 2, 13),
            "apply_pass_banded": (xh, apply, *w.apply_tensors(), 2, 14)}[name]
    torch.library.opcheck(getattr(torch.ops.blle, name).default, args)


def test_wide_kernel_failures_raise(cuda, monkeypatch):
    """No fallback at the wide widths: a GEMM grid the library refuses (more
    CTAs than tiles) raises, and so does a library that cannot be built,
    through the wrappers and through a banded RawFormer-B bottleneck
    block."""
    from bayer_low_light_image_enhancement_tpu_torch.kernels import _build
    from bayer_low_light_image_enhancement_tpu_torch.kernels import wide_block as wb
    from bayer_low_light_image_enhancement_tpu_torch.ops.conv import band_halo
    from bayer_low_light_image_enhancement_tpu_torch.probes import floor as pf

    w = pf.block_weights(384, 18, cuda)
    x = torch.randn(8, 5, 9, 384, device=cuda).to(torch.bfloat16)
    xh = band_halo(x, 2, 8)
    real = wb.gemm_ctas
    monkeypatch.setattr(wb, "gemm_ctas", lambda g, d: g.tiles + 1)
    with torch.inference_mode():
        with pytest.raises(RuntimeError, match="CUDA error"):
            fb.gram_pass_banded(xh, w, 8, 40)
        apply = torch.zeros(8, 384, 384, device=cuda)
        with pytest.raises(RuntimeError, match="CUDA error"):
            fb.apply_pass_banded(xh, apply, w, 8, 40)
    monkeypatch.setattr(wb, "gemm_ctas", real)

    def no_build():
        raise RuntimeError("nvcc failed")

    monkeypatch.setattr(_build, "library", no_build)
    blk = common.TransformerBlock(384, 8, 2, device=cuda, dtype=torch.bfloat16)
    common.bind_bands(blk, 8)
    with torch.inference_mode():
        with pytest.raises(RuntimeError, match="nvcc failed"):
            fb.gram_pass_banded(xh, w, 8, 40)
        with pytest.raises(RuntimeError, match="nvcc failed"):
            blk(x.permute(0, 3, 1, 2))
