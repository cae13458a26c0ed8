"""The split weight-grad regime of the fused-block backward, on the CPU: the
width rule, the weight-grad pass's plan and wrapper
(kernels/weight_grad.py), the per-pixel operand twins of B1/B2
(kernels/fused_block_bwd.py) against bwd1_plain/bwd2_plain, and the whole
block backward through them against the JAX Pallas backward in interpret
mode. The CUDA kernels against their twins are in tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from bayer_low_light_image_enhancement_tpu.kernels.fused_block_bwd import (
    fused_transformer_block_train,
)
from bayer_low_light_image_enhancement_tpu.models.common import TransformerBlock as JaxBlock
from bayer_low_light_image_enhancement_tpu_torch.compat.jax_params import (
    transformer_block_state_dict,
)
from bayer_low_light_image_enhancement_tpu_torch.kernels import fused_block as fb
from bayer_low_light_image_enhancement_tpu_torch.kernels import fused_block_bwd as fbb
from bayer_low_light_image_enhancement_tpu_torch.kernels import weight_grad as wg

torch.set_num_threads(2)


def jax_block(c, heads, seed):
    """JAX TransformerBlock numpy params with non-trivial LN affines and
    temperatures."""
    p = JaxBlock(num_heads=heads).init(jax.random.PRNGKey(seed), jnp.zeros((1, 8, 8, c)))["params"]
    p = jax.tree.map(np.asarray, p)
    g = np.random.default_rng(seed)
    for n in ("norm1", "norm2"):
        p[n] = {k: v + g.uniform(-0.3, 0.3, v.shape).astype(np.float32) for k, v in p[n].items()}
    p["attn"]["temperature"] = p["attn"]["temperature"] + g.uniform(-0.5, 0.5, heads).astype(
        np.float32)
    return p


def backward_inputs(shape, heads, seed):
    """Folded weights, x, dy, apply and the finalize backward's d_gram,
    d_qss, d_kss for B2, all fp32 from numpy."""
    w = fb.fold_block_params(transformer_block_state_dict(jax_block(shape[-1], heads, seed)))
    g = np.random.default_rng(seed)
    x, dy = (torch.from_numpy(g.standard_normal(shape).astype(np.float32)) for _ in "xy")
    gram, qss, kss = fb.gram_pass_plain(x, w)
    apply = fb.finalize_attention(gram, qss, kss, w.temperature, w.wproj, heads)
    return w, x, dy, apply, (gram, qss, kss)


def test_regime_by_width():
    """Below SPLIT_MIN_WIDTH the weight grads stay on chip; from it on they
    go through the weight-grad pass."""
    assert fbb.SPLIT_MIN_WIDTH == 96
    assert [fbb.weight_grad_regime(c) for c in fb.KERNEL_WIDTHS] == ["on chip"] * 3 + ["split"] * 4


PLAN_CASES = [
    [(8, 1024, 256, 256), (1, 8192, 256, 512), (1, 8192, 512, 256)],  # B1 at [8,32,32,256]
    [(8, 4096, 128, 128), (1, 32768, 128, 256), (1, 32768, 256, 128)],  # B1 at [8,64,64,128]
    [(1, 32768, 128, 384)],  # B2 at [8,64,64,128]
    [(1, 8192, 256, 768)],  # B2 at [8,32,32,256]
    [(16, 4096, 128, 128), (1, 65536, 128, 256), (1, 65536, 256, 128)],  # B1, batch 16
    [(2, 91, 96, 96), (1, 182, 96, 192), (1, 182, 192, 96)],  # ragged K, M and N of 96
    [(3, 1000, 8, 96), (1, 4099, 192, 384), (2, 700, 384, 8), (1, 5000, 96, 768)],  # 4 products
    [(1, 1, 8, 8)],
]

# The clusters of 1, 2, 4 and 8 CTAs an H100 holds at once with one CTA an
# SM (132 SMs; an 8-CTA cluster needs 8 free SMs of one GPC); the card's own
# come from the occupancy API (tests/test_torch_cuda.py holds them there).
H100_CLUSTERS = {1: 132, 2: 66, 4: 33, 8: 16}


def h100(tn, cluster):
    return H100_CLUSTERS[cluster]


def pixels_of(shape, sp, cluster):
    """Each cluster's slices of one tile: [(k0, k1) per rank] per cluster."""
    _, k, _, _ = shape
    bounds = [wg.slice_bounds(k, sp.slices, s) for s in range(sp.slices)]
    return [bounds[c:c + cluster] for c in range(0, sp.slices, cluster)]


@pytest.mark.parametrize("shapes", PLAN_CASES)
def test_weight_grad_plan_covers_every_pixel_once(shapes):
    """Each product's K slices tile [0, K) exactly (whole 64-pixel stages,
    the last slice ragged, none empty); partials and CTAs are laid out back
    to back; the plan depends on the shapes and the residency alone."""
    p = wg.plan(shapes, h100)
    first = off = 0
    for (g, k, m, n), sp in zip(shapes, p.splits):
        edges = [wg.slice_bounds(k, sp.slices, s) for s in range(sp.slices)]
        assert edges[0][0] == 0 and edges[-1][1] == k
        assert all(k0 < k1 and k0 % wg.K_STEP == 0 for k0, k1 in edges)
        assert all(a[1] == b[0] for a, b in zip(edges, edges[1:]))
        assert sp.tiles == g * -(-m // wg.TILE_M) * -(-n // p.tn)
        assert sp.blocks == sp.tiles * sp.slices
        assert (sp.first_block, sp.ws_offset) == (first, off)
        first += sp.blocks
        off += g * (sp.slices // p.cluster) * m * n if sp.slices > p.cluster else 0
    assert (p.ws_floats, p.blocks) == (off, first) and wg.plan(shapes, h100) == p


@pytest.mark.parametrize("shapes", PLAN_CASES)
def test_weight_grad_plan_clusters_hold_contiguous_slices(shapes):
    """A cluster is `cluster` consecutive CTAs of one tile holding
    consecutive slices in rank order (the order of the on-chip sum); every
    product's CTAs start on a cluster boundary; the launch is one wave."""
    p = wg.plan(shapes, h100)
    assert p.cluster in wg.CLUSTERS and p.blocks % p.cluster == 0
    units = sum(sp.tiles for sp in p.splits)
    assert units > h100(p.tn, p.cluster) or p.blocks <= p.cluster * h100(p.tn, p.cluster)
    for shape, sp in zip(shapes, p.splits):
        assert sp.slices % p.cluster == 0 and sp.first_block % p.cluster == 0
        clusters = pixels_of(shape, sp, p.cluster)
        assert len(clusters) == sp.slices // p.cluster
        for ranks in clusters:
            assert len(ranks) == p.cluster
            assert all(a[1] == b[0] for a, b in zip(ranks, ranks[1:]))
        assert [c[0][0] for c in clusters] == sorted(c[0][0] for c in clusters)


@pytest.mark.parametrize("shapes", PLAN_CASES)
def test_weight_grad_workspace_matches_the_kernel_layout(shapes):
    """The workspace holds [G, slices / cluster, M, N] floats for each
    product whose K takes more than one cluster, back to back (what
    blle_weight_grad_workspace_floats counts and the kernel indexes), 16-byte
    aligned, and an arrival counter per (tile, rank); a product one cluster
    covers writes its output directly and needs neither."""
    p = wg.plan(shapes, h100)
    want, off, counters, count_off = 0, [], 0, []
    for (g, k, m, n), sp in zip(shapes, p.splits):
        off.append(want)
        count_off.append(counters)
        if sp.slices > p.cluster:
            want += g * (sp.slices // p.cluster) * m * n
            counters += sp.tiles * p.cluster  # one per (tile, rank)
    assert p.ws_floats == want and [sp.ws_offset for sp in p.splits] == off
    assert p.counters == counters and [sp.count_offset for sp in p.splits] == count_off
    assert all(o % 4 == 0 for o in off)


@pytest.mark.parametrize("mn", [8, 96, 192, 384, 768])
def test_weight_grad_tile_width(mn):
    """The output tile is as narrow as covers N in the fewest 256-wide
    passes: 8 -> 64, 96 -> 128, 192 -> 192, 384 -> 2 x 192, 768 -> 3 x
    256; a launch takes the widest of its products'."""
    want = {8: 64, 96: 128, 192: 192, 384: 192, 768: 256}[mn]
    assert wg.tile_n([(1, 640, 64, mn)]) == want
    assert wg.tile_n([(1, 640, 64, mn), (1, 640, 64, 8)]) == want
    assert wg.tile_n([(1, 640, mn, 8)]) == 64
    p = wg.plan([(2, 700, mn, mn)], h100)
    assert p.splits[0].tiles == 2 * -(-mn // wg.TILE_M) * -(-mn // want)


@pytest.mark.parametrize("products", [1, 2, 3, 4])
def test_weight_grad_plan_takes_one_to_four_products(products):
    """1-4 products share a launch; a fifth is refused; a product's split
    does not depend on the products after it when the wave has room."""
    shapes = [(1, 777 * (i + 1), 8 * (i + 1), 96) for i in range(products)]
    p = wg.plan(shapes, h100)
    assert len(p.splits) == products
    assert p.blocks == sum(sp.blocks for sp in p.splits)
    with pytest.raises(ValueError):
        wg.plan(shapes + [(1, 64, 8, 8)] * (5 - products), h100)
    with pytest.raises(ValueError):
        wg.layout(shapes, p.tn, p.cluster, [sp.slices + 1 for sp in p.splits])


def test_weight_grad_plan_shrinks_clusters_to_the_wave():
    """A cluster needs one per tile within a wave: with more tiles than
    8-CTA clusters fit, the plan takes 4-CTA clusters, then 2, then 1; K
    shorter than a cluster's slices takes smaller clusters too."""
    assert wg.plan([(1, 8192, 256, 768)], h100).cluster == 8
    assert wg.plan([(8, 1024, 256, 256)], h100).cluster == 8
    assert wg.plan([(20, 1024, 256, 256)], h100).cluster == 2
    assert wg.plan([(200, 1024, 128, 128)], h100).cluster == 1
    assert wg.plan([(1, 130, 128, 128)], h100).cluster == 2


@pytest.mark.parametrize("shapes", PLAN_CASES[5:])
def test_weight_grad_split_sums_match_the_product(shapes):
    """The kernel's arithmetic, slice by slice in the plan's order (in fp64,
    so that only the partition is tested): each cluster's ranks summed in
    order, then the clusters in order, give the whole product."""
    gen = torch.Generator().manual_seed(len(shapes))
    p = wg.plan(shapes, h100)
    for (g, k, m, n), sp in zip(shapes, p.splits):
        a, b = (torch.randn(g, k, w, generator=gen, dtype=torch.float64) for w in (m, n))
        parts = [sum(torch.einsum("gkm,gkn->gmn", a[:, k0:k1], b[:, k0:k1]) for k0, k1 in ranks)
                 for ranks in pixels_of((g, k, m, n), sp, p.cluster)]
        torch.testing.assert_close(sum(parts), torch.einsum("gkm,gkn->gmn", a, b),
                                   rtol=1e-10, atol=1e-9)


def test_weight_grad_wrapper_runs_twin_on_cpu():
    gen = torch.Generator().manual_seed(3)
    pairs = [(torch.randn(2, 50, 16, generator=gen), torch.randn(2, 50, 24, generator=gen)),
             (torch.randn(1, 70, 8, generator=gen), torch.randn(1, 70, 32, generator=gen))]
    before = wg.weight_grad.launches
    got = wg.weight_grad(pairs)
    outs = [torch.empty(2, 16, 24), torch.empty(1, 8, 32)]
    assert wg.weight_grad(pairs, outs) == outs
    for o, r, (a, b) in zip(outs, got, pairs):
        want = torch.einsum("gkm,gkn->gmn", a, b)
        torch.testing.assert_close(r, want)
        assert torch.equal(o, r)
    assert wg.weight_grad.launches == before


@pytest.mark.parametrize("shape,heads", [((2, 9, 7, 16), 4), ((1, 11, 13, 32), 8)])
def test_bwd1_operands_give_the_twins_products(shape, heads):
    """B1's per-pixel operands (v, LN2(y), dt, GELU(f_pre), dx2) contracted
    as bwd1_product_pairs lays them out give bwd1_plain's d_apply, wp1 and
    wp2 grads (and its dx2)."""
    w, x, dy, apply, _ = backward_inputs(shape, heads, seed=shape[1])
    dx2, d_apply, g = fbb.bwd1_plain(x, dy, apply, w)
    ops = fbb.bwd1_operands_plain(x, dy, apply, w)
    c = shape[-1]
    assert {k: v.shape[-1] for k, v in ops.items()} == dict(v=c, yh=c, dt=2 * c, g=2 * c, dx2=c)
    torch.testing.assert_close(ops["dx2"], dx2, rtol=1e-5, atol=1e-5)
    pairs = fbb.bwd1_product_pairs(ops["v"], ops["dx2"], ops["yh"], ops["dt"], ops["g"], dy)
    da, wp1, wp2 = wg.weight_grad_plain(pairs)
    torch.testing.assert_close(da, d_apply, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(wp1[0], g["wp1"], rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(wp2[0], g["wp2"], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("shape,heads", [((2, 9, 7, 16), 4), ((1, 11, 13, 32), 8)])
def test_bwd2_operands_give_the_twins_products(shape, heads):
    """B2's per-pixel operands (LN1(x), [dz_q|dz_k|dz_v]) contracted as
    bwd2_product_pairs lays them out give bwd2_plain's wqk and wv grads."""
    w, x, dy, apply, (gram, qss, kss) = backward_inputs(shape, heads, seed=shape[2])
    dx2, d_apply, _ = fbb.bwd1_plain(x, dy, apply, w)
    d = fbb.finalize_backward(gram, qss, kss, w.temperature, w.wproj, d_apply, heads)
    _, g = fbb.bwd2_plain(x, dx2, apply, *d[:3], w)
    ops = fbb.bwd2_operands_plain(x, dx2, apply, *d[:3], w)
    c = shape[-1]
    assert (ops["xh"].shape[-1], ops["dz"].shape[-1]) == (c, 3 * c)
    (dw,) = wg.weight_grad_plain(fbb.bwd2_product_pairs(ops["xh"], ops["dz"]))
    torch.testing.assert_close(dw[0, :, : 2 * c], g["wqk"], rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(dw[0, :, 2 * c:], g["wv"], rtol=1e-4, atol=1e-4)


def bwd1_split(x, dy, apply, w):
    """B1 as the split regime computes it: d_apply, wp1, wp2 from the
    operands (the rest from the twin)."""
    _, _, g = fbb.bwd1_plain(x, dy, apply, w)
    ops = fbb.bwd1_operands_plain(x, dy, apply, w)
    da, wp1, wp2 = wg.weight_grad_plain(
        fbb.bwd1_product_pairs(ops["v"], ops["dx2"], ops["yh"], ops["dt"], ops["g"], dy.float()))
    return ops["dx2"].to(x.dtype), da, {**g, "wp1": wp1[0], "wp2": wp2[0]}


def bwd2_split(x, dx2, apply, d_gram, d_qss, d_kss, w):
    dx, g = fbb.bwd2_plain(x, dx2, apply, d_gram, d_qss, d_kss, w)
    ops = fbb.bwd2_operands_plain(x, dx2, apply, d_gram, d_qss, d_kss, w)
    (dw,) = wg.weight_grad_plain(fbb.bwd2_product_pairs(ops["xh"], ops["dz"]))
    c = x.shape[-1]
    return dx.to(x.dtype), {**g, "wqk": dw[0, :, : 2 * c], "wv": dw[0, :, 2 * c:]}


def test_split_route_matches_jax_pallas_backward_interpret(monkeypatch):
    """The block backward with B1/B2 as the split regime computes them
    (operands, then the products) against the JAX Pallas backward (bf16,
    interpret mode): each leaf within max(3 x the JAX bf16 block's error,
    2e-2) of the split route's (the yardstick of tests/test_fused_bwd.py)."""
    heads, shape = 8, (4, 9, 10, 64)
    p = jax_block(64, heads, seed=6)
    m16 = JaxBlock(num_heads=heads, dtype=jnp.bfloat16)
    g = np.random.default_rng(6)
    x, dy = (g.standard_normal(shape).astype(np.float32) for _ in "xy")
    xb = jnp.asarray(x, jnp.bfloat16)

    def jax_grads(fn):
        loss = lambda pp, xx: jnp.sum(fn(pp, xx).astype(jnp.float32) * dy)  # noqa: E731
        gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(jax.tree.map(jnp.asarray, p), xb)
        return ({k: v.numpy() for k, v in transformer_block_state_dict(
            jax.tree.map(np.asarray, gp)).items()}, np.asarray(gx, np.float32))

    monkeypatch.setattr(fbb, "bwd1", bwd1_split)
    monkeypatch.setattr(fbb, "bwd2", bwd2_split)
    sd = {k: v.clone().requires_grad_() for k, v in transformer_block_state_dict(p).items()}
    xt = torch.from_numpy(x).requires_grad_()
    (fb.fused_transformer_block(xt, sd, heads) * torch.from_numpy(dy)).sum().backward()
    ref, ref_dx = {k: v.grad.numpy() for k, v in sd.items()}, xt.grad.numpy()
    kern, kern_dx = jax_grads(lambda pp, xx: fused_transformer_block_train(xx, pp, heads, 8))
    noisy, noisy_dx = jax_grads(lambda pp, xx: m16.apply({"params": pp}, xx))

    def rel(a, r):
        return np.abs(a - r).max() / (np.abs(r).max() + 1e-8)

    for name in ref:
        ek, e16 = rel(kern[name], ref[name]), rel(noisy[name], ref[name])
        assert ek <= max(3 * e16, 2e-2), (name, ek, e16)
    assert rel(kern_dx, ref_dx) <= max(3 * rel(noisy_dx, ref_dx), 2e-2)


def test_time_trees_refuses_without_a_card(monkeypatch, capsys):
    """The tool that times B1/B2 and the train step for several checkouts
    (utils/time_trees.py) exits 2 where nvidia-smi finds no card."""
    from bayer_low_light_image_enhancement_tpu_torch.utils import time_trees

    def no_smi(*args, **kwargs):
        raise FileNotFoundError("nvidia-smi")

    monkeypatch.setattr(time_trees.subprocess, "run", no_smi)
    assert time_trees.main([".", "--what", "bwd"]) == 2
    assert "needs a CUDA card" in capsys.readouterr().err
