"""The plans of K2, K3, K3P and A1 (``kernels/fused_block.tile_config`` /
``block_plan``, the mirror of ``csrc/block_tiles.cuh`` and
``csrc/apply_pipelined.cuh``) on the CPU: shared
memory within an H100 block, tiles that cover the image, every tile walked
by exactly one CTA, and the gram workspace formula. The card tests hold the
same plans against the C library (``test_block_plans_match_the_library``)."""

import pytest

from bayer_low_light_image_enhancement_tpu_torch.kernels import fused_block as fb

SHAPES = [(1, 3, 5), (1, 40, 7), (2, 19, 13), (8, 32, 32), (8, 256, 256), (1, 177, 265),
          (1, 1416, 2120), (3, 11, 29)]
H100_SMS = 132


def cdiv(a, b):
    return -(-a // b)


def tile_runs(total, ctas):
    """The run of tiles [first, last) each CTA walks: the kernels' split of
    ``total`` tiles over ``ctas`` (``first = total * i / ctas``)."""
    return [(total * i // ctas, total * (i + 1) // ctas) for i in range(ctas)]


@pytest.mark.parametrize("c", fb.KERNEL_WIDTHS)
@pytest.mark.parametrize("kind", fb.BLOCK_KINDS)
def test_tile_configs_fit_an_h100_block(kind, c):
    """Shared memory <= 232,448 bytes; 256 threads exactly where two CTAs
    fit an SM (16 warps per SM either way); tiles of whole m16 rows."""
    cfg = fb.tile_config(kind, c)
    assert cfg.smem <= fb.SMEM_PER_BLOCK
    assert cfg.threads == (256 if 2 * (cfg.smem + 1024) <= fb.SMEM_PER_SM else 512)
    assert (cfg.th * cfg.tw) % 16 == 0
    assert c % cfg.splits == 0 and (c // cfg.splits) % 16 == 0
    if kind in ("apply1", "apply2"):
        assert cfg.splits == 1


def test_gram_and_attention_gram_share_a_plan():
    for c in fb.KERNEL_WIDTHS:
        assert fb.tile_config("gram", c) == fb.tile_config("attn_gram", c)


def test_attention_apply_has_the_plan_of_k3_phase_one():
    """A1's apply pass is K3's first kernel without LN1: the same tile,
    threads and shared memory, and the same plan at every shape."""
    for c in fb.KERNEL_WIDTHS:
        assert fb.tile_config("attn_apply", c) == fb.tile_config("apply1", c)
        for b, h, w in SHAPES:
            for resident in (1, 3, H100_SMS, 2 * H100_SMS):
                assert fb.block_plan("attn_apply", b, h, w, c, resident) == \
                    fb.block_plan("apply1", b, h, w, c, resident)


def test_tile_configs_reject_unknown_kinds_and_widths():
    with pytest.raises(ValueError, match="kind"):
        fb.tile_config("bwd", 32)
    with pytest.raises(ValueError, match="no kernel"):
        fb.tile_config("gram", 16)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("kind", ["gram", "apply1", "apply2", "attn_apply"])
def test_plans_cover_the_image_once(kind, shape):
    """At every width and at one and two CTAs per SM: the tiles cover H and
    W with less than one tile to spare, the CTAs' runs partition the tiles
    they walk (per image and channel block in K2, over the call in K3) in
    order, and no CTA is idle."""
    b, h, w = shape
    for c in fb.KERNEL_WIDTHS:
        for per_sm in (1, 2):
            plan = fb.block_plan(kind, b, h, w, c, per_sm * H100_SMS)
            cfg = plan.config
            th, tw = cdiv(h, cfg.th), cdiv(w, cfg.tw)
            assert plan.tiles == th * tw
            assert th * cfg.th >= h > (th - 1) * cfg.th and tw * cfg.tw >= w > (tw - 1) * cfg.tw
            walked = plan.tiles if kind == "gram" else b * plan.tiles
            assert 1 <= plan.ctas <= walked
            runs = tile_runs(walked, plan.ctas)
            assert runs[0][0] == 0 and runs[-1][1] == walked
            assert all(r0 < r1 for r0, r1 in runs)
            assert all(a[1] == b_[0] for a, b_ in zip(runs, runs[1:]))
            if kind == "gram":
                assert plan.blocks == cfg.splits ** 2 and plan.launches == 2
                assert plan.ctas * b * plan.blocks <= max(per_sm * H100_SMS, b * plan.blocks)
            else:
                assert plan.blocks == 1 and plan.launches == 1
                assert plan.ctas == min(walked, per_sm * H100_SMS)


@pytest.mark.parametrize("c", fb.KERNEL_WIDTHS)
def test_gram_workspace_formula(c):
    """One partial per CTA: the [cb, cb] gram block and 2 cb sums, for each
    of the b x splits^2 (image, channel block) pairs."""
    for b, h, w in SHAPES:
        plan = fb.block_plan("gram", b, h, w, c, H100_SMS)
        cb = c // plan.config.splits
        assert fb.gram_workspace_floats(b, h, w, c, plan) == \
            b * plan.blocks * plan.ctas * (cb * cb + 2 * cb)
        # The partials of all blocks hold exactly the [C, C] gram and 2 C
        # sums once per CTA index (q sums of the bi blocks, k sums of bj).
        assert plan.blocks * cb * cb == c * c


def test_gram_plan_regimes():
    """Few resident CTAs: one CTA per (image, block) walks every tile; many:
    one CTA per tile; the deep widths split the gram into 2 x 2 blocks."""
    assert fb.block_plan("gram", 8, 256, 256, 32, 1).ctas == 1
    big = fb.block_plan("gram", 1, 30, 30, 64, 10 ** 6)
    assert big.ctas == big.tiles
    assert fb.block_plan("gram", 8, 32, 32, 256, H100_SMS).blocks == 4
    assert fb.block_plan("gram", 8, 32, 32, 128, H100_SMS).blocks == 1


@pytest.mark.parametrize("c", fb.PIPELINED_WIDTHS)
def test_pipelined_configs_fit_an_h100_block(c):
    """K3P: both phases' buffers in one block's 232,448 bytes, so one CTA an
    SM of 512 threads (two groups of 8 warps); tiles of whole m16 rows, the
    own pixels of K3's tiles or fewer."""
    cfg = fb.tile_config(fb.PIPE, c)
    assert cfg.smem <= fb.SMEM_PER_BLOCK < 2 * (cfg.smem + 1024)
    assert cfg.threads == 512 and cfg.splits == 1
    assert (cfg.th * cfg.tw) % 16 == 0
    k3 = fb.tile_config("apply1", c)
    assert cfg.th * cfg.tw <= k3.th * k3.tw


@pytest.mark.parametrize("c", [16, 48, 96, 192, 512])
def test_pipelined_configs_refuse_other_widths(c):
    with pytest.raises(ValueError, match="no K3P"):
        fb.tile_config(fb.PIPE, c)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("c", fb.PIPELINED_WIDTHS)
def test_pipelined_plans_cover_the_image_once(c, shape):
    """K3P's tiles cover H and W with less than one tile to spare; its CTAs
    (at most one a tile, at most the resident ones) walk runs that partition
    the call's tiles in order, none idle."""
    b, h, w = shape
    for resident in (1, 3, H100_SMS):
        plan = fb.block_plan(fb.PIPE, b, h, w, c, resident)
        cfg = plan.config
        th, tw = cdiv(h, cfg.th), cdiv(w, cfg.tw)
        assert plan.tiles == th * tw and (plan.blocks, plan.launches) == (1, 1)
        assert th * cfg.th >= h > (th - 1) * cfg.th and tw * cfg.tw >= w > (tw - 1) * cfg.tw
        walked = b * plan.tiles
        assert plan.ctas == min(walked, resident)
        runs = tile_runs(walked, plan.ctas)
        assert runs[0][0] == 0 and runs[-1][1] == walked
        assert all(r0 < r1 for r0, r1 in runs)
        assert all(a[1] == b_[0] for a, b_ in zip(runs, runs[1:]))
