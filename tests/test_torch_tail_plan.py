"""The launch plans of T1 (``kernels/fused_stage.tail_config`` /
``tail_plan``, the mirror of ``TailCfg`` in ``csrc/fused_stage.cu``) and K1
(``kernels/bayer_pack.pack_geometry``, the mirror of ``pack_geometry`` in
``csrc/bayer_pack.cu``) on the CPU. The card tests hold both against the C
library (``test_tail_plans_match_the_library``,
``test_pack_geometry_matches_the_library``)."""

import collections

import pytest

from bayer_low_light_image_enhancement_tpu_torch.kernels import bayer_pack as bp
from bayer_low_light_image_enhancement_tpu_torch.kernels import fused_stage as fs
from bayer_low_light_image_enhancement_tpu_torch.kernels.fused_block import KERNEL_WIDTHS

H100_SMS = 132


@pytest.mark.parametrize("c", KERNEL_WIDTHS)
@pytest.mark.parametrize("kind", fs.TAIL_KINDS)
def test_tail_configs_fit_an_h100_block(kind, c):
    """Shared memory <= 227 KB (232,448 bytes), tiles of at least 128 output
    pixels (whole 16-pixel rows: an m16 tile is one tile row), every weight
    resident at C <= 64 and streamed in whole-tap chunks above, two CTAs an
    SM exactly where their shared memory fits."""
    cfg = fs.tail_config(kind, c)
    assert cfg.smem <= fs.SMEM_PER_BLOCK
    assert cfg.th * cfg.tw >= 128 and cfg.tw == 16 and cfg.threads == 256
    assert cfg.resident == (c <= 64)
    if cfg.resident:
        assert cfg.slots == 0 and cfg.kc == c
    else:
        assert cfg.slots in (2, 3) and c % cfg.kc == 0 and cfg.kc % 16 == 0
    assert cfg.per_sm == (2 if 2 * (cfg.smem + 1024) <= fs.SMEM_PER_SM else 1)
    assert cfg.windows in (1, 2) and not (cfg.vx and cfg.windows == 2)
    assert cfg.vx == (kind == "conv" and c == 256)
    assert cfg.wgmma == (c in (128, 192, 256))
    if cfg.wgmma:  # whole 64-column swizzle atoms; 1 KB of slack aligns the slots
        assert cfg.kc == 64 and cfg.slots * cfg.kc * c * 2 + 1024 + 64 < cfg.smem


@pytest.mark.parametrize("c", KERNEL_WIDTHS)
def test_tail_weight_bytes_per_output_pixel(c):
    """Each tile reads every weight from L2 once: 20 C^2 bf16 bytes over 128
    output pixels (22 C^2 with the reduce's, over both kernels), where the
    first port read 3.7-336 KB an output pixel."""
    conv, out = fs.tail_config("conv", c), fs.tail_config("out", c)
    per_pixel = (11 + 9) * c * c * 2 / (conv.th * conv.tw)
    assert per_pixel <= 20 * 256 * 256 * 2 / 128
    assert conv.th * conv.tw == out.th * out.tw == 128


def test_tail_configs_reject_unknown_kinds_and_widths():
    with pytest.raises(ValueError, match="kind"):
        fs.tail_config("reduce", 32)
    with pytest.raises(ValueError, match="no kernel"):
        fs.tail_config("conv", 16)


@pytest.mark.parametrize("shape", [(1, 1, 1), (1, 1, 37), (1, 5, 9), (2, 19, 13), (8, 32, 32),
                                   (1, 177, 265), (1, 1416, 2120)])
def test_tail_plans_cover_the_call(shape):
    """The tiles cover H and W with less than one tile to spare; each
    kernel's persistent CTAs are at most one a tile and as many as are
    resident."""
    b, h, w = shape
    for c in KERNEL_WIDTHS:
        for per_sm in (1, 2):
            plan = fs.tail_plan(b, h, w, c, per_sm * H100_SMS, 2 * H100_SMS)
            th, tw = -(-h // 8), -(-w // 16)
            assert plan.tiles == b * th * tw
            assert th * 8 >= h > (th - 1) * 8 and tw * 16 >= w > (tw - 1) * 16
            assert plan.ctas_conv == min(plan.tiles, per_sm * H100_SMS)
            assert plan.ctas_out == min(plan.tiles, 2 * H100_SMS)
            assert 1 <= plan.ctas_conv <= plan.tiles


def pack_cover(b, h, w):
    """How often K1's geometry writes each packed row and each packed pixel
    of a row (the grid as Cartesian product of its row and column maps)."""
    geo = bp.pack_geometry(b, h, w)
    rows = collections.Counter(r for by in range(geo.gy) for y in range(geo.ty)
                               for r in bp.pack_rows(geo, by, y))
    pixels = collections.Counter(p for bx in range(geo.gx) for x in range(geo.tx)
                                 for g in bp.pack_groups(geo, bx, x)
                                 for p in range(4 * g, min(4 * g + 4, w // 2)))
    return geo, rows, pixels


@pytest.mark.parametrize("shape", [(2, 6, 20), (1, 10, 2), (3, 4, 2), (1, 2, 1042), (8, 512, 512),
                                   (1, 2832, 4240), (2, 8, 8200), (70000, 8, 2), (40000, 10, 36)])
def test_pack_geometry_covers_every_packed_pixel_once(shape):
    """At W % 8 != 0, W = 2, rows beyond the grid's 65535 blocks (the
    grid-stride loop) and wide rows (several column blocks): every packed
    row and every packed pixel of a row is written exactly once."""
    b, h, w = shape
    geo, rows, pixels = pack_cover(b, h, w)
    assert geo.rows == b * (h // 2) and geo.groups == -(-(w // 2) // 4)
    assert set(rows) == set(range(geo.rows)) and set(rows.values()) == {1}
    assert set(pixels) == set(range(w // 2)) and set(pixels.values()) == {1}
    assert geo.tx % 32 == 0 and geo.tx <= bp.MAX_TX and geo.tx * geo.ty <= bp.MAX_TX
    assert 1 <= geo.gy <= bp.MAX_GRID_Y
    if geo.rows > bp.MAX_GRID_Y * geo.ty:
        assert geo.gy == bp.MAX_GRID_Y


def test_pack_geometry_keeps_blocks_busy():
    """A row takes one block of up to 512 threads, 2 groups each; narrow rows
    stack into 128-thread blocks; at most one warp of a row block idles."""
    for w in (2, 64, 512, 1042, 4240, 8200):
        geo = bp.pack_geometry(1, 2, w)
        need = max(1, -(-geo.groups // bp.GROUPS_PER_THREAD))
        assert geo.gx * geo.tx - need < 32 * geo.gx
        assert geo.tx * geo.ty == (geo.tx if geo.tx >= bp.BLOCK_THREADS
                                   else bp.BLOCK_THREADS // geo.tx * geo.tx)
    dims = lambda g: (g.tx, g.ty, g.gx, g.gy)  # noqa: E731
    assert dims(bp.pack_geometry(8, 512, 512)) == (32, 4, 1, 512)
    assert dims(bp.pack_geometry(1, 2832, 4240)) == (288, 1, 1, 1416)


def tail_stage(c, seed):
    import torch

    from bayer_low_light_image_enhancement_tpu_torch.models import common

    stage = common.ConvTransformer(c, 4, 2)
    common.reset_parameters_(stage, torch.Generator().manual_seed(seed))
    return stage, {k: v.detach() for k, v in stage.state_dict().items()
                   if not k.startswith("Transformer.")}


def test_module_tail_is_the_twins_function():
    """fused_stage.module_tail (the library path T1 is timed beside) computes
    the twin's function through the module's own layers."""
    import torch

    stage, sd = tail_stage(16, 0)
    g = torch.Generator().manual_seed(1)
    x, t = torch.randn(2, 9, 11, 16, generator=g), torch.randn(2, 9, 11, 16, generator=g)
    with torch.no_grad():
        got = fs.module_tail(stage, x.permute(0, 3, 1, 2), t.permute(0, 3, 1, 2))
    torch.testing.assert_close(got.permute(0, 2, 3, 1), fs.fused_stage_tail_plain(x, t, sd),
                               rtol=1e-5, atol=1e-5)


def test_kernel_args_are_cached_per_weight_version():
    """T1's bf16 weights are made once per (tensor, _version): a second call
    reuses them, an in-place update remakes them, and they hold the twin's
    weights in the kernel's layout."""
    import torch

    stage, sd = tail_stage(32, 2)
    first = fs._kernel_args(sd)
    assert fs._kernel_args(sd) is first
    w = fs.tail_weights(sd)
    want = [torch.cat([w.wc.reshape(9 * 32, 32), w.wr1, w.wr2]), w.bc, w.br,
            w.wo.reshape(9 * 32, 32), w.bo]
    for got, ref in zip(first, want):
        assert got.is_contiguous() and got.shape == ref.shape
        torch.testing.assert_close(got.float(), ref, rtol=1e-2, atol=1e-2)
    assert [a.dtype for a in first] == [torch.bfloat16, torch.float32, torch.float32,
                                        torch.bfloat16, torch.float32]
    with torch.no_grad():
        sd["conv.weight"].add_(1.0)
    second = fs._kernel_args(sd)
    assert second is not first
    taps = 9 * 32  # conv's tap rows of w1; the reduce rows follow unchanged
    torch.testing.assert_close(second[0][:taps].float(), first[0][:taps].float() + 1.0,
                               rtol=1e-2, atol=1e-2)
    assert torch.equal(second[0][taps:], first[0][taps:])


def test_kernel_args_of_inference_tensors_are_made_every_call():
    """Weights made under torch.inference_mode keep no version counter: T1
    makes their arguments on every call (never a stale cache entry)."""
    import torch

    with torch.inference_mode():
        stage, sd = tail_stage(32, 3)
        first = fs._kernel_args(sd)
        sd["Conv_out.weight"].mul_(-1.0)
        second = fs._kernel_args(sd)
    assert second is not first
    assert torch.equal(second[3], -first[3])
    torch.testing.assert_close(second[3].float(), fs.tail_weights(sd).wo.reshape(9 * 32, 32),
                               rtol=1e-2, atol=1e-2)
