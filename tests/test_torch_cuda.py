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


@pytest.mark.parametrize("c", fb.KERNEL_WIDTHS)
def test_backward_kernels_match_twins(cuda, c):
    """B1 and B2 against their fp32 twins on ragged tiles, each leaf within
    max(3 x the bf16 twin's error, 2e-2) of the fp32 twin."""
    gen = torch.Generator().manual_seed(c + 1)
    blk = common.TransformerBlock(c, 8, 2, device=cuda)
    common.reset_parameters_(blk, gen)
    with torch.no_grad():
        for name, p in blk.named_parameters():
            if "norm" in name or "temperature" in name:
                p.add_(torch.empty(p.shape).uniform_(-0.3, 0.3, generator=gen).to(cuda))
    wts = fb.fold_block_params({k: v.detach() for k, v in blk.named_parameters()})
    x = torch.randn(2, 19, 13, c, generator=gen).to(cuda, torch.bfloat16)
    dy = (0.1 * torch.randn(2, 19, 13, c, generator=gen)).to(cuda, torch.bfloat16)
    before = (fbb.bwd1.launches, fbb.bwd2.launches)
    got = backward_leaves(x, dy, wts, 8, kernel_run)
    assert (fbb.bwd1.launches, fbb.bwd2.launches) == (before[0] + 1, before[1] + 1)
    errs = yardstick_errors(got, backward_leaves(x, dy, wts, 8, twin_run),
                            backward_leaves(x, dy, wts, 8, bf16_twin_run))
    bad = {n: e for n, e in errs.items() if not e[0] <= max(3 * e[1], 2e-2)}
    assert not bad, bad


def scan_inputs(b, L, d, n, dtype, seed):
    g = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(g.standard_normal(s).astype(np.float32))  # noqa: E731
    u, B, C = 0.5 * f(b, L, d), 0.5 * f(b, L, n), 0.5 * f(b, L, n)
    dt = torch.from_numpy(g.uniform(0.02, 0.6, (b, L, d)).astype(np.float32))
    A = -torch.from_numpy(g.uniform(0.2, 2.0, (d, n)).astype(np.float32))
    D, dy = 0.3 * f(d), f(b, L, d)
    return [t.to(dtype) for t in (u, dt)] + [A] + [t.to(dtype) for t in (B, C)] + [D, dy.to(dtype)]


# Ragged shapes: L not a multiple of the 128-step chunk or the 32-step
# sub-chunk, D not a multiple of the 8-channel block, N below 32; the forced
# d-groups make a warp walk two channels and leave some warps without one.
SCAN_CASES = [((2, 300, 20, 32), None), ((1, 77, 13, 8), None), ((3, 1000, 40, 32), 16),
              ((2, 515, 96, 32), 96)]


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
        monkeypatch.setattr(ks, "bwd_dgroup", lambda *a: dgroup)
    *args, dy = [t.to(cuda) for t in scan_inputs(*shape, dtype, seed=sum(shape))]
    before = (ks.selective_scan_fwd.launches, ks.selective_scan_bwd.launches)
    y = ks.selective_scan_fwd(*args)
    y2, states = ks.selective_scan_fwd(*args, save_states=True)
    grads = ks.selective_scan_bwd(*args, dy, states)
    torch.cuda.synchronize()
    assert (ks.selective_scan_fwd.launches, ks.selective_scan_bwd.launches) == (
        before[0] + 2, before[1] + 1)
    assert torch.equal(y, y2) and y.dtype == dtype
    y_ref, st_ref = ssm.selective_scan(*args, chunk_size=ks.FWD_CHUNK, state_every=ks.STATE_EVERY)
    y_ref = ssm.selective_scan(*[t.float() for t in args])
    scale = y_ref.abs().max().item()
    if dtype == torch.float32:
        assert (y - y_ref).abs().max().item() <= 1e-4 * scale
    else:
        assert bool(((y.float() - y_ref).abs() <= 8e-3 * y_ref.abs() + 1e-3 * scale).all())
    assert (states - st_ref).abs().max().item() <= 1e-4 * st_ref.abs().max().item()
    want = ssm.selective_scan_bwd_ref(*args, dy)
    for name, got, ref in zip(("du", "ddt", "dA", "dB", "dC", "dD"), grads, want):
        assert got.dtype == torch.float32 and got.shape == ref.shape, name
        err = (got - ref).abs().max().item() / ref.abs().max().item()
        assert err <= 1e-3, (name, err)


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


def test_train_step_kernel_path_matches_twin_path(cuda, monkeypatch):
    """Two bf16 train steps (the first at the warmup's lr 0) of a dim-32
    RawFormer through K2/K3 + B1/B2 against the same steps with the blocks
    on their fp32 twins: loss within 2e-2 relative, params within 5e-4 (the
    bar of tests/test_fused_bwd.py's trainer test)."""
    from bayer_low_light_image_enhancement_tpu_torch.train import TrainConfig, Trainer

    g = np.random.default_rng(4)
    batch = (torch.from_numpy(g.uniform(0, 2, (2, 64, 64, 1)).astype(np.float32)).to(cuda),
             torch.from_numpy(g.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)).to(cuda))
    cfg = TrainConfig(warmup_epochs=1, steps_per_epoch=1)
    runs = []
    for twin in (False, True):
        if twin:
            monkeypatch.setattr(common, "fused_transformer_block", fb.fused_transformer_block_plain)
        model = RawFormer(RawFormerConfig(dim=32, dtype=torch.bfloat16), device=cuda,
                          generator=torch.Generator().manual_seed(0))
        trainer = Trainer(model, cfg)
        before = [f.launches for f in (fb.gram_pass, fb.apply_pass, fbb.bwd1, fbb.bwd2)]
        losses = [float(trainer.train_step(batch)) for _ in range(2)]
        launched = [f.launches - b for f, b in
                    zip((fb.gram_pass, fb.apply_pass, fbb.bwd1, fbb.bwd2), before)]
        assert launched == ([0] * 4 if twin else [14] * 4)
        runs.append((losses, torch.cat([p.detach().flatten() for p in model.parameters()])))
    (lk, pk), (lt, pt) = runs
    np.testing.assert_allclose(lk, lt, rtol=2e-2)
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
    step; loss within 2e-2 relative, params within 5e-4, BN running stats
    within 1e-2 of their max."""
    from bayer_low_light_image_enhancement_tpu_torch.kernels import ssm_scan as ks
    from bayer_low_light_image_enhancement_tpu_torch.models import RawFormerWFB, RawFormerWFBConfig
    from bayer_low_light_image_enhancement_tpu_torch.train import TrainConfig, Trainer

    g = np.random.default_rng(7)
    batch = (torch.from_numpy(g.uniform(0, 2, (2, 64, 64, 1)).astype(np.float32)).to(cuda),
             torch.from_numpy(g.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)).to(cuda))
    runs = []
    for fused in (True, False):
        model = RawFormerWFB(RawFormerWFBConfig(dim=16, dtype=torch.bfloat16), device=cuda,
                             generator=torch.Generator().manual_seed(0))
        trainer = Trainer(model, TrainConfig(warmup_epochs=1, steps_per_epoch=1,
                                             fused_blocks=fused))
        before = (ks.selective_scan_fwd.launches, ks.selective_scan_bwd.launches)
        losses = [float(trainer.train_step(batch)) for _ in range(2)]
        launched = (ks.selective_scan_fwd.launches - before[0],
                    ks.selective_scan_bwd.launches - before[1])
        assert launched == ((14, 14) if fused else (0, 0))
        runs.append((losses, model.state_dict()))
    (lk, sk), (lt, st) = runs
    np.testing.assert_allclose(lk, lt, rtol=2e-2)
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
