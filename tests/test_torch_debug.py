"""The port's ``utils/debug.py`` and the timing / tracing names of
``utils/profiling.py`` against the JAX package's, on the CPU."""

import glob
import math

import numpy as np
import pytest
import torch

from bayer_low_light_image_enhancement_tpu.utils import debug as jdebug
from bayer_low_light_image_enhancement_tpu.utils import profiling as jprofiling
from bayer_low_light_image_enhancement_tpu_torch.models import RawFormer, RawFormerConfig
from bayer_low_light_image_enhancement_tpu_torch.utils import debug, profiling

from torch_parity import HEADS

RNG = np.random.default_rng(97)


def flat_mapping():
    """Leaves as the JAX functions see them: finite, NaN, +-inf, empty, an
    integer array and a scalar."""
    a = RNG.standard_normal((3, 4)).astype(np.float32)
    nan = a.copy()
    nan[1, 2] = np.nan
    inf = RNG.standard_normal(5).astype(np.float32)
    inf[0], inf[3] = np.inf, -np.inf
    return {"conv.weight": a, "conv.bias": nan, "norm.weight": inf,
            "empty": np.zeros((0, 3), np.float32), "steps": np.arange(4),
            "scale": np.float32(-2.5)}


def test_check_finite_tree_matches_jax():
    tree = flat_mapping()
    assert debug.check_finite_tree(tree, "grads") == jdebug.check_finite_tree(tree, "grads")
    assert debug.check_finite_tree(tree) == ["tree['conv.bias']", "tree['norm.weight']"]
    torch_tree = {k: torch.as_tensor(v) for k, v in tree.items()}
    assert debug.check_finite_tree(torch_tree) == debug.check_finite_tree(tree)


def test_check_finite_tree_of_a_module():
    model = RawFormer(RawFormerConfig(dim=8, num_heads=HEADS))
    assert debug.check_finite_tree(model, "model") == []
    with torch.no_grad():
        model.embedding.bias[0] = float("nan")
    assert debug.check_finite_tree(model, "model") == ["model['embedding.bias']"]


def test_grad_stats_matches_jax():
    tree = flat_mapping()
    want = {k.strip("[]'"): v for k, v in jdebug.grad_stats(tree).items()}
    got = debug.grad_stats(tree)
    assert sorted(got) == sorted(want)
    for k, (mx, mean, has_nan) in want.items():
        gmx, gmean, ghas = got[k]
        assert ghas == has_nan, k
        for g, w in ((gmx, mx), (gmean, mean)):
            assert (math.isnan(g) and math.isnan(w)) or g == pytest.approx(w, rel=1e-6), k


def test_grad_stats_of_a_module():
    model = RawFormer(RawFormerConfig(dim=8, num_heads=HEADS))
    x = torch.from_numpy(RNG.uniform(0, 1, (1, 1, 32, 32)).astype(np.float32))
    model(x).square().mean().backward()
    stats = debug.grad_stats(model)
    assert sorted(stats) == sorted(k for k, p in model.named_parameters() if p.grad is not None)
    g = model.embedding.weight.grad.double()
    assert stats["embedding.weight"] == (g.abs().max().item(), g.mean().item(), False)


def test_finite_or_zero():
    t = torch.tensor([1.0, float("nan"), float("inf"), -float("inf"), -2.0])
    want = torch.tensor([1.0, 0.0, 0.0, 0.0, -2.0])
    assert torch.equal(debug.finite_or_zero(t), want)
    got = debug.finite_or_zero({"a": t, "b": [t, t]})
    assert torch.equal(got["a"], want) and all(torch.equal(v, want) for v in got["b"])
    np.testing.assert_array_equal(np.asarray(jdebug.finite_or_zero(t.numpy())), want.numpy())


def test_enable_debug_nans_raises_at_the_nan():
    x = torch.tensor([-1.0, 4.0], requires_grad=True)
    debug.enable_debug_nans(True)
    try:
        with pytest.raises(RuntimeError, match="nan"):
            torch.sqrt(x).sum().backward()
    finally:
        debug.enable_debug_nans(False)
    assert not torch.is_anomaly_enabled()
    torch.sqrt(x).sum().backward()  # off again: no check


def test_average_meter_matches_jax():
    seq = [(0.5, 1), (2.0, 3), (-1.25, 2), (7.0, 1)]
    ours, theirs = profiling.AverageMeter(), jprofiling.AverageMeter()
    for v, k in seq:
        ours.update(v, k)
        theirs.update(v, k)
        assert (ours.val, ours.sum, ours.count, ours.avg) == \
            (theirs.val, theirs.sum, theirs.count, theirs.avg)
    ours.reset()
    assert (ours.val, ours.sum, ours.count, ours.avg) == (0.0, 0.0, 0, 0.0)


def test_step_timer_and_timed_scan():
    timer = profiling.StepTimer()
    timer.start()
    dt = timer.stop(torch.ones(3) * 2)
    assert dt >= 0 and timer.meter.count == 1 and timer.meter.avg == dt
    calls = []

    def fn(a):
        calls.append(1)
        return a * 2

    sec = profiling.timed_scan(fn, (torch.ones(4),), steps=5, reps=2)
    assert sec > 0 and len(calls) == 1 + 5 * 2


def test_cost_analysis_and_trace(tmp_path):
    a, b = torch.randn(6, 5), torch.randn(5, 7)
    cost = profiling.cost_analysis(torch.mm, a, b)
    assert cost["flops"] == 2 * 6 * 5 * 7 and cost["aten.mm"] == cost["flops"]
    with profiling.trace(str(tmp_path)):
        torch.mm(a, b)
    traces = glob.glob(str(tmp_path / "*.pt.trace.json"))
    assert len(traces) == 1 and "aten::mm" in open(traces[0]).read()
