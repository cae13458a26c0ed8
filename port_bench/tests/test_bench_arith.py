"""The benchmark's arithmetic: the traffic, rates, interval unions, the
trace's attribution and the operation counts."""

import math

import numpy as np
import pytest
import torch

from port_bench import counts, stats, tracing
from port_bench.harness import HERE, Record, load_module
from port_bench.traffic.sid_synth import SID_RATIOS, WHITE_LEVEL, captures
from port_bench.traffic.train_steps import train_gaps


def test_same_seed_same_traffic():
    a = captures(2 ** 31 + 11, 3, 32, 48, "cpu", with_gt=True)
    b = captures(2 ** 31 + 11, 3, 32, 48, "cpu", with_gt=True)
    c = captures(2 ** 31 + 12, 3, 32, 48, "cpu", with_gt=True)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert not np.array_equal(a[0], c[0])
    mosaic, ratio, gt = a
    assert mosaic.dtype == np.uint16 and mosaic.shape == (3, 32, 48)
    assert gt.dtype == np.uint16 and gt.shape == (3, 32, 48, 3)
    assert set(ratio.tolist()) <= set(SID_RATIOS)
    assert mosaic.max() <= WHITE_LEVEL
    assert len({m.tobytes() for m in mosaic}) == 3  # every capture differs


def test_rate_is_over_the_whole_window():
    assert stats.rate(121.2, 30.0) == pytest.approx(4.04)
    with pytest.raises(ValueError):
        stats.rate(1.0, 0.0)


def test_union_counts_overlaps_once():
    iv = [(0, 2), (1, 3), (5, 6), (5.5, 5.7), (7, 7)]
    assert stats.union(iv) == [(0, 3), (5, 6)]
    assert stats.covered(iv) == 4
    assert stats.gaps(iv, -1, 8) == [(-1, 0), (3, 5), (6, 8)]
    assert stats.covered(stats.clip(iv, 1, 5.5)) == 2.5


def event(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "args": {}}
    if corr is not None:
        e["args"]["correlation"] = corr
    return e


def window_events():
    return [
        event("user_annotation", "bench::window", 0, 1000),
        event("user_annotation", "bench::block#0", 100, 200),
        event("cpu_op", "blle::gram_pass", 110, 20),
        event("cuda_runtime", "cudaLaunchKernel", 120, 5, corr=1),
        event("kernel", "k_block", 150, 100, tid=7, corr=1),
        event("cuda_runtime", "cudaLaunchKernel", 400, 5, corr=2),  # outside the block
        event("kernel", "k_other", 410, 100, tid=7, corr=2),
        event("kernel", "k_side", 420, 100, tid=8, corr=3),  # overlaps on another stream
        event("gpu_memcpy", "Memcpy HtoD", 600, 50, tid=7, corr=4),
        event("cpu_op", "aten::copy_", 700, 250),
        event("cuda_runtime", "cudaLaunchKernel", 200, 5, corr=5),  # inside the block
        event("kernel", "k_late", 700, 10, tid=9, corr=5),
        event("cuda_runtime", "cudaMemcpyAsync", 210, 5, corr=6),  # inside the block
        event("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 800, 30, tid=7, corr=6),
    ]


def test_trace_attribution_busy_and_idle():
    t = tracing.Trace(window_events())
    assert t.window_s == pytest.approx(1e-3)
    # kernels alone keep the device busy: the copies do not
    assert t.busy_s() == pytest.approx((100 + 110 + 10) * 1e-6)
    assert t.copy_s("HtoD") == pytest.approx(50e-6)
    assert t.copy_s("DtoH") == pytest.approx(30e-6)
    # a range's device time holds every operation launched inside it
    assert t.device_time_in("bench::block#") == pytest.approx({"bench::block#0": 140e-6})
    assert t.count("blle::") == {"blle::gram_pass": 1}
    idle = dict(t.idle_by_host())
    assert idle["aten::copy_"] == pytest.approx(290e-6)  # the gap 710-1000, by its middle
    assert idle["host outside any operation"] == pytest.approx((150 + 160 + 180) * 1e-6)
    assert sum(idle.values()) == pytest.approx(t.window_s - t.busy_s())
    top = t.top_device_ops()
    assert top[0][0] in ("k_block", "k_other", "k_side") and len(top) == 6


def test_idle_and_copy_readers():
    rec = Record(trace=tracing.summarize(tracing.Trace(window_events())), trace_units=2)
    read = {name: load_module(HERE / "metrics" / f"{name}.py").read
            for name in ("d2h_ms.serve", "device_idle_pct.serve", "device_idle_pct.train")}
    assert read["d2h_ms.serve"](rec) == pytest.approx(30e-3 / 2)  # ms a request
    assert read["device_idle_pct.serve"](rec) == pytest.approx(100 * (1 - 220 / 1000))
    assert read["device_idle_pct.train"](rec) == read["device_idle_pct.serve"](rec)
    rec.trace["d2h_s"] = 0.0  # nothing to read: no number, not 0
    assert read["d2h_ms.serve"](rec) is None
    assert read["device_idle_pct.serve"](Record()) is None


def test_block_counts_match_a_hand_count():
    b, c, h, w, heads, ffn = 2, 64, 16, 24, 8, 2
    p, ch = b * h * w, c // heads
    hand = (2 * c * 3 * c * p           # qkv 1x1
            + 2 * 9 * 3 * c * p         # its depthwise 3x3
            + 2 * (2 * c * ch * p)      # q k^T and attn v, per head
            + 2 * c * c * p             # projection
            + 2 * (2 * c * ffn * c * p)  # the FFN's two 1x1
            + 2 * 9 * ffn * c * p)      # its depthwise 3x3
    assert counts.block_flops(c, heads, ffn, (b, c, h, w)) == hand
    # every product's backward takes both operands' gradients: twice the forward
    assert counts.block_flops(c, heads, ffn, (b, c, h, w), backward=True) == 2 * hand
    # linear in the pixels
    assert counts.block_flops(c, heads, ffn, (b, c, 2 * h, w)) == 2 * hand


def test_model_counts_scale_with_pixels():
    one = counts.rawformer_flops(32, (8, 8, 8, 8), 2, (1, 1, 64, 64))
    assert counts.rawformer_flops(32, (8, 8, 8, 8), 2, (2, 1, 64, 128)) == 4 * one
    both = counts.rawformer_flops(32, (8, 8, 8, 8), 2, (1, 1, 64, 64), backward=True)
    assert 2 * one < both < 3 * one  # no input gradient into the embedding


def test_least_seconds_takes_the_larger_bound():
    assert counts.least_seconds(989e12, 0) == pytest.approx(1.0)
    assert counts.least_seconds(0, 3.35e12) == pytest.approx(1.0)
    assert counts.block_bytes((1, 2, 3, 4), 2, 2, 1, 2) == 2 * 24 * 2 + 4 * counts.block_param_count(2, 1, 2)


def test_train_gaps_by_the_worst_leaf():
    ref = {"losses": [1.0, 2.0], "grad_norms": {"a": 1.0, "b": 2.0, "c": 1e-9},
           "change_norms": {"a": 1.0, "b": 4.0, "c": 5.0}}
    prog = {"losses": [1.01, 2.0], "grad_norms": {"a": 1.1, "b": 2.0, "c": 7.0},
            "change_norms": {"a": 0.0, "b": 4.0, "c": 0.0}}
    g = train_gaps(prog, ref)
    assert g["loss_gap"] == pytest.approx(0.01)
    # "c" has no gradient to speak of and is left out; "a" is measured
    # against the median leaf's norm where its own is smaller
    assert g["grad_leaf_gap"] == pytest.approx(0.1 / 1.5)
    assert g["change_leaf_gap"] == pytest.approx(1.0 / 2.5)
    assert g["leaves"] == ("a", "a", 1)


def test_unchanged_state_reads_one():
    ref = {"losses": [1.0], "grad_norms": {"a": 1.0, "b": 1.0},
           "change_norms": {"a": 2.0, "b": 3.0}}
    prog = {"losses": [1.0], "grad_norms": {"a": 1.0, "b": 1.0},
            "change_norms": {"a": 0.0, "b": 0.0}}
    assert train_gaps(prog, ref)["change_leaf_gap"] == pytest.approx(1.0)


def test_fp8_rounding_is_coarser_than_bf16():
    x = torch.linspace(-3, 3, 1001)
    from port_bench.reference.lowp import round_fp8

    e8 = (round_fp8(x) - x).abs().max()
    e16 = (x.bfloat16().float() - x).abs().max()
    assert e8 > 8 * e16 and math.isfinite(float(e8))
