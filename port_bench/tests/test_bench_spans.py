"""The readers of the port's own spans (``port_bench/spans.py``): each on a
hand-built trace of known times, and on the traced small-size CPU runs of a
frame cell and of the train cell, where the spans come from the program."""

import math

import pytest
import torch

from port_bench import harness, spans, tracing

SEED = 2 ** 31 + 27


def event(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "args": {}}
    if corr is not None:
        e["args"]["correlation"] = corr
    return e


def request_trace():
    """One request in a 1000 us window: h2d 100-200 (its copy 120-180),
    forward 200-400 with a halo 210-230 that launches the kernel at
    300-320, the next kernel 320-600, finish 600-900 (its copy 650-850)."""
    return tracing.Trace([
        event("user_annotation", "bench::window", 0, 1000),
        event("user_annotation", "lle.predictor.request", 100, 800),
        event("user_annotation", "lle.predictor.h2d", 100, 100),
        event("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 120, 60, tid=7),
        event("user_annotation", "lle.predictor.forward", 200, 200),
        event("user_annotation", "lle.bands.halo", 210, 20),
        event("cuda_runtime", "cudaLaunchKernel", 215, 2, corr=1),
        event("kernel", "halo_copy", 300, 20, tid=7, corr=1),
        event("cuda_runtime", "cudaLaunchKernel", 250, 2, corr=2),
        event("kernel", "k_block", 320, 280, tid=7, corr=2),
        event("user_annotation", "lle.predictor.finish", 600, 300),
        event("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 650, 200, tid=7),
        event("user_annotation", "lle.elsewhere", 0, 1000, tid=2),  # another thread
    ])


def step_trace():
    """Two steps in a 1000 us window: each stages its batch while the
    device idles, runs a kernel, and guards; the next kernel starts 30 and
    then 50 us after each guard ends."""
    ev = [event("user_annotation", "bench::window", 0, 1000)]
    for i, t in enumerate((0, 500)):
        ev += [
            event("user_annotation", "lle.loader.stage", t + 50, 100),
            event("user_annotation", "lle.trainer.step", t + 150, 300),
            event("kernel", "k_fwd", t + 160, 200, tid=7, corr=10 + i),
            event("user_annotation", "lle.trainer.guard", t + 370, 30),
            event("kernel", "k_adam", t + 430 + 20 * i, 10, tid=7, corr=20 + i),
        ]
    return tracing.Trace(ev)


def test_span_host_durations():
    s = spans.summarize(request_trace())
    assert s["h2d_host_s"] == pytest.approx([100e-6])
    assert s["enqueue_host_s"] == pytest.approx([200e-6])


def test_halo_device_time_is_what_the_halo_launched():
    s = spans.summarize(request_trace())
    assert s["halo_device_s"] == pytest.approx(20e-6)
    assert spans.values(s, 2)["halo_device_ms"] == pytest.approx(0.01)


def test_idle_by_innermost_span():
    idle = spans.idle_by_span(request_trace())
    want = {spans.NONE_OPEN: 200e-6, "lle.predictor.h2d": 100e-6,
            "lle.predictor.forward": 80e-6, "lle.bands.halo": 20e-6,
            "lle.predictor.finish": 300e-6}
    assert idle == pytest.approx(want)
    # The kernels' gaps, all of them and no more.
    assert sum(idle.values()) == pytest.approx(700e-6)
    v = spans.values(spans.summarize(request_trace()), 1)
    assert v["idle_unspanned_pct"] == pytest.approx(100 * 200 / 700)


@pytest.mark.parametrize("kind, name, want", [
    ("DtoH", "lle.predictor.finish", 1.0),
    ("HtoD", "lle.predictor.h2d", 1.0),
    ("DtoH", "lle.predictor.h2d", 0.0),
    ("HtoD", "lle.predictor.request", 1.0),
])
def test_copy_share_inside_a_span(kind, name, want):
    assert spans.copy_share_in(request_trace(), kind, name) == pytest.approx(want)


def test_copy_share_counts_the_part_inside():
    t = request_trace()
    t.device.append(("Memcpy DtoH (Device -> Pageable)", 850e-6, 950e-6, None, False))
    assert spans.copy_share_in(t, "DtoH", "lle.predictor.finish") == pytest.approx(250 / 300)
    assert spans.copy_share_in(t, "PtoP", "lle.predictor.finish") is None


def test_step_readers():
    s = spans.summarize(step_trace())
    assert s["sync_gaps_s"] == pytest.approx([30e-6, 50e-6])
    v = spans.values(s, 2)
    assert v["sync_gap_ms"] == pytest.approx(0.04)
    # Each stage 50-150 runs while the device idles: 100 us a step.
    assert v["loader_idle_ms"] == pytest.approx(0.1)
    idle = spans.idle_by_span(step_trace())
    assert idle == pytest.approx({"lle.loader.stage": 200e-6, "lle.trainer.guard": 60e-6,
                                  "lle.trainer.step": 130e-6, spans.NONE_OPEN: 190e-6})


def test_a_trace_without_spans_reads_nothing():
    t = tracing.Trace([event("user_annotation", "bench::window", 0, 1000),
                       event("user_annotation", "bench::request", 0, 900),
                       event("kernel", "k", 10, 100, tid=7, corr=1)])
    assert all(v is None for v in spans.values(spans.summarize(t), 1).values())


@pytest.fixture
def span_summaries(monkeypatch):
    """Every traced window's span summary, taken beside the harness's own."""
    got = []
    real = tracing.summarize

    def both(trace):
        if trace is not None:
            got.append(spans.summarize(trace))
        return real(trace)

    monkeypatch.setattr(tracing, "summarize", both)
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield got
    torch.set_num_threads(n)


SMALL_FRAME = {"traffic": {"height": 120, "width": 200, "pool": 2, "warmup": 1,
                           "trace_requests": 3},
               "cell": {"limits": {"rgb_max_rel": 1e9, "rgb_mean_rel": 1e9}}}
SMALL_STEP = {"traffic": {"crop": 32, "rows": 2, "trace_steps": 2, "ref_block_rows": 1},
              "config": {"compute_dtype": "float32"}}


def test_traced_cpu_runs_read_the_ports_spans(span_summaries):
    """On the CPU the host spans read; the device-side ones (the halo's
    device time, the gap after the guard) need the card's kernels."""
    line = harness.run_cell("rawformer_s.sony_frame", SEED, 0.5, True, device="cpu",
                            overrides=SMALL_FRAME)
    assert line["attempted"] == 3 and line["failed"] == 0
    harness.run_cell("rawformer_l.train_b16", SEED, 0.5, True, device="cpu",
                     overrides=SMALL_STEP)
    (frame, step) = span_summaries
    serve = spans.values(frame, 3)
    for key in ("h2d_host_ms", "enqueue_host_ms", "idle_unspanned_pct"):
        assert serve[key] is not None and math.isfinite(serve[key]), key
    assert len(frame["h2d_host_s"]) == len(frame["enqueue_host_s"]) == 3
    train = spans.values(step, 2)
    for key in ("loader_idle_ms", "idle_unspanned_pct"):
        assert train[key] is not None and math.isfinite(train[key]), key
    assert 0 <= serve["idle_unspanned_pct"] <= 100 and 0 <= train["idle_unspanned_pct"] <= 100
    assert serve["halo_device_ms"] is None and train["sync_gap_ms"] is None
