"""The port's spans (``utils.profiling.span``) on the CPU: each phase of a
Predictor request, a train step, the loader and the band halos is one
``record_function`` range under ``torch.profiler``, nested where it belongs,
and nothing at all while no profiler records. Also the union that
``utils.profiling.profile`` counts as busy."""

import pathlib
import re

import numpy as np
import pytest
import torch

from bayer_low_light_image_enhancement_tpu_torch.data.pipeline import prefetch_to_device
from bayer_low_light_image_enhancement_tpu_torch.kernels import fused_block
from bayer_low_light_image_enhancement_tpu_torch.models import RawFormer, RawFormerConfig
from bayer_low_light_image_enhancement_tpu_torch.models import common, fused_apply
from bayer_low_light_image_enhancement_tpu_torch.ops import conv
from bayer_low_light_image_enhancement_tpu_torch.serving import Predictor
from bayer_low_light_image_enhancement_tpu_torch.train.trainer import TrainConfig, Trainer
from bayer_low_light_image_enhancement_tpu_torch.utils import profiling
from bayer_low_light_image_enhancement_tpu_torch.utils.profiling import covered_us, span

torch.set_num_threads(2)

PACKAGE = pathlib.Path(profiling.__file__).resolve().parents[1]
PREDICTOR_PHASES = ("lle.predictor.h2d", "lle.predictor.forward", "lle.predictor.finish")
RNG = np.random.default_rng(27)


def small_rawformer(seed=0):
    return RawFormer(RawFormerConfig(dim=8, num_heads=(2, 2, 2, 2)),
                     generator=torch.Generator().manual_seed(seed))


def spans_of(fn):
    """Run ``fn`` under a CPU ``torch.profiler``: the ``lle.`` events in
    start order, each as (name, parent's name or None, start)."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    out = []
    for e in prof.events():
        if e.name.startswith(profiling.SPAN_PREFIX):
            parent = e.cpu_parent
            while parent is not None and not parent.name.startswith(profiling.SPAN_PREFIX):
                parent = parent.cpu_parent
            out.append((e.name, None if parent is None else parent.name, e.time_range.start))
    return sorted(out, key=lambda s: s[2])


def counts(spans):
    got = {}
    for name, _, _ in spans:
        got[name] = got.get(name, 0) + 1
    return got


def predictor_call(entry):
    pred = Predictor(small_rawformer(), device="cpu")
    mosaic = RNG.integers(0, 17000, (20, 34), dtype=np.uint16)
    if entry == "__call__":
        x = RNG.uniform(0, 1, (20, 34)).astype(np.float32)
        return lambda: pred(x)
    if entry == "codes_sid":
        return lambda: pred.codes(mosaic, 50.0)
    if entry == "codes_mcr":
        return lambda: pred.codes(mosaic.astype(np.uint8), 2.0, decode="mcr")
    return lambda: pred.raw_u16(mosaic, 50.0)


@pytest.mark.parametrize("entry", ["__call__", "codes_sid", "codes_mcr", "raw_u16"])
def test_predictor_entry_emits_its_four_spans_once_a_call(entry):
    call = predictor_call(entry)
    call()  # warm

    def twice():
        call()
        call()

    spans = spans_of(twice)
    assert counts(spans) == {"lle.predictor.request": 2, **{p: 2 for p in PREDICTOR_PHASES}}
    for name, parent, _ in spans:
        assert parent == (None if name == "lle.predictor.request" else "lle.predictor.request")
    # Each request runs its phases in order: h2d, forward, finish.
    order = [name for name, _, _ in spans]
    assert order == 2 * ["lle.predictor.request", *PREDICTOR_PHASES]


def counting_band_halo(monkeypatch):
    """Count the calls of ``band_halo`` made from outside it (an NCHW call
    runs the NHWC body through itself once more), wherever it was
    imported."""
    real = conv.band_halo
    state = {"calls": 0, "depth": 0}

    def counted(*args, **kw):
        state["calls"] += state["depth"] == 0
        state["depth"] += 1
        try:
            return real(*args, **kw)
        finally:
            state["depth"] -= 1

    for mod in (conv, common, fused_block, fused_apply):
        monkeypatch.setattr(mod, "band_halo", counted)
    return state


@pytest.mark.parametrize("fused", [True, False])
def test_banded_forward_emits_one_halo_span_a_band_halo_call(monkeypatch, fused):
    port = small_rawformer().eval()
    common.set_fused_blocks(port, fused)
    fwd = fused_apply.make_banded_forward(port, 4)
    x = torch.from_numpy(RNG.uniform(0, 1, (1, 1, 64, 32)).astype(np.float32))
    state = counting_band_halo(monkeypatch)

    def run():
        with torch.inference_mode():
            fwd(x)

    spans = spans_of(run)
    assert state["calls"] > 0
    assert counts(spans) == {"lle.bands.halo": state["calls"]}


def tiny_trainer(**kw):
    return Trainer(small_rawformer(),
                   TrainConfig(base_lr=1e-3, warmup_epochs=1, steps_per_epoch=1, **kw))


def tiny_batch(seed):
    g = np.random.default_rng(seed)
    return (torch.from_numpy(g.integers(0, 16000, (2, 32, 32, 1), dtype=np.uint16)),
            torch.full((2,), 50.0),
            torch.from_numpy(g.integers(0, 65535, (2, 32, 32, 3), dtype=np.uint16)))


@pytest.mark.parametrize("nan_guard, grad_clip, guard", [
    (True, None, True), (False, None, False), (False, 1.0, True), (True, 1.0, True)])
def test_train_step_emits_its_phases_once_a_step(nan_guard, grad_clip, guard):
    t = tiny_trainer(nan_guard=nan_guard, grad_clip=grad_clip)
    t.train_step(tiny_batch(0))  # warm

    def two_steps():
        for s in (1, 2):
            t.train_step(tiny_batch(s))

    spans = spans_of(two_steps)
    phases = ["lle.trainer.decode", "lle.trainer.forward", "lle.trainer.backward"]
    phases += ["lle.trainer.guard"] * guard + ["lle.trainer.update"]
    assert counts(spans) == {"lle.trainer.step": 2, **{p: 2 for p in phases}}
    for name, parent, _ in spans:
        assert parent == (None if name == "lle.trainer.step" else "lle.trainer.step")
    assert [name for name, _, _ in spans] == 2 * ["lle.trainer.step", *phases]


def test_a_skipped_update_has_no_update_span():
    t = tiny_trainer()
    raw, ratio, gt = tiny_batch(0)
    spans = spans_of(lambda: t.train_step((raw.float() * float("nan"), gt.float())))
    assert t.applied == 0
    assert "lle.trainer.update" not in counts(spans)
    assert counts(spans)["lle.trainer.guard"] == 1


def test_prefetch_to_device_emits_one_stage_span_a_batch():
    batches = [(np.full((2, 4), i, np.float32), np.arange(3, dtype=np.uint16)) for i in range(3)]
    got = []
    spans = spans_of(lambda: got.extend(prefetch_to_device(iter(batches), "cpu")))
    assert len(got) == 3
    assert counts(spans) == {"lle.loader.stage": 3}
    assert all(parent is None for _, parent, _ in spans)


def test_no_profiler_enters_no_record_function(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert span("lle.a") is span("lle.b")
    with span("lle.a"):
        pass
    # Whole requests, steps and loader batches pass through every span.
    for entry in ("__call__", "codes_mcr", "raw_u16"):
        predictor_call(entry)()
    tiny_trainer(grad_clip=1.0).train_step(tiny_batch(0))
    assert len(list(prefetch_to_device(iter([(np.zeros(2, np.float32),)]), "cpu"))) == 1
    fwd = fused_apply.make_banded_forward(small_rawformer().eval(), 4)
    with torch.inference_mode():
        fwd(torch.zeros(1, 1, 64, 32))


def test_span_names_keep_clear_of_the_benchmarks_prefixes():
    names = set()
    for path in PACKAGE.rglob("*.py"):
        names |= set(re.findall(r'\bspan\("([^"]+)"\)', path.read_text()))
    assert {"lle.predictor.request", "lle.trainer.guard", "lle.loader.stage",
            "lle.bands.halo"} <= names
    for name in names:
        assert name.startswith(profiling.SPAN_PREFIX), name
        assert not name.startswith(("blle::", "bench::")), name


@pytest.mark.parametrize("intervals, want", [
    ([], 0.0),
    ([(0.0, 2.0)], 2.0),
    ([(0.0, 2.0), (1.0, 3.0)], 3.0),  # two streams overlapping: once
    ([(5.0, 6.0), (0.0, 1.0), (0.5, 0.75)], 2.0),  # nested and unsorted
    ([(0.0, 1.0), (1.0, 2.0), (4.0, 4.0)], 2.0),  # touching, and empty
])
def test_busy_is_the_union_of_kernel_intervals(intervals, want):
    assert covered_us(intervals) == pytest.approx(want)
