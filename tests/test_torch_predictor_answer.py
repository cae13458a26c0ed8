"""How ``Predictor`` hands its answer back, on the CPU: every entry point
returns the values of the plain expression on the model's output (crop,
NHWC, clamp, fp32, to the host) as one C-contiguous NHWC fp32 array, squeezed
or batched as its input was, and counts it as an answer through plain
memory. The page-locked path of a CUDA Predictor is held on the card
(``tests/test_torch_cuda.py``)."""

import numpy as np
import pytest
import torch

from bayer_low_light_image_enhancement_tpu_torch.models import RawFormer, RawFormerConfig
from bayer_low_light_image_enhancement_tpu_torch.models.fused_apply import make_banded_forward
from bayer_low_light_image_enhancement_tpu_torch.serving import Predictor

torch.set_num_threads(2)

H, W = 20, 34
ENTRIES = ["__call__", "codes_sid", "codes_mcr", "raw_u16", "raw_u16_banded"]


def old_answer(y: torch.Tensor, h: int, w: int, squeeze: bool) -> np.ndarray:
    """The answer as ``Predictor`` computed it before its answers were laid
    out NHWC on the device: a strided view of the clamped output."""
    a = y[:, :, :h, :w].permute(0, 2, 3, 1).clamp(0.0, 1.0).float().cpu().numpy()
    return a[0] if squeeze else a


@pytest.fixture(scope="module")
def model():
    return RawFormer(RawFormerConfig.from_size("S"), generator=torch.Generator().manual_seed(28))


def serve(model, entry, batch):
    """One request through ``entry`` on a seeded frame ([H,W] when ``batch``
    is None, else [batch,H,W(,1)]) -> (answer, the served module's output)."""
    g = np.random.default_rng(28)
    shape = (H, W) if batch is None else (batch, H, W)
    mosaic = g.integers(0, 17000, shape, dtype=np.uint16)
    frames = (lambda a: a) if batch is None else (lambda a: a[..., None])
    ratio = 50.0 if batch is None else g.uniform(50.0, 200.0, batch).astype(np.float32)
    if entry == "raw_u16_banded":  # the benchmark's route: H padded to 32, two 16-row bands
        pred = Predictor(make_banded_forward(model, 2), device="cpu", pad_to=32)
    else:
        pred = Predictor(model, device="cpu")
    outs = []
    hook = pred.model.register_forward_hook(lambda m, a, out: outs.append(out))
    try:
        with torch.inference_mode():
            if entry == "__call__":
                got = pred(frames(g.uniform(0, 1, shape).astype(np.float32) * 40.0))
            elif entry == "codes_sid":
                got = pred.codes(frames(mosaic), ratio)
            elif entry == "codes_mcr":
                got = pred.codes(frames((mosaic >> 8).astype(np.uint8)), 2.0, decode="mcr")
            else:
                got = pred.raw_u16(mosaic, ratio)
    finally:
        hook.remove()
    (y,) = outs
    return got, y


@pytest.mark.parametrize("batch", [None, 2])
@pytest.mark.parametrize("entry", ENTRIES)
def test_answer_holds_the_old_values_as_one_contiguous_nhwc_array(model, entry, batch):
    got, y = serve(model, entry, batch)
    want = old_answer(y, H, W, batch is None)
    assert got.shape == ((H, W, 3) if batch is None else (batch, H, W, 3))
    assert got.dtype == np.float32 and got.flags.c_contiguous
    assert np.array_equal(got, want)
    assert got.min() >= 0.0 and got.max() <= 1.0


@pytest.mark.parametrize("entry", ENTRIES)
def test_cpu_answers_count_as_pageable(model, entry):
    before = (Predictor.pinned_answers, Predictor.pageable_answers)
    serve(model, entry, None)
    serve(model, entry, 2)
    assert (Predictor.pinned_answers, Predictor.pageable_answers) == (before[0], before[1] + 2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("squeeze", [True, False])
def test_finish_clamps_crops_and_casts_as_before(dtype, squeeze):
    """``_finish`` on an output that leaves [0, 1] both ways, in either
    dtype a model may return: the same values as before, now C-contiguous,
    and not a view of the model's output."""
    y = (torch.rand(1 if squeeze else 3, 3, 24, 40, generator=torch.Generator().manual_seed(5))
         * 2.0 - 0.5).to(dtype)
    got = Predictor._finish(y, 17, 29, squeeze)
    want = old_answer(y, 17, 29, squeeze)
    assert got.flags.c_contiguous and got.dtype == np.float32 and got.shape == want.shape
    assert np.array_equal(got, want)
    assert 0.0 < float((got == 0.0).mean()) < 1.0 and 0.0 < float((got == 1.0).mean()) < 1.0
    y.fill_(0.5)
    assert np.array_equal(got, want)
