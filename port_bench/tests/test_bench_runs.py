"""Whole runs of the cells on the CPU at small sizes, the card's look
skipped (``device="cpu"``): the frozen reference against the port's twin
path, and runs with the timed path broken underneath, which must come out
not correct. And ``run.py`` itself, which without a card prints no result.
"""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from port_bench import harness
from port_bench.reference import decode, rawformer as ref

ROOT = Path(__file__).resolve().parents[2]
SMALL_FRAME = {"traffic": {"height": 120, "width": 200, "pool": 2, "warmup": 1,
                           "trace_requests": 3}}
SMALL_STEP = {"traffic": {"crop": 32, "rows": 2, "trace_steps": 2, "ref_block_rows": 1},
              "config": {"compute_dtype": "float32"}}
# An fp32 answer rounds far less than the plain bf16 forward it is divided by.
FP32_FRAME_LIMITS = {"cell": {"limits": {"rgb_max_rel": 1e-2, "rgb_mean_rel": 1e-2}}}
SEED = 2 ** 31 + 77


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


@pytest.fixture
def fp32_port(monkeypatch):
    """The port built in fp32 (its twin path), while the configuration keeps
    its bf16 compute dtype for the plain forward that the frame numbers are
    divided by; returns the small frame cell's overrides."""
    from port_bench import program

    real = program.port_model
    monkeypatch.setattr(program, "port_model", lambda config, seed, device: real(
        {**config, "compute_dtype": "float32"}, seed, device))
    return {**SMALL_FRAME, **FP32_FRAME_LIMITS}


def test_reference_names_are_the_ports():
    from bayer_low_light_image_enhancement_tpu_torch.models import get_model

    port = get_model("rawformer_s", device="meta")
    oracle = ref.RawFormerOracle(dim=32)
    assert {k: v.shape for k, v in port.state_dict().items()} == \
        {k: v.shape for k, v in oracle.state_dict().items()}


def test_reference_decode_is_the_sid_decode():
    codes = torch.tensor([[[0, 511, 512, 8000, 16383, 20000]]], dtype=torch.int32)
    x = decode.decode_sid(codes, torch.tensor([2.0]))
    want = np.clip(np.array([0, 511, 512, 8000, 16383, 20000.0]), 512, 16383)
    want = (want - 512) / (16383 - 512 + 1e-6) * 2
    np.testing.assert_allclose(x[0, 0, 0].numpy(), want, rtol=1e-6)


@pytest.mark.parametrize("cell", ["rawformer_s.sony_frame", "rawformer_l.sony_frame"])
def test_frame_cell_matches_the_reference_in_fp32(cell, fp32_port):
    """The port's banded route in fp32 (its twins) against the frozen
    reference: the whole request, decode to crop."""
    line = harness.run_cell(cell, SEED, 0.5, False, device="cpu", overrides=fp32_port)
    assert line["correct"] and line["failed"] == 0
    assert set(line["checks"]) == {"rgb_max_rel", "rgb_mean_rel"}
    assert set(line["metrics"]) == {"serve_mpix_s", "setup_s"}


def test_frame_limits_are_relative():
    """Both frame cells compare the same two relative numbers."""
    for cell in ("rawformer_s.sony_frame", "rawformer_l.sony_frame"):
        assert set(harness.Cell.find(cell).cell["limits"]) == {"rgb_max_rel", "rgb_mean_rel"}


def test_train_cell_matches_the_reference_in_fp32():
    line = harness.run_cell("rawformer_l.train_b16", SEED, 0.5, False, device="cpu",
                            overrides=SMALL_STEP)
    assert line["correct"]
    checks = {k: v["value"] for k, v in line["checks"].items()}
    assert set(checks) == {"grad_leaf_gap", "change_leaf_gap"}
    assert checks["grad_leaf_gap"] < 1e-3 and checks["change_leaf_gap"] < 1e-3


def test_traced_frame_run_reads_its_route(fp32_port):
    line = harness.run_cell("rawformer_s.sony_frame", SEED, 0.5, True, device="cpu",
                            overrides=fp32_port)
    assert line["correct"]
    routes = {k: v for k, v in line["checks"].items() if k.startswith("route")}
    assert set(routes) == {"route blle::gram_pass_banded", "route blle::apply_pass_banded"}
    assert set(line["metrics"]) <= {"predictor_host_ms.serve", "mfu_pct.serve", "d2h_ms.serve",
                                    "device_idle_pct.serve", "block_roofline_pct.serve"}
    assert "busy_s" in line["device"] and "breakdown" in line


def test_altered_answer_is_not_correct(monkeypatch, fp32_port):
    from bayer_low_light_image_enhancement_tpu_torch.serving import Predictor

    real = Predictor.raw_u16

    def altered(self, mosaic, ratio):
        out = real(self, mosaic, ratio)
        out[:8, :8] = 1.0 - out[:8, :8]  # a corner answered wrong
        return out

    monkeypatch.setattr(Predictor, "raw_u16", altered)
    line = harness.run_cell("rawformer_s.sony_frame", SEED, 0.5, False, device="cpu",
                            overrides=fp32_port)
    assert not line["correct"]


def test_unchanged_state_is_not_correct(monkeypatch):
    from bayer_low_light_image_enhancement_tpu_torch.train.trainer import Trainer

    def idle(self, batch):  # the step returns the state it was given
        self.step += 1
        return torch.zeros(())

    monkeypatch.setattr(Trainer, "train_step", idle)
    line = harness.run_cell("rawformer_l.train_b16", SEED, 0.5, False, device="cpu",
                            overrides=SMALL_STEP)
    assert not line["correct"]


def test_half_batch_is_not_correct(monkeypatch):
    from bayer_low_light_image_enhancement_tpu_torch.train.trainer import Trainer

    real = Trainer.train_step

    def half(self, batch):  # the mean over the first half of the rows
        return real(self, tuple(t[:len(t) // 2] for t in batch))

    monkeypatch.setattr(Trainer, "train_step", half)
    line = harness.run_cell("rawformer_l.train_b16", SEED, 0.5, False, device="cpu",
                            overrides=SMALL_STEP)
    assert not line["correct"]


def test_control_fails_the_limits():
    """The control (the reference with float8 operands) in the program's
    place, on the cells' own limits, at a size the CPU holds."""
    from port_bench import calibrate

    for name in ("rawformer_l.sony_frame", "rawformer_s.sony_frame"):
        cell = harness.Cell.find(name)
        cell.traffic.update(SMALL_FRAME["traffic"])
        limits = cell.cell["limits"]
        for row in calibrate.frames(cell, SEED, True, "cpu"):
            if row["side"] == "control":
                assert all(row[k] > limits[k] for k in limits), row
    cell = harness.Cell.find("rawformer_l.train_b16")
    cell.traffic.update(SMALL_STEP["traffic"])
    rows = calibrate.steps(cell, SEED, True, "cpu")
    limits = cell.cell["limits"]
    for row in rows[1:]:  # the control and the faults each fail one number
        assert any(row[k] > limits[k] for k in limits), row


def test_run_without_a_card_prints_no_result():
    out = subprocess.run([sys.executable, "port_bench/run.py", "--workload",
                          "rawformer_l.sony_frame", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, cwd=ROOT,
                         timeout=300, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "no CUDA device" in out.stderr


def test_run_without_the_port_prints_no_result(tmp_path):
    """In a directory holding only BENCHMARK.json and port_bench/, a run
    (the card's look skipped) fails for want of the program."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "port_bench", tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "port_bench/run.py", "--workload",
                          "rawformer_s.sony_frame", "--seed", "1", "--seconds", "1",
                          "--trace", "0", "--device", "cpu"], capture_output=True, text=True,
                         cwd=tmp_path, timeout=300, env=env)
    assert out.returncode != 0
    assert not any(line.startswith("{") for line in out.stdout.splitlines())
    assert "bayer_low_light_image_enhancement_tpu_torch" in out.stderr


def test_result_line_keys(fp32_port):
    line = harness.run_cell("rawformer_s.sony_frame", SEED, 0.3, False, device="cpu",
                            overrides=fp32_port)
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    json.dumps(line)
    for v in line["checks"].values():
        assert set(v) == {"value", "limit"}
