"""The port's evaluation CLI, train CLI on real-data trees and WFB weight
carry against the JAX package (CPU).

* ``cli.test_cli.main([... --device cpu --fp32 --pth X])`` against the JAX
  ``cli.test_cli.main([... --fp32 --pth X])`` in process, on a tiny SID npz
  tree and a tiny MCR PNG tree (one frame each off the 16-pixel grid, for
  the pad and crop), with one reference-named ``state_dict`` from
  ``torch_oracle.RawFormerOracle``: per-image PSNR within 1e-2 dB, SSIM
  within 1e-4, the CSV rows equal in number and format;
* ``correct_bayer_channels`` / ``auto_correct_rb`` over the four patterns;
* ``Predictor.from_jax_params`` on a dim-8 RawFormer-WFB against the JAX
  WFB apply, fp32, at the repo's 1e-4;
* ``Predictor.codes`` (the device decode of integer codes) against
  ``__call__`` on host-decoded frames;
* the train CLI on a tiny SID tree under ``--loader python`` and ``--loader
  native`` (compact), then the eval CLI from its checkpoint.
"""

import os
import re

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from bayer_low_light_image_enhancement_tpu.cli import test_cli as jtest_cli
from bayer_low_light_image_enhancement_tpu.models import wfb as jwfb
from bayer_low_light_image_enhancement_tpu.utils import logging as jlogging
from bayer_low_light_image_enhancement_tpu_torch.cli import test_cli, train_cli
from bayer_low_light_image_enhancement_tpu_torch.data import native, pipeline, sid, synthetic
from bayer_low_light_image_enhancement_tpu_torch.models import RawFormerWFB, RawFormerWFBConfig
from bayer_low_light_image_enhancement_tpu_torch.models import get_model
from bayer_low_light_image_enhancement_tpu_torch.serving import Predictor
from bayer_low_light_image_enhancement_tpu_torch.train.trainer import decode_batch
from torch_oracle import RawFormerOracle
from torch_trees import write_mcr_tree

torch.set_num_threads(2)

PSNR_TOL, SSIM_TOL = 1e-2, 1e-4
CSV_ROW = re.compile(r"^\d+\.\d{4},-?\d\.\d{4}$")


@pytest.fixture(scope="module")
def pth(tmp_path_factory):
    torch.manual_seed(0)
    path = str(tmp_path_factory.mktemp("pth") / "RawFormer_S_SID.pth")
    torch.save({"epoch": 3, "state_dict": RawFormerOracle(dim=32).state_dict()}, path)
    return path


@pytest.fixture(scope="module")
def eval_trees(tmp_path_factory):
    sid_root = str(tmp_path_factory.mktemp("sid"))
    synthetic.write_sid_tree(sid_root, os.path.join(sid_root, "cache"),
                             {"train": [(40, 56)], "test": [(32, 48), (30, 46)]},
                             np.random.default_rng(8))
    mcr_root = str(tmp_path_factory.mktemp("mcr"))
    write_mcr_tree(mcr_root, {"train": [(40, 56)], "test": [(32, 48), (30, 46)]},
                   np.random.default_rng(9))
    return {"SID": sid_root, "MCR": mcr_root}


def jax_eval(argv, monkeypatch):
    """The JAX CLI's per-image PSNR / SSIM, as passed to its CSV writer."""
    seen = {}
    write = jlogging.MetricsLogger.write_metrics_csv

    def spy(self, path, psnrs, ssims):
        seen.update(psnr=list(psnrs), ssim=list(ssims))
        write(self, path, psnrs, ssims)

    monkeypatch.setattr(jlogging.MetricsLogger, "write_metrics_csv", spy)
    jtest_cli.main(argv)
    return seen


@pytest.mark.parametrize("dataset", ["SID", "MCR"])
def test_eval_cli_matches_jax(eval_trees, pth, tmp_path, monkeypatch, capsys, dataset):
    root = eval_trees[dataset]
    common = ["--dataset", dataset, "--data_root", root, "--cache_dir", os.path.join(root, "cache"),
              "--model_size", "S", "--fp32", "--pth", pth]
    want = jax_eval(common + ["--save_dir", str(tmp_path / "jax")], monkeypatch)
    jax_out = capsys.readouterr().out
    got = test_cli.main(common + ["--save_dir", str(tmp_path / "port"), "--device", "cpu"])
    out = capsys.readouterr().out
    assert "imported torch checkpoint" in out and "Average PSNR" in out
    assert len(got["psnr"]) == len(want["psnr"]) == 2 and len(got["seconds"]) == 2
    np.testing.assert_allclose(got["psnr"], want["psnr"], rtol=0, atol=PSNR_TOL)
    np.testing.assert_allclose(got["ssim"], want["ssim"], rtol=0, atol=SSIM_TOL)
    lines = [ln for ln in out.splitlines() if ln.startswith("image:")]
    assert len(lines) == 2 and all(re.fullmatch(r"image:\d\tPSNR:\d+\.\d{4}\tSSIM:-?\d\.\d{4}", ln)
                                   for ln in lines)
    assert len(lines) == len([ln for ln in jax_out.splitlines() if ln.startswith("image:")])
    rows = {}
    for side in ("jax", "port"):
        csv = tmp_path / side / dataset / "csv" / "test_metrics.csv"
        rows[side] = csv.read_text().splitlines()
        assert len(rows[side]) == 2 and all(CSV_ROW.match(r) for r in rows[side])
    assert rows["port"] == [f"{p:.4f},{s:.4f}" for p, s in zip(got["psnr"], got["ssim"])]


@pytest.mark.parametrize("pattern", ["RGGB", "BGGR", "GRBG", "GBRG"])
def test_channel_fixes_match_jax(pattern):
    rng = np.random.default_rng(2)
    for shift in (0, 60):  # red darker, then brighter, than blue
        img = rng.integers(0, 180, (6, 10, 3), dtype=np.uint8)
        img[..., 0] += shift
        got = test_cli.correct_bayer_channels(img, pattern.lower())
        want = jtest_cli.correct_bayer_channels(img, pattern.lower())
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(test_cli.auto_correct_rb(got), jtest_cli.auto_correct_rb(want))


def jax_wfb_variables(model, x, seed):
    """Seeded variables of the JAX WFB (kernels fan-in scaled, BN variances
    near 1, A_log near log(1..N)), as tests/test_torch_wfb.py fills them."""
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.asarray(x))
    g = np.random.default_rng(seed)

    def fill(path, s):
        name = jax.tree_util.keystr(path)
        v = g.uniform(-1.0, 1.0, s.shape)
        if "kernel" in name:
            v = v / np.sqrt(np.prod(s.shape[:-1]))
        elif "'var'" in name:
            v = 1.0 + 0.5 * v
        elif "A_log" in name:
            v = np.log(np.arange(1, s.shape[1] + 1)) + 0.1 * v
        else:
            v = 0.2 * v + (1.0 if ("scale" in name or "weight" in name or "'D'" in name) else 0.0)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def test_predictor_from_jax_params_serves_wfb():
    """A JAX RawFormerWFB variable tree (params and batch_stats) through
    ``Predictor.from_jax_params``, fp32, against the JAX apply at 1e-4; a
    frame off the 32 grid pads and crops."""
    x = np.random.default_rng(12).uniform(0.0, 1.0, (2, 32, 32, 1)).astype(np.float32)
    jm = jwfb.RawFormerWFB(jwfb.RawFormerWFBConfig(dim=8))
    var = jax_wfb_variables(jm, x, 13)
    want = np.asarray(jax.jit(jm.apply)(var, jnp.asarray(x)))
    pred = Predictor.from_jax_params(RawFormerWFB(RawFormerWFBConfig(dim=8)), var, device="cpu",
                                     pad_to=32)
    np.testing.assert_allclose(pred(x), np.clip(want, 0.0, 1.0), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(pred(x[0, :30, :27]), pred(np.pad(x[0, :30, :27], (
        (0, 2), (0, 5), (0, 0))))[:30, :27], rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="batch_stats"):
        Predictor.from_jax_params(RawFormerWFB(RawFormerWFBConfig(dim=8)),
                                  {"params": var["params"]}, device="cpu")


@pytest.mark.parametrize("decode,model", [("sid", "rawformer_s"), ("mcr", "rawformer_s"),
                                          ("sid", "wfb")])
def test_predictor_codes_match_host_decode(decode, model):
    """Codes decoded on the device (zero codes in the pad) against the
    host-decoded frame through ``__call__`` (fp32; tolerance 1e-5).
    RawFormer's SID codes take ``raw_u16``'s route (the pack kernel's
    twin here, then the prepacked entry), WFB's ``normalize_sid``."""
    rng = np.random.default_rng(14)
    gen = torch.Generator().manual_seed(1)
    if model == "wfb":
        pred = Predictor(RawFormerWFB(RawFormerWFBConfig(dim=8), generator=gen), device="cpu",
                         pad_to=32)
    else:
        pred = Predictor(get_model(model, generator=gen), device="cpu")
    if decode == "sid":
        codes = rng.integers(0, 17000, (2, 30, 46, 1), dtype=np.uint16)
        scale = np.array([100.0, 300.0], np.float32)
        host = np.clip(codes.astype(np.float32), 512.0, 16383.0)
        host = (host - 512.0) / (16383.0 - 512.0 + 1e-6) * scale[:, None, None, None]
    else:
        codes = rng.integers(0, 256, (2, 30, 46, 1), dtype=np.uint8)
        scale = np.array([48.18, 15.98], np.float32)
        host = codes.astype(np.float32) / 255.0 * scale[:, None, None, None]
    got = pred.codes(codes, scale, decode)
    assert got.shape == (2, 30, 46, 3)
    np.testing.assert_allclose(got, pred(host), rtol=1e-5, atol=1e-5)
    if model == "rawformer_s" and decode == "sid":
        np.testing.assert_array_equal(got, pred.raw_u16(codes[..., 0], scale))
    np.testing.assert_allclose(pred.codes(codes[0], scale[0], decode), got[0], rtol=1e-6,
                               atol=1e-6)
    with pytest.raises(TypeError, match="codes must be"):
        pred.codes(codes.astype(np.float32), scale, decode)
    with pytest.raises(ValueError, match="decode must be"):
        pred.codes(codes, scale, "arw")


@pytest.fixture(scope="module")
def train_tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("sid_train"))
    synthetic.write_sid_tree(root, os.path.join(root, "cache"),
                             {"train": [(40, 56), (36, 52), (44, 60)], "test": [(32, 48)]},
                             np.random.default_rng(10))
    return root


@pytest.mark.parametrize("loader", ["python", "native"])
def test_train_cli_on_sid_then_eval(train_tree, tmp_path, monkeypatch, capsys, loader):
    """One epoch of RawFormer-S on the SID tree (batch 2 @ 32^2, validation
    at the full 32x48 test frame), then the eval CLI from its checkpoint."""
    import sys

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)  # ~10 s to import
    cache = os.path.join(train_tree, "cache")
    argv = ["--dataset", "SID", "--data_root", train_tree, "--cache_dir", cache,
            "--model_size", "S", "--patch_size", "32", "--batch_size", "2", "--epochs", "1",
            "--save_dir", str(tmp_path), "--device", "cpu", "--loader", loader]
    with pytest.warns(RuntimeWarning, match="TensorBoard"):
        train_cli.main(argv)
    out = capsys.readouterr().out
    label = "native (compact 16-bit H2D)" if loader == "native" else "python"
    assert f"training batch producer: {label}\n" in out
    log = (tmp_path / "SID" / "log.txt").read_text()
    assert "Epoch 0/1" in log and "Epoch 1/1" in log
    got = test_cli.main(["--dataset", "SID", "--data_root", train_tree, "--cache_dir", cache,
                         "--ckpt", str(tmp_path / "SID" / "weights"), "--device", "cpu",
                         "--save_dir", str(tmp_path / "eval")])
    assert "restored checkpoint step 1" in capsys.readouterr().out
    assert len(got["psnr"]) == 1 and np.isfinite(got["psnr"]).all()


def test_compact_batch_decodes_to_the_host_path(train_tree):
    """The engine's compact triple, decoded as ``Trainer.train_step`` decodes
    it, against the engine's fp32 batch and the Python loader's host path
    for the same crops: equal GT, inputs within one fp32 rounding (the
    decode multiplies by 1/range where numpy divides; rtol 1e-6)."""
    cache = os.path.join(train_tree, "cache")
    ds = sid.SIDDataset(*sid.discover_sid_pairs(train_tree, "train"), 32, True, cache)
    compact = native.sampler_for_dataset(ds, seed=4, compact=True)
    fp32 = native.sampler_for_dataset(ds, seed=4, compact=False)
    idxs = [2, 0, 1]
    triple = compact.sample_batch(idxs, 1)
    inp, gt = decode_batch([pipeline.to_tensor(a) for a in triple])
    raw_f, gt_f = fp32.sample_batch(idxs, 1)
    np.testing.assert_array_equal(inp.numpy(), raw_f)
    np.testing.assert_array_equal(gt.numpy(), gt_f)
    # The Python loader's host path over the same crops and flips.
    rng = np.random.default_rng((4, 1, tuple(idxs)))
    for s, idx in enumerate(idxs):
        mosaic, gt16 = ds._get_raw(idx)
        h, w = mosaic.shape
        ci = int(rng.integers(0, (h - 34) // 2 + 1)) * 2
        cj = int(rng.integers(0, (w - 34) // 2 + 1)) * 2
        flr, fud = rng.random() < 0.5, rng.random() < 0.2
        m, g = mosaic[ci:ci + 32, cj:cj + 32], gt16[ci:ci + 32, cj:cj + 32]
        m, g = (m[:, ::-1], g[:, ::-1]) if flr else (m, g)
        m, g = (m[::-1], g[::-1]) if fud else (m, g)
        ratio = sid.sid_ratio_from_filename(ds.long_paths[idx])
        host = (np.clip(m.astype(np.float32), 512.0, 16383.0) - 512.0) / (
            16383.0 - 512.0 + 1e-6) * ratio
        np.testing.assert_allclose(inp[s, ..., 0].numpy(), host, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(gt[s].numpy(), g.astype(np.float32) / 65535.0, rtol=1e-6,
                                   atol=0)


def test_eval_cli_refusals(tmp_path, monkeypatch):
    base = ["--dataset", "synthetic", "--patch_size", "32", "--save_dir", str(tmp_path)]
    with pytest.raises(SystemExit, match="one device"):
        test_cli.main(base + ["--device", "cpu", "--spatial_chips", "2"])
    orbax = tmp_path / "orbax"
    (orbax / "3").mkdir(parents=True)
    with pytest.raises(SystemExit, match="orbax.*tools/orbax_to_torch.py"):
        test_cli.main(base + ["--device", "cpu", "--ckpt", str(orbax)])
    with pytest.raises(SystemExit, match="no checkpoint found"):
        test_cli.main(base + ["--device", "cpu", "--ckpt", str(tmp_path / "missing")])
    with pytest.raises(SystemExit, match="no SID test pairs"):
        test_cli.main(["--dataset", "SID", "--data_root", str(tmp_path), "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        test_cli.main(base)


def test_eval_cli_no_fused_and_wfb_pad(tmp_path, capsys):
    """``--no_fused`` (module path) against the fused twins on the CPU, fp32;
    WFB raises ``pad_to`` to 32 (a 48x48 frame pads to 64x64)."""
    base = ["--dataset", "synthetic", "--patch_size", "32", "--fp32", "--device", "cpu",
            "--save_dir", str(tmp_path)]
    fused = test_cli.main(base)
    module = test_cli.main(base + ["--no_fused"])
    np.testing.assert_allclose(fused["psnr"], module["psnr"], rtol=0, atol=PSNR_TOL)
    np.testing.assert_allclose(fused["ssim"], module["ssim"], rtol=0, atol=SSIM_TOL)
    wfb = test_cli.main(["--dataset", "synthetic", "--patch_size", "48", "--model",
                         "rawformer_wfb", "--fp32", "--device", "cpu",
                         "--save_dir", str(tmp_path)])
    assert len(wfb["psnr"]) == 4 and np.isfinite(wfb["psnr"]).all()
