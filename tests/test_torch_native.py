"""The port's native C++ batch engine (``data/native.py`` over its own
``csrc/bayer_pipeline.cpp``) against the JAX package's engine and the numpy
path (CPU): the assembled batches bitwise, the samplers' batches for the
same seed, where the library is built (the package's ``_build/``, never the
repository's ``csrc/``), builds started together, and the train CLI's
``--loader native`` without a compiler."""

import os
import subprocess
import sys

import numpy as np
import pytest

from bayer_low_light_image_enhancement_tpu.data import native as jnative
from bayer_low_light_image_enhancement_tpu.data import sid as jsid
from bayer_low_light_image_enhancement_tpu_torch.cli import train_cli
from bayer_low_light_image_enhancement_tpu_torch.data import native, sid, synthetic
from bayer_low_light_image_enhancement_tpu_torch.data.sid import BLACK_LEVEL, WHITE_LEVEL

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RNG = np.random.default_rng(53)
CROPS = np.array([[0, 0], [2, 4], [10, 20]], np.int32)
FLIPS = np.array([[0, 0], [1, 0], [1, 1]], np.uint8)
RATIOS = np.array([100.0, 300.0, 1.0], np.float32)


def frames(n=3, h=48, w=64):
    mosaics = [RNG.integers(0, 40000, (h, w), dtype=np.uint16) for _ in range(n)]
    gts16 = [RNG.integers(0, 65536, (h, w, 3), dtype=np.uint16) for _ in range(n)]
    return mosaics, gts16, [g.astype(np.float32) / 65535.0 for g in gts16]


def numpy_path(mosaic, gt, ci, cj, flr, fud, ratio, patch):
    """The reference's crop, flips and normalisation in numpy."""
    m, g = mosaic[ci:ci + patch, cj:cj + patch], gt[ci:ci + patch, cj:cj + patch]
    if flr:
        m, g = m[:, ::-1], g[:, ::-1]
    if fud:
        m, g = m[::-1], g[::-1]
    mf = np.clip(m.astype(np.float32), BLACK_LEVEL, WHITE_LEVEL)
    return (mf - BLACK_LEVEL) / (WHITE_LEVEL - BLACK_LEVEL + 1e-6) * ratio, m, g


@pytest.mark.parametrize("patch", [32, 30])
def test_assemble_batch_matches_jax_and_numpy(patch):
    mosaics, _, gts = frames()
    got = native.assemble_batch(mosaics, gts, CROPS, FLIPS, RATIOS, patch)
    want = jnative.assemble_batch(mosaics, gts, CROPS, FLIPS, RATIOS, patch)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float32 and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    raw, gt = got
    for i in range(3):
        norm, _, g = numpy_path(mosaics[i], gts[i], *CROPS[i], *FLIPS[i], RATIOS[i], patch)
        np.testing.assert_array_equal(gt[i], g)
        # the engine multiplies by 1/range where numpy divides: 1 ulp
        np.testing.assert_allclose(raw[i, ..., 0], norm, rtol=1e-6, atol=1e-6)


def test_assemble_batch_compact_matches_jax_and_numpy():
    mosaics, gts16, _ = frames()
    got = native.assemble_batch_compact(mosaics, gts16, CROPS, FLIPS, 32)
    want = jnative.assemble_batch_compact(mosaics, gts16, CROPS, FLIPS, 32)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.uint16
        np.testing.assert_array_equal(g, w)
    for i in range(3):
        _, codes, g = numpy_path(mosaics[i], gts16[i], *CROPS[i], *FLIPS[i], RATIOS[i], 32)
        np.testing.assert_array_equal(got[0][i, ..., 0], codes)
        np.testing.assert_array_equal(got[1][i], g)


def test_gt16_to_float_matches_jax_and_numpy():
    gt16 = np.arange(65536, dtype=np.uint16).reshape(64, 1024)
    got = native.gt16_to_float(gt16)
    np.testing.assert_array_equal(got, jnative.gt16_to_float(gt16))
    np.testing.assert_array_equal(got, gt16.astype(np.float32) * np.float32(1 / 65535))
    # x (1/65535) where numpy divides by 65535: within one fp32 ulp
    np.testing.assert_allclose(got, gt16.astype(np.float32) / 65535.0, rtol=2 ** -23, atol=0)


def test_out_of_bounds_crop_raises():
    mosaics, gts16, gts = frames(n=1, h=32, w=32)
    with pytest.raises(RuntimeError, match="code 2"):
        native.assemble_batch(mosaics, gts, np.array([[20, 0]], np.int32),
                              np.zeros((1, 2), np.uint8), np.ones(1, np.float32), 32)
    with pytest.raises(RuntimeError, match="code 2"):
        native.assemble_batch_compact(mosaics, gts16, np.array([[0, 2]], np.int32),
                                      np.zeros((1, 2), np.uint8), 32)


@pytest.mark.parametrize("fault", ["strided_mosaic", "gt_dtype", "gt_shape", "batch_length"])
def test_malformed_frames_raise_before_the_engine(fault):
    """Frames the C engine would misread are refused in Python (ValueError)."""
    mosaics, gts16, _ = frames(n=2)
    crops, flips = CROPS[:2], FLIPS[:2]
    if fault == "strided_mosaic":
        mosaics[1] = np.ascontiguousarray(np.tile(mosaics[1], 2))[:, ::2]
    elif fault == "gt_dtype":
        gts16[0] = gts16[0].astype(np.int32)
    elif fault == "gt_shape":
        gts16[1] = np.ascontiguousarray(gts16[1][:, :-2])
    else:
        crops = CROPS
    with pytest.raises(ValueError):
        native.assemble_batch_compact(mosaics, gts16, crops, flips, 32)


@pytest.mark.parametrize("compact", [False, True])
def test_batch_sampler_matches_jax(compact):
    mosaics, gts16, gts = frames(n=4)
    src = gts16 if compact else gts
    port = native.NativeBatchSampler(mosaics, src, [100.0, 300.0, 100.0, 250.0], 32, seed=5,
                                     compact=compact)
    ref = jnative.NativeBatchSampler(mosaics, src, [100.0, 300.0, 100.0, 250.0], 32, seed=5,
                                     compact=compact)
    for idxs, epoch in (([0, 2], 1), ([3, 1, 2], 1), ([0, 2], 2)):
        got, want = port.sample_batch(idxs, epoch), ref.sample_batch(idxs, epoch)
        assert len(got) == (3 if compact else 2) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    assert not np.array_equal(port.sample_batch([0, 2], 1)[0], port.sample_batch([0, 2], 2)[0])


@pytest.fixture(scope="module")
def sid_train(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("sid"))
    pairs = synthetic.write_sid_tree(root, os.path.join(root, "cache"),
                                     {"train": [(40, 56), (36, 52), (44, 60), (40, 40)]},
                                     np.random.default_rng(6))
    return pairs["train"], os.path.join(root, "cache")


@pytest.mark.parametrize("compact", [False, True])
def test_native_loader_over_sid_matches_jax(sid_train, compact):
    """``sampler_for_dataset`` + ``NativeLoader`` over a preloaded SID
    split: the port's batches equal the JAX package's, two epochs."""
    (shorts, longs), cache = sid_train
    port_ds = sid.SIDDataset(shorts, longs, 32, True, cache)
    jax_ds = jsid.SIDDataset(shorts, longs, 32, True, cache)
    loaders = []
    for mod, ds in ((native, port_ds), (jnative, jax_ds)):
        sampler = mod.sampler_for_dataset(ds, seed=3, compact=compact)
        loaders.append(mod.NativeLoader(ds, sampler, 2, seed=3))
    assert len(loaders[0]) == len(loaders[1]) == 2
    for _ in range(2):
        got, want = list(loaders[0]), list(loaders[1])
        assert len(got) == len(want) == 2
        for bg, bw in zip(got, want):
            assert len(bg) == (3 if compact else 2)
            for g, w in zip(bg, bw):
                np.testing.assert_array_equal(g, w)
    if compact:
        raw16, ratio, gt16 = got[0]
        assert raw16.dtype == gt16.dtype == np.uint16 and set(ratio) <= {100.0, 300.0}


def test_sampler_for_dataset_declines_like_jax(sid_train):
    (shorts, longs), cache = sid_train
    evals = (sid.SIDDataset(shorts, longs, 32, False, cache),
             jsid.SIDDataset(shorts, longs, 32, False, cache))
    lazy = (sid.SIDDataset(shorts, longs, 32, True, cache, preload=False),
            jsid.SIDDataset(shorts, longs, 32, True, cache, preload=False))
    small = (sid.SIDDataset(shorts, longs, 40, True, cache),
             jsid.SIDDataset(shorts, longs, 40, True, cache))  # a 40x40 frame < patch + 2
    for port_ds, jax_ds in (evals, lazy, small):
        assert native.sampler_for_dataset(port_ds) is None
        assert jnative.sampler_for_dataset(jax_ds) is None
    synth = synthetic.SyntheticBayerDataset(num_images=2, full_size=(40, 40), patch_size=32)
    for compact in (False, True):
        s = native.sampler_for_dataset(synth, compact=compact)
        assert s is not None and s.compact == compact and s.gts[0].dtype == (
            np.uint16 if compact else np.float32)


def test_library_lands_in_the_package_build_dir():
    so = native.library_path()
    pkg = os.path.join(REPO, "bayer_low_light_image_enhancement_tpu_torch")
    assert os.path.dirname(so) == os.path.join(pkg, "_build")
    assert str(native.SOURCE) == os.path.join(pkg, "csrc", "bayer_pipeline.cpp")
    assert native.native_available() and so.exists()
    root_csrc = os.path.join(REPO, "csrc")
    assert not [f for f in os.listdir(root_csrc) if f.startswith("libbayer_pipeline_")]
    assert all(not p.name.endswith(".tmp") for p in so.parent.iterdir())


def test_builds_started_together_make_one_library(tmp_path):
    """Three processes build into an empty directory at once: the lock lets
    one compile, all three load the same file, no temporary is left."""
    code = (
        "import sys\n"
        "from pathlib import Path\n"
        "from bayer_low_light_image_enhancement_tpu_torch.data import native\n"
        "native.BUILD_DIR = Path(sys.argv[1])\n"
        "assert native.native_available(), native._build_error\n"
        "print(native.library_path())\n"
    )
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)], cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(3)]
    outs = [p.communicate(timeout=240) for p in procs]
    assert all(p.returncode == 0 for p in procs), [o[1][-2000:] for o in outs]
    assert len({o[0].strip() for o in outs}) == 1
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(
        ["bayer_pipeline.lock", os.path.basename(outs[0][0].strip())])


@pytest.fixture
def no_compiler(monkeypatch, tmp_path):
    """The engine as on a machine without g++: an empty build directory and
    an empty PATH."""
    empty = tmp_path / "bin"
    empty.mkdir()
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_error", None)
    monkeypatch.setenv("PATH", str(empty))


def test_loader_native_raises_without_a_compiler(no_compiler, tmp_path, capsys):
    assert not native.native_available() and "g++ not found" in native._build_error
    with pytest.raises(RuntimeError, match="native pipeline unavailable"):
        native.assemble_batch_compact(*frames(n=1)[:2], CROPS[:1], FLIPS[:1], 32)
    gt16 = RNG.integers(0, 65536, (4, 4, 3), dtype=np.uint16)
    np.testing.assert_array_equal(native.gt16_to_float(gt16), gt16.astype(np.float32) / 65535.0)
    argv = ["--dataset", "synthetic", "--patch_size", "32", "--batch_size", "2", "--epochs", "0",
            "--save_dir", str(tmp_path / "run"), "--device", "cpu"]
    with pytest.raises(SystemExit, match="--loader native.*g\\+\\+ not found"):
        train_cli.main(argv + ["--loader", "native"])
    args = train_cli.build_parser().parse_args(argv)
    loader, kind = train_cli.build_train_loader(args, train_cli.build_split(args, True))
    assert kind == "python" and type(loader).__name__ == "Loader"
