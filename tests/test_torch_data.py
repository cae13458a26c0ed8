"""The port's SID / MCR / raw loaders against the JAX package's (CPU):
filename rules, pair discovery and split lists on a tree of placeholder
ARWs with an npz cache, ``SIDDataset.sample`` and ``MCRDataset.sample``
bitwise equal for the same ``np.random.default_rng`` seed, the rawpy-missing
error, the metrics CSV, and the device decode of compact MCR codes."""

import os

import numpy as np
import pytest
import torch

from bayer_low_light_image_enhancement_tpu.data import mcr as jmcr
from bayer_low_light_image_enhancement_tpu.data import raw as jraw
from bayer_low_light_image_enhancement_tpu.data import sid as jsid
from bayer_low_light_image_enhancement_tpu.utils.logging import MetricsLogger as JaxMetricsLogger
from bayer_low_light_image_enhancement_tpu_torch import data
from bayer_low_light_image_enhancement_tpu_torch.data import mcr, raw, sid, synthetic
from bayer_low_light_image_enhancement_tpu_torch.ops.bayer import normalize_mcr
from bayer_low_light_image_enhancement_tpu_torch.utils.logging import MetricsLogger
from torch_trees import write_mcr_tree

LONGS = ["./Sony/long/00001_00_10s.ARW", "./Sony/long/10003_00_30s.ARW",
         "/d/Sony/long/20208_00_10s.ARW", "/d/Sony/long/00023_01_30s.ARW"]


@pytest.fixture(scope="module")
def sid_tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("sid"))
    cache = os.path.join(root, "cache")
    shapes = {"train": [(40, 56), (36, 52), (44, 60)], "test": [(32, 48), (30, 46)]}
    pairs = synthetic.write_sid_tree(root, cache, shapes, np.random.default_rng(3))
    # a second id prefix of the training split, and a short with no 0.1 s exposure
    open(os.path.join(root, "Sony/short/20000_00_0.1s.ARW"), "wb").close()
    open(os.path.join(root, "Sony/long/20000_00_10s.ARW"), "wb").close()
    open(os.path.join(root, "Sony/short/00000_00_0.04s.ARW"), "wb").close()
    return root, cache, pairs


@pytest.fixture(scope="module")
def mcr_tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("mcr"))
    return root, write_mcr_tree(root, {"train": [(40, 56), (36, 52)], "test": [(32, 48)]},
                                np.random.default_rng(4))


@pytest.mark.parametrize("path", LONGS)
def test_sid_ratio_from_filename_matches_jax(path):
    assert sid.sid_ratio_from_filename(path) == jsid.sid_ratio_from_filename(path)


def test_levels_and_exports():
    assert (sid.BLACK_LEVEL, sid.WHITE_LEVEL) == (jsid.BLACK_LEVEL, jsid.WHITE_LEVEL)
    assert synthetic.BLACK_LEVEL is sid.BLACK_LEVEL and synthetic.WHITE_LEVEL is sid.WHITE_LEVEL
    import bayer_low_light_image_enhancement_tpu.data as jdata

    assert set(jdata.__all__) <= set(data.__all__)


@pytest.mark.parametrize("split", ["train", "test"])
def test_discover_sid_pairs_matches_jax(sid_tree, split):
    root, _, pairs = sid_tree
    got = sid.discover_sid_pairs(root, split)
    assert got == jsid.discover_sid_pairs(root, split)
    shorts, longs = got
    assert len(shorts) == len(longs) == (4 if split == "train" else 2)
    assert set(pairs[split][0]) <= set(shorts)


def test_parse_sid_list_matches_jax(tmp_path):
    p = tmp_path / "Sony_test_list.txt"
    p.write_text("./Sony/short/10003_00_0.1s.ARW ./Sony/long/10003_00_10s.ARW ISO200 F9\n"
                 "\n"
                 "Sony/short/10006_00_0.04s.ARW ./Sony/long/10006_00_30s.ARW ISO100 F8\n"
                 "lonely\n")
    for root in ("", "/data"):
        got = sid.parse_sid_list(str(p), root)
        assert got == jsid.parse_sid_list(str(p), root) and len(got[0]) == 2


def test_cache_path_and_loads_match_jax(sid_tree):
    root, cache, pairs = sid_tree
    short, long = pairs["test"][0][0], pairs["test"][1][0]
    assert raw.cache_path(cache, short) == jraw._cache_path(cache, short) == os.path.join(
        cache, "10000_00_0.1s.ARW.npz")
    m, g = raw.load_short(short, cache), raw.load_long(long, cache)
    assert m.dtype == np.uint16 and m.shape == (32, 48)
    assert g.dtype == np.uint16 and g.shape == (32, 48, 3)
    assert 512 <= m.min() and m.max() <= 16383
    np.testing.assert_array_equal(m, jraw.load_short(short, cache))
    np.testing.assert_array_equal(g, jraw.load_long(long, cache))


@pytest.mark.parametrize("training", [True, False])
@pytest.mark.parametrize("device_normalize", [False, True])
@pytest.mark.parametrize("preload", [True, False])
def test_sid_sample_matches_jax_bitwise(sid_tree, training, device_normalize, preload):
    root, cache, pairs = sid_tree
    split = "train" if training else "test"
    kw = dict(patch_size=16, training=training, cache_dir=cache, preload=preload,
              device_normalize=device_normalize)
    port = sid.SIDDataset(*pairs[split], **kw)
    ref = jsid.SIDDataset(*pairs[split], **kw)
    assert len(port) == len(ref)
    for idx in range(len(port)):
        for seed in (0, 7):
            got = port.sample(idx, np.random.default_rng(seed))
            want = ref.sample(idx, np.random.default_rng(seed))
            for g, w in zip(got, want):
                assert g.dtype == w.dtype and g.shape == w.shape
                np.testing.assert_array_equal(g, w)
            size = (16, 16) if training else port._get_raw(idx)[0].shape
            assert got[0].shape == tuple(size) + (1,)
            assert got[0].dtype == (np.uint16 if device_normalize else np.float32)


@pytest.mark.parametrize("path", ["/x/C00007_48mp_0x8_0x00ff.png", "/x/C00612_48mp_0x8_0x0040.png",
                                  "train_raw_C00499_48mp_0x8_0x0100.png"])
def test_mcr_amplification_matches_jax(path):
    assert mcr.mcr_amplification(path) == jmcr.mcr_amplification(path)


@pytest.mark.parametrize("training", [True, False])
@pytest.mark.parametrize("device_normalize", [False, True])
def test_mcr_sample_matches_jax_bitwise(mcr_tree, training, device_normalize):
    _, pairs = mcr_tree
    split = "train" if training else "test"
    kw = dict(patch_size=16, training=training, device_normalize=device_normalize)
    port, ref = mcr.MCRDataset(*pairs[split], **kw), jmcr.MCRDataset(*pairs[split], **kw)
    for idx in range(len(port)):
        for seed in (1, 5):
            got = port.sample(idx, np.random.default_rng(seed))
            want = ref.sample(idx, np.random.default_rng(seed))
            for g, w in zip(got, want):
                assert g.dtype == w.dtype and g.shape == w.shape
                np.testing.assert_array_equal(g, w)


def test_mcr_device_decode_matches_host_path(mcr_tree):
    """The compact sample's uint8 codes through ``normalize_mcr`` give the
    host fp32 input (one fp32 division and product each; tolerance 1e-6)."""
    _, pairs = mcr_tree
    host = mcr.MCRDataset(*pairs["test"], training=False)
    comp = mcr.MCRDataset(*pairs["test"], training=False, device_normalize=True)
    inp_f, gt_f, amp = host.sample(0, np.random.default_rng(0))
    inp8, gt_c, amp_c = comp.sample(0, np.random.default_rng(0))
    assert inp8.dtype == np.uint8 and amp == amp_c
    dec = normalize_mcr(torch.from_numpy(inp8), torch.tensor(amp_c)).numpy()
    np.testing.assert_allclose(dec, inp_f, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(gt_f, gt_c)


@pytest.mark.parametrize("which", ["short", "long"])
def test_rawpy_missing_error_matches_jax(monkeypatch, tmp_path, which):
    """Without rawpy and without a cache entry the load raises the JAX
    package's RuntimeError, word for word."""
    monkeypatch.setattr(raw, "HAVE_RAWPY", False)
    monkeypatch.setattr(jraw, "HAVE_RAWPY", False)
    path = str(tmp_path / "00001_00_0.1s.ARW")
    port_fn = raw.load_short if which == "short" else raw.load_long
    jax_fn = jraw.load_short if which == "short" else jraw.load_long
    with pytest.raises(RuntimeError) as want:
        jax_fn(path, str(tmp_path))
    with pytest.raises(RuntimeError) as got:
        port_fn(path, str(tmp_path))
    assert str(got.value) == str(want.value) and "rawpy is not available" in str(got.value)
    with pytest.raises(RuntimeError, match="rawpy is not available"):
        raw.cache_decode(path, path, str(tmp_path / "cache"))


def test_metrics_csv_matches_jax(tmp_path):
    psnrs, ssims = [30.12345, 31.5, 7.0], [0.91, 0.923456, 0.0]
    MetricsLogger().write_metrics_csv(str(tmp_path / "port" / "csv" / "m.csv"), psnrs, ssims)
    JaxMetricsLogger().write_metrics_csv(str(tmp_path / "jax.csv"), psnrs, ssims)
    got = (tmp_path / "port" / "csv" / "m.csv").read_text()
    assert got == (tmp_path / "jax.csv").read_text()
    assert got.splitlines()[0] == "30.1234,0.9100" and len(got.splitlines()) == 3
