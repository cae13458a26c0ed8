"""Serving artifacts of the port (``serving/export.py``, ``cli/export_cli.py``)
on the CPU.

RawFormer S/B/L and FLCA-RawFormer at small configs round-trip through
``export_artifact`` / ``load_artifact`` to their eager output, with the
``torch.ops.blle`` operators their blocks run in the graph (the other
RAW -> RGB models: ``test_torch_export_wfb.py``,
``test_torch_export_zoo.py``); RawFormer and FLCA-RawFormer artifacts,
with the JAX package's weights carried over, give JAX's
``clip(model.apply(...), 0, 1)`` in fp32; the CLI's random-init export
mirrors the JAX package's ``tests/test_serving.py``; and the refusals: a
wrong input shape, a newer format, a raw-domain model, and the card where
there is none."""

import functools
import json
import zipfile

import numpy as np
import pytest
import torch

from bayer_low_light_image_enhancement_tpu_torch.cli import export_cli
from bayer_low_light_image_enhancement_tpu_torch.models import RawFormer, RawFormerConfig
from bayer_low_light_image_enhancement_tpu_torch.models import get_model, list_models
from bayer_low_light_image_enhancement_tpu_torch.serving import (
    Predictor,
    export_artifact,
    load_artifact,
)
from bayer_low_light_image_enhancement_tpu_torch.serving import export as export_mod

from torch_parity import (
    BLOCK_OPS,
    GRAPH_OPS,
    RAW_DOMAIN,
    SMALL,
    TOL,
    eager_rgb,
    export_case,
)

RNG = np.random.default_rng(103)
X = RNG.uniform(0, 1.2, (2, 32, 32, 1)).astype(np.float32)
# This file's models; tests/test_torch_export_wfb.py and
# test_torch_export_zoo.py take the other RAW -> RGB names (an export and
# load of a model at its small config takes 5-35 s on the CPU).
WITH_JAX = ("rawformer_s", "flca_rawformer")
NAMES = WITH_JAX + ("rawformer_b", "rawformer_l")


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """name -> ``export_case(name, ...)``, each exported once."""
    root = tmp_path_factory.mktemp("artifacts")
    get = functools.cache(lambda name: export_case(name, str(root / f"{name}.zip"), X,
                                                   name in WITH_JAX))
    get.root = root
    return get


@pytest.mark.parametrize("name", WITH_JAX)
def test_artifact_matches_jax(exported, name):
    _, fn, _, want = exported(name)
    got = fn(X)
    assert got.shape == (2, 32, 32, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("name", NAMES)
def test_artifact_round_trips_to_the_eager_model(exported, name):
    model, fn, meta, _ = exported(name)
    np.testing.assert_allclose(fn(X), eager_rgb(model, X), rtol=0, atol=1e-6)
    assert meta["ops"] == GRAPH_OPS.get(name, BLOCK_OPS)
    assert meta["device"] == "cpu" and meta["input_shape"] == [2, 32, 32, 1]
    assert meta["model"] == name and meta["clip01"] is True


def test_every_rgb_model_is_exported_by_one_file():
    import test_torch_export_wfb
    import test_torch_export_zoo

    names = NAMES + test_torch_export_wfb.NAMES + test_torch_export_zoo.NAMES
    assert sorted(names) == sorted(m for m in list_models() if m not in RAW_DOMAIN)


def test_artifact_serves_like_the_predictor(exported):
    """The artifact and ``Predictor`` on the same frames (no padding at a
    multiple of 16)."""
    model, fn, _, _ = exported("rawformer_s")
    np.testing.assert_allclose(fn(X), Predictor(model, device="cpu")(X), rtol=0, atol=1e-6)


def test_bf16_artifact_keeps_the_eager_layout(tmp_path):
    """A bf16-compute artifact equals ``Predictor`` bitwise: the graph
    keeps the model's channels-last copy of the packed input (with the
    input's C = 1 strides left ambiguous, the traced graph ran NCHW and
    rounded differently, 4.9e-4 off at dim 32)."""
    model = RawFormer(RawFormerConfig(dim=32, num_heads=(8,) * 4, dtype=torch.bfloat16),
                      generator=torch.Generator().manual_seed(2)).eval()
    path = str(tmp_path / "bf16.zip")
    export_artifact(model, None, path, 2, 64, 64, device="cpu")
    x = RNG.uniform(0, 1.2, (2, 64, 64, 1)).astype(np.float32)
    np.testing.assert_array_equal(load_artifact(path)[0](x), Predictor(model, device="cpu")(x))


def test_artifact_rejects_wrong_shape(exported):
    _, fn, _, _ = exported("rawformer_s")
    with pytest.raises(ValueError, match="expects input"):
        fn(RNG.uniform(0, 1, (2, 48, 48, 1)).astype(np.float32))
    with pytest.raises(ValueError, match="expects input"):
        fn(X[:1])


def test_artifact_refuses_a_newer_format_and_another_device(tmp_path, exported, monkeypatch):
    exported("rawformer_s")
    src = exported.root / "rawformer_s.zip"
    path = tmp_path / "newer.zip"
    with zipfile.ZipFile(src) as zin, zipfile.ZipFile(path, "w") as zout:
        for item in zin.infolist():
            data = zin.read(item)
            if item.filename == "meta.json":
                data = json.dumps({**json.loads(data),
                                   "format_version": export_mod.FORMAT_VERSION + 1})
            zout.writestr(item, data)
    with pytest.raises(ValueError, match="too new"):
        load_artifact(str(path))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="exported for cpu"):
        load_artifact(str(src), device="cuda")


def test_no_card_no_cuda_artifact(tmp_path, monkeypatch):
    """Without a card: exporting for CUDA raises, the CLI's --device cuda
    exits, and a CUDA artifact refuses to load (no CPU run of it)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = RawFormer(RawFormerConfig(dim=8, num_heads=(2, 2, 2, 2)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        export_artifact(model, None, str(tmp_path / "a.zip"), 1, 32, 32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        export_artifact(model, None, str(tmp_path / "a.zip"), 1, 32, 32, device="cuda")
    with pytest.raises(SystemExit, match="no CUDA device"):
        export_cli.main(["--height", "32", "--width", "32", "--out", str(tmp_path / "b.zip")])
    path = str(tmp_path / "c.zip")
    export_artifact(model, None, path, 1, 32, 32, device="cpu")
    with zipfile.ZipFile(path) as z:
        meta, blob = json.loads(z.read("meta.json")), z.read("model.pt2")
    with zipfile.ZipFile(path, "w") as z:
        z.writestr("meta.json", json.dumps({**meta, "device": "cuda:0"}))
        z.writestr("model.pt2", blob)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_artifact(path)


def test_raw_domain_model_is_refused(tmp_path):
    model = get_model("flca_unet", **SMALL["flca_unet"])
    with pytest.raises(ValueError, match="raw-domain"):
        export_artifact(model, None, str(tmp_path / "u.zip"), 1, 32, 32, device="cpu")
    with pytest.raises(SystemExit, match="enhancement-domain"):
        export_cli.main(["--model", "flca_unet", "--device", "cpu", "--out",
                         str(tmp_path / "u.zip")])


def test_cli_random_init_export(tmp_path, capsys):
    """The JAX package's tests/test_serving.py TestExportCli on the CPU."""
    out = str(tmp_path / "cli.zip")
    export_cli.main(["--model_size", "S", "--height", "32", "--width", "32", "--device", "cpu",
                     "--out", out])
    assert "random init" in capsys.readouterr().out
    fn, meta = load_artifact(out)
    assert meta["model"] == "rawformer_s"
    y = fn(np.zeros((1, 32, 32, 1), np.float32))
    assert y.shape == (1, 32, 32, 3)


def test_cli_exports_a_pth_checkpoint(tmp_path):
    """--pth: the artifact serves the checkpoint's weights, as
    ``Predictor.from_torch`` of the same file does (fp32 compute)."""
    src = RawFormer(RawFormerConfig.from_size("S"), generator=torch.Generator().manual_seed(9))
    pth = tmp_path / "model_best.pth"
    torch.save({"state_dict": {"module." + k: v for k, v in src.state_dict().items()}}, pth)
    out = str(tmp_path / "pth.zip")
    export_cli.main(["--pth", str(pth), "--fp32", "--batch", "2", "--height", "32", "--width",
                     "32", "--device", "cpu", "--out", out])
    fn, _ = load_artifact(out)
    want = Predictor.from_torch(RawFormer(RawFormerConfig.from_size("S")), str(pth),
                                device="cpu")(X)
    np.testing.assert_allclose(fn(X), want, rtol=0, atol=1e-6)
