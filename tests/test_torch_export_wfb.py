"""Serving artifacts of RawFormer-WFB and luma-MHSA on the CPU: the WFB
artifact, with the JAX package's variables carried over, gives JAX's
``clip(model.apply(...), 0, 1)`` in fp32; both round-trip through
``export_artifact`` / ``load_artifact`` to their eager output, WFB's graph
holding S1 (``blle.selective_scan_fwd``), luma-MHSA's no ``blle`` operator.
(One file of three: an export and load of WFB at dim 8 takes ~35 s.)"""

import functools

import numpy as np
import pytest

from torch_parity import BLOCK_OPS, GRAPH_OPS, TOL, eager_rgb, export_case

X = np.random.default_rng(107).uniform(0, 1.2, (2, 32, 32, 1)).astype(np.float32)
NAMES = ("rawformer_wfb", "luma_mhsa_rawformer")


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    root = tmp_path_factory.mktemp("artifacts")
    return functools.cache(lambda name: export_case(name, str(root / f"{name}.zip"), X,
                                                    name == "rawformer_wfb"))


def test_wfb_artifact_matches_jax(exported):
    _, fn, _, want = exported("rawformer_wfb")
    np.testing.assert_allclose(fn(X), want, **TOL)


@pytest.mark.parametrize("name", NAMES)
def test_artifact_round_trips_to_the_eager_model(exported, name):
    model, fn, meta, _ = exported(name)
    np.testing.assert_allclose(fn(X), eager_rgb(model, X), rtol=0, atol=1e-6)
    assert meta["ops"] == GRAPH_OPS.get(name, BLOCK_OPS) and meta["model"] == name
