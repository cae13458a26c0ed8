"""Serving artifacts of the FLCA / TrueColor family's other three models and
WavKAN on the CPU: each round-trips through ``export_artifact`` /
``load_artifact`` to its eager output, the blocks' graphs holding K2 and K3
(``blle.gram_pass``, ``blle.apply_pass``), WavKAN's no ``blle`` operator.
(One file of three, so that the exports spread over the test workers.)"""

import functools

import numpy as np
import pytest

from torch_parity import BLOCK_OPS, GRAPH_OPS, eager_rgb, export_case

X = np.random.default_rng(109).uniform(0, 1.2, (1, 32, 32, 1)).astype(np.float32)
NAMES = ("multilvl_flca_rawformer", "truecolor_rawformer", "bayertorgb_rawformer",
         "wavkan_rawformer")


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    root = tmp_path_factory.mktemp("artifacts")
    return functools.cache(lambda name: export_case(name, str(root / f"{name}.zip"), X, False))


@pytest.mark.parametrize("name", NAMES)
def test_artifact_round_trips_to_the_eager_model(exported, name):
    model, fn, meta, _ = exported(name)
    np.testing.assert_allclose(fn(X), eager_rgb(model, X), rtol=0, atol=1e-6)
    assert meta["ops"] == GRAPH_OPS.get(name, BLOCK_OPS) and meta["model"] == name
