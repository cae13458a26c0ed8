"""Spatially sharded inference of the token-attention and KAN models on the
CPU (``parallel/tiled.py``): ``luma_mhsa_rawformer`` and
``wavkan_rawformer`` at dim 8 with two heads, ``simple_flca_unet`` at base
8 and ``lumachroma_transformer`` at base 8 with one block a stage
(tests/test_sharding.py's sizes), tiled by four gloo ranks
(``tests/torch_dist_workers.py``, one spawn) by H and over a 2 x 2 mesh:
gather-kv token attention (queries local, keys / values gathered along
every sharded axis), the luma's min / max and the inverse-luma mean,
InstanceNorm means, the 7 / 15 / 31-tap box splits through halos or the
gather branch, the guidance resizes, WavKAN's channel-attention sums,
halo convs. Each rank's whole output is held against the port's
monolithic forward and JAX's monolithic forward on the same weights (JAX
variables carried by ``compat``) at the bar of tests/test_sharding.py
(fp32, rtol 1e-4; atol 2e-5, 3e-5 for the raw-domain models by H),
``luma_mhsa_rawformer`` over 2 x 2 and ``lumachroma_transformer`` by H
also against JAX's own ``make_tiled_forward``; the fused block wrapper is
called 0 times on every rank, and every rank's block of each compared
output varies."""

import numpy as np
import pytest
import torch

from torch_parity import RAW_DOMAIN, blocks, hold_tiled, tiled_zoo

torch.set_num_threads(2)

NAMES = ("luma_mhsa_rawformer", "wavkan_rawformer", "simple_flca_unet",
         "lumachroma_transformer")
CASES = [(name, layout) for name in NAMES for layout in ("h", "hw")]
IDS = [f"{name}-{layout}" for name, layout in CASES]
JAX_TILED = [("luma_mhsa_rawformer", "hw"), ("lumachroma_transformer", "h")]


def atol(case):
    return 3e-5 if case[0] in RAW_DOMAIN and case[1] == "h" else 2e-5


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return tiled_zoo(NAMES, tmp_path_factory.mktemp("tiled_zoo_tokens"), jax_tiled=JAX_TILED)[0]


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_tiled_matches_the_port_monolithic_forward(results, case):
    hold_tiled(results[case], "port", atol(case))


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_tiled_matches_the_jax_monolithic_forward(results, case):
    r = results[case]
    np.testing.assert_allclose(r["port"], r["jax"], rtol=1e-4, atol=atol(case))
    hold_tiled(r, "jax", atol(case))


@pytest.mark.parametrize("case", JAX_TILED, ids=[f"{n}-{l}" for n, l in JAX_TILED])
def test_tiled_matches_jax_make_tiled_forward(results, case):
    hold_tiled(results[case], "jax_tiled", atol(case))


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_tiled_forward_launches_no_kernel(results, case):
    for got in results[case]["ranks"]:
        assert got["calls"] == {"fused_block": 0, "ssm_kernel": 0}


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_every_block_of_the_compared_output_varies(results, case):
    y = results[case]["port"]
    assert np.isfinite(y).all()
    for i, b in enumerate(blocks(y, case[1])):
        assert np.ptp(b) > 1e-2, f"block {i} is nearly constant: {np.ptp(b)}"
