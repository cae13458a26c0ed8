"""Spatially sharded inference of the FLCA / TrueColor family on the CPU
(``parallel/tiled.py``): ``flca_rawformer``, ``multilvl_flca_rawformer``,
``truecolor_rawformer`` and ``bayertorgb_rawformer`` at dim 8 with two
heads (tests/test_sharding.py's sizes), tiled by four gloo ranks
(``tests/torch_dist_workers.py``, one spawn) by H and over a 2 x 2 mesh:
sharded luma max, guidance resizes, SE pools, the pyramid's band and
chroma means and the colour anchors, halo convs, TransformerBlocks on the
module path. Each rank's whole output is held against the port's
monolithic forward and JAX's monolithic forward on the same weights (JAX
variables carried by ``compat``) at the bar of tests/test_sharding.py
(fp32, rtol 1e-4, atol 2e-5), ``flca_rawformer`` by H also against JAX's
own ``make_tiled_forward``; the head's input (``conv_out``'s whole output)
the same way, since a seeded colour correction is flat (TrueColor) or
saturated (BayerTORGB) and its RGB would hide the blocks (ROADMAP C14);
every rank's block of it varies; the fused block wrapper is called 0
times on every rank."""

import numpy as np
import pytest
import torch

from torch_parity import blocks, hold_tiled, tiled_zoo

torch.set_num_threads(2)

ATOL = 2e-5
NAMES = ("flca_rawformer", "multilvl_flca_rawformer", "truecolor_rawformer",
         "bayertorgb_rawformer")
CASES = [(name, layout) for name in NAMES for layout in ("h", "hw")]
IDS = [f"{name}-{layout}" for name, layout in CASES]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return tiled_zoo(NAMES, tmp_path_factory.mktemp("tiled_zoo_guided"),
                     jax_tiled=[("flca_rawformer", "h")])[0]


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_tiled_matches_the_port_monolithic_forward(results, case):
    hold_tiled(results[case], "port", ATOL)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_tiled_matches_the_jax_monolithic_forward(results, case):
    r = results[case]
    np.testing.assert_allclose(r["port"], r["jax"], rtol=1e-4, atol=ATOL)
    hold_tiled(r, "jax", ATOL)


def test_tiled_matches_jax_make_tiled_forward(results):
    hold_tiled(results["flca_rawformer", "h"], "jax_tiled", ATOL)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_tiled_forward_launches_no_kernel(results, case):
    for got in results[case]["ranks"]:
        assert got["calls"] == {"fused_block": 0, "ssm_kernel": 0}


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_the_head_input_matches_too(results, case):
    """``conv_out``'s whole output: the RGB of a seeded TrueColor is flat and
    BayerTORGB's saturated (ROADMAP C14), the head's input is neither."""
    r = results[case]
    np.testing.assert_allclose(r["port_head"], r["jax_head"], rtol=1e-4, atol=ATOL)
    for i, got in enumerate(r["ranks"]):
        for want in ("port_head", "jax_head"):
            np.testing.assert_allclose(got["head"].numpy(), r[want], rtol=1e-4, atol=ATOL,
                                       err_msg=f"rank {i} against {want}")


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_every_block_of_the_compared_head_input_varies(results, case):
    r = results[case]
    assert np.isfinite(r["port"]).all() and np.isfinite(r["port_head"]).all()
    for i, b in enumerate(blocks(r["port_head"], case[1])):
        assert np.ptp(b) > 1e-2, f"block {i} is nearly constant: {np.ptp(b)}"
