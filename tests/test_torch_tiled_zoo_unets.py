"""Spatially sharded inference of the two bottleneck-attention U-Nets and
of the ops the zoo's sharded forwards add, on the CPU
(``parallel/tiled.py``): ``flca_unet`` and ``unet_luma_dwt`` at base 8
with one block a stage and two heads (tests/test_sharding.py's sizes),
tiled by four gloo ranks (``tests/torch_dist_workers.py``, one spawn) by H
and over a 2 x 2 mesh: the strided and dilated halo convs, the SE pools
and the luma max over the spatial groups, the sharded guidance resizes,
gather-kv token attention at the bottleneck, ``unet_luma_dwt``'s local Haar
split. Each rank's whole output is held against the port's monolithic
forward and JAX's monolithic forward on the same weights at the bar of
tests/test_sharding.py (fp32, rtol 1e-4; atol 3e-5 by H, 2e-5 over 2 x 2);
the fused block wrapper is called 0 times.

In the same spawn, each op against its JAX twin under ``jax.shard_map``
over 4 of the conftest's CPU devices, each rank's block (fp32): the bound
``resize_bilinear`` to the four sizes of tests/test_sharding.py's resize
test by H and to four sizes over 2 x 2, bitwise the port's monolithic
resize's block and within 3e-6 of JAX's (the two compute the taps'
weights apart: the monolithic resizes differ by up to 2.4e-6, 10 ulp, on
this N(0, 1) data when 12 columns go to 5), ``bayer_luma_chroma``'s
max normalisation, ``instance_norm``, ``frequency_split`` at 15 and 31 taps
on shards thinner than the halo (the gather branch of the halo conv) and
``TokenTransformer`` with gathered keys and values (atol 1e-5)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from torch_parity import blocks, carried, hold_tiled, jax_variables, tiled_zoo
from bayer_low_light_image_enhancement_tpu.core.mesh import create_mesh
from bayer_low_light_image_enhancement_tpu.models import flca_unet as jfu
from bayer_low_light_image_enhancement_tpu.models import luma_variants as jlv
from bayer_low_light_image_enhancement_tpu.models.lumachroma_transformer import (
    instance_norm as jax_instance_norm,
)
from bayer_low_light_image_enhancement_tpu.ops.flca import resize_bilinear as jax_resize
from bayer_low_light_image_enhancement_tpu.ops.luma import bayer_luma_chroma as jax_luma
from bayer_low_light_image_enhancement_tpu_torch.compat import jax_params as jp
from bayer_low_light_image_enhancement_tpu_torch.ops.flca import resize_bilinear

torch.set_num_threads(2)

NAMES = ("flca_unet", "unet_luma_dwt")
CASES = [(name, layout) for name in NAMES for layout in ("h", "hw")]
IDS = [f"{name}-{layout}" for name, layout in CASES]
RNG = np.random.default_rng(20)
AXES = {"h": "spatial", "hw": ("spatial", "spatial_w")}
SPECS = {"h": P(None, "spatial"), "hw": P(None, "spatial", "spatial_w")}
RESIZES = {"h": [(64, 24), (16, 6), (32, 5), (128, 12)],
           "hw": [(64, 24), (16, 6), (32, 4), (128, 12)]}


def atol(case):
    return 3e-5 if case[1] == "h" else 2e-5


def jax_sharded(fn, x, layout):
    """fn on each of 4 CPU devices' blocks of x under shard_map (by H, or
    2 x 2), the blocks put back together."""
    devices = jax.devices()[:4]
    mesh = (create_mesh(data=1, spatial=4, devices=devices) if layout == "h" else
            create_mesh(data=1, spatial=2, spatial_w=2, devices=devices))
    spec = SPECS[layout]
    return np.asarray(jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=spec, out_specs=spec))(
        jnp.asarray(x)))


def op_cases():
    """(id, "tiled_ops" case, JAX's result over the same layout, atol)."""
    out = []
    x = RNG.standard_normal((2, 32, 12, 3)).astype(np.float32)
    for layout, sizes in RESIZES.items():
        nh, nw = (4, 1) if layout == "h" else (2, 2)
        for h, w in sizes:
            want = jax_sharded(lambda t: jax_resize(t, h // nh, w // nw, AXES[layout]), x, layout)
            out.append((f"resize-{layout}-{h}x{w}",
                        dict(op="resize_bilinear", layout=layout, args=dict(x=x, h=h, w=w)),
                        want, 3e-6))
    planes = RNG.uniform(0, 1.5, (2, 32, 16, 4)).astype(np.float32)
    feats = (RNG.standard_normal((2, 32, 16, 6)) * 2 + 0.5).astype(np.float32)
    guide = RNG.uniform(0, 1, (2, 16, 16, 2)).astype(np.float32)
    tokens = RNG.standard_normal((2, 16, 8, 16)).astype(np.float32)
    jtt = jlv.SimpleTokenTransformer(num_heads=2)
    v = jax_variables(jtt, jnp.asarray(tokens))
    state = carried(jp._token_transformer, v["params"])
    for layout, ax in AXES.items():
        out.append((f"luma-{layout}", dict(op="bayer_luma_chroma", layout=layout,
                                           args=dict(x=planes)),
                    jax_sharded(lambda p: jnp.concatenate(jax_luma(p, spatial_axis=ax), -1),
                                planes, layout), 1e-5))
        out.append((f"instance_norm-{layout}", dict(op="instance_norm", layout=layout,
                                                    args=dict(x=feats)),
                    jax_sharded(lambda t: jax_instance_norm(t, spatial_axis=ax), feats, layout),
                    1e-5))
        for k in (15, 31):  # halos of 7 and 15 rows on shards of 4 or 8
            out.append((f"frequency_split{k}-{layout}",
                        dict(op="frequency_split", layout=layout, args=dict(x=guide, k=k)),
                        jax_sharded(lambda t: jnp.concatenate(
                            jfu.frequency_split(t, k, spatial_axis=ax), -1), guide, layout),
                        1e-5))
        jm = jlv.SimpleTokenTransformer(num_heads=2, spatial_axis=ax)
        out.append((f"token_transformer-{layout}",
                    dict(op="token_transformer", layout=layout,
                         args=dict(x=tokens, dim=16, heads=2, state=state)),
                    jax_sharded(lambda t: jm.apply(v, t), tokens, layout), 1e-5))
    return out


OPS = op_cases()


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return tiled_zoo(NAMES, tmp_path_factory.mktemp("tiled_zoo_unets"),
                     ops=[case for _, case, _, _ in OPS])


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_tiled_matches_the_port_monolithic_forward(results, case):
    hold_tiled(results[0][case], "port", atol(case))


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_tiled_matches_the_jax_monolithic_forward(results, case):
    r = results[0][case]
    np.testing.assert_allclose(r["port"], r["jax"], rtol=1e-4, atol=atol(case))
    hold_tiled(r, "jax", atol(case))


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_tiled_forward_launches_no_kernel(results, case):
    for got in results[0][case]["ranks"]:
        assert got["calls"] == {"fused_block": 0, "ssm_kernel": 0}


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_every_block_of_the_compared_output_varies(results, case):
    y = results[0][case]["port"]
    assert np.isfinite(y).all()
    for i, b in enumerate(blocks(y, case[1])):
        assert np.ptp(b) > 1e-2, f"block {i} is nearly constant: {np.ptp(b)}"


RESIZE_OPS = [i for i, (name, *_) in enumerate(OPS) if name.startswith("resize")]


@pytest.mark.parametrize("i", RESIZE_OPS, ids=[OPS[i][0] for i in RESIZE_OPS])
def test_sharded_resize_is_bitwise_the_monolithic_resize(results, i):
    _, case, _, _ = OPS[i]
    a = case["args"]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # as the ranks: F.interpolate's rounding follows the threads
    try:
        whole = resize_bilinear(torch.from_numpy(a["x"]), a["h"], a["w"]).numpy()
    finally:
        torch.set_num_threads(threads)
    for r, (got, block) in enumerate(zip((ranks[i] for ranks in results[1]),
                                         blocks(whole, case["layout"]))):
        np.testing.assert_array_equal(got.numpy(), block, err_msg=f"rank {r}")


@pytest.mark.parametrize("i", range(len(OPS)), ids=[name for name, *_ in OPS])
def test_op_matches_its_jax_shard_map_twin(results, i):
    _, case, want, tol = OPS[i]
    for r, (got, block) in enumerate(zip((ranks[i] for ranks in results[1]),
                                         blocks(want, case["layout"]))):
        assert got.shape == block.shape, (r, got.shape, block.shape)
        np.testing.assert_allclose(got.numpy(), block, rtol=1e-5, atol=tol, err_msg=f"rank {r}")
