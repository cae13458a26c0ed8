"""The port's spatially sharded ops on the CPU against the JAX ops under
``shard_map``: four gloo ranks (``tests/torch_dist_workers.py``, job kind
"tiled_ops") run every case on their blocks of the same numpy inputs, and
the JAX package runs each op over ``create_mesh`` on 4 of the conftest's 8
CPU devices (as tests/test_sharding.py does). Cases: the halo ``conv2d`` at
3x3, 5x5, dilation 2, stride 2, depthwise and 1-row shards (the gather
branch), by H and by H x W; ``global_mean`` / ``global_max`` /
``global_min``; ``channel_attention`` (one product an image, and by image
rows first, a frame's route); the sequence-parallel
``selective_scan``; ``MambaBlock`` with one and two tokens a shard;
Downsample and Upsample2x bound as in a tiled model; the Haar stacks
(local); and ``parallel/tiled.shard_image`` / ``pad_to_tile`` against
JAX's. fp32, atol
1e-5, rtol 1e-4 (the ops' bar)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import torch_dist_workers as workers
from test_torch_ssm import mamba_state_dict
from bayer_low_light_image_enhancement_tpu.core.mesh import create_mesh
from bayer_low_light_image_enhancement_tpu.models import common as jcommon
from bayer_low_light_image_enhancement_tpu.ops import conv as jconv
from bayer_low_light_image_enhancement_tpu.ops import dwt as jdwt
from bayer_low_light_image_enhancement_tpu.ops import ssm as jssm
from bayer_low_light_image_enhancement_tpu.ops.attention import channel_attention
from bayer_low_light_image_enhancement_tpu.parallel import tiled as jtiled
from bayer_low_light_image_enhancement_tpu_torch.compat import jax_params as jp
from bayer_low_light_image_enhancement_tpu_torch.parallel import tiled

TOL = dict(rtol=1e-4, atol=1e-5)
WORLD = 4
AXES = {"h": ("spatial", None), "hw": ("spatial", "spatial_w")}
RNG = np.random.default_rng(19)


def jax_mesh(layout):
    devices = jax.devices()[:WORLD]
    if layout == "h":
        return create_mesh(data=1, spatial=WORLD, devices=devices)
    return create_mesh(data=1, spatial=2, spatial_w=WORLD // 2, devices=devices)


def jax_sharded(fn, layout, n_in, rank3=False):
    """``fn`` under shard_map over the layout's mesh: its n_in inputs and
    its output split along H (and W), or along the sequence (``rank3``)."""
    h, w = AXES[layout]
    spec = P(None, h) if rank3 else P(None, h, w) if w else P(None, h)
    return jax.jit(jax.shard_map(fn, mesh=jax_mesh(layout), in_specs=(spec,) * n_in,
                                 out_specs=spec))


def normal(*shape, scale=1.0):
    return (RNG.standard_normal(shape) * scale).astype(np.float32)


def conv_case(name, x_shape, k, cin, cout, layout="h", stride=1, groups=1, dilation=1):
    x = normal(*x_shape[:3], cin)
    w = normal(k, k, cin // groups, cout, scale=0.3)
    b = normal(cout)
    kw = dict(stride=stride, groups=groups, dilation=dilation)
    h, wa = AXES[layout]
    spatial = (h, wa) if wa else h
    want = jax_sharded(lambda xl: jconv.conv2d(xl, jnp.asarray(w), jnp.asarray(b),
                                               spatial_axis=spatial, **kw), layout, 1)(x)
    mono = jconv.conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), **kw)
    return name, dict(op="conv2d", layout=layout, args=dict(x=x, w=w, b=b, **kw)), \
        np.asarray(want), np.asarray(mono)


def reduce_case(op, layout):
    x = normal(2, 16, 12, 3)
    h, wa = AXES[layout]
    spatial = (h, wa) if wa else h
    fn = getattr(jconv, op)

    def local(xl):  # broadcast back to the block, so shard_map can split it
        return jnp.broadcast_to(fn(xl, (1, 2), spatial), xl.shape)

    want = jax_sharded(local, layout, 1)(x)
    mono = jnp.broadcast_to(fn(jnp.asarray(x), (1, 2)), x.shape)
    return f"{op}_{layout}", dict(op=op, layout=layout, args=dict(x=x, dims=(1, 2))), \
        np.asarray(want), np.asarray(mono)


def attention_case(layout, row_sum_tokens=None):
    """channel_attention on the layout's blocks; ``row_sum_tokens`` 0 sums
    every image by rows first (a frame's route), else one product."""
    b, h, w, c, heads = 1, 16, 8, 8, 2
    q, k, v = normal(b, h, w, c), normal(b, h, w, c), normal(b, h, w, c)
    temp = RNG.uniform(0.5, 2.0, heads).astype(np.float32)
    ha, wa = AXES[layout]
    spatial = (ha, wa) if wa else ha
    want = jax_sharded(lambda ql, kl, vl: channel_attention(ql, kl, vl, jnp.asarray(temp), heads,
                                                            spatial_axis=spatial), layout, 3)(q, k, v)
    mono = channel_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(temp),
                             heads)
    args = dict(q=q, k=k, v=v, temperature=temp, heads=heads)
    name = "channel_attention_" + ("" if row_sum_tokens is None else "rows_") + layout
    if row_sum_tokens is not None:
        args["row_sum_tokens"] = row_sum_tokens
    return name, dict(op="channel_attention", layout=layout, args=args), \
        np.asarray(want), np.asarray(mono)


def scan_case(L, chunk):
    bsz, d, n = 2, 8, 4
    u = normal(bsz, L, d)
    delta = (np.abs(normal(bsz, L, d)) * 0.5).astype(np.float32)
    A = -np.abs(normal(d, n))
    Bm, Cm, D = normal(bsz, L, n), normal(bsz, L, n), normal(d)
    want = jax_sharded(lambda u_, d_, b_, c_: jssm.selective_scan(
        u_, d_, jnp.asarray(A), b_, c_, jnp.asarray(D), chunk_size=chunk, axis_name="spatial"),
        "h", 4, rank3=True)(u, delta, Bm, Cm)
    mono = jssm.selective_scan(*(jnp.asarray(a) for a in (u, delta, A, Bm, Cm, D)), chunk_size=16)
    args = dict(u=u, delta=delta, A=A, B=Bm, C=Cm, D=D, chunk_size=chunk)
    return f"selective_scan_L{L}_chunk{chunk}", dict(op="selective_scan", args=args), \
        np.asarray(want), np.asarray(mono)


def mamba_case(L):
    """MambaBlock with L / 4 tokens a shard: one or two, fewer than the conv's
    three warm-up tokens, which then come from several shards."""
    d = 8
    x = normal(1, L, d, scale=0.3)
    mono_block = jssm.MambaBlock(d_model=d, d_state=4)
    variables = mono_block.init(jax.random.PRNGKey(L), jnp.asarray(x))
    sharded = jssm.MambaBlock(d_model=d, d_state=4, axis_name="spatial")
    want = jax_sharded(lambda xl: sharded.apply(variables, xl), "h", 1, rank3=True)(x)
    mono = mono_block.apply(variables, jnp.asarray(x))
    args = dict(x=x, d_model=d, d_state=4, state=mamba_state_dict(variables["params"]))
    return f"mamba_block_L{L}", dict(op="mamba", args=args), np.asarray(want), np.asarray(mono)


def module_case(kind, layout):
    """Downsample (a halo conv, then space_to_depth of even local rows) or
    Upsample2x (local: a 1x1 conv and depth_to_space in JAX, a 2x2 stride-2
    transposed conv in the port) on the layout's blocks."""
    x = normal(1, 16, 8, 6)
    h, wa = AXES[layout]
    spatial = (h, wa) if wa else h
    if kind == "downsample":
        jm, jsh, carry = jcommon.Downsample(), jcommon.Downsample(spatial_axis=spatial), jp._conv
        prefix, args = "body.0", dict(cin=6)
    else:
        jm = jcommon.Upsample2x(features=4)
        jsh, carry, prefix = jcommon.Upsample2x(features=4, spatial_axis=spatial), jp._upsample, ""
        args = dict(cin=6, cout=4)
    variables = jm.init(jax.random.PRNGKey(3), jnp.asarray(x))
    state = {}
    carry(variables["params"]["conv"] if kind == "downsample" else variables["params"], "m", state)
    state = {(prefix + k[1:]).lstrip("."): v for k, v in state.items()}
    want = jax_sharded(lambda xl: jsh.apply(variables, xl), layout, 1)(x)
    mono = jm.apply(variables, jnp.asarray(x))
    return f"{kind}_{layout}", dict(op="module", layout=layout,
                                    args=dict(x=x, kind=kind, state=state, **args)), \
        np.asarray(want), np.asarray(mono)


def haar_case(op, layout):
    """The batch-stacked Haar stacks of ops/dwt.py stay local: every block's
    H and W are even (JAX ops/dwt.py takes no spatial_axis)."""
    x = normal(4 if op == "haar_iwt_stack" else 1, 8, 8, 3)
    fn = getattr(jdwt, op)
    want = jax_sharded(fn, layout, 1)(x)
    return f"{op}_{layout}", dict(op=op, layout=layout, args=dict(x=x)), np.asarray(want), \
        np.asarray(fn(jnp.asarray(x)))


def gather_case(layout):
    """gather_spatial into dim 1 (the token dim of gather-kv attention): the
    same replicated result on every rank, blocks stacked H first, then W."""
    x = normal(1, 8, 4, 3)
    h, wa = AXES[layout]
    spatial = (h, wa) if wa else h
    want = jax.jit(jax.shard_map(lambda xl: jconv.gather_spatial(xl, spatial, 1),
                                 mesh=jax_mesh(layout), in_specs=(P(None, h, wa),),
                                 out_specs=P(), check_vma=False))(x)
    return f"gather_spatial_{layout}", dict(op="gather_spatial", layout=layout,
                                            args=dict(x=x)), np.asarray(want), None


def build_cases():
    cases = [
        conv_case("conv3x3_h", (1, 32, 12), 3, 4, 6),
        conv_case("conv5x5_h", (1, 32, 8), 5, 2, 3),
        conv_case("conv3x3_dilation2_h", (1, 32, 8), 3, 3, 4, dilation=2),
        conv_case("conv3x3_stride2_h", (2, 32, 10), 3, 4, 5, stride=2),
        conv_case("conv1x1_stride2_h", (1, 16, 6), 1, 3, 4, stride=2),
        conv_case("conv3x3_depthwise_h", (1, 32, 8), 3, 6, 6, groups=6),
        conv_case("conv3x3_one_row_shards_h", (1, 4, 8), 3, 3, 4),
        conv_case("conv5x5_two_row_shards_h", (1, 8, 8), 5, 2, 2),
        conv_case("conv3x3_hw", (1, 16, 12), 3, 4, 6, layout="hw"),
        conv_case("conv5x5_stride2_hw", (1, 16, 12), 5, 2, 3, layout="hw", stride=2),
        conv_case("conv3x3_one_col_shards_hw", (1, 8, 2), 3, 2, 3, layout="hw"),
    ]
    cases += [reduce_case(op, layout) for op in ("global_mean", "global_max", "global_min")
              for layout in ("h", "hw")]
    cases += [attention_case("h"), attention_case("hw"), attention_case("h", 0),
              attention_case("hw", 0)]
    cases += [scan_case(64, 8), scan_case(36, 4)]
    cases += [mamba_case(4), mamba_case(8)]
    cases += [module_case(kind, layout) for kind in ("downsample", "upsample")
              for layout in ("h", "hw")]
    cases += [haar_case("haar_dwt_stack", "h"), haar_case("haar_iwt_stack", "hw")]
    cases += [gather_case("h"), gather_case("hw")]
    return cases


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """Every case's JAX result and the four ranks' port results (one spawn)."""
    cases = build_cases()
    path = tmp_path_factory.mktemp("tiled_ops") / "job.pt"
    shards = dict(op="shard_image", args=dict(x=np.arange(2 * 16 * 12 * 3, dtype=np.float32)
                                              .reshape(2, 16, 12, 3)))
    jobs = [c[1] for c in cases] + [dict(shards, layout="h"), dict(shards, layout="hw")]
    assert [c[0] for c in cases] == CASE_NAMES
    ranks = workers.run_job(workers.write_job(path, kind="tiled_ops", cases=jobs), WORLD)
    return {name: (want, mono, [r[i] for r in ranks])
            for i, (name, _, want, mono) in enumerate(cases)}, ranks, shards["args"]["x"]


def block(a, layout, rank):
    """Rank ``rank``'s block of the global array ``a`` in the mesh order
    (H, or the sequence, over ``spatial``; W over ``spatial_w``, fastest)."""
    if layout == "h":
        n = a.shape[1] // WORLD
        return a[:, rank * n:(rank + 1) * n]
    h, w = a.shape[1] // 2, a.shape[2] // (WORLD // 2)
    i, j = divmod(rank, WORLD // 2)
    return a[:, i * h:(i + 1) * h, j * w:(j + 1) * w]


CASE_NAMES = [
    "conv3x3_h", "conv5x5_h", "conv3x3_dilation2_h", "conv3x3_stride2_h", "conv1x1_stride2_h",
    "conv3x3_depthwise_h", "conv3x3_one_row_shards_h", "conv5x5_two_row_shards_h",
    "conv3x3_hw", "conv5x5_stride2_hw", "conv3x3_one_col_shards_hw",
    "global_mean_h", "global_mean_hw", "global_max_h", "global_max_hw", "global_min_h",
    "global_min_hw", "channel_attention_h", "channel_attention_hw",
    "channel_attention_rows_h", "channel_attention_rows_hw",
    "selective_scan_L64_chunk8", "selective_scan_L36_chunk4", "mamba_block_L4", "mamba_block_L8",
    "downsample_h", "downsample_hw", "upsample_h", "upsample_hw", "haar_dwt_stack_h",
    "haar_iwt_stack_hw", "gather_spatial_h", "gather_spatial_hw",
]


@pytest.mark.parametrize("name", CASE_NAMES)
def test_sharded_op_matches_jax_shard_map(results, name):
    """Each rank's output block against the JAX op under shard_map and
    against the monolithic op (the sharded forms compute the same function)."""
    by_name, _, _ = results
    want, mono, got = by_name[name]
    layout = "hw" if name.endswith("_hw") else "h"
    if mono is None:  # a replicated result: the whole of it on every rank
        for r, g in enumerate(got):
            np.testing.assert_array_equal(g.numpy(), want, err_msg=f"{name} rank {r}")
        return
    np.testing.assert_allclose(want, mono, **TOL)
    for r, g in enumerate(got):
        np.testing.assert_allclose(g.numpy(), block(want, layout, r), **TOL,
                                   err_msg=f"{name} rank {r}")


@pytest.mark.parametrize("layout", ["h", "hw"])
def test_shard_image_matches_jax(results, layout):
    """Each rank's block from the port's shard_image is the addressable
    shard the JAX shard_image places on the mesh's device at that rank's
    position (devices in mesh order)."""
    _, ranks, x = results
    got = [r[len(CASE_NAMES) + (layout == "hw")] for r in ranks]
    mesh = jax_mesh(layout)
    h, w = AXES[layout]
    placed = jtiled.shard_image(jnp.asarray(x), mesh, h, w)
    order = list(mesh.devices.flatten())
    for s in placed.addressable_shards:
        if s.device in order:
            np.testing.assert_array_equal(got[order.index(s.device)].numpy(), np.asarray(s.data))


@pytest.mark.parametrize("h,n,multiple", [(37, 4, 16), (64, 4, 16), (70, 2, 32), (1, 3, 16)])
def test_pad_to_tile_matches_jax(h, n, multiple):
    x = RNG.uniform(0, 1, (2, h, 5, 1)).astype(np.float32)
    got, got_h = tiled.pad_to_tile(x, n, multiple)
    want, want_h = jtiled.pad_to_tile(x, n, multiple)
    assert got_h == want_h == h and got.shape[1] % (n * multiple) == 0
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("row_sum_tokens", [0, 1 << 17])
def test_channel_attention_sum_routes_match_jax(monkeypatch, row_sum_tokens):
    """On one device, both summation routes of channel_attention (by image
    rows first above ROW_SUM_TOKENS tokens, one product below) against the
    JAX op."""
    from bayer_low_light_image_enhancement_tpu_torch.ops import attention

    g = np.random.default_rng(7)
    q, k, v = (g.standard_normal((2, 12, 10, 8)).astype(np.float32) for _ in range(3))
    temp = g.uniform(0.5, 2.0, 4).astype(np.float32)
    want = np.asarray(channel_attention(*(jnp.asarray(a) for a in (q, k, v, temp)), 4))
    monkeypatch.setattr(attention, "ROW_SUM_TOKENS", row_sum_tokens)
    got = attention.channel_attention(*(torch.from_numpy(a) for a in (q, k, v, temp)), 4)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
