"""The port's ``utils/flops.py`` and the ``torch.ops.blle`` operators'
formulas and registrations (``kernels/ops.py``), on the CPU.

Each operator's flop formula equals ``FlopCounterMode``'s count of its twin
on the same shapes, as exact integers, and ``torch.library.opcheck``
passes for each on CPU tensors; ``count_params`` equals the JAX package's
on every registry model; ``model_complexity`` of a fused model equals the
count of the same model through the twins.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from bayer_low_light_image_enhancement_tpu.models import get_model as jax_get_model
from bayer_low_light_image_enhancement_tpu.utils.flops import count_params as jax_count_params
from bayer_low_light_image_enhancement_tpu_torch.kernels import fused_block as fb
from bayer_low_light_image_enhancement_tpu_torch.kernels import ops
from bayer_low_light_image_enhancement_tpu_torch.kernels import ssm_scan as ssk
from bayer_low_light_image_enhancement_tpu_torch.models import common, get_model, list_models
from bayer_low_light_image_enhancement_tpu_torch.models.common import set_fused_blocks
from bayer_low_light_image_enhancement_tpu_torch.ops import ssm
from bayer_low_light_image_enhancement_tpu_torch.utils import flops
from bayer_low_light_image_enhancement_tpu_torch.utils.profiling import cost_analysis

from torch_parity import RAW_DOMAIN, SMALL

RNG = np.random.default_rng(91)


def block_case(b, h, w, c, seed=0):
    """x [b,h,w,c], folded weights of a seeded TransformerBlock, an apply."""
    blk = common.TransformerBlock(c, 2, 2)
    common.reset_parameters_(blk, torch.Generator().manual_seed(seed))
    wts = fb.fold_block_params({k: v.detach() for k, v in blk.named_parameters()})
    g = np.random.default_rng(seed)
    x = torch.from_numpy(g.standard_normal((b, h, w, c)).astype(np.float32))
    apply = torch.from_numpy(g.standard_normal((b, c, c)).astype(np.float32) / c)
    return x, wts, apply


def scan_case(b, L, d, n, seed=0):
    g = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(g.standard_normal(s).astype(np.float32))  # noqa: E731
    dt = torch.from_numpy(g.uniform(0.01, 0.2, (b, L, d)).astype(np.float32))
    A = -torch.from_numpy(g.uniform(0.5, 2.0, (d, n)).astype(np.float32))
    return f(b, L, d), dt, A, f(b, L, n), f(b, L, n), f(d)


def counted(fn, *args):
    with FlopCounterMode(display=False) as m:
        fn(*args)
    return m.get_total_flops()


@pytest.mark.parametrize("shape", [(2, 5, 7, 16), (1, 9, 4, 32), (3, 3, 3, 8)])
def test_block_formulas_count_what_the_twins_compute(shape):
    x, wts, apply = block_case(*shape)
    want = counted(fb.gram_pass_plain, x, wts)
    assert counted(fb.gram_pass, x, wts) == want == ops.gram_pass_flops(*shape)
    want = counted(fb.apply_pass_plain, x, apply, wts)
    assert want == ops.apply_pass_flops(*shape)
    assert counted(fb.apply_pass, x, apply, wts) == want
    assert counted(fb.apply_pass_pipelined, x, apply, wts) == want


@pytest.mark.parametrize("b,L,d,n", [(2, 40, 6, 4), (1, 300, 16, 32)])
def test_scan_formula_counts_what_the_twin_computes(b, L, d, n):
    args = scan_case(b, L, d, n)
    want = counted(lambda *a: ssm.selective_scan(*a, chunk_size=ssk.TWIN_CHUNK), *args)
    assert want == ops.selective_scan_flops(b, L, d, n)
    assert counted(ssk.selective_scan_fwd, *args) == want


def op_cases():
    x, wts, apply = block_case(2, 6, 5, 16)
    u, dt, A, B, C, D = scan_case(2, 70, 6, 4)
    return {
        "gram_pass": (x, *wts.gram_tensors()),
        "apply_pass": (x, apply, *wts.apply_tensors()),
        "apply_pass_pipelined": (x, apply, *wts.apply_tensors()),
        # a transposed u, as MambaBlock hands it over
        "selective_scan_fwd": (u.transpose(1, 2).contiguous().transpose(1, 2), dt, A, B, C, D),
    }


@pytest.mark.parametrize("name", ["gram_pass", "apply_pass", "apply_pass_pipelined",
                                  "selective_scan_fwd"])
def test_opcheck_on_cpu(name):
    op = getattr(torch.ops.blle, name).default
    args = op_cases()[name]
    torch.library.opcheck(op, args)
    out = op(*args)
    # The twins are what the CPU implementations run; the outputs are fresh.
    assert all(out.data_ptr() != a.data_ptr() for a in args)


def test_ops_run_the_twins_on_cpu():
    cases = op_cases()
    x, wqk, bqk, dwqk, bdwqk = cases["gram_pass"]
    packed = torch.ops.blle.gram_pass(*cases["gram_pass"])
    gram, qss, kss = fb.gram_pass_plain(x, fb.BlockWeights(
        wqk, bqk, dwqk, bdwqk, *[None] * 13))
    c = x.shape[-1]
    assert torch.equal(packed, torch.cat([gram.flatten(1), qss, kss], 1))
    assert packed.shape == (2, c * c + 2 * c) and packed.dtype == torch.float32
    y = torch.ops.blle.apply_pass(*cases["apply_pass"])
    assert torch.equal(y, torch.ops.blle.apply_pass_pipelined(*cases["apply_pass_pipelined"]))
    u = cases["selective_scan_fwd"][0]
    y = torch.ops.blle.selective_scan_fwd(*cases["selective_scan_fwd"])
    assert y.is_contiguous() and y.shape == u.shape
    torch.testing.assert_close(y, ssm.selective_scan_ref(*cases["selective_scan_fwd"]),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("name", sorted(SMALL))
def test_count_params_matches_jax(name):
    """The port's parameters against the JAX package's ``count_params`` of
    its params (``jax.eval_shape`` of the init: shapes only)."""
    kw = SMALL[name]
    x = jnp.zeros((1, 32, 32, 4 if name in RAW_DOMAIN else 1))
    shapes = jax.eval_shape(jax_get_model(name, **kw).init, jax.random.PRNGKey(0), x)
    assert flops.count_params(get_model(name, **kw)) == jax_count_params(shapes["params"])


def test_every_registry_model_is_counted():
    assert sorted(SMALL) == list_models()


@pytest.mark.parametrize("name,shape", [("rawformer_s", (2, 32, 48, 1)),
                                        ("rawformer_wfb", (1, 32, 32, 1)),
                                        ("flca_rawformer", (1, 32, 32, 1)),
                                        ("flca_unet", (1, 16, 16, 4))])
def test_model_complexity_counts_the_twin_path(name, shape):
    """The kernels' formulas inside a model: its flops equal those of the
    same model with every block and scan through the twins (the module
    path's blocks compute the same function in other products)."""
    model = get_model(name, generator=torch.Generator().manual_seed(0), **SMALL[name])
    got = flops.model_complexity(model, shape)
    assert got["params"] == flops.count_params(model) and got["bytes_accessed"] is None
    assert got["flops"] > 0
    saved = common.fused_transformer_block
    common.fused_transformer_block = fb.fused_transformer_block_plain
    try:
        for m in model.modules():
            if isinstance(m, ssm.MambaBlock):
                m.fused = False
        with torch.no_grad():
            want = cost_analysis(model, torch.zeros(shape).permute(0, 3, 1, 2))
    finally:
        common.fused_transformer_block = saved
        set_fused_blocks(model, True)
    assert got["flops"] == want["flops"]
    if name != "flca_unet":  # no TransformerBlock, no scan: no blle operator
        with torch.no_grad():
            by_op = cost_analysis(model, torch.zeros(shape).permute(0, 3, 1, 2))
        assert any(k.startswith("blle.") for k in by_op)
