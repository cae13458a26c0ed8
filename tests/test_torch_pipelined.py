"""The pipelined apply pass (K3P) against the JAX package's v6 kernel, and
the ``apply_kernel`` routing through blocks, models, ``Predictor`` and the
training forward. On the CPU every route runs the plain twins; K3P itself
against its twin is in tests/test_torch_cuda.py."""

import pathlib

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from bayer_low_light_image_enhancement_tpu.kernels import fused_block as jfb
from bayer_low_light_image_enhancement_tpu.models.common import TransformerBlock as JaxBlock
from bayer_low_light_image_enhancement_tpu_torch.compat.jax_params import (
    transformer_block_state_dict,
)
from bayer_low_light_image_enhancement_tpu_torch.kernels import fused_block as fb
from bayer_low_light_image_enhancement_tpu_torch.models import RawFormer, RawFormerConfig, common
from bayer_low_light_image_enhancement_tpu_torch.serving import Predictor

torch.set_num_threads(2)


def jax_block(c, heads, seed):
    """A JAX TransformerBlock's params with non-trivial LN affines and
    temperatures, and the port's state dict of the same."""
    p = JaxBlock(num_heads=heads).init(jax.random.PRNGKey(seed), jnp.zeros((1, 8, 8, c)))["params"]
    p = jax.tree.map(np.asarray, p)
    g = np.random.default_rng(seed)
    for n in ("norm1", "norm2"):
        p[n] = {k: v + g.uniform(-0.3, 0.3, v.shape).astype(np.float32) for k, v in p[n].items()}
    p["attn"]["temperature"] = p["attn"]["temperature"] + g.uniform(-0.5, 0.5, heads).astype(
        np.float32)
    return jax.tree.map(jnp.asarray, p), transformer_block_state_dict(p)


@pytest.mark.parametrize("b,h,w,c,heads", [(4, 16, 16, 32, 1), (2, 16, 16, 64, 2)])
def test_pipelined_twin_matches_jax_v6(monkeypatch, b, h, w, c, heads):
    """The JAX block with BAYER_TPU_FUSED_V5=1 (g*C = 128: the v6 branch),
    its Pallas kernel in interpret mode, against the port's block with
    apply_kernel="pipelined" on the same weights and bf16 input: max abs err
    within 2e-2 of max|ref| (v6 computes in bf16 chains). The v6 kernel body
    is shown to run by a call counter around it."""
    calls = []
    v6 = jfb._apply_ffn_kernel_v6

    def counted(*args, **kwargs):
        calls.append(1)
        return v6(*args, **kwargs)

    monkeypatch.setattr(jfb, "_apply_ffn_kernel_v6", counted)
    monkeypatch.setenv("BAYER_TPU_FUSED_V5", "1")
    params, sd = jax_block(c, heads, seed=c + b)
    x = np.random.default_rng(c).standard_normal((b, h, w, c)).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(jfb.fused_transformer_block(xb, params, heads), np.float32)
    assert calls, "the v6 kernel did not run"
    got = fb.fused_transformer_block(torch.from_numpy(np.asarray(xb, np.float32)), sd, heads,
                                     apply_kernel="pipelined")
    assert got.shape == (b, h, w, c)
    assert np.abs(got.numpy() - want).max() <= 2e-2 * np.abs(want).max()


@pytest.mark.parametrize("c", fb.KERNEL_WIDTHS)
def test_select_apply_pass_gate(c):
    """"pipelined" takes K3P at the power-of-two widths and K3 at 48/96/192;
    "tiled" always K3."""
    want = fb.apply_pass_pipelined if c in (32, 64, 128, 256) else fb.apply_pass
    assert fb.select_apply_pass(c, "pipelined") is want
    assert fb.select_apply_pass(c, "tiled") is fb.apply_pass


@pytest.mark.parametrize("c,kernel", [(32, "pipelined"), (48, "pipelined"), (32, "tiled")])
def test_block_calls_the_selected_apply_wrapper(monkeypatch, c, kernel):
    """fused_transformer_block hands the apply pass to the wrapper the gate
    picks (K3P at C=32, K3 at C=48 under "pipelined"), inference and
    training forward alike."""
    seen = []
    for name in ("apply_pass", "apply_pass_pipelined"):
        real = getattr(fb, name)

        def spy(x, apply, w, real=real, name=name):
            seen.append(name)
            return real(x, apply, w)

        monkeypatch.setattr(fb, name, spy)
    _, sd = jax_block(c, 2, seed=3)
    x = torch.randn(1, 6, 7, c)
    with torch.no_grad():
        fb.fused_transformer_block(x, sd, 2, apply_kernel=kernel)
    fb.fused_transformer_block(x.requires_grad_(), sd, 2, apply_kernel=kernel).sum().backward()
    want = "apply_pass_pipelined" if kernel == "pipelined" and c == 32 else "apply_pass"
    assert seen == [want, want]


def test_training_forward_pipelined_matches_tiled():
    """Through FusedTransformerBlockFn (grad enabled), "pipelined" gives the
    same output and the same grads of x and of every parameter as "tiled"."""
    _, sd = jax_block(32, 4, seed=5)
    x0 = torch.randn(2, 9, 11, 32, generator=torch.Generator().manual_seed(5))
    dy = torch.randn(2, 9, 11, 32, generator=torch.Generator().manual_seed(6))
    runs = []
    for kernel in ("pipelined", "tiled"):
        params = {k: v.clone().requires_grad_() for k, v in sd.items()}
        x = x0.clone().requires_grad_()
        out = fb.fused_transformer_block(x, params, 4, apply_kernel=kernel)
        loss = (out * dy).sum()
        grads = torch.autograd.grad(loss, [x, *params.values()])
        runs.append((out.detach(), grads))
    (op, gp), (ot, gt) = runs
    torch.testing.assert_close(op, ot, rtol=0, atol=0)
    for a, b in zip(gp, gt):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_set_apply_kernel_and_predictor_route_every_block():
    """set_apply_kernel and Predictor(apply_kernel=...) set every
    TransformerBlock; the CPU result is the twin path's either way, and no
    kernel counter moves."""
    model = RawFormer(RawFormerConfig(dim=8), generator=torch.Generator().manual_seed(0))
    blocks = [m for m in model.modules() if isinstance(m, common.TransformerBlock)]
    assert len(blocks) == 7 and all(m.apply_kernel == "tiled" for m in blocks)
    m = np.random.default_rng(2).integers(0, 17000, (1, 32, 48), dtype=np.uint16)
    before = (fb.apply_pass.launches, fb.apply_pass_pipelined.launches)
    tiled = Predictor(model, device="cpu").raw_u16(m, 100.0)
    pred = Predictor(model, device="cpu", apply_kernel="pipelined")
    assert all(m.apply_kernel == "pipelined" for m in blocks)
    np.testing.assert_array_equal(pred.raw_u16(m, 100.0), tiled)
    common.set_apply_kernel(model, "tiled")
    assert all(m.apply_kernel == "tiled" for m in blocks)
    assert (fb.apply_pass.launches, fb.apply_pass_pipelined.launches) == before


def test_unknown_apply_kernel_raises():
    model = RawFormer(RawFormerConfig(dim=8), generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="apply_kernel"):
        common.set_apply_kernel(model, "fast")
    with pytest.raises(ValueError, match="apply_kernel"):
        Predictor(model, device="cpu", apply_kernel="v6")
    _, sd = jax_block(32, 2, seed=1)
    with pytest.raises(ValueError, match="apply_kernel"):
        fb.fused_transformer_block(torch.zeros(1, 4, 4, 32), sd, 2, apply_kernel="pipelined_v6")
    with pytest.raises(ValueError, match="apply_kernel"):
        fb.fused_transformer_block_plain(torch.zeros(1, 4, 4, 32), sd, 2, apply_kernel="")


def test_pipelined_wrapper_runs_twin_on_cpu():
    _, sd = jax_block(64, 2, seed=9)
    w = fb.fold_block_params(sd)
    x = torch.randn(2, 5, 6, 64)
    apply = fb.finalize_attention(*fb.gram_pass_plain(x, w), w.temperature, w.wproj, 2)
    before = fb.apply_pass_pipelined.launches
    assert torch.equal(fb.apply_pass_pipelined(x, apply, w), fb.apply_pass_plain(x, apply, w))
    assert fb.apply_pass_pipelined.launches == before


def test_port_reads_no_bayer_tpu_variable():
    """The kernel choice is an argument: no source of the port (nor
    chip_smoke.py) reads a BAYER_TPU_* environment variable."""
    root = pathlib.Path(__file__).resolve().parents[1]
    pkg = root / "bayer_low_light_image_enhancement_tpu_torch"
    reads = [(p.name, line) for p in [*pkg.rglob("*.py"), root / "chip_smoke.py"]
             for line in p.read_text().splitlines()
             if ("environ" in line or "getenv" in line) and "BAYER" in line]
    assert reads == []
