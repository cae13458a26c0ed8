"""The port's RawFormer-WFB against the JAX package (CPU): both Haar DWT
flavours, FEB / FFAB (the JAX FFT path, its CPU default), the gated
FeedForward with its BatchNorm running stats, WM and WMB in both token
layouts, the full model at dim 8 through ``wfb_state_dict_from_jax`` and
back through ``import_wfb_state_dict``, a WMB lockstep with optax, the WFB
Trainer and CLI on the CPU, and the Predictor / CLI repairs (run on the card
unless asked for the CPU, ``pad_to``). fp32 tolerance 1e-4 unless stated."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from bayer_low_light_image_enhancement_tpu.compat.torch_import import import_wfb_state_dict
from bayer_low_light_image_enhancement_tpu.models import wfb as jwfb
from bayer_low_light_image_enhancement_tpu.ops import dwt as jdwt
from bayer_low_light_image_enhancement_tpu.ops import fft as jfft
from bayer_low_light_image_enhancement_tpu.ops import rep_conv as jrep
from bayer_low_light_image_enhancement_tpu_torch.cli import train_cli
from bayer_low_light_image_enhancement_tpu_torch.compat import jax_params as jp
from bayer_low_light_image_enhancement_tpu_torch.compat import wfb_state_dict_from_jax
from bayer_low_light_image_enhancement_tpu_torch.models import RawFormerWFB, RawFormerWFBConfig
from bayer_low_light_image_enhancement_tpu_torch.models import wfb
from bayer_low_light_image_enhancement_tpu_torch.ops import dwt, fft, rep_conv
from bayer_low_light_image_enhancement_tpu_torch.serving import Predictor
from bayer_low_light_image_enhancement_tpu_torch.train import TrainConfig, Trainer

torch.set_num_threads(2)

RNG = np.random.default_rng(41)
TOL = dict(rtol=1e-4, atol=1e-4)


def nhwc(shape, lo=-1.0, hi=1.0):
    return RNG.uniform(lo, hi, shape).astype(np.float32)


def to_port(x):
    """NHWC numpy -> NCHW channels_last tensor."""
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def from_port(y):
    return y.detach().permute(0, 2, 3, 1).numpy()


def jax_variables(module, x, seed, *args):
    """Variables of ``module`` at input x (eval_shape: tracing only), filled
    from a seed: fan-in-scaled kernels, norm scales near 1, BN running
    variances in [0.5, 1.5], A_log near log(1..N)."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), jnp.asarray(x), *args)
    g = np.random.default_rng(seed)

    def fill(path, s):
        name = jax.tree_util.keystr(path)
        v = g.uniform(-1.0, 1.0, s.shape)
        if "kernel" in name:
            v = v / np.sqrt(np.prod(s.shape[:-1]))
        elif "'var'" in name:
            v = 1.0 + 0.5 * v
        elif "A_log" in name:
            v = np.log(np.arange(1, s.shape[1] + 1)) + 0.1 * v
        else:
            v = 0.2 * v + (1.0 if ("scale" in name or "weight" in name or "'D'" in name) else 0.0)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def port_state(helper, variables, stats=False):
    """A compat helper's state_dict for one module, names relative to it."""
    out = {}
    args = (variables["batch_stats"],) if stats else ()
    helper(variables["params"], *args, "m", out)
    return {k[2:]: v for k, v in out.items()}


def test_dwt_stack_matches_jax_and_round_trips():
    x = nhwc((2, 12, 18, 5))
    got = dwt.haar_dwt_stack(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(jdwt.haar_dwt_stack(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(dwt.haar_iwt_stack(got).numpy(), x, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError):
        dwt.haar_iwt_stack(got[:3])


@pytest.mark.parametrize("hw", [(12, 18), (13, 17)])  # odd sizes reflect-pad
def test_dwt_fb_matches_jax_and_round_trips(hw):
    x = nhwc((2, *hw, 3))
    ll, highs = dwt.haar_dwt_fb(torch.from_numpy(x))
    jll, jhighs = jdwt.haar_dwt_fb(jnp.asarray(x))
    np.testing.assert_allclose(ll.numpy(), np.asarray(jll), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(highs.numpy(), np.asarray(jhighs), rtol=1e-6, atol=1e-6)
    back = dwt.haar_iwt_fb(ll, highs).numpy()
    np.testing.assert_allclose(back[:, : hw[0], : hw[1]], x, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", ["FEB", "FFAB"])
def test_feb_ffab_match_jax_fft_path(name):
    """The JAX FFT path (``_use_dft`` is False off the TPU) at 1e-4."""
    x = nhwc((2, 12, 16, 8), -3.0, 3.0)
    jm = getattr(jfft, name)()
    var = jax_variables(jm, x, seed=3)
    want = np.asarray(jax.jit(jm.apply)(var, jnp.asarray(x)))
    port = getattr(fft, name)(8)
    port.load_state_dict(port_state(jp._feb if name == "FEB" else jp._ffab, var))
    np.testing.assert_allclose(from_port(port(to_port(x))), want, **TOL)


@pytest.mark.parametrize("train", [False, True])
def test_gated_ffn_and_batchnorm_stats_match_jax(train):
    """Output in eval and train mode; after a train-mode call the running
    stats equal JAX's mutated ``batch_stats`` (biased batch variance,
    momentum 0.9 in flax's sense)."""
    x = nhwc((2, 8, 10, 6))
    jm = jrep.GatedFeedForward()
    var = jax_variables(jm, x, 5)
    want, mut = jm.apply(var, jnp.asarray(x), train, mutable=["batch_stats"])
    port = rep_conv.GatedFeedForward(6)
    port.load_state_dict(port_state(jp._gated_ffn, var, stats=True))
    port.train(train)
    np.testing.assert_allclose(from_port(port(to_port(x))), np.asarray(want), **TOL)
    for name in ("rep_conv1", "rep_conv2"):
        bn = getattr(port, name).bn
        st = mut["batch_stats"][name]["bn"]
        np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(st["mean"]), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(st["var"]), rtol=1e-5,
                                   atol=1e-6)
    k, b = rep_conv.fuse_conv_bn(port.rep_conv1.c.weight, port.rep_conv1.bn.weight,
                                 port.rep_conv1.bn.bias, port.rep_conv1.bn.running_mean,
                                 port.rep_conv1.bn.running_var)
    port.eval()
    z = port.project_in(to_port(x))
    fused = torch.nn.functional.conv2d(z, k, b, padding=1, groups=z.shape[1])
    torch.testing.assert_close(fused, port.rep_conv1(z), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("ref_layout", [False, True])
def test_wm_and_wmb_match_jax(ref_layout):
    x = nhwc((2, 16, 16, 8))
    jm = jwfb.WMB(ref_token_layout=ref_layout)
    var = jax_variables(jm, x, 7)
    apply = jax.jit(jm.apply)
    port = wfb.WMB(8, ref_token_layout=ref_layout).eval()
    port.load_state_dict(port_state(jp._wmb, var, stats=True))
    with torch.no_grad():
        np.testing.assert_allclose(from_port(port(to_port(x))),
                                   np.asarray(apply(var, jnp.asarray(x))), **TOL)
        jwm = jwfb.WM(ref_token_layout=ref_layout)
        want = jax.jit(jwm.apply)({"params": var["params"]["mb"]}, jnp.asarray(x))
        np.testing.assert_allclose(from_port(port.mb(to_port(x))), np.asarray(want), **TOL)


@pytest.fixture(scope="module")
def wfb8_variables():
    """Variables of the dim-8 JAX RawFormerWFB (the token layout does not
    change them) and a 32x32 input."""
    x = nhwc((2, 32, 32, 1), 0.0, 1.0)
    return jax_variables(jwfb.RawFormerWFB(jwfb.RawFormerWFBConfig(dim=8)), x, 11), x


@pytest.mark.parametrize("ref_layout", [False, True])
def test_full_model_matches_jax_and_imports_back(wfb8_variables, ref_layout):
    """dim 8 at 32x32 in fp32, through wfb_state_dict_from_jax; the JAX
    package's import_wfb_state_dict reads the port's state_dict back into
    the same variables, which reproduce the JAX output."""
    var, x = wfb8_variables
    jm = jwfb.RawFormerWFB(jwfb.RawFormerWFBConfig(dim=8, ref_token_layout=ref_layout))
    apply = jax.jit(jm.apply)
    want = np.asarray(apply(var, jnp.asarray(x)))
    port = RawFormerWFB(RawFormerWFBConfig(dim=8, ref_token_layout=ref_layout)).eval()
    port.load_state_dict(wfb_state_dict_from_jax(var))
    with torch.no_grad():
        np.testing.assert_allclose(from_port(port(to_port(x))), want, **TOL)
    back = import_wfb_state_dict({k: v.numpy() for k, v in port.state_dict().items()})
    np.testing.assert_array_equal(np.asarray(apply(back, jnp.asarray(x))), want)


def test_wmb_lockstep_with_jax_adam():
    """Four Adam steps (lr 1e-3) on Charbonnier of one WMB at dim 8, 16x16,
    train mode: the port (scan through SelectiveScanFn, twins on the CPU)
    against the JAX WMB with optax (XLA scan). Per-step loss within 1e-4
    relative, params within 1e-3 of each leaf's scale, BN stats 1e-4."""
    import optax

    x, gt = nhwc((2, 16, 16, 8), 0.0, 1.0), nhwc((2, 16, 16, 8), 0.0, 1.0)
    jm = jwfb.WMB(ref_token_layout=True)
    var = jax_variables(jm, x, 13)
    tx = optax.adam(1e-3)

    @jax.jit
    def step(params, stats, opt):
        def loss_fn(p):
            out, upd = jm.apply({"params": p, "batch_stats": stats}, jnp.asarray(x), True,
                                mutable=["batch_stats"])
            d = out - jnp.asarray(gt)
            return jnp.mean(jnp.sqrt(d * d + 1e-6)), upd["batch_stats"]

        (loss, stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        upd, opt = tx.update(grads, opt, params)
        return optax.apply_updates(params, upd), stats, opt, loss

    port = wfb.WMB(8, ref_token_layout=True)
    port.load_state_dict(port_state(jp._wmb, var, stats=True))
    opt = torch.optim.Adam(port.parameters(), lr=1e-3)
    params, stats, jopt = var["params"], var["batch_stats"], tx.init(var["params"])
    for _ in range(4):
        params, stats, jopt, jloss = step(params, stats, jopt)
        opt.zero_grad()
        d = port(to_port(x)) - to_port(gt)
        loss = torch.sqrt(d * d + 1e-6).mean()
        loss.backward()
        opt.step()
        assert abs(loss.item() - float(jloss)) < 1e-4 * abs(float(jloss))
    want = port_state(jp._wmb, {"params": params, "batch_stats": stats}, stats=True)
    for name, v in port.state_dict().items():
        if name.endswith("num_batches_tracked"):
            continue
        w = want[name].numpy()
        err = np.abs(v.numpy() - w).max() / max(np.abs(w).max(), 1e-3)
        assert err < (1e-4 if "running" in name else 1e-3), (name, err)


def tiny_wfb(**kw):
    return RawFormerWFB(RawFormerWFBConfig(dim=8), generator=torch.Generator().manual_seed(2),
                        **kw)


def wfb_batch(seed):
    g = np.random.default_rng(seed)
    return (torch.from_numpy(g.uniform(0, 2, (2, 32, 32, 1)).astype(np.float32)),
            torch.from_numpy(g.uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)))


def test_wfb_trainer_on_cpu_updates_batchnorm_once():
    """A WFB train step on the CPU: finite loss, BN running stats move (once
    per step, also with remat, which the Trainer ignores for BN models as
    the JAX trainer does), eval_step on the running stats."""
    cfg = dict(base_lr=1e-3, warmup_epochs=1, steps_per_epoch=1)
    runs = {}
    for remat in (False, True):
        t = Trainer(tiny_wfb(), TrainConfig(remat=remat, **cfg))
        assert t.has_batchnorm
        bn = t.model.conv_tran1.Transformer.ffn.rep_conv1.bn
        before = bn.running_var.clone()
        loss = t.train_step(wfb_batch(1))
        assert torch.isfinite(loss) and bn.num_batches_tracked.item() == 1
        assert not torch.equal(bn.running_var, before)
        runs[remat] = (float(loss), {k: v.clone() for k, v in t.model.state_dict().items()})
    assert runs[False][0] == runs[True][0]
    for k, v in runs[False][1].items():
        assert torch.equal(v, runs[True][1][k]), k
    pred, psnr = t.eval_step(wfb_batch(2))
    assert pred.shape == (2, 32, 32, 3) and bool(torch.isfinite(psnr).all())
    assert bn.num_batches_tracked.item() == 1  # eval mode: stats untouched


def test_train_cli_wfb_on_cpu(tmp_path, monkeypatch):
    import sys

    # The text log is enough here; importing TensorBoard costs ~10 s.
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    argv = ["--dataset", "synthetic", "--model", "rawformer_wfb", "--patch_size", "32",
            "--batch_size", "8", "--epochs", "0", "--save_dir", str(tmp_path), "--device", "cpu"]
    with pytest.warns(RuntimeWarning, match="TensorBoard"):
        train_cli.main(argv)
    assert (tmp_path / "synthetic" / "weights" / "0.pt").exists()
    assert "Epoch 0/0" in (tmp_path / "synthetic" / "log.txt").read_text()


def test_cli_and_predictor_refuse_a_missing_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        train_cli.main(["--dataset", "synthetic", "--save_dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match='device="cpu"'):
        Predictor(tiny_wfb())


def test_predictor_pad_to_serves_wfb_at_any_size():
    model = tiny_wfb()
    pred = Predictor(model, device="cpu", pad_to=32)
    x = RNG.uniform(0, 2, (37, 45)).astype(np.float32)
    got = pred(x)
    assert got.shape == (37, 45, 3)
    padded = np.zeros((64, 64), np.float32)
    padded[:37, :45] = x
    np.testing.assert_allclose(got, pred(padded)[:37, :45], rtol=1e-6, atol=1e-6)
    with pytest.raises(TypeError, match="prepacked"):
        pred.raw_u16(np.zeros((32, 32), np.uint16), 1.0)
    with pytest.raises(ValueError, match="divisible by 32"):
        Predictor(model, device="cpu")(np.zeros((48, 48), np.float32))
    twin = RawFormerWFB(RawFormerWFBConfig(dim=8, ssm_kernel=False))
    assert {m.fused for m in twin.modules() if hasattr(m, "fused")} == {False}
    twin.load_state_dict(model.state_dict())
    np.testing.assert_allclose(Predictor(twin, device="cpu", pad_to=32)(x), got, rtol=1e-5,
                               atol=1e-5)
