"""The orbax -> port checkpoint converter (``tools/orbax_to_torch.py``,
CPU, where JAX and orbax are): a JAX RawFormer-S train state (RawFormer-WFB's
in ``test_torch_orbax_wfb.py``), saved by the JAX package's ``CheckpointManager``, converted
and read by the port's eval CLI (``--ckpt``) on the tiny SID tree the JAX
eval CLI reads from the orbax directory: per-image PSNR / SSIM at the eval
parity bars; the converted weights' forward against the JAX apply of the
saved variables at the repo's 1e-4; Adam's moments and counts carried; the
train CLI resuming from the converted checkpoint."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayer_low_light_image_enhancement_tpu.cli import test_cli as jtest_cli
from bayer_low_light_image_enhancement_tpu.train import trainer as jtrainer
from bayer_low_light_image_enhancement_tpu.train.checkpoint import (
    CheckpointManager as JaxCheckpointManager,
)
from bayer_low_light_image_enhancement_tpu_torch.cli import test_cli, train_cli
from bayer_low_light_image_enhancement_tpu_torch.data import synthetic
from bayer_low_light_image_enhancement_tpu_torch.serving import Predictor
from bayer_low_light_image_enhancement_tpu_torch.train.checkpoint import CheckpointManager

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "tools"))
import orbax_to_torch  # noqa: E402

from test_torch_eval_cli import PSNR_TOL, SSIM_TOL, jax_eval  # noqa: E402
from torch_parity import TOL  # noqa: E402

torch.set_num_threads(2)

@pytest.fixture(scope="module")
def sid_tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("sid"))
    synthetic.write_sid_tree(root, os.path.join(root, "cache"),
                             {"train": [(40, 56)], "test": [(64, 64), (64, 64)]},
                             np.random.default_rng(91))
    return root


def jax_train_state(name, seed=4):
    """A JAX train state of the model the JAX CLIs build, filled from a seed
    without running its init (``jax.eval_shape``; WFB-48's init compiles op
    by op for a minute): kernels U(+-1/sqrt(fan-in)), the other params and
    the BatchNorm means U(+-0.2), the variances U(0.5, 1.5); then one Adam
    update on made-up grads, so that the moments and counts are off their
    init."""
    model, in_ch = orbax_to_torch.jax_model(name, "S")
    tr = jtrainer.Trainer(model, jtrainer.TrainConfig())
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, in_ch)))
    g = np.random.default_rng(seed)

    def fill(path, s):
        key = jax.tree_util.keystr(path)
        if "kernel" in key:
            bound = 1.0 / np.sqrt(np.prod(s.shape[:-1]))
            return jnp.asarray(g.uniform(-bound, bound, s.shape), s.dtype)
        lo, hi = (0.5, 1.5) if key.endswith("['var']") else (-0.2, 0.2)
        return jnp.asarray(g.uniform(lo, hi, s.shape), s.dtype)

    state = jtrainer.TrainState.create(jax.tree_util.tree_map_with_path(fill, shapes), tr.tx)
    grads = jax.tree.map(lambda p: jnp.asarray(g.standard_normal(p.shape), p.dtype), state.params)
    _, opt = jax.jit(tr.tx.update)(grads, state.opt_state, state.params)
    return model, state.replace(step=state.step + 5, opt_state=opt)


def save_orbax(state, directory):
    mgr = JaxCheckpointManager(directory)
    mgr.save(7, state)
    mgr.wait()
    mgr.close()


def check_converted(name, sid_tree, tmp_path, monkeypatch, capsys):
    """The JAX eval CLI on an orbax directory of ``name`` (None: RawFormer-S)
    against the port's on the converted one (fp32, two 64x64 frames), then
    the converted weights' forward against the JAX apply of the saved
    variables."""
    flags = ["--model", name] if name else []
    model, state = jax_train_state(name)
    orbax_dir = str(tmp_path / "orbax")
    save_orbax(state, orbax_dir)
    common = ["--dataset", "SID", "--data_root", sid_tree, "--cache_dir",
              os.path.join(sid_tree, "cache"), "--fp32"] + flags
    # The CLI's init builds only the restore template: its random bits by
    # unsafe_rbg (compiled faster than threefry's), replaced by the restore.
    with jax.default_prng_impl("unsafe_rbg"):
        want = jax_eval(common + ["--ckpt", orbax_dir, "--save_dir", str(tmp_path / "jax")],
                        monkeypatch)
    assert "restored orbax checkpoint step 7" in capsys.readouterr().out

    port_dir = str(tmp_path / "port")
    assert orbax_to_torch.main(["--ckpt", orbax_dir, "--out", port_dir] + flags) == 0
    assert "converted orbax step 7" in capsys.readouterr().out
    got = test_cli.main(common + ["--ckpt", port_dir, "--save_dir", str(tmp_path / "eval"),
                                  "--device", "cpu"])
    assert "restored checkpoint step 7" in capsys.readouterr().out
    assert len(got["psnr"]) == len(want["psnr"]) == 2
    np.testing.assert_allclose(got["psnr"], want["psnr"], rtol=0, atol=PSNR_TOL)
    np.testing.assert_allclose(got["ssim"], want["ssim"], rtol=0, atol=SSIM_TOL)

    blob, step = CheckpointManager(port_dir).restore()
    tr = blob["trainer"]
    assert step == 7 and blob["best_epoch"] == -1 and (tr["step"], tr["applied"]) == (5, 1)
    adam = [s for s in jax.tree.leaves(state.opt_state, is_leaf=lambda s: hasattr(s, "mu"))
            if hasattr(s, "mu")][0]
    moments = tr["optimizer"]["state"].values()
    assert all(float(s["step"]) == 1.0 for s in moments)
    for key, tree in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
        want_max = max(float(np.abs(np.asarray(a)).max()) for a in jax.tree.leaves(tree))
        assert max(s[key].abs().max().item() for s in moments) == pytest.approx(want_max, rel=1e-6)

    # The CLI's init ran the model op by op at 64x64: the apply reuses it.
    x = np.random.default_rng(92).uniform(0, 1.5, (64, 64)).astype(np.float32)
    ref = np.clip(np.asarray(model.apply(state.variables(), jnp.asarray(x)[None, ..., None])),
                  0.0, 1.0)[0]
    port = Predictor(orbax_to_torch.port_model(name, "S"), tr["model"], device="cpu",
                     pad_to=32 if name == "rawformer_wfb" else 16)
    np.testing.assert_allclose(port(x), ref, **TOL)


def test_converted_rawformer_checkpoint_serves_as_jax(sid_tree, tmp_path, monkeypatch, capsys):
    check_converted(None, sid_tree, tmp_path, monkeypatch, capsys)


def test_train_cli_resumes_from_a_converted_checkpoint(tmp_path, capsys, monkeypatch):
    """The converted RawFormer-S checkpoint, placed where the port's train
    CLI keeps its weights, resumes: one more epoch from step 7."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)  # ~10 s to import
    _, state = jax_train_state(None)
    orbax_dir = str(tmp_path / "orbax")
    save_orbax(state, orbax_dir)
    orbax_to_torch.convert(orbax_dir, str(tmp_path / "run" / "synthetic" / "weights"))
    with pytest.warns(RuntimeWarning, match="TensorBoard"):
        train_cli.main(["--dataset", "synthetic", "--patch_size", "32", "--batch_size", "2",
                        "--epochs", "8", "--loader", "python", "--save_dir",
                        str(tmp_path / "run"), "--device", "cpu", "--resume"])
    out = capsys.readouterr().out
    assert "resumed from epoch 7" in out and "epoch 8/8 loss=" in out
