"""The port's training stack against the JAX package on the CPU: losses, the
lr schedule, metrics, batch decoding, the synthetic data and loader, the
Trainer in lockstep with the JAX Trainer, the NaN-batch skip, checkpoint
resume and the training CLI."""

import re

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from bayer_low_light_image_enhancement_tpu.data import augment as jaug
from bayer_low_light_image_enhancement_tpu.data import pipeline as jpipe
from bayer_low_light_image_enhancement_tpu.data import synthetic as jsyn
from bayer_low_light_image_enhancement_tpu.models.rawformer import (
    RawFormer as JaxRawFormer,
    RawFormerConfig as JaxRawFormerConfig,
)
from bayer_low_light_image_enhancement_tpu.train import losses as jlosses
from bayer_low_light_image_enhancement_tpu.train import metrics as jmetrics
from bayer_low_light_image_enhancement_tpu.train import schedule as jschedule
from bayer_low_light_image_enhancement_tpu.train import trainer as jtrainer
from bayer_low_light_image_enhancement_tpu_torch.cli import train_cli
from bayer_low_light_image_enhancement_tpu_torch.compat import state_dict_from_jax
from bayer_low_light_image_enhancement_tpu_torch.data import augment, pipeline, synthetic
from bayer_low_light_image_enhancement_tpu_torch.models import RawFormer, RawFormerConfig
from bayer_low_light_image_enhancement_tpu_torch.train import losses, metrics, schedule
from bayer_low_light_image_enhancement_tpu_torch.train.checkpoint import CheckpointManager
from bayer_low_light_image_enhancement_tpu_torch.train.trainer import (
    TrainConfig,
    Trainer,
    decode_batch,
)
from bayer_low_light_image_enhancement_tpu_torch.utils.logging import MetricsLogger

torch.set_num_threads(2)

RNG = np.random.default_rng(23)


def rgb_pair(shape=(2, 12, 10, 3)):
    return RNG.uniform(0, 1, shape).astype(np.float32), RNG.uniform(0, 1, shape).astype(np.float32)


@pytest.mark.parametrize("name", ["charbonnier", "l1", "mse", "sid_color", "rgb_to_lab",
                                  "angular_color_loss"])
def test_losses_match_jax(name):
    # 180 values: the two frameworks' fp32 means differ by ~sqrt(N) ulp.
    a, b = rgb_pair((2, 6, 5, 3))
    if name == "rgb_to_lab":
        got = losses.rgb_to_lab(torch.from_numpy(a)).numpy()
        np.testing.assert_allclose(got, np.asarray(jlosses.rgb_to_lab(jnp.asarray(a))),
                                   rtol=1e-5, atol=1e-4)  # Lab values up to ~100
        return
    fn = getattr(losses, name) if name.endswith("loss") else losses.get_loss(name)
    jfn = getattr(jlosses, name) if name.endswith("loss") else jlosses.get_loss(name)
    got = float(fn(torch.from_numpy(a), torch.from_numpy(b)))
    np.testing.assert_allclose(got, float(jfn(jnp.asarray(a), jnp.asarray(b))), rtol=1e-6)


def test_schedule_matches_jax():
    args = (1e-4, 20, 30, 1e-5, 2)
    ours, theirs = schedule.warmup_cosine_schedule(*args), jschedule.warmup_cosine_schedule(*args)
    got = np.array([ours(s) for s in range(61)])
    want = np.array([float(theirs(s)) for s in range(61)])
    assert got[0] == got[1] == 0.0  # epoch 0 trains at lr 0
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    with pytest.raises(ValueError):
        schedule.warmup_cosine_schedule(warmup_epochs=0)


@pytest.mark.parametrize("batched", [False, True])
def test_metrics_match_jax(batched):
    shape = (2, 20, 17, 3) if batched else (20, 17, 3)
    a = RNG.uniform(0, 1, shape).astype(np.float32)
    b = np.clip(a + RNG.normal(0, 0.05, shape), 0, 1).astype(np.float32)
    ta, tb, ja, jb = torch.from_numpy(a), torch.from_numpy(b), jnp.asarray(a), jnp.asarray(b)
    for name in ("psnr_uint8", "ssim_uint8", "ssim"):
        np.testing.assert_allclose(getattr(metrics, name)(ta, tb).numpy(),
                                   np.asarray(getattr(jmetrics, name)(ja, jb)), rtol=1e-4,
                                   err_msg=name)
    np.testing.assert_allclose(float(metrics.psnr(ta * 255, tb * 255)),
                               float(jmetrics.psnr(ja * 255, jb * 255)), rtol=1e-4)


def test_decode_batch_matches_jax():
    raw = RNG.integers(0, 65535, (2, 8, 8, 1), dtype=np.uint16)  # includes codes >= 32768
    ratio = np.array([100.0, 250.0], np.float32)
    gt = RNG.integers(0, 65535, (2, 8, 8, 3), dtype=np.uint16)
    got = decode_batch([pipeline.to_tensor(a) for a in (raw, ratio, gt)])
    want = jtrainer.decode_batch(tuple(jnp.asarray(a) for a in (raw, ratio, gt)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)
    pair = rgb_pair()
    assert all(torch.equal(g, torch.from_numpy(w))
               for g, w in zip(decode_batch([torch.from_numpy(a) for a in pair]), pair))


def test_synthetic_data_and_loader_match_jax():
    kw = dict(num_images=3, full_size=(40, 56), patch_size=16, seed=4)
    ours, theirs = synthetic.SyntheticBayerDataset(**kw), jsyn.SyntheticBayerDataset(**kw)
    for a, b in zip(ours.mosaics + ours.gts, theirs.mosaics + theirs.gts):
        np.testing.assert_array_equal(a, b)
    for k in range(4):
        for a, b in zip(ours.sample(k % 3, np.random.default_rng(k)),
                        theirs.sample(k % 3, np.random.default_rng(k))):
            np.testing.assert_array_equal(a, b)
        m, g = ours.mosaics[0], ours.gts[0]
        for a, b in zip(augment.random_flips(np.random.default_rng(k), *augment.random_even_crop(
                            np.random.default_rng(k), m, g, 16)),
                        jaug.random_flips(np.random.default_rng(k), *jaug.random_even_crop(
                            np.random.default_rng(k), m, g, 16))):
            np.testing.assert_array_equal(a, b)
    batches = list(pipeline.Loader(ours, 2, seed=3, num_threads=2))
    jbatches = list(jpipe.Loader(theirs, 2, seed=3, num_threads=2))
    assert len(batches) == len(jbatches) == 1
    for a, b in zip(batches[0], jbatches[0]):
        np.testing.assert_array_equal(a, b)
    dev = list(pipeline.prefetch_to_device(iter([(ours.mosaics[0][None],)]), "cpu"))
    assert dev[0][0].dtype == torch.uint16
    assert np.array_equal(dev[0][0].view(torch.int16).numpy().view(np.uint16), ours.mosaics[0][None])


def jax_params(model, seed):
    """Params of the JAX model's structure (eval_shape: no compile), filled
    from a seed: torch-init-like kernels and biases, LN affines and
    temperatures near 1."""
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 1)))
    g = np.random.default_rng(seed)

    def fill(path, s):
        name = jax.tree_util.keystr(path)
        bound = 1.0 / np.sqrt(np.prod(s.shape[:-1])) if "kernel" in name else 0.2
        v = g.uniform(-bound, bound, s.shape)
        if "temperature" in name or ("norm" in name and "weight" in name):
            v = v + 1.0
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def test_trainer_lockstep_with_jax_trainer():
    """Six Adam steps (two warmup epochs, lr 0 first, then the cosine) from
    the same weights on the same batches: per-step loss within 2e-4
    relative, final params within 1e-2 of each leaf's scale (the bar of
    tests/test_lockstep_train.py)."""
    cfg = dict(base_lr=1e-3, warmup_epochs=2, total_epochs=50, steps_per_epoch=1)
    jmodel = JaxRawFormer(JaxRawFormerConfig(dim=16, num_heads=(4, 4, 4, 4)))
    params = jax_params(jmodel, seed=6)
    jt = jtrainer.Trainer(jmodel, jtrainer.TrainConfig(**cfg))
    state = jtrainer.TrainState.create({"params": jax.tree.map(jnp.asarray, params["params"])},
                                       jt.tx)
    model = RawFormer(RawFormerConfig(dim=16, num_heads=(4, 4, 4, 4)))
    model.load_state_dict(state_dict_from_jax(params))
    trainer = Trainer(model, TrainConfig(**cfg))
    batches = [rgb_pair((2, 32, 32, 3)) for _ in range(2)]
    batches = [(x[..., :1] * 3.0, y) for x, y in batches]
    got, want = [], []
    for s in range(6):
        x, y = batches[s % 2]
        got.append(float(trainer.train_step((torch.from_numpy(x), torch.from_numpy(y)))))
        state, loss = jt.train_step(state, (jnp.asarray(x), jnp.asarray(y)))
        want.append(float(loss))
    rel = np.abs(np.array(got) - want) / np.abs(want)
    assert rel.max() < 2e-4, rel
    assert trainer.applied == trainer.step == 6
    final = state_dict_from_jax(jax.tree.map(np.asarray, jax.device_get(state.params)))
    moved = 0.0
    for name, p in model.state_dict().items():
        ref = final[name].numpy()
        scale = max(np.abs(ref).max(), 1e-3)
        assert np.abs(p.numpy() - ref).max() / scale < 1e-2, name
        moved = max(moved, np.abs(ref - state_dict_from_jax(params)[name].numpy()).max())
    assert moved > 1e-3  # the params did move


def tiny_trainer(seed=0, **kw):
    model = RawFormer(RawFormerConfig(dim=8, num_heads=(2, 2, 2, 2)),
                      generator=torch.Generator().manual_seed(seed))
    return Trainer(model, TrainConfig(base_lr=1e-3, warmup_epochs=1, steps_per_epoch=1, **kw))


def tiny_batch(seed):
    g = np.random.default_rng(seed)
    return (torch.from_numpy(g.uniform(0, 2, (2, 32, 32, 1)).astype(np.float32)),
            torch.from_numpy(g.uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)))


def test_nan_guard_skips_the_whole_batch():
    t = tiny_trainer()
    for s in range(2):
        t.train_step(tiny_batch(s))
    params = {k: v.clone() for k, v in t.model.state_dict().items()}
    moments = [{k: v.clone() for k, v in st.items()} for st in t.optimizer.state.values()]
    lr = t.lr
    bad = tiny_batch(9)
    bad[0][0, 3, 4, 0] = float("nan")
    loss = t.train_step(bad)
    assert not torch.isfinite(loss)
    assert (t.step, t.applied) == (3, 2) and t.lr == lr
    for k, v in t.model.state_dict().items():
        assert torch.equal(v, params[k]), k
    for before, st in zip(moments, t.optimizer.state.values()):
        assert all(torch.equal(st[k], before[k]) for k in before)
    assert torch.isfinite(t.train_step(tiny_batch(3))) and t.applied == 3


def test_checkpoint_resume_is_bitwise(tmp_path):
    straight = tiny_trainer(grad_clip=0.5)
    for s in range(3):
        straight.train_step(tiny_batch(s))
    first = tiny_trainer(grad_clip=0.5)
    for s in range(2):
        first.train_step(tiny_batch(s))
    mgr = CheckpointManager(str(tmp_path / "w"), max_to_keep=2)
    mgr.save(2, first.state_dict(), metrics={"psnr": 1.0})
    state, step = CheckpointManager(str(tmp_path / "w")).restore()
    assert step == 2 and mgr.latest_step() == 2
    resumed = tiny_trainer(grad_clip=0.5).init(torch.Generator().manual_seed(5))
    resumed.load_state_dict(state)  # another init: everything comes from the file
    resumed.train_step(tiny_batch(2))
    assert (resumed.step, resumed.applied) == (3, 3)
    for (k, a), b in zip(straight.model.state_dict().items(), resumed.model.state_dict().values()):
        assert torch.equal(a, b), k
    for a, b in zip(straight.optimizer.state.values(), resumed.optimizer.state.values()):
        assert all(torch.equal(a[k], b[k]) for k in a)


def test_remat_step_matches_plain_step():
    plain, remat = tiny_trainer(), tiny_trainer(remat=True)
    losses = [t.train_step(tiny_batch(1)) for t in (plain, remat)]
    assert torch.equal(*losses)
    for (k, a), b in zip(plain.model.named_parameters(), remat.model.parameters()):
        torch.testing.assert_close(a.grad, b.grad, rtol=1e-6, atol=1e-7, msg=k)


def test_eval_step_psnr_matches_metric():
    t = tiny_trainer()
    inp, gt = tiny_batch(4)
    pred, per_image = t.eval_step((inp, gt))
    assert pred.shape == (2, 32, 32, 3) and per_image.shape == (2,)
    for p, g, v in zip(pred, gt, per_image):
        assert float(v) == float(metrics.psnr_uint8(p, g))


def test_train_cli_synthetic_and_resume(tmp_path, capsys):
    argv = ["--dataset", "synthetic", "--model_size", "S", "--patch_size", "32",
            "--batch_size", "2", "--save_dir", str(tmp_path), "--device", "cpu"]
    train_cli.main(argv + ["--epochs", "1"])
    log = (tmp_path / "synthetic" / "log.txt").read_text()
    line = r"Epoch {}/1 \| Time: \d+\.\d\ds \| Loss: \d+\.\d{{4}} \| Avg PSNR: \d+\.\d{{4}} \| " \
           r"Best PSNR: \d+\.\d{{4}} \(Epoch \d\)"
    assert re.search(line.format(0), log) and re.search(line.format(1), log)
    weights = tmp_path / "synthetic" / "weights"
    assert sorted(p.name for p in weights.glob("*.pt")) == ["0.pt", "1.pt"]
    capsys.readouterr()
    train_cli.main(argv + ["--epochs", "2", "--resume"])
    out = capsys.readouterr().out
    assert "resumed from epoch 1" in out and "epoch 2/2" in out and "epoch 1/2" not in out
    assert (weights / "2.pt").exists()
    for bad, why in ((["--dataset", "SID", "--data_root", str(tmp_path)], "no SID train pairs"),
                     (["--num_chips", "2"], "later slice")):
        with pytest.raises(SystemExit, match=why):
            train_cli.main(argv + bad)


def test_metrics_logger_warns_once_without_tensorboard(tmp_path, monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    with pytest.warns(RuntimeWarning, match="TensorBoard logging is disabled"):
        logger = MetricsLogger(str(tmp_path / "log.txt"), str(tmp_path / "tb"))
    logger.log_scalars(0, {"x": 1.0})
    logger.log_epoch(0, 1, 1.0, 0.5, 30.0, 30.0, 0)
    logger.close()
    assert "Epoch 0/1 | Time: 1.00s | Loss: 0.5000" in (tmp_path / "log.txt").read_text()
