"""The port's data-parallel training on the CPU (gloo ranks from
``tests/torch_dist_workers.py``) against the port on one process and the JAX
``Trainer`` over ``create_mesh(data=4)`` on the conftest's 8 CPU devices:
the RawFormer step (losses, every grad, the params after two steps at 1e-4,
the bar of tests/test_sharding.py's data-parallel test), the global
BatchNorm statistics of a BatchNorm model and of WFB, the NaN guard deciding
on every rank, remat and the global-norm clip under
``DistributedDataParallel``, and ``eval_step``'s global batch."""

import concurrent.futures

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_workers as workers
from torch_parity import filled_variables
from bayer_low_light_image_enhancement_tpu.core.mesh import create_mesh
from bayer_low_light_image_enhancement_tpu.models.common import Conv2d as JaxConv2d
from bayer_low_light_image_enhancement_tpu.models.rawformer import (
    RawFormer as JaxRawFormer,
    RawFormerConfig as JaxRawFormerConfig,
)
from bayer_low_light_image_enhancement_tpu.ops.rep_conv import GatedFeedForward as JaxGatedFFN
from bayer_low_light_image_enhancement_tpu.train import trainer as jtrainer
from bayer_low_light_image_enhancement_tpu_torch.compat import jax_params as jp
from bayer_low_light_image_enhancement_tpu_torch.compat import state_dict_from_jax
from bayer_low_light_image_enhancement_tpu_torch.models import RawFormer, RawFormerConfig
from bayer_low_light_image_enhancement_tpu_torch.train import TrainConfig, Trainer

torch.set_num_threads(2)

CFG = dict(base_lr=1e-3, warmup_epochs=1, steps_per_epoch=1)
SMALL = dict(dim=8, num_heads=(2, 2, 2, 2))


def batches(n, b=8, size=32, seed=0):
    g = np.random.default_rng(seed)
    return [(torch.from_numpy(g.uniform(0, 2, (b, size, size, 1)).astype(np.float32)),
             torch.from_numpy(g.uniform(0, 1, (b, size, size, 3)).astype(np.float32)))
            for _ in range(n)]


def jax_mesh_steps(jmodel, variables, data, mesh):
    """The JAX Trainer over ``create_mesh(**mesh)`` from ``variables`` on the
    global batches -> (losses, final variables as numpy)."""
    t = jtrainer.Trainer(jmodel, jtrainer.TrainConfig(**CFG), mesh=create_mesh(**mesh))
    state = jtrainer.TrainState.create(jax.tree.map(jnp.asarray, variables), t.tx)
    state = jax.device_put(state, t._replicated)
    losses = []
    for x, y in data:
        state, loss = t.train_step(state, t.shard_batch((jnp.asarray(x.numpy()),
                                                         jnp.asarray(y.numpy()))))
        losses.append(float(loss))
    return losses, jax.tree.map(np.asarray, jax.device_get(state.variables()))


def single_process(model, data, **cfg):
    """The port's single-process run: (losses, first-step grads, trainer)."""
    t = Trainer(model, TrainConfig(**{**CFG, **cfg}))
    losses, grads = [], None
    for b in data:
        losses.append(float(t.train_step(b)))
        if grads is None:
            grads = {n: p.grad.clone() for n, p in model.named_parameters()
                     if p.grad is not None}
    return losses, grads, t


def rel_err(got, want):
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-12))


def assert_state_close(got, want, rtol, atol, what):
    for name, w in want.items():
        if name.endswith("num_batches_tracked"):
            assert int(got[name]) == int(w), name
            continue
        torch.testing.assert_close(got[name], w, rtol=rtol, atol=atol, msg=f"{what}: {name}")


def test_ddp_rawformer_matches_single_process_and_jax_mesh(tmp_path):
    """Four gloo ranks, batch 8 @ 32^2, two Adam steps (the first at the
    warmup's lr 0): the reported loss is the global mean, every rank ends
    with the same params and state, every first-step grad within 1e-5 of
    its leaf's max of the single process's, the params after two steps
    within rtol 1e-4 / atol 1e-6 of the single process and of the JAX
    Trainer over create_mesh(data=4) (weights carried by compat), the
    losses within rtol 1e-5 of both; eval_step gathers the global batch."""
    jmodel = JaxRawFormer(JaxRawFormerConfig(**SMALL))
    variables = filled_variables(jmodel, np.zeros((1, 32, 32, 1), np.float32), seed=6)
    state = state_dict_from_jax(variables)
    data = batches(2)
    job = workers.write_job(tmp_path / "job.pt", kind="train", model=("rawformer", SMALL),
                            state=state, cfg=CFG, batches=data,
                            mesh=dict(data=4, tensor=1))
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(workers.run_job, job, 4)
        jax_losses, jax_final = jax_mesh_steps(jmodel, variables, data, dict(data=4))
        model = RawFormer(RawFormerConfig(**SMALL))
        model.load_state_dict(state)
        losses, grads, single = single_process(model, data)
        res = ranks.result()
    assert [r["rows"] for r in res] == [[2, 2]] * 4
    for r in res:
        assert r["losses"] == res[0]["losses"] and (r["step"], r["applied"]) == (2, 2)
        for k, v in r["local_state"].items():
            assert torch.equal(v, res[0]["local_state"][k]), k
        for k, g in r["grads"].items():  # DDP's averaged grads, the same on every rank
            assert torch.equal(g, res[0]["grads"][k]), k
    np.testing.assert_allclose(res[0]["losses"], losses, rtol=1e-5)
    np.testing.assert_allclose(res[0]["losses"], jax_losses, rtol=1e-5)
    assert sorted(res[0]["grads"]) == sorted(grads)
    for k, g in grads.items():
        assert rel_err(res[0]["grads"][k], g) < 1e-5, k
    got = res[0]["state"]["model"]
    assert_state_close(got, single.state_dict()["model"], 1e-4, 1e-6, "single process")
    assert_state_close(got, state_dict_from_jax(jax_final), 1e-4, 1e-6, "JAX mesh")
    pred, psnr = single.eval_step(data[-1])
    for r in res:
        torch.testing.assert_close(r["eval"][0], pred, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(r["eval"][1], psnr, rtol=1e-5, atol=1e-4)


class JaxBNNet(fnn.Module):
    """The JAX twin of ``torch_dist_workers.BNNet``."""

    dim: int = 6

    @fnn.compact
    def __call__(self, x, train: bool = False):
        x = JaxConv2d(self.dim, 3, name="embed")(x)
        x = JaxGatedFFN(name="ffn")(x, train)
        return JaxConv2d(3, 3, name="out")(x)


def bnnet_state(variables):
    out = {}
    jp._conv(variables["params"]["embed"], "embed", out)
    jp._gated_ffn(variables["params"]["ffn"], variables["batch_stats"]["ffn"], "ffn", out)
    jp._conv(variables["params"]["out"], "out", out)
    return out


def test_batchnorm_global_statistics_match_jax_mesh(tmp_path):
    """A BatchNorm model (the WFB gated FFN between two convs) at data=4,
    batch 8 @ 16^2, two steps: every rank's running statistics after each
    step are the global batch's, those of the JAX Trainer over
    create_mesh(data=4) and of the port on one process (rtol 1e-5), and so
    are the params (rtol 1e-4, atol 1e-6). Statistics of the local rows
    alone would be off by far more (checked)."""
    jm = JaxBNNet()
    variables = filled_variables(jm, np.zeros((1, 16, 16, 1), np.float32), seed=3)
    state = bnnet_state(variables)
    data = batches(2, size=16, seed=4)
    job = workers.write_job(tmp_path / "job.pt", kind="train", model=("bnnet", {}), state=state,
                            cfg=CFG, batches=data, mesh=dict(data=4, tensor=1))
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(workers.run_job, job, 4)
        jax_losses, jax_final = jax_mesh_steps(jm, variables, data, dict(data=4))
        model = workers.BNNet()
        model.load_state_dict(state)
        losses, _, single = single_process(model, data)
        res = ranks.result()
    want_single = single.state_dict()["model"]
    want_jax = {k: v for k, v in bnnet_state(jax_final).items()
                if not k.endswith("num_batches_tracked")}  # JAX keeps no count
    np.testing.assert_allclose(res[0]["losses"], jax_losses, rtol=1e-5)
    np.testing.assert_allclose(res[0]["losses"], losses, rtol=1e-5)
    for r in res:
        got = r["state"]["model"]
        assert int(got["ffn.rep_conv1.bn.num_batches_tracked"]) == 2
        stats = {k: v for k, v in want_single.items() if "running" in k}
        assert_state_close(got, stats, 1e-5, 1e-7, "single process stats")
        assert_state_close(got, {k: want_jax[k] for k in stats}, 1e-5, 1e-7, "JAX stats")
        assert_state_close(got, want_single, 1e-4, 1e-6, "single process")
        assert_state_close(got, want_jax, 1e-4, 1e-6, "JAX mesh")
    # Statistics of rank 0's two rows alone (what a per-rank BatchNorm keeps).
    local = workers.BNNet()
    local.load_state_dict(state)
    local.train()
    with torch.no_grad():
        local(data[0][0][:2].permute(0, 3, 1, 2))
    gap = (local.ffn.rep_conv1.bn.running_var - want_single["ffn.rep_conv1.bn.running_var"])
    assert gap.abs().max() > 100 * 1e-5 * want_single["ffn.rep_conv1.bn.running_var"].abs().max()


def test_wfb_ddp_matches_single_process(tmp_path):
    """RawFormer-WFB at dim 8 over four ranks (batch 4 @ 32^2, one row a
    rank; the Mamba scans through their twins' autograd.Function, every
    BatchNorm on the global batch): two steps without a reducer error (DDP
    sees every grad the scans' and blocks' Functions return), losses within
    rtol 1e-5, the BatchNorm statistics within rtol 1e-5 and the params
    within rtol 1e-4 / atol 1e-6 of one process."""
    from bayer_low_light_image_enhancement_tpu_torch.models import (
        RawFormerWFB,
        RawFormerWFBConfig,
    )

    model = RawFormerWFB(RawFormerWFBConfig(dim=8), generator=torch.Generator().manual_seed(2))
    state = {k: v.clone() for k, v in model.state_dict().items()}
    data = batches(2, b=4, seed=5)
    job = workers.write_job(tmp_path / "job.pt", kind="train", model=("wfb", dict(dim=8)),
                            state=state, cfg=CFG, batches=data, mesh=dict(data=4, tensor=1),
                            eval=False)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(workers.run_job, job, 4)
        losses, _, single = single_process(model, data)
        res = ranks.result()
    np.testing.assert_allclose(res[0]["losses"], losses, rtol=1e-5)
    want = single.state_dict()["model"]
    for r in res:
        assert r["applied"] == 2
        assert_state_close(r["state"]["model"], {k: v for k, v in want.items() if "running" in k},
                           1e-5, 1e-7, "stats")
        assert_state_close(r["state"]["model"], want, 1e-4, 1e-6, "params")


def test_nan_guard_skips_on_every_rank_and_remat_clip_match(tmp_path):
    """Three steps over four ranks where the middle batch has a NaN in rank
    1's rows only: every rank reports a non-finite loss for it, skips it
    (step 3, applied 2) and ends with the params of one process that skipped
    it too; remat with a global-norm clip that bites (0.05) matches as well."""
    model = RawFormer(RawFormerConfig(**SMALL), generator=torch.Generator().manual_seed(1))
    state = {k: v.clone() for k, v in model.state_dict().items()}
    data = batches(3, seed=8)
    data[1][0][3, 5, 7, 0] = float("nan")  # row 3: rank 1's rows are 2-3
    cfg = dict(CFG, remat=True, grad_clip=0.05)
    job = workers.write_job(tmp_path / "job.pt", kind="train", model=("rawformer", SMALL),
                            state=state, cfg=cfg, batches=data, mesh=dict(data=4, tensor=1),
                            eval=False)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(workers.run_job, job, 4)
        losses, _, single = single_process(model, data, grad_clip=0.05)
        res = ranks.result()
    assert not np.isfinite(losses[1]) and (single.step, single.applied) == (3, 2)
    for r in res:
        assert (r["step"], r["applied"]) == (3, 2)
        assert not np.isfinite(r["losses"][1]) and np.isfinite(r["losses"][2])
        np.testing.assert_allclose(np.array(r["losses"])[[0, 2]], np.array(losses)[[0, 2]],
                                   rtol=1e-5)
        assert_state_close(r["state"]["model"], single.state_dict()["model"], 1e-4, 1e-6,
                           "params")


@pytest.mark.parametrize("rows", [(8, 4), (6, 4), (3, 4)])
def test_shard_batch_rows(rows):
    """shard_batch gives data rank r rows [r B / n, (r + 1) B / n): equal
    shares where n divides B, contiguous and covering every row otherwise."""
    from bayer_low_light_image_enhancement_tpu_torch.core.mesh import row_range

    b, n = rows
    x = np.arange(b)
    parts = [x[slice(*row_range(b, r, n))] for r in range(n)]
    np.testing.assert_array_equal(np.concatenate(parts), x)
    if b % n == 0:
        assert all(len(p) == b // n for p in parts)
        assert all(p[0] == r * b // n for r, p in enumerate(parts))
