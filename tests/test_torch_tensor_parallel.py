"""The port's Megatron tensor parallelism (``parallel/tensor.py``) on the CPU
(gloo ranks from ``tests/torch_dist_workers.py``) against the unsharded
port and the JAX package: ``tensor_specs`` against the JAX rules, the
forward at tensor=4 (2e-5, the bar of tests/test_tensor_parallel.py), the
blocks the degree does not divide kept replicated, data=2 x tensor=2
training against one process and the JAX Trainer over
``create_mesh(data=2, tensor=2)`` (that file's bars), and the gathered
checkpoint resumed at tensor=1 and under tensor parallelism, and served by
``Predictor``."""

import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_workers as workers
from torch_parity import filled_variables
from bayer_low_light_image_enhancement_tpu.core.mesh import create_mesh
from bayer_low_light_image_enhancement_tpu.models.rawformer import (
    RawFormer as JaxRawFormer,
    RawFormerConfig as JaxRawFormerConfig,
)
from bayer_low_light_image_enhancement_tpu.parallel.tensor import (
    tensor_shardings,
    tensor_specs as jax_tensor_specs,
)
from bayer_low_light_image_enhancement_tpu.train import trainer as jtrainer
from bayer_low_light_image_enhancement_tpu_torch.compat import state_dict_from_jax
from bayer_low_light_image_enhancement_tpu_torch.models import RawFormer, RawFormerConfig
from bayer_low_light_image_enhancement_tpu_torch.parallel import tensor as tp_lib
from bayer_low_light_image_enhancement_tpu_torch.serving import Predictor
from bayer_low_light_image_enhancement_tpu_torch.train import TrainConfig, Trainer

torch.set_num_threads(2)

# tests/test_tensor_parallel.py's training config (lr 1e-4, two warmup
# epochs of four steps).
CFG = dict(steps_per_epoch=4, total_epochs=10, warmup_epochs=2)


def batches(n, b=4, seed=0):
    g = np.random.default_rng(seed)
    return [(torch.from_numpy(g.uniform(0, 1, (b, 32, 32, 1)).astype(np.float32)),
             torch.from_numpy(g.uniform(0, 1, (b, 32, 32, 3)).astype(np.float32)))
            for _ in range(n)]


@pytest.mark.parametrize("tp", [2, 4, 7])
def test_tensor_specs_agree_with_jax_rules(tp):
    """On RawFormer at dim 16 with 4 heads a level: every leaf the JAX rules
    shard is sharded by the port along the same axis (the JAX kernel's last
    dim is torch's dim 0, its dim -2 torch's dim 1) and no other, apart from
    the temperatures, which the port splits with their heads (JAX keeps
    them replicated); tp = 7 divides nothing: both replicate everything."""
    heads = (4, 4, 4, 4)
    jmodel = JaxRawFormer(JaxRawFormerConfig(dim=16, num_heads=heads))
    variables = filled_variables(jmodel, np.zeros((1, 32, 32, 1), np.float32))
    specs = jax_tensor_specs(variables, tp)

    def mark(leaf, spec):
        # The sharded axis counts 1, 2, ...; a replicated leaf is all zeros.
        axis = next((i for i, a in enumerate(spec) if a is not None), None)
        if axis is None:
            return np.zeros(leaf.shape, np.float32)
        shape = [1] * leaf.ndim
        shape[axis] = leaf.shape[axis]
        return np.broadcast_to(np.arange(1, leaf.shape[axis] + 1).reshape(shape),
                               leaf.shape).astype(np.float32)

    marked = state_dict_from_jax(jax.tree.map(mark, variables, specs,
                                              is_leaf=lambda x: isinstance(x, np.ndarray)))
    jax_dims = {}
    for name, t in marked.items():
        if t.abs().max() > 0:
            jax_dims[name] = next(d for d in range(t.ndim) if t.shape[d] > 1
                                  and not torch.equal(t.narrow(d, 0, 1), t.narrow(d, 1, 1)))
    port = tp_lib.tensor_specs(RawFormer(RawFormerConfig(dim=16, num_heads=heads)), tp)
    if tp == 7:
        assert port == {} and jax_dims == {}
        return
    assert jax_dims
    assert {k: d for k, d in port.items() if "temperature" not in k} == jax_dims
    assert all(port[k] == 0 for k in port if "temperature" in k)


def test_indivisible_blocks_stay_replicated():
    """At tensor=4 the blocks with 2 heads stay whole; the specs name only
    the 4-head blocks' leaves."""
    model = RawFormer(RawFormerConfig(dim=16, num_heads=(4, 2, 4, 2)))
    specs = tp_lib.tensor_specs(model, 4)
    sharded = {k.split(".attn")[0].split(".ffn")[0] for k in specs}
    want = {n for n, m in model.named_modules() if type(m).__name__ == "TransformerBlock"
            and m.num_heads == 4}
    assert sharded == want and len(want) == 4  # conv_tran1 / tran3 / tran5 / tran7


def test_tp_forward_matches_unsharded(tmp_path):
    """tensor=4 on RawFormer at dim 16 (heads 4/4/4/2: the 2-head bottleneck
    block stays replicated and is named): the forward on 2 x 32^2 within
    rtol = atol = 2e-5 of the unsharded module path on every rank."""
    kw = dict(dim=16, num_heads=(4, 4, 4, 2))
    model = RawFormer(RawFormerConfig(**kw), generator=torch.Generator().manual_seed(4))
    state = {k: v.clone() for k, v in model.state_dict().items()}
    data = batches(1, b=2, seed=3)
    job = workers.write_job(tmp_path / "job.pt", kind="forward", model=("rawformer", kw),
                            state=state, cfg=dict(fused_blocks=False), batches=data,
                            mesh=dict(data=1, tensor=4))
    res = workers.run_job(job, 4)
    model.eval()
    with torch.no_grad():
        want = model(data[0][0].permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    for r in res:
        assert r["replicated"] == ["conv_tran4.Transformer (heads 2, hidden 256)"]
        np.testing.assert_allclose(r["out"].numpy(), want.numpy(), rtol=2e-5, atol=2e-5)


def jax_tp_steps(jmodel, params, data):
    """The JAX Trainer over create_mesh(data=2, tensor=2) from ``params``
    (its Megatron shardings applied as its ``init`` does) -> (losses, params)."""
    t = jtrainer.Trainer(jmodel, jtrainer.TrainConfig(**CFG), mesh=create_mesh(data=2, tensor=2))
    state = jtrainer.TrainState.create({"params": jax.tree.map(jnp.asarray, params)}, t.tx)
    t._state_sharding = tensor_shardings(state, t.mesh)
    state = jax.device_put(state, t._state_sharding)
    t.train_step = t._build_train_step()
    losses = []
    for x, y in data:
        state, loss = t.train_step(state, t.shard_batch((jnp.asarray(x.numpy()),
                                                         jnp.asarray(y.numpy()))))
        losses.append(float(loss))
    return losses, jax.tree.map(np.asarray, jax.device_get(state.params))


def test_dp_tp_training_matches_single_process_and_jax(tmp_path):
    """data=2 x tensor=2 on RawFormer at dim 16 (heads 2 a level), batch 4
    @ 32^2, two steps: losses within rtol 1e-5 / atol 1e-6 and params
    within rtol 1e-4 / atol 1e-5 of one process and of the JAX Trainer over
    create_mesh(data=2, tensor=2). The checkpoint state (``state_dict``,
    gathered) has the single-device names and shapes on every rank, resumes
    at tensor=1 (a third step within the same bars of one process's third
    step) and serves through ``Predictor``; one process's state after two
    steps, loaded into the sharded trainer, gives that third step too."""
    kw = dict(dim=16, num_heads=(2, 2, 2, 2))
    jmodel = JaxRawFormer(JaxRawFormerConfig(**kw))
    params = filled_variables(jmodel, np.zeros((1, 32, 32, 1), np.float32), 5)["params"]
    state = state_dict_from_jax(params)
    data = batches(2, seed=7)
    model = RawFormer(RawFormerConfig(**kw))
    model.load_state_dict(state)
    single = Trainer(model, TrainConfig(**CFG))
    losses = [float(single.train_step(b)) for b in data]
    after_two = single.state_dict()
    job = workers.write_job(tmp_path / "job.pt", kind="train", model=("rawformer", kw),
                            state=state, cfg=CFG, batches=data, mesh=dict(data=2, tensor=2),
                            resume=after_two)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(workers.run_job, job, 4)
        jax_losses, jax_final = jax_tp_steps(jmodel, params, data)
        single.train_step(data[-1])
        res = ranks.result()
    want_jax = state_dict_from_jax({"params": jax_final})
    for r in res:
        assert r["replicated"] == [] and r["rows"] == [2, 2]
        np.testing.assert_allclose(r["losses"], losses, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(r["losses"], jax_losses, rtol=1e-5, atol=1e-6)
        got = r["state"]["model"]
        assert {k: v.shape for k, v in got.items()} == {k: v.shape for k, v in state.items()}
        for name, w in after_two["model"].items():
            torch.testing.assert_close(got[name], w, rtol=1e-4, atol=1e-5, msg=name)
            torch.testing.assert_close(got[name], want_jax[name], rtol=1e-4, atol=1e-5, msg=name)
        for name, w in single.state_dict()["model"].items():
            torch.testing.assert_close(r["resumed"]["model"][name], w, rtol=1e-4, atol=1e-5,
                                       msg=name)
    # The gathered checkpoint at tensor=1: the optimizer's moments too.
    ckpt = res[1]["state"]
    resumed = Trainer(RawFormer(RawFormerConfig(**kw)), TrainConfig(**CFG))
    resumed.load_state_dict(ckpt)
    assert (resumed.step, resumed.applied) == (2, 2)
    resumed.train_step(data[-1])
    for name, w in single.state_dict()["model"].items():
        torch.testing.assert_close(resumed.model.state_dict()[name], w, rtol=1e-4, atol=1e-5,
                                   msg=name)
    frame = data[0][0][0, :, :, 0].numpy()
    served = Predictor(resumed.model, device="cpu")(frame)
    resumed.model.eval()
    with torch.no_grad():
        direct = resumed.model(torch.from_numpy(frame)[None, None]).clamp(0, 1)
    np.testing.assert_allclose(served, direct[0].permute(1, 2, 0).numpy(), rtol=1e-5, atol=1e-6)
