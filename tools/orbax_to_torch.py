#!/usr/bin/env python3
"""Convert a JAX package orbax training checkpoint into a PyTorch port
checkpoint.

    python tools/orbax_to_torch.py --ckpt RUN/SID/weights --out PORT/SID/weights \\
        [--model NAME | --model_size S]

Needs JAX, flax and orbax (the JAX package's stack) beside torch; the port
itself never imports them. Steps:

1. build the JAX model as the JAX train CLI's ``build_model`` does
   (``--model`` through the registry, else RawFormer of ``--model_size``;
   a raw-domain model, which that CLI refuses, through the registry) and
   the restore template from its ``init`` (shapes only, ``jax.eval_shape``)
   wrapped in a ``TrainState`` with the trainer's Adam state;
2. restore the latest step with the JAX package's
   ``train/checkpoint.CheckpointManager.restore``;
3. carry the variables (params, and batch_stats where the model has
   BatchNorm) to the port's names with the ``compat.*_state_dict_from_jax``
   of the port model's class, as ``Predictor.from_jax_params`` picks it,
   and Adam's first and second moments with the same carry;
4. ``torch.save`` them as ``<out>/<step>.pt`` through the port's
   ``train/checkpoint.CheckpointManager``, in the train CLI's layout
   (``{"trainer": {model, optimizer, step, applied}, "best_psnr",
   "best_epoch"}``), which the port's eval CLI reads with ``--ckpt`` and
   its train CLI resumes from with ``--resume``.

The best PSNR that the JAX run kept in orbax's metrics is not carried: the
checkpoint starts a fresh best-PSNR record.
"""

from __future__ import annotations

import argparse
import math
import os
import sys
from typing import Optional

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def jax_model(name: Optional[str], model_size: str):
    """The JAX model the JAX CLIs build for ``--model`` / ``--model_size``
    (fp32 compute: the template's parameters do not depend on it), and the
    channel count of its input."""
    from bayer_low_light_image_enhancement_tpu.cli.train_cli import build_model
    from bayer_low_light_image_enhancement_tpu.models import get_model
    from bayer_low_light_image_enhancement_tpu.models.registry import is_raw_domain

    if name and is_raw_domain(name):
        return get_model(name), 4
    args = argparse.Namespace(model=name, model_size=model_size, fp32=True, no_fused_train=True)
    return build_model(args), 1


def port_model(name: Optional[str], model_size: str):
    """The port model of the same name, on the CPU."""
    import torch

    from bayer_low_light_image_enhancement_tpu_torch.models import (
        RawFormer,
        RawFormerConfig,
        get_model,
    )

    if name:
        return get_model(name, dtype=torch.float32)
    return RawFormer(RawFormerConfig.from_size(model_size))


def restore(ckpt: str, model, in_ch: int):
    """-> (the restored ``TrainState`` as numpy leaves, its step)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from bayer_low_light_image_enhancement_tpu.train.checkpoint import CheckpointManager
    from bayer_low_light_image_enhancement_tpu.train.trainer import (
        TrainConfig,
        TrainState,
        make_optimizer,
    )

    tx = make_optimizer(TrainConfig())
    template = jax.eval_shape(lambda: TrainState.create(
        model.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, in_ch), jnp.float32)), tx))
    mgr = CheckpointManager(ckpt)
    try:
        state, step = mgr.restore(template)
    finally:
        mgr.close()
    if state is None:
        raise SystemExit(f"no orbax checkpoint in {ckpt}")
    return jax.tree.map(np.asarray, state), int(step)


def adam_moments(opt_state):
    """optax's ``ScaleByAdamState`` inside the restored Adam state (chained
    after a clip or not): (count, mu, nu)."""
    import jax
    import optax

    found = [s for s in jax.tree.leaves(opt_state, is_leaf=lambda s: isinstance(
        s, optax.ScaleByAdamState)) if isinstance(s, optax.ScaleByAdamState)]
    if len(found) != 1:
        raise SystemExit("the checkpoint's optimizer state holds no single Adam state")
    return int(found[0].count), found[0].mu, found[0].nu


def convert(ckpt: str, out: str, name: Optional[str] = None, model_size: str = "S") -> int:
    """Convert the latest step of the orbax directory ``ckpt``; -> the step
    written to ``out``."""
    import torch

    from bayer_low_light_image_enhancement_tpu_torch.compat import jax_params as jp
    from bayer_low_light_image_enhancement_tpu_torch.train import TrainConfig, Trainer
    from bayer_low_light_image_enhancement_tpu_torch.train.checkpoint import CheckpointManager

    model, in_ch = jax_model(name, model_size)
    state, step = restore(ckpt, model, in_ch)
    target = port_model(name, model_size)
    # The family's carry, as Predictor.from_jax_params picks it.
    carry = getattr(type(target), "state_dict_from_jax", jp.state_dict_from_jax)
    variables = state.variables()
    target.load_state_dict(carry(variables))

    count, mu, nu = adam_moments(state.opt_state)
    trainer = Trainer(target, TrainConfig())
    names = dict(target.named_parameters())
    for moments, key in ((mu, "exp_avg"), (nu, "exp_avg_sq")):
        carried = carry({**variables, "params": moments})
        for n, p in names.items():
            trainer.optimizer.state[p][key] = carried[n].to(p.dtype).clone()
    for p in names.values():
        trainer.optimizer.state[p]["step"] = torch.tensor(float(count))
    trainer.step, trainer.applied = int(state.step), count
    CheckpointManager(out).save(step, {"trainer": trainer.state_dict(), "best_psnr": -math.inf,
                                       "best_epoch": -1})
    return step


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ckpt", required=True, help="the JAX train CLI's orbax weights directory")
    p.add_argument("--out", required=True, help="the port checkpoint directory to write")
    p.add_argument("--model", default=None, help="registry model name; overrides --model_size")
    p.add_argument("--model_size", default="S", choices=["S", "B", "L"])
    args = p.parse_args(argv)
    step = convert(args.ckpt, args.out, args.model, args.model_size)
    print(f"converted orbax step {step} of {args.ckpt} -> {os.path.join(args.out, f'{step}.pt')}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
