"""Helpers of the port's parity tests against the JAX package: JAX
variables from a module's ``init``, one module's carried weights, the
carry's round trip through a JAX importer, NHWC <-> NCHW, grads against
grads."""

import jax
import numpy as np
import torch

# fp32 results are held at the repo's bar; the models at dim 8 with two heads
# a stage, as tests/test_model_parity.py.
TOL = dict(rtol=1e-4, atol=1e-4)
HEADS = (2, 2, 2, 2)


def jax_variables(module, *args, seed=0, jit=False):
    """``module.init`` with every leaf that is not a conv kernel or bias
    (scalar balances, LN affines, temperatures) moved off its init by
    U(+-0.2), as numpy. The key is an ``unsafe_rbg`` one: init runs op by
    op, and its random bits compile for each parameter shape several times
    faster than threefry's. ``jit`` compiles the init as one program (the
    same values; faster for a deep model than op by op)."""
    g = np.random.default_rng(seed + 100)

    def move(path, a):
        a = np.asarray(a, np.float32)
        keys = [str(getattr(k, "key", k)) for k in path]
        if keys[-1] in ("kernel", "bias") and not any(k.startswith("norm") for k in keys):
            return a
        return (a + g.uniform(-0.2, 0.2, a.shape)).astype(np.float32)

    init = jax.jit(module.init) if jit else module.init
    v = init(jax.random.key(seed, impl="unsafe_rbg"), *args)
    return jax.tree_util.tree_map_with_path(move, jax.device_get(v))


def carried(fn, p, prefix="m"):
    """A compat helper's state_dict for one module, names relative to it."""
    out = {}
    fn(p, prefix, out)
    return {k[len(prefix) + 1:]: v for k, v in out.items()}


def t(a):
    """NHWC numpy -> NCHW torch."""
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def n(x):
    """NCHW torch -> NHWC numpy."""
    return x.detach().permute(0, 2, 3, 1).numpy()


def jax_apply_with_head(jmodel, variables, x):
    """A JAX model's output and its head's input (the top-level
    ``conv_out``'s output, NHWC), as numpy."""
    out, state = jmodel.apply(variables, x, mutable=["intermediates"],
                              capture_intermediates=lambda m, _: m.name == "conv_out")
    return np.asarray(out), np.asarray(state["intermediates"]["conv_out"]["__call__"][0])


def torch_run_with_head(model, x):
    """The port model's output and its head's input (``conv_out``'s output,
    NCHW) under no_grad."""
    heads = []
    hook = model.conv_out.register_forward_hook(lambda m, i, o: heads.append(o))
    with torch.no_grad():
        out = model(x)
    hook.remove()
    return out, heads[0]


def round_trip(model, importer, variables):
    """The port model's ``state_dict`` through the JAX ``importer`` gives
    back ``variables`` exactly: every collection the importer returns
    (params, and batch_stats where the model has BatchNorms), the same
    leaves at the same paths and shapes."""
    back = importer({k: p.numpy() for k, p in model.state_dict().items()})
    assert sorted(back) == sorted(variables)
    for col in back:
        want = jax.tree_util.tree_flatten_with_path(variables[col])[0]
        got = jax.tree_util.tree_flatten_with_path(back[col])[0]
        assert [(p, np.shape(a)) for p, a in got] == [(p, np.shape(a)) for p, a in want]
        for (_, a), (_, b) in zip(got, want):
            np.testing.assert_array_equal(a, b)


def assert_grads_match(got, want, tol=1e-6):
    """Two {name: grad} dicts: the same names, each grad within ``tol`` of
    its leaf's largest magnitude (a sum over many terms, taken in another
    order, differs by rounding relative to its terms, not to its result)."""
    assert sorted(got) == sorted(want)
    for name, g in want.items():
        err = (got[name] - g).abs().max().item()
        assert err <= tol * max(g.abs().max().item(), 1e-30), (name, err, g.abs().max().item())
