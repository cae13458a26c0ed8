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


# Every registry model at a small config: the same keyword arguments for the
# JAX package's ``get_model`` and the port's; RAW -> RGB models take
# [B,H,W,1] mosaics, the raw-domain ones [B,H,W,4] planes.
SMALL = {
    **{f"rawformer_{s}": dict(num_heads=HEADS) for s in "sbl"},
    "rawformer_wfb": dict(dim=8),
    **{name: dict(dim=8, num_heads=HEADS)
       for name in ("flca_rawformer", "multilvl_flca_rawformer", "truecolor_rawformer",
                    "bayertorgb_rawformer", "luma_mhsa_rawformer", "wavkan_rawformer")},
    "flca_unet": dict(base=8, blocks=(2, 2, 2), heads=2),
    "unet_luma_dwt": dict(base=8, blocks=(2, 2, 2), heads=2),
    "simple_flca_unet": dict(base_ch=8, heads=2),
    "lumachroma_transformer": dict(base=8, num_blocks=2, heads=2),
}
RAW_DOMAIN = ("flca_unet", "unet_luma_dwt", "simple_flca_unet", "lumachroma_transformer")


def filled_variables(module, x, seed=0):
    """A JAX module's variables at input x from ``jax.eval_shape`` of its
    init (tracing only: a deep model's init costs tens of seconds op by op
    or jitted), filled from a seed: kernels U(+-1/sqrt(fan_in)), norm and
    BatchNorm scales and ``D`` near 1, BatchNorm variances in [0.5, 1.5],
    ``A_log`` near log(1..N), everything else U(+-0.2)."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), x)
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
            near_one = any(k in name for k in ("scale", "weight", "'D'", "temperature"))
            v = 0.2 * v + (1.0 if near_one else 0.0)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def export_case(name, path, x, with_jax):
    """The registry model ``name`` at its SMALL config, exported for the CPU
    at x's shape to ``path`` and loaded back: (the model, the artifact's
    callable, its meta, JAX's clip(apply(x), 0, 1) or None). ``with_jax``:
    the weights are a seeded JAX model's (``filled_variables``), carried
    over by the model class's importer; else the port's seeded init."""
    from bayer_low_light_image_enhancement_tpu.models import get_model as jax_get_model
    from bayer_low_light_image_enhancement_tpu_torch.compat import jax_params as jp
    from bayer_low_light_image_enhancement_tpu_torch.models import get_model
    from bayer_low_light_image_enhancement_tpu_torch.serving import export_artifact, load_artifact

    model = get_model(name, generator=torch.Generator().manual_seed(5), **SMALL[name])
    want = None
    if with_jax:
        jmodel = jax_get_model(name, **SMALL[name])
        v = filled_variables(jmodel, jax.numpy.asarray(x), seed=7)
        carry = getattr(type(model), "state_dict_from_jax", jp.state_dict_from_jax)
        model.load_state_dict(carry(v))
        want = np.clip(np.asarray(jax.jit(jmodel.apply)(v, x)), 0.0, 1.0)
    b, h, w, _ = x.shape
    meta = export_artifact(model, None, path, batch=b, height=h, width=w, device="cpu",
                           meta_extra={"model": name})
    fn, loaded = load_artifact(path)
    assert loaded == meta
    return model.eval(), fn, meta, want


def eager_rgb(model, x):
    """What an artifact of ``model`` computes, eagerly: NHWC numpy [B,H,W,1]
    -> clip(model(x), 0, 1) as NHWC numpy."""
    with torch.no_grad():
        y = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    return y.permute(0, 2, 3, 1).clamp(0.0, 1.0).numpy()


# The blle operators in each RAW -> RGB model's exported graph: K2 and K3
# for the TransformerBlocks, S1 for WFB's Mamba scans, none for luma-MHSA
# and WavKAN (no TransformerBlock, no scan).
BLOCK_OPS = ["blle.apply_pass", "blle.gram_pass"]
GRAPH_OPS = {"rawformer_wfb": ["blle.selective_scan_fwd"], "luma_mhsa_rawformer": [],
             "wavkan_rawformer": []}
