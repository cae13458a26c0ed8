"""The program under test as the benchmark builds it, and the benchmark's
hooks on it.

The port is reached only through its public entry points (``get_model``,
``Predictor``, ``make_banded_forward`` / ``pick_bands``, ``Trainer``,
``prefetch_to_device``), imported inside the functions that use them. Both sides
take the benchmark's seeded weights by the reference's parameter names.
"""

import time

import torch

from port_bench import counts, tracing, weights
from port_bench.reference import rawformer as ref

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def reference_shapes(config: dict):
    with torch.device("meta"):
        model = reference(config)
    return [(n, t.shape) for n, t in model.state_dict().items()]


def reference(config: dict):
    return ref.RawFormerOracle(dim=config["dim"], num_heads=tuple(config["num_heads"]),
                               ffn_expansion=config["ffn_expansion"])


def seeded_weights(config: dict, seed: int, device):
    return weights.make_weights(reference_shapes(config), seed, device, config["init"])


def reference_model(config: dict, seed: int, device):
    """The fp32 reference with the run's weights, made again from the
    seed."""
    model = reference(config).to(device)
    model.load_state_dict(seeded_weights(config, seed, device))
    return model


def port_model(config: dict, seed: int, device):
    """The port's model of the configuration, in its stated dtypes, with the
    run's weights."""
    from bayer_low_light_image_enhancement_tpu_torch.models import get_model

    model = get_model(config["model"], device=device,
                      dtype=DTYPES[config["compute_dtype"]],
                      param_dtype=DTYPES[config["param_dtype"]])
    c = model.config
    got = (c.dim, tuple(c.num_heads), c.ffn_expansion)
    want = (config["dim"], tuple(config["num_heads"]), config["ffn_expansion"])
    if got != want:
        raise ValueError(f"{config['model']} builds {got}, the configuration states {want}")
    model.load_state_dict(seeded_weights(config, seed, device))
    return model


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class BlockHooks:
    """Ranges around every TransformerBlock call (forward, and with
    ``backward`` its backward), each named by a call index whose shape and
    least time (``counts``) the hooks record."""

    def __init__(self, model, config: dict, act_bytes: int, backward: bool):
        from bayer_low_light_image_enhancement_tpu_torch.models.common import TransformerBlock

        self.ranges = tracing.Ranges()
        self.least = {}  # range name -> least seconds
        self.handles = []
        self.config = config
        self.act_bytes = act_bytes
        for m in model.modules():
            if isinstance(m, TransformerBlock):
                self.handles.append(m.register_forward_pre_hook(self._pre))
                self.handles.append(m.register_forward_hook(self._post))
                if backward:
                    self.handles.append(m.register_full_backward_pre_hook(self._bwd_pre))
                    self.handles.append(m.register_full_backward_hook(self._bwd_post))

    def _least(self, module, shape, backward: bool) -> float:
        c, heads, ffn = shape[1], module.num_heads, self.config["ffn_expansion"]
        flops = counts.block_flops(c, heads, ffn, tuple(shape), backward)
        nbytes = counts.block_bytes(tuple(shape), self.act_bytes, c, heads, ffn, backward)
        return counts.least_seconds(flops, nbytes)

    def _open(self, module, shape, backward: bool) -> None:
        name = f"bench::block{'_bwd' if backward else ''}#{len(self.least)}"
        self.least[name] = self._least(module, shape, backward)
        self.ranges.enter("bwd" if backward else "fwd", name)

    def _pre(self, module, args):
        self._open(module, args[0].shape, False)

    def _post(self, module, args, out):
        self.ranges.exit("fwd")

    def _bwd_pre(self, module, grad_out):
        self._open(module, grad_out[0].shape, True)

    def _bwd_post(self, module, grad_in, grad_out):
        self.ranges.exit("bwd")

    def remove(self) -> None:
        for h in self.handles:
            h.remove()


class CallTimer:
    """Host time inside each call of ``module`` (synchronised at both ends),
    under a ``bench::model`` range."""

    def __init__(self, module, device):
        self.device = device
        self.inside = []
        self.ranges = tracing.Ranges()
        self._t = None
        self.handles = [module.register_forward_pre_hook(self._pre),
                        module.register_forward_hook(self._post)]

    def _pre(self, module, args, kwargs=None):
        sync(self.device)
        self._t = time.perf_counter()
        self.ranges.enter("m", "bench::model")

    def _post(self, module, args, out):
        sync(self.device)
        self.ranges.exit("m")
        self.inside.append(time.perf_counter() - self._t)

    def remove(self) -> None:
        for h in self.handles:
            h.remove()
