"""Numerical debugging: non-finite audits, gradient statistics, anomaly mode.

Port of ``bayer_low_light_image_enhancement_tpu/utils/debug.py`` (the
reference's NaN/Inf input skip and per-parameter gradient printer):

* ``enable_debug_nans`` turns on autograd's anomaly mode with its NaN
  check: a backward that produces NaN raises at the forward op that made it
  (JAX's ``jax_debug_nans``);
* ``check_finite_tree`` audits a module's ``state_dict``, a ``state_dict`` or
  a flat mapping of tensors or numpy arrays;
* ``grad_stats`` is the gradient-hook printer as a function;
* ``finite_or_zero`` zeroes non-finite values (the Trainer's NaN guard skips
  the whole update instead, ``train/trainer.py``).

JAX's ``enable_leak_checking`` guards against leaked tracers, which PyTorch
does not have: it is not ported.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Tuple, Union

import numpy as np
import torch
import torch.nn as nn

Tree = Union[nn.Module, Mapping[str, Any]]


def enable_debug_nans(enable: bool = True) -> None:
    """Autograd anomaly mode with the NaN check, process-wide."""
    torch.autograd.set_detect_anomaly(enable, check_nan=True)


def _entries(tree: Tree) -> Mapping[str, Any]:
    return tree.state_dict() if isinstance(tree, nn.Module) else tree


def _tensor(v: Any) -> torch.Tensor:
    return v.detach() if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))


def check_finite_tree(tree: Tree, name: str = "tree") -> List[str]:
    """The entries of ``tree`` holding a NaN or an infinity, as
    ``name['key']`` (JAX's path notation); empty when all are finite.
    Integer and boolean entries are always finite."""
    bad = []
    for key, v in _entries(tree).items():
        t = _tensor(v)
        if t.is_floating_point() and not bool(torch.isfinite(t).all()):
            bad.append(f"{name}[{key!r}]")
    return bad


def grad_stats(grads: Tree) -> Dict[str, Tuple[float, float, bool]]:
    """{name: (max |g|, mean g, whether g has a NaN)} over a module's
    parameter gradients (those that have one) or a mapping of gradients;
    the sums are taken in float64."""
    if isinstance(grads, nn.Module):
        grads = {k: p.grad for k, p in grads.named_parameters() if p.grad is not None}
    out = {}
    for key, v in grads.items():
        t = _tensor(v).double()
        empty = t.numel() == 0
        out[key] = (0.0 if empty else t.abs().max().item(), 0.0 if empty else t.mean().item(),
                    bool(t.isnan().any()))
    return out


def finite_or_zero(tensors: Any) -> Any:
    """A tensor, or a mapping, list or tuple of tensors, with every
    non-finite value replaced by 0."""
    if isinstance(tensors, torch.Tensor):
        return torch.where(torch.isfinite(tensors), tensors, torch.zeros_like(tensors))
    if isinstance(tensors, Mapping):
        return {k: finite_or_zero(v) for k, v in tensors.items()}
    return type(tensors)(finite_or_zero(v) for v in tensors)
