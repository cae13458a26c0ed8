"""Kernel arguments made from module weights, cached per weight version.

A wrapper that hands a kernel its weights in another layout or dtype (T1's
stacked bf16 taps, A1's split and transposed matrices) makes them once per
version of its source tensors instead of on every call. An entry is keyed by
each source's ``id`` and ``_version``: a weight changed in place bumps its
version, so the next call remakes the arguments. The entry holds its sources,
so no ``id`` is reused while it lives. Inference tensors (made under
``torch.inference_mode``) keep no version counter: their arguments are made
on every call and never stored.
"""

from __future__ import annotations

import collections
from typing import Any, Callable, Sequence

import torch


class ArgCache:
    """The ``size`` most recently used argument sets, by source version."""

    def __init__(self, size: int = 16):
        self.size = size
        self._entries: "collections.OrderedDict" = collections.OrderedDict()

    def get(self, sources: Sequence[torch.Tensor], make: Callable[[], Any]) -> Any:
        """The arguments ``make()`` gives for ``sources`` as they stand now."""
        if any(v.is_inference() for v in sources):
            return make()
        key = tuple((id(v), v._version) for v in sources)
        hit = self._entries.get(key)
        if hit is not None:
            self._entries.move_to_end(key)
            return hit[1]
        args = make()
        self._entries[key] = (tuple(sources), args)
        if len(self._entries) > self.size:
            self._entries.popitem(last=False)
        return args

    def __len__(self) -> int:
        return len(self._entries)
