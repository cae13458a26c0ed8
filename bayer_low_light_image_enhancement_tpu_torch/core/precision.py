"""Mixed-precision policy.

Port of ``bayer_low_light_image_enhancement_tpu/core/precision.py`` with
torch dtypes: bf16 compute, fp32 parameters, fp32 output. Normalisation
statistics, softmax and token reductions accumulate in fp32 regardless.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Policy:
    """Precision policy: parameter storage / compute / output dtypes."""

    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16
    output_dtype: torch.dtype = torch.float32

    def cast_to_compute(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.compute_dtype)

    def cast_to_output(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.output_dtype)


def wide(x: torch.Tensor) -> torch.Tensor:
    """x in fp32 for a bf16 / fp16 / fp32 x, kept in fp64 for an fp64 x: the
    dtype of the statistics and reductions that run in fp32 whatever the
    compute dtype (an fp64 model stays fp64 throughout, as the tests run
    it)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def default_policy(bf16: bool = True) -> Policy:
    """bf16 compute policy by default; pass ``bf16=False`` for full fp32."""
    if bf16:
        return Policy()
    return Policy(compute_dtype=torch.float32)
