"""The control: the reference computed one precision below bf16.

Inside ``float8_operands()`` every convolution and matrix product of the
reference takes its floating operands rounded to float8 (e4m3, scaled per
tensor by its largest magnitude, as fp8 inference and training kernels
scale them); the gradients flowing back into those operands are rounded to
e5m2 the same way. Everything else (bias adds, norms, softmax, the loss,
Adam) stays in fp32. This is the step a later change could be tempted to
take below the configuration's bf16 compute, so the benchmark's limits must
fail it.
"""

import contextlib

import torch
from torch.overrides import TorchFunctionMode

E4M3_MAX = 448.0
E5M2_MAX = 57344.0
_PRODUCTS = {"conv2d", "conv_transpose2d", "matmul", "__matmul__", "__rmatmul__", "bmm",
             "linear"}


def round_fp8(x: torch.Tensor, dtype=torch.float8_e4m3fn, top: float = E4M3_MAX) -> torch.Tensor:
    """x rounded to ``dtype`` under a per-tensor scale that maps its largest
    magnitude to ``top``; returned in x's dtype."""
    amax = x.detach().abs().max()
    if not bool(torch.isfinite(amax)) or float(amax) == 0.0:
        return x
    s = top / amax
    return ((x * s).clamp(-top, top).to(dtype).to(x.dtype)) / s


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return round_fp8(x)

    @staticmethod
    def backward(ctx, g):
        return round_fp8(g, torch.float8_e5m2, E5M2_MAX)


class _Fp8Operands(TorchFunctionMode):
    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if getattr(func, "__name__", "") in _PRODUCTS:
            args = tuple(_Fp8.apply(a) if isinstance(a, torch.Tensor) and a.is_floating_point()
                         and a.dim() > 1 else a for a in args)
        return func(*args, **kwargs)


@contextlib.contextmanager
def float8_operands():
    with _Fp8Operands():
        yield
