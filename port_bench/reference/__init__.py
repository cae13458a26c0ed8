"""The benchmark's plain reference: what each cell's outputs are held to.

Plain PyTorch in fp32 with TF32 off. It imports nothing of the port and
takes nothing the port made: it decodes the uint16 mosaics itself, gets
its weights by name from the benchmark (``port_bench.weights``) and works
out again every step the port's timed path took.

* ``rawformer``: the frozen RawFormer oracle;
* ``decode``: SID uint16 codes -> the model's input, the request's pad and
  crop;
* ``train``: the training step (Charbonnier, the NaN guard, Adam under the
  warmup-cosine schedule), in blocks of rows;
* ``lowp``: the control, the reference with every convolution and matmul
  operand rounded to float8.
"""

import contextlib

import torch


@contextlib.contextmanager
def fp32():
    """TF32 off for matmuls and cuDNN convolutions inside the block, as
    they were before it."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old
