"""Operations, bytes and peaks behind every roofline and mfu share.

Operations come from ``torch.utils.flop_counter.FlopCounterMode`` over the
frozen reference (``port_bench.reference.rawformer``) run on the meta
device at the shapes in question: convolutions (depthwise ones included,
by their groups), transposed convolutions and matmuls, two operations a
multiply-add; elementwise work is not counted. They never come from the
port's own flop formulas, so no change to the program moves the yardstick.

The backward of a convolution counts, for each gradient it computes
(input, weight), the forward's multiply-adds, groups included (torch's own
backward formula counts a depthwise convolution as a dense one).

Bytes count each input and each output of the work once: activations in
the compute dtype, parameters and their gradients in fp32.

Peaks: NVIDIA H100 SXM, dense bf16 989 TFLOP/s and HBM3 3.35 TB/s, the
data sheet's figures at the full 700 W (the run reports the card's power
limit beside its shares).
"""

import functools

import torch
from torch.utils.flop_counter import FlopCounterMode

from port_bench.reference import rawformer as ref

PEAK_FLOPS = 989e12
PEAK_BYTES_S = 3.35e12


def _conv_backward_flops(grad_out_shape, x_shape, w_shape, _bias, _stride, _padding,
                         _dilation, transposed, _output_padding, _groups, output_mask,
                         out_shape=None, **kwargs) -> int:
    """Two operations a multiply-add, the forward's multiply-adds once for
    each gradient computed."""
    per_weight = 1
    for s in w_shape[1:]:
        per_weight *= s
    spread = 1
    for s in (x_shape if transposed else grad_out_shape):
        spread *= s
    return 2 * spread * per_weight * (int(bool(output_mask[0])) + int(bool(output_mask[1])))


COUNTED = {torch.ops.aten.convolution_backward: _conv_backward_flops}


def _count(build, shape, backward: bool, input_grad: bool):
    """(forward operations, backward operations) of ``build()`` on an input
    of ``shape``, on the meta device (grad mode on, also when called from
    inside an inference)."""
    with torch.inference_mode(False), torch.enable_grad():
        return _count_meta(build, shape, backward, input_grad)


def _count_meta(build, shape, backward: bool, input_grad: bool):
    with torch.device("meta"):
        model = build()
        x = torch.empty(shape, requires_grad=input_grad)
    with FlopCounterMode(display=False, custom_mapping=COUNTED) as fwd:
        y = model(x)
    bwd = 0
    if backward:
        with FlopCounterMode(display=False, custom_mapping=COUNTED) as both:
            y.backward(torch.ones_like(y))
        bwd = both.get_total_flops()
    return fwd.get_total_flops(), bwd


@functools.lru_cache(maxsize=None)
def block_flops(dim: int, heads: int, ffn: int, shape: tuple, backward: bool = False) -> int:
    """Operations of one TransformerBlock (pre-LN channel attention, then
    the conv FFN) on an NCHW ``shape``: its forward, or with
    ``backward`` its backward (the input's and the parameters' gradients)."""
    f, b = _count(lambda: ref.TransformerBlock(dim, heads, ffn), shape, backward, True)
    return b if backward else f


@functools.lru_cache(maxsize=None)
def rawformer_flops(dim: int, heads: tuple, ffn: int, shape: tuple, backward: bool = False) -> int:
    """Operations of RawFormer on [B, 1, H, W] mosaics: the forward, or with
    ``backward`` the forward plus the backward (the input takes no
    gradient)."""
    f, b = _count(lambda: ref.RawFormerOracle(dim=dim, num_heads=heads, ffn_expansion=ffn),
                  shape, backward, False)
    return f + b


@functools.lru_cache(maxsize=None)
def block_param_count(dim: int, heads: int, ffn: int) -> int:
    """Parameters of one TransformerBlock."""
    with torch.device("meta"):
        return sum(p.numel() for p in ref.TransformerBlock(dim, heads, ffn).parameters())


def block_bytes(shape: tuple, act_bytes: int, dim: int, heads: int, ffn: int,
                backward: bool = False) -> int:
    """Bytes one block call must move: x in and y out (forward); x and dy
    in, dx out, the parameters read and their gradients written in fp32
    (backward); the parameters read once in either."""
    n = 1
    for s in shape:
        n *= s
    params = 4 * block_param_count(dim, heads, ffn)
    if backward:
        return 3 * n * act_bytes + 2 * params
    return 2 * n * act_bytes + params


def least_seconds(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the operations
    over the bf16 peak and the bytes over the HBM peak."""
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES_S)
