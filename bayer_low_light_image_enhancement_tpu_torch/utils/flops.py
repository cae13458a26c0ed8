"""Parameter and operation counts of a model's forward.

Port of ``bayer_low_light_image_enhancement_tpu/utils/flops.py`` (the
reference's ptflops printout). The operations come from
``torch.utils.flop_counter.FlopCounterMode`` over one no-grad forward, with
the ``torch.ops.blle`` kernels counted by their flop formulas
(``kernels/ops.py``). PyTorch's convention is products and their sums only
(2 per multiply-add of a matmul or convolution; elementwise work, norms and
softmax count 0), so ``flops`` is not XLA's count and is not compared with
it.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Union

import torch
import torch.nn as nn

from bayer_low_light_image_enhancement_tpu_torch.utils.profiling import cost_analysis


def count_params(model: nn.Module) -> int:
    """The number of parameter elements (buffers such as BatchNorm's running
    statistics are not parameters)."""
    return sum(p.numel() for p in model.parameters())


def model_complexity(model: nn.Module, input_shape=(1, 512, 512, 1),
                     device: Optional[Union[str, torch.device]] = None) -> Dict[str, Any]:
    """{'params', 'flops', 'bytes_accessed'} for one no-grad forward of
    ``model`` on zeros of ``input_shape`` (NHWC, as the JAX function takes:
    [B,H,W,1] RAW mosaics, or [B,H,W,4] planes for a raw-domain model), on
    ``device`` (the model's own device when None; the model is moved
    there). ``bytes_accessed`` is None: PyTorch has no compiled cost
    analysis, as the JAX function returns None where XLA gives none."""
    if device is not None:
        model = model.to(device)
    dev = next(model.parameters()).device
    x = torch.zeros(input_shape, device=dev).permute(0, 3, 1, 2)
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            flops = cost_analysis(model, x)["flops"]
    finally:
        model.train(was_training)
    return {"params": count_params(model), "flops": flops, "bytes_accessed": None}
