"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Every test here is marked ``cuda`` and skips without a card (the kernels
have no CPU mode). The file imports nothing of JAX, so it also runs on a
machine without it:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from bayer_low_light_image_enhancement_tpu_torch.kernels import bayer_pack as bp
from bayer_low_light_image_enhancement_tpu_torch.kernels import fused_block as fb
from bayer_low_light_image_enhancement_tpu_torch.models import RawFormer, RawFormerConfig, common
from bayer_low_light_image_enhancement_tpu_torch.serving import Predictor

torch.set_num_threads(2)

pytestmark = pytest.mark.cuda

# bf16 kernel vs fp32 twin on the same bf16 input, as tests/test_fused_block.py.
BF16_TOL = dict(rtol=2.5e-2, atol=2.5e-2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def u16(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int16)).to(device).view(torch.uint16)


@pytest.mark.parametrize("shape", [(2, 16, 64), (1, 6, 20)])  # vector and scalar paths
def test_pack_kernel_matches_twin(cuda, shape):
    g = np.random.default_rng(8)
    m = g.integers(0, 65536, shape, dtype=np.uint16)  # hot pixels included
    md, rd = u16(m, cuda), torch.from_numpy(g.uniform(1, 300, shape[0]).astype(np.float32)).to(cuda)
    before = bp.bayer_pack_normalize.launches
    got = bp.bayer_pack_normalize(md, rd, torch.bfloat16, clamp01=True)
    assert bp.bayer_pack_normalize.launches == before + 1
    want = bp.bayer_pack_normalize_plain(md, rd, torch.float32, clamp01=True)
    torch.testing.assert_close(got.float(), want, rtol=0, atol=4e-3)
    got = bp.bayer_pack_normalize(md, rd, torch.float32)
    torch.testing.assert_close(got, bp.bayer_pack_normalize_plain(md, rd), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("c", fb.KERNEL_WIDTHS)
def test_block_kernels_match_twins(cuda, c):
    blk = common.TransformerBlock(c, 8, 2, device=cuda)
    common.reset_parameters_(blk, torch.Generator().manual_seed(c))
    params = dict(blk.named_parameters())
    x = torch.randn(2, 19, 13, c, device=cuda).to(torch.bfloat16)  # ragged tiles
    w = fb.fold_block_params(params)
    with torch.inference_mode():
        g, qs, ks = fb.gram_pass(x, w)
        g0, qs0, ks0 = fb.gram_pass_plain(x, w)
        cos = g / torch.sqrt(qs[:, :, None] * ks[:, None, :])
        cos0 = g0 / torch.sqrt(qs0[:, :, None] * ks0[:, None, :])
        torch.testing.assert_close(cos, cos0, rtol=0, atol=2e-2)
        torch.testing.assert_close(qs, qs0, rtol=2e-2, atol=0)
        got = fb.fused_transformer_block(x, params, 8).float()
        want = fb.fused_transformer_block_plain(x, params, 8).float()
    torch.testing.assert_close(got, want, **BF16_TOL)


def test_block_kernels_refuse_grad_and_unsupported_widths(cuda):
    blk = common.TransformerBlock(32, 8, 2, device=cuda)
    x = torch.randn(1, 8, 8, 32, device=cuda).to(torch.bfloat16)
    with pytest.raises(RuntimeError, match="inference-only"):
        fb.fused_transformer_block(x, dict(blk.named_parameters()), 8)
    blk16 = common.TransformerBlock(16, 8, 2, device=cuda)
    with torch.inference_mode(), pytest.raises(ValueError, match="no kernel"):
        fb.fused_transformer_block(x[..., :16].contiguous(), dict(blk16.named_parameters()), 8)


def test_raw_u16_serving_matches_cpu_twin_path(cuda):
    """RawFormer-S on the card (kernels, bf16) against the same weights on
    the CPU (twins, fp32), through Predictor.raw_u16 on a ragged frame."""
    gen = torch.Generator().manual_seed(3)
    gpu = RawFormer(RawFormerConfig.from_size("S", dtype=torch.bfloat16), device=cuda, generator=gen)
    cpu = RawFormer(RawFormerConfig.from_size("S"))
    cpu.load_state_dict(gpu.state_dict())
    m = np.random.default_rng(9).integers(0, 17000, (2, 70, 90), dtype=np.uint16)
    before = (fb.gram_pass.launches, fb.apply_pass.launches)
    got = Predictor(gpu).raw_u16(m, [60.0, 200.0])
    assert (fb.gram_pass.launches, fb.apply_pass.launches) == (before[0] + 7, before[1] + 7)
    want = Predictor(cpu).raw_u16(m, [60.0, 200.0])
    assert got.shape == (2, 70, 90, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-2)
