"""The kernel-argument cache T1 and A1 share (``kernels/arg_cache.py``), on
the CPU: arguments are made once per weight version, remade after an
in-place update, and never stored for inference tensors."""

import pytest
import torch

from bayer_low_light_image_enhancement_tpu_torch.kernels import fused_attention as fa
from bayer_low_light_image_enhancement_tpu_torch.kernels import fused_stage as fs
from bayer_low_light_image_enhancement_tpu_torch.kernels.arg_cache import ArgCache
from bayer_low_light_image_enhancement_tpu_torch.models import common

torch.set_num_threads(2)


def attention_params(c, seed):
    attn = common.ChannelAttention(c, 4)
    common.reset_parameters_(attn, torch.Generator().manual_seed(seed))
    return {k: v.detach() for k, v in attn.state_dict().items()}


def test_t1_and_a1_share_one_cache_class():
    assert isinstance(fs._ARGS, ArgCache) and isinstance(fa._ARGS, ArgCache)
    assert fs._ARGS is not fa._ARGS


def test_cache_keeps_the_most_recent_entries():
    cache = ArgCache(size=2)
    ts = [torch.zeros(3) for _ in range(3)]
    made = []

    def make(i):
        made.append(i)
        return i

    for i in (0, 1, 0, 2, 0, 1):
        assert cache.get([ts[i]], lambda: make(i)) == i
    # 0 and 1 made, 0 hit, 2 made (evicts 1), 0 hit, 1 made again
    assert made == [0, 1, 2, 1] and len(cache) == 2


def test_attention_args_are_remade_after_an_in_place_update():
    """A1's arguments: the same objects while the weights stand, new ones
    after an in-place change, holding the twin's weights in the kernels'
    layouts and dtypes."""
    sd = attention_params(32, 0)
    first = fa._kernel_args(sd)
    assert fa._kernel_args(sd) is first
    gram, fin, app = first
    w = fa.attention_weights(sd)
    want = [w.wqk, w.bqk, w.dwqk, w.bdwqk, w.temperature, w.wproj, w.wv, w.bv, w.dwv, w.bdwv,
            w.bproj]
    for got, ref in zip(gram + fin + app, want):
        assert got.is_contiguous() and got.shape == ref.shape
        assert got.dtype == (torch.bfloat16 if got is gram[0] or got is app[0] else torch.float32)
        torch.testing.assert_close(got.float(), ref, rtol=1e-2, atol=1e-2)
    with torch.no_grad():
        sd["project_out.weight"].mul_(-1.0)
    second = fa._kernel_args(sd)
    assert second is not first
    assert torch.equal(second[1][1], -first[1][1])  # wproj
    assert torch.equal(second[0][0], first[0][0])   # wqk unchanged


@pytest.mark.parametrize("wrapper", ["attention", "stage_tail"])
def test_inference_tensors_are_never_stored(wrapper):
    """Weights made under torch.inference_mode keep no version counter:
    their arguments are made on every call and the cache does not grow."""
    if wrapper == "attention":
        mod, make_sd, key = fa, lambda: attention_params(32, 1), "temperature"
    else:
        stage = common.ConvTransformer(32, 4, 2)
        common.reset_parameters_(stage, torch.Generator().manual_seed(1))
        mod, key = fs, "Conv_out.bias"
        make_sd = lambda: {k: v.detach() for k, v in stage.state_dict().items()  # noqa: E731
                           if not k.startswith("Transformer.")}
    size = len(mod._ARGS)
    # Flat index 4 is the argument made from `key` in both wrappers (A1's
    # temperature, T1's output bias).
    flat = lambda a: [t for part in a for t in (part if isinstance(part, list) else [part])]  # noqa: E731
    with torch.inference_mode():
        sd = {k: v.clone() for k, v in make_sd().items()}
        first = mod._kernel_args(sd)
        before = flat(first)[4].clone()
        sd[key].add_(1.0)
        second = mod._kernel_args(sd)
    assert second is not first and len(mod._ARGS) == size
    torch.testing.assert_close(flat(second)[4], before + 1.0)
