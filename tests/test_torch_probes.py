"""The probe ladders' plain twins and their CLI, on the CPU. The probe
kernels against these twins are in tests/test_torch_cuda.py."""

import pathlib
import subprocess
import sys

import pytest
import torch
import torch.nn.functional as F

from bayer_low_light_image_enhancement_tpu_torch.kernels import fused_block as fb
from bayer_low_light_image_enhancement_tpu_torch.probes import __main__ as cli
from bayer_low_light_image_enhancement_tpu_torch.probes import floor as pf

torch.set_num_threads(2)


def floor_inputs(seed=0, shape=(2, 13, 11, 32)):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(shape, generator=g).bfloat16()
    w = (torch.randn(32, 32, generator=g) / 32 ** 0.5).bfloat16()
    return x, w, torch.randn(9, 32, generator=g) / 3


@pytest.mark.parametrize("strategy", pf.STRATEGIES)
def test_floor_level_c_copies_exactly(strategy):
    x, w, dw = floor_inputs()
    before = pf.floor_probe.launches
    assert torch.equal(pf.floor_probe(x, w, dw, strategy, "c", 8), x)
    assert pf.floor_probe.launches == before


def test_floor_twin_levels_m_and_v():
    """Level m is x times w's sixth power; level v the whole-image chain,
    written here with grouped convs (zero padding)."""
    x, w, dw = floor_inputs(1)
    xf, wf = x.float(), w.float()
    torch.testing.assert_close(pf.floor_probe_plain(x, w, dw, "m"),
                               xf @ torch.linalg.matrix_power(wf, 6), rtol=1e-4, atol=1e-5)

    def dw3(z):
        k = dw.t().reshape(32, 1, 3, 3)
        return F.conv2d(z.permute(0, 3, 1, 2), k, padding=1, groups=32).permute(0, 2, 3, 1)

    y = dw3(dw3(xf @ wf) @ wf @ wf @ wf)
    torch.testing.assert_close(pf.floor_probe_plain(x, w, dw, "v"), F.gelu(y) @ wf @ wf,
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("c", [32, 64])
def test_bisect_twins_are_prefixes_of_the_apply_pass(c):
    """Stage 3 is the first residual's output, stage 2 that minus x, stage 1
    the v 1x1 before its depthwise conv, stage 4 the FFN expand of LN2(y),
    stage 5 the apply pass; the CPU wrapper returns them."""
    w = pf.block_weights(c, c, "cpu")
    x = torch.randn(2, 9, 10, c, generator=torch.Generator().manual_seed(c))
    apply = fb.finalize_attention(*fb.gram_pass_plain(x, w), w.temperature, w.wproj, 8)
    s = {k: pf.bisect_probe_plain(x, apply, w, k) for k in pf.STAGES}
    y = fb.attention_out_plain(x, apply, w)
    torch.testing.assert_close(s[3], y, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(s[2], y - x, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(s[1], fb._ln_hat(x) @ w.wv + w.bv, rtol=0, atol=0)
    torch.testing.assert_close(s[4], (fb._ln_hat(y) @ w.wp1 + w.bp1)[..., :c], rtol=1e-5,
                               atol=1e-5)
    torch.testing.assert_close(s[5], fb.apply_pass_plain(x, apply, w), rtol=0, atol=0)
    before = pf.bisect_probe.launches
    for kind in fb.APPLY_KERNELS:
        for k in pf.STAGES:
            assert torch.equal(pf.bisect_probe(x, apply, w, k, kind), s[k])
    assert pf.bisect_probe.launches == before


def test_probe_wrappers_check_arguments():
    x, w, dw = floor_inputs()
    for bad in (dict(strategy="dma"), dict(level="p3"), dict(th=32)):
        with pytest.raises(ValueError):
            pf.floor_probe(x, w, dw, **{**dict(strategy="plain", level="c", th=8), **bad})
    bw = pf.block_weights(32, 0, "cpu")
    apply = torch.zeros(2, 32, 32)
    with pytest.raises(ValueError, match="stage"):
        pf.bisect_probe(x.float(), apply, bw, 6)
    with pytest.raises(ValueError, match="apply_kernel"):
        pf.bisect_probe(x.float(), apply, bw, 1, "v6")


def test_cli_help():
    out = subprocess.run(
        [sys.executable, "-m", "bayer_low_light_image_enhancement_tpu_torch.probes", "--help"],
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0
    for flag in ("--ladder", "--th", "--strategies", "--levels", "--stages", "--widths"):
        assert flag in out.stdout


def test_tma_strategy_is_accepted_and_its_twin_is_the_plain_one():
    """The "tma" rung is a strategy of the wrapper and of the CLI; on the CPU
    every strategy's result is the whole-image twin at every level."""
    assert cli.parser().parse_args(["--strategies", "plain,tma"]).strategies == ["plain", "tma"]
    x, w, dw = floor_inputs(2)
    for level in pf.LEVELS:
        assert torch.equal(pf.floor_probe(x, w, dw, "tma", level, 4),
                           pf.floor_probe(x, w, dw, "plain", level, 4))


@pytest.mark.parametrize("argv", [["--th", "5"], ["--shape", "8,256,256,64"],
                                  ["--strategies", "plain,dma"], ["--levels", ""],
                                  ["--stages", "0"], ["--widths", "48"], ["--ladder", "roof"],
                                  ["--iters", "0"]])
def test_cli_refuses_bad_arguments(argv):
    with pytest.raises(SystemExit) as e:
        cli.main(argv)
    assert e.value.code == 2


def test_cli_needs_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    assert cli.main(["--ladder", "floor", "--th", "8"]) == 2
    assert "no CUDA device" in capsys.readouterr().err


def test_new_modules_import_no_jax():
    """The probes, A1 and T1 modules import nothing of JAX, of the JAX
    package, of attic/ or of benchmarks/."""
    code = (
        "import sys\n"
        "import bayer_low_light_image_enhancement_tpu_torch.probes.__main__\n"
        "import bayer_low_light_image_enhancement_tpu_torch.kernels.fused_attention\n"
        "import bayer_low_light_image_enhancement_tpu_torch.kernels.fused_stage\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'attic',\n"
        "       'benchmarks', 'bayer_low_light_image_enhancement_tpu', 'fused_attention',\n"
        "       'fused_stage')]\n"
        "assert not bad, bad\n"
    )
    root = pathlib.Path(__file__).resolve().parents[1]
    subprocess.run([sys.executable, "-c", code], check=True, cwd=root, timeout=120)
