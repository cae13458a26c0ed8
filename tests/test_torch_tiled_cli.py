"""The eval CLI over a spatial mesh on the CPU: ``--spatial_chips 2`` and
``--spatial_chips 2 --spatial_w_chips 2`` start 2 and 4 gloo ranks of the
CLI (``--device cpu``), each frame is tiled over them and rank 0 reports;
the per-image PSNR / SSIM equal the single-device run's in fp32 (within
1e-3 dB / 1e-5), for RawFormer-S, for RawFormer-WFB by H, for
``flca_rawformer`` by H and over 2 x 2 (built with both axes: ROADMAP C17)
and for ``luma_mhsa_rawformer`` by H; rank 0 alone writes the CSV. And the
CLI's exits: WFB over W, a bad count, no card, and ranks started by
torchrun that do not match the flags."""

import numpy as np
import pytest
import torch

from bayer_low_light_image_enhancement_tpu_torch.cli import test_cli

PSNR_TOL, SSIM_TOL = 1e-3, 1e-5


@pytest.fixture(autouse=True)
def few_threads(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "2")  # the ranks' torch threads


def base(tmp_path, *extra):
    return ["--dataset", "synthetic", "--patch_size", "64", "--fp32", "--device", "cpu",
            "--save_dir", str(tmp_path), *extra]


@pytest.mark.parametrize("model,mesh", [
    ([], ["--spatial_chips", "2"]),
    ([], ["--spatial_chips", "2", "--spatial_w_chips", "2"]),
    (["--model", "rawformer_wfb"], ["--spatial_chips", "2"]),
    (["--model", "flca_rawformer"], ["--spatial_chips", "2"]),
    (["--model", "flca_rawformer"], ["--spatial_chips", "2", "--spatial_w_chips", "2"]),
    (["--model", "luma_mhsa_rawformer"], ["--spatial_chips", "2"]),
])
def test_eval_cli_over_a_spatial_mesh_matches_one_device(tmp_path, capfd, model, mesh):
    one = test_cli.main(base(tmp_path / "one", *model))
    capfd.readouterr()
    tiled = test_cli.main(base(tmp_path / "tiled", *model, *mesh))
    out = capfd.readouterr().out
    assert len(tiled["psnr"]) == len(one["psnr"]) == 4
    np.testing.assert_allclose(tiled["psnr"], one["psnr"], rtol=0, atol=PSNR_TOL)
    np.testing.assert_allclose(tiled["ssim"], one["ssim"], rtol=0, atol=SSIM_TOL)
    n = int(mesh[1])
    wfb = model == ["--model", "rawformer_wfb"]
    h_mult = 32 if wfb else 16
    assert tiled["pad_to"] == max(h_mult * n, 32 if wfb else 16)
    assert out.count("image:0\t") == 1 and out.count("Average PSNR") == 1  # rank 0 alone
    rows = (tmp_path / "tiled" / "synthetic" / "csv" / "test_metrics.csv").read_text().split()
    assert len(rows) == 4


def test_eval_cli_spatial_exits(tmp_path, monkeypatch):
    with pytest.raises(SystemExit, match="H-shardable only"):
        test_cli.main(base(tmp_path, "--model", "rawformer_wfb", "--spatial_chips", "2",
                           "--spatial_w_chips", "2"))
    with pytest.raises(SystemExit, match="want counts >= 1"):
        test_cli.main(base(tmp_path, "--spatial_chips", "0"))
    monkeypatch.setenv("WORLD_SIZE", "3")  # started by torchrun with three ranks
    with pytest.raises(SystemExit, match="4 ranks, but 3 were started"):
        test_cli.main(base(tmp_path, "--spatial_chips", "4"))
    monkeypatch.delenv("WORLD_SIZE")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        test_cli.main(["--dataset", "synthetic", "--spatial_chips", "2"])
