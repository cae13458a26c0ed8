"""The port's mesh (``core/mesh.py``) and its data split on the CPU: the
mesh shapes and errors against the JAX ``create_mesh`` on the same device
counts, ``create_mesh`` on a 4-rank gloo world (``tests/torch_dist_workers.py``),
each data rank's rows of the global batch from ``Loader`` and the native
engine, and the training CLI over two gloo ranks with ``--resume`` under
another layout."""

import re

import jax
import numpy as np
import pytest

import torch_dist_workers as workers
from bayer_low_light_image_enhancement_tpu.core.mesh import create_mesh as jax_create_mesh
from bayer_low_light_image_enhancement_tpu_torch.cli import train_cli
from bayer_low_light_image_enhancement_tpu_torch.core import mesh as meshlib
from bayer_low_light_image_enhancement_tpu_torch.data import native, pipeline, synthetic
from bayer_low_light_image_enhancement_tpu_torch.models import RawFormer, RawFormerConfig
from bayer_low_light_image_enhancement_tpu_torch.serving import Predictor
from bayer_low_light_image_enhancement_tpu_torch.train import CheckpointManager

LAYOUTS = [
    (1, {}), (2, {}), (4, {}), (8, {}),
    (8, dict(tensor=2)), (8, dict(data=2, tensor=4)), (8, dict(data=2)),
    (4, dict(tensor=3)), (4, dict(data=4, tensor=2)), (6, dict(data=-1, tensor=4)),
    (2, dict(data=3)),
    (4, dict(data=1, spatial=4)), (8, dict(spatial=2, spatial_w=2)), (8, dict(spatial=4)),
    (8, dict(data=2, spatial=2, tensor=2)), (6, dict(spatial=4)), (4, dict(spatial_w=3)),
    (4, dict(data=1, spatial=4, spatial_w=2)), (8, dict(data=-1, spatial=2, spatial_w=2)),
]


def jax_shape(n, layout):
    try:
        return tuple(jax_create_mesh(**layout, devices=jax.devices()[:n]).devices.shape)
    except ValueError as e:
        return str(e)


def port_shape(n, layout):
    try:
        return meshlib.mesh_shape(n, **layout)
    except ValueError as e:
        return str(e)


@pytest.mark.parametrize("n,layout", LAYOUTS)
def test_mesh_shape_matches_jax(n, layout):
    """The (data, spatial, spatial_w, tensor) shape, or the error, of the
    JAX create_mesh over the first n devices."""
    assert port_shape(n, layout) == jax_shape(n, layout)


def test_spatial_axes_are_refused():
    """Spatial layouts follow the JAX rules: one larger than the ranks, or
    one the ranks do not divide under data=-1, is refused with the JAX
    error; create_mesh needs a process group; device_type is cuda or cpu."""
    for n, layout in ((2, dict(data=1, spatial=4)), (4, dict(spatial=2, spatial_w=3)),
                      (6, dict(spatial=4))):
        with pytest.raises(ValueError) as e:
            meshlib.mesh_shape(n, **layout)
        assert str(e.value) == jax_shape(n, layout)
    with pytest.raises(RuntimeError, match="initialised process group"):
        meshlib.create_mesh()
    with pytest.raises(ValueError, match="device_type"):
        meshlib.initialize_multihost("file:///nowhere", 1, 0, device_type="tpu")


def test_create_mesh_on_a_gloo_world(tmp_path):
    """Four gloo ranks: the meshes' shapes, axis names, each rank's
    coordinates (tensor fastest, then spatial_w, spatial, data slowest, as
    the JAX device array) and group sizes, the spatial layouts among them;
    the JAX errors for the layouts that do not fit."""
    layouts = [{}, dict(data=2, tensor=2), dict(data=1, tensor=4), dict(tensor=3),
               dict(data=4, tensor=2), dict(data=1, spatial=4), dict(spatial=2, spatial_w=2),
               dict(data=2, spatial=2), dict(spatial=2, tensor=2)]
    res = workers.run_job(workers.write_job(tmp_path / "job.pt", kind="mesh", layouts=layouts), 4)
    for r, out in enumerate(res):
        for layout, got in zip(layouts, out):
            want = jax_shape(4, layout)
            if isinstance(want, str):
                assert got == ("error", want)
                continue
            kind, shape, names, coords, groups, ranks = got
            assert kind == "mesh" and shape == want and names == meshlib.MESH_AXES
            assert ranks == list(range(4))
            assert coords == dict(zip(meshlib.MESH_AXES, map(int, np.unravel_index(r, shape))))
            assert groups == dict(zip(meshlib.MESH_AXES, shape))


def split_batches(make_loader, parts):
    """Each part's batches of one epoch, concatenated per batch."""
    per_part = [list(make_loader(p, parts)) for p in range(parts)]
    return [tuple(np.concatenate([bs[i][j] for bs in per_part]) for j in range(len(bs0)))
            for i, bs0 in enumerate(per_part[0])]


@pytest.mark.parametrize("parts", [2, 3, 4, 5])
def test_python_loader_rows_follow_the_global_batch(parts):
    """Loader(..., part, parts): part r yields rows row_range(B, r, parts)
    of each global batch (loading only those; none for part 0 of 5) and
    together they are the single loader's batches, the same draws, for the
    same seed."""
    ds = synthetic.SyntheticBayerDataset(num_images=8, full_size=(40, 56), patch_size=16, seed=4)
    whole = list(pipeline.Loader(ds, 4, seed=3, num_threads=2))
    got = split_batches(lambda p, n: pipeline.Loader(ds, 4, seed=3, num_threads=2, part=p,
                                                     parts=n), parts)
    assert len(got) == len(whole) == 2
    for g, w in zip(got, whole):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
    first = next(iter(pipeline.Loader(ds, 4, seed=3, part=1, parts=parts)))
    assert len(first[0]) == len(range(*meshlib.row_range(4, 1, parts)))


@pytest.mark.parametrize("compact", [False, True])
def test_native_loader_rows_follow_the_global_batch(compact):
    """The native engine's split: each data rank assembles only its rows of
    each global batch, from the same crop / flip draws."""
    ds = synthetic.SyntheticBayerDataset(num_images=8, full_size=(40, 56), patch_size=16, seed=4)
    sampler = native.sampler_for_dataset(ds, seed=2, compact=compact)
    assert sampler is not None, native._build_error
    whole = list(native.NativeLoader(ds, sampler, 4, seed=2))
    got = split_batches(lambda p, n: native.NativeLoader(ds, sampler, 4, seed=2, part=p,
                                                         parts=n), 2)
    assert len(got) == len(whole) == 2 and len(whole[0]) == (3 if compact else 2)
    for g, w in zip(got, whole):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
    raw = sampler.sample_batch([5, 1, 7, 2], 0, rows=(1, 3))[0]
    np.testing.assert_array_equal(raw, sampler.sample_batch([5, 1, 7, 2], 0)[0][1:3])


def test_train_cli_over_two_ranks_and_resume_under_another_layout(tmp_path, capfd, monkeypatch):
    """``--device cpu --num_chips 2`` trains one epoch over two gloo ranks
    (rank 0 alone writes the log and the checkpoints, in the single-device
    format); ``--resume`` under ``--num_chips 1 --tensor_chips 2`` goes on
    from them; the checkpoint loads into a one-process model and serves."""
    monkeypatch.setenv("OMP_NUM_THREADS", "2")  # the ranks' torch threads
    argv = ["--dataset", "synthetic", "--model_size", "S", "--patch_size", "32",
            "--batch_size", "4", "--save_dir", str(tmp_path), "--device", "cpu",
            "--loader", "python", "--fp32"]
    train_cli.main(argv + ["--num_chips", "2", "--epochs", "1"])
    log = (tmp_path / "synthetic" / "log.txt").read_text()
    assert log.count("Training start time") == 1
    assert re.search(r"Epoch 0/1 \| .*Epoch 1/1 \| ", log, re.S)
    weights = tmp_path / "synthetic" / "weights"
    assert sorted(p.name for p in weights.glob("*.pt")) == ["0.pt", "1.pt"]
    capfd.readouterr()
    train_cli.main(argv + ["--num_chips", "1", "--tensor_chips", "2", "--epochs", "2",
                           "--resume"])
    out = capfd.readouterr().out
    assert out.count("resumed from epoch 1") == 1 and "epoch 2/2" in out
    state, step = CheckpointManager(str(weights)).restore()
    assert step == 2 and state["trainer"]["applied"] == 12  # 3 epochs of 16 crops, batch 4
    model = RawFormer(RawFormerConfig.from_size("S"))
    model.load_state_dict(state["trainer"]["model"])  # the single-device names and shapes
    rgb = Predictor(model, device="cpu")(np.full((32, 32), 0.2, np.float32))
    assert rgb.shape == (32, 32, 3) and np.isfinite(rgb).all()


def test_train_cli_mesh_errors(tmp_path):
    argv = ["--dataset", "synthetic", "--patch_size", "32", "--batch_size", "4",
            "--save_dir", str(tmp_path), "--device", "cpu"]
    for bad, why in ((["--num_chips", "0"], "want --num_chips -1 or >= 1"),
                     (["--tensor_chips", "0"], "want --num_chips -1 or >= 1"),
                     (["--num_chips", "2", "--device", "cuda"], "needs 2 devices, have 0")):
        with pytest.raises(SystemExit, match=why):
            train_cli.main(argv + bad)


def test_train_cli_batch_note(capsys, monkeypatch):
    """The JAX CLI's rule: the data ranks shrink to the largest count that
    divides --batch_size, with its note."""
    args = train_cli.build_parser().parse_args(["--batch_size", "6", "--num_chips", "4",
                                                "--device", "cpu"])
    assert train_cli.check_supported(args) == (3, 1)
    assert "note: batch_size 6 not divisible by device count; using 3 data-parallel" \
        in capsys.readouterr().out
    monkeypatch.setenv("WORLD_SIZE", "4")  # started by torchrun with four ranks
    args = train_cli.build_parser().parse_args(["--tensor_chips", "2", "--device", "cpu"])
    assert train_cli.check_supported(args) == (2, 2)
    with pytest.raises(SystemExit, match="4 were started"):
        train_cli.check_supported(train_cli.build_parser().parse_args(["--num_chips", "1"]))
