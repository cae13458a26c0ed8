"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level module names (the port's name begins with the JAX
package's, so a prefix would be wrong), and the reference imports nothing
of the port."""

import ast
import subprocess
import sys
import types
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
HERE = ROOT / "port_bench"
FORBIDDEN = {"jax", "jaxlib", "flax", "bayer_low_light_image_enhancement_tpu"}
PORT = "bayer_low_light_image_enhancement_tpu_torch"
SOURCES = sorted(p for p in HERE.rglob("*.py") if "tests" not in p.parts)


def imported(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_sources_import_no_jax(path):
    assert not set(imported(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert PORT not in set(imported(path))
    assert set(imported(path)) <= {"torch", "contextlib", "math", "dataclasses", "typing",
                                   "port_bench"}


def test_whole_names_are_compared(monkeypatch):
    from port_bench import harness

    monkeypatch.setitem(sys.modules, PORT + ".fake", types.ModuleType(PORT + ".fake"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    assert harness.forbidden_modules() == ["jax"]


def test_a_run_loads_no_jax():
    """Import everything a run imports, the port's entry points included, in
    a fresh process, and look at sys.modules."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from port_bench import harness, calibrate, counts, tracing, program\n"
        "from port_bench.traffic import serve_frames, train_steps\n"
        "from bayer_low_light_image_enhancement_tpu_torch.models.fused_apply import "
        "make_banded_forward, pick_bands\n"
        "from bayer_low_light_image_enhancement_tpu_torch.serving import Predictor\n"
        "from bayer_low_light_image_enhancement_tpu_torch.train.trainer import Trainer\n"
        "from bayer_low_light_image_enhancement_tpu_torch.data.pipeline import "
        "prefetch_to_device\n"
        "import pathlib\n"
        "for p in pathlib.Path(%r).glob('metrics/*.py'): harness.load_module(p)\n"
        "print(','.join(harness.forbidden_modules()))\n"
    ) % (str(ROOT), str(HERE))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == ""
