"""One run of one cell: find its pieces by name, run its loop, read its
metrics, hold its outputs to the reference, print the result line.

Everything that belongs to one cell is found by the names in
``BENCHMARK.json``:

* ``configs/<config>.json``: the model (registry name, widths, dtypes,
  the weights' ranges);
* ``traffic/<traffic>.json``: the mix's parameters; its ``kind`` names the
  generator and loop, ``traffic/<kind>.py``;
* ``workloads/<cell>.json``: the cell's route (the ``blle`` operators a
  request or step calls, checked in traced runs) and its output limits;
* ``metrics/<metric>.py``: one reader per metric, ``read(record)``.
"""

import importlib.util
import json
import math
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "bayer_low_light_image_enhancement_tpu"}


class SetupError(Exception):
    """The cell cannot run here (no card, a missing piece)."""


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """Import a file by its path (metric names hold dots)."""
    name = "port_bench_" + path.stem.replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.exists():
        raise SetupError(f"no such file: {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    cell: dict
    per_layer: List[dict]
    end_to_end: List[dict]
    overrides: dict = field(default_factory=dict)

    @classmethod
    def find(cls, name: str, root: Path = ROOT) -> "Cell":
        bench = load_json(root / "BENCHMARK.json")
        entry = next((w for w in bench["workloads"] if w["name"] == name), None)
        if entry is None:
            raise SetupError(f"no workload {name!r} in BENCHMARK.json")
        conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
        mine = [m for m in bench["end_to_end"] + bench["per_layer"]
                if name in m.get("workloads", [name])]
        return cls(
            name=name,
            chips=int(entry["chips"]),
            config=load_json(root / conf["file"]),
            traffic=load_json(HERE / "traffic" / f"{entry['traffic']}.json"),
            cell=load_json(HERE / "workloads" / f"{name}.json"),
            per_layer=[m for m in mine if m in bench["per_layer"]],
            end_to_end=[m for m in mine if m in bench["end_to_end"]],
        )


class Clock:
    """Set-up time from the process's start, split into named parts."""

    def __init__(self, t0: float):
        self.t0 = self.last = t0
        self.parts: Dict[str, float] = {}

    def mark(self, part: str) -> None:
        now = time.perf_counter()
        self.parts[part] = self.parts.get(part, 0.0) + now - self.last
        self.last = now

    def since_start(self) -> float:
        return time.perf_counter() - self.t0


@dataclass
class Record:
    """What a loop hands back: the window's work and the checks' numbers.
    ``units`` are requests or steps; ``mpix`` the megapixels they
    completed."""

    window_s: float = 0.0
    units: int = 0
    attempted: int = 0
    failed: int = 0
    mpix: float = 0.0
    latencies_s: List[float] = field(default_factory=list)
    setup_s: float = 0.0
    peak_bytes: int = 0
    window_peak_bytes: int = 0
    chips: int = 1
    flops_per_unit: float = 0.0
    trace: Optional[dict] = None
    trace_units: int = 0
    block_calls: Dict[str, tuple] = field(default_factory=dict)
    host_s: List[float] = field(default_factory=list)
    checks: Dict[str, dict] = field(default_factory=dict)
    notes: List[str] = field(default_factory=list)


def check_device(chips: int, device: str) -> None:
    if device != "cuda":
        return
    if not torch.cuda.is_available():
        raise SetupError("no CUDA device: the benchmark measures the card and does not "
                         "fall back to the CPU")
    if torch.cuda.device_count() < chips:
        raise SetupError(f"the cell needs {chips} CUDA devices, "
                         f"{torch.cuda.device_count()} are present")


def forbidden_modules() -> List[str]:
    """Modules loaded in this process whose top-level name is JAX's, one of
    its libraries' or the JAX package's (whole names compared)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError):
        return "not read"


def read_metrics(specs: List[dict], record: Record) -> Dict[str, dict]:
    out = {}
    for m in specs:
        value = load_module(HERE / "metrics" / f"{m['name']}.py").read(record)
        if value is None:
            continue
        if not math.isfinite(value):
            raise ValueError(f"metric {m['name']} read {value}")
        out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def route_checks(cell: Cell, record: Record) -> None:
    """In a traced run: the ``blle`` operators a unit of work called, each
    against the cell's route (an exact comparison, limit 0)."""
    if record.trace is None or not record.trace_units:
        return
    want = cell.cell.get("route", {})
    got = record.trace["ops"]
    for op in sorted(set(want) | set(got)):
        per_unit = got.get(op, 0) / record.trace_units
        record.checks[f"route {op}"] = {"value": abs(per_unit - want.get(op, 0)), "limit": 0}


def result_line(cell: Cell, record: Record, trace: bool, device: str) -> dict:
    metrics = read_metrics(cell.per_layer if trace else cell.end_to_end, record)
    route_checks(cell, record)
    ok = all(c["value"] <= c["limit"] for c in record.checks.values())
    correct = bool(ok and record.checks and record.failed == 0 and record.units > 0)
    dev = {
        "platform": "gpu" if device == "cuda" else "cpu",
        "kind": torch.cuda.get_device_name(0) if device == "cuda" else "cpu",
        "count": record.chips,
        "memory_peak_bytes": int(record.peak_bytes),
    }
    line = {"correct": correct, "attempted": record.attempted, "failed": record.failed,
            "metrics": metrics, "device": dev}
    if trace and record.trace is not None:
        dev["busy_s"] = record.trace["busy_s"]
        dev["window_s"] = record.trace["window_s"]
        line["breakdown"] = {"device_ops": record.trace["top_device_ops"],
                             "idle_gaps": record.trace["idle_by_host"]}
    line["checks"] = record.checks
    return line


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             t0: Optional[float] = None, overrides: Optional[dict] = None):
    """Run one cell once; returns the result line. ``overrides`` replaces
    keys of the config, traffic or cell files (``{"config": {...},
    "traffic": {...}, "cell": {...}}``): the tests run cells at small sizes
    on the CPU with it."""
    clock = Clock(time.perf_counter() if t0 is None else t0)
    cell = Cell.find(workload)
    cell.overrides = overrides or {}
    for part, over in cell.overrides.items():
        getattr(cell, part).update(over)
    check_device(cell.chips, device)
    loop = load_module(HERE / "traffic" / f"{cell.traffic['kind']}.py")
    record = loop.run(cell, seed=seed, seconds=seconds, trace=trace, device=device, clock=clock)
    found = forbidden_modules()
    if found:
        raise SetupError(f"the run loaded {', '.join(found)}: the benchmark measures the "
                         "port alone")
    line = result_line(cell, record, trace, device)
    if device == "cuda":
        print(f"card: {power_limit()}", file=sys.stderr)
    print("setup " + " ".join(f"{k}={v:.3f}s" for k, v in clock.parts.items()), file=sys.stderr)
    for note in record.notes:
        print(note, file=sys.stderr)
    for k, v in record.checks.items():
        print(f"check {k}: {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    return line

