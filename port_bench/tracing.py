"""The traced run: torch.profiler over a short window, read back from its
Chrome trace.

The benchmark opens its own ranges with ``record_function``: the window
(``bench::window``), each unit of work (``bench::request`` / ``bench::step``),
the served model's call (``bench::model``), and every TransformerBlock's
forward and backward (``bench::block#<i>``, ``bench::block_bwd#<i>``, from
module hooks; ``i`` indexes the shapes the hooks recorded). A device
operation belongs to a range when the host call that launched it (found by
the profiler's correlation id) ran inside that range on the same thread.
"""

import bisect
import contextlib
import json
import os
import tempfile
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

from port_bench import stats

WINDOW = "bench::window"
# Busy and idle time count kernels alone: a copy keeps the copy engine
# busy while the SMs wait (a pageable copy is staged by the host besides).
# Copies and sets still show among the device operations and in the
# ranges' device time.
KERNEL_CAT = "kernel"
DEVICE_CATS = {KERNEL_CAT, "gpu_memcpy", "gpu_memset"}
LAUNCH_CATS = {"cuda_runtime", "cuda_driver"}
HOST_CATS = {"cpu_op", "user_annotation"}


class Ranges:
    """Open and close named ``record_function`` ranges from hooks."""

    def __init__(self):
        self._open: Dict[object, list] = defaultdict(list)

    def enter(self, key, name: str) -> None:
        rf = torch.autograd.profiler.record_function(name)
        rf.__enter__()
        self._open[key].append(rf)

    def exit(self, key) -> None:
        if self._open[key]:
            self._open[key].pop().__exit__(None, None, None)


def profiler():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def events_of(prof) -> List[dict]:
    """The profile's complete ("X") events, through a Chrome trace written
    to a temporary file that is removed again."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    finally:
        os.unlink(path)
    return [e for e in data.get("traceEvents", []) if e.get("ph") == "X"]


class Trace:
    """A trace's events, indexed for the readers (times in seconds)."""

    def __init__(self, events: List[dict]):
        self.device, self.host, self.launch = [], [], {}
        for e in events:
            cat = str(e.get("cat", "")).lower()
            ts, dur = float(e["ts"]) * 1e-6, float(e.get("dur", 0.0)) * 1e-6
            corr = (e.get("args") or {}).get("correlation")
            if cat in DEVICE_CATS:
                self.device.append((e["name"], ts, ts + dur, corr, cat == KERNEL_CAT))
            elif cat in LAUNCH_CATS and corr is not None:
                self.launch[corr] = (ts, e.get("tid"))
            elif cat in HOST_CATS:
                self.host.append((e["name"], ts, ts + dur, e.get("tid")))
        win = [h for h in self.host if h[0] == WINDOW]
        if not win:
            raise ValueError(f"the trace has no {WINDOW} range")
        _, self.lo, self.hi, self.tid = win[0]
        self.device = [d for d in self.device if d[2] > self.lo and d[1] < self.hi]
        self.kernels = [(a, b) for _, a, b, _, kernel in self.device if kernel]

    @property
    def window_s(self) -> float:
        return self.hi - self.lo

    def busy_s(self) -> float:
        """Seconds of the window in which some kernel ran on the device."""
        return stats.covered(stats.clip(self.kernels, self.lo, self.hi))

    def copy_s(self, kind: str) -> float:
        """Device seconds of the copies whose name holds ``kind`` (``DtoH``,
        ``HtoD``), within the window."""
        return sum(min(b, self.hi) - max(a, self.lo)
                   for name, a, b, _, kernel in self.device if not kernel and kind in name)

    def host_ranges(self, prefix: str) -> List[Tuple[str, float, float, object]]:
        return [h for h in self.host if h[0].startswith(prefix) and self.lo <= h[1] < self.hi]

    def count(self, prefix: str) -> Dict[str, int]:
        """Host operations whose name starts with ``prefix``, counted."""
        out: Dict[str, int] = defaultdict(int)
        for name, *_ in self.host_ranges(prefix):
            out[name] += 1
        return dict(out)

    def device_time_in(self, prefix: str) -> Dict[str, float]:
        """Device seconds of the operations launched inside each range whose
        name starts with ``prefix``."""
        by_tid = defaultdict(list)
        for name, a, b, tid in self.host_ranges(prefix):
            by_tid[tid].append((a, b, name))
        for v in by_tid.values():
            v.sort()
        starts = {t: [r[0] for r in v] for t, v in by_tid.items()}
        out: Dict[str, float] = defaultdict(float)
        for name, a, b, corr, _ in self.device:
            ts, tid = self.launch.get(corr, (None, None))
            if ts is None or tid not in by_tid:
                continue
            i = bisect.bisect_right(starts[tid], ts) - 1
            if i >= 0 and by_tid[tid][i][1] >= ts:
                out[by_tid[tid][i][2]] += b - a
        return dict(out)

    def top_device_ops(self, n: int = 10) -> List[list]:
        tot: Dict[str, float] = defaultdict(float)
        for name, a, b, _, _ in self.device:
            tot[name[:200]] += b - a
        return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]

    def idle_by_host(self, n: int = 10) -> List[list]:
        """The device's idle time in the window (no kernel running), summed by
        the innermost host operation that the window's thread was running in
        mid-gap."""
        points = []  # (time, order, payload): ends, then queries, then starts
        for i, (name, a, b, tid) in enumerate(self.host):
            if tid == self.tid and name != WINDOW:
                points += [(a, 2, i), (b, 0, i)]
        for a, b in stats.gaps(self.kernels, self.lo, self.hi):
            points.append((0.5 * (a + b), 1, b - a))
        tot: Dict[str, float] = defaultdict(float)
        stack: List[int] = []
        for _, order, x in sorted(points):
            if order == 2:
                stack.append(x)
            elif order == 0:
                if x in stack:
                    del stack[len(stack) - 1 - stack[::-1].index(x)]
            else:
                label = self.host[stack[-1]][0] if stack else "host outside any operation"
                tot[label[:200]] += x
        return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]


@contextlib.contextmanager
def traced(enabled: bool):
    """``yield`` a holder whose ``trace`` is the window's Trace once the
    block ends (None when not ``enabled``)."""
    holder = type("Held", (), {"trace": None})()
    if not enabled:
        yield holder
        return
    prof = profiler()
    with prof:
        with torch.autograd.profiler.record_function(WINDOW):
            yield holder
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    holder.trace = Trace(events_of(prof))


def summarize(trace: Optional[Trace]) -> Optional[dict]:
    """What the readers and the result line take from a trace."""
    if trace is None:
        return None
    return {
        "window_s": trace.window_s,
        "busy_s": trace.busy_s(),
        "d2h_s": trace.copy_s("DtoH"),
        "blocks": trace.device_time_in("bench::block#"),
        "blocks_bwd": trace.device_time_in("bench::block_bwd#"),
        "models": trace.device_time_in("bench::model"),
        "ops": trace.count("blle::"),
        "top_device_ops": trace.top_device_ops(),
        "idle_by_host": trace.idle_by_host(),
    }
