"""The port's own spans in a traced run, read from the same trace and clock
as the device's kernels and copies.

The port opens ``record_function`` ranges named ``lle.*`` at its layer
boundaries while a profiler records (``utils/profiling.span``):
``lle.predictor.request`` around ``lle.predictor.h2d`` / ``.forward`` /
``.finish``, ``lle.trainer.step`` around ``lle.trainer.decode`` /
``.forward`` / ``.backward`` / ``.guard`` / ``.update``,
``lle.loader.stage`` once a batch and ``lle.bands.halo`` once a
``band_halo`` call. ``summarize(trace)`` gathers what the per-layer numbers
below are computed from, and ``values(summary, units)`` computes them
(``units`` the window's requests or steps):

* ``h2d_host_ms.serve``: the median host duration of ``lle.predictor.h2d``;
* ``enqueue_host_ms.serve``: the median host duration of
  ``lle.predictor.forward`` (the host's time to issue K1 and the forward);
* ``halo_device_ms.serve``: device time of the operations launched inside
  ``lle.bands.halo``, a request;
* ``idle_unspanned_pct.serve`` / ``.train``: the share of the window's
  device idle (no kernel running) during which no ``lle.`` span is open on
  the window's thread;
* ``loader_idle_ms.train``: device idle a step during which
  ``lle.loader.stage`` is the innermost open ``lle.`` span;
* ``sync_gap_ms.train``: the median over steps of the time from the end of
  ``lle.trainer.guard`` to the start of the next kernel.

Nothing here reads a trace without the spans: where the program has none,
every number is None.
"""

import bisect
from typing import Dict, List, Optional

from port_bench import stats
from port_bench.tracing import Trace

SPAN = "lle."
NONE_OPEN = ""  # idle_by_span's key for idle with no lle. span open


def durations(trace: Trace, name: str) -> List[float]:
    """Host seconds of each ``name`` range that starts in the window."""
    return [b - a for n, a, b, _ in trace.host_ranges(name) if n == name]


def thread_spans(trace: Trace) -> List[tuple]:
    """The ``lle.`` ranges on the window's thread: (name, start, end)."""
    return [(n, a, b) for n, a, b, tid in trace.host if n.startswith(SPAN) and tid == trace.tid]


def idle_by_span(trace: Trace) -> Dict[str, float]:
    """The window's device idle (no kernel running), in seconds, by the
    innermost ``lle.`` span open on the window's thread (``NONE_OPEN``
    where none is). Spans on one thread nest, so the innermost open one
    is the latest started."""
    spans = thread_spans(trace)
    marks = []  # (time, order, payload): ends before starts at one time
    for i, (_, a, b) in enumerate(spans):
        marks += [(a, 1, i), (b, 0, i)]
    for a, b in stats.gaps(trace.kernels, trace.lo, trace.hi):
        marks += [(a, 1, -1), (b, 0, -1)]
    out: Dict[str, float] = {}
    stack: List[int] = []
    idle, at = False, trace.lo
    for t, order, i in sorted(marks):
        t = min(max(t, trace.lo), trace.hi)
        if idle and t > at:
            key = spans[stack[-1]][0] if stack else NONE_OPEN
            out[key] = out.get(key, 0.0) + t - at
        at = t
        if i < 0:
            idle = bool(order)
        elif order:
            stack.append(i)
        elif i in stack:
            stack.remove(i)
    return out


def gaps_after(trace: Trace, name: str) -> List[float]:
    """For each ``name`` range in the window, the seconds from its end to
    the start of the next kernel (none after the last kernel)."""
    starts = sorted(a for a, _ in trace.kernels)
    out = []
    for _, _, end, _ in trace.host_ranges(name):
        i = bisect.bisect_left(starts, end)
        if i < len(starts):
            out.append(starts[i] - end)
    return out


def copy_share_in(trace: Trace, kind: str, name: str) -> Optional[float]:
    """The share of the window's copies whose name holds ``kind`` (``DtoH``,
    ``HtoD``) that ran while a ``name`` range was open on the host; None
    where there is no such copy."""
    copies = [(max(a, trace.lo), min(b, trace.hi))
              for n, a, b, _, kernel in trace.device if not kernel and kind in n]
    total = stats.covered(copies)
    if not total:
        return None
    open_ = stats.union((a, b) for n, a, b, _ in trace.host if n == name)
    inside = sum(stats.covered(stats.clip(copies, a, b)) for a, b in open_)
    return inside / total


def summarize(trace: Trace) -> dict:
    """What ``values`` reads, from one traced window."""
    return {
        "h2d_host_s": durations(trace, "lle.predictor.h2d"),
        "enqueue_host_s": durations(trace, "lle.predictor.forward"),
        "halo_device_s": trace.device_time_in("lle.bands.halo").get("lle.bands.halo"),
        "idle_by_span": idle_by_span(trace),
        "sync_gaps_s": gaps_after(trace, "lle.trainer.guard"),
        "loader_stages": len(durations(trace, "lle.loader.stage")),
    }


def values(summary: dict, units: int) -> Dict[str, Optional[float]]:
    """The per-layer numbers of one traced window of ``units`` requests or
    steps (ms and %); None where the trace holds nothing to read."""
    idle = summary["idle_by_span"]
    spanned = any(k != NONE_OPEN for k in idle)
    total = sum(idle.values())

    def median_ms(key):
        return 1e3 * stats.median(summary[key]) if summary[key] else None

    return {
        "h2d_host_ms": median_ms("h2d_host_s"),
        "enqueue_host_ms": median_ms("enqueue_host_s"),
        "halo_device_ms": (1e3 * summary["halo_device_s"] / units
                           if summary["halo_device_s"] and units else None),
        "idle_unspanned_pct": (100.0 * idle.get(NONE_OPEN, 0.0) / total
                               if spanned and total else None),
        "loader_idle_ms": (1e3 * idle.get("lle.loader.stage", 0.0) / units
                           if summary["loader_stages"] and units else None),
        "sync_gap_ms": median_ms("sync_gaps_s"),
    }
