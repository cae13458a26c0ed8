"""Arithmetic the metric readers share."""

from port_bench.counts import PEAK_FLOPS


def roofline(rec, key: str):
    """100 x the least time of the ranges' work over their device time; none
    where no range launched anything."""
    if rec.trace is None:
        return None
    device = rec.trace[key]
    spent = sum(device.values())
    if not spent:
        return None
    least = sum(rec.block_calls[name] for name in device)
    return 100.0 * least / spent


def mfu(rec):
    t = rec.trace
    if t is None or not rec.trace_units:
        return None
    return 100.0 * rec.flops_per_unit * rec.trace_units / (t["window_s"] * rec.chips * PEAK_FLOPS)


def idle(rec):
    """100 x the share of the traced window in which no kernel ran."""
    t = rec.trace
    if t is None:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
