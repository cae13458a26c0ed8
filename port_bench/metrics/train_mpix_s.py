"""Crop megapixels of every step completed in the window (global batch x
crop^2), over the whole window (host clock)."""

from port_bench.stats import rate


def read(rec):
    return rate(rec.mpix, rec.window_s) if rec.units else None
