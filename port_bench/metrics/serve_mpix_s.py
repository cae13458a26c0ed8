"""Mosaic megapixels of every request completed in the window, over the
whole window (host clock)."""

from port_bench.stats import rate


def read(rec):
    return rate(rec.mpix, rec.window_s) if rec.units else None
