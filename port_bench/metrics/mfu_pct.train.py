"""Forward and backward operations a step (``counts``, the reference at
the global batch) times the steps, over the traced window times the chips
times the bf16 peak, in %."""

from port_bench.metrics_util import mfu


def read(rec):
    return mfu(rec)
