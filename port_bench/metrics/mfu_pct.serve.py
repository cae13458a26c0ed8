"""Forward operations a request (``counts``, the reference at the padded
frame) times the requests, over the traced window times the bf16 peak, in
%."""

from port_bench.metrics_util import mfu


def read(rec):
    return mfu(rec)
