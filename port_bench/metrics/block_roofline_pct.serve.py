"""Every TransformerBlock call's least time (``counts``: its operations
over the bf16 peak or its bytes over HBM's, the larger) over the device
time of everything launched inside those calls, in % (traced window)."""

from port_bench.metrics_util import roofline


def read(rec):
    return roofline(rec, "blocks")
