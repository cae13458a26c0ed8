"""The TransformerBlocks' backward: each call's least time over the device
time of everything launched inside it (module backward hooks), in %
(traced window)."""

from port_bench.metrics_util import roofline


def read(rec):
    return roofline(rec, "blocks_bwd")
