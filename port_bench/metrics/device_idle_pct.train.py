"""The share of the traced window in which no kernel ran on the device
(the union of the profiler's kernel intervals over every stream), in %.
Copies do not count as busy: the SMs wait through them."""

from port_bench.metrics_util import idle


def read(rec):
    return idle(rec)
