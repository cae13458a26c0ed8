"""The median request's host time outside the served model's call, in ms:
the request's time minus the time inside the model's forward (the
benchmark's hooks, synchronised at both ends in the traced run only): pad,
host -> device, the pack kernel, crop, clamp, device -> host."""

from port_bench.stats import median


def read(rec):
    return median(rec.host_s) * 1e3 if rec.host_s else None
