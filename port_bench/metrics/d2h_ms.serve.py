"""Device time a request of the device -> host copies (the answer's RGB
into the returned array), in ms (traced window)."""


def read(rec):
    if rec.trace is None or not rec.trace_units or not rec.trace["d2h_s"]:
        return None
    return 1e3 * rec.trace["d2h_s"] / rec.trace_units
