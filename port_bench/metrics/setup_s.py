"""Seconds from the process's start to the window's opening: imports, the
card's context, the kernels' library (built on a checkout's first run),
weights, traffic and warm-up."""


def read(rec):
    return rec.setup_s
