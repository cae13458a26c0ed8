"""``torch.cuda.max_memory_allocated`` over the window's steps (reset when
the window opens), in GiB."""


def read(rec):
    return rec.window_peak_bytes / 2 ** 30 if rec.window_peak_bytes else None
