"""Percent of the traced window in which no operation ran on the device:
100 x (1 - the union of the device's kernels and copies / the window)."""


def read(ctx):
    w = ctx.window
    if getattr(w, "busy_s", None) is None or w.seconds <= 0:
        return None
    return 100.0 * (1.0 - w.busy_s / w.seconds)
