"""Poses synthesized a second (trunk, bone scalers, FK, camera, projection), outputs left on the device.
All the window's work over all its time, whole chunks."""


def read(ctx):
    w = ctx.window
    return w.counts["poses"] / w.seconds if w.counts.get("poses") else None
