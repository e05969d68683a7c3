"""Kernel B1's share of its roofline: the least time for the traced
dispatches' forward FK (bytes at 3.35 TB/s or float32 operations at
67 TFLOP/s, the larger) over the device time of every
``fk_forward_kernel`` launch, from the trace."""
from benchmark.counts import flops, peaks

KERNEL = "fk_forward_kernel"


def read(ctx):
    w = ctx.window
    seconds = sum(s for name, (s, _) in getattr(w, "kernels", {}).items() if KERNEL in name)
    if not seconds or not w.counts.get("dispatches"):
        return None
    one = flops.fk_forward(ctx.traffic["batch"])
    bound = max(one["flop"] / peaks.FP32_FLOP_S, one["bytes"] / peaks.BYTES_S)
    return 100.0 * bound * w.counts["dispatches"] / seconds
