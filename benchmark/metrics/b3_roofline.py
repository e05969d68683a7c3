"""Kernel B3's share of its roofline: the least time the card could take
for the traced dispatches' trunks (operations at 989 TFLOP/s or bytes at
3.35 TB/s, the larger) over the device time of every ``trunk_gemm_kernel``
launch (8 a trunk), from the trace."""
from benchmark.counts import flops, peaks

KERNEL = "trunk_gemm_kernel"


def read(ctx):
    w = ctx.window
    seconds = sum(s for name, (s, _) in getattr(w, "kernels", {}).items() if KERNEL in name)
    if not seconds or not w.counts.get("dispatches"):
        return None
    one = flops.trunk(ctx.config["gan"]["gen_dense"], ctx.traffic["batch"])
    bound = max(one["flop"] / peaks.BF16_FLOP_S, one["bytes"] / peaks.BYTES_S)
    return 100.0 * bound * w.counts["dispatches"] / seconds
