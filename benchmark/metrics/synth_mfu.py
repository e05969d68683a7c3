"""Synthesis's share of the bfloat16 peak: the trunk's algorithmic FLOPs
for the traced chunks' poses over their window, against 989 TFLOP/s."""
from benchmark.counts import flops, peaks


def read(ctx):
    w = ctx.window
    if not w.counts.get("poses") or not hasattr(w, "busy_s"):
        return None
    work = flops.trunk(ctx.config["gan"]["gen_dense"], w.counts["poses"])["flop"]
    return 100.0 * work / w.seconds / peaks.BF16_FLOP_S
