"""The whole PoseFormer video step's share of the float32 peak: the
frozen algorithmic FLOPs of the traced chunks' iterations
(``benchmark/counts/poseformer.py``: the GAN's at 81 frames and 8
PoseFormer steps a batch) over their window, against 67 TFLOP/s."""
from benchmark.counts import peaks, poseformer


def read(ctx):
    w = ctx.window
    if not w.counts.get("iterations") or not hasattr(w, "busy_s"):
        return None
    work = poseformer.video_iteration(ctx.config, ctx.traffic)["total"] * w.counts["iterations"]
    return 100.0 * work / w.seconds / peaks.FP32_FLOP_S
