"""The PoseFormer steps' share of the float32 peak: their algorithmic
FLOPs (``benchmark/counts/poseformer.py``) over the harness's fenced span
around the program's two posenet passes in the traced chunks, against
67 TFLOP/s."""
from benchmark.counts import peaks, poseformer


def read(ctx):
    w = ctx.window
    spans = getattr(w, "spans", {})
    if "posenet" not in spans or not w.counts.get("posenet_steps"):
        return None
    work = poseformer.train_step(ctx.config["posenet"], ctx.traffic["batch"])
    return 100.0 * work * w.counts["posenet_steps"] / spans["posenet"] / peaks.FP32_FLOP_S
