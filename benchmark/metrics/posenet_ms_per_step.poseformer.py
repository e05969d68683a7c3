"""Milliseconds a PoseFormer optimizer step (81-frame clips): the
harness's fenced span around the program's two posenet passes, over
their steps in the traced chunks."""


def read(ctx):
    w = ctx.window
    spans = getattr(w, "spans", {})
    if "posenet" not in spans or not w.counts.get("posenet_steps"):
        return None
    return 1e3 * spans["posenet"] / w.counts["posenet_steps"]
