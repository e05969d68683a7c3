"""Milliseconds a video GAN iteration at 81 frames: the harness's fenced
span around the program's GAN epoch call, over the iterations of the
traced chunks."""


def read(ctx):
    w = ctx.window
    spans = getattr(w, "spans", {})
    if "gan" not in spans or not w.counts.get("iterations"):
        return None
    return 1e3 * spans["gan"] / w.counts["iterations"]
