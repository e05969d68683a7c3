"""Nine-frame clips a second through the whole augmented video step (re-skin, GAN iterations with motion critics, both posenet passes).
All the window's work over all its time, whole chunks."""


def read(ctx):
    w = ctx.window
    return w.counts["clips"] / w.seconds if w.counts.get("clips") else None
