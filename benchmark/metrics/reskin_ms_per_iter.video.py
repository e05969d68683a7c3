"""Milliseconds of re-skin a GAN iteration: the program's ``reskin.update``
spans of the traced chunks over their GAN iterations.  The re-skin ends in
a device-to-host read, so its host time is its wall time."""
from benchmark import program_spans


def read(ctx):
    spans = program_spans.counted(ctx, "reskin.update", 1)
    iterations = ctx.window.counts.get("iterations")
    if spans is None or not iterations:
        return None
    return sum(r.ms for r in program_spans.select(spans, "reskin.update")) / iterations
