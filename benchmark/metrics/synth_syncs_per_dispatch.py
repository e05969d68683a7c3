"""Synchronizing CUDA operations a synthesis dispatch: every sync the
program's spans counted under the traced chunks' ``synth.dispatch`` roots,
over those dispatches.  A count, the same in every traced run."""
from benchmark import program_spans


def read(ctx):
    spans = program_spans.counted(ctx, "synth.dispatch", ctx.traffic["chunk_batches"])
    return program_spans.syncs_per(spans, "synth.dispatch")
