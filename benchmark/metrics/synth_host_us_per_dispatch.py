"""Host microseconds a synthesis dispatch: the program's ``synth.dispatch``
spans of the traced chunks.  Beside the window's seconds a dispatch, it
says how far the host runs ahead of the card."""
from benchmark import program_spans


def read(ctx):
    spans = program_spans.counted(ctx, "synth.dispatch", ctx.traffic["chunk_batches"])
    ms = program_spans.mean_ms(spans, "synth.dispatch")
    return None if ms is None else 1e3 * ms
