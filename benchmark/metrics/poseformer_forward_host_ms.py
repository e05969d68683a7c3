"""Host milliseconds a PoseFormer forward: the program's
``posenet.spatial`` and ``posenet.temporal`` spans, unfenced, under the
traced chunks' ``posenet.pass`` roots (two a chunk), summed over both
transformers and divided by the forwards (one ``posenet.spatial`` each).
A checkout whose PoseFormer records no spans reads None."""
from benchmark import program_spans


def read(ctx):
    spans = program_spans.counted(ctx, "posenet.pass", 2)
    if spans is None:
        return None
    spatial = program_spans.select(spans, "posenet.spatial")
    temporal = program_spans.select(spans, "posenet.temporal")
    if not spatial or len(temporal) != len(spatial):
        return None
    return sum(r.ms for r in spatial + temporal) / len(spatial)
