"""Host milliseconds a posenet optimizer step: the program's
``posenet.step`` spans, unfenced, under the traced chunks' ``posenet.pass``
roots (two a chunk: the fake clips, the real windows).  Beside the fenced
``posenet_ms_per_step.video``."""
from benchmark import program_spans


def read(ctx):
    return program_spans.mean_ms(program_spans.counted(ctx, "posenet.pass", 2), "posenet.step")
