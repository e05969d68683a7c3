"""Host milliseconds a critic update: the program's ``gan.critic.<role>``
spans (d3d, d2d, md3d, md2d; twelve an iteration with the motion critics,
flip and playback on) under the traced chunks' ``gan.epoch`` roots."""
from benchmark import program_spans


def read(ctx):
    return program_spans.mean_ms(program_spans.counted(ctx, "gan.epoch", 1),
                                 program_spans.is_critic)
