"""Host milliseconds a video GAN iteration: the program's ``gan.iteration``
spans, unfenced, under the traced chunks' ``gan.epoch`` roots.  Beside the
fenced ``gan_ms_per_iter.video``, the gap between the two is device time
the host did not cover."""
from benchmark import program_spans


def read(ctx):
    return program_spans.mean_ms(program_spans.counted(ctx, "gan.epoch", 1), "gan.iteration")
