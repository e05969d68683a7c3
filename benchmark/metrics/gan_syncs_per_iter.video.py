"""Synchronizing CUDA operations a video GAN iteration: every sync the
program's spans counted under the traced chunks' ``gan.epoch`` roots, over
their ``gan.iteration`` spans.  A count, the same in every traced run."""
from benchmark import program_spans


def read(ctx):
    return program_spans.syncs_per(program_spans.counted(ctx, "gan.epoch", 1), "gan.iteration")
