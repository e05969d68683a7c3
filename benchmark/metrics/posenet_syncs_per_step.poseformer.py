"""Synchronizing CUDA operations a PoseFormer optimizer step: every sync
the program's spans counted under the traced chunks' ``posenet.pass``
roots (two a chunk: the fake clips, the real windows), over their
``posenet.step`` spans.  A count, the same in every traced run."""
from benchmark import program_spans


def read(ctx):
    return program_spans.syncs_per(program_spans.counted(ctx, "posenet.pass", 2), "posenet.step")
