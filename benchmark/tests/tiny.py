"""Cells cut to a size the CPU runs in seconds: narrow nets, small batches,
a small pool.  Only for tests; the cells as committed run at full size."""
from __future__ import annotations

import copy

from benchmark import harness

WIDTH = 32


def tiny_spec(name: str, manifest: dict = None):
    spec = harness.cell_spec(name, manifest)
    spec = copy.copy(spec)
    config = copy.deepcopy(spec.config)
    traffic = dict(spec.traffic)
    gan = config["gan"]
    for key in ("gen_dense", "dis_dense_3d", "dis_dense_2d", "video_dis_dense_3d",
                "video_dis_dense_2d"):
        if key in gan:
            gan[key] = WIDTH
    traffic["batch"] = 64 if traffic["runner"] == "synth" else 8
    traffic["chunk_batches"] = 3 if traffic["runner"] == "synth" else 2
    traffic["trace_chunks"] = 1
    argv = list(config["argv"])
    i = argv.index("--batch_size")
    argv[i + 1] = str(traffic["batch"])
    argv += ["--Gen_DenseDim", str(WIDTH), "--Dis_DenseDim_3D", str(WIDTH),
             "--Dis_DenseDim_2D", str(WIDTH), "--video_Dis_DenseDim_3D", str(WIDTH),
             "--video_Dis_DenseDim_2D", str(WIDTH)]
    config["argv"] = argv
    config["pool"] = dict(config["pool"], frames=1280, sequence_frames=8)
    spec.config, spec.traffic = config, traffic
    return spec
