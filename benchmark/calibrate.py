"""Readings that the limits of ``correct`` are set from, in one process.

    python3 -m benchmark.calibrate --workload video-train --seeds 1,2,3 \\
        --faults half_batch,stale_batch --fault_seeds 4,5,6 \\
        --control_seeds 7,8,9 [--out FILE]

For each of ``--seeds``: a run as ``benchmark.run`` makes it (set-up, a
window of one chunk, the check): the program's readings.  For each fault
of ``--faults`` (``benchmark/faults.py``) and each of ``--fault_seeds``:
the same run with the fault planted in the program underneath.  For each
of ``--control_seeds``: the control, the reference one precision lower in
the program's place, against the reference.  Prints one JSON line a
reading and writes them all to ``--out``.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark import faults, harness, pool  # noqa: E402

harness.cache_dirs()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault_seeds", default="")
    ap.add_argument("--control_seeds", default="")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    import torch

    device = torch.device("cuda", 0)
    spec = harness.cell_spec(args.workload)
    ints = lambda s: [int(x) for x in s.split(",") if x]
    readings = []

    def emit(kind, seed, values, t0, extra=None):
        rec = {"workload": args.workload, "kind": kind, "seed": seed, "values": values,
               "seconds": time.perf_counter() - t0, **(extra or {})}
        readings.append(rec)
        print(json.dumps(rec), flush=True)

    def run(kind, seed):
        t0 = time.perf_counter()
        values = {}
        line = harness.run_cell(spec, seed, 0.0, False, device, values)
        emit(kind, seed, values, t0, {"correct": line["correct"], "metrics": line["metrics"]})
        torch.cuda.empty_cache()

    for seed in ints(args.seeds):
        run("program", seed)
    for name in [f for f in args.faults.split(",") if f]:
        for seed in ints(args.fault_seeds):
            with faults.Patches() as p:
                faults.of(spec)[name](spec, p.setattr)
                run(f"fault:{name}", seed)
    runner = harness.runner_of(spec)
    for seed in ints(args.control_seeds):
        t0 = time.perf_counter()
        emit("control", seed, runner.control(spec.config, spec.traffic, pool.seeds(seed), device),
             t0)
        torch.cuda.empty_cache()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("".join(json.dumps(r) + "\n" for r in readings))
    return 0


if __name__ == "__main__":
    sys.exit(main())
