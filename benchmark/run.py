"""The benchmark of dhaug_torch on NVIDIA cards: one run of one cell.

    python3 -m benchmark.run --workload video-train --seed 7 --seconds 20 --trace 0

Run from the root of a checkout.  The result's line carries the cell's
end-to-end metrics, and with ``--trace 1`` its per-layer metrics too, all
from a few profiled chunks.  Exits 2, printing no result, without
as many cards as the cell asks for, and 3 if JAX or the JAX package has
been loaded.  The last line of standard output is the result (JSON); the
last lines of standard error give each compared number beside its limit.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark import harness  # noqa: E402

harness.cache_dirs()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", required=True, type=int)
    ap.add_argument("--seconds", required=True, type=float)
    ap.add_argument("--trace", default=0, type=int, choices=(0, 1))
    args = ap.parse_args(argv)
    import torch

    spec = harness.cell_spec(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < spec.chips:
        print(f"{args.workload} needs {spec.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    line = harness.run_cell(spec, args.seed, args.seconds, bool(args.trace),
                            torch.device("cuda", 0))
    found = harness.forbidden_modules()
    if found:
        print(f"loaded modules of JAX or the JAX package: {', '.join(found)}", file=sys.stderr)
        return 3
    harness.report(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
