#!/usr/bin/env python3
"""Time the FK kernels B1/B2 of a checkout on one NVIDIA card.

    python3 fk_bench.py [--repo DIR] [--label NAME]

Imports ``dhaug_torch`` from DIR (default: the directory of this script),
builds its kernels and prints the card's name and power limit, then one JSON
line from ``chip_smoke.time_fk_kernels``: B1 and B2 at B = 1024 and 8192 as
device µs a launch (torch.profiler), the loop of launches (CUDA events) and
host µs a call, and a launch floor (a one-element ``zero_()``).  Any
checkout whose ``dhaug_torch.ops.fk_cuda`` has ``fk_forward_cuda`` and
``fk_backward_cuda`` can be timed.  To compare two checkouts, run it once
per checkout in turns (A, B, B, A) on one card, one after another.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import chip_smoke  # this checkout's timing code, imported before DIR joins the path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", default=str(Path(__file__).resolve().parent),
                    help="checkout whose dhaug_torch is timed")
    ap.add_argument("--label", default=None, help="name printed with the numbers")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("fk_bench.py: no CUDA device", file=sys.stderr)
        return 1
    repo = Path(args.repo).resolve()
    # chip_smoke imported this checkout's dhaug_torch for its timing helpers:
    # forget it, so that the kernels come from DIR's
    for name in [n for n in sys.modules if n.split(".")[0] == "dhaug_torch"]:
        del sys.modules[name]
    sys.path.insert(0, str(repo))
    from dhaug_torch.ops import fk_cuda
    if not Path(fk_cuda.__file__).resolve().is_relative_to(repo):
        raise RuntimeError(f"imported {fk_cuda.__file__}, not the checkout {repo}")
    smi = chip_smoke.nvidia_smi()
    print(smi, flush=True)
    device = torch.device("cuda", 0)
    times = chip_smoke.time_fk_kernels(fk_cuda, device)
    chip_smoke.emit({"fk_bench": args.label or str(repo), "nvidia_smi": smi, **times})
    return 0


if __name__ == "__main__":
    sys.exit(main())
