"""A CPU stand-in for the card's trace, for tests: the program's plain trunk
and FK are labelled with the names of the kernels that replace them on the
card, and host operations count as device operations."""
from __future__ import annotations

import torch

from benchmark import harness

KERNELS = ("trunk_gemm_kernel", "fk_forward_kernel")


def _labelled(fn, name):
    def wrapper(*args, **kwargs):
        with torch.profiler.record_function(name):
            return fn(*args, **kwargs)
    return wrapper


def patch(monkeypatch) -> None:
    import dhaug_torch.ops.fk_cuda as fk_cuda
    import dhaug_torch.parallel.sharded as sharded

    monkeypatch.setattr(sharded, "trunk_forward", _labelled(sharded.trunk_forward, KERNELS[0]))
    monkeypatch.setattr(fk_cuda, "fk_world_pose_16",
                        _labelled(fk_cuda.fk_world_pose_16, KERNELS[1]))
    device_events = harness.device_events

    def events(prof):
        _, host, notes = device_events(prof)
        kernels = [n for n in notes if n[0] in KERNELS]
        return host + kernels, host, [n for n in notes if n[0] not in KERNELS]

    monkeypatch.setattr(harness, "device_events", events)
