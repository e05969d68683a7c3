"""Tracing and timing helpers.

Port of ``dhaug_tpu/utils/profiling.py``, with the same functions and
report format:

* :func:`trace` -- a context manager around ``torch.profiler`` that writes
  a Chrome trace (``chrome://tracing``, Perfetto) of host and device
  activity into ``log_dir``;
* :class:`StepTimer` -- per-phase wall timing, fenced on the device when
  asked, aggregated like the reference's AverageMeter;
* :func:`timed` -- one fenced timing of a callable.

Nothing in the training loop calls them, as in the JAX package.
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Callable, Mapping

import torch


def _first_tensor(out):
    if isinstance(out, torch.Tensor):
        return out
    if isinstance(out, Mapping):
        out = list(out.values())
    if isinstance(out, (list, tuple)):
        for item in out:
            found = _first_tensor(item)
            if found is not None:
                return found
    return None


def fence(out) -> None:
    """Wait for the device of the first tensor found in ``out`` (nested
    lists, tuples and dicts are searched), or for ``out`` itself when it is
    a ``torch.device``, to finish its queued work.  A CPU tensor or device,
    or no tensor at all, has nothing to wait for."""
    device = out if isinstance(out, torch.device) else getattr(_first_tensor(out), "device", None)
    if device is not None and device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block with ``torch.profiler`` (the CPU, and CUDA where a
    card is present) and write ``<log_dir>/trace.json``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def timed(fn: Callable, *args, iters: int = 1, **kwargs):
    """(result, seconds_per_call) with a device fence before and after."""
    out = fn(*args, **kwargs)
    fence(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args, **kwargs)
    fence(out)
    return out, (time.perf_counter() - t0) / iters


class StepTimer:
    """Accumulates per-phase timings: ``with timer("gan"): ...``.  Pass
    ``fence_out=<device output>`` to include the device work in the
    measurement (its device is synchronized at phase exit)."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def __call__(self, phase: str, fence_out=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if fence_out is not None:
                fence(fence_out)
            self.totals[phase] += time.perf_counter() - t0
            self.counts[phase] += 1

    def summary(self) -> dict:
        return {p: {"total_s": self.totals[p], "count": self.counts[p],
                    "mean_s": self.totals[p] / max(self.counts[p], 1)}
                for p in self.totals}

    def report(self) -> str:
        return " | ".join(f"{p}: {v['mean_s'] * 1000:.1f} ms x{v['count']}"
                          for p, v in self.summary().items())
