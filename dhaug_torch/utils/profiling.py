"""Tracing and timing helpers.

Port of ``dhaug_tpu/utils/profiling.py`` (``fence``, ``trace``, ``timed``),
with the JAX package's per-phase ``StepTimer`` replaced by a span recorder
on the profiler's clock:

* :func:`span` -- a named span at a layer boundary of the program.  It is
  live only while a ``torch.profiler`` profile records, and then opens a
  ``record_function`` of its name, keeps its start, end, parent, root and
  self time in memory, and counts the synchronizing CUDA operations made
  inside it; otherwise it does nothing.  :func:`span_records` and
  :func:`span_summary` read what was kept;
* :func:`trace` -- a context manager around ``torch.profiler`` that writes
  a Chrome trace (``chrome://tracing``, Perfetto) of host and device
  activity into ``log_dir``, and the block's span table beside it;
* :func:`timed` -- one fenced timing of a callable.

The card's measurement helpers, shared by ``chip_smoke.py``, ``fk_bench.py``
and the bench modules (``dhaug_torch.bench`` and its siblings):

* :func:`cuda_time_ms` -- CUDA events around a loop of calls;
* :func:`device_us` / :func:`host_us` -- one kernel's device time a launch
  (torch.profiler) and the host time a call;
* :func:`profile_iterations` / :func:`device_kernels` -- host wall, device
  kernel time and busy share of a run of GAN iterations;
* :func:`bound_ms` against the H100's published peaks (``PEAK_*``);
* :func:`device_name` / :func:`nvidia_smi` -- the card's name, and its
  name and power limit.
"""
from __future__ import annotations

import contextlib
import functools
import json
import os
import statistics
import subprocess
import time
import warnings
from collections import defaultdict
from typing import Callable, Mapping, NamedTuple, Optional, Sequence

import torch
import torch.autograd.profiler as _autograd_profiler


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

SYNC_WARNING = "called a synchronizing CUDA operation"


class SpanRecord(NamedTuple):
    """One closed span.  ``span_id`` numbers the spans in the order they
    opened, ``parent_id`` is the enclosing span's (-1 for a root, the
    outermost open span), ``root`` the ordinal of the span's root among
    roots: every span of one root shares it.  Times are ``time.time_ns()``,
    the clock kineto stamps host events with.  ``syncs`` counts the
    synchronizing CUDA operations made in the span and not in a child."""
    name: str
    start_ns: int
    end_ns: int
    span_id: int
    parent_id: int
    root: int
    syncs: int
    child_ns: int

    @property
    def ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6

    @property
    def self_ms(self) -> float:
        """The duration less the time the span's children cover."""
        return (self.end_ns - self.start_ns - self.child_ns) / 1e6


class _Off:
    """The span of a recorder that is off: enters and exits, nothing else."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("recorder", "name", "start_ns", "span_id", "parent", "root", "syncs",
                 "child_ns", "annotation")

    def __init__(self, recorder: "SpanRecorder", name: str):
        self.recorder, self.name = recorder, name

    def __enter__(self):
        rec = self.recorder
        self.parent = rec.open[-1] if rec.open else None
        if self.parent is None:
            self.root = rec.roots
            rec.roots += 1
            rec.begin_root()
        else:
            self.root = self.parent.root
        self.span_id = rec.spans
        rec.spans += 1
        self.syncs = self.child_ns = 0
        rec.open.append(self)
        self.start_ns = time.time_ns()
        self.annotation = torch.profiler.record_function(self.name)
        self.annotation.__enter__()
        return self

    def __exit__(self, *exc):
        self.annotation.__exit__(*exc)
        end_ns = time.time_ns()
        rec = self.recorder
        rec.open.pop()
        parent = self.parent
        if parent is not None:
            parent.child_ns += end_ns - self.start_ns
        else:
            rec.end_root()
        rec.records.append(SpanRecord(self.name, self.start_ns, end_ns, self.span_id,
                                      -1 if parent is None else parent.span_id, self.root,
                                      self.syncs, self.child_ns))
        return False


class SpanRecorder:
    """What :func:`span` keeps: the closed spans' records, the open spans
    (innermost last) and the counts that number spans and roots.

    While a root span is open, the synchronizing CUDA operations it makes
    are counted on the innermost open span: where CUDA is initialized the
    root sets ``torch.cuda.set_sync_debug_mode("warn")``, and each such
    warning is counted instead of shown; the previous mode, warning filters
    and ``warnings.showwarning`` come back when the root closes.  Spans add
    no fence or synchronization of their own."""

    def __init__(self):
        self.records = []            # SpanRecord, in the order spans closed
        self.open = []
        self.spans = self.roots = 0
        self._warnings = self._shown = self._mode = None

    def begin_root(self) -> None:
        self._warnings = warnings.catch_warnings()
        self._warnings.__enter__()
        warnings.filterwarnings("always", message=".*" + SYNC_WARNING)
        self._shown = warnings.showwarning
        warnings.showwarning = self._count
        if torch.cuda.is_initialized():
            self._mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("warn")

    def end_root(self) -> None:
        if self._mode is not None:
            torch.cuda.set_sync_debug_mode(self._mode)
            self._mode = None
        self._warnings.__exit__(None, None, None)
        self._warnings = self._shown = None

    def _count(self, message, category, filename, lineno, file=None, line=None):
        if self.open and SYNC_WARNING in str(message):
            self.open[-1].syncs += 1
        else:
            self._shown(message, category, filename, lineno, file, line)


RECORDER = SpanRecorder()


def span(name: str):
    """``with span("gan.iteration"): ...``: a span of the process's
    recorder, live only while a ``torch.profiler`` profile records
    (``torch.autograd.profiler._is_profiler_enabled``, a module bool).
    Otherwise it is one shared no-op object: no annotation, clock read or
    allocation."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(RECORDER, name)


def spanned(name: str):
    """Decorator: each call of the function runs in ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _autograd_profiler._is_profiler_enabled:
                return fn(*args, **kwargs)
            with _Span(RECORDER, name):
                return fn(*args, **kwargs)
        return call
    return wrap


def span_records() -> list:
    """The process's kept :class:`SpanRecord` list, in closing order."""
    return RECORDER.records


def span_summary(records: Optional[Sequence[SpanRecord]] = None) -> dict:
    """For each span name of ``records`` (the process's kept records by
    default): calls, total and self milliseconds, and syncs."""
    out = {}
    for r in RECORDER.records if records is None else records:
        row = out.setdefault(r.name, {"calls": 0, "total_ms": 0.0, "self_ms": 0.0, "syncs": 0})
        row["calls"] += 1
        row["total_ms"] += r.ms
        row["self_ms"] += r.self_ms
        row["syncs"] += r.syncs
    return out


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block with ``torch.profiler`` (the CPU, and CUDA where a
    card is present) and write ``<log_dir>/trace.json`` and, from the
    spans the block recorded, ``<log_dir>/spans.json`` (:func:`span_summary`)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    first = len(RECORDER.records)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
    with open(os.path.join(log_dir, "spans.json"), "w") as f:
        json.dump(span_summary(RECORDER.records[first:]), f, indent=1)


def timed(fn: Callable, *args, iters: int = 1, **kwargs):
    """(result, seconds_per_call) with a device fence before and after."""
    out = fn(*args, **kwargs)
    fence(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args, **kwargs)
    fence(out)
    return out, (time.perf_counter() - t0) / iters


# Published peaks of one H100 SXM at its 700 W limit (NVIDIA's data sheet,
# dense rates): a card set below 700 W runs slower under load.
PEAK_BYTES_PER_S = 3.35e12   # HBM3
PEAK_FP32_FLOP_S = 67e12     # fp32, outside the tensor cores
PEAK_BF16_FLOP_S = 989e12    # dense bf16 tensor cores


def device_name(device) -> str:
    """The card's name (``torch.cuda.get_device_name``), or "cpu"."""
    device = torch.device(device)
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def nvidia_smi() -> str:
    """The first card's ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`` line, e.g. ``NVIDIA H100 80GB HBM3, 700.00 W``."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_time_ms(fn, iters: int = 200, warmup: int = 20) -> float:
    """Milliseconds a call of ``fn`` over ``iters`` calls after
    ``warmup``, from CUDA events around the loop."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(n_bytes: float, n_flops: float, peak_flops: float = PEAK_FP32_FLOP_S):
    """(the least ms the card could take, "bytes" or "operations"): the
    larger of ``n_bytes`` over the memory rate and ``n_flops`` over
    ``peak_flops``."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_S, n_flops / peak_flops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def device_us(fn, name=None, calls: int = 30, warmup: int = 10) -> float:
    """Median device time (µs) of one launch of the kernel whose name holds
    ``name`` (any kernel when None), over ``calls`` calls of ``fn`` after
    warm-up, from torch.profiler's kernel events; each call must launch it
    once."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA and (name is None or name in e.name)]
    # the profiler's activity buffer may drop an event now and then
    if not calls - 3 <= len(us) <= calls:
        raise AssertionError(f"profiled {len(us)} launches of {name}, expected {calls}")
    return statistics.median(us)


def host_us(fn, calls: int = 200, warmup: int = 20) -> float:
    """Host µs a call: a host clock over ``calls`` unsynchronized calls,
    then one synchronize (outside the clock)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return seconds / calls * 1e6


class KernelTotal(NamedTuple):
    """One device-side event name of a profile: its summed device µs
    and its count, named as ``key_averages()`` names them."""
    key: str
    self_device_time_total: float
    count: int


def device_kernels(prof) -> list:
    """The device-side events of a torch.profiler run (kernels and
    copies) by name, without user annotations, whose device ranges only
    span kernels that are counted already: what ``prof.key_averages()``
    gives for them, read from the raw kineto events.  ``key_averages()``
    builds an object, stack and tree for every event, host work that took
    longer than the profiled run itself on whole training runs (15.5 s
    against this walk's 0.9 s for 210,000 CPU events, torch 2.13)."""
    totals = defaultdict(lambda: [0.0, 0])
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA and not e.is_user_annotation():
            total = totals[e.name()]
            total[0] += e.duration_ns() / 1e3
            total[1] += 1
    return [KernelTotal(name, us, n) for name, (us, n) in totals.items()]


def profile_iterations(run, iters: int) -> dict:
    """``run(n)`` runs n GAN iterations and synchronizes: after a warm-up,
    the host wall per iteration (unprofiled), and from torch.profiler the
    device time of each kernel, whose sum over that wall is the device's
    busy share."""
    from torch.profiler import ProfilerActivity, profile

    run(5)  # warm-up
    t0 = time.perf_counter()
    run(iters)
    wall_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run(iters)
    prof_wall_us = (time.perf_counter() - t0) * 1e6
    # device time from kernel events only: a CPU op's self device time
    # repeats the time of the kernels it launched, and a user annotation's
    # device range (Optimizer.step#Adam.step) spans kernels counted already
    kernels = device_kernels(prof)
    dev = lambda e: e.self_device_time_total
    busy_us = sum(dev(e) for e in kernels)
    fk = {name: [dev(e) / e.count, e.count / iters]
          for name in ("fk_forward_kernel", "fk_backward_kernel")
          for e in kernels if name in e.key}
    top = sorted(kernels, key=dev, reverse=True)[:6]
    return {"iters": iters, "gan_iter_ms": wall_ms / iters,
            "profiled_iter_ms": prof_wall_us / 1e3 / iters,
            "device_kernel_ms_per_iter": busy_us / 1e3 / iters,
            "device_busy_share": busy_us / 1e3 / wall_ms,
            "fk_kernel_device_us_per_call_and_calls_per_iter": fk,
            "top_kernels_device_ms_per_iter": [[e.key[:90], dev(e) / 1e3 / iters,
                                                e.count / iters] for e in top]}
