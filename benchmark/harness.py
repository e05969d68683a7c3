"""The benchmark's harness: reads ``BENCHMARK.json``, finds a cell's
configuration, traffic, runner, limits and metric readers by name, runs
set-up, the measured window or the traced chunks, the correctness check,
and builds the result's line from the manifest.

A cell's files, all found by name:

* ``benchmark/configs/<config>.json`` -- the configuration as it is run;
* ``benchmark/traffic/<traffic>.json`` -- the mix: the runner it drives
  (``benchmark/runners/<runner>.py``), batch, chunk size, traced chunks;
* ``benchmark/workloads/<cell>.json`` -- the limits that decide
  ``correct``, and the readings they were set from;
* ``benchmark/metrics/<metric>.py`` -- one reader a metric, end-to-end and
  per-layer alike: ``read(ctx)`` returns the value, or None where the run
  has nothing to read.

The window is timed in whole chunks: it opens at a synchronize after
set-up and closes at the synchronize after the first chunk that ends at or
after ``--seconds``, so every run reads every metric it declares.
"""
from __future__ import annotations

import bisect
import contextlib
import importlib.util
import json
import math
import os
import sys
import time
from collections import Counter
from pathlib import Path
from types import SimpleNamespace

import torch

from benchmark import checks, pool

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "dhaug_tpu")


def load_manifest(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def load_module(path: Path):
    """A benchmark file as a module, its name made from its path (metric
    files carry dots in their names)."""
    name = "benchmark_file_" + "_".join(path.relative_to(BENCH).with_suffix("").parts) \
        .replace(".", "_").replace("-", "_")
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def applies(metric: dict, cell: dict, manifest: dict) -> bool:
    """Whether ``cell`` reports ``metric``: those its ``workloads`` name,
    or, without the key, every cell (end-to-end) or every cell reporting
    the metric it moves (per-layer)."""
    if "workloads" in metric:
        return cell["name"] in metric["workloads"]
    if "moves" in metric:
        moved = next(m for m in manifest["end_to_end"] if m["name"] == metric["moves"])
        return applies(moved, cell, manifest)
    return True


def cell_spec(name: str, manifest: dict = None, root: Path = ROOT) -> SimpleNamespace:
    manifest = manifest or load_manifest(root)
    cell = next((w for w in manifest["workloads"] if w["name"] == name), None)
    if cell is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    config = next(c for c in manifest["configs"] if c["name"] == cell["config"])
    bench = root / "benchmark"
    return SimpleNamespace(
        name=name, chips=cell["chips"], manifest=manifest,
        config=json.loads((root / config["file"]).read_text()),
        traffic=json.loads((bench / "traffic" / f"{cell['traffic']}.json").read_text()),
        limits=json.loads((bench / "workloads" / f"{name}.json").read_text())["limits"],
        end_to_end=[m for m in manifest["end_to_end"] if applies(m, cell, manifest)],
        per_layer=[m for m in manifest["per_layer"] if applies(m, cell, manifest)])


def runner_of(spec) -> object:
    return load_module(BENCH / "runners" / f"{spec.traffic['runner']}.py")


def synchronize(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Run:
    """What a runner sees of the run: the device, the seeds, and the
    harness's spans, which are fenced and timed in a traced run only."""

    def __init__(self, device, seed: int):
        self.device = device
        self.seed = seed
        self.seeds = pool.seeds(seed)
        self.tracing = False
        self.spans = Counter()
        self.span_counts = Counter()

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.tracing:
            yield
            return
        synchronize(self.device)
        t0 = time.perf_counter()
        with torch.profiler.record_function(name):
            yield
            synchronize(self.device)
        self.spans[name] += time.perf_counter() - t0
        self.span_counts[name] += 1


def timed_window(runner, state, run, seconds: float) -> SimpleNamespace:
    """Whole chunks from one synchronize to the synchronize after the first
    chunk that ends at or after ``seconds``."""
    counts = Counter()
    synchronize(run.device)
    t0 = time.perf_counter()
    ends = []
    while True:
        counts.update(runner.chunk(state, run)["counts"])
        synchronize(run.device)
        ends.append(time.perf_counter() - t0)
        if ends[-1] >= seconds:
            return SimpleNamespace(seconds=ends[-1], chunks=len(ends), counts=counts,
                                   chunk_s=[b - a for a, b in zip([0.0] + ends, ends)])


def _union_seconds(intervals) -> float:
    total, end = 0, -1
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total / 1e9


def device_events(prof):
    """(device kernels and copies, host ops, host annotations) as
    (name, start_ns, end_ns) from the raw kineto events: a copy of the
    port's ``utils/profiling.device_kernels`` walk, which ``key_averages()``
    costs tens of host seconds on a training run."""
    dev, host, notes = [], [], []
    for e in prof.profiler.kineto_results.events():
        item = (e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if not e.is_user_annotation():
                dev.append(item)
        elif e.is_user_annotation():
            notes.append(item)
        else:
            host.append(item)
    return dev, host, notes


def _innermost(events, starts, t):
    """The latest-starting event of ``events`` (sorted by start) that
    covers time ``t``, or None."""
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(-1, i - 400), -1):
        if events[j][2] > t:
            return events[j]
    return None


def _top(counter: Counter) -> list:
    return [[k[:120], v] for k, v in counter.most_common(10)]


def device_ops(dev) -> list:
    """The 10 device operations that took most time, [name, seconds]."""
    by_op = Counter()
    for name, s, e in dev:
        by_op[name] += (e - s) / 1e9
    return _top(by_op)


def idle_gaps(dev, host, notes, window) -> list:
    """The 10 longest kinds of idle gap in ``window`` (start, end ns), each
    named by the harness span and the host op that covered its middle."""
    host = sorted(host, key=lambda x: x[1])
    notes = sorted(notes, key=lambda x: x[1])
    hs, ns = [h[1] for h in host], [n[1] for n in notes]
    gaps = Counter()
    end = window[0]
    for name, s, e in sorted(dev, key=lambda x: x[1]) + [("end", window[1], window[1])]:
        if s > end:
            mid = (s + end) // 2
            note, op = _innermost(notes, ns, mid), _innermost(host, hs, mid)
            label = f"{note[0] if note else 'between chunks'} / {op[0] if op else 'python'}"
            gaps[label] += (s - end) / 1e9
        end = max(end, e)
    return _top(gaps)


def traced_chunks(runner, state, run, n: int, summary_path: Path = None) -> SimpleNamespace:
    """``n`` chunks under torch.profiler recording device activity only, with
    the harness's spans fenced: window seconds, counts, spans, device time by
    kernel and the device's busy seconds (the union of its operations).
    Then one more chunk with host operations recorded too, which costs host
    time of its own, only to name what the host did in each idle gap."""
    from torch.profiler import ProfilerActivity, profile

    cuda = run.device.type == "cuda"
    counts = Counter()
    run.tracing = True
    synchronize(run.device)
    with profile(activities=[ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            counts.update(runner.chunk(state, run)["counts"])
            synchronize(run.device)
        seconds = time.perf_counter() - t0
    spans, span_counts = dict(run.spans), dict(run.span_counts)
    dev, _, _ = device_events(prof)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        with torch.profiler.record_function("window"):
            runner.chunk(state, run)
            synchronize(run.device)
    run.tracing = False
    dev2, host, notes = device_events(prof)
    window = next(((x[1], x[2]) for x in notes if x[0] == "window"),
                  (min((x[1] for x in dev2), default=0), max((x[2] for x in dev2), default=0)))
    kernels = {}
    for name, s, e in dev:
        k = kernels.setdefault(name, [0.0, 0])
        k[0] += (e - s) / 1e9
        k[1] += 1
    out = SimpleNamespace(seconds=seconds, chunks=n, counts=counts, spans=spans,
                          span_counts=span_counts, kernels=kernels,
                          busy_s=_union_seconds([(s, e) for _, s, e in dev]),
                          breakdown={"device_ops": device_ops(dev),
                                     "idle_gaps": idle_gaps(dev2, host, notes, window)})
    if summary_path is not None:
        summary_path.parent.mkdir(parents=True, exist_ok=True)
        top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:50]
        summary_path.write_text(json.dumps({
            "window_s": seconds, "busy_s": out.busy_s, "counts": counts, "spans": spans,
            "span_counts": span_counts, "kernels": [[k, s, c] for k, (s, c) in top],
            "breakdown": out.breakdown}, indent=1))
    return out


def read_metrics(spec, window, setup_s: float, trace: bool) -> dict:
    """Every metric the cell declares for this kind of run, each from its
    reader: every end-to-end metric in every run (a traced run's rates are
    those of its traced chunks), and every per-layer metric in a traced
    run.  A reader that finds nothing to read returns None, and the metric
    is left out of the line and named on standard error."""
    ctx = SimpleNamespace(setup_s=setup_s, window=window, config=spec.config,
                          traffic=spec.traffic, cell=spec.name)
    out = {}
    for metric in spec.end_to_end + (spec.per_layer if trace else []):
        value = load_module(BENCH / "metrics" / f"{metric['name']}.py").read(ctx)
        if value is None or not math.isfinite(value):
            print(f"{spec.name}: metric {metric['name']} read nothing", file=sys.stderr)
            continue
        out[metric["name"]] = {"value": float(value), "unit": metric["unit"]}
    return out


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run_cell(spec, seed: int, seconds: float, trace: bool, device, readings: dict = None) -> dict:
    """Set-up, window (or traced chunks), check; the result's line.  Every
    number the check read, compared or not, goes into ``readings``."""
    t0 = time.perf_counter()
    import dhaug_torch  # noqa: F401  (keeps TF32 off, as the program runs)
    if device.type == "cuda":
        from dhaug_torch.ops import cuda_lib
        cuda_lib.build()
        torch.zeros(1, device=device)
        torch.cuda.reset_peak_memory_stats(device)
    runner = runner_of(spec)
    run = Run(device, seed)
    t_build = time.perf_counter() - t0
    state = runner.setup(run, spec.config, spec.traffic)
    synchronize(device)
    setup_s = time.perf_counter() - t0
    if trace:
        window = traced_chunks(runner, state, run, spec.traffic["trace_chunks"],
                               BENCH / "_out" / f"{spec.name}.trace.json")
    else:
        window = timed_window(runner, state, run, seconds)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    t_check = time.perf_counter()
    values = runner.check(state, run)
    if readings is not None:
        readings.update(values)
    print(f"{spec.name}: set-up {setup_s:.3f} s (build and import {t_build:.3f} s), "
          f"{window.chunks} chunks in {window.seconds:.3f} s, check "
          f"{time.perf_counter() - t_check:.3f} s, peak {peak / 2 ** 30:.2f} GiB",
          file=sys.stderr)
    if getattr(window, "chunk_s", None):
        print(f"{spec.name}: chunk seconds " + " ".join(f"{s:.3f}" for s in window.chunk_s),
              file=sys.stderr)
    metrics = read_metrics(spec, window, setup_s, trace)
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu",
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": spec.chips, "memory_peak_bytes": int(peak)}
    line = {"correct": checks.judge(values, spec.limits),
            "attempted": int(window.counts.get("units", 0)), "failed": 0,
            "metrics": metrics, "device": dev}
    if trace:
        dev.update(busy_s=window.busy_s, window_s=window.seconds)
        line["breakdown"] = window.breakdown
    finite = lambda x: x if x is not None and math.isfinite(x) else None   # JSON has no NaN
    line["checks"] = {k: {"value": finite(values.get(k)), "limit": v}
                      for k, v in spec.limits.items()}
    return line


def report(line: dict) -> None:
    """Each compared number beside its limit as the last lines of
    standard error, then the result as the last line of standard output."""
    for name, c in line["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(f"correct = {line['correct']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line, allow_nan=False), flush=True)


def cache_dirs(root: Path = ROOT) -> None:
    """Kernel and build caches at fixed paths inside the checkout."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(root / "benchmark" / "_cache" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(root / "benchmark" / "_cache" / "triton")
