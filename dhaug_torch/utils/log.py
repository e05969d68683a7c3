"""Run logging: the tab-separated ``log.txt``, the scalar stream, counters.

Port of ``dhaug_tpu/utils/log.py``'s ``Logger``, ``MetricsWriter``,
``Summary`` (with its ``state_dict``/``load_state_dict`` for resume),
``AverageMeter`` and ``ProgressMeter``.  ``log.txt`` has the JAX package's schema: the args dump, the
header row, then one row per logged epoch.  Scalars go to
``metrics.jsonl`` under the reference's TensorBoard tags; this port writes
no TensorBoard event files (importing ``torch.utils.tensorboard`` can pull in
all of TensorFlow, which costs more than a short run).  A ``Logger`` or
``MetricsWriter`` given no path writes nothing: the ranks of a data-parallel
run other than rank 0 keep the counters but write no file.
"""
from __future__ import annotations

import json
import os
import sys
import time
from typing import Optional


class Logger:
    """Tab-separated metric rows with named columns (none without ``fpath``)."""

    def __init__(self, fpath: Optional[str], args=None):
        self.file = open(fpath, "w") if fpath is not None else None
        self.names = []
        if args is not None:
            self.record_args(str(args))

    def _write(self, line: str):
        if self.file is not None:
            self.file.write(line + "\n")
            self.file.flush()

    def record_args(self, text: str):
        self._write(text)

    def set_names(self, names):
        self.names = list(names)
        self._write("\t".join(self.names))

    def append(self, numbers):
        if len(self.names) != len(numbers):
            raise ValueError("numbers do not match names")
        row = [f"{num}" if isinstance(num, int) else f"{float(num):.6f}" for num in numbers]
        self._write("\t".join(row))

    def close(self):
        if self.file is not None:
            self.file.close()


class MetricsWriter:
    """Scalar stream, one JSON object a line (none without a directory)."""

    def __init__(self, directory: Optional[str]):
        self._jsonl = None
        if directory is not None:
            os.makedirs(directory, exist_ok=True)
            self._jsonl = open(os.path.join(directory, "metrics.jsonl"), "a")

    def add_scalar(self, tag: str, value, step: int):
        if self._jsonl is not None:
            self._jsonl.write(json.dumps({"tag": tag, "value": float(value), "step": int(step),
                                          "ts": time.time()}) + "\n")

    def flush(self):
        if self._jsonl is not None:
            self._jsonl.flush()

    def close(self):
        if self._jsonl is not None:
            self._jsonl.close()


class Summary:
    """Iteration/epoch counters shared across the training phases; its
    writer writes nothing without a ``directory``."""

    def __init__(self, directory: Optional[str]):
        self.directory = directory
        self.epoch = 0
        self.train_iter_num = 0
        self.train_fakepose_iter_num = 0
        self.train_discrim_iter_num = 0
        self.writer: Optional[MetricsWriter] = None
        # per-epoch GAN scalars (Wasserstein curves), appended by run_gan_epoch
        self.epoch_scalar_history: dict = {}

    def record_epoch_scalars(self, scalars: dict) -> None:
        for k, v in scalars.items():
            self.epoch_scalar_history.setdefault(k, []).append(float(v))

    def create_summary(self) -> MetricsWriter:
        self.writer = MetricsWriter(self.directory)
        return self.writer

    _COUNTERS = ("epoch", "train_iter_num", "train_fakepose_iter_num",
                 "train_discrim_iter_num")

    def state_dict(self) -> dict:
        """The counters and the scalar history, for a resume snapshot."""
        d = {k: getattr(self, k) for k in self._COUNTERS}
        d["epoch_scalar_history"] = {k: list(v) for k, v in self.epoch_scalar_history.items()}
        return d

    def load_state_dict(self, d: dict) -> None:
        for k, v in d.items():
            if k == "epoch_scalar_history":
                self.epoch_scalar_history = {kk: [float(x) for x in vv]
                                             for kk, vv in dict(v).items()}
            elif k in self._COUNTERS:
                setattr(self, k, int(v))
            else:
                raise ValueError(f"unknown summary counter {k!r}")

    def close(self):
        if self.writer is not None:
            self.writer.close()


class AverageMeter:
    """Running mean of a value (the reference's AverageMeter,
    utils/utils.py:95)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n=1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count


class ProgressMeter:
    """Minimal console progress line (replaces the reference's vendored
    progress package)."""

    def __init__(self, title: str, total: int, stream=sys.stderr):
        self.title = title
        self.total = total
        self.start = time.time()
        self.stream = stream

    def update(self, i: int, suffix: str = ""):
        elapsed = time.time() - self.start
        rate = (i + 1) / max(elapsed, 1e-9)
        eta = (self.total - i - 1) / max(rate, 1e-9)
        self.stream.write(
            f"\r{self.title} ({i + 1}/{self.total}) "
            f"{elapsed:6.1f}s elapsed | ETA {eta:6.1f}s {suffix}")
        self.stream.flush()

    def finish(self):
        self.stream.write("\n")
        self.stream.flush()
