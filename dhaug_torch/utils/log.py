"""Run logging: the tab-separated ``log.txt``, the scalar stream, counters.

Port of ``dhaug_tpu/utils/log.py``'s ``Logger``, ``MetricsWriter`` and
``Summary``.  ``log.txt`` has the JAX package's schema: the args dump, the
header row, then one row per logged epoch.  Scalars go to
``metrics.jsonl`` under the reference's TensorBoard tags; this port writes
no TensorBoard event files (importing ``torch.utils.tensorboard`` can pull in
all of TensorFlow, which costs more than a short run).
"""
from __future__ import annotations

import json
import os
import time
from typing import Optional


class Logger:
    """Tab-separated metric rows with named columns."""

    def __init__(self, fpath: str, args=None):
        self.file = open(fpath, "w")
        self.names = []
        if args is not None:
            self.record_args(str(args))

    def record_args(self, text: str):
        self.file.write(text + "\n")
        self.file.flush()

    def set_names(self, names):
        self.names = list(names)
        self.file.write("\t".join(self.names) + "\n")
        self.file.flush()

    def append(self, numbers):
        if len(self.names) != len(numbers):
            raise ValueError("numbers do not match names")
        row = [f"{num}" if isinstance(num, int) else f"{float(num):.6f}" for num in numbers]
        self.file.write("\t".join(row) + "\n")
        self.file.flush()

    def close(self):
        self.file.close()


class MetricsWriter:
    """Scalar stream, one JSON object a line."""

    def __init__(self, directory: str):
        os.makedirs(directory, exist_ok=True)
        self._jsonl = open(os.path.join(directory, "metrics.jsonl"), "a")

    def add_scalar(self, tag: str, value, step: int):
        self._jsonl.write(json.dumps({"tag": tag, "value": float(value), "step": int(step),
                                      "ts": time.time()}) + "\n")

    def close(self):
        self._jsonl.close()


class Summary:
    """Iteration/epoch counters shared across the training phases."""

    def __init__(self, directory: str):
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

    def close(self):
        if self.writer is not None:
            self.writer.close()
