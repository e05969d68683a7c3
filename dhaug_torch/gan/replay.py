"""Historical-sample replay pool (Shrivastava et al.): a numpy copy of
``dhaug_tpu/gan/replay.py``'s ``SampleFromPool``.

The reference imports it (utils/gan_utils.py:163-184) but its main path does
not use it, and neither does the JAX package's or the port's; it is kept as
an optional critic-input stabilizer.  One call swaps a whole batch against
the pool.
"""
from __future__ import annotations

import numpy as np


class SampleFromPool:
    def __init__(self, max_elements: int = 4096, seed: int = 0):
        self.max_elements = max_elements
        self.rng = np.random.default_rng(seed)
        self.items: np.ndarray | None = None
        self.count = 0

    def __call__(self, batch: np.ndarray) -> np.ndarray:
        """The batch with, once the pool is full, each item swapped with
        probability 0.5 against a random stored element (which the incoming
        item replaces)."""
        batch = np.asarray(batch)
        if self.items is None:
            self.items = np.empty((self.max_elements,) + batch.shape[1:], batch.dtype)
        out = batch.copy()
        n = batch.shape[0]
        if self.count < self.max_elements:
            take = min(self.max_elements - self.count, n)
            self.items[self.count:self.count + take] = batch[:take]
            self.count += take
            rest = batch[take:]
        else:
            rest = batch
        if self.count >= self.max_elements and rest.shape[0]:
            m = rest.shape[0]
            swap = self.rng.random(m) > 0.5
            idx = self.rng.integers(0, self.max_elements, size=m)
            offset = n - m
            for i in range(m):
                if swap[i]:
                    out[offset + i] = self.items[idx[i]]
                    self.items[idx[i]] = rest[i]
        return out
