"""Frame-centred window samplers for video mode: a copy of
``dhaug_tpu/data/chunked.py``, numpy on the host and torch on the device.

* ``ChunkWindows`` <- ChunkedGenerator (video_mode_operate.py:193) and
  GAN_video_ChunkedGenerator (:35), which the reference uses with
  chunk_length=1 only, so every frame is a chunk centre; the 3D target is
  the single centre frame or the full +-pad window (:149-162).  Each
  sequence is edge-padded once and all of them concatenate into one array,
  so a batch of windows is one index gather (the training loops gather on
  the device from ``device_arrays`` and the index arrays; ``device_epoch``
  yields such batches).
* ``UnchunkedSequences`` <- UnchunkedGenerator (:350): whole-sequence
  evaluation batches with symmetric edge padding of the 2D input.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from dhaug_torch.utils.profiling import span


class ChunkWindows:
    """Frame-centred +-pad windows over a list of sequences.

    poses_2d: list of (Ni, 16, 2); poses_3d: list of (Ni, 16, 3);
    cams: list of per-sequence camera vectors (C,) or per-frame (Ni, C).
    full_3d_window=True pads the 3D target to the same window as the 2D
    input (the GAN clip sampler); False keeps the single centre frame
    (the posenet chunk sampler).
    """

    def __init__(self, batch_size: int, cams: Optional[Sequence],
                 poses_3d: Sequence, poses_2d: Sequence, pad: int,
                 full_3d_window: bool = False, shuffle: bool = True,
                 random_seed: int = 1234, drop_last: bool = True):
        assert len(poses_3d) == len(poses_2d)
        # every offset below is derived from the 2D lengths; a per-sequence
        # frame-count mismatch would silently shift every 3D target after
        # the first unequal sequence — fail loudly instead
        for i, (s3, s2) in enumerate(zip(poses_3d, poses_2d)):
            if np.asarray(s3).shape[0] != np.asarray(s2).shape[0]:
                raise ValueError(
                    f"sequence {i}: 3D has {np.asarray(s3).shape[0]} frames "
                    f"but 2D has {np.asarray(s2).shape[0]} — trim upstream "
                    "(data/loaders.py::fetch aligns them)")
        self.batch_size = batch_size
        self.pad = pad
        self.full_3d_window = full_3d_window
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.rng = np.random.default_rng(random_seed)

        pad2d = [np.pad(np.asarray(s, np.float32), ((pad, pad), (0, 0), (0, 0)),
                        "edge") for s in poses_2d]
        self.big2d = np.concatenate(pad2d)
        if full_3d_window:
            pad3d = [np.pad(np.asarray(s, np.float32), ((pad, pad), (0, 0), (0, 0)),
                            "edge") for s in poses_3d]
            self.big3d = np.concatenate(pad3d)
        else:
            self.big3d = np.concatenate([np.asarray(s, np.float32) for s in poses_3d])

        lengths = np.array([s.shape[0] for s in poses_2d])
        # offsets into the PADDED concatenation: window for (seq, centre c)
        # starts at off2d[seq] + c and spans 2*pad+1 frames.
        off2d = np.concatenate([[0], np.cumsum(lengths + 2 * pad)])[:-1]
        off3d_padded = off2d
        off3d_plain = np.concatenate([[0], np.cumsum(lengths)])[:-1]

        seq_idx = np.concatenate([np.full(n, i) for i, n in enumerate(lengths)])
        centers = np.concatenate([np.arange(n) for n in lengths])
        self.start2d = (off2d[seq_idx] + centers).astype(np.int64)
        if full_3d_window:
            self.start3d = (off3d_padded[seq_idx] + centers).astype(np.int64)
        else:
            self.idx3d = (off3d_plain[seq_idx] + centers).astype(np.int64)

        if cams is not None:
            cam_rows = []
            for i, n in enumerate(lengths):
                c = np.asarray(cams[i], np.float32)
                cam_rows.append(np.tile(c[None], (n, 1)) if c.ndim == 1 else c)
            self.cams = np.concatenate(cam_rows)
        else:
            self.cams = None

        self.n_chunks = int(lengths.sum())
        self.window = 2 * pad + 1

    @property
    def num_batches(self) -> int:
        if self.drop_last:
            return self.n_chunks // self.batch_size
        return -(-self.n_chunks // self.batch_size)

    def gather(self, sel: np.ndarray):
        """Materialize the batch for chunk indices ``sel``."""
        w2d = self.big2d[self.start2d[sel][:, None] + np.arange(self.window)[None]]
        if self.full_3d_window:
            w3d = self.big3d[self.start3d[sel][:, None] + np.arange(self.window)[None]]
        else:
            w3d = self.big3d[self.idx3d[sel]][:, None]  # (B, 1, 16, 3)
        cam = self.cams[sel] if self.cams is not None else None
        return cam, w3d, w2d

    def next_epoch(self):
        order = self.rng.permutation(self.n_chunks) if self.shuffle \
            else np.arange(self.n_chunks)
        stop = self.num_batches * self.batch_size if self.drop_last else self.n_chunks
        for s in range(0, stop, self.batch_size):
            yield self.gather(order[s:s + self.batch_size])

    def device_arrays(self, device):
        """(big2d, big3d, cams) as tensors on ``device`` (cams None without
        camera records), uploaded once and kept on the sampler."""
        device = torch.empty(0, device=device).device   # 'cuda' -> 'cuda:0'
        cached = getattr(self, "_device_arrays", None)
        if cached is None or cached[0].device != device:
            with span("data.upload"):
                cached = tuple(None if a is None else torch.as_tensor(a, device=device)
                               for a in (self.big2d, self.big3d, self.cams))
            self._device_arrays = cached
        return cached

    def device_epoch(self, device):
        """:meth:`next_epoch` on the device: the same (cam, w3d, w2d)
        batches as tensors gathered from :meth:`device_arrays`, the last
        partial batch always dropped."""
        big2d, big3d, cams = self.device_arrays(device)
        device = big2d.device
        order = self.rng.permutation(self.n_chunks) if self.shuffle \
            else np.arange(self.n_chunks)
        n_full = self.n_chunks // self.batch_size
        sel = order[: n_full * self.batch_size].reshape(n_full, self.batch_size)
        with span("data.upload"):     # closed before the first yield
            rows = lambda a: torch.as_tensor(a[sel], device=device)
            start2d = rows(self.start2d)
            start3d = rows(self.start3d if self.full_3d_window else self.idx3d)
            sel = torch.as_tensor(sel, device=device)
            win = torch.arange(self.window, device=device)[None]
        for b in range(n_full):
            w2d = big2d[start2d[b][:, None] + win]
            w3d = big3d[start3d[b][:, None] + win] if self.full_3d_window \
                else big3d[start3d[b]][:, None]
            yield None if cams is None else cams[sel[b]], w3d, w2d


class UnchunkedSequences:
    """Whole-sequence eval batches: yields (cam, seq3d (1, T, 16, 3),
    seq2d (1, T + 2*pad, 16, 2)) per sequence."""

    def __init__(self, cams: Optional[Sequence], poses_3d: Sequence,
                 poses_2d: Sequence, pad: int):
        self.cams = cams
        self.poses_3d = [np.asarray(s, np.float32) for s in poses_3d]
        self.poses_2d = [np.asarray(s, np.float32) for s in poses_2d]
        self.pad = pad

    def __len__(self):
        return len(self.poses_2d)

    def num_frames(self) -> int:
        return int(sum(s.shape[0] for s in self.poses_2d))

    def next_epoch(self):
        for i, (s3, s2) in enumerate(zip(self.poses_3d, self.poses_2d)):
            cam = None if self.cams is None else np.asarray(self.cams[i])[None]
            p2 = np.pad(s2, ((self.pad, self.pad), (0, 0), (0, 0)), "edge")
            yield cam, s3[None], p2[None]


# MPI-INF-3DHP's 2929-frame test set splits into 6 camera sequences at these
# hardcoded boundaries (video_mode_operate.py:495-499).
MPI3D_SEQUENCE_RANGES = ((0, 603), (603, 1143), (1143, 1648),
                         (1648, 2201), (2201, 2477), (2477, 2929))


def split_mpi3d_sequences(pose3d: np.ndarray, pose2d: np.ndarray):
    # the 6-sequence frame ranges are hardcoded for the reference's
    # 2929-frame test_3dhp.npz export (prepare_data_3dhp.py); a different
    # frame count would silently mis-split (or crash on an empty slice many
    # epochs in), so fail at data-prep time with an actionable message
    n = MPI3D_SEQUENCE_RANGES[-1][1]
    if pose3d.shape[0] != n:
        raise ValueError(
            f"test_3dhp.npz has {pose3d.shape[0]} frames but the video-mode "
            f"6-sequence split (MPI3D_SEQUENCE_RANGES) assumes the "
            f"reference's {n}-frame export. Regenerate it with "
            "data_extra/prepare_data_3dhp.py, or adjust "
            "MPI3D_SEQUENCE_RANGES for your export's camera boundaries.")
    seq3d = [pose3d[a:b] for a, b in MPI3D_SEQUENCE_RANGES]
    seq2d = [pose2d[a:b] for a, b in MPI3D_SEQUENCE_RANGES]
    return seq3d, seq2d
