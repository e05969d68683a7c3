"""Host-side data pipeline: npz ingestion, flattening, frame-level containers.

A numpy copy of ``dhaug_tpu/data/loaders.py`` (read_3d_data,
create_2d_data, fetch, the PoseDataset / PoseBuffer / PoseTarget /
PoseTarget2D / CmuPoseTarget containers with their epoch samplers, and
``pad_to_batch``).  The
training loops move the concatenated arrays to the device once and batch
them there with index gathers.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Iterator, List, Sequence

import numpy as np


# ---------------------------------------------------------------------------
# numpy camera helpers (host prep; device code uses dhaug_torch.ops.camera)
# ---------------------------------------------------------------------------

def np_qrot(q: np.ndarray, v: np.ndarray) -> np.ndarray:
    w = q[..., :1]
    qvec = q[..., 1:]
    uv = np.cross(qvec, v)
    uuv = np.cross(qvec, uv)
    return v + 2.0 * (w * uv + uuv)


def np_world_to_camera(X: np.ndarray, R: np.ndarray, t: np.ndarray) -> np.ndarray:
    Rt = np.concatenate([R[..., :1], -R[..., 1:]], axis=-1)
    Rt = np.broadcast_to(Rt, X.shape[:-1] + (4,))
    return np_qrot(Rt, X - t)


def np_camera_to_world(X: np.ndarray, R: np.ndarray, t: np.ndarray) -> np.ndarray:
    R = np.broadcast_to(R, X.shape[:-1] + (4,))
    return np_qrot(R, X) + t


def np_normalize_screen(points: np.ndarray, w: float, h: float) -> np.ndarray:
    out = points.copy()
    out[..., 0] = out[..., 0] / w * 2.0 - 1.0
    out[..., 1] = out[..., 1] / w * 2.0 - h / w
    return out


# ---------------------------------------------------------------------------
# npz ingestion
# ---------------------------------------------------------------------------

def read_3d_data(dataset):
    """Attach per-camera camera-space 3D ('positions_3d') to every action.
    Mirrors utils/data_utils.py:26-39."""
    for subject in dataset.subjects():
        for action in dataset[subject].keys():
            anim = dataset[subject][action]
            positions_3d = []
            for cam in anim["cameras"]:
                pos_3d = np_world_to_camera(
                    anim["positions"], R=cam["orientation"], t=cam["translation"])
                positions_3d.append(pos_3d.astype(np.float32))
            anim["positions_3d"] = positions_3d
    return dataset


def create_2d_data(data_path, dataset):
    """Load a data_2d_*.npz and normalize to screen coordinates.
    Mirrors utils/data_utils.py:11-23."""
    keypoints = np.load(data_path, allow_pickle=True)["positions_2d"].item()
    for subject in keypoints.keys():
        for action in keypoints[subject]:
            for cam_idx, kps in enumerate(keypoints[subject][action]):
                cam = dataset.cameras()[subject][cam_idx]
                kps = np.asarray(kps, dtype=np.float32)
                kps[..., :2] = np_normalize_screen(
                    kps[..., :2], w=cam["res_w"], h=cam["res_h"])
                keypoints[subject][action][cam_idx] = kps
    return keypoints


def fetch(subjects, dataset, keypoints, action_filter=None, stride: int = 1,
          train: bool = True, with_extrinsics: bool = True, per_frame_cam: bool = True,
          min_motion_mm: float | None = None):
    """Flatten (subject, action, camera) into parallel per-sequence lists of
    camera-space 3D (N, 16, 3), 2D (N, 16, 2), camera records and per-frame
    action names (utils/data_utils.py:42-126).  A camera record is the
    intrinsic(9), followed by orientation(4) | translation(3) when
    ``with_extrinsics``; ``per_frame_cam`` repeats it per frame (the
    reference's 'single' mode), else each sequence keeps one ('multi').
    ``stride`` subsamples the training frames; ``min_motion_mm`` (the
    --video_over_200mm filter) then keeps, of the training frames, the first
    and each one whose largest joint move from the last kept frame reaches
    it."""
    out_poses_3d, out_poses_2d, out_cam, out_actions = [], [], [], []
    for subject in subjects:
        for action in keypoints[subject].keys():
            if action_filter is not None and \
                    not any(action.split(" ")[0] == a for a in action_filter):
                continue
            anim = dataset[subject][action]
            poses_2d = keypoints[subject][action]
            if len(anim["positions_3d"]) != len(poses_2d):
                raise ValueError(f"{subject}/{action}: camera count mismatch")
            for i, pose_3d in enumerate(anim["positions_3d"]):
                # detector exports may cover trailing video frames past the
                # mocap: trim the 2D to the 3D length
                n3 = pose_3d.shape[0]
                if poses_2d[i].shape[0] < n3:
                    raise ValueError(f"{subject}/{action} cam {i}: 2D has "
                                     f"{poses_2d[i].shape[0]} frames < 3D {n3}")
                cam = anim["cameras"][i]
                parts = [cam["intrinsic"]]
                if with_extrinsics:
                    parts += [cam["orientation"], cam["translation"]]
                record = np.concatenate(parts).astype(np.float32)
                sl = slice(None, None, stride if train else 1)
                out_poses_3d.append(np.asarray(pose_3d, np.float32)[sl])
                out_poses_2d.append(np.asarray(poses_2d[i][:n3], np.float32)[sl])
                out_cam.append(np.tile(record[None], (n3, 1))[sl] if per_frame_cam else record)
                out_actions.append([action.split(" ")[0]] * len(out_poses_3d[-1]))

    if min_motion_mm is not None and train:
        # the reference's `continue` skips its `prev_kp3d = kp3d` update
        # (utils/data_utils.py:110-122), so the motion is measured from the
        # last KEPT frame
        for i, seq3d in enumerate(out_poses_3d):
            keep, prev = [0], seq3d[0]
            for f in range(1, seq3d.shape[0]):
                if np.any(np.linalg.norm(prev - seq3d[f], axis=1) * 1000.0 >= min_motion_mm):
                    keep.append(f)
                    prev = seq3d[f]
            out_poses_3d[i] = seq3d[keep]
            out_poses_2d[i] = out_poses_2d[i][keep]
            out_actions[i] = [out_actions[i][k] for k in keep]
            if per_frame_cam:
                out_cam[i] = out_cam[i][keep]
    return out_poses_3d, out_poses_2d, out_cam, out_actions


# ---------------------------------------------------------------------------
# frame-level containers
# ---------------------------------------------------------------------------

def _batch_indices(rng: np.random.Generator, n: int, batch_size: int,
                   shuffle: bool = True, drop_last: bool = True) -> Iterator[np.ndarray]:
    """Row indices of each batch of an epoch over n rows: one
    ``rng.permutation`` when shuffling, the last partial batch dropped
    with ``drop_last``."""
    idx = rng.permutation(n) if shuffle else np.arange(n)
    stop = n - (n % batch_size) if drop_last else n
    for s in range(0, stop, batch_size):
        yield idx[s:s + batch_size]


@dataclass
class PoseDataset:
    """Concatenated (3D, 2D, cam) frames (PoseDataSet,
    common/data_loader.py:9).  Arrays are numpy on the host or tensors on
    the device once a training loop has staged them."""

    poses_3d: Any   # (N, 16, 3)
    poses_2d: Any   # (N, 16, 2)
    cams: Any       # (N, C)

    @classmethod
    def from_lists(cls, poses_3d: Sequence, poses_2d: Sequence, cams: Sequence):
        return cls(
            np.concatenate([np.asarray(p, np.float32) for p in poses_3d]),
            np.concatenate([np.asarray(p, np.float32) for p in poses_2d]),
            np.concatenate([np.asarray(c, np.float32) for c in cams]),
        )

    def __len__(self):
        return self.poses_3d.shape[0]

    def batches(self, rng: np.random.Generator, batch_size: int,
                shuffle: bool = True, drop_last: bool = True) -> Iterator[tuple]:
        for sel in _batch_indices(rng, len(self), batch_size, shuffle, drop_last):
            yield self.poses_3d[sel], self.poses_2d[sel], self.cams[sel]

    def num_batches(self, batch_size: int, drop_last: bool = True) -> int:
        n = len(self)
        return n // batch_size if drop_last else -(-n // batch_size)


@dataclass
class PoseBuffer:
    """(3D, 2D) pairs without camera records (PoseBuffer,
    common/data_loader.py:39) -- the 3DHP test set."""

    poses_3d: Any
    poses_2d: Any

    @classmethod
    def from_lists(cls, poses_3d, poses_2d):
        return cls(
            np.concatenate([np.asarray(p, np.float32) for p in poses_3d]),
            np.concatenate([np.asarray(p, np.float32) for p in poses_2d]),
        )

    def __len__(self):
        return self.poses_3d.shape[0]

    def batches(self, batch_size: int) -> Iterator[tuple]:
        """In order, the last batch partial."""
        for s in range(0, len(self), batch_size):
            yield self.poses_3d[s:s + batch_size], self.poses_2d[s:s + batch_size]


@dataclass
class PoseTarget:
    """Single-array target set (PoseTarget, common/data_loader.py:62)."""

    poses: Any

    @classmethod
    def from_lists(cls, poses):
        return cls(np.concatenate([np.asarray(p, np.float32) for p in poses]))

    def __len__(self):
        return self.poses.shape[0]

    def batches(self, rng: np.random.Generator, batch_size: int,
                shuffle: bool = True, drop_last: bool = True) -> Iterator[Any]:
        for sel in _batch_indices(rng, len(self), batch_size, shuffle, drop_last):
            yield self.poses[sel]


@dataclass
class PoseTarget2D:
    """2D targets and a confidence-mask channel (PoseTarget2D,
    common/data_loader.py:92)."""

    poses_2d: np.ndarray

    @classmethod
    def from_lists(cls, poses_2d):
        return cls(np.concatenate([np.asarray(p, np.float32) for p in poses_2d]))

    def __len__(self):
        return self.poses_2d.shape[0]

    def batches(self, rng: np.random.Generator, batch_size: int,
                shuffle: bool = True, drop_last: bool = True) -> Iterator[tuple]:
        """(poses_2d, mask) batches, the mask all ones (B, 16, 1)."""
        mask = np.ones((batch_size, self.poses_2d.shape[1], 1), np.float32)
        for sel in _batch_indices(rng, len(self), batch_size, shuffle, drop_last):
            yield self.poses_2d[sel], mask[: len(sel)]


@dataclass
class CmuPoseTarget:
    """(3D, 2D, camera) sampler whose cameras cycle independently of the
    poses (CmuDatasetPoseTarget, common/data_loader.py:109-129)."""

    poses_3d: np.ndarray
    poses_2d: np.ndarray
    cams: np.ndarray

    def __len__(self):
        return len(self.poses_3d)

    def batches(self, rng: np.random.Generator, batch_size: int,
                drop_last: bool = True) -> Iterator[tuple]:
        n_cams = self.cams.shape[0]
        for sel in _batch_indices(rng, len(self), batch_size, drop_last=drop_last):
            yield (self.poses_3d[sel], self.poses_2d[sel],
                   self.cams[sel % max(n_cams - 1, 1)])


def pad_to_batch(arrays: List[np.ndarray], batch_size: int):
    """Edge-pad the leading axis of each array to a multiple of
    ``batch_size``; returns (padded arrays, count of real rows)."""
    n = arrays[0].shape[0]
    pad = (-n) % batch_size
    if pad == 0:
        return arrays, n
    return [np.concatenate([a, np.repeat(a[-1:], pad, axis=0)], axis=0) for a in arrays], n
