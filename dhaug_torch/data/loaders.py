"""Host-side data pipeline: npz ingestion, flattening, frame-level containers.

A numpy copy of what the single-frame path uses from
``dhaug_tpu/data/loaders.py`` (read_3d_data, create_2d_data, fetch and the
PoseDataset / PoseBuffer / PoseTarget containers).  The training loops move
the concatenated arrays to the device once and batch them there with index
gathers.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Sequence

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
          train: bool = True):
    """Flatten (subject, action, camera) into parallel per-sequence lists of
    camera-space 3D (N, 16, 3), 2D (N, 16, 2), per-frame 16-float camera
    records (intrinsic | orientation | translation) and per-frame action
    names: the reference's 'single' mode of utils/data_utils.py:42-126.
    ``stride`` subsamples the training frames."""
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
                record = np.concatenate([cam["intrinsic"], cam["orientation"],
                                         cam["translation"]]).astype(np.float32)
                sl = slice(None, None, stride if train else 1)
                out_poses_3d.append(np.asarray(pose_3d, np.float32)[sl])
                out_poses_2d.append(np.asarray(poses_2d[i][:n3], np.float32)[sl])
                out_cam.append(np.tile(record[None], (n3, 1))[sl])
                out_actions.append([action.split(" ")[0]] * len(out_poses_3d[-1]))
    return out_poses_3d, out_poses_2d, out_cam, out_actions


# ---------------------------------------------------------------------------
# frame-level containers
# ---------------------------------------------------------------------------

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


@dataclass
class PoseTarget:
    """Single-array target set (PoseTarget, common/data_loader.py:62)."""

    poses: Any

    def __len__(self):
        return self.poses.shape[0]
