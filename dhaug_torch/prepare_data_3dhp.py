"""Prepare the MPI-INF-3DHP cross-dataset test set (2929 frames).

Port of ``data_extra/prepare_data_3dhp.py``.  Converts SPIN's
``mpi_inf_3dhp_valid.npz`` (keys ``imgname``, ``part`` (2D + confidence),
``S`` (3D + confidence)) into the 16-joint H36M layout and writes
``test_set/test_3dhp.npz`` in the current directory:

    pose3d: (N, 16, 3) camera-space metres
    pose2d: (N, 16, 2) normalized screen coordinates, confidence-masked

SPIN's joints are reordered into the H36M-16 slots; each frame's size comes
from its image path (TS5/TS6 are 1920x1080, TS1-TS4 2048x2048) for the
aspect-preserving normalization (x/w*2-1, y/w*2-h/w), and joints whose
confidence is 0 are zeroed.  An npz that carries 17-joint ``pose3d`` (mm)
and ``pose2d`` (pixels of a ``--res`` square frame) instead is reordered,
root-centred and normalized.  The arithmetic runs on ``--device`` (default
``cuda``; ``--device cpu`` without a card) in the dtypes the reference's
numpy ends in; the file is float32.

    python -m dhaug_torch.prepare_data_3dhp --source mpi_inf_3dhp_valid.npz
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

import dhaug_torch

# SPIN 19-joint -> H36M-16 reorder (the reference's prepare_data_3dhp.py:27)
SPIN_REORDER = [14, 2, 1, 0, 3, 4, 5, 16, 12, 18, 9, 10, 11, 8, 7, 6]

# the 3DHP annotated 17-joint set -> the 16-joint layout (ours <- theirs)
H36M16_FROM_3DHP17 = [14, 8, 9, 10, 11, 12, 13, 15, 1, 16, 5, 6, 7, 2, 3, 4]

# sequences filmed at 1920x1080; the others are 2048x2048
SMALL_FRAME_SEQUENCES = ("/TS5/", "/TS6/")

OUTPUT = os.path.join("test_set", "test_3dhp.npz")


def _path(name) -> str:
    return name.decode() if isinstance(name, bytes) else str(name)


def _float(t: torch.Tensor) -> torch.Tensor:
    """numpy's true divide turns integers into float64; torch's would give
    float32."""
    return t if t.is_floating_point() else t.double()


def convert_spin(data, device="cuda") -> tuple:
    """SPIN's mpi_inf_3dhp npz -> (pose3d (N, 16, 3), pose2d (N, 16, 2)),
    float32 numpy arrays."""
    device = dhaug_torch.resolve_device(str(device))
    sel = torch.as_tensor(SPIN_REORDER, device=device)
    part = torch.as_tensor(np.asarray(data["part"]), device=device)  # x, y, conf
    S = torch.as_tensor(np.asarray(data["S"]), device=device)        # x, y, z, conf
    p2 = part[:, sel, :2].float()
    mask = part[:, sel, 2:3].float()
    p3 = S[:, sel, :3].float()

    small = torch.as_tensor([any(s in _path(f) for s in SMALL_FRAME_SEQUENCES)
                             for f in np.asarray(data["imgname"])], device=device)
    w = torch.where(small, 1920.0, 2048.0).float()[:, None, None]
    h = torch.where(small, 1080.0, 2048.0).float()[:, None, None]
    offset = torch.cat([torch.ones_like(w), h / w], dim=-1)
    pose2d = (p2 / w * 2.0 - offset) * mask
    return p3.cpu().numpy(), pose2d.cpu().numpy()


def convert_generic(data, res: float = 2048.0, device="cuda") -> tuple:
    """17-joint ``pose3d`` (mm, camera space) and ``pose2d`` (pixels of a
    ``res`` square frame) -> (root-centred metres, normalized coordinates);
    the 3D keeps its input's float dtype."""
    device = dhaug_torch.resolve_device(str(device))
    sel = torch.as_tensor(H36M16_FROM_3DHP17, device=device)
    pose3d = _float(torch.as_tensor(np.asarray(data["pose3d"]), device=device)[:, sel]) / 1000.0
    pose3d = pose3d - pose3d[:, :1]
    pose2d = torch.as_tensor(np.asarray(data["pose2d"]), device=device)[:, sel].float()
    pose2d = pose2d / res * 2 - 1
    return pose3d.cpu().numpy(), pose2d.cpu().numpy()


def spin_layout(pose3d: np.ndarray, pose2d: np.ndarray, imgname) -> dict:
    """The inverse of :func:`convert_spin` for confident joints: a SPIN npz's
    ``imgname``/``part``/``S`` (24 joints, confidence 1 on the 16 kept, the
    rest 0) whose conversion gives back ``pose3d``/``pose2d`` (for checking
    a conversion round trip)."""
    n = len(pose3d)
    small = np.array([any(s in _path(f) for s in SMALL_FRAME_SEQUENCES) for f in imgname])
    w = np.where(small, 1920.0, 2048.0)[:, None, None]
    h = np.where(small, 1080.0, 2048.0)[:, None, None]
    part = np.zeros((n, 24, 3))
    S = np.zeros((n, 24, 4))
    part[:, SPIN_REORDER, :2] = (pose2d + np.concatenate([np.ones_like(w), h / w], -1)) * w / 2
    part[:, SPIN_REORDER, 2] = 1.0
    S[:, SPIN_REORDER, :3] = pose3d
    S[:, SPIN_REORDER, 3] = 1.0
    return {"imgname": np.asarray(imgname), "part": part, "S": S}


def write_test_set(pose3d: np.ndarray, pose2d: np.ndarray, out_dir: str = ".") -> str:
    path = os.path.join(out_dir, OUTPUT)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez_compressed(path, pose3d=np.asarray(pose3d, np.float32),
                        pose2d=np.asarray(pose2d, np.float32))
    return path


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--source", required=True, type=str,
                    help="SPIN-format mpi_inf_3dhp valid npz (imgname/part/S) "
                         "or a generic npz with pose3d/pose2d 17-joint arrays")
    ap.add_argument("--res", default=2048.0, type=float,
                    help="frame size for the generic 17-joint path")
    ap.add_argument("--device", default="cuda", type=str)
    args = ap.parse_args(argv)
    device = dhaug_torch.resolve_device(args.device)

    data = np.load(args.source, allow_pickle=True)
    if "S" in data:
        pose3d, pose2d = convert_spin(data, device)
    else:
        pose3d, pose2d = convert_generic(data, args.res, device)
    path = write_test_set(pose3d, pose2d)
    print(f"wrote {path}: {pose3d.shape[0]} frames")
    return {"path": path, "frames": int(pose3d.shape[0])}


if __name__ == "__main__":
    main(sys.argv[1:])
