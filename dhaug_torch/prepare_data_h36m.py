"""Prepare the Human3.6M npz files from the official release.

Port of ``data/prepare_data_h36m.py``.  Writes, in the current directory,
``data_3d_h36m.npz`` ({'positions_3d': {subject: {action: (N, 32, 3) world
metres}}}) and ``data_2d_h36m_gt.npz`` (ground-truth 2D from projecting the
16 kept joints through each subject's 4 calibrated cameras, in pixels, with
the reference's ``metadata``).  Two sources, like the reference:

    python -m dhaug_torch.prepare_data_h36m --from-archive h36m.zip
    python -m dhaug_torch.prepare_data_h36m --from-source <dir>

``--from-archive`` reads the "D3 positions" ``.cdf`` files of the archive
(extracted to ``extract_tmp/``) and needs ``cdflib``; ``--from-source``
reads per-subject ``.mat`` exports (``<dir>/S*/MyPoseFeatures/D3_Positions``)
and needs ``h5py``.  The readers decode files with numpy on the host; the
projection runs on ``--device`` (default ``cuda``; ``--device cpu`` on a
machine without a card).  Run it inside ``data/`` of a data root.
"""
from __future__ import annotations

import argparse
import importlib
import os
import sys
import time
import zipfile
from glob import glob

import numpy as np
import torch

import dhaug_torch
from dhaug_torch.data.h36m import (H36M_32_To_16_Table, JOINTS_LEFT_16, JOINTS_RIGHT_16,
                                   normalized_camera)
from dhaug_torch.ops.camera import image_coordinates, project_to_2d, world_to_camera

SUBJECTS = ["S1", "S5", "S6", "S7", "S8", "S9", "S11"]
OUTPUT_3D = "data_3d_h36m"
OUTPUT_2D = "data_2d_h36m_gt"
N_CAMERAS = 4


def _reader(package: str, what: str):
    """Import ``package`` or exit naming it (neither reader ships with the
    port)."""
    try:
        return importlib.import_module(package)
    except ImportError as e:
        raise SystemExit(f"{package} is required to read {what}; pip install {package} "
                         "on a machine with the dataset") from e


def load_cdf_positions(path: str) -> np.ndarray:
    cdflib = _reader("cdflib", "the official .cdf files")
    positions = cdflib.CDF(path)["Pose"].reshape(-1, 32, 3) / 1000.0
    return positions.astype(np.float32)


def load_mat_positions(path: str) -> np.ndarray:
    h5py = _reader("h5py", "the .mat exports")
    with h5py.File(path, "r") as hf:
        positions = np.asarray(hf["data"])[0].reshape(-1, 32, 3) / 1000.0
    return positions.astype(np.float32)


def write_mat_tree(positions_3d: dict, root: str) -> None:
    """The inverse of the ``--from-source`` reader: each (N, 32, 3) metre
    sequence as ``root/<subject>/MyPoseFeatures/D3_Positions/<action>.mat``
    holding 'data' (1, N, 96) in millimetres, the release's export layout
    (for checking the reader on known poses)."""
    h5py = _reader("h5py", "the .mat exports")
    for subject, actions in positions_3d.items():
        d3 = os.path.join(root, subject, "MyPoseFeatures", "D3_Positions")
        os.makedirs(d3, exist_ok=True)
        for action, pose in actions.items():
            with h5py.File(os.path.join(d3, f"{action}.mat"), "w") as hf:
                hf.create_dataset("data", data=np.asarray(pose, np.float64).reshape(
                    1, -1, 96) * 1000.0)


def _collect(root: str, ext: str, load) -> dict:
    """{subject: {action: (N, 32, 3)}} from ``root/S*/MyPoseFeatures/
    D3_Positions/*.<ext>``, in sorted-glob order, ``_`` in a file name read
    as a space."""
    output = {}
    for subject in SUBJECTS:
        output[subject] = {}
        for f in sorted(glob(os.path.join(root, subject, "MyPoseFeatures", "D3_Positions",
                                          f"*.{ext}"))):
            action = os.path.splitext(os.path.basename(f))[0].replace("_", " ")
            output[subject][action] = load(f)
    return output


def collect_3d(args) -> dict:
    """The release's 3D poses in metres, float32, as the reference reads
    them.  Exits naming the missing reader before any file is touched."""
    if args.from_archive:
        _reader("cdflib", "the official .cdf files")
        workdir = os.path.abspath("extract_tmp")
        os.makedirs(workdir, exist_ok=True)
        with zipfile.ZipFile(args.from_archive) as zf:
            zf.extractall(workdir)
        return _collect(workdir, "cdf", load_cdf_positions)
    if args.from_source:
        _reader("h5py", "the .mat exports")
        return _collect(args.from_source, "mat", load_mat_positions)
    raise SystemExit("pass --from-archive or --from-source")


def _camera_tensors(subject: str, device: torch.device) -> list:
    out = []
    for cam_idx in range(N_CAMERAS):
        cam = normalized_camera(subject, cam_idx)
        out.append([torch.as_tensor(cam[k], device=device)
                    for k in ("orientation", "translation", "intrinsic")]
                   + [cam["res_w"], cam["res_h"]])
    return out


def project_positions_2d(positions_3d: dict, device="cuda") -> dict:
    """{subject: {action: [4 x (N, 16, 2) float32 pixels]}}: the 16 kept
    joints of every sequence through each of its subject's cameras
    (world -> camera, the distorted projection with the divide clipped to
    [-1, 1], normalized -> pixel coordinates), on ``device``.  A subject's
    sequences go to the device as one array (the arithmetic is per joint,
    so this changes no value) and come back split by sequence."""
    device = dhaug_torch.resolve_device(str(device))
    table = torch.as_tensor(H36M_32_To_16_Table, device=device)
    positions_2d = {}
    with torch.no_grad():
        for subject, actions in positions_3d.items():
            positions_2d[subject] = {}
            if not actions:
                continue
            pose16 = torch.as_tensor(np.concatenate(list(actions.values())),
                                     device=device)[:, table]
            ends = np.cumsum([len(p) for p in actions.values()])[:-1]
            per_camera = [np.split(image_coordinates(
                project_to_2d(world_to_camera(pose16, R, t), intr[None]), w, h).cpu().numpy(),
                ends) for R, t, intr, w, h in _camera_tensors(subject, device)]
            for i, action in enumerate(actions):
                positions_2d[subject][action] = [cam[i] for cam in per_camera]
    return positions_2d


def _require_numpy(tree, where: str) -> None:
    """Only numpy arrays may go into the pickled npz objects: a tensor
    there makes the file unreadable without torch."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            _require_numpy(v, f"{where}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            _require_numpy(v, f"{where}[{i}]")
    elif not isinstance(tree, np.ndarray):
        raise TypeError(f"{where} is a {type(tree).__name__}, not a numpy array")


def write_outputs(positions_3d: dict, positions_2d: dict, out_dir: str = ".") -> tuple:
    """``data_3d_h36m.npz`` and ``data_2d_h36m_gt.npz`` in ``out_dir``, in
    the reference's pickled layout; the 2D file carries the processed
    16-joint skeleton's size and left/right symmetry groups as
    ``metadata``.  Returns the two paths."""
    _require_numpy(positions_3d, "positions_3d")
    _require_numpy(positions_2d, "positions_2d")
    path_3d = os.path.join(out_dir, f"{OUTPUT_3D}.npz")
    path_2d = os.path.join(out_dir, f"{OUTPUT_2D}.npz")
    print(f"==> Saving {path_3d} ...")
    np.savez_compressed(path_3d, positions_3d=positions_3d)
    metadata = {
        "num_joints": len(H36M_32_To_16_Table),
        "keypoints_symmetry": [list(JOINTS_LEFT_16), list(JOINTS_RIGHT_16)],
    }
    print(f"==> Saving {path_2d} ...")
    np.savez_compressed(path_2d, positions_2d=positions_2d, metadata=metadata)
    return path_3d, path_2d


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--from-archive", default="", type=str)
    ap.add_argument("--from-source", default="", type=str)
    ap.add_argument("--device", default="cuda", type=str)
    args = ap.parse_args(argv)
    device = dhaug_torch.resolve_device(args.device)

    print("==> Collecting 3D poses...")
    positions_3d = collect_3d(args)
    print(f"==> Computing ground-truth 2D by camera projection on {device}...")
    t0 = time.perf_counter()
    positions_2d = project_positions_2d(positions_3d, device)
    seconds = time.perf_counter() - t0
    paths = write_outputs(positions_3d, positions_2d)
    frames = sum(len(p) for actions in positions_3d.values() for p in actions.values())
    print(f"Done: {frames} frames.")
    return {"paths": paths, "frames": frames, "projection_seconds": seconds}


if __name__ == "__main__":
    main(sys.argv[1:])
