"""Preflight validation for real dataset files.

The reference trusts whatever npz it is pointed at and fails hours into a
run (or silently trains on garbage) when a file is mm-scaled, has the wrong
joint count, or isn't normalized the way the loaders assume.  This module
checks the three input files — ``data_3d_h36m.npz``, ``data_2d_h36m_<kp>.npz``
and ``test_3dhp.npz`` (+ the bone-length template asset) — BEFORE training
starts and raises :class:`DataValidationError` with an actionable message.

A numpy copy of ``dhaug_tpu/data/validate.py`` (the port imports nothing
of the JAX package), with the same checks, messages and reports.  Pure
numpy on purpose: it runs at CLI startup, before any device work.

Expected formats (set by the prep scripts, kept byte-compatible with the
reference's — data/prepare_data_h36m.py:18-19, data_extra/
prepare_data_3dhp.py:102):

  * data_3d_h36m.npz: {'positions_3d': {subject: {action: (N, 32, 3)}}},
    world coordinates in METRES.
  * data_2d_h36m_<kp>.npz: {'positions_2d': {subject: {action: [4 cameras of
    (N, 16, 2)]}}}, PIXEL coordinates (normalized at load time).
  * test_3dhp.npz: pose3d (2929, 16, 3) root-centred camera-space metres,
    pose2d (2929, 16, 2) normalized screen coordinates.
  * hm36s15678_bl_templates.npy: (T, 15) bone lengths in metres.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np

from dhaug_torch.data.h36m import H36M_32_To_16_Table
from dhaug_torch.ops.bones import H36M_TREE_BONES


class DataValidationError(SystemExit):
    """Raised (exits the CLI) when an input file fails preflight."""

    def __init__(self, path: str, problem: str, fix: str):
        super().__init__(
            f"\n==> Preflight validation FAILED for {path}\n"
            f"    problem: {problem}\n"
            f"    fix:     {fix}")


# a standing human spans ~0.5-2.5 m; per-frame bbox diagonals far outside
# [LO, HI] metres indicate a unit problem (mm-scaled data sits near 1500)
_SCALE_LO, _SCALE_HI = 0.2, 8.0

H36M_TRAIN_SUBJECTS = ("S1", "S5", "S6", "S7", "S8")


def _bbox_diag(pose: np.ndarray) -> float:
    """Median per-frame bounding-box diagonal of (N, J, 3) poses."""
    span = pose.max(axis=1) - pose.min(axis=1)
    return float(np.median(np.linalg.norm(span, axis=-1)))


def _sample_frames(arr: np.ndarray, n: int = 256) -> np.ndarray:
    if arr.shape[0] <= n:
        return arr
    step = arr.shape[0] // n
    return arr[::step][:n]


def validate_3d_npz(path: str) -> dict:
    """Validate data_3d_h36m.npz; returns {'subjects': [...], 'n_frames': N}."""
    if not os.path.exists(path):
        raise DataValidationError(
            path, "file not found",
            "run python -m dhaug_torch.prepare_data_h36m on the official H36M "
            "release, or "
            "pass --synthetic_data true for the hermetic fixture")
    data = np.load(path, allow_pickle=True)
    if "positions_3d" not in data:
        raise DataValidationError(
            path, f"missing 'positions_3d' key (has {list(data.keys())})",
            "regenerate with python -m dhaug_torch.prepare_data_h36m (saves "
            "np.savez(..., positions_3d=...))")
    d3 = data["positions_3d"].item()
    n_frames = 0
    for subject, actions in d3.items():
        for action, pose in actions.items():
            pose = np.asarray(pose)
            if pose.ndim != 3 or pose.shape[1:] != (32, 3):
                raise DataValidationError(
                    path,
                    f"{subject}/{action!r} has shape {pose.shape}, expected "
                    "(N, 32, 3)",
                    "the 3D file must carry the raw 32-joint H36M layout "
                    "(joint removal happens at load time); 16/17-joint "
                    "exports are a different pipeline's format")
            if not np.isfinite(_sample_frames(pose)).all():
                raise DataValidationError(
                    path, f"{subject}/{action!r} contains NaN/Inf frames",
                    "re-extract the sequence from the source .cdf")
            diag = _bbox_diag(_sample_frames(pose))
            if not (_SCALE_LO < diag < _SCALE_HI):
                hint = ("values look like MILLIMETRES; divide by 1000 "
                        "(python -m dhaug_torch.prepare_data_h36m does this)"
                        if diag > _SCALE_HI else
                        "pose extents are implausibly small — check the "
                        "export scaling")
                raise DataValidationError(
                    path,
                    f"{subject}/{action!r} median pose bbox diagonal is "
                    f"{diag:.1f} (expected metres, ~0.5-2.5)",
                    hint)
            n_frames += pose.shape[0]
    missing = [s for s in H36M_TRAIN_SUBJECTS if s not in d3]
    if len(missing) == len(H36M_TRAIN_SUBJECTS):
        raise DataValidationError(
            path, f"no training subjects present (found {sorted(d3)})",
            "the training split needs S1/S5/S6/S7/S8")
    return {"subjects": sorted(d3), "n_frames": n_frames}


def validate_2d_npz(path: str, d3_path: Optional[str] = None,
                    res_w: int = 1000) -> dict:
    """Validate a data_2d_h36m_<kp>.npz (gt or detections)."""
    if not os.path.exists(path):
        raise DataValidationError(
            path, "file not found",
            "for GT: python -m dhaug_torch.prepare_data_h36m writes it; for "
            "detections "
            "name the file data_2d_h36m_<kp>.npz and pass --keypoints <kp>")
    data = np.load(path, allow_pickle=True)
    if "positions_2d" not in data:
        raise DataValidationError(
            path, f"missing 'positions_2d' key (has {list(data.keys())})",
            "save as np.savez(..., positions_2d={subject: {action: "
            "[4 cameras of (N, 16, 2) pixel keypoints]}})")
    d2 = data["positions_2d"].item()
    d3 = None
    if d3_path and os.path.exists(d3_path):
        d3 = np.load(d3_path, allow_pickle=True)["positions_3d"].item()
    for subject, actions in d2.items():
        for action, cams in actions.items():
            if len(cams) != 4:
                raise DataValidationError(
                    path,
                    f"{subject}/{action!r} has {len(cams)} cameras, "
                    "expected 4",
                    "H36M records every action with 4 cameras; the loaders "
                    "index them positionally")
            for ci, kps in enumerate(cams):
                kps = np.asarray(kps)
                if kps.ndim != 3 or kps.shape[1:] != (16, 2):
                    fix = ("16-joint H36M layout expected; 17-joint "
                           "VideoPose3D-style detections must be converted "
                           "(drop the nose, remap to the H36M_32_To_16 "
                           "ordering)" if kps.ndim == 3 and
                           kps.shape[1] == 17 else
                           "each camera entry must be (N, 16, 2) pixel "
                           "keypoints")
                    raise DataValidationError(
                        path,
                        f"{subject}/{action!r} cam{ci} has shape "
                        f"{kps.shape}, expected (N, 16, 2)", fix)
                sample = _sample_frames(kps)
                span = float(np.median(sample.max(axis=(1, 2))
                                       - sample.min(axis=(1, 2))))
                if span < 10.0:
                    raise DataValidationError(
                        path,
                        f"{subject}/{action!r} cam{ci} coordinate span is "
                        f"{span:.3f} — looks ALREADY normalized to [-1, 1]",
                        "store PIXEL coordinates; normalization happens at "
                        "load time (create_2d_data) against each camera's "
                        "resolution")
                if np.abs(sample).max() > 20.0 * res_w:
                    raise DataValidationError(
                        path,
                        f"{subject}/{action!r} cam{ci} has coordinates up "
                        f"to {np.abs(sample).max():.0f} px "
                        f"(resolution ~{res_w})",
                        "check the detector's coordinate frame/scaling")
                if d3 is not None and subject in d3 and action in d3[subject]:
                    n3 = np.asarray(d3[subject][action]).shape[0]
                    if kps.shape[0] < n3:
                        raise DataValidationError(
                            path,
                            f"{subject}/{action!r} cam{ci} has "
                            f"{kps.shape[0]} frames but the 3D file has "
                            f"{n3}",
                            "2D must cover every 3D frame (extra trailing "
                            "2D frames are tolerated and trimmed at load)")
    return {"subjects": sorted(d2)}


def validate_3dhp_npz(path: str) -> dict:
    if not os.path.exists(path):
        raise DataValidationError(
            path, "file not found",
            "run python -m dhaug_torch.prepare_data_3dhp (expects SPIN's "
            "mpi_inf_3dhp npz), or --synthetic_data true")
    data = np.load(path)
    for key, last in (("pose3d", 3), ("pose2d", 2)):
        if key not in data:
            raise DataValidationError(
                path, f"missing '{key}' key (has {list(data.keys())})",
                "regenerate with python -m dhaug_torch.prepare_data_3dhp")
        arr = data[key]
        if arr.ndim != 3 or arr.shape[1] != 16 or arr.shape[2] != last:
            raise DataValidationError(
                path, f"'{key}' has shape {arr.shape}, expected "
                f"(N, 16, {last})",
                "the 3DHP test set uses the 16-joint H36M layout "
                "(python -m dhaug_torch.prepare_data_3dhp reorders SPIN's 24)")
    p3 = data["pose3d"]
    if np.abs(p3[:, 0]).max() > 1e-3:
        raise DataValidationError(
            path, "pose3d is not root-centred (joint 0 must be the origin)",
            "subtract the hip: pose3d -= pose3d[:, :1]")
    diag = _bbox_diag(_sample_frames(p3))
    if not (_SCALE_LO < diag < _SCALE_HI):
        raise DataValidationError(
            path, f"pose3d median bbox diagonal is {diag:.1f} "
            "(expected metres)",
            "divide by 1000 if the export is in millimetres")
    if np.abs(_sample_frames(data["pose2d"])).max() > 10.0:
        raise DataValidationError(
            path, "pose2d looks like PIXEL coordinates",
            "store normalized screen coordinates (the prep script "
            "normalizes against the 2048x2048 3DHP frames)")
    return {"n_frames": int(p3.shape[0])}


def validate_bone_templates(path: str,
                            d3_path: Optional[str] = None) -> dict:
    if not os.path.exists(path):
        raise DataValidationError(
            path, "file not found",
            "drop in the reference's hm36s15678_bl_templates.npy or "
            "generate one with dhaug_torch.data.synthetic.make_bone_templates")
    tmpl = np.load(path)
    if tmpl.ndim != 2 or tmpl.shape[1] != 15:
        raise DataValidationError(
            path, f"shape {tmpl.shape}, expected (T, 15)",
            "15 bone lengths per template, H36M kinematic-tree order")
    if (tmpl <= 0).any():
        raise DataValidationError(
            path, "non-positive bone lengths present",
            "bone lengths must be positive metres")
    total = float(np.median(tmpl.sum(axis=1)))
    if not (1.0 < total < 10.0):
        raise DataValidationError(
            path, f"median skeleton total length {total:.1f} "
            "(expected ~3-5 m)",
            "divide by 1000 if the templates are in millimetres")
    out = {"n_templates": int(tmpl.shape[0])}
    # bone-length plausibility vs the actual 3D data: re-skinning with these
    # templates must not rescale the skeleton by more than ~3x
    if d3_path and os.path.exists(d3_path):
        d3 = np.load(d3_path, allow_pickle=True)["positions_3d"].item()
        subject = next(iter(d3))
        pose32 = _sample_frames(
            np.asarray(next(iter(d3[subject].values()))), 64)
        pose16 = pose32[:, np.asarray(H36M_32_To_16_Table)]
        lens = np.stack([np.linalg.norm(pose16[:, c] - pose16[:, p], axis=-1)
                         for p, c in H36M_TREE_BONES], axis=1)
        data_total = float(np.median(lens.sum(axis=1)))
        ratio = total / max(data_total, 1e-6)
        if not (1 / 3 < ratio < 3):
            raise DataValidationError(
                path,
                f"template skeleton length {total:.2f} m vs dataset "
                f"{data_total:.2f} m (ratio {ratio:.2f})",
                "templates and dataset must share units/skeleton — "
                "harvest templates from this dataset or fix the scaling")
        out["ratio_vs_data"] = ratio
    return out


def validate_dataset_dir(root: str, keypoints: str = "gt",
                         verbose: bool = True,
                         require_templates: bool = True) -> dict:
    """Validate all input files under ``root``.  Called automatically by
    prepare_data when --synthetic_data is false; also the CLI entry
    (``python -m dhaug_torch.validate_data``).

    ``require_templates=False`` skips a MISSING bone-template asset (it is
    consumed only by the GAN re-skin path, run_Fk_GAN.py — run_baseline /
    run_evaluate never read it) but still validates one that is present."""
    d3_path = os.path.join(root, "data", "data_3d_h36m.npz")
    report = {"data_3d_h36m.npz": validate_3d_npz(d3_path)}
    p2 = os.path.join(root, "data", f"data_2d_h36m_{keypoints}.npz")
    report[os.path.basename(p2)] = validate_2d_npz(p2, d3_path)
    report["test_3dhp.npz"] = validate_3dhp_npz(
        os.path.join(root, "data_extra", "test_set", "test_3dhp.npz"))
    tmpl_path = os.path.join(root, "data_extra", "bone_length_npy",
                             "hm36s15678_bl_templates.npy")
    if require_templates or os.path.exists(tmpl_path):
        report["hm36s15678_bl_templates.npy"] = validate_bone_templates(
            tmpl_path, d3_path)
    if verbose:
        print("==> Preflight data validation passed:")
        for name, info in report.items():
            print(f"    {name}: {info}")
    return report
