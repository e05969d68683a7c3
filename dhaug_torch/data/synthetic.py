"""Synthetic H36M/3DHP-format dataset fixtures.

Port of ``dhaug_tpu/data/synthetic.py``.  The real Human3.6M archives are
license-gated, so this module writes small datasets in the exact npz
formats the reference's prep scripts emit (``data/data_3d_h36m.npz``,
``data/data_2d_h36m_gt.npz``, ``data/data_2d_h36m_cpn.npz``,
``data_extra/test_set/test_3dhp.npz`` and
``data_extra/bone_length_npy/hm36s15678_bl_templates.npy``).  Poses come
from the DH forward kinematics itself (the plain 32-slot ``ops/fk``, on the
device given), so they are plausible and bone-length consistent.

Every draw comes from ``np.random.default_rng`` in the JAX package's order,
so a port run and a JAX run seeded alike write the same files, up to the
FK's fp32 rounding.
"""
from __future__ import annotations

import os

import numpy as np
import torch

import dhaug_torch
from dhaug_torch.data import h36m
from dhaug_torch.data.loaders import np_world_to_camera
from dhaug_torch.ops.bones import bone_lengths, bone_vectors_tree
from dhaug_torch.ops.fk import CANONICAL_BONE_LEN, fk_world_pose

# Modest angle ranges keep the synthetic crowd within each camera's view.
_ANGLE_STD = 18.0


def _np_project(X: np.ndarray, intr9: np.ndarray) -> np.ndarray:
    f, c, k, p = intr9[:2], intr9[2:4], intr9[4:7], intr9[7:9]
    XX = np.clip(X[..., :2] / X[..., 2:], -1, 1)
    r2 = np.sum(XX ** 2, axis=-1, keepdims=True)
    radial = 1 + np.sum(k * np.concatenate([r2, r2 ** 2, r2 ** 3], axis=-1),
                        axis=-1, keepdims=True)
    tan = np.sum(p * XX, axis=-1, keepdims=True)
    return f * (XX * (radial + tan) + p * r2) + c


def random_fk_poses(rng: np.random.Generator, n: int, device="cuda") -> np.ndarray:
    """(n, 32, 3) world poses in the H36M 32-slot layout, sampled from the DH
    model around standing height; the FK runs on ``device``."""
    angles = rng.normal(0.0, _ANGLE_STD, size=(n, 33)).astype(np.float32)
    bl = np.asarray(CANONICAL_BONE_LEN, np.float32)
    bl = bl[None] * rng.uniform(0.9, 1.1, size=(n, 1)).astype(np.float32)
    grot = np.stack([
        rng.uniform(-15, 15, size=n),
        rng.uniform(-15, 15, size=n),
        rng.uniform(-180, 180, size=n),
    ], axis=-1).astype(np.float32)
    root = np.stack([
        rng.uniform(-1.5, 1.5, size=n),
        rng.uniform(-1.5, 1.5, size=n),
        rng.uniform(0.8, 1.2, size=n),
    ], axis=-1).astype(np.float32)
    with torch.no_grad():
        pose32 = fk_world_pose(*(torch.as_tensor(a, device=device)
                                 for a in (angles, bl, grot, root)))
    return pose32.cpu().numpy()


def make_h36m_npz(root_dir: str, n_frames_per_action: int = 120,
                  subjects=("S1", "S5", "S6", "S7", "S8", "S9", "S11"),
                  actions=("Walking 1", "Eating 1"), seed: int = 0, device="cuda"):
    """Write data/data_3d_h36m.npz and data/data_2d_h36m_gt.npz under
    ``root_dir`` in the reference formats.  Returns the two paths."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root_dir, "data"), exist_ok=True)

    positions_3d = {}
    positions_2d = {}
    for subject in subjects:
        positions_3d[subject] = {}
        positions_2d[subject] = {}
        for action in actions:
            # random FK poses + a small random walk of the root, so the
            # chunked/video samplers see coherent sequences
            pose32 = random_fk_poses(rng, n_frames_per_action, device)
            drift = np.cumsum(rng.normal(0, 0.005, size=(n_frames_per_action, 1, 3)),
                              axis=0).astype(np.float32)
            pose32 = pose32 + drift
            positions_3d[subject][action] = pose32.astype(np.float32)

            # GT 2D per camera, in pixels (create_2d_data normalizes at
            # load time)
            cams_2d = []
            pose16 = pose32[:, np.asarray(h36m.H36M_32_To_16_Table)]
            for cam_idx in range(4):
                cam = h36m.normalized_camera(subject, cam_idx)
                pos_cam = np_world_to_camera(pose16, cam["orientation"], cam["translation"])
                pos_cam[..., 2] = np.maximum(pos_cam[..., 2], 1.0)  # keep in front
                pix_norm = _np_project(pos_cam, cam["intrinsic"])
                w, hgt = cam["res_w"], cam["res_h"]
                pix = pix_norm.copy()
                pix[..., 0] = (pix_norm[..., 0] + 1) * w / 2
                pix[..., 1] = (pix_norm[..., 1] + hgt / w) * w / 2
                cams_2d.append(pix.astype(np.float32))
            positions_2d[subject][action] = cams_2d

    p3d = os.path.join(root_dir, "data", "data_3d_h36m.npz")
    p2d = os.path.join(root_dir, "data", "data_2d_h36m_gt.npz")
    np.savez_compressed(p3d, positions_3d=positions_3d)
    np.savez_compressed(p2d, positions_2d=positions_2d)
    return p3d, p2d


def make_det_2d_npz(root_dir: str, keypoints: str = "cpn",
                    noise_px: float = 3.0, seed: int = 3) -> str:
    """Write data/data_2d_h36m_<keypoints>.npz: the GT pixel keypoints
    perturbed by Gaussian detector noise, the detected-2D file the
    reference's posenet real pass reads (utils/data_utils.py:11-23).  Needs
    data_2d_h36m_gt.npz (make_h36m_npz)."""
    rng = np.random.default_rng(seed)
    gt_path = os.path.join(root_dir, "data", "data_2d_h36m_gt.npz")
    gt = np.load(gt_path, allow_pickle=True)["positions_2d"].item()
    det = {}
    for subject, actions in gt.items():
        det[subject] = {}
        for action, cams in actions.items():
            det[subject][action] = [
                (np.asarray(c, np.float32)
                 + rng.normal(0.0, noise_px, np.asarray(c).shape).astype(np.float32))
                for c in cams]
    path = os.path.join(root_dir, "data", f"data_2d_h36m_{keypoints}.npz")
    np.savez_compressed(path, positions_2d=det)
    return path


def make_3dhp_npz(root_dir: str, n_frames: int = 2929, seed: int = 1, device="cuda"):
    """Write data_extra/test_set/test_3dhp.npz: ('pose3d' (N,16,3) root-centred
    camera-space metres, 'pose2d' (N,16,2) normalized screen coords)."""
    rng = np.random.default_rng(seed)
    out_dir = os.path.join(root_dir, "data_extra", "test_set")
    os.makedirs(out_dir, exist_ok=True)

    pose32 = random_fk_poses(rng, n_frames, device)
    pose16 = pose32[:, np.asarray(h36m.H36M_32_To_16_Table)]
    cam = h36m.normalized_camera("S1", 0)
    pos_cam = np_world_to_camera(pose16, cam["orientation"], cam["translation"])
    pos_cam[..., 2] = np.maximum(pos_cam[..., 2], 1.0)
    pose2d = _np_project(pos_cam, cam["intrinsic"]).astype(np.float32)
    pose3d = (pos_cam - pos_cam[:, :1]).astype(np.float32)
    path = os.path.join(out_dir, "test_3dhp.npz")
    np.savez_compressed(path, pose3d=pose3d, pose2d=pose2d)
    return path


def make_bone_templates(root_dir: str, n_templates: int = 200, seed: int = 2,
                        device="cuda"):
    """Write data_extra/bone_length_npy/hm36s15678_bl_templates.npy: (T, 15)
    bone lengths in H36M kinematic-tree order for the bone re-skin."""
    rng = np.random.default_rng(seed)
    out_dir = os.path.join(root_dir, "data_extra", "bone_length_npy")
    os.makedirs(out_dir, exist_ok=True)

    pose32 = random_fk_poses(rng, n_templates, device)
    pose16 = pose32[:, np.asarray(h36m.H36M_32_To_16_Table)]
    with torch.no_grad():
        lens = bone_lengths(bone_vectors_tree(torch.as_tensor(pose16, device=device)))
    path = os.path.join(out_dir, "hm36s15678_bl_templates.npy")
    np.save(path, lens.cpu().numpy().astype(np.float32))
    return path


def ensure_synthetic_dataset(root_dir: str, n_frames_per_action: int = 120,
                             seed: int = 0, device="cuda"):
    """Write each fixture file that is absent; the ones present stay as
    they are.  ``device`` runs the FK (``cuda`` raises without a card)."""
    device = dhaug_torch.resolve_device(str(device))
    p3d = os.path.join(root_dir, "data", "data_3d_h36m.npz")
    if not os.path.exists(p3d):
        make_h36m_npz(root_dir, n_frames_per_action, seed=seed, device=device)
    det = os.path.join(root_dir, "data", "data_2d_h36m_cpn.npz")
    if not os.path.exists(det):
        make_det_2d_npz(root_dir, "cpn", seed=seed + 3)
    dhp = os.path.join(root_dir, "data_extra", "test_set", "test_3dhp.npz")
    if not os.path.exists(dhp):
        make_3dhp_npz(root_dir, seed=seed + 1, device=device)
    tmpl = os.path.join(root_dir, "data_extra", "bone_length_npy",
                        "hm36s15678_bl_templates.npy")
    if not os.path.exists(tmpl):
        make_bone_templates(root_dir, seed=seed + 2, device=device)
    return root_dir


FIXTURE_FILES = (
    "data/data_3d_h36m.npz", "data/data_2d_h36m_gt.npz", "data/data_2d_h36m_cpn.npz",
    "data_extra/test_set/test_3dhp.npz",
    "data_extra/bone_length_npy/hm36s15678_bl_templates.npy")


def _max_abs_diff(a, b) -> float:
    """Max |a - b| over two arrays, or over two equally nested
    {subject: {action: array or [camera arrays]}} trees."""
    if isinstance(a, dict):
        if set(a) != set(b):
            raise ValueError(f"keys differ: {sorted(a)} vs {sorted(b)}")
        return max(_max_abs_diff(a[k], b[k]) for k in a)
    if isinstance(a, list):
        if len(a) != len(b):
            raise ValueError(f"lengths differ: {len(a)} vs {len(b)}")
        return max(_max_abs_diff(x, y) for x, y in zip(a, b))
    if a.shape != b.shape:
        raise ValueError(f"shapes differ: {a.shape} vs {b.shape}")
    return float(np.abs(a.astype(np.float64) - b.astype(np.float64)).max())


def fixture_differences(root_a: str, root_b: str) -> dict:
    """The largest absolute difference of each array of the fixture's five
    files between two dataset directories, keyed ``<file>/<array>`` (the
    template file's array is ``lengths``); raises ValueError when their
    structures differ."""
    out = {}
    for rel in FIXTURE_FILES:
        a, b = (os.path.join(root, rel) for root in (root_a, root_b))
        name = os.path.basename(rel)
        if rel.endswith(".npy"):
            out[f"{name}/lengths"] = _max_abs_diff(np.load(a), np.load(b))
            continue
        za, zb = np.load(a, allow_pickle=True), np.load(b, allow_pickle=True)
        for key in za.files:
            xa, xb = za[key], zb[key]
            if xa.dtype == object:
                xa, xb = xa.item(), xb.item()
            out[f"{name}/{key}"] = _max_abs_diff(xa, xb)
    return out
