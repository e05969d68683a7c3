"""Offline DH-skeleton viewer: render FK poses to a PNG.

Port of ``scripts/visualize_fk.py``, the replacement for the reference's
interactive Qt slider tool (models_Fk_GAN/visual_Fk_DH_byQt.py +
main_qt_visual.py): pass joint angles on the command line, or sweep one of
the 33 chain-packed angles over the traditional augmenter's range, and get
a grid of rendered skeletons.

    python -m dhaug_torch.visualize_fk --out fk.png        # zero-angle skeleton
    python -m dhaug_torch.visualize_fk --sweep 3 --out knee.png
    python -m dhaug_torch.visualize_fk --angles 0,0,30,-60 --out pose.png --device cpu

Every pose of the grid goes through one ``ops/fk_cuda.fk_world_pose_16``
call: on the card that is one launch of the FK kernel B1, on the CPU the
plain FK.  Runs on CUDA unless ``--device cpu`` is given; ``--device cuda``
without a card raises.  The grid is drawn by ``utils/viz.plot_pose_grid_3d``
(matplotlib) or, where matplotlib is absent, by this module's Pillow
renderer; the line the tool prints names the renderer used.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

import dhaug_torch
from dhaug_torch.gan.traditional import TRAD_HI, TRAD_LO, _PACK_34_TO_33
from dhaug_torch.ops import fk_cuda
from dhaug_torch.ops.fk import CANONICAL_BONE_LEN, N_CHAIN_ANGLES
from dhaug_torch.utils.viz import _LEFT_EDGES, SKELETON_EDGES_16, plot_pose_grid_3d


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--angles", default="", type=str,
                    help="comma-separated chain-packed angles (deg), up to 33")
    ap.add_argument("--sweep", default=-1, type=int,
                    help="sweep this angle index over its traditional range")
    ap.add_argument("--global_rot", default="0,0,0", type=str)
    ap.add_argument("--bone_len", default="", type=str,
                    help="comma-separated 15 bone lengths (default canonical)")
    ap.add_argument("--out", default="fk_pose.png", type=str)
    ap.add_argument("--steps", default=8, type=int)
    ap.add_argument("--device", default="cuda", type=str, help="cuda or cpu")
    args = ap.parse_args(argv)
    floats = lambda text: [float(x) for x in text.split(",")] if text else []
    args.angles, args.global_rot = floats(args.angles), floats(args.global_rot)
    args.bone_len = floats(args.bone_len) or list(CANONICAL_BONE_LEN)
    if len(args.angles) > N_CHAIN_ANGLES or len(args.global_rot) != 3 \
            or len(args.bone_len) != 15:
        ap.error("--angles takes up to 33 values, --global_rot 3, --bone_len 15")
    if not -1 <= args.sweep < N_CHAIN_ANGLES or args.steps < 1:
        ap.error(f"--sweep must be an angle index in [0, {N_CHAIN_ANGLES}), --steps >= 1")
    return args


def sweep_angles(index: int, steps: int):
    """(steps, 33) angles sweeping chain angle ``index`` over its
    traditional range [lo, hi] (degrees), every other angle 0; and (lo, hi)."""
    table_idx = _PACK_34_TO_33[index]
    lo, hi = float(TRAD_LO[table_idx]), float(TRAD_HI[table_idx])
    angles = np.zeros((steps, N_CHAIN_ANGLES), np.float32)
    angles[:, index] = np.linspace(lo, hi, steps)
    return angles, (lo, hi)


def pose_grid_pil(poses16: np.ndarray, path: str, cols: int = 4, title: str = "",
                  cell: int = 240) -> str:
    """``plot_pose_grid_3d`` without matplotlib: each pose seen along
    matplotlib's default 3D view (elevation 30, azimuth -60 degrees),
    orthographically, scaled to fill its cell, in the same colours and grid."""
    from PIL import Image, ImageDraw

    n = min(len(poses16), cols * cols)
    top = 24 if title else 0
    img = Image.new("RGB", (cols * cell, -(-n // cols) * cell + top), "white")
    draw = ImageDraw.Draw(img)
    if title:
        draw.text((6, 6), title, fill="black")
    az, el = np.radians(-60.0), np.radians(30.0)
    right = np.array([-np.sin(az), np.cos(az), 0.0])
    up = np.array([-np.cos(az) * np.sin(el), -np.sin(az) * np.sin(el), np.cos(el)])
    for i in range(n):
        xy = np.stack([poses16[i] @ right, poses16[i] @ up], axis=-1)
        lo, hi = xy.min(axis=0), xy.max(axis=0)
        xy = (xy - (lo + hi) / 2) * (0.8 * cell / max(float((hi - lo).max()), 1e-6))
        cx, cy = (i % cols + 0.5) * cell, top + (i // cols + 0.5) * cell
        pts = [(cx + x, cy - y) for x, y in xy]
        for a, b in SKELETON_EDGES_16:
            color = (31, 119, 180) if (a, b) in _LEFT_EDGES else (214, 39, 40)
            draw.line([pts[a], pts[b]], fill=color, width=3)
        for x, y in pts:
            draw.ellipse([x - 2, y - 2, x + 2, y + 2], fill="black")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    img.save(path)
    return path


def main(argv=None) -> dict:
    """Render the poses; returns the PNG's path, the renderer used, the
    poses (N, 16, 3) on the host, their angles, the sweep's range (None
    without ``--sweep``) and the B1 launches made."""
    args = parse_args(argv)
    device = dhaug_torch.resolve_device(args.device)
    sweep_range = None
    if args.sweep >= 0:
        angles, sweep_range = sweep_angles(args.sweep, args.steps)
        print(f"sweeping chain angle {args.sweep} over [{sweep_range[0]}, {sweep_range[1]}] deg")
    else:
        angles = np.zeros((1, N_CHAIN_ANGLES), np.float32)
        angles[0, :len(args.angles)] = args.angles

    n = angles.shape[0]
    rows = lambda values: torch.tensor(values, dtype=torch.float32,
                                       device=device).expand(n, -1).contiguous()
    before = fk_cuda.FWD_LAUNCHES
    with torch.no_grad():
        poses = fk_cuda.fk_world_pose_16(torch.as_tensor(angles, device=device),
                                         rows(args.bone_len), rows(args.global_rot),
                                         rows([0.0, 0.0, 0.0]))
    launches = fk_cuda.FWD_LAUNCHES - before
    poses = poses.cpu().numpy()
    try:
        path, renderer = plot_pose_grid_3d(poses, args.out, title="DH-FK skeleton"), "matplotlib"
    except ImportError:
        path, renderer = pose_grid_pil(poses, args.out, title="DH-FK skeleton"), "pillow"
    print(f"wrote {path} ({renderer}): {n} poses, FK on {device}, {launches} B1 launch(es)")
    return {"path": path, "renderer": renderer, "poses": poses, "angles": angles, "sweep_range": sweep_range,
            "launches": launches}


if __name__ == "__main__":
    main(sys.argv[1:])
