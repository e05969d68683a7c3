"""Offline pose visualization (matplotlib Agg).

A numpy copy of ``dhaug_tpu/utils/viz.py`` (the port imports nothing of the
JAX package), with its eleven plotters: the reference's plotting helpers
(models_Fk_GAN/special_operate.py:212-734: 3D/2D pose grids, the 'for
paper' figures, loss curves, the DOF-angle heatmap and density, GAN video
dumps), a headless animation writer and the ``log.txt`` metric curves.
Every plotter takes host numpy arrays and writes one file.  matplotlib is
imported inside :func:`_plt`, at the first plot, so the package imports
where matplotlib is absent; ``--record_all_picture`` needs it.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

# 16-joint H36M skeleton edges for plotting
SKELETON_EDGES_16 = (
    (0, 1), (1, 2), (2, 3), (0, 4), (4, 5), (5, 6), (0, 7), (7, 8),
    (8, 9), (8, 10), (10, 11), (11, 12), (8, 13), (13, 14), (14, 15),
)
_LEFT_EDGES = {(0, 4), (4, 5), (5, 6), (8, 10), (10, 11), (11, 12)}
# The reference's paper figures colour left limbs AND the spine chain red
# (LR mask [0,0,0,1,1,1,1,1,1,1,1,1,0,0,0] over its I/J edge order,
# special_operate.py:614-616): red = left + spine, blue = right.
_PAPER_RED_EDGES = _LEFT_EDGES | {(0, 7), (7, 8), (8, 9)}


def _plt():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def plot_pose_grid_3d(poses16: np.ndarray, path: str, cols: int = 4,
                      title: str = "") -> str:
    """Grid of 3D skeleton plots; poses16 (N, 16, 3)."""
    plt = _plt()
    n = min(len(poses16), cols * cols)
    fig = plt.figure(figsize=(3 * cols, 3 * ((n + cols - 1) // cols)))
    for i in range(n):
        ax = fig.add_subplot((n + cols - 1) // cols, cols, i + 1,
                             projection="3d")
        p = poses16[i]
        for a, b in SKELETON_EDGES_16:
            color = "tab:blue" if (a, b) in _LEFT_EDGES else "tab:red"
            ax.plot([p[a, 0], p[b, 0]], [p[a, 1], p[b, 1]],
                    [p[a, 2], p[b, 2]], c=color, lw=2)
        ax.scatter(p[:, 0], p[:, 1], p[:, 2], s=4, c="k")
        ax.set_box_aspect((1, 1, 1))
        ax.set_xticks([]), ax.set_yticks([]), ax.set_zticks([])
    if title:
        fig.suptitle(title)
    fig.tight_layout()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path, dpi=80)
    plt.close(fig)
    return path


def plot_pose_grid_2d(poses16: np.ndarray, path: str, cols: int = 4,
                      title: str = "") -> str:
    """Grid of 2D skeleton plots; poses16 (N, 16, 2)."""
    plt = _plt()
    n = min(len(poses16), cols * cols)
    fig, axes = plt.subplots((n + cols - 1) // cols, cols,
                             figsize=(2.5 * cols, 2.5 * ((n + cols - 1) // cols)),
                             squeeze=False)
    for i in range(n):
        ax = axes[i // cols][i % cols]
        p = poses16[i]
        for a, b in SKELETON_EDGES_16:
            color = "tab:blue" if (a, b) in _LEFT_EDGES else "tab:red"
            ax.plot([p[a, 0], p[b, 0]], [p[a, 1], p[b, 1]], c=color, lw=2)
        ax.scatter(p[:, 0], p[:, 1], s=4, c="k")
        ax.invert_yaxis()
        ax.set_xticks([]), ax.set_yticks([])
    for j in range(n, axes.size):
        axes[j // cols][j % cols].axis("off")
    if title:
        fig.suptitle(title)
    fig.tight_layout()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path, dpi=80)
    plt.close(fig)
    return path


def plot_paper_pose3d_row(poses16: np.ndarray, path: str, n: int = 3,
                          title: str = "") -> str:
    """The 'for paper' clean 3D figure (special_operate.py:604-676
    my_visual_3D_pos_for_parer): one row of ``n`` axis-free skeletons —
    white panes, no ticks, red/blue limb colouring, tight per-pose 3D box
    centred on the hip.  poses16 (N, 16, 3); the first ``n`` poses are drawn
    (the reference hardcodes indices 50-52 of its buffer; callers pass the
    slice they want)."""
    plt = _plt()
    n = min(n, len(poses16))
    fig = plt.figure(figsize=(6.4 * n, 10.8))
    for i in range(n):
        p = np.asarray(poses16[i])
        ax = fig.add_subplot(1, n, i + 1, projection="3d")
        radius = 1.7
        ax.set_xlim3d([p[0, 0] - radius / 2, p[0, 0] + radius / 2])
        ax.set_ylim3d([p[0, 1] - radius / 2, p[0, 1] + radius / 2])
        ax.set_zlim3d([p[0, 2] - radius / 2, p[0, 2] + radius / 2])
        white = (1.0, 1.0, 1.0, 0.0)
        for axis in (ax.xaxis, ax.yaxis, ax.zaxis):
            axis.set_pane_color(white)
            axis.line.set_color(white)
        ax.set_xticks([]), ax.set_yticks([]), ax.set_zticks([])
        for a, b in SKELETON_EDGES_16:
            color = "red" if (a, b) in _PAPER_RED_EDGES else "blue"
            ax.plot([p[a, 0], p[b, 0]], [p[a, 1], p[b, 1]],
                    [p[a, 2], p[b, 2]], c=color, lw=2)
    if title:
        fig.suptitle(title)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path, dpi=80)
    plt.close(fig)
    return path


def plot_paper_pose2d(pose16: np.ndarray, path: str, title: str = "") -> str:
    """The 'for paper' clean single 2D skeleton (special_operate.py:678-734
    my_visual_2D_pos_for_paper): equal-aspect [-1, 1] box, no ticks, y
    flipped, red/blue limbs.  pose16 (16, 2)."""
    plt = _plt()
    p = np.asarray(pose16)
    fig, ax = plt.subplots(figsize=(10.8, 10.8))
    ax.set_aspect("equal")
    ax.set_xlim([-1, 1])
    ax.set_ylim([-1, 1])
    ax.set_xticks([]), ax.set_yticks([])
    for a, b in SKELETON_EDGES_16:
        color = "red" if (a, b) in _PAPER_RED_EDGES else "blue"
        ax.plot([p[a, 0], p[b, 0]], [-p[a, 1], -p[b, 1]], c=color, lw=2)
    if title:
        ax.set_title(title)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path, dpi=80)
    plt.close(fig)
    return path


def plot_fake_real_pairs_3d(fake16: np.ndarray, real16: np.ndarray,
                            path: str, n: int = 4, title: str = "") -> str:
    """Fake-vs-real pair grid: each column pairs a fake pose (top row) with a
    real pose (bottom row) — the qualitative comparison the reference
    assembles from its per-epoch fake/real paper dumps.  fake16/real16
    (N, 16, 3)."""
    plt = _plt()
    n = min(n, len(fake16), len(real16))
    fig = plt.figure(figsize=(3.2 * n, 6.4))
    for row, poses in enumerate((fake16, real16)):
        for i in range(n):
            p = np.asarray(poses[i]) - np.asarray(poses[i])[:1]
            ax = fig.add_subplot(2, n, row * n + i + 1, projection="3d")
            for a, b in SKELETON_EDGES_16:
                color = "red" if (a, b) in _PAPER_RED_EDGES else "blue"
                ax.plot([p[a, 0], p[b, 0]], [p[a, 1], p[b, 1]],
                        [p[a, 2], p[b, 2]], c=color, lw=2)
            ax.set_box_aspect((1, 1, 1))
            ax.set_xticks([]), ax.set_yticks([]), ax.set_zticks([])
            if i == 0:
                ax.set_title("fake" if row == 0 else "real", loc="left")
    if title:
        fig.suptitle(title)
    fig.tight_layout()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path, dpi=80)
    plt.close(fig)
    return path


def plot_video_strip(clip3d: np.ndarray, clip2d: Optional[np.ndarray],
                     path: str, title: str = "") -> str:
    """One row of 3D frames (+ optional 2D row) for a clip (F, 16, 3) — the
    GAN video dump (special_operate.my_visual_GAN_video)."""
    plt = _plt()
    F = clip3d.shape[0]
    rows = 2 if clip2d is not None else 1
    fig = plt.figure(figsize=(2.2 * F, 2.5 * rows))
    for f in range(F):
        ax = fig.add_subplot(rows, F, f + 1, projection="3d")
        p = clip3d[f]
        for a, b in SKELETON_EDGES_16:
            ax.plot([p[a, 0], p[b, 0]], [p[a, 1], p[b, 1]],
                    [p[a, 2], p[b, 2]], lw=1.5)
        ax.set_xticks([]), ax.set_yticks([]), ax.set_zticks([])
        if clip2d is not None:
            ax2 = fig.add_subplot(rows, F, F + f + 1)
            q = clip2d[f]
            for a, b in SKELETON_EDGES_16:
                ax2.plot([q[a, 0], q[b, 0]], [q[a, 1], q[b, 1]], lw=1.5)
            ax2.invert_yaxis()
            ax2.set_xticks([]), ax2.set_yticks([])
    if title:
        fig.suptitle(title)
    fig.tight_layout()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path, dpi=70)
    plt.close(fig)
    return path


def plot_dof_angle_heatmap(angles: np.ndarray, path: str,
                           bins: int = 73) -> str:
    """Distribution heatmap of the generator's 37 DOF/rot angles over a
    batch — special_operate.my_draw_DOF_angle_distribute (:347)."""
    plt = _plt()
    angles = np.asarray(angles)
    hist = np.stack([
        np.histogram(angles[:, d], bins=bins, range=(-182.5, 182.5))[0]
        for d in range(angles.shape[1])])
    fig, ax = plt.subplots(figsize=(10, 6))
    im = ax.imshow(hist, aspect="auto", cmap="hot",
                   extent=[-182.5, 182.5, angles.shape[1], 0])
    ax.set_xlabel("angle (deg)")
    ax.set_ylabel("DOF index")
    fig.colorbar(im)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path, dpi=80)
    plt.close(fig)
    return path


def plot_scalar_curves(history: dict, path: str, title: str = "") -> str:
    """Per-epoch scalar curves (e.g. Wasserstein distances, G cost) from a
    {name: [values...]} history — the reference's GAN loss-curve dumps
    (special_operate.py:322-344)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(8, 5))
    for name, vals in history.items():
        ax.plot(np.arange(len(vals)), vals, label=name)
    ax.set_xlabel("epoch")
    ax.legend()
    if title:
        ax.set_title(title)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path, dpi=80)
    plt.close(fig)
    return path


def render_animation(path: str, pred3d: np.ndarray,
                     gt3d: Optional[np.ndarray] = None,
                     input2d: Optional[np.ndarray] = None,
                     fps: int = 10, title: str = "") -> str:
    """Headless animation of a pose sequence: up to three synchronized
    columns — input 2D, ground-truth 3D, prediction 3D — written as a .gif
    (PillowWriter; needs no ffmpeg) or .mp4 when ffmpeg exists.

    pred3d (F, 16, 3); gt3d optional (F, 16, 3); input2d optional (F, 16, 2).
    Qualitative-video capability the reference delegates to its matplotlib
    FuncAnimation plotting stack (common/viz.py, video dumps in
    video_GAN_fun.py:590-600)."""
    plt = _plt()
    from matplotlib import animation

    F = pred3d.shape[0]
    panels = [("prediction 3D", pred3d, 3)]
    if gt3d is not None:
        panels.insert(0, ("ground truth 3D", gt3d, 3))
    if input2d is not None:
        panels.insert(0, ("input 2D", input2d, 2))
    n = len(panels)
    fig = plt.figure(figsize=(4 * n, 4.2))
    axes, artists = [], []
    for i, (name, data, dim) in enumerate(panels):
        if dim == 3:
            ax = fig.add_subplot(1, n, i + 1, projection="3d")
            r = float(np.abs(data - data[:, :1]).max()) + 1e-6
            c = data[0, 0]
            ax.set_xlim(c[0] - r, c[0] + r)
            ax.set_ylim(c[1] - r, c[1] + r)
            ax.set_zlim(c[2] - r, c[2] + r)
            ax.set_xticks([]), ax.set_yticks([]), ax.set_zticks([])
        else:
            ax = fig.add_subplot(1, n, i + 1)
            r = float(np.abs(data).max()) + 1e-6
            ax.set_xlim(-r, r), ax.set_ylim(-r, r)
            ax.invert_yaxis()
            ax.set_xticks([]), ax.set_yticks([])
        ax.set_title(name)
        lines = []
        for a, b in SKELETON_EDGES_16:
            color = "tab:blue" if (a, b) in _LEFT_EDGES else "tab:red"
            if dim == 3:
                (ln,) = ax.plot([], [], [], c=color, lw=2)
            else:
                (ln,) = ax.plot([], [], c=color, lw=2)
            lines.append((ln, a, b))
        axes.append((ax, data, dim))
        artists.append(lines)
    if title:
        fig.suptitle(title)

    def update(f):
        out = []
        for (ax, data, dim), lines in zip(axes, artists):
            p = data[f]
            for ln, a, b in lines:
                ln.set_data([p[a, 0], p[b, 0]], [p[a, 1], p[b, 1]])
                if dim == 3:
                    ln.set_3d_properties([p[a, 2], p[b, 2]])
                out.append(ln)
        return out

    anim = animation.FuncAnimation(fig, update, frames=F, blit=False)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if path.endswith(".mp4") and animation.FFMpegWriter.isAvailable():
        anim.save(path, writer=animation.FFMpegWriter(fps=fps))
    else:
        if path.endswith(".mp4"):  # no ffmpeg: fall back to gif
            path = path[:-4] + ".gif"
        anim.save(path, writer=animation.PillowWriter(fps=fps))
    plt.close(fig)
    return path


def plot_angle_pair_density(angles: np.ndarray, path: str,
                            pair: tuple = (8, 3), title: str = "") -> str:
    """Paper-figure plotter: 2-D density heatmap of one DOF pair over a
    batch of generated (or dataset) angle vectors — the reference's
    my_draw_distribute_for_paper / my_draw_original_dataset_distribute_for_paper
    (special_operate.py:420-488; default pair 8/3 = the left/right knee DOFs
    it hardcodes).  angles (N, >=max(pair)+1) in degrees."""
    plt = _plt()
    a = np.asarray(angles)
    x = np.clip(a[:, pair[0]], -180, 180)
    y = np.clip(a[:, pair[1]], -180, 180)
    hist, _, _ = np.histogram2d(x, y, bins=361, range=[[-180.5, 180.5]] * 2)
    fig, ax = plt.subplots(figsize=(6, 6))
    im = ax.imshow(np.log1p(hist.T), origin="lower", cmap="hot",
                   extent=[-180, 180, -180, 180])
    ax.set_xlabel(f"DOF {pair[0]} (deg)")
    ax.set_ylabel(f"DOF {pair[1]} (deg)")
    fig.colorbar(im, label="log(1+count)")
    if title:
        ax.set_title(title)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path, dpi=90)
    plt.close(fig)
    return path


def plot_metric_curves(logfile: str, path: str,
                       columns: Sequence[str] = ("error_h36m_p1",
                                                 "error_3dhp_p1")) -> str:
    """Loss/metric curves from a Logger log.txt (utils/log.py plot)."""
    plt = _plt()
    names = None
    rows = []
    with open(logfile) as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if names is None:
                if parts and parts[0] == "epoch":
                    names = parts
                continue
            if len(parts) == len(names):
                try:
                    rows.append([float(x) for x in parts])
                except ValueError:
                    pass
    data = np.asarray(rows)
    fig, ax = plt.subplots(figsize=(8, 5))
    for col in columns:
        if names and col in names:
            ax.plot(data[:, names.index("epoch")], data[:, names.index(col)],
                    label=col)
    ax.set_xlabel("epoch")
    ax.set_ylabel("mm")
    ax.legend()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path, dpi=80)
    plt.close(fig)
    return path
