"""The numbers that decide ``correct``: gaps between what the timed path
produced and what the reference computes from the same seed.

Training (the first three steps, each a chunk of the window's own size
through the window's own chunk call, from a run's fifth iteration on):

* ``loss_gap`` -- the first iteration's 3D and 2D critics' mean real and
  fake scores and the first step's posenet passes' mean losses, the
  largest |program - reference| over max(|reference|, ``LOSS_FLOOR``);
* ``motion_gap`` -- the same of the first iteration's two motion critics'
  Wasserstein estimates (each a mean over four updates, three of them read
  after an Adam step: hence a limit of its own);
* ``moment_gap_median`` -- each parameter's Adam first-moment norm after
  the first step, |program - reference| over the larger of the
  reference's norm of that leaf and of its net's median leaf: the median
  leaf's gap;
* ``change_gap`` -- each parameter's change over the three steps, the
  worst leaf's gap as above; leaves whose reference first moment is under
  a thousandth of their net's median leaf's are left out: their gradient
  is nought to rounding, and Adam moves them by round-off alone;
* ``fake_bone_gap``, ``fake_proj_gap`` -- every iteration's fake clips
  (all three steps, every batch): their bone lengths against those the
  reference scaled for them, their 2D poses against the reference
  projection of their 3D poses through the reference's drawn camera, and
  their intrinsics against that camera's.  Neither depends on the nets'
  weights, so both hold every batch, the later ones too.

Reported beside them and not compared (``PERF.md`` gives the readings):
the generator's cost of the first iteration, the later iterations'
critic scores and the worst leaf's moment gap, which are read after Adam
steps in which elements whose gradient is rounding noise have moved by the
learning rate either way, and the median leaf's change.

Synthesis (one dispatch a window chunk, drawn from the seed):

* ``pose_gap_mean`` -- mean |program - reference| of the camera-space
  poses, metres;
* ``pose_gap_worst_rel`` -- the largest over the poses of the mean joint
  distance between program and reference, each pose taken relative to its
  root joint (the root's own place swings with the trunk's rounding
  through tanh x 10 m), metres: one wrong pose of many shows here;
* ``bone_gap_max`` -- the largest gap between a synthesized pose's bone
  lengths and the scaled lengths it was asked for, metres;
* ``proj_gap_max`` -- the largest gap between a 2D pose and the reference
  projection of the program's own 3D pose through the drawn camera, and
  between the intrinsics returned and the drawn camera's.
"""
from __future__ import annotations

import math
import statistics

import torch

LOSS_FLOOR = 1.0
NOUGHT = 1e-3


def _per_net(norms: dict) -> dict:
    by_net = {}
    for leaf, v in norms.items():
        by_net.setdefault(leaf.split(".", 1)[0], []).append(v)
    return {net: statistics.median(vals) for net, vals in by_net.items()}


def leaf_gap(program: dict, reference: dict, skip=()) -> float:
    """Worst leaf of |norm_p - norm_r| / max(norm_r, its net's median)."""
    median = _per_net(reference)
    worst = 0.0
    for leaf, r in reference.items():
        if leaf in skip:
            continue
        p = program.get(leaf, math.nan)
        scale = max(r, median[leaf.split(".", 1)[0]])
        worst = max(worst, abs(p - r) / scale if scale > 0 else abs(p - r))
        if math.isnan(p):
            return math.nan
    return worst


def nought_leaves(reference_moments: dict) -> set:
    median = _per_net(reference_moments)
    return {leaf for leaf, v in reference_moments.items()
            if v < NOUGHT * median[leaf.split(".", 1)[0]]}


def median_leaf_gap(program: dict, reference: dict, skip=()) -> float:
    """The median leaf's |norm_p - norm_r| / max(norm_r, its net's median)."""
    median = _per_net(reference)
    gaps = [abs(program.get(leaf, math.nan) - r) / max(r, median[leaf.split(".", 1)[0]], 1e-30)
            for leaf, r in reference.items() if leaf not in skip]
    return statistics.median(gaps)


def loss_gap(program: list, reference: list, rows, terms) -> float:
    """The largest |program - reference| / max(|reference|, LOSS_FLOOR)
    over the loss records ``rows`` at indices ``terms``."""
    worst = 0.0
    for b in rows:
        for i in terms:
            p, r = program[b][i], reference[b][i]
            if math.isnan(r) and math.isnan(p):
                continue
            if math.isnan(p) or math.isnan(r):
                return math.nan
            worst = max(worst, abs(p - r) / max(abs(r), LOSS_FLOOR))
    return worst


@torch.no_grad()
def fake_gaps(program_fakes: list, reference: dict, bone_lengths_fk, project_to_2d) -> dict:
    """Every fake pose of every iteration: its bone lengths against those
    the reference scaled for it, and its 2D pose and intrinsics against the
    reference's camera through the reference projection of the program's
    own 3D pose."""
    f3d = torch.cat([f[0] for f in program_fakes])
    f2d = torch.cat([f[1] for f in program_fakes])
    intr = torch.cat([f[2] for f in program_fakes])
    bones = torch.cat(reference["bones"])
    ref_intr = torch.cat(reference["intrs"])
    if f3d.shape[0] != bones.shape[0] or intr.shape != ref_intr.shape:
        return {"fake_bone_gap": math.nan, "fake_proj_gap": math.nan}
    frames = f3d.numel() // (bones.shape[0] * 48)
    bones = bones.repeat_interleave(frames, dim=0)
    flat3d, flat2d = f3d.reshape(-1, 16, 3), f2d.reshape(-1, 16, 2)
    flat_intr = ref_intr.reshape(-1, 9)
    return {"fake_bone_gap": float((bone_lengths_fk(flat3d) - bones).abs().max()),
            "fake_proj_gap": max(float((flat2d - project_to_2d(flat3d, flat_intr)).abs().max()),
                                 float((intr - ref_intr).abs().max()))}


def training_gaps(program: dict, reference: dict, terms: dict, bone_lengths_fk,
                  project_to_2d) -> dict:
    """The training check's numbers; ``terms`` names the loss records'
    indices by what computes them."""
    if len(program["losses"]) != len(reference["losses"]):
        return {k: math.nan for k in ("loss_gap", "motion_gap", "moment_gap_median",
                                      "change_gap", "fake_bone_gap", "fake_proj_gap")}
    lp, lr = program["losses"], reference["losses"]
    scores = terms["critic3d"] + terms["critic2d"] + terms["motion"]
    nought = nought_leaves(reference["moments"])
    return {"loss_gap": loss_gap(lp, lr, [0], terms["critic3d"] + terms["critic2d"]
                                 + terms["posenet"]),
            "motion_gap": loss_gap(lp, lr, [0], terms["motion"]),
            "generator_gap": loss_gap(lp, lr, [0], terms["generator"]),
            "score_gap_late": loss_gap(lp, lr, range(1, len(lr)), scores),
            "moment_gap": leaf_gap(program["moments"], reference["moments"]),
            "moment_gap_median": median_leaf_gap(program["moments"], reference["moments"]),
            "change_gap": leaf_gap(program["changes"], reference["changes"], nought),
            "change_gap_median": median_leaf_gap(program["changes"], reference["changes"],
                                                 nought),
            **fake_gaps(program["fakes"], reference, bone_lengths_fk, project_to_2d)}


@torch.no_grad()
def synthesis_gaps(program_rows: list, reference_rows: list, bone_lengths_fk,
                   project_to_2d) -> dict:
    """``program_rows`` (cam3d, pose2d, intr) and ``reference_rows``
    (cam3d, pose2d, intr, scaled bones) of the same dispatches."""
    total, count, bone, proj, worst_rel = 0.0, 0, 0.0, 0.0, 0.0
    for (p3, p2, pi), (r3, _, ri, bones) in zip(program_rows, reference_rows):
        total += float((p3 - r3).abs().sum())
        count += p3.numel()
        rel = (p3 - p3[:, :1]) - (r3 - r3[:, :1])
        worst_rel = max(worst_rel, float(rel.norm(dim=-1).mean(dim=-1).max()))
        bone = max(bone, float((bone_lengths_fk(p3) - bones).abs().max()))
        proj = max(proj, float((p2 - project_to_2d(p3, ri)).abs().max()),
                   float((pi - ri).abs().max()))
    if len(program_rows) != len(reference_rows) or count == 0:
        return {k: math.nan for k in ("pose_gap_mean", "pose_gap_worst_rel", "bone_gap_max",
                                      "proj_gap_max")}
    return {"pose_gap_mean": total / count, "pose_gap_worst_rel": worst_rel,
            "bone_gap_max": bone, "proj_gap_max": proj}


def judge(values: dict, limits: dict) -> bool:
    """Every number that has a limit present, finite and at or under it."""
    return all(k in values and math.isfinite(values[k]) and values[k] <= limits[k]
               for k in limits)
