"""Data preparation for the single-frame runner (port of
``dhaug_tpu/train/data_prep.py``'s ``prepare_data`` and
``train_subject_list``).

It reads the H36M-format npz files and the 3DHP test set from
``--data_root``.  It does not validate the dataset directory or fabricate a
synthetic one; both stay with the JAX package.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List

import numpy as np

from dhaug_torch.data.h36m import TEST_SUBJECTS, Human36mDataset
from dhaug_torch.data.loaders import (PoseBuffer, PoseDataset, create_2d_data, fetch,
                                      read_3d_data)


@dataclass
class DataBundle:
    train_det2d3d: PoseDataset   # posenet's real pass (2D from --keypoints)
    train_gt2d3d: PoseDataset    # what the GAN epoch re-skins
    h36m_test: PoseDataset
    mpi3d: PoseBuffer


def train_subject_list(args) -> List[str]:
    if args.s1only:
        return ["S1"]
    if getattr(args, "s1s5only", False):
        return ["S1", "S5"]
    return ["S1", "S5", "S6", "S7", "S8"]


def prepare_data(args) -> DataBundle:
    """Load the dataset and build the frame-level sets of the single-frame
    pipeline (one camera record per frame)."""
    if args.dataset != "h36m":
        raise KeyError("Invalid dataset")
    root = args.data_root
    dataset = read_3d_data(Human36mDataset(
        os.path.join(root, "data", f"data_3d_{args.dataset}.npz")))
    keypoints = create_2d_data(
        os.path.join(root, "data", f"data_2d_{args.dataset}_{args.keypoints}.npz"),
        dataset)

    action_filter = None if args.actions == "*" else args.actions.split(",")
    if action_filter is not None:
        action_filter = [dataset.define_actions(a)[0] for a in action_filter]

    train_ds = PoseDataset.from_lists(*fetch(
        train_subject_list(args), dataset, keypoints, action_filter, args.downsample,
        train=True))
    valid_ds = PoseDataset.from_lists(*fetch(
        list(TEST_SUBJECTS), dataset, keypoints, action_filter, args.downsample,
        train=False))

    mpi = np.load(os.path.join(root, "data_extra", "test_set", "test_3dhp.npz"))
    mpi3d = PoseBuffer.from_lists([mpi["pose3d"]], [mpi["pose2d"]])

    return DataBundle(
        train_det2d3d=train_ds,
        train_gt2d3d=PoseDataset(train_ds.poses_3d.copy(), train_ds.poses_2d.copy(),
                                 train_ds.cams.copy()),
        h36m_test=valid_ds,
        mpi3d=mpi3d,
    )
