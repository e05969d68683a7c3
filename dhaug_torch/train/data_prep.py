"""Data preparation for the single-frame runners (port of
``dhaug_tpu/train/data_prep.py``'s ``prepare_data``, ``train_subject_list``
and ``world_pose_pool``).

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
                                      np_camera_to_world, read_3d_data)


@dataclass
class DataBundle:
    dataset: Human36mDataset     # its skeleton() builds the SemGCN graph
    train_det2d3d: PoseDataset   # posenet's real pass (2D from --keypoints)
    train_gt2d3d: PoseDataset    # what the GAN epoch re-skins
    h36m_test: PoseDataset
    mpi3d: PoseBuffer
    actions_valid: list          # one action name per H36M test frame
    # per-sequence training lists, for the traditional augmenter's pose pool
    poses_train: list
    cams_train: list


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

    poses_train, poses_train_2d, cams_train, _ = fetch(
        train_subject_list(args), dataset, keypoints, action_filter, args.downsample,
        train=True)
    poses_valid, poses_valid_2d, cams_valid, actions_valid = fetch(
        list(TEST_SUBJECTS), dataset, keypoints, action_filter, args.downsample,
        train=False)
    train_ds = PoseDataset.from_lists(poses_train, poses_train_2d, cams_train)

    mpi = np.load(os.path.join(root, "data_extra", "test_set", "test_3dhp.npz"))
    mpi3d = PoseBuffer.from_lists([mpi["pose3d"]], [mpi["pose2d"]])

    return DataBundle(
        dataset=dataset,
        train_det2d3d=train_ds,
        train_gt2d3d=PoseDataset(train_ds.poses_3d.copy(), train_ds.poses_2d.copy(),
                                 train_ds.cams.copy()),
        h36m_test=PoseDataset.from_lists(poses_valid, poses_valid_2d, cams_valid),
        mpi3d=mpi3d,
        actions_valid=[a for seq in actions_valid for a in seq],
        poses_train=poses_train,
        cams_train=cams_train,
    )


def world_pose_pool(bundle: DataBundle, max_poses: int = 20000,
                    seed: int = 0) -> np.ndarray:
    """A (P, 16, 3) pool of real world poses for the traditional augmenter
    to harvest bone lengths and roots from: each training sequence taken
    back to the world frame through its camera, at most ``max_poses`` of
    them drawn without replacement (the JAX package's numpy stream)."""
    rng = np.random.default_rng(seed)
    pool = np.concatenate([np_camera_to_world(pose_cam, cam[0, 9:13], cam[0, 13:16])
                           for pose_cam, cam in zip(bundle.poses_train, bundle.cams_train)])
    pool = pool.astype(np.float32)
    if pool.shape[0] > max_poses:
        pool = pool[rng.choice(pool.shape[0], max_poses, replace=False)]
    return pool
