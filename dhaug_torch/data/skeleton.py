"""Parent-array skeleton model and the mocap dataset base (plain numpy).

Copy of the host-side metadata the single-frame pipeline needs: a skeleton
with joint removal and parent rewiring, and the per-subject/action container
the H36M loader fills.
"""
from __future__ import annotations

import numpy as np


class Skeleton:
    def __init__(self, parents, joints_left, joints_right):
        if len(joints_left) != len(joints_right):
            raise ValueError("joints_left and joints_right differ in length")
        self._parents = np.array(parents)
        self._joints_left = list(joints_left)
        self._joints_right = list(joints_right)

    def num_joints(self) -> int:
        return len(self._parents)

    def parents(self) -> np.ndarray:
        return self._parents

    def remove_joints(self, joints_to_remove, dataset=None):
        """Remove joints, rewiring children to the removed joint's parent,
        and drop the same columns from every pose array of ``dataset``.
        Returns the kept joint indices."""
        valid_joints = [j for j in range(len(self._parents))
                        if j not in joints_to_remove]

        for i in range(len(self._parents)):
            while self._parents[i] in joints_to_remove:
                self._parents[i] = self._parents[self._parents[i]]

        index_offsets = np.zeros(len(self._parents), dtype=int)
        new_parents = []
        for i, parent in enumerate(self._parents):
            if i not in joints_to_remove:
                new_parents.append(parent - index_offsets[parent])
            else:
                index_offsets[i:] += 1
        self._parents = np.array(new_parents)

        removed = np.asarray(joints_to_remove)
        self._joints_left = [j - int(np.sum(removed < j))
                             for j in self._joints_left if j not in joints_to_remove]
        self._joints_right = [j - int(np.sum(removed < j))
                              for j in self._joints_right if j not in joints_to_remove]

        if dataset is not None:
            for subject in dataset.subjects():
                for action in dataset[subject].keys():
                    s = dataset[subject][action]
                    s["positions"] = s["positions"][:, valid_joints]

        return valid_joints


class MocapDataset:
    """Per-subject/action pose arrays plus camera metadata."""

    def __init__(self, fps, skeleton: Skeleton):
        self._skeleton = skeleton
        self._fps = fps
        self._data = None
        self._cameras = None

    def remove_joints(self, joints_to_remove):
        return self._skeleton.remove_joints(joints_to_remove, self)

    def __getitem__(self, key):
        return self._data[key]

    def subjects(self):
        return self._data.keys()

    def skeleton(self) -> Skeleton:
        return self._skeleton

    def cameras(self):
        return self._cameras
