"""3DPW and other external joint layouts -> the H36M 16-joint layout.

A numpy copy of ``dhaug_tpu/data/pw3d.py``: the index tables (theirs ->
ours) for SMPL-24 (3DPW), VIBE-14 and COCO-16 joints, and the converter
``run_evaluate --Path_3DPW`` uses.
"""
from __future__ import annotations

import numpy as np

PW3D_TO_16POINTS_TABLE = {1: 4, 2: 1, 6: 7, 4: 5, 5: 2, 7: 6, 8: 3, 15: 9,
                          16: 10, 17: 13, 18: 11, 19: 14, 20: 12, 21: 15}

PW3D_TO_16POINTS_TABLE_FROM_VIBE = {0: 3, 1: 2, 2: 1, 3: 4, 4: 5, 5: 6,
                                    6: 15, 7: 14, 8: 13, 9: 10, 10: 11,
                                    11: 12, 12: 9}

PW3D_TO_16POINTS_TABLE_FROM_COCO = {0: 9, 1: 8, 2: 13, 3: 14, 4: 15, 5: 10,
                                    6: 11, 7: 12, 8: 1, 9: 2, 10: 3, 11: 4,
                                    12: 5, 13: 6}


def convert_to_16(joints: np.ndarray, table: dict) -> np.ndarray:
    """(N, J_src, C) -> (N, 16, C) through a theirs -> ours index table;
    unmapped slots are zero."""
    out = np.zeros(joints.shape[:1] + (16,) + joints.shape[2:], joints.dtype)
    for src, dst in table.items():
        out[:, dst] = joints[:, src]
    return out
