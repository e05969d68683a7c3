"""Standalone preflight validation of a dataset directory.

Port of ``scripts/validate_data.py``: checks ``data_3d_h36m.npz``,
``data_2d_h36m_<kp>.npz``, ``test_3dhp.npz`` and the bone-length template
asset for format, units (metres vs millimetres), joint counts and
normalization before a training run can be started on them.  The training
CLIs run the same checks whenever ``--synthetic_data`` is false.  Host-only:
it reads numpy files and touches no device.

    python -m dhaug_torch.validate_data --data_root /data/h36m --keypoints cpn
"""
from __future__ import annotations

import argparse
import sys

from dhaug_torch.data.validate import validate_dataset_dir


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--data_root", default=".", type=str)
    parser.add_argument("--keypoints", default="gt", type=str)
    args = parser.parse_args(argv)
    return validate_dataset_dir(args.data_root, args.keypoints)


if __name__ == "__main__":
    main(sys.argv[1:])
