"""Runner plumbing shared by the entry points (port of the parts of
``dhaug_tpu/train/runners.py`` the single-frame runner uses)."""
from __future__ import annotations

import datetime
import os
from typing import Tuple

from dhaug_torch.utils.log import Logger, Summary

LOG_COLUMNS = ["epoch", "lr", "error_h36m_p1", "error_h36m_p2",
               "error_3dhp_p1", "error_3dhp_p2", "PCK", "AUC"]


def make_run_dir(args) -> str:
    """checkpoint/<posenet>/<keypoints>/<timestamp>_<note>/ (the reference's
    layout, run_Fk_GAN.py:79-83)."""
    run_dir = os.path.join(args.checkpoint, args.posenet_name, args.keypoints,
                           datetime.datetime.now().isoformat() + "_" + args.note)
    os.makedirs(os.path.join(run_dir, "tmp"), exist_ok=True)
    return run_dir


def make_logger(run_dir: str, args) -> Tuple[Logger, Summary]:
    logger = Logger(os.path.join(run_dir, "log.txt"), args)
    logger.set_names(LOG_COLUMNS)
    summary = Summary(run_dir)
    summary.create_summary()
    return logger, summary


def write_eval_scalars(writer, epoch: int, h36m: dict, dhp: dict, tag: str) -> None:
    """Per-epoch evaluation scalars under the reference's TensorBoard tags
    (function_aug/model_pos_eval.py:81-85); ``tag`` is '_fake' or '_real'."""
    if writer is None:
        return
    for key, scores, flipaug in (("H36M_test", h36m, ""), ("mpi3d_loader", dhp, "_flip")):
        base = f"posenet_{key}{flipaug}"
        writer.add_scalar(f"{base}/p1score{tag}", scores.get("p1", 0.0), epoch)
        writer.add_scalar(f"{base}/p2score{tag}", scores.get("p2", 0.0), epoch)
        writer.add_scalar(f"{base}/_pck{tag}", scores.get("pck", 0.0), epoch)
        writer.add_scalar(f"{base}/_auc{tag}", scores.get("auc", 0.0), epoch)
