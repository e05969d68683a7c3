"""Runner plumbing shared by the entry points (port of the parts of
``dhaug_tpu/train/runners.py`` the runners use).  Under data or tensor
parallelism only global rank 0 makes the run directory and writes the
logs; the other ranks get its path and loggers that write nothing."""
from __future__ import annotations

import datetime
import os
from typing import Tuple

from dhaug_torch.models.factory import SINGLE_FRAME_NAMES
from dhaug_torch.parallel import mesh
from dhaug_torch.utils.log import Logger, Summary

LOG_COLUMNS = ["epoch", "lr", "error_h36m_p1", "error_h36m_p2",
               "error_3dhp_p1", "error_3dhp_p2", "PCK", "AUC"]


def check_posenet_mode(args) -> None:
    """The multi-frame posenets train in video mode, the others in
    single-frame mode."""
    video_net = args.posenet_name not in SINGLE_FRAME_NAMES
    if video_net != (args.single_or_multi_train_mode == "multi"):
        raise SystemExit(f"--posenet_name {args.posenet_name} needs "
                         f"--single_or_multi_train_mode {'multi' if video_net else 'single'}")


def make_run_dir(args) -> str:
    """checkpoint/<posenet>/<keypoints>/<timestamp>_<note>/ (the reference's
    layout, run_Fk_GAN.py:79-83), made by rank 0; every rank gets its path."""
    dp = mesh.current()
    run_dir = None
    if dp.is_main:
        run_dir = os.path.join(args.checkpoint, args.posenet_name, args.keypoints,
                               datetime.datetime.now().isoformat() + "_" + args.note)
        os.makedirs(os.path.join(run_dir, "tmp"), exist_ok=True)
    return dp.broadcast_object(run_dir)


def make_logger(run_dir: str, args) -> Tuple[Logger, Summary]:
    """``log.txt`` and ``metrics.jsonl`` in ``run_dir``, on rank 0 only."""
    main = mesh.current().is_main
    logger = Logger(os.path.join(run_dir, "log.txt") if main else None, args)
    logger.set_names(LOG_COLUMNS)
    summary = Summary(run_dir if main else None)
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
