"""Flags of ``python -m dhaug_torch.run_fk_gan``, ``run_baseline`` and
``run_evaluate``.

A copy of the JAX package's two parsers (``dhaug_tpu/train/config.py``)
with every reference flag under its name and default.  The one change:
the JAX-only ``--jax_platform`` becomes ``--device`` (default ``cuda``).
Flags whose code is not ported yet are parsed and refused by the runners.
"""
from __future__ import annotations

import argparse


def _str2bool(x) -> bool:
    return str(x).lower() == "true"


def _add_common(parser: argparse.ArgumentParser):
    parser.add_argument("--dataset", default="h36m", type=str, metavar="NAME")
    parser.add_argument("--keypoints", default="gt", type=str, metavar="NAME",
                        help="2D detections to use: gt/hr/cpn_ft_h36m_dbb/detectron_ft_h36m")
    parser.add_argument("--actions", default="*", type=str, metavar="LIST")
    parser.add_argument("--checkpoint", default="checkpoint/debug", type=str, metavar="PATH")
    parser.add_argument("--note", default="debug", type=str)
    parser.add_argument("--evaluate", default="", type=str, metavar="FILENAME")
    parser.add_argument("--posenet_name", default="videopose", type=str,
                        help="gcn/mlp/videopose/mulit_farme_videopose/mulit_farme_poseformer")
    parser.add_argument("--stages", default=4, type=int, metavar="N")
    parser.add_argument("--dropout", default=0.25, type=float)
    parser.add_argument("--batch_size", default=1024, type=int, metavar="N")
    parser.add_argument("--epochs", default=50, type=int, metavar="N")
    parser.add_argument("--no_max", dest="max_norm", action="store_false")
    parser.set_defaults(max_norm=True)
    parser.add_argument("--random_seed", type=int, default=0)
    parser.add_argument("--downsample", default=1, type=int, metavar="FACTOR")
    parser.add_argument("--pretrain", default=False, type=_str2bool,
                        help="with --evaluate <ckpt>: load the pretrained "
                             "posenet and evaluate once, no training (the "
                             "reference's intent at run_Fk_GAN.py:107,238; "
                             "its loader globs a hardcoded empty path and "
                             "crashes — here it works via run_evaluate)")
    parser.add_argument("--s1only", default=False, type=_str2bool)
    parser.add_argument("--num_workers", default=0, type=int, metavar="N",
                        help="accepted for CLI compatibility; the host feed is single-process")
    parser.add_argument("--model_parallel_devices", default=1, type=int,
                        help="shard Dense layers wider than 512 over a "
                             "'model' mesh axis (tensor parallelism); "
                             "composes with --data_parallel_devices into a "
                             "(data, model) mesh of data*model devices")
    parser.add_argument("--ckpt_format", default="pickle", type=str,
                        choices=("pickle", "orbax"),
                        help="full-state snapshot format: 'pickle' (one "
                             ".ckpt file) or 'orbax' (a ckpt_<suffix>/ orbax "
                             "directory); --resume/--evaluate auto-detect "
                             "either")
    # extensions beyond the reference's flags
    parser.add_argument("--data_root", default=".", type=str,
                        help="directory containing data/ and data_extra/")
    parser.add_argument("--synthetic_data", default=False, type=_str2bool,
                        help="fabricate a small synthetic dataset when the npz files are absent")
    parser.add_argument("--data_parallel_devices", default=0, type=int,
                        help="run the compiled epoch programs data-parallel over "
                             "this many devices (0/1 = single device); "
                             "batch_size must divide by it")
    parser.add_argument("--device", default="cuda", type=str,
                        help="cuda (default) or cpu; cuda without a card raises")
    parser.add_argument("--bf16_trunk", default=False, type=_str2bool,
                        help="compute the generator trunk's dense matmuls in "
                             "bfloat16 (params stay fp32; the FK/geometry "
                             "path stays fp32-pinned) — a throughput option "
                             "for bulk synthesis")


def get_aug_parser() -> argparse.ArgumentParser:
    """The run_Fk_GAN flag surface (function_aug/config.py)."""
    parser = argparse.ArgumentParser(description="DH-AUG training (PyTorch port)")
    _add_common(parser)
    parser.add_argument("--snapshot", default=2, type=int)
    parser.add_argument("--resume", default="", type=str, metavar="FILENAME")
    parser.add_argument("--decay_epoch", default=0, type=int, metavar="N",
                        help="accepted for CLI compatibility; dead in the "
                             "reference too (parsed, never read)")
    parser.add_argument("--lr_g", default=1.0e-4, type=float, metavar="LR")
    parser.add_argument("--lr_d", default=1.0e-4, type=float, metavar="LR")
    parser.add_argument("--lr_p", default=1.0e-4, type=float, metavar="LR")
    parser.add_argument("--warmup", default=2, type=int)
    parser.add_argument("--df", default=2, type=int,
                        help="accepted for CLI compatibility; dead in the "
                             "reference too (parsed, never read — its "
                             "critic cadence is hardcoded n_critic=5)")
    parser.add_argument("--s1s5only", default=False, type=_str2bool)
    parser.add_argument("--data_enhancement_method", default="GAN", type=str,
                        help="GAN | normal | NO_enhance")
    parser.add_argument("--generator_whole_number", default=10000, type=int)
    parser.add_argument("--generator_choose_BoneLen", default=True, type=_str2bool)
    parser.add_argument("--bone_len_scaler", default="different", type=str,
                        help="'different' | 'same' | ''")
    parser.add_argument("--generator_choose_root_pos", default=True, type=_str2bool)
    parser.add_argument("--generator_global_rot", default=True, type=_str2bool)
    parser.add_argument("--GAN_OUTPUT_DIM", default=35, type=int)
    parser.add_argument("--GAN_LAMBDA", default=10, type=int)
    parser.add_argument("--GAN_whether_use_preAngle", default=True, type=_str2bool)
    parser.add_argument("--motion_Dis_whether_use_3dPos_branch", default=True, type=_str2bool)
    parser.add_argument("--motion_Dis_whether_use_3dDiff_branch", default=True, type=_str2bool)
    parser.add_argument("--Dis_DenseDim_3D", default=1000, type=int)
    parser.add_argument("--Dis_DenseDim_2D", default=1000, type=int)
    parser.add_argument("--Gen_DenseDim", default=1000, type=int)
    parser.add_argument("--video_Dis_DenseDim_3D", default=1000, type=int)
    parser.add_argument("--video_Dis_DenseDim_2D", default=1000, type=int)
    parser.add_argument("--GAN_3d_loss_weight", default=1, type=float)
    parser.add_argument("--GAN_2d_loss_weight", default=0.2, type=float)
    parser.add_argument("--GAN_3d_motion_loss_weight", default=1, type=float)
    parser.add_argument("--GAN_2d_motion_loss_weight", default=1, type=float)
    parser.add_argument("--GAN_whether_rand_root", default=True, type=_str2bool,
                        help="accepted for CLI compatibility; dead in the "
                             "reference too (parsed, never read)")
    parser.add_argument("--set_demo_mode", default=False, type=_str2bool,
                        help="accepted for CLI compatibility; dead in the "
                             "reference too (parsed, never read)")
    parser.add_argument("--GAN_checkpoint", default="checkpoint", type=str,
                        help="accepted for CLI compatibility; dead in the "
                             "reference too (parsed, never read — GAN "
                             "weights ride the full-state --snapshot here)")
    parser.add_argument("--GAN_resume", default="", type=str, metavar="FILENAME")
    parser.add_argument("--record_all_picture", default=False, type=_str2bool)
    parser.add_argument("--additional_train_epoch", default=60, type=int)
    parser.add_argument("--additional_LR_decay", default=0.95, type=float)
    parser.add_argument("--single_dis_warmup_epoch", default=4, type=int)
    parser.add_argument("--video_over_200mm", default=False, type=_str2bool)
    parser.add_argument("--whether_use_RT", default=True, type=_str2bool)
    parser.add_argument("--flip_pos_model_input", default=True, type=_str2bool)
    parser.add_argument("--flip_GAN_model_input", default=True, type=_str2bool)
    parser.add_argument("--Pos_video_playback_input", default=True, type=_str2bool)
    parser.add_argument("--GAN_video_playback_input", default=True, type=_str2bool)
    parser.add_argument("--gpu_id", default="0", type=str,
                        help="accepted for CLI compatibility; ignored")
    parser.add_argument("--Path_3DPW", default="", type=str,
                        help="accepted for CLI compatibility on the training "
                             "CLIs (the reference's 3DPW path is dead code); "
                             "run_evaluate.py implements it as a working "
                             "cross-dataset evaluation")
    parser.add_argument("--single_or_multi_train_mode", default="single", type=str)
    parser.add_argument("--architecture", default="3,3,3", type=str, metavar="LAYERS")
    return parser


def get_baseline_parser() -> argparse.ArgumentParser:
    """The run_baseline / run_evaluate flag surface (function_baseline/config.py)."""
    parser = argparse.ArgumentParser(description="DH-AUG baseline (PyTorch port)")
    _add_common(parser)
    parser.add_argument("--snapshot", default=25, type=int)
    parser.add_argument("--action-wise", default=True, type=_str2bool)
    parser.add_argument("--Path_3DPW", default="", type=str,
                        help="npz with pose3d (N,24|16,3 m) + pose2d "
                             "(N,16,2 normalized): adds a 3DPW cross-dataset "
                             "evaluation to run_evaluate (the reference's "
                             "--Path_3DPW is dead code)")
    parser.add_argument("--train_npz", default="", type=str,
                        help="train on a synthesized (2D, 3D) dataset npz "
                             "(synthesize_dataset output: pose3d "
                             "cam-space metres, pose2d normalized, cam "
                             "intrinsics) — the DH-3DHP workflow; evaluation "
                             "stays on H36M S9/S11 + 3DHP.  See "
                             "--train_npz_mode for replace-vs-mix")
    parser.add_argument("--train_npz_mode", default="mix", type=str,
                        choices=["mix", "replace"],
                        help="how --train_npz combines with the real train "
                             "split: 'mix' (default) concatenates the "
                             "synthesized pairs with the real pairs and "
                             "shuffles them together — the released-dataset "
                             "augmentation workflow the reference's DH-3DHP "
                             "download serves (README.md:104-106); "
                             "'replace' trains on the npz alone")
    parser.add_argument("--lr", default=1.0e-3, type=float, metavar="LR")
    parser.add_argument("--lr_decay", type=int, default=100000)
    parser.add_argument("--lr_gamma", type=float, default=0.96)
    # the aug parser's video/arch flags are needed by shared code paths
    parser.add_argument("--single_or_multi_train_mode", default="single", type=str)
    parser.add_argument("--architecture", default="3,3,3", type=str, metavar="LAYERS")
    parser.add_argument("--flip_pos_model_input", default=False, type=_str2bool)
    return parser


def _validate_architecture(arch: str):
    try:
        widths = [int(x) for x in arch.split(",")]
    except ValueError:
        raise SystemExit(f"--architecture must be comma-separated ints, got {arch!r}")
    if any(w % 2 == 0 for w in widths):
        raise SystemExit("--architecture: only odd filter widths are supported")


def parse_aug_args(argv=None):
    args = get_aug_parser().parse_args(argv)
    _validate_architecture(args.architecture)
    if args.data_enhancement_method not in ("GAN", "normal", "NO_enhance"):
        raise SystemExit("--data_enhancement_method must be GAN | normal | NO_enhance")
    if args.single_or_multi_train_mode not in ("single", "multi"):
        raise SystemExit("--single_or_multi_train_mode must be single | multi")
    if args.resume and args.evaluate:
        raise SystemExit("--resume and --evaluate cannot be set at the same time")
    if args.s1only and args.s1s5only:
        raise SystemExit("--s1only and --s1s5only cannot both be true")
    return args


def parse_baseline_args(argv=None):
    args = get_baseline_parser().parse_args(argv)
    _validate_architecture(args.architecture)
    return args
