"""Bulk FK-GAN pose synthesis: write a DH-3DHP-style synthetic dataset.

Port of ``scripts/synthesize_dataset.py``: sample N (3D, 2D, camera) pairs
from a trained generator, loaded from a snapshot that
``python -m dhaug_torch.run_fk_gan`` wrote (``--ckpt``), or from a fresh
initialisation (``--random_init true``).  Each batch runs the generator
trunk (kernel B3 on the card), the bone scalers and the FK (kernel B1),
then puts the whole batch through one random H36M training camera.

    python -m dhaug_torch.synthesize_dataset \\
        --ckpt <run dir>/ckpt_resume_latest.ckpt --n_poses 1000000 --out dh_synth.npz
    python -m dhaug_torch.synthesize_dataset --device cpu --random_init true \\
        --n_poses 10000 --out dh_synth.npz

Runs on CUDA unless ``--device cpu`` is given; ``--device cuda`` without a
card raises.  On the CPU the trunk is the plain bf16 version
(``models/trunk_cuda.py``), the function the card and the TPU compute.  The
npz holds ``pose3d`` (N, 16, 3) camera-space poses, ``pose2d`` (N, 16, 2),
``cam`` (N, 9) intrinsics, ``seed`` and ``n_devices`` (1: multi-device
synthesis, ``--coordinator``/``--num_processes``, is not ported yet).
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

import dhaug_torch
from dhaug_torch.gan.wgan import camera_bank
from dhaug_torch.models.generator import FkGeneratorNet, GeneratorConfig
from dhaug_torch.models.trunk_cuda import trunk_weights
from dhaug_torch.ops.camera import project_to_2d, world_to_camera_batch
from dhaug_torch.ops.fk import CANONICAL_BONE_LEN
from dhaug_torch.parallel.sharded import make_sharded_synthesizer
from dhaug_torch.utils.checkpoint import load_snapshot, restore_into

CAMERA_SUBJECTS = ("S1", "S5", "S6", "S7", "S8")


def _str2bool(x) -> bool:
    return str(x).lower() == "true"


def get_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Bulk FK-GAN pose synthesis (PyTorch port)")
    ap.add_argument("--n_poses", default=100000, type=int)
    ap.add_argument("--batch", default=8192, type=int, help="per-dispatch batch")
    ap.add_argument("--out", default="dh_synth.npz", type=str)
    ap.add_argument("--ckpt", default="", type=str,
                    help="dhaug_torch.run_fk_gan resume snapshot with a gen_state")
    ap.add_argument("--random_init", default=False, type=_str2bool)
    ap.add_argument("--Gen_DenseDim", default=1000, type=int)
    ap.add_argument("--seed", default=0, type=int)
    ap.add_argument("--device", default="cuda", type=str,
                    help="cuda (default) or cpu; cuda without a card raises")
    ap.add_argument("--coordinator", default="", type=str,
                    help="multi-process synthesis: not ported yet (refused)")
    ap.add_argument("--num_processes", default=1, type=int,
                    help="multi-process synthesis: not ported yet (refused above 1)")
    ap.add_argument("--process_id", default=0, type=int)
    return ap


def synth_pairs(synthesize, ops, bone_len, cameras, generator, noise=None, scaler8=None,
                cam_idx=None):
    """One batch: world poses -> one camera -> (cam3d (B, 16, 3), pose2d
    (B, 16, 2), intrinsics (B, 9)); ``noise``, ``scaler8`` and ``cam_idx``
    replace the draws (scripts/synthesize_dataset.py:109-118)."""
    quats, trans, intrs = cameras
    pose16 = synthesize(ops, bone_len, generator, noise=noise, scaler8=scaler8)
    with torch.no_grad():
        if cam_idx is None:
            cam_idx = torch.randint(0, quats.shape[0], (), generator=generator,
                                    device=quats.device)
        cam3d = world_to_camera_batch(pose16, quats[cam_idx][None], trans[cam_idx][None])
        intr = intrs[cam_idx][None].expand(pose16.shape[0], 9)
        pose2d = project_to_2d(cam3d, intr)
    return cam3d, pose2d, intr


def main(argv=None) -> dict:
    """Synthesize and write the npz.  Returns the output path, the pose
    count, the loop's seconds and poses/s, and the generator net used."""
    args = get_parser().parse_args(argv)
    if args.coordinator or args.num_processes > 1:
        raise NotImplementedError(
            "--coordinator/--num_processes (multi-process synthesis) are not ported yet "
            "to dhaug_torch (ROADMAP A16)")
    device = dhaug_torch.resolve_device(args.device)

    cfg = GeneratorConfig(dense_dim=args.Gen_DenseDim)
    torch.manual_seed(args.seed)  # weight initialisation
    net = FkGeneratorNet(cfg)
    if args.ckpt:
        saved = load_snapshot(args.ckpt)
        gen_state = saved.get("gen_state")
        restore_into(net, gen_state["model"] if gen_state is not None else saved["gen"])
        print(f"==> loaded generator from {args.ckpt}")
    elif not args.random_init:
        print("WARNING: no --ckpt given; using a randomly initialized generator")
    net = net.to(device).eval()
    ops = trunk_weights(net)  # prepared once, after the weights are loaded

    synthesize = make_sharded_synthesizer(cfg)
    cameras = camera_bank(list(CAMERA_SUBJECTS), device)
    B = args.batch
    bone_len = torch.tensor(CANONICAL_BONE_LEN, dtype=torch.float32,
                            device=device).expand(B, 15).contiguous()
    generator = torch.Generator(device=device)
    generator.manual_seed(args.seed + 1)

    out3d, out2d, outcam = [], [], []
    done = 0
    t0 = time.perf_counter()
    while done < args.n_poses:
        cam3d, pose2d, intr = synth_pairs(synthesize, ops, bone_len, cameras, generator)
        take = min(B, args.n_poses - done)
        out3d.append(cam3d[:take].cpu().numpy())
        out2d.append(pose2d[:take].cpu().numpy())
        outcam.append(intr[:take].cpu().numpy())
        done += take
    seconds = time.perf_counter() - t0

    pose3d = np.concatenate(out3d)
    np.savez_compressed(args.out, pose3d=pose3d, pose2d=np.concatenate(out2d),
                        cam=np.concatenate(outcam), seed=np.int64(args.seed),
                        n_devices=np.int64(1))
    print(f"wrote {args.out}: {pose3d.shape[0]} poses in {seconds:.1f}s "
          f"({pose3d.shape[0] / seconds:.0f} poses/s on {device})")
    return {"out": args.out, "n_poses": int(pose3d.shape[0]), "seconds": seconds,
            "poses_per_s": pose3d.shape[0] / seconds, "generator": net}


if __name__ == "__main__":
    main(sys.argv[1:])
