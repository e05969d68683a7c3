"""Bulk FK-GAN pose synthesis: write a DH-3DHP-style synthetic dataset.

Port of ``scripts/synthesize_dataset.py``: sample N (3D, 2D, camera) pairs
from a trained generator, loaded from a snapshot that
``python -m dhaug_torch.run_fk_gan`` wrote (``--ckpt``: a ``.ckpt`` file or a
``--ckpt_format orbax`` directory), or from a fresh
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
``cam`` (N, 9) intrinsics, ``seed`` and ``n_devices``.

Multi-process synthesis (scripts/synthesize_dataset.py:40-172): start one
process a device with the same ``--coordinator host:port`` and
``--num_processes P`` and each its ``--process_id``; the processes form a
gloo group over ``tcp://host:port`` (the gathered rows go to the host for
the npz anyway), process i runs on card ``i % cards`` (or the CPU), each
batch of ``--batch`` poses (cut to a multiple of P) is P shards of which
each process synthesizes its own (``parallel/sharded.py``), and process 0
gathers the rows and writes the npz.

    python -m dhaug_torch.synthesize_dataset --random_init true --n_poses 65536 \
        --coordinator localhost:29500 --num_processes 2 --process_id 0 &
    python -m dhaug_torch.synthesize_dataset --random_init true --n_poses 65536 \
        --coordinator localhost:29500 --num_processes 2 --process_id 1

One process draws each batch's noise, scalers and camera from one stream
seeded with ``--seed`` + 1; over P processes, shard s of batch i draws from
a stream seeded with (``--seed`` + 1, i, s) and the camera from one seeded
with (``--seed`` + 1, i), so (seed, P), recorded as ``n_devices``, pins
the dataset, as it does for the JAX package.
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
from dhaug_torch.parallel import mesh
from dhaug_torch.parallel.sharded import make_sharded_synthesizer, stream
from dhaug_torch.utils.checkpoint import load_snapshot, restore_into
from dhaug_torch.utils.profiling import span, spanned

CAMERA_SUBJECTS = ("S1", "S5", "S6", "S7", "S8")


def _str2bool(x) -> bool:
    return str(x).lower() == "true"


def get_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Bulk FK-GAN pose synthesis (PyTorch port)")
    ap.add_argument("--n_poses", default=100000, type=int)
    ap.add_argument("--batch", default=8192, type=int, help="per-dispatch batch")
    ap.add_argument("--out", default="dh_synth.npz", type=str)
    ap.add_argument("--ckpt", default="", type=str,
                    help="dhaug_torch.run_fk_gan resume snapshot with a gen_state "
                         "(a .ckpt file or an orbax directory)")
    ap.add_argument("--random_init", default=False, type=_str2bool)
    ap.add_argument("--Gen_DenseDim", default=1000, type=int)
    ap.add_argument("--seed", default=0, type=int)
    ap.add_argument("--device", default="cuda", type=str,
                    help="cuda (default) or cpu; cuda without a card raises")
    ap.add_argument("--coordinator", default="", type=str,
                    help="host:port of process 0 for multi-process synthesis")
    ap.add_argument("--num_processes", default=1, type=int,
                    help="processes (one a device) of a multi-process synthesis")
    ap.add_argument("--process_id", default=0, type=int,
                    help="this process's index in [0, --num_processes)")
    return ap


@spanned("synth.dispatch")
def synth_pairs(synthesize, ops, bone_len, cameras, generator, noise=None, scaler8=None,
                cam_idx=None):
    """One batch: world poses -> one camera -> (cam3d (B, 16, 3), pose2d
    (B, 16, 2), intrinsics (B, 9)); ``noise``, ``scaler8`` and ``cam_idx``
    replace the draws (scripts/synthesize_dataset.py:109-118).  The camera
    is gathered on the device, so a dispatch reads nothing back to the host
    and the host can queue the next one while this one runs."""
    quats, trans, intrs = cameras
    pose16 = synthesize(ops, bone_len, generator, noise=noise, scaler8=scaler8)
    with torch.no_grad(), span("synth.project"):
        if cam_idx is None:
            cam_idx = torch.randint(0, quats.shape[0], (), generator=generator,
                                    device=quats.device)
        row = torch.as_tensor(cam_idx, device=quats.device).reshape(1)
        cam3d = world_to_camera_batch(pose16, quats.index_select(0, row),
                                      trans.index_select(0, row))
        intr = intrs.index_select(0, row).expand(pose16.shape[0], 9)
        pose2d = project_to_2d(cam3d, intr)
    return cam3d, pose2d, intr


def join_processes(args) -> torch.device:
    """Check the multi-process flags and, for more than one process, join
    their gloo group on this process's device."""
    P = args.num_processes
    if P < 1 or not 0 <= args.process_id < P:
        raise SystemExit(f"--process_id {args.process_id} is not in [0, --num_processes {P})")
    if bool(args.coordinator) != (P > 1):
        raise SystemExit("multi-process synthesis needs both --coordinator host:port and "
                         f"--num_processes above 1 (got --coordinator {args.coordinator!r}, "
                         f"--num_processes {P})")
    device = dhaug_torch.resolve_device(args.device)
    if P > 1:
        if device.type == "cuda":
            device = torch.device("cuda", args.process_id % torch.cuda.device_count())
        mesh.join("gloo", device, args.process_id, P, f"tcp://{args.coordinator}")
    return device


def main(argv=None) -> dict:
    """Synthesize and write the npz (process 0 of a multi-process run).
    Returns the output path, the pose count, the loop's seconds and
    poses/s, and the generator net used."""
    args = get_parser().parse_args(argv)
    device = join_processes(args)
    try:
        return synthesize_npz(args, device)
    finally:
        if args.num_processes > 1:
            mesh.leave()


def synthesize_npz(args, device) -> dict:
    """The synthesis loop on ``device``: this process's shard of every
    batch over ``--num_processes`` processes, gathered for process 0."""
    P = args.num_processes

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

    synthesize = make_sharded_synthesizer(cfg, n_devices=P)
    cameras = camera_bank(list(CAMERA_SUBJECTS), device)
    B = args.batch - args.batch % P or P
    generator = torch.Generator(device=device).manual_seed(args.seed + 1) if P == 1 else None
    dp = mesh.current()
    bone_len = torch.tensor(CANONICAL_BONE_LEN, dtype=torch.float32,
                            device=device).expand(B, 15).contiguous()

    out3d, out2d, outcam = [], [], []
    done, i = 0, 0
    t0 = time.perf_counter()
    while done < args.n_poses:
        if P == 1:
            cam3d, pose2d, intr = synth_pairs(synthesize, ops, bone_len, cameras, generator)
        else:
            shards = [stream(device, args.seed + 1, i, s) for s in range(P)]
            cam_idx = torch.randint(0, cameras[0].shape[0], (),
                                    generator=stream(device, args.seed + 1, i), device=device)
            cam3d, pose2d, intr = (dp.all_gather_rows(t) for t in synth_pairs(
                synthesize, ops, bone_len, cameras, shards, cam_idx=cam_idx))
        take = min(B, args.n_poses - done)
        out3d.append(cam3d[:take].cpu().numpy())
        out2d.append(pose2d[:take].cpu().numpy())
        outcam.append(intr[:take].cpu().numpy())
        done += take
        i += 1
    seconds = time.perf_counter() - t0

    pose3d = np.concatenate(out3d)
    if dp.is_main:
        np.savez_compressed(args.out, pose3d=pose3d, pose2d=np.concatenate(out2d),
                            cam=np.concatenate(outcam), seed=np.int64(args.seed),
                            n_devices=np.int64(P))
        print(f"wrote {args.out}: {pose3d.shape[0]} poses in {seconds:.1f}s "
              f"({pose3d.shape[0] / seconds:.0f} poses/s on {device}"
              f"{f' / {P} processes' if P > 1 else ''})")
    return {"out": args.out, "n_poses": int(pose3d.shape[0]), "seconds": seconds,
            "poses_per_s": pose3d.shape[0] / seconds, "generator": net}


if __name__ == "__main__":
    main(sys.argv[1:])
