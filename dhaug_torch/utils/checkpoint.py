"""Checkpoint save/load with working resume.

Port of ``dhaug_tpu/utils/checkpoint.py``.  A checkpoint is a dict of
state_dicts, tensors, numbers, strings and plain containers, written with
``torch.save`` after every tensor is moved to the CPU, and read with
``torch.load(..., map_location="cpu", weights_only=True)``, so a snapshot
written on the card loads on the CPU and the reverse, and loading runs no
pickled code.  numpy's ``bit_generator.state`` (a dict of strings and
Python ints, 128-bit ones included) loads under ``weights_only``.

Not ported: the ``orbax`` format (refused with ``NotImplementedError``),
reading the JAX package's snapshots, and ``fetch_tree``, which served the
TPU runtime; ``.cpu()`` takes its place.
"""
from __future__ import annotations

import os
from typing import Any, Mapping

import torch

from dhaug_torch.utils.transplant import (is_torch_checkpoint, load_posenet_state_dict,
                                          load_torch_checkpoint)


def _to_cpu(obj: Any) -> Any:
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, Mapping):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def save_ckpt(state: dict, ckpt_dir: str, suffix: str | None = None) -> str:
    """Save ``state`` as ``<ckpt_dir>/ckpt_<suffix>.ckpt`` (``suffix``
    defaults to ``epoch_<epoch>``); returns the path."""
    if suffix is None:
        suffix = "epoch_{:04d}".format(state.get("epoch", 0))
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"ckpt_{suffix}.ckpt")
    torch.save(_to_cpu(state), path)
    return path


def load_ckpt(path: str) -> dict:
    return torch.load(path, map_location="cpu", weights_only=True)


def save_snapshot(state: dict, ckpt_dir: str, suffix: str, fmt: str = "pickle") -> str:
    """Full-state snapshot save (``--ckpt_format``): 'pickle' writes one
    ``ckpt_<suffix>.ckpt`` file; 'orbax' is not ported."""
    if fmt == "orbax":
        raise NotImplementedError("--ckpt_format orbax is not ported yet to dhaug_torch "
                                  "(the JAX package's utils/checkpoint.py has it)")
    if fmt != "pickle":
        raise ValueError(f"unknown --ckpt_format {fmt!r} (pickle|orbax)")
    return save_ckpt(state, ckpt_dir, suffix=suffix)


def load_snapshot(path: str) -> dict:
    """Load a snapshot written by :func:`save_snapshot`.  A directory is an
    orbax snapshot, which the port cannot read yet."""
    if os.path.isdir(path):
        raise NotImplementedError(f"{path} is an orbax snapshot directory; reading orbax "
                                  "snapshots is not ported yet to dhaug_torch")
    return load_ckpt(path)


def restore_into(module: torch.nn.Module, saved: Mapping[str, torch.Tensor]) -> torch.nn.Module:
    """Load the state_dict ``saved`` into ``module`` in place, strictly:
    the keys and every shape must match the module's own, or this raises
    ``ValueError`` (the JAX ``restore_into``'s checks and messages)."""
    template = module.state_dict()
    if len(template) != len(saved):
        raise ValueError(
            f"checkpoint structure mismatch: {len(saved)} saved leaves vs "
            f"{len(template)} template leaves")
    mismatched = [(t, s) for t, s in zip(template, saved) if t != s]
    if mismatched:
        head = "; ".join(f"template {t} vs saved {s}" for t, s in mismatched[:3])
        raise ValueError(
            f"checkpoint key-path mismatch ({len(mismatched)} of {len(template)} leaves "
            f"differ): {head}. The checkpoint was saved from a different "
            "model/optimizer architecture.")
    for key, t in template.items():
        if tuple(t.shape) != tuple(saved[key].shape):
            raise ValueError(f"shape mismatch at {key}: template {tuple(t.shape)} vs "
                             f"saved {tuple(saved[key].shape)}")
    module.load_state_dict(saved, strict=True)
    return module


def load_posenet_checkpoint(path: str) -> dict:
    """A posenet checkpoint as a dict: a port ``.ckpt`` as written, a
    reference ``.pth.tar`` as ``{'state_dict': <its posenet state_dict>}``."""
    if is_torch_checkpoint(path):
        return {"state_dict": load_torch_checkpoint(path)}
    return load_snapshot(path)


def resolve_posenet_weights(ckpt: Mapping, net: torch.nn.Module) -> torch.nn.Module:
    """Load a checkpoint's posenet weights into ``net``, strictly by name,
    from any of the layouts: 'state_dict' (``run_baseline``, a reference
    ``.pth.tar``), 'model_pos' (``run_fk_gan``'s best-posenet saves) and
    the full-state 'pos_state' of a ``--snapshot``/``--resume`` snapshot.
    Shared by ``run_evaluate`` and ``run_baseline``'s ``--pretrain`` warm
    start."""
    saved = ckpt.get("state_dict", ckpt.get("model_pos"))
    if saved is None and "pos_state" in ckpt:
        saved = ckpt["pos_state"]["model"]
    if saved is None:
        raise SystemExit(f"unsupported checkpoint format: keys {sorted(ckpt)} (expected "
                         "'state_dict', 'model_pos', or a full-state 'pos_state')")
    return load_posenet_state_dict(net, saved)
