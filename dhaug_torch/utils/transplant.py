"""Reference posenet checkpoints (``ckpt_*.pth.tar``) into the port's nets.

The reference saves a posenet ``state_dict`` under 'state_dict'
(run_baseline.py:64) or 'model_pos' (run_Fk_GAN.py:176).  The port's
posenets carry the reference's parameter names (``models/posenets.py``), so
such a file loads with one strict ``load_state_dict``; nothing is renamed or
transposed, unlike ``dhaug_tpu/utils/transplant.py``, which maps it onto
flax trees.
"""
from __future__ import annotations

from typing import Mapping

import torch


def is_torch_checkpoint(path: str) -> bool:
    """Reference checkpoints are ``ckpt_<suffix>.pth.tar`` (utils.py:134)."""
    return path.endswith((".pth.tar", ".pth"))


def load_torch_checkpoint(path: str) -> dict:
    """The posenet state_dict of a reference ``.pth.tar``, under either key
    layout ('state_dict' or 'model_pos'), as CPU tensors.  Loading runs no
    pickled code (``weights_only=True``)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    return dict(ckpt.get("state_dict", ckpt.get("model_pos", ckpt)))


def load_posenet_state_dict(net: torch.nn.Module,
                            state: Mapping[str, torch.Tensor]) -> torch.nn.Module:
    """Load ``state`` into ``net`` strictly.  A mismatch raises
    ``ValueError`` naming the first missing and unexpected keys, or the
    first shape that differs.  BatchNorm's ``num_batches_tracked`` counters
    are the one thing a file may lack: the net's own are kept then."""
    own = net.state_dict()
    missing = [k for k in own if k not in state and not k.endswith("num_batches_tracked")]
    unexpected = [k for k in state if k not in own]
    if missing or unexpected:
        raise ValueError(
            f"posenet checkpoint mismatch: {len(missing)} missing (first few: "
            f"{missing[:6]}), {len(unexpected)} unexpected (first few: {unexpected[:6]}) "
            "-- wrong --posenet_name / --stages / --architecture for this file?")
    for k, v in state.items():
        if tuple(v.shape) != tuple(own[k].shape):
            raise ValueError(f"shape mismatch at {k}: checkpoint {tuple(v.shape)} vs "
                             f"model {tuple(own[k].shape)} -- wrong model dims for this file")
    net.load_state_dict({**own, **state}, strict=True)
    return net
