"""Checkpoint save/load with working resume.

Port of ``dhaug_tpu/utils/checkpoint.py``.  A checkpoint is a dict of
state_dicts, tensors, numbers, strings and plain containers, written with
``torch.save`` after every tensor is moved to the CPU, and read with
``torch.load(..., map_location="cpu", weights_only=True)``, so a snapshot
written on the card loads on the CPU and the reverse, and loading runs no
pickled code.  numpy's ``bit_generator.state`` (a dict of strings and
Python ints, 128-bit ones included) loads under ``weights_only``.

``--ckpt_format orbax`` writes a snapshot as the JAX package's directory
layout, ``ckpt_<suffix>/`` with ``arrays/`` (the numeric array leaves) and
``aux.pkl`` (every other leaf: counters, None, strings, numpy's
bit-generator state, and the tree's structure), in torch, numpy and the
standard library alone: ``arrays/`` holds one ``.npy`` a leaf and an
``index.json`` with the format tag ``FORMAT``, and ``aux.pkl`` is plain
containers read by the numpy-only unpickler below.

The JAX package's posenet checkpoints (its ``save_ckpt`` pickles plain
dicts of numpy arrays: 'state_dict' from ``run_baseline.py``, 'model_pos'
from ``run_Fk_GAN.py``) are told apart by their first bytes (``torch.save``
writes a zip, a raw pickle starts with ``0x80``) and read by an unpickler
that resolves only the numpy globals an array pickle names; their flax
trees go through ``models/convert.load_posenet``.  The JAX package's
full-state snapshots, in either format (flax ``NetState`` objects in a
pickle; an orbax/tensorstore ``arrays/`` and a jax treedef in ``aux.pkl``),
are refused with a message that says why.  Not ported: ``fetch_tree``,
which served the TPU runtime; ``.cpu()`` takes its place.

Under data or tensor parallelism only global rank 0 writes, every rank
reads, and a net and its optimizer are held in the single-device layout
(:func:`net_state` gathers the column blocks of ``parallel/tensor.py``,
:func:`restore_net` cuts them out), so a snapshot written on any grid
resumes on any other and ``run_evaluate`` reads it unchanged.
"""
from __future__ import annotations

import json
import os
import pickle
import shutil
from typing import Any, Mapping

import numpy as np
import torch

from dhaug_torch.models.convert import load_posenet
from dhaug_torch.parallel import mesh
from dhaug_torch.parallel.tensor import (full_optimizer_state, full_state_dict,
                                         local_optimizer_state, local_state_dict)
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
    defaults to ``epoch_<epoch>``); returns the path.  Only global rank 0
    writes."""
    if suffix is None:
        suffix = "epoch_{:04d}".format(state.get("epoch", 0))
    path = os.path.join(ckpt_dir, f"ckpt_{suffix}.ckpt")
    if mesh.current().is_main:
        os.makedirs(ckpt_dir, exist_ok=True)
        torch.save(_to_cpu(state), path)
    return path


def load_ckpt(path: str) -> dict:
    return torch.load(path, map_location="cpu", weights_only=True)


def is_raw_pickle(path: str) -> bool:
    """A raw pickle (the JAX package's ``save_ckpt``) starts with the
    PROTO opcode 0x80; a ``torch.save`` file is a zip, which starts with ``PK``."""
    with open(path, "rb") as f:
        return f.read(1) == b"\x80"


def _numpy_globals() -> dict:
    """The globals a pickled numpy array or scalar names, under both module
    spellings (numpy 2 writes ``numpy._core``, numpy 1 ``numpy.core``),
    resolved in the numpy that runs here."""
    try:
        from numpy._core import multiarray, numeric
    except ImportError:  # numpy < 2
        from numpy.core import multiarray, numeric
    found = {}
    for core in ("numpy.core", "numpy._core"):
        found[(f"{core}.multiarray", "_reconstruct")] = multiarray._reconstruct
        found[(f"{core}.multiarray", "scalar")] = multiarray.scalar
        found[(f"{core}.numeric", "_frombuffer")] = numeric._frombuffer
    found[("numpy", "ndarray")] = np.ndarray
    found[("numpy", "dtype")] = np.dtype
    return found


class _NumpyOnlyUnpickler(pickle.Unpickler):
    """Resolves numpy's array globals and nothing else, so a pickle that
    names any other class or function fails before anything of it runs."""

    allowed = _numpy_globals()

    def find_class(self, module, name):
        if (module, name) in self.allowed:
            return self.allowed[(module, name)]
        why = ""
        if module.split(".")[0] in ("dhaug_tpu", "flax", "optax", "jax", "jaxlib"):
            why = (" It is a JAX package full-state snapshot (its nets are flax NetState "
                   "objects): the port reads only the JAX package's posenet checkpoints "
                   "('state_dict' or 'model_pos' of numpy arrays); evaluate the run's "
                   "ckpt_best_*.ckpt instead.")
        raise pickle.UnpicklingError(
            f"refused to unpickle the global {module}.{name}: a JAX package checkpoint may "
            f"hold numpy arrays only, so no pickled code runs.{why}")


def load_jax_ckpt(path: str) -> dict:
    """A checkpoint of the JAX package's ``save_ckpt`` (a raw pickle of
    dicts, numbers, strings and numpy arrays), read with numpy globals
    only."""
    with open(path, "rb") as f:
        return _NumpyOnlyUnpickler(f).load()


FORMAT = "dhaug_torch.npy/1"       # arrays/index.json's tag of the port's layout


def _keystr(path: tuple) -> str:
    return "".join(f"[{k!r}]" for k in path)


def _flatten(obj: Any, path: tuple, arrays: dict, others: dict):
    """The structure of ``obj`` as plain containers; its array leaves go to
    ``arrays`` and every other leaf to ``others``, under their key path."""
    if isinstance(obj, Mapping):
        return ("dict", [(k, _flatten(v, path + (k,), arrays, others)) for k, v in obj.items()])
    if isinstance(obj, (list, tuple)):
        return (type(obj).__name__,
                [_flatten(v, path + (i,), arrays, others) for i, v in enumerate(obj)])
    key = _keystr(path)
    if isinstance(obj, torch.Tensor) or (isinstance(obj, np.ndarray)
                                         and np.issubdtype(obj.dtype, np.number)):
        arrays[key] = obj
        return ("array", key)
    others[key] = obj
    return ("leaf", key)


def _unflatten(node, arrays: dict, others: dict):
    kind, body = node
    if kind == "dict":
        return {k: _unflatten(v, arrays, others) for k, v in body}
    if kind in ("list", "tuple"):
        items = [_unflatten(v, arrays, others) for v in body]
        return items if kind == "list" else tuple(items)
    return arrays[body] if kind == "array" else others[body]


def save_ckpt_orbax(state: dict, ckpt_dir: str, suffix: str = "orbax") -> str:
    """Save ``state`` as the directory ``<ckpt_dir>/ckpt_<suffix>/``
    (``arrays/`` and ``aux.pkl``, see above), replacing one that is there;
    returns its path.  Only global rank 0 writes."""
    path = os.path.abspath(os.path.join(ckpt_dir, f"ckpt_{suffix}"))
    if not mesh.current().is_main:
        return path
    arrays, others = {}, {}
    structure = _flatten(_to_cpu(state), (), arrays, others)
    part = path + ".part"
    shutil.rmtree(part, ignore_errors=True)
    os.makedirs(os.path.join(part, "arrays"))
    index = {}
    for i, (key, leaf) in enumerate(arrays.items()):
        kind, dtype = ("tensor", str(leaf.dtype).split(".")[-1]) \
            if isinstance(leaf, torch.Tensor) else ("ndarray", leaf.dtype.str)
        if kind == "tensor":
            leaf = (leaf.view(torch.int16) if leaf.dtype == torch.bfloat16 else leaf).numpy()
        name = f"{i:05d}.npy"
        np.save(os.path.join(part, "arrays", name), leaf, allow_pickle=False)
        index[key] = {"file": name, "kind": kind, "dtype": dtype}
    with open(os.path.join(part, "arrays", "index.json"), "w") as f:
        json.dump({"format": FORMAT, "leaves": index}, f)
    with open(os.path.join(part, "aux.pkl"), "wb") as f:
        pickle.dump({"format": FORMAT, "structure": structure, "others": others}, f)
    shutil.rmtree(path, ignore_errors=True)
    os.replace(part, path)
    return path


def _refuse_jax_orbax(path: str, why: str):
    raise NotImplementedError(
        f"{path} is an orbax snapshot directory written by the JAX package ({why}): the "
        "port resumes only its own snapshots, in either format (the JAX package's nets, "
        "optimizer states and PRNG key do not map onto them, and it reads no "
        "orbax/tensorstore arrays); run_evaluate and --pretrain read the JAX package's "
        "posenet checkpoints (ckpt_best_*.ckpt)")


def load_ckpt_orbax(path: str) -> dict:
    """A directory of :func:`save_ckpt_orbax`, its tensors on the CPU.  The
    JAX package's orbax directories are refused (``NotImplementedError``)."""
    index_path = os.path.join(path, "arrays", "index.json")
    if not os.path.exists(index_path):
        markers = [m for m in ("manifest.ocdbt", "_METADATA", "_CHECKPOINT_METADATA")
                   if os.path.exists(os.path.join(path, "arrays", m))]
        _refuse_jax_orbax(path, f"arrays/ holds {', '.join(markers)}" if markers
                          else "arrays/ holds no index.json")
    with open(index_path) as f:
        index = json.load(f)
    if index.get("format") != FORMAT:
        raise ValueError(f"{path}: unknown snapshot format {index.get('format')!r} "
                         f"(expected {FORMAT!r})")
    try:
        with open(os.path.join(path, "aux.pkl"), "rb") as f:
            aux = _NumpyOnlyUnpickler(f).load()
    except pickle.UnpicklingError as exc:
        if "jax" in str(exc):
            _refuse_jax_orbax(path, "its aux.pkl names jax globals")
        raise
    arrays = {}
    for key, leaf in index["leaves"].items():
        a = np.load(os.path.join(path, "arrays", leaf["file"]), allow_pickle=False)
        if leaf["kind"] == "tensor":
            t = torch.from_numpy(a)
            arrays[key] = t.view(torch.bfloat16) if leaf["dtype"] == "bfloat16" else t
        else:
            arrays[key] = a
    return _unflatten(aux["structure"], arrays, aux["others"])


def save_snapshot(state: dict, ckpt_dir: str, suffix: str, fmt: str = "pickle") -> str:
    """Full-state snapshot save (``--ckpt_format``): 'pickle' writes one
    ``ckpt_<suffix>.ckpt`` file, 'orbax' a ``ckpt_<suffix>/`` directory."""
    if fmt == "orbax":
        return save_ckpt_orbax(state, ckpt_dir, suffix=suffix)
    if fmt != "pickle":
        raise ValueError(f"unknown --ckpt_format {fmt!r} (pickle|orbax)")
    return save_ckpt(state, ckpt_dir, suffix=suffix)


def load_snapshot(path: str) -> dict:
    """Load a snapshot written by :func:`save_snapshot` in either format:
    a directory is an orbax snapshot.  A raw pickle is the JAX package's
    and does not resume."""
    if os.path.isdir(path):
        return load_ckpt_orbax(path)
    if is_raw_pickle(path):
        raise NotImplementedError(
            f"{path} is a JAX package checkpoint (a raw pickle): the port resumes only its "
            "own snapshots (the JAX package's nets, optimizer states and PRNG key do not map "
            "onto them); run_evaluate and --pretrain read its posenet checkpoints")
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
    """A posenet checkpoint as a dict: a port ``.ckpt`` as written, a JAX
    package checkpoint as it pickled it (flax trees of numpy arrays), a
    reference ``.pth.tar`` as ``{'state_dict': <its posenet state_dict>}``."""
    if is_torch_checkpoint(path):
        return {"state_dict": load_torch_checkpoint(path)}
    if not os.path.isdir(path) and is_raw_pickle(path):
        return load_jax_ckpt(path)
    return load_snapshot(path)


def _is_flax_tree(saved: Mapping) -> bool:
    """flax params nest a dict per module; a state_dict maps names to tensors."""
    return any(isinstance(v, Mapping) for v in saved.values())


def resolve_posenet_weights(ckpt: Mapping, net: torch.nn.Module, name: str) -> torch.nn.Module:
    """Load a checkpoint's weights into ``net``, the ``name`` posenet, from
    any of the layouts: 'state_dict' (``run_baseline``, a reference
    ``.pth.tar``), 'model_pos' (``run_fk_gan``'s best-posenet saves), each
    as a port state_dict (strictly by name) or as the JAX package's flax
    trees with their 'batch_stats' (``convert.load_posenet``), and the
    full-state 'pos_state' of a ``--snapshot``/``--resume`` snapshot.
    Shared by ``run_evaluate`` and ``run_baseline``'s ``--pretrain`` warm
    start."""
    saved = ckpt.get("state_dict", ckpt.get("model_pos"))
    if saved is None and "pos_state" in ckpt:
        saved = ckpt["pos_state"]["model"]
    if saved is None:
        raise SystemExit(f"unsupported checkpoint format: keys {sorted(ckpt)} (expected "
                         "'state_dict', 'model_pos', or a full-state 'pos_state')")
    if _is_flax_tree(saved):
        return load_posenet(name, net, saved, ckpt.get("batch_stats"))
    return load_posenet_state_dict(net, saved)


def net_state(net: torch.nn.Module, opt: torch.optim.Optimizer) -> dict:
    """A net and its optimizer, as a snapshot holds them: in the
    single-device layout (every rank of a model group calls this)."""
    return {"model": full_state_dict(net), "opt": full_optimizer_state(opt, net)}


def restore_net(net: torch.nn.Module, opt: torch.optim.Optimizer, saved: Mapping) -> None:
    """Load :func:`net_state`'s dict, cut to this rank's column blocks."""
    restore_into(net, local_state_dict(net, saved["model"]))
    opt.load_state_dict(local_optimizer_state(opt, net, saved["opt"]))


def generator_state(generator: torch.Generator, device: torch.device) -> dict:
    return {"device": device.type, "state": generator.get_state()}


def restore_generator(generator: torch.Generator, saved: Mapping, device: torch.device,
                      seed: int) -> None:
    """Take the snapshot's ``torch.Generator`` stream back where it was
    written on this device type; a CUDA state cannot seed a CPU generator
    or the reverse, so there it is reseeded with ``seed``."""
    if saved["device"] == device.type:
        generator.set_state(saved["state"])
    else:
        generator.manual_seed(seed)
        print(f"==> the snapshot's torch.Generator stream is for {saved['device']}; "
              f"reseeded for {device.type}")
