"""Data parallelism over processes: one rank a device, ``torch.distributed``.

Port of the data axis of ``dhaug_tpu/parallel/mesh.py`` (``make_mesh``,
``shard_index_rows``, ``mesh_from_args``).  The JAX package runs one
compiled epoch program on a mesh and lets GSPMD shard the batch and insert
the gradient all-reduce; the port runs one process a device and does the
same by hand, so that N ranks equal one device up to the order of
reductions:

* every rank holds the whole epoch data and draws every random number at
  the GLOBAL batch shape (the same seeds on every rank), then takes its own
  rows ``[r*B/N, (r+1)*B/N)`` (:meth:`DataParallel.rows`);
* the gradients of each optimizer step are averaged over the ranks in one
  flattened all-reduce before any clipping (:meth:`DataParallel.
  all_reduce_grads`), so every rank applies the same update; the weights
  are broadcast from rank 0 once, at start and after a resume;
* batch norm in train mode averages over the global batch
  (``models/posenets.py``) through the autograd-aware :func:`sum_across`;
* buffers that span ranks (the GAN's fakes) are gathered in rank order
  (:meth:`DataParallel.all_gather_rows`) and scalars averaged.

:func:`current` is the rank's :class:`DataParallel`; outside a group it is
a single device (rank 0 of 1, no collectives).  It is state of the process,
as ``torch.distributed``'s default group is: a process is one rank, and the
nets' batch norm and dropout read it where no argument reaches them.  :func:`join` makes this
process a rank of a group, :func:`launch` starts one process a device
(``spawn``) and :func:`launch_from_args` is the CLIs' ``--data_parallel_
devices`` entry point, with the JAX package's checks.  Backends: NCCL on
cards (a card a rank), gloo on the CPU; the library launcher also takes
gloo with several ranks on one card, which the CLI never picks by itself.

``COLLECTIVE_CALLS`` / ``COLLECTIVE_SECONDS`` count this process's
collectives and the host seconds spent in them (with gloo a call returns
when its data is reduced; with NCCL when it is queued), so a run can say
what share of its time the all-reduces take.
"""
from __future__ import annotations

import importlib
import os
import shutil
import socket
import tempfile
import time
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

COLLECTIVE_CALLS = 0
COLLECTIVE_SECONDS = 0.0


def _collective(fn, *args, **kwargs):
    global COLLECTIVE_CALLS, COLLECTIVE_SECONDS
    t0 = time.perf_counter()
    fn(*args, **kwargs)
    COLLECTIVE_SECONDS += time.perf_counter() - t0
    COLLECTIVE_CALLS += 1


class DataParallel:
    """A rank of a data-parallel group: ``rank`` of ``world`` on ``device``.
    With ``group`` None it is a single device and runs no collective."""

    def __init__(self, rank: int = 0, world: int = 1, device=None, group=None,
                 backend: Optional[str] = None):
        self.rank, self.world = rank, world
        self.device = None if device is None else torch.device(device)
        self.group, self.backend = group, backend

    @property
    def is_main(self) -> bool:
        """Rank 0 writes the run's files."""
        return self.rank == 0

    @property
    def sharded(self) -> bool:
        """True when the batch is split over more than one rank."""
        return self.world > 1

    def rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a global-batch tensor (leading axis)."""
        if self.world == 1:
            return x
        n = x.shape[0] // self.world
        return x[self.rank * n:(self.rank + 1) * n]

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the ranks, in place."""
        if self.group is not None:
            _collective(dist.all_reduce, t, group=self.group)
        return t

    def mean(self, t: torch.Tensor) -> torch.Tensor:
        """The mean of ``t`` over the ranks (a new tensor)."""
        if self.group is None:
            return t
        return self.all_reduce_(t.clone()) / self.world

    def all_reduce_grads(self, grads: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """The ranks' mean of each gradient: one flattened all-reduce."""
        grads = list(grads)
        if self.group is None or not grads:
            return grads
        flat = self.all_reduce_(torch.cat([g.reshape(-1) for g in grads])) / self.world
        return [f.view_as(g) for f, g in zip(flat.split([g.numel() for g in grads]), grads)]

    def broadcast_modules(self, *modules: torch.nn.Module) -> None:
        """Rank 0's parameters and buffers onto every rank."""
        if self.group is None:
            return
        with torch.no_grad():
            for module in modules:
                for t in list(module.parameters()) + list(module.buffers()):
                    _collective(dist.broadcast, t.data, src=0, group=self.group)

    def barrier(self) -> None:
        """Wait until every rank gets here."""
        self.all_reduce_(torch.zeros(1, device=self.device))

    def broadcast_object(self, obj):
        """Rank 0's picklable ``obj`` on every rank."""
        if self.group is None:
            return obj
        box = [obj]
        dist.broadcast_object_list(box, src=0, group=self.group,
                                   device=self.device if self.backend == "nccl" else None)
        return box[0]

    def all_gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """The ranks' ``x`` concatenated along the leading axis, in rank
        order, on every rank."""
        if self.group is None:
            return x
        x = x.contiguous()
        if self.backend == "gloo" and x.device.type == "cuda":
            # gloo's all_gather is staged through host memory here: the
            # gathered buffer is small (once an epoch) and this keeps to the
            # collectives gloo runs on every build; NCCL stays on the card
            parts = [torch.empty_like(x, device="cpu") for _ in range(self.world)]
            _collective(dist.all_gather, parts, x.cpu(), group=self.group)
            return torch.cat(parts).to(x.device)
        parts = [torch.empty_like(x) for _ in range(self.world)]
        _collective(dist.all_gather, parts, x, group=self.group)
        return torch.cat(parts)


SINGLE = DataParallel()
_CURRENT = SINGLE


def current() -> DataParallel:
    """This process's rank (a single device outside a group)."""
    return _CURRENT


class _SumAcross(torch.autograd.Function):
    """All-reduce (sum) whose gradient is the all-reduced gradient: each
    rank's output feeds its own loss, so the cotangent of a rank's input is
    the sum of every rank's cotangent of the shared output."""

    @staticmethod
    def forward(ctx, t):
        return current().all_reduce_(t.clone())

    @staticmethod
    def backward(ctx, g):
        return current().all_reduce_(g.clone())


def sum_across(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the ranks, differentiably."""
    return _SumAcross.apply(t) if current().group is not None else t


def join(backend: str, device, rank: int, world: int, init_method: str) -> DataParallel:
    """Make this process rank ``rank`` of ``world`` on ``device`` and the
    current :class:`DataParallel`."""
    global _CURRENT
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank)
    _CURRENT = DataParallel(rank, world, device, dist.group.WORLD, backend)
    return _CURRENT


def leave() -> None:
    """Leave the group and run as a single device again."""
    global _CURRENT
    if dist.is_initialized():
        dist.destroy_process_group()
    _CURRENT = SINGLE


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _worker(rank, target, args, devices, backend, init_method, out_dir, threads):
    if threads:
        torch.set_num_threads(threads)
    join(backend, devices[rank], rank, len(devices), init_method)
    try:
        module, name = target.split(":")
        out = getattr(importlib.import_module(module), name)(*args)
        path = os.path.join(out_dir, f"rank{rank}.pt")
        torch.save(out, path + ".part")
        os.replace(path + ".part", path)
    finally:
        leave()


def launch(target: str, args: tuple, devices: Sequence, backend: str,
           threads: Optional[int] = None) -> list:
    """Run ``module:function`` (``target``) with ``args`` on ``len(devices)``
    ranks, one process each (start method ``spawn``), rank r on
    ``devices[r]``; returns every rank's return value, in rank order.  A
    rank that fails fails the launch.  ``threads`` sets each rank's
    intra-op threads."""
    devices = [str(d) for d in devices]
    out_dir = tempfile.mkdtemp(prefix="dhaug_dp_")
    try:
        torch.multiprocessing.start_processes(
            _worker, args=(target, args, devices, backend,
                           f"tcp://localhost:{free_port()}", out_dir, threads),
            nprocs=len(devices), start_method="spawn", join=True)
        return [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
                for r in range(len(devices))]
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)


def kernel_launches() -> dict:
    """This process's launch counts of the kernels B1, B2 and B3."""
    from dhaug_torch.models import trunk_cuda
    from dhaug_torch.ops import fk_cuda
    return {"fwd": fk_cuda.FWD_LAUNCHES, "bwd": fk_cuda.BWD_LAUNCHES,
            "trunk": trunk_cuda.TRUNK_LAUNCHES}


def run_main(module: str, argv: list) -> dict:
    """A rank's run of ``module.main(argv)``: rank 0 returns its result;
    every rank its kernel launch counts (``launches``), its wall seconds,
    start and end (``time.time()``) and collective calls and seconds
    (``rank``)."""
    started, t0 = time.time(), time.perf_counter()
    result = importlib.import_module(module).main(argv)
    out = dict(result) if current().is_main else {}
    out["launches"] = kernel_launches()
    out["rank"] = {"wall_s": time.perf_counter() - t0, "started_at": started,
                   "ended_at": time.time(), "collective_calls": COLLECTIVE_CALLS,
                   "collective_s": COLLECTIVE_SECONDS}
    return out


def launch_main(module: str, argv: list, devices: Sequence, backend: str,
                threads: Optional[int] = None) -> dict:
    """``module.main(argv)`` on one rank a device (:func:`run_main`);
    returns rank 0's result with ``rank_launches`` and ``ranks``, each
    rank's kernel launch counts and its ``rank`` entry."""
    results = launch("dhaug_torch.parallel.mesh:run_main", (module, list(argv)), devices,
                     backend, threads)
    out = results[0]
    out["rank_launches"] = [r.pop("launches") for r in results]
    out["ranks"] = [r.pop("rank") for r in results]
    return out


def visible_devices(device_type: str) -> int:
    """Devices a rank can take: the cards, or the CPU's cores."""
    if device_type == "cuda":
        return torch.cuda.device_count()
    return os.cpu_count() or 1


def check_request(n: int, batch_size: int, device_type: str) -> None:
    """The JAX package's checks of ``mesh_from_args`` (mesh.py:107-120),
    in its words, before any device work."""
    have = visible_devices(device_type)
    if have < n:
        raise SystemExit(
            f"--data_parallel_devices {n} x --model_parallel_devices 1 requests {n} "
            f"devices but only {have} device(s) are visible on platform '{device_type}'")
    if batch_size % n != 0:
        raise SystemExit(f"--batch_size {batch_size} is not divisible by "
                         f"--data_parallel_devices {n}")


def launch_from_args(args, module: str, argv) -> Optional[dict]:
    """``--data_parallel_devices N`` for a CLI's ``main``.  Returns None
    when this process runs the job itself: one device, or already a rank
    (started here, joined by the caller, or under ``torchrun``, whose
    group it joins); otherwise starts N ranks of ``module.main(argv)`` (NCCL
    on N cards, gloo on the CPU) and returns rank 0's result."""
    n = max(int(args.data_parallel_devices or 0), 1)
    device_type = torch.device(args.device).type
    if current().group is None and "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        local = int(os.environ.get("LOCAL_RANK", 0))
        join("nccl" if device_type == "cuda" else "gloo",
             f"cuda:{local}" if device_type == "cuda" else "cpu",
             int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]), "env://")
    dp = current()
    if dp.group is not None:
        if n > 1 and n != dp.world:
            raise SystemExit(f"--data_parallel_devices {n} does not match the "
                             f"{dp.world} ranks of the group this process joined")
        if args.batch_size % dp.world != 0:
            raise SystemExit(f"--batch_size {args.batch_size} is not divisible by "
                             f"--data_parallel_devices {dp.world}")
        return None
    if n == 1:
        return None
    check_request(n, args.batch_size, device_type)
    if device_type == "cuda":
        devices, backend, threads = [f"cuda:{i}" for i in range(n)], "nccl", None
    else:
        devices, backend = ["cpu"] * n, "gloo"
        threads = max(1, torch.get_num_threads() // n)
    print(f"==> Data parallel: {n} ranks on {device_type} ({backend})")
    return launch_main(module, list(argv), devices, backend, threads)
