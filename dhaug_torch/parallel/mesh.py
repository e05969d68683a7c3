"""Data and tensor parallelism over processes: one rank a device, ``torch.distributed``.

Port of ``dhaug_tpu/parallel/mesh.py`` (``make_mesh``, ``shard_index_rows``,
``mesh_from_args``).  The JAX package runs one compiled epoch program on a
(data, model) mesh and lets GSPMD shard the batch and the wide layers and
insert the collectives; the port runs one process a device and does the
same by hand, so that D x M ranks equal one device up to the order of
reductions.  Global rank ``r`` sits at data index ``r // M`` and model
index ``r % M``, the JAX mesh's placement of device ``r`` (``make_mesh``);
the ranks of one model index form a data group, those of one data index a
model group.

On the data axis:

* every rank holds the whole epoch data and draws every random number at
  the GLOBAL batch shape (the same seeds on every rank), then takes its own
  rows ``[d*B/D, (d+1)*B/D)`` (:meth:`DataParallel.rows`);
* the gradients of each optimizer step are averaged over the data group in
  one flattened all-reduce before any clipping (:meth:`DataParallel.
  all_reduce_grads`), so every rank applies the same update; the weights
  are broadcast from data index 0 once, at start and after a resume;
* batch norm in train mode averages over the global batch
  (``models/posenets.py``) through the autograd-aware :func:`sum_across`;
* buffers that span ranks (the GAN's fakes) are gathered in rank order
  (:meth:`DataParallel.all_gather_rows`) and scalars averaged.

The model axis (:class:`ModelAxis`, ``DataParallel.model``) holds the
column blocks of the wide layers (``parallel/tensor.py``); every other
tensor, activations included, is the same on every rank of a model group.

:func:`current` is the rank's :class:`DataParallel`; outside a group it is
a single device (rank 0 of 1, no collectives).  It is state of the process,
as ``torch.distributed``'s default group is: a process is one rank, and the
nets' batch norm, dropout and tensor-parallel layers read it where no
argument reaches them.  :func:`join` makes this process a rank of a group,
:func:`launch` starts one process a device (``spawn``) and
:func:`launch_from_args` is the CLIs' ``--data_parallel_devices`` /
``--model_parallel_devices`` entry point, with the JAX package's checks.
Backends: NCCL on cards (a card a rank), gloo on the CPU; the library
launcher also takes gloo with several ranks on one card, which the CLI
never picks by itself.

``COLLECTIVE_CALLS`` / ``COLLECTIVE_SECONDS`` count this process's
collectives and the host seconds spent in them (with gloo a call returns
when its data is reduced; with NCCL when it is queued), so a run can say
what share of its time the collectives take.
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


def _gather_parts(x: torch.Tensor, world: int, group, backend) -> List[torch.Tensor]:
    """Every rank's ``x`` of a group, in rank order.  gloo's all_gather of
    a CUDA tensor is staged through host memory (and a bf16 one through
    fp32, which it holds exactly): this keeps to the collectives gloo runs
    on every build; NCCL stays on the card."""
    x = x.contiguous()
    if backend == "gloo" and (x.device.type == "cuda" or x.dtype == torch.bfloat16):
        host = x.detach().cpu()
        host = host.float() if host.dtype == torch.bfloat16 else host
        parts = [torch.empty_like(host) for _ in range(world)]
        _collective(dist.all_gather, parts, host, group=group)
        return [p.to(x.device, x.dtype) for p in parts]
    parts = [torch.empty_like(x) for _ in range(world)]
    _collective(dist.all_gather, parts, x, group=group)
    return parts


class ModelAxis:
    """A rank's place on the model axis: ``rank`` of ``world`` ranks that
    each hold a column block of the wide layers (``parallel/tensor.py``).
    With ``group`` None it is one rank and runs no collective."""

    def __init__(self, rank: int = 0, world: int = 1, group=None,
                 backend: Optional[str] = None):
        self.rank, self.world, self.group, self.backend = rank, world, group, backend

    def block(self, n: int) -> slice:
        """This rank's block of ``n`` columns (``n`` divisible by the axis)."""
        k = n // self.world
        return slice(self.rank * k, (self.rank + 1) * k)

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the model group, in place."""
        if self.group is not None:
            if self.backend == "gloo" and t.dtype == torch.bfloat16:
                t.copy_(self.all_reduce_(t.float()))
            else:
                _collective(dist.all_reduce, t, group=self.group)
        return t

    def all_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The model group's blocks of ``x`` concatenated along ``dim``."""
        if self.group is None:
            return x
        return torch.cat(_gather_parts(x, self.world, self.group, self.backend), dim)


class DataParallel:
    """A rank's place on the data axis: ``rank`` of ``world`` data-parallel
    ranks on ``device``, with its model axis (``model``) and its global
    rank of ``global_world``.  With ``group`` None the data axis is one
    rank and runs no collective."""

    def __init__(self, rank: int = 0, world: int = 1, device=None, group=None,
                 backend: Optional[str] = None, model: Optional[ModelAxis] = None,
                 global_rank: int = 0, global_world: int = 1):
        self.rank, self.world = rank, world
        self.device = None if device is None else torch.device(device)
        self.group, self.backend = group, backend
        self.model = model if model is not None else ModelAxis()
        self.global_rank, self.global_world = global_rank, global_world

    @property
    def is_main(self) -> bool:
        """Global rank 0 writes the run's files."""
        return self.global_rank == 0

    @property
    def sharded(self) -> bool:
        """True when the batch is split over more than one rank."""
        return self.world > 1

    @property
    def src(self) -> int:
        """The global rank of this data group's data index 0."""
        return self.model.rank

    def rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a global-batch tensor (leading axis)."""
        if self.world == 1:
            return x
        n = x.shape[0] // self.world
        return x[self.rank * n:(self.rank + 1) * n]

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the data group, in place."""
        if self.group is not None:
            _collective(dist.all_reduce, t, group=self.group)
        return t

    def mean(self, t: torch.Tensor) -> torch.Tensor:
        """The mean of ``t`` over the data group (a new tensor)."""
        if self.group is None:
            return t
        return self.all_reduce_(t.clone()) / self.world

    def all_reduce_grads(self, grads: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """The data group's mean of each gradient: one flattened all-reduce.
        A column block's gradient is whole on its rank and a replicated
        parameter's the same on every rank of a model group, so the model
        axis needs none."""
        grads = list(grads)
        if self.group is None or not grads:
            return grads
        flat = self.all_reduce_(torch.cat([g.reshape(-1) for g in grads])) / self.world
        return [f.view_as(g) for f, g in zip(flat.split([g.numel() for g in grads]), grads)]

    def broadcast_modules(self, *modules: torch.nn.Module) -> None:
        """Data index 0's parameters and buffers onto every rank of the data
        group (a rank's column blocks from the rank that holds the same
        blocks)."""
        if self.group is None:
            return
        with torch.no_grad():
            for module in modules:
                for t in list(module.parameters()) + list(module.buffers()):
                    _collective(dist.broadcast, t.data, src=self.src, group=self.group)

    def barrier(self) -> None:
        """Wait until every rank of the job gets here."""
        if self.global_world > 1:
            _collective(dist.all_reduce, torch.zeros(1, device=self.device))

    def broadcast_object(self, obj):
        """Global rank 0's picklable ``obj`` on every rank of the job."""
        if self.global_world == 1:
            return obj
        box = [obj]
        dist.broadcast_object_list(box, src=0,
                                   device=self.device if self.backend == "nccl" else None)
        return box[0]

    def all_gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """The data group's ``x`` concatenated along the leading axis, in
        rank order, on every rank."""
        if self.group is None:
            return x
        return torch.cat(_gather_parts(x, self.world, self.group, self.backend))


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


def join(backend: str, device, rank: int, world: int, init_method: str,
         model_parallel: int = 1) -> DataParallel:
    """Make this process global rank ``rank`` of ``world`` = D x M on
    ``device`` (M = ``model_parallel``) and the current
    :class:`DataParallel`: data index ``rank // M``, model index
    ``rank % M``.  Every rank makes every group, in the same order."""
    global _CURRENT
    if world % model_parallel:
        raise ValueError(f"{world} ranks do not make a grid of --model_parallel_devices "
                         f"{model_parallel}")
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank)
    M, D = model_parallel, world // model_parallel
    d, m = divmod(rank, M)
    if M == 1:
        data_group, model_group = dist.group.WORLD, None
    elif D == 1:
        data_group, model_group = None, dist.group.WORLD
    else:
        data_groups = [dist.new_group([i * M + j for i in range(D)]) for j in range(M)]
        model_groups = [dist.new_group([i * M + j for j in range(M)]) for i in range(D)]
        data_group, model_group = data_groups[m], model_groups[d]
    _CURRENT = DataParallel(d, D, device, data_group, backend,
                            ModelAxis(m, M, model_group, backend), rank, world)
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


def _worker(rank, target, args, devices, backend, init_method, out_dir, threads,
            model_parallel):
    if threads:
        torch.set_num_threads(threads)
    join(backend, devices[rank], rank, len(devices), init_method, model_parallel)
    try:
        module, name = target.split(":")
        out = getattr(importlib.import_module(module), name)(*args)
        path = os.path.join(out_dir, f"rank{rank}.pt")
        torch.save(out, path + ".part")
        os.replace(path + ".part", path)
    finally:
        leave()


def launch(target: str, args: tuple, devices: Sequence, backend: str,
           threads: Optional[int] = None, model_parallel: int = 1) -> list:
    """Run ``module:function`` (``target``) with ``args`` on ``len(devices)``
    ranks, one process each (start method ``spawn``), rank r on
    ``devices[r]``, in a grid of ``model_parallel`` ranks a model group
    (:func:`join`); returns every rank's return value, in rank order.  A
    rank that fails fails the launch.  ``threads`` sets each rank's
    intra-op threads."""
    devices = [str(d) for d in devices]
    out_dir = tempfile.mkdtemp(prefix="dhaug_dp_")
    try:
        torch.multiprocessing.start_processes(
            _worker, args=(target, args, devices, backend,
                           f"tcp://localhost:{free_port()}", out_dir, threads, model_parallel),
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
                threads: Optional[int] = None, model_parallel: int = 1) -> dict:
    """``module.main(argv)`` on one rank a device (:func:`run_main`), in a
    grid of ``model_parallel`` ranks a model group; returns global rank 0's
    result with ``rank_launches`` and ``ranks``, each rank's kernel launch
    counts and its ``rank`` entry."""
    results = launch("dhaug_torch.parallel.mesh:run_main", (module, list(argv)), devices,
                     backend, threads, model_parallel)
    out = results[0]
    out["rank_launches"] = [r.pop("launches") for r in results]
    out["ranks"] = [r.pop("rank") for r in results]
    return out


def visible_devices(device_type: str) -> int:
    """Devices a rank can take: the cards, or the CPU's cores."""
    if device_type == "cuda":
        return torch.cuda.device_count()
    return os.cpu_count() or 1


def check_request(n_data: int, n_model: int, batch_size: int, device_type: str) -> None:
    """The JAX package's checks of ``mesh_from_args`` (mesh.py:107-120),
    in its words, before any device work."""
    have, total = visible_devices(device_type), n_data * n_model
    if have < total:
        raise SystemExit(
            f"--data_parallel_devices {n_data} x --model_parallel_devices {n_model} requests "
            f"{total} devices but only {have} device(s) are visible on platform "
            f"'{device_type}'")
    if batch_size % n_data != 0:
        raise SystemExit(f"--batch_size {batch_size} is not divisible by "
                         f"--data_parallel_devices {n_data}")


def launch_from_args(args, module: str, argv) -> Optional[dict]:
    """``--data_parallel_devices D`` and ``--model_parallel_devices M`` for
    a CLI's ``main``.  Returns None when this process runs the job itself:
    one device, or already a rank (started here, joined by the caller, or
    under ``torchrun``, whose group of D x M ranks it joins); otherwise
    starts D x M ranks of ``module.main(argv)`` (NCCL on D x M cards, gloo
    on the CPU) and returns global rank 0's result."""
    n_data = max(int(args.data_parallel_devices or 0), 1)
    n_model = max(int(args.model_parallel_devices or 0), 1)
    device_type = torch.device(args.device).type
    if not dist.is_initialized() and "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        local = int(os.environ.get("LOCAL_RANK", 0))
        join("nccl" if device_type == "cuda" else "gloo",
             f"cuda:{local}" if device_type == "cuda" else "cpu",
             int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]), "env://", n_model)
    dp = current()
    if dist.is_initialized():
        if (n_data > 1 and n_data != dp.world) or n_model != dp.model.world:
            raise SystemExit(f"--data_parallel_devices {n_data} x --model_parallel_devices "
                             f"{n_model} does not match the {dp.world} x {dp.model.world} "
                             "ranks of the group this process joined")
        if args.batch_size % dp.world != 0:
            raise SystemExit(f"--batch_size {args.batch_size} is not divisible by "
                             f"--data_parallel_devices {dp.world}")
        return None
    if n_data * n_model == 1:
        return None
    check_request(n_data, n_model, args.batch_size, device_type)
    n = n_data * n_model
    if device_type == "cuda":
        devices, backend, threads = [f"cuda:{i}" for i in range(n)], "nccl", None
    else:
        devices, backend = ["cpu"] * n, "gloo"
        threads = max(1, torch.get_num_threads() // n)
    print(f"==> Parallel grid: {n_data} x {n_model} ranks (data x model) on {device_type} "
          f"({backend})")
    return launch_main(module, list(argv), devices, backend, threads, n_model)
