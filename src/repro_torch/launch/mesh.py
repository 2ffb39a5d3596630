"""Process groups for the sharded store's collective query.

The JAX package lays the sharded store's stacked buffer over the
``data`` axis of a device mesh (``local_data_mesh``), and one
``shard_map`` program scans every device's slots.  The port runs one
process (a rank) per device instead, joined by a ``torch.distributed``
process group: ``DataGroup`` is the port's word for that mesh, and every
function that takes ``mesh=`` in the JAX package takes ``group=`` here.

- ``local_data_group`` joins the group this process was started in (the
  ``torchrun`` variables ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
  ``MASTER_PORT``), or returns ``None`` when fewer than ``min_devices``
  ranks exist, as ``local_data_mesh`` returns ``None`` for fewer
  devices.
- ``run_ranks`` starts ``world_size`` ranks of a function from one
  process (the spawn start method: CUDA cannot be re-initialised in a
  forked child; the ranks meet through a file, so no port is picked),
  joins them under a time limit, kills the rest when one
  fails or hangs, and returns each rank's result.

NCCL serves ranks that each have a card of their own; ranks that share a
card, or run on the CPU, join a gloo group.  Every group is made with an
explicit timeout, so a rank left alone in a collective raises instead of
hanging.  Importing this module starts no group and no process.

``make_production_mesh`` and ``make_local_mesh`` name the ranks of the
default group as a ``DeviceMesh`` with the JAX package's axes: (16, 16)
``data, model`` or (2, 16, 16) ``pod, data, model`` for production.  On
an HGX H100 a 16-wide ``model`` axis spans two 8-card NVLink domains.
Only the dry run (``launch/dryrun.py``) builds a production mesh, over
a fake group of 256 or 512 ranks.
"""
from __future__ import annotations

import datetime
import multiprocessing
import os
import queue
import shutil
import sys
import tempfile
import time
import traceback
from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.common.sharding import MeshShape
from repro_torch.kernels.common import resolve_device

GROUP_TIMEOUT_S = 120.0      # a collective that waits longer raises
RUN_TIMEOUT_S = 600.0        # run_ranks kills every rank past this
# thread pools of the numeric libraries, which ranks on the CPU share
_THREAD_VARS = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS",
                "MKL_NUM_THREADS")


def production_mesh_shape(multi_pod: bool = False) -> MeshShape:
    """The production mesh's axes and sizes (no group needed)."""
    if multi_pod:
        return MeshShape((2, 16, 16), ("pod", "data", "model"))
    return MeshShape((16, 16), ("data", "model"))


def device_mesh(shape: MeshShape, device_type: str, exact: bool = True):
    """A ``DeviceMesh`` over ranks ``0 .. prod(shape) - 1`` of the
    default group, row-major (``jax.make_mesh``'s device order); every
    rank of the group unless not ``exact``."""
    from torch.distributed.device_mesh import DeviceMesh
    if not dist.is_initialized():
        raise RuntimeError("a mesh names the ranks of a process group: "
                           "initialize one first")
    world = dist.get_world_size()
    if world < shape.size or (exact and world != shape.size):
        raise ValueError(f"a {shape.sizes} mesh needs {shape.size} ranks, "
                         f"the group has {dist.get_world_size()}")
    ranks = torch.arange(shape.size, dtype=torch.int64).reshape(shape.sizes)
    return DeviceMesh(device_type, ranks, mesh_dim_names=shape.axis_names)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The production mesh over the default group, which must have 256
    ranks (512 with ``multi_pod``)."""
    return device_mesh(production_mesh_shape(multi_pod), device_type)


def make_local_mesh(n_devices: Optional[int] = None, model: int = 1, *,
                    device_type: str = "cuda"):
    """A (n / model, model) ``data, model`` mesh over the default
    group's ``n_devices`` ranks (all of them by default; tests)."""
    n = n_devices or dist.get_world_size()
    if n % model:
        raise ValueError(f"{n} ranks do not divide a model axis of {model}")
    return device_mesh(MeshShape((n // model, model), ("data", "model")),
                        device_type, exact=False)


@dataclass(frozen=True)
class DataGroup:
    """One rank's view of the process group that holds a sharded store:
    the group, this process's ``rank`` in it, the ``world_size``, the
    ``device`` its tensors live on and the ``backend`` (``nccl`` or
    ``gloo``).  The collectives below are the only ones the store
    uses."""

    pg: Any
    rank: int
    world_size: int
    device: torch.device
    backend: str

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` (equal shapes) concatenated along dim 0 in
        rank order, on ``t``'s device.  Both backends take CUDA tensors
        (gloo copies them through the host itself)."""
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.world_size)]
        dist.all_gather(parts, t, group=self.pg)
        return torch.cat(parts)

    def broadcast(self, t: torch.Tensor, src: int) -> torch.Tensor:
        """Rank ``src``'s ``t``, on every rank (other ranks pass a
        tensor of the same shape and dtype to receive into)."""
        t = t.contiguous()
        dist.broadcast(t, src=src, group=self.pg)
        return t

    def barrier(self) -> None:
        dist.barrier(group=self.pg)


def _backend(device: torch.device, world_size: int) -> str:
    if device.type == "cuda" and torch.cuda.device_count() >= world_size:
        return "nccl"
    return "gloo"


def local_data_group(min_devices: int = 2,
                     n_devices: Optional[int] = None, *, device=None,
                     timeout_s: float = GROUP_TIMEOUT_S,
                     store: Optional[dist.Store] = None
                     ) -> Optional[DataGroup]:
    """This process's rank of the group over the first ``n_devices``
    ranks (all of them by default), or ``None`` when fewer than
    ``max(min_devices, n_devices)`` ranks exist or this rank is not
    among the first ``n_devices``.

    The ranks come from the ``torchrun`` environment (``WORLD_SIZE``
    and ``RANK``, 1 and 0 when unset).  Several ranks meet through
    ``store`` when given (``run_ranks`` passes a ``FileStore``), else
    through ``MASTER_ADDR`` and ``MASTER_PORT``.  ``device`` is the
    tensors' device (``cuda`` unless asked for another; a rank takes
    card ``rank % device_count``).  The default process group is made
    on the first call, with ``timeout_s`` on every collective."""
    device = resolve_device(device)
    if dist.is_initialized():
        n_avail, rank = dist.get_world_size(), dist.get_rank()
    else:
        n_avail = int(os.environ.get("WORLD_SIZE", "1"))
        rank = int(os.environ.get("RANK", "0"))
    n = n_devices or n_avail
    if n_avail < max(min_devices, n):
        return None
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", rank % torch.cuda.device_count())
    if device.type == "cuda":
        torch.cuda.set_device(device)
    backend = _backend(device, n_avail)
    timeout = datetime.timedelta(seconds=timeout_s)
    if not dist.is_initialized():
        if store is None and n_avail == 1:
            store = dist.HashStore()
        if store is not None:
            dist.init_process_group(backend, store=store, rank=rank,
                                    world_size=n_avail, timeout=timeout)
        else:
            dist.init_process_group(backend, init_method="env://",
                                    rank=rank, world_size=n_avail,
                                    timeout=timeout)
    backend = dist.get_backend()
    pg = dist.group.WORLD
    if n < n_avail:
        # every rank takes part in making a subgroup
        pg = dist.new_group(list(range(n)), timeout=timeout,
                            backend=backend)
        if rank >= n:
            return None
    return DataGroup(pg=pg, rank=rank, world_size=n, device=device,
                     backend=backend)


def _rank_main(fn: Callable, rank: int, world_size: int,
               store_path: str, device: str, timeout_s: float,
               args: Sequence, results: "multiprocessing.Queue") -> None:
    """A spawned rank: join the group through the file at
    ``store_path``, run ``fn(group, *args)``, report its result (or the
    traceback) to the parent."""
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank),
                      WORLD_SIZE=str(world_size))
    try:
        group = local_data_group(
            min_devices=1, device=device, timeout_s=timeout_s,
            store=dist.FileStore(store_path, world_size))
        out = fn(group, *args)
    except Exception:    # the process boundary: report, then exit 1
        results.put((rank, False, traceback.format_exc()))
        sys.exit(1)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    results.put((rank, True, out))


def _stop(procs: List) -> None:
    for p in procs:
        if p.is_alive():
            p.terminate()
    for p in procs:
        p.join(5)
        if p.is_alive():
            p.kill()
            p.join(5)


def run_ranks(fn: Callable, world_size: int, *, device=None,
              timeout_s: float = RUN_TIMEOUT_S,
              args: Sequence = ()) -> List[Any]:
    """Run ``fn(group, *args)`` on ``world_size`` spawned ranks of one
    group on ``device`` (``cuda`` unless asked for ``cpu``) and return
    their results in rank order.

    ``fn`` and ``args`` are pickled: ``fn`` must be a module-level
    function of a module the ranks can import.  The ranks' collectives
    time out after ``timeout_s``, and the whole run is killed after it:
    a rank that fails, exits without a result or outlives the limit
    stops every other rank, and ``run_ranks`` raises.  The ranks meet
    through a file in a fresh directory under ``tempfile.gettempdir()``
    (no port to pick), removed when they are done."""
    device = str(resolve_device(device))
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    meet = tempfile.mkdtemp(prefix="run_ranks_")
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, world_size,
                               os.path.join(meet, "store"), device,
                               timeout_s, tuple(args), results))
             for r in range(world_size)]
    # ranks on the CPU split the host's cores: a child reads its thread
    # counts from the environment it starts with
    threads = str(max(1, (os.cpu_count() or 1) // world_size))
    saved = {v: os.environ.get(v) for v in _THREAD_VARS}
    if device == "cpu":
        os.environ.update(dict.fromkeys(_THREAD_VARS, threads))
    try:
        for p in procs:
            p.start()
    finally:
        for var, val in saved.items():
            if val is None:
                os.environ.pop(var, None)
            else:
                os.environ[var] = val
    out = {}
    deadline = time.monotonic() + timeout_s
    try:
        while len(out) < world_size:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"run_ranks: {world_size - len(out)} of {world_size} "
                    f"ranks gave no result within {timeout_s:.0f} s")
            try:
                rank, ok, payload = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                lost = [r for r, p in enumerate(procs)
                        if r not in out and p.exitcode not in (None, 0)]
                if lost:
                    raise RuntimeError(
                        f"run_ranks: rank {lost[0]} exited "
                        f"{procs[lost[0]].exitcode} without a result")
                continue
            if not ok:
                raise RuntimeError(f"run_ranks: rank {rank} failed:\n"
                                   f"{payload}")
            out[rank] = payload
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
        codes = [p.exitcode for p in procs]
        if any(c != 0 for c in codes):
            raise RuntimeError(f"run_ranks: exit codes {codes}")
    finally:
        _stop(procs)
        shutil.rmtree(meet, ignore_errors=True)
    return [out[r] for r in range(world_size)]
