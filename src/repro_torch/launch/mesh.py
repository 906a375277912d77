"""Rank meshes over ``torch.distributed`` (port of ``repro.launch.mesh``).

``make_host_mesh(data, model, pod=0)`` builds the :class:`~repro_torch.
distributed.sharding.Mesh` of an initialised process group (one process
per rank, ranks row-major over (data, model), or over (pod, data, model)
with ``pod`` > 0: the mesh pod-local overlay banks serve on).
``backend_for`` is the one backend rule of the port:

* NCCL when every rank has a card of its own;
* gloo otherwise — the CPU, and ranks that share one card.  Under gloo the
  collective helpers copy CUDA tensors through the host, one copy each way
  (``sharding.psum`` / ``all_gather``); the kernels still run on the card.

``spawn(fn, mesh_shape)`` (a (data, model) or (pod, data, model) shape)
starts one process per rank, initialises the group (``file://``
rendezvous in a fresh temporary directory, so runs side by side never
share a port), calls ``fn(mesh, *args)`` on every rank and
returns the ranks' results in rank order.  It joins with a deadline: a
rank that raises, or a group that outlives ``timeout_s``, ends every rank
and raises with the failing rank's traceback — a failure never hangs.
``make_production_mesh`` (256 or 512 chips) is the dry-run's, a later
slice.
"""
from __future__ import annotations

import datetime
import math
import multiprocessing as mp
import os
import pickle
import shutil
import tempfile
import time
import traceback

import torch

from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import Mesh, build_groups

# a group's deadline (spawn) and its process group's collective timeout
# (torchrun) when the caller names none: a full-width serve's build, load
# and run fit well inside it
DEFAULT_TIMEOUT_S = 1200.0


def backend_for(device: str, world: int) -> str:
    """NCCL when every rank has a card of its own, else gloo."""
    if torch.device(device).type == "cuda" \
            and torch.distributed.is_nccl_available() \
            and torch.cuda.device_count() >= world:
        return "nccl"
    return "gloo"


def rank_device(device: str, backend: str, rank: int) -> torch.device:
    """The card (or CPU) rank ``rank`` runs on: its own card under NCCL,
    card 0 (shared) under gloo."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    return torch.device("cuda", rank if backend == "nccl" else 0)


def make_host_mesh(data: int = 1, model: int = 1, pod: int = 0, *,
                   device=None) -> Mesh:
    """The (data, model) — or with ``pod`` > 0 (pod, data, model) — mesh
    of the initialised default process group, with one group per axis set
    (``sharding.build_groups``).  Raises when the world is not the mesh's
    size.  ``device`` defaults to the rank's card under the group's backend
    (``rank_device``), whatever the backend: the CPU only when asked for,
    as ``device.resolve_device`` has it."""
    dist = torch.distributed
    if not dist.is_initialized():
        raise RuntimeError("make_host_mesh needs an initialised process "
                           "group (launch.mesh.spawn or torchrun)")
    shape = (pod, data, model) if pod else (data, model)
    names = ("pod", "data", "model") if pod else ("data", "model")
    world = dist.get_world_size()
    if world != math.prod(shape):
        raise RuntimeError(f"mesh {shape} needs {math.prod(shape)} ranks, "
                           f"the process group has {world}")
    rank = dist.get_rank()
    backend = dist.get_backend()
    if device is None:
        device = rank_device(str(resolve_device()), backend, rank)
    coords, r = [], rank
    for n in reversed(shape):
        coords.insert(0, r % n)
        r //= n
    groups = build_groups(names, shape, backend)
    host = dist.new_group(list(range(world)), backend="gloo") \
        if backend != "gloo" else dist.group.WORLD
    return Mesh(names, shape, tuple(coords), backend=backend,
                device=torch.device(device), groups=groups, host_group=host)


def sub_mesh(data: int, model: int, *, device=None):
    """The (data, model) mesh over the first data·model ranks of the
    initialised world, row-major: the ranks that remain after a drop.
    Collective — every rank of the world calls it (``new_group`` is), and
    a rank outside the sub-mesh gets None."""
    dist = torch.distributed
    shape = (data, model)
    n = math.prod(shape)
    if n > dist.get_world_size():
        raise RuntimeError(f"a {shape} sub-mesh needs {n} ranks, the world "
                           f"has {dist.get_world_size()}")
    backend = dist.get_backend()
    groups = build_groups(("data", "model"), shape, backend)
    host = dist.new_group(list(range(n)), backend="gloo")
    rank = dist.get_rank()
    if rank >= n:
        return None
    if device is None:
        device = rank_device(str(resolve_device()), backend, rank)
    return Mesh(("data", "model"), shape, (rank // model, rank % model),
                backend=backend, device=torch.device(device), groups=groups,
                host_group=host)


def mesh_of_shape(shape: tuple, device=None) -> Mesh:
    """``make_host_mesh`` of a (data, model) or (pod, data, model)
    shape."""
    if len(shape) == 3:
        return make_host_mesh(shape[1], shape[2], pod=shape[0],
                              device=device)
    return make_host_mesh(*shape, device=device)


def load_kernels(mesh: Mesh, load=None) -> None:
    """Load the kernel library on every rank of a mesh on cards, in turns:
    rank 0 first (a build, on a miss, stores the entry in the compile
    cache the ranks share), the others after a barrier, as hits.  So the
    ranks build at most once between them (``core/compile_cache``: its
    files also land whole, should processes race on a key).  ``load``
    (any loader, run the same way) replaces the library's; without it,
    nothing on the CPU, which has no library."""
    if load is None:
        if mesh.device.type != "cuda":
            return
        from repro_torch.kernels import build
        load = build.library
    if mesh.rank == 0:
        load()
    mesh.barrier()
    if mesh.rank != 0:
        load()


# ---------------------------------------------------------------------------
# spawn: one process per rank, a deadline, no hang on failure
# ---------------------------------------------------------------------------

def _rank_main(fn, rank: int, world: int, mesh_shape: tuple, device: str,
               backend: str, workdir: str, timeout_s: float, args: tuple,
               threads: int) -> None:
    out = os.path.join(workdir, f"rank{rank}")
    try:
        if threads:
            torch.set_num_threads(threads)
        dev = rank_device(device, backend, rank)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        torch.distributed.init_process_group(
            backend, init_method=f"file://{workdir}/rendezvous",
            rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=timeout_s))
        mesh = mesh_of_shape(mesh_shape, device=dev)
        load_kernels(mesh)
        result = fn(mesh, *args)
        with open(out + ".tmp", "wb") as f:
            pickle.dump(result, f)
        os.replace(out + ".tmp", out + ".ok")
        # no rank tears its groups down while a peer is still in a
        # collective
        mesh.barrier()
        torch.distributed.destroy_process_group()
    except BaseException:
        with open(out + ".err", "w") as f:
            f.write(traceback.format_exc())
        os._exit(1)


class RankFailure(RuntimeError):
    """A rank raised, or the group outlived its deadline."""


class Group:
    """A running group of ranks (``start``); ``join()`` returns their
    results or raises :class:`RankFailure`."""

    def __init__(self, procs, workdir, timeout_s):
        self.procs = procs
        self.workdir = workdir
        self.deadline = time.monotonic() + timeout_s
        self.timeout_s = timeout_s

    def _kill(self) -> None:
        for p in self.procs:
            if p.is_alive():
                p.kill()
        for p in self.procs:
            p.join(5)

    def _error(self, rank: int) -> str:
        path = os.path.join(self.workdir, f"rank{rank}.err")
        if os.path.exists(path):
            with open(path) as f:
                return f.read()
        return f"(rank {rank} exited with code {self.procs[rank].exitcode})"

    def join(self) -> list:
        try:
            while True:
                codes = [p.exitcode for p in self.procs]
                failed = [r for r, c in enumerate(codes)
                          if c is not None and c != 0]
                if failed:
                    self._kill()
                    r = failed[0]
                    raise RankFailure(f"rank {r} of {len(self.procs)} "
                                      f"failed (exit codes {codes}):\n"
                                      f"{self._error(r)}")
                if all(c == 0 for c in codes):
                    break
                if time.monotonic() > self.deadline:
                    self._kill()
                    raise RankFailure(
                        f"group of {len(self.procs)} ranks outlived its "
                        f"{self.timeout_s} s deadline; ranks still running: "
                        f"{[r for r, c in enumerate(codes) if c is None]}")
                time.sleep(0.02)
            out = []
            for r in range(len(self.procs)):
                with open(os.path.join(self.workdir, f"rank{r}.ok"),
                          "rb") as f:
                    out.append(pickle.load(f))
            return out
        finally:
            self._kill()
            shutil.rmtree(self.workdir, ignore_errors=True)


def start(fn, mesh_shape: tuple, *, device: str = "cuda",
          timeout_s: float = DEFAULT_TIMEOUT_S, args: tuple = (),
          threads: int = 0) -> Group:
    """Start one process per rank of ``mesh_shape`` ((data, model) or
    (pod, data, model)) running ``fn(mesh, *args)`` (``fn`` and ``args``
    must pickle: a module-level function).  ``threads`` > 0 sets each
    rank's intra-op threads."""
    world = math.prod(mesh_shape)
    backend = backend_for(device, world)
    workdir = tempfile.mkdtemp(prefix="repro_mesh_")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world, tuple(mesh_shape), device,
                               backend, workdir, timeout_s, tuple(args),
                               threads),
                         daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    return Group(procs, workdir, timeout_s)


def spawn(fn, mesh_shape: tuple, *, device: str = "cuda",
          timeout_s: float = DEFAULT_TIMEOUT_S, args: tuple = (),
          threads: int = 0) -> list:
    """``start`` then ``join``: the ranks' results in rank order."""
    return start(fn, mesh_shape, device=device, timeout_s=timeout_s,
                 args=args, threads=threads).join()

