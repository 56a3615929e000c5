"""Process groups, device meshes and a launcher for the multi-device paths.

Counterpart of the mesh half of ``nerf_vo_tpu/parallel/sharding.py``
(``initialize_distributed``, ``make_mesh``, ``make_mesh_2d``,
``make_pod_mesh``). A JAX mesh axis becomes one ``torch.distributed``
process group per row of a ``DeviceMesh``; each process is one rank and
runs the same program (SPMD), so a mesh spans every rank of the default
group. :class:`Axis` is what the collective-using code takes: an axis's
group, its size and this rank's index along it.

:func:`spawn` starts ``world`` ranks on one host. Its backend is explicit
(:func:`pick_backend`): NCCL with rank r on ``cuda:r`` where the machine has
at least ``world`` cards, gloo with every rank on ``cuda:0`` where it has
fewer (NCCL refuses two ranks on one card; gloo runs its collectives on
CUDA tensors through host copies), gloo on CPU tensors for ``device="cpu"``.
It never switches backend after a failure.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import queue as queue_mod
import shutil
import tempfile
import traceback
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Axis:
    """One mesh axis as seen from this rank: its process group (None: the
    default group), its size and this rank's index along it."""

    group: Any
    size: int
    index: int


def initialize_distributed(backend: Optional[str] = None) -> bool:
    """``init_process_group`` from the torchrun environment (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``; ``LOCAL_RANK`` picks
    the card), like ``jax.distributed.initialize``; a no-op without it or
    when a group is up. ``backend`` defaults to NCCL with a card, gloo
    without. Returns whether a default group is up."""
    if dist.is_initialized():
        return True
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return False
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group(backend)
    return True


def _mesh_device_type() -> str:
    # an NCCL group serves CUDA tensors; a gloo group is built as a CPU mesh
    # (it serves CUDA tensors as well), so that DeviceMesh never asks NCCL
    # for groups of ranks that share a card
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def _check_world(n: int, what: str) -> None:
    world = dist.get_world_size()
    if n != world:
        raise ValueError(f"{what}: a mesh of {n} ranks in a world of {world}; "
                         "a mesh spans every rank of the default group")


def make_mesh(n_devices: Optional[int] = None, axis: str = "data"):
    """1D mesh over every rank (``n_devices``, if given, must be the world
    size)."""
    from torch.distributed.device_mesh import init_device_mesh

    n = dist.get_world_size() if n_devices is None else n_devices
    _check_world(n, "make_mesh")
    return init_device_mesh(_mesh_device_type(), (n,), mesh_dim_names=(axis,))


def make_mesh_2d(n_data: int, n_model: int,
                 axes: Tuple[str, str] = ("data", "model")):
    """2D mesh: data-parallel rays x model-parallel hash tables. Row-major:
    the model axis is innermost, so a model group is consecutive ranks."""
    from torch.distributed.device_mesh import init_device_mesh

    _check_world(n_data * n_model, "make_mesh_2d")
    return init_device_mesh(_mesh_device_type(), (n_data, n_model),
                            mesh_dim_names=tuple(axes))


def make_pod_mesh(n_data: Optional[int] = None, n_model: int = 1,
                  axes: Tuple[str, str] = ("data", "model")):
    """Multi-host 2D mesh with the model axis inside a host.

    The model axis carries several collectives per train step (one per
    hash-grid encode), the data axis one gradient all-reduce, so the model
    axis must stay on one host's links. Launchers give a host consecutive
    ranks (``LOCAL_WORLD_SIZE`` of them), and the model axis is the
    innermost of :func:`make_mesh_2d`'s row-major layout, so a model group
    lies on one host when ``n_model`` divides the host's rank count. On one
    host this is :func:`make_mesh_2d`'s layout.
    """
    world = dist.get_world_size()
    if n_data is None:
        if world % n_model:
            raise ValueError(f"world {world} is not a multiple of n_model "
                             f"{n_model}")
        n_data = world // n_model
    per_host = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if per_host < world and (n_model > per_host or per_host % n_model):
        raise ValueError(f"model axis ({n_model}) must fit inside one host "
                         f"({per_host} ranks): its collectives ride the "
                         "host's links")
    return make_mesh_2d(n_data, n_model, axes)


def mesh_axis(mesh, name: str) -> Axis:
    """:class:`Axis` of mesh dimension ``name``."""
    return Axis(mesh.get_group(name), mesh.size(mesh.mesh_dim_names.index(
        name)), mesh.get_local_rank(name))


def world_axis() -> Axis:
    """Every rank of the default group: the flattened axes of a mesh."""
    return Axis(None, dist.get_world_size(), dist.get_rank())


# ---------------------------------------------------------------------------
# collectives (a size-1 axis moves nothing)
# ---------------------------------------------------------------------------

def all_reduce_sum(t: torch.Tensor, axis: Axis) -> torch.Tensor:
    """In-place SUM over ``axis``; returns ``t``."""
    if axis.size > 1:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=axis.group)
    return t


def all_gather_cat(t: torch.Tensor, axis: Axis, dim: int = 0) -> torch.Tensor:
    """Every rank's ``t`` (all the same shape), concatenated in axis order
    along ``dim`` (``all_gather``'s list form: gloo has no tensor form)."""
    if axis.size == 1:
        return t
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(axis.size)]
    dist.all_gather(parts, t, group=axis.group)
    return torch.cat(parts, dim)


def all_to_all_rows(t: torch.Tensor, send: Sequence[int],
                    recv: Sequence[int], axis: Axis) -> torch.Tensor:
    """Rows ``t[sum(send[:j]) : sum(send[:j+1])]`` go to rank j of ``axis``;
    returns the ``sum(recv)`` rows received, in sender order."""
    if axis.size == 1:
        return t
    out = t.new_empty((int(sum(recv)),) + tuple(t.shape[1:]))
    dist.all_to_all_single(out, t.contiguous(), [int(r) for r in recv],
                           [int(s) for s in send], group=axis.group)
    return out


def exchange_counts(send: torch.Tensor, axis: Axis) -> torch.Tensor:
    """[size] int64 counts this rank sends to each rank -> the counts each
    rank sends to this one."""
    if axis.size == 1:
        return send.clone()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send.contiguous(), group=axis.group)
    return recv


# ---------------------------------------------------------------------------
# launcher
# ---------------------------------------------------------------------------

def pick_backend(world: int, device="cuda",
                 backend: Optional[str] = None) -> Tuple[str, List[str]]:
    """(backend, each rank's device) for ``world`` ranks on this host:
    ``device="cpu"`` -> gloo on CPU tensors; a card per rank -> NCCL (or the
    ``backend`` given) with rank r on ``cuda:r``; fewer cards -> gloo with
    every rank on ``cuda:0``."""
    if torch.device(device).type == "cpu":
        if backend not in (None, "gloo"):
            raise ValueError(f"backend {backend!r} on CPU tensors: gloo only")
        return "gloo", ["cpu"] * world
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("spawn(device='cuda'): no CUDA device")
    if n >= world:
        return backend or "nccl", [f"cuda:{r}" for r in range(world)]
    if backend not in (None, "gloo"):
        raise ValueError(f"{world} ranks on {n} card(s): NCCL needs a card "
                         "per rank; gloo shares the card")
    return "gloo", ["cuda:0"] * world


def _rank_main(rank, world, backend, device, init_file, timeout, fn, args,
               results):
    torch.set_num_threads(1)
    if device.startswith("cuda"):
        torch.cuda.set_device(torch.device(device))
    dist.init_process_group(
        backend, init_method=f"file://{init_file}", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=timeout))
    try:
        out = fn(rank, world, torch.device(device), *args)
        # by value: a tensor through the queue would be shared memory that
        # dies with this process
        results.put((rank, True, pickle.dumps(out)))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        dist.destroy_process_group()


class Ranks:
    """Running ranks started by :func:`spawn`; :meth:`join` waits for them
    and returns each rank's result."""

    def __init__(self, procs, results, tmp, timeout):
        self._procs, self._results = procs, results
        self._tmp, self._timeout = tmp, timeout

    def join(self) -> List[Any]:
        out, errors = {}, {}
        deadline = datetime.datetime.now() + datetime.timedelta(
            seconds=self._timeout)
        try:
            while len(out) + len(errors) < len(self._procs):
                try:
                    rank, ok, payload = self._results.get(timeout=1.0)
                except queue_mod.Empty:
                    dead = [r for r, p in enumerate(self._procs)
                            if not p.is_alive() and p.exitcode != 0
                            and r not in out and r not in errors]
                    if dead:
                        errors.update({r: f"exit code "
                                       f"{self._procs[r].exitcode}"
                                       for r in dead})
                    elif datetime.datetime.now() > deadline:
                        raise TimeoutError(f"ranks did not finish in "
                                           f"{self._timeout} s")
                    continue
                if ok:
                    out[rank] = pickle.loads(payload)
                else:
                    errors[rank] = payload
                if errors:
                    break
        finally:
            for p in self._procs:
                p.join(timeout=30 if not errors else 5)
                if p.is_alive():
                    p.terminate()
                    p.join()
            shutil.rmtree(self._tmp, ignore_errors=True)
        if errors:
            msg = "\n".join(f"--- rank {r}:\n{e}" for r, e in
                            sorted(errors.items()))
            raise RuntimeError(f"rank(s) {sorted(errors)} failed:\n{msg}")
        return [out[r] for r in range(len(self._procs))]


def spawn(fn: Callable, world: int, device="cuda",
          backend: Optional[str] = None, args: tuple = (),
          timeout: float = 600.0, wait: bool = True, quiet: bool = False):
    """Run ``fn(rank, world, device, *args)`` on ``world`` new processes
    (start method ``spawn``), each rank in a default process group set up
    through a file store in a fresh temporary directory (no fixed TCP
    port, so that test files running side by side never collide).

    ``fn`` must be importable by name and return a picklable result (it is
    pickled by value; return tensors on the CPU). The backend and devices
    come from :func:`pick_backend`, and the choice is printed unless
    ``quiet``. Any rank's failure raises ``RuntimeError`` with its
    traceback. ``wait=False`` returns the running :class:`Ranks` at once.
    """
    import multiprocessing

    backend, devices = pick_backend(world, device, backend)
    if not quiet:
        per_card = "" if devices[0] == "cpu" else (
            f", {world // len(set(devices))} rank(s) a card")
        print(f"spawn: {world} rank(s), backend {backend}, devices "
              f"{sorted(set(devices))}{per_card}", flush=True)
    ctx = multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="nerf_vo_spawn_")
    init_file = os.path.join(tmp, "rendezvous")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, args=(
        r, world, backend, devices[r], init_file, timeout, fn, tuple(args),
        results), daemon=False) for r in range(world)]
    for p in procs:
        p.start()
    ranks = Ranks(procs, results, tmp, timeout)
    return ranks.join() if wait else ranks
