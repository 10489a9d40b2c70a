"""Device mesh over ``torch.distributed`` ranks (port of
``epivo_tpu/parallel/mesh.py``).

The reference runs one host program over a ``jax.sharding.Mesh`` with two
named axes:

- ``win``: windows and pairs, data-parallel (independent BA windows and
  independent frame pairs split across devices);
- ``hyp``: RANSAC hypotheses (the minimal solves and their scores split
  across devices, with one collective for the winner).

The port runs one process per rank, every rank running the same program,
and names the groups with a ``DeviceMesh`` of the same axes. Where the
reference places an array with a ``NamedSharding``, a rank here takes its
own block (:func:`shard_rows`), computes on it, and reassembles the whole
(:func:`gather_rows`) or a sum (:func:`psum`) with one collective. Results
the reference keeps replicated are then the same on every rank.

Collectives. NCCL takes CUDA tensors only: it is the backend of a mesh
on cards, one card per rank. Gloo takes CPU tensors, and CUDA tensors for
``all_reduce`` and the list form of ``all_gather``, the only two
collectives used here. For CUDA tensors the gloo backend itself copies
them into pinned host buffers, runs the collective on the CPU and copies
the result back; this layer passes the tensors as they are and adds no
staging of its own. Gloo is how two ranks share one card, which NCCL
refuses. :data:`COLLECTIVES` counts the collectives this process ran by
backend and tensor device, so a run can report what it passed.

CUDA graphs. A graph records an NCCL collective as a kernel on the card,
so a captured step may hold one (:func:`capturable`); gloo runs its
collectives on the host, which a graph cannot record. A replay runs no
Python, so the graph cache (``_graphs.py``) adds to :data:`COLLECTIVES`
the collectives each replay runs, as it does for the kernels' launches.
A mesh enters a graph's key as a :class:`MeshKey`.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

AXES = ("win", "hyp")

# "op/backend/device type" -> number of calls in this process.
COLLECTIVES: dict = {}


def _count(op: str, group, x: torch.Tensor) -> None:
    key = f"{op}/{dist.get_backend(group)}/{x.device.type}"
    COLLECTIVES[key] = COLLECTIVES.get(key, 0) + 1


def capturable(mesh: DeviceMesh | None) -> bool:
    """Whether a CUDA graph can hold the collectives of ``mesh``: every
    group of it on NCCL, on CUDA tensors (no mesh holds none). Gloo
    stages CUDA tensors through host buffers and runs the collective on
    the CPU, which a graph cannot record."""
    if mesh is None:
        return True
    return mesh.device_type == "cuda" and all(
        dist.get_backend(mesh.get_group(a)) == "nccl" for a in mesh.mesh_dim_names)


class MeshKey:
    """A mesh in a graph key (``_graphs.run``'s ``static``): equal for the
    same process groups, by identity, and the same rank. A captured
    collective runs on the communicator it was recorded on, so a key
    replays only on the groups it was captured with; the key holds them
    while the cache holds the key."""

    __slots__ = ("mesh", "_groups", "_rank")

    def __init__(self, mesh: DeviceMesh):
        self.mesh = mesh
        self._groups = tuple(mesh.get_group(a) for a in mesh.mesh_dim_names)
        self._rank = dist.get_rank()

    def __eq__(self, other) -> bool:
        return (isinstance(other, MeshKey) and self._rank == other._rank
                and len(self._groups) == len(other._groups)
                and all(a is b for a, b in zip(self._groups, other._groups)))

    def __hash__(self) -> int:
        return hash((self._rank, tuple(id(g) for g in self._groups)))


def make_mesh(n_win: int | None = None, n_hyp: int = 1,
              device_type: str = "cuda") -> DeviceMesh:
    """A (win, hyp) mesh over every rank of the default process group
    (:func:`multihost.initialize` starts it). ``n_win`` defaults to the
    world size over ``n_hyp``. A world of one rank is a valid mesh.

    ``device_type`` is the type of the device every rank computes on
    ("cuda" or "cpu"); "cuda" without a card raises, and a CPU mesh on the
    NCCL backend (which has no CPU collectives) raises.
    """
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised default process group "
                           "(see multihost.initialize)")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; build a mesh with device_type='cpu' "
                           "to run the ranks on the CPU")
    if device_type == "cpu" and dist.get_backend() == "nccl":
        raise ValueError("a CPU mesh needs the gloo backend; NCCL has no CPU collectives")
    world = dist.get_world_size()
    if n_win is None:
        n_win = world // n_hyp
    if n_win * n_hyp != world:
        raise ValueError(f"mesh (win={n_win}, hyp={n_hyp}) does not cover the "
                         f"{world} ranks")
    return init_device_mesh(device_type, (n_win, n_hyp), mesh_dim_names=AXES)


def check_mesh(mesh, device: torch.device) -> None:
    """Raise unless ``mesh`` is a DeviceMesh built for ``device``'s type."""
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a torch.distributed DeviceMesh "
                        f"(parallel.mesh.make_mesh), got {type(mesh).__name__}")
    if mesh.device_type != torch.device(device).type:
        raise ValueError(f"the mesh was built for {mesh.device_type} but the run "
                         f"works on {device}")


def axis_size(mesh: DeviceMesh | None, axis: str) -> int:
    """Ranks along ``axis``; 1 without a mesh or for an axis it lacks."""
    if mesh is None or axis not in (mesh.mesh_dim_names or ()):
        return 1
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_rank(mesh: DeviceMesh | None, axis: str) -> int:
    """This rank's coordinate along ``axis``; 0 where :func:`axis_size` is 1."""
    if axis_size(mesh, axis) == 1:
        return 0
    return mesh.get_local_rank(axis)


def block(n: int, mesh: DeviceMesh | None, axis: str) -> tuple[int, int]:
    """[lo, hi): this rank's equal block of ``n`` rows along ``axis``
    (the reference's ``P(axis)``); ``n`` must divide evenly."""
    size = axis_size(mesh, axis)
    if n % size:
        raise ValueError(f"{n} rows do not divide the mesh axis {axis!r} of size {size}")
    per = n // size
    r = axis_rank(mesh, axis)
    return r * per, (r + 1) * per


def shard_rows(x: torch.Tensor, mesh: DeviceMesh | None, axis: str) -> torch.Tensor:
    """This rank's contiguous block of the leading axis of ``x``."""
    lo, hi = block(x.shape[0], mesh, axis)
    return x[lo:hi]


def gather_rows(x_local: torch.Tensor, mesh: DeviceMesh | None, axis: str) -> torch.Tensor:
    """The full leading axis on every rank: the blocks of every rank along
    ``axis``, concatenated in rank order (one ``all_gather``). Every rank
    passes a block of the same shape."""
    if mesh is None:
        return x_local
    group = mesh.get_group(axis)
    is_bool = x_local.dtype == torch.bool  # gathered as bytes
    x = (x_local.to(torch.uint8) if is_bool else x_local).contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    _count("all_gather", group, x)
    dist.all_gather(parts, x, group=group)
    out = torch.cat(parts)
    return out != 0 if is_bool else out


def psum(x: torch.Tensor, mesh: DeviceMesh | None, axis: str) -> torch.Tensor:
    """The sum of ``x`` over the ranks along ``axis``, on every rank (one
    ``all_reduce``; the backend fixes the order of the sum, so a repeat at
    the same world size is bit-equal)."""
    if mesh is None:
        return x
    out = x.detach().clone()
    group = mesh.get_group(axis)
    _count("all_reduce", group, out)
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out
