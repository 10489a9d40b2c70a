"""Multi-process launch and per-host window blocks (port of
``epivo_tpu/parallel/multihost.py``).

The reference initializes ``jax.distributed`` and builds a (host, win)
mesh whose collectives span processes. Here every rank is a process of one
``torch.distributed`` group:

    from epivo_tpu_torch.parallel import dist, multihost
    multihost.initialize(coordinator, num_processes=N, process_id=i)
    mesh = multihost.host_mesh()                  # (host, win)
    lo, hi = multihost.host_window_range(W_global)
    # build ONLY windows [lo, hi) on this process ...
    gl = multihost.global_window_arrays(mesh, T0s_local, p_local, ...)
    step = dist.distributed_ba_step(multihost.fold_win_mesh(mesh), spec, cfg)
    out = step(*gl)   # the same on every rank

:func:`spawn` starts a group of local ranks with ``torch.multiprocessing``
(the tests, ``tools/dryrun_multichip.py`` and ``chip_smoke.py`` use it);
:func:`_test_worker` is the two-process check of the reference's
``tests/test_multihost.py``.
"""

from __future__ import annotations

import json
import os
import pickle
import socket
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from epivo_tpu_torch.parallel import mesh as mesh_mod


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               backend: str | None = None,
               device_type: str = "cuda") -> None:
    """``torch.distributed.init_process_group`` over TCP.

    Each of the three falls back on the reference's variables
    (``EPIVO_COORDINATOR`` = "host:port", ``EPIVO_NUM_PROCESSES``,
    ``EPIVO_PROCESS_ID``), then on torchrun's (``MASTER_ADDR`` /
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``). The backend is the
    caller's, else NCCL for ``device_type`` "cuda" (one card per rank) and
    gloo for "cpu"; nothing falls back from one to the other.
    """
    env = os.environ
    coord = coordinator_address or env.get("EPIVO_COORDINATOR")
    if coord is None and "MASTER_ADDR" in env:
        coord = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
    n = num_processes or env.get("EPIVO_NUM_PROCESSES") or env.get("WORLD_SIZE")
    pid = process_id if process_id is not None else env.get(
        "EPIVO_PROCESS_ID", env.get("RANK"))
    if coord is None or n is None or pid is None:
        raise ValueError("initialize needs the coordinator address, the number of "
                         "processes and this process's id (arguments or EPIVO_* / "
                         "torchrun variables)")
    if backend is None:
        backend = {"cuda": "nccl", "cpu": "gloo"}[device_type]
    dist.init_process_group(backend, init_method=f"tcp://{coord}",
                            world_size=int(n), rank=int(pid))


def host_mesh(axis_names=("host", "win"), device_type: str = "cuda") -> DeviceMesh:
    """Global (host, win) mesh: the first axis across hosts, the second
    across each host's ranks. Ranks are grouped by ``LOCAL_WORLD_SIZE``
    (torchrun's ranks per host), or all on one host when it is unset."""
    world = dist.get_world_size()
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if world % local:
        raise ValueError(f"{world} ranks do not split into hosts of {local}")
    return init_device_mesh(device_type, (world // local, local),
                            mesh_dim_names=tuple(axis_names))


def fold_win_mesh(mesh: DeviceMesh) -> DeviceMesh:
    """Collapse a (host, win) mesh into a flat ('win',) mesh over the same
    ranks in host-major order, for single-axis consumers
    (``dist.distributed_ba_step``). Every rank of the mesh calls it."""
    return DeviceMesh(mesh.device_type, mesh.mesh.flatten(), mesh_dim_names=("win",))


def host_window_range(n_windows: int,
                      process_id: int | None = None,
                      num_processes: int | None = None) -> tuple[int, int]:
    """[lo, hi) window range owned by this host (contiguous block split,
    remainder to the front hosts) — per-host data loading of disjoint
    shards."""
    pid = dist.get_rank() if process_id is None else process_id
    n = dist.get_world_size() if num_processes is None else num_processes
    base = n_windows // n
    extra = n_windows % n
    lo = pid * base + min(pid, extra)
    hi = lo + base + (1 if pid < extra else 0)
    return lo, hi


def global_window_arrays(mesh: DeviceMesh, *local_arrays):
    """Assemble every rank's window block into the global arrays, on every
    rank: each rank passes its own block (the blocks of
    :func:`host_window_range`, whose sizes may differ by one) and gets the
    blocks of all ranks concatenated in rank order (host-major). The
    blocks are padded to the largest, gathered over the whole mesh and
    trimmed. Returns tensors on the rank's device of the mesh's type."""
    if mesh.size() != dist.get_world_size():
        raise ValueError("global_window_arrays needs a mesh over every rank")
    flat = fold_win_mesh(mesh) if mesh.ndim > 1 else mesh
    dev = torch.device("cuda", torch.cuda.current_device()) \
        if mesh.device_type == "cuda" else torch.device("cpu")
    counts = mesh_mod.gather_rows(
        torch.tensor([len(local_arrays[0])], device=dev), flat, flat.mesh_dim_names[0])
    counts = [int(c) for c in counts.cpu()]
    n_max = max(counts)
    out = []
    for a in local_arrays:
        t = torch.as_tensor(np.asarray(a)).to(dev)
        if len(t) != counts[dist.get_rank()]:
            raise ValueError("every local array needs this rank's window count")
        pad = t.new_zeros((n_max - len(t),) + tuple(t.shape[1:]))
        full = mesh_mod.gather_rows(torch.cat([t, pad]), flat, flat.mesh_dim_names[0])
        out.append(torch.cat([full[r * n_max:r * n_max + c] for r, c in enumerate(counts)]))
    return tuple(out)


def free_port() -> int:
    """A TCP port on the loopback interface that was free a moment ago."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_device(rank: int, nprocs: int, backend: str, device: str) -> torch.device:
    """The device of local rank ``rank`` for :func:`spawn`: the CPU, or the
    cards round-robin. NCCL needs one card per rank (it refuses two ranks
    on one device); gloo ranks may share a card."""
    if device == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device for the ranks; spawn them with device='cpu'")
    n_cards = torch.cuda.device_count()
    if backend == "nccl" and nprocs > n_cards:
        raise ValueError(f"NCCL needs one card per rank: {nprocs} ranks, {n_cards} cards")
    return torch.device("cuda", rank % n_cards)


def _rank_main(rank, nprocs, port, backend, device, fn, args, out_dir):
    torch.set_num_threads(1)  # the ranks share the host's cores
    dev = _rank_device(rank, nprocs, backend, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    initialize(f"127.0.0.1:{port}", nprocs, rank, backend=backend, device_type=dev.type)
    try:
        out = fn(dev, *args)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


class Ranks:
    """Local ranks started by :func:`start`; :meth:`results` waits for
    them."""

    def __init__(self, ctx, out_dir: tempfile.TemporaryDirectory, nprocs: int):
        self._ctx, self._out_dir, self.nprocs = ctx, out_dir, nprocs

    def results(self, timeout_s: float = 600.0) -> list:
        """Each rank's result, in rank order. A rank that raised, or ranks
        still running after ``timeout_s``, stop every rank and raise."""
        try:
            deadline = time.monotonic() + timeout_s
            while not self._ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    for p in self._ctx.processes:
                        if p.is_alive():
                            p.terminate()
                    for p in self._ctx.processes:
                        p.join(10)
                    raise TimeoutError(f"{self.nprocs} ranks still running after "
                                       f"{timeout_s} s")
            results = []
            for r in range(self.nprocs):
                with open(os.path.join(self._out_dir.name, f"rank{r}.pkl"), "rb") as f:
                    results.append(pickle.load(f))
            return results
        finally:
            self._out_dir.cleanup()


def start(fn, nprocs: int, *args, backend: str = "gloo", device: str = "cpu") -> Ranks:
    """Start ``fn(rank_device, *args)`` on ``nprocs`` local ranks of a new
    process group and return at once.

    The ranks are ``torch.multiprocessing`` spawn processes, so ``fn`` must
    be a module-level function (the children import it by name) and
    ``args`` picklable; the group meets at a free loopback port. ``device``
    is "cpu" or "cuda" (:func:`_rank_device`).
    """
    out_dir = tempfile.TemporaryDirectory()
    ctx = mp.spawn(_rank_main, nprocs=nprocs, join=False,
                   args=(nprocs, free_port(), backend, device, fn, args, out_dir.name))
    return Ranks(ctx, out_dir, nprocs)


def spawn(fn, nprocs: int, *args, backend: str = "gloo", device: str = "cpu",
          timeout_s: float = 600.0) -> list:
    """:func:`start`, then each rank's result in rank order
    (:meth:`Ranks.results`)."""
    return start(fn, nprocs, *args, backend=backend, device=device).results(timeout_s)


def _test_worker(process_id: int, num_processes: int, port: int,
                 out_path: str) -> None:
    """Two-process CPU validation worker (the reference's, driven by its
    ``tests/test_multihost.py``; here by ``tests/test_torch_multihost.py``).

    Builds a (host, win) mesh over every rank on gloo, runs a psum over
    every rank (a cross-process collective), then a window-sharded BA step
    where each rank builds only its own block of 4 windows (synthetic
    scenes from per-window seeds), and writes the replicated results for the
    parent to compare."""
    from epivo_tpu_torch.datasets import synthetic
    from epivo_tpu_torch.parallel import dist as dist_mod
    from epivo_tpu_torch.pipeline import ba
    from epivo_tpu_torch.pipeline.config import BAConfig, LMConfig

    torch.set_num_threads(1)
    initialize(f"127.0.0.1:{port}", num_processes, process_id, backend="gloo",
               device_type="cpu")
    try:
        mesh = host_mesh(device_type="cpu")
        n_total = mesh.size()

        # --- cross-process psum over every rank ------------------------------
        flat = fold_win_mesh(mesh)
        xs = torch.arange(n_total, dtype=torch.float32)
        total = float(mesh_mod.psum(mesh_mod.shard_rows(xs, flat, "win"), flat, "win")[0])
        expect = float(xs.sum())

        # --- window-sharded BA step, each rank building its own windows ------
        spec = ba.mono_window_spec(ws=3)
        cfg = BAConfig(lm=LMConfig(n_points=8, huber_delta=1.0, max_iters=5,
                                   revert_r_norm=10.0))
        W_global = 4 * n_total
        lo, hi = host_window_range(W_global)
        scenes = [synthetic.gen_scene_sequence(
            torch.Generator().manual_seed(3 + w), N=8, n_zeta=spec.n_zeta,
            reps=[tuple(r) for r in spec.reps]) for w in range(lo, hi)]
        T0s = torch.stack([s.T0s for s in scenes])
        pp = torch.stack([s.p for s in scenes])
        pt = torch.stack([s.p_t for s in scenes])
        wreps = torch.ones((hi - lo, spec.reps.shape[0]))
        pmask = torch.ones((hi - lo, spec.reps.shape[0], 8), dtype=torch.bool)
        gl = global_window_arrays(mesh, T0s, pp, pt, wreps, pmask)
        out = dist_mod.distributed_ba_step(flat, spec, cfg)(*gl)
        traj = out.trajectory.numpy()
        with open(out_path, "w") as f:
            json.dump({
                "process": process_id,
                "n_devices": n_total,
                "psum": total,
                "psum_expect": expect,
                "global_r_norm": float(out.global_r_norm),
                "traj_sum": float(traj.astype(np.float64).sum()),
                "traj_finite": bool(np.all(np.isfinite(traj))),
                "traj_shape": list(traj.shape),
            }, f)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    import sys

    _test_worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
