"""Rank programs of the multi-device checks.

Each function here runs on every rank of a group started by
:func:`parallel.multihost.spawn` (``spawn(fn, nprocs, *args)`` calls
``fn(rank_device, *args)`` in each rank) and returns what that rank saw,
with every tensor moved to a numpy array on the host. The CPU tests
(``tests/test_torch_dist.py``, ``test_torch_multihost.py``,
``test_torch_runner_mesh.py``) and ``chip_smoke.py``'s multi-device
phase hold the results against the same calls without a mesh. The
children import this module, and nothing of JAX.
"""

from __future__ import annotations

import contextlib
import importlib

import numpy as np
import torch

from epivo_tpu_torch.parallel import dist as dist_mod, mesh as mesh_mod


def to_host(x):
    """``x`` with every tensor in it (also inside tuples, lists and dicts)
    as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(to_host(v) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(to_host(v) for v in x)
    if isinstance(x, dict):
        return {k: to_host(v) for k, v in x.items()}
    return x


def _resolve(target: str):
    module, name = target.split(":")
    return getattr(importlib.import_module(module), name)


def _call(mesh, dev, target: str, args=(), kwargs=None, mesh_arg: str = "mesh",
          device_arg: bool = False, repeats: int = 1, without_mesh: bool = False):
    fn = _resolve(target)
    to = lambda v: v.to(dev) if isinstance(v, torch.Tensor) else v
    args = tuple(to(a) for a in args)
    kwargs = {k: to(v) for k, v in (kwargs or {}).items()}
    if device_arg:
        kwargs["device"] = dev
    runs = [to_host(fn(*args, **kwargs, **{mesh_arg: mesh})) for _ in range(repeats)]
    if without_mesh:
        return to_host(fn(*args, **kwargs, **{mesh_arg: None})), runs
    return runs


def call_on_mesh(dev: torch.device, target: str, shape: tuple, args: tuple = (),
                 kwargs: dict | None = None, mesh_arg: str = "mesh",
                 device_arg: bool = False, repeats: int = 1, without_mesh: bool = False):
    """Build a (win, hyp) mesh of ``shape`` on ``dev``'s type and call
    ``target`` ("module:function") with ``mesh_arg=mesh``.

    Tensors among ``args`` / ``kwargs`` move to ``dev``; ``device_arg``
    passes ``device=dev``. Returns the list of ``repeats`` results; with
    ``without_mesh``, (the same call with ``mesh_arg=None``, that list).
    """
    mesh = mesh_mod.make_mesh(*shape, device_type=dev.type)
    return _call(mesh, dev, target, args, kwargs, mesh_arg, device_arg, repeats,
                 without_mesh)


def calls_on_mesh(dev: torch.device, shape: tuple, calls: list) -> list:
    """:func:`call_on_mesh` for each of ``calls`` (dicts of its keyword
    arguments after ``shape``) on one mesh."""
    mesh = mesh_mod.make_mesh(*shape, device_type=dev.type)
    return [_call(mesh, dev, **c) for c in calls]


def mesh_groups(dev: torch.device, shapes: list) -> list:
    """For each mesh shape: the axis sizes, this rank's coordinates, and
    the global ranks of this rank's group along each axis (gathered)."""
    me = torch.tensor([torch.distributed.get_rank()], device=dev)
    out = []
    for shape in shapes:
        mesh = mesh_mod.make_mesh(*shape, device_type=dev.type)
        out.append({"shape": tuple(mesh.shape), "names": mesh.mesh_dim_names,
                    **{f"size_{a}": mesh_mod.axis_size(mesh, a) for a in mesh_mod.AXES},
                    **{f"rank_{a}": mesh_mod.axis_rank(mesh, a) for a in mesh_mod.AXES},
                    **{f"group_{a}": mesh_mod.gather_rows(me, mesh, a).tolist()
                       for a in mesh_mod.AXES}})
    return out


def window_arrays(dev: torch.device, n_windows: int) -> tuple:
    """:func:`multihost.global_window_arrays` on a (host, win) mesh, each
    rank passing only its own block of ``n_windows`` (window w's arrays
    hold w): (the rank's block range, the global arrays)."""
    from epivo_tpu_torch.parallel import multihost

    lo, hi = multihost.host_window_range(n_windows)
    w = torch.arange(lo, hi)
    local = (w.to(torch.float32)[:, None, None] * torch.ones(1, 2, 3),
             (w % 2 == 0)[:, None].expand(-1, 4), w)
    return (lo, hi), to_host(multihost.global_window_arrays(
        multihost.host_mesh(device_type=dev.type), *local))


def ba_step(T0s, p, p_t, wreps, pmask, spec, config, mesh):
    """:func:`dist.distributed_ba_step` built for ``mesh`` and called."""
    return dist_mod.distributed_ba_step(mesh, spec, config)(T0s, p, p_t, wreps, pmask)


def ransac_dist(samples, p, p_t, mask, n_hyp_per_device, threshold, mesh):
    """:func:`dist.distributed_ransac_essential` built for ``mesh`` and
    called on ``samples`` (or a generator seeded with ``samples`` when it
    is an int)."""
    if isinstance(samples, int):
        samples = torch.Generator(device=p.device).manual_seed(samples)
    return dist_mod.distributed_ransac_essential(mesh, n_hyp_per_device, threshold)(
        samples, p, p_t, mask)


@contextlib.contextmanager
def retry_launches(counts):
    """Count the kernel launches made inside ``vo.vo_step_orb_batched``
    (the ORB retry pass of :func:`runners._extract_pairs`) during the
    block, ``counts()`` being the launch counters as a dict: yields a dict
    that holds them when the block ends. The KLT pass's launches are the
    block's total less these."""
    from epivo_tpu_torch.pipeline import vo

    retry = dict.fromkeys(counts(), 0)
    orb_step = vo.vo_step_orb_batched

    def counted(*args, **kw):
        before = counts()
        out = orb_step(*args, **kw)
        for k, v in counts().items():
            retry[k] += v - before[k]
        return out

    vo.vo_step_orb_batched = counted
    try:
        yield retry
    finally:
        vo.vo_step_orb_batched = orb_step


def card_check(dev: torch.device, frames: list, pairs: list, vo_cfg, extract: dict,
               ba_in: tuple, zetas: np.ndarray, pair_data: dict, ba_cfg,
               ransac_in: tuple) -> dict:
    """``chip_smoke.py``'s multi-device phase on one rank of a 2-rank group:

    - ``_extract_pairs`` of ``pairs`` over ``frames`` with the pair batch
      over ``win`` (``extract``: n_points, batch), with the launch counts
      set to 0 just before it: this rank's launches in the KLT pass and in
      the ORB retry pass, and the lanes of each step it ran; then one more
      step on this rank's lanes of the first batch with any host sync
      raising (``torch.cuda.set_sync_debug_mode``);
    - ``distributed_ba_step`` over ``win`` on ``ba_in`` = (T0s, p, p_t,
      wreps, pmask, spec, BA config);
    - ``refine_global`` over ``win`` on ``zetas`` and ``pair_data``, twice;
    - ``ransac_essential`` with its hypotheses over ``hyp`` on
      ``ransac_in`` = (p, p_t, mask, samples, threshold).

    Returns the results (numpy), the host wall seconds of each, and the
    collectives this rank ran (:data:`mesh.COLLECTIVES`)."""
    import time

    from epivo_tpu_torch import ransac
    from epivo_tpu_torch.frontend import fast, klt
    from epivo_tpu_torch.pipeline import runners, stream

    win = mesh_mod.make_mesh(2, 1, device_type=dev.type)
    hyp = mesh_mod.make_mesh(1, 2, device_type=dev.type)
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    counts = lambda: {"fast": fast.KERNEL_LAUNCHES, "fast_cand": fast.CAND_LAUNCHES,
                      "klt_level": klt.LEVEL_LAUNCHES, "extract": klt.EXTRACT_LAUNCHES,
                      "lk": klt.LK_LAUNCHES}

    def reset():
        fast.KERNEL_LAUNCHES = fast.CAND_LAUNCHES = 0
        klt.LEVEL_LAUNCHES = klt.EXTRACT_LAUNCHES = klt.LK_LAUNCHES = 0

    out, wall, st = {}, {}, {}
    mesh_mod.COLLECTIVES.clear()
    reset()
    t0 = time.perf_counter()
    with retry_launches(counts) as retry:
        out["pairs"] = runners._extract_pairs(stream.FrameStream(list(frames)), pairs, vo_cfg,
                                              0, mesh=win, device=dev, stats=st, **extract)
    wall["extract_s"] = time.perf_counter() - t0
    total = counts()
    out["launches"] = {"klt": {k: total[k] - retry[k] for k in total}, "retry": retry,
                       "step_lanes": st["step_lanes"], "retry_lanes": st["retry_lanes"]}
    out["retried"] = st["retried"]

    # The host-sync check, on one more step of this rank's lanes of the
    # first batch (its launches are not counted).
    batch = extract["batch"]
    lanes = runners._lanes(batch, win)
    src, tgt = runners._pair_inputs(frames.__getitem__, [pairs[q] for q in lanes], dev)
    step = runners._extract_step(vo_cfg, False)
    gen = torch.Generator(device=dev).manual_seed(0)
    step(src, tgt, runners._draw(gen, lanes, batch, win))
    sync()
    if dev.type == "cuda":
        torch.cuda.set_sync_debug_mode("error")
    try:
        step(src, tgt, runners._draw(gen, lanes, batch, win))
    finally:
        if dev.type == "cuda":
            torch.cuda.set_sync_debug_mode("default")
    sync()

    *arrays, spec, cfg = ba_in
    fn = dist_mod.distributed_ba_step(win, spec, cfg)
    args = [torch.from_numpy(a).to(dev) for a in arrays]
    sync()
    t0 = time.perf_counter()
    out["ba"] = to_host(fn(*args))
    wall["ba_s"] = time.perf_counter() - t0  # the first call: its warm-up included

    t0 = time.perf_counter()
    out["global"] = [to_host(runners.refine_global(zetas, pair_data, ba_cfg, mesh=win,
                                                   device=dev)) for _ in range(2)]
    wall["global_s"] = (time.perf_counter() - t0) / 2

    p, p_t, mask, samples, thr = (torch.from_numpy(a).to(dev) if isinstance(a, np.ndarray)
                                  else a for a in ransac_in)
    out["ransac"] = to_host(ransac.ransac_essential(
        None, p, p_t, n_hyp=samples.shape[0], threshold=thr, mask=mask, samples=samples,
        hyp_mesh=hyp))
    out["wall"] = wall
    out["backend"] = torch.distributed.get_backend()
    out["collectives"] = dict(mesh_mod.COLLECTIVES)
    return out
