"""CPU stand-ins for the graph cache's capture (``epivo_tpu_torch/_graphs.py``),
and the rank program of ``tests/test_torch_graphs_mesh.py``.

There is no CUDA graph on the CPU. :class:`StubCapture`'s "capture" runs
the function once, and its "replay" (:class:`StubGraph`) runs it again on
the static inputs with the launch and collective counters put back, as a
CUDA graph replays without running Python. With it the graphed code path
of the entry points runs on the CPU, collectives included (a stub replay
on gloo ranks runs them, as a replay on NCCL ranks does).

This module imports nothing of JAX: the gloo ranks that
:func:`mesh_graph_checks` runs in import it.
"""

from __future__ import annotations

import torch

from epivo_tpu_torch import _graphs


class StubGraph:
    """Replays by running the function again on the static inputs, with the
    launch and collective counters put back, into the static outputs."""

    def __init__(self, fn, static, inputs, outputs):
        self.fn, self.static, self.inputs, self.outputs = fn, static, inputs, outputs

    def replay(self):
        saved, saved_c = _graphs.launches(), _graphs.collectives()
        new = self.fn(self.static, *self.inputs)
        _graphs._add_launches({k: saved[k] - v for k, v in _graphs.launches().items()})
        _graphs._add_collectives({k: saved_c.get(k, 0) - v
                                  for k, v in _graphs.collectives().items()})
        for o, n in zip(_flat(self.outputs), _flat(new)):
            o.copy_(n)


def _flat(out):
    return [out] if isinstance(out, torch.Tensor) else [o for o in out if o is not None]


class StubCapture:
    def __init__(self):
        self.captures = 0

    def warmup(self, fn, static, args, device):
        return fn(static, *args)

    def capture(self, fn, static, inputs, device):
        self.captures += 1
        out = fn(static, *inputs)
        return StubGraph(fn, static, inputs, out), out, 0, 0.0


def graph_cpu_calls(wanted):
    """``_graphs.wanted`` with ``graph=None`` graphing CPU tensors too (as
    it graphs CUDA tensors on the card), from the original ``wanted``."""
    return lambda x, graph, blocked=None, default=True: (
        (blocked is None and default) if graph is None else wanted(x, graph, blocked, default))


class RecordingCache(_graphs.GraphCache):
    """The graph cache, logging (function name, what the call did: "eager",
    "capture" or "replay") per call."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.log = []

    def __call__(self, fn, static, *args):
        key = (fn, static, tuple(_graphs._spec(a) for a in args))
        what = ("replay" if key in self.entries else "capture" if key in self.seen
                else "eager")
        self.log.append((fn.__name__, what))
        return super().__call__(fn, static, *args)


def mesh_graph_checks(dev: torch.device, src, tgt, vo_cfg, orb_cfg, ba_in: tuple,
                      chain: tuple) -> dict:
    """The mesh paths through the graph cache on one of two gloo CPU ranks
    (``multihost.spawn``), each held to the same call with ``graph=False``:

    - ``batch_draw``: ``vo_step_batched`` and ``vo_step_orb_batched`` on
      this rank's lanes of a 3-lane batch (``runners._lanes`` over
      ``win``; rank 1's lanes repeat the last), drawing from a
      ``BatchDraw``: three calls from one seed and three from a carried
      generator, beside the eager calls. On gloo as it is: the step holds
      no collective;
    - ``gloo``: what a gloo mesh blocks: ``graph=True`` with a hyp split
      and with the polish raises, ``graph=None`` runs them eagerly;
    - ``hyp``, ``ba`` and ``global``, with every mesh taken as capturable
      (the rule of an NCCL mesh): the step with its hypotheses over
      ``hyp`` (three calls, the collectives they ran against three eager
      calls'), ``distributed_ba_step`` over ``win`` on ``ba_in`` (T0s, p,
      p_t, wreps, pmask, spec, BA config), ``global_ba_solve`` over
      ``win`` on ``chain`` (T0s, reps, p, p_t, wreps, keyword arguments),
      eagerly and twice graphed, with the collectives of each.

    Returns numpy results, the cache's log and the captures."""
    from epivo_tpu_torch import ransac
    from epivo_tpu_torch.parallel import dist as dist_mod, mesh as mesh_mod
    from epivo_tpu_torch.pipeline import runners, vo
    from epivo_tpu_torch.tools.mesh_checks import to_host

    cache = RecordingCache(capturer=StubCapture())
    _graphs.CACHE = cache
    _graphs.wanted = graph_cpu_calls(_graphs.wanted)
    win = mesh_mod.make_mesh(2, 1, device_type=dev.type)
    hyp = mesh_mod.make_mesh(1, 2, device_type=dev.type)
    src, tgt = torch.from_numpy(src), torch.from_numpy(tgt)
    gen = lambda seed: torch.Generator().manual_seed(seed)
    out = {}

    def counted(fn):
        before = _graphs.collectives()
        res = fn()
        return res, {k: v - before.get(k, 0) for k, v in _graphs.collectives().items()
                     if v != before.get(k, 0)}

    lanes = runners._lanes(src.shape[0], win)
    s_l, t_l = src[lanes], tgt[lanes]
    draw = lambda g: ransac.BatchDraw(g, tuple(lanes), src.shape[0])
    bd = {}
    for name, step, cfg in (("klt", vo.vo_step_batched, vo_cfg),
                            ("orb", vo.vo_step_orb_batched, orb_cfg)):
        g_e, g_g = gen(5), gen(5)
        bd[name] = dict(
            eager=step(s_l, t_l, draw(gen(9)), cfg, graph=False),
            graphed=[step(s_l, t_l, draw(gen(9)), cfg) for _ in range(3)],
            carried_eager=[step(s_l, t_l, draw(g_e), cfg, graph=False) for _ in range(3)],
            carried=[step(s_l, t_l, draw(g_g), cfg) for _ in range(3)])
    out["batch_draw"] = bd
    out["lanes"] = lanes

    captures = cache.capturer.captures
    raised = []
    for call in (lambda: vo.vo_step_batched(src[:2], tgt[:2], gen(3), vo_cfg, hyp_mesh=hyp,
                                            graph=True),
                 lambda: _solve(chain, mesh=win, graph=True)):
        try:
            call()
        except ValueError as e:
            raised.append(str(e))
    out["gloo"] = dict(
        raised=raised,
        hyp_eager=counted(lambda: vo.vo_step_batched(src[:2], tgt[:2], gen(3), vo_cfg,
                                                     hyp_mesh=hyp, graph=False)),
        hyp_none=counted(lambda: vo.vo_step_batched(src[:2], tgt[:2], gen(3), vo_cfg,
                                                    hyp_mesh=hyp)),
        global_eager=counted(lambda: _solve(chain, mesh=win, graph=False)),
        global_none=counted(lambda: _solve(chain, mesh=win)),
        captures=cache.capturer.captures - captures)

    # The distributed BA step: no collective inside its graph, so on gloo too.
    *arrays, spec, ba_cfg = ba_in
    args = [torch.from_numpy(a) for a in arrays]
    out["ba"] = dict(eager=[counted(lambda: dist_mod.distributed_ba_step(
                         win, spec, ba_cfg, graph=False)(*args)) for _ in range(3)],
                     graphed=[counted(lambda: dist_mod.distributed_ba_step(
                         win, spec, ba_cfg)(*args)) for _ in range(3)])

    # With the collectives inside: an NCCL mesh's rule on these gloo ranks.
    mesh_mod.capturable = lambda mesh: True
    out["hyp"] = dict(
        eager=[counted(lambda: vo.vo_step_batched(src[:2], tgt[:2], gen(3), vo_cfg,
                                                  hyp_mesh=hyp, graph=False))
               for _ in range(3)],
        graphed=[counted(lambda: vo.vo_step_batched(src[:2], tgt[:2], gen(3), vo_cfg,
                                                    hyp_mesh=hyp)) for _ in range(3)])
    out["global"] = dict(
        eager=counted(lambda: _solve(chain, mesh=win, graph=False)),
        graphed=[counted(lambda: _solve(chain, mesh=win)) for _ in range(2)])
    out["log"] = cache.log
    out["captures"] = cache.capturer.captures
    out["replays"] = {f"{k[0].__name__} {[None if a is None else list(a[0]) for a in k[2]]}":
                      e.replays for k, e in cache.entries.items()}
    return to_host(out)


def _solve(chain: tuple, **kw):
    """``global_ba_solve`` on ``chain`` = (T0s, reps, p, p_t, wreps, its
    keyword arguments)."""
    from epivo_tpu_torch.parallel import global_ba

    T0s, reps, p, p_t, w, kwargs = chain
    t = torch.from_numpy
    return global_ba.global_ba_solve(t(T0s), reps, t(p), t(p_t), wreps=t(w), **kwargs, **kw)
