"""Compile-once dispatch on the card: each (function, static configuration,
input shapes) of a main-path entry point is captured as a CUDA graph on
its second call and replayed on every later call.

This is the port's counterpart of the reference's ``jax.jit`` under
``functools.lru_cache(maxsize=16)`` (``epivo_tpu/pipeline/runners.py:52,317``):
XLA runs a step as one program, where eager PyTorch issues every operator
from the host (some 27,000 kernels for one KLT step). A replay issues the
whole step with one host call.

:func:`run` ``(fn, static, *args)`` calls ``fn(static, *args)``. ``static``
is hashable (the frozen config dataclasses); each argument is a tensor,
``None`` or a :class:`Fill`. The cache key is ``fn``, ``static``, and each
argument's shape, dtype and device (``None`` where an optional input is
absent); a new shape is a new key, as a new shape is a new jit.

- First call for a key: ``fn`` runs eagerly on the caller's stream and
  nothing is captured; the key goes into a "seen" LRU of the same size.
  Unlike XLA's compile, a capture is pure overhead (the eager run has
  already done the work), so a key called once (a short last batch, a
  one-shot retry) never pays for one.
- Second call: ``fn`` runs eagerly on the capture stream, and its result
  is the call's result. That run also builds the lazy state a capture may
  not build (cuBLAS handles and workspaces, the kernel library of
  ``_kernels.lib()``, allocator blocks). Then ``fn`` is captured with
  ``torch.cuda.graph`` on static copies of the inputs, into static outputs
  in a private memory pool of its own (an entry's replays never share a
  pool with another's).
- Later calls copy the inputs into the static buffers, replay, and return
  clones of the outputs: callers dispatch ahead and keep earlier results,
  and JAX returns fresh arrays too.
- The least recently used entry goes when a 17th key is captured; the
  least recently seen key when a 17th is seen once.

What the cache built is counted on it (:class:`BuildTotals`, read by
:func:`build_totals`): eager first calls and captures with their host
seconds, replays and evictions, totals that outlive the entries. The
seconds leave out the kernel library's compile (``_kernels.build_s``),
which only a checkout without the built library pays. Each
call opens host spans while a ``torch.profiler`` runs
(``utils/profiling.py::span``): ``graph.eager`` for a first call,
``graph.capture`` for a second (warm-up, recording, instantiation), and
``graph.fill`` (the ``Fill`` draws and input copies), ``graph.replay``
and ``graph.clone`` (the output clones) for a replay.

The kernels' launch counters (``frontend/fast.py``, ``frontend/klt.py``,
``frontend/orb.py``, ``frontend/undistort.py``)
and the mesh's collectives counter (``parallel/mesh.py``'s
``COLLECTIVES``) are Python numbers that a wrapper bumps when its Python
runs, which a replay never does. So the counts a capture makes are taken
back and kept on the entry, and every replay adds them: the counts stay
the launches and collectives the card ran.

Mesh paths. A step may hold NCCL collectives (a hyp-split RANSAC's
``all_gather``, the global polish's ``all_reduce``s): the graph records
them on the mesh's communicators, which exist by then (the key's eager
first and second calls made them), and a replay runs them. Gloo runs its
collectives on the host, so a call whose function holds one on a gloo
mesh runs eagerly (``wanted``'s ``blocked``: "a gloo mesh"); a mesh
enters ``static`` as a ``parallel.mesh.MeshKey``. The capture keeps the
default (global) error mode, in which torch 2.11 with NCCL 2.27 captures
and replays NCCL collectives (``chip_smoke.py`` phase 13 holds the
replays to eager).

Every rank of a mesh must make the same choices for a key that holds a
collective: a rank that captures while another runs the key eagerly or
replays it would pair its collectives with other ones, and the ranks
hang. The cache's choices (eager, capture, replay, evict) depend only on
the sequence of keys a process calls, and a key only on ``fn``,
``static`` and shapes, so the ranks of an SPMD program call keys in the
same pattern (a ``MeshKey`` holds the rank's own groups; a ``Fill``'s key
is its shape, never the rows it draws). So every rank
captures a key at the same call, as long as the ranks call the same
sequence of keys: keep a rank's own calls (a key only one rank calls)
off the cache with ``graph=False``.

Nothing falls back: an error of a capture or a replay propagates.
"""

from __future__ import annotations

import collections
import dataclasses
import importlib
import time
from typing import Any, Callable, Hashable, NamedTuple

import torch

from epivo_tpu_torch import _kernels
from epivo_tpu_torch.parallel import mesh as mesh_mod
from epivo_tpu_torch.utils import profiling

MAX_ENTRIES = 16  # as the reference's lru_cache(maxsize=16)

# The kernels' launch counters, (module, attribute).
COUNTERS = (
    ("epivo_tpu_torch.frontend.fast", "KERNEL_LAUNCHES"),
    ("epivo_tpu_torch.frontend.fast", "CAND_LAUNCHES"),
    ("epivo_tpu_torch.frontend.klt", "EXTRACT_LAUNCHES"),
    ("epivo_tpu_torch.frontend.klt", "LK_LAUNCHES"),
    ("epivo_tpu_torch.frontend.klt", "LEVEL_LAUNCHES"),
    ("epivo_tpu_torch.frontend.orb", "DESCRIBE_LAUNCHES"),
    ("epivo_tpu_torch.frontend.undistort", "LAUNCHES"),
)


class Fill(NamedTuple):
    """An input that the call writes into the entry's static buffer itself:
    ``fill(out)`` writes a tensor of ``shape`` and ``dtype`` on ``device``
    (the RANSAC uniforms, drawn from their generator before each replay)."""

    shape: tuple
    dtype: torch.dtype
    device: torch.device
    fill: Callable[[torch.Tensor], Any]


def wanted(x: torch.Tensor, graph: bool | None, blocked: str | None = None,
           default: bool = True) -> bool:
    """Resolve an entry point's ``graph`` switch, as ``_device.kernel_wanted``
    resolves ``use_kernel``.

    ``None`` graphs a CUDA tensor unless ``blocked`` (what keeps this call
    from a capture, e.g. "a gloo mesh") or not ``default`` (a path that
    runs eagerly unless asked, e.g. the plain versions of the kernels).
    ``True`` on a CPU tensor or with ``blocked`` raises: nothing falls
    back. ``False`` runs eagerly: the oracle and the debugging path.
    """
    if graph is None:
        return x.is_cuda and blocked is None and default
    if graph:
        if blocked is not None:
            raise ValueError(f"graph=True with {blocked}: a CUDA graph cannot hold this "
                             "call (a gloo mesh's collectives run on the host; an NCCL "
                             "mesh's can be captured); run it with graph=None or False")
        if not x.is_cuda:
            raise ValueError(f"graph=True needs CUDA tensors, got one on {x.device}: "
                             "CUDA graphs exist only on the card")
    return bool(graph)


def launches() -> dict:
    """Every kernel launch counter, {(module, attribute): count}."""
    return {(m, a): getattr(importlib.import_module(m), a) for m, a in COUNTERS}


def _add_launches(delta: dict, sign: int = 1) -> None:
    for (m, a), n in delta.items():
        if n:
            mod = importlib.import_module(m)
            setattr(mod, a, getattr(mod, a) + sign * n)


def collectives() -> dict:
    """The collectives this process ran, {"op/backend/device": calls}."""
    return dict(mesh_mod.COLLECTIVES)


def _add_collectives(delta: dict, sign: int = 1) -> None:
    for k, n in delta.items():
        if n:
            mesh_mod.COLLECTIVES[k] = mesh_mod.COLLECTIVES.get(k, 0) + sign * n


def _map(fn, out):
    """``fn`` on every tensor of an output: a tensor, or a (named) tuple of
    tensors and ``None``."""
    if isinstance(out, torch.Tensor):
        return fn(out)
    if isinstance(out, tuple):
        items = [None if o is None else _map(fn, o) for o in out]
        return type(out)(*items) if hasattr(out, "_fields") else type(out)(items)
    raise TypeError(f"a graphed function returns tensors or tuples of them, "
                    f"got {type(out).__name__}")


def _spec(a):
    if a is None:
        return None
    if isinstance(a, Fill):
        return tuple(a.shape), a.dtype, torch.device(a.device)
    return tuple(a.shape), a.dtype, a.device


@dataclasses.dataclass
class Entry:
    """One captured (function, static, input specs)."""

    graph: Any  # replay() runs the captured work
    inputs: list  # static input buffers (None where the argument is None)
    outputs: Any  # static outputs, in fn's structure
    launches: dict  # counter -> launches per replay
    capture_s: float  # host seconds of the capture and instantiation
    pool_bytes: int  # device memory the capture reserved (its private pool)
    warmup_s: float = 0.0  # host seconds of the eager run before the capture
    instantiate_s: float = 0.0  # the part of capture_s after the recording
    replays: int = 0
    collectives: dict = dataclasses.field(default_factory=dict)  # per replay


@dataclasses.dataclass
class BuildTotals:
    """What a cache built and ran since it was made, kept across evictions."""

    eager: int = 0  # first calls of a key, run eagerly
    eager_s: float = 0.0  # their host seconds
    captures: int = 0  # second calls, captured
    capture_s: float = 0.0  # their host seconds: warm-up, recording, instantiation
    replays: int = 0
    evictions: int = 0  # captured entries dropped by the LRU


class CudaCapture:
    """Warm-up and capture on the card, on one side stream per device."""

    def __init__(self):
        self._streams: dict = {}

    def _stream(self, device: torch.device) -> torch.cuda.Stream:
        s = self._streams.get(device)
        if s is None:
            s = self._streams[device] = torch.cuda.Stream(device=device)
        return s

    def warmup(self, fn, static, args, device):
        """fn(static, *args) eagerly on the capture stream: the first call's
        result, and the lazy state (handles, workspaces, the kernel library)
        built on the stream the capture will use."""
        s, cur = self._stream(device), torch.cuda.current_stream(device)
        s.wait_stream(cur)
        with torch.cuda.stream(s):
            out = fn(static, *args)
        cur.wait_stream(s)
        # Allocated on s, read on the caller's stream from now on.
        _map(lambda t: t.record_stream(cur), out)
        return out

    def capture(self, fn, static, inputs, device):
        """(graph, static outputs, bytes reserved by the capture, host
        seconds from the end of the recording to the instantiated graph)."""
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        before = torch.cuda.memory_reserved(device)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=self._stream(device)):
            out = fn(static, *inputs)
            recorded = time.perf_counter()
        instantiate_s = time.perf_counter() - recorded
        return graph, out, torch.cuda.memory_reserved(device) - before, instantiate_s


def _filled(args) -> list:
    """The arguments with each :class:`Fill` written into a new tensor."""
    out = []
    for a in args:
        if isinstance(a, Fill):
            buf = torch.empty(a.shape, dtype=a.dtype, device=a.device)
            a.fill(buf)
            a = buf
        out.append(a)
    return out


class GraphCache:
    """An LRU of :class:`Entry` by key; :func:`run` is its call."""

    def __init__(self, maxsize: int = MAX_ENTRIES, capturer=None):
        self.maxsize = maxsize
        self.capturer = capturer if capturer is not None else CudaCapture()
        self.entries: collections.OrderedDict = collections.OrderedDict()
        self.seen: collections.OrderedDict = collections.OrderedDict()  # called once
        self.totals = BuildTotals()

    def __call__(self, fn: Callable, static: Hashable, *args):
        key = (fn, static, tuple(_spec(a) for a in args))
        entry = self.entries.get(key)
        if entry is None:
            if self.seen.pop(key, None) is None:
                self.seen[key] = True
                while len(self.seen) > self.maxsize:
                    self.seen.popitem(last=False)
                with profiling.span("graph.eager"):
                    t0, built = time.perf_counter(), _kernels.build_s
                    out = fn(static, *_filled(args))
                    self.totals.eager += 1
                    self.totals.eager_s += (time.perf_counter() - t0
                                            - (_kernels.build_s - built))
                return out
            with profiling.span("graph.capture"):
                return self._capture(key, fn, static, args)
        self.entries.move_to_end(key)
        with profiling.span("graph.fill"):
            for buf, a in zip(entry.inputs, args):
                if isinstance(a, Fill):
                    a.fill(buf)
                elif a is not None:
                    buf.copy_(a)
        with profiling.span("graph.replay"):
            entry.graph.replay()
        entry.replays += 1
        self.totals.replays += 1
        _add_launches(entry.launches)
        _add_collectives(entry.collectives)
        with profiling.span("graph.clone"):
            return _map(torch.clone, entry.outputs)

    def _capture(self, key, fn, static, args):
        device = next(torch.device(s[2]) for s in key[2] if s is not None)
        eager_args = _filled(args)
        built = _kernels.build_s
        t0 = time.perf_counter()
        out = self.capturer.warmup(fn, static, eager_args, device)
        warmup_s = time.perf_counter() - t0
        inputs = [a if isinstance(f, Fill) or a is None
                  else torch.empty_like(a, memory_format=torch.contiguous_format).copy_(a)
                  for f, a in zip(args, eager_args)]
        before, before_c = launches(), collectives()
        t0 = time.perf_counter()
        graph, outputs, pool, instantiate_s = self.capturer.capture(fn, static, inputs, device)
        capture_s = time.perf_counter() - t0
        delta = {k: v - before[k] for k, v in launches().items()}
        delta_c = {k: v - before_c.get(k, 0) for k, v in collectives().items()}
        _add_launches(delta, -1)  # the capture launched nothing
        _add_collectives(delta_c, -1)  # and ran no collective
        self.entries[key] = Entry(graph, inputs, outputs, delta, capture_s, pool,
                                  warmup_s=warmup_s, instantiate_s=instantiate_s,
                                  collectives={k: n for k, n in delta_c.items() if n})
        self.totals.captures += 1
        self.totals.capture_s += warmup_s + capture_s - (_kernels.build_s - built)
        while len(self.entries) > self.maxsize:
            self.entries.popitem(last=False)
            self.totals.evictions += 1
        return out


CACHE = GraphCache()


def run(fn: Callable, static: Hashable, *args):
    """``fn(static, *args)`` through the process's graph cache (see the
    module docstring)."""
    return CACHE(fn, static, *args)


def build_totals() -> dict:
    """The process's graph cache's :class:`BuildTotals` as a dict."""
    return dataclasses.asdict(CACHE.totals)
