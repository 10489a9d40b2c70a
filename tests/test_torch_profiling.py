"""The port's program spans, stage marks and the graph cache's build totals
(``epivo_tpu_torch/utils/profiling.py``, ``epivo_tpu_torch/_graphs.py``)
on the CPU.

- ``run_vo_sequence`` under ``torch.profiler`` opens ``vo.sequence`` and,
  per batch, ``vo.stack``, ``vo.upload``, ``vo.dispatch``, ``vo.fetch`` and
  ``vo.collect`` carrying the batch's index and first frame, then
  ``vo.cloud`` and ``vo.finish``, all nested under ``vo.sequence``; through
  the stub capturer of ``tests/graph_stub.py`` the cache's ``graph.*``
  spans sit under the batch's ``vo.dispatch``. Without a profiler every
  span is the shared no-op, nothing is counted, and the run is bit-equal
  to the profiled one.
- The cache counts eager calls, captures, replays and evictions with
  their host seconds, less the kernel library's compile, and keeps them
  when an entry is evicted.
- The captured and the eager KLT and ORB steps mark ``frontend``,
  ``estimate``, ``refine`` and ``end`` in that order, after ``undistort``
  where the configuration has a distortion (raw frames); a mark on a CPU
  tensor does nothing, and on the card it launches only for a step that
  runs the kernels, while captured or profiled (the card-only test of the
  mark kernels is in ``tests/test_torch_kernels_cuda.py``).

Small sizes: 96x128 corridor frames (128 keypoints, 3 KLT levels, 16
hypotheses); one torch thread.
"""

import contextlib
import dataclasses
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from epivo_tpu_torch import _graphs, _kernels, ransac as transac
from epivo_tpu_torch.datasets import photoreal
from epivo_tpu_torch.frontend import fast as tfast, orb as torb
from epivo_tpu_torch.geometry.camera import Distortion, Pinhole
from epivo_tpu_torch.pipeline import config as tconfig, runners, vo
from epivo_tpu_torch.utils import profiling
from tests.graph_stub import StubCapture, graph_cpu_calls

HS, WS = 96, 128
# The marks of a step on pinhole frames, in order.
STEP_STAGES = ("frontend", "estimate", "refine", "end")
BATCH_SPANS = ("vo.stack", "vo.upload", "vo.dispatch", "vo.fetch", "vo.collect")


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _config():
    return tconfig.VOConfig(
        camera=Pinhole(fx=110.0, fy=110.0, cx=WS / 2, cy=HS / 2, width=WS, height=HS),
        frontend=tconfig.FrontendConfig(fast_threshold=12.0, max_keypoints=128,
                                        klt_levels=3),
        ransac=tconfig.RansacConfig(n_hyp=16),
        lm=tconfig.LMConfig(n_points=16, max_iters=5),
    )


@pytest.fixture(scope="module")
def frames():
    K = np.array([[110.0, 0, WS / 2], [0, 110.0, HS / 2], [0, 0, 1.0]])
    return list(photoreal.corridor_sequence(7, H=HS, W=WS, K=K, speed=0.45, seed=11)[0])


def _profiled(fn):
    """fn() under a CPU profiler with concrete inputs: (its result, the
    program's spans [(name, ids, start, end, names of the spans enclosing
    it, innermost first)] in order of start)."""
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        out = fn()
    # The raw records: FunctionEvent trees over every operator take minutes.
    spans = sorted(((e.name(), list(e.concrete_inputs()), e.start_ns(), e.end_ns())
                    for e in prof.profiler.kineto_results.events()
                    if e.name().startswith(("vo.", "graph."))), key=lambda s: (s[2], -s[3]))
    return out, [(n, ids, s, e, [o[0] for o in reversed(spans[:k]) if o[2] <= s and e <= o[3]])
                 for k, (n, ids, s, e) in enumerate(spans)]


def _assert_same_result(a, b):
    for x, y in ((a.trajectory, b.trajectory), (a.cloud, b.cloud),
                 (a.cloud_limits, b.cloud_limits)):
        assert np.array_equal(x, y)
    for k in a.per_frame:
        assert np.array_equal(a.per_frame[k], b.per_frame[k]), k


def test_runner_spans_nest_with_batch_ids(frames):
    cfg = _config()
    run = lambda: runners.run_vo_sequence(frames[:5], cfg, batch=2, seed=3, device="cpu")
    assert profiling.span("vo.fetch", b=0, frame=0) is profiling.span("graph.replay")
    before = profiling.span_totals()
    plain = run()
    assert profiling.span_totals() == before  # no profiler: nothing counted
    traced, spans = _profiled(run)
    _assert_same_result(plain, traced)

    names = [s[0] for s in spans]
    assert names.count("vo.sequence") == 1
    seq = next(s for s in spans if s[0] == "vo.sequence")
    assert seq[1] == [3]  # the call's seed
    for name in BATCH_SPANS:
        assert [s[1] for s in spans if s[0] == name] == [[0, 0], [1, 2]], name
    assert names.count("vo.cloud") == 1 and names[-1] == "vo.finish"
    for name, _, start, end, up in spans:
        if name != "vo.sequence":
            assert "vo.sequence" in up and seq[2] <= start <= end <= seq[3], name
    # Depth 2: both batches are dispatched before the first fetch.
    assert names.index("vo.fetch") > max(i for i, n in enumerate(names) if n == "vo.dispatch")
    after = profiling.span_totals()
    for name in BATCH_SPANS:
        assert after[name][1] - before.get(name, (0.0, 0))[1] == 2
    assert after["vo.sequence"][0] > after["vo.fetch"][0] >= 0.0


def test_graph_spans_under_dispatch(frames, monkeypatch):
    cache = _graphs.GraphCache(capturer=StubCapture())
    monkeypatch.setattr(_graphs, "CACHE", cache)
    monkeypatch.setattr(_graphs, "wanted", graph_cpu_calls(_graphs.wanted))
    # Three batches of two pairs: the key's eager call, its capture, a replay.
    res, spans = _profiled(lambda: runners.run_vo_sequence(
        frames, _config(), batch=2, seed=5, device="cpu"))
    assert res.trajectory.shape == (7, 4, 4)
    graph = [(s[0], s[4]) for s in spans if s[0].startswith("graph.")]
    assert [g[0] for g in graph] == ["graph.eager", "graph.capture", "graph.fill",
                                     "graph.replay", "graph.clone"]
    for _, up in graph:
        assert up[0] == "vo.dispatch" and "vo.sequence" in up
    t = cache.totals
    assert (t.eager, t.captures, t.replays, t.evictions) == (1, 1, 1, 0)


def _scale(static, x):
    return x * static


def test_build_totals_survive_eviction(monkeypatch):
    cache = _graphs.GraphCache(maxsize=1, capturer=StubCapture())
    monkeypatch.setattr(_graphs, "CACHE", cache)
    assert _graphs.build_totals() == dict(eager=0, eager_s=0.0, captures=0, capture_s=0.0,
                                          replays=0, evictions=0)
    a, b = torch.ones(3), torch.ones(4)
    for _ in range(4):  # eager, capture, two replays
        cache(_scale, 2.0, a)
    (entry_a,) = cache.entries.values()
    first = dataclasses.asdict(cache.totals)
    assert first["capture_s"] == pytest.approx(entry_a.warmup_s + entry_a.capture_s)
    cache(_scale, 2.0, b)  # eager
    cache(_scale, 2.0, b)  # capture: a's entry goes
    (entry_b,) = cache.entries.values()
    t = _graphs.build_totals()
    assert (t["eager"], t["captures"], t["replays"], t["evictions"]) == (2, 2, 2, 1)
    assert t["eager_s"] > first["eager_s"] > 0.0
    assert t["capture_s"] == pytest.approx(first["capture_s"] + entry_b.warmup_s
                                           + entry_b.capture_s)


@pytest.fixture(scope="module")
def pair(frames):
    return (torch.from_numpy(np.stack(frames[:2])),
            torch.from_numpy(np.stack(frames[1:3])))


@pytest.mark.parametrize("path", ["captured", "eager"])
@pytest.mark.parametrize("step", ["klt", "orb"])
def test_step_marks_in_order(pair, monkeypatch, step, path):
    marked = []
    monkeypatch.setattr(profiling, "mark", lambda stage, like, use_kernel=None: marked.append(
        (stage, like.device.type, use_kernel)))
    src, tgt = pair
    cfg = _config()
    gen = torch.Generator().manual_seed(1)
    if path == "eager":
        use_kernel = False
        fn = vo.vo_step_batched if step == "klt" else vo.vo_step_orb_batched
        fn(src, tgt, gen, cfg, use_kernel=use_kernel, graph=False)
    else:
        use_kernel = None
        fn = vo._klt_graphed if step == "klt" else vo._orb_graphed
        K = (tfast.n_keypoints(HS, WS, cfg.frontend.max_keypoints) if step == "klt"
             else torb.n_keypoints(HS, WS, cfg.frontend))
        fn((cfg, use_kernel, True, None), src, tgt,
           transac.draw_uniforms(gen, cfg.ransac.hypotheses(), K, (2,)))
    # Every mark carries the step's use_kernel, which decides whether it launches.
    assert marked == [(s, "cpu", use_kernel) for s in STEP_STAGES]


@pytest.mark.parametrize("step", ["klt", "orb"])
def test_raw_frames_step_marks_undistort_first(pair, monkeypatch, step):
    """A step given raw frames (``distortion`` set) opens with the
    ``undistort`` mark, captured and eager alike."""
    marked = []
    monkeypatch.setattr(profiling, "mark", lambda stage, like, use_kernel=None: marked.append(
        stage))
    src, tgt = pair
    cfg = dataclasses.replace(_config(), distortion=Distortion(-0.28, 0.07, 2e-4, 2e-5))
    gen = torch.Generator().manual_seed(1)
    fn = vo.vo_step_batched if step == "klt" else vo.vo_step_orb_batched
    fn(src, tgt, gen, cfg, use_kernel=False, graph=False)
    graphed = vo._klt_graphed if step == "klt" else vo._orb_graphed
    K = (tfast.n_keypoints(HS, WS, cfg.frontend.max_keypoints) if step == "klt"
         else torb.n_keypoints(HS, WS, cfg.frontend))
    graphed((cfg, None, True, None), src, tgt,
            transac.draw_uniforms(gen, cfg.ransac.hypotheses(), K, (2,)))
    assert marked == 2 * list(profiling.STAGES)


def test_mark_on_cpu_loads_nothing(monkeypatch):
    def no_library():
        raise AssertionError("a mark on a CPU tensor loaded the kernel library")

    monkeypatch.setattr(_kernels, "lib", no_library)
    for stage in profiling.STAGES:
        assert profiling.mark(stage, torch.zeros(2)) is None
    assert profiling.STAGES == ("undistort",) + STEP_STAGES


class _CardLike:
    """Stands for a CUDA tensor: the mark's gate reads only ``is_cuda``."""

    is_cuda = True


@pytest.mark.parametrize("use_kernel,capturing,profiled,launches", [
    (None, False, False, 0),  # an untraced eager kernel step
    (None, True, False, 4),  # a capture
    (None, False, True, 4),  # a profiled eager kernel step
    (False, True, True, 0),  # the plain route, even captured and profiled
])
def test_mark_launches_when_captured_or_profiled(monkeypatch, use_kernel, capturing,
                                                 profiled, launches):
    launched = []

    class Library:
        def epivo_stage_mark(self, number, stream):
            launched.append(number)
            return 0

    monkeypatch.setattr(_kernels, "lib", Library)
    monkeypatch.setattr(_kernels, "stream_of", lambda like: 0)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: capturing)
    with profile(activities=[ProfilerActivity.CPU]) if profiled else contextlib.nullcontext():
        for stage in STEP_STAGES:
            profiling.mark(stage, _CardLike(), use_kernel)
        if launches:  # a raw-frames step's mark, numbered first
            profiling.mark("undistort", _CardLike(), use_kernel)
    assert launched == [profiling.STAGES.index(s) for s in STEP_STAGES][:launches] + (
        [0] if launches else [])


def test_build_totals_leave_out_the_library_compile(monkeypatch):
    cache = _graphs.GraphCache(capturer=StubCapture())
    monkeypatch.setattr(_kernels, "build_s", 0.0)

    def compiling(static, x):
        t0 = time.perf_counter()  # as a kernel launch that compiles the library
        time.sleep(0.05)
        _kernels.build_s += time.perf_counter() - t0
        return x * static

    cache(compiling, 2.0, torch.ones(3))  # eager
    cache(compiling, 2.0, torch.ones(3))  # capture: warm-up and recording
    t = cache.totals
    assert (t.eager, t.captures) == (1, 1)
    assert _kernels.build_s >= 0.15
    assert 0.0 <= t.eager_s < 0.05 and 0.0 <= t.capture_s < 0.05
