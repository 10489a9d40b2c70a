"""The port's compile-once dispatch (``epivo_tpu_torch/_graphs.py``) on the
CPU, where there is no CUDA graph: the ``graph=`` switch of
``vo_step_batched``, ``vo_step`` and ``ba_windows``, the RANSAC draw split
into uniforms (drawn before a replay) and the Gumbel top-k (captured), the
device constants built once, the cache's keys, LRU and launch accounting,
and what a mesh or a ``BatchDraw`` leaves to a capture.

The cache's bookkeeping runs through a stub capturer
(``tests/graph_stub.py``): its "capture" runs the function once, and its
"replay" runs it again on the static inputs with the launch and
collective counters put back, as a CUDA graph replays without running
Python. With it the graphed code path of the entry points runs on
the CPU and must give the eager result bit for bit; the graphed windowed
BA is also held to the JAX package's ``ba_windows`` at
``tests/test_torch_ba.py``'s tolerances. ``chip_smoke.py`` holds the real
graphs to the eager path on the card.

Small sizes: 96x128 corridor pairs (128 keypoints, 3 KLT levels, 16
hypotheses) and 8 windows of ``bench_ba_workload.npz``; one torch thread.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epivo_tpu.pipeline import ba as jba, config as jconfig
from epivo_tpu_torch import _device, _graphs, ransac as transac
from epivo_tpu_torch.datasets import photoreal
from epivo_tpu_torch.frontend import fast as tfast, klt as tklt
from epivo_tpu_torch.geometry.camera import Pinhole
from epivo_tpu_torch.parallel import global_ba as tgba
from epivo_tpu_torch.pipeline import ba as tba, config as tconfig, vo as tvo
from tests.graph_stub import StubCapture, StubGraph, graph_cpu_calls  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HS, WS = 96, 128


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _config(solver="8pt", method="ransac"):
    return tconfig.VOConfig(
        camera=Pinhole(fx=110.0, fy=110.0, cx=WS / 2, cy=HS / 2, width=WS, height=HS),
        frontend=tconfig.FrontendConfig(fast_threshold=12.0, max_keypoints=128,
                                        klt_levels=3),
        ransac=tconfig.RansacConfig(n_hyp=16, solver=solver, method=method),
        lm=tconfig.LMConfig(n_points=16, max_iters=5),
    )


@pytest.fixture(scope="module")
def pairs():
    """[2, H, W] sources and targets: frames 0 -> 1 of two corridors."""
    K = np.array([[110.0, 0, WS / 2], [0, 110.0, HS / 2], [0, 0, 1.0]])
    seqs = [list(photoreal.corridor_sequence(2, H=HS, W=WS, K=K, speed=0.45, seed=s)[0])
            for s in (11, 12)]
    src = np.stack([np.asarray(f[0], np.float32) for f in seqs])
    tgt = np.stack([np.asarray(f[1], np.float32) for f in seqs])
    return torch.from_numpy(src), torch.from_numpy(tgt)


def _ba_inputs(n=8):
    z = np.load(os.path.join(REPO, "bench_ba_workload.npz"))
    return [torch.from_numpy(z[k][:n]) for k in ("T0s", "p", "p_t", "wreps", "pmask")]


def _ba_config():
    return tconfig.BAConfig(lm=tconfig.LMConfig(n_points=32, max_iters=30,
                                                revert_r_norm=1e-2),
                            window_size=3, stride=2)


@pytest.fixture
def gloo_mesh(tmp_path):
    """A (1, 1) CPU mesh on a gloo group of one rank in this process: its
    collectives run, over one rank."""
    import torch.distributed as dist

    from epivo_tpu_torch.parallel import mesh as mesh_mod

    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    try:
        yield mesh_mod.make_mesh(1, 1, device_type="cpu")
    finally:
        dist.destroy_process_group()


@pytest.fixture
def stub_cache(monkeypatch):
    """The process cache replaced by one on the stub capturer, and every
    CPU call of the entry points sent through it (``graph=None`` graphs)."""
    cache = _graphs.GraphCache(capturer=StubCapture())
    monkeypatch.setattr(_graphs, "CACHE", cache)
    monkeypatch.setattr(_graphs, "wanted", graph_cpu_calls(_graphs.wanted))
    return cache


def _assert_equal(a, b):
    for x, y in zip(a, b):
        assert torch.equal(x, y)


# -- the switch ---------------------------------------------------------------


def test_graph_true_raises_on_cpu(pairs):
    src, tgt = pairs
    with pytest.raises(ValueError, match="CUDA"):
        tvo.vo_step_batched(src, tgt, torch.Generator().manual_seed(0), _config(),
                            graph=True)
    with pytest.raises(ValueError, match="CUDA"):
        tvo.vo_step(src[0], tgt[0], torch.Generator().manual_seed(0), _config(),
                    graph=True)
    T0s, p, p_t, w, m = _ba_inputs(2)
    with pytest.raises(ValueError, match="CUDA"):
        tba.ba_windows(T0s, tba.mono_window_spec(3), p, p_t, w, m, _ba_config(),
                       graph=True)


@pytest.mark.parametrize("case", ["gloo_mesh", "batch_draw"])
def test_graph_true_raises_with_a_mesh_or_a_batch_draw(pairs, request, case):
    """graph=True raises where a gloo mesh's collective sits inside the
    captured function; a BatchDraw graphs (its rows drawn before each
    replay)."""
    src, tgt = pairs
    gen = torch.Generator().manual_seed(0)
    if case == "gloo_mesh":
        mesh = request.getfixturevalue("gloo_mesh")
        T0s, p, p_t, w, m = _ba_inputs(2)
        reps = np.array([[0, 0], [1, 1]], np.int32)
        args = (T0s[0, :2].contiguous(), reps, p[:, 0], p_t[:, 0])
        # The polish sums over its mesh even at one rank: a gloo all_reduce.
        with pytest.raises(ValueError, match="a gloo mesh.*graph=None or False"):
            tgba.global_ba_solve(*args, max_span=1, max_iters=2, mesh=mesh, graph=True)
        # Under None it runs eagerly, as a CPU call does.
        assert not _graphs.wanted(T0s, None, "a gloo mesh")
        assert not _graphs.wanted(T0s, None) and not _graphs.wanted(T0s, False)
        # A hyp axis of one rank leaves RANSAC without a collective: only
        # the CPU keeps this step from a graph.
        with pytest.raises(ValueError, match="CUDA"):
            tvo.vo_step_batched(src, tgt, gen, _config(), hyp_mesh=mesh, graph=True)
        _assert_equal(tvo.vo_step_batched(src, tgt, torch.Generator().manual_seed(4),
                                          _config(), hyp_mesh=mesh, graph=False),
                      tvo.vo_step_batched(src, tgt, torch.Generator().manual_seed(4),
                                          _config(), graph=False))
    else:
        cache = request.getfixturevalue("stub_cache")
        draw = lambda g: transac.BatchDraw(g, (1, 0), 3)
        with pytest.raises(ValueError, match="CUDA"):
            tvo.vo_step_batched(src, tgt, draw(gen), _config(), graph=True)
        eager = tvo.vo_step_batched(src, tgt, draw(torch.Generator().manual_seed(6)),
                                    _config(), graph=False)
        for _ in range(3):  # eager, the capture's eager run, a replay
            _assert_equal(tvo.vo_step_batched(src, tgt, draw(torch.Generator().manual_seed(6)),
                                              _config()), eager)
        assert cache.capturer.captures == 1
        assert next(iter(cache.entries.values())).replays == 1


@pytest.mark.parametrize("solver", ["8pt", "5pt"])
def test_graph_none_on_cpu_is_eager(pairs, solver):
    src, tgt = pairs
    cfg = _config(solver)
    run = lambda graph: tvo.vo_step_batched(src, tgt, torch.Generator().manual_seed(3),
                                            cfg, graph=graph)
    _assert_equal(run(None), run(False))
    T0s, p, p_t, w, m = _ba_inputs(4)
    ba = lambda graph: tba.ba_windows(T0s, tba.mono_window_spec(3), p, p_t, w, m,
                                      _ba_config(), graph=graph)
    _assert_equal(ba(None), ba(False))


# -- the draw -----------------------------------------------------------------


def _old_sample_indices(generator, n_hyp, N, mask, sample_size, lead):
    """``ransac._sample_indices`` as it was before the split: one function."""
    u = torch.rand(tuple(lead) + (n_hyp, N), generator=generator, device=generator.device)
    u = torch.clamp(u, min=torch.finfo(u.dtype).tiny)
    g = -torch.log(-torch.log(u))
    if mask is not None:
        g = torch.where(mask[..., None, :], g, -torch.inf)
    return transac.top_k_stable(g, sample_size)[1]


@pytest.mark.parametrize("sample_size,lead", [(8, ()), (8, (3,)), (5, (2,))])
def test_split_draw_matches_one_function(sample_size, lead):
    N, n_hyp = 40, 16
    mask = (torch.arange(N) % 3 > 0).expand(lead + (N,))
    old = _old_sample_indices(torch.Generator().manual_seed(4), n_hyp, N, mask,
                              sample_size, lead)
    g = torch.Generator().manual_seed(4)
    u = transac.draw_uniforms(g, n_hyp, N, lead)
    assert torch.equal(transac.gumbel_top_k(u, mask, sample_size), old)
    g = torch.Generator().manual_seed(4)
    out = torch.empty(lead + (n_hyp, N))
    transac.draw_uniforms(g, n_hyp, N, lead, out=out)
    assert torch.equal(transac.gumbel_top_k(out, mask, sample_size), old)
    assert torch.equal(transac._sample_indices(torch.Generator().manual_seed(4), n_hyp,
                                               N, mask, sample_size, lead=lead), old)


def test_n_keypoints_is_detects_budget():
    for H, W, k in ((96, 128, 128), (96, 128, 50000), (256, 300, 512), (256, 300, 9000),
                    (20, 30, 1000)):
        kp = tfast.detect(torch.rand(H, W) * 255, 12.0, k)
        assert kp.xy.shape[-2] == tfast.n_keypoints(H, W, k)


# -- host data ----------------------------------------------------------------


@pytest.fixture
def host_builds(monkeypatch):
    """Counts the tensors built from host data (not from a tensor)."""
    seen = []
    for name in ("as_tensor", "tensor", "from_numpy"):
        fn = getattr(torch, name)

        def counted(data, *a, _fn=fn, _name=name, **kw):
            if not isinstance(data, torch.Tensor):
                seen.append(_name)
            return _fn(data, *a, **kw)

        monkeypatch.setattr(torch, name, counted)
    to_device = _device.to_device
    monkeypatch.setattr(_device, "to_device",
                        lambda *a, **kw: seen.append("to_device") or to_device(*a, **kw))
    return seen


@pytest.mark.parametrize("solver", ["8pt", "5pt"])
def test_second_step_builds_nothing_from_host_data(pairs, host_builds, solver):
    src, tgt = pairs
    cfg = _config(solver)
    gen = torch.Generator().manual_seed(1)
    tvo.vo_step_batched(src, tgt, gen, cfg)
    host_builds.clear()
    tvo.vo_step_batched(src, tgt, gen, cfg)
    tvo.vo_step(src[0], tgt[0], gen, cfg)
    assert host_builds == []


def test_second_ba_call_builds_nothing_from_host_data(host_builds):
    T0s, p, p_t, w, m = _ba_inputs(4)
    for spec in (tba.mono_window_spec(3), tba.stereo_window_spec(3)[0]):
        n_r, n_z = len(spec.reps), spec.n_zeta
        args = (T0s[:, :1].expand(4, n_z, 4, 4).contiguous(), spec,
                p[:, :1].expand(4, n_r, -1, -1), p_t[:, :1].expand(4, n_r, -1, -1))
        cfg = dataclasses.replace(_ba_config(), lm=tconfig.LMConfig(max_iters=3))
        tba.ba_windows(*args, config=cfg)
        host_builds.clear()
        tba.ba_windows(*args, config=cfg)
        assert host_builds == []


def test_constants_are_built_once():
    a = _device.constant([[1.0, 2.0]], torch.float32, "cpu")
    b = _device.constant(np.array([[1.0, 2.0]]), torch.float32, torch.device("cpu"))
    assert a is b
    assert _device.constant([[1.0, 2.0]], torch.float64, "cpu") is not a
    assert _device.constant([[1.0, 3.0]], torch.float32, "cpu") is not a


# -- the cache ----------------------------------------------------------------


def _bump(static, x, y=None):
    """A stand-in step: two fast_cand launches and one klt_level launch per
    call, as the kernel wrappers count them."""
    tfast.CAND_LAUNCHES += 2
    tklt.LEVEL_LAUNCHES += 1
    out = x * static[0] + (0 if y is None else y.sum())
    return out, out.sum()


def test_cache_keys_configs_shapes_and_optional_inputs():
    cap = StubCapture()
    cache = _graphs.GraphCache(capturer=cap)
    x8, x4 = torch.ones(8, 3), torch.ones(4, 3)
    for static, args in (((2.0,), (x8,)), ((2.0,), (x8,)), ((3.0,), (x8,)),
                         ((2.0,), (x4,)), ((2.0,), (torch.ones(8, 5),)),
                         ((2.0,), (x8.double(),)), ((2.0,), (x8, x4)), ((2.0,), (x8, None))):
        for _ in range(2):  # a key captures on its second call
            cache(_bump, static, *args)
    # Two calls shared one key; a None differs from an absent argument.
    assert cap.captures == len(cache.entries) == 7 and not cache.seen
    # A replay gives what the eager call gives, as a fresh tensor.
    out = cache(_bump, (3.0,), torch.full((8, 3), 2.0))
    assert torch.equal(out[0], torch.full((8, 3), 6.0)) and cap.captures == 7
    again = cache(_bump, (3.0,), torch.full((8, 3), 2.0))
    assert again[0] is not out[0] and torch.equal(again[0], out[0])


def test_cache_evicts_the_least_recently_used_after_16():
    cap = StubCapture()
    cache = _graphs.GraphCache(capturer=cap)
    xs = [torch.ones(n + 1) for n in range(17)]
    for x in xs[:16]:
        cache(_bump, (1.0,), x)
        cache(_bump, (1.0,), x)  # the second call captures
    cache(_bump, (1.0,), xs[0])  # a hit: xs[0] becomes the most recent
    cache(_bump, (1.0,), xs[16])
    cache(_bump, (1.0,), xs[16])  # the 17th captured key evicts xs[1]'s
    assert len(cache.entries) == _graphs.MAX_ENTRIES == 16
    shapes = [k[2][0][0] for k in cache.entries]
    assert (2,) not in shapes and (1,) in shapes and (17,) in shapes
    cache(_bump, (1.0,), xs[1])  # evicted: seen anew, eager
    assert cap.captures == 17
    cache(_bump, (1.0,), xs[1])
    assert cap.captures == 18


def test_replays_add_the_captured_launches():
    cache = _graphs.GraphCache(capturer=StubCapture())
    x = torch.ones(3)
    c0, l0 = tfast.CAND_LAUNCHES, tklt.LEVEL_LAUNCHES
    cache(_bump, (1.0,), x)  # the eager first call launches
    assert (tfast.CAND_LAUNCHES - c0, tklt.LEVEL_LAUNCHES - l0) == (2, 1)
    assert not cache.entries
    cache(_bump, (1.0,), x)  # the second call's eager run launches; its capture does not
    assert (tfast.CAND_LAUNCHES - c0, tklt.LEVEL_LAUNCHES - l0) == (4, 2)
    entry = next(iter(cache.entries.values()))
    assert {a: n for (_, a), n in entry.launches.items() if n} == {
        "CAND_LAUNCHES": 2, "LEVEL_LAUNCHES": 1}
    for _ in range(3):
        cache(_bump, (1.0,), x)
    assert (tfast.CAND_LAUNCHES - c0, tklt.LEVEL_LAUNCHES - l0) == (10, 5)
    assert entry.replays == 3


def test_fill_inputs_are_written_before_each_replay():
    cache = _graphs.GraphCache(capturer=StubCapture())
    g = torch.Generator().manual_seed(5)
    fill = lambda: _graphs.Fill((4,), torch.float32, torch.device("cpu"),
                                lambda out: torch.rand(4, generator=g, out=out))
    got = [cache(_bump, (1.0,), fill())[0] for _ in range(3)]
    ref = torch.Generator().manual_seed(5)
    for x in got:  # one draw per call, in order: the generator is not used twice
        assert torch.equal(x, torch.rand(4, generator=ref))


# -- the graphed entry points through the stub ----------------------------------


@pytest.mark.parametrize("solver,method", [("8pt", "ransac"), ("5pt", "ransac"),
                                           ("8pt", "lmeds")])
def test_graphed_step_matches_eager(pairs, stub_cache, monkeypatch, solver, method):
    src, tgt = pairs
    cfg = _config(solver, method)
    # A budget above lane 0's 963 corners: its empty lanes mask the draw.
    big = dataclasses.replace(cfg, frontend=dataclasses.replace(
        cfg.frontend, max_keypoints=1024, klt_levels=2))
    gen = lambda: torch.Generator().manual_seed(9)
    eager = tvo.vo_step_batched(src, tgt, gen(), big, graph=False)
    seen = []
    ransac_essential = transac.ransac_essential
    monkeypatch.setattr(transac, "ransac_essential", lambda *a, **kw: (
        seen.append(kw["samples"]), ransac_essential(*a, **kw))[1])
    c0, l0 = tfast.CAND_LAUNCHES, tklt.LEVEL_LAUNCHES
    for _ in range(3):  # the eager first call, the capture's eager run, a replay
        _assert_equal(tvo.vo_step_batched(src, tgt, gen(), big), eager)
    assert stub_cache.capturer.captures == 1
    assert next(iter(stub_cache.entries.values())).replays == 1
    # The captured top-k draws the eager path's samples: the same uniforms,
    # masked by the tracked points.
    fc = big.frontend
    kp = tfast.detect(src, fc.fast_threshold, fc.max_keypoints)
    status = tklt.track(src, tgt, kp.xy, valid=kp.valid, win=fc.klt_window,
                        levels=fc.klt_levels, iters=fc.klt_iters,
                        min_eig=fc.klt_min_eig).status
    assert not status.all()
    want = transac._sample_indices(gen(), 16, 1024, status, transac.SAMPLE_SIZE[solver],
                                   lead=(2,))
    assert torch.equal(seen[0], want) and torch.equal(seen[-1], want)
    # A generator carried on: each call draws the next uniforms, as eagerly.
    g_e, g_g = gen(), gen()
    for _ in range(3):
        _assert_equal(tvo.vo_step_batched(src, tgt, g_g, cfg),
                      tvo.vo_step_batched(src, tgt, g_e, cfg, graph=False))
    # Injected samples are a static input, and another key.
    samples = transac._sample_indices(gen(), 16, 128, None,
                                      transac.SAMPLE_SIZE[solver], lead=(2,))
    for _ in range(3):
        _assert_equal(tvo.vo_step_batched(src, tgt, None, cfg, ransac_samples=samples),
                      tvo.vo_step_batched(src, tgt, None, cfg, ransac_samples=samples,
                                          graph=False))
    # B = 1 (vo_step) is another key.
    for _ in range(3):
        one = tvo.vo_step(src[1], tgt[1], gen(), cfg)
        _assert_equal(one, tvo.vo_step(src[1], tgt[1], gen(), cfg, graph=False))
    assert stub_cache.capturer.captures == 4 and len(stub_cache.entries) == 4
    # Each key's third call was a replay, checked against eager above.
    assert [e.replays for e in stub_cache.entries.values()] == [1, 1, 1, 1]
    # The plain path keeps no launch count, eager or replayed.
    assert (tfast.CAND_LAUNCHES, tklt.LEVEL_LAUNCHES) == (c0, l0)


def test_graphed_step_keys_batch_and_image_shapes(pairs, stub_cache):
    src, tgt = pairs
    cfg = _config()
    gen = torch.Generator().manual_seed(2)
    tvo.vo_step_batched(src, tgt, gen, cfg)
    tvo.vo_step_batched(src[:1], tgt[:1], gen, cfg)  # a short last batch
    tvo.vo_step_batched(src[:, :80], tgt[:, :80], gen, cfg)  # another image size
    tvo.vo_step_batched(src, tgt, gen, dataclasses.replace(
        cfg, ransac=dataclasses.replace(cfg.ransac, n_hyp=32)))
    tvo.vo_step_batched(src, tgt, gen, cfg)
    # The first key captured on its second call; the other three were seen once.
    assert stub_cache.capturer.captures == len(stub_cache.entries) == 1
    assert len(stub_cache.seen) == 3


def test_graphed_ba_matches_eager_and_reference(stub_cache):
    T0s, p, p_t, w, m = _ba_inputs()
    spec, cfg = tba.mono_window_spec(3), _ba_config()
    eager = tba.ba_windows(T0s, spec, p, p_t, w, m, cfg, graph=False)
    for _ in range(3):  # eager, the capture's eager run, a replay
        _assert_equal(tba.ba_windows(T0s, spec, p, p_t, w, m, cfg), eager)
    for _ in range(3):
        _assert_equal(tba.ba_windows(T0s, spec, p, p_t, None, m, cfg),
                      tba.ba_windows(T0s, spec, p, p_t, None, m, cfg, graph=False))
    assert stub_cache.capturer.captures == 2
    assert [e.replays for e in stub_cache.entries.values()] == [1, 1]
    # The graphed solve against the JAX package's (tests/test_torch_ba.py's
    # tolerances).
    ref = jba.ba_windows(*(jnp.asarray(x.numpy()) for x in (T0s,)), jba.mono_window_spec(3),
                         *(jnp.asarray(x.numpy()) for x in (p, p_t)),
                         wreps=jnp.asarray(w.numpy()), pmask=jnp.asarray(m.numpy()),
                         config=jconfig.BAConfig(lm=jconfig.LMConfig(
                             n_points=32, max_iters=30, revert_r_norm=1e-2),
                             window_size=3, stride=2))
    out = tba.ba_windows(T0s, spec, p, p_t, w, m, cfg)
    _assert_equal(out, eager)
    assert [e.replays for e in stub_cache.entries.values()] == [1, 2]
    rot_dir = lambda T: (np.asarray(T, np.float64)[..., :3, :3],
                         np.asarray(T, np.float64)[..., :3, 3]
                         / np.linalg.norm(np.asarray(T, np.float64)[..., :3, 3], axis=-1,
                                          keepdims=True))
    (R_t, d_t), (R_j, d_j) = rot_dir(out.T_opt.numpy()), rot_dir(ref.T_opt)
    np.testing.assert_allclose(R_t, R_j, atol=1e-4)
    np.testing.assert_allclose(d_t, d_j, atol=3e-3)
    np.testing.assert_allclose(out.r_norm.numpy(), np.asarray(ref.r_norm), rtol=0.2,
                               atol=1e-5)
    np.testing.assert_array_equal(out.reverted.numpy(), np.asarray(ref.reverted))
