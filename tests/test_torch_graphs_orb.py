"""The compile-once dispatch (``epivo_tpu_torch/_graphs.py``) on the ORB
step (``vo_step_orb_batched`` / ``vo_step_orb``) and on the global-BA LM
loop (``global_ba_solve``), and the cache's second-call policy, on the CPU.

As in ``tests/test_torch_graphs.py``, whose stub capturer this file uses,
the graphed code path runs on the CPU: the stub's "capture" runs the
function once and its "replay" runs it again on the static inputs. The
graphed ORB step must give the eager step bit for bit (single scale at
B = 1 and 2, the pyramid at B = 1, from a generator and from injected
samples, and with a lane under the 8-match gate) and stay within
``tests/test_torch_vo_orb.py``'s tolerances of the JAX ``vo_step_orb`` on
the reference's samples; the graphed global solve must give the eager
loop bit for bit and stay within ``tests/test_torch_global_ba.py``'s
tolerances of the JAX ``global_ba_solve``. ``orb.n_keypoints`` (the K of
the RANSAC uniforms drawn before a replay) must equal the association's
K, and a later ORB call must build no tensor from host data (a capture
may not copy from pageable host memory). ``chip_smoke.py`` holds the real
graphs to the eager path on the card.

Small sizes: the 160x120 rendered pairs of ``tests/test_torch_vo_orb.py``
(128 keypoints, 256 hypotheses), the reference's ``chain_scene``; one
torch thread.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epivo_tpu.parallel import global_ba as jgba
from epivo_tpu.pipeline import vo as jvo
from epivo_tpu_torch import _graphs, convert, ransac as transac
from epivo_tpu_torch.frontend import orb as torb
from epivo_tpu_torch.parallel import global_ba as tgba
from epivo_tpu_torch.pipeline import vo as tvo
from tests.test_global_ba import chain_scene
from tests.test_runners_datasets import VO_CFG
from tests.test_torch_graphs import (StubCapture, _assert_equal, _bump,  # noqa: F401
                                     gloo_mesh, host_builds, stub_cache)
from tests.test_torch_vo_orb import _assert_close, _pairs, _reference_samples

B = 2


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _config(pyramid=False):
    cfg = convert.config_from_reference(VO_CFG)
    return dataclasses.replace(cfg, frontend=dataclasses.replace(cfg.frontend,
                                                                 orb_pyramid=pyramid))


@pytest.fixture(scope="module")
def frames():
    src, tgt = _pairs()
    return torch.from_numpy(src), torch.from_numpy(tgt)


# -- the second-call policy -----------------------------------------------------


def test_second_call_policy():
    cap = StubCapture()
    cache = _graphs.GraphCache(capturer=cap)
    x = torch.ones(3)
    key = lambda: next(iter(cache.seen))
    cache(_bump, (1.0,), x)  # call 1: eager, nothing captured, the key seen
    assert cap.captures == 0 and not cache.entries and len(cache.seen) == 1
    assert key()[2][0][0] == (3,)
    cache(_bump, (1.0,), x)  # call 2: the capture
    assert cap.captures == 1 and len(cache.entries) == 1 and not cache.seen
    entry = next(iter(cache.entries.values()))
    assert entry.replays == 0
    out = cache(_bump, (1.0,), torch.full((3,), 4.0))  # call 3: a replay
    assert entry.replays == 1 and cap.captures == 1
    assert torch.equal(out[0], torch.full((3,), 4.0))
    # A key called once never captures.
    once = cache(_bump, (2.0,), torch.ones(5))
    assert torch.equal(once[0], torch.full((5,), 2.0))
    assert cap.captures == 1 and len(cache.entries) == 1 and len(cache.seen) == 1
    # The seen LRU holds as many keys as the cache; the least recently seen goes.
    for n in range(_graphs.MAX_ENTRIES + 4):
        cache(_bump, (3.0,), torch.ones(n + 1))
    assert len(cache.seen) == _graphs.MAX_ENTRIES == 16
    seen = [(k[1], k[2][0][0]) for k in cache.seen]
    assert ((2.0,), (5,)) not in seen and ((3.0,), (1,)) not in seen
    assert ((3.0,), (5,)) in seen and ((3.0,), (20,)) in seen
    cache(_bump, (3.0,), torch.ones(1))  # forgotten: seen anew, not captured
    assert cap.captures == 1 and len(cache.seen) == 16
    cache(_bump, (3.0,), torch.ones(20))  # seen: captured
    assert cap.captures == 2 and len(cache.entries) == 2


# -- the switch -----------------------------------------------------------------


def test_graph_true_raises_on_cpu_and_with_a_mesh(frames, gloo_mesh):
    src, tgt = frames
    gen = torch.Generator().manual_seed(0)
    cfg = _config()
    with pytest.raises(ValueError, match="CUDA"):
        tvo.vo_step_orb_batched(src, tgt, gen, cfg, graph=True)
    with pytest.raises(ValueError, match="CUDA"):
        tvo.vo_step_orb(src[0], tgt[0], gen, cfg, graph=True)
    # Neither a hyp axis of one rank (no collective in the step) nor a
    # BatchDraw keeps the step from a graph: only the CPU does.
    with pytest.raises(ValueError, match="CUDA"):
        tvo.vo_step_orb_batched(src, tgt, gen, cfg, hyp_mesh=gloo_mesh, graph=True)
    with pytest.raises(ValueError, match="CUDA"):
        tvo.vo_step_orb_batched(src, tgt, transac.BatchDraw(gen, (0, 1), 2), cfg,
                                graph=True)
    scene = chain_scene(jax.random.PRNGKey(2), n_zeta=6, span=2)
    args = (torch.from_numpy(np.array(scene.T0s)), np.asarray(scene.reps),
            torch.from_numpy(np.array(scene.p)), torch.from_numpy(np.array(scene.p_t)))
    with pytest.raises(ValueError, match="CUDA"):
        tgba.global_ba_solve(*args, max_span=2, max_iters=2, graph=True)
    # The polish's all_reduce on a gloo mesh, even of one rank.
    with pytest.raises(ValueError, match="a gloo mesh"):
        tgba.global_ba_solve(*args, max_span=2, max_iters=2, mesh=gloo_mesh, graph=True)


# -- the ORB step ---------------------------------------------------------------


@pytest.mark.parametrize("pyramid,b", [(False, 1), (False, 2), (True, 1)])
def test_graphed_orb_step_matches_eager(frames, stub_cache, pyramid, b):
    src, tgt = (f[:b] for f in frames)
    cfg = _config(pyramid)
    gen = lambda: torch.Generator().manual_seed(5)
    eager = tvo.vo_step_orb_batched(src, tgt, gen(), cfg, graph=False)
    for _ in range(3):  # eager, the capture's eager run, a replay
        _assert_equal(tvo.vo_step_orb_batched(src, tgt, gen(), cfg), eager)
    # A generator carried on: each call draws the next uniforms, as eagerly.
    g_e, g_g = gen(), gen()
    for _ in range(3):
        _assert_equal(tvo.vo_step_orb_batched(src, tgt, g_g, cfg),
                      tvo.vo_step_orb_batched(src, tgt, g_e, cfg, graph=False))
    # Injected samples are another key.
    _, _, status = tvo.orb_associate(src, tgt, cfg)
    samples = transac._sample_indices(gen(), cfg.ransac.hypotheses(), status.shape[-1],
                                      status, lead=(b,))
    want = tvo.vo_step_orb_batched(src, tgt, None, cfg, ransac_samples=samples, graph=False)
    for _ in range(3):
        _assert_equal(tvo.vo_step_orb_batched(src, tgt, None, cfg, ransac_samples=samples),
                      want)
    assert stub_cache.capturer.captures == len(stub_cache.entries) == 2
    assert sorted(e.replays for e in stub_cache.entries.values()) == [1, 4]
    if b == 1:  # vo_step_orb is the B = 1 call: the same key
        one = tvo.vo_step_orb(src[0], tgt[0], gen(), cfg)
        _assert_equal(one, tvo.vo_step_orb(src[0], tgt[0], gen(), cfg, graph=False))
        assert stub_cache.capturer.captures == 2


def test_graphed_orb_step_with_a_lane_under_the_match_gate(frames, stub_cache):
    src, tgt = (f.clone() for f in frames)
    src[1] = tgt[1] = 90.0  # flat: no match
    cfg = _config()
    gen = lambda: torch.Generator().manual_seed(2)
    eager = tvo.vo_step_orb_batched(src, tgt, gen(), cfg, graph=False)
    for _ in range(3):
        res = tvo.vo_step_orb_batched(src, tgt, gen(), cfg)
        _assert_equal(res, eager)
    assert int(res.n_tracked[0]) >= 8 and int(res.n_tracked[1]) < 8
    assert bool(res.reverted[1]) and not bool(res.points_valid[1].any())
    expect = torch.eye(4)
    expect[:3, 3] = torch.tensor([0.1, 0.1, -0.9]) / np.linalg.norm([0.1, 0.1, -0.9])
    torch.testing.assert_close(res.T[1], expect, atol=1e-6, rtol=0)
    assert stub_cache.capturer.captures == 1


def test_graphed_orb_step_matches_reference(frames, stub_cache):
    src, tgt = frames
    keys = jax.random.split(jax.random.PRNGKey(3), B)
    a, b = jnp.asarray(src.numpy()), jnp.asarray(tgt.numpy())
    res_j = jax.vmap(lambda x, y, k: jvo.vo_step_orb(x, y, k, VO_CFG))(a, b, keys)
    idx = convert.ransac_samples_from_reference(_reference_samples(a, b, keys, VO_CFG))
    for _ in range(3):  # the third call is a replay
        res_t = tvo.vo_step_orb_batched(src, tgt, None, _config(), ransac_samples=idx)
    assert next(iter(stub_cache.entries.values())).replays == 1
    for lane in range(B):
        assert int(res_j.n_tracked[lane]) >= 8
        _assert_close(res_t, res_j, lane)


def _pyramid_heights(H, fc):
    h, out = H, []
    for _ in range(fc.orb_levels):
        out.append(h)
        h = max(int(round(h / fc.orb_scale_factor)), 1)
    return out


@pytest.mark.parametrize("H,W,pyramid,k", [
    (120, 160, False, 128), (120, 160, True, 128), (120, 160, True, 1024),
    (64, 100, True, 256), (256, 300, True, 512), (256, 300, False, 9000),
    (40, 50, False, 4000)])
def test_orb_n_keypoints_is_the_associations_k(H, W, pyramid, k):
    cfg = _config(pyramid)
    cfg = dataclasses.replace(cfg, frontend=dataclasses.replace(cfg.frontend,
                                                                max_keypoints=k))
    g = torch.Generator().manual_seed(H + W + k)
    img = torch.rand((2, H, W), generator=g) * 255
    kp0, tgt_xy, status = tvo.orb_associate(img[:1], img[1:], cfg)
    assert kp0.xy.shape[-2] == tgt_xy.shape[-2] == status.shape[-1]
    assert status.shape[-1] == torb.n_keypoints(H, W, cfg.frontend)
    if pyramid and H == 120:  # a level below 2 * PATCH gets no budget
        assert min(_pyramid_heights(H, cfg.frontend)) < 2 * torb.PATCH


@pytest.mark.parametrize("pyramid", [False, True])
def test_later_orb_call_builds_nothing_from_host_data(frames, host_builds, stub_cache,
                                                      pyramid):
    src, tgt = frames
    cfg = _config(pyramid)
    gen = torch.Generator().manual_seed(1)
    tvo.vo_step_orb_batched(src, tgt, gen, cfg, graph=False)
    host_builds.clear()
    tvo.vo_step_orb_batched(src, tgt, gen, cfg, graph=False)
    for _ in range(3):  # graphed: eager, the capture, a replay
        tvo.vo_step_orb_batched(src, tgt, gen, cfg)
    tvo.vo_step_orb(src[0], tgt[0], gen, cfg)
    assert host_builds == []


# -- the global-BA LM loop --------------------------------------------------------


@pytest.mark.parametrize("seed,n_zeta,span", [(0, 12, 2), (1, 8, 3)])
def test_graphed_global_ba_matches_eager_and_reference(stub_cache, seed, n_zeta, span):
    scene = chain_scene(jax.random.PRNGKey(seed), n_zeta=n_zeta, span=span)
    w = np.ones(scene.reps.shape[0], np.float32)
    w[::5] = 0.0
    kw = dict(max_span=span, max_iters=15, cg_iters=32, huber_delta=1.0)
    t = lambda x: torch.from_numpy(np.array(x))
    solve = lambda graph: tgba.global_ba_solve(
        t(scene.T0s), np.asarray(scene.reps), t(scene.p), t(scene.p_t),
        wreps=torch.from_numpy(w), graph=graph, **kw)
    eager = solve(False)
    first = solve(None)  # iteration 1 eager, 2 captured, 3-15 replayed
    assert stub_cache.capturer.captures == 1
    entry = next(iter(stub_cache.entries.values()))
    assert entry.replays == kw["max_iters"] - 2
    second = solve(None)  # every iteration replayed
    assert stub_cache.capturer.captures == 1
    assert entry.replays == 2 * kw["max_iters"] - 2
    for res in (first, second):
        _assert_equal(res, eager)
        assert res.lam.shape == () and res.n_accepted.dtype == torch.int32
    res_j = jgba.global_ba_solve(scene.T0s, scene.reps, scene.p, scene.p_t,
                                 wreps=jnp.asarray(w), **kw)
    np.testing.assert_allclose(second.T0s.numpy(), np.asarray(res_j.T0s), atol=5e-3)
    r_j = float(res_j.r_norm)
    assert abs(float(second.r_norm) - r_j) < max(1e-6, 0.05 * r_j)
