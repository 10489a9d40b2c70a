"""The mesh paths through the compile-once dispatch
(``epivo_tpu_torch/_graphs.py``) on two gloo ranks on the CPU.

The ranks are spawned processes (``multihost.spawn``, one torch thread
each) running ``tests/graph_stub.py::mesh_graph_checks`` through the stub
capturer of ``tests/test_torch_graphs.py`` (its "replay" runs the
function again, collectives included, with the counters put back). On
gloo as it is, the steps drawing from a ``BatchDraw`` and the
window-sharded BA step graph (no collective inside their graphs), while a
hyp split and the mesh polish run eagerly; with every mesh taken as
capturable (``parallel.mesh.capturable``, the rule of an NCCL mesh) the
hyp split and the polish are captured with their collectives. Tolerances:

- every graphed call bit-equal to the same call with ``graph=False``, and
  the collectives counter moved as by the eager call;
- both ranks make the same sequence of cache decisions (eager, capture,
  replay) per function;
- ``global_ba_solve(mesh=)`` graphed against the JAX package's on its
  8-device mesh at ``tests/test_torch_global_ba.py``'s tolerances (poses
  within 5e-3, r_norm within 5 % or 1e-6).

Small sizes: the 96x128 corridor pairs and configuration of
``tests/test_torch_graphs.py`` (16 hypotheses), 8 windows of
``bench_ba_workload.npz``, a padded 9-zeta ``chain_scene``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from epivo_tpu.parallel import global_ba as jgba, mesh as jmesh
from epivo_tpu_torch.parallel import multihost
from epivo_tpu_torch.pipeline import ba as tba
from tests import graph_stub
from tests.test_torch_dist import _padded_chain
from tests.test_torch_graphs import _ba_config, _ba_inputs, _config

GLOBAL_KW = dict(max_span=2, max_iters=15, cg_iters=32, huber_delta=1.0)


@pytest.fixture(scope="module")
def ranks():
    from epivo_tpu_torch.datasets import photoreal
    from tests.test_torch_graphs import HS, WS

    K = np.array([[110.0, 0, WS / 2], [0, 110.0, HS / 2], [0, 0, 1.0]])
    seqs = [list(photoreal.corridor_sequence(2, H=HS, W=WS, K=K, speed=0.45, seed=s)[0])
            for s in (11, 12)]
    f = lambda s, i: np.asarray(seqs[s][i], np.float32)
    # Three pairs: rank 0 steps lanes 0-1, rank 1 lane 2 twice.
    src = np.stack([f(0, 0), f(1, 0), f(0, 1)])
    tgt = np.stack([f(0, 1), f(1, 1), f(0, 0)])
    cfg = _config()
    orb_cfg = dataclasses.replace(cfg, frontend=dataclasses.replace(cfg.frontend,
                                                                     fast_threshold=8.0))
    ba_in = (*(x.numpy() for x in _ba_inputs(8)), tba.mono_window_spec(3), _ba_config())
    chain = (*_padded_chain(), GLOBAL_KW)
    outs = multihost.spawn(graph_stub.mesh_graph_checks, 2, src, tgt, cfg, orb_cfg, ba_in,
                           chain, timeout_s=300)
    return outs, chain


def _equal(a, b):
    """Every field bit for bit (results are numpy after the ranks)."""
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_batch_draw_step_graphs_on_gloo(ranks):
    outs, _ = ranks
    assert [o["lanes"] for o in outs] == [[0, 1], [2, 2]]
    for o in outs:
        for name in ("klt", "orb"):
            bd = o["batch_draw"][name]
            for g in bd["graphed"]:
                _equal(g, bd["eager"])
            for g, e in zip(bd["carried"], bd["carried_eager"]):
                _equal(g, e)
    # Rank 1's two lanes are one pair with one row of the draw.
    e = outs[1]["batch_draw"]["klt"]["eager"]
    for field in e:
        np.testing.assert_array_equal(field[0], field[1])


def test_gloo_mesh_blocks_only_a_collective_inside(ranks):
    outs, _ = ranks
    for o in outs:
        g = o["gloo"]
        assert len(g["raised"]) == 2
        assert all("graph=True with a gloo mesh" in m for m in g["raised"])
        assert g["captures"] == 0  # graph=None ran both eagerly
        _equal(g["hyp_none"][0], g["hyp_eager"][0])
        _equal(g["global_none"][0], g["global_eager"][0])
        assert g["hyp_none"][1] == g["hyp_eager"][1] == {"all_gather/gloo/cpu": 1}
        assert g["global_none"][1] == g["global_eager"][1]
        # The window solve's graph holds no collective: it is captured on gloo.
        assert ("_solve", "capture") in o["log"]


def test_hyp_split_step_graphed_matches_eager(ranks):
    outs, _ = ranks
    for o in outs:
        h = o["hyp"]
        for (g, c_g), (e, c_e) in zip(h["graphed"], h["eager"]):
            _equal(g, e)
            assert c_g == c_e == {"all_gather/gloo/cpu": 1}
    _equal(outs[0]["hyp"]["graphed"][2][0], outs[1]["hyp"]["graphed"][2][0])


def test_distributed_ba_step_graphed_matches_eager(ranks):
    outs, _ = ranks
    for o in outs:
        b = o["ba"]
        for (g, c_g), (e, c_e) in zip(b["graphed"], b["eager"]):
            _equal(g, e)
            assert c_g == c_e == {"all_gather/gloo/cpu": 1, "all_reduce/gloo/cpu": 1}
    _equal(outs[0]["ba"]["graphed"][2][0], outs[1]["ba"]["graphed"][2][0])


def test_global_ba_mesh_graphed_matches_eager_and_reference(ranks):
    outs, chain = ranks
    n_iter, cg = GLOBAL_KW["max_iters"], GLOBAL_KW["cg_iters"]
    for o in outs:
        e, c_e = o["global"]["eager"]
        assert c_e == {"all_reduce/gloo/cpu": 1 + n_iter * (cg + 2)}
        for g, c_g in o["global"]["graphed"]:  # iteration 2 captured; then all replays
            _equal(g, e)
            assert c_g == c_e
        key = [k for k in o["replays"] if k.startswith("_lm_iteration")]
        assert len(key) == 1 and o["replays"][key[0]] == 2 * n_iter - 2
    T0s, reps, p, p_t, w, _ = chain
    ref = jgba.global_ba_solve(jnp.asarray(T0s), reps, jnp.asarray(p), jnp.asarray(p_t),
                               wreps=jnp.asarray(w), mesh=jmesh.make_mesh(n_win=8, n_hyp=1),
                               **GLOBAL_KW)
    res = outs[0]["global"]["graphed"][1][0]
    np.testing.assert_allclose(res.T0s, np.asarray(ref.T0s), atol=5e-3)
    r_j = float(ref.r_norm)
    assert abs(float(res.r_norm) - r_j) < max(1e-6, 0.05 * r_j)


def test_ranks_make_the_same_key_sequence(ranks):
    outs, _ = ranks
    log0, log1 = outs[0]["log"], outs[1]["log"]
    assert log0 == log1 and outs[0]["captures"] == outs[1]["captures"]
    per_fn = lambda name: [w for f, w in log0 if f == name]
    # The BatchDraw steps' keys (three calls from a seed, three carried),
    # then the hyp split's key (three calls).
    first = ["eager", "capture", "replay"]
    assert per_fn("_klt_graphed") == first + ["replay"] * 3 + first
    assert per_fn("_orb_graphed") == first + ["replay"] * 3
    assert per_fn("_solve") == first
    n_iter = GLOBAL_KW["max_iters"]
    assert per_fn("_lm_iteration") == ["eager", "capture"] + ["replay"] * (2 * n_iter - 2)
