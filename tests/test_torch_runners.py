"""Port parity: the monocular sequence layer (``pipeline/stream.py``,
``eval/metrics.py``, ``utils/checkpoint.py``, ``pipeline/scale.py`` and the
pair extraction of ``pipeline/runners.py``).

Tolerances:

- ``FrameStream`` / ``PipelinedDispatch``: the cases of ``tests/test_stream.py``,
  exact;
- metrics (Umeyama alignment, ATE with and without scale, RPE) in float64:
  within 1e-12 of the reference;
- checkpoint: a saved state restores bit-equal, and the newest snapshot wins;
- the scale graph (``scale_graph_measurements``, ``scale_graph_solve``),
  ``hampel_log`` and ``runners._chained_scales``, fed the same synthetic
  ``pair_data`` (exact projections of known depths, numpy-seeded pose and
  pixel noise, one corrupted boundary): the same measurements (frame, kind,
  points used), their log-ratios and sigmas within 1e-5, and the recovered
  scales within 1e-5 relative (the port's float32 epipolar depths run in
  another order of operations);
- ``_extract_pairs`` on the 160x120 rendered fixture of
  ``tests/test_runners_datasets.py`` with ``orb_fallback_frac`` raised to
  0.5, so that every pair is retried by ORB, and every pair's reference
  RANSAC samples injected in both passes: the same retry and replace
  counts (the replacing case is ``tests/test_torch_runners_turn.py``); per pair the
  source points equal, the target points within 1e-5 (normalized; 2e-3 px)
  on at least 97 % of the lanes, the inlier masks equal on at least 97 %,
  n_inliers within 3, ``rev`` equal, rotation and translation direction
  within 2e-3.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from epivo_tpu import ransac as jransac
from epivo_tpu.eval import metrics as jmetrics
from epivo_tpu.frontend import fast as jfast, klt as jklt, match as jmatch, orb as jorb
from epivo_tpu.pipeline import runners as jrunners, scale as jscale, stream as jstream
from epivo_tpu.pipeline.config import ScaleConfig as JScaleConfig
from epivo_tpu.utils import profiling as jprofiling
from epivo_tpu_torch import convert
from epivo_tpu_torch.eval import metrics as tmetrics
from epivo_tpu_torch.pipeline import runners as trunners, scale as tscale, stream as tstream
from epivo_tpu_torch.pipeline.config import ScaleConfig as TScaleConfig
from epivo_tpu_torch.utils import checkpoint as tckpt
from tests.test_runners_datasets import VO_CFG, make_sequence
from tests.test_scale import _chain_pair_data
from tests.test_torch_vo_batched import _dir

# Parallel test workers share the CPU: one intra-op thread each (more
# threads only contend on these small tensors).
torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# FrameStream and PipelinedDispatch: the cases of tests/test_stream.py.
# ---------------------------------------------------------------------------


def _counting(n):
    for i in range(n):
        yield np.full((8, 8), i, np.float32)


@pytest.mark.parametrize("mod", [jstream, tstream], ids=["jax", "torch"])
def test_frame_stream_cases(mod):
    frames = [np.full((4, 4), i, np.float32) for i in range(5)]
    fs = mod.FrameStream(frames)
    assert fs.sized and len(fs) == 5 and fs.get(3)[0, 0] == 3.0
    fs.evict_below(4)  # no-op for sequences
    assert fs.get(0)[0, 0] == 0.0

    fs = mod.FrameStream(_counting(100), n_frames=100)
    for i in range(0, 96, 4):
        assert fs.get(i + 2)[0, 0] == i + 2 and fs.get(i)[0, 0] == i
        fs.evict_below(i + 1)
    assert fs.peak_buffered <= 8
    with pytest.raises(IndexError, match="evicted"):
        fs.get(0)

    fs = mod.FrameStream(iter([np.zeros((2, 2))]), n_frames=None)
    assert not fs.sized
    with pytest.raises(TypeError, match="n_frames"):
        len(fs)
    with pytest.raises(IndexError, match="ended"):
        fs.get(5)

    fs = mod.FrameStream(_counting(50), n_frames=50)
    fs.evict_below(40)
    assert fs.get(41)[0, 0] == 41 and fs.peak_buffered <= 2


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_pipelined_dispatch_order(depth):
    got = {}
    for mod in (jstream, tstream):
        seen, at_submit = [], []
        pipe = mod.PipelinedDispatch(lambda r, c: seen.append((r, c)), depth=depth)
        for k in range(5):
            pipe.submit(lambda k=k: f"r{k}", f"c{k}")
            at_submit.append(len(seen))
        pipe.flush()
        pipe.flush()  # idempotent
        got[mod] = (seen, at_submit)
    assert got[tstream] == got[jstream]
    seen, at_submit = got[tstream]
    assert seen == [(f"r{k}", f"c{k}") for k in range(5)]
    assert at_submit == [max(0, k + 1 - depth) for k in range(5)]


# ---------------------------------------------------------------------------
# Metrics and checkpoints.
# ---------------------------------------------------------------------------


def _trajectories(seed=0, F=40):
    rng = np.random.default_rng(seed)
    gt = np.tile(np.eye(4), (F, 1, 1))
    gt[:, :3, 3] = np.cumsum(rng.normal(0, 1, (F, 3)) + [0, 0, 1.5], axis=0)
    ang = np.cumsum(rng.normal(0, 0.05, F))
    c, s = np.cos(ang), np.sin(ang)
    gt[:, 0, 0], gt[:, 0, 2], gt[:, 2, 0], gt[:, 2, 2] = c, s, -s, c
    est = gt.copy()
    est[:, :3, 3] = 0.7 * gt[:, :3, 3] + rng.normal(0, 0.2, (F, 3)) + [1.0, -2.0, 0.5]
    return est, gt


def test_metrics_match_reference():
    est, gt = _trajectories()
    for ws in (True, False):
        a_t = tmetrics.umeyama(est[:, :3, 3], gt[:, :3, 3], with_scale=ws)
        a_j = jmetrics.umeyama(est[:, :3, 3], gt[:, :3, 3], with_scale=ws)
        for x, y in zip(a_t, a_j):
            np.testing.assert_allclose(x, y, rtol=0, atol=1e-12)
        for align in (True, False):
            assert tmetrics.ate_rmse(est, gt, align=align, with_scale=ws) == pytest.approx(
                jmetrics.ate_rmse(est, gt, align=align, with_scale=ws), abs=1e-12)
    for delta in (1, 5):
        for x, y in zip(tmetrics.rpe(est, gt, delta), jmetrics.rpe(est, gt, delta)):
            assert x == pytest.approx(y, abs=1e-12)


def test_photoreal_scoring_matches_reference():
    """``tools/photoreal_ate.py``'s scores as ``scripts/run_photoreal_ate.py``
    computes them with the reference's metrics (float64, 1e-12), and its
    pair accuracy on exact, flipped and rotated pairs."""
    from epivo_tpu_torch.tools import photoreal_ate

    est, gt = _trajectories(seed=3)
    got = photoreal_ate.score_no_gt(est, gt, length=100.0)
    gt_aln = np.linalg.inv(gt[0])[None] @ gt
    ate = jmetrics.ate_rmse(est, gt_aln, align=True, with_scale=True)
    es = np.linalg.norm(np.diff(est[:, :3, 3], axis=0), axis=-1)
    gs = np.linalg.norm(np.diff(gt_aln[:, :3, 3], axis=0), axis=-1)
    assert got["ate_sim3_pct_of_length"] == pytest.approx(100.0 * ate / 100.0, abs=1e-12)
    assert got["ate_se3_rmse_m"] == pytest.approx(
        jmetrics.ate_rmse(est, gt_aln, align=True, with_scale=False), abs=1e-12)
    assert got["length_ratio_gauge0"] == pytest.approx(es.sum() * gs[0] / es[0] / gs.sum(),
                                                       abs=1e-12)

    rel = lambda i, j: np.linalg.inv(gt[j]) @ gt[i]
    flipped = rel(2, 1).copy()
    flipped[:3, 3] *= -1
    turned = rel(3, 5).copy()
    turned[:3, :3] = turned[:3, :3] @ np.array([[0, -1, 0], [1, 0, 0], [0, 0, 1.0]])
    acc = photoreal_ate.pair_accuracy({(0, 1): {"T": rel(0, 1)}, (2, 1): {"T": flipped},
                                       (3, 5): {"T": turned}}, gt)
    assert acc["all"]["n"] == 3 and acc["all"]["flipped"] == 1
    assert acc["forward"]["dir_median"] < 1e-12
    assert acc["backward"]["dir_median"] == pytest.approx(2.0, abs=1e-12)
    assert acc["forward_skip"]["rot_median"] == pytest.approx(2.0, abs=1e-12)


def test_profiling_cases(tmp_path):
    """``utils/profiling.py``: the cases of ``tests/test_aux.py`` (stage
    timer, fenced ``time_fn``, JSONL logger with tensors), and a CPU
    ``device_trace`` that writes its trace."""
    from epivo_tpu_torch.utils import profiling

    t = profiling.StageTimer(fence=True)
    for name in ("a", "a", "b"):
        with t.stage(name, torch.ones(3)):
            sum(range(1000))
    out = t.time_fn("matmul", lambda: torch.ones(64, 64) @ torch.ones(64, 64))
    s = t.summary()
    assert out.shape == (64, 64) and s["a"]["count"] == 2 and s["matmul"]["count"] == 1
    assert "a" in t.report()
    p = tmp_path / "m.jsonl"
    m = profiling.MetricsLogger(str(p))
    m.log({"frame": 1, "x": torch.tensor(2.5), "arr": np.arange(3)})
    m.close()
    assert [json.loads(line) for line in p.read_text().splitlines()] == [
        {"frame": 1, "x": 2.5, "arr": [0, 1, 2]}]
    profiling.MetricsLogger(None).log({"a": 1})
    with profiling.device_trace(str(tmp_path / "trace")):
        torch.ones(8).sum()
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0


def test_checkpoint_round_trip(tmp_path):
    ck = tckpt.SequenceCheckpointer(str(tmp_path), every=4)
    assert ck.restore() is None and not ck.due(3) and ck.due(8)
    rng = np.random.default_rng(0)
    states = {f: {"dTs": rng.normal(size=(f, 4, 4)).astype(np.float32),
                  "reverted": rng.uniform(size=f) < 0.5,
                  "pair_keys": np.arange(2 * f, dtype=np.int64).reshape(f, 2)}
              for f in (4, 8)}
    for f, st in states.items():
        assert ck.maybe_save(f, st)
    assert not ck.maybe_save(9, states[8])  # not due
    frame, got = ck.restore()
    assert frame == 8 and ck.latest() == 8
    for k, v in states[8].items():
        assert got[k].dtype == v.dtype and np.array_equal(got[k], v)
    frame, got = tckpt.SequenceCheckpointer(str(tmp_path)).restore(4)
    assert frame == 4 and np.array_equal(got["dTs"], states[4]["dTs"])


# ---------------------------------------------------------------------------
# Scale graph, Hampel filter and the sequential chain.
# ---------------------------------------------------------------------------


def _noisy_pair_data(case):
    """Synthetic pair_data from tests/test_scale.py's geometry (exact
    projections of known depths), with numpy-seeded noise: pixel noise on
    the target points, a small rotation error on every pair pose, 10 %
    of the points masked out, and in the ``corrupt`` case one backward
    pair taken from a world whose step was 5x larger."""
    steps = {"vary": np.array([1.0, 1.15, 0.9, 1.05, 0.95, 1.1, 1.0, 1.2, 0.85]),
             "corrupt": np.ones(9)}[case]
    rng = np.random.default_rng(21)

    def tilt(i, j, T):
        th = rng.normal(0, 0.002, 2)
        cy, sy, cx, sx = np.cos(th[0]), np.sin(th[0]), np.cos(th[1]), np.sin(th[1])
        Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
        Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
        T = T.copy()
        T[:3, :3] = (Ry @ Rx).astype(np.float32)
        return T

    pd = _chain_pair_data(steps, [10, 20, 35, 300], T_noise=tilt)
    if case == "corrupt":
        bad = steps.copy()
        bad[2] = 5.0
        pd[(3, 2)] = _chain_pair_data(bad, [10, 20, 35, 300])[(3, 2)]
    for d in pd.values():
        n = d["p_full"].shape[0]
        d["p_t_full"] = d["p_t_full"].copy()
        d["p_t_full"][:, :2] += rng.normal(0, 2e-3, (n, 2)).astype(np.float32)
        d["mask_full"] = rng.uniform(size=n) > 0.1
    return steps, pd


def _cfgs(**kw):
    return JScaleConfig(**kw), TScaleConfig(**kw)


@pytest.mark.parametrize("case", ["vary", "corrupt"])
def test_scale_graph_matches_reference(case):
    steps, pd = _noisy_pair_data(case)
    n = len(steps)
    sc_j, sc_t = _cfgs(chain_hampel_ratio=0.0) if case == "corrupt" else _cfgs()
    m_j = jscale.scale_graph_measurements(pd, n, sc_j)
    m_t = tscale.scale_graph_measurements(pd, n, sc_t, device="cpu")
    assert [(m.b, m.kind, m.n) for m in m_t] == [(m.b, m.kind, m.n) for m in m_j]
    assert {m.kind for m in m_t} == {"boundary", "boundary_own", "skip_boundary"}
    for a, b in zip(m_t, m_j):
        assert a.value == pytest.approx(b.value, abs=1e-5)
        assert a.sigma == pytest.approx(b.sigma, abs=1e-5)
        np.testing.assert_allclose(a.aux, b.aux, atol=1e-6)
    c_j = jscale.scale_graph_solve(m_j, n, sc_j)
    c_t = tscale.scale_graph_solve(m_t, n, sc_t)
    np.testing.assert_allclose(c_t, c_j, rtol=1e-5)


@pytest.mark.parametrize("case", ["vary", "corrupt"])
@pytest.mark.parametrize("gates", ["default", "off", "smooth"])
def test_chained_scales_match_reference(case, gates):
    steps, pd = _noisy_pair_data(case)
    kw = {"default": {}, "off": dict(chain_hampel_ratio=0.0, chain_flow_topfrac=0.0),
          "smooth": dict(chain_smooth=3, chain_hampel_mad_k=3.0)}[gates]
    sc_j, sc_t = _cfgs(**kw)
    c_j = jrunners._chained_scales(pd, len(steps), sc_j)
    c_t = trunners._chained_scales(pd, len(steps), sc_t, device="cpu")
    assert c_t.dtype == np.float32
    np.testing.assert_allclose(c_t, c_j, rtol=1e-5)


@pytest.mark.parametrize("mad_k", [None, 3.0])
def test_hampel_log_matches_reference(mad_k):
    rng = np.random.default_rng(5)
    s = 0.8 * (1 + 0.3 * np.sin(0.13 * np.arange(60))) * np.exp(rng.normal(0, 0.03, 60))
    s[[20, 33]] *= (8.0, 0.12)
    s[40] = np.nan
    out_t, rep_t = tscale.hampel_log(s, window=7, max_ratio=1.5, mad_k=mad_k)
    out_j, rep_j = jscale.hampel_log(s, window=7, max_ratio=1.5, mad_k=mad_k)
    np.testing.assert_array_equal(rep_t, rep_j)
    np.testing.assert_array_equal(out_t, out_j)
    assert rep_t[[20, 33, 40]].all()


# ---------------------------------------------------------------------------
# Pair extraction with the ORB retry pass.
# ---------------------------------------------------------------------------

def extract_both(frames, pairs, cfg, batch, log_dir):
    """``_extract_pairs`` through both packages, every pair's reference
    RANSAC samples injected into the port in both passes.

    The reference draws one key split per batch of pairs, then one per
    batch of the retried pairs; its KLT pass's own results (recorded as its
    step returns them) say which pairs the retry pass takes. Returns
    (reference pairs, reference retry log, port pairs, port stats, retried
    pairs)."""
    fc, n_hyp = cfg.frontend, cfg.ransac.hypotheses()
    klt_scal = []  # the KLT pass's [n_inliers, reverted] per pair, in order
    make_step = jrunners._extract_step

    def recording_step(vo_cfg, use_orb, mesh=None):
        step = make_step(vo_cfg, use_orb, mesh)
        if use_orb:
            return step

        def run(a, b, k):
            out = step(a, b, k)
            klt_scal.append(out[-1])
            return out

        return run

    log = log_dir / "ref.jsonl"
    mlog = jprofiling.MetricsLogger(str(log))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jrunners, "_extract_step", recording_step)
        pd_j = jrunners._extract_pairs(jstream.FrameStream(list(frames)), pairs, cfg, 0,
                                       n_points=32, batch=batch, mlog=mlog)
    mlog.close()
    ref_stats = ([r for r in map(json.loads, log.read_text().splitlines())
                  if r.get("stage") == "extract_orb_fallback"] or [{}])[0]
    scal = np.concatenate([np.asarray(s) for s in klt_scal])[:len(pairs)]
    retried = sorted(pr for pr, (n_inl, rev) in zip(pairs, scal)
                     if rev > 0.5 or int(n_inl) < fc.orb_fallback_frac
                     * fc.max_keypoints)[:fc.orb_fallback_max]
    key = jax.random.PRNGKey(0)
    klt_keys, orb_keys = {}, {}
    for table, order in ((klt_keys, pairs), (orb_keys, retried)):
        for c0 in range(0, len(order), batch):
            key, keys = jrunners._split_keys(key, batch)
            table.update(zip(order[c0:c0 + batch], keys))

    def klt_status(x, y):
        kp = jfast.detect(x, fc.fast_threshold, fc.max_keypoints)
        return jklt.track(x, y, kp.xy, valid=kp.valid, win=fc.klt_window,
                          levels=fc.klt_levels, iters=fc.klt_iters,
                          min_eig=fc.klt_min_eig).status

    def orb_status(x, y):
        kp0 = jfast.detect(x, fc.fast_threshold, fc.max_keypoints)
        kp1 = jfast.detect(y, fc.fast_threshold, fc.max_keypoints)
        d0, d1 = jorb.describe(x, kp0.xy, kp0.valid), jorb.describe(y, kp1.xy, kp1.valid)
        return jmatch.match(d0.signs, d1.signs, valid1=kp0.valid, valid2=kp1.valid,
                            max_dist=64.0).valid

    def samples(keys, status_fn, frames):
        out = {}
        for (i, j), k in keys.items():
            st = jax.jit(status_fn)(frames[i], frames[j])
            out[(i, j)] = convert.ransac_samples_from_reference(
                jransac._sample_indices(k, n_hyp, fc.max_keypoints, st))
        return out

    stats = {}
    pd_t = trunners._extract_pairs(
        tstream.FrameStream(list(frames)), pairs, convert.config_from_reference(cfg), 0,
        n_points=32, batch=batch, device="cpu", stats=stats,
        ransac_samples=samples(klt_keys, klt_status, frames),
        # The ORB pass sees the retried frames rounded to uint8.
        orb_samples=samples(orb_keys, orb_status,
                            [np.clip(np.rint(f), 0, 255).astype(np.uint8).astype(np.float32)
                             for f in frames]))
    return pd_j, ref_stats, pd_t, stats, retried


def assert_pair_close(a, b):
    """One extracted pair of the port (a) against the reference's (b), at
    the tolerances of the module docstring."""
    assert set(a) == set(b)
    np.testing.assert_array_equal(a["p_full"], np.asarray(b["p_full"]))
    assert np.mean(np.abs(a["p_t_full"] - np.asarray(b["p_t_full"])).max(-1) < 1e-5) >= 0.97
    assert np.mean(a["mask_full"] == np.asarray(b["mask_full"])) >= 0.97
    assert abs(a["n_inl"] - b["n_inl"]) <= 3 and a["rev"] == b["rev"]
    T_t, T_j = a["T"], np.asarray(b["T"])
    assert np.linalg.norm(T_t[:3, :3] - T_j[:3, :3]) < 2e-3
    assert np.linalg.norm(_dir(T_t[:3, 3]) - _dir(T_j[:3, 3])) < 2e-3
    for k in ("p", "p_t", "mask"):
        assert a[k].shape == np.asarray(b[k]).shape


# (2, 1) is left out: there one point sits at the RANSAC threshold, its
# inlier flag flips between the packages, and another hypothesis wins
# (0.28 in the translation direction).
PAIRS = [(0, 1), (0, 2), (1, 0), (1, 2)]


@pytest.fixture(scope="module")
def extraction(tmp_path_factory):
    frames = [np.asarray(f, np.float32) for f in make_sequence(F=3)[0]]
    cfg = dataclasses.replace(VO_CFG, frontend=dataclasses.replace(
        VO_CFG.frontend, orb_fallback_frac=0.5))
    return extract_both(frames, PAIRS, cfg, 2, tmp_path_factory.mktemp("extract"))


def test_extract_pairs_retry_decisions_match_reference(extraction):
    pd_j, ref_stats, _, stats, retried = extraction
    # Every pair keeps fewer than 64 KLT inliers, so every pair is retried;
    # ORB keeps fewer inliers than KLT on these frames, so none is replaced.
    assert retried == sorted(PAIRS) and stats["n_pairs"] == len(PAIRS)
    assert stats["n_retried"] == ref_stats["n_retried"] == len(PAIRS)
    assert stats["n_replaced"] == ref_stats["n_replaced"] == 0


@pytest.mark.parametrize("pair", PAIRS)
def test_extract_pairs_match_reference(extraction, pair):
    pd_j, _, pd_t, _, _ = extraction
    assert_pair_close(pd_t[pair], pd_j[pair])


def test_runners_refuse_what_is_not_ported():
    from epivo_tpu_torch.pipeline.config import BAConfig, GlobalBAConfig, LoopConfig

    frames = [np.zeros((8, 8), np.float32)] * 4
    with pytest.raises(TypeError, match="DeviceMesh"):
        trunners.run_vo_sequence(frames, convert.config_from_reference(VO_CFG),
                                 mesh=object(), device="cpu")
    # The mesh layer is ported (tests/test_torch_runner_mesh.py runs it):
    # what every runner refuses is a mesh that is not a torch.distributed
    # DeviceMesh, beside the global-BA polish and loop closure too.
    both = BAConfig(loop=LoopConfig(enabled=True), global_ba=GlobalBAConfig(enabled=True))
    with pytest.raises(TypeError, match="DeviceMesh"):
        trunners.run_ba_sequence(frames, both, mesh=object(), device="cpu")
    with pytest.raises(TypeError, match="DeviceMesh"):
        trunners.refine_global(np.tile(np.eye(4, dtype=np.float32), (3, 1, 1)), {}, both,
                               mesh=object(), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            trunners.run_vo_sequence(frames, convert.config_from_reference(VO_CFG))
