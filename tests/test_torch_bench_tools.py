"""Port parity: the bench harness and its one-core baselines
(``epivo_tpu_torch/tools/{bench,native_ba,cv2_kitti_e}.py``) against the
reference's (``bench.py``, ``baselines/native_ba.py``,
``baselines/cv2_kitti_e.py``, loaded by path: they import nothing heavy at
module level).

- ``native_ba.solve_all`` on the first 16 windows of
  ``bench_ba_workload.npz``: the port's (through ``epivo_tpu_torch.runtime``)
  and the reference's (through ``epivo_tpu.runtime``) give equal total
  iterations and each window's ``lm_windowed`` output bit-equal; the LM
  schedule and counts equal;
- ``cv2_kitti_e``: the port's render bit-equal to
  ``bench.render_bench_frames()``, and ``run_pair`` giving the
  reference's pose bit-equal and the same cloud count on those frames
  (``cv2.setNumThreads(1)``);
- ``bench``: ``flops_model()``, the data part of ``WORKLOAD`` and the
  configurations equal to the reference's; the committed npz accepted and
  a copy with one data key changed refused; ``main(--device cpu)`` at the
  smallest counts on a 120x160 render with both baselines measured in
  pinned children: its line has every key of the reference's (the
  roofline fractions renamed), writes only under its ``--out``, and the
  repository's ``bench_stages.json`` and ``bench_baseline.json`` stay
  byte-unchanged; the baseline cache keyed by the host's CPU model; a
  failed baseline raising with the child's stderr; the one-CPU guard.
"""

import dataclasses
import importlib.util
import json
import math
import os

import numpy as np
import pytest
import torch

from epivo_tpu import runtime as jrt
from epivo_tpu_torch import runtime as trt
from epivo_tpu_torch.tools import bench as tbench
from epivo_tpu_torch.tools import cv2_kitti_e as tcv2
from epivo_tpu_torch.tools import native_ba as tnative

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPZ = os.path.join(REPO, "bench_ba_workload.npz")
# The keys of bench.py's line (bench.py:519-539), with the two roofline
# fractions as the port names them, and the port's own "device".
LINE_KEYS = {"metric", "value", "unit", "vs_baseline", "latency_fps", "baseline_fps",
             "ba_windows_per_s", "ba_iters_per_s", "vs_baseline_ba",
             "ba_baseline_windows_per_s", "ba_baseline_iters_per_s", "rep_spread",
             "vo_gflops", "vo_frac_fp32_peak", "ba_gflops", "ba_frac_fp32_peak",
             "stages_ms", "device"}
STAGES = {"fast_detect", "klt_track", "ransac_recover", "lm_refine", "triangulate"}


def _load(name, *path):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, *path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def ref_bench():
    return _load("ref_bench", "bench.py")


@pytest.fixture(scope="module")
def ref_native():
    return _load("ref_native_ba", "baselines", "native_ba.py")


@pytest.fixture(scope="module")
def ref_cv2():
    return _load("ref_cv2_kitti_e", "baselines", "cv2_kitti_e.py")


@pytest.fixture(scope="module")
def built():
    if not jrt.available():
        try:
            jrt.build()
        except Exception as e:
            pytest.skip(f"native build failed: {e}")
    return True


@pytest.fixture(scope="module")
def frames(ref_bench):
    """(port render, reference render) of the bench pair."""
    return tbench.render_bench_frames(), ref_bench.render_bench_frames()


class Recording:
    """A runtime whose ``lm_windowed`` records every output."""

    def __init__(self, runtime):
        self.runtime, self.outputs = runtime, []

    def lm_windowed(self, *args, **kw):
        out = self.runtime.lm_windowed(*args, **kw)
        self.outputs.append(out)
        return out


def test_native_ba_solve_all_matches_reference(built, ref_native):
    with np.load(NPZ) as z:
        data = {k: np.asarray(z[k]) for k in tnative.KEYS}
    data = {k: (v if k == "reps" else v[:16]) for k, v in data.items()}
    port, ref = Recording(trt), Recording(jrt)
    iters = tnative.solve_all(port, data)
    assert iters == ref_native.solve_all(ref, data) and iters > 0
    assert len(port.outputs) == len(ref.outputs) == 16
    for (T_p, r_p, a_p, i_p), (T_r, r_r, a_r, i_r) in zip(port.outputs, ref.outputs):
        np.testing.assert_array_equal(T_p, T_r)
        assert (r_p, a_p, i_p) == (r_r, a_r, i_r)


@pytest.mark.parametrize("name", ["N_WARMUP", "N_REPS", "LAMBDA0", "MAX_ITERS",
                                  "HUBER_DELTA", "EPSILON"])
def test_native_ba_schedule(ref_native, name):
    assert getattr(tnative, name) == getattr(ref_native, name)


def test_cv2_render_bit_equal(frames):
    (i0, i1, K), (r0, r1, rK) = frames
    for a, b in ((i0, r0), (i1, r1), (K, rK)):
        assert a.dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, np.asarray(b))


def test_cv2_run_pair_matches_reference(built, frames, ref_cv2):
    cv2 = pytest.importorskip("cv2")
    threads = cv2.getNumThreads()
    cv2.setNumThreads(1)
    try:
        (i0, i1, K), _ = frames
        inputs = tcv2.pair_inputs(i0, i1, K)
        T, n = tcv2.run_pair(cv2, *inputs, trt.lm_refine_pose)
        T_ref, n_ref = ref_cv2.run_pair(cv2, *inputs, jrt.lm_refine_pose)
    finally:
        cv2.setNumThreads(threads)
    np.testing.assert_array_equal(T, T_ref)
    assert n == n_ref  # 0 here: forward motion leaves every |B| under 1e-2
    assert (tcv2.N_WARMUP, tcv2.N_ITERS) == (ref_cv2.N_WARMUP, ref_cv2.N_ITERS)


def test_flops_model_equal(ref_bench):
    assert tbench.flops_model() == ref_bench.flops_model()


def test_workload_data_part_equal(ref_bench):
    assert tbench.WORKLOAD == {k: v for k, v in ref_bench.WORKLOAD.items() if k != "method"}
    assert {k: tbench.REFERENCE_METHOD[k] for k in ref_bench.WORKLOAD["method"]} == \
        ref_bench.WORKLOAD["method"]


@pytest.mark.parametrize("which", ["_config", "_ba_config"])
def test_configs_equal(ref_bench, which):
    port = dataclasses.asdict(getattr(tbench, which)())
    # The port's VOConfig also names a raw frame's lens; the bench's frames are pinhole.
    assert port.pop("distortion", None) is None
    assert port == dataclasses.asdict(getattr(ref_bench, which)())


def test_ba_workload_accepted():
    data = tbench.build_ba_workload()
    with np.load(NPZ) as z:
        assert set(data) == set(tbench.BA_KEYS)
        for k in tbench.BA_KEYS:
            np.testing.assert_array_equal(data[k], z[k])
    assert data["T0s"].shape[0] == tbench.WORKLOAD["ba"]["windows"]


@pytest.mark.parametrize("change", ["image", "ba.windows", "version"])
def test_ba_workload_refused(tmp_path, change):
    with np.load(NPZ) as z:
        arrays = {k: z[k] for k in z.files}
    workload = json.loads(str(arrays["workload"]))
    if change == "ba.windows":
        workload["ba"]["windows"] = 256
    elif change == "image":
        workload["image"] = [120, 160]
    else:
        workload["version"] += 1
    arrays["workload"] = json.dumps(workload)
    path = tmp_path / "changed.npz"
    np.savez_compressed(path, **arrays)
    with pytest.raises(ValueError, match="fingerprint"):
        tbench.build_ba_workload(path)


def test_main_cpu_rehearsal(built, tmp_path):
    root_files = {name: open(os.path.join(REPO, name), "rb").read()
                  for name in ("bench_stages.json", "bench_baseline.json")}
    out = tmp_path / "out"
    line = tbench.main(["--device", "cpu", "--quick", "--image", "120x160",
                        "--out", str(out)])
    assert LINE_KEYS <= set(line)
    assert set(line["stages_ms"]) == STAGES
    assert set(line["rep_spread"]) == {"batched", "latency", "ba"}
    for k in LINE_KEYS - {"metric", "unit", "rep_spread", "stages_ms", "device"}:
        assert math.isfinite(line[k]) and line[k] > 0, (k, line[k])
    assert all(v > 0 for v in line["stages_ms"].values())
    assert line["vs_baseline"] == line["value"] / line["baseline_fps"]
    assert line["vs_baseline_ba"] == line["ba_windows_per_s"] / line["ba_baseline_windows_per_s"]
    assert line["device"] == "cpu" and "CPU times" in line["note"]
    assert sorted(os.listdir(tmp_path)) == ["out"]
    assert sorted(os.listdir(out)) == ["bench_baseline.json", "bench_stages.json"]
    stages = json.loads((out / "bench_stages.json").read_text())
    assert stages["method"] == tbench.QUICK and stages["workload"]["image"] == [120, 160]
    cache = json.loads((out / "bench_baseline.json").read_text())
    assert cache["cv2_cpus"] == cache["ba_cpus"] and len(cache["ba_cpus"]) == 1
    for name, data in root_files.items():
        assert open(os.path.join(REPO, name), "rb").read() == data, name


def test_baseline_cache_keyed_by_host(tmp_path, monkeypatch):
    calls = []

    def fake(module, extra_args=()):
        calls.append(module)
        return {"cv2_fps": 10.0, "cv2_version": "x", "cpus": [0]}

    monkeypatch.setattr(tbench, "_run_pinned", fake)
    assert tbench.cv2_baseline_fps(tmp_path)["fps"] == 10.0
    assert tbench.cv2_baseline_fps(tmp_path)["fps"] == 10.0
    assert len(calls) == 1  # cached
    monkeypatch.setattr(tbench, "host_cpu", lambda: "another host")
    tbench.cv2_baseline_fps(tmp_path)
    assert len(calls) == 2  # another host's baseline is not reused


def test_baseline_failure_raises(tmp_path):
    with pytest.raises(RuntimeError, match="native_ba failed") as e:
        tbench._run_pinned("epivo_tpu_torch.tools.native_ba",
                           (str(tmp_path / "missing.npz"),))
    assert "missing.npz" in str(e.value)


def test_one_cpu_guard():
    cpus = os.sched_getaffinity(0)
    if len(cpus) == 1:
        pytest.skip("this process already runs on one CPU")
    with pytest.raises(SystemExit, match="refusing to time"):
        tnative.one_cpu()


def test_rebuild_ba_workload_matches_reference(tmp_path, monkeypatch, ref_bench):
    """``--rebuild-workload``'s tiling, jitter and fingerprint against
    ``bench.build_ba_workload``'s, both fed the same extracted windows (the
    first 64 of the committed file, through stubs of each package's
    ``corridor_sequence`` and ``prepare_mono_windows``): the written files
    are array-for-array equal, and the port's is accepted."""
    from types import SimpleNamespace

    from epivo_tpu.datasets import photoreal as jphotoreal
    from epivo_tpu.pipeline import runners as jrunners
    from epivo_tpu_torch.datasets import photoreal as tphotoreal
    from epivo_tpu_torch.pipeline import runners as trunners

    with np.load(NPZ) as z:
        n_u = tbench.WORKLOAD["ba"]["unique_windows"]
        win = SimpleNamespace(anchors=list(range(n_u)), spec=SimpleNamespace(reps=z["reps"]),
                              **{k: z[k][:n_u] for k in ("T0s", "p", "p_t", "wreps", "pmask")})
    seen = []
    for mod in (jphotoreal, tphotoreal):
        monkeypatch.setattr(mod, "corridor_sequence", lambda F, **kw: ([], None, None))
    for mod in (jrunners, trunners):
        monkeypatch.setattr(mod, "prepare_mono_windows",
                            lambda frames, cfg, **kw: seen.append(kw["n_frames"]) or win)
    monkeypatch.setattr(ref_bench, "BA_WORKLOAD_CACHE", str(tmp_path / "ref.npz"))
    ref_bench.build_ba_workload()
    port_path = tmp_path / "out" / "bench_ba_workload.npz"
    tbench.rebuild_ba_workload(port_path, "cpu")
    assert seen == [tbench.BA_F, tbench.BA_F]
    with np.load(tmp_path / "ref.npz") as r, np.load(port_path) as p:
        assert sorted(r.files) == sorted(p.files)
        for k in r.files:
            np.testing.assert_array_equal(p[k], r[k])
    assert tbench.build_ba_workload(port_path)["T0s"].shape[0] == tbench.WORKLOAD["ba"]["windows"]
