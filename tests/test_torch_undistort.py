"""The step's undistortion of raw frames (``frontend/undistort.py``,
``csrc/undistort.cu``) against the host numpy undistortion of
``datasets/euroc.py`` (``remap(img, *undistort_map(K, dist, (H, W)))``).

On the CPU: the plain route equals the port's numpy functions and the JAX
package's (``epivo_tpu.datasets.euroc``, numpy) bit for bit, at EuRoC
cam0's lens on a small camera, with no distortion, and with sources that
leave the frame; a pair of inputs equals their stack; the lens constant
equals the dataset module's; ``vo_step_batched`` and
``vo_step_orb_batched`` on raw frames with ``distortion`` set equal the
same steps on host-undistorted frames with ``distortion=None``, bit for
bit.

On the card (``cuda``-marked; skip without one): the kernel equals the
plain route bit for bit at 752x480 with n = 64, in one launch for a pair
of inputs; the graphed step on raw frames equals the graphed step on
kernel-undistorted frames; a pinhole step launches no ``undistort`` mark
and no undistortion kernel, a raw-frames step one of each, first.

    python -m pytest tests/test_torch_undistort.py --noconftest -q   # the card
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from epivo_tpu_torch.datasets import euroc as teuroc, photoreal
from epivo_tpu_torch.frontend import undistort
from epivo_tpu_torch.geometry.camera import (EUROC_CAM0, EUROC_CAM0_DIST, Distortion,
                                             Pinhole)
from epivo_tpu_torch.pipeline import config, vo

torch.set_num_threads(1)

# EuRoC cam0's K shrunk 6x: its lens bends a small frame as much as the
# real one (the same normalized coordinates).
SMALL = Pinhole(fx=458.654 / 6, fy=457.296 / 6, cx=367.215 / 6, cy=248.375 / 6,
                width=125, height=80)
LENSES = {
    "euroc": EUROC_CAM0_DIST,
    "none": Distortion(0.0, 0.0, 0.0, 0.0),
    # Pincushion: the corners' sources leave the frame (zeros there).
    "out_of_range": Distortion(0.45, 0.1, 0.004, -0.003),
}


def _K(camera: Pinhole) -> np.ndarray:
    return np.array([[camera.fx, 0.0, camera.cx], [0.0, camera.fy, camera.cy],
                     [0.0, 0.0, 1.0]])


def _raw(n: int, H: int, W: int, seed: int = 0) -> np.ndarray:
    """Raw frames: grey levels with fractions, float32."""
    return np.random.default_rng(seed).uniform(0, 255, (n, H, W)).astype(np.float32)


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.uint32)


def _host(frames: np.ndarray, camera: Pinhole, dist: Distortion, euroc=teuroc) -> np.ndarray:
    maps = euroc.undistort_map(_K(camera), np.array([dist.k1, dist.k2, dist.p1, dist.p2]),
                               frames.shape[-2:])
    return np.stack([euroc.remap(f, *maps) for f in frames])


@pytest.mark.parametrize("lens", list(LENSES))
def test_plain_equals_numpy_remap(lens):
    dist = LENSES[lens]
    jeuroc = pytest.importorskip("epivo_tpu.datasets.euroc")  # absent where JAX is
    raw = _raw(3, SMALL.height, SMALL.width)
    got = undistort.undistort(torch.from_numpy(raw), SMALL, dist)
    want = _host(raw, SMALL, dist)
    assert np.array_equal(_bits(got), _bits(want))
    assert np.array_equal(_bits(got), _bits(_host(raw, SMALL, dist, jeuroc)))
    maps = teuroc.undistort_map(_K(SMALL), np.array(dataclasses.astuple(dist)), raw.shape[-2:])
    for m, m_ref in zip(undistort.undistort_map(SMALL, dist, *raw.shape[-2:]), maps):
        assert np.array_equal(_bits(m), _bits(m_ref))
    zeros = int((want == 0).sum())
    if lens == "out_of_range":
        assert zeros > 3 * 100  # the corners of each frame
    elif lens == "none":
        assert np.array_equal(_bits(got), _bits(raw))  # the identity, bit for bit
    else:
        assert zeros == 0


def test_pair_equals_stack():
    raw = torch.from_numpy(_raw(5, SMALL.height, SMALL.width, seed=1))
    both = undistort.undistort((raw[:2], raw[2:]), SMALL, EUROC_CAM0_DIST)
    assert torch.equal(both, undistort.undistort(raw, SMALL, EUROC_CAM0_DIST))
    assert both.shape == raw.shape


def test_replays_count_the_kernel_launches():
    """A replay never runs the wrapper's Python, so the graph cache adds the
    launches its capture made to ``undistort.LAUNCHES``, as for the other
    kernels."""
    from epivo_tpu_torch import _graphs

    assert ("epivo_tpu_torch.frontend.undistort", "LAUNCHES") in _graphs.COUNTERS
    assert ("epivo_tpu_torch.frontend.undistort", "LAUNCHES") in _graphs.launches()


def test_cam0_lens_is_the_dataset_calibration():
    assert np.array_equal(np.array(dataclasses.astuple(EUROC_CAM0_DIST)),
                          teuroc.EUROC_CAM0_DIST)
    assert np.array_equal(_K(EUROC_CAM0), teuroc.EUROC_CAM0_K)
    assert config.VOConfig().distortion is None


def _small_config(dist=None):
    return config.VOConfig(
        camera=SMALL,
        frontend=config.FrontendConfig(fast_threshold=12.0, max_keypoints=128, klt_levels=3),
        ransac=config.RansacConfig(n_hyp=32, method="ransac", threshold_px=0.3),
        lm=config.LMConfig(n_points=16), distortion=dist)


@pytest.fixture(scope="module")
def raw_pair():
    frames, _, _ = photoreal.corridor_sequence(3, H=SMALL.height, W=SMALL.width, K=_K(SMALL),
                                               speed=0.3, seed=5)
    f = np.stack(list(frames)).astype(np.float32)
    return f[:2], f[1:]


def _same_result(a, b):
    for name, x, y in zip(vo.VOStepResult._fields, a, b):
        assert torch.equal(x, y), name


@pytest.mark.parametrize("step", ["klt", "orb"])
def test_step_on_raw_frames_equals_host_undistorted(raw_pair, step):
    src, tgt = raw_pair
    fn = vo.vo_step_batched if step == "klt" else vo.vo_step_orb_batched
    run = lambda a, b, cfg: fn(torch.from_numpy(a), torch.from_numpy(b),
                               torch.Generator().manual_seed(3), cfg, use_kernel=False,
                               graph=False)
    on_raw = run(src, tgt, _small_config(EUROC_CAM0_DIST))
    host = run(_host(src, SMALL, EUROC_CAM0_DIST), _host(tgt, SMALL, EUROC_CAM0_DIST),
               _small_config())
    _same_result(on_raw, host)
    # The lens moves the result: the step does undistort.
    assert not torch.equal(on_raw.matches_tgt, run(src, tgt, _small_config()).matches_tgt)


# --- On the card ---------------------------------------------------------


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernel_equals_plain_at_euroc_size(dev):
    H, W = EUROC_CAM0.height, EUROC_CAM0.width
    raw = torch.from_numpy(_raw(64, H, W, seed=2))
    want = undistort.undistort_plain(raw, EUROC_CAM0, EUROC_CAM0_DIST)
    launches = undistort.LAUNCHES
    got = undistort.undistort(raw.to(dev), EUROC_CAM0, EUROC_CAM0_DIST)
    pair = undistort.undistort((raw[:32].to(dev), raw[32:].to(dev)), EUROC_CAM0,
                               EUROC_CAM0_DIST)
    assert undistort.LAUNCHES == launches + 2
    assert np.array_equal(_bits(got.cpu()), _bits(want))
    assert np.array_equal(_bits(pair.cpu()), _bits(want))
    plain_card = undistort.undistort(raw.to(dev), EUROC_CAM0, EUROC_CAM0_DIST, use_kernel=False)
    assert np.array_equal(_bits(plain_card.cpu()), _bits(want))
    out_of_range = Distortion(0.45, 0.1, 0.004, -0.003)
    assert np.array_equal(
        _bits(undistort.undistort(raw[:3].to(dev), EUROC_CAM0, out_of_range).cpu()),
        _bits(undistort.undistort_plain(raw[:3], EUROC_CAM0, out_of_range)))


def _euroc_config(dist):
    return config.VOConfig(camera=EUROC_CAM0,
                           frontend=config.FrontendConfig(fast_threshold=20.0),
                           ransac=config.RansacConfig(n_hyp=512, threshold_px=0.3),
                           lm=config.LMConfig(n_points=48, revert_r_norm=1e-4),
                           distortion=dist)


@pytest.fixture(scope="module")
def euroc_frames():
    frames, _, _ = photoreal.corridor_sequence(4, H=EUROC_CAM0.height, W=EUROC_CAM0.width,
                                               K=_K(EUROC_CAM0), speed=0.05, seed=7)
    return np.stack(list(frames)).astype(np.float32)


def _graphed_replay(f, cfg, dev):
    """The third call (a replay) of the step's key on frames f[:-1] -> f[1:]."""
    for _ in range(3):
        out = vo.vo_step_batched(f[:-1], f[1:], torch.Generator(device=dev).manual_seed(9), cfg)
    return out


@pytest.mark.cuda
def test_graphed_raw_step_equals_step_on_kernel_undistorted(dev, euroc_frames):
    from epivo_tpu_torch import _graphs

    raw = torch.from_numpy(euroc_frames).to(dev)
    replays = _graphs.build_totals()["replays"]
    on_raw = _graphed_replay(raw, _euroc_config(EUROC_CAM0_DIST), dev)
    clean = undistort.undistort(raw, EUROC_CAM0, EUROC_CAM0_DIST)
    on_clean = _graphed_replay(clean, _euroc_config(None), dev)
    assert _graphs.build_totals()["replays"] == replays + 2
    _same_result(on_raw, on_clean)


def _kernel_names(step, tmp_path) -> list:
    """The kernels of one call of ``step`` in launch order, from a profile
    whose first (warm-up) call is discarded: CUPTI may drop the records
    at the start of a fresh profile."""
    from torch.profiler import ProfilerActivity, profile, schedule

    path = str(tmp_path / "trace.json")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 on_trace_ready=lambda p: p.export_chrome_trace(path)) as prof:
        for _ in range(2):
            step()
            torch.cuda.synchronize()
            prof.step()
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    return [ev["name"] for ev in sorted((e for e in events if e.get("cat") == "kernel"),
                                        key=lambda e: e["ts"])]


@pytest.mark.cuda
@pytest.mark.parametrize("lens", ["pinhole", "raw"])
def test_undistort_mark_and_kernel_only_for_raw_frames(dev, euroc_frames, tmp_path, lens):
    from epivo_tpu_torch.utils import profiling

    dist = EUROC_CAM0_DIST if lens == "raw" else None
    f = torch.from_numpy(euroc_frames).to(dev)
    cfg = _euroc_config(dist)
    _graphed_replay(f, cfg, dev)  # the key's eager call and capture, and a replay
    launches = undistort.LAUNCHES
    names = _kernel_names(lambda: vo.vo_step_batched(
        f[:-1], f[1:], torch.Generator(device=dev).manual_seed(9), cfg), tmp_path)
    # Two replays, each adding its capture's launch.
    assert undistort.LAUNCHES == launches + (2 if lens == "raw" else 0)
    marks = [n for n in names if "stage_mark_" in n]
    remaps = [k for k, n in enumerate(names) if "undistort_remap_kernel" in n]
    if lens == "pinhole":
        assert [m.split("stage_mark_")[1].split("_kernel")[0] for m in marks] == list(
            profiling.STAGES[1:])
        assert remaps == [] and not any("undistort" in n for n in names)
    else:
        assert [m.split("stage_mark_")[1].split("_kernel")[0] for m in marks] == list(
            profiling.STAGES)
        assert len(remaps) == 1
        first = names.index(marks[0])
        assert first < remaps[0] < names.index(marks[1])
