"""The EuRoC raw-frames cell (kind ``vo_raw_runner``): its tiny CPU
rehearsal comes out correct with every reading 0 (the plain routes are
bit-equal), and not correct when the port's undistortion is skipped (the
step then works on the raw frames); the raw frames are held to a digest,
and undistorting them gives back the corridor's pinhole view."""

import hashlib
import time

import numpy as np
import torch

from benchmark.harness import cell as cell_mod, spec as spec_mod
from benchmark.reference import undistort as ref_undistort
from benchmark.tests._tiny import tiny_cell
from benchmark.yardstick import frames, raw_frames

NAME = "euroc_mh01_vo.offline_b32_raw"
SEED = 2**33 + 17
# sha256 of the cell's first 3 raw frames at the tiny camera and SEED.
DIGEST = "e635229aa3143f736478992d82e8a8a14d95cfe0e87acbbf9ebc4c59dfdef0ff"


def _run():
    res, _ = cell_mod.run_cell(tiny_cell(NAME), SEED, 1.0, False, torch.device("cpu"),
                               time.perf_counter())
    return res


def test_tiny_raw_run_is_correct_to_the_bit():
    res = _run()
    assert res["correct"] and res["failed"] == 0, res["checks"]
    assert all(c["value"] == 0 for c in res["checks"].values()), res["checks"]


def test_skipped_undistortion_is_not_correct(monkeypatch):
    from epivo_tpu_torch.frontend import undistort

    def skipped(frames, camera, dist, use_kernel=None):
        return torch.cat(list(frames)) if isinstance(frames, (tuple, list)) else frames

    monkeypatch.setattr(undistort, "undistort", skipped)
    res = _run()
    assert not res["correct"], res["checks"]


def test_raw_frames_held_to_their_digest():
    c = tiny_cell(NAME)
    f = raw_frames.render(SEED, 3, c.config["camera"], c.config["distortion"],
                          motion=c.config["motion"])
    assert f.dtype == np.float32 and np.array_equal(f, np.round(f))
    assert hashlib.sha256(f.tobytes()).hexdigest() == DIGEST


def test_undistorted_raw_frames_are_the_pinhole_view():
    """At EuRoC's camera shrunk 4x (its lens bends by up to ~35 px there),
    the plain undistortion of noise-free raw frames matches the pinhole
    rendering of the same seed far better than the raw frames do (by the
    correlation of their horizontal gradients; two bilinear samplings
    blur the undistorted frame's fine texture)."""
    c = spec_mod.cell(NAME).config
    cam = dict({k: c["camera"][k] / 4 for k in ("fx", "fy", "cx", "cy")}, width=188,
               height=120)
    raw = raw_frames.render(SEED, 1, cam, c["distortion"], noise_sigma=0.0,
                            motion=c["motion"])[0]
    pin = frames.render(SEED, 1, cam, noise_sigma=0.0, motion=c["motion"])[0]
    und = ref_undistort.undistort(torch.from_numpy(raw), cam, c["distortion"]).numpy()
    grad = lambda a: np.diff(a.astype(np.float64), axis=1)[10:-10, 10:-10].ravel()
    corr = lambda a, b: float(np.corrcoef(grad(a), grad(b))[0, 1])
    assert corr(und, pin) > 0.7 and corr(raw, pin) < corr(und, pin) - 0.4, (
        corr(und, pin), corr(raw, pin))

