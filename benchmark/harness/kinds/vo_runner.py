"""Back-to-back calls of ``pipeline.runners.run_vo_sequence`` over a stream
of frames held in host memory, as an offline user runs a sequence.

Each call streams ``stream_frames`` frames (the rendered frames played
forward and back, from a start that moves with the call) with the
traffic's batch and pipeline depth, no ground truth, the cloud collected,
no checkpoint and no metrics file; its seed, from which the runner draws
its RANSAC samples, comes from ``--seed`` and the call's index.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.harness import compare, stats, trace
from benchmark.harness.kinds import _vo
from benchmark.reference import vo as ref_vo
from benchmark.yardstick import frames as frames_mod

# The traffic's overrides for the CPU rehearsal (with the tiny camera of
# ``benchmark/tests/_tiny.py``) and for the card's control test, and the
# port function that the rehearsal's faults wrap.
REHEARSAL = dict(stream_frames=9, batch=4, check_calls=1, warmup_calls=1)
CONTROL = dict(stream_frames=65, warmup_calls=1, check_calls=1)
FAULT_TARGET = "vo_step_batched"


class Driver:
    def __init__(self, cell, seed: int, device: torch.device):
        self.cfg, self.traffic, self.seed, self.dev = cell.config, cell.traffic, seed, device
        self.s = ref_vo.VOSettings.from_config(self.cfg)
        self.L = self.traffic["stream_frames"]
        self.B = self.traffic["batch"]
        self.results = {}

    def setup(self) -> None:
        from benchmark.harness import port

        self.frames = _vo.render(self.cfg, self.traffic, self.seed)
        self.config = port.vo_config(self.cfg)
        for c in range(-self.traffic["warmup_calls"], 0):
            self._call(c)

    def _stream(self, c: int) -> list[int]:
        return frames_mod.stream(c * self.traffic["start_stride"], self.L, len(self.frames))

    def _call(self, c: int):
        from epivo_tpu_torch.pipeline import runners

        return runners.run_vo_sequence(
            (self.frames[i] for i in self._stream(c)), self.config, gt_poses=None,
            batch=self.B, seed=compare.derive(self.seed, "call", c), collect_cloud=True,
            checkpoint_dir=None, metrics_path=None,
            pipeline_depth=self.traffic["pipeline_depth"], device=self.dev)

    def window(self, seconds: float) -> dict:
        t0 = time.perf_counter()
        c = 0
        walls = []
        while time.perf_counter() - t0 < seconds:
            t1 = time.perf_counter()
            with trace.span("runner_call"):
                res = self._call(c)
            walls.append(time.perf_counter() - t1)
            self.results[c] = res
            c += 1
        elapsed = time.perf_counter() - t0
        pairs = c * (self.L - 1)
        failed = sum(int((~np.isfinite(r.trajectory).all(axis=(1, 2)))[1:].sum())
                     for r in self.results.values())
        steps = c * -(-(self.L - 1) // self.B)
        return {"e2e": {"pairs_per_s": stats.rate(pairs, elapsed)}, "attempted": pairs,
                "failed": failed, "wall_per_call_s": elapsed / steps,
                "note": {"runner_calls": c, "step_calls": steps, "call_s": walls}}

    def traced(self) -> trace.TraceSummary:
        c = len(self.results)
        steps = -(-(self.L - 1) // self.B)

        def run():
            with trace.span("runner_call"):
                self._call(c)

        t = trace.profile(run, steps)
        # The kernels' work at the traced call's inputs, batch by batch.
        fr = torch.from_numpy(self.frames).to(self.dev)
        idx = self._stream(c)
        for b in range(steps):
            pairs = [(idx[q], idx[q + 1]) for q in range(b * self.B,
                                                          min((b + 1) * self.B, self.L - 1))]
            for k, v in _vo.frontend_bounds(fr, pairs, self.s).items():
                t.bounds[k] = t.bounds.get(k, 0.0) + v
        return t

    def sample(self) -> list[int]:
        rng = np.random.default_rng(compare.derive(self.seed, "sample"))
        calls = sorted(self.results)
        n = min(self.traffic["check_calls"], len(calls))
        return sorted(rng.choice(calls, n, replace=False).tolist())

    def release(self) -> None:
        chosen = set(self.sample())
        self.results = {c: r for c, r in self.results.items() if c in chosen}

    def _reference(self, c: int, lowp: bool) -> dict:
        """The reference's run of call c: its steps' fields, trajectory and
        cloud."""
        fr = torch.from_numpy(self.frames).to(self.dev)
        idx = self._stream(c)
        K = ref_vo.n_keypoints(self.s)
        gen = torch.Generator(device=self.dev)
        gen.manual_seed(compare.derive(self.seed, "call", c))
        parts = []
        for b0 in range(0, self.L - 1, self.B):
            pairs = [(idx[q], idx[q + 1]) for q in range(b0, min(b0 + self.B, self.L - 1))]
            u = torch.rand((len(pairs), self.s.n_hyp, K), generator=gen, device=self.dev)
            parts.append(_vo.ref_steps(fr, pairs, u, self.s, lowp=lowp))
        st = {f: np.concatenate([p[f] for p in parts]) for f in ref_vo.FIELDS}
        traj = ref_vo.trajectory(st["T"])
        cloud, lims = ref_vo.world_cloud(traj, st["points"], st["points_valid"])
        return dict(trajectory=traj, cloud=cloud, cloud_limits=lims,
                    n_inliers=st["n_inliers"], n_tracked=st["n_tracked"],
                    reverted=st["reverted"])

    @staticmethod
    def _of_program(r) -> dict:
        return dict(trajectory=r.trajectory, cloud=r.cloud, cloud_limits=r.cloud_limits,
                    n_inliers=r.per_frame["n_inliers"], n_tracked=r.per_frame["n_tracked"],
                    reverted=r.per_frame["reverted"])

    def check(self) -> dict:
        return _merge([readings(self._of_program(self.results[c]), self._reference(c, False))
                       for c in sorted(self.results)])

    def control(self) -> dict:
        return _merge([readings(self._reference(c, True), self._reference(c, False))
                       for c in sorted(self.results)])


def _merge(rs: list[dict]) -> dict:
    """The worst of each reading over the checked calls."""
    return {k: max(r[k] for r in rs) for k in rs[0]}


def _steps(traj: np.ndarray) -> np.ndarray:
    """Relative poses dT_i = inv(traj_{i+1}) @ traj_i [F, 4, 4]."""
    t = np.asarray(traj, np.float64)
    return np.linalg.inv(t[1:]) @ t[:-1]


def _depths(traj: np.ndarray, cloud: np.ndarray, lims: np.ndarray) -> np.ndarray:
    """Each pair's median distance of its points from its source camera."""
    ends = np.append(lims[1:], len(cloud))
    out = np.zeros(len(lims))
    for i, (a, b) in enumerate(zip(lims, ends)):
        if b > a:
            out[i] = np.median(np.linalg.norm(cloud[a:b] - traj[i][:3, 3], axis=-1))
    return out


def readings(got: dict, ref: dict) -> dict:
    """The worst over a call's pairs of each gap between two runner
    results (trajectory, cloud and per-pair counts)."""
    dg, dr = _steps(got["trajectory"]), _steps(ref["trajectory"])
    pos_g, pos_r = got["trajectory"][:, :3, 3], ref["trajectory"][:, :3, 3]
    length = np.linalg.norm(np.diff(pos_r, axis=0), axis=-1).sum()
    count = lambda r: np.diff(np.append(r["cloud_limits"], len(r["cloud"])))
    return {
        **compare.spread("rot_rad", compare.rot_gap(dg[:, :3, :3], dr[:, :3, :3])),
        **compare.spread("dir_rad", compare.dir_gap(dg[:, :3, 3], dr[:, :3, 3])),
        **compare.spread("n_inliers", compare.rel_gap(got["n_inliers"], ref["n_inliers"], 1.0)),
        "tracked": compare.worst(np.abs(np.asarray(got["n_tracked"], np.int64)
                                        - np.asarray(ref["n_tracked"], np.int64))),
        "reverted": float((np.asarray(got["reverted"]) != np.asarray(ref["reverted"])).sum()),
        "trajectory": compare.worst(np.linalg.norm(pos_g - pos_r, axis=-1) / max(length, 1e-9)),
        **compare.spread("cloud_count", compare.rel_gap(count(got), count(ref), 1.0)),
        **compare.spread("cloud_depth", compare.rel_gap(
            _depths(got["trajectory"], got["cloud"], got["cloud_limits"]),
            _depths(ref["trajectory"], ref["cloud"], ref["cloud_limits"]), 1e-6)),
    }
