"""Back-to-back calls of ``pipeline.runners.run_vo_sequence`` over a stream
of raw frames of a camera with a radial-tangential lens, which the step
undistorts on the card (the configuration's ``distortion``), as an offline
user replays a recorded sequence from its raw camera images.

The stream, the calls and the readings are ``vo_runner``'s. The program
is given the raw frames (``yardstick/raw_frames.py``) and a configuration
that carries the lens; ``self.frames`` holds them undistorted by the plain
reference (``reference/undistort.py``), which is what the reference's
steps and the front end's work counts see. The traced call adds the least
time of its undistortion launches (``yardstick/undistort_work.py``).
"""

from __future__ import annotations

import dataclasses

import torch

from benchmark.harness import compare, trace
from benchmark.harness.kinds import vo_runner
from benchmark.reference import undistort as ref_undistort
from benchmark.yardstick import raw_frames, undistort_work

REHEARSAL = vo_runner.REHEARSAL
CONTROL = vo_runner.CONTROL
FAULT_TARGET = "vo_step_batched"


class Driver(vo_runner.Driver):
    def setup(self) -> None:
        from benchmark.harness import port
        from epivo_tpu_torch.geometry.camera import Distortion

        # The lens first: a program without one fails here, before any frame.
        self.config = dataclasses.replace(port.vo_config(self.cfg),
                                          distortion=Distortion(**self.cfg["distortion"]))
        self.raw = raw_frames.render(compare.derive(self.seed, "frames"),
                                     self.traffic["frames_rendered"], self.cfg["camera"],
                                     self.cfg["distortion"], motion=self.cfg.get("motion"))
        self.frames = ref_undistort.undistort(torch.from_numpy(self.raw).to(self.dev),
                                              self.cfg["camera"],
                                              self.cfg["distortion"]).cpu().numpy()
        for c in range(-self.traffic["warmup_calls"], 0):
            self._call(c)

    def _call(self, c: int):
        """``vo_runner``'s call c, on the raw frames."""
        from epivo_tpu_torch.pipeline import runners

        return runners.run_vo_sequence(
            (self.raw[i] for i in self._stream(c)), self.config, gt_poses=None,
            batch=self.B, seed=compare.derive(self.seed, "call", c), collect_cloud=True,
            checkpoint_dir=None, metrics_path=None,
            pipeline_depth=self.traffic["pipeline_depth"], device=self.dev)

    def traced(self) -> trace.TraceSummary:
        t = super().traced()
        # A step is given its pairs' distinct frames, each once: its pairs
        # and one frame more.
        n_pairs = self.L - 1
        frames = sum(min(self.B, n_pairs - b0) + 1 for b0 in range(0, n_pairs, self.B))
        H, W = self.raw.shape[1:]
        t.bounds["undistort"] = undistort_work.bound_s(frames, H, W)
        return t
