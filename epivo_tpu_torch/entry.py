"""The flagship forward step as a callable and its example arguments (the
port's counterpart of ``__graft_entry__.entry()``).

    from epivo_tpu_torch.entry import entry
    fn, args = entry()          # on the CUDA card; entry("cpu") on the CPU
    result = fn(*args)          # one vo.vo_step on a 376x1241 frame pair

The multi-device dry run is ``python -m epivo_tpu_torch.tools.dryrun_multichip``.
"""

from __future__ import annotations

import numpy as np
import torch

from epivo_tpu_torch._device import runner_device


def entry(device=None):
    """(fn, (img0, img1, generator)) for one two-view VO device step on a
    KITTI-sized frame pair: the reference's configuration (KITTI_00, FAST
    40, 512 keypoints, 4 KLT levels, 512 hypotheses, 48 LM points) and its
    frames (``np.random.default_rng(0).uniform(0, 255, (H, W))`` twice, as
    float32). ``device`` defaults to the CUDA card and raises without
    one; ``fn`` draws its RANSAC samples from the generator (seeded 0), so
    re-seeding it repeats a call."""
    from epivo_tpu_torch.geometry import camera
    from epivo_tpu_torch.pipeline import vo
    from epivo_tpu_torch.pipeline.config import (FrontendConfig, LMConfig, RansacConfig,
                                                 VOConfig)

    dev = runner_device(device)
    cfg = VOConfig(
        camera=camera.KITTI_00,
        frontend=FrontendConfig(fast_threshold=40.0, max_keypoints=512, klt_levels=4),
        ransac=RansacConfig(n_hyp=512),
        lm=LMConfig(n_points=48),
    )
    H, W = camera.KITTI_00.height, camera.KITTI_00.width
    rng = np.random.default_rng(0)
    img0 = torch.from_numpy(rng.uniform(0, 255, (H, W)).astype(np.float32)).to(dev)
    img1 = torch.from_numpy(rng.uniform(0, 255, (H, W)).astype(np.float32)).to(dev)
    generator = torch.Generator(device=dev).manual_seed(0)

    def fn(a, b, g):
        return vo.vo_step(a, b, g, cfg)

    return fn, (img0, img1, generator)
