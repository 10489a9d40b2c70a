"""The VO driver's frames, the reference's steps in blocks of lanes, and
the kernels' work at the traced step's inputs."""

from __future__ import annotations

import numpy as np
import torch

from benchmark.harness import compare
from benchmark.reference import fast as ref_fast, klt as ref_klt, vo as ref_vo
from benchmark.yardstick import frames as frames_mod, work

LANES = 8  # lanes per block of the reference's step


def render(cfg: dict, traffic: dict, seed: int) -> np.ndarray:
    return frames_mod.render(compare.derive(seed, "frames"), traffic["frames_rendered"],
                             cfg["camera"], motion=cfg.get("motion"))


def ref_steps(frames_dev: torch.Tensor, pairs: list, uniforms: torch.Tensor,
              s: ref_vo.VOSettings, lowp: bool = False):
    """The reference's fields (numpy, leading [B]) of the pairs (i, j) of
    rendered frames, stepped ``LANES`` at a time with their rows of
    ``uniforms`` [B, n_hyp, K]."""
    out = {k: [] for k in ref_vo.FIELDS}
    for b0 in range(0, len(pairs), LANES):
        blk = pairs[b0:b0 + LANES]
        src = frames_dev[[i for i, _ in blk]]
        tgt = frames_dev[[j for _, j in blk]]
        res = ref_vo.step(src, tgt, uniforms[b0:b0 + len(blk)], s, lowp=lowp)
        for k in ref_vo.FIELDS:
            out[k].append(res[k].cpu().numpy())
    return {k: np.concatenate(v) for k, v in out.items()}


def frontend_bounds(frames_dev: torch.Tensor, pairs: list, s: ref_vo.VOSettings) -> dict:
    """Least seconds of the ``fast_cand`` and ``klt_level`` launches of one
    batched step over ``pairs`` (one launch of each per level), from their
    work at these inputs (``yardstick.work``)."""
    fast_b = klt_b = 0.0
    margins = ref_klt.default_margins(s.klt_levels)
    for b0 in range(0, len(pairs), LANES):
        blk = pairs[b0:b0 + LANES]
        src = frames_dev[[i for i, _ in blk]]
        nbytes, nops = work.cand_work(src, s.fast_threshold)
        fast_b += work.bound_s(nbytes, nops)
        tgt = frames_dev[[j for _, j in blk]]
        kp = ref_fast.detect(src, s.fast_threshold, s.max_keypoints)
        levels: list = []
        ref_klt.track(src, tgt, kp.xy, valid=kp.valid, win=s.klt_window, levels=s.klt_levels,
                      iters=s.klt_iters, min_eig=s.klt_min_eig, levels_out=levels)
        for k, (ls, lt, pts, guess) in enumerate(levels):
            lvl = s.klt_levels - 1 - k
            nbytes, nops = work.level_work(ls, lt, pts, guess, s.klt_window, margins[lvl],
                                           s.klt_iters)
            klt_b += work.bound_s(nbytes, nops)
    return {"fast_cand": fast_b, "klt_level": klt_b}
