#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (epivo_tpu_torch) once on one GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each reported on its own line:

1. device: the CUDA card, and its name and power limit from nvidia-smi;
2. build: the hand-written kernels, compiled from epivo_tpu_torch/csrc/
   into build/epivo_tpu_torch/ (first use only);
3. kernels: each kernel against its plain PyTorch version on the card, at
   the shapes the two-view VO step gives it: the wrapper's time (host and
   device), the kernel's own device time, the plain version's time, the
   bound (the least time the card could take for the same work) and, where
   one PyTorch call computes the same function, that call's time;
4. slice: vo_step on the KITTI-sized (376x1241) photoreal corridor pair at
   the bench configuration, counting kernel launches, timing the step, the
   detect stage and the KLT stage, checking that fast.detect and klt.track
   make no host sync, and checking the pose against the ground truth and
   against the plain path;
5. degenerate: textureless frames must still give a finite pose;
6. batched: vo_step_batched on B = 8 copies of the corridor pair (the
   throughput mode): one fast_cand and four klt_level launches per call,
   as a single step has, no host sync in the whole call, every lane
   against the ground truth, the kernel path against the plain path and
   lane 0 against a single vo_step with the same samples, a repeat probe,
   pairs/s in turns with single steps, and fast_cand / klt_level at B = 8
   against their plain versions with device time and bound;
7. ba: ba_windows on the 512 windows of bench_ba_workload.npz (the bench's
   BA workload): no host sync, the card against the port's CPU path, the
   same ATen operators at W = 64 and W = 512 (no loop over windows), and
   windows/s and LM iterations/s;
8. orb: vo_step_orb on the corridor pair (one fast_cand and one extract
   launch per step), vo_step_orb_batched at B = 8 (no host sync, bit-equal
   on repeat, every lane against the ground truth, kernel path against
   plain path), the extraction kernel at the ORB window (S = 37) for the
   2 and 16 frames of a single and a batched step, one step on the 8-level
   pyramid (fast_cand 6, fast 2, extract 8; the dense FAST kernel against
   its plain version at that step's 127x415 and 106x346 levels), and the
   ORB retry of _extract_pairs on a turn pair where KLT alone
   under-rotates;
9. sequence: the 300-frame KITTI-sized corridor through run_vo_sequence
   (ground-truth scale) and run_ba_sequence (no ground truth): ATE, length
   ratio, the pairs' accuracy, the pairs retried and replaced by ORB, the
   wall time of each stage, and fast_cand, klt_level and the extraction
   kernel against their plain versions on the inputs of one 32-pair
   extraction batch and one ORB retry batch of that run, with device time
   and bound;
10. stereo: the 60-frame KITTI-sized stereo corridor through
   run_stereo_ba_sequence at two seeds: metric ATE, length ratio and
   step-length error against the JAX package's own CPU spread, the metric
   scale on the card against the CPU (its depth step free of host syncs),
   pairs, retries, wall time per stage, peak_buffered and device memory,
   and fast_cand and klt_level against their plain versions on the first
   extraction batch of that run, which holds rig pairs (and the ORB retry
   batch's kernels, if the retry fired);
11. loop: the 236-frame KITTI-sized out-and-back loop course through
   run_ba_sequence with loop closure on (no ground truth): Sim(3) ATE,
   endpoint gap and the loops applied against the JAX package's own CPU
   spread, the wall time of describe, retrieval, verification and the pose
   graph, and the launches of the loop stage (one pyramid ORB call for the
   keyframe stack, one per verification); the drift-injected fixture
   through the loop stage on the card, every applied loop's verification
   against the port's CPU path with the same samples; and fast_cand, the
   dense FAST kernel and the extraction kernel against their plain
   versions at the half-resolution keyframe pyramid's shapes;
12. five-point and global BA: vo_step with RansacConfig(solver="5pt") on
   the corridor pair (5,120 candidates per pair): a KLT step's launches,
   step time, the five-point stage's device time and ATen operators per
   call, the pose against the ground truth and the JAX package's CPU
   spread, the kernel path against the plain path; vo_step_batched at
   B = 8 with no host sync, pairs/s and peak device memory; five_point on
   the card against the port's CPU path on the same 512 samples (sets of
   candidates up to sign); and the global-BA polish on phase 9's two
   no-GT runs over their own zetas and pairs: the paired Sim(3) ATE delta
   against the JAX package's CPU spread, kept step norms, accepted steps,
   the card against the port's CPU and a bit-equal repeat;
13. multi-device on one card, on phase 9's frames, seed-0 run and pairs
   (rendering nothing): (a) NCCL at a world size of 1, where
   _extract_pairs on the first 64 pairs (two 32-pair calls), _solve_windows
   on seed 0's windows and refine_global on its zetas and pairs must be
   bit-equal with a mesh and without one; (b) two gloo ranks sharing the
   card (torch.multiprocessing spawn, tools/mesh_checks.card_check): the
   64 pairs at 16 pairs per rank per call (each rank's launches counted in
   that run: fast_cand 1 / klt_level 4 per call, the ORB retry pass apart;
   no host sync in the step), the window solve on the 512 windows of
   bench_ba_workload.npz, the constraint-sharded global polish and the
   hypothesis-split RANSAC on the corridor pair, each against one rank;
   batch-shape controls (rank 0's lanes and windows in one process without
   a mesh at the rank's B and W); the collectives rank 0 ran, by backend
   and tensor device; and fast_cand and klt_level against their plain
   versions at B = 16;
14. entry points, on phase 9's first 64 frames and phase 10's first 20
   stereo frames written as KITTI trees of PNGs (rendering nothing): the
   native runtime (built from the checkout beside the kernels) decoding
   every PNG bit-equal to its uint8 frame, the loader's frames/s; entry()
   on the card (one vo_step's launches, a bit-equal repeat);
   tools/run_kitti.py in all four modes in this process (ba and stereo
   bit-equal to their runners on the same frames in memory, the ba run's
   launches, vo's ATE against the JAX CLI's on the CPU, the reference
   CLI's files and summary keys); and tools/synthetic_vo_demo.py with its
   --flat probe.

Before the last two lines, one JSON object holds the batched, BA, ORB,
sequence, stereo, loop, five-point, global, multi-device and entry-point
phases' numbers; the line before the last is a JSON object with one entry
per kernel (launches per KLT step, per ORB step, per pyramid ORB step, in
the sequence run, in the stereo run, in the loop run, in its loop stage,
per loop-stage call, per 5-point step, per rank and call of the 2-rank
extraction, and in the KITTI CLI's ba run); the last line is {"ok": true,
"device": {...}}. Any failed check raises and exits non-zero without that
line. Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

H, W = 376, 1241
SEED = 7
# Kernel B3 (LK) sums in another order than its plain version: the
# tolerance on the tracked corner and on the mean residual.
LK_Q_ATOL = 1e-3  # px
LK_ERR_ATOL, LK_ERR_RTOL = 1e-3, 1e-4
# The level kernel (B2 + B3 fused) against the plain level: the same
# tolerances on the new guess and the residual; ok equal except where
# min_ev / win^2 lies within this relative distance of min_eig. A keypoint
# whose LK loop takes a step within FREEZE_NEAR_RTOL of the freeze
# threshold eps may freeze on one path and take one more step, below eps,
# on the other: its guess may differ by up to eps and its residual by
# FREEZE_ERR_RTOL (one keypoint of phase 9's first batch: a step 1 ulp
# from eps, guess 0.0045 px and residual 1.05e-3 apart; the plain path on
# the CPU froze there as the kernel did).
OK_NEAR_RTOL = 1e-4
FREEZE_NEAR_RTOL, FREEZE_ERR_RTOL = 1e-4, 1e-2
# Kernel path vs plain path of the whole step, same RANSAC samples.
STEP_R_TOL, STEP_DIR_TOL = 2e-3, 2e-3
# Pose against the corridor's ground truth.
GT_R_TOL, GT_DIR_TOL = 0.01, 0.1
# Pairs per batched call (bench.py's batched mode).
N_PAIRS = 8
# Windowed BA, card against the port's CPU path, at the tolerances of the
# CPU tests (tests/test_torch_ba.py): rotations, translation directions,
# accepted steps, and the final residual norm (rtol, atol); the share of
# windows whose poses must meet them (see phase_ba).
BA_R_TOL, BA_DIR_TOL, BA_ACC_TOL = 1e-4, 3e-3, 8
BA_R_RTOL, BA_R_ATOL = 0.2, 1e-5
BA_WITHIN = 0.95
# Device activities per BA call at W = 64 against W = 512: cuBLAS picks its
# GEMM / GEMV kernels (and split-K passes) by shape; a loop over windows
# would multiply the count by 8.
BA_DEVICE_RTOL = 0.01
# ORB pose against the corridor pair's ground truth: twice the JAX
# package's worst over RANSAC seeds 0-43 on this pair (CPU, python -m
# tests.reference_accuracy orb-pose; medians 0.0096 / 0.181 and 0.0074 /
# 0.092): single scale 0.0266 / 0.440, the 8-level pyramid 0.0374 / 0.651.
# ORB keeps ~25 matches here (47 on the pyramid) and trades subpixel
# accuracy for robustness.
ORB_GT_R_TOL, ORB_GT_DIR_TOL = 0.053, 0.88
PYR_GT_R_TOL, PYR_GT_DIR_TOL = 0.075, 1.3
# The port's own spread on this pair over as many RANSAC draws as those
# reference seeds, beside the reference's median and worst over them: the
# median over the draws within ORB_MEDIAN_GAIN x the reference's median.
ORB_DRAWS = 44
ORB_REF_MEDIAN, ORB_REF_WORST = (0.00961, 0.181), (0.0266, 0.440)
ORB_MEDIAN_GAIN = 2.0
# The ORB retry on the turn pair (tests/test_runners_datasets.py's slow
# test): KLT alone below this share of the true rotation angle, the retry
# within this relative error of it, with at least this many times the
# inliers. KLT alone is that wrong in some RANSAC draws only (the JAX
# package: 3 of seeds 0-9 on the CPU, seed 0 among them, python -m
# tests.reference_accuracy turn), so the first check runs over TURN_DRAWS
# draws; the other two hold at seed 0 and for the draws' medians.
TURN_KLT_MAX, TURN_ORB_RTOL, TURN_INLIER_GAIN = 0.7, 0.2, 2
TURN_DRAWS = 16
# The corridor sequence (ROADMAP A10): frames, pairs per batched call, the
# no-GT seeds, and the accuracy limits. VO with the GT scale: the JAX
# package gives 1.171 % (ATE_photoreal.json). No GT: the scale graph
# compounds every pair's error into the scales after it, so one seed's
# trajectory is one draw from a wide spread. The JAX package's own seeds
# 0-3 on the CPU (python -m tests.reference_accuracy sequence) give Sim(3)
# ATE 3.419 / 4.912 / 1.776 / 5.164 % and length ratio 1.127 / 1.898 /
# 1.031 / 2.301; its pairs' median direction error against the ground
# truth 0.0578-0.0585 with 42-53 flipped. The trajectory limits are on the
# median over SEQ_SEEDS, within 1.5x of the reference's extremes. The
# pairs do not compound: their limits, also on the median over the seeds,
# are the top of the spread measured over nine realizations of the
# estimator (0.0561-0.0625, 41-54 flipped): the reference's seeds 0-3,
# the port's seeds 0-2, and the port on the reference's own RANSAC draws
# of seeds 0-1 (python -m tests.sequence_parity). The scale graph on the
# card must keep the CPU's measurements, to float32 rounding. Two seeds,
# to keep the script within half the run's time limit with phase 14 (seed
# 2 was cut, as phase 10's was): the limits stand (the reference's own
# seeds on these frames), and a median of two is their mean, which no
# single seed can hide in.
SEQ_FRAMES, SEQ_BATCH, SEQ_SEEDS = 300, 32, (0, 1)
SEQ_VO_ATE_PCT, SEQ_BA_ATE_PCT, SEQ_RATIO = 2.5, 1.5 * 5.164, (1.031 / 1.5, 1.5 * 2.301)
SEQ_PAIR_DIR, SEQ_PAIR_FLIPPED = 0.0625, 54
SEQ_GRAPH_ATOL = 1e-3
# The stereo corridor (ROADMAP A12): frames per camera, the seeds, pairs per
# batched call (scripts/run_photoreal_stereo.py's configuration). The
# limits come from the JAX package's own CPU runs on the same 60 frames,
# seeds 0-3 (python -m tests.reference_accuracy stereo --frames 60 --seeds
# 0-3): the median relative step-length error per seed within 1.5x its
# worst seed's (0.0284 / 0.0305 / 0.0304 / 0.0305); over the seeds, the
# median metric ATE (% of the length) within 1.5x its worst (0.283 / 0.574
# / 0.352 / 0.304 %), and the median length ratio's distance from 1 within
# 1.5x its largest (1.0062 / 1.0179 / 1.0089 / 1.0064). The card's scales
# against the CPU's on the same pairs: STEREO_SCALE_RTOL relative, the
# same Hampel replacements. Two seeds, to keep the script within half the
# run's time limit with phase 13: the limits stand (they are the
# reference's own seeds on these frames), and a median of two is their
# mean, which no single seed can hide in. Fewer frames would tighten the
# reference's spread (at 40 frames its worst length ratio is 1.0123, and
# the port's seeds 0-2 on the CPU give a median of 1.0180 against the
# 1.0185 that would allow: python -m tests.reference_accuracy stereo
# --frames 40 --seeds 0-3; python -m epivo_tpu_torch.tools.photoreal_stereo
# --frames 40 --seeds 0,1,2 --device cpu).
STEREO_FRAMES, STEREO_SEEDS, STEREO_BATCH = 60, (0, 1), 8
STEREO_REF_STEP_ERR, STEREO_REF_ATE_PCT, STEREO_REF_RATIO_DEV = 0.030527, 0.5745, 0.017930
STEREO_STEP_ERR = 1.5 * STEREO_REF_STEP_ERR
STEREO_ATE_PCT = 1.5 * STEREO_REF_ATE_PCT
STEREO_RATIO_DEV = 1.5 * STEREO_REF_RATIO_DEV
STEREO_SCALE_RTOL = 1e-4
# Loop closure (ROADMAP A13) on the out-and-back loop course
# (tools/photoreal_loop.py: 236 frames, 376x1241, the configuration of
# scripts/run_photoreal_loop.py), no ground truth fed, seed LOOP_SEED. The
# limits come from the JAX package's own CPU runs on the same frames,
# seeds 0-3 (python -m tests.reference_accuracy loop --course out-and-back
# --seeds 0-3; loop on: Sim(3) ATE 14.421 / 8.643 / 10.516 / 15.799 % of
# the length, endpoint gap 1.418 / 0.883 / 2.979 / 0.321 m with the gauge
# on step 0, the loop (8, 232) with 265 inliers in every seed): at least
# one loop, and the ATE and the gap within 1.5x its worst seed's. The
# drift-injected fixture (the JAX package's
# test_close_loops_on_photoreal_fixture at full width; the reference on
# the CPU: 8.304 -> 2.374 m with the loop (8, 232), 351 inliers): at least
# one loop, and the position RMSE below LOOP_DRIFT_GAIN x the drifted
# chain's. Each applied loop's verification on the card
# against the port's CPU path with the same samples: inliers within
# LOOP_INLIER_TOL, the same branch, rotation and translation direction
# within LOOP_R_TOL / LOOP_DIR_TOL (the CPU parity tests' tolerances).
LOOP_SEED, LOOP_BATCH = 0, 32
LOOP_REF_ATE_PCT, LOOP_REF_GAP_M = 15.799405, 2.979042
LOOP_ATE_PCT, LOOP_GAP_M = 1.5 * LOOP_REF_ATE_PCT, 1.5 * LOOP_REF_GAP_M
LOOP_DRIFT_GAIN = 0.7
LOOP_INLIER_TOL, LOOP_R_TOL, LOOP_DIR_TOL = 3, 2e-3, 2e-3
# The 5-point solver (ROADMAP A11) on the corridor pair at the bench
# configuration with RansacConfig(solver="5pt"). The JAX package on the CPU
# over RANSAC seeds FIVE_REF_SEEDS (python -m tests.reference_accuracy
# five-point --eager; its jit compile did not finish in 6 minutes): worst
# and median |R - R_gt|_F and direction error; the port
# holds every step and lane within twice the worst, and the median over the
# B = 8 lanes' draws within twice the median. The card against the port's
# CPU path on the same 512 samples, candidates matched as sets up to sign
# within FIVE_MATCH_TOL Frobenius: at least FIVE_MATCH of each side's exact
# candidates (Sampson error below FIVE_EXACT on all 5 points) match a valid
# one on the other side. The solver's other candidates move with float32
# rounding: on these samples one ulp on the CPU's inputs leaves ~70 % of
# all valid candidates within the tolerance, and the JAX package against
# the port, both on the CPU, ~73 %. So the share over all
# valid candidates is held to the CPU's own one-ulp control, measured in
# the same run, less FIVE_CONTROL_SLACK.
FIVE_REF_SEEDS = "0-43"
FIVE_REF_WORST, FIVE_REF_MEDIAN = (0.002430, 0.045883), (0.002342, 0.045162)
FIVE_MATCH, FIVE_MATCH_TOL, FIVE_EXACT, FIVE_CONTROL_SLACK = 0.95, 1e-3, 1e-12, 0.05
# The global-BA polish (ROADMAP A14a) on phase 9's no-GT runs, over
# each run's own zetas and pairs. The JAX package on the CPU, seeds 0-3 of
# tests.reference_accuracy sequence, through the back half with the polish
# off and on (python -m tests.reference_accuracy global): paired Sim(3) ATE
# deltas (on - off, pp of the length) -0.442 / +0.263 / +0.319 / +0.195,
# whose extremes are GLOBAL_REF_DELTA; the median
# over SEQ_SEEDS must lie within 1.5x those extremes. Step norms kept to
# GLOBAL_NORM_RTOL. The card against the port's CPU on seed 0's input: the
# per-zeta rotation difference (largest entry) within GLOBAL_R_TOL at its
# 95th percentile (the reference's own 1-vs-8-device bound for the solver on
# synthetic chains, tests/test_global_ba.py:80-82) and within GLOBAL_R_MAX at
# its largest (the reference's own bound for its sharded against its
# single-device polish on rendered frames, tests/test_global_ba.py:167): the
# corridor's last zetas, where the camera reaches the back wall, are
# ill-conditioned, and one ulp on the input rotations moves one of them by
# up to 0.025 on a CPU (the control line prints the CPU's own spread);
# r_norm within GLOBAL_RNORM_RTOL.
# Multi-device on one card (ROADMAP A14b): the first MULTI_PAIRS pairs of
# phase 9's seed-0 run (two SEQ_BATCH-pair calls), its windows, zetas and
# pairs, bench_ba_workload.npz and the corridor pair. (a) NCCL at a world
# size of 1: every mesh path bit-equal to the path without a mesh. (b) two
# gloo ranks sharing the card: the extraction's median pose delta against
# one rank below MULTI_POSE_MEDIAN (the reference's 1-vs-8 bound of its
# sharded frontend, __graft_entry__.py:171); the window solve held to one
# rank as phase 7 holds the card to the CPU (r_norm and the reverted set on
# every window, rotations, directions and accepted steps at BA_*_TOL on
# BA_WITHIN of the windows), and its rotations and translation directions
# within MULTI_T_ATOL (the reference's 1-vs-8 bound on T_opt,
# tests/test_sharding.py:55) on MULTI_WITHIN of them. The translation
# magnitudes are left out as phase 7 leaves them out: the epipolar energy
# barely sees a window's ratio of its two translations, so rounding alone
# moves them (the control line measures it: one rank against itself with
# the initial poses moved by 1e-7); the whole T_opt within MULTI_T_ATOL is
# printed beside that control. The global polish within phase 12's
# card-vs-CPU bounds; the hypothesis-split RANSAC the same winner as one
# rank.
MULTI_PAIRS = 64
MULTI_POSE_MEDIAN = 1e-2
MULTI_T_ATOL = 5e-3
MULTI_WITHIN = 0.95
GLOBAL_REF_DELTA = (-0.441746, 0.319116)
GLOBAL_DELTA = (GLOBAL_REF_DELTA[0] - 0.5 * abs(GLOBAL_REF_DELTA[0]),
                GLOBAL_REF_DELTA[1] + 0.5 * abs(GLOBAL_REF_DELTA[1]))
GLOBAL_NORM_RTOL, GLOBAL_R_TOL, GLOBAL_R_MAX, GLOBAL_RNORM_RTOL = 1e-3, 5e-3, 2e-2, 0.05

# The entry points (ROADMAP A15), on phase 9's first ENTRY_FRAMES frames and
# phase 10's first ENTRY_STEREO_FRAMES stereo frames, written as KITTI trees
# of PNGs and run through tools/run_kitti.py at phase 9's frontend settings
# (FAST 30, 512 keypoints, batches of 32 pairs; stereo in batches of 8).
# The vo mode's ATE within 1.5x the JAX package's own CLI on the CPU on the
# same tree (python -m tests.reference_accuracy kitti-cli --frames 64:
# 0.106211 m over the 52.746 m of the 64 frames, 0.201364 %); the CLI takes
# no seed, so that one run is the reference.
ENTRY_FRAMES, ENTRY_STEREO_FRAMES = 64, 20
CLI_REF_VO_ATE_PCT = 0.201364
CLI_VO_ATE_PCT = 1.5 * CLI_REF_VO_ATE_PCT
# The reference CLI's files per mode (scripts/run_kitti.py), before the
# cloud's and the plot's, and its summary keys.
CLI_FILES = {"kitti.T", "est_kitti_format.txt", "kitti.GT", "summary.json"}
CLI_SUMMARY = {"mode", "seq", "frames", "ate_m", "rpe_t", "config"}
CLI_CONFIG = {"batch", "pipeline_depth", "devices", "global_ba", "loop_close", "n_hyp",
              "max_keypoints", "platform"}

def _check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    from epivo_tpu_torch.frontend import fast, klt

    fast.KERNEL_LAUNCHES = fast.CAND_LAUNCHES = 0
    klt.LEVEL_LAUNCHES = klt.EXTRACT_LAUNCHES = klt.LK_LAUNCHES = 0


def launches_now() -> dict:
    """Every kernel's launch count since the last reset."""
    from epivo_tpu_torch.frontend import fast, klt

    return {"fast": fast.KERNEL_LAUNCHES, "fast_cand": fast.CAND_LAUNCHES,
            "klt_level": klt.LEVEL_LAUNCHES, "extract": klt.EXTRACT_LAUNCHES,
            "lk": klt.LK_LAUNCHES}


def host_ms(fn) -> float:
    """Host-clock ms of fn() with a synchronise on each side."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of fn() in ms (CUDA events, after warm-up)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


# The card's peaks for the bound (H100 SXM data sheet): HBM bytes/s, and
# float32 operations/s outside the tensor cores (an FMA counts as two).
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12
# Float operations per pixel, counted from the kernels' arithmetic.
SAMPLE_OPS = 11  # four-tap bilinear blend: 8 products, 3 sums
LK_STEP_OPS = SAMPLE_OPS + 5  # residual, and 2 multiply-adds into b
G_OPS = 6  # 3 products, 3 sums into G
ERR_OPS = SAMPLE_OPS + 2  # residual, |.| summed
TAP3_OPS = 6  # one 3-tap Scharr pass
# FAST without early rejection: ring differences, 16 arcs x 8 x (min, max),
# the best arc and the score (printed beside the bound for comparison).
FAST_NAIVE_OPS = 16 + 16 * 8 * 2 + 16 * 3 + 2
# The compass test: the neighbouring pairs' min and max (14), two centre
# subtractions, two comparisons.
COMPASS_OPS = 14 + 2 + 2
# One side of the full score: shared partial minima (48), arc minima (16),
# the best-arc tree (15), the centre, the threshold.
ARC_OPS = 48 + 16 + 15 + 1 + 1
NMS_OPS = 9  # 8 neighbour maxima and the comparison (dense kernel)
NMS_SEP_OPS = 6  # with row maxima shared between rows (candidate kernel)
SELECT_OPS = 2 * 256  # per selection round of a block: max reduction, ballots
FAST_T = 40.0  # the bench configuration's threshold


def bound(nbytes: float, nops: float) -> tuple[float, str]:
    """Least time in ms for moving ``nbytes`` and doing ``nops``, and which
    of the two binds."""
    t_b, t_o = nbytes / PEAK_BYTES_S * 1e3, nops / PEAK_F32_S * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def device_ms(launch, kernel: str | None, reps: int = 50) -> tuple[float, str]:
    """The kernel's own mean device time in ms per launch: torch.profiler's
    device time for the kernel of that name, or, where the profiler shows
    none, CUDA events around 100 back-to-back launches. With kernel=None,
    the device time of every kernel one call of ``launch`` runs."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    launch()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            launch()
        torch.cuda.synchronize()
    total_us, count = 0.0, 0
    for e in prof.key_averages():
        if kernel is None and e.device_type == DeviceType.CUDA:
            total_us += e.device_time_total
            count = reps
        elif kernel is not None and kernel in e.key:
            total_us += e.device_time_total
            count += e.count
    if count and total_us > 0:
        return total_us / count / 1e3, "profiler"
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(100):
        launch()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 100, "events"


def fast_work(img: torch.Tensor, t: float) -> tuple[int, int]:
    """(interior pixels, compass-test sides passed summed over them) of one
    frame: the data-dependent part of the FAST op count."""
    H, W = img.shape
    c = img[3:H - 3, 3:W - 3]
    d = [img[3 + dy:H - 3 + dy, 3 + dx:W - 3 + dx] - c
         for dy, dx in ((-3, 0), (0, 3), (3, 0), (0, -3))]
    pairs = ((0, 1), (1, 2), (2, 3), (3, 0))
    bright = torch.stack([(d[a] > t) & (d[b] > t) for a, b in pairs]).any(0)
    dark = torch.stack([(d[a] < -t) & (d[b] < -t) for a, b in pairs]).any(0)
    return c.numel(), int(bright.sum()) + int(dark.sum())


def lk_steps(tgt_wins, T, Ix, Iy, q0, win: int, iters: int,
             eps: float) -> tuple[int, torch.Tensor]:
    """The LK loop on these inputs (lk_iterate_plain's rule): the
    keypoint-steps it runs before each keypoint freezes, for the
    data-dependent op count, and each keypoint's closest approach to the
    freeze threshold, min |(|step| - eps) / eps| over the steps it takes."""
    from epivo_tpu_torch.frontend import klt

    S = tgt_wins.shape[-1]
    hi = S - win - 1 - 1e-3
    Gxx, Gxy, Gyy = ((a * b).sum((1, 2)) for a, b in ((Ix, Ix), (Ix, Iy), (Iy, Iy)))
    det = Gxx * Gyy - Gxy * Gxy
    inv_det = torch.where(det.abs() > 1e-12, 1.0 / det, 0.0)
    q = q0.clamp(0.0, hi)
    done = torch.zeros(q.shape[0], dtype=torch.bool, device=q.device)
    closest = torch.full((q.shape[0],), torch.inf, device=q.device)
    steps = 0
    for _ in range(iters):
        steps += int((~done).sum())
        dI = klt._sample_patches(tgt_wins, q, win) - T
        bx, by = (dI * Ix).sum((1, 2)), (dI * Iy).sum((1, 2))
        step = torch.stack([-(Gyy * bx - Gxy * by) * inv_det,
                            -(-Gxy * bx + Gxx * by) * inv_det], -1)
        norm = torch.linalg.norm(step, dim=-1)
        closest = torch.where(done, closest, torch.minimum(closest, (norm - eps).abs() / eps))
        q = torch.where(done[:, None], q, (q + step).clamp(0.0, hi))
        done = done | (norm < eps)
    return steps, closest


def cand_work(imgs: torch.Tensor, thr: float = FAST_T) -> dict:
    """The fused candidate kernel's work on frames [B, H, W] at threshold
    ``thr``: the bytes it must move, the operations these frames need (the
    compass test, the scores of the sides that pass it, NMS and the
    selection rounds), and the counts they come from."""
    from epivo_tpu_torch.frontend import fast

    B, Hh, Ww = imgs.shape
    n_int = n_sides = rounds = 0
    for img in imgs:
        a, b = fast_work(img, thr)
        pv, _ = fast.block_candidates(fast.nms3(fast.fast_score_map(img, thr)))
        n_int, n_sides = n_int + a, n_sides + b
        rounds += int((1 + (pv[:, 1:] != pv[:, :-1]).sum(-1)).sum())
    nb = pv.shape[0]
    score_ops = n_int * COMPASS_OPS + n_sides * ARC_OPS
    return dict(nb=nb, n_int=n_int, n_sides=n_sides, rounds=rounds, score_ops=score_ops,
                nbytes=B * Hh * Ww * 4 + B * nb * 8 * (4 + 4),
                nops=score_ops + B * Hh * Ww * NMS_SEP_OPS + rounds * SELECT_OPS)


def extract_report(imgs, oy, ox, S: int, what: str = "") -> dict:
    """The extraction kernel on [B, H, W] images and [B, K] origins against
    its plain version (bit-equal, no host sync), with the wrapper's time,
    the kernel's device time, the bound, the plain version's time and the
    library yardstick's: one advanced-indexing gather of unfolded views."""
    from epivo_tpu_torch import _kernels
    from epivo_tpu_torch.frontend import klt

    lib, stream = _kernels.lib(), torch.cuda.current_stream().cuda_stream
    B, Hl, Wl = imgs.shape
    K = oy.shape[1]
    k = no_sync(lambda: klt.extract_windows_kernel(imgs, oy, ox, S))
    p = klt.extract_windows_plain(imgs, oy, ox, S)
    oyc, oxc = oy.clamp(0, Hl - S), ox.clamp(0, Wl - S)
    b_idx = torch.arange(B, device=imgs.device)[:, None].expand(B, K)
    gather = lambda: imgs.unfold(-2, S, 1).unfold(-2, S, 1)[b_idx, oyc, oxc]
    torch.cuda.synchronize()
    _check(torch.equal(k, p), f"extract kernel differs (S={S}, B={B}{what})")
    _check(torch.equal(gather(), p), f"library gather differs (S={S}, B={B}{what})")
    oy32, ox32 = oy.int().contiguous(), ox.int().contiguous()
    raw = lambda: lib.epivo_extract_windows(
        imgs.data_ptr(), oy32.data_ptr(), ox32.data_ptr(), k.data_ptr(),
        B, Hl, Wl, K, S, stream)
    dev_ms, how = device_ms(raw, "extract_windows_kernel")
    lib_dev_ms, lib_how = device_ms(gather, None)
    b_ms, b_by = bound(B * Hl * Wl * 4 + 2 * B * K * 4 + k.numel() * 4, 0)
    t = timed_in_turns({
        "kernel": lambda: klt.extract_windows_kernel(imgs, oy, ox, S),
        "plain": lambda: klt.extract_windows_plain(imgs, oy, ox, S),
        "library": gather}, turns=1)
    print(f"kernel extract: S={S} B={B} K={K} on {Hl}x{Wl}{what} bit-equal, no host "
          f"sync, wrapper {t['kernel']:.4f} ms, device {dev_ms:.4f} ms ({how}), "
          f"bound {b_ms:.4f} ms ({b_by}), plain {t['plain']:.4f} ms, "
          f"library gather {t['library']:.4f} ms, its device time "
          f"{lib_dev_ms:.4f} ms ({lib_how})")
    return dict(max_abs_err=float((k - p).abs().max()), ms=t["kernel"], device_ms=dev_ms,
                plain_ms=t["plain"], bound_ms=b_ms, bound_by=b_by, library_ms=t["library"],
                library_device_ms=lib_dev_ms)


def level_lk(src, tgt, pts, guess, win: int, S: int, iters: int,
             eps: float) -> tuple[int, torch.Tensor]:
    """lk_steps on one level's inputs ([B, H, W] images, [B, K, 2] points),
    for its first chunk of ``iters`` steps; the closest approach [B * K]."""
    from epivo_tpu_torch.frontend import klt

    T, Ix, Iy, c_eff = klt._template(src, pts, win, S, use_kernel=False)
    tgt_wins, _, q0 = klt._target(tgt, guess + (c_eff - pts), win, S, use_kernel=False)
    return lk_steps(tgt_wins.reshape(-1, S, S), T.reshape(-1, win, win),
                    Ix.reshape(-1, win, win), Iy.reshape(-1, win, win),
                    q0.reshape(-1, 2), win, iters, eps)


def level_work(src, tgt, pts, guess, win: int, S: int, iters: int,
               eps: float) -> tuple[int, int, int]:
    """(bytes, operations, keypoint-steps) of one level-kernel launch on
    [B, H, W] images and [B, K, 2] points, the LK steps counted as this
    data takes them before each keypoint freezes."""
    B, Hl, Wl = src.shape
    K, n = pts.shape[1], win * win
    steps, _ = level_lk(src, tgt, pts, guess, win, S, iters, eps)
    scharr = ((win + 3) * (win + 1) + (win + 1) ** 2) * 2 * TAP3_OPS
    nbytes = 2 * B * Hl * Wl * 4 + 2 * B * K * 2 * 4 + B * K * (2 * 4 + 1 + 4)
    nops = (B * K * (scharr + n * (3 * SAMPLE_OPS + G_OPS + ERR_OPS))
            + steps * n * LK_STEP_OPS)
    return nbytes, nops, steps


def level_launch(src, tgt, pts, guess, win: int, S: int, iters: int, eps: float,
                 min_eig: float):
    """A raw ctypes launch of the level kernel (one chunk of ``iters``
    steps), for its device time; its outputs are discarded."""
    from epivo_tpu_torch import _kernels

    lib, stream = _kernels.lib(), torch.cuda.current_stream().cuda_stream
    B, Hl, Wl = src.shape
    K = pts.shape[1]
    g_o = torch.empty_like(guess)
    ok_o = torch.empty((B, K), dtype=torch.bool, device=src.device)
    e_o = torch.empty((B, K), device=src.device)
    return lambda: lib.epivo_track_level(
        src.data_ptr(), tgt.data_ptr(), pts.data_ptr(), guess.data_ptr(),
        g_o.data_ptr(), ok_o.data_ptr(), e_o.data_ptr(), B, Hl, Wl, K, S, win,
        iters, 1, eps, min_eig, S - win - 1 - 1e-3, stream)


def phase_device() -> tuple[str, str]:
    _check(torch.cuda.is_available(), "no CUDA device")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"device: {name} count={torch.cuda.device_count()} "
          f"torch={torch.__version__} cuda={torch.version.cuda}")
    print(f"nvidia-smi: {smi}")
    return name, smi


def _runtime_build() -> tuple[Path, float, str]:
    from epivo_tpu_torch import runtime

    t0 = time.perf_counter()
    return runtime.build(), time.perf_counter() - t0, runtime.build_log


def phase_build():
    """Build the kernels, with the native runtime (g++) building beside
    them in a thread. Returns the runtime build's future, which phase 14
    reads: a runtime that does not build fails that phase, not this one."""
    import concurrent.futures

    from epivo_tpu_torch import _kernels

    pool = concurrent.futures.ThreadPoolExecutor(1)
    runtime_build = pool.submit(_runtime_build)
    pool.shutdown(wait=False)
    t0 = time.perf_counter()
    path = _kernels.build()
    _kernels.lib()
    dt = time.perf_counter() - t0
    print(f"build: {dt:.1f} s -> {path.relative_to(_kernels.BUILD_DIR.parent.parent)}")
    for line in _kernels.build_log.splitlines():
        if "Used" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")
    return runtime_build


def corridor_pair(dev):
    from epivo_tpu_torch.datasets import photoreal

    frames, gt, _ = photoreal.corridor_sequence(2, H=H, W=W, seed=0)
    f0, f1 = (torch.from_numpy(np.asarray(f, np.float32)).to(dev) for f in frames)
    return f0, f1, gt


def no_sync(fn):
    """fn() with any host sync raising (torch.cuda.set_sync_debug_mode)."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")


@contextlib.contextmanager
def patched(module, name: str, value):
    """Replace ``module.name`` for the duration of the block."""
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


def level_inputs(f0, f1, kp, cfg) -> list:
    """Each pyramid level's (src, tgt, pt_src, guess) as klt.track hands
    them to the level kernel, top level first."""
    from epivo_tpu_torch.frontend import klt

    fc = cfg.frontend
    with recording(klt, "track_level_kernel") as seen:
        klt.track(f0, f1, kp.xy, valid=kp.valid, win=fc.klt_window,
                  levels=fc.klt_levels, iters=fc.klt_iters, min_eig=fc.klt_min_eig)
    return [args[:4] for args in seen]


def check_level(args, min_eig: float) -> tuple[float, float, int, int]:
    """The level kernel against the plain level on the same inputs; returns
    (max |d guess|, max |d err| off the freeze threshold, keypoints whose
    ok sits at its threshold, keypoints whose LK loop meets a step at the
    freeze threshold)."""
    from epivo_tpu_torch.frontend import klt

    src, tgt, pts, guess, win, margin, iters, eps = args[:8]
    n_chunks = args[-1]
    S = win + 2 * margin + 1
    g_k, ok_k, e_k = klt.track_level_kernel(*args)
    g_p, ok_p, e_p = klt.track_level_composed(*args, use_kernel=False)
    torch.cuda.synchronize()
    _, Ix, Iy, _ = klt._template(src, pts, win, S, use_kernel=False)
    near = ((klt._min_eigenvalue(Ix, Iy) / (win * win) - min_eig).abs()
            <= OK_NEAR_RTOL * min_eig)
    _, closest = level_lk(src, tgt, pts, guess, win, S, max(1, iters // n_chunks), eps)
    at_freeze = (closest <= FREEZE_NEAR_RTOL).reshape(ok_p.shape)
    dg_k = (g_k - g_p).abs().amax(-1)
    de_k = (e_k - e_p).abs()
    top = lambda x, m: float(torch.where(m, x, 0.0).max())
    dg, de = top(dg_k, ~at_freeze), top(de_k, ~at_freeze)
    what = f"level kernel (B={src.shape[0]}, margin={margin}, n_chunks={n_chunks})"
    _check(dg <= LK_Q_ATOL, f"{what}: guess differs by {dg}")
    _check(bool(((de_k <= LK_ERR_ATOL + LK_ERR_RTOL * e_p.abs()) | at_freeze).all()),
           f"{what}: err differs by {de}")
    within = (dg_k <= eps) & (de_k <= LK_ERR_ATOL + FREEZE_ERR_RTOL * e_p.abs())
    _check(bool((within | ~at_freeze).all()),
           f"{what}: at the freeze threshold, guess differs by {top(dg_k, at_freeze)} "
           f"or err by {top(de_k, at_freeze)}")
    _check(bool(((ok_k == ok_p) | near).all()), f"{what}: ok differs off the threshold")
    return dg, de, int(near.sum()), int(at_freeze.sum())


def timed_in_turns(fns: dict, turns: int = 2, **kw) -> dict:
    """cuda_ms of each callable, taken in turns (a, b, c, c, b, a, ...) in one
    process; the mean of each one's medians."""
    times = {k: [] for k in fns}
    order = list(fns)
    for t in range(turns):
        for k in (order if t % 2 == 0 else order[::-1]):
            times[k].append(cuda_ms(fns[k], **kw))
    return {k: float(np.mean(v)) for k, v in times.items()}


def phase_kernels(f0, f1, cfg) -> dict:
    """Each kernel vs its plain version at the main path's shapes, with the
    wrapper's time, the kernel's device time, the bound and the plain and
    library times."""
    from epivo_tpu_torch import _kernels
    from epivo_tpu_torch.frontend import fast, image, klt

    lib = _kernels.lib()
    stream = torch.cuda.current_stream().cuda_stream
    dev = f0.device
    report = {}

    # B1: the dense FAST score + NMS and the fused candidate kernel (score,
    # NMS and the first top-k stage) on both full frames and on a B = 2
    # stack, against nms3(fast_score_map) and block_candidates of it;
    # bit-equal.
    thr = FAST_T
    err = cerr = 0.0
    for img in (f0, f1, torch.stack([f0, f1])):
        p = fast.nms3(fast.fast_score_map(img, thr))
        k = fast.fast_score_map_kernel(img, thr, nms=True)
        pv, pi = fast.block_candidates(p)
        kv, ki = fast.fast_candidates_kernel(img, thr, nms=True)
        torch.cuda.synchronize()
        _check(torch.equal(k, p), f"FAST kernel differs from plain ({tuple(img.shape)})")
        _check(torch.equal(kv, pv) and torch.equal(ki, pi),
               f"FAST candidate kernel differs from plain ({tuple(img.shape)})")
        err = max(err, float((k - p).abs().max()))
        cerr = max(cerr, float((kv - pv).abs().max()))
    work = cand_work(f0[None])
    n_int, n_sides, rounds, nb = (work[k] for k in ("n_int", "n_sides", "rounds", "nb"))
    score_ops = work["score_ops"]
    naive_ops = (H - 6) * (W - 6) * FAST_NAIVE_OPS + H * W * NMS_OPS
    print(f"FAST work on frame 0: {n_int} interior pixels, {n_sides} compass-test "
          f"sides passed ({n_sides / n_int:.4f} per pixel), {nb} blocks, {rounds} "
          f"selection rounds; {score_ops} operations to score "
          f"(naive arc loop and NMS: {naive_ops})")

    out = torch.empty_like(f0)
    dev_ms, how = device_ms(lambda: lib.epivo_fast_score(
        f0.data_ptr(), out.data_ptr(), 1, H, W, thr, 1, stream), "fast_score_kernel")
    b_ms, b_by = bound(2 * H * W * 4, score_ops + H * W * NMS_OPS)
    naive_ms, naive_by = bound(2 * H * W * 4, naive_ops)
    tt = timed_in_turns({
        "kernel": lambda: fast.fast_score_map_kernel(f0, thr, nms=True),
        "plain": lambda: fast.nms3(fast.fast_score_map(f0, thr))}, turns=1)
    print(f"kernel fast: {H}x{W} bit-equal (B=1, B=2), max_abs_err={err}, wrapper "
          f"{tt['kernel']:.4f} ms, device {dev_ms:.4f} ms ({how}), bound {b_ms:.4f} ms "
          f"({b_by}; with the naive op count {naive_ms:.4f} ms, {naive_by}), "
          f"plain {tt['plain']:.4f} ms")
    report["fast"] = dict(max_abs_err=err, ms=tt["kernel"], device_ms=dev_ms,
                          plain_ms=tt["plain"], bound_ms=b_ms, bound_by=b_by,
                          library_ms=None)

    cv = torch.empty((nb, 8), device=dev)
    ci = torch.empty((nb, 8), dtype=torch.int32, device=dev)
    dev_ms, how = device_ms(lambda: lib.epivo_fast_candidates(
        f0.data_ptr(), cv.data_ptr(), ci.data_ptr(), 1, H, W, thr, 1, stream),
        "fast_candidates_kernel")
    cand_bytes, cand_ops = work["nbytes"], work["nops"]
    b_ms, b_by = bound(cand_bytes, cand_ops)
    naive_ms, naive_by = bound(cand_bytes, naive_ops + nb * 8 * SELECT_OPS)
    tt = timed_in_turns({
        "kernel": lambda: fast.fast_candidates_kernel(f0, thr, nms=True),
        "plain": lambda: fast.block_candidates(fast.nms3(fast.fast_score_map(f0, thr)))},
        turns=1)
    print(f"kernel fast_cand: {H}x{W} -> {nb}x8 candidates bit-equal (B=1, B=2), "
          f"max_abs_err={cerr}, wrapper {tt['kernel']:.4f} ms, device {dev_ms:.4f} ms "
          f"({how}), bound {b_ms:.4f} ms ({b_by}; {cand_bytes} bytes, "
          f"{cand_ops} operations; with the naive op count "
          f"and 8 rounds per block {naive_ms:.4f} ms, {naive_by}), "
          f"plain {tt['plain']:.4f} ms")
    report["fast_cand"] = dict(max_abs_err=cerr, ms=tt["kernel"], device_ms=dev_ms,
                               plain_ms=tt["plain"], bound_ms=b_ms, bound_by=b_by,
                               library_ms=None)

    # B2: window extraction at the main path's levels; bit-equal.
    pyr = image.build_pyramid(f0, 4)
    g = torch.Generator().manual_seed(SEED)
    err, rows = 0.0, {}
    for S, lvl in ((46, 3), (34, 0)):
        img = pyr[lvl]
        Hl, Wl = img.shape
        for B in (1, 8):
            imgs = img[None].expand(B, -1, -1).contiguous()
            oy = torch.randint(0, Hl - S + 1, (B, 512), generator=g).to(dev)
            ox = torch.randint(0, Wl - S + 1, (B, 512), generator=g).to(dev)
            rows[(S, B)] = extract_report(imgs, oy, ox, S)
            err = max(err, rows[(S, B)]["max_abs_err"])
    report["extract"] = dict(rows[(34, 1)], max_abs_err=err)

    # B3: LK on the path's own inputs (template at the detected corners,
    # zero-motion guess), at the top level (S=46) and the finest (S=34).
    kp = fast.detect(f0, FAST_T, 512)
    pyr1 = image.build_pyramid(f1, 4)
    err_q = err_e = 0.0
    rows = {}
    for S, lvl in ((46, 3), (34, 0)):
        pts = kp.xy / 2.0 ** lvl
        T, Ix, Iy, c_eff = klt._template(pyr[lvl], pts, 21, S)
        tgt_wins, _, q0 = klt._target(pyr1[lvl], c_eff, 21, S)
        args = (tgt_wins, T, Ix, Iy, q0, 21, 12, 0.01)
        q_k, e_k = klt.lk_iterate_kernel(*args)
        q_p, e_p = klt.lk_iterate_plain(*args)
        torch.cuda.synchronize()
        dq = float((q_k - q_p).abs().max())
        de = float((e_k - e_p).abs().max())
        _check(dq <= LK_Q_ATOL, f"LK kernel q differs by {dq} (S={S})")
        _check(bool(((e_k - e_p).abs() <= LK_ERR_ATOL + LK_ERR_RTOL * e_p.abs()).all()),
               f"LK kernel err differs by {de} (S={S})")
        err_q, err_e = max(err_q, dq), max(err_e, de)
        K, n = q0.shape[0], 21 * 21
        raw = lambda: lib.epivo_lk_iterate(
            tgt_wins.data_ptr(), T.data_ptr(), Ix.data_ptr(), Iy.data_ptr(),
            q0.data_ptr(), q_k.data_ptr(), e_k.data_ptr(), K, S, 21, 12, 0.01,
            S - 21 - 1 - 1e-3, stream)
        dev_ms, how = device_ms(raw, "lk_iterate_kernel")
        steps, _ = lk_steps(*args)
        b_ms, b_by = bound(tgt_wins.numel() * 4 + 3 * K * n * 4 + K * 2 * 4 * 2 + K * 4,
                           K * n * (G_OPS + ERR_OPS) + steps * n * LK_STEP_OPS)
        t_k = cuda_ms(lambda: klt.lk_iterate_kernel(*args))
        t_p = cuda_ms(lambda: klt.lk_iterate_plain(*args), reps=5)
        rows[S] = dict(ms=t_k, device_ms=dev_ms, plain_ms=t_p, bound_ms=b_ms,
                       bound_by=b_by, library_ms=None)
        print(f"kernel lk: S={S} K=512 iters=12 ({steps} keypoint-steps) "
              f"max|dq|={dq:.3g} px max|derr|={de:.3g}, wrapper {t_k:.4f} ms, "
              f"device {dev_ms:.4f} ms ({how}), bound {b_ms:.4f} ms ({b_by}), "
              f"plain {t_p:.4f} ms")
    report["lk"] = dict(max_abs_err=max(err_q, err_e), **rows[34])

    # The level kernel (B2 + B3 fused) on the inputs klt.track gives it at
    # the top level (S=46) and the finest (S=34), against the plain level,
    # timed in turns with the composed level (B2 + torch + B3, the main
    # path before the level kernel) and the plain level.
    fc = cfg.frontend
    win, iters, eps, min_eig = fc.klt_window, fc.klt_iters, 0.01, fc.klt_min_eig
    levels = level_inputs(f0, f1, kp, cfg)
    err_g = err_e = 0.0
    rows = {}
    for S, (src, tgt, pts, guess) in ((46, levels[0]), (34, levels[-1])):
        margin = (S - win - 1) // 2
        args = (src, tgt, pts, guess, win, margin, iters, eps, min_eig, 1)
        dg, de, n_near, n_freeze = check_level(args, min_eig)
        err_g, err_e = max(err_g, dg), max(err_e, de)
        Hl, Wl = src.shape[-2:]
        K = pts.shape[1]
        dev_ms, how = device_ms(
            level_launch(src, tgt, pts, guess, win, S, iters, eps, min_eig),
            "track_level_kernel")
        nbytes, nops, steps = level_work(src, tgt, pts, guess, win, S, iters, eps)
        b_ms, b_by = bound(nbytes, nops)
        t = timed_in_turns({
            "kernel": lambda: klt.track_level_kernel(*args),
            "composed": lambda: klt.track_level_composed(*args, use_kernel=True),
            "plain": lambda: klt.track_level_composed(*args, use_kernel=False)}, reps=10)
        rows[S] = dict(ms=t["kernel"], device_ms=dev_ms, plain_ms=t["plain"],
                       bound_ms=b_ms, bound_by=b_by, library_ms=None)
        print(f"kernel klt_level: S={S} K={K} on {Hl}x{Wl} max|dg|={dg:.3g} px "
              f"max|derr|={de:.3g}, ok at the threshold: {n_near}, at a freeze step: "
              f"{n_freeze}; "
              f"wrapper {t['kernel']:.4f} ms, device {dev_ms:.4f} ms ({how}), "
              f"bound {b_ms:.4f} ms ({b_by}, {steps} keypoint-steps), "
              f"composed B2 + B3 {t['composed']:.4f} ms, plain {t['plain']:.4f} ms")
    # Once with a batch of two pairs and a re-centred second chunk.
    src, tgt, pts, guess = levels[-1]
    args = (torch.cat([src, tgt]), torch.cat([tgt, src]), torch.cat([pts, pts]),
            torch.cat([guess, pts]), win, (34 - win - 1) // 2, iters, eps, min_eig, 2)
    dg, de, n_near, n_freeze = check_level(args, min_eig)
    err_g, err_e = max(err_g, dg), max(err_e, de)
    print(f"kernel klt_level: S=34 B=2 n_chunks=2 max|dg|={dg:.3g} px "
          f"max|derr|={de:.3g}, ok at the threshold: {n_near}, at a freeze step: "
          f"{n_freeze}")
    report["klt_level"] = dict(max_abs_err=max(err_g, err_e), **rows[34])
    return report


def bench_config():
    """The bench configuration (``bench.py``'s), as the runner bench uses it."""
    from epivo_tpu_torch.tools.bench_runner import bench_config as config

    return config()


def _pose_err(T, T_ref):
    T, T_ref = np.asarray(T, np.float64), np.asarray(T_ref, np.float64)
    d = T[:3, 3] / np.linalg.norm(T[:3, 3])
    d_ref = T_ref[:3, 3] / np.linalg.norm(T_ref[:3, 3])
    return float(np.linalg.norm(T[:3, :3] - T_ref[:3, :3])), float(np.linalg.norm(d - d_ref))


def phase_slice(f0, f1, gt, cfg) -> dict:
    from epivo_tpu_torch import ransac
    from epivo_tpu_torch.frontend import fast, klt
    from epivo_tpu_torch.pipeline import vo

    dev = f0.device
    fc = cfg.frontend
    gen = lambda: torch.Generator(device=dev).manual_seed(SEED)

    def step(**kw):
        out = vo.vo_step(f0, f1, gen(), cfg, **kw)
        torch.cuda.synchronize()
        return out

    first = step()  # warm-up: allocator, cuBLAS handles

    n_steps = 5
    reset_launches()
    times, results = [], []
    for _ in range(n_steps):
        t0 = time.perf_counter()
        results.append(step())
        times.append((time.perf_counter() - t0) * 1e3)
    launches = launches_now()
    per_step = {"fast": 0, "fast_cand": 1, "klt_level": fc.klt_levels, "extract": 0,
                "lk": 0}
    _check(launches == {k: v * n_steps for k, v in per_step.items()},
           f"launch counts {launches} != {per_step} per step x {n_steps}")
    for r in results:  # repeat probe: same seed, same answer
        _check(torch.equal(r.T, first.T) and int(r.n_inliers) == int(first.n_inliers),
               "repeated vo_step changed its result")

    T = first.T.cpu().numpy()
    _check(T.shape == (4, 4) and bool(np.isfinite(T).all()), "pose not finite")
    _check(first.points.shape == (512, 3) and bool(torch.isfinite(first.points).all()),
           "points not finite")
    T_gt = np.linalg.inv(np.linalg.inv(gt[0]) @ gt[1])
    r_err, d_err = _pose_err(T, T_gt)
    _check(r_err < GT_R_TOL and d_err < GT_DIR_TOL,
           f"pose vs ground truth: |dR|_F={r_err:.4g}, dir={d_err:.4g}")
    print(f"slice: vo_step {H}x{W} n_tracked={int(first.n_tracked)} "
          f"n_inliers={int(first.n_inliers)} reverted={bool(first.reverted)} "
          f"|R-R_gt|_F={r_err:.4g} dir_err={d_err:.4g} "
          f"median {np.median(times):.2f} ms/step over {n_steps} "
          f"(launches per step: {per_step})")

    def stage_ms(fn, reps: int = 7) -> list:
        return [host_ms(fn) for _ in range(reps)]

    # The detect stage: fast.detect on the kernel path (the fused candidate
    # kernel, then the torch second stage) must make no host sync and give
    # the keypoints of the route before it (the dense kernel, then the torch
    # first stage); then both timed in turns, host clock with a synchronise
    # on each side.
    detect = lambda: fast.detect(f0, fc.fast_threshold, fc.max_keypoints)
    dense_route = lambda: fast.top_k_keypoints(
        fast.fast_score_map_kernel(f0, fc.fast_threshold, nms=True), fc.max_keypoints)
    kp = no_sync(detect)
    kp_dense = dense_route()
    torch.cuda.synchronize()
    _check(all(torch.equal(a, b) for a, b in zip(kp, kp_dense)),
           "detect: the fused route's keypoints differ from the dense route's")
    det = {"fused": [], "dense": []}
    for turn in ("fused", "dense", "dense", "fused"):
        det[turn] += stage_ms(detect if turn == "fused" else dense_route)
    detect_ms = float(np.median(det["fused"]))
    dense_ms = float(np.median(det["dense"]))
    print(f"slice: detect stage (fast.detect) {detect_ms:.3f} ms on the fused kernel "
          f"path, no host sync; {dense_ms:.3f} ms by the dense kernel and the torch "
          f"first stage; same keypoints ({int(kp.valid.sum())} valid); median of "
          f"{len(det['fused'])} each, in turns")

    # The KLT stage: klt.track on the kernel path must make no host sync;
    # then its time, host clock with a synchronise on each side, in turns
    # with the same track running each level as the composed B2 + torch + B3.
    track = lambda: klt.track(f0, f1, kp.xy, valid=kp.valid, win=fc.klt_window,
                              levels=fc.klt_levels, iters=fc.klt_iters,
                              min_eig=fc.klt_min_eig)
    flow = no_sync(track)

    def composed_level(*args, n_chunks, use_kernel):
        return klt.track_level_composed(*args, n_chunks, use_kernel=True)

    stage = {"kernel": [], "composed": []}
    for turn in ("kernel", "composed", "composed", "kernel"):
        if turn == "composed":
            with patched(klt, "_track_level", composed_level):
                stage[turn] += stage_ms(track)
        else:
            stage[turn] += stage_ms(track)
    track_ms = float(np.median(stage["kernel"]))
    composed_ms = float(np.median(stage["composed"]))
    print(f"slice: KLT stage (klt.track) {track_ms:.2f} ms on the kernel path, no host "
          f"sync; {composed_ms:.2f} ms with each level composed of B2 + torch + B3; "
          f"median of "
          f"{len(stage['kernel'])} each, in turns; step {np.median(times):.2f} ms")

    # Kernel path vs plain path on the card, with the same injected samples.
    samples = ransac._sample_indices(gen(), cfg.ransac.hypotheses(),
                                     fc.max_keypoints, flow.status, device=dev)
    r_k = step(ransac_samples=samples)
    t0 = time.perf_counter()
    r_p = step(ransac_samples=samples, use_kernel=False)
    plain_step_ms = (time.perf_counter() - t0) * 1e3
    r_err, d_err = _pose_err(r_k.T.cpu().numpy(), r_p.T.cpu().numpy())
    _check(r_err < STEP_R_TOL and d_err < STEP_DIR_TOL,
           f"kernel vs plain step: |dR|_F={r_err:.4g}, dir={d_err:.4g}")
    print(f"slice: kernel vs plain path, same samples: |dR|_F={r_err:.3g} "
          f"dir={d_err:.3g} n_tracked {int(r_k.n_tracked)}/{int(r_p.n_tracked)} "
          f"n_inliers {int(r_k.n_inliers)}/{int(r_p.n_inliers)}; "
          f"plain step {plain_step_ms:.2f} ms")
    return launches


def phase_degenerate(dev) -> None:
    from epivo_tpu_torch.pipeline import vo

    flat = torch.full((H, W), 90.0, device=dev)
    r = vo.vo_step(flat, flat, torch.Generator(device=dev).manual_seed(SEED),
                   bench_config())
    torch.cuda.synchronize()
    _check(bool(torch.isfinite(r.T).all()), "flat frames gave a non-finite pose")
    print(f"degenerate: flat frames n_tracked={int(r.n_tracked)} "
          f"reverted={bool(r.reverted)} finite pose")


def phase_batched(f0, f1, gt, cfg, n_pairs: int = N_PAIRS) -> dict:
    """vo_step_batched on B copies of the corridor pair, lane b's source
    frame brightened by b * 1e-5 (as bench.py's batched mode does): launch
    counts, host syncs, poses, the plain path, a single step, throughput,
    and fast_cand / klt_level at B."""
    from epivo_tpu_torch import ransac
    from epivo_tpu_torch.frontend import fast, klt
    from epivo_tpu_torch.pipeline import vo

    dev = f0.device
    fc = cfg.frontend
    eps = torch.arange(n_pairs, dtype=f0.dtype, device=dev)[:, None, None] * 1e-5
    img0 = (f0[None] + eps).contiguous()
    img1 = f1[None].expand(n_pairs, -1, -1).contiguous()
    gen = lambda: torch.Generator(device=dev).manual_seed(SEED)
    batched = lambda **kw: vo.vo_step_batched(img0, img1, gen(), cfg, **kw)

    first = batched()  # warm-up
    torch.cuda.synchronize()
    reset_launches()
    res = no_sync(batched)
    torch.cuda.synchronize()
    launches = launches_now()
    per_call = {"fast": 0, "fast_cand": 1, "klt_level": fc.klt_levels, "extract": 0,
                "lk": 0}
    _check(launches == per_call,
           f"batched launch counts {launches} != {per_call} per call")
    _check(torch.equal(res.T, first.T) and torch.equal(res.n_inliers, first.n_inliers),
           "repeated vo_step_batched changed its result")
    _check(res.T.shape == (n_pairs, 4, 4) and bool(torch.isfinite(res.T).all())
           and bool(torch.isfinite(res.points).all()), "batched poses not finite")
    T_gt = np.linalg.inv(np.linalg.inv(gt[0]) @ gt[1])
    gt_errs = [_pose_err(T, T_gt) for T in res.T.cpu().numpy()]
    r_gt, d_gt = max(e[0] for e in gt_errs), max(e[1] for e in gt_errs)
    _check(r_gt < GT_R_TOL and d_gt < GT_DIR_TOL,
           f"batched poses vs ground truth: max |dR|_F={r_gt:.4g}, dir={d_gt:.4g}")

    # The same samples through the kernel path, the plain path and, for
    # lane 0 (the unbrightened pair), a single vo_step.
    kp = fast.detect(img0, fc.fast_threshold, fc.max_keypoints)
    flow = klt.track(img0, img1, kp.xy, valid=kp.valid, win=fc.klt_window,
                     levels=fc.klt_levels, iters=fc.klt_iters, min_eig=fc.klt_min_eig)
    samples = ransac._sample_indices(gen(), cfg.ransac.hypotheses(), fc.max_keypoints,
                                     flow.status, device=dev, lead=(n_pairs,))
    r_k = batched(ransac_samples=samples)
    r_p = batched(ransac_samples=samples, use_kernel=False)
    one = vo.vo_step(f0, f1, None, cfg, ransac_samples=samples[0])
    torch.cuda.synchronize()
    kp_errs = [_pose_err(a, b) for a, b in zip(r_k.T.cpu().numpy(), r_p.T.cpu().numpy())]
    r_kp, d_kp = max(e[0] for e in kp_errs), max(e[1] for e in kp_errs)
    _check(r_kp < STEP_R_TOL and d_kp < STEP_DIR_TOL,
           f"batched kernel vs plain path: max |dR|_F={r_kp:.4g}, dir={d_kp:.4g}")
    r_1, d_1 = _pose_err(r_k.T[0].cpu().numpy(), one.T.cpu().numpy())
    _check(r_1 < STEP_R_TOL and d_1 < STEP_DIR_TOL,
           f"batched lane 0 vs single step: |dR|_F={r_1:.4g}, dir={d_1:.4g}")
    print(f"batched: vo_step_batched B={n_pairs} {H}x{W} launches per call {launches} "
          f"(a single step's), no host sync, repeat probe equal; every lane vs ground "
          f"truth max |R-R_gt|_F={r_gt:.4g} dir_err={d_gt:.4g}; kernel vs plain path, "
          f"same samples, max |dR|_F={r_kp:.3g} dir={d_kp:.3g}; lane 0 vs a single "
          f"vo_step, same samples, |dR|_F={r_1:.3g} dir={d_1:.3g}; n_inliers "
          f"{[int(x) for x in r_k.n_inliers]}")

    # Throughput: batched calls in turns with single steps.
    times = {"batched": [], "single": []}
    single = lambda: vo.vo_step(f0, f1, gen(), cfg)
    for turn in ("batched", "single", "single", "batched"):
        times[turn] += [host_ms(batched if turn == "batched" else single)
                        for _ in range(3)]
    ms_b, ms_1 = float(np.median(times["batched"])), float(np.median(times["single"]))
    pairs_s, single_pairs_s = n_pairs / ms_b * 1e3, 1e3 / ms_1
    print(f"batched: {pairs_s:.2f} pairs/s at B={n_pairs} (median {ms_b:.2f} ms per call "
          f"over {len(times['batched'])}); single step {single_pairs_s:.2f} pairs/s "
          f"(median {ms_1:.2f} ms over {len(times['single'])}); in turns, host clock, "
          f"synchronised")

    # fast_cand and klt_level (top and finest level) at B on the inputs
    # the step gives them.
    win, iters, eps_lk, min_eig = fc.klt_window, fc.klt_iters, 0.01, fc.klt_min_eig
    levels = level_inputs(img0, img1, kp, cfg)
    level = {S: level_report((src, tgt, pts, guess, win, (S - win - 1) // 2, iters, eps_lk,
                              min_eig, 1), f"batched: B={n_pairs}")
             for S, (src, tgt, pts, guess) in ((46, levels[0]), (34, levels[-1]))}
    return dict(
        launches=launches, pairs_s=pairs_s, single_pairs_s=single_pairs_s,
        ms_per_call=ms_b, single_ms=ms_1,
        fast_cand=cand_report(img0, FAST_T, f"batched: B={n_pairs}"), klt_level=level)


def cand_report(imgs, thr: float, what: str) -> dict:
    """The fused candidate kernel on frames [B, H, W] against its plain
    version (bit-equal), with the wrapper's time, the kernel's device time,
    the bound of this data's work and the plain version's time."""
    from epivo_tpu_torch import _kernels
    from epivo_tpu_torch.frontend import fast

    B, Hh, Ww = imgs.shape
    plain = lambda: fast.block_candidates(fast.nms3(fast.fast_score_map(imgs, thr)))
    kv, ki = fast.fast_candidates_kernel(imgs, thr, nms=True)
    pv, pi = plain()
    torch.cuda.synchronize()
    _check(torch.equal(kv, pv) and torch.equal(ki, pi),
           f"FAST candidate kernel differs from plain ({what}, {tuple(imgs.shape)})")
    work = cand_work(imgs, thr)
    lib, stream = _kernels.lib(), torch.cuda.current_stream().cuda_stream
    dev_ms, how = device_ms(lambda: lib.epivo_fast_candidates(
        imgs.data_ptr(), kv.data_ptr(), ki.data_ptr(), B, Hh, Ww, thr, 1, stream),
        "fast_candidates_kernel")
    b_ms, b_by = bound(work["nbytes"], work["nops"])
    tt = timed_in_turns({"kernel": lambda: fast.fast_candidates_kernel(imgs, thr, nms=True),
                         "plain": plain}, turns=1, reps=5, warmup=1)
    print(f"{what}: kernel fast_cand B={B} {Hh}x{Ww} threshold {thr:g} bit-equal, wrapper "
          f"{tt['kernel']:.4f} ms, device {dev_ms:.4f} ms ({how}), bound {b_ms:.4f} ms "
          f"({b_by}; {work['nbytes']} bytes, {work['nops']} operations, {work['rounds']} "
          f"selection rounds), plain {tt['plain']:.4f} ms")
    return dict(max_abs_err=float(torch.where(kv == pv, 0.0, (kv - pv).abs()).max()),
                ms=tt["kernel"], device_ms=dev_ms, plain_ms=tt["plain"], bound_ms=b_ms,
                bound_by=b_by, library_ms=None)


def dense_report(imgs, thr: float, what: str) -> dict:
    """The dense FAST kernel (score and 3x3 NMS) on frames [B, H, W]
    against its plain version (bit-equal), with the wrapper's time, the
    kernel's device time, the bound of this data's work and the plain
    version's time."""
    from epivo_tpu_torch import _kernels
    from epivo_tpu_torch.frontend import fast

    B, Hh, Ww = imgs.shape
    plain = lambda: fast.nms3(fast.fast_score_map(imgs, thr))
    k = fast.fast_score_map_kernel(imgs, thr, nms=True)
    torch.cuda.synchronize()
    _check(torch.equal(k, plain()), f"FAST kernel differs from plain ({what}, "
           f"{tuple(imgs.shape)})")
    lib, stream = _kernels.lib(), torch.cuda.current_stream().cuda_stream
    dev_ms, how = device_ms(lambda: lib.epivo_fast_score(
        imgs.data_ptr(), k.data_ptr(), B, Hh, Ww, thr, 1, stream), "fast_score_kernel")
    b_ms, b_by = bound(2 * B * Hh * Ww * 4, cand_work(imgs, thr)["score_ops"]
                       + B * Hh * Ww * NMS_OPS)
    tt = timed_in_turns({"kernel": lambda: fast.fast_score_map_kernel(imgs, thr, nms=True),
                         "plain": plain}, turns=1, reps=5, warmup=1)
    print(f"{what}: kernel fast (dense) B={B} {Hh}x{Ww} threshold {thr:g} bit-equal, "
          f"wrapper {tt['kernel']:.4f} ms, device {dev_ms:.4f} ms ({how}), bound "
          f"{b_ms:.4f} ms ({b_by}), plain {tt['plain']:.4f} ms")
    return dict(max_abs_err=0.0, ms=tt["kernel"], device_ms=dev_ms, plain_ms=tt["plain"],
                bound_ms=b_ms, bound_by=b_by, library_ms=None)


def level_report(args, what: str) -> dict:
    """The level kernel against the plain level on ``args`` (those of
    klt.track_level_kernel, one chunk), with the wrapper's time, the
    kernel's device time, the bound of this data's work and the plain
    level's time."""
    from epivo_tpu_torch.frontend import klt

    src, tgt, pts, guess, win, margin, iters, eps, min_eig, n_chunks = args
    _check(n_chunks == 1, f"level kernel timed with {n_chunks} chunks")
    S = win + 2 * margin + 1
    dg, de, n_near, n_freeze = check_level(args, min_eig)
    dev_ms, how = device_ms(level_launch(src, tgt, pts, guess, win, S, iters, eps, min_eig),
                            "track_level_kernel")
    nbytes, nops, steps = level_work(src, tgt, pts, guess, win, S, iters, eps)
    b_ms, b_by = bound(nbytes, nops)
    tt = timed_in_turns({
        "kernel": lambda: klt.track_level_kernel(*args),
        "plain": lambda: klt.track_level_composed(*args, use_kernel=False)},
        turns=1, reps=5, warmup=1)
    print(f"{what}: kernel klt_level B={src.shape[0]} S={S} K={pts.shape[1]} on "
          f"{src.shape[1]}x{src.shape[2]} max|dg|={dg:.3g} px max|derr|={de:.3g}, ok at "
          f"the threshold: {n_near}, at a freeze step: {n_freeze}; wrapper "
          f"{tt['kernel']:.4f} ms, device "
          f"{dev_ms:.4f} ms ({how}), bound {b_ms:.4f} ms ({b_by}, {steps} "
          f"keypoint-steps), plain {tt['plain']:.4f} ms")
    return dict(max_abs_err=max(dg, de), ms=tt["kernel"], device_ms=dev_ms,
                plain_ms=tt["plain"], bound_ms=b_ms, bound_by=b_by, library_ms=None,
                max_dg=dg, at_freeze=n_freeze)


def work_counts(fn) -> tuple[dict, int, float, float]:
    """One call of fn() under torch.profiler, after a warm-up call: the
    ATen operators it issues from the host, by name, the device activities
    (kernels, copies) they run, their summed device ms, and the call's host
    wall ms."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    ops, n_device, device_us = {}, 0, 0.0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            n_device += e.count
            device_us += e.device_time_total
        elif e.key.startswith("aten::"):
            ops[e.key] = ops.get(e.key, 0) + e.count
    _check(n_device > 0, "the profiler saw no device activity")
    return ops, n_device, device_us / 1e3, wall_ms


def _rot_dir(T: torch.Tensor):
    T = T.double()
    t = T[..., :3, 3]
    return T[..., :3, :3], t / torch.linalg.norm(t, dim=-1, keepdim=True)


def phase_ba(dev) -> dict:
    """ba_windows on all windows of bench_ba_workload.npz at the bench's BA
    configuration: finite, no host sync, the card against the port's CPU
    path, the same device work at W = 64 and all windows, and windows/s."""
    from epivo_tpu_torch.pipeline import ba, config

    z = np.load(Path(__file__).resolve().parent / "bench_ba_workload.npz")
    spec = ba.mono_window_spec(3)
    _check(np.array_equal(spec.reps, z["reps"]), "workload reps differ from the spec")
    cfg = config.BAConfig(lm=config.LMConfig(n_points=32, max_iters=30,
                                             revert_r_norm=1e-2),
                          window_size=3, stride=2)
    keys = ("T0s", "p", "p_t", "wreps", "pmask")
    cpu = {k: torch.from_numpy(z[k]) for k in keys}
    gpu = {k: v.to(dev) for k, v in cpu.items()}
    n_win = cpu["T0s"].shape[0]

    def run(d, n=None):
        return ba.ba_windows(d["T0s"][:n], spec, d["p"][:n], d["p_t"][:n],
                             wreps=d["wreps"][:n], pmask=d["pmask"][:n], config=cfg)

    run(gpu)  # warm-up
    out = no_sync(lambda: run(gpu))
    torch.cuda.synchronize()
    _check(out.T_opt.shape == (n_win, 2, 4, 4) and bool(torch.isfinite(out.T_opt).all()),
           "BA T_opt not finite")
    ref = run(cpu)

    # Card vs CPU. The energy and the reverted set on every window. Poses
    # and accepted steps at the CPU tests' tolerances on BA_WITHIN of the
    # windows: on the rest rounding alone moves the optimum along a flat
    # valley. The control line below measures that: the CPU against
    # itself with the initial poses perturbed by 1e-7 (about one float32
    # rounding), and the spread of the workload's copies of each window.
    R_c, dir_c = _rot_dir(ref.T_opt)

    def deviations(res):
        R_x, dir_x = _rot_dir(res.T_opt.cpu())
        dR = (R_x - R_c).abs().amax((1, 2, 3))
        ddir = (dir_x - dir_c).abs().amax((1, 2))
        dacc = (res.n_accepted.cpu() - ref.n_accepted).abs()
        within = (dR <= BA_R_TOL) & (ddir <= BA_DIR_TOL) & (dacc <= BA_ACC_TOL)
        return dR, ddir, dacc, within

    dR, ddir, dacc, within = deviations(out)
    g = torch.Generator().manual_seed(SEED)
    jitter = 1e-7 * torch.randn(cpu["T0s"].shape, generator=g)
    *_, within_ctl = deviations(run({**cpu, "T0s": cpu["T0s"] + jitter}))
    n_unique = json.loads(str(z["workload"]))["ba"]["unique_windows"]
    copies = lambda x: x.reshape((n_win // n_unique, n_unique) + x.shape[1:])
    spread = lambda x: float((copies(x) - copies(x)[:1]).abs().max())
    print(f"ba: control on the CPU: initial poses + 1e-7 keep {int(within_ctl.sum())} "
          f"of {n_win} windows within the tolerances; the workload's {n_win // n_unique} "
          f"copies of each window (1e-6 jitter) spread by |dR| {spread(R_c):.3g}, dir "
          f"{spread(dir_c):.3g}")
    r_g, r_c = out.r_norm.cpu(), ref.r_norm
    _check(bool(((r_g - r_c).abs() <= BA_R_ATOL + BA_R_RTOL * r_c.abs()).all()),
           f"BA r_norm card vs CPU: max diff {float((r_g - r_c).abs().max()):.3g}")
    _check(torch.equal(out.reverted.cpu(), ref.reverted), "BA reverted sets differ")
    share = float(within.double().mean())
    _check(share >= BA_WITHIN, f"BA card vs CPU: {share:.4f} of the windows within "
           f"the tolerances (|dR| <= {BA_R_TOL}, dir <= {BA_DIR_TOL}, n_accepted <= "
           f"{BA_ACC_TOL}), fewer than {BA_WITHIN}")
    dT = float((out.T_opt.cpu() - ref.T_opt).abs().max())
    print(f"ba: ba_windows W={n_win} ws=3 N=32 30 iterations, no host sync, finite; "
          f"card vs CPU: reverted equal ({int(ref.reverted.sum())} reverted), max "
          f"|dr_norm| {float((r_g - r_c).abs().max()):.3g} (r_norm up to "
          f"{float(r_c.max()):.3g}); {int(within.sum())} of {n_win} windows within "
          f"the tolerances; median |dR| {float(dR.median()):.3g}, dir "
          f"{float(ddir.median()):.3g}; max |dR| {float(dR.max()):.3g}, dir "
          f"{float(ddir.max()):.3g}, n_accepted {float(dacc.max()):.0f}, |dT_opt| {dT:.3g}")

    # No loop over windows: the same operators at W = 64 and all windows,
    # and as many device activities up to cuBLAS's choice of GEMM / GEMV
    # kernels by shape (and a few between repeats of one call).
    ops_small, dev_small, *_ = work_counts(lambda: run(gpu, 64))
    ops_all, dev_all, *_ = work_counts(lambda: run(gpu))
    n_small, n_all = sum(ops_small.values()), sum(ops_all.values())
    diff = {k: (ops_small.get(k, 0), ops_all.get(k, 0))
            for k in set(ops_small) | set(ops_all) if ops_small.get(k, 0) != ops_all.get(k, 0)}
    _check(not diff, f"BA operators differ between W=64 and W={n_win}: {diff}")
    _check(abs(dev_all - dev_small) <= BA_DEVICE_RTOL * dev_small,
           f"BA device activities: {dev_small} at W=64, {dev_all} at W={n_win}")

    ms = [host_ms(lambda: run(gpu)) for _ in range(7)]
    per_call = float(np.median(ms))
    win_s = n_win / per_call * 1e3
    print(f"ba: {n_all} ATen operators per call at W=64 and W={n_win}, device "
          f"activities {dev_small} and {dev_all}; {win_s:.1f} windows/s, "
          f"{win_s * cfg.lm.max_iters:.1f} LM iterations/s (median {per_call:.2f} ms "
          f"per call over {len(ms)}, host clock, synchronised)")
    return dict(windows_s=win_s, iters_s=win_s * cfg.lm.max_iters, ms_per_call=per_call,
                operators=n_all, device_activities=dev_all, within=int(within.sum()),
                within_control=int(within_ctl.sum()))


def orb_config(cfg, pyramid: bool = False):
    """The bench configuration with the ORB step's pyramid on or off."""
    return dataclasses.replace(cfg, frontend=dataclasses.replace(cfg.frontend,
                                                                 orb_pyramid=pyramid))


@contextlib.contextmanager
def recording(module, name: str, keep=lambda *args: True):
    """Replace ``module.name`` for the duration of the block by a function
    that appends the arguments of each call for which ``keep(*args)``
    holds to the list it yields, then calls the original."""
    seen, fn = [], getattr(module, name)

    def record(*args, **kw):
        if keep(*args):
            seen.append(args)
        return fn(*args, **kw)

    with patched(module, name, record):
        yield seen


def extract_inputs(fn) -> list:
    """The (images, oy, ox, S) of every extraction-kernel launch fn() makes."""
    from epivo_tpu_torch.frontend import klt

    with recording(klt, "extract_windows_kernel") as seen:
        fn()
    return seen


def phase_orb(f0, f1, gt, cfg, n_pairs: int = N_PAIRS) -> dict:
    """The ORB step (vo_step_orb and vo_step_orb_batched) on the corridor
    pair at the bench configuration, the extraction kernel at the ORB
    window, one step on the scale pyramid, and the ORB retry of pair
    extraction on a turn pair."""
    from epivo_tpu_torch import ransac
    from epivo_tpu_torch.frontend import fast
    from epivo_tpu_torch.pipeline import vo

    dev = f0.device
    fc = cfg.frontend
    gen = lambda: torch.Generator(device=dev).manual_seed(SEED)
    T_gt = np.linalg.inv(np.linalg.inv(gt[0]) @ gt[1])
    out = {}

    # Single steps: launches, repeat probe, pose.
    step = lambda c=cfg: vo.vo_step_orb(f0, f1, gen(), c)
    first = step()
    torch.cuda.synchronize()
    n_steps = 3
    reset_launches()
    times, results = [], []
    for _ in range(n_steps):
        t0 = time.perf_counter()
        results.append(step())
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    launches = launches_now()
    per_step = {"fast": 0, "fast_cand": 1, "klt_level": 0, "extract": 1, "lk": 0}
    _check(launches == {k: v * n_steps for k, v in per_step.items()},
           f"ORB launch counts {launches} != {per_step} per step x {n_steps}")
    for r in results:
        _check(torch.equal(r.T, first.T) and torch.equal(r.inlier_mask, first.inlier_mask),
               "repeated vo_step_orb changed its result")
    _check(bool(torch.isfinite(first.T).all()) and int(first.n_tracked) >= 8,
           f"vo_step_orb: {int(first.n_tracked)} matches or a non-finite pose")
    r_err, d_err = _pose_err(first.T.cpu().numpy(), T_gt)
    _check(r_err < ORB_GT_R_TOL and d_err < ORB_GT_DIR_TOL,
           f"ORB pose vs ground truth: |dR|_F={r_err:.4g}, dir={d_err:.4g}")
    print(f"orb: vo_step_orb {H}x{W} matches={int(first.n_tracked)} "
          f"n_inliers={int(first.n_inliers)} reverted={bool(first.reverted)} "
          f"|R-R_gt|_F={r_err:.4g} dir_err={d_err:.4g} median {np.median(times):.2f} ms/step "
          f"over {n_steps} (launches per step: {per_step})")
    out.update(launches_per_step={k: v // n_steps for k, v in launches.items()},
               ms_per_step=float(np.median(times)),
               n_matches=int(first.n_tracked), r_err=r_err, dir_err=d_err)

    # Batched: launches, host syncs, repeat, every lane, kernel vs plain.
    eps = torch.arange(n_pairs, dtype=f0.dtype, device=dev)[:, None, None] * 1e-5
    img0 = (f0[None] + eps).contiguous()
    img1 = f1[None].expand(n_pairs, -1, -1).contiguous()
    batched = lambda **kw: vo.vo_step_orb_batched(img0, img1, gen(), cfg, **kw)
    warm = batched()
    torch.cuda.synchronize()
    reset_launches()
    res = no_sync(batched)
    torch.cuda.synchronize()
    launches_b = launches_now()
    _check(launches_b == per_step, f"batched ORB launches {launches_b} != {per_step}")
    _check(all(torch.equal(a, b) for a, b in zip(res, warm)),
           "repeated vo_step_orb_batched changed its result")
    gt_errs = [_pose_err(T, T_gt) for T in res.T.cpu().numpy()]
    r_gt, d_gt = max(e[0] for e in gt_errs), max(e[1] for e in gt_errs)
    _check(r_gt < ORB_GT_R_TOL and d_gt < ORB_GT_DIR_TOL,
           f"batched ORB poses vs ground truth: max |dR|_F={r_gt:.4g}, dir={d_gt:.4g}")
    _, _, status = vo.orb_associate(img0, img1, cfg)
    samples = ransac._sample_indices(gen(), cfg.ransac.hypotheses(), fc.max_keypoints,
                                     status, device=dev, lead=(n_pairs,))
    r_k = batched(ransac_samples=samples)
    r_p = batched(ransac_samples=samples, use_kernel=False)
    torch.cuda.synchronize()
    _check(torch.equal(r_k.matches_tgt, r_p.matches_tgt)
           and torch.equal(r_k.n_tracked, r_p.n_tracked),
           "ORB kernel path and plain path matched differently")
    kp_errs = [_pose_err(a, b) for a, b in zip(r_k.T.cpu().numpy(), r_p.T.cpu().numpy())]
    r_kp, d_kp = max(e[0] for e in kp_errs), max(e[1] for e in kp_errs)
    _check(r_kp < STEP_R_TOL and d_kp < STEP_DIR_TOL,
           f"ORB kernel vs plain path: max |dR|_F={r_kp:.4g}, dir={d_kp:.4g}")
    times = {"batched": [], "single": []}
    for turn in ("batched", "single", "single", "batched"):
        times[turn] += [host_ms(batched if turn == "batched" else step) for _ in range(2)]
    ms_b, ms_1 = float(np.median(times["batched"])), float(np.median(times["single"]))
    print(f"orb: vo_step_orb_batched B={n_pairs} launches per call {launches_b}, no host "
          f"sync, repeat bit-equal; every lane vs ground truth max |R-R_gt|_F={r_gt:.4g} "
          f"dir_err={d_gt:.4g}; kernel vs plain path, same samples, equal matches, max "
          f"|dR|_F={r_kp:.3g} dir={d_kp:.3g}; {n_pairs / ms_b * 1e3:.2f} pairs/s "
          f"(median {ms_b:.2f} ms per call) against {1e3 / ms_1:.2f} for single steps "
          f"(median {ms_1:.2f} ms), in turns, host clock, synchronised")
    out.update(pairs_s=n_pairs / ms_b * 1e3, single_pairs_s=1e3 / ms_1, ms_per_call=ms_b,
               lanes_r_err=r_gt, lanes_dir_err=d_gt, kernel_vs_plain=[r_kp, d_kp])

    # The port's spread over ORB_DRAWS RANSAC draws: identical lanes of one
    # batched call, each drawing its own samples.
    a, b = (f[None].expand(ORB_DRAWS, -1, -1).contiguous() for f in (f0, f1))
    draws = vo.vo_step_orb_batched(a, b, gen(), cfg)
    errs = np.array([_pose_err(T, T_gt) for T in draws.T.cpu().numpy()])
    med, worst = np.median(errs, 0), errs.max(0)
    above = int((errs > np.array(ORB_REF_WORST)).any(1).sum())
    print(f"orb: {ORB_DRAWS} RANSAC draws on the pair: |R-R_gt|_F median {med[0]:.4g}, "
          f"90th percentile {np.quantile(errs[:, 0], 0.9):.4g}, worst {worst[0]:.4g}; "
          f"dir_err median {med[1]:.4g}, 90th percentile {np.quantile(errs[:, 1], 0.9):.4g}, "
          f"worst {worst[1]:.4g}; {above} of {ORB_DRAWS} beyond the JAX package's worst "
          f"over RANSAC seeds 0-43 ({ORB_REF_WORST[0]} / {ORB_REF_WORST[1]}; median "
          f"{ORB_REF_MEDIAN[0]} / {ORB_REF_MEDIAN[1]})")
    _check(bool((med <= ORB_MEDIAN_GAIN * np.array(ORB_REF_MEDIAN)).all()),
           f"ORB pose over {ORB_DRAWS} draws: median {med[0]:.4g} / {med[1]:.4g} against "
           f"{ORB_MEDIAN_GAIN} x the JAX package's {ORB_REF_MEDIAN}")
    out["draws"] = dict(n=ORB_DRAWS, r_median=float(med[0]), dir_median=float(med[1]),
                        r_p90=float(np.quantile(errs[:, 0], 0.9)),
                        dir_p90=float(np.quantile(errs[:, 1], 0.9)),
                        r_worst=float(worst[0]), dir_worst=float(worst[1]),
                        beyond_reference_worst=above)

    # The extraction kernel at the ORB window, on the inputs describe gives
    # it: the two frames of one step and the 16 of a batched call.
    rows = {}
    for label, fn in (("B2", lambda: vo.orb_associate(f0[None], f1[None], cfg)),
                      ("B16", lambda: vo.orb_associate(img0, img1, cfg))):
        (imgs, oy, ox, S), = extract_inputs(fn)
        _check(S == 37 and imgs.shape[0] == int(label[1:]),
               f"ORB extraction at S={S}, B={imgs.shape[0]}")
        rows[f"S37_{label}"] = extract_report(imgs, oy, ox, S, " (ORB describe)")
    out["extract"] = rows

    # One step on the 8-level scale pyramid; the warm-up step records the
    # dense FAST kernel's inputs (levels 6-7, below 65,536 pixels).
    cfg_p = orb_config(cfg, pyramid=True)
    with recording(fast, "fast_score_map_kernel") as dense:
        step(cfg_p)
    torch.cuda.synchronize()
    stacks = [(img.reshape(-1, *img.shape[-2:]), thr) for img, thr, *_ in dense]
    out["fast_dense"] = {f"{img.shape[1]}x{img.shape[2]}_B{img.shape[0]}": dense_report(
        img, thr, "orb: pyramid step") for img, thr in stacks}
    reset_launches()
    t0 = time.perf_counter()
    r_pyr = step(cfg_p)
    torch.cuda.synchronize()
    pyr_ms = (time.perf_counter() - t0) * 1e3
    launches_p = launches_now()
    per_pyr = {"fast": 2, "fast_cand": 6, "klt_level": 0, "extract": 8, "lk": 0}
    _check(launches_p == per_pyr, f"pyramid ORB launches {launches_p} != {per_pyr}")
    r_err, d_err = _pose_err(r_pyr.T.cpu().numpy(), T_gt)
    _check(bool(torch.isfinite(r_pyr.T).all()) and r_err < PYR_GT_R_TOL
           and d_err < PYR_GT_DIR_TOL,
           f"pyramid ORB pose vs ground truth: |dR|_F={r_err:.4g}, dir={d_err:.4g}")
    print(f"orb: pyramid step (8 levels, scale 1.2) launches {launches_p}, "
          f"matches={int(r_pyr.n_tracked)} n_inliers={int(r_pyr.n_inliers)} "
          f"|R-R_gt|_F={r_err:.4g} dir_err={d_err:.4g}, {pyr_ms:.2f} ms")
    out.update(pyramid=dict(launches_per_step=launches_p, ms=pyr_ms, r_err=r_err,
                            dir_err=d_err, n_matches=int(r_pyr.n_tracked)))
    out["turn"] = turn_pair(dev)
    return out


def turn_pair(dev) -> dict:
    """The ORB retry of _extract_pairs on tests/test_runners_datasets.py's
    turn pair (loop_trajectory frames 80 -> 81, 188x1241): KLT alone
    under-rotates in some RANSAC draws, the retry recovers the rotation
    with more inliers."""
    from epivo_tpu_torch.datasets import photoreal
    from epivo_tpu_torch.geometry.camera import Pinhole
    from epivo_tpu_torch.pipeline import runners, stream, vo
    from epivo_tpu_torch.pipeline.config import (
        FrontendConfig, LMConfig, RansacConfig, VOConfig,
    )

    Ht, f, k0 = 188, 718.856, 80
    K = np.array([[f, 0, W / 2.0], [0, f, Ht / 2.0], [0, 0, 1.0]])
    gt = photoreal.loop_trajectory()
    scene = photoreal.CorridorScene()
    tex = scene.textures()
    rng = np.random.default_rng(7)
    frames = [photoreal.render_frame(scene, tex, K, gt[k], Ht, W, noise_sigma=2.0, rng=rng)
              for k in (k0, k0 + 1)]
    base = VOConfig(camera=Pinhole(f, f, W / 2.0, Ht / 2.0, W, Ht),
                    frontend=FrontendConfig(fast_threshold=12.0, max_keypoints=256,
                                            klt_levels=4),
                    ransac=RansacConfig(n_hyp=256), lm=LMConfig(n_points=32))
    off = dataclasses.replace(base, frontend=dataclasses.replace(base.frontend,
                                                                 orb_fallback_frac=0.0))
    angle = lambda R: float(np.degrees(np.arccos(np.clip((np.trace(R[:3, :3]) - 1) / 2,
                                                         -1, 1))))
    a_gt = angle(np.linalg.inv(gt[k0 + 1]) @ gt[k0])
    got = {}
    for name, c in (("off", off), ("on", base)):
        stats = {}
        reset_launches()
        pd = runners._extract_pairs(stream.FrameStream(list(frames)), [(0, 1)], c, 0,
                                    n_points=32, batch=2, device=dev, stats=stats)
        got[name] = dict(angle=angle(pd[(0, 1)]["T"]), n_inl=pd[(0, 1)]["n_inl"],
                         launches=launches_now(), **stats)
    a_off, a_on = got["off"]["angle"], got["on"]["angle"]
    n_off, n_on = got["off"]["n_inl"], got["on"]["n_inl"]
    print(f"orb: turn pair 188x1241 (true rotation {a_gt:.3f} deg), seed 0: KLT alone "
          f"{a_off:.3f} deg, {n_off} inliers; with the ORB retry {a_on:.3f} deg, {n_on} "
          f"inliers (retried {got['on']['n_retried']}, replaced {got['on']['n_replaced']}, "
          f"launches {got['on']['launches']})")
    _check(abs(a_on - a_gt) < TURN_ORB_RTOL * a_gt,
           f"turn pair: the ORB retry gives {a_on:.3f} deg against {a_gt:.3f}")
    _check(n_on > TURN_INLIER_GAIN * n_off,
           f"turn pair: {n_on} inliers with the retry against {n_off} without")
    _check(got["on"]["n_replaced"] == 1 and got["on"]["launches"]["extract"] == 1,
           f"turn pair: the retry did not replace the pair through the kernels "
           f"({got['on']})")

    # Many draws: KLT on the frames, ORB on their uint8 rounding (what the
    # retry pass sees), one batched call each.
    stack = lambda f: torch.from_numpy(f).to(dev)[None].expand(TURN_DRAWS, -1, -1).contiguous()
    src, tgt = stack(frames[0]), stack(frames[1])
    gen = torch.Generator(device=dev).manual_seed(SEED)
    r8 = lambda x: torch.round(x).clamp(0, 255)
    k = vo.vo_step_batched(src, tgt, gen, off)
    o = vo.vo_step_orb_batched(r8(src), r8(tgt), gen, base)
    a_k = [angle(T) for T in k.T.cpu().numpy()]
    a_o = [angle(T) for T in o.T.cpu().numpy()]
    n_k, n_o = k.n_inliers.cpu().numpy(), o.n_inliers.cpu().numpy()
    under = sum(a < TURN_KLT_MAX * a_gt for a in a_k)
    err_o = float(np.median(np.abs(np.array(a_o) - a_gt)))
    print(f"orb: turn pair over {TURN_DRAWS} draws: KLT alone {under} under "
          f"{TURN_KLT_MAX} x the true angle (angles {min(a_k):.3f}-{max(a_k):.3f} deg, median "
          f"{np.median(a_k):.3f}, median inliers {np.median(n_k):.1f}); ORB median error "
          f"{err_o:.3f} deg (angles {min(a_o):.3f}-{max(a_o):.3f}), median inliers "
          f"{np.median(n_o):.1f}")
    _check(under >= 1, f"turn pair: KLT alone never under {TURN_KLT_MAX} x {a_gt:.3f} deg "
           f"over {TURN_DRAWS} draws ({a_k})")
    _check(err_o < TURN_ORB_RTOL * a_gt, f"turn pair: ORB median error {err_o:.3f} deg")
    _check(np.median(n_o) > TURN_INLIER_GAIN * np.median(n_k),
           f"turn pair: median inliers ORB {np.median(n_o)} against KLT {np.median(n_k)}")
    return dict(true_deg=a_gt, **got, draws=dict(
        klt_under=int(under), klt_deg=[min(a_k), float(np.median(a_k)), max(a_k)],
        orb_median_err_deg=err_o, klt_median_inliers=float(np.median(n_k)),
        orb_median_inliers=float(np.median(n_o))))


def phase_sequence(dev) -> dict:
    """The 300-frame corridor through both sequence runners: VO with the
    ground-truth scale, and windowed BA with no ground truth at SEQ_SEEDS,
    held to the JAX package's own CPU realizations (SEQ_* above); the scale
    graph on the card against the CPU on the same pairs. Returns (the
    phase's numbers, the kernel rows at the sequence's shapes, and (ground
    truth, trajectory length, [(seed, the no-GT runner's result)], the
    frames) for phases 12 and 13)."""
    from epivo_tpu_torch.pipeline import scale
    from epivo_tpu_torch.tools import photoreal_ate

    t0 = time.perf_counter()
    frames, gt, _, length = photoreal_ate.render_corridor(
        SEQ_FRAMES, workers=max(1, min(8, os.cpu_count() or 1)))
    render_s = time.perf_counter() - t0
    print(f"sequence: rendered {len(frames)} frames {H}x{W} in {render_s:.1f} s "
          f"(trajectory {length:.2f} m)")
    vo_run = photoreal_ate.vo_gt_scale(frames, gt, length, batch=SEQ_BATCH, device=dev)
    print(f"sequence: run_vo_sequence with the ground-truth scale: ATE "
          f"{vo_run['ate_rmse_m']:.4f} m = {vo_run['ate_pct_of_length']:.3f} % of the length, "
          f"mean inliers {vo_run['inliers_mean']:.1f}, reverted {vo_run['reverted_frames']}, "
          f"{vo_run['wall_s']:.1f} s")
    _check(vo_run["ate_pct_of_length"] <= SEQ_VO_ATE_PCT,
           f"VO sequence ATE {vo_run['ate_pct_of_length']:.3f} % > {SEQ_VO_ATE_PCT} %")

    runs, results, launches, pair_data, recorded = [], [], None, None, None
    for seed in SEQ_SEEDS:
        reset_launches()
        with (sequence_recording() if launches is None
              else contextlib.nullcontext()) as rec:
            run, res = photoreal_ate.ba_no_gt(frames, gt, length, seed=seed,
                                              batch=SEQ_BATCH, device=dev)
        if launches is None:
            launches, pair_data, recorded = launches_now(), res.pair_data, rec
        results.append((seed, res))
        st, acc = run["stats"], run["pairs"]["all"]
        print(f"sequence: run_ba_sequence, no ground truth, seed {seed}: Sim(3) ATE "
              f"{run['ate_sim3_rmse_m']:.4f} m = {run['ate_sim3_pct_of_length']:.3f} % of the "
              f"length, length ratio (gauge on step 0) {run['length_ratio_gauge0']:.4f}; "
              f"{st['n_pairs']} pairs extracted, {st['n_retried']} retried by ORB, "
              f"{st['n_replaced']} replaced; pairs vs ground truth: median direction error "
              f"{acc['dir_median']:.4f}, {acc['flipped']} flipped, median |dR|_F "
              f"{acc['rot_median']:.4f}; {st['n_measurements']} scale-graph measurements; "
              f"{run['windows_total']} windows, {run['windows_reverted']} reverted")
        print(f"sequence: seed {seed} wall: extraction {st['extract_s']:.1f} s "
              f"({st['n_pairs'] / st['extract_s']:.2f} pairs/s), ORB retry "
              f"{st['orb_retry_s']:.1f} s, scale graph {st['scale_graph_s']:.2f} s, window "
              f"solve {st['solve_s']:.2f} s, run_ba_sequence total {st['total_s']:.1f} s")
        _check(run["windows_reverted"] == 0, f"seed {seed}: {run['windows_reverted']} windows "
               f"reverted")
        runs.append(run)
    print(f"sequence: launches in the seed-{SEQ_SEEDS[0]} run {launches}")
    _check(launches["fast_cand"] > 0 and launches["klt_level"] > 0
           and (runs[0]["stats"]["n_retried"] == 0 or launches["extract"] > 0),
           f"the sequence did not run through the kernels: {launches}")
    kernels = sequence_kernels(recorded)
    del recorded

    pair_dir = float(np.median([r["pairs"]["all"]["dir_median"] for r in runs]))
    flipped = float(np.median([r["pairs"]["all"]["flipped"] for r in runs]))
    print(f"sequence: the pairs over seeds {list(SEQ_SEEDS)}: median direction error "
          f"{pair_dir:.4f} (limit {SEQ_PAIR_DIR}), flipped {flipped:.0f} (limit "
          f"{SEQ_PAIR_FLIPPED}), medians over the seeds")
    _check(pair_dir <= SEQ_PAIR_DIR and flipped <= SEQ_PAIR_FLIPPED,
           f"the pairs' median direction error {pair_dir:.4f} (limit {SEQ_PAIR_DIR}) or "
           f"{flipped:.0f} flipped (limit {SEQ_PAIR_FLIPPED}), medians over the seeds")

    # The scale graph on the card against the CPU, on the same pairs.
    cfg_s = photoreal_ate.configs()[1].scale
    n_zeta = SEQ_FRAMES - 1
    m_dev = scale.scale_graph_measurements(pair_data, n_zeta, cfg_s, device=dev)
    m_cpu = scale.scale_graph_measurements(pair_data, n_zeta, cfg_s, device="cpu")
    _check([(m.b, m.kind) for m in m_dev] == [(m.b, m.kind) for m in m_cpu],
           "scale graph: the card and the CPU keep different measurements")
    dv = max(abs(a.value - b.value) for a, b in zip(m_dev, m_cpu))
    c_dev = scale.scale_graph_solve(m_dev, n_zeta, cfg_s)
    c_cpu = scale.scale_graph_solve(m_cpu, n_zeta, cfg_s)
    dc = float(np.max(np.abs(np.log(c_dev / c_cpu))))
    print(f"sequence: scale graph on the card vs the CPU, seed-{SEQ_SEEDS[0]} pairs: "
          f"{len(m_dev)} measurements alike, max |d log-ratio| {dv:.3g}, max |d log c| {dc:.3g}")
    _check(dv <= SEQ_GRAPH_ATOL and dc <= SEQ_GRAPH_ATOL,
           f"scale graph card vs CPU: {dv:.3g} / {dc:.3g} > {SEQ_GRAPH_ATOL}")

    ates = [r["ate_sim3_pct_of_length"] for r in runs]
    ratios = [r["length_ratio_gauge0"] for r in runs]
    med_ate, med_ratio = float(np.median(ates)), float(np.median(ratios))
    print(f"sequence: no-GT over seeds {list(SEQ_SEEDS)}: Sim(3) ATE "
          f"{', '.join(f'{a:.3f}' for a in ates)} % (median {med_ate:.3f}), length ratio "
          f"{', '.join(f'{r:.4f}' for r in ratios)} (median {med_ratio:.4f}); limits: median "
          f"ATE <= {SEQ_BA_ATE_PCT:.3f} %, median ratio in [{SEQ_RATIO[0]:.3f}, "
          f"{SEQ_RATIO[1]:.3f}]")
    _check(med_ate <= SEQ_BA_ATE_PCT, f"no-GT median Sim(3) ATE {med_ate:.3f} % > "
           f"{SEQ_BA_ATE_PCT} %")
    _check(SEQ_RATIO[0] <= med_ratio <= SEQ_RATIO[1],
           f"no-GT median length ratio {med_ratio:.4f} outside {SEQ_RATIO}")
    for r in runs:
        r["stats"] = {k: r["stats"][k] for k in ("n_pairs", "n_retried", "n_replaced",
                                                 "extract_s", "solve_s", "total_s")}
    st = runs[0]["stats"]
    return dict(render_s=render_s, length_m=length, vo=vo_run, ba=runs, launches=launches,
                pairs_s=st["n_pairs"] / st["extract_s"], median_ate_pct=med_ate,
                median_ratio=med_ratio, median_pair_dir=pair_dir, median_flipped=flipped,
                graph_card_vs_cpu=[dv, dc]), kernels, (gt, length, results, frames)


@contextlib.contextmanager
def sequence_recording(batch: int = SEQ_BATCH):
    """Record, during one sequence run, the arguments of the launches
    whose shapes phases 9 and 10 add to the kernel checks: the first
    fast_cand launch of a full extraction batch (``batch`` pairs) and that
    batch's klt_level launches (one per level), and the first fast_cand
    and extraction launches of the ORB retry pass. Yields
    {(pass, kernel[, level height]): args}."""
    from epivo_tpu_torch.frontend import fast, klt
    from epivo_tpu_torch.pipeline import vo

    rec, retry, orb_step = {}, [], vo.vo_step_orb_batched

    def in_retry(*args, **kw):
        retry.append(True)
        return orb_step(*args, **kw)

    def first(module, name, key):
        fn = getattr(module, name)

        def record(*args, **kw):
            k = key(args[0])
            if k is not None:
                rec.setdefault(k, args)
            return fn(*args, **kw)

        return patched(module, name, record)

    full = lambda x: not retry and x.shape[0] == batch
    with contextlib.ExitStack() as stack:
        for cm in (patched(vo, "vo_step_orb_batched", in_retry),
                   first(fast, "fast_candidates_kernel",
                         lambda img: ("retry", "fast_cand") if retry
                         else ("batch", "fast_cand") if full(img) else None),
                   first(klt, "track_level_kernel",
                         lambda src: ("batch", "klt_level", src.shape[-2]) if full(src)
                         else None),
                   first(klt, "extract_windows_kernel",
                         lambda img: ("retry", "extract") if retry else None)):
            stack.enter_context(cm)
        yield rec


def sequence_kernels(rec: dict, phase: str = "sequence", retry_required: bool = True) -> dict:
    """fast_cand, klt_level (top and finest level) and the extraction
    kernel against their plain versions on the inputs a sequence run gave
    them (sequence_recording), with device time and bound. The ORB retry
    batch's rows need a retry pass: required unless ``retry_required`` is
    false, then checked where the run made one."""
    levels = sorted(((k[2], v) for k, v in rec.items() if k[1] == "klt_level"),
                    key=lambda kv: kv[0])
    retried = ("retry", "fast_cand") in rec
    need = [("batch", "fast_cand")]
    if retried or retry_required:
        need += [("retry", "fast_cand"), ("retry", "extract")]
    _check(all(k in rec for k in need) and len(levels) >= 2,
           f"{phase} recorded launches {sorted(rec)}: a full extraction batch"
           f"{' and an ORB retry batch' if retry_required else ''} expected")
    out = {"fast_cand": {}, "klt_level": {}, "extract": {}}
    for k, what in ((("batch", "fast_cand"), "extraction batch"),
                    (("retry", "fast_cand"), "ORB retry batch")):
        if k not in rec:
            continue
        img, thr = rec[k][:2]
        out["fast_cand"][f"{k[0]}_B{img.shape[0]}"] = cand_report(
            img, thr, f"{phase}: {what}")
    for _, args in (levels[0], levels[-1]):
        win, margin = args[4:6]
        out["klt_level"][f"S{win + 2 * margin + 1}_B{args[0].shape[0]}"] = level_report(
            args, f"{phase}: extraction batch")
    if ("retry", "extract") in rec:
        imgs, oy, ox, S = rec["retry", "extract"]
        out["extract"][f"S{S}_B{imgs.shape[0]}"] = extract_report(
            imgs, oy, ox, S, f" ({phase}: ORB retry batch)")
    return out


def stereo_frames(n_frames: int):
    """Both cameras' frames of the stereo corridor, rendered in up to 8
    worker processes; the first two of each camera checked bit-equal
    against corridor_stereo_sequence's generators. Returns (left, right,
    K, T_rig, trajectory length)."""
    import multiprocessing

    from epivo_tpu_torch.datasets import photoreal
    from epivo_tpu_torch.tools import photoreal_stereo as ps

    gt, K, T_rig, length = ps.stereo_fixture(n_frames)
    with multiprocessing.get_context("spawn").Pool(max(1, min(8, os.cpu_count() or 1))) as pool:
        L, R = (list(ps.camera_frames(gt, K, H, W, right, pool, chunk=n_frames))
                for right in (False, True))
    gen_l, gen_r, *_ = photoreal.corridor_stereo_sequence(2, H=H, W=W, seed=ps.FIXTURE_SEED)
    for k, (a, b) in enumerate(zip(gen_l, gen_r)):
        _check(np.array_equal(L[k], a) and np.array_equal(R[k], b),
               f"stereo frame {k} differs from the generator's")
    return L, R, K, T_rig, length


def phase_stereo(dev) -> tuple[dict, dict, tuple]:
    """The stereo corridor (STEREO_FRAMES per camera) through
    run_stereo_ba_sequence at STEREO_SEEDS, held to the JAX package's own
    CPU runs (STEREO_* above); the metric scale on the card against the
    CPU on seed 0's pairs, its depth step free of host syncs; and the
    kernels against their plain versions on seed 0's first extraction
    batch (which holds rig pairs) and, if one ran, its first ORB retry
    batch. Returns (the phase's numbers, the kernel rows, and the first
    ENTRY_STEREO_FRAMES frames of each camera with their ground truth, K
    and T_rig for phase 14)."""
    from epivo_tpu_torch.geometry.camera import Pinhole
    from epivo_tpu_torch.pipeline import runners
    from epivo_tpu_torch.tools import photoreal_stereo as ps

    t0 = time.perf_counter()
    L, R, K, T_rig, length = stereo_frames(STEREO_FRAMES)
    render_s = time.perf_counter() - t0
    print(f"stereo: rendered {len(L)} + {len(R)} frames {H}x{W} in {render_s:.1f} s "
          f"(trajectory {length:.2f} m, baseline {ps.BASELINE} m), bit-equal on frames 0-1")
    runs, launches, res0, recorded = [], [], None, None
    for seed in STEREO_SEEDS:
        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        with (sequence_recording(STEREO_BATCH) if res0 is None
              else contextlib.nullcontext()) as rec:
            run, res = ps.run_seed(STEREO_FRAMES, seed, batch=STEREO_BATCH, frames=(L, R),
                                   device=dev)
        launches.append(launches_now())
        run["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
        if res0 is None:
            res0, recorded = res, rec
        st = run["stats"]
        print(f"stereo: seed {seed}: metric ATE {run['ate_metric_rmse_m']:.4f} m = "
              f"{run['ate_pct_of_length']:.3f} % of the length, length ratio "
              f"{run['length_ratio']:.4f}, step-length error median "
              f"{run['step_err_median']:.4f} (worst {run['step_err_max']:.4f}); "
              f"{st['n_pairs']} pairs, {st['n_retried']} retried by ORB "
              f"({run['n_retried_rig']} rig pairs), {st['n_replaced']} replaced; "
              f"{st['n_refined']} of {st['n_scale_steps']} steps refined, "
              f"{st['n_hampel']} Hampel replacements; {run['windows_total']} windows, "
              f"{run['windows_reverted']} reverted; launches {launches[-1]}")
        print(f"stereo: seed {seed} wall: extraction {st['extract_s']:.1f} s "
              f"({st['n_pairs'] / st['extract_s']:.2f} pairs/s), ORB retry "
              f"{st['orb_retry_s']:.1f} s, metric scale {st['scale_s']:.2f} s, window solve "
              f"{st['solve_s']:.2f} s, post-LM rescale {st['rescale_s']:.2f} s, "
              f"run_stereo_ba_sequence total {st['total_s']:.1f} s; peak_buffered "
              f"{st['peak_buffered']} frames, max_memory_allocated "
              f"{run['max_memory_allocated_gb']:.3f} GB")
        _check(run["windows_reverted"] == 0, f"stereo seed {seed}: "
               f"{run['windows_reverted']} windows reverted")
        _check(run["step_err_median"] <= STEREO_STEP_ERR,
               f"stereo seed {seed}: median step-length error {run['step_err_median']:.4f} "
               f"> {STEREO_STEP_ERR:.4f}")
        runs.append(run)
    l0 = launches[0]
    _check(l0["fast_cand"] > 0 and l0["klt_level"] > 0
           and (runs[0]["stats"]["n_retried"] == 0 or l0["extract"] > 0),
           f"the stereo run did not go through the kernels: {l0}")
    first = sorted(res0.pair_data)[:STEREO_BATCH]
    n_rig = sum(1 for i, j in first if i % 2 == 0 and j == i + 1)
    _check(n_rig > 0, f"the first extraction batch {first} holds no rig pair")
    print(f"stereo: seed-{STEREO_SEEDS[0]} kernels on its first extraction batch {first} "
          f"({n_rig} rig pairs)" + (" and its first ORB retry batch"
                                   if ("retry", "fast_cand") in recorded else ""))
    kernels = sequence_kernels(recorded, "stereo", retry_required=False)
    del recorded

    # The metric scale on the card against the CPU, on seed 0's pairs.
    cfg = ps.configs(Pinhole.from_K(K, W, H))
    s_dev = runners.stereo_step_scales(res0.pair_data, STEREO_FRAMES, T_rig, cfg, device=dev)
    s_cpu = runners.stereo_step_scales(res0.pair_data, STEREO_FRAMES, T_rig, cfg, device="cpu")
    dmax = 0.0
    for name in ("s0", "s0_clean", "s_refined", "scale"):
        a, b = getattr(s_dev, name), getattr(s_cpu, name)
        _check(np.array_equal(np.isnan(a), np.isnan(b)),
               f"stereo scales card vs CPU: {name} missing on other steps")
        fin = ~np.isnan(a)
        dmax = max(dmax, float(np.max(np.abs(a[fin] / b[fin] - 1.0), initial=0.0)))
    reps = [tuple(int(getattr(s, r).sum()) for s in (s_dev, s_cpu))
            for r in ("replaced0", "replaced1")]
    d = no_sync(lambda: runners._stereo_depths(s_dev.rows, T_rig, dev))
    _check(bool(torch.isfinite(d).all()), "stereo depths not finite")
    print(f"stereo: metric scale on the card vs the CPU, seed-{STEREO_SEEDS[0]} pairs: "
          f"{len(s_dev.ks)} steps, both passes max relative difference {dmax:.3g} (limit "
          f"{STEREO_SCALE_RTOL}), Hampel replacements {reps[0]} / {reps[1]} (pass 1 / 2, "
          f"card, CPU); the depth step ({d.shape[1]} steps x {d.shape[2]} points, one "
          f"call) makes no host sync")
    _check(dmax <= STEREO_SCALE_RTOL, f"stereo scales card vs CPU differ by {dmax:.3g}")
    _check(all(a == b for a, b in reps), f"stereo Hampel replacements differ: {reps}")

    ates = [r["ate_pct_of_length"] for r in runs]
    ratios = [r["length_ratio"] for r in runs]
    med_ate, med_ratio = float(np.median(ates)), float(np.median(ratios))
    print(f"stereo: over seeds {list(STEREO_SEEDS)}: metric ATE "
          f"{', '.join(f'{a:.3f}' for a in ates)} % (median {med_ate:.3f}), length ratio "
          f"{', '.join(f'{r:.4f}' for r in ratios)} (median {med_ratio:.4f}); limits: median "
          f"ATE <= {STEREO_ATE_PCT:.3f} %, |median ratio - 1| <= {STEREO_RATIO_DEV:.4f}, "
          f"median step error per seed <= {STEREO_STEP_ERR:.4f}")
    _check(med_ate <= STEREO_ATE_PCT, f"stereo median metric ATE {med_ate:.3f} % > "
           f"{STEREO_ATE_PCT:.3f} %")
    _check(abs(med_ratio - 1.0) <= STEREO_RATIO_DEV,
           f"stereo median length ratio {med_ratio:.4f}: |ratio - 1| > {STEREO_RATIO_DEV:.4f}")
    gt = ps.stereo_fixture(STEREO_FRAMES)[0]
    keep = (L[:ENTRY_STEREO_FRAMES], R[:ENTRY_STEREO_FRAMES], gt[:ENTRY_STEREO_FRAMES], K, T_rig)
    return dict(render_s=render_s, length_m=length, runs=runs, launches=launches,
                median_ate_pct=med_ate, median_ratio=med_ratio,
                scale_card_vs_cpu=dmax, hampel=reps), kernels, keep


@contextlib.contextmanager
def loop_recording():
    """Record, during one run with loop closure on, the launch counts of
    the loop stage, of its describe call and of each verification call
    (loopclose._vo_pairs), and the first inputs per shape that the
    describe call gives fast_cand, the dense FAST kernel and the
    extraction kernel. Yields {"stage": counts, "describe": counts,
    "pairs": [counts per call], "inputs": {(kernel, H, W): args}}."""
    from epivo_tpu_torch.frontend import fast, klt
    from epivo_tpu_torch.pipeline import loopclose, runners

    rec = {"pairs": [], "inputs": {}}
    in_describe = []

    def counted(module, name, key, keep_inputs=False):
        fn = getattr(module, name)

        def run(*args, **kw):
            before = launches_now()
            if keep_inputs:
                in_describe.append(True)
            try:
                out = fn(*args, **kw)
            finally:
                if keep_inputs:
                    in_describe.pop()
            diff = {k: v - before[k] for k, v in launches_now().items()}
            if key == "pairs":
                rec["pairs"].append(diff)
            else:
                rec[key] = diff
            return out

        return patched(module, name, run)

    def first_input(module, name, kernel):
        fn = getattr(module, name)

        def run(*args, **kw):
            if in_describe:
                rec["inputs"].setdefault((kernel, *args[0].shape[-2:]), args)
            return fn(*args, **kw)

        return patched(module, name, run)

    with contextlib.ExitStack() as stack:
        for cm in (counted(runners, "_loop_stage", "stage"),
                   counted(loopclose, "_describe_batch", "describe", keep_inputs=True),
                   counted(loopclose, "_vo_pairs", "pairs"),
                   first_input(fast, "fast_candidates_kernel", "fast_cand"),
                   first_input(fast, "fast_score_map_kernel", "fast"),
                   first_input(klt, "extract_windows_kernel", "extract")):
            stack.enter_context(cm)
        yield rec


def loop_verify_card_vs_cpu(loops, store, est, vo_half, dev) -> list:
    """verify_loop on the card and on the port's CPU path for each loop
    (i, j), with the same samples (drawn from the CPU path's match masks),
    held to LOOP_*_TOL. Returns [(i, j, inliers card / CPU, |dR|_F, dir)]."""
    from epivo_tpu_torch import ransac
    from epivo_tpu_torch.pipeline import loopclose, vo

    kf = store.as_dict()
    out = []
    for lp in loops:
        i, j = lp.i, lp.j
        t_next = float(np.linalg.norm((np.linalg.inv(est[i]) @ est[i + 1])[:3, 3]))
        src = torch.from_numpy(np.stack([kf[i], kf[i]]))
        tgt = torch.from_numpy(np.stack([kf[j], kf[i + 1]]))
        _, _, status = vo.orb_associate(src, tgt, vo_half)
        gen = torch.Generator().manual_seed(1000 + i + j)
        smp = ransac._sample_indices(gen, vo_half.ransac.hypotheses(), status.shape[-1],
                                     status, device="cpu", lead=(2,))
        rc, rp = (loopclose.verify_loop(kf[i], kf[j], kf[i + 1], t_next, vo_half, None,
                                        ransac_samples=smp, device=d) for d in (dev, "cpu"))
        _check(rc is not None and rp is not None,
               f"loop ({i}, {j}): verification on the card {rc is not None}, on the CPU "
               f"{rp is not None}")
        dr = float(np.linalg.norm(rc.T_meas[:3, :3] - rp.T_meas[:3, :3]))
        nc, npc = np.linalg.norm(rc.T_meas[:3, 3]), np.linalg.norm(rp.T_meas[:3, 3])
        dd = 0.0 if rc.zero_baseline else float(np.linalg.norm(
            rc.T_meas[:3, 3] / nc - rp.T_meas[:3, 3] / npc))
        print(f"loop: verification of ({i}, {j}) card vs CPU, same samples: inliers "
              f"{rc.n_inliers} / {rp.n_inliers}, zero baseline {rc.zero_baseline} / "
              f"{rp.zero_baseline}, |dR|_F={dr:.3g} dir={dd:.3g}")
        _check(rc.zero_baseline == rp.zero_baseline
               and abs(rc.n_inliers - rp.n_inliers) <= LOOP_INLIER_TOL
               and dr < LOOP_R_TOL and dd < LOOP_DIR_TOL,
               f"loop ({i}, {j}) verification card vs CPU beyond the tolerances")
        out.append((i, j, rc.n_inliers, rp.n_inliers, dr, dd))
    return out


def phase_loop(dev) -> tuple[dict, dict]:
    """Loop closure: the out-and-back loop course through run_ba_sequence
    with loop closure on (no ground truth), held to the JAX package's CPU
    spread (LOOP_* above), with the loop stage's launches per call; the
    drift-injected fixture through the loop stage on the card, with every
    applied loop's verification against the CPU; and fast_cand, the dense
    FAST kernel and the extraction kernel against their plain versions at
    the keyframe pyramid's shapes. Returns (the phase's numbers, the kernel
    rows)."""
    from epivo_tpu_torch.datasets import photoreal
    from epivo_tpu_torch.geometry import camera
    from epivo_tpu_torch.pipeline import config as pc, loopclose, runners
    from epivo_tpu_torch.tools import photoreal_loop as pl

    t0 = time.perf_counter()
    frames, gt, _, length = pl.render_loop("out-and-back",
                                           workers=max(1, min(8, os.cpu_count() or 1)))
    render_s = time.perf_counter() - t0
    gen_frames = photoreal.loop_sequence(H=H, W=W)[0]
    for k, a in zip(range(2), gen_frames):
        _check(np.array_equal(frames[k], a), f"loop frame {k} differs from the generator's")
    print(f"loop: rendered {len(frames)} frames {H}x{W} in {render_s:.1f} s (trajectory "
          f"{length:.2f} m), bit-equal on frames 0-1")

    # The runner path: run_ba_sequence with loop closure on.
    cfg = pl.ba_config(pc, camera, enabled=True)
    reset_launches()
    with loop_recording() as rec:
        res = runners.run_ba_sequence(frames, cfg, gt_poses=None, seed=LOOP_SEED,
                                      batch=LOOP_BATCH, pipeline_depth=2, device=dev)
    launches = launches_now()
    score = pl.score_loop(res.trajectory, gt, length)
    st, ls = res.stats, res.stats["loop"]
    loops = pl.loops_report(res.loops)
    print(f"loop: run_ba_sequence, loop closure on, no ground truth, seed {LOOP_SEED}: Sim(3) "
          f"ATE {score['ate_sim3_rmse_m']:.4f} m = {score['ate_sim3_pct_of_length']:.3f} % of "
          f"the length, endpoint gap {score['endpoint_gap_gauge0_m']:.3f} m, length ratio "
          f"{score['length_ratio_gauge0']:.4f} (gauge on step 0); loops applied "
          f"{[(l['i'], l['j'], l['inliers'], l['retrieval_score'], round(l['sigma'], 4)) for l in loops]}"
          f" (i, j, inliers, retrieval score, sigma)")
    print(f"loop: stage: {ls['keyframes']} keyframes, {ls['candidates']} candidates, "
          f"{ls['verifications']} verifications, {ls['scale_checks']} scale-drift checks, "
          f"{ls['loops_applied']} loops, pose graph {ls['pose_graph']}; wall: extraction "
          f"{st['extract_s']:.1f} s, ORB retry {st['orb_retry_s']:.1f} s, scale graph "
          f"{st['scale_graph_s']:.2f} s, window solve {st['solve_s']:.2f} s, describe "
          f"{ls['describe_s']:.3f} s, retrieval {ls['retrieval_s']:.3f} s, verification "
          f"{ls['verify_s']:.2f} s, pose graph {ls['pose_graph_s']:.3f} s, loop stage "
          f"{ls['loop_s']:.2f} s, run_ba_sequence total {st['total_s']:.1f} s")
    n_calls = 1 + ls["verifications"] + ls["scale_checks"]
    per_call = rec["describe"]
    print(f"loop: launches in the run {launches}; in the loop stage {rec['stage']}, its "
          f"describe call {per_call}, per verification call "
          f"{rec['pairs'][0] if rec['pairs'] else None} ({len(rec['pairs'])} calls)")
    _check(per_call["fast_cand"] > 0 and per_call["fast"] > 0 and per_call["extract"] > 0
           and per_call["klt_level"] == 0,
           f"the loop stage's describe call did not run through the kernels: {per_call}")
    _check(len(rec["pairs"]) == n_calls - 1
           and all(p == per_call for p in rec["pairs"])
           and rec["stage"] == {k: v * n_calls for k, v in per_call.items()},
           f"loop stage launches {rec['stage']} != {n_calls} x {per_call}")

    # The drift-injected fixture on the card, and its loops' verification
    # against the CPU.
    reset_launches()
    drift = pl.run_drift(frames, dev)
    drift_launches = launches_now()
    print(f"loop: drift fixture: position RMSE {drift['ate_before_m']:.3f} m -> "
          f"{drift['ate_after_m']:.3f} m, loops {[(l['i'], l['j'], l['inliers']) for l in drift['loops']]}"
          f", {drift['stats']['verifications']} verifications, wall {drift['wall_s']:.2f} s, "
          f"launches {drift_launches}")
    _check(len(drift["loops"]) >= 1
           and drift["ate_after_m"] < LOOP_DRIFT_GAIN * drift["ate_before_m"],
           f"drift fixture: {len(drift['loops'])} loops, RMSE {drift['ate_before_m']:.3f} -> "
           f"{drift['ate_after_m']:.3f} m")
    cfg_d = pl.ba_config(pc, camera, pl.DRIFT, enabled=True)
    store = pl.keyframes(loopclose, frames, cfg_d)
    applied = [loopclose.Loop(l["i"], l["j"], None, l["inliers"], l["retrieval_score"])
               for l in drift["loops"]]
    verify = loop_verify_card_vs_cpu(applied, store, pl.drift_chain(gt),
                                     runners._loop_vo_config(cfg_d), dev)

    # The kernels at the keyframe pyramid's shapes, on the describe call's
    # inputs of the runner run.
    inputs = rec["inputs"]
    kernels = {"fast_cand": {}, "fast": {}, "extract": {}}
    for (kernel, Hl, Wl), args in sorted(inputs.items(), key=lambda kv: -kv[0][1]):
        img = args[0]
        tag = f"{Hl}x{Wl}_B{img.shape[0]}"
        if kernel == "fast_cand":
            kernels[kernel][tag] = cand_report(img, args[1], "loop: describe")
        elif kernel == "fast":
            kernels[kernel][tag] = dense_report(img, args[1], "loop: describe")
        else:
            kernels[kernel][f"S{args[3]}_{tag}"] = extract_report(*args[:4],
                                                                  f" (loop: describe {tag})")
    _check(all(kernels[k] for k in kernels), f"loop: no recorded inputs for "
           f"{[k for k in kernels if not kernels[k]]}")
    print(f"loop: limits: Sim(3) ATE <= {LOOP_ATE_PCT:.3f} %, endpoint gap <= "
          f"{LOOP_GAP_M:.3f} m (1.5x the JAX package's worst over its CPU seeds 0-3: "
          f"{LOOP_REF_ATE_PCT} %, {LOOP_REF_GAP_M} m)")
    _check(len(loops) >= 1 and score["ate_sim3_pct_of_length"] <= LOOP_ATE_PCT
           and score["endpoint_gap_gauge0_m"] <= LOOP_GAP_M,
           f"loop on: {len(loops)} loops, Sim(3) ATE {score['ate_sim3_pct_of_length']:.3f} % (limit "
           f"{LOOP_ATE_PCT:.3f}) or endpoint gap {score['endpoint_gap_gauge0_m']:.3f} m "
           f"(limit {LOOP_GAP_M:.3f})")
    return dict(render_s=render_s, length_m=length, seed=LOOP_SEED, score=score, loops=loops,
                stats={k: ls[k] for k in ls}, run_stats={k: st[k] for k in (
                    "n_pairs", "extract_s", "solve_s", "total_s")},
                launches=launches, launches_stage=rec["stage"], launches_per_call=per_call,
                drift={k: drift[k] for k in ("ate_before_m", "ate_after_m", "loops", "wall_s")},
                drift_launches=drift_launches, verify_card_vs_cpu=verify), kernels


def candidate_match(Es_a, va, Es_b, vb, tol: float = FIVE_MATCH_TOL) -> tuple[int, int]:
    """(matched, total): the valid candidates [S, 10, 3, 3] of side a within
    ``tol`` Frobenius of a valid candidate of the same sample on side b,
    up to sign."""
    d = torch.minimum(torch.linalg.norm(Es_a[:, :, None] - Es_b[:, None], dim=(-2, -1)),
                      torch.linalg.norm(Es_a[:, :, None] + Es_b[:, None], dim=(-2, -1)))
    d = torch.where(vb[:, None, :], d, torch.inf).amin(-1)  # [S, 10]
    return int(((d < tol) & va).sum()), int(va.sum())


def five_point_card_vs_cpu(p_s, pt_s) -> dict:
    """five_point on the samples' device against the port's CPU path on
    the same samples, beside the CPU against itself with one ulp on the
    inputs: candidates matched as sets up to sign, over all valid ones and
    over the exact ones (FIVE_* above)."""
    from epivo_tpu_torch.geometry import essential, fivepoint

    p_c, pt_c = p_s.cpu(), pt_s.cpu()
    Es_d, v_d = (x.cpu() for x in fivepoint.five_point(p_s, pt_s))
    Es_c, v_c = fivepoint.five_point(p_c, pt_c)
    Es_u, v_u = fivepoint.five_point(torch.nextafter(p_c, torch.full_like(p_c, 10.0)), pt_c)
    exact = lambda Es, v: v & (essential.sampson_error(Es, p_c[:, None], pt_c[:, None])
                               .amax(-1) < FIVE_EXACT)

    def shares(Es_a, v_a, Es_b, v_b):
        m_all = [candidate_match(Es_a, v_a, Es_b, v_b), candidate_match(Es_b, v_b, Es_a, v_a)]
        m_ex = [candidate_match(Es_a, exact(Es_a, v_a), Es_b, v_b),
                candidate_match(Es_b, exact(Es_b, v_b), Es_a, v_a)]
        share = lambda m: min(h / max(n, 1) for h, n in m)
        return m_all, m_ex, share(m_all), share(m_ex)

    m_all, m_ex, share_all, share_ex = shares(Es_d, v_d, Es_c, v_c)
    _, _, ctrl_all, ctrl_ex = shares(Es_c, v_c, Es_u, v_u)
    print(f"five_point: card vs CPU on the same {p_s.shape[0]} samples: {m_all[0][1]} / "
          f"{m_all[1][1]} valid candidates, {m_all[0][0]} / {m_all[1][0]} matched within "
          f"{FIVE_MATCH_TOL} up to sign ({100 * share_all:.2f} %; the CPU against itself "
          f"with one ulp on the inputs {100 * ctrl_all:.2f} %, limit that less "
          f"{100 * FIVE_CONTROL_SLACK:.0f} pp); exact candidates (Sampson < {FIVE_EXACT:g}) "
          f"{m_ex[0][1]} / {m_ex[1][1]}, matched {m_ex[0][0]} / {m_ex[1][0]} "
          f"({100 * share_ex:.2f} %, limit {100 * FIVE_MATCH:.0f} %; one-ulp control "
          f"{100 * ctrl_ex:.2f} %)")
    _check(m_ex[0][1] > 0 and m_ex[1][1] > 0 and share_ex >= FIVE_MATCH,
           f"five_point card vs CPU: exact candidates matched {m_ex}")
    _check(share_all >= ctrl_all - FIVE_CONTROL_SLACK,
           f"five_point card vs CPU: {100 * share_all:.2f} % of all valid candidates matched, "
           f"the one-ulp control {100 * ctrl_all:.2f} %")
    return dict(valid=[m_all[0][1], m_all[1][1]], matched=[m_all[0][0], m_all[1][0]],
                share=share_all, exact=share_ex, control=ctrl_all, control_exact=ctrl_ex)


def phase_five_point(f0, f1, gt, cfg, n_pairs: int = N_PAIRS) -> dict:
    """The 5-point step (RansacConfig(solver="5pt"), 512 hypotheses, 5,120
    candidates per pair): launches per step (a KLT step's), step time, the
    five-point stage's device time and ATen operators per call, the pose
    against the ground truth, the kernel path against the plain path on
    the same samples; vo_step_batched at B = n_pairs with no host sync,
    every lane against the ground truth, pairs/s in turns with single
    steps and the peak device memory at B = 1 and B = n_pairs; and
    five_point on the card against the port's CPU path on the step's own
    512 samples."""
    from epivo_tpu_torch import ransac
    from epivo_tpu_torch.frontend import fast, klt
    from epivo_tpu_torch.geometry import fivepoint
    from epivo_tpu_torch.pipeline import vo

    dev = f0.device
    fc = cfg.frontend
    cfg5 = dataclasses.replace(cfg, ransac=dataclasses.replace(cfg.ransac, solver="5pt"))
    gen = lambda: torch.Generator(device=dev).manual_seed(SEED)
    T_gt = np.linalg.inv(np.linalg.inv(gt[0]) @ gt[1])
    lim_r, lim_d = 2 * FIVE_REF_WORST[0], 2 * FIVE_REF_WORST[1]

    def step(**kw):
        out = vo.vo_step(f0, f1, gen(), cfg5, **kw)
        torch.cuda.synchronize()
        return out

    with recording(fivepoint, "five_point") as rec:
        first = step()  # warm-up; records the solver's inputs
    p_s, pt_s = rec[0][:2]
    _check(p_s.shape == (cfg5.ransac.hypotheses(), 5, 3), f"five_point got {p_s.shape}")
    n_steps = 5
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    times, results = [], []
    for _ in range(n_steps):
        t0 = time.perf_counter()
        results.append(step())
        times.append((time.perf_counter() - t0) * 1e3)
    mem1 = torch.cuda.max_memory_allocated() / 1e9
    launches = launches_now()
    per_step = {"fast": 0, "fast_cand": 1, "klt_level": fc.klt_levels, "extract": 0, "lk": 0}
    _check(launches == {k: v * n_steps for k, v in per_step.items()},
           f"5-point launch counts {launches} != {per_step} per step x {n_steps}")
    for r in results:
        _check(torch.equal(r.T, first.T), "repeated 5-point vo_step changed its result")
    _check(bool(torch.isfinite(first.T).all()), "5-point pose not finite")
    r_err, d_err = _pose_err(first.T.cpu().numpy(), T_gt)
    _check(r_err < lim_r and d_err < lim_d,
           f"5-point pose vs ground truth: |dR|_F={r_err:.4g}, dir={d_err:.4g} (limits "
           f"{lim_r:.4g} / {lim_d:.4g})")
    ops, n_dev, dev_ms, wall_ms = work_counts(lambda: fivepoint.five_point(p_s, pt_s))
    stage = {"aten_ops": sum(ops.values()), "device_activities": n_dev, "device_ms": dev_ms,
             "wall_ms": wall_ms}
    step_ms = float(np.median(times))
    print(f"five_point: vo_step 5pt {H}x{W} {p_s.shape[0]} samples x 10 candidates, "
          f"n_inliers={int(first.n_inliers)} reverted={bool(first.reverted)} "
          f"|R-R_gt|_F={r_err:.4g} dir_err={d_err:.4g} (limits {lim_r:.4g} / {lim_d:.4g}); "
          f"median {step_ms:.2f} ms/step over {n_steps}; launches per step {per_step}; "
          f"five-point stage per call: {stage['aten_ops']} ATen operators, "
          f"{stage['device_activities']} device activities, device {stage['device_ms']:.3f} "
          f"ms, wall {stage['wall_ms']:.2f} ms; max_memory_allocated {mem1:.3f} GB at B=1")

    # Kernel path vs plain path, the same samples.
    kp = fast.detect(f0, fc.fast_threshold, fc.max_keypoints)
    flow = klt.track(f0, f1, kp.xy, valid=kp.valid, win=fc.klt_window, levels=fc.klt_levels,
                     iters=fc.klt_iters, min_eig=fc.klt_min_eig)
    samples = ransac._sample_indices(gen(), cfg5.ransac.hypotheses(), fc.max_keypoints,
                                     flow.status, 5, device=dev)
    r_k = step(ransac_samples=samples)
    r_p = step(ransac_samples=samples, use_kernel=False)
    kr, kd = _pose_err(r_k.T.cpu().numpy(), r_p.T.cpu().numpy())
    _check(kr < STEP_R_TOL and kd < STEP_DIR_TOL,
           f"5-point kernel vs plain step: |dR|_F={kr:.4g}, dir={kd:.4g}")
    print(f"five_point: kernel vs plain path, same samples: |dR|_F={kr:.3g} dir={kd:.3g} "
          f"n_inliers {int(r_k.n_inliers)}/{int(r_p.n_inliers)}")

    card_vs_cpu = five_point_card_vs_cpu(p_s, pt_s)

    # The batched step at B = n_pairs.
    eps = torch.arange(n_pairs, dtype=f0.dtype, device=dev)[:, None, None] * 1e-5
    img0 = (f0[None] + eps).contiguous()
    img1 = f1[None].expand(n_pairs, -1, -1).contiguous()
    batched = lambda: vo.vo_step_batched(img0, img1, gen(), cfg5)
    first_b = batched()
    torch.cuda.synchronize()
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    res = no_sync(batched)
    torch.cuda.synchronize()
    memb = torch.cuda.max_memory_allocated() / 1e9
    launches_b = launches_now()
    _check(launches_b == per_step, f"batched 5-point launches {launches_b} != {per_step}")
    _check(torch.equal(res.T, first_b.T), "repeated 5-point vo_step_batched changed its result")
    errs = [_pose_err(T, T_gt) for T in res.T.cpu().numpy()]
    r_max, d_max = max(e[0] for e in errs), max(e[1] for e in errs)
    r_med, d_med = float(np.median([e[0] for e in errs])), float(np.median([e[1] for e in errs]))
    _check(r_max < lim_r and d_max < lim_d,
           f"batched 5-point lanes vs ground truth: max |dR|_F={r_max:.4g}, dir={d_max:.4g}")
    _check(r_med <= 2 * FIVE_REF_MEDIAN[0] and d_med <= 2 * FIVE_REF_MEDIAN[1],
           f"batched 5-point lanes' median {r_med:.4g} / {d_med:.4g} above twice the "
           f"reference's median {FIVE_REF_MEDIAN}")
    times = {"batched": [], "single": []}
    single = lambda: vo.vo_step(f0, f1, gen(), cfg5)
    for turn in ("batched", "single", "single", "batched"):
        times[turn] += [host_ms(batched if turn == "batched" else single) for _ in range(3)]
    ms_b, ms_1 = float(np.median(times["batched"])), float(np.median(times["single"]))
    print(f"five_point: vo_step_batched 5pt B={n_pairs} launches per call {launches_b}, no "
          f"host sync, repeat equal; lanes vs ground truth max |R-R_gt|_F={r_max:.4g} "
          f"dir_err={d_max:.4g}, median {r_med:.4g} / {d_med:.4g} (limits {lim_r:.4g} / "
          f"{lim_d:.4g}, median {2 * FIVE_REF_MEDIAN[0]:.4g} / {2 * FIVE_REF_MEDIAN[1]:.4g}); "
          f"{n_pairs / ms_b * 1e3:.2f} pairs/s (median {ms_b:.2f} ms per call over "
          f"{len(times['batched'])}), single {1e3 / ms_1:.2f} pairs/s (median {ms_1:.2f} ms), "
          f"in turns; max_memory_allocated {memb:.3f} GB at B={n_pairs}")
    return dict(launches_per_step=per_step, step_ms=step_ms, stage=stage,
                pose=[r_err, d_err], kernel_vs_plain=[kr, kd],
                card_vs_cpu=card_vs_cpu,
                batched=dict(pairs_s=n_pairs / ms_b * 1e3, single_pairs_s=1e3 / ms_1,
                             ms_per_call=ms_b, lanes_max=[r_max, d_max],
                             lanes_median=[r_med, d_med]),
                max_memory_allocated_gb={"B1": mem1, f"B{n_pairs}": memb})


def global_card_vs_cpu(seed: int, res, dev) -> dict:
    """refine_global on ``dev`` against the port's CPU on a no-GT run's own
    zetas and pairs, beside the CPU against itself with one ulp on the
    input rotations, and a repeat on ``dev`` (GLOBAL_* above)."""
    from epivo_tpu_torch.pipeline import runners
    from epivo_tpu_torch.pipeline.config import GlobalBAConfig
    from epivo_tpu_torch.tools import photoreal_ate

    cfg = dataclasses.replace(photoreal_ate.configs()[1],
                              global_ba=GlobalBAConfig(enabled=True))
    zetas = res.per_frame["zetas"]
    z_d, r_d = runners.refine_global(zetas, res.pair_data, cfg, device=dev)
    z_2, r_2 = runners.refine_global(zetas, res.pair_data, cfg, device=dev)
    t0 = time.perf_counter()
    z_c, r_c = runners.refine_global(zetas, res.pair_data, cfg, device="cpu")
    cpu_s = time.perf_counter() - t0
    z_u = zetas.copy()
    z_u[:, :3, :3] = np.nextafter(z_u[:, :3, :3], np.float32(2.0))
    z_cu, _ = runners.refine_global(z_u, res.pair_data, cfg, device="cpu")
    per_zeta = lambda a, b: np.abs(a[:, :3, :3] - b[:, :3, :3]).max(axis=(1, 2))
    dRz, ctrl = per_zeta(z_d, z_c), per_zeta(z_cu, z_c)
    dR, dR95, ctrl_max = float(dRz.max()), float(np.quantile(dRz, 0.95)), float(ctrl.max())
    dr = abs(float(r_d.r_norm) - float(r_c.r_norm)) / float(r_c.r_norm)
    repeat = bool(np.array_equal(z_d, z_2) and float(r_d.r_norm) == float(r_2.r_norm))
    print(f"global: card vs CPU on seed {seed}'s input: rotation difference per "
          f"zeta 95th percentile {dR95:.3g} (limit {GLOBAL_R_TOL}), largest {dR:.3g} at zeta "
          f"{int(dRz.argmax())} (limit {GLOBAL_R_MAX}; the CPU against itself with one ulp "
          f"on the input rotations: "
          f"{ctrl_max:.3g} at zeta {int(ctrl.argmax())}, 95th percentile "
          f"{float(np.quantile(ctrl, 0.95)):.3g}), r_norm {float(r_d.r_norm):.6g} / "
          f"{float(r_c.r_norm):.6g} ({100 * dr:.3f} %), accepted {int(r_d.n_accepted)} / "
          f"{int(r_c.n_accepted)}; repeat on the card bit-equal: {repeat}; CPU {cpu_s:.2f} s")
    _check(dR95 < GLOBAL_R_TOL and dR < GLOBAL_R_MAX and dr < GLOBAL_RNORM_RTOL,
           f"global card vs CPU: rotations {dR95:.3g} (95th percentile) / {dR:.3g} (largest; "
           f"one-ulp control {ctrl_max:.3g}), r_norm {dr:.3g}")
    _check(repeat, "global: a repeat on the card changed the result")
    return dict(rot_p95=dR95, rot_max=dR, rot_max_ulp_control=ctrl_max, r_norm_rel=dr,
                repeat_equal=repeat, cpu_s=cpu_s)


def phase_global(results: list, gt, length: float, dev) -> dict:
    """The global-BA polish on each of phase 9's no-GT runs, over the run's
    own zetas and pairs (tools/photoreal_ate.global_paired): the paired
    Sim(3) ATE delta and length ratio, kept step norms, accepted steps,
    the residual norm before and after and the stage's wall seconds; the
    median delta against the JAX package's CPU spread; the card against
    the port's CPU on seed 0's input, and a bit-equal repeat."""
    from epivo_tpu_torch.tools import photoreal_ate

    runs = []
    for seed, res in results:
        g = photoreal_ate.global_paired(res, gt, length, device=dev)
        runs.append(g)
        print(f"global: seed {seed}: Sim(3) ATE {g['off']['ate_sim3_pct_of_length']:.3f} -> "
              f"{g['on']['ate_sim3_pct_of_length']:.3f} % (delta {g['delta_pp']:+.3f} pp), "
              f"length ratio {g['off']['length_ratio_gauge0']:.4f} -> "
              f"{g['on']['length_ratio_gauge0']:.4f}; step norms kept to "
              f"{g['norm_rel_change_max']:.2g}; {g['n_accepted']} steps accepted, r_norm "
              f"{g['r_norm_start']:.6g} -> {g['r_norm_end']:.6g}; stage {g['wall_s']:.2f} s")
        _check(g["norm_rel_change_max"] <= GLOBAL_NORM_RTOL,
               f"global seed {seed}: step norms moved by {g['norm_rel_change_max']:.3g}")
        _check(g["n_accepted"] > 0 and g["r_norm_end"] <= g["r_norm_start"],
               f"global seed {seed}: {g['n_accepted']} accepted, r_norm "
               f"{g['r_norm_start']} -> {g['r_norm_end']}")
    med = float(np.median([g["delta_pp"] for g in runs]))
    print(f"global: median paired delta over seeds {list(SEQ_SEEDS)} {med:+.3f} pp (limits "
          f"[{GLOBAL_DELTA[0]:+.3f}, {GLOBAL_DELTA[1]:+.3f}], 1.5x the reference's CPU "
          f"extremes {GLOBAL_REF_DELTA})")
    _check(GLOBAL_DELTA[0] <= med <= GLOBAL_DELTA[1],
           f"global median paired delta {med:+.3f} pp outside {GLOBAL_DELTA}")
    return dict(runs=runs, median_delta_pp=med,
                card_vs_cpu=global_card_vs_cpu(results[0][0], results[0][1], dev))


def _pairs_equal(a: dict, b: dict) -> list:
    """The pairs whose every field is bit-equal in both extractions."""
    return [k for k in a if k in b and all(np.array_equal(a[k][f], b[k][f]) for f in a[k])]


def phase_multi(frames, results, f0, f1, cfg, dev) -> tuple[dict, dict]:
    """The multi-device layer on one card, on phase 9's frames and seed-0
    run, phase 7's windows and the corridor pair (MULTI_* above): (a) NCCL
    at a world size of 1, every mesh path against the path without a mesh;
    (b) two gloo ranks sharing the card (tools/mesh_checks.card_check),
    each stepping half of every batch: launches and host syncs per rank
    and call, the extraction, the window solve, the global polish and the
    hypothesis-split RANSAC against one rank, and fast_cand and klt_level
    against their plain versions at the ranks' B. Renders nothing. Returns
    (the phase's numbers, the kernel rows and launches per rank and call)."""
    from epivo_tpu_torch import ransac
    from epivo_tpu_torch.frontend import fast, klt
    from epivo_tpu_torch.geometry import camera as cam
    from epivo_tpu_torch.parallel import mesh as mesh_mod, multihost
    from epivo_tpu_torch.pipeline import ba, config, runners, scale, stream
    from epivo_tpu_torch.pipeline.config import GlobalBAConfig, VOConfig
    from epivo_tpu_torch.tools import mesh_checks, photoreal_ate

    t_phase = time.perf_counter()
    res0 = results[0][1]
    _, bcfg = photoreal_ate.configs()
    gcfg = dataclasses.replace(bcfg, global_ba=GlobalBAConfig(enabled=True))
    vo_cfg = VOConfig(camera=bcfg.camera, frontend=bcfg.frontend, ransac=bcfg.ransac,
                      lm=bcfg.lm)
    pairs = sorted(res0.pair_data)[:MULTI_PAIRS]
    sub = frames[:max(max(pr) for pr in pairs) + 1]
    extract = dict(n_points=bcfg.lm.n_points, batch=SEQ_BATCH)
    # Seed 0's windows, from its pairs and its scale graph.
    n_zeta = SEQ_FRAMES - 1
    c_scale = scale.scale_graph_solve(scale.scale_graph_measurements(
        res0.pair_data, n_zeta, bcfg.scale, device=dev), n_zeta, bcfg.scale)
    spec = ba.mono_window_spec(bcfg.window_size)
    anchors = list(range(0, SEQ_FRAMES - bcfg.window_size + 1, bcfg.stride))
    T0s, wp, wpt, wreps, pmask = runners._mono_windows(res0.pair_data, anchors, spec,
                                                       c_scale, bcfg.lm.n_points)
    zetas = res0.per_frame["zetas"]

    # (b) two gloo ranks on the card, started first: they start (spawn,
    # CUDA, the kernel library) while (a) runs here.
    z = np.load(Path(__file__).resolve().parent / "bench_ba_workload.npz")
    ba_cfg = config.BAConfig(lm=config.LMConfig(n_points=32, max_iters=30,
                                                revert_r_norm=1e-2), window_size=3, stride=2)
    ba_arrays = [z[k] for k in ("T0s", "p", "p_t", "wreps", "pmask")]
    fc, rc = cfg.frontend, cfg.ransac
    kp = fast.detect(f0[None], fc.fast_threshold, fc.max_keypoints)
    flow = klt.track(f0[None], f1[None], kp.xy, valid=kp.valid, win=fc.klt_window,
                     levels=fc.klt_levels, iters=fc.klt_iters, min_eig=fc.klt_min_eig)
    K_inv = cfg.camera.K_inv(torch.float32, dev)
    p0, p1 = cam.normalize(kp.xy, K_inv)[0], cam.normalize(flow.xy, K_inv)[0]
    mask = flow.status[0]
    samples = ransac._sample_indices(torch.Generator(device=dev).manual_seed(SEED),
                                     rc.hypotheses(), p0.shape[0], mask, device=dev)
    thr = (rc.threshold_px / cfg.camera.fx) ** 2
    r_one = ransac.ransac_essential(None, p0, p1, n_hyp=rc.hypotheses(), threshold=thr,
                                    mask=mask, samples=samples)
    host = lambda t: t.cpu().numpy()
    t0 = time.perf_counter()
    ranks = multihost.start(mesh_checks.card_check, 2, sub, pairs, vo_cfg, extract,
                            (*ba_arrays, spec, ba_cfg), zetas, res0.pair_data, gcfg,
                            (host(p0), host(p1), host(mask), host(samples), thr),
                            backend="gloo", device="cuda")
    # (a) NCCL, world size 1: every mesh path bit-equal to no mesh.
    multihost.initialize(f"127.0.0.1:{multihost.free_port()}", 1, 0, backend="nccl")
    try:
        mesh = mesh_mod.make_mesh(1, 1, device_type="cuda")
        one, one_m = (runners._extract_pairs(stream.FrameStream(list(sub)), pairs, vo_cfg, 0,
                                             mesh=m, device=dev, **extract)
                      for m in (None, mesh))
        sw = [runners._solve_windows(T0s, spec, wp, wpt, wreps, pmask, bcfg, mesh=m,
                                     device=dev) for m in (None, mesh)]
        gz = [runners.refine_global(zetas, res0.pair_data, gcfg, mesh=m, device=dev)
              for m in (None, mesh)]
    finally:
        torch.distributed.destroy_process_group()
    eq_a = dict(pairs=len(_pairs_equal(one, one_m)),
                windows=all(np.array_equal(a, b) for a, b in zip(*sw)),
                global_ba=bool(np.array_equal(gz[0][0], gz[1][0])
                               and float(gz[0][1].r_norm) == float(gz[1][1].r_norm)))
    print(f"multi: (a) {time.perf_counter() - t_phase:.1f} s; NCCL, world size 1: "
          f"{eq_a['pairs']} of {len(pairs)} pairs bit-equal "
          f"to no mesh; _solve_windows on seed {results[0][0]}'s {len(anchors)} windows "
          f"bit-equal: {eq_a['windows']}; refine_global bit-equal: {eq_a['global_ba']}")
    _check(eq_a["pairs"] == len(pairs) and eq_a["windows"] and eq_a["global_ba"],
           f"NCCL world size 1: a mesh path differs from no mesh: {eq_a}")

    outs = ranks.results(timeout_s=300)
    spawn_s = time.perf_counter() - t0
    r0 = outs[0]
    print(f"multi: (b) 2 ranks sharing {torch.cuda.get_device_name(0)} on {r0['backend']}; "
          f"collectives rank 0 ran (op/backend/tensor device: calls) {r0['collectives']}; "
          f"the layer stages none through the host itself (gloo copies CUDA tensors "
          f"through pinned host buffers inside the backend); ranks' wall "
          f"{spawn_s:.1f} s (start included, beside (a)); per rank: extraction "
          f"{r0['wall']['extract_s']:.2f} s, window solve {r0['wall']['ba_s']:.3f} s, "
          f"global polish {r0['wall']['global_s']:.3f} s (two ranks share one card: not a "
          f"scaling number)")
    for r in outs[1:]:
        _check(_pairs_equal(r["pairs"], r0["pairs"]) == list(r0["pairs"])
               and all(np.array_equal(a, b) for a, b in zip(r["ba"], r0["ba"]))
               and np.array_equal(r["global"][0][0], r0["global"][0][0]),
               "the ranks' replicated results differ")

    # Each rank's launches in its _extract_pairs(mesh=) run, counted from
    # 0 just before it: the KLT pass per call at the lanes its steps saw,
    # and the ORB retry pass (fast_cand 1 / extract 1 per call). A step on
    # a rank's lanes also ran under set_sync_debug_mode("error").
    want = {"fast": 0, "fast_cand": 1, "klt_level": fc.klt_levels, "extract": 0, "lk": 0}
    n_calls = -(-len(pairs) // SEQ_BATCH)
    for r in outs:
        la = r["launches"]
        n_r = len(la["retry_lanes"])
        want_retry = {"fast": 0, "fast_cand": n_r, "klt_level": 0, "extract": n_r, "lk": 0}
        _check(la["step_lanes"] == [SEQ_BATCH // 2] * n_calls
               and la["klt"] == {k: v * n_calls for k, v in want.items()}
               and la["retry"] == want_retry,
               f"rank launches: KLT pass {la['klt']} over steps of {la['step_lanes']} lanes, "
               f"retry pass {la['retry']} over steps of {la['retry_lanes']} lanes; expected "
               f"{want} per call over {n_calls} steps of {SEQ_BATCH // 2} lanes, {want_retry}")
    la0 = r0["launches"]
    per_call = {k: v // n_calls for k, v in la0["klt"].items()}

    # The extraction against one rank.
    got = r0["pairs"]
    _check(set(got) == set(one), "2-rank extraction returned other pairs")
    dTs = sorted(float(np.abs(got[k]["T"] - one[k]["T"]).max()) for k in pairs)
    n_eq = len(_pairs_equal(got, one))
    med = dTs[len(dTs) // 2]
    print(f"multi: _extract_pairs, {len(pairs)} pairs, {SEQ_BATCH // 2} per rank per call: "
          f"{n_eq} bit-equal to one rank, median pose delta {med:.3g} (limit "
          f"{MULTI_POSE_MEDIAN}), largest {dTs[-1]:.3g}; rank 0's launches in that run: KLT "
          f"pass {la0['klt']} over {n_calls} steps of {la0['step_lanes']} lanes ({per_call} "
          f"per call), ORB retry pass {la0['retry']} over steps of {la0['retry_lanes']} "
          f"lanes; no host sync in the step")
    _check(med < MULTI_POSE_MEDIAN, f"2-rank extraction median pose delta {med:.3g}")

    # The batch-shape control: rank 0's lanes of the first call stepped
    # here by one process without a mesh, at the rank's B and with the
    # rank's draw (the whole batch's samples from the generator
    # _extract_pairs seeds, rows 0..B-1). The same step records fast_cand
    # and klt_level's inputs at that B for the kernel checks below.
    half = SEQ_BATCH // 2
    ctl_pairs = [k for k in pairs[:half] if k not in r0["retried"]]
    src, tgt = runners._pair_inputs(sub.__getitem__, pairs[:half], dev)
    with sequence_recording(batch=half) as rec:
        packed = runners._extract_step(vo_cfg, False)(src, tgt, ransac.BatchDraw(
            torch.Generator(device=dev).manual_seed(0), tuple(range(half)), SEQ_BATCH))
    T_c, p0_c, p1_c, _, inl_c, _ = runners._unpack_step(host(packed))
    fields = lambda b: dict(T=T_c[b], p_full=p0_c[b], p_t_full=p1_c[b], mask_full=inl_c[b])
    same_as = lambda ex, b, k: all(np.array_equal(v, ex[k][f]) for f, v in fields(b).items())
    ctl_rank0 = sum(same_as(got, b, k) for b, k in enumerate(pairs[:half]) if k in ctl_pairs)
    ctl_one = sum(same_as(one, b, k) for b, k in enumerate(pairs[:half]) if k in ctl_pairs)
    print(f"multi: batch-shape control: rank 0's {len(ctl_pairs)} pairs of the first call "
          f"(ORB-retried pairs left out) stepped in one process without a mesh at B={half} "
          f"with the rank's draw: {ctl_rank0} bit-equal to rank 0's, {ctl_one} to one rank's "
          f"B={SEQ_BATCH} call")

    # The window solve against one rank on the card, and one rank against
    # itself with the initial poses moved by 1e-7 (the control).
    gpu = [torch.from_numpy(a).to(dev) for a in ba_arrays]
    one_rank = lambda T0: [host(x) for x in ba.ba_windows(
        T0, spec, gpu[1], gpu[2], wreps=gpu[3], pmask=gpu[4], config=ba_cfg)]
    ref = one_rank(gpu[0])
    jitter = 1e-7 * torch.randn(gpu[0].shape, generator=torch.Generator().manual_seed(SEED))
    ctl = one_rank(gpu[0] + jitter.to(dev))
    bd = r0["ba"]
    n_win = bd.T_opt.shape[0]
    full = lambda T: int((np.abs(T - ref[0]).max(axis=(1, 2, 3)) <= MULTI_T_ATOL).sum())
    R_m, dir_m = _rot_dir(torch.from_numpy(bd.T_opt))
    R_1, dir_1 = _rot_dir(torch.from_numpy(ref[0]))
    dR = (R_m - R_1).abs().amax((1, 2, 3)).numpy()
    ddir = (dir_m - dir_1).abs().amax((1, 2)).numpy()
    dacc = np.abs(bd.n_accepted.astype(int) - ref[3].astype(int))
    as_p7 = int(((dR <= BA_R_TOL) & (ddir <= BA_DIR_TOL) & (dacc <= BA_ACC_TOL)).sum())
    within = int(((dR <= MULTI_T_ATOL) & (ddir <= MULTI_T_ATOL)).sum())
    r_ok = bool(np.all(np.abs(bd.r_norm - ref[1]) <= BA_R_ATOL + BA_R_RTOL * np.abs(ref[1])))
    rev_ok = bool(np.array_equal(bd.reverted, ref[2]))
    n_eq_w = int(np.all(bd.T_opt == ref[0], axis=(1, 2, 3)).sum())
    # The batch-shape control: rank 0's windows solved here by one process
    # without a mesh at the rank's W.
    wh = n_win // 2
    half_w = host(ba.ba_windows(gpu[0][:wh], spec, gpu[1][:wh], gpu[2][:wh],
                                wreps=gpu[3][:wh], pmask=gpu[4][:wh], config=ba_cfg).T_opt)
    ctl_w_rank0 = int(np.all(half_w == bd.T_opt[:wh], axis=(1, 2, 3)).sum())
    ctl_w_one = int(np.all(half_w == ref[0][:wh], axis=(1, 2, 3)).sum())
    print(f"multi: distributed_ba_step, {n_win} windows, {n_win // 2} per rank: {n_eq_w} "
          f"bit-equal to one rank; {as_p7} within phase 7's tolerances (need "
          f"{BA_WITHIN:.0%}); rotations and directions within {MULTI_T_ATOL}: {within} (need "
          f"{MULTI_WITHIN:.0%}), largest {dR.max():.3g} / {ddir.max():.3g}; r_norm within "
          f"rtol {BA_R_RTOL} / atol {BA_R_ATOL}: {r_ok}; reverted sets equal: {rev_ok}; the "
          f"whole T_opt within {MULTI_T_ATOL}: {full(bd.T_opt)} (control, one rank with the "
          f"initial poses + 1e-7: {full(ctl[0])}); trajectory {tuple(bd.trajectory.shape)}, "
          f"global r_norm {float(bd.global_r_norm):.6g}; batch-shape control, rank 0's "
          f"{wh} windows solved in one process without a mesh at W={wh}: {ctl_w_rank0} "
          f"bit-equal to rank 0's, {ctl_w_one} to one rank's W={n_win} solve")
    _check(r_ok and rev_ok and as_p7 >= BA_WITHIN * n_win and within >= MULTI_WITHIN * n_win,
           f"2-rank window solve vs one rank: r_norm {r_ok}, reverted {rev_ok}, {as_p7} of "
           f"{n_win} within phase 7's tolerances, {within} within {MULTI_T_ATOL}")

    # The global polish against one rank (phase 12's card-vs-CPU bounds),
    # and a repeat at the same world size.
    (zg, rg), (zg2, rg2) = r0["global"]
    dRz = np.abs(zg[:, :3, :3] - gz[0][0][:, :3, :3]).max(axis=(1, 2))
    dR95, dRmax = float(np.quantile(dRz, 0.95)), float(dRz.max())
    repeat = bool(np.array_equal(zg, zg2) and float(rg.r_norm) == float(rg2.r_norm))
    dr = abs(float(rg.r_norm) - float(gz[0][1].r_norm)) / float(gz[0][1].r_norm)
    print(f"multi: refine_global, constraints over 2 ranks: per-zeta rotation difference "
          f"to one rank 95th percentile {dR95:.3g} (limit {GLOBAL_R_TOL}), largest "
          f"{dRmax:.3g} (limit {GLOBAL_R_MAX}), r_norm {100 * dr:.3f} %; repeat bit-equal: "
          f"{repeat}")
    _check(dR95 < GLOBAL_R_TOL and dRmax < GLOBAL_R_MAX and dr < GLOBAL_RNORM_RTOL,
           f"2-rank global polish vs one rank: {dR95:.3g} / {dRmax:.3g}, r_norm {dr:.3g}")
    _check(repeat, "2-rank global polish: a repeat changed the result")

    # The hypothesis-split RANSAC against one rank, same samples.
    rr = r0["ransac"]
    same = bool(np.array_equal(rr.E, host(r_one.E))
                and np.array_equal(rr.inliers, host(r_one.inliers))
                and float(rr.best_score) == float(r_one.best_score))
    print(f"multi: ransac_essential, {rc.hypotheses()} hypotheses over hyp=2 on the corridor "
          f"pair: the winner of one rank: {same} (score {float(rr.best_score):.0f}, "
          f"{int(rr.n_inliers)} inliers)")
    _check(same, "hyp-split RANSAC picked another winner than one rank")

    # fast_cand and klt_level at the ranks' B, on rank 0's lanes of the
    # first extraction call (recorded by the control step above).
    kernels = sequence_kernels(rec, phase="multi", retry_required=False)
    wall = time.perf_counter() - t_phase
    print(f"multi: phase wall {wall:.1f} s")
    return dict(world1=eq_a, pairs_bit_equal=n_eq, median_pose_delta=med,
                control_pairs=len(ctl_pairs), control_pairs_rank0=ctl_rank0,
                control_pairs_one=ctl_one, control_windows_rank0=ctl_w_rank0,
                control_windows_one=ctl_w_one, collectives=r0["collectives"],
                windows_bit_equal=n_eq_w, windows_within=within, windows_as_phase7=as_p7,
                windows_full_T=full(bd.T_opt), windows_full_T_control=full(ctl[0]),
                global_rot_p95=dR95,
                global_rot_max=dRmax, global_repeat=repeat, ransac_same=same,
                spawn_s=spawn_s, rank_wall=r0["wall"], wall_s=wall,
                backend=r0["backend"]), dict(
                    kernels=kernels, launches=per_call,
                    run={k: la0["klt"][k] + la0["retry"][k] for k in per_call},
                    retry=la0["retry"])


KERNELS = {
    "fast": ("epivo_tpu_torch/csrc/fast.cu",
             "epivo_tpu/frontend/pallas_fast.py:33"),
    "fast_cand": ("epivo_tpu_torch/csrc/fast.cu",
                  "epivo_tpu/frontend/pallas_fast.py:33; "
                  "epivo_tpu/frontend/fast.py:122"),
    "klt_level": ("epivo_tpu_torch/csrc/klt_level.cu",
                  "epivo_tpu/frontend/pallas_klt.py:211; "
                  "epivo_tpu/frontend/pallas_klt.py:75"),
    "extract": ("epivo_tpu_torch/csrc/klt_extract.cu",
                "epivo_tpu/frontend/pallas_klt.py:211"),
    "lk": ("epivo_tpu_torch/csrc/klt_lk.cu",
           "epivo_tpu/frontend/pallas_klt.py:75"),
}


def write_png(path, img: np.ndarray) -> None:
    """An 8-bit grayscale PNG of ``img`` (uint8 [H, W]), or an RGB one of
    uint8 [H, W, 3]: signature, IHDR, one zlib IDAT of unfiltered rows,
    IEND. Test scaffolding that needs no PIL (the GPU machine's Python may
    have none)."""
    import struct
    import zlib

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    img = np.ascontiguousarray(img, np.uint8)
    h, w = img.shape[:2]
    color = 2 if img.ndim == 3 else 0  # RGB, else gray
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, -1)], axis=1)  # filter 0
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(rows.tobytes(), 1)) + chunk(b"IEND", b""))


def kitti_tree(root, frames, gt: np.ndarray, K: np.ndarray, right=None,
               T_rig: np.ndarray | None = None) -> list:
    """Write a KITTI odometry tree for sequence 00 under ``root``: the
    frames rounded to uint8 as ``sequences/00/image_0/%06d.png`` (and
    ``right`` as ``image_1``), ``calib.txt`` with P0 = K [I | 0] and P1 =
    K [I | t_rig] (``T_rig``'s translation, else KITTI_00's baseline), and
    ``poses/00.txt`` from ``gt``. Returns the uint8 frames, each camera's
    in a list."""
    root = Path(root)
    seq = root / "sequences" / "00"
    t_rig = (np.asarray(T_rig, np.float64)[:3, 3] if T_rig is not None
             else np.array([-386.1448 / 718.856, 0.0, 0.0]))
    P0 = np.concatenate([K, np.zeros((3, 1))], axis=1)
    P1 = np.concatenate([K, (K @ t_rig)[:, None]], axis=1)
    fmt = lambda a: " ".join(f"{v:.12e}" for v in np.asarray(a, np.float64).reshape(-1))
    (root / "poses").mkdir(parents=True, exist_ok=True)
    out = []
    for cam, fs in (("image_0", frames), ("image_1", right)):
        if fs is None:
            continue
        (seq / cam).mkdir(parents=True, exist_ok=True)
        u8 = [np.clip(np.rint(np.asarray(f, np.float64)), 0, 255).astype(np.uint8)
              for f in fs]
        for i, img in enumerate(u8):
            write_png(seq / cam / f"{i:06d}.png", img)
        out.append(u8)
    (seq / "calib.txt").write_text(f"P0: {fmt(P0)}\nP1: {fmt(P1)}\n")
    (root / "poses" / "00.txt").write_text(
        "".join(fmt(T[:3]) + "\n" for T in np.asarray(gt)[:len(frames)]))
    return out



def run_cli(main, argv: list):
    """main(argv) with its standard output kept; returns (its return
    value, the output)."""
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = main(argv)
    return out, buf.getvalue()


def cli_artifacts(out_dir: str, res, mode: str) -> None:
    """The reference CLI's files and summary keys in ``out_dir``."""
    import importlib.util

    want = set(CLI_FILES) | ({"ckpt"} if mode == "vo" else set())
    if res.cloud.shape[0]:
        want |= {"pts.cld", "lims"}
    if importlib.util.find_spec("matplotlib") is not None:
        want.add("traj.png")
    got = set(os.listdir(out_dir))
    _check(got == want, f"CLI artifacts {sorted(got)}, expected {sorted(want)}")
    summary = json.loads(Path(out_dir, "summary.json").read_text())
    _check(set(summary) == CLI_SUMMARY and set(summary["config"]) == CLI_CONFIG
           and summary["config"]["platform"] == "cuda",
           f"CLI summary keys {sorted(summary)} / {sorted(summary['config'])}")


def phase_entry_points(dev, runtime_build, frames, gt, stereo) -> tuple[dict, dict]:
    """The entry points on phase 9's and phase 10's frames (ENTRY_* above),
    rendering nothing: (a) the native runtime, built from the checkout,
    decodes every PNG of the KITTI trees bit-equal to its uint8 frame; (b)
    entry() on the card: one vo_step's launches, finite, a bit-equal
    repeat; (c) tools/run_kitti.py in this process: --mode ba (its KLT
    pass's launches, the reference CLI's files and summary keys, the
    trajectory bit-equal to run_ba_sequence on the same uint8 frames in
    memory), --mode vo (ATE within CLI_VO_ATE_PCT), --mode gt, and --mode
    stereo on the stereo tree (bit-equal to run_stereo_ba_sequence in
    memory); (d) tools/synthetic_vo_demo.py and its --flat probe. Returns
    (the phase's numbers, the --mode ba run's launches)."""
    import importlib.util
    import tempfile

    from epivo_tpu_torch import runtime
    from epivo_tpu_torch.datasets import kitti
    from epivo_tpu_torch.entry import entry
    from epivo_tpu_torch.geometry.camera import KITTI_00 as cam
    from epivo_tpu_torch.pipeline import runners
    from epivo_tpu_torch.pipeline.config import (BAConfig, FrontendConfig, LMConfig,
                                                 RansacConfig)
    from epivo_tpu_torch.tools import (mesh_checks, photoreal_stereo as ps, run_kitti,
                                       synthetic_vo_demo)

    report = {}
    # (a) The runtime, built in phase 2's thread: it raises here if g++ or
    # libpng is missing.
    lib, build_s, how = runtime_build.result()
    report["runtime_build_s"] = build_s
    print(f"entry: runtime built in {build_s:.1f} s -> {lib.name} ({how})")
    gxx = subprocess.run(["g++", "-dumpfullversion"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    have = {m: importlib.util.find_spec(m) is not None for m in ("PIL", "matplotlib", "cv2")}
    report["machine"] = {"g++": gxx, **have}
    print(f"entry: this machine: g++ {gxx}; importable: {have}")
    K = np.array([[cam.fx, 0, cam.cx], [0, cam.fy, cam.cy], [0, 0, 1.0]])
    gt64 = gt[:ENTRY_FRAMES]
    length = float(np.sum(np.linalg.norm(np.diff(gt64[:, :3, 3], axis=0), axis=-1)))
    L, R, gt_s, K_s, T_rig = stereo
    with tempfile.TemporaryDirectory() as tmp:
        mono, st_root = os.path.join(tmp, "mono"), os.path.join(tmp, "stereo")
        t0 = time.perf_counter()
        (u8,) = kitti_tree(mono, frames[:ENTRY_FRAMES], gt64, K)
        u8_l, u8_r = kitti_tree(st_root, L, gt_s, K_s, right=R, T_rig=T_rig)
        report["png_write_s"] = time.perf_counter() - t0
        trees = [(kitti.KittiSequence(mono, "00"), u8),
                 (kitti.KittiSequence(st_root, "00"), u8_l),
                 (kitti.KittiSequence(st_root, "00", cam="image_1"), u8_r)]
        n_png = sum(len(u) for _, u in trees)
        t0 = time.perf_counter()
        for seq, us in trees:
            for i, u in enumerate(us):
                _check(np.array_equal(runtime.decode_png(seq.image_path(i)),
                                      u.astype(np.float32)),
                       f"decode_png({seq.image_path(i)}) differs from its uint8 frame")
        report["decode_ms_per_frame"] = (time.perf_counter() - t0) / n_png * 1e3
        # One RGB PNG (three frames as its channels) through the same
        # route: libpng's fixed-point BT.709 luma, (6968 R + 23434 G +
        # 2366 B) >> 15, exactly.
        rgb = np.stack(u8[:3], axis=-1)
        write_png(os.path.join(tmp, "rgb.png"), rgb)
        r, g, b = (rgb[..., c].astype(np.int64) for c in range(3))
        _check(np.array_equal(runtime.decode_png(os.path.join(tmp, "rgb.png")),
                              ((6968 * r + 23434 * g + 2366 * b) >> 15).astype(np.float32)),
               "decode_png of an RGB PNG differs from libpng's BT.709 luma")
        loader = runtime.NativeLoader([trees[0][0].image_path(i) for i in range(len(u8))],
                                      n_workers=3, capacity=34)
        _check(loader.decoder == "native", f"the loader decodes with {loader.decoder}")
        t0 = time.perf_counter()
        streamed = list(loader)
        report["loader_fps"] = len(streamed) / (time.perf_counter() - t0)
        _check(all(np.array_equal(a, b.astype(np.float32)) for a, b in zip(streamed, u8))
               and len(streamed) == len(u8), "the loader's stream differs from the frames")
        print(f"entry: decoder: {loader.decoder}; {n_png} PNGs ({H}x{W}) written in "
              f"{report['png_write_s']:.2f} s, each decoded bit-equal to its uint8 frame, "
              f"an RGB one to its BT.709 luma "
              f"({report['decode_ms_per_frame']:.1f} ms a frame); the loader streams "
              f"{report['loader_fps']:.1f} frames/s (3 threads)")

        # (b) entry() with no device argument.
        fn, args = entry()
        _check(all(a.device.type == "cuda" for a in args[:2])
               and args[2].device.type == "cuda", "entry() is not on the card")
        reset_launches()
        out = fn(*args)
        la = launches_now()
        args[2].manual_seed(0)
        again = fn(*args)
        torch.cuda.synchronize()
        _check(la == {"fast": 0, "fast_cand": 1, "klt_level": 4, "extract": 0, "lk": 0},
               f"entry(): launches {la}")
        _check(all(bool(torch.isfinite(f.float()).all()) for f in out),
               "entry(): non-finite outputs")
        _check(all(torch.equal(a, b) for a, b in zip(out, again)),
               "entry(): a repeat with the same generator seed differs")
        report["entry_launches"] = la
        print(f"entry: entry() on {args[0].device}: launches {la}, finite, repeat "
              f"bit-equal; {int(out.n_tracked)} tracked, {int(out.n_inliers)} inliers")

        # (c) The KITTI CLI, in this process.
        base = ["--root", mono, "--seq", "00", "--batch", str(SEQ_BATCH),
                "--fast-threshold", "30", "--max-keypoints", "512"]
        out_ba = os.path.join(tmp, "out_ba")
        reset_launches()
        t0 = time.perf_counter()
        with mesh_checks.retry_launches(launches_now) as retry:
            res, _ = run_cli(run_kitti.main, base + ["--mode", "ba", "--out", out_ba])
        report["ba_cli_s"] = time.perf_counter() - t0
        total = launches_now()
        klt_pass = {k: total[k] - retry[k] for k in total}
        # One fast_cand and one klt_level a level per SEQ_BATCH-pair call.
        calls = -(-res.stats["n_pairs"] // SEQ_BATCH)
        _check(klt_pass == {"fast": 0, "fast_cand": calls, "klt_level": 4 * calls,
                            "extract": 0, "lk": 0},
               f"run_kitti --mode ba: KLT pass launches {klt_pass} in {calls} calls")
        cli_artifacts(out_ba, res, "ba")
        ba_cfg = BAConfig(camera=kitti.KittiSequence(mono, "00").intrinsics(),
                          frontend=FrontendConfig(fast_threshold=30.0, max_keypoints=512),
                          ransac=RansacConfig(n_hyp=512),
                          lm=LMConfig(n_points=32, revert_r_norm=1e-2))
        t0 = time.perf_counter()
        mem = runners.run_ba_sequence([u.astype(np.float32) for u in u8], ba_cfg,
                                      gt_poses=kitti.KittiSequence(mono, "00").load_poses(),
                                      n_frames=len(u8), batch=SEQ_BATCH, device=dev)
        report["ba_memory_s"] = time.perf_counter() - t0
        _check(np.array_equal(res.trajectory, mem.trajectory),
               "run_kitti --mode ba differs from run_ba_sequence on the frames in memory")
        report.update(ba_launches=total, ba_retry_launches=retry, ba_ate_m=res.ate,
                      ba_pairs=res.stats["n_pairs"], ba_retried=res.stats["n_retried"])
        print(f"entry: run_kitti --mode ba: {ENTRY_FRAMES} frames, {res.stats['n_pairs']} "
              f"pairs ({res.stats['n_retried']} retried by ORB), ATE {res.ate:.4f} m, "
              f"{report['ba_cli_s']:.1f} s; launches: KLT pass {klt_pass} in {calls} "
              f"calls of {SEQ_BATCH} pairs, retry pass "
              f"{retry}; files and summary keys as the reference CLI's; trajectory "
              f"bit-equal to run_ba_sequence in memory ({report['ba_memory_s']:.1f} s)")

        out_vo = os.path.join(tmp, "out_vo")
        t0 = time.perf_counter()
        res, _ = run_cli(run_kitti.main, base + ["--mode", "vo", "--out", out_vo])
        report["vo_cli_s"] = time.perf_counter() - t0
        cli_artifacts(out_vo, res, "vo")
        report["vo_ate_pct"] = 100.0 * res.ate / length
        print(f"entry: run_kitti --mode vo (LMedS, GT step lengths): ATE {res.ate:.4f} m = "
              f"{report['vo_ate_pct']:.4f} % of {length:.3f} m (limit {CLI_VO_ATE_PCT:.4f} %: "
              f"1.5x the JAX CLI's {CLI_REF_VO_ATE_PCT} % on the CPU), "
              f"{report['vo_cli_s']:.1f} s")
        _check(report["vo_ate_pct"] <= CLI_VO_ATE_PCT,
               f"run_kitti --mode vo ATE {report['vo_ate_pct']:.4f} % > {CLI_VO_ATE_PCT:.4f} %")

        out_gt = os.path.join(tmp, "out_gt")
        t0 = time.perf_counter()
        res, _ = run_cli(run_kitti.main, base + ["--mode", "gt", "--out", out_gt])
        report["gt_cli_s"] = time.perf_counter() - t0
        cli_artifacts(out_gt, res, "gt")
        _check(res.cloud.shape[0] > 0 and bool(np.isfinite(res.cloud).all()),
               "run_kitti --mode gt: no finite cloud")
        print(f"entry: run_kitti --mode gt: {res.cloud.shape[0]} points triangulated, "
              f"{report['gt_cli_s']:.1f} s")

        out_st = os.path.join(tmp, "out_stereo")
        t0 = time.perf_counter()
        res, _ = run_cli(run_kitti.main, [
            "--root", st_root, "--seq", "00", "--mode", "stereo",
            "--batch", str(STEREO_BATCH), "--fast-threshold", "30", "--max-keypoints", "512",
            "--out", out_st])
        report["stereo_cli_s"] = time.perf_counter() - t0
        cli_artifacts(out_st, res, "stereo")
        seq = kitti.KittiSequence(st_root, "00")
        st_cfg = ps.configs(seq.intrinsics())
        mem = runners.run_stereo_ba_sequence(
            [u.astype(np.float32) for u in u8_l], [u.astype(np.float32) for u in u8_r],
            st_cfg, T_rig=seq.stereo_baseline_T(), gt_poses=seq.load_poses(),
            n_frames=len(u8_l), batch=STEREO_BATCH, device=dev)
        _check(np.array_equal(res.trajectory, mem.trajectory),
               "run_kitti --mode stereo differs from run_stereo_ba_sequence in memory")
        report["stereo_ate_m"] = res.ate
        print(f"entry: run_kitti --mode stereo: {len(u8_l)} stereo frames, baseline "
              f"{-seq.stereo_baseline_T()[0, 3]:.4f} m, ATE {res.ate:.4f} m, "
              f"{report['stereo_cli_s']:.1f} s; trajectory bit-equal to "
              f"run_stereo_ba_sequence in memory")

    # (d) The synthetic demo on the card, and its flat-frame probe.
    for argv, want in (([], "RESULT ok=True"), (["--flat"], "DEGENERATE: too few tracks")):
        rc, text = run_cli(synthetic_vo_demo.main, argv)
        _check(rc == 0 and want in text, f"synthetic_vo_demo {argv}: {text}")
        line = [ln for ln in text.splitlines() if ln.startswith(("LM-pose", "fallback"))]
        print(f"entry: synthetic_vo_demo {' '.join(argv) or '(KLT)'}: {want}; {line[0]}")
    return report, total


def main() -> int:
    t_start = time.perf_counter()
    phase_s = {}

    def timed(phase: str, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        phase_s[phase] = round(time.perf_counter() - t0, 1)
        return out

    name, _ = phase_device()
    dev = torch.device("cuda", 0)
    runtime_build = timed("build", phase_build)
    f0, f1, gt = corridor_pair(dev)
    cfg = bench_config()
    report = timed("kernels", phase_kernels, f0, f1, cfg)
    launches = timed("slice", phase_slice, f0, f1, gt, cfg)
    timed("degenerate", phase_degenerate, dev)
    batched = timed("batched", phase_batched, f0, f1, gt, cfg)
    ba_report = timed("ba", phase_ba, dev)
    orb = timed("orb", phase_orb, f0, f1, gt, cfg)
    report["extract"]["orb"] = orb["extract"]
    report["fast"]["orb_pyramid"] = orb.pop("fast_dense")
    sequence, seq_kernels, seq_runs = timed("sequence", phase_sequence, dev)
    for k, rows in seq_kernels.items():
        report[k]["sequence"] = rows
    stereo, stereo_kernels, stereo_frames_kept = timed("stereo", phase_stereo, dev)
    for k, rows in stereo_kernels.items():
        report[k]["stereo"] = rows
    loop, loop_kernels = timed("loop", phase_loop, dev)
    for k, rows in loop_kernels.items():
        report[k]["loop"] = rows
    five = timed("five_point", phase_five_point, f0, f1, gt, cfg)
    seq_gt, seq_length, seq_results, seq_frames = seq_runs
    glob = timed("global", phase_global, seq_results, seq_gt, seq_length, dev)
    multi, multi_kernels = timed("multi", phase_multi, seq_frames, seq_results, f0, f1,
                                 cfg, dev)
    for k, rows in multi_kernels["kernels"].items():
        report[k]["multi_rank"] = rows
    entry_points, launches_cli = timed("entry_points", phase_entry_points, dev,
                                       runtime_build, seq_frames, seq_gt, stereo_frames_kept)
    del seq_frames, stereo_frames_kept
    print(f"phases (wall s): {phase_s}")
    print(f"elapsed: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"batched": batched, "ba": ba_report, "orb": orb,
                      "sequence": sequence, "stereo": stereo, "loop": loop,
                      "five_point": five, "global": glob, "multi": multi,
                      "entry_points": entry_points, "phase_s": phase_s}))
    kernels = [
        {"name": k, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[k], "launches_per_orb_step": orb["launches_per_step"][k],
         "launches_per_pyramid_orb_step": orb["pyramid"]["launches_per_step"][k],
         "launches_sequence": sequence["launches"][k],
         "launches_stereo": stereo["launches"][0][k], "launches_loop": loop["launches"][k],
         "launches_loop_stage": loop["launches_stage"][k],
         "launches_per_loop_call": loop["launches_per_call"][k],
         "launches_per_five_point_step": five["launches_per_step"][k],
         "launches_multi_rank": multi_kernels["launches"][k],
         "launches_multi_rank_run": multi_kernels["run"][k],
         "launches_multi_rank_retry": multi_kernels["retry"][k],
         "launches_cli": launches_cli[k], **report[k]}
        for k, (src, rep) in KERNELS.items()
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
