"""One-core baseline of the windowed BA solve (the port's counterpart of
``baselines/native_ba.py``): the native multi-zeta LM looped serially over
the bench's windows on ONE CPU core.

The reference's BA consumer thread solves one ws=3 window at a time
(``kitti_ba.cpp:757-905``: assemble the constraints, call
``Levenberg_Marquardt``, revert on a high residual). This script replays
that loop over the window tensors the bench solves on the card
(``bench_ba_workload.npz``, or a rebuilt copy of it), through the native
windowed LM (``epivo_tpu_torch/runtime/lm_ref.cpp::epivo_lm_windowed``, a
byte-equal copy of the reference's: flat arrays, analytic Jacobians, a
hand-rolled Cholesky).

The pinning is the caller's: run it under ``taskset -c 0``, or pass
``--pin CPU`` to pin the process itself. It refuses to time unless the
process may run on exactly one CPU:

    taskset -c 0 python3 -m epivo_tpu_torch.tools.native_ba bench_ba_workload.npz

Prints one JSON line: ``{"ba_windows_per_s": ..., "ba_iters_per_s": ...,
"n_windows": ..., "iters_per_pass": ..., "note": ..., "cpus": [...]}``.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

N_WARMUP = 1
N_REPS = 3

# LM schedule: must match bench._ba_config (ref `kitti_ba.cpp:1044`,
# `jac_Rt_gen_.cpp:17,323`).
LAMBDA0 = 1e-2
MAX_ITERS = 30
HUBER_DELTA = 1e-5
EPSILON = 1e-8

KEYS = ("T0s", "p", "p_t", "wreps", "pmask", "reps")


def solve_all(runtime, data):
    total_iters = 0
    for w in range(data["T0s"].shape[0]):
        _, _, _, iters = runtime.lm_windowed(
            data["T0s"][w], data["reps"], data["p"][w], data["p_t"][w],
            wreps=data["wreps"][w], pmask=data["pmask"][w],
            lambda0=LAMBDA0, max_iters=MAX_ITERS, huber_delta=HUBER_DELTA,
            epsilon=EPSILON,
        )
        total_iters += iters
    return total_iters


def one_cpu(pin: int | None = None) -> list:
    """The CPUs this process may run on, after pinning it to ``pin`` when
    given. Raises SystemExit unless that is exactly one CPU: a baseline
    timed on more cores is not the one-core execution model."""
    if pin is not None:
        os.sched_setaffinity(0, {pin})
    cpus = sorted(os.sched_getaffinity(0))
    if len(cpus) != 1:
        raise SystemExit(f"refusing to time on CPUs {cpus}: pin the process to one CPU "
                         "(taskset -c 0, or --pin)")
    return cpus


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("workload", help="the bench's BA windows (an npz of bench.build_ba_workload)")
    ap.add_argument("--pin", type=int, default=None,
                    help="pin this process to this CPU (where taskset is missing)")
    args = ap.parse_args(argv)
    cpus = one_cpu(args.pin)

    import torch

    from epivo_tpu_torch import runtime

    torch.set_num_threads(1)
    runtime.build()
    z = np.load(args.workload)
    data = {k: np.asarray(z[k]) for k in KEYS}
    W = data["T0s"].shape[0]

    for _ in range(N_WARMUP):
        solve_all(runtime, data)
    best = float("inf")
    iters = 0
    for _ in range(N_REPS):
        t0 = time.perf_counter()
        iters = solve_all(runtime, data)
        best = min(best, time.perf_counter() - t0)

    out = {
        "ba_windows_per_s": W / best,
        "ba_iters_per_s": iters / best,
        "n_windows": W,
        "iters_per_pass": iters,
        "note": "native windowed multi-zeta LM, 1 core, serial windows "
                "(no Eigen heap traffic: faster than the reference's own "
                "implementation)",
        "cpus": cpus,
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
