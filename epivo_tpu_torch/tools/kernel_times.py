"""Device times of the ORB describe route and the LK kernel at the main
path's shapes, for comparing two checkouts of the port in one call.

Times ``orb.describe`` on CUDA tensors (whatever route the checkout takes
there: the ``orb_describe`` kernel, or the extraction kernel and the plain
chain before it) on the corridor pair's FAST keypoints at B = 2 (one ORB
step), 16 (a batched step), 64 (the sequence's ORB retry batch) and 30
half-resolution frames (the loop stage's keyframe stack); the describe
calls of one 8-level pyramid ORB step at B = 2 (threshold 40, 512
keypoints) and of the loop stage's describe call (``loopclose._describe_batch``
on 30 half-resolution frames, threshold 30), level by level and summed,
with that whole call's host time; and ``klt.lk_iterate_kernel`` on the
corridor pair's level-0 (S = 34) and level-3 (S = 46) LK inputs (K = 512,
12 iterations). Per describe call: its median host time around
synchronised calls, and from ``torch.profiler`` its device time and
device activities per call and the device time of the extraction and
describe kernels in it. Prints one JSON line.

Run on the card from the root of a checkout:

    python3 -m epivo_tpu_torch.tools.kernel_times

or on another checkout's package (its kernels build into its own
``build/``), e.g. a ``git archive`` of the parent in an ignored directory:

    PYTHONPATH=<other checkout> python3 epivo_tpu_torch/tools/kernel_times.py
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

# Kernels whose device time each describe row reports on its own.
KERNELS = {"extract": "extract_windows_kernel", "orb_describe": "orb_describe_kernel"}


def profiled(fn, reps: int = 20) -> dict:
    """From torch.profiler over ``reps`` calls of fn() after a warm-up call,
    per call: ``device_ms`` and ``activities`` of every device kernel, and
    ``<name>_ms`` for each kernel of :data:`KERNELS` and for
    ``lk_iterate_kernel`` (0.0 where the call runs none)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    ms = lambda es: sum(e.device_time_total for e in es) / 1e3 / reps
    out = {"device_ms": ms(kern), "activities": sum(e.count for e in kern) / reps}
    for name, key in {**KERNELS, "lk": "lk_iterate_kernel"}.items():
        out[f"{name}_ms"] = ms([e for e in kern if key in e.key])
    return out


def _host_ms(fn, reps: int = 20) -> float:
    """Median host ms of fn() between synchronises, after two warm-up calls."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def _describe_row(imgs, xy, valid=None) -> dict:
    from epivo_tpu_torch.frontend import orb

    call = lambda: orb.describe(imgs, xy, valid)
    return dict(shape=[*imgs.shape, *xy.shape[1:]], host_ms=_host_ms(call), **profiled(call))


def _levels(fn) -> dict:
    """The describe calls fn() makes, each timed on its own inputs, and
    their sums over the levels."""
    from epivo_tpu_torch.frontend import orb

    seen, describe = [], orb.describe

    def record(img, xy, valid=None, use_kernel=None):
        seen.append((img, xy, valid))
        return describe(img, xy, valid, use_kernel=use_kernel)

    orb.describe = record
    try:
        fn()
    finally:
        orb.describe = describe
    rows = [_describe_row(*args) for args in seen]
    keys = [k for k in rows[0] if k.endswith("ms") or k == "activities"]
    return dict(levels=rows, sum={k: sum(r[k] for r in rows) for k in keys})


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device", file=sys.stderr)
        return 1
    import epivo_tpu_torch
    from epivo_tpu_torch.datasets import photoreal
    from epivo_tpu_torch.frontend import fast, image, klt, orb
    from epivo_tpu_torch.pipeline import loopclose
    from epivo_tpu_torch.pipeline.config import LoopConfig

    dev = torch.device("cuda", 0)
    frames = lambda h, w: [torch.from_numpy(np.asarray(f, np.float32)).to(dev)
                           for f in photoreal.corridor_sequence(2, H=h, W=w, seed=0)[0]]
    f0, f1 = frames(376, 1241)
    h0, h1 = frames(188, 620)

    def stack(a, b, n):  # n frames: a and b in turns, lane i brightened by i * 1e-5
        eps = torch.arange(n, device=dev, dtype=torch.float32)[:, None, None] * 1e-5
        return (torch.stack([a, b] * (n // 2)) + eps).contiguous()

    out = {"package": epivo_tpu_torch.__file__, "describe": {}, "lk": {}}
    for name, imgs in (("B2", stack(f0, f1, 2)), ("B16", stack(f0, f1, 16)),
                       ("B64", stack(f0, f1, 64)), ("keyframes_B30", stack(h0, h1, 30))):
        xy = fast.detect(imgs, 40.0 if imgs.shape[-1] > 1000 else 30.0, 512).xy
        out["describe"][name] = _describe_row(imgs, xy)

    pair, keyframes = stack(f0, f1, 2), stack(h0, h1, 30)
    out["describe"]["pyramid_B2"] = _levels(
        lambda: orb.detect_and_describe_pyramid(pair, 40.0, 512))
    loop_call = lambda: loopclose._describe_batch(keyframes, LoopConfig(), 30.0)
    out["describe"]["loop_stage_B30"] = dict(_levels(loop_call), call_host_ms=_host_ms(loop_call),
                                             call=profiled(loop_call, 5))

    kp = fast.detect(f0, 40.0, 512)
    pyr0, pyr1 = image.build_pyramid(f0, 4), image.build_pyramid(f1, 4)
    for S, lvl in ((34, 0), (46, 3)):
        T, Ix, Iy, c_eff = klt._template(pyr0[lvl], kp.xy / 2.0 ** lvl, 21, S)
        tgt_wins, _, q0 = klt._target(pyr1[lvl], c_eff, 21, S)
        call = lambda: klt.lk_iterate_kernel(tgt_wins, T, Ix, Iy, q0, 21, 12, 0.01)
        out["lk"][f"S{S}"] = dict(host_ms=_host_ms(call), device_ms=profiled(call, 50)["lk_ms"])

    out["device"] = torch.cuda.get_device_name(0)
    out["nvidia_smi"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
