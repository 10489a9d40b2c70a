"""The readings that a cell's limits are set from, on the card: for each
seed, a run's set-up, a short window at the cell's own load, and the
comparison of what the timed path produced with the reference; for the
control seeds also the reference computed in the lower precision
(``reference.vo.precision``: TF32) against the reference,
and where the driver has one, a rounding witness (the reference on inputs
moved by one ulp) against the reference.
The benchmark's own runs never run this.

    python3 -m benchmark.calibrate --workload kitti00_ba.windows_seq00 \\
        --seeds 1,2,3 --control-seeds 1,2,3 --seconds 4 --out chiprun_out/cal.jsonl

One JSON line per seed on standard output (and appended to ``--out``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

for _var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[_var] = "1"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--control-seeds", default="", help="comma-separated")
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    from benchmark.harness import cell as cell_mod, spec as spec_mod

    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    cell = spec_mod.cell(args.workload)
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.perf_counter()
        drv = cell_mod.driver(cell, seed, dev)
        drv.setup()
        setup_s = time.perf_counter() - t0
        win = drv.window(args.seconds)
        drv.release()
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        line = {"workload": args.workload, "seed": seed, "setup_s": setup_s,
                "e2e": win["e2e"], "note": win.get("note"), "check": drv.check()}
        line["check_s"] = time.perf_counter() - t1
        if seed in controls:
            line["control"] = drv.control()
            if hasattr(drv, "witness"):
                line["witness"] = drv.witness()
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
        del drv
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
