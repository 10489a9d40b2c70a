"""Run one cell of ``BENCHMARK.json`` once on the card and print its result.

    python3 -m benchmark.run --workload kitti00_vo.offline_b32 --seed 7 --seconds 20 --trace 0

Sets up (frames or windows from the seed, the warm-up of every shape the
cell uses), measures for ``--seconds``, with ``--trace 1`` profiles a
short stretch after the window, then compares what the timed path
produced with the plain reference. The last line of standard output is
one JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each
number compared beside its limit); the same numbers are the last lines of
standard error. Exits 2 without a card (or with fewer than the cell
needs) and 3 if JAX or the JAX package is loaded, printing no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

# One process with few threads: the host's cores are shared, and a graph
# replay's launch is host work (BLAS and OpenMP pools are read at import).
for _var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[_var] = "1"


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    from benchmark.harness import guard, spec as spec_mod

    try:
        cell = spec_mod.cell(args.workload)
    except (KeyError, FileNotFoundError) as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    import torch

    torch.set_num_threads(1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"benchmark: {args.workload} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    from benchmark.harness import cell as cell_mod

    result, checks = cell_mod.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                                       torch.device("cuda", 0), T_START)
    loaded = guard.forbidden_modules()
    if loaded:
        print(f"benchmark: the run loaded {', '.join(loaded)}", file=sys.stderr)
        return 3
    for c in checks:
        print(f"check {c.name} {c.value!r} limit {c.limit!r} "
              f"{'ok' if c.ok else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
