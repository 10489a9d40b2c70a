"""Back-to-back window solves through ``pipeline.ba.ba_windows``, called as
``runners._solve_windows`` calls it: the windows uploaded from numpy, one
call on all of a sequence's windows, and one packed copy of T_opt, r_norm,
reverted and n_accepted back to the host.

The windows come from ``window_sets`` sets made from ``--seed`` at set-up
(``yardstick.ba_windows``); call c solves set c mod ``window_sets``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.harness import compare, stats, trace
from benchmark.reference import ba as ref_ba
from benchmark.yardstick import ba_windows as gen_mod

KEYS = ("T0s", "p", "p_t", "wreps", "pmask")

# The traffic's overrides for the CPU rehearsal and for the card's control
# test, and the port function that the rehearsal's faults wrap.
REHEARSAL = dict(windows_per_call=16, window_sets=2, warmup_calls=1)
CONTROL = dict(windows_per_call=512, check_calls=1)
FAULT_TARGET = "ba_windows"


class Driver:
    def __init__(self, cell, seed: int, device: torch.device):
        self.cfg, self.traffic, self.seed, self.dev = cell.config, cell.traffic, seed, device
        self.W = self.traffic["windows_per_call"]
        self.results = {}

    def setup(self) -> None:
        from benchmark.harness import port

        self.sets = [gen_mod.make(compare.derive(self.seed, "windows", i), self.W,
                                  self.cfg["camera"], self.cfg["windows"],
                                  self.cfg["lm"]["n_points"])
                     for i in range(self.traffic["window_sets"])]
        self.config, self.spec = port.ba_config(self.cfg)
        for c in range(self.traffic["warmup_calls"]):
            self._call(c)

    def _call(self, c: int) -> np.ndarray:
        """One solve of set c mod window_sets: the packed host result [W,
        Z * 16 + 3]."""
        from epivo_tpu_torch.pipeline import ba

        w = self.sets[c % len(self.sets)]
        with trace.span("upload"):
            up = {k: torch.from_numpy(np.ascontiguousarray(w[k])).to(self.dev) for k in KEYS}
        with trace.span("window_call"):
            out = ba.ba_windows(up["T0s"], self.spec, up["p"], up["p_t"], wreps=up["wreps"],
                                pmask=up["pmask"], config=self.config)
        with trace.span("fetch"):
            W = out.T_opt.shape[0]
            return torch.cat([out.T_opt.reshape(W, -1), out.r_norm[:, None],
                              out.reverted.to(out.r_norm.dtype)[:, None],
                              out.n_accepted.to(out.r_norm.dtype)[:, None]], -1).cpu().numpy()

    def window(self, seconds: float) -> dict:
        t0 = time.perf_counter()
        c = 0
        walls = []
        while time.perf_counter() - t0 < seconds:
            t1 = time.perf_counter()
            self.results[c] = self._call(c)
            walls.append(time.perf_counter() - t1)
            c += 1
        elapsed = time.perf_counter() - t0
        failed = sum(int((~np.isfinite(h).all(-1)).sum()) for h in self.results.values())
        return {"e2e": {"ba_windows_per_s": stats.rate(c * self.W, elapsed)}, "attempted": c * self.W,
                "failed": failed, "wall_per_call_s": elapsed / c,
                "note": {"calls": c, "call_s": walls}}

    def traced(self) -> trace.TraceSummary:
        n = self.traffic["traced_calls"]
        c0 = len(self.results)
        return trace.profile(lambda: [self._call(c0 + i) for i in range(n)], n)

    def sample(self) -> list[int]:
        rng = np.random.default_rng(compare.derive(self.seed, "sample"))
        calls = sorted(self.results)
        n = min(self.traffic["check_calls"], len(calls))
        return sorted(rng.choice(calls, n, replace=False).tolist())

    def release(self) -> None:
        chosen = set(self.sample())
        self.results = {c: h for c, h in self.results.items() if c in chosen}

    def _reference(self, c: int, lowp: bool, ulp: bool = False) -> dict:
        w = self.sets[c % len(self.sets)]
        up = {k: torch.from_numpy(np.ascontiguousarray(w[k])).to(self.dev) for k in KEYS}
        if ulp:  # every initial pose entry moved by one unit in the last place
            rng = np.random.default_rng(c)
            T = w["T0s"]
            up["T0s"] = torch.from_numpy(np.where(rng.random(T.shape) < 0.5,
                                                  np.nextafter(T, np.inf),
                                                  np.nextafter(T, -np.inf))).to(self.dev)
        r = ref_ba.windows(up["T0s"], up["p"], up["p_t"], up["wreps"], up["pmask"],
                           self.cfg["lm"], ws=self.cfg["window"]["size"], lowp=lowp)
        return {k: v.cpu().numpy() for k, v in r.items()}

    def _of_program(self, h: np.ndarray) -> dict:
        W, Z = h.shape[0], self.cfg["window"]["size"] - 1
        return dict(T_opt=h[:, :-3].reshape(W, Z, 4, 4), r_norm=h[:, -3],
                    reverted=h[:, -2] > 0.5, n_accepted=h[:, -1].astype(np.int64))

    def check(self) -> dict:
        return _merge([readings(self._of_program(self.results[c]), self._reference(c, False))
                       for c in sorted(self.results)])

    def control(self) -> dict:
        return _merge([readings(self._reference(c, True), self._reference(c, False))
                       for c in sorted(self.results)])

    def witness(self) -> dict:
        """The readings that rounding alone gives: the reference on initial
        poses moved by one ulp, against the reference."""
        return _merge([readings(self._reference(c, False, ulp=True),
                                self._reference(c, False)) for c in sorted(self.results)])


def _merge(rs: list[dict]) -> dict:
    """The worst of each reading over the checked calls."""
    return {k: max(r[k] for r in rs) for k in rs[0]}


def readings(got: dict, ref: dict) -> dict:
    """Gaps between two solves of the same windows: the worst, the 90th
    percentile and the median over every window's zetas of the rotation
    and translation gaps and over the windows of the residual norm's, the
    windows whose revert differs, and the largest gap in accepted steps."""
    rot = compare.rot_gap(got["T_opt"][..., :3, :3], ref["T_opt"][..., :3, :3])
    tg = got["T_opt"][..., :3, 3].astype(np.float64)
    tr = ref["T_opt"][..., :3, 3].astype(np.float64)
    trans = np.linalg.norm(tg - tr, axis=-1) / np.maximum(np.linalg.norm(tr, axis=-1), 1e-9)
    rn = compare.rel_gap(got["r_norm"], ref["r_norm"], 1e-9)
    return {
        **compare.spread("rot", rot),
        **compare.spread("trans", trans),
        **compare.spread("r_norm", rn),
        "reverted": float((got["reverted"] != ref["reverted"]).sum()),
        "n_accepted": compare.worst(np.abs(got["n_accepted"].astype(np.int64)
                                           - ref["n_accepted"].astype(np.int64))),
    }
