"""Windowed bundle adjustment, plain: a frozen copy of the port's
``pipeline/ba.py::ba_windows`` (``_solve``) for the mono window of size 3
at stride 2, on one batched LM with the window axis first."""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import lm
from benchmark.reference.vo import precision


def mono_reps(ws: int = 3) -> np.ndarray:
    """The window's constraint spans: consecutive pairs, then the anchor
    skip constraint (``ba.mono_window_spec``)."""
    n_zeta = ws - 1
    reps = [(j, j) for j in range(n_zeta)]
    if ws >= 3:
        reps.append((0, n_zeta - 1))
    return np.asarray(reps, np.int64)


def windows(T0s, p, p_t, wreps, pmask, lm_cfg: dict, ws: int = 3,
            lowp: bool = False) -> dict:
    """All windows' solves: T0s [W, Z, 4, 4], p / p_t [W, R, N, 3], wreps
    [W, R], pmask [W, R, N] (tensors on one device). Returns T_opt, r_norm,
    reverted and n_accepted, each with a leading [W]. ``lowp`` runs every
    matmul and einsum in TF32."""
    with precision(lowp):
        reps = torch.as_tensor(mono_reps(ws), device=T0s.device)
        res = lm.solve_batched(T0s, reps, p, p_t, wreps=wreps, pmask=pmask,
                               lambda0=lm_cfg["lambda0"], epsilon=lm_cfg["epsilon"],
                               max_iters=lm_cfg["max_iters"],
                               huber_delta=lm_cfg["huber_delta"])
        reverted = res.r_norm > lm_cfg["revert_r_norm"]
        T_opt = torch.where(reverted[:, None, None, None], T0s, res.T0s)
        return dict(T_opt=T_opt, r_norm=res.r_norm, reverted=reverted,
                    n_accepted=res.n_accepted)
