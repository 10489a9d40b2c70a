"""Batched Nistér/Stewénius 5-point essential-matrix solver (port of
``epivo_tpu/geometry/fivepoint.py``).

Everything is batched over S minimal samples with fixed shapes, and runs
on the inputs' device with no host sync:

1. Nullspace: the 4-dim nullspace of the 5x9 constraint matrix by
   subspace inverse iteration on the ridge-shifted 9x9 normal matrix
   (``cholesky_ex`` and two triangular solves, then Gram-Schmidt).
2. Polynomial system: E = x X + y Y + z Z + W. The 10 cubic constraints
   (det E = 0 and 2 E E^T E - tr(E E^T) E = 0) are cubic forms in the
   entries of E; their coefficients over the 20 monomials of degree <= 3
   in (x, y, z) come from one static cubic-form tensor contracted with
   the basis three times (the reference expands Python dicts of
   monomials into thousands of elementwise operations; the sums here run
   in another order).
3. Stewenius reduction: Gauss-Jordan with virtual partial pivoting over
   the 10 degree-3 monomial columns, then the 10x10 action matrix of
   multiplication by x in the degree-<=2 basis.
4. Real eigenvalues without a nonsymmetric eigensolver: the action matrix
   is balanced, det(A - lambda I) is evaluated by pivoted elimination on a
   static log-spaced grid (in chunks of samples, so the [S, 513, 10, 10]
   grid stays bounded), and roots are isolated by sign changes and a
   fixed number of bisection steps.
5. Eigenvectors by inverse iteration (batched Gauss-Jordan solves); (y, z)
   read off the monomial-structured eigenvector.

Up to 10 candidate E per sample with a validity mask; RANSAC scores all
of them (``ransac.ransac_essential(solver="5pt")``).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from epivo_tpu_torch._device import constant
from epivo_tpu_torch.geometry import essential

# Monomial orders (exponent triples over x, y, z).
_B = [(2, 0, 0), (1, 1, 0), (0, 2, 0), (1, 0, 1), (0, 1, 1), (0, 0, 2),
      (1, 0, 0), (0, 1, 0), (0, 0, 1), (0, 0, 0)]  # degree <= 2 basis
_D3 = [(3, 0, 0), (2, 1, 0), (1, 2, 0), (0, 3, 0), (2, 0, 1), (1, 1, 1),
       (0, 2, 1), (1, 0, 2), (0, 1, 2), (0, 0, 3)]  # degree-3 monomials
_COLS = {m: i for i, m in enumerate(_D3 + _B)}  # 20 columns, [D3 | B]
_BIDX = {m: i for i, m in enumerate(_B)}
_D3IDX = {m: i for i, m in enumerate(_D3)}

# Sign-change probes over the eigenvalue range: 512 log-spaced probes
# resolve real-root pairs ~1.8% apart (closer pairs are invisible to sign
# counting, which sets the per-sample recall).
_GRID = 512
_BISECT = 36
_GRID_DECADES = 4.0  # log grid spans [radius * 10^-4, radius]
# Matrices per chunk of the grid's determinant evaluation: each [.., 10,
# 10] float32 intermediate of a chunk stays under ~420 MB.
_CHARFN_CHUNK = 1 << 20


@functools.lru_cache(maxsize=None)
def _cubic_forms() -> tuple[np.ndarray, np.ndarray]:
    """Static tables of the constraint matrix: (Q [10, 9, 9, 9], the 10
    constraints as cubic forms in vec(E) (row-major), and Mon [64, 20],
    which maps the basis-index triple (a, b, c) of the coefficients
    (x, y, z, 1) to its monomial column)."""
    Q = np.zeros((10, 9, 9, 9), np.float64)
    e = lambda i, j: 3 * i + j
    for (p0, p1, p2), sgn in (((0, 1, 2), 1.0), ((0, 2, 1), -1.0), ((1, 0, 2), -1.0),
                              ((1, 2, 0), 1.0), ((2, 0, 1), 1.0), ((2, 1, 0), -1.0)):
        Q[0, e(0, p0), e(1, p1), e(2, p2)] += sgn
    for i in range(3):
        for j in range(3):
            r = 1 + 3 * i + j
            for k in range(3):
                for l in range(3):
                    Q[r, e(i, k), e(l, k), e(l, j)] += 2.0  # 2 (E E^T E)_ij
                    Q[r, e(k, l), e(k, l), e(i, j)] -= 1.0  # tr(E E^T) E_ij
    unit = [(1, 0, 0), (0, 1, 0), (0, 0, 1), (0, 0, 0)]
    Mon = np.zeros((64, 20), np.float64)
    for a in range(4):
        for b in range(4):
            for c in range(4):
                m = tuple(unit[a][d] + unit[b][d] + unit[c][d] for d in range(3))
                Mon[16 * a + 4 * b + c, _COLS[m]] = 1.0
    return Q, Mon


def nullspace4(p: torch.Tensor, p_t: torch.Tensor, iters: int = 6) -> torch.Tensor:
    """4 orthonormal null vectors of the [S, 5, 9] constraint matrix.

    Subspace inverse iteration on AtA + ridge (rank <= 5, so the 4 zero
    eigenvalues are exact; convergence ratio is ridge/lambda_5). The
    factorization is ``cholesky_ex`` (no error check, so no host sync; the
    ridge keeps the matrix positive definite). Returns [S, 4, 3, 3] (basis
    matrices X, Y, Z, W).
    """
    A = essential.design_rows(p, p_t)  # [S, 5, 9]
    AtA = torch.einsum("...ni,...nj->...ij", A, A)
    dtype, dev = AtA.dtype, AtA.device
    eye9 = torch.eye(9, dtype=dtype, device=dev)
    tr = torch.diagonal(AtA, dim1=-2, dim2=-1).sum(-1)[..., None, None]
    M = AtA + 1e-6 * (tr + 1e-30) * eye9
    L = torch.linalg.cholesky_ex(M).L
    # cho_solve(L, I): two triangular solves.
    Y = torch.linalg.solve_triangular(L, eye9.expand(M.shape), upper=False)
    Minv = torch.linalg.solve_triangular(L.mT, Y, upper=True)
    # Fixed start block; deterministic, generic (the reference's draw).
    V0 = np.random.default_rng(12345).normal(size=(9, 4)).astype(np.float32)
    V = constant(V0, dtype, dev).expand(AtA.shape[:-2] + (9, 4))
    for _ in range(iters):
        V = torch.einsum("...ij,...jk->...ik", Minv, V)
        # Modified Gram-Schmidt over the 4 columns (unrolled).
        cols = []
        for c in range(4):
            v = V[..., :, c]
            for u in cols:
                v = v - torch.sum(v * u, dim=-1, keepdim=True) * u
            v = v / (torch.linalg.norm(v, dim=-1, keepdim=True) + 1e-30)
            cols.append(v)
        V = torch.stack(cols, dim=-1)
    basis = V.transpose(-1, -2)  # [S, 4, 9]
    return basis.reshape(basis.shape[:-1] + (3, 3))


def _constraint_matrix(basis: torch.Tensor) -> torch.Tensor:
    """[S, 10, 20] cubic-constraint coefficients over [_D3 | _B] monomials.

    basis: [S, 4, 3, 3] nullspace matrices (X, Y, Z, W); E = x X + y Y
    + z Z + W. Row 0 is det(E), rows 1-9 the entries (i, j) of
    2 E E^T E - tr(E E^T) E in row-major order.
    """
    S = basis.shape[0]
    Q, Mon = _cubic_forms()
    Bv = basis.reshape(S, 4, 9)
    Qt = constant(Q, basis.dtype, basis.device)
    T = torch.einsum("rijk,sai->sarjk", Qt, Bv)  # [S, 4, 10, 9, 9]
    T = torch.einsum("sarjk,sbj->sabrk", T, Bv)  # [S, 4, 4, 10, 9]
    T = torch.einsum("sabrk,sck->srabc", T, Bv)  # [S, 10, 4, 4, 4]
    return T.reshape(S, 10, 64) @ constant(Mon, basis.dtype, basis.device)


def _pivot(M: torch.Tensor, used: torch.Tensor, k: int):
    """Virtual partial pivoting on column k of [S, 10, C]: the pivot row
    (largest |entry| among the rows not used yet; first on ties), its
    value, the row itself and its one-hot mask."""
    col = torch.where(used, -1.0, torch.abs(M[:, :, k]))
    r = torch.argmax(col, dim=1)  # [S]
    pval = torch.gather(M[:, :, k], 1, r[:, None])[:, 0]
    prow = torch.gather(M, 1, r[:, None, None].expand(-1, 1, M.shape[-1]))[:, 0]
    is_piv = torch.arange(10, device=M.device)[None, :] == r[:, None]
    return r, pval, prow, is_piv


def _gauss_jordan_reduce(M: torch.Tensor):
    """Reduce [S, 10, 20] over the first 10 columns (virtual partial
    pivoting). Returns (C [S, 10, 10], ok [S]) with row k of C holding the
    degree-<=2 tail of the reduction of degree-3 monomial k:
    D3[k] = -sum_j C[k, j] * B[j] modulo the ideal."""
    S = M.shape[0]
    used = torch.zeros((S, 10), dtype=torch.bool, device=M.device)
    ok = torch.ones((S,), dtype=torch.bool, device=M.device)
    piv_rows = []
    for k in range(10):
        r, pval, prow, is_piv = _pivot(M, used, k)
        good = torch.abs(pval) > 1e-12
        ok = ok & good
        prow = prow / torch.where(good, pval, 1.0)[:, None]
        factor = torch.where(is_piv, 0.0, M[:, :, k])
        M = M - factor[:, :, None] * prow[:, None, :]
        M = torch.where(is_piv[:, :, None], prow[:, None, :], M)
        used = used | is_piv
        piv_rows.append(r)
    pr = torch.stack(piv_rows, dim=1)  # [S, 10] row of pivot for column k
    C = torch.gather(M[:, :, 10:], 1, pr[:, :, None].expand(-1, -1, 10))
    return C, ok


def _action_matrix_x(C: torch.Tensor) -> torch.Tensor:
    """Multiplication-by-x action matrix [S, 10, 10] in the _B basis: row i
    is the one-hot of x * B[i] where that stays in the basis, else minus
    the reduction row of the degree-3 monomial it reaches."""
    S = C.shape[0]
    eye = torch.eye(10, dtype=C.dtype, device=C.device)
    rows = []
    for b in _B:
        m = (b[0] + 1, b[1], b[2])
        rows.append(eye[_BIDX[m]].expand(S, 10) if m in _BIDX else -C[:, _D3IDX[m], :])
    return torch.stack(rows, dim=1)


def _balance(A: torch.Tensor, sweeps: int = 3):
    """Diagonal-similarity balancing (eigenvalues preserved): powers-of-2
    row/column norm equalization, ``sweeps`` passes over the rows.

    Returns (A_balanced, d) with A_b = D^-1 A D, D = diag(d): eigenvalues
    unchanged, eigenvectors v = D v_b.
    """
    n = A.shape[-1]
    A = A.clone()
    d = torch.ones(A.shape[:-2] + (n,), dtype=A.dtype, device=A.device)
    for _ in range(sweeps):
        for i in range(n):
            aii = torch.abs(A[..., i, i])
            r = torch.sum(torch.abs(A[..., i, :]), dim=-1) - aii
            c = torch.sum(torch.abs(A[..., :, i]), dim=-1) - aii
            safe = (r > 1e-30) & (c > 1e-30)
            # row i scales by 1/f, col i by f: equal norms at f = sqrt(r/c).
            f = torch.sqrt(torch.where(safe, r / torch.where(safe, c, 1.0), 1.0))
            f = torch.exp2(torch.round(torch.log2(torch.clamp(f, min=1e-30))))
            f = torch.clamp(f, 2.0**-8, 2.0**8)
            A[..., i, :] *= (1.0 / f)[..., None]
            A[..., :, i] *= f[..., None]
            d[..., i] *= f
    return A, d


def _det10(A: torch.Tensor) -> torch.Tensor:
    """Signed determinant of batched [.., 10, 10] via Gauss elimination
    with virtual partial pivoting (product of pivots x permutation
    parity); far better conditioned in float32 than an explicit
    characteristic polynomial."""
    batch = A.shape[:-2]
    M = A.reshape(-1, 10, 10)
    S = M.shape[0]
    used = torch.zeros((S, 10), dtype=torch.bool, device=M.device)
    det = torch.ones((S,), dtype=A.dtype, device=A.device)
    piv_rows = []
    for k in range(10):
        r, pval, prow, is_piv = _pivot(M, used, k)
        det = det * pval
        prow = prow / torch.where(torch.abs(pval) > 1e-38, pval, 1.0)[:, None]
        factor = torch.where(is_piv | used, 0.0, M[:, :, k])
        M = M - factor[:, :, None] * prow[:, None, :]
        used = used | is_piv
        piv_rows.append(r)
    pr = torch.stack(piv_rows, dim=1)  # [S, 10]
    ar = torch.arange(10, device=A.device)
    inv = torch.sum((pr[:, :, None] > pr[:, None, :]) & (ar[:, None] < ar[None, :])[None],
                    dim=(1, 2))
    sign = torch.where(inv % 2 == 0, 1.0, -1.0).to(A.dtype)
    return (det * sign).reshape(batch)


def _charfn(A: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """det(A - lam I): A [S, 10, 10], lam [S, G] -> [S, G], evaluated in
    chunks of samples of at most ``_CHARFN_CHUNK`` matrices."""
    eye = torch.eye(10, dtype=A.dtype, device=A.device)
    S, G = lam.shape
    step = max(1, _CHARFN_CHUNK // G)
    return torch.cat([_det10(A[s:s + step, None] - lam[s:s + step, :, None, None] * eye)
                      for s in range(0, S, step)])


def _real_roots(A: torch.Tensor, radius: torch.Tensor):
    """Up to 10 real eigenvalues of batched [S, 10, 10] matrices.

    Sign changes of det(A - lambda I) on a symmetric log-spaced grid
    (the spectrum can span 4 orders of magnitude), then fixed-iteration
    bisection. ``radius`` [S] bounds |eigenvalues| (Gershgorin after
    balancing).

    Returns (roots [S, 10], valid [S, 10]).
    """
    dtype, dev = A.dtype, A.device
    half = _GRID // 2  # points per sign
    mag = torch.pow(10.0, torch.linspace(-_GRID_DECADES, 0.0, half, dtype=dtype,
                                         device=dev))  # (1e-4 .. 1]
    tpl = torch.cat([-mag.flip(0), torch.zeros(1, dtype=dtype, device=dev), mag])
    lam = radius[:, None] * 1.05 * tpl[None]  # [S, G+1] ascending
    vals = _charfn(A, lam)
    sign = torch.sign(vals)
    change = (sign[:, :-1] * sign[:, 1:]) <= 0.0
    change = change & (torch.abs(vals[:, :-1]) + torch.abs(vals[:, 1:]) > 0.0)
    G = tpl.shape[0] - 1
    score = change.to(dtype) * 2.0 - torch.arange(G, dtype=dtype, device=dev)[None] * 1e-6
    # The first 10 sign changes (lax.top_k: the largest, lower index first).
    topv, topi = torch.sort(score, dim=-1, descending=True, stable=True)
    topv, topi = topv[:, :10], topi[:, :10]
    valid = topv > 0.5
    a = torch.gather(lam, 1, topi)
    b = torch.gather(lam, 1, topi + 1)
    fa = _charfn(A, a)
    for _ in range(_BISECT):
        m = 0.5 * (a + b)
        fm = _charfn(A, m)
        left = fa * fm <= 0.0
        a, b = torch.where(left, a, m), torch.where(left, m, b)
        fa = torch.where(left, fa, fm)
    return 0.5 * (a + b), valid


def _solve_gj(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched 10x10 Gauss-Jordan solve with virtual partial pivoting.
    A [S, 10, 10], b [S, 10] -> x [S, 10] (garbage where singular; callers
    mask)."""
    M = torch.cat([A, b[..., None]], dim=-1)  # [S, 10, 11]
    S = M.shape[0]
    used = torch.zeros((S, 10), dtype=torch.bool, device=M.device)
    piv_rows = []
    for k in range(10):
        r, pval, prow, is_piv = _pivot(M, used, k)
        prow = prow / torch.where(torch.abs(pval) > 1e-20, pval, 1.0)[:, None]
        factor = torch.where(is_piv, 0.0, M[:, :, k])
        M = M - factor[:, :, None] * prow[:, None, :]
        M = torch.where(is_piv[:, :, None], prow[:, None, :], M)
        used = used | is_piv
        piv_rows.append(r)
    pr = torch.stack(piv_rows, dim=1)
    return torch.gather(M[:, :, 10], 1, pr)


def five_point(p: torch.Tensor, p_t: torch.Tensor):
    """Batched 5-point minimal solver.

    p, p_t: [S, 5, 3] normalized matches. Returns (Es [S, 10, 3, 3],
    valid [S, 10]): up to 10 essential-matrix candidates per sample, each
    of unit Frobenius norm on the essential manifold.
    """
    S = p.shape[0]
    dtype, dev = p.dtype, p.device
    basis = nullspace4(p, p_t)  # [S, 4, 3, 3]
    M = _constraint_matrix(basis)
    # Row scaling (each constraint is homogeneous): improves GJ pivots.
    M = M / (torch.amax(torch.abs(M), dim=-1, keepdim=True) + 1e-30)
    C, ok = _gauss_jordan_reduce(M)
    Ax = _action_matrix_x(C)

    # Balancing tightens the Gershgorin radius to within a small factor of
    # the spectral radius (eigenvalues preserved).
    Axb, dbal = _balance(Ax)
    radius = torch.amax(torch.sum(torch.abs(Axb), dim=-1), dim=-1) + 1e-12  # [S]
    mu, root_ok = _real_roots(Axb, radius)  # [S, 10] eigenvalues (= x)

    # Eigenvectors by inverse iteration per root: solve
    # (Axb - mu I + eps) v = v0 twice (eps scale-aware).
    eyeb = torch.eye(10, dtype=dtype, device=dev)
    eps = (1e-6 * radius)[:, None, None, None]
    Ashift = Axb[:, None] - mu[:, :, None, None] * eyeb + eps * eyeb  # [S, 10, 10, 10]
    Af = Ashift.reshape(S * 10, 10, 10)
    v0 = np.random.default_rng(999).normal(size=(10,)).astype(np.float32)
    v = _solve_gj(Af, constant(v0, dtype, dev).expand(S * 10, 10))
    v = _solve_gj(Af, v / (torch.linalg.norm(v, dim=-1, keepdim=True) + 1e-30))
    v = v.reshape(S, 10, 10)
    # Undo the balancing similarity: the eigenvector of the original
    # action matrix is v = D v_balanced.
    v = v * dbal[:, None, :]

    w = v[:, :, 9]  # coefficient of the constant monomial
    w_ok = torch.abs(w) > 1e-12
    wsafe = torch.where(w_ok, w, 1.0)
    # x from the eigenvalue itself (more accurate than the vector ratio).
    x = mu
    y = v[:, :, 7] / wsafe
    z = v[:, :, 8] / wsafe

    Es = (x[..., None, None] * basis[:, None, 0]
          + y[..., None, None] * basis[:, None, 1]
          + z[..., None, None] * basis[:, None, 2]
          + basis[:, None, 3])  # [S, 10, 3, 3]
    n = torch.linalg.norm(Es.reshape(S, 10, 9), dim=-1)
    n_ok = n > 1e-12
    Es = Es / torch.where(n_ok, n, 1.0)[..., None, None]
    # Exact-manifold candidates: float32 root and eigenvector error leave
    # det(E) at up to ~1e-3; the closed-form 3x3 SVD projection pins the
    # singular values (1, 1, 0), renormalized to unit Frobenius norm.
    Es = essential.project_essential(Es) / math.sqrt(2.0)
    valid = ok[:, None] & root_ok & w_ok & n_ok
    return Es, valid
