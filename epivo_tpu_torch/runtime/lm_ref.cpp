// Native single-pose Levenberg-Marquardt refine — baseline-fidelity kernel.
//
// Role: the benchmark baseline (`baselines/cv2_kitti_e.py`) re-executes the
// reference's kitti_E workload in its own execution model (C++ / one CPU
// core). OpenCV supplies the frontend (FAST/LK/findEssentialMat); this file
// supplies the reference's hand-written LM pose refinement step
// (`/root/reference/jac_Rt_gen_.cpp:287-478` with n_zeta=1, called at
// `kitti_E.cpp:196`) so the baseline pays a comparable native cost for it.
//
// This is an independent implementation of the dissertation's math — the
// same residual/Jacobian chain as epivo_tpu/geometry/epipolar.py (residual
// d = |P't|/|P'Rp|, X' = R(dp)+t, r = huber(|X'/z - p'|^2 / 2)), written
// against flat arrays with an analytic 6-dof generator Jacobian and a
// hand-rolled 6x6 Cholesky solve. No Eigen, no heap in the hot loop.
//
// Exported C ABI (ctypes):
//   epivo_lm_refine_pose(T[16] row-major in/out, p[3n], pt[3n], n,
//                        lambda0, max_iters, huber_delta, epsilon)
//   returns the number of accepted steps.

#include <cmath>
#include <cstring>

namespace {

struct Mat3 {
  double m[9];
};

inline void mat3_mul(const double* a, const double* b, double* out) {
  for (int i = 0; i < 3; i++)
    for (int j = 0; j < 3; j++) {
      double s = 0;
      for (int k = 0; k < 3; k++) s += a[3 * i + k] * b[3 * k + j];
      out[3 * i + j] = s;
    }
}

// T (4x4 row-major) = T @ exp(xi), xi = (tx, ty, tz, wx, wy, wz) —
// the multiplicative update convention of the optimizer core
// (epivo_tpu/optim/lm.py; ref update at jac_Rt_gen_.cpp:416-422).
void se3_exp_right_multiply(double* T, const double* xi) {
  const double wx = xi[3], wy = xi[4], wz = xi[5];
  const double th2 = wx * wx + wy * wy + wz * wz;
  const double th = std::sqrt(th2);
  // Rodrigues with small-angle guards.
  double A, B, C;
  if (th < 1e-9) {
    A = 1.0 - th2 / 6.0;
    B = 0.5 - th2 / 24.0;
    C = 1.0 / 6.0 - th2 / 120.0;
  } else {
    A = std::sin(th) / th;
    B = (1.0 - std::cos(th)) / th2;
    C = (1.0 - A) / th2;
  }
  const double K[9] = {0, -wz, wy, wz, 0, -wx, -wy, wx, 0};
  double K2[9];
  mat3_mul(K, K, K2);
  double R[9], V[9];
  for (int i = 0; i < 9; i++) {
    const double I = (i % 4 == 0) ? 1.0 : 0.0;
    R[i] = I + A * K[i] + B * K2[i];
    V[i] = I + B * K[i] + C * K2[i];
  }
  double t[3];
  for (int i = 0; i < 3; i++)
    t[i] = V[3 * i] * xi[0] + V[3 * i + 1] * xi[1] + V[3 * i + 2] * xi[2];

  double Tn[16];
  // Tn = T @ [R t; 0 1]
  for (int i = 0; i < 4; i++) {
    for (int j = 0; j < 3; j++) {
      double s = 0;
      for (int k = 0; k < 3; k++) s += T[4 * i + k] * R[3 * k + j];
      Tn[4 * i + j] = s;
    }
    Tn[4 * i + 3] = T[4 * i] * t[0] + T[4 * i + 1] * t[1] +
                    T[4 * i + 2] * t[2] + T[4 * i + 3];
  }
  std::memcpy(T, Tn, sizeof(Tn));
}

inline double huber(double s, double delta) {
  return (s <= delta) ? s : delta * (std::sqrt(s) - delta / 2.0);
}
inline double huber_deriv(double s, double delta) {
  return (s <= delta) ? 1.0 : delta / (2.0 * std::sqrt(s > 1e-300 ? s : 1e-300));
}

// Residual (and optionally the 6-dof Jacobian row) for one match under
// pose T. Returns the robustified residual; fills J[6] when non-null.
double point_residual(const double* T, const double* p, const double* pt,
                      double huber_delta, double* J) {
  const double R[9] = {T[0], T[1], T[2], T[4], T[5], T[6], T[8], T[9], T[10]};
  const double t[3] = {T[3], T[7], T[11]};
  const double xq = pt[0], yq = pt[1];
  // P' rows: (1, 0, -x'), (0, 1, -y')
  const double A0 = t[0] - xq * t[2];
  const double A1 = t[1] - yq * t[2];
  double Rp[3];
  for (int i = 0; i < 3; i++)
    Rp[i] = R[3 * i] * p[0] + R[3 * i + 1] * p[1] + R[3 * i + 2] * p[2];
  const double B0 = Rp[0] - xq * Rp[2];
  const double B1 = Rp[1] - yq * Rp[2];
  const double ATA = A0 * A0 + A1 * A1;
  const double BTB = B0 * B0 + B1 * B1;
  if (BTB < 1e-24 || ATA < 1e-24) {
    if (J) std::memset(J, 0, 6 * sizeof(double));
    return 0.0;
  }
  const double nA = std::sqrt(ATA), nB = std::sqrt(BTB);
  const double d = nA / nB;
  double X[3];
  for (int i = 0; i < 3; i++) X[i] = Rp[i] * d + t[i];
  if (std::fabs(X[2]) < 1e-12) {
    if (J) std::memset(J, 0, 6 * sizeof(double));
    return 0.0;
  }
  const double iz = 1.0 / X[2];
  const double ex = X[0] * iz - xq, ey = X[1] * iz - yq;
  const double s = 0.5 * (ex * ex + ey * ey);
  const double r = huber(s, huber_delta);
  if (!J) return r;

  // dT_k = T @ G_k, generators ordered (tx, ty, tz, wx, wy, wz).
  // For G of translation k: dR = 0, dt = column k of T's rotation.
  // For G of rotation k:    dR = R @ hat(e_k), dt = 0.
  const double drho = huber_deriv(s, huber_delta);
  for (int k = 0; k < 6; k++) {
    double dR[9] = {0, 0, 0, 0, 0, 0, 0, 0, 0};
    double dt[3] = {0, 0, 0};
    if (k < 3) {
      dt[0] = R[k];
      dt[1] = R[3 + k];
      dt[2] = R[6 + k];
    } else {
      const int a = k - 3;
      // hat(e_a) columns; dR = R * hat(e_a)
      double H[9] = {0, 0, 0, 0, 0, 0, 0, 0, 0};
      if (a == 0) { H[5] = -1; H[7] = 1; }      // hat(ex): (2,1)=1,(1,2)=-1
      if (a == 1) { H[2] = 1; H[6] = -1; }      // hat(ey): (0,2)=1,(2,0)=-1
      if (a == 2) { H[1] = -1; H[3] = 1; }      // hat(ez): (1,0)=1,(0,1)=-1
      mat3_mul(R, H, dR);
    }
    double dRp[3];
    for (int i = 0; i < 3; i++)
      dRp[i] = dR[3 * i] * p[0] + dR[3 * i + 1] * p[1] + dR[3 * i + 2] * p[2];
    const double JA0 = dt[0] - xq * dt[2];
    const double JA1 = dt[1] - yq * dt[2];
    const double JB0 = dRp[0] - xq * dRp[2];
    const double JB1 = dRp[1] - yq * dRp[2];
    // d d / d eps = ((|B|/|A|) A.JA - (|A|/|B|) B.JB) / |B|^2
    const double AdJA = A0 * JA0 + A1 * JA1;
    const double BdJB = B0 * JB0 + B1 * JB1;
    const double Jd = ((nB / nA) * AdJA - (nA / nB) * BdJB) / BTB;
    // J_X = dR (d p) + dt + Rp * Jd
    double JX[3];
    for (int i = 0; i < 3; i++) JX[i] = dRp[i] * d + dt[i] + Rp[i] * Jd;
    // e^T J_Pi J_X, with J_Pi rows (1/z, 0, -x/z^2), (0, 1/z, -y/z^2)
    const double px = X[0] * iz, py = X[1] * iz;
    const double g0 = ex * iz;
    const double g1 = ey * iz;
    const double g2 = -(ex * px + ey * py) * iz;
    J[k] = drho * (g0 * JX[0] + g1 * JX[1] + g2 * JX[2]);
  }
  return r;
}

// In-place Cholesky solve of the 6x6 SPD system H x = -b. Returns false on
// a non-positive pivot.
bool solve6(double H[36], const double b[6], double x[6]) {
  double L[36];
  std::memcpy(L, H, sizeof(L));
  for (int i = 0; i < 6; i++) {
    for (int j = 0; j <= i; j++) {
      double s = L[6 * i + j];
      for (int k = 0; k < j; k++) s -= L[6 * i + k] * L[6 * j + k];
      if (i == j) {
        if (s <= 0) return false;
        L[6 * i + j] = std::sqrt(s);
      } else {
        L[6 * i + j] = s / L[6 * j + j];
      }
    }
  }
  double y[6];
  for (int i = 0; i < 6; i++) {
    double s = -b[i];
    for (int k = 0; k < i; k++) s -= L[6 * i + k] * y[k];
    y[i] = s / L[6 * i + i];
  }
  for (int i = 5; i >= 0; i--) {
    double s = y[i];
    for (int k = i + 1; k < 6; k++) s -= L[6 * k + i] * x[k];
    x[i] = s / L[6 * i + i];
  }
  return true;
}

}  // namespace

extern "C" int epivo_lm_refine_pose(double* T, const double* p,
                                    const double* pt, int n, double lambda0,
                                    int max_iters, double huber_delta,
                                    double epsilon) {
  double lambda = lambda0;
  double prev_E = 1e300;
  int accepted = 0;
  for (int it = 0; it < max_iters; it++) {
    double H[36] = {0};
    double b[6] = {0};
    double J[6];
    double E = 0;
    for (int i = 0; i < n; i++) {
      const double r = point_residual(T, p + 3 * i, pt + 3 * i, huber_delta, J);
      E += r * r;
      for (int a = 0; a < 6; a++) {
        b[a] += J[a] * r;
        for (int c = a; c < 6; c++) H[6 * a + c] += J[a] * J[c];
      }
    }
    for (int a = 0; a < 6; a++)
      for (int c = 0; c < a; c++) H[6 * a + c] = H[6 * c + a];
    if (it == 0) prev_E = E;
    // Damping: H + lambda * diag(H) (ref schedule /2, x5,
    // jac_Rt_gen_.cpp:456-467), plus a tiny absolute floor.
    double Hd[36];
    std::memcpy(Hd, H, sizeof(Hd));
    for (int a = 0; a < 6; a++)
      Hd[6 * a + a] += lambda * H[6 * a + a] + 1e-18;
    double delta[6];
    if (!solve6(Hd, b, delta)) {
      lambda *= 5.0;
      continue;
    }
    double dn = 0;
    for (int a = 0; a < 6; a++) dn += delta[a] * delta[a];
    if (!(dn == dn)) break;               // NaN guard (ref :407-410)
    if (std::sqrt(dn) < epsilon) break;   // small-step exit (ref :412-414)
    double Tc[16];
    std::memcpy(Tc, T, sizeof(Tc));
    se3_exp_right_multiply(Tc, delta);
    double Ec = 0;
    for (int i = 0; i < n; i++) {
      const double r = point_residual(Tc, p + 3 * i, pt + 3 * i, huber_delta,
                                      nullptr);
      Ec += r * r;
    }
    if (Ec < prev_E) {
      std::memcpy(T, Tc, sizeof(Tc));
      prev_E = Ec;
      lambda /= 2.0;
      accepted++;
    } else {
      lambda *= 5.0;
    }
  }
  return accepted;
}

// ---------------------------------------------------------------------------
// Windowed multi-zeta LM — the reference's full Levenberg_Marquardt
// (`/root/reference/jac_Rt_gen_.cpp:287-478`): joint optimization of Z
// relative poses over R weighted reprojection constraints with forward
// zeta spans (the mono/stereo window shapes of `kitti_ba.cpp:757-905`).
// Used by the BA benchmark baseline (`baselines/native_ba.py`) so the
// windows/s comparison pays native single-core cost for the whole solver.
//
// Chain-rule structure: a constraint spanning zetas [z0, z1] sees the
// composed pose T_comp = T_{z1} ... T_{z0}; embedding the update at zeta k
// (T_k <- T_k exp(e)) gives T(e) = T_comp * exp(Adj(B^-1) e) with
// B = T_{k-1} ... T_{z0}, so the per-zeta Jacobian block is the
// right-tangent point Jacobian at T_comp times the 6x6 adjoint of B^-1 —
// the flat-array equivalent of the reference's RepJacobian::compute
// left/right frames (`jac_Rt_gen_.cpp:262-284`).

namespace {

constexpr int kMaxZ = 8;            // poses per window (mono ws<=9)
constexpr int kMaxDim = 6 * kMaxZ;  // normal-equation dimension

inline void mat4_mul(const double* a, const double* b, double* out) {
  for (int i = 0; i < 4; i++)
    for (int j = 0; j < 4; j++) {
      double s = 0;
      for (int k = 0; k < 4; k++) s += a[4 * i + k] * b[4 * k + j];
      out[4 * i + j] = s;
    }
}

inline void mat4_identity(double* out) {
  std::memset(out, 0, 16 * sizeof(double));
  out[0] = out[5] = out[10] = out[15] = 1.0;
}

// SE(3) inverse: (R, t) -> (R^T, -R^T t).
inline void se3_inverse(const double* T, double* out) {
  mat4_identity(out);
  for (int i = 0; i < 3; i++)
    for (int j = 0; j < 3; j++) out[4 * i + j] = T[4 * j + i];
  for (int i = 0; i < 3; i++) {
    double s = 0;
    for (int j = 0; j < 3; j++) s += out[4 * i + j] * T[4 * j + 3];
    out[4 * i + 3] = -s;
  }
}

// 6x6 adjoint of X = (R, t) in (v, w) twist order:
// Adj = [[R, hat(t) R], [0, R]]  (X exp(xi) X^-1 = exp(Adj xi)).
inline void se3_adjoint(const double* T, double* A /* 36 */) {
  const double R[9] = {T[0], T[1], T[2], T[4], T[5], T[6], T[8], T[9], T[10]};
  const double t[3] = {T[3], T[7], T[11]};
  const double ht[9] = {0, -t[2], t[1], t[2], 0, -t[0], -t[1], t[0], 0};
  double htR[9];
  mat3_mul(ht, R, htR);
  std::memset(A, 0, 36 * sizeof(double));
  for (int i = 0; i < 3; i++)
    for (int j = 0; j < 3; j++) {
      A[6 * i + j] = R[3 * i + j];
      A[6 * i + (j + 3)] = htR[3 * i + j];
      A[6 * (i + 3) + (j + 3)] = R[3 * i + j];
    }
}

// General n x n Cholesky solve of H x = -b (in-place scratch). False on a
// non-positive pivot.
bool solveN(const double* H, const double* b, double* x, int n) {
  double L[kMaxDim * kMaxDim];
  std::memcpy(L, H, n * n * sizeof(double));
  for (int i = 0; i < n; i++) {
    for (int j = 0; j <= i; j++) {
      double s = L[n * i + j];
      for (int k = 0; k < j; k++) s -= L[n * i + k] * L[n * j + k];
      if (i == j) {
        if (s <= 0) return false;
        L[n * i + j] = std::sqrt(s);
      } else {
        L[n * i + j] = s / L[n * j + j];
      }
    }
  }
  double y[kMaxDim];
  for (int i = 0; i < n; i++) {
    double s = -b[i];
    for (int k = 0; k < i; k++) s -= L[n * i + k] * y[k];
    y[i] = s / L[n * i + i];
  }
  for (int i = n - 1; i >= 0; i--) {
    double s = y[i];
    for (int k = i + 1; k < n; k++) s -= L[n * k + i] * x[k];
    x[i] = s / L[n * i + i];
  }
  return true;
}

// Weighted window energy: sum over constraints of w^2 * sum r_i^2.
double window_energy(const double* T0s, int Z, const int* reps,
                     const double* wreps, int R, const double* p,
                     const double* pt, const unsigned char* pmask, int N,
                     double huber_delta) {
  double E = 0;
  for (int r = 0; r < R; r++) {
    const double w = wreps ? wreps[r] : 1.0;
    if (w == 0.0) continue;
    const int z0 = reps[2 * r], z1 = reps[2 * r + 1];
    double Tc[16];
    mat4_identity(Tc);
    for (int k = z0; k <= z1; k++) {  // T_comp = T_{z1} ... T_{z0}
      double tmp[16];
      mat4_mul(T0s + 16 * k, Tc, tmp);
      std::memcpy(Tc, tmp, sizeof(tmp));
    }
    for (int i = 0; i < N; i++) {
      if (pmask && !pmask[r * N + i]) continue;
      const double ri =
          point_residual(Tc, p + 3 * (r * N + i), pt + 3 * (r * N + i),
                         huber_delta, nullptr);
      E += w * w * ri * ri;
    }
  }
  return E;
}

}  // namespace

// Joint windowed LM. T0s: Z row-major 4x4 poses (in/out); reps: R (z0, z1)
// forward spans (z0 <= z1); wreps: R weights (null = all 1); p/pt:
// [R, N, 3] normalized matches; pmask: [R, N] validity (null = all valid).
// Writes the final weighted residual norm to *r_norm_out (if non-null) and
// the number of LM iterations executed to *iters_out. Returns accepted
// step count.
extern "C" int epivo_lm_windowed(double* T0s, int Z, const int* reps,
                                 const double* wreps, int R, const double* p,
                                 const double* pt, const unsigned char* pmask,
                                 int N, double lambda0, int max_iters,
                                 double huber_delta, double epsilon,
                                 double* r_norm_out, int* iters_out) {
  if (Z > kMaxZ) return -1;
  const int dim = 6 * Z;
  double lambda = lambda0;
  double prev_E =
      window_energy(T0s, Z, reps, wreps, R, p, pt, pmask, N, huber_delta);
  int accepted = 0;
  int it = 0;
  for (; it < max_iters; it++) {
    double H[kMaxDim * kMaxDim] = {0};
    double b[kMaxDim] = {0};
    // Per constraint: composed pose + per-zeta adjoints, then accumulate.
    for (int r = 0; r < R; r++) {
      const double w = wreps ? wreps[r] : 1.0;
      if (w == 0.0) continue;
      const int z0 = reps[2 * r], z1 = reps[2 * r + 1];
      double Tc[16];
      mat4_identity(Tc);
      double Adj[kMaxZ][36];  // Adj(B_k^-1), B_k = T_{k-1} ... T_{z0}
      double Bk[16];
      mat4_identity(Bk);
      for (int k = z0; k <= z1; k++) {
        double Binv[16];
        se3_inverse(Bk, Binv);
        se3_adjoint(Binv, Adj[k]);
        double tmp[16];
        mat4_mul(T0s + 16 * k, Bk, tmp);  // B_{k+1} = T_k ... T_{z0}
        std::memcpy(Bk, tmp, sizeof(tmp));
      }
      std::memcpy(Tc, Bk, sizeof(Tc));  // T_comp = T_{z1} ... T_{z0}

      double Jrow[kMaxDim];
      for (int i = 0; i < N; i++) {
        if (pmask && !pmask[r * N + i]) continue;
        double J6[6];
        const double ri =
            point_residual(Tc, p + 3 * (r * N + i), pt + 3 * (r * N + i),
                           huber_delta, J6);
        std::memset(Jrow, 0, dim * sizeof(double));
        for (int k = z0; k <= z1; k++)
          for (int c = 0; c < 6; c++) {
            double s = 0;
            for (int a = 0; a < 6; a++) s += J6[a] * Adj[k][6 * a + c];
            Jrow[6 * k + c] = w * s;
          }
        const double wr = w * ri;
        for (int a = 0; a < dim; a++) {
          if (Jrow[a] == 0.0) continue;
          b[a] += Jrow[a] * wr;
          for (int c = a; c < dim; c++) H[dim * a + c] += Jrow[a] * Jrow[c];
        }
      }
    }
    for (int a = 0; a < dim; a++)
      for (int c = 0; c < a; c++) H[dim * a + c] = H[dim * c + a];
    // Damping + relative Tikhonov floor (matches optim/lm.py:208-215).
    double trace = 0;
    for (int a = 0; a < dim; a++) trace += H[dim * a + a];
    const double floor_ = 1e-7 * (trace / dim + 1e-30);
    double Hd[kMaxDim * kMaxDim];
    std::memcpy(Hd, H, dim * dim * sizeof(double));
    for (int a = 0; a < dim; a++)
      Hd[dim * a + a] += lambda * H[dim * a + a] + floor_;
    double delta[kMaxDim];
    if (!solveN(Hd, b, delta, dim)) {
      lambda *= 5.0;
      continue;
    }
    double dn = 0;
    for (int a = 0; a < dim; a++) dn += delta[a] * delta[a];
    if (!(dn == dn)) break;              // NaN guard (ref :407-410)
    if (std::sqrt(dn) < epsilon) break;  // small-step exit (ref :412-414)
    double Tc[kMaxZ * 16];
    std::memcpy(Tc, T0s, 16 * Z * sizeof(double));
    for (int k = 0; k < Z; k++) se3_exp_right_multiply(Tc + 16 * k, delta + 6 * k);
    const double Ec =
        window_energy(Tc, Z, reps, wreps, R, p, pt, pmask, N, huber_delta);
    if (Ec < prev_E) {
      std::memcpy(T0s, Tc, 16 * Z * sizeof(double));
      prev_E = Ec;
      lambda /= 2.0;
      accepted++;
    } else {
      lambda *= 5.0;
    }
  }
  if (r_norm_out) *r_norm_out = std::sqrt(prev_E);
  if (iters_out) *iters_out = it;
  return accepted;
}
