// The guarded Cholesky factorization shared by K8 (mvn_fit.cu) and K13
// (local_factor.cu).
//
// Replaces: pyabc_tpu/transition/util.py::device_chol_guarded and
// device_chol_guarded_batched (CHOL_JITTER_LADDER), whose factor comes from
// the first rung of the jitter ladder that factorizes: rung 0 is the
// matrix itself, then cov + (j tr) I for j = 1e-10, 1e-7, 1e-4 with
// tr = max(trace / d, 1e-30).
//
// Both functions work on any d x d row-major matrix with row stride ld
// (shared memory in K8's one block, a thread's local array in K13).
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace pyabc {

// max(x, lo) that keeps NaN (NaN compares false and stays NaN).
__device__ __forceinline__ float clamp_min_keep_nan(float x, float lo) {
  return x < lo ? lo : x;
}

// Cholesky of the lower triangle of the d x d matrix A (row stride ld)
// into L; false when a pivot is not positive (L is then NaN on and below
// the diagonal, 0 above, as jnp.linalg.cholesky's failed factor) or L is
// not finite.
__device__ inline bool cholesky(const float* A, float* L, int d, int ld) {
  for (int i = 0; i < d; ++i)
    for (int j = 0; j < d; ++j) L[i * ld + j] = 0.f;
  for (int j = 0; j < d; ++j) {
    float s = A[j * ld + j];
    for (int k = 0; k < j; ++k) s -= L[j * ld + k] * L[j * ld + k];
    if (!(s > 0.f)) {
      for (int i = 0; i < d; ++i)
        for (int k = 0; k < d; ++k) L[i * ld + k] = k <= i ? NAN : 0.f;
      return false;
    }
    const float ljj = sqrtf(s);
    L[j * ld + j] = ljj;
    for (int i = j + 1; i < d; ++i) {
      float t = A[i * ld + j];
      for (int k = 0; k < j; ++k) t -= L[i * ld + k] * L[j * ld + k];
      L[i * ld + j] = t / ljj;
    }
  }
  for (int i = 0; i < d; ++i)
    for (int j = 0; j < d; ++j)
      if (!isfinite(L[i * ld + j])) return false;
  return true;
}

// The jitter ladder on cov (modified in place into the covariance used;
// d <= 32). Returns the rung taken (0..3), or 4 when every rung failed
// (L NaN).
__device__ inline int chol_guarded(float* cov, float* L, int d, int ld) {
  const float ladder[3] = {1e-10f, 1e-7f, 1e-4f};
  if (cholesky(cov, L, d, ld)) return 0;
  float tr = 0.f;
  for (int k = 0; k < d; ++k) tr += cov[k * ld + k];
  tr = clamp_min_keep_nan(tr / (float)d, 1e-30f);
  float diag[32];
  for (int k = 0; k < d; ++k) diag[k] = cov[k * ld + k];
  for (int r = 0; r < 3; ++r) {
    const float jit = ladder[r] * tr;
    for (int k = 0; k < d; ++k) cov[k * ld + k] = diag[k] + jit;
    if (cholesky(cov, L, d, ld)) return r + 1;
  }
  return 4;
}

// Inverse of the lower-triangular L (row stride ld) into Linv by forward
// substitution, column by column; Linv's upper triangle is set to 0.
__device__ inline void tri_inverse(const float* L, float* Linv, int d,
                                   int ld) {
  for (int c = 0; c < d; ++c) {
    for (int i = 0; i < c; ++i) Linv[i * ld + c] = 0.f;
    Linv[c * ld + c] = 1.f / L[c * ld + c];
    for (int i = c + 1; i < d; ++i) {
      float t = 0.f;
      for (int k = c; k < i; ++k) t += L[i * ld + k] * Linv[k * ld + c];
      Linv[i * ld + c] = -t / L[i * ld + i];
    }
  }
}

}  // namespace pyabc
