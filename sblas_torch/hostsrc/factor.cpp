// Incomplete factorizations on the host, in f64, for the preconditioners
// of sblas_torch/solvers.py: the port's own copy of sblas_ic0_f64 and
// sblas_ilu0_f64 from the JAX package's native helpers. Built with g++ into
// build/sblas_torch/ at first use (sblas_torch/native.py) and loaded with
// ctypes; the factors then go to the card's triangular-solve kernel.

#include <cmath>
#include <cstdint>
#include <vector>

// IC(0): incomplete Cholesky on the pattern of tril(A), in place.
// Input: CSR of tril(A) (columns ascending, diagonal present as the last
// entry of each row), values overwritten with L such that L L^T ~= A.
// Returns 0, or (i+1) if the pivot of row i was non-positive (breakdown:
// the caller may shift the diagonal and retry).
extern "C" int64_t sblas_ic0_f64(const int32_t* indptr,
                                 const int32_t* indices,
                                 double* data, int64_t n) {
  for (int64_t i = 0; i < n; ++i) {
    const int32_t p0 = indptr[i], p1 = indptr[i + 1];
    // columns ascending; diagonal last
    for (int32_t p = p0; p < p1 - 1; ++p) {
      const int32_t k = indices[p];
      // dot of row i prefix [p0, p) with row k's sub-diagonal part,
      // two-pointer merge over sorted columns
      double dot = 0.0;
      const int32_t k0 = indptr[k], k1 = indptr[k + 1] - 1;  // excl diag
      int32_t a = p0, b = k0;
      while (a < p && b < k1) {
        const int32_t ca = indices[a], cb = indices[b];
        if (ca == cb) { dot += data[a] * data[b]; ++a; ++b; }
        else if (ca < cb) ++a;
        else ++b;
      }
      const double lkk = data[indptr[k + 1] - 1];
      data[p] = (data[p] - dot) / lkk;
    }
    double diag = data[p1 - 1];
    for (int32_t p = p0; p < p1 - 1; ++p) diag -= data[p] * data[p];
    if (!(diag > 0.0)) return i + 1;
    data[p1 - 1] = sqrt(diag);
  }
  return 0;
}

// ILU(0): incomplete LU on the pattern of A (square CSR, columns ascending,
// full diagonal), in place: IKJ sweep with a column-position work array.
// On return data holds L (strictly lower, unit diagonal implicit) and U
// (diagonal + strictly upper). Returns 0, or (i+1) if row i hit a zero
// pivot or a missing diagonal (the caller may shift the diagonal and retry).
extern "C" int64_t sblas_ilu0_f64(const int32_t* indptr,
                                  const int32_t* indices,
                                  double* data, int64_t n) {
  std::vector<int32_t> diag(n, -1);
  std::vector<int32_t> pos(n, -1);
  for (int64_t i = 0; i < n; ++i) {
    const int32_t p0 = indptr[i], p1 = indptr[i + 1];
    for (int32_t p = p0; p < p1; ++p) pos[indices[p]] = p;
    int64_t bad = 0;
    for (int32_t p = p0; p < p1 && indices[p] < i; ++p) {
      const int32_t k = indices[p];
      const double ukk = data[diag[k]];
      if (ukk == 0.0) { bad = (int64_t)k + 1; break; }
      const double lik = data[p] / ukk;
      data[p] = lik;
      for (int32_t q = diag[k] + 1; q < indptr[k + 1]; ++q) {
        const int32_t pj = pos[indices[q]];
        if (pj >= 0) data[pj] -= lik * data[q];
      }
    }
    if (!bad) {
      const int32_t pd = pos[i];
      if (pd < 0 || data[pd] == 0.0) bad = i + 1;
      else diag[i] = pd;
    }
    for (int32_t p = p0; p < p1; ++p) pos[indices[p]] = -1;
    if (bad) return bad;
  }
  return 0;
}
