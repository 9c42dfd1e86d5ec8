// Dependency levels of a triangular CSR matrix for the triangular solves:
// the port's own copy of sblas_level_schedule_lower/_upper from the JAX
// package's native helpers. Built with the other hostsrc/*.cpp into one
// library (sblas_torch/native.py) and loaded with ctypes.
//
// level[i] = 1 + max(level[j]) over the stored entries on the strict side
// of the diagonal (j < i for lower, j > i for upper), 0 with none. Rows
// are in dependency order by index, so one sweep over the entries is
// enough: O(n + nnz). Returns the number of levels (0 for n = 0), or -1
// where a strict-side index lies outside [0, n).

#include <cstdint>

extern "C" int32_t sblas_torch_levels_lower(const int32_t* indptr,
                                            const int32_t* indices,
                                            int64_t n, int32_t* levels) {
  int32_t nlevels = 0;
  for (int64_t i = 0; i < n; ++i) {
    int32_t lvl = 0;
    for (int32_t k = indptr[i]; k < indptr[i + 1]; ++k) {
      const int32_t j = indices[k];
      if (j < i) {
        if (j < 0) return -1;
        if (levels[j] + 1 > lvl) lvl = levels[j] + 1;
      }
    }
    levels[i] = lvl;
    if (lvl + 1 > nlevels) nlevels = lvl + 1;
  }
  return nlevels;
}

extern "C" int32_t sblas_torch_levels_upper(const int32_t* indptr,
                                            const int32_t* indices,
                                            int64_t n, int32_t* levels) {
  int32_t nlevels = 0;
  for (int64_t i = n - 1; i >= 0; --i) {
    int32_t lvl = 0;
    for (int32_t k = indptr[i]; k < indptr[i + 1]; ++k) {
      const int32_t j = indices[k];
      if (j > i) {
        if (j >= n) return -1;
        if (levels[j] + 1 > lvl) lvl = levels[j] + 1;
      }
    }
    levels[i] = lvl;
    if (lvl + 1 > nlevels) nlevels = lvl + 1;
  }
  return nlevels;
}
