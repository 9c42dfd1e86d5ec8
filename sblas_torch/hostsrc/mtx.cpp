// The body of a MatrixMarket coordinate file, parsed on the host: the
// port's own copy of sblas_parse_mtx_body from the JAX package's native
// helpers, writing 64-bit indices. Built with the other hostsrc/*.cpp into
// one library (sblas_torch/native.py) and loaded with ctypes.
//
// Reads up to nnz entries "row col [value]" from buf (len bytes, followed
// by a NUL, as a Python bytes object is), skipping blank space and lines
// that start with '%'. Indices go from 1-based to 0-based; with
// has_value == 0 every value is 1.0. Returns the entries parsed (fewer
// than nnz for a short body), or -1 where a token is not a number.

#include <cstdint>
#include <cstdlib>

extern "C" int64_t sblas_torch_parse_mtx_body(const char* buf, int64_t len,
                                              int64_t nnz, int32_t has_value,
                                              int64_t* rows, int64_t* cols,
                                              double* vals) {
  const char* p = buf;
  const char* const end = buf + len;
  int64_t count = 0;
  while (count < nnz && p < end) {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r'))
      ++p;
    if (p >= end) break;
    if (*p == '%') {
      while (p < end && *p != '\n') ++p;
      continue;
    }
    char* next;
    const long long r = strtoll(p, &next, 10);
    if (next == p) return -1;
    p = next;
    const long long c = strtoll(p, &next, 10);
    if (next == p) return -1;
    p = next;
    double v = 1.0;
    if (has_value) {
      v = strtod(p, &next);
      if (next == p) return -1;
      p = next;
    }
    rows[count] = r - 1;
    cols[count] = c - 1;
    vals[count] = v;
    ++count;
  }
  return count;
}
