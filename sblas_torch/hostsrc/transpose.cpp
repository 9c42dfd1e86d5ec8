// The CSR of a matrix's transpose by a counting sort on the columns, for
// sblas_torch.formats.csr_transpose (the IC(0) preconditioner's L^T, the
// transposed SpMV operand, CSR.tocsc). Built with the other hostsrc/*.cpp
// into one library (sblas_torch/native.py) and loaded with ctypes.
//
// Two passes over the entries: one counts each column's entries into the
// transpose's indptr, one scatters row ids and values in row order to the
// next free slot of their column. Entries of one column so keep their order
// of the input, as a stable sort by column would: the result equals
// formats.csr_transpose_plain's for any input, sorted or not, duplicates
// included. O(m + n + nnz). Values are copied as bits, by their width
// (4, 8 or 16 bytes: f32, f64 or c64, c128). Returns 0, or -1 where a
// column index lies outside [0, n); the caller has checked indptr.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Bits16 {
  uint64_t lo, hi;
};

template <typename T>
int32_t transpose(const int32_t* indptr, const int32_t* indices,
                  const T* data, int64_t m, int64_t n, int32_t* t_indptr,
                  int32_t* t_indices, T* t_data) {
  const int64_t nnz = indptr[m];
  std::memset(t_indptr, 0, sizeof(int32_t) * (n + 1));
  for (int64_t k = 0; k < nnz; ++k) {
    const int32_t j = indices[k];
    if (j < 0 || j >= n) return -1;
    ++t_indptr[j + 1];
  }
  for (int64_t j = 0; j < n; ++j) t_indptr[j + 1] += t_indptr[j];
  std::vector<int32_t> next(t_indptr, t_indptr + n);
  for (int64_t i = 0; i < m; ++i) {
    for (int32_t k = indptr[i]; k < indptr[i + 1]; ++k) {
      const int32_t p = next[indices[k]]++;
      t_indices[p] = static_cast<int32_t>(i);
      t_data[p] = data[k];
    }
  }
  return 0;
}

}  // namespace

extern "C" int32_t sblas_torch_csr_transpose(
    const int32_t* indptr, const int32_t* indices, const void* data,
    int64_t m, int64_t n, int64_t value_bytes, int32_t* t_indptr,
    int32_t* t_indices, void* t_data) {
  switch (value_bytes) {
    case 4:
      return transpose(indptr, indices, static_cast<const uint32_t*>(data),
                       m, n, t_indptr, t_indices,
                       static_cast<uint32_t*>(t_data));
    case 8:
      return transpose(indptr, indices, static_cast<const uint64_t*>(data),
                       m, n, t_indptr, t_indices,
                       static_cast<uint64_t*>(t_data));
    case 16:
      return transpose(indptr, indices, static_cast<const Bits16*>(data),
                       m, n, t_indptr, t_indices,
                       static_cast<Bits16*>(t_data));
    default:
      return -2;
  }
}
