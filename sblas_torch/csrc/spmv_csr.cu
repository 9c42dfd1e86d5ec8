// CSR SpMV for Hopper (sm_90a): y_out = alpha * A @ x + beta * y_in.
//
// Replaces the TPU kernels sblas/ops/kernels/spmv_pallas.py:_kernel (f32)
// and sblas/ops/kernels/spmv_wsell_ds.py:_kernel_ds (f64 class). The first
// computes the product over the w-SELL layout: per (8 x 128) round it
// gathers x from a two-panel window with the Mosaic lane gather, multiplies,
// segment-sums each row through a 0/1 matrix on the MXU (split3) and
// accumulates into a y that stays in VMEM. The second carries every value
// and x entry as two f32 (hi + lo) with Dekker products and a two_sum lane
// butterfly, because Mosaic has no f64. Every one of those pieces exists
// because of the TPU; this kernel computes what they compute, not how. The
// f64 build runs the same body in IEEE double: Hopper has native FP64, and
// one rounding per FMA is at least as accurate as the double-single error
// model (~max_deg * 2^-48).
//
// What bounds it on an H100: bytes. Each nonzero streams one value (4 B in
// f32, 2 B in bf16, 8 B in f64) and one int32 column index, so the nnz
// stream is about 8 B/nnz in f32, 6 in bf16 and 12 in f64, against 2 flops.
// That is far below the card's ridge point (FP64 too: 34 TFLOP/s against
// 3.35 TB/s), so the design only keeps the stream coalesced:
//
//   * plain CSR straight from the host arrays, no packing step;
//   * csr-vector: a group of G lanes (a power of two in 2..32, picked by the
//     caller from the mean row length) owns one row and strides over its
//     nonzeros, so neighbouring lanes load neighbouring indices and values;
//     x is gathered through the read-only path (__ldg). The caller's rule
//     (spmv_csr.group_size) follows chip_smoke.py's group sweep (PERF.md):
//     G = 8 at 58-112 nonzeros per row, and 16 at 110 in the f64 build;
//   * T-typed FMA accumulation (T = float for f32 and bf16 values, bf16
//     upcast in registers; T = double for f64 values, x and y); on a row of
//     more than G * kSumBlock nonzeros a lane sums its share in blocks of
//     kSumBlock products, so that the rows of 10^5+ nonzeros of a web graph
//     keep f32 accuracy;
//   * a shuffle reduction inside the group, then a fused alpha/beta
//     epilogue by the group's first lane. y_in == nullptr means "no y" and
//     is never read;
//   * one launch, no atomics: results are the same from run to run.
//
// Rows without entries write alpha * 0 (+ beta * y_in). No thread reads
// past indptr[m].

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;  // threads per block; a multiple of every G
constexpr unsigned kSumBlock = 256;  // products a lane sums before acc

__device__ __forceinline__ float load_value(const float* p) { return __ldg(p); }

__device__ __forceinline__ float load_value(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ double load_value(const double* p) {
  return __ldg(p);
}

__device__ __forceinline__ float fma_t(float a, float b, float c) {
  return fmaf(a, b, c);
}

__device__ __forceinline__ double fma_t(double a, double b, double c) {
  return fma(a, b, c);
}

// The G lanes of a row are consecutive and aligned inside one warp. The
// shuffle mask names only them, because other groups of the warp may have
// left already.
template <int G>
__device__ __forceinline__ unsigned group_mask() {
  if constexpr (G == 32) {
    return 0xffffffffu;
  } else {
    return ((1u << G) - 1u) << ((threadIdx.x & 31u) & ~(G - 1u));
  }
}

// V: the stored value type; T: the type of x, y, alpha, beta and the sums
template <typename V, typename T, int G>
__global__ void __launch_bounds__(kBlock)
spmv_csr_vector(int m, const int* __restrict__ indptr,
                const int* __restrict__ indices, const V* __restrict__ values,
                const T* __restrict__ x, const T* __restrict__ y_in,
                T alpha, T beta, T* __restrict__ y_out) {
  const long long row =
      (static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x) / G;
  if (row >= m) return;  // the G lanes of a row leave together
  const unsigned lane = threadIdx.x & (G - 1);
  // unsigned: j + G stays below 2^32 for any nnz < 2^31
  const unsigned begin = static_cast<unsigned>(__ldg(indptr + row));
  const unsigned end = static_cast<unsigned>(__ldg(indptr + row + 1));
  T acc = 0;
  if (end - begin <= G * kSumBlock) {
    for (unsigned j = begin + lane; j < end; j += G) {
      acc = fma_t(load_value(values + j), __ldg(x + __ldg(indices + j)), acc);
    }
  } else {
    // A longer row: each lane sums its share in blocks of kSumBlock
    // products and adds the blocks' sums into acc. On a row of 387,101
    // nonzeros one register would otherwise take ~48,000 products one
    // after the other, and its rounding error grows with that count.
    // (A row of one block takes the loop above: 0 + part is exact, so
    // both loops give the same bits there; the plain loop is the faster.)
    for (unsigned j0 = begin + lane; j0 < end; j0 += G * kSumBlock) {
      const unsigned stop = min(end, j0 + G * kSumBlock);
      T part = 0;
      for (unsigned j = j0; j < stop; j += G) {
        part = fma_t(load_value(values + j), __ldg(x + __ldg(indices + j)),
                     part);
      }
      acc += part;
    }
  }
  const unsigned mask = group_mask<G>();
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) {
    acc += __shfl_down_sync(mask, acc, off, G);
  }
  if (lane == 0) {
    T r = alpha * acc;
    if (y_in != nullptr) r += beta * y_in[row];
    y_out[row] = r;
  }
}

template <typename V, typename T, int G>
cudaError_t launch_group(int m, const void* indptr, const void* indices,
                         const void* values, const void* x, const void* y_in,
                         T alpha, T beta, void* y_out, cudaStream_t stream) {
  const long long threads = static_cast<long long>(m) * G;
  const unsigned blocks = static_cast<unsigned>((threads + kBlock - 1) / kBlock);
  spmv_csr_vector<V, T, G><<<blocks, kBlock, 0, stream>>>(
      m, static_cast<const int*>(indptr), static_cast<const int*>(indices),
      static_cast<const V*>(values), static_cast<const T*>(x),
      static_cast<const T*>(y_in), alpha, beta, static_cast<T*>(y_out));
  return cudaGetLastError();
}

template <typename V, typename T>
int launch(int m, int group, const void* indptr, const void* indices,
           const void* values, const void* x, const void* y_in, T alpha,
           T beta, void* y_out, void* stream) {
  if (m <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (group) {
    case 2:
      err = launch_group<V, T, 2>(m, indptr, indices, values, x, y_in, alpha, beta, y_out, s);
      break;
    case 4:
      err = launch_group<V, T, 4>(m, indptr, indices, values, x, y_in, alpha, beta, y_out, s);
      break;
    case 8:
      err = launch_group<V, T, 8>(m, indptr, indices, values, x, y_in, alpha, beta, y_out, s);
      break;
    case 16:
      err = launch_group<V, T, 16>(m, indptr, indices, values, x, y_in, alpha, beta, y_out, s);
      break;
    case 32:
      err = launch_group<V, T, 32>(m, indptr, indices, values, x, y_in, alpha, beta, y_out, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // namespace

// One entry point per value type: f32 and bf16 values take f32 x, y, alpha
// and beta; f64 values take f64 x, y, alpha and beta. Pointers are device
// pointers on the current device; `stream` is the caller's cudaStream_t on
// that device (a stream of another device fails the launch). Returns the
// cudaError_t of the launch (0 on success).
extern "C" int sblas_spmv_csr_f32(int m, int group, const void* indptr,
                                  const void* indices, const void* values,
                                  const void* x, const void* y_in,
                                  float alpha, float beta, void* y_out,
                                  void* stream) {
  return launch<float, float>(m, group, indptr, indices, values, x, y_in,
                              alpha, beta, y_out, stream);
}

extern "C" int sblas_spmv_csr_bf16(int m, int group, const void* indptr,
                                   const void* indices, const void* values,
                                   const void* x, const void* y_in,
                                   float alpha, float beta, void* y_out,
                                   void* stream) {
  return launch<__nv_bfloat16, float>(m, group, indptr, indices, values, x,
                                      y_in, alpha, beta, y_out, stream);
}

extern "C" int sblas_spmv_csr_f64(int m, int group, const void* indptr,
                                  const void* indices, const void* values,
                                  const void* x, const void* y_in,
                                  double alpha, double beta, void* y_out,
                                  void* stream) {
  return launch<double, double>(m, group, indptr, indices, values, x, y_in,
                                alpha, beta, y_out, stream);
}

extern "C" const char* sblas_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
