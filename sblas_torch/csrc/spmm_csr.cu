// nnz-balanced (merge-path) CSR SpMM for Hopper (sm_90a):
//   Y_out = alpha * A @ X + beta * Y_in,   X (n, K) and Y (m, K) row-major f32.
// K = 1 is SpMV.
//
// Replaces four TPU kernels that compute this one function over a CSR
// matrix with irregular rows (power-law graphs):
//   sblas/ops/kernels/spmv_pseg.py:37   _kernel       PSEG SpMV: hub windows
//                                                     plus panel-bound tail rounds;
//   sblas/ops/kernels/spmm_pseg.py:134  _kernel       PSEG SpMM, X resident,
//                                                     kc columns a pass;
//   sblas/ops/kernels/spmm_pseg.py:350  _kernel_kres  PSEG SpMM grouped by y,
//                                                     Xt streamed in chunks;
//   sblas/ops/kernels/spmm_pallas.py:30 _kernel       w-SELL SpMM, one column
//                                                     at a time.
// They differ only in how the PSEG and w-SELL layouts get around Mosaic's
// lack of a gather, and in what they keep in VMEM. Hopper gathers natively
// and X stays in device memory and L2, so one kernel over plain CSR serves
// all four.
//
// What bounds it on an H100: bytes. The CSR stream nnz * (val_bytes + 4),
// plus the X rows it gathers (K floats a nonzero, from L2 where X fits
// there), plus Y. 2 * K flops a nonzero are far below the ridge point.
// What hurts on a power-law graph is balance, not arithmetic: a row of
// 387,101 nonzeros (twitter7 at 2% scale) given to one lane group is a
// serial loop on one SM. So:
//
//   * the work is split by merged path over row ends and nonzeros (Merrill
//     and Garland, SC'16): the host (sblas_torch/ops/kernels/spmm_csr.py,
//     merge_path) gives each warp an equal share of rows + nonzeros and
//     passes one (row, nonzero) start per warp. A long row is spread over
//     many warps;
//   * inside its share a warp takes rows by groups of G lanes (G from the
//     mean row length, as the csr SpMV kernel does), each lane striding
//     over the row's nonzeros and keeping KC columns of K (1, 4, 8 or 16)
//     in registers: one value and index load serves every column of the
//     chunk, X's row slice comes as 16-byte loads where K allows. A row
//     slice longer than 8 G goes to the whole warp instead. Sums meet by
//     shuffles; the K-chunks of one share run on neighbouring warps;
//   * no atomics. A row that a warp finishes is written by it, with the
//     alpha/beta epilogue fused. The row a share ends inside leaves its
//     partial sums in carry[share, :]; a row a share begins inside is
//     written raw, and a second small launch (spmm_csr_fixup) adds the
//     carries of the shares before it, from the nearest back, and applies
//     alpha/beta. Results are the same from run to run.
//
// Rows with no nonzeros write beta * Y_in (0 without Y_in); nnz = 0,
// m != n and any K need no padding.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;  // 4 warps, one share each
constexpr int kWarps = kThreads / 32;
constexpr int kFixThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float load_value(const float* p) { return __ldg(p); }

__device__ __forceinline__ float load_value(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// acc[q] += v * X[c, k0 + q] for the KC columns of the chunk (none past K).
// `vec`: K is a multiple of 4 and X 16-byte aligned.
template <int KC>
__device__ __forceinline__ void fma_row(float (&acc)[KC], float v, const float* __restrict__ x,
                                        int c, int k, int k0, bool vec) {
  const float* src = x + static_cast<long long>(c) * k + k0;
  if constexpr (KC == 1) {
    acc[0] = fmaf(v, __ldg(src), acc[0]);
  } else {
    if (vec) {
#pragma unroll
      for (int p = 0; p < KC / 4; ++p) {
        if (k0 + 4 * p < k) {
          const float4 x4 = __ldg(reinterpret_cast<const float4*>(src) + p);
          acc[4 * p + 0] = fmaf(v, x4.x, acc[4 * p + 0]);
          acc[4 * p + 1] = fmaf(v, x4.y, acc[4 * p + 1]);
          acc[4 * p + 2] = fmaf(v, x4.z, acc[4 * p + 2]);
          acc[4 * p + 3] = fmaf(v, x4.w, acc[4 * p + 3]);
        }
      }
    } else {
#pragma unroll
      for (int q = 0; q < KC; ++q) {
        if (k0 + q < k) acc[q] = fmaf(v, __ldg(src + q), acc[q]);
      }
    }
  }
}

// Share `unit` covers merged-path items part[2u] + part[2u+1] ..: rows
// r0 .. r1 and nonzeros j0 .. j1. Rows r0 .. r1-1 end inside it; row r1
// (when r1 < m) is cut by its end and goes to the carry.
template <typename V, int KC, int G>
__global__ void __launch_bounds__(kThreads)
spmm_csr_kernel(int m, int k, int units, const int* __restrict__ indptr,
                const int* __restrict__ indices, const V* __restrict__ values,
                const int* __restrict__ part, const float* __restrict__ x,
                const float* __restrict__ y_in, float alpha, float beta,
                float* __restrict__ y_out, float* __restrict__ carry, bool vec) {
  constexpr int kGroups = 32 / G;
  const int chunks = (k + KC - 1) / KC;
  const long long w = static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32;
  if (w >= static_cast<long long>(units) * chunks) return;  // the warp leaves together
  const int unit = static_cast<int>(w / chunks);
  const int k0 = static_cast<int>(w % chunks) * KC;
  const int lane = threadIdx.x & 31;
  const int g = lane / G;
  const int gl = lane % G;
  const int r0 = __ldg(part + 2 * unit);
  const int j0 = __ldg(part + 2 * unit + 1);
  const int r1 = __ldg(part + 2 * unit + 2);
  const int j1 = __ldg(part + 2 * unit + 3);
  const int rows = r1 - r0 + (r1 < m ? 1 : 0);
  // the share's first row began in an earlier share: written raw, fixed up
  const bool first_cut = __ldg(indptr + r0) < j0;

  // the sum s of row r, column k0 + q, to where it belongs
  auto emit = [=](int r, int q, float s) {
    if (r == r1) {
      carry[static_cast<long long>(unit) * k + k0 + q] = s;
      return;
    }
    const long long idx = static_cast<long long>(r) * k + k0 + q;
    if (r == r0 && first_cut) {
      y_out[idx] = s;
      return;
    }
    float out = alpha * s;
    if (y_in != nullptr) out += beta * y_in[idx];
    y_out[idx] = out;
  };

  for (int base = 0; base < rows; base += kGroups) {
    const int i = base + g;
    int r = -1, s = 0, e = 0;
    if (i < rows) {
      r = r0 + i;
      s = max(__ldg(indptr + r), j0);
      e = min(__ldg(indptr + r + 1), j1);
    }
    const bool is_long = e - s > 8 * G;
    float acc[KC];
#pragma unroll
    for (int q = 0; q < KC; ++q) acc[q] = 0.0f;
    if (!is_long) {
      for (int j = s + gl; j < e; j += G) {
        fma_row<KC>(acc, load_value(values + j), x, __ldg(indices + j), k, k0, vec);
      }
    }
    // every lane takes part, so the full mask holds; offsets stay in the group
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1) {
#pragma unroll
      for (int q = 0; q < KC; ++q) acc[q] += __shfl_xor_sync(kFull, acc[q], off);
    }
    if (i < rows && !is_long) {
#pragma unroll
      for (int q = 0; q < KC; ++q) {
        if (q % G == gl && k0 + q < k) emit(r, q, acc[q]);
      }
    }
    // this round's long rows: the whole warp, one row at a time
    unsigned longs = __ballot_sync(kFull, i < rows && is_long && gl == 0);
    while (longs != 0u) {
      const int src = __ffs(longs) - 1;
      longs &= longs - 1u;
      const int lr = __shfl_sync(kFull, r, src);
      const int ls = __shfl_sync(kFull, s, src);
      const int le = __shfl_sync(kFull, e, src);
      float a2[KC];
#pragma unroll
      for (int q = 0; q < KC; ++q) a2[q] = 0.0f;
      for (int j = ls + lane; j < le; j += 32) {
        fma_row<KC>(a2, load_value(values + j), x, __ldg(indices + j), k, k0, vec);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
        for (int q = 0; q < KC; ++q) a2[q] += __shfl_xor_sync(kFull, a2[q], off);
      }
#pragma unroll
      for (int q = 0; q < KC; ++q) {
        if (q == lane && k0 + q < k) emit(lr, q, a2[q]);
      }
    }
  }
}

// One thread per (cut row, column): the raw sum of the share that ends the
// row, plus the carries of the shares before it, nearest first; then
// alpha/beta.
__global__ void __launch_bounds__(kFixThreads)
spmm_csr_fixup(int k, int nfix, const int* __restrict__ indptr, const int* __restrict__ part,
               const int* __restrict__ fix, const float* __restrict__ carry,
               const float* __restrict__ y_in, float alpha, float beta,
               float* __restrict__ y_out) {
  const long long t = static_cast<long long>(blockIdx.x) * kFixThreads + threadIdx.x;
  if (t >= static_cast<long long>(nfix) * k) return;
  const int f = static_cast<int>(t / k);
  const int q = static_cast<int>(t % k);
  int b = fix[f];
  const int r = part[2 * b];
  const int start = indptr[r];
  const long long idx = static_cast<long long>(r) * k + q;
  float s = y_out[idx];
  for (;;) {
    --b;
    s += carry[static_cast<long long>(b) * k + q];
    // share b began inside row r too: its predecessor carries more of it
    if (part[2 * b] != r || part[2 * b + 1] <= start) break;
  }
  float out = alpha * s;
  if (y_in != nullptr) out += beta * y_in[idx];
  y_out[idx] = out;
}

struct Args {
  int m, n, k, units, nfix;
  const int *indptr, *indices, *part, *fix;
  const void* values;
  const float *x, *y_in;
  float alpha, beta;
  float *y_out, *carry;
  cudaStream_t stream;
};

template <typename V, int KC, int G>
cudaError_t launch_main(const Args& a) {
  const long long warps = static_cast<long long>(a.units) * ((a.k + KC - 1) / KC);
  const long long ctas = (warps + kWarps - 1) / kWarps;
  if (ctas > 0x7fffffffLL) return cudaErrorInvalidValue;
  const bool vec = a.k % 4 == 0 && reinterpret_cast<uintptr_t>(a.x) % 16 == 0;
  spmm_csr_kernel<V, KC, G><<<static_cast<unsigned>(ctas), kThreads, 0, a.stream>>>(
      a.m, a.k, a.units, a.indptr, a.indices, static_cast<const V*>(a.values), a.part, a.x,
      a.y_in, a.alpha, a.beta, a.y_out, a.carry, vec);
  return cudaGetLastError();
}

// K-chunk: 1 for K = 1, else the smallest of 4, 8, 16 that holds K, else 16.
template <typename V, int G>
cudaError_t launch_chunk(const Args& a) {
  if (a.k == 1) return launch_main<V, 1, G>(a);
  if (a.k <= 4) return launch_main<V, 4, G>(a);
  if (a.k <= 8) return launch_main<V, 8, G>(a);
  return launch_main<V, 16, G>(a);
}

template <typename V>
int launch(const Args& a, int group) {
  if (a.m <= 0 || a.n < 0 || a.k <= 0 || a.units <= 0 || a.nfix < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err;
  switch (group) {
    case 2:
      err = launch_chunk<V, 2>(a);
      break;
    case 4:
      err = launch_chunk<V, 4>(a);
      break;
    case 8:
      err = launch_chunk<V, 8>(a);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  if (err != cudaSuccess || a.nfix == 0) return static_cast<int>(err);
  const long long threads = static_cast<long long>(a.nfix) * a.k;
  const long long blocks = (threads + kFixThreads - 1) / kFixThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  spmm_csr_fixup<<<static_cast<unsigned>(blocks), kFixThreads, 0, a.stream>>>(
      a.k, a.nfix, a.indptr, a.part, a.fix, a.carry, a.y_in, a.alpha, a.beta, a.y_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One entry point per value type. `group` is the lanes per row (2, 4 or 8);
// `part` holds units + 1 (row, nonzero) pairs of int32, the merge-path
// start of each share and the end; `fix` the nfix shares whose first row
// began in an earlier share; `carry` room for units * k floats. Pointers
// are device pointers on the current device, `y_in` may be null (then beta
// is not read), `stream` is the caller's cudaStream_t on that device. Every
// launch goes on that stream. Returns the cudaError_t of the launches (0 on
// success).
#define SBLAS_SPMM_CSR_ENTRY(NAME, V)                                                     \
  extern "C" int NAME(int m, int n, int k, int group, int units, int nfix,                \
                      const void* indptr, const void* indices, const void* values,        \
                      const void* part, const void* fix, const void* x,                   \
                      const void* y_in, float alpha, float beta, void* y_out,             \
                      void* carry, void* stream) {                                        \
    const Args a{m,                                                                       \
                 n,                                                                       \
                 k,                                                                       \
                 units,                                                                   \
                 nfix,                                                                    \
                 static_cast<const int*>(indptr),                                         \
                 static_cast<const int*>(indices),                                        \
                 static_cast<const int*>(part),                                           \
                 static_cast<const int*>(fix),                                            \
                 values,                                                                  \
                 static_cast<const float*>(x),                                            \
                 static_cast<const float*>(y_in),                                         \
                 alpha,                                                                   \
                 beta,                                                                    \
                 static_cast<float*>(y_out),                                              \
                 static_cast<float*>(carry),                                              \
                 static_cast<cudaStream_t>(stream)};                                      \
    return launch<V>(a, group);                                                           \
  }

SBLAS_SPMM_CSR_ENTRY(sblas_spmm_csr_f32, float)
SBLAS_SPMM_CSR_ENTRY(sblas_spmm_csr_bf16, __nv_bfloat16)
