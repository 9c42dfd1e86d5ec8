// nnz-balanced (merge-path) CSR SpMM for Hopper (sm_90a):
//   Y_out = alpha * A @ X + beta * Y_in,   X (n, K) and Y (m, K) row-major,
// f32 (values f32 or bf16) or f64. K = 1 is SpMV.
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
// all four. Its f64 build (values, X and Y in double) has no TPU
// counterpart of its own: Mosaic has no f64.
//
// What bounds it on an H100: bytes. The CSR stream nnz * (val_bytes + 4),
// plus the X rows it gathers (K values a nonzero, from L2 where X fits
// there), plus Y. 2 * K flops a nonzero are far below the ridge point. What
// hurts on a power-law graph is balance, not arithmetic: a row of 387,101
// nonzeros (twitter7 at 2% scale) given to one lane group is a serial loop
// on one SM. So the work is split by merged path over row ends and
// nonzeros (Merrill and Garland, SC'16): the host
// (sblas_torch/ops/kernels/spmm_csr.py, merge_path) gives each warp an
// equal share of `unit` row ends + nonzeros and passes one (row, nonzero)
// start per share. A long row is spread over many warps.
//
// K = 1 (spmv_merge_kernel). What bounded the first design, which walked a
// share 32 / G rows at a time with G lanes a row (2 on uk-2002): each lane
// made scalar loads that depended on each other (an index, then x at that
// index), so one or two gathers were in flight a lane, and 16 lane groups
// read 16 separate row spans of what is one contiguous span of nonzeros.
// It ran at 1.85-1.92x the time of cuSPARSE's addmv on the graphs. Now:
//
//   * the warp stages its share into shared memory: the row ends (indptr)
//     and the products values[j] * x[indices[j]], both read as one
//     contiguous, coalesced span with evict-first loads (L1 is left to the
//     gathered x, which a power-law graph's hub columns reuse); each lane
//     issues kBatch index and value loads, then all kBatch gathers of x,
//     before it uses any;
//   * each lane then takes a contiguous run of ceil(unit / 32) merged-path
//     items (the thread-sequential split), found by a binary search of the
//     staged row ends along its diagonal, and walks it in shared memory:
//     a nonzero adds its product to the running sum, a row end closes the
//     row. Products sit one padding slot in 33, so that lanes walking
//     nonzeros at a stride of 32 items hit distinct banks;
//   * a row closed after the run's first row end began in the lane and is
//     written at once. The sums of the rows left open at the runs' ends meet
//     in a segmented shuffle scan over the lanes (keyed by the open row),
//     which completes the row each lane closes first and leaves the share's
//     last, cut row in lane 31.
//
// K > 1 (spmm_csr_kernel) keeps the first design: inside its share a warp
// takes rows by groups of G lanes (G from the mean row length, as the csr
// SpMV kernel does), each lane striding over the row's nonzeros and
// keeping KC columns of K (4, 8 or 16; at most 8 in f64) in registers: one
// value and index load serves every column of the chunk, X's row slice
// comes as 16-byte loads where K allows. A row slice longer than 8 G goes
// to the whole warp instead. The K-chunks of one share run on neighbouring
// warps.
//
// Both: no atomics. A row that a share finishes is written by it, with the
// alpha/beta epilogue fused. The row a share ends inside leaves its
// partial sums in carry[share, :]; a row a share begins inside is written
// raw, and a second small launch (spmm_csr_fixup) adds the carries of the
// shares before it and applies alpha/beta: one thread a cut row (and
// column), and the whole warp for a row cut into more than kShortFix + 1
// shares, so that a row of 387,101 nonzeros (~1,500 carries at K = 1) is
// not a serial loop of loads in one thread. Every sum runs in a fixed
// order: the same bits from run to run.
//
// The fix-up launch and the gap before it take ~12 of twitter7's ~120 us
// at K = 1. Joining the cut rows inside the main kernel instead (each
// share of a cut row stores its part and counts itself in with an integer
// atomic; the last to arrive adds the carries) timed far slower on an
// H100, in one call against this design: uk-2002@0.05 112.7 against 69.9
// us, twitter7@0.02 197.2 against 119.3 (acq_rel atomics; with a
// __threadfence and atomicAdd, 115.8 and 200.3). Every warp that ends or
// begins a cut row, nearly all of them at 256 items a share, then waits
// for its stores and an atomic's round trip before it retires, and that
// wait is paid once a wave of warps, 7 waves on uk-2002 and 14 on twitter7.
//
// Rows with no nonzeros write beta * Y_in (0 without Y_in); nnz = 0,
// m != n and any K need no padding.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 128;  // 4 warps, one share each
constexpr int kWarps = kThreads / 32;
constexpr int kFixThreads = 256;  // fix-up: one cut row (and column) a thread
constexpr int kShortFix = 8;      // fix-up: carries a thread adds alone
constexpr int kFixBatch = 8;      // fix-up: carry loads a lane has in flight
constexpr int kBatch = 8;         // K = 1: loads a lane has in flight
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float load_value(const float* p) { return __ldg(p); }

__device__ __forceinline__ float load_value(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ double load_value(const double* p) { return __ldg(p); }

// a value read once: evict-first, so that L1 keeps the x entries gathered
__device__ __forceinline__ float load_streamed(const float* p) { return __ldcs(p); }

__device__ __forceinline__ float load_streamed(const __nv_bfloat16* p) {
  return __bfloat162float(__ldcs(p));
}

__device__ __forceinline__ double load_streamed(const double* p) { return __ldcs(p); }

__device__ __forceinline__ float fma_t(float a, float b, float c) { return fmaf(a, b, c); }

__device__ __forceinline__ double fma_t(double a, double b, double c) { return fma(a, b, c); }

// item i of a share's staged products lives at slot padded(i): one slot in
// 33 is left free, so that 32 lanes reading items 32 apart hit 32 banks
__host__ __device__ constexpr int padded(int i) { return i + (i >> 5); }

// shared memory a warp of the K = 1 kernel stages its share in: the
// products from the front, the row ends (ints) from the back. A share of
// `unit` items holds nnz products and rows row ends with nnz + rows <=
// unit, so both fit in padded(unit) + 1 slots of T.
template <typename T>
__host__ __device__ constexpr size_t warp_smem(int unit) {
  return ((static_cast<size_t>(padded(unit)) + 1) * sizeof(T) + 15) / 16 * 16;
}

// Share `u` covers merged-path items part[2u] + part[2u+1] ..: rows r0 ..
// r1 and nonzeros j0 .. j1. Rows r0 .. r1-1 end inside it; row r1 (when r1
// < m) is cut by its end and goes to the carry.
template <typename V, typename T>
__global__ void __launch_bounds__(kThreads)
spmv_merge_kernel(int m, int units, int unit, const int* __restrict__ indptr,
                  const int* __restrict__ indices, const V* __restrict__ values,
                  const int* __restrict__ part, const T* __restrict__ x,
                  const T* __restrict__ y_in, T alpha, T beta, T* __restrict__ y_out,
                  T* __restrict__ carry) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const long long u = static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32;
  if (u >= units) return;  // the warp leaves together; no block barrier below
  const size_t per = warp_smem<T>(unit);
  unsigned char* mine = smem + per * (threadIdx.x / 32);
  T* s_prod = reinterpret_cast<T*>(mine);
  const int r0 = __ldg(part + 2 * u);
  const int j0 = __ldg(part + 2 * u + 1);
  const int r1 = __ldg(part + 2 * u + 2);
  const int j1 = __ldg(part + 2 * u + 3);
  const int rows = r1 - r0;  // rows that end inside the share
  const int nnz = j1 - j0;
  const int total = rows + nnz;
  int* s_end = reinterpret_cast<int*>(mine + per) - rows;
  // the share's first row began in an earlier share: written raw, fixed up
  const bool first_cut = __ldg(indptr + r0) < j0;

  // 1. stage the row ends and the products, each a contiguous span
  for (int i = lane; i < rows; i += 32) s_end[i] = __ldcs(indptr + r0 + 1 + i);
  for (int i0 = 0; i0 < nnz; i0 += 32 * kBatch) {
    int c[kBatch];
    T v[kBatch];
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      const int i = i0 + lane + 32 * q;
      c[q] = -1;
      v[q] = T(0);
      if (i < nnz) {
        c[q] = __ldcs(indices + j0 + i);
        v[q] = load_streamed(values + j0 + i);
      }
    }
    T xv[kBatch];
#pragma unroll
    for (int q = 0; q < kBatch; ++q) xv[q] = c[q] >= 0 ? __ldg(x + c[q]) : T(0);
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      const int i = i0 + lane + 32 * q;
      if (i < nnz) s_prod[padded(i)] = v[q] * xv[q];
    }
  }
  __syncwarp();

  // 2. this lane's run of the merged path: find its start on diagonal d0
  // (ri row ends and ni nonzeros before it), then walk it
  const int ipt = (unit + 31) / 32;
  const int d0 = min(lane * ipt, total);
  const int d1 = min(d0 + ipt, total);
  int lo = max(d0 - nnz, 0), hi = min(d0, rows);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    // row end mid comes before nonzero d0 - mid - 1 when it is <= it
    if (s_end[mid] <= j0 + d0 - mid - 1) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  const int ri0 = lo;
  int ri = lo, ni = d0 - lo;
  T run = T(0), first = T(0);
  bool closed = false;  // has the run closed a row yet?
  for (int d = d0; d < d1; ++d) {
    if (ri < rows && s_end[ri] <= j0 + ni) {
      if (closed) {
        // began in this run: complete
        const long long idx = r0 + ri;
        T out = alpha * run;
        if (y_in != nullptr) out += beta * y_in[idx];
        y_out[idx] = out;
      } else {
        first = run;
        closed = true;
      }
      run = T(0);
      ++ri;
    } else {
      run += s_prod[padded(ni)];
      ++ni;
    }
  }

  // 3. the segmented scan of the rows left open at the runs' ends (row ri):
  // v = this run's part plus that of the runs before it that end in the
  // same row
  T v = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const T vo = __shfl_up_sync(kFull, v, off);
    const int ko = __shfl_up_sync(kFull, ri, off);
    if (lane >= off && ko == ri) v = vo + v;
  }
  // the run before this one ends in the row this run closes first
  const T before = __shfl_up_sync(kFull, v, 1);
  if (closed) {
    const T s = lane > 0 ? before + first : first;
    const long long idx = r0 + ri0;
    if (ri0 == 0 && first_cut) {
      y_out[idx] = s;
    } else {
      T out = alpha * s;
      if (y_in != nullptr) out += beta * y_in[idx];
      y_out[idx] = out;
    }
  }
  // lane 31's run ends where the share does: inside row r1
  if (lane == 31 && r1 < m) carry[u] = v;
}

// acc[q] += v * X[c, k0 + q] for the KC columns of the chunk (none past K).
// `vec`: 16-byte loads of X (K a multiple of 16 / sizeof(T), X aligned).
template <typename T, int KC>
__device__ __forceinline__ void fma_row(T (&acc)[KC], T v, const T* __restrict__ x, int c,
                                        int k, int k0, bool vec) {
  const T* src = x + static_cast<long long>(c) * k + k0;
  if (vec) {
    if constexpr (sizeof(T) == sizeof(float)) {
#pragma unroll
      for (int p = 0; p < KC / 4; ++p) {
        if (k0 + 4 * p < k) {
          const float4 x4 = __ldg(reinterpret_cast<const float4*>(src) + p);
          acc[4 * p + 0] = fma_t(v, x4.x, acc[4 * p + 0]);
          acc[4 * p + 1] = fma_t(v, x4.y, acc[4 * p + 1]);
          acc[4 * p + 2] = fma_t(v, x4.z, acc[4 * p + 2]);
          acc[4 * p + 3] = fma_t(v, x4.w, acc[4 * p + 3]);
        }
      }
    } else {
#pragma unroll
      for (int p = 0; p < KC / 2; ++p) {
        if (k0 + 2 * p < k) {
          const double2 x2 = __ldg(reinterpret_cast<const double2*>(src) + p);
          acc[2 * p + 0] = fma_t(v, x2.x, acc[2 * p + 0]);
          acc[2 * p + 1] = fma_t(v, x2.y, acc[2 * p + 1]);
        }
      }
    }
  } else {
#pragma unroll
    for (int q = 0; q < KC; ++q) {
      if (k0 + q < k) acc[q] = fma_t(v, __ldg(src + q), acc[q]);
    }
  }
}

// K > 1: share `unit`'s chunk of KC columns; rows as in spmv_merge_kernel.
template <typename V, typename T, int KC, int G>
__global__ void __launch_bounds__(kThreads)
spmm_csr_kernel(int m, int k, int units, const int* __restrict__ indptr,
                const int* __restrict__ indices, const V* __restrict__ values,
                const int* __restrict__ part, const T* __restrict__ x,
                const T* __restrict__ y_in, T alpha, T beta, T* __restrict__ y_out,
                T* __restrict__ carry, bool vec) {
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
  auto emit = [=](int r, int q, T s) {
    if (r == r1) {
      carry[static_cast<long long>(unit) * k + k0 + q] = s;
      return;
    }
    const long long idx = static_cast<long long>(r) * k + k0 + q;
    if (r == r0 && first_cut) {
      y_out[idx] = s;
      return;
    }
    T out = alpha * s;
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
    T acc[KC];
#pragma unroll
    for (int q = 0; q < KC; ++q) acc[q] = T(0);
    if (!is_long) {
      for (int j = s + gl; j < e; j += G) {
        fma_row<T, KC>(acc, load_value(values + j), x, __ldg(indices + j), k, k0, vec);
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
      T a2[KC];
#pragma unroll
      for (int q = 0; q < KC; ++q) a2[q] = T(0);
      for (int j = ls + lane; j < le; j += 32) {
        fma_row<T, KC>(a2, load_value(values + j), x, __ldg(indices + j), k, k0, vec);
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

// One thread per (cut row, column): the carries of shares fix_lo[f] ..
// fix[f] - 1 (the shares before fix[f] that end inside its first row)
// added in order, at most kShortFix of them, all loads in flight; then the
// raw sum of share fix[f] plus that, and alpha/beta. A longer span (a row
// of 10^5+ nonzeros leaves hundreds of carries) goes to the whole warp:
// lane l adds carries l, l + 32, ... into its kFixBatch partial sums in
// turn, a tree adds those, a shuffle tree the lanes.
template <typename T>
__global__ void __launch_bounds__(kFixThreads)
spmm_csr_fixup(int k, int nfix, const int* __restrict__ part, const int* __restrict__ fix,
               const int* __restrict__ fix_lo, const T* __restrict__ carry,
               const T* __restrict__ y_in, T alpha, T beta, T* __restrict__ y_out) {
  const long long t = static_cast<long long>(blockIdx.x) * kFixThreads + threadIdx.x;
  bool valid = t < static_cast<long long>(nfix) * k;  // no return: the warp ballots
  const int lane = threadIdx.x & 31;
  int q = 0, b = 0, lo = 0;
  if (valid) {
    const int f = static_cast<int>(t / k);
    q = static_cast<int>(t % k);
    b = __ldg(fix + f);
    lo = __ldg(fix_lo + f);
  }
  valid = valid && b >= 0;  // -1: padding, no row
  const bool is_long = valid && b - lo > kShortFix;
  T s = T(0);
  if (valid && !is_long) {
#pragma unroll
    for (int p = 0; p < kShortFix; ++p) {
      if (lo + p < b) s += carry[static_cast<long long>(lo + p) * k + q];
    }
  }
  unsigned longs = __ballot_sync(kFull, is_long);
  while (longs != 0u) {
    const int src = __ffs(longs) - 1;
    longs &= longs - 1u;
    const int lb = __shfl_sync(kFull, b, src);
    const int llo = __shfl_sync(kFull, lo, src);
    const int lq = __shfl_sync(kFull, q, src);
    T sums[kFixBatch];
#pragma unroll
    for (int p = 0; p < kFixBatch; ++p) sums[p] = T(0);
    for (int i0 = llo + lane; i0 < lb; i0 += 32 * kFixBatch) {
#pragma unroll
      for (int p = 0; p < kFixBatch; ++p) {
        const int i = i0 + 32 * p;
        if (i < lb) sums[p] += carry[static_cast<long long>(i) * k + lq];
      }
    }
#pragma unroll
    for (int w = kFixBatch / 2; w > 0; w >>= 1) {
#pragma unroll
      for (int p = 0; p < w; ++p) sums[p] += sums[p + w];
    }
    T tot = sums[0];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) tot += __shfl_down_sync(kFull, tot, off);
    tot = __shfl_sync(kFull, tot, 0);
    if (lane == src) s = tot;
  }
  if (valid) {
    const long long idx = static_cast<long long>(__ldg(part + 2 * b)) * k + q;
    T out = alpha * (y_out[idx] + s);
    if (y_in != nullptr) out += beta * y_in[idx];
    y_out[idx] = out;
  }
}

template <typename T>
struct Args {
  int m, n, k, units, unit, nfix;
  const int *indptr, *indices, *part, *fix, *fix_lo;
  const void* values;
  const T *x, *y_in;
  T alpha, beta;
  T *y_out, *carry;
  cudaStream_t stream;
};

template <typename V, typename T>
cudaError_t launch_spmv(const Args<T>& a) {
  const long long ctas = (static_cast<long long>(a.units) + kWarps - 1) / kWarps;
  if (ctas > 0x7fffffffLL) return cudaErrorInvalidValue;
  const size_t smem = kWarps * warp_smem<T>(a.unit);
  // above 48 KB a block's shared memory must be asked for, on each device:
  // asked for at every such launch (a cheap call), never remembered
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        spmv_merge_kernel<V, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  spmv_merge_kernel<V, T><<<static_cast<unsigned>(ctas), kThreads, smem, a.stream>>>(
      a.m, a.units, a.unit, a.indptr, a.indices, static_cast<const V*>(a.values), a.part,
      a.x, a.y_in, a.alpha, a.beta, a.y_out, a.carry);
  return cudaGetLastError();
}

template <typename V, typename T, int KC, int G>
cudaError_t launch_main(const Args<T>& a) {
  const long long warps = static_cast<long long>(a.units) * ((a.k + KC - 1) / KC);
  const long long ctas = (warps + kWarps - 1) / kWarps;
  if (ctas > 0x7fffffffLL) return cudaErrorInvalidValue;
  const bool vec = a.k % static_cast<int>(16 / sizeof(T)) == 0 &&
                   reinterpret_cast<uintptr_t>(a.x) % 16 == 0;
  spmm_csr_kernel<V, T, KC, G><<<static_cast<unsigned>(ctas), kThreads, 0, a.stream>>>(
      a.m, a.k, a.units, a.indptr, a.indices, static_cast<const V*>(a.values), a.part, a.x,
      a.y_in, a.alpha, a.beta, a.y_out, a.carry, vec);
  return cudaGetLastError();
}

// K-chunk for K > 1: the smallest of 4, 8, 16 that holds K, else 16; at
// most 8 in f64 (16 doubles a lane would spill)
template <typename V, typename T, int G>
cudaError_t launch_chunk(const Args<T>& a) {
  if (a.k <= 4) return launch_main<V, T, 4, G>(a);
  if constexpr (sizeof(T) == sizeof(double)) {
    return launch_main<V, T, 8, G>(a);
  } else {
    if (a.k <= 8) return launch_main<V, T, 8, G>(a);
    return launch_main<V, T, 16, G>(a);
  }
}

template <typename V, typename T>
int launch(const Args<T>& a, int group) {
  if (a.m <= 0 || a.n < 0 || a.k <= 0 || a.units <= 0 || a.unit <= 0 || a.nfix < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err;
  if (a.k == 1) {
    err = launch_spmv<V, T>(a);
  } else {
    switch (group) {
      case 2:
        err = launch_chunk<V, T, 2>(a);
        break;
      case 4:
        err = launch_chunk<V, T, 4>(a);
        break;
      case 8:
        err = launch_chunk<V, T, 8>(a);
        break;
      default:
        err = cudaErrorInvalidValue;
    }
  }
  if (err != cudaSuccess || a.nfix == 0) return static_cast<int>(err);
  const long long threads = static_cast<long long>(a.nfix) * a.k;
  const long long blocks = (threads + kFixThreads - 1) / kFixThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  spmm_csr_fixup<T><<<static_cast<unsigned>(blocks), kFixThreads, 0, a.stream>>>(
      a.k, a.nfix, a.part, a.fix, a.fix_lo, a.carry, a.y_in, a.alpha, a.beta, a.y_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One entry point per value type: values V, and X, Y, alpha, beta in T.
// `group` is the lanes per row at K > 1 (2, 4 or 8); `unit` the
// merged-path items of a share; `part` holds units + 1 (row, nonzero) pairs
// of int32, the merge-path start of each share and the end; `fix` the nfix
// shares whose first row began in an earlier share (-1: none, padding),
// and `fix_lo` for each the share where that row began; `carry` room for
// units * k values of T.
// Pointers are device pointers on the current device, `y_in` may be null
// (then beta is not read), `stream` is the caller's cudaStream_t on that
// device. Every launch goes on that stream. Returns the cudaError_t of the
// launches (0 on success).
#define SBLAS_SPMM_CSR_ENTRY(NAME, V, T)                                                      \
  extern "C" int NAME(int m, int n, int k, int group, int units, int unit, int nfix,          \
                      const void* indptr, const void* indices, const void* values,            \
                      const void* part, const void* fix, const void* fix_lo, const void* x,   \
                      const void* y_in, T alpha, T beta, void* y_out, void* carry,            \
                      void* stream) {                                                         \
    const Args<T> a{m,                                                                        \
                    n,                                                                        \
                    k,                                                                        \
                    units,                                                                    \
                    unit,                                                                     \
                    nfix,                                                                     \
                    static_cast<const int*>(indptr),                                          \
                    static_cast<const int*>(indices),                                         \
                    static_cast<const int*>(part),                                            \
                    static_cast<const int*>(fix),                                             \
                    static_cast<const int*>(fix_lo),                                          \
                    values,                                                                   \
                    static_cast<const T*>(x),                                                 \
                    static_cast<const T*>(y_in),                                              \
                    alpha,                                                                    \
                    beta,                                                                     \
                    static_cast<T*>(y_out),                                                   \
                    static_cast<T*>(carry),                                                   \
                    static_cast<cudaStream_t>(stream)};                                       \
    return launch<V, T>(a, group);                                                            \
  }

SBLAS_SPMM_CSR_ENTRY(sblas_spmm_csr_f32, float, float)
SBLAS_SPMM_CSR_ENTRY(sblas_spmm_csr_bf16, __nv_bfloat16, float)
SBLAS_SPMM_CSR_ENTRY(sblas_spmm_csr_f64, double, double)
