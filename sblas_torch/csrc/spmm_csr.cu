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
// K > 1 has two kernels, both one pass over the CSR stream. What bounds
// them on an H100 at K <= 16: the CSR stream from HBM, and the X rows
// gathered, K values a nonzero (nnz * K * 4 bytes in f32: 461 MB on
// uk-2002@0.05 at K = 8, 4x the CSR stream), from L1 and L2 where X fits
// there (27-32 MB at K = 8 on the graphs). The first design walked a share
// 32 / G rows at a time, G lanes a row, with the sums of a chunk of K in
// each lane's registers; it ran at 21-29% of the bound at K = 8 (uk-2002
// 212 us against 62.08, twitter7@0.02 383 against 92.81; H100 80GB HBM3,
// 700 W; PERF.md), for four reasons: (a) nothing was staged: G-lane groups
// read 32 / G separate row spans of what is one contiguous span of
// nonzeros; (b) each lane had one gather in flight (an index, then X at
// that index, then the FMAs, in a loop of varying trip count); (c) each
// round of lane groups waited for the warp's longest row, and rows longer
// than 8 * G went to the whole warp one after the other; (d) a row's K
// sums went out as 4-byte stores from G lanes. Now:
//
//   * spmm_rows_kernel (the rows kernel; f32/bf16 values and f64, the
//     small K that ops/kernels/spmm_csr.py:rows_kernel gives it) takes the
//     K = 1 kernel's scheme to KC columns (16 to 64 bytes of them: 4, 8,
//     16 floats or 2, 4, 8 doubles; the grid's y takes chunks of 64 bytes'
//     worth past that). (a) The warp stages its share's values, column
//     indices and row ends, coalesced and evict-first, each nonzero one
//     slot in 33 apart as at K = 1. (b) Each lane walks a contiguous run
//     of ceil(unit / 32) merged-path items with its KC sums in registers,
//     and loads the X rows of its next kRowsBatch nonzeros (2 to 8 rows,
//     16 bytes a load where K allows) before it uses any. (c) A run closes
//     every row that ends in it as it comes, whatever the rows' lengths:
//     a long row is a run of nonzeros in many lanes (and shares), short
//     ones many closes in one lane, and the rows left open at the runs'
//     ends meet in a segmented shuffle scan (KC columns, keyed by the open
//     row). (d) A closed row's KC sums leave its lane as 16-byte stores;
//     beta * Y_in is added after the walk in a coalesced pass, as in the
//     columns kernel. What then bounds it is how many warps an SM holds
//     (their gathers in flight): the sums of the row a lane closes first
//     wait for the scan in shared memory, not in registers, and shares of
//     UNIT = 512 items (4.2 KB a warp in f32, and 32 * KC sums) timed
//     faster than 256 (more scans) and 1,024 (fewer warps; PERF.md).
//     Staging the
//     products instead (a warp gathering the X rows of consecutive
//     nonzeros, K values a nonzero in shared memory) timed slower at K >= 8
//     in two layouts: the walk's reads met bank conflicts, and the 8-16 KB
//     a warp left fewer warps and less L1;
//   * spmm_merge_kernel (the columns kernel) stages its share once, as
//     the K = 1 kernel does, and gives lanes the columns: slots of W
//     lanes (W the power of two that holds K, up to 32; 2 or 4 columns a
//     lane past 32) take the share's nonzeros 32 / W a step, so that at K
//     = 32 a nonzero's X row is one 128-byte warp load and a row's store
//     one coalesced run. A lane issues 8 gathers before it uses any. A
//     row that ends inside a step takes the products of the slots before
//     its end, and its slots' sums meet in a shuffle tree (none from K =
//     17 on); no row needs a special case, since a share holds at most
//     `unit` items of it. All of K up to 128 columns is one pass over the
//     CSR stream. beta * Y_in is added after the walk, in a coalesced pass
//     of the rows the share completed: read while the row closed, its
//     load's latency stalled every row. Shares of UNIT_COLS = 512 items (4
//     KB of shared memory a warp in f32) leave room for twice the warps of
//     1,024. It takes the K past the rows kernel's range. It closes a
//     step's rows one after the other, so it loses where rows are short
//     and many (the first rows design against it, one call of
//     chip_smoke.py: K = 8 uk-2002@0.05 212 us against 276, K = 16 382
//     against 442; K = 32 928 against 754).
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
constexpr int kBatch = 8;         // staging: loads a lane has in flight
constexpr unsigned kFull = 0xffffffffu;
// the columns kernel with bf16 values: 8 CTAs an SM (at most 64 registers
// a thread), under which ptxas does not spill at W = 8 as it does unbounded
template <typename V>
constexpr int kColsMinCtas = sizeof(V) == 2 ? 8 : 1;

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

// shared memory a warp of the rows kernel stages its share in: the values
// (in T) and the column indices, each at slot padded(i) as in
// spmv_merge_kernel, from the front, and the row ends (ints) from the back
// of (padded(unit) + 1) * (sizeof(T) + 4) bytes (nnz + rows <= unit);
// after them, each lane's KC sums of the row it closes first
template <typename T>
__host__ __device__ constexpr size_t stage_smem_rows(int unit) {
  return ((static_cast<size_t>(padded(unit)) + 1) * (sizeof(T) + 4) + 15) / 16 * 16;
}

template <typename T, int KC>
__host__ __device__ constexpr size_t warp_smem_rows(int unit) {
  return stage_smem_rows<T>(unit) + 32 * KC * sizeof(T);
}

// 16 bytes of T (4 floats or 2 doubles), and its values
template <typename T>
struct Chunk;
template <>
struct Chunk<float> {
  using type = float4;
};
template <>
struct Chunk<double> {
  using type = double2;
};

__device__ __forceinline__ void split(const float4& c, float (&e)[4]) {
  e[0] = c.x;
  e[1] = c.y;
  e[2] = c.z;
  e[3] = c.w;
}

__device__ __forceinline__ void split(const double2& c, double (&e)[2]) {
  e[0] = c.x;
  e[1] = c.y;
}

__device__ __forceinline__ float4 join(const float (&e)[4]) {
  return make_float4(e[0], e[1], e[2], e[3]);
}

__device__ __forceinline__ double2 join(const double (&e)[2]) { return make_double2(e[0], e[1]); }

// the rows kernel's X rows in flight a lane, and its blocks an SM. Where
// an X row is 4 floats (K <= 4 in f32), 4 rows in flight and 8 blocks an
// SM (at most 64 registers; no spill) timed faster on the H100 than 8
// rows at the ~76 registers ptxas takes unbounded, on the graphs and pwtk
// (PERF.md); elsewhere 128 bytes of rows in flight (2 to 8
// rows) and no bound: bounded, f64 timed slower, and f32 at K > 4 faster
// on the graphs but slower on the FEM matrices
template <typename T, int KC>
constexpr bool kRowsNarrow = sizeof(T) == sizeof(float) && KC == 4;
template <typename T, int KC>
constexpr int kRowsBatch = kRowsNarrow<T, KC> ? 4 : 128 / (KC * static_cast<int>(sizeof(T)));

// K > 1 (the rows kernel): share u, columns k0 .. k0 + KC - 1 (k0 =
// blockIdx.y * KC). The warp stages its share's values, column indices
// and row ends; each lane walks a run of the merged path as in
// spmv_merge_kernel, KC sums in registers, and loads the X rows of its
// next kB nonzeros before it uses any. The runs' open rows meet in a
// segmented shuffle scan; beta * Y_in comes after, in a coalesced pass.
template <typename V, typename T, int KC>
__global__ void __launch_bounds__(kThreads, (kRowsNarrow<T, KC> ? 8 : 1))
spmm_rows_kernel(int m, int k, int units, int unit, const int* __restrict__ indptr,
                 const int* __restrict__ indices, const V* __restrict__ values,
                 const int* __restrict__ part, const T* __restrict__ x,
                 const T* __restrict__ y_in, T alpha, T beta, T* __restrict__ y_out,
                 T* __restrict__ carry, bool vec) {
  using C = typename Chunk<T>::type;
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));  // values a chunk
  constexpr int W = KC / kVec;                              // chunks a row
  constexpr int kB = kRowsBatch<T, KC>;                     // X rows in flight
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const long long u = static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32;
  if (u >= units) return;  // the warp leaves together; no block barrier below
  const int k0 = static_cast<int>(blockIdx.y) * KC;
  const int kk = min(KC, k - k0);  // this chunk's columns
  const size_t per = warp_smem_rows<T, KC>(unit);
  unsigned char* mine = smem + per * (threadIdx.x / 32);
  const size_t staged = stage_smem_rows<T>(unit);
  const int r0 = __ldg(part + 2 * u);
  const int j0 = __ldg(part + 2 * u + 1);
  const int r1 = __ldg(part + 2 * u + 2);
  const int j1 = __ldg(part + 2 * u + 3);
  const int rows = r1 - r0;  // rows that end inside the share
  const int nnz = j1 - j0;
  const int total = rows + nnz;
  T* s_val = reinterpret_cast<T*>(mine);
  int* s_col = reinterpret_cast<int*>(s_val + padded(nnz) + 1);
  int* s_end = reinterpret_cast<int*>(mine + staged) - rows;
  C* s_first = reinterpret_cast<C*>(mine + staged) + lane * W;
  // the share's first row began in an earlier share: written raw, fixed up
  const bool first_cut = __ldg(indptr + r0) < j0;

  // 1. stage the row ends (relative to j0), column indices and values:
  // contiguous spans, coalesced, evict-first, kBatch loads a lane in flight
  for (int i = lane; i < rows; i += 32) s_end[i] = __ldcs(indptr + r0 + 1 + i) - j0;
  for (int i0 = 0; i0 < nnz; i0 += 32 * kBatch) {
    int c[kBatch];
    T v[kBatch];
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      const int i = i0 + lane + 32 * q;
      c[q] = 0;
      v[q] = T(0);
      if (i < nnz) {
        c[q] = __ldcs(indices + j0 + i);
        v[q] = load_streamed(values + j0 + i);
      }
    }
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      const int i = i0 + lane + 32 * q;
      if (i < nnz) {
        s_col[padded(i)] = c[q];
        s_val[padded(i)] = v[q];
      }
    }
  }
  __syncwarp();

  // 2. this lane's run of the merged path, items d0 .. d1: row ends ri0 ..
  // ri1 - 1 and nonzeros ni0 .. ni1 - 1. Its start by a search along
  // diagonal d0; its end is where the next lane's run starts (lane 31's
  // run ends with the share)
  const int ipt = (unit + 31) / 32;
  const int d0 = min(lane * ipt, total);
  const int d1 = min(d0 + ipt, total);
  int lo = max(d0 - nnz, 0), hi = min(d0, rows);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    // row end mid comes before nonzero d0 - mid - 1 when it is <= it
    if (s_end[mid] <= d0 - mid - 1) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  const int ri0 = lo;
  const int ni0 = d0 - lo;
  int ri1 = __shfl_down_sync(kFull, ri0, 1);
  if (lane == 31) ri1 = rows;
  const int ni1 = d1 - ri1;
  int ri = ri0;
  T acc[KC];
#pragma unroll
  for (int q = 0; q < KC; ++q) acc[q] = T(0);
  bool closed = false;  // has the run closed a row yet?
  // a row's KC sums to dst, times scale: 16-byte stores where `vec`
  auto put = [&](T* dst, const T(&sums)[KC], T scale) {
    if (vec) {
#pragma unroll
      for (int p = 0; p < W; ++p) {
        if (p * kVec >= kk) continue;
        T e[kVec];
#pragma unroll
        for (int q = 0; q < kVec; ++q) e[q] = scale * sums[p * kVec + q];
        reinterpret_cast<C*>(dst)[p] = join(e);
      }
    } else {
#pragma unroll
      for (int q = 0; q < KC; ++q) {
        if (q < kk) dst[q] = scale * sums[q];
      }
    }
  };
  // row ri ends: the run's first such row waits for the scan (its sums
  // in shared memory, out of the registers); a later one began in this run
  // and is complete (alpha now, beta * Y_in in step 4)
  auto close = [&]() {
    if (closed) {
      put(y_out + static_cast<long long>(r0 + ri) * k + k0, acc, alpha);
    } else {
#pragma unroll
      for (int p = 0; p < W; ++p) {
        T e[kVec];
#pragma unroll
        for (int h = 0; h < kVec; ++h) e[h] = acc[p * kVec + h];
        s_first[p] = join(e);
      }
      closed = true;
    }
#pragma unroll
    for (int q = 0; q < KC; ++q) acc[q] = T(0);
    ++ri;
  };
  int e = ri < rows ? s_end[ri] : 0x7fffffff;  // row ri ends before nonzero e
  for (int nb = ni0; nb < ni1; nb += kB) {
    T v[kB];
    T xv[kB][KC];
#pragma unroll
    for (int q = 0; q < kB; ++q) {
      const int n = nb + q;
      const bool in = n < ni1;
      const T* src = x + (in ? static_cast<long long>(s_col[padded(n)]) : 0LL) * k + k0;
      v[q] = in ? s_val[padded(n)] : T(0);
#pragma unroll
      for (int p = 0; p < W; ++p) {
        T ch[kVec];
#pragma unroll
        for (int h = 0; h < kVec; ++h) ch[h] = T(0);
        if (vec) {
          if (in && p * kVec < kk) split(__ldg(reinterpret_cast<const C*>(src) + p), ch);
        } else {
#pragma unroll
          for (int h = 0; h < kVec; ++h) {
            if (in && p * kVec + h < kk) ch[h] = __ldg(src + p * kVec + h);
          }
        }
#pragma unroll
        for (int h = 0; h < kVec; ++h) xv[q][p * kVec + h] = ch[h];
      }
    }
#pragma unroll
    for (int q = 0; q < kB; ++q) {
      const int n = nb + q;
      if (n < ni1) {
        while (e <= n) {
          close();
          e = ri < rows ? s_end[ri] : 0x7fffffff;
        }
#pragma unroll
        for (int p = 0; p < KC; ++p) acc[p] = fma_t(v[q], xv[q][p], acc[p]);
      }
    }
  }
  // the row ends after the run's last nonzero
  while (ri < ri1) close();

  // 3. the segmented scan of the rows left open at the runs' ends (row
  // ri1), as in spmv_merge_kernel, a column at a time
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int ko = __shfl_up_sync(kFull, ri, off);
#pragma unroll
    for (int q = 0; q < KC; ++q) {
      const T vo = __shfl_up_sync(kFull, acc[q], off);
      if (lane >= off && ko == ri) acc[q] = vo + acc[q];
    }
  }
  // the run before this one ends in the row this run closes first
  T first[KC];
#pragma unroll
  for (int p = 0; p < W; ++p) {
    T e[kVec];
    split(s_first[p], e);
#pragma unroll
    for (int h = 0; h < kVec; ++h) first[p * kVec + h] = closed ? e[h] : T(0);
  }
#pragma unroll
  for (int q = 0; q < KC; ++q) {
    const T before = __shfl_up_sync(kFull, acc[q], 1);
    if (lane > 0) first[q] = before + first[q];
  }
  if (closed) {
    const bool raw = ri0 == 0 && first_cut;
    put(y_out + static_cast<long long>(r0 + ri0) * k + k0, first, raw ? T(1) : alpha);
  }
  // lane 31's run ends where the share does: inside row r1
  if (lane == 31 && r1 < m) put(carry + u * k + k0, acc, T(1));

  // 4. beta * Y_in added to the rows the share completed (not the raw
  // first row), a coalesced pass with its loads in flight
  if (y_in == nullptr) return;
  __syncwarp();  // the warp's stores above are seen by every lane
  const int rlo = first_cut ? 1 : 0;
  const int span = (rows - rlo) * kk;
#pragma unroll 4
  for (int i = lane; i < span; i += 32) {
    const long long idx = static_cast<long long>(r0 + rlo + i / kk) * k + k0 + i % kk;
    y_out[idx] += beta * __ldcs(y_in + idx);
  }
}

// shared memory a warp of the K > 1 kernel stages its share in: the values
// (in T) and column indices from the front, the row ends (ints) from the
// back; nnz + rows <= unit, so both fit in unit * (sizeof(T) + 4) bytes
template <typename T>
__host__ __device__ constexpr size_t warp_smem_k(int unit) {
  return (static_cast<size_t>(unit) * (sizeof(T) + 4) + 15) / 16 * 16;
}

// K > 1: share u, columns k0 .. k0 + W * CPL - 1 (k0 = blockIdx.y * W * CPL).
// The lanes form 32 / W slots of W lanes; a step takes the share's next
// 32 / W nonzeros, one a slot, and lane gl of a slot owns columns k0 + gl
// + W * p (p < CPL) of X's row and of the sum. Rows as in spmv_merge_kernel.
template <typename V, typename T, int W, int CPL>
__global__ void __launch_bounds__(kThreads, kColsMinCtas<V>)
spmm_merge_kernel(int m, int k, int units, int unit, const int* __restrict__ indptr,
                  const int* __restrict__ indices, const V* __restrict__ values,
                  const int* __restrict__ part, const T* __restrict__ x,
                  const T* __restrict__ y_in, T alpha, T beta, T* __restrict__ y_out,
                  T* __restrict__ carry) {
  constexpr int kSlots = 32 / W;                  // nonzeros a step
  constexpr int kSteps = CPL >= 4 ? 2 : 8 / CPL;  // steps of gathers in flight
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const long long u = static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32;
  if (u >= units) return;  // the warp leaves together; no block barrier below
  const int k0 = static_cast<int>(blockIdx.y) * W * CPL;
  const size_t per = warp_smem_k<T>(unit);
  unsigned char* mine = smem + per * (threadIdx.x / 32);
  const int r0 = __ldg(part + 2 * u);
  const int j0 = __ldg(part + 2 * u + 1);
  const int r1 = __ldg(part + 2 * u + 2);
  const int j1 = __ldg(part + 2 * u + 3);
  const int rows = r1 - r0;  // rows that end inside the share
  const int nnz = j1 - j0;
  T* s_val = reinterpret_cast<T*>(mine);
  int* s_col = reinterpret_cast<int*>(s_val + nnz);
  int* s_end = reinterpret_cast<int*>(mine + per) - rows;
  // the share's first row began in an earlier share: written raw, fixed up
  const bool first_cut = __ldg(indptr + r0) < j0;

  // 1. stage the row ends (relative to j0), column indices and values:
  // contiguous spans, coalesced, evict-first, kBatch loads a lane in flight
  for (int i = lane; i < rows; i += 32) s_end[i] = __ldcs(indptr + r0 + 1 + i) - j0;
  for (int i0 = 0; i0 < nnz; i0 += 32 * kBatch) {
    int c[kBatch];
    T v[kBatch];
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      const int i = i0 + lane + 32 * q;
      c[q] = 0;
      v[q] = T(0);
      if (i < nnz) {
        c[q] = __ldcs(indices + j0 + i);
        v[q] = load_streamed(values + j0 + i);
      }
    }
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      const int i = i0 + lane + 32 * q;
      if (i < nnz) {
        s_col[i] = c[q];
        s_val[i] = v[q];
      }
    }
  }
  __syncwarp();

  // 2. walk the share's nonzeros a step at a time; a row that ends inside a
  // step takes the products of the slots before its end, its slots' sums
  // meet in a shuffle tree, and the first slot stores it
  const int g = lane / W;
  const int gl = lane % W;
  T acc[CPL];
#pragma unroll
  for (int p = 0; p < CPL; ++p) acc[p] = T(0);
  int ri = 0;
  int e = rows > 0 ? s_end[0] : 0x7fffffff;  // where row ri ends
  bool col_ok[CPL];  // this lane's column p is in K
#pragma unroll
  for (int p = 0; p < CPL; ++p) col_ok[p] = k0 + gl + W * p < k;
  // the slots' sums of row ri (ri == rows: the cut row, to the carry) to
  // Y: alpha times them, the raw first row as they are; beta * Y_in comes
  // after the walk (step 3), so that no row waits for its load
  auto close = [&]() {
    T s[CPL];
#pragma unroll
    for (int p = 0; p < CPL; ++p) {
      s[p] = acc[p];
      acc[p] = T(0);
    }
#pragma unroll
    for (int off = W; off < 32; off <<= 1) {
#pragma unroll
      for (int p = 0; p < CPL; ++p) s[p] += __shfl_xor_sync(kFull, s[p], off);
    }
    if (g != 0) return;
#pragma unroll
    for (int p = 0; p < CPL; ++p) {
      if (!col_ok[p]) continue;
      const int col = k0 + gl + W * p;
      if (ri == rows) {
        carry[u * k + col] = s[p];
        continue;
      }
      const long long idx = static_cast<long long>(r0 + ri) * k + col;
      y_out[idx] = ri == 0 && first_cut ? s[p] : alpha * s[p];
    }
  };

  for (int base = 0; base < nnz; base += kSlots * kSteps) {
    T v[kSteps];
    T xv[kSteps][CPL];
#pragma unroll
    for (int q = 0; q < kSteps; ++q) {
      const int i = base + q * kSlots + g;
      const bool in = i < nnz;
      const long long row = in ? s_col[i] : 0;
      v[q] = in ? s_val[i] : T(0);
#pragma unroll
      for (int p = 0; p < CPL; ++p) {
        xv[q][p] = in && col_ok[p] ? __ldg(x + row * k + k0 + gl + W * p) : T(0);
      }
    }
#pragma unroll
    for (int q = 0; q < kSteps; ++q) {
      const int sb = base + q * kSlots;
      if (sb >= nnz) continue;  // the same for the whole warp
      bool used = false;
      while (e < sb + kSlots) {  // row ri ends inside this step
        if (!used && sb + g < e) {
#pragma unroll
          for (int p = 0; p < CPL; ++p) acc[p] = fma_t(v[q], xv[q][p], acc[p]);
          used = true;
        }
        close();
        ++ri;
        e = ri < rows ? s_end[ri] : 0x7fffffff;
      }
      if (!used) {
#pragma unroll
        for (int p = 0; p < CPL; ++p) acc[p] = fma_t(v[q], xv[q][p], acc[p]);
      }
    }
  }
  // the row ends after the last nonzero, then the cut row r1 to the carry
  for (; ri < rows; ++ri) close();
  if (r1 < m) close();

  // 3. beta * Y_in added to the rows the share completed (not the raw
  // first row), a coalesced pass with its loads in flight
  if (y_in == nullptr) return;
  __syncwarp();  // the warp's stores above are seen by every lane
  const int lo = first_cut ? 1 : 0;
  const int cw = min(W * CPL, k - k0);
  const int total = (rows - lo) * cw;
#pragma unroll 4
  for (int i = lane; i < total; i += 32) {
    const long long idx = static_cast<long long>(r0 + lo + i / cw) * k + k0 + i % cw;
    y_out[idx] += beta * __ldcs(y_in + idx);
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

template <typename V, typename T, int W, int CPL>
cudaError_t launch_main(const Args<T>& a) {
  const long long ctas = (static_cast<long long>(a.units) + kWarps - 1) / kWarps;
  const int chunks = (a.k + W * CPL - 1) / (W * CPL);
  if (ctas > 0x7fffffffLL || chunks > 65535) return cudaErrorInvalidValue;
  const size_t smem = kWarps * warp_smem_k<T>(a.unit);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        spmm_merge_kernel<V, T, W, CPL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(static_cast<unsigned>(ctas), static_cast<unsigned>(chunks));
  spmm_merge_kernel<V, T, W, CPL><<<grid, kThreads, smem, a.stream>>>(
      a.m, a.k, a.units, a.unit, a.indptr, a.indices, static_cast<const V*>(a.values), a.part,
      a.x, a.y_in, a.alpha, a.beta, a.y_out, a.carry);
  return cudaGetLastError();
}

// K > 1: lanes a slot W the power of two that holds K, up to 32, and CPL
// columns a lane beyond 32; past 128 columns the grid's y takes chunks of
// 128
template <typename V, typename T>
cudaError_t launch_cols(const Args<T>& a) {
  if (a.k <= 2) return launch_main<V, T, 2, 1>(a);
  if (a.k <= 4) return launch_main<V, T, 4, 1>(a);
  if (a.k <= 8) return launch_main<V, T, 8, 1>(a);
  if (a.k <= 16) return launch_main<V, T, 16, 1>(a);
  if (a.k <= 32) return launch_main<V, T, 32, 1>(a);
  if (a.k <= 64) return launch_main<V, T, 32, 2>(a);
  return launch_main<V, T, 32, 4>(a);
}

template <typename V, typename T, int KC>
cudaError_t launch_rows_main(const Args<T>& a) {
  const long long ctas = (static_cast<long long>(a.units) + kWarps - 1) / kWarps;
  const int chunks = (a.k + KC - 1) / KC;
  if (ctas > 0x7fffffffLL || chunks > 65535) return cudaErrorInvalidValue;
  const size_t smem = kWarps * warp_smem_rows<T, KC>(a.unit);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(spmm_rows_kernel<V, T, KC>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  // 16-byte rows of X, Y and the carries: K a multiple of 16 / sizeof(T),
  // each array 16-byte aligned
  const uintptr_t bases = reinterpret_cast<uintptr_t>(a.x) |
                          reinterpret_cast<uintptr_t>(a.y_out) |
                          reinterpret_cast<uintptr_t>(a.carry);
  const bool vec = a.k % static_cast<int>(16 / sizeof(T)) == 0 && bases % 16 == 0;
  const dim3 grid(static_cast<unsigned>(ctas), static_cast<unsigned>(chunks));
  spmm_rows_kernel<V, T, KC><<<grid, kThreads, smem, a.stream>>>(
      a.m, a.k, a.units, a.unit, a.indptr, a.indices, static_cast<const V*>(a.values), a.part,
      a.x, a.y_in, a.alpha, a.beta, a.y_out, a.carry, vec);
  return cudaGetLastError();
}

// the rows kernel's columns a chunk KC: the smallest that holds K of 16
// bytes' worth (4 floats, 2 doubles) up to 64 bytes' worth (16 floats, 8
// doubles); past that the grid's y takes chunks of 64 bytes' worth
template <typename V, typename T>
cudaError_t launch_rows(const Args<T>& a) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  if (a.k <= kVec) return launch_rows_main<V, T, kVec>(a);
  if (a.k <= 2 * kVec) return launch_rows_main<V, T, 2 * kVec>(a);
  return launch_rows_main<V, T, 4 * kVec>(a);
}

template <typename V, typename T>
int launch(const Args<T>& a, int rows) {
  if (a.m <= 0 || a.n < 0 || a.k <= 0 || a.units <= 0 || a.unit <= 0 || a.nfix < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err;
  if (a.k == 1) {
    err = launch_spmv<V, T>(a);
  } else if (rows != 0) {
    err = launch_rows<V, T>(a);
  } else {
    err = launch_cols<V, T>(a);
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
// `rows` != 0 takes the rows kernel at K > 1, 0 the columns kernel; `unit`
// the merged-path items of a share; `part` holds units + 1 (row, nonzero) pairs
// of int32, the merge-path start of each share and the end; `fix` the nfix
// shares whose first row began in an earlier share (-1: none, padding),
// and `fix_lo` for each the share where that row began; `carry` room for
// units * k values of T.
// Pointers are device pointers on the current device, `y_in` may be null
// (then beta is not read), `stream` is the caller's cudaStream_t on that
// device. Every launch goes on that stream. Returns the cudaError_t of the
// launches (0 on success).
#define SBLAS_SPMM_CSR_ENTRY(NAME, V, T)                                                      \
  extern "C" int NAME(int m, int n, int k, int rows, int units, int unit, int nfix,           \
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
    return launch<V, T>(a, rows);                                                             \
  }

SBLAS_SPMM_CSR_ENTRY(sblas_spmm_csr_f32, float, float)
SBLAS_SPMM_CSR_ENTRY(sblas_spmm_csr_bf16, __nv_bfloat16, float)
SBLAS_SPMM_CSR_ENTRY(sblas_spmm_csr_f64, double, double)
