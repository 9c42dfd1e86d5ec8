// Sync-free sparse triangular solve for Hopper (sm_90a): x = op(L)^{-1} b
// for a lower- or upper-triangular CSR matrix with f32 or f64 values, b and
// x row-major (n, K) in the same type, any K >= 1.
//
// Replaces the TPU kernels sblas/ops/kernels/sptrsv_pallas.py:_kernel
// (one right-hand side, and K <= 8 with per-RHS refs) and :_kernel_m (K <= 8
// right-hand sides on sublanes), and with its f64 build the f64-class solves
// of sblas/ops/kernels/sptrsv_ds.py (PallasSptrsvDS, PallasSptrsmDS): an f32
// wavefront solve, then two rounds of a double-single residual SpMV
// (spmv_wsell_ds.py:_kernel_ds) and another f32 solve, because Mosaic has
// no f64. Hopper has native FP64, so the f64 build solves in f64 directly,
// with no refinement. The two wavefront kernels run a level set at a time
// inside one Pallas call: rows are permuted into 128-row same-level blocks,
// x lives in VMEM, dependencies are gathered through 32-panel windows, and
// the narrow tail of levels is solved by precomputed 128 x 128 block
// inverses on the MXU. Every one of those pieces exists because a TPU core
// has no fine-grained synchronisation and a small, fast scratch memory.
//
// A GPU has device-wide atomics and coherent L2, so this kernel solves
// sync-free, as s-blas does: plain CSR, no barrier per level, each row
// waiting on its own dependencies through a flag in device memory.
//
//   * One warp per row, the rows level by level. A block of kWarps warps
//     takes its tickets from a global counter, not from blockIdx: CUDA does
//     not promise that blocks start in order, and a warp must never wait on
//     a row that no running warp holds. Ticket t solves row perm[t], where
//     perm (built on the host from the dependency levels: sptrsv_csr.py,
//     ticket_order) lists level 0 first, then level 1, and so on, except
//     that consecutive levels of few rows are merged into groups of about
//     2,048 rows taken by row index (descending for upper). Every
//     dependency of a row lies on a strictly lower level, so in the same
//     group or an earlier one, and in the same group at a lower row (a
//     higher one for upper): it has a smaller ticket, so its warp started
//     earlier and is resident or done. No deadlock.
//
//     What bounded the row-order design (ticket t solved row t, or n-1-t
//     for upper): the ~8,400 resident warps of an H100 held 8,400
//     consecutive rows. On a natural-order 2D grid factor that is ~8 grid
//     rows, each a chain of 1,000 dependent rows, so a solve took ~119,000
//     dependent steps where the factor has only 1,999 levels; and the
//     backsolve of a nested-dissection factor queued its separator chains
//     first. In level order the resident window holds whole levels: the
//     rows of a level wait only on the levels before it, so the chain is
//     the level count, and the window keeps many levels in flight.
//
//     Why levels of few rows are grouped: in plain level order the ~115
//     rows of a band-parallel level took ~15 consecutive blocks, so a
//     level ran on ~15 SMs, and the solve was 4-6% slower than in row
//     order, where a level's rows are spread over many blocks; each row's
//     code and reads are the same in every order. Grouped, a level's rows
//     share blocks with other levels' rows, as in row order, and the
//     factors timed within 1% of row order. A group stays well under the
//     resident window, so that several are in flight: a group larger than
//     the window brings back row order's chains inside it. A level of more
//     than 2,048 rows (the large levels of the 1M-row factors) stays alone.
//   * The dependencies. Lanes stride over the row's nonzeros, forward for
//     lower and backward for upper, so that the rows finished last (the
//     nearest to the diagonal) come last and the rest is summed while they
//     are pending. Entries on the diagonal and on the other side of it are
//     skipped. In batches of kBatch entries a lane loads its columns' flags
//     (relaxed, at gpu scope, all in flight together). Where some are not
//     set, lane 0 alone polls one pending row, then the lanes check theirs
//     again: a window of thousands of waiting warps would otherwise keep L2
//     busy with one poll per pending entry. The row polled is the pending
//     one nearest the diagonal: a genuine dependency, so the wait ends, and
//     the loop re-checks every flag after it. (Polling the one latest in
//     level order instead, through the inverse of perm, was 7-10% slower on
//     every factor in one call on an H100: IC(0) forward 5,718 against 5,181
//     us, chol-nd-poisson2d-1000 L 8,105 against 7,422.) Then each
//     lane issues an acquire fence and reads x through L2 (__ldcg: never
//     the non-coherent path, and x is not const).
//   * The finish. A shuffle tree adds the 32 partial sums; lane 0 writes
//     x_r = (b_r - sum) * inv_diag_r (inv_diag = 1 for a unit diagonal), and
//     after all K columns lane 0's release store sets the row's flag.
//   * K > 1: each lane holds a chunk of KC <= 16 partial sums in registers
//     (KC <= 8 in the f64 build: its doubles spilled at 16, 8 bytes, by
//     nvcc's -Xptxas -v report in build/sblas_torch/*.log); chunks loop
//     over K. One flag per row covers all K columns.
//   * Each lane's sum runs in a fixed order, and so does the tree: the same
//     bits from run to run, whatever the timing.
//
// What bounds it on an H100: latency, not bytes. The matrix streams once
// (8 B a nonzero in f32, 12 in f64: 0.12 and 0.18 ms for 50M nonzeros at
// 3.35 TB/s), but a chain of dependent rows costs one flag round trip
// through L2, an x read and a write each, and a Cholesky factor's separator
// rows form such chains.
//
// Each row's arithmetic does not depend on the ticket order, so level order
// and row order give the same bits.
//
// Flags and the ticket are cleared with cudaMemsetAsync on the launch's
// stream before each solve, so a solve can be captured in a CUDA graph.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;  // rows (warps) per block
constexpr int kBlock = 32 * kWarps;
constexpr int kBatch = 8;  // entries a lane checks before one acquire fence
constexpr unsigned kFull = 0xffffffffu;
// polls of one flag before the kernel gives up: tens of seconds, where a
// whole solve takes under one. A dependency that never completes cannot
// happen for a valid triangular CSR; if it does, the launch fails (trap)
// instead of holding the card.
constexpr long long kMaxPolls = 1ll << 26;

__device__ __forceinline__ int load_relaxed(const int* p) {
  int v;
  asm volatile("ld.relaxed.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ void wait_flag(const int* p) {
  for (long long polls = 0; load_relaxed(p) == 0; ++polls) {
    if (polls > kMaxPolls) __trap();
  }
}

__device__ __forceinline__ void fence_acq_rel() {
  asm volatile("fence.acq_rel.gpu;" ::: "memory");
}

__device__ __forceinline__ void store_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

__device__ __forceinline__ float fma_t(float a, float b, float c) {
  return fmaf(a, b, c);
}

__device__ __forceinline__ double fma_t(double a, double b, double c) {
  return fma(a, b, c);
}

// T: the type of the values, inv_diag, b, x and the sums (float or double)
template <typename T, int KC>
__global__ void __launch_bounds__(kBlock)
sptrsv_syncfree(int n, int k, int lower, const int* __restrict__ indptr,
                const int* __restrict__ indices,
                const T* __restrict__ values,
                const T* __restrict__ inv_diag,
                const int* __restrict__ perm, const T* __restrict__ b, T* x,
                int* flags) {
  __shared__ int block_ticket;
  int* ticket = flags + n;
  if (threadIdx.x == 0) block_ticket = atomicAdd(ticket, 1);
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const long long t =
      static_cast<long long>(block_ticket) * kWarps + (threadIdx.x >> 5);
  if (t >= n) return;  // the whole warp leaves together
  const int row = __ldg(perm + t);
  const int begin = __ldg(indptr + row);
  const int end = __ldg(indptr + row + 1);
  const int len = end - begin;
  const T inv = __ldg(inv_diag + row);
  const long long base = static_cast<long long>(row) * k;

  for (int c0 = 0; c0 < k; c0 += KC) {
    const int w = min(KC, k - c0);
    T acc[KC];
#pragma unroll
    for (int q = 0; q < KC; ++q) acc[q] = 0;
    // the walk's i-th entry: forward for lower, backward for upper. Every
    // lane runs the same batches, so that the warp can wait together.
    // a dependency: strictly on this side of the diagonal (an entry past
    // the row's end reads as the diagonal). Tested where it is used rather
    // than kept in kBatch predicate registers.
    auto dep = [=](int c) { return lower ? c < row : c > row; };
    for (int i0 = 0; i0 < len; i0 += 32 * kBatch) {
      int col[kBatch];
      T val[kBatch];
      bool any = false;
#pragma unroll
      for (int q = 0; q < kBatch; ++q) {
        const int i = i0 + lane + 32 * q;
        col[q] = row;
        val[q] = 0;
        if (i < len) {
          const int j = lower ? begin + i : end - 1 - i;
          col[q] = __ldg(indices + j);
          val[q] = __ldg(values + j);
        }
        any |= dep(col[q]);
      }
      if (!__any_sync(kFull, any)) continue;
      int ready[kBatch];
#pragma unroll
      for (int q = 0; q < kBatch; ++q)
        ready[q] = dep(col[q]) ? load_relaxed(flags + col[q]) : 1;
      // Lane 0 alone waits for the warp's pending dependency nearest the
      // diagonal, then each lane checks its own flags again, until none is
      // pending: one poller a warp, not one a pending entry, so that a
      // window of waiting warps does not flood L2 with polls.
      while (true) {
        int latest = -1;
#pragma unroll
        for (int q = 0; q < kBatch; ++q)
          if (ready[q] == 0)
            latest = max(latest, lower ? col[q] : n - 1 - col[q]);
        latest = __reduce_max_sync(kFull, latest);
        if (latest < 0) break;
        if (lane == 0) wait_flag(flags + (lower ? latest : n - 1 - latest));
        __syncwarp();
#pragma unroll
        for (int q = 0; q < kBatch; ++q)
          if (ready[q] == 0) ready[q] = load_relaxed(flags + col[q]);
      }
      fence_acq_rel();  // the x reads below see what the flags released
#pragma unroll
      for (int q = 0; q < kBatch; ++q) {
        if (dep(col[q])) {
          const T* xc = x + static_cast<long long>(col[q]) * k + c0;
#pragma unroll
          for (int p = 0; p < KC; ++p)
            if (p < w) acc[p] = fma_t(val[q], __ldcg(xc + p), acc[p]);
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
      for (int p = 0; p < KC; ++p)
        acc[p] += __shfl_down_sync(kFull, acc[p], off);
    }
    if (lane == 0) {
#pragma unroll
      for (int p = 0; p < KC; ++p)
        if (p < w) x[base + c0 + p] = (__ldg(b + base + c0 + p) - acc[p]) * inv;
    }
  }
  // lane 0 wrote every x of the row: its release store orders them
  // before the flag
  if (lane == 0) store_release(flags + row, 1);
}

template <typename T, int KC>
cudaError_t launch_chunk(int n, int k, int lower, const void* indptr,
                         const void* indices, const void* values,
                         const void* inv_diag, const void* perm,
                         const void* b, void* x, void* flags,
                         cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((n + kWarps - 1) / kWarps);
  sptrsv_syncfree<T, KC><<<blocks, kBlock, 0, stream>>>(
      n, k, lower, static_cast<const int*>(indptr),
      static_cast<const int*>(indices), static_cast<const T*>(values),
      static_cast<const T*>(inv_diag), static_cast<const int*>(perm),
      static_cast<const T*>(b), static_cast<T*>(x), static_cast<int*>(flags));
  return cudaGetLastError();
}

template <typename T>
int solve(int n, int k, int lower, const void* indptr, const void* indices,
          const void* values, const void* inv_diag, const void* perm,
          const void* b, void* x, void* flags, void* stream) {
  if (n <= 0 || k <= 0) return static_cast<int>(cudaErrorInvalidValue);
  // the widest chunk: 16 columns, 8 in f64 (see the note at the top)
  constexpr int kWide = sizeof(T) == sizeof(double) ? 8 : 16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(
      flags, 0, (static_cast<size_t>(n) + 1) * sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (k == 1) {
    err = launch_chunk<T, 1>(n, k, lower, indptr, indices, values, inv_diag,
                             perm, b, x, flags, s);
  } else if (k == 2) {
    err = launch_chunk<T, 2>(n, k, lower, indptr, indices, values, inv_diag,
                             perm, b, x, flags, s);
  } else if (k <= 4) {
    err = launch_chunk<T, 4>(n, k, lower, indptr, indices, values, inv_diag,
                             perm, b, x, flags, s);
  } else if (k <= 8) {
    err = launch_chunk<T, 8>(n, k, lower, indptr, indices, values, inv_diag,
                             perm, b, x, flags, s);
  } else {
    err = launch_chunk<T, kWide>(n, k, lower, indptr, indices, values,
                                 inv_diag, perm, b, x, flags, s);
  }
  return static_cast<int>(err);
}

}  // namespace

// x (n, k) = op(L)^{-1} b (n, k), both row-major in the values' type (f32
// or f64); `lower` selects the side (1 lower, 0 upper). `perm` (n ints)
// is the order rows are solved in, each row after all its dependencies.
// `flags` holds n + 1 ints of scratch (the rows' flags, then the ticket),
// cleared here on `stream` before the launch. Pointers are device pointers
// on the current device. Returns the cudaError_t of the memset or the
// launch (0 on success).
extern "C" int sblas_sptrsv_csr_f32(int n, int k, int lower,
                                    const void* indptr, const void* indices,
                                    const void* values, const void* inv_diag,
                                    const void* perm, const void* b, void* x,
                                    void* flags, void* stream) {
  return solve<float>(n, k, lower, indptr, indices, values, inv_diag, perm,
                      b, x, flags, stream);
}

extern "C" int sblas_sptrsv_csr_f64(int n, int k, int lower,
                                    const void* indptr, const void* indices,
                                    const void* values, const void* inv_diag,
                                    const void* perm, const void* b, void* x,
                                    void* flags, void* stream) {
  return solve<double>(n, k, lower, indptr, indices, values, inv_diag, perm,
                       b, x, flags, stream);
}
