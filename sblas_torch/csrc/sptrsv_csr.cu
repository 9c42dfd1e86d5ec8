// Sync-free sparse triangular solve for Hopper (sm_90a): x = op(L)^{-1} b
// for a lower- or upper-triangular CSR matrix with f32 values, b and x
// row-major (n, K), any K >= 1.
//
// Replaces the TPU kernels sblas/ops/kernels/sptrsv_pallas.py:_kernel
// (one right-hand side, and K <= 8 with per-RHS refs) and :_kernel_m (K <= 8
// right-hand sides on sublanes). Those run a level-set wavefront inside one
// Pallas call: rows are permuted into 128-row same-level blocks, x lives in
// VMEM, dependencies are gathered through 32-panel windows, and the narrow
// tail of levels is solved by precomputed 128 x 128 block inverses on the
// MXU. Every one of those pieces exists because a TPU core has no
// fine-grained synchronisation and a small, fast scratch memory.
//
// A GPU has device-wide atomics and coherent L2, so this kernel solves
// sync-free, as s-blas does: plain CSR in natural row order, no level
// analysis at solve time, no barrier per level.
//
//   * One warp per row. A block of kWarps warps takes its rows from a global
//     ticket (row = kWarps * ticket + warp for lower, n-1 minus that for
//     upper), not from blockIdx: CUDA does not promise that blocks start in
//     order, and a warp must never wait on a row that no running warp holds.
//     A row's dependencies have smaller tickets, so their warps started
//     earlier and are resident or done: no deadlock.
//   * The dependencies. Lanes stride over the row's nonzeros, forward for
//     lower and backward for upper, so that the rows finished last (the
//     nearest to the diagonal) come last and the rest is summed while they
//     are pending. Entries on the diagonal and on the other side of it are
//     skipped. In batches of kBatch entries a lane loads its columns' flags
//     (relaxed, at gpu scope, all in flight together). Where some are not
//     set, lane 0 alone polls the warp's latest pending row, then the lanes
//     check theirs again: a window of thousands of waiting warps would
//     otherwise keep L2 busy with one poll per pending entry. Then each
//     lane issues an acquire fence and reads x through L2 (__ldcg: never
//     the non-coherent path, and x is not const).
//   * The finish. A shuffle tree adds the 32 partial sums; lane 0 writes
//     x_r = (b_r - sum) * inv_diag_r (inv_diag = 1 for a unit diagonal), and
//     after all K columns a release fence, then the row's flag.
//   * K > 1: each lane holds a chunk of KC <= 16 partial sums in registers;
//     chunks loop over K. One flag per row covers all K columns.
//   * Each lane's sum runs in a fixed order, and so does the tree: the same
//     bits from run to run, whatever the timing.
//
// What bounds it on an H100: latency, not bytes. The matrix streams once
// (8 B a nonzero, about 0.12 ms for 50M nonzeros at 3.35 TB/s), but a chain
// of dependent rows costs one flag round trip through L2, an x read and a
// write each, and a Cholesky factor's separator rows form such chains.
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

template <int KC>
__global__ void __launch_bounds__(kBlock)
sptrsv_syncfree(int n, int k, int lower, const int* __restrict__ indptr,
                const int* __restrict__ indices,
                const float* __restrict__ values,
                const float* __restrict__ inv_diag,
                const float* __restrict__ b, float* x, int* flags) {
  __shared__ int block_ticket;
  int* ticket = flags + n;
  if (threadIdx.x == 0) block_ticket = atomicAdd(ticket, 1);
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const long long t =
      static_cast<long long>(block_ticket) * kWarps + (threadIdx.x >> 5);
  if (t >= n) return;  // the whole warp leaves together
  const int row = lower ? static_cast<int>(t) : n - 1 - static_cast<int>(t);
  const int begin = __ldg(indptr + row);
  const int end = __ldg(indptr + row + 1);
  const int len = end - begin;
  const float inv = __ldg(inv_diag + row);
  const long long base = static_cast<long long>(row) * k;

  for (int c0 = 0; c0 < k; c0 += KC) {
    const int w = min(KC, k - c0);
    float acc[KC];
#pragma unroll
    for (int q = 0; q < KC; ++q) acc[q] = 0.0f;
    // the walk's i-th entry: forward for lower, backward for upper. Every
    // lane runs the same batches, so that the warp can wait together.
    for (int i0 = 0; i0 < len; i0 += 32 * kBatch) {
      int col[kBatch];
      float val[kBatch];
      bool dep[kBatch];
      bool any = false;
#pragma unroll
      for (int q = 0; q < kBatch; ++q) {
        const int i = i0 + lane + 32 * q;
        col[q] = row;
        val[q] = 0.0f;
        if (i < len) {
          const int j = lower ? begin + i : end - 1 - i;
          col[q] = __ldg(indices + j);
          val[q] = __ldg(values + j);
        }
        dep[q] = lower ? col[q] < row : col[q] > row;
        any |= dep[q];
      }
      if (!__any_sync(kFull, any)) continue;
      int ready[kBatch];
#pragma unroll
      for (int q = 0; q < kBatch; ++q)
        ready[q] = dep[q] ? load_relaxed(flags + col[q]) : 1;
      // Lane 0 alone waits for the warp's latest pending dependency (the
      // largest ticket), then each lane checks its own flags again, until
      // none is pending: one poller a warp, not one a pending entry, so
      // that a window of waiting warps does not flood L2 with polls.
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
        if (dep[q]) {
          const float* xc = x + static_cast<long long>(col[q]) * k + c0;
#pragma unroll
          for (int p = 0; p < KC; ++p)
            if (p < w) acc[p] = fmaf(val[q], __ldcg(xc + p), acc[p]);
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
  if (lane == 0) {
    __threadfence();
    store_release(flags + row, 1);
  }
}

template <int KC>
cudaError_t launch_chunk(int n, int k, int lower, const void* indptr,
                         const void* indices, const void* values,
                         const void* inv_diag, const void* b, void* x,
                         void* flags, cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((n + kWarps - 1) / kWarps);
  sptrsv_syncfree<KC><<<blocks, kBlock, 0, stream>>>(
      n, k, lower, static_cast<const int*>(indptr),
      static_cast<const int*>(indices), static_cast<const float*>(values),
      static_cast<const float*>(inv_diag), static_cast<const float*>(b),
      static_cast<float*>(x), static_cast<int*>(flags));
  return cudaGetLastError();
}

}  // namespace

// x (n, k) = op(L)^{-1} b (n, k), both row-major f32; `lower` selects the
// side (1 lower, 0 upper). `flags` holds n + 1 ints of scratch (the rows'
// flags, then the ticket), cleared here on `stream` before the launch.
// Pointers are device pointers on the current device. Returns the
// cudaError_t of the memset or the launch (0 on success).
extern "C" int sblas_sptrsv_csr_f32(int n, int k, int lower,
                                    const void* indptr, const void* indices,
                                    const void* values, const void* inv_diag,
                                    const void* b, void* x, void* flags,
                                    void* stream) {
  if (n <= 0 || k <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(
      flags, 0, (static_cast<size_t>(n) + 1) * sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (k == 1) {
    err = launch_chunk<1>(n, k, lower, indptr, indices, values, inv_diag, b,
                          x, flags, s);
  } else if (k == 2) {
    err = launch_chunk<2>(n, k, lower, indptr, indices, values, inv_diag, b,
                          x, flags, s);
  } else if (k <= 4) {
    err = launch_chunk<4>(n, k, lower, indptr, indices, values, inv_diag, b,
                          x, flags, s);
  } else if (k <= 8) {
    err = launch_chunk<8>(n, k, lower, indptr, indices, values, inv_diag, b,
                          x, flags, s);
  } else {
    err = launch_chunk<16>(n, k, lower, indptr, indices, values, inv_diag, b,
                           x, flags, s);
  }
  return static_cast<int>(err);
}
