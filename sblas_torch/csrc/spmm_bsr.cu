// Dense-block (BSR) SpMM for Hopper (sm_90a):
//   Y_out = alpha * A @ X + beta * Y_in,   X (n, K) and Y (m, K) row-major f32.
//
// Replaces three TPU kernels of sblas/ops/kernels/spmm_bsr_pallas.py:
//   _kernel_t          (:96)  Yt[:, brow] += Xt[:, bcol] @ At_b, 128x128
//                             blocks stored transposed, Xt resident in VMEM;
//   _kernel_t_streamed (:44)  the same with Xt streamed through VMEM in
//                             column slices when it does not fit;
//   _kernel            (:481) Y[brow] += A_blk @ X[bcol], 64x128 row-major
//                             blocks, X and Y resident in VMEM.
// All three compute Y[brow] += A_b @ X[bcol] over the dense blocks of a BSR
// matrix; they differ only in what the TPU keeps in VMEM and in the MXU's
// preferred orientation. On Hopper X stays in device memory and L2 and is
// never staged whole, so one kernel serves all three, at block_rows 128
// (the counterpart of _kernel_t/_kernel_t_streamed) or 64 (of _kernel).
//
// Layout (sblas_torch/retile_bsr.py): the blocks of block-row i are
// bptr[i] .. bptr[i+1]; block b covers rows i*BR .. and columns
// bcol[b]*128 ..; each block is stored transposed, (128 cols, BR rows), in
// f32 or bf16. For a fixed column j of a block, its BR rows lie at
// consecutive addresses, so the threads that own consecutive rows read
// consecutive addresses: every value load of a warp is one coalesced run.
//
// What bounds it on an H100: bytes. A block moves 128*BR values (64 KB in
// f32 at BR = 128) for 2*128*BR*K flops, so at K = 8 the stream takes about
// six times as long as the FMAs at the card's 67 TFLOP/s fp32 rate, and
// at K = 32 about 1.6 times (the block stream of the FEM suite is 130-213 MB
// at 10-12% density, above the 50 MB L2). The design keeps the stream
// coalesced and in flight, and the FMA pipe fed:
//
//   * one CTA of 128 threads (4 warps) per block-row and K-chunk of KC (4,
//     8 or 16) columns, the chunks of a block-row on neighbouring CTAs, so
//     that a block read by one is still in L2 for the next. Warp w takes
//     block columns 32w .. 32w+31 of every block of the row; each thread
//     owns 4 consecutive rows (one 16-byte load of f32 values, 8 of bf16,
//     per block column) and KC columns of K, so one X value read from
//     shared memory feeds 4 FMAs and one value load feeds 4*KC. At BR = 64
//     the two half-warps split the warp's 32 block columns;
//   * each warp stages the X rows of its block columns (32 x KC f32) in
//     its own slice of shared memory, double-buffered: the next block's X
//     rows are loaded into registers while the current block is used, and
//     a __syncwarp is the only barrier of the main loop, so the warps of a
//     CTA never wait for each other there. Every X value is read by a whole
//     (half-)warp at once (broadcast);
//   * the FMAs are plain fp32: exact f32 products, f32 sums; bf16 values are
//     widened in registers, which is exact;
//   * epilogue: the partial sums of a row's column shares meet in shared
//     memory and are added in a fixed order, alpha/beta is fused, and the
//     stores run along the row-major Y tile. No atomics: results are the
//     same from run to run.
//
// Empty block-rows write beta * Y_in (0 without Y_in); rows past m are not
// stored, X rows past n read as 0, and K needs no padding.
//
// Not done here: tensor cores. Plain TF32 (about 1e-3) misses the f32
// tolerance of 2e-5; 3xTF32 through mma/wgmma would keep it and move the
// K = 32 case off the FMA pipe. That is a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 128;  // threads per CTA: 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kBC = 128;       // block columns, 32 per warp
constexpr int kUnroll = 8;     // value loads a thread keeps in flight
// at most 128 registers a thread, so that 4 CTAs (16 warps) share an SM and
// keep more loads in flight; at KC = 16 the compiler would take 156
constexpr int kMinCtas = 4;

// 4 consecutive values of one block column, widened to f32.
__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  // a bf16 is the upper half of the f32 with the same value
  const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
  return make_float4(__uint_as_float(raw.x << 16),
                     __uint_as_float(raw.x & 0xffff0000u),
                     __uint_as_float(raw.y << 16),
                     __uint_as_float(raw.y & 0xffff0000u));
}

template <int BR, int KC>
struct Shape {
  static constexpr int kRowThreads = BR / 4;              // 4 rows a thread
  static constexpr int kSplit = kThreads / kRowThreads;   // column shares
  static constexpr int kCols = kBC / kSplit;              // columns a thread
  static constexpr int kStage = 32 * KC;                  // a warp's X rows
  static constexpr int kRowPad = BR + 4;                  // epilogue row
  static constexpr int kRed = kSplit * KC * kRowPad;
  static constexpr int kSmem = 2 * kWarps * kStage > kRed ? 2 * kWarps * kStage : kRed;
  static_assert(kCols % kUnroll == 0 && 32 % kRowThreads == 0, "shape");
  static_assert(KC % 4 == 0, "K-chunk");
};

// Lane l of warp w stages X[col, k0 .. k0 + KC) for col = bc * 128 + 32w + l
// (that is, + threadIdx.x): zero past n and past K. `vec`: K is a multiple
// of 4 and X 16-byte aligned, so the row loads as float4s.
template <int KC>
__device__ __forceinline__ void fetch_x(float (&r)[KC], const float* __restrict__ x,
                                        int bc, int n, int k, int k0, bool vec) {
  const long long col = static_cast<long long>(bc) * kBC + threadIdx.x;
#pragma unroll
  for (int q = 0; q < KC; ++q) r[q] = 0.0f;
  if (col >= n) return;
  const float* src = x + col * k + k0;
  if (vec) {
#pragma unroll
    for (int p = 0; p < KC / 4; ++p) {
      if (k0 + 4 * p < k) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(src) + p);
        r[4 * p + 0] = v.x;
        r[4 * p + 1] = v.y;
        r[4 * p + 2] = v.z;
        r[4 * p + 3] = v.w;
      }
    }
  } else {
#pragma unroll
    for (int q = 0; q < KC; ++q) {
      if (k0 + q < k) r[q] = __ldg(src + q);
    }
  }
}

template <int KC>
__device__ __forceinline__ void store_x(float* stage, const float (&r)[KC]) {
  float4* dst = reinterpret_cast<float4*>(stage + (threadIdx.x & 31) * KC);
#pragma unroll
  for (int p = 0; p < KC / 4; ++p) {
    dst[p] = make_float4(r[4 * p], r[4 * p + 1], r[4 * p + 2], r[4 * p + 3]);
  }
}

template <typename V, int BR, int KC>
__global__ void __launch_bounds__(kThreads, kMinCtas)
spmm_bsr_kernel(int m, int n, int k, const int* __restrict__ bptr,
                const int* __restrict__ bcol, const V* __restrict__ blocks_t,
                const float* __restrict__ x, const float* __restrict__ y_in,
                float alpha, float beta, float* __restrict__ y_out, bool vec) {
  using S = Shape<BR, KC>;
  __shared__ __align__(16) float smem[S::kSmem];

  const int chunks = (k + KC - 1) / KC;
  const int brow = blockIdx.x / chunks;
  const int k0 = (blockIdx.x % chunks) * KC;
  const int warp = threadIdx.x / 32;
  const int rt = threadIdx.x % S::kRowThreads;  // rows 4*rt .. 4*rt+3
  const int h = threadIdx.x / S::kRowThreads;   // columns h*kCols ..
  const int begin = bptr[brow];
  const int end = bptr[brow + 1];

  float acc[4][KC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int q = 0; q < KC; ++q) acc[i][q] = 0.0f;
  }

  // this warp's two X buffers; this thread's columns start at row `own`
  float* stage = smem + warp * 2 * S::kStage;
  const int own = (h * S::kCols - 32 * warp) * KC;
  float xr[KC];
  if (begin < end) {
    fetch_x<KC>(xr, x, bcol[begin], n, k, k0, vec);
    store_x<KC>(stage, xr);
  }
  __syncwarp();

  int cur = 0;
  for (int b = begin; b < end; ++b) {
    const bool more = b + 1 < end;
    if (more) fetch_x<KC>(xr, x, bcol[b + 1], n, k, k0, vec);
    const float* xs = stage + cur * S::kStage + own;
    const V* a = blocks_t + (static_cast<size_t>(b) * kBC + h * S::kCols) * BR + 4 * rt;
    for (int j0 = 0; j0 < S::kCols; j0 += kUnroll) {
      float4 av[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) av[u] = load4(a + static_cast<size_t>(j0 + u) * BR);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const float4* xv = reinterpret_cast<const float4*>(xs + (j0 + u) * KC);
#pragma unroll
        for (int p = 0; p < KC / 4; ++p) {
          const float4 x4 = xv[p];
          const float xq[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            acc[0][4 * p + c] = fmaf(av[u].x, xq[c], acc[0][4 * p + c]);
            acc[1][4 * p + c] = fmaf(av[u].y, xq[c], acc[1][4 * p + c]);
            acc[2][4 * p + c] = fmaf(av[u].z, xq[c], acc[2][4 * p + c]);
            acc[3][4 * p + c] = fmaf(av[u].w, xq[c], acc[3][4 * p + c]);
          }
        }
      }
    }
    if (more) store_x<KC>(stage + (cur ^ 1) * S::kStage, xr);
    // the next buffer is written, and no lane reads this one any more
    __syncwarp();
    cur ^= 1;
  }

  // the column shares of each row meet here, after every warp is done with
  // its X buffers; rows padded so that the reads below spread over banks
  __syncthreads();
  float* red = smem;
#pragma unroll
  for (int q = 0; q < KC; ++q) {
    *reinterpret_cast<float4*>(red + (h * KC + q) * S::kRowPad + 4 * rt) =
        make_float4(acc[0][q], acc[1][q], acc[2][q], acc[3][q]);
  }
  __syncthreads();

  const int kcount = min(KC, k - k0);
  const long long row0 = static_cast<long long>(brow) * BR;
  for (int e = threadIdx.x; e < BR * kcount; e += kThreads) {
    const int rr = e / kcount;
    const int q = e % kcount;
    const long long row = row0 + rr;
    if (row >= m) break;  // e only grows, and so does the row
    float s = 0.0f;
#pragma unroll
    for (int hh = 0; hh < S::kSplit; ++hh) s += red[(hh * KC + q) * S::kRowPad + rr];
    const size_t idx = static_cast<size_t>(row) * k + k0 + q;
    float out = alpha * s;
    if (y_in != nullptr) out += beta * y_in[idx];
    y_out[idx] = out;
  }
}

template <typename V, int BR, int KC>
cudaError_t launch_chunk(int m, int n, int k, const void* bptr, const void* bcol,
                         const void* blocks_t, const void* x, const void* y_in,
                         float alpha, float beta, void* y_out, cudaStream_t stream) {
  const long long ctas = static_cast<long long>((m + BR - 1) / BR) * ((k + KC - 1) / KC);
  if (ctas > 0x7fffffffLL) return cudaErrorInvalidValue;
  const bool vec = k % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  spmm_bsr_kernel<V, BR, KC><<<static_cast<unsigned>(ctas), kThreads, 0, stream>>>(
      m, n, k, static_cast<const int*>(bptr), static_cast<const int*>(bcol),
      static_cast<const V*>(blocks_t), static_cast<const float*>(x),
      static_cast<const float*>(y_in), alpha, beta, static_cast<float*>(y_out), vec);
  return cudaGetLastError();
}

// K-chunk: the smallest of 4, 8, 16 that holds K, else 16.
template <typename V, int BR>
cudaError_t launch_rows(int m, int n, int k, const void* bptr, const void* bcol,
                        const void* blocks_t, const void* x, const void* y_in,
                        float alpha, float beta, void* y_out, cudaStream_t s) {
  if (k <= 4)
    return launch_chunk<V, BR, 4>(m, n, k, bptr, bcol, blocks_t, x, y_in, alpha, beta, y_out, s);
  if (k <= 8)
    return launch_chunk<V, BR, 8>(m, n, k, bptr, bcol, blocks_t, x, y_in, alpha, beta, y_out, s);
  return launch_chunk<V, BR, 16>(m, n, k, bptr, bcol, blocks_t, x, y_in, alpha, beta, y_out, s);
}

template <typename V>
int launch(int m, int n, int k, int br, const void* bptr, const void* bcol,
           const void* blocks_t, const void* x, const void* y_in, float alpha,
           float beta, void* y_out, void* stream) {
  if (m <= 0 || n < 0 || k <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (br) {
    case 64:
      err = launch_rows<V, 64>(m, n, k, bptr, bcol, blocks_t, x, y_in, alpha, beta, y_out, s);
      break;
    case 128:
      err = launch_rows<V, 128>(m, n, k, bptr, bcol, blocks_t, x, y_in, alpha, beta, y_out, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // namespace

// One entry point per value type. `br` is the block rows (64 or 128; the
// block columns are 128); `bptr` has ceil(m / br) + 1 entries. Pointers are
// device pointers on the current device, `y_in` may be null (then beta is
// not read), `stream` is the caller's cudaStream_t on that device. Returns
// the cudaError_t of the launch (0 on success).
extern "C" int sblas_spmm_bsr_f32(int m, int n, int k, int br, const void* bptr,
                                  const void* bcol, const void* blocks_t,
                                  const void* x, const void* y_in, float alpha,
                                  float beta, void* y_out, void* stream) {
  return launch<float>(m, n, k, br, bptr, bcol, blocks_t, x, y_in, alpha, beta,
                       y_out, stream);
}

extern "C" int sblas_spmm_bsr_bf16(int m, int n, int k, int br, const void* bptr,
                                   const void* bcol, const void* blocks_t,
                                   const void* x, const void* y_in, float alpha,
                                   float beta, void* y_out, void* stream) {
  return launch<__nv_bfloat16>(m, n, k, br, bptr, bcol, blocks_t, x, y_in, alpha,
                               beta, y_out, stream);
}
