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
// f32 at BR = 128) for 2*128*BR*K flops; the block stream of the FEM suite
// is 130-213 MB at 10-12% density, above the 50 MB L2.
//
// What bounded the first design (plain fp32 FMAs): at K = 32 it ran at
// 36-50% of the bound on an H100 80GB HBM3 at 700 W (cant 109.9 us against
// 54.8, consph 153.4 against 73.2, pdb1HYS 118.8 against 43.0; PERF.md).
// K-chunks of 16
// columns ran two CTAs a block-row, each streaming every block of the row
// (once from HBM, once from L2) and doing half of the FMAs; at K = 32 the
// FMAs alone take about 1.6x the stream's time at 67 TFLOP/s, fed by one
// shared-memory load per 16 FMAs, 64 of 128 registers in sums. Now:
//
//   * the products run on the tensor cores: mma.sync m16n8k8 on TF32
//     operands, f32 sums. Plain TF32 keeps about 1e-3 and misses the f32
//     tolerance of 2e-5, so each operand is split into hi = rna(v) and lo =
//     rna(v - hi) and the tile sums a_lo x_hi + a_hi x_lo + a_hi x_hi
//     (3xTF32; a_lo x_lo is below the f32 rounding). bf16 values are TF32
//     already (a_lo = 0): two products;
//   * one CTA of 4 warps a block-row takes up to 32 columns of K (K > 32 in
//     chunks of 32, on more CTAs), so a block is read once at K <= 32.
//     Warp w owns 16 MT rows of the block-row (MT = BR / 64 m16 tiles) over
//     all 128 block columns: no two warps share a sum, and no epilogue
//     reduction is needed. The tile rows of a lane are chosen so that its
//     A fragments for a k-step are two loads of 2 MT contiguous rows (16
//     bytes of f32 at BR = 128), read straight from device memory into
//     registers with evict-first loads: a warp's load is four full 128-byte
//     lines, and no shared memory holds the block stream;
//   * the X panel of the next block (128 rows x up to 32 columns) is copied
//     into shared memory with cp.async while the current block is used
//     (two buffers), in rows padded so that the B-fragment loads hit
//     distinct banks; tile columns are permuted so that a lane's B
//     fragments of all n-tiles are one vector load and its sums cover
//     contiguous columns of Y;
//   * epilogue: alpha/beta fused, 16-byte stores along the row-major Y
//     rows. No atomics, no split sums: results are the same from run to
//     run.
//
// Empty block-rows write beta * Y_in (0 without Y_in); rows past m are not
// stored, X rows past n read as 0, and K needs no padding.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 128;  // threads per CTA: 4 warps
constexpr int kBC = 128;       // block columns
constexpr int kSteps = kBC / 8;  // k-steps of 8 block columns a block
// at most 128 registers a thread, so that 4 CTAs (16 warps) share an SM
constexpr int kMinCtas = 4;

// cvt.rna.tf32.f32: v rounded to TF32 (10 mantissa bits, nearest, ties
// away from zero), as the bits of an f32 whose low 13 bits are zero
__device__ __forceinline__ uint32_t to_tf32(float v) {
  uint32_t u;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(u) : "f"(v));
  return u;
}

// d += a * b on the tensor cores: one m16n8k8 tile, TF32 operands, f32 sums
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 2 * MT consecutive rows of one block column, widened to f32: MT = 2 one
// 16-byte load of f32 (8 bytes of bf16), MT = 1 one 8-byte load (4 bytes)
template <int MT>
__device__ __forceinline__ void load_rows(float (&r)[2 * MT], const float* p) {
  if constexpr (MT == 2) {
    const float4 v = __ldcs(reinterpret_cast<const float4*>(p));
    r[0] = v.x;
    r[1] = v.y;
    r[2] = v.z;
    r[3] = v.w;
  } else {
    const float2 v = __ldcs(reinterpret_cast<const float2*>(p));
    r[0] = v.x;
    r[1] = v.y;
  }
}

template <int MT>
__device__ __forceinline__ void load_rows(float (&r)[2 * MT], const __nv_bfloat16* p) {
  // a bf16 is the upper half of the f32 with the same value
  if constexpr (MT == 2) {
    const uint2 v = __ldcs(reinterpret_cast<const uint2*>(p));
    r[0] = __uint_as_float(v.x << 16);
    r[1] = __uint_as_float(v.x & 0xffff0000u);
    r[2] = __uint_as_float(v.y << 16);
    r[3] = __uint_as_float(v.y & 0xffff0000u);
  } else {
    const unsigned v = __ldcs(reinterpret_cast<const unsigned*>(p));
    r[0] = __uint_as_float(v << 16);
    r[1] = __uint_as_float(v & 0xffff0000u);
  }
}

// the X panel of a chunk in shared memory: 128 rows (block columns) of
// KC = 8 * NT floats, rows KP apart so that the B-fragment loads of a warp
// hit distinct banks (KP = 8 or 24 modulo 32)
template <int NT>
struct Panel {
  static constexpr int kKC = 8 * NT;
  static constexpr int kKP = NT == 1 ? 8 : kKC + 8;
  static constexpr int kFloats = kBC * kKP;
};

// cp.async of `bytes` (16 or 4) from global to shared memory, zeros where
// !ok; then the group's commit, and the wait for all but N groups
template <int BYTES>
__device__ __forceinline__ void copy_async(float* dst, const float* src, bool ok) {
  const unsigned sa = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(sa), "l"(src),
                 "r"(ok ? 16 : 0));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(sa), "l"(src),
                 "r"(ok ? 4 : 0));
  }
}

__device__ __forceinline__ void copy_commit() { asm volatile("cp.async.commit_group;"); }

template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N));
}

// Thread t copies X[bc * 128 + t, k0 .. k0 + KC) into row t of `dst`, 16
// bytes a copy where `vec` (K a multiple of 4, X 16-byte aligned), else 4,
// zero past n and past K; one commit group.
template <int NT>
__device__ __forceinline__ void stage_x(float* dst, const float* __restrict__ x, int bc,
                                        int n, int k, int k0, bool vec) {
  using P = Panel<NT>;
  const int t = threadIdx.x;
  const long long col = static_cast<long long>(bc) * kBC + t;
  const bool row_ok = col < n;
  const float* src = x + (row_ok ? col * k : 0);
  float* d = dst + t * P::kKP;
  if (vec) {
#pragma unroll
    for (int q = 0; q < P::kKC; q += 4) {
      const bool ok = row_ok && k0 + q < k;
      copy_async<16>(d + q, ok ? src + k0 + q : x, ok);
    }
  } else {
#pragma unroll
    for (int q = 0; q < P::kKC; ++q) {
      const bool ok = row_ok && k0 + q < k;
      copy_async<4>(d + q, ok ? src + k0 + q : x, ok);
    }
  }
  copy_commit();
}

// One CTA a block-row and chunk of KC = 8 * NT columns (all K <= 32 in
// one). Warp w owns rows 16 MT w .. 16 MT (w + 1) - 1 of the block-row
// (MT = BR / 64 m16 tiles) across all 128 block columns, so no two warps
// share an output; lane (g, t) = (lane / 4, lane % 4) holds the A
// fragments of local rows 2 MT g .. 2 MT g + 2 MT - 1: tile row g of m-tile
// mt is row 2 MT g + 2 mt, tile row g + 8 the row after it, and its
// columns t and t + 4 of a k-step are two loads of 2 MT contiguous rows.
// Tile column c of n-tile nt is chunk column NT c + nt, so lane (g, t)'s B
// fragments of all n-tiles are NT contiguous floats, and its sums cover 2
// NT contiguous columns of each of its rows.
template <typename V, int BR, int NT>
__global__ void __launch_bounds__(kThreads, kMinCtas)
spmm_bsr_tc(int m, int n, int k, const int* __restrict__ bptr, const int* __restrict__ bcol,
            const V* __restrict__ blocks_t, const float* __restrict__ x,
            const float* __restrict__ y_in, float alpha, float beta, float* __restrict__ y_out,
            bool vec) {
  constexpr int MT = BR / 64;
  constexpr bool kSplitA = sizeof(V) == sizeof(float);  // bf16 values are TF32 already
  using P = Panel<NT>;
  __shared__ __align__(16) float panel[2][P::kFloats];

  const int brow = blockIdx.x;
  const int k0 = blockIdx.y * P::kKC;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int row0 = warp * 16 * MT + g * 2 * MT;  // this lane's first local row
  const int begin = bptr[brow];
  const int end = bptr[brow + 1];

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.0f;
    }
  }

  if (begin < end) stage_x<NT>(panel[0], x, bcol[begin], n, k, k0, vec);
  int cur = 0;
  for (int b = begin; b < end; ++b) {
    if (b + 1 < end) {
      stage_x<NT>(panel[cur ^ 1], x, bcol[b + 1], n, k, k0, vec);
      copy_wait<1>();
    } else {
      copy_wait<0>();
    }
    __syncthreads();  // block b's panel is in, from every thread
    const V* a = blocks_t + static_cast<size_t>(b) * kBC * BR + row0;
    const float* xs = panel[cur];
#pragma unroll 4
    for (int s = 0; s < kSteps; ++s) {
      // A: columns 8s + t and 8s + t + 4 of this lane's 2 MT rows
      float lo_col[2 * MT], hi_col[2 * MT];
      load_rows<MT>(lo_col, a + static_cast<size_t>(8 * s + t) * BR);
      load_rows<MT>(hi_col, a + static_cast<size_t>(8 * s + t + 4) * BR);
      uint32_t ah[MT][4], al[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const float v[4] = {lo_col[2 * i], lo_col[2 * i + 1], hi_col[2 * i], hi_col[2 * i + 1]};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          ah[i][c] = kSplitA ? to_tf32(v[c]) : __float_as_uint(v[c]);
          al[i][c] = kSplitA ? to_tf32(v[c] - __uint_as_float(ah[i][c])) : 0u;
        }
      }
      // B: rows 8s + t and 8s + t + 4 of the panel, NT columns from NT g
      uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float* src = xs + (8 * s + t + 4 * r) * P::kKP + NT * g;
        float v[NT];
        if constexpr (NT == 4) {
          const float4 q = *reinterpret_cast<const float4*>(src);
          v[0] = q.x;
          v[1] = q.y;
          v[2] = q.z;
          v[3] = q.w;
        } else if constexpr (NT == 2) {
          const float2 q = *reinterpret_cast<const float2*>(src);
          v[0] = q.x;
          v[1] = q.y;
        } else {
          v[0] = src[0];
        }
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          bh[j][r] = to_tf32(v[j]);
          bl[j][r] = to_tf32(v[j] - __uint_as_float(bh[j][r]));
        }
      }
      // 3xTF32: the small products first, then hi * hi (a_lo * x_lo, below
      // the f32 rounding of the sum, is left out)
      if constexpr (kSplitA) {
#pragma unroll
        for (int i = 0; i < MT; ++i) {
#pragma unroll
          for (int j = 0; j < NT; ++j) mma_tf32(acc[i][j], al[i], bh[j]);
        }
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_tf32(acc[i][j], ah[i], bl[j]);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_tf32(acc[i][j], ah[i], bh[j]);
      }
    }
    __syncthreads();  // every warp is done with this panel before it is refilled
    cur ^= 1;
  }

  // epilogue: lane (g, t) holds, for each of its rows, chunk columns 2 NT t
  // .. 2 NT t + 2 NT - 1: column 2 NT t + e NT + nt of tile row h of m-tile
  // i is acc[i][nt][2 h + e]
  const int c0 = k0 + 2 * NT * t;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long row = static_cast<long long>(brow) * BR + row0 + 2 * i + h;
      if (row >= m) continue;
      float out[2 * NT];
#pragma unroll
      for (int q = 0; q < 2 * NT; ++q) out[q] = alpha * acc[i][q % NT][2 * h + q / NT];
      float* dst = y_out + row * k + c0;
      const float* yy = y_in == nullptr ? nullptr : y_in + row * k + c0;
      if (vec && NT >= 2 && c0 + 2 * NT <= k) {
#pragma unroll
        for (int q = 0; q < 2 * NT; q += 4) {
          float4 o = make_float4(out[q], out[q + 1], out[q + 2], out[q + 3]);
          if (yy != nullptr) {
            const float4 w = *reinterpret_cast<const float4*>(yy + q);
            o.x += beta * w.x;
            o.y += beta * w.y;
            o.z += beta * w.z;
            o.w += beta * w.w;
          }
          *reinterpret_cast<float4*>(dst + q) = o;
        }
      } else {
#pragma unroll
        for (int q = 0; q < 2 * NT; ++q) {
          if (c0 + q >= k) break;
          float o = out[q];
          if (yy != nullptr) o += beta * yy[q];
          dst[q] = o;
        }
      }
    }
  }
}

template <typename V, int BR, int NT>
cudaError_t launch_chunk(int m, int n, int k, const void* bptr, const void* bcol,
                         const void* blocks_t, const void* x, const void* y_in,
                         float alpha, float beta, void* y_out, cudaStream_t stream) {
  const long long brows = (m + BR - 1) / BR;
  const int chunks = (k + 8 * NT - 1) / (8 * NT);
  if (brows > 0x7fffffffLL || chunks > 65535) return cudaErrorInvalidValue;
  const bool vec = k % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   (y_in == nullptr || reinterpret_cast<uintptr_t>(y_in) % 16 == 0) &&
                   reinterpret_cast<uintptr_t>(y_out) % 16 == 0;
  const dim3 grid(static_cast<unsigned>(brows), static_cast<unsigned>(chunks));
  spmm_bsr_tc<V, BR, NT><<<grid, kThreads, 0, stream>>>(
      m, n, k, static_cast<const int*>(bptr), static_cast<const int*>(bcol),
      static_cast<const V*>(blocks_t), static_cast<const float*>(x),
      static_cast<const float*>(y_in), alpha, beta, static_cast<float*>(y_out), vec);
  return cudaGetLastError();
}

// Columns a chunk: 8 (one n-tile) up to K = 8, 16 up to 16, else 32.
template <typename V, int BR>
cudaError_t launch_rows(int m, int n, int k, const void* bptr, const void* bcol,
                        const void* blocks_t, const void* x, const void* y_in,
                        float alpha, float beta, void* y_out, cudaStream_t s) {
  if (k <= 8)
    return launch_chunk<V, BR, 1>(m, n, k, bptr, bcol, blocks_t, x, y_in, alpha, beta, y_out, s);
  if (k <= 16)
    return launch_chunk<V, BR, 2>(m, n, k, bptr, bcol, blocks_t, x, y_in, alpha, beta, y_out, s);
  return launch_chunk<V, BR, 4>(m, n, k, bptr, bcol, blocks_t, x, y_in, alpha, beta, y_out, s);
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
