// K3's bf16 entry: the window aggregation as a banded bf16 product on the
// tensor cores, and the fused 2x2 solve.
//
// Replaces microaligner_tpu/ops/pallas_agg.py::pallas_smooth5_solve on bf16 M
// (pass 1 `_smooth_w_padded` / `_w_kernel_ring`, also public as
// `pallas_smooth_w`; pass 2 `_h_solve_kernel_ring`), where each pass is a
// dense bf16 matmul on the MXU with float32 accumulation against the block's
// slice of the banded replicate operator (`_band_factors`).  Here each pass
// is the same product with mma.sync.m16n8k16 (bf16 in, float32 sums):
//   pass 1 (along W): out[row, o] = sum_j x[row, j] D_W[j, o], stored bf16;
//   pass 2 (along H): s[c, y, x] = sum_j t[c, j, x] D_H[j, y] for the five
//   planes c, then det = g11 g22 - g12^2 + 1e-3, fx = (g11 h2 - g12 h1) / det,
//   fy = (g22 h1 - g12 h2) / det, writing only fx and fy.
// D is the TPU operator rounded to bf16 (its folded edge coefficients are
// entries of it), so the replicate border costs nothing here.
//
// Bound on the H100: bytes.  Five bf16 planes in and two float32 planes out
// (18 B a pixel), plus the bf16 scratch's round trip (20 B a pixel more): the
// tensor cores do the 2 x 5 x (2r+1) multiply-adds a pixel in a fraction of
// the time the bytes take.  The design:
// - The data is the A operand and the operator the B operand of both passes
//   (the TPU kernel's pass 2 puts the operator on the left; the product is
//   the same, transposed).  A warp owns kGroup = 32 consecutive outputs
//   along the filtered axis; they read the 32 + 2 R8 sources from R8 = r
//   rounded up to 8 left of them, so a warp makes (32 + 2 R8) / 16 k-steps
//   (9 at window 99) where the block's 128 outputs read 128 + 2 R8: the
//   k-steps whose factor is zero for a warp's outputs are never made.
// - The operator comes as B fragments, laid out on the host in the order the
//   lanes hold them (one 16-byte load a lane gives two n-tiles of a k-step),
//   one slot a 32-output group (see kernel_agg.tc_factor_table).  Groups
//   whose outputs lie at least r from both ends of the axis read the same
//   Toeplitz slice and share one slot, so the table is a few slots, read
//   through L1.
// - Pass 1: a block is 64 rows x 128 outputs of one plane, four warps of 64
//   rows x 32 outputs (4 x 4 m16n8 tiles).  The rows' 128 + 2 R8 sources are
//   copied once into shared memory (cp.async, 16 bytes a thread where W is a
//   multiple of 8; a row stride of an odd number of 16-byte units keeps
//   ldmatrix free of bank conflicts); sums rounded to bf16 go back through
//   shared memory and out as 16-byte stores.  Inside smooth5_solve pass 1
//   writes its sums transposed, (n, 5, W, H), 128 bytes a column of a block.
// - Pass 2 is then pass 1's product on columns: a block is 128 outputs along
//   H x 16 columns of one image; each of its five planes' 16 columns stages
//   its 128 + 2 R8 sources as one contiguous run, as pass 1 stages a row
//   (reading 32-byte pieces of 240 rows of an untransposed scratch was
//   slower on the H100).  A warp keeps the five planes' sums of its
//   16 x 32 outputs in registers: each pixel's five values sit in one thread
//   at one fragment position, so the solve is the epilogue.
// - Blocks are not persistent: several fit an SM (4 at window 99), so one
//   block's copies overlap another's products.
// Numerics: a product of two bf16 values is exact; the tensor cores sum them
// in their own order, so the entry is not bit-equal to its plain version
// (which sums the taps in ascending order): the row pass is within one bf16
// unit of it (a float32 sum can fall on the other side of a rounding
// boundary) plus what two float32 orders of one sum can differ by, which
// matters where the signed planes' sums cancel, and the flow within a bar,
// checked on the card against the plain version and against a float64 run
// of the same operator.
//
// Design limit: r <= 128 (kMaxHalfWindow, the same as the float32 entry);
// the wrapper checks it.  Sources outside [0, n) are staged as zeros and
// multiplied by zero factors.
#include <algorithm>
#include <atomic>
#include <cstdint>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBlock = 128;   // outputs a block along the filtered axis
constexpr int kGroup = 32;    // outputs a warp along it; one factor slot
constexpr int kWarps = kBlock / kGroup;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 64;     // pass 1: rows a block, 4 m-tiles a warp
constexpr int kCols = 16;     // pass 2: columns a block, 1 m-tile a warp
constexpr int kOutStride = kBlock + 8;  // pass 1's bf16 sums in shared memory, 17 units a row
constexpr int kOutStrideT = kRows + 8;  // the same, transposed: 9 units a column
constexpr int kMaxHalfWindow = 128;
constexpr int kMaxDevices = 64;

// R8: sources a group reads left (and right) of its outputs; the staged rows start on 16 bytes
__host__ __device__ constexpr int halo(int r) { return (r + 7) / 8 * 8; }
// sources a block reads: 128 + 2 R8 (240 at window 99, 384 at r = 128)
__host__ __device__ constexpr int sources(int r) { return kBlock + 2 * halo(r); }
// k-steps of 16 sources a warp makes
__host__ __device__ constexpr int steps(int r) { return (kGroup + 2 * halo(r)) / 16; }
// pass 1's staged row stride in elements: sources(r) / 8 is even, so one more
// 16-byte unit makes eight consecutive rows fall on eight different units
__host__ __device__ constexpr int row_stride(int r) { return sources(r) + 8; }

// the staged rows, or the transposed sums that take their place (more at r = 0)
size_t rows_smem(int r) { return sizeof(bf16) * std::max(kRows * row_stride(r), kBlock * kOutStrideT); }
size_t cols_smem(int r) { return sizeof(bf16) * 5 * kCols * row_stride(r); }

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes into shared memory, or 16 zero bytes when `valid` is false.
__device__ __forceinline__ void copy16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void copy_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&a)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(smem_u32(p)));
}

// d += a (16 x 16, row) * b (16 x 8, col), bf16 in, float32 sums
__device__ __forceinline__ void mma(float (&d)[4], const unsigned (&a)[4], unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The factor slot of 32-output group g: groups [gl, gt) share the interior slot gl.
__device__ __forceinline__ int slot_of(int g, int gl, int gt) {
  return g < gl ? g : g < gt ? gl : gl + 1 + (g - gt);
}

// The B fragments of k-step s for a warp's four n-tiles: b[2t], b[2t + 1] of n-tile t.
__device__ __forceinline__ void load_b(unsigned (&b)[8], const uint4* __restrict__ frag, int slot,
                                       int nsteps, int s, int lane) {
  const uint4* p = frag + (static_cast<int64_t>(slot * nsteps + s) * 2) * 32 + lane;
  const uint4 lo = __ldg(p), hi = __ldg(p + 32);
  b[0] = lo.x; b[1] = lo.y; b[2] = lo.z; b[3] = lo.w;
  b[4] = hi.x; b[5] = hi.y; b[6] = hi.z; b[7] = hi.w;
}

// Pass 1: out[p, y, x] = sum_j in[p, y, j] D[j, x], rounded to bf16.  Block
// (bx, by, p) owns rows [64 by, 64 by + 64) x outputs [128 bx, 128 bx + 128) of
// plane p and stages sources [128 bx - R8, 128 bx + 128 + R8) of those rows.
template <bool kTransposed>
__global__ void __launch_bounds__(kThreads, 4)
agg_rows_tc_kernel(const bf16* __restrict__ in, bf16* __restrict__ out, const uint4* __restrict__ frag,
                   int gl, int gt, int h, int w, int r) {
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  bf16* tile = reinterpret_cast<bf16*>(smem_bytes);
  const int kc = sources(r), stride = row_stride(r), nsteps = steps(r);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int x_out = blockIdx.x * kBlock;  // first output column
  const int x_src = x_out - halo(r);      // first staged column, a multiple of 8
  const int y0 = blockIdx.y * kRows;
  const int64_t plane = static_cast<int64_t>(blockIdx.z) * h * w;
  const bool wide = w % 8 == 0 && reinterpret_cast<uintptr_t>(in) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(out) % 16 == 0;

  // stage: a 16-byte chunk of 8 sources lies wholly inside [0, w) or outside when w % 8 == 0
  const int chunks = kc / 8;
  for (int i = tid; i < kRows * chunks; i += kThreads) {
    const int row = i / chunks, x = x_src + 8 * (i % chunks), y = y0 + row;
    bf16* dst = tile + row * stride + 8 * (i % chunks);
    if (wide) {
      const bool valid = y < h && x >= 0 && x < w;
      copy16(dst, valid ? in + plane + static_cast<int64_t>(y) * w + x : in, valid);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        dst[e] = y < h && x + e >= 0 && x + e < w ? in[plane + static_cast<int64_t>(y) * w + x + e]
                                                  : __float2bfloat16_rn(0.0f);
    }
  }
  copy_wait_all();
  __syncthreads();

  float acc[4][4][4] = {};
  const int g = blockIdx.x * kWarps + warp;  // this warp's group of 32 outputs
  if (g * kGroup < w) {
    const int slot = slot_of(g, gl, gt);
    // lane l gives ldmatrix row l % 16 of an m-tile and the k half l / 16
    const bf16* a_base = tile + (lane % 16) * stride + warp * kGroup + 8 * (lane / 16);
    for (int s = 0; s < nsteps; ++s) {
      unsigned b[8];
      load_b(b, frag, slot, nsteps, s, lane);
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        unsigned a[4];
        ldmatrix_x4(a, a_base + mt * 16 * stride + 16 * s);
#pragma unroll
        for (int t = 0; t < 4; ++t) mma(acc[mt][t], a, b[2 * t], b[2 * t + 1]);
      }
    }
  }
  __syncthreads();  // every warp has read the tile: its space takes the sums
  if constexpr (kTransposed) {
    // out is (planes, w, h): the block's sums go out as 128 columns of 64 rows, 128 bytes each
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int row = mt * 16 + lane / 4, col = warp * kGroup + t * 8 + 2 * (lane % 4);
        tile[col * kOutStrideT + row] = __float2bfloat16_rn(acc[mt][t][0]);
        tile[(col + 1) * kOutStrideT + row] = __float2bfloat16_rn(acc[mt][t][1]);
        tile[col * kOutStrideT + row + 8] = __float2bfloat16_rn(acc[mt][t][2]);
        tile[(col + 1) * kOutStrideT + row + 8] = __float2bfloat16_rn(acc[mt][t][3]);
      }
    __syncthreads();
    const bool wide_t = h % 8 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
    for (int i = tid; i < kBlock * (kRows / 8); i += kThreads) {
      const int col = i / (kRows / 8), x = x_out + col, y = y0 + 8 * (i % (kRows / 8));
      if (y >= h || x >= w) continue;
      const bf16* src = tile + col * kOutStrideT + 8 * (i % (kRows / 8));
      bf16* dst = out + plane + static_cast<int64_t>(x) * h + y;
      if (wide_t) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
        for (int e = 0; e < 8 && y + e < h; ++e) dst[e] = src[e];
      }
    }
    return;
  }
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int row = mt * 16 + lane / 4, col = warp * kGroup + t * 8 + 2 * (lane % 4);
      *reinterpret_cast<__nv_bfloat162*>(tile + row * kOutStride + col) =
          __floats2bfloat162_rn(acc[mt][t][0], acc[mt][t][1]);
      *reinterpret_cast<__nv_bfloat162*>(tile + (row + 8) * kOutStride + col) =
          __floats2bfloat162_rn(acc[mt][t][2], acc[mt][t][3]);
    }
  __syncthreads();
  for (int i = tid; i < kRows * (kBlock / 8); i += kThreads) {
    const int row = i / (kBlock / 8), x = x_out + 8 * (i % (kBlock / 8)), y = y0 + row;
    if (y >= h || x >= w) continue;
    const bf16* src = tile + row * kOutStride + 8 * (i % (kBlock / 8));
    bf16* dst = out + plane + static_cast<int64_t>(y) * w + x;
    if (wide) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int e = 0; e < 8 && x + e < w; ++e) dst[e] = src[e];
    }
  }
}

// Pass 2 and the solve, on pass 1's sums stored transposed, (n, 5, w, h):
// block (bx, by, i) owns outputs [128 bx, 128 bx + 128) along H x columns
// [16 by, 16 by + 16) of image i and stages, for each of its five planes and
// 16 columns, the column's sources [128 bx - R8, 128 bx + 128 + R8): a
// contiguous run of 128 + 2 R8 values, as pass 1 stages a row.
__global__ void __launch_bounds__(kThreads, 4)
agg_cols_solve_tc_kernel(const bf16* __restrict__ in, float* __restrict__ fx, float* __restrict__ fy,
                         const uint4* __restrict__ frag, int gl, int gt, int h, int w, int r) {
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  bf16* slab = reinterpret_cast<bf16*>(smem_bytes);
  const int kc = sources(r), stride = row_stride(r), nsteps = steps(r);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int y_src = blockIdx.x * kBlock - halo(r);
  const int x0 = blockIdx.y * kCols;
  const int64_t hw = static_cast<int64_t>(h) * w;
  const int64_t image = static_cast<int64_t>(blockIdx.z) * 5 * hw;
  const bool wide = h % 8 == 0 && reinterpret_cast<uintptr_t>(in) % 16 == 0;

  const int chunks = kc / 8;
  for (int i = tid; i < 5 * kCols * chunks; i += kThreads) {
    const int line = i / chunks, x = x0 + line % kCols, y = y_src + 8 * (i % chunks);
    bf16* dst = slab + line * stride + 8 * (i % chunks);  // line = plane * 16 + column
    const int64_t at = image + line / kCols * hw + static_cast<int64_t>(x) * h + y;
    if (wide) {
      const bool valid = x < w && y >= 0 && y < h;
      copy16(dst, valid ? in + at : in, valid);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        dst[e] = x < w && y + e >= 0 && y + e < h ? in[at + e] : __float2bfloat16_rn(0.0f);
    }
  }
  copy_wait_all();
  __syncthreads();

  const int g = blockIdx.x * kWarps + warp;  // this warp's group of 32 outputs along H
  if (g * kGroup >= h) return;
  float acc[5][4][4] = {};
  const int slot = slot_of(g, gl, gt);
  // lane l gives ldmatrix row (column) l % 16 and the k half l / 16
  const bf16* a_base = slab + (lane % 16) * stride + warp * kGroup + 8 * (lane / 16);
  for (int s = 0; s < nsteps; ++s) {
    unsigned b[8];
    load_b(b, frag, slot, nsteps, s, lane);
#pragma unroll
    for (int c = 0; c < 5; ++c) {
      unsigned a[4];
      ldmatrix_x4(a, a_base + c * kCols * stride + 16 * s);
#pragma unroll
      for (int t = 0; t < 4; ++t) mma(acc[c][t], a, b[2 * t], b[2 * t + 1]);
    }
  }
  // acc[c][t][2 half + e] is plane c's sum at column x0 + lane / 4 + 8 half, row
  // 32 g + 8 t + 2 (lane % 4) + e
#pragma unroll
  for (int t = 0; t < 4; ++t)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int y = g * kGroup + t * 8 + 2 * (lane % 4) + j % 2, x = x0 + lane / 4 + 8 * (j / 2);
      if (y >= h || x >= w) continue;
      const float g11 = acc[0][t][j], g12 = acc[1][t][j], g22 = acc[2][t][j];
      const float h1 = acc[3][t][j], h2 = acc[4][t][j];
      const float det = ma::add(ma::sub(ma::mul(g11, g22), ma::mul(g12, g12)), 1e-3f);
      const float idet = __fdiv_rn(1.0f, det);
      const int64_t o = blockIdx.z * hw + static_cast<int64_t>(y) * w + x;
      fx[o] = ma::mul(ma::sub(ma::mul(g11, h2), ma::mul(g12, h1)), idet);
      fy[o] = ma::mul(ma::sub(ma::mul(g22, h1), ma::mul(g12, h2)), idet);
    }
}

// Lifts `kernel`'s dynamic shared memory limit to what r = 128 needs, once a device.
template <typename Kernel>
cudaError_t allow_shared_memory(Kernel kernel, size_t bytes, std::atomic<bool>* done) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < kMaxDevices && done[dev].load()) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (e == cudaSuccess && dev < kMaxDevices) done[dev].store(true);
  return e;
}

std::atomic<bool> rows_allowed[2][kMaxDevices];
std::atomic<bool> cols_allowed[kMaxDevices];

int ceil_div(int a, int b) { return (a + b - 1) / b; }

// `transposed`: out is (planes, w, h), pass 2's input; else (planes, h, w).
template <bool kTransposed>
cudaError_t launch_rows(const void* in, void* out, const void* frag, int gl, int gt, int planes, int h,
                        int w, int r, cudaStream_t stream) {
  if (r < 0 || r > kMaxHalfWindow) return cudaErrorInvalidValue;
  if (planes <= 0 || h <= 0 || w <= 0) return cudaSuccess;
  const dim3 grid(ceil_div(w, kBlock), ceil_div(h, kRows), planes);
  if (grid.y > 65535 || grid.z > 65535) return cudaErrorInvalidValue;
  const cudaError_t e =
      allow_shared_memory(agg_rows_tc_kernel<kTransposed>, rows_smem(kMaxHalfWindow), rows_allowed[kTransposed]);
  if (e != cudaSuccess) return e;
  agg_rows_tc_kernel<kTransposed><<<grid, kThreads, rows_smem(r), stream>>>(
      static_cast<const bf16*>(in), static_cast<bf16*>(out), static_cast<const uint4*>(frag), gl, gt, h, w, r);
  return cudaGetLastError();
}

}  // namespace

// Pass 1 alone: `planes` bf16 (h, w) planes smoothed along W into `out`
// (bf16).  `frag`, `gl`, `gt`: the W axis's factor table (kernel_agg.tc_factor_table).
extern "C" int ma_smooth_rows_tc(const void* x, void* out, const void* frag, int gl, int gt, int planes,
                                 int h, int w, int r, cudaStream_t stream) {
  return static_cast<int>(launch_rows<false>(x, out, frag, gl, gt, planes, h, w, r, stream));
}

// bf16 M (n, 5, h, w) -> fx, fy (n, h, w) float; `scratch` (n * 5 * h * w
// bf16) holds pass 1, transposed to (n, 5, w, h).  One factor table for each
// axis.
extern "C" int ma_smooth5_solve_tc(const void* m, void* scratch, float* fx, float* fy, const void* frag_w,
                                   int gl_w, int gt_w, const void* frag_h, int gl_h, int gt_h, int n, int h,
                                   int w, int r, cudaStream_t stream) {
  cudaError_t e = launch_rows<true>(m, scratch, frag_w, gl_w, gt_w, 5 * n, h, w, r, stream);
  if (e != cudaSuccess || n <= 0 || h <= 0 || w <= 0) return static_cast<int>(e);
  const dim3 grid(ceil_div(h, kBlock), ceil_div(w, kCols), n);
  if (grid.y > 65535 || grid.z > 65535) return static_cast<int>(cudaErrorInvalidValue);
  e = allow_shared_memory(agg_cols_solve_tc_kernel, cols_smem(kMaxHalfWindow), cols_allowed);
  if (e != cudaSuccess) return static_cast<int>(e);
  agg_cols_solve_tc_kernel<<<grid, kThreads, cols_smem(r), stream>>>(
      static_cast<const bf16*>(scratch), fx, fy, static_cast<const uint4*>(frag_h), gl_h, gt_h, h, w, r);
  return static_cast<int>(cudaGetLastError());
}
