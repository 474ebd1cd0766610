// K3: Gaussian window aggregation of the five normal-equation planes and the
// per-pixel 2x2 solve.
//
// Replaces microaligner_tpu/ops/pallas_agg.py::pallas_smooth5_solve (pass 1
// `_smooth_w_padded` / `_w_kernel_ring`, pass 2 `_h_solve_kernel_ring`).  The
// window has 2r+1 taps (r = winsize // 2, sigma = 0.3 r) and a replicate
// border.  Pass 1 smooths each plane along W into a scratch tensor; pass 2
// smooths along H and solves
//   det = g11 g22 - g12^2 + 1e-3,  fx = (g11 h2 - g12 h1) / det,
//   fy = (g22 h1 - g12 h2) / det,
// writing only fx and fy.
//
// Bound on the H100: arithmetic, 2r+1 multiply-adds per tap pass, channel and
// pixel (99 x 5 x 2 on the main path), all in f32.  Each block stages its
// strip plus the r-pixel halo in shared memory, so every input is read from
// device memory once per pass and the tap loop runs out of shared memory
// without bank conflicts.  Taps are summed in ascending order with separate
// multiply and add, as the plain version sums them.
//
// Design limit: r <= 128 (pass 2 stages (64 + 2r) rows of a 32-column strip
// in 48 KB of shared memory); the wrapper checks it.
#include "common.cuh"

namespace {

constexpr int kRowTile = 512;     // pass 1: outputs per block along W
constexpr int kRowThreads = 256;
constexpr int kColW = 32;         // pass 2: columns per block
constexpr int kColThreadsY = 8;
constexpr int kColRowsPerThread = 8;
constexpr int kColRows = kColThreadsY * kColRowsPerThread;  // output rows per block

// out[p, y, x] = sum_k taps[k] * in[p, y, clamp(x + k - r)]
__global__ void smooth_rows_kernel(const float* __restrict__ in, float* __restrict__ out,
                                   const float* __restrict__ taps, int h, int w, int r) {
  extern __shared__ float smem[];
  const int ntaps = 2 * r + 1;
  float* st = smem;
  float* sx = smem + ntaps;
  const int x0 = blockIdx.x * kRowTile;
  const int64_t row = (static_cast<int64_t>(blockIdx.z) * h + blockIdx.y) * w;
  for (int i = threadIdx.x; i < ntaps; i += blockDim.x) st[i] = taps[i];
  const int span = kRowTile + 2 * r;
  for (int i = threadIdx.x; i < span; i += blockDim.x) {
    const int xx = min(max(x0 - r + i, 0), w - 1);
    sx[i] = __ldg(in + row + xx);
  }
  __syncthreads();
  for (int ox = threadIdx.x; ox < kRowTile; ox += blockDim.x) {
    if (x0 + ox >= w) break;
    float acc = ma::mul(sx[ox], st[0]);
    for (int k = 1; k < ntaps; ++k) acc = ma::add(acc, ma::mul(sx[ox + k], st[k]));
    out[row + x0 + ox] = acc;
  }
}

// Smooths the five row-smoothed planes of one image along H and solves.
__global__ void smooth_cols_solve_kernel(const float* __restrict__ in,
                                         float* __restrict__ fx, float* __restrict__ fy,
                                         const float* __restrict__ taps, int h, int w, int r) {
  extern __shared__ float smem[];
  const int ntaps = 2 * r + 1;
  float* st = smem;
  float* tile = smem + ntaps;
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kColW + tx;
  const int x = blockIdx.x * kColW + tx;
  const int y0 = blockIdx.y * kColRows;
  const int n = blockIdx.z;
  const int64_t hw = static_cast<int64_t>(h) * w;
  const int span = kColRows + 2 * r;
  for (int i = tid; i < ntaps; i += kColW * kColThreadsY) st[i] = taps[i];

  float s[5][kColRowsPerThread];
#pragma unroll
  for (int c = 0; c < 5; ++c) {
    const float* plane = in + (static_cast<int64_t>(n) * 5 + c) * hw;
    __syncthreads();  // the previous channel's reads of `tile` are done
    for (int i = ty; i < span; i += kColThreadsY) {
      const int yy = min(max(y0 - r + i, 0), h - 1);
      tile[i * kColW + tx] = x < w ? __ldg(plane + static_cast<int64_t>(yy) * w + x) : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kColRowsPerThread; ++j)
      s[c][j] = ma::mul(tile[(ty + kColThreadsY * j) * kColW + tx], st[0]);
    for (int k = 1; k < ntaps; ++k) {
      const float wk = st[k];
#pragma unroll
      for (int j = 0; j < kColRowsPerThread; ++j)
        s[c][j] = ma::add(s[c][j], ma::mul(tile[(ty + kColThreadsY * j + k) * kColW + tx], wk));
    }
  }
  if (x >= w) return;
#pragma unroll
  for (int j = 0; j < kColRowsPerThread; ++j) {
    const int y = y0 + ty + kColThreadsY * j;
    if (y >= h) break;
    const float g11 = s[0][j], g12 = s[1][j], g22 = s[2][j], h1 = s[3][j], h2 = s[4][j];
    const float det = ma::add(ma::sub(ma::mul(g11, g22), ma::mul(g12, g12)), 1e-3f);
    const float idet = __fdiv_rn(1.0f, det);
    const int64_t o = static_cast<int64_t>(n) * hw + static_cast<int64_t>(y) * w + x;
    fx[o] = ma::mul(ma::sub(ma::mul(g11, h2), ma::mul(g12, h1)), idet);
    fy[o] = ma::mul(ma::sub(ma::mul(g22, h1), ma::mul(g12, h2)), idet);
  }
}

cudaError_t launch_smooth_rows(const float* in, float* out, const float* taps, int planes,
                               int h, int w, int r, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (2 * r + 1 + kRowTile + 2 * r);
  const dim3 grid((w + kRowTile - 1) / kRowTile, h, planes);
  smooth_rows_kernel<<<grid, kRowThreads, smem, stream>>>(in, out, taps, h, w, r);
  return cudaGetLastError();
}

}  // namespace

// Pass 1 alone: `planes` (h, w) planes smoothed along W.
extern "C" int ma_smooth_rows(const float* x, float* out, const float* taps, int planes,
                              int h, int w, int r, cudaStream_t stream) {
  return static_cast<int>(launch_smooth_rows(x, out, taps, planes, h, w, r, stream));
}

// M (n, 5, h, w) -> fx, fy (n, h, w); scratch (n, 5, h, w) holds pass 1.
extern "C" int ma_smooth5_solve(const float* m, float* scratch, float* fx, float* fy,
                                const float* taps, int n, int h, int w, int r,
                                cudaStream_t stream) {
  const cudaError_t e = launch_smooth_rows(m, scratch, taps, n * 5, h, w, r, stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t smem2 = sizeof(float) * (2 * r + 1 + (kColRows + 2 * r) * kColW);
  const dim3 block2(kColW, kColThreadsY);
  const dim3 grid2((w + kColW - 1) / kColW, (h + kColRows - 1) / kColRows, n);
  smooth_cols_solve_kernel<<<grid2, block2, smem2, stream>>>(scratch, fx, fy, taps, h, w, r);
  return static_cast<int>(cudaGetLastError());
}
