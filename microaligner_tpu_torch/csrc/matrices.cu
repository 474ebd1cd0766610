// K4: Farneback matrix update for iterations 2..n.
//
// Replaces microaligner_tpu/ops/pallas_matrices.py::pallas_update_matrices
// (Pallas body `_kernel`).  For every pixel p the five channels of R1 are
// sampled bilinearly at p + (fx, fy)(p) and combined with R0(p) into the
// normal equations M = [G11, G12, G22, h1, h2] as
// optflow/farneback.py::_combine_matrices_cf does: the sample counts only
// when the whole 2x2 stencil lies inside the image, and the outer 5 px are
// down-weighted.
//
// Bound on the H100: bytes (R0 five planes, R1 four taps of five planes,
// fx, fy read; five planes written).  One thread per pixel gathers its taps
// directly, exact for any displacement; the TPU kernel's band and its
// exact-gather fallback are gone.
#include "common.cuh"

namespace {

__global__ void update_matrices_kernel(const float* __restrict__ R0,
                                       const float* __restrict__ R1,
                                       const float* __restrict__ fx,
                                       const float* __restrict__ fy,
                                       float* __restrict__ M, int h, int w) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= w || y >= h) return;
  const int n = blockIdx.z;
  const int64_t hw = static_cast<int64_t>(h) * w;
  const int64_t pix = static_cast<int64_t>(y) * w + x;
  const float dx = fx[n * hw + pix];
  const float dy = fy[n * hw + pix];
  const float x1 = floorf(dx);
  const float y1 = floorf(dy);
  const float tx = ma::sub(dx, x1);
  const float ty = ma::sub(dy, y1);
  const int ax = x + ma::floor_index(x1);
  const int ay = y + ma::floor_index(y1);
  const bool inb = ax >= 0 && ax < w - 1 && ay >= 0 && ay < h - 1;

  const int64_t base = static_cast<int64_t>(n) * 5 * hw;
  float r0[5], samp[5];
#pragma unroll
  for (int c = 0; c < 5; ++c) {
    r0[c] = R0[base + c * hw + pix];
    samp[c] = 0.0f;
  }
  if (inb) {
    const int64_t t = static_cast<int64_t>(ay) * w + ax;
#pragma unroll
    for (int c = 0; c < 5; ++c) {
      const float* p = R1 + base + c * hw + t;
      samp[c] = ma::bilinear(__ldg(p), __ldg(p + 1), __ldg(p + w), __ldg(p + w + 1), tx, ty);
    }
  }
  const float scale = ma::mul(ma::edge_scale(x, w), ma::edge_scale(y, h));
  float m[5];
  ma::combine_matrices(r0, samp, inb, dx, dy, scale, m);
#pragma unroll
  for (int c = 0; c < 5; ++c) M[base + c * hw + pix] = m[c];
}

}  // namespace

extern "C" int ma_update_matrices(const float* R0, const float* R1, const float* fx,
                                  const float* fy, float* M, int n, int h, int w,
                                  cudaStream_t stream) {
  const dim3 block(32, 8);
  const dim3 grid((w + block.x - 1) / block.x, (h + block.y - 1) / block.y, n);
  update_matrices_kernel<<<grid, block, 0, stream>>>(R0, R1, fx, fy, M, h, w);
  return static_cast<int>(cudaGetLastError());
}
