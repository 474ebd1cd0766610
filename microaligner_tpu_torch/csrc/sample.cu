// K1: bilinear displacement sampling, out(p) = img(p + (fx, fy)(p)), and K5,
// the same for N planes that share one displacement field (below).
//
// Replaces microaligner_tpu/ops/pallas_sample.py::pallas_sample_displaced
// (Pallas body `_kernel_batched`).  The TPU kernel avoided gathers with a
// band of shifted views, exact only for integer displacements within
// [-band, band-1]; here one thread gathers its four taps directly, so any
// displacement is exact and no banded/exact branch is needed.
//
// Bound on the H100: bytes.  Per pixel it reads fx, fy and four taps and
// writes one f32; neighbouring threads own neighbouring pixels, so the flow
// reads and the store coalesce, and for smooth flows the taps of a warp fall
// on one or two cache lines of each of two rows.
#include "common.cuh"

namespace {

__global__ void sample_displaced_kernel(const float* __restrict__ img,
                                        const float* __restrict__ fx,
                                        const float* __restrict__ fy,
                                        float* __restrict__ out, int h, int w) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= w || y >= h) return;
  const int64_t plane = static_cast<int64_t>(blockIdx.z) * h * w;
  const int64_t i = plane + static_cast<int64_t>(y) * w + x;
  const float dx = fx[i];
  const float dy = fy[i];
  const float x1 = floorf(dx);
  const float y1 = floorf(dy);
  const float tx = ma::sub(dx, x1);
  const float ty = ma::sub(dy, y1);
  const int xi = x + ma::floor_index(x1);
  const int yi = y + ma::floor_index(y1);
  const float* p = img + plane;
  const bool x0in = xi >= 0 && xi < w;
  const bool x1in = xi + 1 >= 0 && xi + 1 < w;
  const bool y0in = yi >= 0 && yi < h;
  const bool y1in = yi + 1 >= 0 && yi + 1 < h;
  const int64_t r0 = static_cast<int64_t>(yi) * w;
  const int64_t r1 = r0 + w;
  const float v00 = (y0in && x0in) ? __ldg(p + r0 + xi) : 0.0f;
  const float v01 = (y0in && x1in) ? __ldg(p + r0 + xi + 1) : 0.0f;
  const float v10 = (y1in && x0in) ? __ldg(p + r1 + xi) : 0.0f;
  const float v11 = (y1in && x1in) ? __ldg(p + r1 + xi + 1) : 0.0f;
  out[i] = ma::bilinear(v00, v01, v10, v11, tx, ty);
}

// K5: K1 for N planes that share one displacement field.
//
// Replaces microaligner_tpu/ops/pallas_sample.py::pallas_sample_displaced_multi
// (Pallas body `_kernel_multi`), the z-stack apply: every channel and z-plane
// of a cycle is pulled by the cycle's one flow.  The TPU kernel computed its
// banded weight planes once per block and broadcast them over the planes;
// here a thread reads fx, fy once, computes floor, fractions, tap offsets and
// their validity once, then loops over the planes with four gathers each.
//
// Bound on the H100: bytes.  Per pixel it reads the flow once (8 bytes) and,
// per plane, four taps and one store; N K1 launches would read the flow N
// times.  The arithmetic per plane is ma::bilinear, rounded as in K1, so each
// plane equals a K1 launch on it bit for bit.
__global__ void sample_displaced_multi_kernel(const float* __restrict__ img,
                                              const float* __restrict__ fx,
                                              const float* __restrict__ fy,
                                              float* __restrict__ out, int n, int h, int w) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= w || y >= h) return;
  const int64_t i = static_cast<int64_t>(y) * w + x;
  const float dx = fx[i];
  const float dy = fy[i];
  const float x1 = floorf(dx);
  const float y1 = floorf(dy);
  const float tx = ma::sub(dx, x1);
  const float ty = ma::sub(dy, y1);
  const int xi = x + ma::floor_index(x1);
  const int yi = y + ma::floor_index(y1);
  const bool x0in = xi >= 0 && xi < w;
  const bool x1in = xi + 1 >= 0 && xi + 1 < w;
  const bool y0in = yi >= 0 && yi < h;
  const bool y1in = yi + 1 >= 0 && yi + 1 < h;
  const bool m00 = y0in && x0in, m01 = y0in && x1in, m10 = y1in && x0in, m11 = y1in && x1in;
  const int64_t r0 = static_cast<int64_t>(yi) * w + xi;
  const int64_t r1 = r0 + w;
  const int64_t plane = static_cast<int64_t>(h) * w;
  for (int k = 0; k < n; ++k) {
    const float* p = img + k * plane;
    const float v00 = m00 ? __ldg(p + r0) : 0.0f;
    const float v01 = m01 ? __ldg(p + r0 + 1) : 0.0f;
    const float v10 = m10 ? __ldg(p + r1) : 0.0f;
    const float v11 = m11 ? __ldg(p + r1 + 1) : 0.0f;
    out[k * plane + i] = ma::bilinear(v00, v01, v10, v11, tx, ty);
  }
}

}  // namespace

extern "C" int ma_sample_displaced(const float* img, const float* fx, const float* fy,
                                   float* out, int n, int h, int w, cudaStream_t stream) {
  const dim3 block(32, 8);
  const dim3 grid((w + block.x - 1) / block.x, (h + block.y - 1) / block.y, n);
  sample_displaced_kernel<<<grid, block, 0, stream>>>(img, fx, fy, out, h, w);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ma_sample_displaced_multi(const float* img, const float* fx, const float* fy,
                                         float* out, int n, int h, int w, cudaStream_t stream) {
  const dim3 block(32, 8);
  const dim3 grid((w + block.x - 1) / block.x, (h + block.y - 1) / block.y);
  sample_displaced_multi_kernel<<<grid, block, 0, stream>>>(img, fx, fy, out, n, h, w);
  return static_cast<int>(cudaGetLastError());
}
