// K2: polynomial expansion of both images of a pair (poly_n = 1) plus the
// first iteration's zero-flow normal equations; K6, the expansion of one
// image (below).  Both call one __device__ function for the 3x3 moments.
//
// Replaces microaligner_tpu/ops/pallas_poly.py::pallas_poly_pair_m (Pallas
// body `_pair_kernel`, moments in `_moments5`).  Inputs are the pre-smoothed
// images padded by one replicated pixel, (N, H+2, W+2); outputs are
// R0, R1 = [b_y, b_x, A_yy, A_xx, A_xy] and M0 = [G11, G12, G22, h1, h2],
// each (N, 5, H, W): R0 and R1 stored as TR and M0 as TM (float or bf16, the
// TPU kernel's `r_dtype` and `m_dtype`).  The expansion and the combine stay
// float in registers; M0 is combined from the values before they are rounded
// to TR, and each output is rounded to nearest even on store, so every
// instantiation equals the plain version bit for bit.
//
// Bound on the H100: bytes (2 planes read, 15 written, ~40 flops a pixel).
// One thread per output pixel reads its 3x3 neighbourhood of both inputs;
// the rows that neighbouring threads share come from L1, so each input byte
// is fetched from device memory about once.  The moments are summed in the
// order of the plain version (optflow/farneback.py::_poly_exp_cf: vertical
// taps first, then horizontal, zero taps skipped).
#include "common.cuh"

namespace {

struct PolyCoeffs {
  float g0, g1, xg1, xxg1, ig11, ig03, ig33, ig55;
};

// The five expansion channels of one pixel from the 3x3 window whose top-left
// corner is p (row stride `stride`).
__device__ __forceinline__ void moments5(const float* __restrict__ p, int64_t stride,
                                         const PolyCoeffs& c, float out[5]) {
  float row0[3], row1[3], row2[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const float up = __ldg(p + j);
    const float mid = __ldg(p + stride + j);
    const float dn = __ldg(p + 2 * stride + j);
    row0[j] = ma::add(ma::add(ma::mul(up, c.g0), ma::mul(mid, c.g1)), ma::mul(dn, c.g0));
    row1[j] = ma::add(ma::mul(up, -c.xg1), ma::mul(dn, c.xg1));
    row2[j] = ma::add(ma::mul(up, c.xxg1), ma::mul(dn, c.xxg1));
  }
  const float b1 = ma::add(ma::add(ma::mul(row0[0], c.g0), ma::mul(row0[1], c.g1)),
                           ma::mul(row0[2], c.g0));
  const float b2 = ma::add(ma::mul(row0[0], -c.xg1), ma::mul(row0[2], c.xg1));
  const float b4 = ma::add(ma::mul(row0[0], c.xxg1), ma::mul(row0[2], c.xxg1));
  const float b3 = ma::add(ma::add(ma::mul(row1[0], c.g0), ma::mul(row1[1], c.g1)),
                           ma::mul(row1[2], c.g0));
  const float b6 = ma::add(ma::mul(row1[0], -c.xg1), ma::mul(row1[2], c.xg1));
  const float b5 = ma::add(ma::add(ma::mul(row2[0], c.g0), ma::mul(row2[1], c.g1)),
                           ma::mul(row2[2], c.g0));
  out[0] = ma::mul(b3, c.ig11);
  out[1] = ma::mul(b2, c.ig11);
  out[2] = ma::add(ma::mul(b5, c.ig33), ma::mul(b1, c.ig03));
  out[3] = ma::add(ma::mul(b4, c.ig33), ma::mul(b1, c.ig03));
  out[4] = ma::mul(b6, c.ig55);
}

template <typename TR, typename TM>
__global__ void poly_pair_m_kernel(const float* __restrict__ sp0,
                                   const float* __restrict__ sp1,
                                   TR* __restrict__ r0, TR* __restrict__ r1,
                                   TM* __restrict__ m, int h, int w, PolyCoeffs c) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= w || y >= h) return;
  const int n = blockIdx.z;
  const int64_t pstride = w + 2;
  const int64_t pplane = static_cast<int64_t>(h + 2) * pstride;
  const int64_t win = n * pplane + static_cast<int64_t>(y) * pstride + x;
  float e0[5], e1[5];
  moments5(sp0 + win, pstride, c, e0);
  moments5(sp1 + win, pstride, c, e1);

  const int64_t hw = static_cast<int64_t>(h) * w;
  const int64_t o = static_cast<int64_t>(n) * 5 * hw + static_cast<int64_t>(y) * w + x;
#pragma unroll
  for (int ch = 0; ch < 5; ++ch) {
    r0[o + ch * hw] = ma::narrow<TR>(e0[ch]);
    r1[o + ch * hw] = ma::narrow<TR>(e1[ch]);
  }
  // zero flow: the other expansion is sampled at p itself, and the 2x2
  // stencil is inside unless p sits on the last row or column
  const bool inb = x < w - 1 && y < h - 1;
  const float scale = ma::mul(ma::edge_scale(x, w), ma::edge_scale(y, h));
  float mm[5];
  ma::combine_matrices(e0, e1, inb, 0.0f, 0.0f, scale, mm);
#pragma unroll
  for (int ch = 0; ch < 5; ++ch) m[o + ch * hw] = ma::narrow<TM>(mm[ch]);
}

// K6: the expansion of one image, no M0.
//
// Replaces microaligner_tpu/ops/pallas_poly.py::pallas_poly_exp5 (Pallas body
// `_kernel`, moments in `_moments5`), which the JAX package launches only on
// Farneback's unpaired route (MICROALIGNER_TPU_PALLAS_POLY=1, poly_n = 1):
// one launch for the movs, one for the refs, then the zero-flow combine.
//
// Bound on the H100: bytes (1 plane read, 5 written, ~20 flops a pixel).  One
// thread per output pixel, the 3x3 window from L1 as in K2, and the same
// moments5 as K2, so each expansion equals K2's R0/R1 bit for bit.
__global__ void poly_exp5_kernel(const float* __restrict__ sp, float* __restrict__ r,
                                 int h, int w, PolyCoeffs c) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= w || y >= h) return;
  const int n = blockIdx.z;
  const int64_t pstride = w + 2;
  const int64_t pplane = static_cast<int64_t>(h + 2) * pstride;
  float e[5];
  moments5(sp + n * pplane + static_cast<int64_t>(y) * pstride + x, pstride, c, e);
  const int64_t hw = static_cast<int64_t>(h) * w;
  const int64_t o = static_cast<int64_t>(n) * 5 * hw + static_cast<int64_t>(y) * w + x;
#pragma unroll
  for (int ch = 0; ch < 5; ++ch) r[o + ch * hw] = e[ch];
}

}  // namespace

extern "C" int ma_poly_exp5(const float* sp, float* r, int n, int h, int w, float g0, float g1,
                            float xg1, float xxg1, float ig11, float ig03, float ig33, float ig55,
                            cudaStream_t stream) {
  const PolyCoeffs c{g0, g1, xg1, xxg1, ig11, ig03, ig33, ig55};
  const dim3 block(32, 8);
  const dim3 grid((w + block.x - 1) / block.x, (h + block.y - 1) / block.y, n);
  poly_exp5_kernel<<<grid, block, 0, stream>>>(sp, r, h, w, c);
  return static_cast<int>(cudaGetLastError());
}

namespace {

template <typename TR, typename TM>
int launch_pair(const float* sp0, const float* sp1, void* r0, void* r1, void* m, int n, int h,
                int w, const PolyCoeffs& c, cudaStream_t stream) {
  const dim3 block(32, 8);
  const dim3 grid((w + block.x - 1) / block.x, (h + block.y - 1) / block.y, n);
  poly_pair_m_kernel<TR, TM><<<grid, block, 0, stream>>>(
      sp0, sp1, static_cast<TR*>(r0), static_cast<TR*>(r1), static_cast<TM*>(m), h, w, c);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// r_bf16 / m_bf16: R0 and R1, and M0, are stored as bf16 (1) or float (0).
extern "C" int ma_poly_pair_m(const float* sp0, const float* sp1, void* r0, void* r1, void* m,
                              int n, int h, int w, float g0, float g1, float xg1, float xxg1,
                              float ig11, float ig03, float ig33, float ig55, int r_bf16,
                              int m_bf16, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  const PolyCoeffs c{g0, g1, xg1, xxg1, ig11, ig03, ig33, ig55};
  if (r_bf16)
    return m_bf16 ? launch_pair<bf16, bf16>(sp0, sp1, r0, r1, m, n, h, w, c, stream)
                  : launch_pair<bf16, float>(sp0, sp1, r0, r1, m, n, h, w, c, stream);
  return m_bf16 ? launch_pair<float, bf16>(sp0, sp1, r0, r1, m, n, h, w, c, stream)
                : launch_pair<float, float>(sp0, sp1, r0, r1, m, n, h, w, c, stream);
}
