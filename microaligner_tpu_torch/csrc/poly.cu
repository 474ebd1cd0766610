// K2: polynomial expansion of both images of a pair (poly_n = 1) plus the
// first iteration's zero-flow normal equations; K6, the expansion of one
// image (below).  Both sum the 3x3 moments with the same __device__
// functions (`vertical`, then `horizontal`).
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
// With one pixel a thread, 18 scalar loads and 15 scalar stores a pixel
// (2-byte ones for bf16), memory instructions, not bytes, held it back.  So
// a thread owns kPix = 4 consecutive pixels of a plane's
// flat index (a warp 128, a block 1,024, each plane's stores one contiguous
// run): where they lie in one row it computes the vertical taps of the 6
// columns of their windows once (36 loads, as float2 where W is even, for
// 4 pixels) and every output plane gets one packed store, 8 bytes of bf16
// or 16 of float.  A group that crosses a row end computes each pixel from
// its own (y, x).  A plane's row y starts at flat index y * W, so a group
// (at a multiple of 4) is aligned for its vector stores in every plane when
// H * W is a multiple of 4; otherwise its pixels are stored one by one.  The
// moments are summed in the order of the plain version
// (optflow/farneback.py::_poly_exp_cf: vertical taps first, then
// horizontal, zero taps skipped), so every instantiation stays bit-equal.
#include "common.cuh"

namespace {

struct PolyCoeffs {
  float g0, g1, xg1, xxg1, ig11, ig03, ig33, ig55;
};

// The three vertical taps of one column of a 3x3 window.
struct Column {
  float row0, row1, row2;
};

__device__ __forceinline__ Column vertical(float up, float mid, float dn, const PolyCoeffs& c) {
  return {ma::add(ma::add(ma::mul(up, c.g0), ma::mul(mid, c.g1)), ma::mul(dn, c.g0)),
          ma::add(ma::mul(up, -c.xg1), ma::mul(dn, c.xg1)),
          ma::add(ma::mul(up, c.xxg1), ma::mul(dn, c.xxg1))};
}

// The five expansion channels of one pixel from its window's three columns.
__device__ __forceinline__ void horizontal(const Column& l, const Column& m, const Column& r,
                                           const PolyCoeffs& c, float out[5]) {
  const float b1 = ma::add(ma::add(ma::mul(l.row0, c.g0), ma::mul(m.row0, c.g1)), ma::mul(r.row0, c.g0));
  const float b2 = ma::add(ma::mul(l.row0, -c.xg1), ma::mul(r.row0, c.xg1));
  const float b4 = ma::add(ma::mul(l.row0, c.xxg1), ma::mul(r.row0, c.xxg1));
  const float b3 = ma::add(ma::add(ma::mul(l.row1, c.g0), ma::mul(m.row1, c.g1)), ma::mul(r.row1, c.g0));
  const float b6 = ma::add(ma::mul(l.row1, -c.xg1), ma::mul(r.row1, c.xg1));
  const float b5 = ma::add(ma::add(ma::mul(l.row2, c.g0), ma::mul(m.row2, c.g1)), ma::mul(r.row2, c.g0));
  out[0] = ma::mul(b3, c.ig11);
  out[1] = ma::mul(b2, c.ig11);
  out[2] = ma::add(ma::mul(b5, c.ig33), ma::mul(b1, c.ig03));
  out[3] = ma::add(ma::mul(b4, c.ig33), ma::mul(b1, c.ig03));
  out[4] = ma::mul(b6, c.ig55);
}

// The five expansion channels of one pixel from the 3x3 window whose top-left
// corner is p (row stride `stride`).
__device__ __forceinline__ void moments5(const float* __restrict__ p, int64_t stride,
                                         const PolyCoeffs& c, float out[5]) {
  Column col[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) col[j] = vertical(__ldg(p + j), __ldg(p + stride + j), __ldg(p + 2 * stride + j), c);
  horizontal(col[0], col[1], col[2], c, out);
}

constexpr int kPix = 4;          // consecutive pixels a thread
constexpr int kPairThreads = 256;

// v[i] = p[i], i < kPix + 2; as float2 where p lies on 8 bytes (`pairs`).
__device__ __forceinline__ void load_row(const float* __restrict__ p, bool pairs, float (&v)[kPix + 2]) {
  if (pairs) {
#pragma unroll
    for (int i = 0; i < (kPix + 2) / 2; ++i) {
      const float2 t = __ldg(reinterpret_cast<const float2*>(p) + i);
      v[2 * i] = t.x;
      v[2 * i + 1] = t.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < kPix + 2; ++i) v[i] = __ldg(p + i);
  }
}

// kPix values of one plane, each rounded to nearest even into T: one store.
__device__ __forceinline__ void store_group(float* dst, const float (&v)[kPix]) {
  *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store_group(__nv_bfloat16* dst, const float (&v)[kPix]) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(dst) =
      make_uint2(*reinterpret_cast<const unsigned*>(&lo), *reinterpret_cast<const unsigned*>(&hi));
}

// Stores out[ch][j] at dst + ch * hw + j: one packed store a plane where
// `vec`, else pixel by pixel for the `count` pixels of the group.
template <typename T>
__device__ __forceinline__ void store_planes(T* __restrict__ dst, int64_t hw, const float (&out)[5][kPix],
                                             bool vec, int count) {
#pragma unroll
  for (int ch = 0; ch < 5; ++ch) {
    if (vec) {
      store_group(dst + ch * hw, out[ch]);
    } else {
      for (int j = 0; j < count; ++j) dst[ch * hw + j] = ma::narrow<T>(out[ch][j]);
    }
  }
}

// Thread t of image n owns the pixels of flat index [4t, 4t + 4) in the (h, w)
// plane.  `pairs`: W is even and both inputs lie on 8 bytes; `vec`: H * W is a
// multiple of 4 and the outputs lie on 16 bytes.
template <typename TR, typename TM>
__global__ void __launch_bounds__(kPairThreads)
poly_pair_m_kernel(const float* __restrict__ sp0, const float* __restrict__ sp1, TR* __restrict__ r0,
                   TR* __restrict__ r1, TM* __restrict__ m, int h, int w, PolyCoeffs c, bool pairs, bool vec) {
  const int hw = h * w;
  const int f0 = (blockIdx.x * kPairThreads + threadIdx.x) * kPix;
  if (f0 >= hw) return;
  const int n = blockIdx.y;
  const int64_t pstride = w + 2;
  const int64_t pplane = static_cast<int64_t>(h + 2) * pstride;
  const float* a = sp0 + n * pplane;
  const float* b = sp1 + n * pplane;
  const int y = f0 / w, x = f0 - y * w;
  const int count = min(kPix, hw - f0);
  float e0[5][kPix], e1[5][kPix], px[5];
  if (x + kPix <= w) {  // one row: the 6 columns' vertical taps once
    Column ca[kPix + 2], cb[kPix + 2];
    {
      float up[kPix + 2], mid[kPix + 2], dn[kPix + 2];
      const int64_t o = y * pstride + x;
      load_row(a + o, pairs, up);
      load_row(a + o + pstride, pairs, mid);
      load_row(a + o + 2 * pstride, pairs, dn);
#pragma unroll
      for (int i = 0; i < kPix + 2; ++i) ca[i] = vertical(up[i], mid[i], dn[i], c);
      load_row(b + o, pairs, up);
      load_row(b + o + pstride, pairs, mid);
      load_row(b + o + 2 * pstride, pairs, dn);
#pragma unroll
      for (int i = 0; i < kPix + 2; ++i) cb[i] = vertical(up[i], mid[i], dn[i], c);
    }
#pragma unroll
    for (int j = 0; j < kPix; ++j) {
      horizontal(ca[j], ca[j + 1], ca[j + 2], c, px);
#pragma unroll
      for (int ch = 0; ch < 5; ++ch) e0[ch][j] = px[ch];
      horizontal(cb[j], cb[j + 1], cb[j + 2], c, px);
#pragma unroll
      for (int ch = 0; ch < 5; ++ch) e1[ch][j] = px[ch];
    }
  } else {  // across a row end, or the plane's last group: each pixel from its own (y, x)
#pragma unroll
    for (int j = 0; j < kPix; ++j) {
      const int f = min(f0 + j, hw - 1);
      const int64_t o = static_cast<int64_t>(f / w) * pstride + f % w;
      moments5(a + o, pstride, c, px);
#pragma unroll
      for (int ch = 0; ch < 5; ++ch) e0[ch][j] = px[ch];
      moments5(b + o, pstride, c, px);
#pragma unroll
      for (int ch = 0; ch < 5; ++ch) e1[ch][j] = px[ch];
    }
  }
  const int64_t hw64 = hw;
  const int64_t at = static_cast<int64_t>(n) * 5 * hw64 + f0;
  store_planes(r0 + at, hw64, e0, vec, count);
  store_planes(r1 + at, hw64, e1, vec, count);
  // zero flow: the other expansion is sampled at p itself, and the 2x2
  // stencil is inside unless p sits on the last row or column
  float mm[5][kPix];
#pragma unroll
  for (int j = 0; j < kPix; ++j) {
    const int f = min(f0 + j, hw - 1);
    const int yj = f / w, xj = f % w;
    const bool inb = xj < w - 1 && yj < h - 1;
    const float scale = ma::mul(ma::edge_scale(xj, w), ma::edge_scale(yj, h));
    float p0[5], p1[5];
#pragma unroll
    for (int ch = 0; ch < 5; ++ch) {
      p0[ch] = e0[ch][j];
      p1[ch] = e1[ch][j];
    }
    ma::combine_matrices(p0, p1, inb, 0.0f, 0.0f, scale, px);
#pragma unroll
    for (int ch = 0; ch < 5; ++ch) mm[ch][j] = px[ch];
  }
  store_planes(m + at, hw64, mm, vec, count);
}

// K6: the expansion of one image, no M0.
//
// Replaces microaligner_tpu/ops/pallas_poly.py::pallas_poly_exp5 (Pallas body
// `_kernel`, moments in `_moments5`), which the JAX package launches only on
// Farneback's unpaired route (MICROALIGNER_TPU_PALLAS_POLY=1, poly_n = 1):
// one launch for the movs, one for the refs, then the zero-flow combine.
//
// Bound on the H100: bytes (1 plane read, 5 written, ~20 flops a pixel).  One
// thread per output pixel, the 3x3 window from L1 through moments5, which
// makes the steps K2 makes for each of its pixels, so each expansion equals
// K2's R0/R1 bit for bit.
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

bool on(const void* p, uintptr_t bytes) { return reinterpret_cast<uintptr_t>(p) % bytes == 0; }

template <typename TR, typename TM>
int launch_pair(const float* sp0, const float* sp1, void* r0, void* r1, void* m, int n, int h,
                int w, const PolyCoeffs& c, cudaStream_t stream) {
  const int64_t groups = (static_cast<int64_t>(h) * w + kPix - 1) / kPix;
  if (n <= 0 || groups <= 0) return 0;
  const dim3 grid(static_cast<unsigned>((groups + kPairThreads - 1) / kPairThreads), n);
  const bool pairs = w % 2 == 0 && on(sp0, 8) && on(sp1, 8);
  const bool vec = static_cast<int64_t>(h) * w % kPix == 0 && on(r0, 16) && on(r1, 16) && on(m, 16);
  poly_pair_m_kernel<TR, TM><<<grid, kPairThreads, 0, stream>>>(
      sp0, sp1, static_cast<TR*>(r0), static_cast<TR*>(r1), static_cast<TM*>(m), h, w, c, pairs, vec);
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
