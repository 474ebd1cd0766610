// Shared device helpers for the port's hand-written Hopper kernels.
//
// Every arithmetic step that the plain PyTorch versions perform as a separate
// elementwise op is written here with the round-to-nearest intrinsics
// (__fmul_rn, __fadd_rn, __fsub_rn), which the compiler never contracts into
// an FMA.  The kernels therefore round at the same places, in the same order,
// as their plain versions, and agree with them bit for bit.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ma {

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// A stored value as float (exact), and a float stored as T: bf16 rounds to
// nearest even, as tensor.to(torch.bfloat16) does.
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T narrow(float v);
template <>
__device__ __forceinline__ float narrow<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// floor(v) as an int, clamped so that a huge or non-finite displacement
// cannot overflow the pixel index it is added to (such taps land outside the
// image and read zero).
__device__ __forceinline__ int floor_index(float floored) {
  return static_cast<int>(fminf(fmaxf(floored, -1073741824.0f), 1073741824.0f));
}

// Bilinear blend of four taps, in the order of the plain version:
// ((v00*ux)*uy + (v01*tx)*uy) + (v10*ux)*ty + (v11*tx)*ty.
__device__ __forceinline__ float bilinear(float v00, float v01, float v10, float v11,
                                          float tx, float ty) {
  const float ux = sub(1.0f, tx);
  const float uy = sub(1.0f, ty);
  float acc = mul(mul(v00, ux), uy);
  acc = add(acc, mul(mul(v01, tx), uy));
  acc = add(acc, mul(mul(v10, ux), ty));
  acc = add(acc, mul(mul(v11, tx), ty));
  return acc;
}

// OpenCV's down-weighting of the displacement equations in the outer 5 px
// (optflow/farneback.py::_BORDER_SCALE = [0.14, 0.14, 0.4472, 0.4472, 0.4472]).
__device__ __forceinline__ float border_weight(int i) {
  return i <= 1 ? 0.14f : 0.4472f;
}

__device__ __forceinline__ float edge_scale(int i, int size) {
  const float lead = i < 5 ? border_weight(i) : 1.0f;
  const int ti = size - 1 - i;
  const float trail = ti < 5 ? border_weight(ti) : 1.0f;
  return mul(lead, trail);
}

// The displacement normal equations M = [G11, G12, G22, h1, h2] of one pixel
// from its own expansion r0 and the expansion of the other image sampled at
// p + (dx, dy) (optflow/farneback.py::_combine_matrices_cf).
__device__ __forceinline__ void combine_matrices(const float r0[5], const float samp[5],
                                                 bool inb, float dx, float dy,
                                                 float scale, float m[5]) {
  float r2 = inb ? samp[0] : 0.0f;
  float r3 = inb ? samp[1] : 0.0f;
  float r4 = inb ? mul(add(r0[2], samp[2]), 0.5f) : r0[2];
  float r5 = inb ? mul(add(r0[3], samp[3]), 0.5f) : r0[3];
  float r6 = inb ? mul(add(r0[4], samp[4]), 0.25f) : mul(r0[4], 0.5f);
  r2 = mul(sub(r0[0], r2), 0.5f);
  r3 = mul(sub(r0[1], r3), 0.5f);
  r2 = add(add(r2, mul(r4, dy)), mul(r6, dx));
  r3 = add(add(r3, mul(r6, dy)), mul(r5, dx));
  r2 = mul(r2, scale);
  r3 = mul(r3, scale);
  r4 = mul(r4, scale);
  r5 = mul(r5, scale);
  r6 = mul(r6, scale);
  m[0] = add(mul(r4, r4), mul(r6, r6));
  m[1] = mul(add(r4, r5), r6);
  m[2] = add(mul(r5, r5), mul(r6, r6));
  m[3] = add(mul(r4, r2), mul(r6, r3));
  m[4] = add(mul(r6, r2), mul(r5, r3));
}

}  // namespace ma
