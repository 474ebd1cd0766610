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
// Bound on the H100: float32 arithmetic, one fused multiply-add a tap, pass,
// channel and pixel (99 x 5 x 2 on the main path); the scratch's round trip
// through device memory comes second (about 95 bytes a pixel in all, tile
// halos included, against 1,980 multiply-adds).  The design keeps the other
// pipes out of the multiply-add's way:
// - A thread owns kOut = 16 consecutive outputs along the filtered axis and
//   slides a register window over the inputs they need, so a value loaded
//   from shared memory feeds 16 multiply-adds (`slide`).  In pass 2 a thread
//   is one column of a 32-column tile and the 32 lanes read 32 consecutive
//   floats.  In pass 1 it is one row of a 32-row tile and loads its inputs 16
//   bytes at a time; the row stride is 4 mod 8 floats, so the 8 lanes that
//   such a load serves together read 8 different 16-byte columns of the banks.
// - The taps come in the kernel's parameters (constant memory): the tap index
//   is the same for the whole warp and costs no shared-memory load.
// - A tile is kSpan = 256 outputs along the axis: 256 + 2r lines are staged to
//   write 256 (1.38 reads an output at r = 49).  Two tiles live in dynamic
//   shared memory (130 KB at r = 128).
// - Blocks are persistent: as many as the device holds at once (two an SM in
//   pass 1, one in pass 2, whose 80 accumulators take 124 registers), each
//   walking over every gridDim.x-th tile.  The next tile is copied with
//   cp.async while the current one is summed, across planes and tile
//   positions, so only a block's first tile is waited for.
// - The copies are 16 bytes a thread where W is a multiple of 4 and, in pass
//   1, the tile needs no border: with 4 bytes a copy, issuing the copies
//   took a quarter of a pass's time from the sums.  Pass 1's tiles start up
//   to 3 columns left of the image so that each one's first staged column is
//   a multiple of 4.
// - Pass 1 turns its sums through the tile it has just read, so that the
//   scratch is written in full rows.
// Each tap is one __fmaf_rn, taps in ascending order: the sums round once a
// tap where the plain version rounds twice, so K3 agrees with its plain
// version to a bar (1e-4 px), not bit for bit, and is no further from a
// float64 run than the plain version is.
//
// Design limit: r <= 128, the size of the tap table in the parameters; the
// wrapper checks it.  The zero taps that pad the table to whole steps
// multiply staged, finite inputs.
//
// Stored types.  Both kernels are templates on T, the type M and the scratch
// are stored in: float, or bf16 on Farneback's reduced-precision route, where
// the TPU kernel runs both passes in M's dtype (its band factors cast to it,
// its pass-1 output stored in it) with float accumulation.  For bf16 the
// wrapper hands over taps already rounded to bf16; staged values are widened
// to float, each product of two bf16 values is exact in float, so the single
// rounding of each __fmaf_rn is the plain version's rounding of its add and
// the bf16 kernels equal their plain version bit for bit.  Pass 1 rounds its
// sums to bf16 into the scratch; pass 2 sums those and solves in float.  The
// TPU operator folds the taps that the replicate border sends to an edge
// pixel into one coefficient for that pixel, summed in float64 and rounded
// once (microaligner_tpu/optflow/farneback.py::_banded_smooth_matrix); in
// bf16 that differs from rounding each tap, so the outputs within r of
// either end of an axis are summed again with those coefficients
// (`border_sum`, the `Folds` table).  The whole block shares that work, a
// warp to one line of them: left to the threads that own those outputs, the
// few tiles at an axis's ends take about ten times as long as the rest (the
// kernel three times as long as the float one on the H100).  Pass 1 writes those sums
// straight out; pass 2 hands them to their owners through a table in shared
// memory, one channel at a time.  A vector copy or load is 4 elements
// (16 bytes of float, 8 of bf16) for both types, so the tile geometry, the
// row strides' bank spread and the W % 4 condition of the wide copies are
// the same; bf16's one-element copies are plain loads and stores (cp.async
// moves 4, 8 or 16 bytes).
#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kSpan = 256;       // outputs a block along the filtered axis
constexpr int kLanes = 32;       // lines a block across it, one a lane
constexpr int kOut = 16;         // consecutive outputs a thread
constexpr int kRowTaps = 20;     // taps an unrolled step of pass 1 (99 -> 5 x 20), a multiple of 4
constexpr int kColTaps = 11;     // taps an unrolled step of pass 2 (99 = 9 x 11)
constexpr int kGroups = kSpan / kOut;  // threadIdx.y: a thread's place along the axis
constexpr int kThreads = kLanes * kGroups;
constexpr int kMaxHalfWindow = 128;
constexpr int kTurnStride = kSpan + 1;  // pass 1's sums in the tile, odd row stride
constexpr int kMaxDevices = 64;
constexpr int kVec = 4;  // elements a vector copy or load moves

using bf16 = __nv_bfloat16;
// the bf16 route sums the outputs near an axis's ends again, with the folded coefficients
template <typename T>
constexpr bool kFolded = std::is_same_v<T, bf16>;

// 2r+1 taps rounded up to whole steps of `step` taps; the tail is zero.
__host__ __device__ constexpr int padded_taps(int r, int step) {
  return (2 * r + 1 + step - 1) / step * step;
}

struct Taps {
  float v[padded_taps(kMaxHalfWindow, kRowTaps) > padded_taps(kMaxHalfWindow, kColTaps)
              ? padded_taps(kMaxHalfWindow, kRowTaps)
              : padded_taps(kMaxHalfWindow, kColTaps)];
};

// The bf16 route's border coefficients (see the header): lead[i] is what
// output i <= r applies to pixel 0 of its axis, trail[d] what output n-1-d
// applies to pixel n-1, and total what the one output of a one-pixel axis
// applies to its pixel; each already rounded to bf16.
struct Folds {
  float lead[kMaxHalfWindow + 1];
  float trail[kMaxHalfWindow + 1];
  float total;
};

// Pass 1's tile: kSpan + ntp staged columns a row, on a row stride of 4 mod 8
// elements.  Rows then start on a vector, and the lanes that a vector load
// serves together (8 of 16 bytes, or 16 of 8 bytes) read different columns
// of the banks.
__host__ __device__ constexpr int row_tile_stride(int r) {
  const int span4 = (kSpan + padded_taps(r, kRowTaps) + 3) / 4 * 4;
  return span4 % 8 == 0 ? span4 + 4 : span4;
}

// Columns left of the image at which pass 1's tiles start.
__host__ __device__ constexpr int row_tile_pad(int r) { return (4 - r % 4) % 4; }

// One element into shared memory: cp.async for a float; a bf16 (2 bytes,
// which cp.async does not move) is loaded and stored.
__device__ __forceinline__ void copy_one(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void copy_one(bf16* dst, const bf16* src) { *dst = *src; }
// kVec elements into shared memory: 16 bytes of float, 8 of bf16.
__device__ __forceinline__ void copy_vec(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void copy_vec(bf16* dst, const bf16* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// dst[i] = in[i * kStride] as float, i < kCount.  Consecutive inputs
// (kStride == 1) lie on a vector and are loaded kVec at a time.
template <int kStride, int kCount, typename T>
__device__ __forceinline__ void load_inputs(const T* __restrict__ in, float* dst) {
  if constexpr (kStride == 1) {
    static_assert(kCount % kVec == 0, "whole vector loads");
#pragma unroll
    for (int i = 0; i < kCount / kVec; ++i) {
      if constexpr (std::is_same_v<T, float>) {
        const float4 v = reinterpret_cast<const float4*>(in)[i];
        dst[4 * i] = v.x;
        dst[4 * i + 1] = v.y;
        dst[4 * i + 2] = v.z;
        dst[4 * i + 3] = v.w;
      } else {
        const uint2 v = reinterpret_cast<const uint2*>(in)[i];
        const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
        const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
        dst[4 * i] = lo.x;
        dst[4 * i + 1] = lo.y;
        dst[4 * i + 2] = hi.x;
        dst[4 * i + 3] = hi.y;
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < kCount; ++i) dst[i] = ma::widen(in[i * kStride]);
  }
}

// Inputs a thread carries from one step to the next: the kOut - 1 that the
// next step's first tap still needs, or kOut where they come four at a time.
template <int kStride>
constexpr int kHeld = kStride == 1 ? kOut : kOut - 1;

// acc[j] = sum_k taps[k] * in[(j + k) * kStride], k ascending, j < kOut.
// `in` is the thread's first staged input; it reads ntp + kHeld of them.  A
// window of kHeld + kTaps inputs lives in registers: each step loads kTaps
// new inputs and kTaps taps for kOut * kTaps multiply-adds.
template <int kStride, int kTaps, typename T>
__device__ __forceinline__ void slide(const T* __restrict__ in, const Taps& taps, int ntp,
                                      float (&acc)[kOut]) {
  constexpr int held = kHeld<kStride>;
  float win[held + kTaps];
#pragma unroll
  for (int j = 0; j < kOut; ++j) acc[j] = 0.0f;
  load_inputs<kStride, held>(in, win);
  for (int k0 = 0; k0 < ntp; k0 += kTaps) {
    load_inputs<kStride, kTaps>(in + (k0 + held) * kStride, win + held);
#pragma unroll
    for (int k = 0; k < kTaps; ++k) {
      const float t = taps.v[k0 + k];
#pragma unroll
      for (int j = 0; j < kOut; ++j) acc[j] = __fmaf_rn(win[j + k], t, acc[j]);
    }
#pragma unroll
    for (int i = 0; i < held; ++i) win[i] = win[i + kTaps];
  }
}

// The bf16 route's sum for output i of an axis of n pixels: sum_k c_k *
// in[k * kStride], k ascending, where c_k is the coefficient the TPU operator
// gives the pixel tap k reads: 0 where the tap falls outside the axis (its
// weight is in the edge pixel's), the folded coefficient at an edge pixel,
// the bf16 tap elsewhere.  The zero taps are skipped: adding an exact zero
// changes no sum.  `in` is output i's first staged input.
template <int kStride, typename T>
__device__ __forceinline__ float border_sum(const T* __restrict__ in, const Taps& taps,
                                            const Folds& folds, int i, int n, int r) {
  const int lo = max(0, r - i);              // the first tap on the axis
  const int hi = min(2 * r, n - 1 - i + r);  // the last
  const float c_lo = i > r ? taps.v[0] : n == 1 ? folds.total : folds.lead[i];
  float acc = __fmaf_rn(ma::widen(in[lo * kStride]), c_lo, 0.0f);
  for (int k = lo + 1; k < hi; ++k) acc = __fmaf_rn(ma::widen(in[k * kStride]), taps.v[k], acc);
  if (hi > lo) {
    const float c_hi = i >= n - 1 - r ? folds.trail[n - 1 - i] : taps.v[2 * r];
    acc = __fmaf_rn(ma::widen(in[hi * kStride]), c_hi, acc);
  }
  return acc;
}

// Whether output i of an axis of n pixels reads a replicated tap, so that the
// bf16 route sums it with `border_sum`.
__device__ __forceinline__ bool near_edge(int i, int n, int r) {
  return i >= 0 && i < n && (i < r || i >= n - r);
}

// The outputs of [first, first + span) that are near an edge of an axis of n
// pixels, as at most two runs: count of them, the c-th at at(c).
struct EdgeRuns {
  int lo0, n0, lo1, count;
  __device__ int at(int c) const { return c < n0 ? lo0 + c : lo1 + (c - n0); }
};

__device__ __forceinline__ EdgeRuns edge_runs(int first, int span, int n, int r) {
  const int a = max(first, 0), b = min(first + span, n);
  const int l1 = min(b, r);                 // [0, r)
  const int r0 = max(a, max(n - r, r));     // [n - r, n), less what [0, r) holds
  const int n0 = max(0, l1 - a);
  return {a, n0, r0, n0 + max(0, b - r0)};
}

// out[p, y, x] = sum_k taps[k] * in[p, y, clamp(x + k - r)].  A tile is 32 rows
// x 256 columns of one plane, lane = row; a block walks over every
// gridDim.x-th tile and copies its next tile while it sums this one.  Tiles
// start `pad` columns left of the image so that a tile's first staged column,
// its first output less r, is a multiple of 4: where W is one too, a tile
// that needs no border is copied 16 bytes a thread.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
smooth_rows_kernel(const T* __restrict__ in, T* __restrict__ out, const __grid_constant__ Taps taps,
                   const __grid_constant__ Folds folds, int planes, int h, int w, int r) {
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  T* smem = reinterpret_cast<T*>(smem_bytes);
  const int ntp = padded_taps(r, kRowTaps);
  const int span = kSpan + ntp;  // staged columns
  const int stride = row_tile_stride(r);
  const int lane = threadIdx.x;
  const int g = threadIdx.y;
  const int pad = row_tile_pad(r);
  const int tiles_x = (w + pad + kSpan - 1) / kSpan;
  const int tiles_y = (h + kLanes - 1) / kLanes;
  const int tiles = planes * tiles_y * tiles_x;
  const int64_t hw = static_cast<int64_t>(h) * w;
  const bool aligned = w % kVec == 0 && reinterpret_cast<uintptr_t>(in) % (kVec * sizeof(T)) == 0;

  auto stage = [&](int tile, T* dst) {
    const int x0 = tile % tiles_x * kSpan - pad - r;  // first staged column
    const int y0 = tile / tiles_x % tiles_y * kLanes;
    const T* plane = in + (tile / tiles_x / tiles_y) * hw;
    const int span4 = (span + kVec - 1) / kVec * kVec;
    const bool wide = aligned && x0 >= 0 && x0 + span4 <= w;
    for (int row = g; row < kLanes; row += kGroups) {
      const T* src = plane + static_cast<int64_t>(min(y0 + row, h - 1)) * w;
      if (wide) {
        for (int i = kVec * lane; i < span4; i += kVec * kLanes)
          copy_vec(dst + row * stride + i, src + x0 + i);
      } else {
        for (int i = lane; i < span; i += kLanes)
          copy_one(dst + row * stride + i, src + min(max(x0 + i, 0), w - 1));
      }
    }
    cp_async_commit();
  };

  T* cur = smem;
  T* next = smem + kLanes * stride;
  stage(blockIdx.x, cur);
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    cp_async_wait_all();
    __syncthreads();  // this tile has landed; the other buffer is free
    if (tile + gridDim.x < tiles) stage(tile + gridDim.x, next);
    float acc[kOut];
    slide<1, kRowTaps>(cur + lane * stride + g * kOut, taps, ntp, acc);
    const int x0 = tile % tiles_x * kSpan - pad;  // first output column
    const int y0 = tile / tiles_x % tiles_y * kLanes;
    T* plane = out + (tile / tiles_x / tiles_y) * hw;
    if constexpr (kFolded<T>) {
      // the tile's outputs near either end of the row, shared by the whole block (a warp
      // takes one column's rows) and written here; the slide's sums there are not written
      const EdgeRuns e = edge_runs(x0, kSpan, w, r);
      const int rows = min(kLanes, h - y0);
      for (int b = g * kLanes + lane; b < rows * e.count; b += kThreads) {
        const int row = b % rows;
        const int x = e.at(b / rows);
        plane[static_cast<int64_t>(y0 + row) * w + x] =
            ma::narrow<T>(border_sum<1>(cur + row * stride + (x - x0), taps, folds, x, w, r));
      }
    }
    __syncthreads();  // every thread has read its inputs: turn the sums through the tile
#pragma unroll
    for (int j = 0; j < kOut; ++j) cur[lane * kTurnStride + g * kOut + j] = ma::narrow<T>(acc[j]);
    __syncthreads();
    for (int row = g; row < kLanes && y0 + row < h; row += kGroups) {
      T* dst = plane + static_cast<int64_t>(y0 + row) * w + x0;
      for (int i = lane; i < kSpan && x0 + i < w; i += kLanes)
        if (x0 + i >= 0 && !(kFolded<T> && near_edge(x0 + i, w, r))) dst[i] = cur[row * kTurnStride + i];
    }
    T* t = cur;
    cur = next;
    next = t;
  }
}

// Smooths the five row-smoothed planes of one image along H and solves.  A
// tile is 256 rows x 32 columns of one plane, lane = column; a block walks
// over every gridDim.x-th tile position through its five planes and copies
// the next plane's (or position's) tile while it sums this one.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
smooth_cols_solve_kernel(const T* __restrict__ in, float* __restrict__ fx, float* __restrict__ fy,
                         const __grid_constant__ Taps taps, const __grid_constant__ Folds folds,
                         int n, int h, int w, int r) {
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  T* smem = reinterpret_cast<T*>(smem_bytes);
  const int ntp = padded_taps(r, kColTaps);
  const int span = kSpan + ntp - 1;  // staged rows
  const int lane = threadIdx.x;
  const int g = threadIdx.y;
  const int tiles_x = (w + kLanes - 1) / kLanes;
  const int tiles_y = (h + kSpan - 1) / kSpan;
  const int tiles = n * tiles_y * tiles_x;
  const int64_t hw = static_cast<int64_t>(h) * w;
  // a vector a copy where every row of a tile starts on a vector
  const bool wide = w % kVec == 0 && reinterpret_cast<uintptr_t>(in) % (kVec * sizeof(T)) == 0;
  const int tid = g * kLanes + lane;
  auto stage = [&](int tile, int c, T* dst) {
    const int x0 = tile % tiles_x * kLanes;
    const int y0 = tile / tiles_x % tiles_y * kSpan - r;
    const T* plane = in + (static_cast<int64_t>(tile / tiles_x / tiles_y) * 5 + c) * hw;
    if (wide) {
      const int col = kVec * (tid % (kLanes / kVec));
      const T* src = plane + min(x0 + col, w - kVec);
      for (int i = tid / (kLanes / kVec); i < span; i += kThreads / (kLanes / kVec))
        copy_vec(dst + i * kLanes + col, src + static_cast<int64_t>(min(max(y0 + i, 0), h - 1)) * w);
    } else {
      const T* src = plane + min(x0 + lane, w - 1);
      for (int i = g; i < span; i += kGroups)
        copy_one(dst + i * kLanes + lane, src + static_cast<int64_t>(min(max(y0 + i, 0), h - 1)) * w);
    }
    cp_async_commit();
  };

  T* cur = smem;
  T* next = smem + span * kLanes;
  stage(blockIdx.x, 0, cur);
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    float s[5][kOut];
#pragma unroll
    for (int c = 0; c < 5; ++c) {
      cp_async_wait_all();
      __syncthreads();  // this tile has landed; the other buffer is free
      if (c + 1 < 5) {
        stage(tile, c + 1, next);
      } else if (tile + gridDim.x < tiles) {
        stage(tile + gridDim.x, 0, next);
      }
      slide<kLanes, kColTaps>(cur + g * kOut * kLanes + lane, taps, ntp, s[c]);
      if constexpr (kFolded<T>) {
        // the tile's outputs near either end of the column, shared by the whole block (a warp
        // takes one row's columns) through a table in shared memory
        const int y_first = tile / tiles_x % tiles_y * kSpan;
        const EdgeRuns e = edge_runs(y_first, kSpan, h, r);
        if (e.count > 0) {  // the same for the whole block
          float* edge = reinterpret_cast<float*>(smem + 2 * span * kLanes);
          for (int b = tid; b < e.count * kLanes; b += kThreads) {
            const int y = e.at(b / kLanes) - y_first;
            edge[y * kLanes + b % kLanes] =
                border_sum<kLanes>(cur + y * kLanes + b % kLanes, taps, folds, y + y_first, h, r);
          }
          __syncthreads();
#pragma unroll
          for (int j = 0; j < kOut; ++j)
            if (near_edge(y_first + g * kOut + j, h, r)) s[c][j] = edge[(g * kOut + j) * kLanes + lane];
        }  // the next channel's first barrier frees the table
      }
      T* t = cur;
      cur = next;
      next = t;
    }
    const int x = tile % tiles_x * kLanes + lane;
    if (x >= w) continue;
    const int y0 = tile / tiles_x % tiles_y * kSpan + g * kOut;
    const int64_t o = (tile / tiles_x / tiles_y) * hw + static_cast<int64_t>(y0) * w + x;
#pragma unroll
    for (int j = 0; j < kOut; ++j) {
      if (y0 + j >= h) break;
      const float g11 = s[0][j], g12 = s[1][j], g22 = s[2][j], h1 = s[3][j], h2 = s[4][j];
      const float det = ma::add(ma::sub(ma::mul(g11, g22), ma::mul(g12, g12)), 1e-3f);
      const float idet = __fdiv_rn(1.0f, det);
      fx[o + static_cast<int64_t>(j) * w] = ma::mul(ma::sub(ma::mul(g11, h2), ma::mul(g12, h1)), idet);
      fy[o + static_cast<int64_t>(j) * w] = ma::mul(ma::sub(ma::mul(g22, h1), ma::mul(g12, h2)), idet);
    }
  }
}

template <typename T>
size_t rows_smem(int r) {
  return sizeof(T) * 2 * kLanes * row_tile_stride(r);
}

// Two staged tiles, and for bf16 the table of a tile's sums near the column's ends.
template <typename T>
size_t cols_smem(int r) {
  return sizeof(T) * 2 * (kSpan + padded_taps(r, kColTaps) - 1) * kLanes +
         (kFolded<T> ? sizeof(float) * kSpan * kLanes : 0);
}

// Lifts `kernel`'s dynamic shared memory limit to `bytes` (what r = 128
// needs), once a device.
template <typename Kernel>
cudaError_t allow_shared_memory(Kernel kernel, size_t bytes, std::atomic<bool>* done) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < kMaxDevices && done[dev].load()) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(bytes));
  if (e == cudaSuccess && dev < kMaxDevices) done[dev].store(true);
  return e;
}

// one flag a device for each kernel and type
template <typename T>
std::atomic<bool> rows_allowed[kMaxDevices];
template <typename T>
std::atomic<bool> cols_allowed[kMaxDevices];

// As many blocks as the device runs at once with `smem` bytes each, at most
// one a tile.
template <typename Kernel>
cudaError_t resident_blocks(Kernel kernel, size_t smem, int64_t tiles, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (e == cudaSuccess && per_sm < 1) e = cudaErrorLaunchOutOfResources;
  *blocks = static_cast<int>(std::min<int64_t>(tiles, static_cast<int64_t>(sms) * per_sm));
  return e;
}

// `taps`: 2r+1 floats in host memory, followed for bf16 by the border
// coefficients: lead (r+1), trail (r+1) and total (1).
cudaError_t make_taps(const float* taps, int r, bool folded, Taps* out, Folds* folds) {
  if (r < 0 || r > kMaxHalfWindow) return cudaErrorInvalidValue;
  std::memset(out, 0, sizeof(Taps));
  std::memset(folds, 0, sizeof(Folds));
  std::memcpy(out->v, taps, sizeof(float) * (2 * r + 1));
  if (folded) {
    std::memcpy(folds->lead, taps + 2 * r + 1, sizeof(float) * (r + 1));
    std::memcpy(folds->trail, taps + 3 * r + 2, sizeof(float) * (r + 1));
    folds->total = taps[4 * r + 3];
  }
  return cudaSuccess;
}

int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

template <typename T>
cudaError_t launch_smooth_rows(const void* in, void* out, const Taps& taps, const Folds& folds,
                               int planes, int h, int w, int r, cudaStream_t stream) {
  const int64_t tiles = planes * ceil_div(h, kLanes) * ceil_div(w + row_tile_pad(r), kSpan);
  if (tiles <= 0) return cudaSuccess;
  if (tiles > INT32_MAX) return cudaErrorInvalidValue;
  cudaError_t e =
      allow_shared_memory(smooth_rows_kernel<T>, rows_smem<T>(kMaxHalfWindow), rows_allowed<T>);
  int blocks = 0;
  if (e == cudaSuccess) e = resident_blocks(smooth_rows_kernel<T>, rows_smem<T>(r), tiles, &blocks);
  if (e != cudaSuccess) return e;
  smooth_rows_kernel<T><<<blocks, dim3(kLanes, kGroups), rows_smem<T>(r), stream>>>(
      static_cast<const T*>(in), static_cast<T*>(out), taps, folds, planes, h, w, r);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_smooth_cols_solve(const void* in, float* fx, float* fy, const Taps& taps,
                                     const Folds& folds, int n, int h, int w, int r,
                                     cudaStream_t stream) {
  const int64_t tiles = n * ceil_div(h, kSpan) * ceil_div(w, kLanes);
  if (tiles <= 0) return cudaSuccess;
  if (tiles > INT32_MAX) return cudaErrorInvalidValue;
  cudaError_t e = allow_shared_memory(smooth_cols_solve_kernel<T>, cols_smem<T>(kMaxHalfWindow),
                                      cols_allowed<T>);
  int blocks = 0;
  if (e == cudaSuccess)
    e = resident_blocks(smooth_cols_solve_kernel<T>, cols_smem<T>(r), tiles, &blocks);
  if (e != cudaSuccess) return e;
  smooth_cols_solve_kernel<T><<<blocks, dim3(kLanes, kGroups), cols_smem<T>(r), stream>>>(
      static_cast<const T*>(in), fx, fy, taps, folds, n, h, w, r);
  return cudaGetLastError();
}

template <typename T>
cudaError_t smooth5_solve(const void* m, void* scratch, float* fx, float* fy, const Taps& taps,
                          const Folds& folds, int n, int h, int w, int r, cudaStream_t stream) {
  const cudaError_t e = launch_smooth_rows<T>(m, scratch, taps, folds, n * 5, h, w, r, stream);
  if (e != cudaSuccess) return e;
  return launch_smooth_cols_solve<T>(scratch, fx, fy, taps, folds, n, h, w, r, stream);
}

}  // namespace

// Pass 1 alone: `planes` (h, w) planes smoothed along W, stored as bf16 (bf16
// = 1, with the bf16 route's taps and border coefficients in `taps`) or
// float.  `taps` is in host memory (see make_taps); every other pointer is
// device memory.
extern "C" int ma_smooth_rows(const void* x, void* out, const float* taps, int planes, int h,
                              int w, int r, int bf16_io, cudaStream_t stream) {
  Taps t;
  Folds f;
  const cudaError_t e = make_taps(taps, r, bf16_io, &t, &f);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(bf16_io ? launch_smooth_rows<bf16>(x, out, t, f, planes, h, w, r, stream)
                                  : launch_smooth_rows<float>(x, out, t, f, planes, h, w, r, stream));
}

// M (n, 5, h, w) -> fx, fy (n, h, w) float; scratch (n, 5, h, w) holds pass 1
// in M's type, bf16 (bf16 = 1) or float.  `taps` is in host memory (see
// make_taps).
extern "C" int ma_smooth5_solve(const void* m, void* scratch, float* fx, float* fy,
                                const float* taps, int n, int h, int w, int r, int bf16_io,
                                cudaStream_t stream) {
  Taps t;
  Folds f;
  const cudaError_t e = make_taps(taps, r, bf16_io, &t, &f);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(bf16_io ? smooth5_solve<bf16>(m, scratch, fx, fy, t, f, n, h, w, r, stream)
                                  : smooth5_solve<float>(m, scratch, fx, fy, t, f, n, h, w, r, stream));
}
