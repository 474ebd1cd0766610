// K1: bilinear displacement sampling, out(p) = img(p + (fx, fy)(p)), and K5,
// the same for N planes that share one displacement field (below).
//
// Replaces microaligner_tpu/ops/pallas_sample.py::pallas_sample_displaced
// (Pallas body `_kernel_batched`).  The TPU kernel avoided gathers with a
// band of shifted views, exact only for integer displacements within
// [-band, band-1]; here a thread gathers its taps directly, so any
// displacement is exact and no banded/exact branch is needed.
//
// Bound on the H100: bytes.  Per output it reads fx, fy and four taps (for
// smooth flows mostly from L1: neighbouring outputs share them) and writes
// one f32.  A one-output thread has two flow loads and then four gathers in
// flight, which left the kernel latency-bound at about 70% of its bound,
// behind F.grid_sample at the 20480^2 band slab.  The design:
// - A block of 32 x 8 threads owns a tile of 16 rows x 64 columns; a thread
//   owns 4 outputs, columns lane + 32 j of rows warp and warp + 8, so that a
//   warp's flow loads, gathers and stores fall on consecutive words.
// - Every flow load of the thread is issued before its first gather, and
//   all 16 gathers before the first blend.  Beside the flow's loads the
//   image under each output is prefetched into L1, so that a smooth flow's
//   gathers, issued a flow latency later, find their lines there.
// - The output (and the displacement) may be a window of rows x cols pixels
//   whose row 0 is image row `row0`: output pixel (x, y) samples the image
//   at (x + fx, row0 + y + fy).  The affine warps pass one band of output
//   rows at a time this way; with the whole image and row0 = 0 it is the
//   plain K1.  One image plane a grid z.
#include <climits>
#include <type_traits>

#include "common.cuh"

namespace {

namespace k1 {

constexpr int kLanes = 32, kWarps = 8, kThreads = kLanes * kWarps;
constexpr int kCols = 2, kRows = 2, kOut = kCols * kRows;
constexpr int kTileW = kLanes * kCols, kTileH = kWarps * kRows;  // 64 x 16 outputs
constexpr int kMinBlocks = 4;                                   // blocks an SM: at most 64 registers a thread

struct Args {
  const float* img;  // (n, h, w)
  const float* fx;   // (n, rows, cols): displacement of output (x, y)
  const float* fy;
  float* out;        // (n, rows, cols)
  int h, w;          // the image
  int rows, cols;    // the output window
  int row0;          // image row of output row 0
};

__global__ void __launch_bounds__(kThreads, kMinBlocks) sample_kernel(const Args a) {
  const int lane = threadIdx.x, warp = threadIdx.y;
  const int x0 = blockIdx.x * kTileW + lane;
  const int y0 = blockIdx.y * kTileH + warp;
  const size_t k = blockIdx.z;
  const float* __restrict__ img = a.img + k * a.h * static_cast<size_t>(a.w);
  const size_t plane = static_cast<size_t>(a.rows) * a.cols;
  const float* __restrict__ fx = a.fx + k * plane;
  const float* __restrict__ fy = a.fy + k * plane;
  float dx[kOut], dy[kOut];
  unsigned active = 0u;
#pragma unroll
  for (int o = 0; o < kOut; ++o) {
    const int x = x0 + (o % kCols) * kLanes, y = y0 + (o / kCols) * kWarps;
    dx[o] = dy[o] = 0.0f;
    if (x >= a.cols || y >= a.rows) continue;
    active |= 1u << o;
    dx[o] = __ldg(fx + (y * a.cols + x));
    dy[o] = __ldg(fy + (y * a.cols + x));
  }
#pragma unroll
  for (int o = 0; o < kOut; ++o) {
    const int x = x0 + (o % kCols) * kLanes, y = a.row0 + y0 + (o / kCols) * kWarps;
    if ((active >> o & 1u) && x < a.w && y < a.h) {
      asm volatile("prefetch.global.L1 [%0];" ::"l"(img + (y * a.w + x)));
    }
  }
  float tx[kOut], ty[kOut];
  int i00[kOut];
  unsigned m[kOut];
#pragma unroll
  for (int o = 0; o < kOut; ++o) {
    const int x = x0 + (o % kCols) * kLanes, y = a.row0 + y0 + (o / kCols) * kWarps;
    const float x1 = floorf(dx[o]), y1 = floorf(dy[o]);
    tx[o] = ma::sub(dx[o], x1);
    ty[o] = ma::sub(dy[o], y1);
    const int xi = x + ma::floor_index(x1), yi = y + ma::floor_index(y1);
    const bool x0in = xi >= 0 && xi < a.w, x1in = xi + 1 >= 0 && xi + 1 < a.w;
    const bool y0in = yi >= 0 && yi < a.h, y1in = yi + 1 >= 0 && yi + 1 < a.h;
    m[o] = (active >> o & 1u) ? ((y0in && x0in) | (y0in && x1in) << 1 | (y1in && x0in) << 2 | (y1in && x1in) << 3)
                              : 0u;
    i00[o] = m[o] ? yi * a.w + xi : 0;  // in [-w - 1, h * w) when any tap is in
  }
  float v[kOut][4];
#pragma unroll
  for (int o = 0; o < kOut; ++o) {
    const int i = i00[o];
    v[o][0] = (m[o] & 1u) ? __ldg(img + i) : 0.0f;
    v[o][1] = (m[o] & 2u) ? __ldg(img + i + 1) : 0.0f;
    v[o][2] = (m[o] & 4u) ? __ldg(img + i + a.w) : 0.0f;
    v[o][3] = (m[o] & 8u) ? __ldg(img + i + a.w + 1) : 0.0f;
  }
  float* __restrict__ out = a.out + k * plane;
#pragma unroll
  for (int o = 0; o < kOut; ++o) {
    if (!(active >> o & 1u)) continue;
    const int x = x0 + (o % kCols) * kLanes, y = y0 + (o / kCols) * kWarps;
    out[y * a.cols + x] = ma::bilinear(v[o][0], v[o][1], v[o][2], v[o][3], tx[o], ty[o]);
  }
}

}  // namespace k1

// K5: K1 for N planes that share one displacement field.
//
// Replaces microaligner_tpu/ops/pallas_sample.py::pallas_sample_displaced_multi
// (Pallas body `_kernel_multi`), the z-stack apply: every channel and z-plane
// of a cycle is pulled by the cycle's one flow.  The TPU kernel computed its
// banded weight planes once per block and broadcast them over the planes.
//
// Bound on the H100: bytes.  Per pixel it reads the flow once and, per
// plane, one stored value and writes one; N K1 launches would read the flow
// N times.  The design:
// - A block of 32 x 8 threads owns a tile of 16 rows x 64 columns; a thread
//   owns 4 outputs, columns lane + 32 j (j < 2) of two rows, so that a warp's
//   flow loads, stores and shared-memory reads fall on consecutive words.
//   It reads the flow, splits floor and fraction and computes its taps once.
// - Staged branch: each plane's window of taps is copied into shared memory
//   as stored (16-byte cp.async copies, zeros outside the valid rows and
//   columns) and the taps are read from there.  The copies run in a ring of
//   kStages windows, kStages - 1 planes ahead of the one being summed, with
//   one barrier a plane.  The first planes' windows (the tile and margins of
//   2 rows and 8 columns, 16 for 8-bit planes) are issued on speculation
//   right after the flow's loads: their latency overlaps the flow's without
//   delaying it, which at 2 planes is most of a block's life.  The block
//   then reduces its taps to a bounding box.  If the box lies in that window
//   (a flow within about 2 rows and 8 columns), the ring goes on from it; else, if the
//   box fits a window, the ring restarts at the box (a larger or uniform
//   shift).
// - Direct branch: where the box does not fit (a flow that tears the tile
//   apart), or where the row stride is not a multiple of 16 bytes, the
//   block gathers its taps from global memory, K1's way.
//   Both branches round as K1 does, so every plane equals a K1 launch on it
//   bit for bit.
// - Typed in and out: the planes may be stored as u8, i8, u16, i16, i32 or
//   f32 and are converted as the taps are read; the output is rounded half
//   to even, clamped and converted in the store (`round_to_dtype`), so the
//   z-stack apply reads the stored planes and writes its result with no f32
//   copies.
// - A launch writes output rows [row0, row0 + rows) of the image; taps on
//   source rows outside [lo, hi) read zero (a band of the z-stack apply with
//   its halo), as do taps outside the columns [0, w).
// - The flow is either two planes fx, fy (taps at p + f) or one interleaved
//   (h, w, 2) field read with the sign -1 (taps at p - f, the Warper's pull),
//   given by the launch's first row, an element stride and a row pitch, so
//   a band's own flow in its slab coordinates (the banded Farneback's) is
//   read in place.  Negation is exact, so both round as K1 on the negated
//   flow does.
namespace k5 {

constexpr int kLanes = 32, kWarps = 8, kThreads = kLanes * kWarps;
constexpr int kCols = 2, kRows = 2, kOut = kCols * kRows;
constexpr int kTileW = kLanes * kCols, kTileH = kWarps * kRows;  // 64 x 16 outputs
constexpr int kMarginY = 2, kMarginX = 8;  // of the window staged on speculation, around the tile
constexpr int kWinH = kTileH + 2 * kMarginY;                     // rows of a window
constexpr int kWinW = kTileW + 2 * (kMarginX > 16 ? kMarginX : 16);  // row pitch of a window
constexpr int kStages = 3;                    // windows in the cp.async ring
constexpr int kBufBytes = kWinH * kWinW * 4;  // one window of 4-byte values
constexpr int kMinBlocks = 4;                 // blocks an SM: 64 registers a thread, no spills

struct Args {
  const void* img;  // (n, h, w) Tin
  // displacement of output (x, y), image row row0 + y: fsign * fx[y * fpitch + x * fstride]
  const float* fx;
  const float* fy;
  int fstride, fpitch;
  float fsign;
  void* out;  // (n, h, w) Tout
  int n, h, w;
  int row0, rows;         // output rows [row0, row0 + rows)
  int lo, hi;             // valid source rows [lo, hi)
  unsigned int* staged;  // null, or a count of the tiles that took the staged branch
};

__device__ __forceinline__ float clamp_keep_nan(float v, float lo, float hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// round_to_dtype: round half to even, clamp to the type's range (as float32
// bounds, like torch.clamp on a float32 tensor), convert (saturating, NaN to 0)
template <typename T>
struct Store;
template <>
struct Store<float> {
  __device__ static float cvt(float v) { return v; }
};
template <>
struct Store<uint8_t> {
  __device__ static uint8_t cvt(float v) {
    return static_cast<uint8_t>(clamp_keep_nan(rintf(v), 0.0f, 255.0f));
  }
};
template <>
struct Store<int8_t> {
  __device__ static int8_t cvt(float v) {
    return static_cast<int8_t>(clamp_keep_nan(rintf(v), -128.0f, 127.0f));
  }
};
template <>
struct Store<uint16_t> {
  __device__ static uint16_t cvt(float v) {
    return static_cast<uint16_t>(clamp_keep_nan(rintf(v), 0.0f, 65535.0f));
  }
};
template <>
struct Store<int16_t> {
  __device__ static int16_t cvt(float v) {
    return static_cast<int16_t>(clamp_keep_nan(rintf(v), -32768.0f, 32767.0f));
  }
};
template <>
struct Store<int32_t> {
  // 2147483647 is 2147483648.0f as a float32 bound; the conversion saturates,
  // as round_to_dtype's float64 clamp does
  __device__ static int32_t cvt(float v) {
    return static_cast<int32_t>(clamp_keep_nan(rintf(v), -2147483648.0f, 2147483648.0f));
  }
};

// A stored value as float32, the value `.to(torch.float32)` gives: 8- and
// 16-bit integers as the float32 2^23 + v less 2^23 (exact, on the
// full-rate integer and float pipes rather than the conversion unit), i32
// rounded to nearest.
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(int32_t v) { return static_cast<float>(v); }
__device__ __forceinline__ float to_f32(uint16_t v) {
  return ma::sub(__uint_as_float(0x4B000000u | v), 8388608.0f);
}
__device__ __forceinline__ float to_f32(int16_t v) {
  return ma::sub(__uint_as_float(0x4B000000u | static_cast<unsigned>(v + 32768)), 8421376.0f);
}
__device__ __forceinline__ float to_f32(uint8_t v) {
  return ma::sub(__uint_as_float(0x4B000000u | v), 8388608.0f);
}
__device__ __forceinline__ float to_f32(int8_t v) {
  return ma::sub(__uint_as_float(0x4B000000u | static_cast<unsigned>(v + 128)), 8388736.0f);
}

// 16 bytes from global to shared memory, or 16 zero bytes when !full (the
// source is then not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool full) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(full ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Per thread: its outputs' fractions and top-left taps, and which are inside
// the launch's output window.
struct Taps {
  float tx[kOut], ty[kOut];
  int xi[kOut], yi[kOut];
  unsigned active;
};

// One plane's outputs from its staged window (stored values, row pitch kWinW).
template <typename Tin, typename Tout>
__device__ __forceinline__ void sum_window(const Args& a, const Taps& t, const int (&off)[kOut],
                                           const Tin* __restrict__ s, Tout* __restrict__ dst, int out0) {
#pragma unroll
  for (int o = 0; o < kOut; ++o) {
    if (!(t.active >> o & 1u)) continue;
    const Tin* p = s + off[o];
    const float v = ma::bilinear(to_f32(p[0]), to_f32(p[1]), to_f32(p[kWinW]), to_f32(p[kWinW + 1]),
                                 t.tx[o], t.ty[o]);
    dst[out0 + (o / kCols) * kWarps * a.w + (o % kCols) * kLanes] = Store<Tout>::cvt(v);
  }
}

// The columns of Tin's windows: the tile and a margin of kMarginX, or of
// 16 bytes where that is more, on each side.
template <typename Tin>
struct Span {
  static constexpr int V = 16 / static_cast<int>(sizeof(Tin));  // values in 16 bytes
  static constexpr int kMargin = kMarginX > V ? kMarginX : V;
  static constexpr int kCols = kTileW + 2 * kMargin;
};

// Rows [0, nrow) of plane `src`'s window at (wy0, wx0), Span<Tin>::kCols
// columns, into `buf` as stored, by 16-byte cp.async copies; zeros outside
// the valid rows and columns.  Needs the row stride and wx0 on 16 bytes.
template <typename Tin>
__device__ __forceinline__ void issue_window(const Args& a, const Tin* __restrict__ src, Tin* buf, int tid,
                                             int wy0, int wx0, int nrow) {
  constexpr int V = Span<Tin>::V, kChunkCols = Span<Tin>::kCols / V;
  for (int e = tid; e < nrow * kChunkCols; e += kThreads) {
    const int r = e / kChunkCols, c = e % kChunkCols;
    const int sr = wy0 + r, sc = wx0 + c * V;
    const bool ok = sr >= a.lo && sr < a.hi && sc >= 0 && sc < a.w;
    cp_async16(buf + r * kWinW + c * V, ok ? src + (sr * a.w + sc) : src, ok);
  }
}

__device__ __forceinline__ unsigned char* ring_slot(unsigned char* smem, int k) {
  return smem + (k % kStages) * kBufBytes;
}

// The staged branch's offsets of each output's top-left tap in a window at
// (wy0, wx0).
__device__ __forceinline__ void window_offsets(const Taps& t, int wy0, int wx0, int (&off)[kOut]) {
#pragma unroll
  for (int o = 0; o < kOut; ++o) {
    off[o] = (t.active >> o & 1u) ? (t.yi[o] - wy0) * kWinW + (t.xi[o] - wx0) : 0;
  }
}

// The staged branch on the cp.async route: the windows of kStages - 1
// planes in flight in a ring of shared memory while a plane is summed, one
// barrier a plane.  Planes [0, issued) are already issued, one commit group
// each.
template <typename Tin, typename Tout>
__device__ __forceinline__ void ring_planes(const Args& a, const Taps& t, int tid, int out0, int wy0, int wx0,
                                            int nrow, int issued, unsigned char* smem) {
  const Tin* __restrict__ img = static_cast<const Tin*>(a.img);
  Tout* __restrict__ out = static_cast<Tout*>(a.out);
  const size_t plane = static_cast<size_t>(a.h) * a.w;
  int off[kOut];
  window_offsets(t, wy0, wx0, off);
  for (int k = issued; k < kStages - 1; ++k) {
    if (k < a.n) {
      issue_window(a, img + k * plane, reinterpret_cast<Tin*>(ring_slot(smem, k)), tid, wy0, wx0, nrow);
    }
    cp_async_commit();
  }
  for (int k = 0; k < a.n; ++k) {
    cp_async_wait<kStages - 2>();  // this thread's copies of plane k have landed
    __syncthreads();               // every thread's, and plane k - 1 is summed
    const int next = k + kStages - 1;  // into plane k - 1's slot
    if (next < a.n) {
      issue_window(a, img + next * plane, reinterpret_cast<Tin*>(ring_slot(smem, next)), tid, wy0, wx0, nrow);
    }
    cp_async_commit();
    sum_window(a, t, off, reinterpret_cast<const Tin*>(ring_slot(smem, k)), out + k * plane, out0);
  }
}

template <typename Tin, typename Tout>
__device__ __forceinline__ void direct_planes(const Args& a, const Taps& t, int out0) {
  const Tin* __restrict__ img = static_cast<const Tin*>(a.img);
  Tout* __restrict__ out = static_cast<Tout*>(a.out);
  const size_t plane = static_cast<size_t>(a.h) * a.w;
  int i00[kOut];
  unsigned m[kOut];
#pragma unroll
  for (int o = 0; o < kOut; ++o) {
    const int xi = t.xi[o], yi = t.yi[o];
    const bool x0in = xi >= 0 && xi < a.w, x1in = xi + 1 >= 0 && xi + 1 < a.w;
    const bool y0in = yi >= a.lo && yi < a.hi, y1in = yi + 1 >= a.lo && yi + 1 < a.hi;
    m[o] = (y0in && x0in) | (y0in && x1in) << 1 | (y1in && x0in) << 2 | (y1in && x1in) << 3;
    i00[o] = m[o] ? yi * a.w + xi : 0;  // in [-w - 1, h * w) when any tap is in
  }
  for (int k = 0; k < a.n; ++k) {
    const Tin* __restrict__ p = img + k * plane;
    Tout* __restrict__ dst = out + k * plane;
#pragma unroll
    for (int o = 0; o < kOut; ++o) {
      if (!(t.active >> o & 1u)) continue;
      const int i = i00[o];
      const float v00 = (m[o] & 1u) ? to_f32(__ldg(p + i)) : 0.0f;
      const float v01 = (m[o] & 2u) ? to_f32(__ldg(p + i + 1)) : 0.0f;
      const float v10 = (m[o] & 4u) ? to_f32(__ldg(p + i + a.w)) : 0.0f;
      const float v11 = (m[o] & 8u) ? to_f32(__ldg(p + i + a.w + 1)) : 0.0f;
      const float v = ma::bilinear(v00, v01, v10, v11, t.tx[o], t.ty[o]);
      dst[out0 + (o / kCols) * kWarps * a.w + (o % kCols) * kLanes] = Store<Tout>::cvt(v);
    }
  }
}

template <typename Tin, typename Tout>
__global__ void __launch_bounds__(kThreads, kMinBlocks) sample_multi_kernel(const Args a, int vec) {
  __shared__ __align__(16) unsigned char smem[kStages * kBufBytes];
  __shared__ int box[4];
  const int lane = threadIdx.x, warp = threadIdx.y;
  const int tid = warp * kLanes + lane;
  const int x0 = blockIdx.x * kTileW + lane;
  const int y0 = blockIdx.y * kTileH + warp;  // output row within the launch
  // The flow is read first; the windows of the tile and its margins are
  // staged on speculation behind it, so that their copies overlap the flow's
  // latency without delaying it.
  const int sy0 = a.row0 + blockIdx.y * kTileH - kMarginY;
  const int sx0 = blockIdx.x * kTileW - Span<Tin>::kMargin;
  const Tin* __restrict__ img = static_cast<const Tin*>(a.img);
  const size_t plane = static_cast<size_t>(a.h) * a.w;
  Taps t;
  t.active = 0u;
  float dx[kOut], dy[kOut];
#pragma unroll
  for (int o = 0; o < kOut; ++o) {
    const int x = x0 + (o % kCols) * kLanes;
    const int y = y0 + (o / kCols) * kWarps;
    dx[o] = dy[o] = 0.0f;
    if (x >= a.w || y >= a.rows) continue;
    const int i = y * a.fpitch + x * a.fstride;
    dx[o] = __ldg(a.fx + i);
    dy[o] = __ldg(a.fy + i);
    t.active |= 1u << o;
  }
  if (vec) {
#pragma unroll
    for (int k = 0; k < kStages - 1; ++k) {
      if (k < a.n) {
        issue_window(a, img + k * plane, reinterpret_cast<Tin*>(ring_slot(smem, k)), tid, sy0, sx0, kWinH);
      }
      cp_async_commit();
    }
  }
  int minx = INT_MAX, maxx = INT_MIN, miny = INT_MAX, maxy = INT_MIN;
#pragma unroll
  for (int o = 0; o < kOut; ++o) {
    const int x = x0 + (o % kCols) * kLanes;
    const int row = a.row0 + y0 + (o / kCols) * kWarps;
    const float fx = ma::mul(a.fsign, dx[o]), fy = ma::mul(a.fsign, dy[o]);
    const float x1 = floorf(fx), y1 = floorf(fy);
    t.tx[o] = ma::sub(fx, x1);
    t.ty[o] = ma::sub(fy, y1);
    t.xi[o] = x + ma::floor_index(x1);
    t.yi[o] = row + ma::floor_index(y1);
    if (!(t.active >> o & 1u)) continue;
    minx = min(minx, t.xi[o]), maxx = max(maxx, t.xi[o]);
    miny = min(miny, t.yi[o]), maxy = max(maxy, t.yi[o]);
  }
  const int out0 = (a.row0 + y0) * a.w + x0;  // this thread's first output in a plane
  if (!vec) {  // 16-byte copies do not fit the row stride
    direct_planes<Tin, Tout>(a, t, out0);
    return;
  }
  if (tid == 0) {
    box[0] = INT_MAX, box[1] = INT_MIN, box[2] = INT_MAX, box[3] = INT_MIN;
  }
  minx = __reduce_min_sync(0xffffffffu, minx), maxx = __reduce_max_sync(0xffffffffu, maxx);
  miny = __reduce_min_sync(0xffffffffu, miny), maxy = __reduce_max_sync(0xffffffffu, maxy);
  __syncthreads();  // box initialised
  if (lane == 0) {
    atomicMin(&box[0], minx), atomicMax(&box[1], maxx);
    atomicMin(&box[2], miny), atomicMax(&box[3], maxy);
  }
  __syncthreads();
  // the taps span columns [box0, box1 + 1] and rows [box2, box3 + 1]
  const bool staged_counted = a.staged != nullptr && tid == 0;
  if (box[0] >= sx0 && box[1] + 1 < sx0 + Span<Tin>::kCols && box[2] >= sy0 && box[3] + 1 < sy0 + kWinH) {
    if (staged_counted) atomicAdd(a.staged, 1u);
    ring_planes<Tin, Tout>(a, t, tid, out0, sy0, sx0, kWinH, kStages - 1, smem);
    return;
  }
  cp_async_wait<0>();  // the speculation missed: let its copies land before the slots are reused
  __syncthreads();
  const int wx0 = box[0] & -Span<Tin>::V;
  const int wy0 = box[2];
  const long long span_x = static_cast<long long>(box[1]) + 2 - wx0;
  const long long span_y = static_cast<long long>(box[3]) + 2 - wy0;
  if (span_x <= Span<Tin>::kCols && span_y <= kWinH) {
    if (staged_counted) atomicAdd(a.staged, 1u);
    ring_planes<Tin, Tout>(a, t, tid, out0, wy0, wx0, static_cast<int>(span_y), 0, smem);
  } else {
    direct_planes<Tin, Tout>(a, t, out0);
  }
}

template <typename Tin, typename Tout>
int launch(const Args& a, int vec, cudaStream_t stream) {
  const dim3 block(kLanes, kWarps);
  const dim3 grid((a.w + kTileW - 1) / kTileW, (a.rows + kTileH - 1) / kTileH);
  sample_multi_kernel<Tin, Tout><<<grid, block, 0, stream>>>(a, vec);
  return static_cast<int>(cudaGetLastError());
}

// dtype codes of ops/kernel_sample.py::DTYPE_CODES
enum Kind { kU8 = 0, kI8 = 1, kU16 = 2, kI16 = 3, kI32 = 4, kF32 = 5 };

}  // namespace k5

}  // namespace

extern "C" int ma_sample_displaced(const float* img, const float* fx, const float* fy, float* out, int n,
                                   int h, int w, int rows, int cols, int row0, cudaStream_t stream) {
  using namespace k1;
  const dim3 grid((cols + kTileW - 1) / kTileW, (rows + kTileH - 1) / kTileH, n);
  sample_kernel<<<grid, dim3(kLanes, kWarps), 0, stream>>>(Args{img, fx, fy, out, h, w, rows, cols, row0});
  return static_cast<int>(cudaGetLastError());
}

// K5: planes and output of one dtype (`kind`), one of the six.
extern "C" int ma_sample_multi(const void* img, const float* fx, const float* fy, int fstride,
                               int fpitch, float fsign, void* out, int n, int h, int w, int row0,
                               int rows, int lo, int hi, int kind, int vec, unsigned int* staged,
                               cudaStream_t stream) {
  using namespace k5;
  const Args a{img, fx, fy, fstride, fpitch, fsign, out, n, h, w, row0, rows, lo, hi, staged};
  switch (kind) {
    case kU8: return launch<uint8_t, uint8_t>(a, vec, stream);
    case kI8: return launch<int8_t, int8_t>(a, vec, stream);
    case kU16: return launch<uint16_t, uint16_t>(a, vec, stream);
    case kI16: return launch<int16_t, int16_t>(a, vec, stream);
    case kI32: return launch<int32_t, int32_t>(a, vec, stream);
    case kF32: return launch<float, float>(a, vec, stream);
    default: return -1;
  }
}
