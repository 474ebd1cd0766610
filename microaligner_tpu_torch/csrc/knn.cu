// K8: FeatureReg's exact knn top-2 on the bf16 operand route, one launch a
// match_descriptors call.
//
// Replaces no TPU kernel: the JAX package leaves its knn to XLA
// (microaligner_tpu/features/match.py).  It was added because the plain
// version on the card (ops/kernel_knn.py::top2_plain) writes every
// query-train distance to device memory: one cuBLAS bf16 product with a
// float32 output a chunk of queries, then the distance formula, the clamp,
// the min, the scatter and the amin, each a pass over the chunk's float32
// entries, about 50 bytes of device memory an entry and 5.4e10 entries a
// registered chained_8k cycle.
//
// It computes the plain version's bf16-route arithmetic:
//   cross  = sum_k q~_k t~_k  (bf16 operands, float32 sums on the tensor cores)
//   d      = max(((qn + tn) - 2 cross) + tmask, 0)
//   d1, i1 = the least d of the query row and its train index, the smaller
//            index on equal d; d2 = the least of the rest, a tie counting as
//            the runner-up (plain: min, a scatter of _BIG at i1, amin)
// qn and tn are the float32 sums of the unrounded descriptors, from the
// wrapper.  (qn + tn) rounds once (__fadd_rn); subtracting 2 cross is one
// __fmaf_rn(-2, cross, .), exactly __fsub_rn(., 2 cross) since doubling is
// exact; tmask is folded into the staged tn: an invalid or absent train row
// stages +inf, so its d is +inf, and the outputs are clamped to
// float32(_BIG), which is what plain gives where an invalid row's _BIG is
// the least left (fewer than two valid rows).  The cross term is summed in
// wgmma's order, not cuBLAS's: features/match.py's error argument covers
// any order.
//
// Bound on the H100: the tensor cores.  An entry is 208 bf16 multiply-adds
// (the width 200 padded with zeros to 13 k-steps of 16; zeros add exactly)
// and about 9 float32 or integer operations of epilogue (the distance, the
// clamp, the running top-2), and no distance reaches device memory.  The
// design:
// - A block owns 256 query rows, two warpgroups of 128 (two m64 blocks
//   each).  Its bf16 rows are staged once (cp.async) into shared memory in
//   wgmma's no-swizzle K-major layout (8 x 8 core matrices of 128 bytes)
//   and stay there.
// - Train rows stream in tiles of 64 through a ring of up to 4 stages (3 at
//   width 256), one TMA load a tile: a 3-D tensor map (8 elements x rows x
//   16-byte chunks) lays a tile out as [chunk][row][8], which is again
//   the core-matrix layout, and zero-fills past the width and past T.  An
//   mbarrier a stage tells the block that a tile has landed.  Every block
//   walks the tiles in the same order, so co-resident blocks read the train
//   side from L2; 256 query rows a block halve those reads against 128.
// - Each warpgroup issues its tile as 13 x 2 wgmma.m64n64k16 (float32
//   accumulators, 32 a thread a block) and, while they run, folds the
//   previous tile into its running top-2 from a second set of accumulators;
//   so the epilogue overlaps the products.
// - Epilogue in registers: a thread holds 4 query rows x 16 train columns of
//   a tile, visited in increasing order, so a strict comparison keeps the
//   smaller index on ties; the staged tn of the next tile is loaded while
//   the current one is multiplied.  At the end the four lanes of a quad merge
//   their (d1, i1, d2), ties to the smaller index, and store once a row.
//
// Limits: the width W is a multiple of 8 (16-byte rows, TMA strides) and at
// most 256 (shared memory); Q and T at least 1; the wrapper checks them.
#include <cuda.h>

#include <atomic>
#include <cmath>
#include <cstdint>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kRows = 256;          // query rows a block: two warpgroups of 128
constexpr int kCols = 64;           // train rows a tile
constexpr int kThreads = 256;
constexpr int kMaxStages = 4;
constexpr int kMaxWidth = 256;
constexpr int kMaxDevices = 64;
constexpr int kSmemLimit = 232448;  // an H100 block's dynamic shared memory at most
constexpr int kAlign = 128;         // slack to align the dynamic shared memory
constexpr int kHead = 128;          // the ring's mbarriers
constexpr float kBig = 3.4e38f;     // features/match.py's _BIG as float32

__host__ __device__ constexpr int padded_width(int w) { return (w + 15) / 16 * 16; }
__host__ __device__ constexpr size_t tn_bytes() { return sizeof(float) * 3 * kCols; }
__host__ __device__ constexpr size_t query_bytes(int w) {
  return sizeof(bf16) * static_cast<size_t>(kRows) * padded_width(w);
}
__host__ __device__ constexpr size_t stage_bytes(int w) {
  return sizeof(bf16) * static_cast<size_t>(kCols) * padded_width(w);
}
// as many ring stages as fit beside the query rows, at most kMaxStages (3 at width 256, 4 at 200)
int stages_for(int w) {
  const size_t fit = (kSmemLimit - kAlign - kHead - tn_bytes() - query_bytes(w)) / stage_bytes(w);
  return static_cast<int>(fit < kMaxStages ? fit : kMaxStages);
}
size_t smem_bytes(int w) { return kAlign + kHead + tn_bytes() + query_bytes(w) + stages_for(w) * stage_bytes(w); }

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes into shared memory, or 16 zero bytes when `valid` is false.
__device__ __forceinline__ void copy16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void bar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred done;\nWAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT_%=;\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// The train tile of rows [row0, row0 + kCols), every chunk, into `dst` as [chunk][row][8 elements]: the
// core matrix (8 rows x 16 bytes) of row group g and chunk c lies at (c kCols + 8 g) 16 bytes.
__device__ __forceinline__ void load_tile(bf16* dst, const CUtensorMap* map, int row0, uint64_t* bar,
                                          uint32_t bytes) {
  bar_expect(bar, bytes);
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4}], "
      "[%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(0), "r"(row0), "r"(0), "r"(smem_u32(bar))
      : "memory");
}

// The block's query rows [row0, row0 + kRows) of (rows, w) bf16 into `dst`, one thread a row, zero past w
// and rows: the core matrix of row group g and chunk c at (g kc + c) 128 bytes, kc = padded_width(w) / 8.
__device__ __forceinline__ void stage_queries(bf16* dst, const bf16* __restrict__ src, int row0, int rows, int w) {
  const int kc = padded_width(w) / 8, wc = w / 8;
  const int r = threadIdx.x, row = row0 + r;
  const bf16* from = src + static_cast<int64_t>(row < rows ? row : 0) * w;
  bf16* to = dst + (r / 8) * kc * 64 + (r % 8) * 8;
  for (int c = 0; c < kc; ++c) {
    const bool valid = row < rows && c < wc;
    copy16(to + 64 * c, valid ? from + 8 * c : src, valid);
  }
  asm volatile("cp.async.commit_group;\ncp.async.wait_all;\n" ::: "memory");
}

// tn of train row j as staged: +inf where the row is invalid or absent (tmask)
__device__ __forceinline__ float staged_tn(const float* __restrict__ tn, const uint8_t* __restrict__ valid, int j,
                                           int rows) {
  return j < rows && valid[j] ? tn[j] : INFINITY;
}

struct Top2 {
  float d1, d2;
  int i1;
};

// the top-2 of two disjoint sets: on equal d1 the smaller index wins, the other's d1 is the runner-up
__device__ __forceinline__ Top2 merge(Top2 a, Top2 b) {
  const bool b_wins = b.d1 < a.d1 || (b.d1 == a.d1 && b.i1 < a.i1);
  return b_wins ? Top2{b.d1, fminf(b.d2, a.d1), b.i1} : Top2{a.d1, fminf(a.d2, b.d1), a.i1};
}

__device__ __forceinline__ Top2 shuffle_merge(Top2 s, int mask) {
  const Top2 o{__shfl_xor_sync(0xffffffffu, s.d1, mask), __shfl_xor_sync(0xffffffffu, s.d2, mask),
               __shfl_xor_sync(0xffffffffu, s.i1, mask)};
  return merge(s, o);
}

// acc[mb][n][e]: the warpgroup's m64 block mb, n8 block n, in wgmma's accumulator order: e = 0, 1 are
// row lane / 4 (of the warp's 16) and columns 8 n + 2 (lane % 4) + e; e = 2, 3 are row lane / 4 + 8
using Acc = float[2][8][4];

// a shared-memory matrix descriptor, no swizzle: start, leading (K) and stride (M or N) byte offsets
__device__ __forceinline__ uint64_t descriptor(const void* p, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}

// keeps the compiler from moving an accumulator across the asynchronous products
__device__ __forceinline__ void pin(Acc& acc) {
#pragma unroll
  for (int mb = 0; mb < 2; ++mb)
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(acc[mb][n][e])::"memory");
}

// d (+)= A (64 x 16, K-major) B^T (B 64 x 16, K-major), bf16 in, float32 sums
__device__ __forceinline__ void wgmma_64x64x16(float (&d)[8][4], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, "
      "%22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]),
        "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]),
        "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]),
        "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(da), "l"(db), "r"(accumulate));
}

// Issues this warpgroup's products of one tile, its two m64 blocks (as stage_queries lays them out)
// against the tile's 64 rows (as load_tile does), k-step by k-step, and commits them as one group.
__device__ __forceinline__ void issue_tile(Acc& acc, const bf16* a_rows, const bf16* b_tile, int kc) {
  pin(acc);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
  for (int k = 0; k < kc / 2; ++k) {
    const uint64_t db = descriptor(b_tile + 2 * k * kCols * 8, kCols * 16, 128);
#pragma unroll
    for (int mb = 0; mb < 2; ++mb)
      wgmma_64x64x16(acc[mb], descriptor(a_rows + mb * 8 * kc * 64 + 128 * k, 128, 128 * kc), db, k > 0);
  }
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Folds a tile's distances into the running top-2 of this thread's four rows (slot s = 2 mb + h: row
// 16 (warp % 4) + lane / 4 + 8 h of block mb), column j0 + 8 n + e, in increasing order; the tile's tn
// is staged at tn_tile + 8 n + e.
__device__ __forceinline__ void tile_epilogue(const Acc& acc, const float* tn_tile, int j0, const float (&qr)[4],
                                              Top2 (&best)[4]) {
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const float2 tc = *reinterpret_cast<const float2*>(tn_tile + 8 * n);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int j = j0 + 8 * n + e;
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const float base = ma::add(qr[s], e ? tc.y : tc.x);
        const float d = fmaxf(__fmaf_rn(-2.0f, acc[s / 2][n][2 * (s % 2) + e], base), 0.0f);
        const bool lt = d < best[s].d1;
        best[s].d2 = fminf(best[s].d2, lt ? best[s].d1 : d);
        best[s].i1 = lt ? j : best[s].i1;
        best[s].d1 = fminf(best[s].d1, d);
      }
    }
  }
}

// what every tile step of a block reads
struct Ring {
  const CUtensorMap* map;
  uint64_t* bars;      // one mbarrier a stage
  bf16* tiles;         // `stages` tiles of kCols rows
  float* tns;          // three slots of kCols staged tn
  const float* tn;
  const uint8_t* t_valid;
  const bf16* a_rows;  // this warpgroup's 128 query rows
  int nt, kc, stages, count, c0;
};

// Tile it: load tile it + stages - 1 into the stage tile it - 1 left, wait for tile it, issue its
// products into `cur` and, while they run, fold tile it - 1 in from `prev`; then wait for them.
__device__ __forceinline__ void step(const Ring& r, Acc& cur, Acc& prev, int it, const float (&qr)[4],
                                     Top2 (&best)[4]) {
  const int tid = threadIdx.x, ahead = it + r.stages - 1, tile_elems = kCols * r.kc * 8;
  if (tid == 0 && ahead < r.count)
    load_tile(r.tiles + (ahead % r.stages) * tile_elems, r.map, ahead * kCols, r.bars + ahead % r.stages,
              2 * tile_elems);
  float next_tn = 0.0f;
  if (it + 1 < r.count && tid < kCols) next_tn = staged_tn(r.tn, r.t_valid, (it + 1) * kCols + tid, r.nt);
  bar_wait(r.bars + it % r.stages, (it / r.stages) & 1);
  issue_tile(cur, r.a_rows, r.tiles + (it % r.stages) * tile_elems, r.kc);
  if (it > 0) tile_epilogue(prev, r.tns + ((it - 1) % 3) * kCols + r.c0, (it - 1) * kCols + r.c0, qr, best);
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  pin(cur);
  if (it + 1 < r.count && tid < kCols) r.tns[((it + 1) % 3) * kCols + tid] = next_tn;
  __syncthreads();  // every warpgroup is done with tile it's stage before it is refilled
}

__global__ void __launch_bounds__(kThreads, 1)
knn_top2_kernel(const __grid_constant__ CUtensorMap map, const bf16* __restrict__ q, const float* __restrict__ qn,
                const float* __restrict__ tn, const uint8_t* __restrict__ t_valid, int nq, int nt, int w,
                int stages, float* __restrict__ out_d1, float* __restrict__ out_d2,
                int64_t* __restrict__ out_i1) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((kAlign - (smem_u32(smem_raw) % kAlign)) % kAlign);
  const int kc = padded_width(w) / 8;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  float* tns = reinterpret_cast<float*>(smem + kHead);
  bf16* qs = reinterpret_cast<bf16*>(smem + kHead + tn_bytes());
  bf16* tiles = qs + kRows * kc * 8;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32, wg = warp / 4;
  const int row0 = blockIdx.x * kRows;
  const int count = (nt + kCols - 1) / kCols;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) bar_init(bars + s);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0)
    for (int s = 0; s + 1 < stages && s < count; ++s)
      load_tile(tiles + s * kCols * kc * 8, &map, s * kCols, bars + s, kCols * kc * 16);
  stage_queries(qs, q, row0, nq, w);
  if (tid < kCols) tns[tid] = staged_tn(tn, t_valid, tid, nt);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // the queries, for wgmma
  __syncthreads();

  // this thread's rows, slot s = 2 mb + h
  float qr[4];
  Top2 best[4];
  int rows[4];
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    rows[s] = row0 + 128 * wg + 64 * (s / 2) + 16 * (warp % 4) + lane / 4 + 8 * (s % 2);
    qr[s] = rows[s] < nq ? qn[rows[s]] : 0.0f;
    best[s] = Top2{INFINITY, INFINITY, 0};
  }
  const Ring r{&map, bars, tiles, tns, tn, t_valid, qs + 128 * wg * kc * 8, nt, kc, stages, count, 2 * (lane % 4)};

  Acc acc0, acc1;  // tile it's products and tile it - 1's, in turn
  for (int it = 0; it < count; it += 2) {
    step(r, acc0, acc1, it, qr, best);
    if (it + 1 < count) step(r, acc1, acc0, it + 1, qr, best);
  }
  const int last = count - 1;
  if (last % 2 == 0) {
    tile_epilogue(acc0, tns + (last % 3) * kCols + r.c0, last * kCols + r.c0, qr, best);
  } else {
    tile_epilogue(acc1, tns + (last % 3) * kCols + r.c0, last * kCols + r.c0, qr, best);
  }

  // merge the quad's four column sets; one store a row
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const Top2 m = shuffle_merge(shuffle_merge(best[s], 1), 2);
    if (lane % 4 == 0 && rows[s] < nq) {
      out_d1[rows[s]] = fminf(m.d1, kBig);
      out_d2[rows[s]] = fminf(m.d2, kBig);
      out_i1[rows[s]] = m.i1;
    }
  }
}

std::atomic<bool> smem_allowed[kMaxDevices];

// Lifts the kernel's dynamic shared memory limit to the card's, once a device.
cudaError_t allow_shared_memory() {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < kMaxDevices && smem_allowed[dev].load()) return cudaSuccess;
  e = cudaFuncSetAttribute(knn_top2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  if (e == cudaSuccess && dev < kMaxDevices) smem_allowed[dev].store(true);
  return e;
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, found through the runtime, so nothing links against libcuda
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                                           &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

}  // namespace

// For each of the nq bf16 query rows (nq, w), the top-2 of d over the nt bf16
// train rows (nt, w): d1 and d2 (float32) and i1 (int64), each (nq,).  qn
// (nq,) and tn (nt,) are the float32 squared norms of the unrounded rows;
// t_valid (nt,) is 1 for a valid train row, 0 otherwise.  Rows start on 16
// bytes; w is a multiple of 8 in [8, 256]; nq and nt are at least 1.
extern "C" int ma_knn_top2(const void* q, const void* t, const float* qn, const float* tn,
                           const uint8_t* t_valid, int nq, int nt, int w, float* d1, float* d2, int64_t* i1,
                           cudaStream_t stream) {
  if (w < 8 || w > kMaxWidth || w % 8 != 0 || nq < 1 || nt < 1) return cudaErrorInvalidValue;
  cudaError_t e = allow_shared_memory();
  if (e != cudaSuccess) return e;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  // the train rows as 3-D: 8 elements x nt rows x w / 8 chunks; a box is 8 x kCols x every chunk
  const cuuint64_t dims[3] = {8, static_cast<cuuint64_t>(nt), static_cast<cuuint64_t>(w / 8)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(w) * 2, 16};
  const cuuint32_t box[3] = {8, kCols, static_cast<cuuint32_t>(padded_width(w) / 8)};
  const cuuint32_t unit[3] = {1, 1, 1};
  CUtensorMap map;
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(t), dims, strides, box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  knn_top2_kernel<<<(nq + kRows - 1) / kRows, kThreads, smem_bytes(w), stream>>>(
      map, static_cast<const bf16*>(q), qn, tn, t_valid, nq, nt, w, stages_for(w), d1, d2, i1);
  return static_cast<int>(cudaGetLastError());
}
