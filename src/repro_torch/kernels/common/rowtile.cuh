// The many-row vocab GEMM shared by sample_topk's many-row top-1 kernel and
// the fused-CE forward on Hopper (sm_90a).
//
// Both compute softcap(h @ W^T) for thousands of rows of h against the
// whole vocabulary and keep a per-row summary (a running best; an online
// softmax with the target logit and the sum), so the products bound them:
// 2 * 4096 * 1024 * 152064 = 1.28 TFLOP at the MTP accuracy's rows, ~1.29
// ms at 989 TFLOP/s, against ~0.1 ms of bytes.  This header is the main
// loop both kernels share, tiled like a GEMM:
//
//   * ownership: CTA (blockIdx.x, blockIdx.y) owns 128 rows of h (row tile
//     blockIdx.x) and vocab slice blockIdx.y (`per` consecutive 256-column
//     tiles of W).  The row tiles of one slice are neighbours in launch
//     order, so they run side by side and share the slice's W bytes in L2;
//   * producer: one thread streams, for each tile and 64-wide k chunk, an h
//     box (128 x 64 bf16) and a W box (256 x 64) into a 4-stage TMA ring
//     (128-byte swizzle, mbarrier completion).  TMA's zero fill covers the
//     ragged row and vocab edges.  It walks the slice's tiles without a
//     pause, so the next tile's loads overlap this tile's epilogue;
//   * consumers: two warpgroups, each issuing wgmma m64n256k16 for its 64
//     rows (h as A, W as B, both K-major from shared memory, f32
//     accumulators in registers: 128 a thread).  One chunk's products stay
//     in flight while the next chunk is awaited; a stage goes back to the
//     producer once the products that read it have completed;
//   * the grid is (row tiles, slices), slices chosen so that ~8 waves of
//     CTAs fill the 132 SMs (`splits`; 4096 rows: 32 x 33).
//
// A quantized head (the fused-CE forward's w_scale: an int8, e4m3 or e5m2
// W) streams 1 byte a weight: the W box is 256 x 64 bytes, unswizzled.
// Three warps of the producer's warpgroup (idle in the bf16 kernel) widen
// each landed W box into one of two 256 x 64 bf16 tiles, in the 128-byte
// swizzle the bf16 W box has, from which the same wgmma reads; full and
// empty mbarriers a tile pass them to the consumers, so the widening of
// the next chunk overlaps the products of this one (kSmemQ bytes).  The
// epilogue applies each column's scale to its logit.
//
// The epilogues (the kernels' own) read the accumulator fragment of a
// 64 x 256 tile: thread T of consumer warpgroup cw holds rows cw * 64 +
// 16 (T / 32 % 4) + T % 32 / 4 + 8 i and columns 8 j + 2 (T % 4) + c of
// the tile in acc[4 j + 2 i + c], i, c in {0, 1}, j in [0, 32).

#pragma once

#include <cuda_bf16.h>

#include "hopper.cuh"

namespace rowtile {

constexpr int kRows = 128;           // h rows a CTA: two consumer warpgroups
constexpr int kCols = 256;           // vocab columns a tile (wgmma n)
constexpr int kChunk = 64;           // k a stage: one 128-byte swizzle row
constexpr int kStages = 4;
constexpr int kThreads = 384;        // producer warpgroup + 2 consumers
constexpr int kWaves = 8;            // CTAs in flight per SM, times 132
constexpr int kNumSMs = 132;         // H100 SXM
constexpr int kAcc = kCols / 2;      // f32 accumulators a consumer thread
constexpr int kStageBytes = (kRows + kCols) * kChunk * 2;
constexpr size_t kSmem =
    1024 + (size_t)kStages * kStageBytes + 2 * kStages * 8;
// 1-byte W: the W box is 1 byte an element; two widened bf16 W tiles,
// their full and empty mbarriers, and the 3 converter warps
constexpr int kStageBytesQ = (kRows * 2 + kCols) * kChunk;
constexpr int kCvtBufs = 2;
constexpr int kCvtBytes = kCvtBufs * kCols * kChunk * 2;
constexpr int kConverters = 96;
constexpr size_t kSmemQ = 1024 + (size_t)kStages * kStageBytesQ + kCvtBytes +
                          2 * kStages * 8 + 2 * kCvtBufs * 8;

// Vocab slices for `rows` rows and `v_orig` columns: ~kWaves waves of CTAs
// on the SMs, never more slices than tiles; *per_out gets the tiles a
// slice.  Every slice holds at least one tile.
inline int splits(int rows, int v_orig, int* per_out) {
  const int row_tiles = (rows + kRows - 1) / kRows;
  const int n_tiles = (v_orig + kCols - 1) / kCols;
  int want = (kWaves * kNumSMs + row_tiles - 1) / row_tiles;
  want = want < 1 ? 1 : (want > n_tiles ? n_tiles : want);
  const int per = (n_tiles + want - 1) / want;
  if (per_out) *per_out = per;
  return (n_tiles + per - 1) / per;
}

// TMA maps of h (rows, d) in 128-row boxes and W (v_orig, d) in 256-row
// boxes (bf16, or 1 byte an element for `kind` != kBf16); returns a
// cudaError_t.
inline int make_maps(CUtensorMap* hmap, CUtensorMap* wmap, const void* h,
                     const void* w, int rows, int v_orig, int d,
                     int kind = hopper::kBf16) {
  int err = hopper::make_tmap_bf16(hmap, h, rows, d, kRows);
  if (err) return err;
  return kind == hopper::kBf16
             ? hopper::make_tmap_bf16(wmap, w, v_orig, d, kCols)
             : hopper::make_tmap_u8(wmap, w, v_orig, d, kCols);
}

struct Ring {
  __nv_bfloat16* a;   // kStages x (128 x 64) h boxes
  unsigned char* b;   // kStages x (256 x 64) W boxes (wb bytes a weight)
  __nv_bfloat16* cvt; // 1-byte W: two widened (256 x 64) bf16 W tiles
  uint64_t* full;     // kStages: the stage's boxes have landed
  uint64_t* empty;    // kStages: the 8 consumer warps (and, 1-byte W, the
                      // 3 converter warps) are done with it
  uint64_t* cfull;    // kCvtBufs, 1-byte W: a widened tile is written
  uint64_t* cempty;   // kCvtBufs, 1-byte W: ... and read by the consumers
  int kind;           // hopper::WKind of W
  int wb;             // bytes a W element
};

// The ring in the kernel's dynamic shared memory (kSmem bytes, kSmemQ for
// a 1-byte W), its barriers initialised; every thread of the CTA calls it.
__device__ __forceinline__ Ring setup(unsigned char* smem_raw,
                                      int kind = hopper::kBf16) {
  using namespace hopper;
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  Ring r;
  r.kind = kind;
  r.wb = kind == kBf16 ? 2 : 1;
  r.a = reinterpret_cast<__nv_bfloat16*>(smem);
  r.b = reinterpret_cast<unsigned char*>(r.a + kStages * kRows * kChunk);
  r.cvt = reinterpret_cast<__nv_bfloat16*>(r.b + kStages * kCols * kChunk *
                                                     r.wb);
  r.full = reinterpret_cast<uint64_t*>(
      reinterpret_cast<unsigned char*>(r.cvt) +
      (r.wb == 1 ? kCvtBytes : 0));
  r.empty = r.full + kStages;
  r.cfull = r.empty + kStages;
  r.cempty = r.cfull + kCvtBufs;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&r.full[s], 1);
      // one arrival per consumer warp (and converter warp)
      mbar_init(&r.empty[s], r.wb == 1 ? 8 + kConverters / 32 : 8);
    }
    if (r.wb == 1)
      for (int b = 0; b < kCvtBufs; ++b) {
        mbar_init(&r.cfull[b], kConverters / 32);  // a converter warp each
        mbar_init(&r.cempty[b], 8);            // every consumer warp
      }
    fence_mbar_init();
  }
  __syncthreads();
  return r;
}

// The producer (one thread): tiles [t_begin, t_end) of the slice, nk
// chunks each, for the 128 rows from row0.
__device__ __forceinline__ void produce(const Ring& r, const CUtensorMap* hmap,
                                        const CUtensorMap* wmap, int row0,
                                        int t_begin, int t_end, int nk) {
  using namespace hopper;
  int it = 0;
  for (int tile = t_begin; tile < t_end; ++tile)
    for (int kc = 0; kc < nk; ++kc, ++it) {
      const int s = it % kStages;
      mbar_wait(&r.empty[s], ((it / kStages) & 1) ^ 1);
      mbar_arrive_tx(&r.full[s], r.wb == 2 ? kStageBytes : kStageBytesQ);
      tma_load_2d(r.a + s * kRows * kChunk, hmap, &r.full[s], kc * kChunk,
                  row0);
      tma_load_2d(r.b + (size_t)s * kCols * kChunk * r.wb, wmap, &r.full[s],
                  kc * kChunk, tile * kCols);
    }
}

// The converter warps of a 1-byte W (thread c = 0..95): for each tile and
// chunk, once the stage has landed and a widened tile is free, widen the
// stage's 256 x 64-byte W box into that tile (16-byte chunk j of row r at
// j ^ (r % 8): the bf16 box's swizzle) and release the stage.
__device__ __forceinline__ void convert(const Ring& r, int t_begin,
                                        int t_end, int nk, int c) {
  using namespace hopper;
  int it = 0;
  for (int tile = t_begin; tile < t_end; ++tile)
    for (int kc = 0; kc < nk; ++kc, ++it) {
      const int s = it % kStages, b = it % kCvtBufs;
      mbar_wait(&r.full[s], (it / kStages) & 1);
      mbar_wait(&r.cempty[b], ((it / kCvtBufs) & 1) ^ 1);
      const unsigned char* raw = r.b + (size_t)s * kCols * kChunk;
      unsigned char* d =
          reinterpret_cast<unsigned char*>(r.cvt + b * kCols * kChunk);
#pragma unroll 4
      for (int u = c; u < kCols * 8; u += kConverters) {
        const int row = u >> 3, j = u & 7;
        const uint2 x =
            *reinterpret_cast<const uint2*>(raw + row * kChunk + j * 8);
        *reinterpret_cast<uint4*>(d + row * 128 + ((j ^ (row & 7)) << 4)) =
            widen8(x, r.kind);
      }
      fence_proxy_async();
      __syncwarp();
      if ((c & 31) == 0) {        // the warp's part is written and fenced
        mbar_arrive(&r.cfull[b]);
        mbar_arrive(&r.empty[s]);
      }
    }
}

// A consumer warpgroup's product of one tile: acc = h[cw * 64 ..] . W
// tile^T over all nk chunks (acc is overwritten).  `it` counts the chunks
// this warpgroup has consumed, across tiles.  On return every product has
// completed and acc may be read.  kQ (a 1-byte W, a separate
// instantiation, so the bf16 loop is untouched): W comes from the
// widened tile of the chunk, released with the stage.
template <bool kQ = false>
__device__ __forceinline__ void tile_product(float (&acc)[kAcc], const Ring& r,
                                             int cw, int nk, int& it) {
  using namespace hopper;
  const bool leader = (threadIdx.x & 31) == 0;
  for (int kc = 0; kc < nk; ++kc, ++it) {
    const int s = it % kStages;
    mbar_wait(&r.full[s], (it / kStages) & 1);
    const __nv_bfloat16* a = r.a + s * kRows * kChunk + cw * 64 * kChunk;
    const __nv_bfloat16* b;
    if constexpr (kQ) {
      const int cb = it % kCvtBufs;
      mbar_wait(&r.cfull[cb], (it / kCvtBufs) & 1);
      b = r.cvt + cb * kCols * kChunk;
    } else {
      b = reinterpret_cast<const __nv_bfloat16*>(r.b) +
          (size_t)s * kCols * kChunk;
    }
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kChunk / 16; ++ks)
      wgmma_ss<kCols>(acc, desc_b128(a + ks * 16, 16, 1024),
                      desc_b128(b + ks * 16, 16, 1024), kc | ks);
    wgmma_commit();
    if (kc > 0) {
      // the previous chunk's products are done: its stage may be refilled
      wgmma_wait<1>();
      if (leader) {
        mbar_arrive(&r.empty[(it - 1) % kStages]);
        if constexpr (kQ) mbar_arrive(&r.cempty[(it - 1) % kCvtBufs]);
      }
    }
  }
  wgmma_wait<0>();
  fence_regs(acc);
  if (leader) {
    mbar_arrive(&r.empty[(it - 1) % kStages]);
    if constexpr (kQ) mbar_arrive(&r.cempty[(it - 1) % kCvtBufs]);
  }
}

}  // namespace rowtile
