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
// boxes; returns a cudaError_t.
inline int make_maps(CUtensorMap* hmap, CUtensorMap* wmap, const void* h,
                     const void* w, int rows, int v_orig, int d) {
  int err = hopper::make_tmap_bf16(hmap, h, rows, d, kRows);
  if (err) return err;
  return hopper::make_tmap_bf16(wmap, w, v_orig, d, kCols);
}

struct Ring {
  __nv_bfloat16* a;   // kStages x (128 x 64) h boxes
  __nv_bfloat16* b;   // kStages x (256 x 64) W boxes
  uint64_t* full;     // kStages: the stage's boxes have landed
  uint64_t* empty;    // kStages: the 8 consumer warps are done with it
};

// The ring in the kernel's dynamic shared memory (kSmem bytes), its
// barriers initialised; every thread of the CTA calls it.
__device__ __forceinline__ Ring setup(unsigned char* smem_raw) {
  using namespace hopper;
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  Ring r;
  r.a = reinterpret_cast<__nv_bfloat16*>(smem);
  r.b = r.a + kStages * kRows * kChunk;
  r.full = reinterpret_cast<uint64_t*>(r.b + kStages * kCols * kChunk);
  r.empty = r.full + kStages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&r.full[s], 1);
      mbar_init(&r.empty[s], 8);      // one arrival per consumer warp
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
      mbar_arrive_tx(&r.full[s], kStageBytes);
      tma_load_2d(r.a + s * kRows * kChunk, hmap, &r.full[s], kc * kChunk,
                  row0);
      tma_load_2d(r.b + s * kCols * kChunk, wmap, &r.full[s], kc * kChunk,
                  tile * kCols);
    }
}

// A consumer warpgroup's product of one tile: acc = h[cw * 64 ..] . W
// tile^T over all nk chunks (acc is overwritten).  `it` counts the chunks
// this warpgroup has consumed, across tiles.  On return every product has
// completed and acc may be read.
__device__ __forceinline__ void tile_product(float (&acc)[kAcc], const Ring& r,
                                             int cw, int nk, int& it) {
  using namespace hopper;
  const bool leader = (threadIdx.x & 31) == 0;
  for (int kc = 0; kc < nk; ++kc, ++it) {
    const int s = it % kStages;
    mbar_wait(&r.full[s], (it / kStages) & 1);
    const __nv_bfloat16* a = r.a + s * kRows * kChunk + cw * 64 * kChunk;
    const __nv_bfloat16* b = r.b + s * kCols * kChunk;
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
      if (leader) mbar_arrive(&r.empty[(it - 1) % kStages]);
    }
  }
  wgmma_wait<0>();
  fence_regs(acc);
  if (leader) mbar_arrive(&r.empty[(it - 1) % kStages]);
}

}  // namespace rowtile
