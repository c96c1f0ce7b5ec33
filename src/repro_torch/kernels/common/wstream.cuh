// The W stream shared by the few-row vocab scans on Hopper (sm_90a):
// score_tokens and sample_topk's decode kernel.
//
// Both compute softcap(h @ W^T) for a few rows of h against the whole
// vocabulary and keep a per-row summary (an online softmax, a top-k), so
// what bounds them is reading W (V x d bf16) once from device memory:
// 311 MB for qwen3-0.6b's padded head, ~93 us at 3.35 TB/s.  This header
// is the main loop both kernels share, built so that a CTA's shared memory
// and its bytes in flight do not depend on d or on the warp count:
//
//   * ownership: CTA (blockIdx.x, blockIdx.y) owns row tile blockIdx.x (R
//     rows of h, R a wgmma n width) and vocab slice blockIdx.y (`per`
//     consecutive 128-column tiles of W).  The row tiles of one slice are
//     neighbours in launch order, so they run side by side and share the
//     slice's W bytes in L2: up to 256 rows, W is read once;
//   * producer: one warp streams, for each tile and 64-wide k chunk, a W
//     box (128 x 64 bf16) and an h box (R x 64) into an S-stage TMA ring
//     (128-byte swizzle, mbarrier completion).  TMA's zero fill covers the
//     ragged row and vocab edges.  It walks the slice's tiles without a
//     pause, so the next tile's loads overlap this tile's epilogue;
//   * consumers: two warpgroups, each issuing wgmma m64nRk16 with its 64
//     W columns as A and the R rows of h as B (both K-major from shared
//     memory), f32 accumulators in registers: R / 2 a thread;
//   * a stage takes (128 + R) x 128 bytes whatever d is, and the ring
//     holds up to 8 of them: up to 128 KB of W in flight an SM.
//
// The grid has ~132 CTAs (one an SM; `plan`), each walking several tiles.
// The epilogues (the kernels' own) read the accumulator fragment: thread T
// of warpgroup wg holds vocab columns wg*64 + 16 (T/32 % 4) + T%32/4 + 8i
// of the tile and rows 8j + 2 (T%4) + c of the row tile in
// acc[4j + 2i + c], i, c in {0, 1}.

#pragma once

#include <cuda_bf16.h>

#include "hopper.cuh"

namespace wstream {

constexpr int kCols = 128;              // W rows (vocab columns) a tile
constexpr int kChunk = 64;              // k a stage: one 128-byte row
constexpr int kConsumers = 256;         // two consumer warpgroups
constexpr int kThreads = kConsumers + 32;  // and one producer warp
constexpr int kMaxStages = 8;
constexpr int kNumSMs = 132;            // H100 SXM
constexpr int kMaxSmem = 232448;        // dynamic shared memory a block
constexpr int kMaxPer = 511;            // tiles a slice: columns < 2^16

__host__ __device__ constexpr int stage_bytes(int r) {
  return (kCols + r) * kChunk * 2;
}

// A launch's plan: R rows of h a CTA (a wgmma n width), row_tiles of them,
// `per` W tiles a slice, `slices` slices, `stages` ring stages and the
// dynamic shared memory a CTA takes (ring, barriers, 1024 bytes of
// alignment and the epilogue's `fixed` bytes).
struct Plan {
  int rows, row_tiles, per, slices, stages, smem;
};

// The widths R takes: every multiple of 8 up to 64, then 128 and 256.
__host__ __device__ inline int row_width(int rows) {
  const int r = (rows + 7) / 8 * 8;
  return r <= 64 ? r : (r <= 128 ? 128 : 256);
}

// The row tiling of `rows` rows at most `rmax` (64 or 256) a tile, and
// the vocab slicing of `v` columns: ~132 CTAs in all, a slice at least one
// tile and at most kMaxPer.
__host__ __device__ inline Plan plan_grid(int rows, int v, int rmax) {
  Plan p;
  p.row_tiles = (rows + rmax - 1) / rmax;
  p.rows = row_width((rows + p.row_tiles - 1) / p.row_tiles);
  const int n_tiles = (v + kCols - 1) / kCols;
  int want = kNumSMs / p.row_tiles;
  want = want < 1 ? 1 : want;
  p.per = (n_tiles + want - 1) / want;
  p.per = p.per > kMaxPer ? kMaxPer : p.per;
  p.slices = (n_tiles + p.per - 1) / p.per;
  p.stages = 0;
  p.smem = 0;
  return p;
}

// As many ring stages as fit beside `fixed` epilogue bytes, at most 8.
__host__ __device__ inline void plan_stages(Plan& p, int fixed) {
  const int per_stage = stage_bytes(p.rows) + 16;  // and two mbarriers
  int s = (kMaxSmem - 1024 - fixed) / per_stage;
  p.stages = s > kMaxStages ? kMaxStages : s;
  p.smem = 1024 + p.stages * per_stage + fixed;
}

template <int N>
struct Ring {
  unsigned char* base;                  // 1024-byte aligned
  uint64_t* full;
  uint64_t* empty;
  int stages;

  __device__ __nv_bfloat16* w(int s) const {
    return reinterpret_cast<__nv_bfloat16*>(base + (size_t)s * stage_bytes(N));
  }
  __device__ __nv_bfloat16* h(int s) const { return w(s) + kCols * kChunk; }
};

// Lays the ring out at the start of dynamic shared memory and initialises
// its barriers (thread 0); returns the epilogue's area after them.  The
// caller synchronises the block before the roles split.
template <int N>
__device__ unsigned char* ring_init(Ring<N>& ring, unsigned char* smem_raw,
                                    int stages) {
  ring.base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  ring.stages = stages;
  ring.full = reinterpret_cast<uint64_t*>(ring.base +
                                          (size_t)stages * stage_bytes(N));
  ring.empty = ring.full + stages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      hopper::mbar_init(&ring.full[s], 1);
      hopper::mbar_init(&ring.empty[s], kConsumers / 32);  // a consumer warp
    }
    hopper::fence_mbar_init();
  }
  return reinterpret_cast<unsigned char*>(ring.empty + stages);
}

// The producer warp: lane 0 keeps the ring full over tiles
// [t_begin, t_end) of W and rows [row0, row0 + N) of h, nk chunks a tile.
template <int N>
__device__ void produce(const Ring<N>& ring, const CUtensorMap* wmap,
                        const CUtensorMap* hmap, int t_begin, int t_end,
                        int nk, int row0) {
  using namespace hopper;
  if ((threadIdx.x & 31) != 0) return;
  int s = 0;
  uint32_t phase = 0;
  for (int tile = t_begin; tile < t_end; ++tile)
    for (int kc = 0; kc < nk; ++kc) {
      mbar_wait(&ring.empty[s], phase ^ 1);
      mbar_arrive_tx(&ring.full[s], stage_bytes(N));
      tma_load_2d(ring.w(s), wmap, &ring.full[s], kc * kChunk, tile * kCols);
      tma_load_2d(ring.h(s), hmap, &ring.full[s], kc * kChunk, row0);
      if (++s == ring.stages) {
        s = 0;
        phase ^= 1;
      }
    }
}

// A consumer thread (0..255): acc = the tile's 128 x N logits fragment over
// nk chunks; (s, phase) is the thread's place in the ring across tiles.
// One chunk's products stay in flight while the next chunk's stage is
// awaited, and a stage is released once its products are done.
template <int N>
__device__ void consume_tile(const Ring<N>& ring, float (&acc)[N / 2],
                             int& s, uint32_t& phase, int nk) {
  using namespace hopper;
  const int wg = threadIdx.x >> 7;
  const bool leader = (threadIdx.x & 31) == 0;
  int prev = -1;
  for (int kc = 0; kc < nk; ++kc) {
    mbar_wait(&ring.full[s], phase);
    const __nv_bfloat16* a = ring.w(s) + wg * 64 * kChunk;
    const __nv_bfloat16* b = ring.h(s);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kChunk / 16; ++ks)
      wgmma_ss<N>(acc, desc_b128(a + ks * 16, 16, 1024),
                  desc_b128(b + ks * 16, 16, 1024), kc | ks);
    wgmma_commit();
    wgmma_wait<1>();
    if (prev >= 0 && leader) mbar_arrive(&ring.empty[prev]);
    prev = s;
    if (++s == ring.stages) {
      s = 0;
      phase ^= 1;
    }
  }
  wgmma_wait<0>();
  fence_regs(acc);
  if (leader) mbar_arrive(&ring.empty[prev]);
}

// Encodes both TMA maps of a launch: W (v x d) in 128-row boxes, h
// (rows x d) in r-row boxes.  Returns a cudaError_t.
inline int make_maps(CUtensorMap* wmap, CUtensorMap* hmap, const void* w,
                     const void* h, int v, int rows, int d, int r) {
  int err = hopper::make_tmap_bf16(wmap, w, v, d, kCols);
  if (err) return err;
  return hopper::make_tmap_bf16(hmap, h, rows, d, r);
}

}  // namespace wstream
