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
//
// Both kernels can keep a per-row online softmax over the same columns
// (score_tokens' lse, sample_topk's return_lse), and share its fold here:
// a row's state (m, a) is its largest logit and the sum of exp(z - m)
// over the columns folded so far, in f32 on the CUDA cores (the tensor
// cores only form the dot products: they truncate small addends).  Each
// CTA folds its fragment tile by tile (RowStates), its 8 consumer warps'
// states merge in warp order into one (m, a) a (row, slice), and one warp
// a row folds the slices' pairs in a fixed order (slices_lse).  No float
// atomics: two calls on the same inputs agree bit for bit.

#pragma once

#include <cuda_bf16.h>
#include <math.h>

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

// Merge the online-softmax state (om, oa) into (m, a); -inf and 0 is the
// state of no column.
__device__ __forceinline__ void merge_state(float& m, float& a, float om,
                                            float oa) {
  const float mn = fmaxf(m, om);
  const float safe = (mn == -INFINITY) ? 0.f : mn;
  a = a * expf(m - safe) + oa * expf(om - safe);
  m = mn;
}

// The online-softmax states of the rows a consumer thread folds.  A
// warp's 16 columns of a row reduce by a max butterfly, then a sum
// butterfly of exp(z - max), and one lane of the 8 that share the row
// keeps the row's running state (the lane whose index g is the row's j mod
// 8), so the states take N / 16 registers a thread, not N / 2.
template <int N>
struct RowStates {
  static constexpr int kNJ = N / 8;
  static constexpr int kJS = (kNJ + 7) / 8;  // states a lane keeps, per c
  float m[kJS][2], a[kJS][2];

  __device__ void init() {
#pragma unroll
    for (int q = 0; q < kJS; ++q)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        m[q][c] = -INFINITY;
        a[q][c] = 0.f;
      }
  }

  // Folds one tile's fragment: z[4j + 2i + c] (the layout above), -inf
  // at every column that does not count for its row.
  __device__ void fold(const float (&z)[N / 2], int g) {
#pragma unroll
    for (int j = 0; j < kNJ; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float z0 = z[4 * j + c];
        const float z1 = z[4 * j + 2 + c];
        float mx = fmaxf(z0, z1);
#pragma unroll
        for (int off = 4; off < 32; off <<= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float safe = mx == -INFINITY ? 0.f : mx;
        float sum = expf(z0 - safe) + expf(z1 - safe);
#pragma unroll
        for (int off = 4; off < 32; off <<= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, off);
        if ((j & 7) == g) merge_state(m[j >> 3][c], a[j >> 3][c], mx, sum);
      }
  }

  // The 8 consumer warps' states of each row, merged in warp order, to
  // part[(row * n_split + split) * 2 + {0, 1}].  `red` holds 2 * 8 * N
  // floats; consumer threads only (they meet at named barrier 1).
  __device__ void store(float* red, float* part, int row0, int rows,
                        int n_split, int split) const {
    const int tid = threadIdx.x;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
    float* red_m = red;
    float* red_a = red + (kConsumers / 32) * N;
#pragma unroll
    for (int j = 0; j < kNJ; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c)
        if ((j & 7) == g) {
          const int n = 8 * j + 2 * t + c;
          red_m[warp * N + n] = m[j >> 3][c];
          red_a[warp * N + n] = a[j >> 3][c];
        }
    hopper::bar_sync(1, kConsumers);
    if (tid < N && row0 + tid < rows) {
      float mm = -INFINITY, aa = 0.f;
      for (int wp = 0; wp < kConsumers / 32; ++wp)
        merge_state(mm, aa, red_m[wp * N + tid], red_a[wp * N + tid]);
      float* out = part + ((size_t)(row0 + tid) * n_split + split) * 2;
      out[0] = mm;
      out[1] = aa;
    }
  }
};

// One whole warp: m + log a of a row from its n_split (m, a) partials
// pr[2 s], pr[2 s + 1] (lane l merges slices l, l + 32, ... in order, then
// a fixed butterfly); -inf for a row with no column that counts.
__device__ __forceinline__ float slices_lse(const float* pr, int n_split,
                                            int lane) {
  float m = -INFINITY, a = 0.f;
  for (int s = lane; s < n_split; s += 32)
    merge_state(m, a, pr[2 * s], pr[2 * s + 1]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float om = __shfl_xor_sync(0xffffffffu, m, off);
    const float oa = __shfl_xor_sync(0xffffffffu, a, off);
    merge_state(m, a, om, oa);
  }
  return m + logf(a);
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
