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
// A quantized head (int8, e4m3 or e5m2 W with a per-column f32 scale,
// the JAX kernels' w_scale) streams 1 byte a weight.  Its W box keeps
// rows of 128 bytes, so a stage holds 128 k columns: a 128 x 128-byte W
// box (unswizzled) and two R x 64 h boxes, and the ring takes up to 8
// stages, the same 128 KB of W in flight.  Such a launch (the kernels' kQ
// instantiations) has a third role, converter warps (one warpgroup, or
// two where the registers allow: `converters`), between the producer and
// the consumers: they widen each landed W box to bf16 --
// exactly: every int8, e4m3 and e5m2 value is a bf16 value -- into one of
// two pairs of 128 x 64 bf16 tiles, laid out as the 128-byte swizzle the
// bf16 path's TMA writes, and the consumers issue the same wgmma on them.
// Full / empty mbarriers a pair pass them between the two roles, so the
// widening of the next chunk overlaps the products of this one and the
// consumers never wait at a block barrier.  The widening's ALU work, not
// the loads or the handoffs, is what paces such a stream.
// The epilogues multiply each column's f32 logit by its scale
// (load_scales) before any softcap; no dequantized W reaches global
// memory.
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
// 1-byte W: the converter threads.  Two warpgroups where the launch's
// registers allow it (at most 32 rows), else one: the widening's ALU
// work, not its loads, sets the stream's pace.
__host__ __device__ constexpr int converters(int n) {
  return n <= 32 ? 256 : 128;
}
constexpr int kMaxStages = 8;          // bf16 W
constexpr int kMaxStagesQ = 8;          // 1-byte W: 128 k columns a stage
constexpr int kNumSMs = 132;            // H100 SXM
constexpr int kMaxSmem = 232448;        // dynamic shared memory a block
constexpr int kMaxPer = 511;            // tiles a slice: columns < 2^16
// 1-byte W: two pairs of widened 128 x 64 bf16 W tiles (a stage's 128 k
// columns), and their full and empty mbarriers
constexpr int kCvtBufs = 2;
constexpr int kCvtTile = kCols * kChunk;               // bf16 elements
constexpr int kCvtBytes = kCvtBufs * 2 * kCvtTile * 2;
constexpr int kCvtExtra = kCvtBytes + 2 * kCvtBufs * 8;

using hopper::kBf16;
using hopper::kE4M3;
using hopper::kE5M2;
using hopper::kInt8;

// One ring stage: a 128 x 64 bf16 W box and an R x 64 h box (wb 2), or a
// 128 x 128 1-byte W box and two R x 64 h boxes (wb 1).
__host__ __device__ constexpr int stage_bytes(int r, int wb = 2) {
  return wb == 1 ? (kCols + r * 2) * kChunk * 2 : (kCols + r) * kChunk * 2;
}

// k columns a stage holds
__host__ __device__ constexpr int stage_k(int wb) {
  return wb == 1 ? 2 * kChunk : kChunk;
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
// tile and at most kMaxPer.  A launch plan's overrides replace the two
// choices: `per` > 0 tiles a slice, and `rmax` is then the caller's row
// tile bound (a width, see override_ok).
__host__ __device__ inline Plan plan_grid(int rows, int v, int rmax,
                                          int per = 0) {
  Plan p;
  p.row_tiles = (rows + rmax - 1) / rmax;
  p.rows = row_width((rows + p.row_tiles - 1) / p.row_tiles);
  const int n_tiles = (v + kCols - 1) / kCols;
  if (per > 0) {
    p.per = per;
  } else {
    int want = kNumSMs / p.row_tiles;
    want = want < 1 ? 1 : want;
    p.per = (n_tiles + want - 1) / want;
    p.per = p.per > kMaxPer ? kMaxPer : p.per;
  }
  p.slices = (n_tiles + p.per - 1) / p.per;
  p.stages = 0;
  p.smem = 0;
  return p;
}

// As many ring stages as fit beside `fixed` epilogue bytes (and, for a
// 1-byte W, the widened buffers and their barriers), at most 8 (bf16 W)
// or 16 (1-byte W).
__host__ __device__ inline void plan_stages(Plan& p, int fixed, int wb = 2) {
  const int per_stage = stage_bytes(p.rows, wb) + 16;  // and two mbarriers
  const int cvt = wb == 1 ? kCvtExtra : 0;
  const int most = wb == 1 ? kMaxStagesQ : kMaxStages;
  int s = (kMaxSmem - 1024 - cvt - fixed) / per_stage;
  p.stages = s > most ? most : s;
  p.smem = 1024 + cvt + p.stages * per_stage + fixed;
}

// Whether a launch plan's overrides are ones the stream takes: 0 keeps
// the launch's own choice; a row tile bound `rows_max` is a width that
// row_width produces and at most `rmax`; `per` is at most kMaxPer tiles.
// (The launch then checks its slices, stages and shared memory.)
__host__ __device__ inline bool override_ok(int rows_max, int per,
                                            int rmax) {
  if (rows_max < 0 || per < 0 || per > kMaxPer) return false;
  return rows_max == 0 ||
         (rows_max <= rmax && row_width(rows_max) == rows_max);
}

// CTAs a slice's merge may have to fold: ~kNumSMs by plan_grid's rule,
// and at most this many under an override.
constexpr int kMaxSlices = kNumSMs;

template <int N>
struct Ring {
  unsigned char* base;                  // 1024-byte aligned: the stages
  __nv_bfloat16* cvt;                   // 1-byte W: the widened tiles
  uint64_t* full;
  uint64_t* empty;
  uint64_t* cfull;                      // 1-byte W: a widened tile ready
  uint64_t* cempty;                     // ... and read by the consumers
  int stages;
  int kind;                             // WKind of W
  int wb;                               // bytes a W element

  __device__ unsigned char* w(int s) const {
    return base + (size_t)s * stage_bytes(N, wb);
  }
  // the stage's h box `half` (0, or 1 for a 1-byte W's second 64 k),
  // after its 16 KB W box
  __device__ __nv_bfloat16* h(int s, int half = 0) const {
    return reinterpret_cast<__nv_bfloat16*>(w(s) + kCols * kChunk * 2) +
           half * N * kChunk;
  }
};

// Lays the ring out at the start of dynamic shared memory (after the
// widened tiles of a 1-byte W) and initialises its barriers (thread 0);
// returns the epilogue's area after them.  A stage is released by the 8
// consumer warps and, for a 1-byte W, the `conv` / 32 converter warps.
// The caller synchronises the block before the roles split.
template <int N>
__device__ unsigned char* ring_init(Ring<N>& ring, unsigned char* smem_raw,
                                    int stages, int kind = kBf16,
                                    int conv = 0) {
  unsigned char* aligned = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  ring.kind = kind;
  ring.wb = kind == kBf16 ? 2 : 1;
  ring.cvt = reinterpret_cast<__nv_bfloat16*>(aligned);
  ring.base = aligned + (ring.wb == 1 ? kCvtBytes : 0);
  ring.stages = stages;
  ring.full = reinterpret_cast<uint64_t*>(
      ring.base + (size_t)stages * stage_bytes(N, ring.wb));
  ring.empty = ring.full + stages;
  ring.cfull = ring.empty + stages;
  ring.cempty = ring.cfull + (ring.wb == 1 ? kCvtBufs : 0);
  if (threadIdx.x == 0) {
    const int releasers =
        kConsumers / 32 + (ring.wb == 1 ? conv / 32 : 0);
    for (int s = 0; s < stages; ++s) {
      hopper::mbar_init(&ring.full[s], 1);
      hopper::mbar_init(&ring.empty[s], releasers);       // a warp each
    }
    if (ring.wb == 1)
      for (int b = 0; b < kCvtBufs; ++b) {
        hopper::mbar_init(&ring.cfull[b], conv / 32);  // a warp each
        hopper::mbar_init(&ring.cempty[b], kConsumers / 32);
      }
    hopper::fence_mbar_init();
  }
  return reinterpret_cast<unsigned char*>(
      ring.cempty + (ring.wb == 1 ? kCvtBufs : 0));
}

// The producer warp: lane 0 keeps the ring full over tiles
// [t_begin, t_end) of W and rows [row0, row0 + N) of h, nk stages a tile
// (stage_k(wb) k columns each).
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
      const int k0 = kc * stage_k(ring.wb);
      mbar_arrive_tx(&ring.full[s], stage_bytes(N, ring.wb));
      tma_load_2d(ring.w(s), wmap, &ring.full[s], k0, tile * kCols);
      tma_load_2d(ring.h(s), hmap, &ring.full[s], k0, row0);
      if (ring.wb == 1)
        tma_load_2d(ring.h(s, 1), hmap, &ring.full[s], k0 + kChunk, row0);
      if (++s == ring.stages) {
        s = 0;
        phase ^= 1;
      }
    }
}

// A converter thread of a 1-byte W (c = 0 .. kConv - 1):
// for each tile and stage, once the stage has landed and a pair of
// widened tiles is free, it widens the stage's 128 x 128 bytes
// (unswizzled) into the pair: k columns 0..63 to the first tile, 64..127
// to the second, each 128 x 64 bf16 in the 128-byte swizzle wgmma's B128
// descriptor reads (16-byte chunk j of row r at j ^ (r % 8)); then it
// releases the stage.  A warp arrives on the pair's barrier once all its
// lanes have written and fenced their part.
template <int N, int kConv>
__device__ void convert(const Ring<N>& ring, int t_begin, int t_end, int nk,
                        int c) {
  using namespace hopper;
  int s = 0, b = 0;
  uint32_t phase = 0, cphase = 0;
  for (int tile = t_begin; tile < t_end; ++tile)
    for (int kc = 0; kc < nk; ++kc) {
      mbar_wait(&ring.full[s], phase);
      mbar_wait(&ring.cempty[b], cphase ^ 1);
      const unsigned char* raw = ring.w(s);
      unsigned char* d =
          reinterpret_cast<unsigned char*>(ring.cvt + b * 2 * kCvtTile);
#pragma unroll 4
      for (int u = c; u < kCols * 16; u += kConv) {
        const int r = u >> 4, j = u & 7, t = (u >> 3) & 1;
        const uint2 x =
            *reinterpret_cast<const uint2*>(raw + r * 128 + (u & 15) * 8);
        *reinterpret_cast<uint4*>(d + t * kCvtTile * 2 + r * 128 +
                                  ((j ^ (r & 7)) << 4)) =
            widen8(x, ring.kind);
      }
      fence_proxy_async();
      __syncwarp();
      if ((c & 31) == 0) {
        mbar_arrive(&ring.cfull[b]);
        mbar_arrive(&ring.empty[s]);
      }
      if (++s == ring.stages) {
        s = 0;
        phase ^= 1;
      }
      if (++b == kCvtBufs) {
        b = 0;
        cphase ^= 1;
      }
    }
}

// A consumer thread (0..255): acc = the tile's 128 x N logits fragment over
// nk stages; (s, phase) is the thread's place in the ring across tiles,
// (b, cphase) its place in the widened tile pairs of a 1-byte W (kQ).
// One stage's products stay in flight while the next stage is awaited,
// and a stage (and a widened pair) is released once its products are
// done.
template <int N, bool kQ = false>
__device__ void consume_tile(const Ring<N>& ring, float (&acc)[N / 2],
                             int& s, uint32_t& phase, int nk, int& b,
                             uint32_t& cphase) {
  using namespace hopper;
  const int wg = threadIdx.x >> 7;
  const bool leader = (threadIdx.x & 31) == 0;
  int prev = -1, prev_b = -1;
  for (int kc = 0; kc < nk; ++kc) {
    mbar_wait(&ring.full[s], phase);
    const __nv_bfloat16* a;
    if constexpr (kQ) {
      mbar_wait(&ring.cfull[b], cphase);
      a = ring.cvt + b * 2 * kCvtTile + wg * 64 * kChunk;
    } else {
      a = reinterpret_cast<const __nv_bfloat16*>(ring.w(s)) + wg * 64 * kChunk;
    }
    const __nv_bfloat16* hb = ring.h(s);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kChunk / 16; ++ks)
      wgmma_ss<N>(acc, desc_b128(a + ks * 16, 16, 1024),
                  desc_b128(hb + ks * 16, 16, 1024), kc | ks);
    if constexpr (kQ) {       // the stage's second 64 k columns
      const __nv_bfloat16* a2 = a + kCvtTile;
      const __nv_bfloat16* h2 = ring.h(s, 1);
#pragma unroll
      for (int ks = 0; ks < kChunk / 16; ++ks)
        wgmma_ss<N>(acc, desc_b128(a2 + ks * 16, 16, 1024),
                    desc_b128(h2 + ks * 16, 16, 1024), 1);
    }
    wgmma_commit();
    wgmma_wait<1>();
    if (prev >= 0 && leader) {
      mbar_arrive(&ring.empty[prev]);
      if constexpr (kQ) mbar_arrive(&ring.cempty[prev_b]);
    }
    prev = s;
    prev_b = b;
    if (++s == ring.stages) {
      s = 0;
      phase ^= 1;
    }
    if constexpr (kQ) {
      if (++b == kCvtBufs) {
        b = 0;
        cphase ^= 1;
      }
    }
  }
  wgmma_wait<0>();
  fence_regs(acc);
  if (leader) {
    mbar_arrive(&ring.empty[prev]);
    if constexpr (kQ) mbar_arrive(&ring.cempty[prev_b]);
  }
}

// The scales of a consumer thread's two columns of tile `tile` (columns
// col_lo and col_lo + 8 of the tile; 1 past v_orig), or 1 without w_scale.
__device__ __forceinline__ void load_scales(float (&sc)[2],
                                            const float* __restrict__ ws,
                                            int tile, int col_lo,
                                            int v_orig) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int local = tile * kCols + col_lo + 8 * i;
    sc[i] = ws && local < v_orig ? __ldg(ws + local) : 1.f;
  }
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

// Encodes both TMA maps of a launch: W (v x d) in 128-row boxes (bf16,
// or 1 byte an element for a quantized head), h (rows x d) in r-row
// boxes.  Returns a cudaError_t.
inline int make_maps(CUtensorMap* wmap, CUtensorMap* hmap, const void* w,
                     const void* h, int v, int rows, int d, int r,
                     int kind = kBf16) {
  int err = kind == kBf16
                ? hopper::make_tmap_bf16(wmap, w, v, d, kCols)
                : hopper::make_tmap_u8(wmap, w, v, d, kCols, 2 * kChunk);
  if (err) return err;
  return hopper::make_tmap_bf16(hmap, h, rows, d, r);
}

}  // namespace wstream
