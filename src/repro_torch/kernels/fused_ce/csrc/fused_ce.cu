// Fused output projection + cross-entropy for Hopper (sm_90a): the forward
// statistics and the two backward contractions, without the (rows, V)
// logits ever reaching device memory.
//
// Replaces repro/kernels/fused_ce/kernel.py:_fwd_kernel (with its
// return_tile_stats option), _dh_kernel and _dw_kernel (the exact Pallas
// TPU kernels) and _dh_kernel_filtered / _dw_kernel_filtered (the
// gradient-filtered ones).  Same contract:
//   * a column (vocab row of W) is valid iff local < v_orig and
//     local + col_offset < valid; z = h . w (f32 sums of exact bf16
//     products), tanh-softcapped when cap > 0;
//   * forward, per row: lse = m + log a over the valid columns (online
//     softmax, with the m = -inf guard), z_target = z[y] when y is a valid
//     column (else 0), z_sum = sum of the valid z;
//   * backward, per (row, column): g = pc*p - gamma*((1-eps)*onehot +
//     eps/valid), times 1 - (zc/cap)^2 under softcap, 0 off the valid
//     columns and past the rows; dH = g W and dW = g^T H, both f32;
//   * tile statistic (optional, forward): tmax[rt, ct] = the max
//     post-softcap z over the 64 x 64 tile (rows 64 rt.., columns
//     64 ct..) restricted to live rows (row < n, y != ignore_index) and
//     valid columns, -inf where the tile has none;
//   * filtered backward: tile (rt, ct) of that grid is left out of dH and
//     dW where skip[rt, ct] (a (ceil(n/64), ceil(v/64)) byte mask).
//
// Bound (H100 SXM, 989 TFLOP/s bf16, 3.35 TB/s): at qwen3-0.6b's training
// shape (8192 rows, W 152064 x 1024 bf16) each pass is a 2.55 TFLOP
// product (the forward one; dH and dW two each, recompute and
// contraction), while its bytes are ~0.33 GB (dW's f32 output 0.62 GB):
// every kernel here is bound by operations, so the design keeps all of
// them on the tensor cores and keeps every logit tile in registers and
// shared memory.  All three run on wgmma with TMA.
//
// Forward (fce_fwd_partial<kStats, kQ>): the many-row GEMM of
// common/rowtile.cuh, the main loop it shares with sample_topk's many-row
// top-1 kernel: a CTA owns 128 rows of h and walks a vocab slice in
// 256-column W tiles; one producer thread streams 64-wide k chunks of both
// through a 4-stage TMA ring (128-byte swizzle, zero fill at the ragged
// edges) without pausing between tiles, so a tile's epilogue overlaps the
// next tile's loads; two consumer warpgroups issue wgmma m64n256k16 (f32
// accumulate), one chunk's products in flight.  The epilogue stays in
// registers: each thread holds 2 rows x 64 columns of the tile and
// updates each row's (m, a) by online softmax (exp2 of a fused multiply
// -add), z_sum and z_target over the valid columns.  The tile statistic
// (kStats) is the max of each of the 2 x 4 64 x 64 grid tiles the 128 x
// 256 tile holds whole: reduced in registers and the warp, then across the
// warpgroup's 4 warps through shared memory, written once by the one CTA
// that owns it.  Slices are chosen so that ~8 waves of CTAs fill the card
// (rowtile::splits; 8192 rows: 64 x 17), and a merge kernel combines each
// row's partials in slice order: no atomics, so two calls give the same
// bits, and with or without the statistic the row outputs are computed
// the same way.
//
// Backward (fce_grad<kDW, C, kFiltered>): dH and dW are one contraction
// with the roles of h and W swapped.  A CTA per 256-wide d range that
// recomputed the whole logit tile in its range would spend 4 x 2.55 TFLOP
// on recompute beside 2 x 2.55 of contraction (g as bf16 hi + lo) at d
// 1024, 16 x at d 4096.  Instead the C = ceil(d / 256) CTAs of a
// thread-block cluster (C = 4 at d 1024) share one 64-row block of the
// stationary operand (h for dH, W for dW): each keeps its rows' 256-wide
// d range in shared memory, and per 64-row tile of the streamed operand
// (W, h) TMA brings that tile's d range, which feeds both the CTA's
// partial logits over its range and its share of the contraction.  The
// partials are reduce-scattered through the bulk-copy engine: each CTA
// sums 64 / C rows of the tile in CTA order (the same z, bit for bit,
// whichever CTA forms it), forms g of them once, and sends that slice of
// g to the others, so the logits are recomputed once (7.65 TFLOP at d
// 1024 with the contraction) and g is formed once.  d 4096 takes a
// non-portable cluster of 16: the 8 x 512 alternative would need a 64 x
// 256 running sum and as large an accumulator per warpgroup, more than the
// 168 registers a thread at 384 threads.  See fce_grad for the pipeline.
//
// Past d 4096 (kWide, any d % 64 == 0): the same cluster of 16 in P =
// ceil(d / 4096) column passes, one a grid z index, so the register budget
// stays: pass p's CTA `rank` contracts g against columns [4096 p + 256
// rank, + 256) only, and for the logits streams its other ranges [4096 q +
// 256 rank, + 256) of each tile (q != p, boxes past d left out) box by box
// through a 2-stage ring of 64 x 64 S and T boxes, beside the stationary
// range of its own pass; the sum runs in ascending q whatever p is, so
// every pass forms the same z bit for bit and g is the full-d one.  The
// streamed slices drop from 3 to 2 stages to make room.  The cost: the
// logits are recomputed P times (3 x at d 12288, 2 x at 5120 and 7168),
// and the S boxes of the other ranges are re-read from L2 every tile;
// running sums in shared memory instead would take 64 KB a pass that the
// pipeline does not have.
//
// Design, and what it does about the TPU kernel's assumptions:
//   * the TPU kernel carries (m, a, z*, sum z) across a SEQUENTIAL vocab
//     grid axis.  Here the vocab is cut into n_split slices across CTAs
//     (grid row tiles x slices); each CTA runs the online softmax over its
//     slice's 256-column tiles, each thread keeping the state of its own 2
//     rows over its own columns, merged across the quad at the end, and a
//     second kernel merges the (rows, n_split, 4) partials in a fixed
//     order.  So a few hundred rows still fill the SMs;
//   * g is formed in f32, as the TPU kernel forms it, and contracted as two
//     bf16 halves (g = hi + lo, both rounded to nearest), two products on
//     the tensor cores: |g - hi - lo| <= 2^-17 |g|, well inside the
//     reference's rtol 3e-4 (a single bf16 g would cost 2^-9 a term);
//   * the Pallas kernels hold a full-d (bm, d) / (bv, d) f32 accumulator
//     in VMEM.  Here the cluster spreads d over its CTAs, 256 columns
//     each (in passes of 4096 columns past d 4096), and each contraction
//     warpgroup keeps a 64 x 128 running sum in registers;
//   * each 64-row tile of the streamed operand is contracted into a fresh
//     tensor-core accumulator and added to an f32 running sum on the CUDA
//     cores: the tensor cores truncate addends far below the accumulator,
//     and one accumulator holding the target term for the whole vocab
//     cost dH a relative error of 2.9e-4 at V = 152k (H100 80GB HBM3,
//     700 W, chip_smoke.py);
//   * dW is the reference's deterministic two-pass layout: a dH pass over
//     row blocks streaming the vocab, and a dW pass over vocab blocks
//     streaming the rows.  No atomics: the sums run in a fixed order and
//     repeat bit for bit.
//   * the gradient filter shares one 64 x 64 tile grid between the
//     statistic, the mask and both backward grids: a dH cluster owns 64
//     rows of h and streams W in 64-row tiles (mask row rt), a dW cluster
//     owns 64 rows of W and streams h in 64-row tiles (mask column ct).
//     A forward tile (128 x 256, two warpgroups of 64 rows) holds eight
//     grid tiles whole, written once, with no cross-CTA merge.  A filtered
//     backward CTA first compacts its mask
//     row or column into an ascending list of live tiles in shared
//     memory (warp ballots), then walks only that list: a skipped tile
//     costs neither its bytes nor its recompute, and an all-False mask
//     walks 0..n-1 in the exact kernel's order, bit for bit.  Live
//     tiles are uneven across clusters (target tiles pin some): no load
//     balancing yet.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"
#include "rowtile.cuh"

namespace {

using bf16 = __nv_bfloat16;

// the backward's (and the filter's) tile grid
constexpr int kBwdRows = 64;         // stationary rows a cluster
constexpr int kBwdCols = 64;         // streamed rows a tile

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Merge the online-softmax state (om, oa) into (m, a).
__device__ __forceinline__ void merge_state(float& m, float& a, float om,
                                            float oa) {
  const float mn = fmaxf(m, om);
  const float safe = (mn == -INFINITY) ? 0.f : mn;
  a = a * expf(m - safe) + oa * expf(om - safe);
  m = mn;
}

// ---------------------------------------------------------------------------
// forward: the many-row GEMM of common/rowtile.cuh, an online softmax in
// registers
// ---------------------------------------------------------------------------

constexpr float kLog2e = 1.4426950408889634f;
// the 64 x 64 tiles of the filter's grid that a 128 x 256 forward tile
// holds: each consumer warpgroup's 64 rows by four column quarters
constexpr int kQuarters = rowtile::kCols / kBwdCols;
static_assert(rowtile::kRows == 2 * kBwdRows,
              "a consumer warpgroup covers one row of the filter's grid");

// grid (ceil(n / 128), n_split), rowtile::kThreads threads,
// rowtile::kSmem bytes.  Slice `split` covers vocab tiles [split * per,
// (split + 1) * per) of 256 columns; the partial state (m, a, z_target,
// z_sum) of every row over it goes to part[(row * n_split + split) * 4
// ...].  kStats: also the tile statistic tmax (num_r, num_v) of the 64 x
// 64 grid, every entry written by the one CTA that owns it; the other
// outputs are computed the same way.
template <bool kStats, bool kQ>
__global__ void __launch_bounds__(rowtile::kThreads, 1)
    fce_fwd_partial(const __grid_constant__ CUtensorMap hmap,
                    const __grid_constant__ CUtensorMap wmap,
                    const int* __restrict__ y, float* __restrict__ part,
                    int n, int d, int v_orig, int valid, int col_offset,
                    int n_split, int per, int has_cap, float cap,
                    int ignore_index, float* __restrict__ tmax,
                    const float* __restrict__ ws, int kind) {
  using rowtile::kCols;
  extern __shared__ unsigned char smem_raw[];
  // kStats: each consumer warp's max of each quarter, double-buffered by
  // tile parity (a warp rewrites a buffer only after the warpgroup's
  // barrier of the next tile, which the readers of this one have passed)
  __shared__ float sTq[2][8][kQuarters];
  const rowtile::Ring ring = rowtile::setup(smem_raw, kind);
  const int row0 = blockIdx.x * rowtile::kRows;
  const int split = blockIdx.y;
  const int n_tiles = (v_orig + kCols - 1) / kCols;
  const int t_begin = split * per;
  const int t_end = min(t_begin + per, n_tiles);
  const int nk = d / rowtile::kChunk;
  const int wg = threadIdx.x / 128;

  if (wg == 0) {
    if (threadIdx.x == 0)
      rowtile::produce(ring, &hmap, &wmap, row0, t_begin, t_end, nk);
    else if (kQ && threadIdx.x >= 32)   // warps 1-3 widen the 1-byte W
      rowtile::convert(ring, t_begin, t_end, nk, threadIdx.x - 32);
    return;
  }

  const int cw = wg - 1;                // consumer: rows cw * 64 ..
  const int wt = threadIdx.x % 128;
  const int warp = wt >> 5;
  const int lane = wt & 31;
  const int t = lane & 3;
  // this thread's rows: row0 + cw * 64 + 16 warp + lane / 4 + 8 i
  float m[2], a[2], zt[2], zs[2];
  int yv[2];
  bool live_row[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + cw * 64 + 16 * warp + (lane >> 2) + 8 * i;
    m[i] = -INFINITY;
    a[i] = 0.f;
    zt[i] = 0.f;
    zs[i] = 0.f;
    yv[i] = row < n ? y[row] : -1;
    live_row[i] = row < n && yv[i] != ignore_index;
  }

  float acc[rowtile::kAcc];
  int it = 0;
  for (int tile = t_begin; tile < t_end; ++tile) {
    rowtile::tile_product<kQ>(acc, ring, cw, nk, it);
    const int c_base = tile * kCols;
    // pass 1: softcap, mask, the sums and each row's max over each
    // quarter (64 columns: a tile of the filter's grid), in place
    float qmax[2][kQuarters];
#pragma unroll
    for (int q = 0; q < kQuarters; ++q) qmax[0][q] = qmax[1][q] = -INFINITY;
#pragma unroll
    for (int q = 0; q < kQuarters; ++q)
#pragma unroll
      for (int j = q * (kBwdCols / 8); j < (q + 1) * (kBwdCols / 8); ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int local = c_base + 8 * j + 2 * t + c;
          const bool live = local < v_orig && local + col_offset < valid;
          float sc = 1.f;
          if constexpr (kQ) sc = local < v_orig ? __ldg(ws + local) : 1.f;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            float z = acc[4 * j + 2 * i + c];
            if constexpr (kQ) z *= sc;
            if (has_cap) z = cap * tanhf(z / cap);
            if (live) {
              zs[i] += z;
              if (local + col_offset == yv[i]) zt[i] += z;
            } else {
              z = -INFINITY;
            }
            acc[4 * j + 2 * i + c] = z;
            qmax[i][q] = fmaxf(qmax[i][q], z);
          }
        }
    float lmax[2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
      lmax[i] = fmaxf(fmaxf(qmax[i][0], qmax[i][1]),
                      fmaxf(qmax[i][2], qmax[i][3]));
    // pass 2: each row's online softmax update
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m_new = fmaxf(m[i], lmax[i]);
      const float safe = (m_new == -INFINITY) ? 0.f : m_new;
      const float nsafe = -safe * kLog2e;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols / 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c)
          sum += exp2f(fmaf(acc[4 * j + 2 * i + c], kLog2e, nsafe));
      a[i] = a[i] * expf(m[i] - safe) + sum;
      m[i] = m_new;
    }
    if (kStats) {
      // a quarter's max over the warp's 16 live rows, then over the 4
      // warps of the warpgroup: grid tile (2 blockIdx.x + cw, 4 tile + q)
      const int buf = (tile - t_begin) & 1;
#pragma unroll
      for (int q = 0; q < kQuarters; ++q) {
        float tq = fmaxf(live_row[0] ? qmax[0][q] : -INFINITY,
                         live_row[1] ? qmax[1][q] : -INFINITY);
#pragma unroll
        for (int off = 1; off < 32; off <<= 1)
          tq = fmaxf(tq, __shfl_xor_sync(0xffffffffu, tq, off));
        if (lane == 0) sTq[buf][cw * 4 + warp][q] = tq;
      }
      if (cw == 0)
        hopper::bar_sync(1, 128);
      else
        hopper::bar_sync(2, 128);
      if (wt < kQuarters) {
        const int rt = blockIdx.x * 2 + cw, ct = tile * kQuarters + wt;
        const int num_r = (n + kBwdRows - 1) / kBwdRows;
        const int num_v = (v_orig + kBwdCols - 1) / kBwdCols;
        float mx = sTq[buf][cw * 4][wt];
#pragma unroll
        for (int w = 1; w < 4; ++w) mx = fmaxf(mx, sTq[buf][cw * 4 + w][wt]);
        if (rt < num_r && ct < num_v) tmax[(size_t)rt * num_v + ct] = mx;
      }
    }
  }

  // merge the quad (the 4 lanes that share a row) and write the partial
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      const float om = __shfl_xor_sync(0xffffffffu, m[i], off);
      const float oa = __shfl_xor_sync(0xffffffffu, a[i], off);
      zt[i] += __shfl_xor_sync(0xffffffffu, zt[i], off);
      zs[i] += __shfl_xor_sync(0xffffffffu, zs[i], off);
      merge_state(m[i], a[i], om, oa);
    }
    const int row = row0 + cw * 64 + 16 * warp + (lane >> 2) + 8 * i;
    if (t == 0 && row < n) {
      float* out = part + ((size_t)row * n_split + split) * 4;
      out[0] = m[i];
      out[1] = a[i];
      out[2] = zt[i];
      out[3] = zs[i];
    }
  }
}

// grid ceil(n / 256), 256 threads: merge each row's n_split partials in
// slice order.
__global__ void fce_fwd_merge(const float* __restrict__ part,
                              float* __restrict__ lse,
                              float* __restrict__ ztgt,
                              float* __restrict__ zsum, int n, int n_split) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;
  float m = -INFINITY, a = 0.f, zt = 0.f, zs = 0.f;
  for (int s = 0; s < n_split; ++s) {
    const float* p = part + ((size_t)row * n_split + s) * 4;
    merge_state(m, a, p[0], p[1]);
    zt += p[2];
    zs += p[3];
  }
  lse[row] = m + logf(a);
  ztgt[row] = zt;
  zsum[row] = zs;
}

constexpr size_t kSmemMax = 232448;   // H100: dynamic smem a block can use

// ---------------------------------------------------------------------------
// backward: dH and dW, a thread-block cluster along d, on wgmma
// ---------------------------------------------------------------------------

constexpr int kRange = 256;              // d columns a CTA
constexpr int kBox = 64;                 // d columns a TMA box (128 bytes)
constexpr int kBoxes = kRange / kBox;
constexpr int kContract = 256;           // warpgroups 0-1: the contraction
constexpr int kBwdThreads = kContract + 128;  // + warpgroup 2: the logits
constexpr int kBwdWarps = kBwdThreads / 32;
constexpr int kPartLd = kBwdCols + 4;    // padded f32 row of a partial
constexpr uint32_t kSBytes = kBwdRows * kRange * 2;  // stationary, 32 KB
constexpr uint32_t kTBytes = kBwdCols * kRange * 2;  // a streamed slice
constexpr uint32_t kGBytes = kBwdRows * kBwdCols * 2;  // 8 KB
// row statistics y, lse, gamma, pc of 64 rows: one slot a ring stage
constexpr uint32_t kStatBytes = 4 * kBwdCols * 4;
constexpr size_t kPartBytes = kBwdRows * kPartLd * 4;
// past d 4096 (kWide): the cluster's 16 CTAs cover d in passes of 4096
// columns, and the logits warpgroup streams the CTA's other ranges of each
// tile box by box, an S box and a T box a stage
constexpr int kPassCols = 16 * kRange;
constexpr uint32_t kXBox = kBwdRows * kBox * 2;      // 8 KB
constexpr int kXStages = 2;

// shared memory, from a 1024-byte aligned base: the stationary range, the
// streamed slices, g (hi, lo x 2 buffers), the CTA's partial logits
// (staging for its bulk copies) and two receive buffers of C row slices
// (each 64 padded rows of f32), a statistics slot a slice, (kWide) the
// box ring, the barriers, the warps' counts and the filtered tile list
template <bool kWide>
struct BwdLayout {
  static constexpr int kStages = kWide ? 2 : 3;   // streamed slices
  static constexpr size_t kOffS = 0;
  static constexpr size_t kOffT = kOffS + kSBytes;
  static constexpr size_t kOffG = kOffT + (size_t)kStages * kTBytes;
  static constexpr size_t kOffPart = kOffG + 4 * kGBytes;
  static constexpr size_t kOffStats = kOffPart + 3 * kPartBytes;
  static constexpr size_t kEndStats =
      kOffStats + (size_t)kStages * kStatBytes;
  static constexpr size_t kOffX = kWide ? (kEndStats + 1023) & ~size_t(1023)
                                        : kEndStats;
  static constexpr size_t kOffBar =
      kOffX + (kWide ? (size_t)kXStages * 2 * kXBox : 0);
  static constexpr int kBars = kStages + 1 + 2 + 2 + 2 + (kWide ? kXStages : 0);
  static constexpr size_t kOffCnt = kOffBar + kBars * 8;
  static constexpr size_t kOffList = kOffCnt + kBwdWarps * 4;
  static constexpr size_t kSmem = 1024 + kOffList;  // + the tile list
};
constexpr size_t kBwdSmem = BwdLayout<false>::kSmem;
static_assert(BwdLayout<true>::kSmem <= kBwdSmem,
              "the wide layout fits wherever the narrow one does");
constexpr int kBwdMaxFilteredTiles =
    (int)((kSmemMax - kBwdSmem) / sizeof(uint16_t));

// 4-byte async copy; `pred` false fills zeros (src-size 0, no read)
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(pred ? 4 : 0));
}

// one arrival on `bar` once this thread's earlier cp.async copies have
// landed (the barrier's count includes it)
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// dH (n, d) f32 when !kDW, dW (v_orig, d) f32 when kDW.  S is the
// stationary operand (h for dH, W for dW), T the streamed one (W, h): the
// logit tile is z[S row, T row] either way.  grid (C, ceil(S rows / 64),
// P) in clusters of (C, 1, 1), C in {1, 4, 16} covering ceil(d / 256)
// ranges of 256 columns (a range past d reads zeros and writes nothing),
// P = 1, or C = 16 and P = ceil(d / 4096) passes when kWide (the header),
// kBwdThreads threads, BwdLayout<kWide>::kSmem bytes (+ 2 a streamed tile
// when filtered).  CTA `rank` of pass p owns d columns c0 = [4096 p + 256
// rank, + 256) (p = 0 unless kWide) of the cluster's 64
// S rows, and row slice [R rank, R rank + R), R = 64 / C, of every tile's
// logits.  Per live T tile j:
//   * warpgroup 2 (the logits warpgroup) issues the partial logits over
//     the CTA's d range, 64 x 64 (wgmma m64n64k16, both operands K-major;
//     S[rows, d range] stays in shared memory), stages them and
//     bulk-copies each CTA's row slice into that CTA's receive buffer j % 2,
//     completing its pfull[j % 2];
//   * warpgroups 0-1 (the contraction warpgroups), once pfull[j % 2]
//     completes, sum the CTA's own slice of the C partials in CTA order
//     (the cluster's z, bit for bit, once), form g of the slice (bf16 hi
//     and lo) in g[j % 2], 128-byte swizzled, and bulk-copy the slice into
//     every other CTA's g[j % 2], completing their gfull[j % 2]; once
//     gfull[j % 2] completes, each contracts a fresh 64 x 128 accumulator =
//     g (hi, then lo) . T[tile, its 128 d columns] read MN-major (wgmma
//     m64n128k16, B transposed), adds it to its f32 running sum on the CUDA
//     cores and arrives on every CTA's gfree[j % 2] (2 C a phase); then
//     T[tile j + 3, d range] is loaded by TMA into the slice just freed.
//     They form tile j + 1's g right after contracting tile j.
// The row statistics belong to h's rows: dH loads its 64 stationary rows'
// once; dW's come with each streamed slice, into the stage's slot, by 64
// threads' 4-byte cp.async (zeros past n) whose arrivals the slice's
// full[] barrier counts beside the TMA bytes, so they stay until the
// slice is reloaded, after its contraction.
// Flow control: a CTA sends tile j + 2's partial slices only once its own
// gfull[j % 2] has completed, because every CTA sends its g of tile j only
// after it has summed its receive buffer of tile j; it writes g of tile j + 2
// only once gfree[j % 2] says every CTA has contracted tile j.  All
// exchanges go through the bulk-copy engine with transaction counts: on
// the H100 a thread's remote mbarrier arrival with release semantics, and
// a pull of the partials through distributed shared memory, each stalled
// the pipeline for longer than the tile's own products.  The contraction
// warpgroups hold their running sum and one accumulator (128 of the 168
// registers a thread that ptxas allots at 384 threads) and the exchange's
// few values; the logits warpgroup runs up to two tiles ahead of them.
// Each CTA receives (C - 1) / C of a partial and sends as much of g a
// tile, ~24 KB at any C, where an all-gather of the partials would move
// 48 KB at C = 4 and 240 KB at C = 16.
template <bool kDW, int kC, bool kFiltered, bool kWide>
__global__ void __launch_bounds__(kBwdThreads, 1)
    fce_grad(const __grid_constant__ CUtensorMap smap,
             const __grid_constant__ CUtensorMap tmap,
             const int* __restrict__ y, const float* __restrict__ lse,
             const float* __restrict__ gamma, const float* __restrict__ pc,
             const uint8_t* __restrict__ skip, float* __restrict__ out, int n,
             int d, int v_orig, int valid, int col_offset, int has_cap,
             float cap, float eps) {
  using namespace hopper;
  using L = BwdLayout<kWide>;
  constexpr int kStages = L::kStages;
  constexpr int R = kBwdRows / kC;       // rows of a tile this CTA owns
  constexpr uint32_t kGSlice = R * 128;  // bytes of a g slice (hi or lo)
  extern __shared__ unsigned char bwd_smem_raw[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(bwd_smem_raw) + 1023) & ~uintptr_t(1023));
  bf16* ss = reinterpret_cast<bf16*>(sm + L::kOffS);
  bf16* ts = reinterpret_cast<bf16*>(sm + L::kOffT);
  unsigned char* gt = sm + L::kOffG;  // g[b]: hi at 2 b, lo at 2 b + 1 tiles
  float* stage = reinterpret_cast<float*>(sm + L::kOffPart);
  float* recv = stage + kBwdRows * kPartLd;  // [2][C][R][kPartLd]
  // slot k: y[64], then lse, gamma, pc (f32); dH uses slot 0 only
  auto stat_slot = [&](int k) {
    return reinterpret_cast<int*>(sm + L::kOffStats + k * kStatBytes);
  };
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::kOffBar);
  uint64_t* sbar = full + kStages;
  uint64_t* pfull = sbar + 1;
  uint64_t* gfull = pfull + 2;
  uint64_t* gfree = gfull + 2;
  uint64_t* xfull = gfree + 2;          // kWide: the box ring
  int* sCnt = reinterpret_cast<int*>(sm + L::kOffCnt);
  uint16_t* sList = reinterpret_cast<uint16_t*>(sm + L::kOffList);

  const int s_rows = kDW ? v_orig : n;
  const int t_rows = kDW ? n : v_orig;
  const int rank = blockIdx.x;          // the cluster spans gridDim.x
  // kWide: pass blockIdx.z contracts columns [4096 z, 4096 z + 4096)
  const int pass = kWide ? (int)blockIdx.z : 0;
  const int c0 = pass * kPassCols + rank * kRange;
  const int s0 = blockIdx.y * kBwdRows;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wt = tid & 127;             // thread in its warpgroup
  const int wl = wt >> 5;               // warp in its warpgroup
  const int g = lane >> 2;
  const int t = lane & 3;

  if (!kDW && tid < kBwdRows) {
    int* sY = stat_slot(0);
    float* sL = reinterpret_cast<float*>(sY + kBwdRows);
    const int r = s0 + tid;
    const bool ok = r < n;
    sY[tid] = ok ? y[r] : -1;
    sL[tid] = ok ? lse[r] : 0.f;
    sL[kBwdRows + tid] = ok ? gamma[r] : 0.f;
    sL[2 * kBwdRows + tid] = ok ? pc[r] : 0.f;
  }
  if (tid == 0) {
    // dW: + one cp.async arrival of each statistics thread
    for (int s = 0; s < kStages; ++s)
      mbar_init(&full[s], kDW ? 1 + kBwdCols : 1);
    if (kWide)
      for (int s = 0; s < kXStages; ++s) mbar_init(&xfull[s], 1);
    mbar_init(sbar, 1);
    for (int b = 0; b < 2; ++b) {
      mbar_init(&pfull[b], 1);          // + the C partial slices' bytes
      mbar_init(&gfull[b], 1);          // + the peers' g bytes
      mbar_init(&gfree[b], 2 * kC);
    }
    fence_mbar_init();
  }
  const int n_tiles = (t_rows + kBwdCols - 1) / kBwdCols;
  int n_live = n_tiles;
  if (kFiltered) {
    // compact this block's line of the (ceil(n/64), ceil(v/64)) mask into
    // sList, in ascending order: dH reads row blockIdx.y, dW column
    // blockIdx.y.  One ballot a warp, warp offsets from sCnt.  Every CTA
    // of the cluster reads the same line, so all walk the same list.
    n_live = 0;
    for (int base = 0; base < n_tiles; base += kBwdThreads) {
      const int i = base + tid;
      const size_t at = kDW ? (size_t)i * gridDim.y + blockIdx.y
                            : (size_t)blockIdx.y * n_tiles + i;
      const bool live = i < n_tiles && !skip[at];
      const unsigned bal = __ballot_sync(0xffffffffu, live);
      if (lane == 0) sCnt[warp] = __popc(bal);
      __syncthreads();
      int off = n_live, tot = 0;
      for (int k = 0; k < kBwdWarps; ++k) {
        const int c = sCnt[k];
        off += k < warp ? c : 0;
        tot += c;
      }
      if (live) sList[off + __popc(bal & ((1u << lane) - 1u))] = i;
      n_live += tot;
      __syncthreads();  // sCnt is rewritten next round; sList is complete
    }
  }
  __syncthreads();
  cluster_sync();  // every CTA's barriers exist before any remote arrival

  // T[tile of the li-th live tile, d range] into slice li % kStages
  // (thread 0); dW: the statistics of its 64 rows into slot li % kStages
  // (threads 0-63)
  auto load_t = [&](int li) {
    const int s = li % kStages;
    const int tile = kFiltered ? sList[li] : li;
    if (kDW && tid < kBwdCols) {
      const int r = tile * kBwdCols + tid;
      const bool ok = r < n;
      const int rr = ok ? r : 0;
      int* dst = stat_slot(s) + tid;
      cp_async4(dst, y + rr, ok);
      cp_async4(dst + kBwdCols, lse + rr, ok);
      cp_async4(dst + 2 * kBwdCols, gamma + rr, ok);
      cp_async4(dst + 3 * kBwdCols, pc + rr, ok);
      cp_async_arrive(&full[s]);
    }
    if (tid == 0) {
      mbar_arrive_tx(&full[s], kTBytes);
      bf16* dst = ts + (size_t)s * kBwdCols * kRange;
      for (int j = 0; j < kBoxes; ++j)
        tma_load_2d(dst + j * kBwdCols * kBox, &tmap, &full[s],
                    c0 + j * kBox, tile * kBwdCols);
    }
  };

  constexpr uint32_t kPSlice = R * kPartLd * 4;   // bytes of a partial slice

  if (tid < kContract) {
    // ---- the contraction warpgroups --------------------------------------
    const int w = tid >> 7;             // 128 d columns each
    // X and G: the first kXT threads take E entries each of the CTA's row
    // slice (E >= 2: g is packed two bf16 to a word)
    constexpr int kXT = R * kBwdCols / 2 < kContract ? R * kBwdCols / 2
                                                     : kContract;
    constexpr int E = R * kBwdCols / kXT;
    constexpr int VW = E < 4 ? E : 4;   // floats a read
    const int xr = tid / (kBwdCols / E);            // row in the slice
    const int xc = (tid % (kBwdCols / E)) * E;      // first column
    const int grow = R * rank + xr;                 // row in the tile
    const float one_m_eps = 1.f - eps;
    const float eps_valid = eps / (float)valid;
    for (int li = 0; li < kStages && li < n_live; ++li) load_t(li);
    if (tid == 0)
      for (int b = 0; b < 2; ++b) mbar_arrive_tx(&pfull[b], kC * kPSlice);
    // X then G: the li-th live tile's row slice summed over the C
    // partials in CTA order, then g of it, bf16 hi and lo, into g[li % 2]
    // and bulk-copied into every other CTA's (lane c to CTA rank + c)
    auto exchange = [&](int li) {
      const int b = li & 1;
      const int tile = kFiltered ? sList[li] : li;
      unsigned char* ghi = gt + (2 * b) * kGBytes;
      unsigned char* glo = ghi + kGBytes;
      mbar_wait(&pfull[b], (li >> 1) & 1);
      float z[E];
      if (tid < kXT) {
        const float* src = recv + b * kC * R * kPartLd + xr * kPartLd + xc;
#pragma unroll
        for (int c = 0; c < kC; ++c)
#pragma unroll
          for (int e = 0; e < E; e += VW) {
            const float* p = src + c * R * kPartLd + e;
            float q[VW];
            if constexpr (VW == 4) {
              const float4 v4 = *reinterpret_cast<const float4*>(p);
              q[0] = v4.x, q[1] = v4.y, q[2] = v4.z, q[3] = v4.w;
            } else {
              const float2 v2 = *reinterpret_cast<const float2*>(p);
              q[0] = v2.x, q[1] = v2.y;
            }
#pragma unroll
            for (int k = 0; k < VW; ++k)
              z[e + k] = c ? z[e + k] + q[k] : q[k];
          }
      }
      // the buffer is consumed: arm it for tile li + 2 (whose slices the
      // peers send only after this CTA's g of tile li reaches them)
      bar_sync(2, kContract);
      if (tid == 0 && li + 2 < n_live)
        mbar_arrive_tx(&pfull[b], kC * kPSlice);
      if (tid < kXT) {
        // statistics of h's row: dH's stationary row, dW's streamed ones
        // (their slot is complete once the slice's barrier is)
        const int* sY = stat_slot(kDW ? li % kStages : 0);
        const float* sL = reinterpret_cast<const float*>(sY + kBwdRows);
        if (kDW) mbar_wait(&full[li % kStages], (li / kStages) & 1);
        const int srow = s0 + grow;
        uint32_t hi[E / 2], lo[E / 2];
#pragma unroll
        for (int e = 0; e < E; e += 2) {
          float gv[2];
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int trow = tile * kBwdCols + xc + e + j;
            const int si = kDW ? xc + e + j : grow;   // h's row in the slot
            const int row = kDW ? trow : srow;         // h's row
            const int local = kDW ? srow : trow;       // W's row
            const float lr = sL[si], gr = sL[kBwdRows + si];
            const float pr = sL[2 * kBwdRows + si];
            const int yr = sY[si];
            const bool live = row < n && local < v_orig &&
                              local + col_offset < valid;
            float zc = z[e + j];
            if (has_cap) zc = cap * tanhf(zc / cap);
            const float p =
                live ? exp2f((zc - lr) * 1.4426950408889634f) : 0.f;
            const float onehot = (local + col_offset == yr) ? 1.f : 0.f;
            float gg = pr * p - gr * (one_m_eps * onehot + eps_valid);
            if (has_cap) {
              const float rr = zc / cap;
              gg *= 1.f - rr * rr;
            }
            gv[j] = live ? gg : 0.f;
          }
          const bf16 h0 = __float2bfloat16_rn(gv[0]);
          const bf16 h1 = __float2bfloat16_rn(gv[1]);
          const bf16 l0 = __float2bfloat16_rn(gv[0] - __bfloat162float(h0));
          const bf16 l1 = __float2bfloat16_rn(gv[1] - __bfloat162float(h1));
          __nv_bfloat162 hp = __halves2bfloat162(h0, h1);
          __nv_bfloat162 lp = __halves2bfloat162(l0, l1);
          hi[e / 2] = *reinterpret_cast<uint32_t*>(&hp);
          lo[e / 2] = *reinterpret_cast<uint32_t*>(&lp);
        }
        // the g tiles are free once every CTA has contracted tile li - 2
        if (li >= 2) mbar_wait_cluster(&gfree[b], ((li >> 1) - 1) & 1);
        // 128-byte swizzle: 16-byte chunk k of row r sits at chunk k ^ (r %
        // 8)
#pragma unroll
        for (int e = 0; e < E; e += (E < 8 ? E : 8)) {
          const int col = xc + e;
          const int off = grow * 128 +
                          ((((col * 2) >> 4) ^ (grow & 7)) << 4) +
                          ((col * 2) & 15);
          if constexpr (E >= 8) {
            *reinterpret_cast<uint4*>(ghi + off) = make_uint4(
                hi[e / 2], hi[e / 2 + 1], hi[e / 2 + 2], hi[e / 2 + 3]);
            *reinterpret_cast<uint4*>(glo + off) = make_uint4(
                lo[e / 2], lo[e / 2 + 1], lo[e / 2 + 2], lo[e / 2 + 3]);
          } else if constexpr (E == 4) {
            *reinterpret_cast<uint2*>(ghi + off) = make_uint2(hi[0], hi[1]);
            *reinterpret_cast<uint2*>(glo + off) = make_uint2(lo[0], lo[1]);
          } else {
            *reinterpret_cast<uint32_t*>(ghi + off) = hi[0];
            *reinterpret_cast<uint32_t*>(glo + off) = lo[0];
          }
        }
        fence_proxy_async();
      }
      bar_sync(2, kContract);
      if (tid == 0) mbar_arrive_tx(&gfull[b], 2 * (kC - 1) * kGSlice);
      if (tid > 0 && tid < kC) {
        const uint32_t off = R * rank * 128;
        const int peer = (rank + tid) % kC;
        bulk_copy_to_cta(ghi + off, ghi + off, kGSlice, &gfull[b], peer);
        bulk_copy_to_cta(glo + off, glo + off, kGSlice, &gfull[b], peer);
      }
    };

    float run[64], acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) run[i] = 0.f;
    if (n_live > 0) exchange(0);
    for (int li = 0; li < n_live; ++li) {
      const int b = li & 1;
      const int s = li % kStages;
      const unsigned char* ghi = gt + (2 * b) * kGBytes;
      const unsigned char* glo = ghi + kGBytes;
      const bf16* tsl = ts + (size_t)s * kBwdCols * kRange +
                        2 * w * kBwdCols * kBox;
      mbar_wait(&gfull[b], (li >> 1) & 1);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kv = 0; kv < kBwdCols / 16; ++kv) {
        const uint64_t db = desc_b128(tsl + kv * 16 * kBox,
                                      kBwdCols * kBox * 2, 1024);
        wgmma_m64n128k16_tb(acc, desc_b128(ghi + kv * 32, 16, 1024), db,
                            kv);
        wgmma_m64n128k16_tb(acc, desc_b128(glo + kv * 32, 16, 1024), db, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
#pragma unroll
      for (int i = 0; i < 64; ++i) run[i] += acc[i];
      // g[b] is free here (the group has completed); on every CTA once all
      // have arrived
      if (wt < kC) mbar_arrive_cluster_relaxed(&gfree[b], wt);
      bar_sync(2, kContract);           // both are done with slice s
      if (li + kStages < n_live) load_t(li + kStages);
      if (li + 1 < n_live) exchange(li + 1);
    }
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = s0 + 16 * wl + g + 8 * i;
        const int col = c0 + w * 128 + 8 * j + 2 * t;
        if (row < s_rows && col < d)
          *reinterpret_cast<float2*>(out + (size_t)row * d + col) =
              make_float2(run[4 * j + 2 * i], run[4 * j + 2 * i + 1]);
      }
    __syncwarp();
    cluster_sync();  // no CTA leaves while a peer may send to it
    return;
  }

  // ---- the logits warpgroup -----------------------------------------------
  float accZ[32];
  if (n_live > 0) {  // a filtered CTA with no live tile reads no operand
    if (wt == 0) {
      mbar_arrive_tx(sbar, kSBytes);
      for (int j = 0; j < kBoxes; ++j)
        tma_load_2d(ss + j * kBwdRows * kBox, &smap, sbar, c0 + j * kBox,
                    s0);
    }
    mbar_wait(sbar, 0);
  }
  // kWide: the CTA's ranges are columns [4096 q + 256 rank, + 256) for q
  // < ceil(d / 4096); a tile's partial logits sum them in ascending q, the
  // boxes of each in ascending order, boxes past d left out, so every pass
  // forms the same z bit for bit.  Range `pass` comes from the stationary
  // S and the streamed slice; the others' boxes, nx a tile, come through
  // the box ring: step x of the flattened (live tile, box) sequence into
  // stage x % 2, issued two steps ahead by thread 0 of this warpgroup.
  const int n_pass = kWide ? (d + kPassCols - 1) / kPassCols : 1;
  auto boxes_of = [&](int q) {          // range q's boxes below d
    const int base = q * kPassCols + rank * kRange;
    return base >= d ? 0 : min(kBoxes, (d - base) / kBox);
  };
  int nx = 0;
  if (kWide)
    for (int q = 0; q < n_pass; ++q) nx += q == pass ? 0 : boxes_of(q);
  const int x_total = n_live * nx;
  auto load_x = [&](int x) {
    const int st = x % kXStages;
    const int li = x / nx;
    int r = x % nx, q = 0;
    for (;; ++q) {
      const int nb = q == pass ? 0 : boxes_of(q);
      if (r < nb) break;
      r -= nb;
    }
    const int col = q * kPassCols + rank * kRange + r * kBox;
    const int tile = kFiltered ? sList[li] : li;
    unsigned char* xs = sm + L::kOffX + (size_t)st * 2 * kXBox;
    mbar_arrive_tx(&xfull[st], 2 * kXBox);
    tma_load_2d(xs, &smap, &xfull[st], col, s0);
    tma_load_2d(xs + kXBox, &tmap, &xfull[st], col, tile * kBwdCols);
  };
  if (kWide && wt == 0)
    for (int x = 0; x < kXStages && x < x_total; ++x) load_x(x);
  int xstep = 0;
  // L then P: the partial logits of the li-th live tile, staged, then each
  // CTA's row slice bulk-copied into its receive buffer li % 2 (completing
  // its pfull), once every CTA has consumed that buffer's tile li - 2: each
  // sent its g of tile li - 2 after, so this CTA's gfull of it says so.
  // Lane c serves CTA rank + c.
  for (int li = 0; li < n_live; ++li) {
    const int s = li % kStages;
    const bf16* tsl = ts + (size_t)s * kBwdCols * kRange;
    if constexpr (kWide) {
      int first = 0;                    // scale_d: 0 starts the sum
      for (int q = 0; q < n_pass; ++q) {
        const int nb = boxes_of(q);
        if (q == pass) {
          mbar_wait(&full[s], (li / kStages) & 1);
          fence_regs(accZ);
          wgmma_fence();
          for (int ks = 0; ks < 4 * nb; ++ks) {
            const int box = ks >> 2, kin = (ks & 3) * 16;
            wgmma_ss<64>(
                accZ, desc_b128(ss + box * kBwdRows * kBox + kin, 16, 1024),
                desc_b128(tsl + box * kBwdCols * kBox + kin, 16, 1024),
                first);
            first = 1;
          }
          wgmma_commit();
          continue;
        }
        for (int j = 0; j < nb; ++j, ++xstep) {
          const int st = xstep % kXStages;
          const bf16* xs = reinterpret_cast<const bf16*>(
              sm + L::kOffX + (size_t)st * 2 * kXBox);
          mbar_wait(&xfull[st], (xstep / kXStages) & 1);
          fence_regs(accZ);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < kBox / 16; ++kk) {
            wgmma_ss<64>(accZ, desc_b128(xs + kk * 16, 16, 1024),
                         desc_b128(xs + kBwdRows * kBox + kk * 16, 16, 1024),
                         first);
            first = 1;
          }
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(accZ);
          bar_sync(1, 128);             // every warp is done with stage st
          if (wt == 0 && xstep + kXStages < x_total)
            load_x(xstep + kXStages);
        }
      }
    } else {
      mbar_wait(&full[s], (li / kStages) & 1);
      fence_regs(accZ);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kRange / 16; ++ks) {
        const int box = ks >> 2, kin = (ks & 3) * 16;
        wgmma_ss<64>(accZ,
                     desc_b128(ss + box * kBwdRows * kBox + kin, 16, 1024),
                     desc_b128(tsl + box * kBwdCols * kBox + kin, 16, 1024),
                     ks);
      }
      wgmma_commit();
    }
    if (wt < kC) bulk_wait_read();      // the last tile's copies are out
    wgmma_wait<0>();
    fence_regs(accZ);
    bar_sync(1, 128);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = 16 * wl + g + 8 * i;
        *reinterpret_cast<float2*>(stage + row * kPartLd + 8 * j + 2 * t) =
            make_float2(accZ[4 * j + 2 * i], accZ[4 * j + 2 * i + 1]);
      }
    fence_proxy_async();
    bar_sync(1, 128);
    if (wt < kC) {
      const int b = li & 1;
      const int peer = (rank + wt) % kC;
      if (li >= 2) mbar_wait(&gfull[b], ((li >> 1) - 1) & 1);
      bulk_copy_to_cta(recv + (b * kC + rank) * R * kPartLd,
                       stage + peer * R * kPartLd, kPSlice, &pfull[b], peer);
      bulk_commit();
    }
  }
  __syncwarp();
  cluster_sync();
}

// the launch configuration of fce_grad<kDW, kC, kFiltered, kWide>, with
// its attributes set: grid (C, ceil(S rows / 64), passes) in clusters of C
template <bool kDW, int kC, bool kFiltered, bool kWide>
cudaError_t grad_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute* attr,
                        int s_rows, int passes, size_t smem,
                        cudaStream_t stream) {
  const auto kern = fce_grad<kDW, kC, kFiltered, kWide>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  if (kC > 8) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  cfg = {};
  cfg.gridDim = dim3(kC, (s_rows + kBwdRows - 1) / kBwdRows, passes);
  cfg.blockDim = dim3(kBwdThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kC;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaSuccess;
}

template <bool kDW, int kC, bool kFiltered, bool kWide = false>
int launch_grad(const CUtensorMap& smap, const CUtensorMap& tmap,
                const void* y, const void* lse, const void* gamma,
                const void* pc, const void* skip, void* out, int n, int d,
                int v_orig, int valid, int col_offset, int has_cap,
                float cap, float eps, size_t list_bytes,
                cudaStream_t stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  const int passes = kWide ? (d + kPassCols - 1) / kPassCols : 1;
  cudaError_t err = grad_config<kDW, kC, kFiltered, kWide>(
      cfg, attr, kDW ? v_orig : n, passes,
      BwdLayout<kWide>::kSmem + list_bytes, stream);
  if (err != cudaSuccess) return (int)err;
  const auto kern = fce_grad<kDW, kC, kFiltered, kWide>;
  err = cudaLaunchKernelEx(
      &cfg, kern, smap, tmap,
      static_cast<const int*>(y), static_cast<const float*>(lse),
      static_cast<const float*>(gamma), static_cast<const float*>(pc),
      static_cast<const uint8_t*>(skip), static_cast<float*>(out), n, d,
      v_orig, valid, col_offset, has_cap, cap, eps);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// the cluster size of d: 1, 4 or 16 ranges of 256 columns (16 past 4096,
// in passes)
int grad_cluster(int d) { return d <= 256 ? 1 : (d <= 1024 ? 4 : 16); }

template <bool kDW, bool kFiltered>
int launch_grad_any(const void* h, const void* w, const void* y,
                    const void* lse, const void* gamma, const void* pc,
                    const void* skip, void* out, int n, int d, int v_orig,
                    int valid, int col_offset, int has_cap, float cap,
                    float eps, void* stream) {
  const int s_rows = kDW ? v_orig : n;
  const int t_rows = kDW ? n : v_orig;
  const int n_tiles = (t_rows + kBwdCols - 1) / kBwdCols;
  if (d < kBox || d % kBox || (kFiltered && n_tiles > kBwdMaxFilteredTiles))
    return (int)cudaErrorInvalidValue;
  CUtensorMap smap, tmap;
  int e = hopper::make_tmap_bf16(&smap, kDW ? w : h, s_rows, d, kBwdRows);
  if (e) return e;
  e = hopper::make_tmap_bf16(&tmap, kDW ? h : w, t_rows, d, kBwdCols);
  if (e) return e;
  const size_t list = kFiltered ? (size_t)n_tiles * sizeof(uint16_t) : 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (d > kPassCols)
    return launch_grad<kDW, 16, kFiltered, true>(
        smap, tmap, y, lse, gamma, pc, skip, out, n, d, v_orig, valid,
        col_offset, has_cap, cap, eps, list, s);
  switch (grad_cluster(d)) {
    case 1:
      return launch_grad<kDW, 1, kFiltered>(
          smap, tmap, y, lse, gamma, pc, skip, out, n, d, v_orig, valid,
          col_offset, has_cap, cap, eps, list, s);
    case 4:
      return launch_grad<kDW, 4, kFiltered>(
          smap, tmap, y, lse, gamma, pc, skip, out, n, d, v_orig, valid,
          col_offset, has_cap, cap, eps, list, s);
    default:
      return launch_grad<kDW, 16, kFiltered>(
          smap, tmap, y, lse, gamma, pc, skip, out, n, d, v_orig, valid,
          col_offset, has_cap, cap, eps, list, s);
  }
}

template <bool kDW, int kC>
int max_clusters(int* count) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t err = grad_config<kDW, kC, false, false>(
      cfg, attr, 1024 * kBwdRows, 1, kBwdSmem, 0);
  if (err != cudaSuccess) return (int)err;
  const auto kern = fce_grad<kDW, kC, false, false>;
  return (int)cudaOccupancyMaxActiveClusters(count, kern, &cfg);
}

}  // namespace

extern "C" {

// The forward's vocab slices for n rows and v_orig columns, into out[0]
// (the wrapper's Python mirror, core.windows.choose_ce_plan, must agree).
void fused_ce_fwd_plan(int n, int v_orig, int* out) {
  out[0] = rowtile::splits(n, v_orig, nullptr);
}

// Forward statistics: part is (n, n_split, 4) f32 scratch; lse, ztgt, zsum
// are (n,) f32.  tmax, when not null, receives the (ceil(n/64),
// ceil(v_orig/64)) f32 tile statistic over the rows whose y is not
// ignore_index.  W's elements are of hopper::WKind `kind` (bf16, or 1
// byte: int8, e4m3, e5m2); ws is the (v_orig,) f32 scale of each column,
// given exactly with a 1-byte W, and not with tmax.  n_split, the launch
// plan's vocab slices, is any count from 1 to the vocab's 256-column tiles
// that leaves no slice empty (ceil(tiles / ceil(tiles / n_split)) ==
// n_split); another returns cudaErrorInvalidValue.  Returns the
// cudaError_t of the launches.
int fused_ce_fwd_launch(const void* h, const void* w, const void* y,
                        void* part, void* lse, void* ztgt, void* zsum, int n,
                        int d, int v_orig, int valid, int col_offset,
                        int n_split, int has_cap, float cap, int ignore_index,
                        void* tmax, const void* ws, int kind, void* stream) {
  const int n_tiles = (v_orig + rowtile::kCols - 1) / rowtile::kCols;
  if (n < 1 || v_orig < 1 || d < rowtile::kChunk || d % rowtile::kChunk ||
      n_split < 1 || n_split > 65535 || n_split > n_tiles || kind < 0 ||
      kind > hopper::kE5M2 || (tmax && ws) ||
      (ws != nullptr) != (kind != hopper::kBf16))
    return (int)cudaErrorInvalidValue;
  const int per = (n_tiles + n_split - 1) / n_split;
  if ((n_tiles + per - 1) / per != n_split)     // no slice left empty
    return (int)cudaErrorInvalidValue;
  static int given[3][hopper::kMaxDevices];
  const int variant = tmax ? 1 : (ws ? 2 : 0);
  const auto kern = variant == 1   ? fce_fwd_partial<true, false>
                    : variant == 2 ? fce_fwd_partial<false, true>
                                   : fce_fwd_partial<false, false>;
  const int smem = (int)(kind ? rowtile::kSmemQ : rowtile::kSmem);
  cudaError_t err = hopper::raise_smem_limit(
      reinterpret_cast<const void*>(kern), smem, given[variant]);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap hmap, wmap;
  const int e = rowtile::make_maps(&hmap, &wmap, h, w, n, v_orig, d, kind);
  if (e) return e;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  dim3 grid((n + rowtile::kRows - 1) / rowtile::kRows, n_split);
  kern<<<grid, rowtile::kThreads, smem, s>>>(
      hmap, wmap, static_cast<const int*>(y), static_cast<float*>(part), n,
      d, v_orig, valid, col_offset, n_split, per, has_cap, cap, ignore_index,
      static_cast<float*>(tmax), static_cast<const float*>(ws), kind);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fce_fwd_merge<<<(n + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(part), static_cast<float*>(lse),
      static_cast<float*>(ztgt), static_cast<float*>(zsum), n, n_split);
  return (int)cudaGetLastError();
}

// dH (n, d) f32 from h, W and the row statistics.  skip, when not null,
// is the (ceil(n/64), ceil(v_orig/64)) byte mask of the tiles to leave out.
int fused_ce_dh_launch(const void* h, const void* w, const void* y,
                       const void* lse, const void* gamma, const void* pc,
                       const void* skip, void* dh, int n, int d, int v_orig,
                       int valid, int col_offset, int has_cap, float cap,
                       float eps, void* stream) {
  const auto launch = skip ? launch_grad_any<false, true>
                           : launch_grad_any<false, false>;
  const int err = launch(h, w, y, lse, gamma, pc, skip, dh, n, d, v_orig,
                         valid, col_offset, has_cap, cap, eps, stream);
  if (err) return err;
  return (int)cudaGetLastError();
}

// dW (v_orig, d) f32 from h, W and the row statistics; skip as for dH
// (read by column).
int fused_ce_dw_launch(const void* h, const void* w, const void* y,
                       const void* lse, const void* gamma, const void* pc,
                       const void* skip, void* dw, int n, int d, int v_orig,
                       int valid, int col_offset, int has_cap, float cap,
                       float eps, void* stream) {
  const auto launch = skip ? launch_grad_any<true, true>
                           : launch_grad_any<true, false>;
  const int err = launch(h, w, y, lse, gamma, pc, skip, dw, n, d, v_orig,
                         valid, col_offset, has_cap, cap, eps, stream);
  if (err) return err;
  return (int)cudaGetLastError();
}

// *count = cudaOccupancyMaxActiveClusters of the exact backward kernel
// (dW when dw, else dH) at cluster size c (1, 4 or 16).  Returns the
// cudaError_t.
int fused_ce_bwd_max_clusters(int dw, int c, int* count) {
  switch (c) {
    case 1:
      return dw ? max_clusters<true, 1>(count) : max_clusters<false, 1>(count);
    case 4:
      return dw ? max_clusters<true, 4>(count) : max_clusters<false, 4>(count);
    case 16:
      return dw ? max_clusters<true, 16>(count)
                : max_clusters<false, 16>(count);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The most streamed 64-row tiles one filtered dH or dW launch takes (its
// live-tile list lives in shared memory beside the exact kernel's); the
// wrapper splits a longer streamed axis into launches of at most this many.
int fused_ce_max_filtered_tiles() { return kBwdMaxFilteredTiles; }

const char* fused_ce_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
