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
// shared memory.  The forward runs on mma.sync m16n8k16 (bf16 in, f32
// accumulate) with cp.async; dH and dW on wgmma with TMA (below).
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
// 168 registers a thread at 384 threads.  d > 4096 is refused.  See
// fce_grad for the pipeline.
//
// Design, and what it does about the TPU kernel's assumptions:
//   * the TPU kernel carries (m, a, z*, sum z) across a SEQUENTIAL vocab
//     grid axis.  Here the vocab is cut into n_split slices across blocks
//     (grid rows x slices); each block runs the online softmax over its
//     slice's 128-column tiles, each thread keeping the state of its own
//     8 rows over its own columns, merged across the quad and the warps
//     at the end, and a second kernel merges the (rows, n_split, 4)
//     partials in a fixed order.  So a few hundred rows still fill the SMs;
//   * g is formed in f32, as the TPU kernel forms it, and contracted as two
//     bf16 halves (g = hi + lo, both rounded to nearest), two products on
//     the tensor cores: |g - hi - lo| <= 2^-17 |g|, well inside the
//     reference's rtol 3e-4 (a single bf16 g would cost 2^-9 a term);
//   * the Pallas kernels hold a full-d (bm, d) / (bv, d) f32 accumulator
//     in VMEM.  Here the cluster spreads d over its CTAs, 256 columns
//     each, and each contraction warpgroup keeps a 64 x 128 running sum in
//     registers;
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
//     A forward tile (128 x 128, warps 2 x 4 of 64 x 32) holds four grid
//     tiles whole, each the max of two warps: reduced in registers and
//     the warp, combined through shared memory, written once, with no
//     cross-block merge.  A filtered backward CTA first compacts its mask
//     row or column into an ascending list of live tiles in shared
//     memory (warp ballots), then walks only that list: a skipped tile
//     costs neither its bytes nor its recompute, and an all-False mask
//     walks 0..n-1 in the exact kernel's order, bit for bit.  Live
//     tiles are uneven across clusters (target tiles pin some): no load
//     balancing yet.
// The forward streams its operands through a 3-stage cp.async ring of
// 32-wide k chunks and reads them into fragments with ldmatrix (rows
// padded by 16 bytes against bank conflicts).  Rows past the ends load as
// zeros.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kStages = 3;           // cp.async ring depth (forward)
constexpr int kFwdBK = 32;           // k chunk (bf16) of a forward stage

// padded smem row of a BK-wide k chunk: +16 bytes against bank conflicts
__host__ __device__ constexpr int ld_of(int bk) { return bk + 8; }

constexpr int kFwdRows = 128;        // forward tile: rows of h
constexpr int kFwdCols = 128;        //               vocab columns
constexpr int kFwdThreads = 256;     // 8 warps, 2 (rows) x 4 (columns)

// the backward's (and the filter's) tile grid
constexpr int kBwdRows = 64;         // stationary rows a cluster
constexpr int kBwdCols = 64;         // streamed rows a tile

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; `pred` false fills zeros (src-size 0, no read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c (16x8, f32) += a (16x16 bf16, row) * b (16x8 bf16, col)
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Merge the online-softmax state (om, oa) into (m, a).
__device__ __forceinline__ void merge_state(float& m, float& a, float om,
                                            float oa) {
  const float mn = fmaxf(m, om);
  const float safe = (mn == -INFINITY) ? 0.f : mn;
  a = a * expf(m - safe) + oa * expf(om - safe);
  m = mn;
}

// acc (warp tile of the BS x BT block) = S[s0 .. s0+BS) . T[t0 .. t0+BT)^T
// over all of d.  S and T are row-major (rows, d) bf16; rows past s_rows /
// t_rows read as zeros.  The warps form a WM x WN grid; warp (wm, wn) owns
// rows wm*(BS/WM) + [0, BS/WM) and columns wn*(BT/WN) + [0, BT/WN), in
// m16n8 fragments acc[mt][nt].  Every committed cp.async group of the
// caller completes before the first product; on return all groups are
// complete and the ring may be reused.
template <int BS, int BT, int BK, int WM, int WN, int NTHREADS>
__device__ __forceinline__ void tile_dot(
    float (&acc)[BS / WM / 16][BT / WN / 8][4], const bf16* __restrict__ S,
    int s0, int s_rows, const bf16* __restrict__ T, int t0, int t_rows,
    int d, bf16* sS, bf16* sT) {
  constexpr int MT = BS / WM / 16;
  constexpr int NT = BT / WN / 8;
  static_assert(NT % 2 == 0, "B fragments load two n-tiles at a time");
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wm = warp / WN;
  const int wn = warp % WN;

#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

  constexpr int LD = ld_of(BK);
  constexpr int SEGS = BK / 8;          // 16-byte segments of a chunk row
  const int nk = (d + BK - 1) / BK;      // a last partial chunk reads zeros
  auto load = [&](int stage, int kc) {
    const int k0 = kc * BK;
    for (int i = tid; i < BS * SEGS; i += NTHREADS) {
      const int r = i / SEGS, k = k0 + (i % SEGS) * 8;
      const bool ok = s0 + r < s_rows && k < d;
      const bf16* src = S + (ok ? (size_t)(s0 + r) * d + k : 0);
      cp_async16(sS + (stage * BS + r) * LD + (i % SEGS) * 8, src, ok);
    }
    for (int i = tid; i < BT * SEGS; i += NTHREADS) {
      const int r = i / SEGS, k = k0 + (i % SEGS) * 8;
      const bool ok = t0 + r < t_rows && k < d;
      const bf16* src = T + (ok ? (size_t)(t0 + r) * d + k : 0);
      cp_async16(sT + (stage * BT + r) * LD + (i % SEGS) * 8, src, ok);
    }
  };

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < nk) load(st, st);
    cp_async_commit();
  }
  for (int kc = 0; kc < nk; ++kc) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int nxt = kc + kStages - 1;
    if (nxt < nk) load(nxt % kStages, nxt);
    cp_async_commit();
    const bf16* a_base = sS + (kc % kStages) * BS * LD;
    const bf16* b_base = sT + (kc % kStages) * BT * LD;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int row = wm * (BS / WM) + mt * 16 + (lane & 15);
        ldsm_x4(a[mt], a_base + row * LD + kk + (lane >> 4) * 8);
      }
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t b[4];
        const int n = wn * (BT / WN) + np * 16 + (lane & 7) + (lane >> 4) * 8;
        ldsm_x4(b, b_base + n * LD + kk + ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma16816(acc[mt][2 * np], a[mt], b[0], b[1]);
          mma16816(acc[mt][2 * np + 1], a[mt], b[2], b[3]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

// grid (ceil(n / 128), n_split), kFwdThreads threads.  Writes the partial
// state (m, a, z_target, z_sum) of every row over its vocab slice to
// part[(row * n_split + split) * 4 ...].  kStats: also the tile statistic
// tmax (num_r, num_v) of the 64 x 64 grid, every entry written by the one
// block that owns it; the other outputs are computed the same way.
template <bool kStats>
__global__ void __launch_bounds__(kFwdThreads)
    fce_fwd_partial(const bf16* __restrict__ h, const bf16* __restrict__ w,
                    const int* __restrict__ y, float* __restrict__ part,
                    int n, int d, int v_orig, int valid, int col_offset,
                    int n_split, int tiles_per_split, int has_cap,
                    float cap, int ignore_index, float* __restrict__ tmax) {
  constexpr int WM = 2, WN = 4;
  constexpr int MT = kFwdRows / WM / 16;  // 4
  constexpr int NT = kFwdCols / WN / 8;   // 4
  static_assert(kFwdRows / WM == kBwdRows && 2 * kFwdCols / WN == kBwdCols,
                "a warp pair covers one tile of the filter's grid");
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float sTq[WM * WN];          // per-warp tile maxima
  bf16* sS = reinterpret_cast<bf16*>(smem);
  bf16* sT = sS + kStages * kFwdRows * ld_of(kFwdBK);

  const int r0 = blockIdx.x * kFwdRows;
  const int split = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wm = warp / WN;
  const int wn = warp % WN;
  const int g = lane >> 2;
  const int t = lane & 3;

  // this thread's rows: wm*64 + mt*16 + g + 8*hh
  float m[MT][2], a[MT][2], zt[MT][2], zs[MT][2];
  int yv[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = r0 + wm * 64 + mt * 16 + g + 8 * hh;
      m[mt][hh] = -INFINITY;
      a[mt][hh] = 0.f;
      zt[mt][hh] = 0.f;
      zs[mt][hh] = 0.f;
      yv[mt][hh] = row < n ? y[row] : -1;
    }

  const int n_tiles = (v_orig + kFwdCols - 1) / kFwdCols;
  const int tile_end = min((split + 1) * tiles_per_split, n_tiles);
  for (int tile = split * tiles_per_split; tile < tile_end; ++tile) {
    const int c0 = tile * kFwdCols;
    float acc[MT][NT][4];
    tile_dot<kFwdRows, kFwdCols, kFwdBK, WM, WN, kFwdThreads>(
        acc, h, r0, n, w, c0, v_orig, d, sS, sT);
    float tq = -INFINITY;   // this thread's max over its live rows
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float z[NT * 2];
        float lmax = -INFINITY;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int local = c0 + wn * 32 + nt * 8 + 2 * t + j;
            float zv = acc[mt][nt][2 * hh + j];
            if (has_cap) zv = cap * tanhf(zv / cap);
            const bool live = local < v_orig && local + col_offset < valid;
            if (live) {
              zs[mt][hh] += zv;
              if (local + col_offset == yv[mt][hh]) zt[mt][hh] += zv;
            } else {
              zv = -INFINITY;
            }
            z[nt * 2 + j] = zv;
            lmax = fmaxf(lmax, zv);
          }
        const float m_new = fmaxf(m[mt][hh], lmax);
        const float safe = (m_new == -INFINITY) ? 0.f : m_new;
        float sum = 0.f;
#pragma unroll
        for (int i = 0; i < NT * 2; ++i) sum += expf(z[i] - safe);
        a[mt][hh] = a[mt][hh] * expf(m[mt][hh] - safe) + sum;
        m[mt][hh] = m_new;
        if (kStats) {
          const int row = r0 + wm * 64 + mt * 16 + g + 8 * hh;
          if (row < n && yv[mt][hh] != ignore_index) tq = fmaxf(tq, lmax);
        }
      }
    if (kStats) {
      // warp (wm, wn) covers grid tile (2 * blockIdx.x + wm, 2 * tile +
      // wn / 2); its partner is wn ^ 1
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        tq = fmaxf(tq, __shfl_xor_sync(0xffffffffu, tq, off));
      if (lane == 0) sTq[warp] = tq;
      __syncthreads();
      if (tid < WM * 2) {
        const int qr = tid >> 1, qc = tid & 1;
        const int rt = blockIdx.x * WM + qr, ct = tile * 2 + qc;
        const int num_r = (n + kBwdRows - 1) / kBwdRows;
        const int num_v = (v_orig + kBwdCols - 1) / kBwdCols;
        if (rt < num_r && ct < num_v)
          tmax[(size_t)rt * num_v + ct] =
              fmaxf(sTq[qr * WN + 2 * qc], sTq[qr * WN + 2 * qc + 1]);
      }
      // the next tile's tile_dot passes a barrier before sTq is rewritten
    }
  }

  // merge the quad (the 4 lanes that share rows), then the 4 column warps
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        const float om = __shfl_xor_sync(0xffffffffu, m[mt][hh], off);
        const float oa = __shfl_xor_sync(0xffffffffu, a[mt][hh], off);
        zt[mt][hh] += __shfl_xor_sync(0xffffffffu, zt[mt][hh], off);
        zs[mt][hh] += __shfl_xor_sync(0xffffffffu, zs[mt][hh], off);
        merge_state(m[mt][hh], a[mt][hh], om, oa);
      }
  // the ring is idle (tile_dot ended with a barrier): reuse it
  float* red = reinterpret_cast<float*>(smem);  // [WN][kFwdRows][4]
  if (t == 0) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float* p = red + ((size_t)wn * kFwdRows + wm * 64 + mt * 16 + g +
                          8 * hh) * 4;
        p[0] = m[mt][hh];
        p[1] = a[mt][hh];
        p[2] = zt[mt][hh];
        p[3] = zs[mt][hh];
      }
  }
  __syncthreads();
  if (tid < kFwdRows && r0 + tid < n) {
    float mm = -INFINITY, aa = 0.f, tt = 0.f, ss = 0.f;
#pragma unroll
    for (int c = 0; c < WN; ++c) {
      const float* p = red + ((size_t)c * kFwdRows + tid) * 4;
      merge_state(mm, aa, p[0], p[1]);
      tt += p[2];
      ss += p[3];
    }
    float* out = part + ((size_t)(r0 + tid) * n_split + split) * 4;
    out[0] = mm;
    out[1] = aa;
    out[2] = tt;
    out[3] = ss;
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

constexpr size_t kFwdSmem =
    (size_t)kStages * (kFwdRows + kFwdCols) * ld_of(kFwdBK) * sizeof(bf16);
static_assert(kFwdSmem >= (size_t)4 * kFwdRows * 4 * sizeof(float),
              "the forward reduction reuses the ring");
constexpr size_t kSmemMax = 232448;   // H100: dynamic smem a block can use

// ---------------------------------------------------------------------------
// backward: dH and dW, a thread-block cluster along d, on wgmma
// ---------------------------------------------------------------------------

constexpr int kRange = 256;              // d columns a CTA
constexpr int kBox = 64;                 // d columns a TMA box (128 bytes)
constexpr int kBoxes = kRange / kBox;
constexpr int kBwdStages = 3;            // streamed slices in flight
constexpr int kContract = 256;           // warpgroups 0-1: the contraction
constexpr int kBwdThreads = kContract + 128;  // + warpgroup 2: the logits
constexpr int kBwdWarps = kBwdThreads / 32;
constexpr int kPartLd = kBwdCols + 4;    // padded f32 row of a partial
constexpr uint32_t kSBytes = kBwdRows * kRange * 2;  // stationary, 32 KB
constexpr uint32_t kTBytes = kBwdCols * kRange * 2;  // a streamed slice
constexpr uint32_t kGBytes = kBwdRows * kBwdCols * 2;  // 8 KB
// row statistics y, lse, gamma, pc of 64 rows: one slot a ring stage
constexpr uint32_t kStatBytes = 4 * kBwdCols * 4;
// shared memory, from a 1024-byte aligned base
constexpr size_t kOffS = 0;
constexpr size_t kOffT = kOffS + kSBytes;
constexpr size_t kOffG = kOffT + (size_t)kBwdStages * kTBytes;
// the CTA's partial logits (staging for its bulk copies), then two receive
// buffers of C row slices; each is 64 padded rows of f32
constexpr size_t kOffPart = kOffG + 4 * kGBytes;  // g hi, lo x 2 buffers
constexpr size_t kPartBytes = kBwdRows * kPartLd * 4;
constexpr size_t kOffStats = kOffPart + 3 * kPartBytes;
constexpr size_t kOffBar = kOffStats + (size_t)kBwdStages * kStatBytes;
constexpr int kBwdBars = kBwdStages + 1 + 2 + 2 + 2;
constexpr size_t kOffCnt = kOffBar + kBwdBars * 8;
constexpr size_t kOffList = kOffCnt + kBwdWarps * 4;
constexpr size_t kBwdSmem = 1024 + kOffList;  // + the filtered tile list
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
// logit tile is z[S row, T row] either way.  grid (C, ceil(S rows / 64))
// in clusters of (C, 1, 1), C in {1, 4, 16} covering ceil(d / 256) ranges
// of 256 columns (a range past d reads zeros and writes nothing),
// kBwdThreads threads, kBwdSmem bytes (+ 2 a streamed tile when filtered).
// CTA `rank` owns d columns [256 rank, 256 rank + 256) of the cluster's 64
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
template <bool kDW, int kC, bool kFiltered>
__global__ void __launch_bounds__(kBwdThreads, 1)
    fce_grad(const __grid_constant__ CUtensorMap smap,
             const __grid_constant__ CUtensorMap tmap,
             const int* __restrict__ y, const float* __restrict__ lse,
             const float* __restrict__ gamma, const float* __restrict__ pc,
             const uint8_t* __restrict__ skip, float* __restrict__ out, int n,
             int d, int v_orig, int valid, int col_offset, int has_cap,
             float cap, float eps) {
  using namespace hopper;
  constexpr int R = kBwdRows / kC;       // rows of a tile this CTA owns
  constexpr uint32_t kGSlice = R * 128;  // bytes of a g slice (hi or lo)
  extern __shared__ unsigned char bwd_smem_raw[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(bwd_smem_raw) + 1023) & ~uintptr_t(1023));
  bf16* ss = reinterpret_cast<bf16*>(sm + kOffS);
  bf16* ts = reinterpret_cast<bf16*>(sm + kOffT);
  unsigned char* gt = sm + kOffG;  // g[b]: hi at 2 b, lo at 2 b + 1 tiles
  float* stage = reinterpret_cast<float*>(sm + kOffPart);
  float* recv = stage + kBwdRows * kPartLd;  // [2][C][R][kPartLd]
  // slot k: y[64], then lse, gamma, pc (f32); dH uses slot 0 only
  auto stat_slot = [&](int k) {
    return reinterpret_cast<int*>(sm + kOffStats + k * kStatBytes);
  };
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + kOffBar);
  uint64_t* sbar = full + kBwdStages;
  uint64_t* pfull = sbar + 1;
  uint64_t* gfull = pfull + 2;
  uint64_t* gfree = gfull + 2;
  int* sCnt = reinterpret_cast<int*>(sm + kOffCnt);
  uint16_t* sList = reinterpret_cast<uint16_t*>(sm + kOffList);

  const int s_rows = kDW ? v_orig : n;
  const int t_rows = kDW ? n : v_orig;
  const int rank = blockIdx.x;          // the cluster spans gridDim.x
  const int c0 = rank * kRange;
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
    for (int s = 0; s < kBwdStages; ++s)
      mbar_init(&full[s], kDW ? 1 + kBwdCols : 1);
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

  // T[tile of the li-th live tile, d range] into slice li % 3 (thread 0);
  // dW: the statistics of its 64 rows into slot li % 3 (threads 0-63)
  auto load_t = [&](int li) {
    const int s = li % kBwdStages;
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
    for (int li = 0; li < kBwdStages && li < n_live; ++li) load_t(li);
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
        const int* sY = stat_slot(kDW ? li % kBwdStages : 0);
        const float* sL = reinterpret_cast<const float*>(sY + kBwdRows);
        if (kDW) mbar_wait(&full[li % kBwdStages], (li / kBwdStages) & 1);
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
      const int s = li % kBwdStages;
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
      if (li + kBwdStages < n_live) load_t(li + kBwdStages);
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
  // L then P: the partial logits of the li-th live tile, staged, then each
  // CTA's row slice bulk-copied into its receive buffer li % 2 (completing
  // its pfull), once every CTA has consumed that buffer's tile li - 2: each
  // sent its g of tile li - 2 after, so this CTA's gfull of it says so.
  // Lane c serves CTA rank + c.
  for (int li = 0; li < n_live; ++li) {
    const int s = li % kBwdStages;
    mbar_wait(&full[s], (li / kBwdStages) & 1);
    const bf16* tsl = ts + (size_t)s * kBwdCols * kRange;
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

// the launch configuration of fce_grad<kDW, kC, kFiltered>, with its
// attributes set: grid (C, ceil(S rows / 64)) in clusters of C
template <bool kDW, int kC, bool kFiltered>
cudaError_t grad_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute* attr,
                        int s_rows, size_t smem, cudaStream_t stream) {
  const auto kern = fce_grad<kDW, kC, kFiltered>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  if (kC > 8) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  cfg = {};
  cfg.gridDim = dim3(kC, (s_rows + kBwdRows - 1) / kBwdRows, 1);
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

template <bool kDW, int kC, bool kFiltered>
int launch_grad(const CUtensorMap& smap, const CUtensorMap& tmap,
                const void* y, const void* lse, const void* gamma,
                const void* pc, const void* skip, void* out, int n, int d,
                int v_orig, int valid, int col_offset, int has_cap,
                float cap, float eps, size_t smem, cudaStream_t stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t err = grad_config<kDW, kC, kFiltered>(
      cfg, attr, kDW ? v_orig : n, smem, stream);
  if (err != cudaSuccess) return (int)err;
  const auto kern = fce_grad<kDW, kC, kFiltered>;
  err = cudaLaunchKernelEx(
      &cfg, kern, smap, tmap,
      static_cast<const int*>(y), static_cast<const float*>(lse),
      static_cast<const float*>(gamma), static_cast<const float*>(pc),
      static_cast<const uint8_t*>(skip), static_cast<float*>(out), n, d,
      v_orig, valid, col_offset, has_cap, cap, eps);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// the cluster size of d: 1, 4 or 16 ranges of 256 columns
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
  if (d % kBox || d > 16 * kRange ||
      (kFiltered && n_tiles > kBwdMaxFilteredTiles))
    return (int)cudaErrorInvalidValue;
  CUtensorMap smap, tmap;
  int e = hopper::make_tmap_bf16(&smap, kDW ? w : h, s_rows, d, kBwdRows);
  if (e) return e;
  e = hopper::make_tmap_bf16(&tmap, kDW ? h : w, t_rows, d, kBwdCols);
  if (e) return e;
  const size_t smem =
      kBwdSmem + (kFiltered ? (size_t)n_tiles * sizeof(uint16_t) : 0);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  switch (grad_cluster(d)) {
    case 1:
      return launch_grad<kDW, 1, kFiltered>(
          smap, tmap, y, lse, gamma, pc, skip, out, n, d, v_orig, valid,
          col_offset, has_cap, cap, eps, smem, s);
    case 4:
      return launch_grad<kDW, 4, kFiltered>(
          smap, tmap, y, lse, gamma, pc, skip, out, n, d, v_orig, valid,
          col_offset, has_cap, cap, eps, smem, s);
    default:
      return launch_grad<kDW, 16, kFiltered>(
          smap, tmap, y, lse, gamma, pc, skip, out, n, d, v_orig, valid,
          col_offset, has_cap, cap, eps, smem, s);
  }
}

template <bool kDW, int kC>
int max_clusters(int* count) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t err = grad_config<kDW, kC, false>(cfg, attr, 1024 * kBwdRows,
                                                kBwdSmem, 0);
  if (err != cudaSuccess) return (int)err;
  const auto kern = fce_grad<kDW, kC, false>;
  return (int)cudaOccupancyMaxActiveClusters(count, kern, &cfg);
}

}  // namespace

extern "C" {

// Forward statistics: part is (n, n_split, 4) f32 scratch; lse, ztgt, zsum
// are (n,) f32.  tmax, when not null, receives the (ceil(n/64),
// ceil(v_orig/64)) f32 tile statistic over the rows whose y is not
// ignore_index.  Returns the cudaError_t of the launches.
int fused_ce_fwd_launch(const void* h, const void* w, const void* y,
                        void* part, void* lse, void* ztgt, void* zsum, int n,
                        int d, int v_orig, int valid, int col_offset,
                        int n_split, int has_cap, float cap, int ignore_index,
                        void* tmax, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const auto kern = tmax ? fce_fwd_partial<true> : fce_fwd_partial<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kFwdSmem);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = (v_orig + kFwdCols - 1) / kFwdCols;
  const int per = (n_tiles + n_split - 1) / n_split;
  dim3 grid((n + kFwdRows - 1) / kFwdRows, n_split);
  kern<<<grid, kFwdThreads, kFwdSmem, s>>>(
      static_cast<const bf16*>(h), static_cast<const bf16*>(w),
      static_cast<const int*>(y), static_cast<float*>(part), n, d, v_orig,
      valid, col_offset, n_split, per, has_cap, cap, ignore_index,
      static_cast<float*>(tmax));
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
  return launch(h, w, y, lse, gamma, pc, skip, dh, n, d, v_orig, valid,
                col_offset, has_cap, cap, eps, stream);
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
  return launch(h, w, y, lse, gamma, pc, skip, dw, n, d, v_orig, valid,
                col_offset, has_cap, cap, eps, stream);
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

const char* fused_ce_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
