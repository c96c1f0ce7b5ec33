// Fused output projection + cross-entropy for Hopper (sm_90a): the forward
// statistics and the two backward contractions, without the (rows, V)
// logits ever reaching device memory.
//
// Replaces repro/kernels/fused_ce/kernel.py:_fwd_kernel, _dh_kernel and
// _dw_kernel (the exact Pallas TPU kernels).  Same contract:
//   * a column (vocab row of W) is valid iff local < v_orig and
//     local + col_offset < valid; z = h . w (f32 sums of exact bf16
//     products), tanh-softcapped when cap > 0;
//   * forward, per row: lse = m + log a over the valid columns (online
//     softmax, with the m = -inf guard), z_target = z[y] when y is a valid
//     column (else 0), z_sum = sum of the valid z;
//   * backward, per (row, column): g = pc*p - gamma*((1-eps)*onehot +
//     eps/valid), times 1 - (zc/cap)^2 under softcap, 0 off the valid
//     columns and past the rows; dH = g W and dW = g^T H, both f32.
//
// Bound (H100 SXM, 989 TFLOP/s bf16, 3.35 TB/s): at qwen3-0.6b's training
// shape (8192 rows, W 152064 x 1024 bf16) each pass is a 2.55 TFLOP
// product (the forward one; dH and dW two each, recompute and
// contraction), while its bytes are ~0.33 GB: every kernel here is bound
// by operations, so the design keeps all of them on the tensor cores
// (mma.sync m16n8k16, bf16 in, f32 accumulate) and keeps every logit tile
// in registers and shared memory.  No wgmma, TMA or tuned tiles yet.
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
//     in VMEM.  Here a backward block owns 64 rows of its stationary
//     operand (h for dH, W for dW) and a 256-wide range of d, with the
//     sums in registers (16 warps x 16 columns); a second grid axis covers
//     d in 256-wide ranges, each recomputing the logit tile, so any d that
//     is a multiple of 64 works (d = 1024: four ranges, d = 4096: 16);
//   * each 64-row tile of the streamed operand is contracted into a fresh
//     tensor-core accumulator and added to an f32 running sum on the CUDA
//     cores: the tensor cores truncate addends far below the accumulator,
//     and one accumulator holding the target term for the whole vocab
//     cost dH a relative error of 2.9e-4 at V = 152k (H100 80GB HBM3,
//     700 W, chip_smoke.py);
//   * dW is the reference's deterministic two-pass layout: a dH pass over
//     (row blocks x d ranges) streaming the vocab, and a dW pass over
//     (vocab blocks x d ranges) streaming the rows.  No atomics: the sums
//     run in a fixed order and repeat bit for bit.
// Operands stream through a 3-stage cp.async ring of k chunks (32 wide in
// the forward; 128 wide in the backward, whose 64 x 64 recompute tile does
// too little between two barriers at 32: dH took 155 ms at 32 and 107 ms
// at 128 on an H100 80GB HBM3, 700 W, in chip_smoke.py)
// and are read into fragments with ldmatrix (rows padded by 16 bytes
// against bank conflicts).  Rows past the ends load as zeros.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kStages = 3;           // cp.async ring depth
constexpr int kFwdBK = 32;           // k chunk (bf16) of a forward stage
constexpr int kBwdBK = 128;          // k chunk (bf16) of a backward stage

// padded smem row of a BK-wide k chunk: +16 bytes against bank conflicts
__host__ __device__ constexpr int ld_of(int bk) { return bk + 8; }

constexpr int kFwdRows = 128;        // forward tile: rows of h
constexpr int kFwdCols = 128;        //               vocab columns
constexpr int kFwdThreads = 256;     // 8 warps, 2 (rows) x 4 (columns)

constexpr int kBwdRows = 64;         // backward: stationary rows a block
constexpr int kBwdCols = 64;         //           streamed rows a tile
constexpr int kBwdWarps = 16;
constexpr int kBwdThreads = kBwdWarps * 32;
constexpr int kBwdWarpD = 16;          // d columns a warp accumulates
constexpr int kBwdD = kBwdWarps * kBwdWarpD;  // d columns a block owns
constexpr int kGLd = kBwdCols + 8;     // padded row of the g tile
constexpr int kPLd = kBwdD + 8;        // padded row of the streamed panel

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

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
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
// part[(row * n_split + split) * 4 ...].
__global__ void __launch_bounds__(kFwdThreads)
    fce_fwd_partial(const bf16* __restrict__ h, const bf16* __restrict__ w,
                    const int* __restrict__ y, float* __restrict__ part,
                    int n, int d, int v_orig, int valid, int col_offset,
                    int n_split, int tiles_per_split, int has_cap,
                    float cap) {
  constexpr int WM = 2, WN = 4;
  constexpr int MT = kFwdRows / WM / 16;  // 4
  constexpr int NT = kFwdCols / WN / 8;   // 4
  extern __shared__ __align__(16) unsigned char smem[];
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

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

// kDW false (dH): S = h (n rows), T = W (v_orig rows), out = dH (n, d).
// kDW true  (dW): S = W, T = h, out = dW (v_orig, d).
// grid (ceil(S rows / 64), ceil(d / 256)), kBwdThreads threads.  For each
// 64-row tile of T: z = S_blk T_tile^T (recompute over all of d), g from z
// into shared memory as bf16 hi/lo, then acc += g T_tile[:, d range].
template <bool kDW>
__global__ void __launch_bounds__(kBwdThreads, 1)
    fce_grad(const bf16* __restrict__ h, const bf16* __restrict__ w,
             const int* __restrict__ y, const float* __restrict__ lse,
             const float* __restrict__ gamma, const float* __restrict__ pc,
             float* __restrict__ out, int n, int d, int v_orig, int valid,
             int col_offset, int has_cap, float cap, float eps) {
  constexpr int WM = 4, WN = 4;  // recompute layout: 16 x 16 a warp
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sS = reinterpret_cast<bf16*>(smem);
  bf16* sT = sS + kStages * kBwdRows * ld_of(kBwdBK);
  bf16* gHi = sT + kStages * kBwdCols * ld_of(kBwdBK);
  bf16* gLo = gHi + kBwdRows * kGLd;
  bf16* panel = gLo + kBwdRows * kGLd;
  int* sY = reinterpret_cast<int*>(panel + kBwdCols * kPLd);
  float* sL = reinterpret_cast<float*>(sY + 64);
  float* sG = sL + 64;
  float* sP = sG + 64;

  const bf16* S = kDW ? w : h;
  const bf16* T = kDW ? h : w;
  const int s_rows = kDW ? v_orig : n;
  const int t_rows = kDW ? n : v_orig;
  const int s0 = blockIdx.x * kBwdRows;
  const int c0 = blockIdx.y * kBwdD;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wm = warp / WN;
  const int wn = warp % WN;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int col_w = c0 + warp * kBwdWarpD;  // this warp's output columns
  const bool warp_live = col_w < d;         // d % 16 == 0: warp-uniform
  const float one_m_eps = 1.f - eps;
  const float eps_valid = eps / (float)valid;

  // row statistics of the 64 h rows a tile or the block covers
  auto load_stats = [&](int r0) {
    if (tid < 64) {
      const int r = r0 + tid;
      const bool ok = r < n;
      sY[tid] = ok ? y[r] : -1;
      sL[tid] = ok ? lse[r] : 0.f;
      sG[tid] = ok ? gamma[r] : 0.f;
      sP[tid] = ok ? pc[r] : 0.f;
    }
  };
  if (!kDW) load_stats(s0);

  // run: the f32 sum over the tiles so far (CUDA-core adds, rounded to
  // nearest); acc: one tile's sum on the tensor cores, started from zero
  float run[4][2][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) run[mt][nt][i] = 0.f;

  const int n_tiles = (t_rows + kBwdCols - 1) / kBwdCols;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int t0 = tile * kBwdCols;
    __syncthreads();  // the last contraction is done with panel, g, stats
    if (kDW) load_stats(t0);
    // the panel T[t0 .. t0+64, c0 .. c0+256) for the contraction
    for (int i = tid; i < kBwdCols * (kBwdD / 8); i += kBwdThreads) {
      const int r = i / (kBwdD / 8);
      const int seg = i % (kBwdD / 8);
      const int col = c0 + seg * 8;
      const bool ok = t0 + r < t_rows && col < d;
      const bf16* src = T + (size_t)(ok ? t0 + r : 0) * d + (ok ? col : 0);
      cp_async16(panel + r * kPLd + seg * 8, src, ok);
    }
    cp_async_commit();

    float z[1][2][4];
    tile_dot<kBwdRows, kBwdCols, kBwdBK, WM, WN, kBwdThreads>(
        z, S, s0, s_rows, T, t0, t_rows, d, sS, sT);

    // g into shared memory as [S row][T row], hi and lo halves
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int sl = wm * 16 + g + 8 * hh;
        const int tl = wn * 16 + nt * 8 + 2 * t;
        float gv[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int ri = kDW ? tl + j : sl;         // index into the stats
          const int row = kDW ? t0 + tl + j : s0 + sl;
          const int local = kDW ? s0 + sl : t0 + tl + j;
          const bool live = row < n && local < v_orig &&
                            local + col_offset < valid;
          float zc = z[0][nt][2 * hh + j];
          if (has_cap) zc = cap * tanhf(zc / cap);
          const float p = live ? expf(zc - sL[ri]) : 0.f;
          const float onehot = (local + col_offset == sY[ri]) ? 1.f : 0.f;
          float gg = sP[ri] * p - sG[ri] * (one_m_eps * onehot + eps_valid);
          if (has_cap) {
            const float r = zc / cap;
            gg *= 1.f - r * r;
          }
          gv[j] = live ? gg : 0.f;
        }
        const bf16 h0 = __float2bfloat16_rn(gv[0]);
        const bf16 h1 = __float2bfloat16_rn(gv[1]);
        const bf16 l0 = __float2bfloat16_rn(gv[0] - __bfloat162float(h0));
        const bf16 l1 = __float2bfloat16_rn(gv[1] - __bfloat162float(h1));
        *reinterpret_cast<__nv_bfloat162*>(gHi + sl * kGLd + tl) =
            __halves2bfloat162(h0, h1);
        *reinterpret_cast<__nv_bfloat162*>(gLo + sl * kGLd + tl) =
            __halves2bfloat162(l0, l1);
      }
    __syncthreads();

    // acc (64 x this warp's 16 columns) = g (64 x 64) . panel (64 x 16),
    // then run += acc.  The tensor cores align their addends to the
    // largest and truncate, so summing the whole vocab in one accumulator
    // that holds the target term (-gamma W[y], ~2^17 times a softmax term
    // at V = 152k) would cut every later softmax term toward zero: a
    // relative error of a few 1e-4 in dH.  A tile at a time keeps the
    // accumulator near the size of its addends.
    if (warp_live) {
      float acc[4][2][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kBwdCols; kk += 16) {
        uint32_t b[4];
        const int kr = kk + (lane & 7) + ((lane >> 3) & 1) * 8;
        ldsm_x4_t(b, panel + kr * kPLd + warp * kBwdWarpD + (lane >> 4) * 8);
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          uint32_t ah[4], al[4];
          const int row = mt * 16 + (lane & 15);
          const int col = kk + (lane >> 4) * 8;
          ldsm_x4(ah, gHi + row * kGLd + col);
          ldsm_x4(al, gLo + row * kGLd + col);
          mma16816(acc[mt][0], ah, b[0], b[1]);
          mma16816(acc[mt][0], al, b[0], b[1]);
          mma16816(acc[mt][1], ah, b[2], b[3]);
          mma16816(acc[mt][1], al, b[2], b[3]);
        }
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) run[mt][nt][i] += acc[mt][nt][i];
    }
  }

  if (!warp_live) return;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = s0 + mt * 16 + g + 8 * hh;
      if (row >= s_rows) continue;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int col = col_w + nt * 8 + 2 * t;
        *reinterpret_cast<float2*>(out + (size_t)row * d + col) =
            make_float2(run[mt][nt][2 * hh], run[mt][nt][2 * hh + 1]);
      }
    }
}

constexpr size_t kFwdSmem =
    (size_t)kStages * (kFwdRows + kFwdCols) * ld_of(kFwdBK) * sizeof(bf16);
constexpr size_t kBwdSmem =
    (size_t)kStages * (kBwdRows + kBwdCols) * ld_of(kBwdBK) * sizeof(bf16) +
    (size_t)2 * kBwdRows * kGLd * sizeof(bf16) +
    (size_t)kBwdCols * kPLd * sizeof(bf16) + 4 * 64 * sizeof(float);
static_assert(kFwdSmem >= (size_t)4 * kFwdRows * 4 * sizeof(float),
              "the forward reduction reuses the ring");

template <bool kDW>
int launch_grad(const void* h, const void* w, const void* y, const void* lse,
                const void* gamma, const void* pc, void* out, int n, int d,
                int v_orig, int valid, int col_offset, int has_cap, float cap,
                float eps, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      fce_grad<kDW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kBwdSmem);
  if (err != cudaSuccess) return (int)err;
  const int s_rows = kDW ? v_orig : n;
  dim3 grid((s_rows + kBwdRows - 1) / kBwdRows, (d + kBwdD - 1) / kBwdD);
  fce_grad<kDW><<<grid, kBwdThreads, kBwdSmem,
                  reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(h), static_cast<const bf16*>(w),
      static_cast<const int*>(y), static_cast<const float*>(lse),
      static_cast<const float*>(gamma), static_cast<const float*>(pc),
      static_cast<float*>(out), n, d, v_orig, valid, col_offset, has_cap,
      cap, eps);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Forward statistics: part is (n, n_split, 4) f32 scratch; lse, ztgt, zsum
// are (n,) f32.  Returns the cudaError_t of the launches.
int fused_ce_fwd_launch(const void* h, const void* w, const void* y,
                        void* part, void* lse, void* ztgt, void* zsum, int n,
                        int d, int v_orig, int valid, int col_offset,
                        int n_split, int has_cap, float cap, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(
      fce_fwd_partial, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kFwdSmem);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = (v_orig + kFwdCols - 1) / kFwdCols;
  const int per = (n_tiles + n_split - 1) / n_split;
  dim3 grid((n + kFwdRows - 1) / kFwdRows, n_split);
  fce_fwd_partial<<<grid, kFwdThreads, kFwdSmem, s>>>(
      static_cast<const bf16*>(h), static_cast<const bf16*>(w),
      static_cast<const int*>(y), static_cast<float*>(part), n, d, v_orig,
      valid, col_offset, n_split, per, has_cap, cap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fce_fwd_merge<<<(n + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(part), static_cast<float*>(lse),
      static_cast<float*>(ztgt), static_cast<float*>(zsum), n, n_split);
  return (int)cudaGetLastError();
}

// dH (n, d) f32 from h, W and the row statistics.
int fused_ce_dh_launch(const void* h, const void* w, const void* y,
                       const void* lse, const void* gamma, const void* pc,
                       void* dh, int n, int d, int v_orig, int valid,
                       int col_offset, int has_cap, float cap, float eps,
                       void* stream) {
  return launch_grad<false>(h, w, y, lse, gamma, pc, dh, n, d, v_orig, valid,
                            col_offset, has_cap, cap, eps, stream);
}

// dW (v_orig, d) f32 from h, W and the row statistics.
int fused_ce_dw_launch(const void* h, const void* w, const void* y,
                       const void* lse, const void* gamma, const void* pc,
                       void* dw, int n, int d, int v_orig, int valid,
                       int col_offset, int has_cap, float cap, float eps,
                       void* stream) {
  return launch_grad<true>(h, w, y, lse, gamma, pc, dw, n, d, v_orig, valid,
                           col_offset, has_cap, cap, eps, stream);
}

const char* fused_ce_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
