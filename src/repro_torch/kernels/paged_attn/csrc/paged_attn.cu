// Paged decode attention over a block-pool KV cache for Hopper (sm_90a).
//
// Replaces repro/kernels/paged_attn/kernel.py:_paged_kernel (the Pallas
// TPU kernel behind pallas_paged_attention).  Same contract: q (B, Tq, nq,
// hd) bf16 attends over each row's block chain -- kp/vp (N, bs, nkv, hd)
// bf16 pools, table (B, nb) int32 chain rows, lens (B,) int32 lengths
// AFTER the Tq appends.  Query i of a row sits at lens - Tq + i and sees
// keys at absolute positions <= its own.  Scores are q.k in f32 times
// 1/sqrt(hd), with the optional tanh softcap; the softmax is an f32 online
// softmax whose p stays in f32 for the p @ v sum; the output is
// acc / max(a, 1e-30) rounded to bf16.  Rows with lens == 0 give zeros.
// GQA: the g = nq / nkv query heads of one KV head share its pages.
//
// Bound (H100 SXM, 3.35 TB/s): the kernel must read each row's live K/V
// entries once, plus q, and write the output.  At the serving cell's
// decode shape (B 8, nkv 8, hd 128, bs 16) a full 512-token chain is
// 8 * 512 * 8 * 128 * 2 B * 2 = 16.8 MB a layer, ~5.0 us; the products
// (2 + 2 flops per key, query row and head dim) are far below the
// tensor-core line, so it is memory-bound -- and at the cell's ~260-token
// rows (~2.2 us) bound by the latency of a launch and of one dependent
// chain of loads (lens, the table, the pages).
//
// Design: what bounds it is bytes in flight and latency, so the work of a
// (row, KV head) is spread over as many SMs as it takes to fill the card,
// and the arithmetic goes to the tensor cores so that it stays small
// beside the loads whatever g * Tq is:
//   * split chain (flash-decoding): the grid is (B, nkv, splits); split s
//     of a (row, head) owns pages [s pps, (s + 1) pps) of its table row,
//     pps chosen from B * nkv, the table width and the 132 SMs (`plan`:
//     ~2 CTAs an SM at the decode shape, 4 splits of 8 pages).  A split
//     past ceil(lens / bs) pages returns at once: it reads nothing.  The
//     TPU kernel's scalar-prefetch index maps and sequential chain axis
//     have no counterpart here: a CTA reads its own table entries, clamped
//     into the pool as JAX's gathers do, and never touches a page past the
//     chain (null block 0);
//   * latency: before it reads the row's length, a CTA stages q by
//     cp.async and prefetches its split's table entries into L1, so the
//     chain of dependent loads is lens -> K/V.  K and V then stream
//     through a 2-stage cp.async ring of kt-key tiles (kt 64, halved while
//     shared memory runs out; a tile may straddle pages and ends at the
//     split's last live key, the rest zero-filled and masked), both stages
//     issued at once, one 16-byte copy per 8 values;
//   * scores and p @ v on mma.sync m16n8k16 (bf16 in, f32 accumulate): the
//     g * Tq query rows of the KV head are m16 tiles, zero-padded, and hd
//     is zero-padded to a multiple of 16 in shared memory.  S = q k^T (A
//     from q, B from the K tile by ldmatrix) lands in shared memory; 8
//     lanes a row update (m, a) by online softmax and write p in place as
//     two bf16 halves, p = hi + lo (|p - hi - lo| <= 2^-17 |p|, as the
//     fused-CE backward contracts g); then acc = acc * alpha + hi @ v + lo
//     @ v (B from the V tile by ldmatrix.trans), acc in shared memory, each
//     entry owned by one thread.  So Tq 5 costs about what Tq 1 costs:
//     both are one m16 tile;
//   * merge: a (row, head) with one live split writes its output directly.
//     Otherwise each split writes its partial (m, a, acc) in f32, and the
//     last split to finish (a counter a (row, head) in global memory,
//     reset by that CTA) merges the partials in split order: one launch,
//     no order-dependent sums, so two calls give the same bits.  (The
//     splits of a (row, head) as one thread-block cluster, merging
//     through distributed shared memory, was tried and ran slower.)
//
// int8 pools (the JAX kernel's kp_scale / vp_scale): kp/vp hold int8 values
// and kps/vps (N, bs, nkv, 1) f32 scales a (token, KV head), reached
// through the same table entries as the pages.  The cp.async ring stages
// the int8 rows (half the bytes) and each key's two scales; once a tile
// has landed, K becomes bf16(float(k) * ks[token]) -- the reference's
// (k.astype(f32) * ks).astype(q.dtype), bit for bit -- and V becomes
// bf16(v), which is exact, in a one-stage bf16 tile that feeds the same
// mma path.  The reference forms p @ (v * vs) in f32; here vs[token]
// folds into p before the hi + lo split (p' = p * vs, f32), so that the
// product with the exact bf16(v) keeps p's 2^-17 split error.  The row
// sum a takes the unscaled p.  Nothing dequantized reaches global memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 2;             // cp.async ring depth (tiles)
constexpr int kTileKeys = 64;          // keys a tile, at most
constexpr int kMinTileKeys = 16;       // one mma k step
constexpr int kSlots = 2 * 132;        // CTAs the card holds at once
constexpr int kMaxSmem = 232448;       // 227 KB a block on the H100

__host__ __device__ constexpr int round16(int x) { return (x + 15) & ~15; }

// Shared memory of a CTA with tiles of kt keys, head dim hd and `rows`
// query rows: the K and V rings (bf16), q, the scores (then p as bf16 hi /
// lo), acc, and m, a, alpha, then a flag.  With int8 pools (`quant`) the
// bf16 K and V tiles take one stage (the converted tile), beside the int8
// rings (rows hdp + 16 bytes) and the rings of each key's K and V scale.
__host__ __device__ inline int smem_bytes(int kt, int hd, int rows,
                                          int quant) {
  const int hdp = round16(hd), rp = round16(rows);
  const int ldk = hdp + 8;
  const int bf16_stages = quant ? 1 : kStages;
  const int q8 = quant ? 2 * kStages * kt * (hdp + 16) + 2 * kStages * kt * 4
                       : 0;
  return 2 * bf16_stages * kt * ldk * 2 + q8 + rp * ldk * 2 +
         rp * (kt + 4) * 4 + rp * (hdp + 4) * 4 + 3 * rp * 4 + 16;
}

struct Plan {
  int kt, pps, splits, smem;
};

// Pages a split by the kernel's own rule for tiles of kt keys: such that
// ~kSlots CTAs cover the table, a split's keys a multiple of the tile.
inline int own_pps(int b, int nkv, int nb, int bs, int kt) {
  const int pairs = b * nkv;
  const int want = pairs >= kSlots ? 1 : (kSlots + pairs - 1) / pairs;
  const int pages = (nb + want - 1) / want;
  const int keys = (pages * bs + kt - 1) / kt * kt;
  return (keys + bs - 1) / bs;
}

// The launch plan: the widest tile (64, 32 or 16 keys) whose shared memory
// fits, and own_pps pages a split.  A launch plan's overrides replace
// them where > 0: `kt` keys a tile (64, 32 or 16) and `pps` pages a split
// (the JAX kernel's pages_per_step); plan_ok says which the kernel takes.
inline Plan plan(int b, int nkv, int nb, int bs, int hd, int rows, int quant,
                 int pps = 0, int kt = 0) {
  Plan p;
  if (kt > 0) {
    p.kt = kt;
  } else {
    p.kt = kTileKeys;
    while (p.kt > kMinTileKeys &&
           smem_bytes(p.kt, hd, rows, quant) > kMaxSmem)
      p.kt /= 2;
  }
  p.smem = smem_bytes(p.kt, hd, rows, quant);
  p.pps = pps > 0 ? pps : own_pps(b, nkv, nb, bs, p.kt);
  p.splits = (nb + p.pps - 1) / p.pps;
  return p;
}

// Whether the kernel takes the overrides (pps, kt; 0 keeps its own): kt
// one of 64, 32, 16 whose shared memory fits, and a split's keys a
// multiple of the tile -- unless one split covers the table or pps is the
// own rule's for that tile.
inline bool plan_ok(int b, int nkv, int nb, int bs, int hd, int rows,
                    int quant, int pps, int kt) {
  if (pps < 0 || kt < 0) return false;
  if (kt && kt != 64 && kt != 32 && kt != 16) return false;
  const Plan p = plan(b, nkv, nb, bs, hd, rows, quant, pps, kt);
  if (p.smem > kMaxSmem) return false;
  return pps == 0 || pps >= nb || pps * bs % p.kt == 0 ||
         pps == own_pps(b, nkv, nb, bs, p.kt);
}

// 16-byte async copy; `pred` false fills zeros (src-size 0, no read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   hopper::smem_u32(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}

// 4-byte async copy (a scale); `pred` false fills zeros.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   hopper::smem_u32(dst)),
               "l"(src), "r"(pred ? 4 : 0));
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
      : "r"(hopper::smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(hopper::smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(hopper::smem_u32(p)));
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

// grid (B, nkv, splits), kThreads threads, smem_bytes(kt, hd, g * tq,
// kQ).  Query row r of a CTA is (gi, ti) = (r / tq, r % tq): head n * g +
// gi, position lens[b] - tq + ti.  part holds (B, nkv, splits) partials of
// rows * (hd + 2) f32 (m, a, then acc), counts (B, nkv) zeros.  kQ: kp/vp
// are int8 pools and kps/vps their f32 scale pools.
template <bool kQ>
__global__ void __launch_bounds__(kThreads)
paged_attn_kernel(const bf16* __restrict__ q, const void* __restrict__ kpv,
                  const void* __restrict__ vpv, const float* __restrict__ kps,
                  const float* __restrict__ vps, const int* __restrict__ table,
                  const int* __restrict__ lens, bf16* __restrict__ out,
                  float* __restrict__ part, int* __restrict__ counts,
                  int n_pool, int bs, int nkv, int hd, int nb, int tq, int g,
                  int kt, int pps, int splits, float scale, int has_softcap,
                  float softcap) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x;
  const int n = blockIdx.y;
  const int split = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gq = lane >> 2, tq4 = lane & 3;   // mma fragment coordinates
  const int rows = g * tq;
  const int rp = round16(rows);
  const int hdp = round16(hd);
  const int ldk = hdp + 8;                    // bf16, +16 B: no conflicts
  const int lds = kt + 4;                     // f32 scores of a row
  const int ldo = hdp + 4;
  const int nq = nkv * g;
  constexpr int kBufStages = kQ ? 1 : kStages;  // bf16 K / V tiles
  const int ldq = hdp + 16;                   // int8 ring row, bytes

  bf16* kbuf = reinterpret_cast<bf16*>(smem);
  bf16* vbuf = kbuf + kBufStages * kt * ldk;
  int8_t* kq8 = reinterpret_cast<int8_t*>(vbuf + kBufStages * kt * ldk);
  int8_t* vq8 = kq8 + (kQ ? kStages * kt * ldq : 0);
  float* ksc = reinterpret_cast<float*>(vq8 + (kQ ? kStages * kt * ldq : 0));
  float* vsc = ksc + (kQ ? kStages * kt : 0);
  bf16* qs = reinterpret_cast<bf16*>(vsc + (kQ ? kStages * kt : 0));
  const bf16* kp = static_cast<const bf16*>(kpv);
  const bf16* vp = static_cast<const bf16*>(vpv);
  const int8_t* kp8 = static_cast<const int8_t*>(kpv);
  const int8_t* vp8 = static_cast<const int8_t*>(vpv);
  float* sc = reinterpret_cast<float*>(qs + rp * ldk);
  float* acc = sc + rp * lds;
  float* m = acc + rp * ldo;
  float* a = m + rp;
  float* alpha = a + rp;
  int* flag = reinterpret_cast<int*>(alpha + rp);

  // Before the length is known: bring this split's table entries into L1
  // and stage q (rows and columns past the ends as zeros), so that the
  // chain of dependent loads is lens -> K/V and nothing longer.
  const int* trow = table + (size_t)b * nb + (size_t)split * pps;
  for (int p = tid * 32; p < min(pps, nb - split * pps); p += kThreads * 32)
    asm volatile("prefetch.global.L1 [%0];\n" ::"l"(trow + p));
  for (int e = tid; e < rp * (hdp / 8); e += kThreads) {
    const int r = e / (hdp / 8), c = (e - r * (hdp / 8)) * 8;
    const bool ok = r < rows && c < hd;
    const int gi = r / tq, ti = r - (r / tq) * tq;
    cp_async16(qs + r * ldk + c,
               q + (ok ? (((size_t)b * tq + ti) * nq + n * g + gi) * hd + c
                       : 0),
               ok);
  }
  cp_async_commit();
  const int len = lens[b];
  const int npages = len <= 0 ? 0 : min((len + bs - 1) / bs, nb);
  const int live = max(1, (npages + pps - 1) / pps);
  if (split >= live) {                        // past the chain: no K/V
    cp_async_wait<0>();
    return;
  }

  // this split's keys [k0, k1): absolute positions in the chain
  const int k0 = split * pps * bs;
  const int k1 = min(min((split + 1) * pps, npages) * bs, len);
  const int ntiles = k1 > k0 ? (k1 - k0 + kt - 1) / kt : 0;
  const int chunks = hd / 8;                  // 16-byte pieces of a row

  auto load_tile = [&](int tile, int stage) {
    if (kQ) {                                 // int8 rows, 16 a copy
      int8_t* kd = kq8 + stage * kt * ldq;
      int8_t* vd = vq8 + stage * kt * ldq;
      const int c16 = hd / 16;
      for (int e = tid; e < kt * (c16 + 1); e += kThreads) {
        const int t = e / (c16 + 1);
        const int c = e - t * (c16 + 1);      // c16: the two scales
        const int kpos = k0 + tile * kt + t;
        const bool ok = kpos < k1;
        size_t tok = 0;
        if (ok) {
          const int page = kpos / bs;
          int blk = table[(size_t)b * nb + page];
          blk = min(max(blk, 0), n_pool - 1);
          tok = ((size_t)blk * bs + (kpos - page * bs)) * nkv + n;
        }
        if (c < c16) {
          cp_async16(kd + t * ldq + 16 * c, kp8 + tok * hd + 16 * c, ok);
          cp_async16(vd + t * ldq + 16 * c, vp8 + tok * hd + 16 * c, ok);
        } else {
          cp_async4(ksc + stage * kt + t, kps + tok, ok);
          cp_async4(vsc + stage * kt + t, vps + tok, ok);
        }
      }
      return;
    }
    bf16* kd = kbuf + stage * kt * ldk;
    bf16* vd = vbuf + stage * kt * ldk;
    for (int e = tid; e < kt * chunks; e += kThreads) {
      const int t = e / chunks;
      const int c = (e - t * chunks) * 8;
      const int kpos = k0 + tile * kt + t;
      const bool ok = kpos < k1;
      size_t src = 0;
      if (ok) {
        const int page = kpos / bs;
        int blk = table[(size_t)b * nb + page];
        blk = min(max(blk, 0), n_pool - 1);   // clamp as JAX's gathers do
        src = (((size_t)blk * bs + (kpos - page * bs)) * nkv + n) * hd + c;
      }
      cp_async16(kd + t * ldk + c, kp + src, ok);
      cp_async16(vd + t * ldk + c, vp + src, ok);
    }
  };

  // every stage in flight at once; one commit group a tile
#pragma unroll
  for (int s = 0; s < kStages; ++s) {
    if (s < ntiles) load_tile(s, s);
    cp_async_commit();
  }
  // the head-dim padding of the ring is never copied: zero it; clear acc
  // and the row state
  if (hdp > hd)
    for (int e = tid; e < 2 * kBufStages * kt * (hdp - hd); e += kThreads) {
      const int r = e / (hdp - hd);
      kbuf[r * ldk + hd + (e - r * (hdp - hd))] = __float2bfloat16_rn(0.f);
    }
  for (int e = tid; e < rp * hdp; e += kThreads)
    acc[(e / hdp) * ldo + e % hdp] = 0.f;
  for (int r = tid; r < rp; r += kThreads) {
    m[r] = -INFINITY;
    a[r] = 0.f;
    alpha[r] = 0.f;
  }

  const int mtiles = rp / 16;
  const int nks = kt / 16;                    // mma k steps of a tile
  for (int it = 0; it < ntiles; ++it) {
    cp_async_wait<kStages - 1>();             // q and tile `it` have landed
    __syncthreads();                          // ... for every thread
    const int stage = it % kStages;
    const bf16* ks = kbuf + (kQ ? 0 : stage) * kt * ldk;
    const bf16* vs = vbuf + (kQ ? 0 : stage) * kt * ldk;
    const int key0 = k0 + it * kt;
    if (kQ) {
      // widen the landed int8 tile: K to bf16(k * ks), V to bf16(v)
      const int8_t* kr = kq8 + stage * kt * ldq;
      const int8_t* vr = vq8 + stage * kt * ldq;
      const float* kss = ksc + stage * kt;
      const int c8 = hd / 8;
      for (int e = tid; e < kt * c8; e += kThreads) {
        const int t = e / c8;
        const int c = (e - t * c8) * 8;
        const uint2 kw = *reinterpret_cast<const uint2*>(kr + t * ldq + c);
        const uint2 vw = *reinterpret_cast<const uint2*>(vr + t * ldq + c);
        const float sk = kss[t];
        uint32_t ko[4], vo[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const uint32_t kx = i < 2 ? kw.x : kw.y;
          const uint32_t vx = i < 2 ? vw.x : vw.y;
          const int j = (i & 1) * 2;
          const float k0f = hopper::int8_value(kx, j);
          const float k1f = hopper::int8_value(kx, j + 1);
          const float v0f = hopper::int8_value(vx, j);
          const float v1f = hopper::int8_value(vx, j + 1);
          const bf16 a0 = __float2bfloat16_rn(__fmul_rn(k0f, sk));
          const bf16 a1 = __float2bfloat16_rn(__fmul_rn(k1f, sk));
          const bf16 b0 = __float2bfloat16_rn(v0f);
          const bf16 b1 = __float2bfloat16_rn(v1f);
          ko[i] = (uint32_t)__bfloat16_as_ushort(a0) |
                  ((uint32_t)__bfloat16_as_ushort(a1) << 16);
          vo[i] = (uint32_t)__bfloat16_as_ushort(b0) |
                  ((uint32_t)__bfloat16_as_ushort(b1) << 16);
        }
        *reinterpret_cast<uint4*>(kbuf + t * ldk + c) =
            make_uint4(ko[0], ko[1], ko[2], ko[3]);
        *reinterpret_cast<uint4*>(vbuf + t * ldk + c) =
            make_uint4(vo[0], vo[1], vo[2], vo[3]);
      }
      __syncthreads();
    }

    // S = q k^T: warp pairs (m tile, 8-key n tile)
    const int nkt = kt / 8;
    for (int p = warp; p < mtiles * nkt; p += kWarps) {
      const int mt = p / nkt, nt = p - (p / nkt) * nkt;
      // two accumulators (even and odd k steps) halve the mma chain
      float c[4] = {0.f, 0.f, 0.f, 0.f}, c2[4] = {0.f, 0.f, 0.f, 0.f};
      const bf16* qa = qs + (mt * 16 + (lane & 15)) * ldk + (lane >> 4) * 8;
      const bf16* kb = ks + (nt * 8 + (lane & 7)) * ldk + ((lane >> 3) & 1) * 8;
      for (int kk = 0; kk < hdp; kk += 32) {
        uint32_t fa[4], fb[2];
        ldsm_x4(fa, qa + kk);
        ldsm_x2(fb, kb + kk);
        mma16816(c, fa, fb[0], fb[1]);
        if (kk + 16 < hdp) {
          ldsm_x4(fa, qa + kk + 16);
          ldsm_x2(fb, kb + kk + 16);
          mma16816(c2, fa, fb[0], fb[1]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) c[i] += c2[i];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = mt * 16 + gq + 8 * (i >> 1);
        const int col = nt * 8 + 2 * tq4 + (i & 1);
        float s = 0.f;                        // padding rows: p = 0
        if (r < rows) {
          s = c[i] * scale;
          if (has_softcap) s = softcap * tanhf(s / softcap);
          const int kpos = key0 + col;
          const int qpos = len - tq + (r - (r / tq) * tq);
          if (kpos >= k1 || kpos > qpos) s = -INFINITY;
        }
        sc[r * lds + col] = s;
      }
    }
    __syncthreads();

    // online softmax, 8 lanes a row (keys li, li + 8, ...), 4 rows a warp;
    // p = hi + lo written over the row's scores
    const int lg = lane >> 3, li = lane & 7;
    for (int base = warp * 4; base < rows; base += kWarps * 4) {
      const int r = base + lg;
      const bool on = r < rows;
      float* sr = sc + (on ? r : 0) * lds;
      float v[kTileKeys / 8];
      float smax = -INFINITY;
#pragma unroll
      for (int j = 0; j < kTileKeys / 8; ++j) {
        const int t = li + 8 * j;
        v[j] = on && t < kt ? sr[t] : -INFINITY;
        smax = fmaxf(smax, v[j]);
      }
#pragma unroll
      for (int o = 1; o < 8; o <<= 1)
        smax = fmaxf(smax, __shfl_xor_sync(0xffffffffu, smax, o));
      const float m_prev = on ? m[r] : -INFINITY;
      const float m_new = fmaxf(m_prev, smax);
      const float safe = m_new == -INFINITY ? 0.f : m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kTileKeys / 8; ++j) {
        v[j] = li + 8 * j < kt ? expf(v[j] - safe) : 0.f;
        sum += v[j];
      }
#pragma unroll
      for (int o = 1; o < 8; o <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      __syncwarp();                           // the rows' scores are read
      if (on) {
        bf16* hi = reinterpret_cast<bf16*>(sr);
        bf16* lo = hi + kt;
#pragma unroll
        for (int j = 0; j < kTileKeys / 8; ++j) {
          const int t = li + 8 * j;
          if (t < kt) {
            // int8 V: the key's scale folds into p before the split
            const float pv = kQ ? v[j] * vsc[stage * kt + t] : v[j];
            const bf16 h = __float2bfloat16_rn(pv);
            hi[t] = h;
            lo[t] = __float2bfloat16_rn(pv - __bfloat162float(h));
          }
        }
        if (li == 0) {
          const float al = expf(m_prev - safe);
          a[r] = a[r] * al + sum;
          m[r] = m_new;
          alpha[r] = al;
        }
      }
    }
    __syncthreads();

    // acc = acc * alpha + hi @ v + lo @ v: warp pairs (m tile, 8-column
    // n tile of hd); a warp loads the p fragments of its m tile once
    const int nht = hdp / 8;
    int frag_mt = -1;
    uint32_t fh[kTileKeys / 16][4], fl[kTileKeys / 16][4];
    for (int p = warp; p < mtiles * nht; p += kWarps) {
      const int mt = p / nht, nt = p - (p / nht) * nht;
      if (mt != frag_mt) {
        const bf16* prow = reinterpret_cast<const bf16*>(
            sc + (mt * 16 + (lane & 15)) * lds) + (lane >> 4) * 8;
#pragma unroll
        for (int k = 0; k < kTileKeys / 16; ++k)
          if (k < nks) {
            ldsm_x4(fh[k], prow + 16 * k);
            ldsm_x4(fl[k], prow + kt + 16 * k);
          }
        frag_mt = mt;
      }
      float c[4] = {0.f, 0.f, 0.f, 0.f}, c2[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int k = 0; k < kTileKeys / 16; ++k)
        if (k < nks) {
          uint32_t fv[2];
          ldsm_x2_t(fv, vs + (16 * k + (lane & 15)) * ldk + nt * 8);
          mma16816(c, fh[k], fv[0], fv[1]);
          mma16816(c2, fl[k], fv[0], fv[1]);
        }
#pragma unroll
      for (int i = 0; i < 4; ++i) c[i] += c2[i];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = mt * 16 + gq + 8 * (i >> 1);
        const int col = nt * 8 + 2 * tq4 + (i & 1);
        acc[r * ldo + col] = acc[r * ldo + col] * alpha[r] + c[i];
      }
    }
    if (it + kStages < ntiles) {
      __syncthreads();                        // the stage is free
      load_tile(it + kStages, stage);
    }
    cp_async_commit();
  }
  cp_async_wait<0>();
  __syncthreads();                            // acc, m, a complete

  auto store = [&](int r, int c, float v) {
    const int gi = r / tq, ti = r - (r / tq) * tq;
    out[(((size_t)b * tq + ti) * nq + n * g + gi) * hd + c] =
        __float2bfloat16_rn(v);
  };
  if (live == 1) {
    for (int e = tid; e < rows * hd; e += kThreads) {
      const int r = e / hd, c = e - (e / hd) * hd;
      store(r, c, acc[r * ldo + c] / fmaxf(a[r], 1e-30f));
    }
    return;
  }

  // several live splits: write this one's partial; the last to finish
  // merges them all in split order
  const size_t pstride = (size_t)rows * (hd + 2);
  const size_t pbase = ((size_t)b * nkv + n) * splits;
  float* mine = part + (pbase + split) * pstride;
  for (int r = tid; r < rows; r += kThreads) {
    mine[r] = m[r];
    mine[rows + r] = a[r];
  }
  for (int e = tid; e < rows * hd; e += kThreads) {
    const int r = e / hd, c = e - (e / hd) * hd;
    mine[2 * rows + e] = acc[r * ldo + c];
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    int* cnt = counts + (size_t)b * nkv + n;
    const bool last = atomicAdd(cnt, 1) == live - 1;
    if (last) *cnt = 0;                       // ready for the next launch
    *flag = last;
  }
  __syncthreads();
  if (!*flag) return;
  __threadfence();
  // per row, one warp, lanes over the splits: the merged max (m) and sum
  // (a), reduced in a fixed order whichever CTA is last
  for (int r = warp; r < rows; r += kWarps) {
    float mx = -INFINITY;
    for (int s = lane; s < live; s += 32)
      mx = fmaxf(mx, __ldcg(part + (pbase + s) * pstride + r));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    const float safe = mx == -INFINITY ? 0.f : mx;
    float sum = 0.f;
    for (int s = lane; s < live; s += 32) {
      const float* ps = part + (pbase + s) * pstride;
      sum += __ldcg(ps + rows + r) * expf(__ldcg(ps + r) - safe);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (lane == 0) {
      m[r] = safe;
      a[r] = sum;
    }
  }
  __syncthreads();
  for (int e = tid; e < rows * hd; e += kThreads) {
    const int r = e / hd, c = e - (e / hd) * hd;
    float v = 0.f;
#pragma unroll 4
    for (int s = 0; s < live; ++s) {
      const float* ps = part + (pbase + s) * pstride;
      v += __ldcg(ps + 2 * rows + e) * expf(__ldcg(ps + r) - m[r]);
    }
    store(r, c, v / fmaxf(a[r], 1e-30f));
  }
}

}  // namespace

extern "C" {

// The launch plan for (B, nkv, nb, bs, hd, rows = g * Tq, int8 pools or
// not) under the overrides (pps, kt; 0 keeps the kernel's own): {tile
// keys, pages a split, splits, dynamic shared memory} into out[0..3] (the
// wrapper's Python mirror, core.windows.paged_plan, must agree).
void paged_attn_plan(int b, int nkv, int nb, int bs, int hd, int rows,
                     int quant, int pps, int kt, int* out) {
  const Plan p = plan(b, nkv, nb, bs, hd, rows, quant, pps, kt);
  out[0] = p.kt;
  out[1] = p.pps;
  out[2] = p.splits;
  out[3] = p.smem;
}

// Launches on `stream` under the overrides (pps, kt; 0 keeps the kernel's
// own, and a plan the kernel does not take, plan_ok, returns
// cudaErrorInvalidValue); returns the cudaError_t of the launch.  part is
// (B, nkv, splits, g * tq, hd + 2) f32 scratch (unused with one split),
// counts (B, nkv) int32 that are zero and left zero.  kps / vps, when not
// null, are the (N, bs, nkv, 1) f32 scale pools of int8 kp / vp (both or
// neither; hd % 16 == 0).
int paged_attn_launch(const void* q, const void* kp, const void* vp,
                      const void* kps, const void* vps, const void* table,
                      const void* lens, void* out, void* part, void* counts,
                      int b, int tq, int nq, int nkv, int hd, int n_pool,
                      int bs, int nb, float scale, int has_softcap,
                      float softcap, int pps, int kt, void* stream) {
  const int g = nq / nkv;
  const int quant = kps != nullptr;
  if (!plan_ok(b, nkv, nb, bs, hd, g * tq, quant, pps, kt))
    return (int)cudaErrorInvalidValue;
  const Plan p = plan(b, nkv, nb, bs, hd, g * tq, quant, pps, kt);
  if (p.smem > kMaxSmem || hd % 8 || p.splits > 65535 ||
      (vps != nullptr) != quant || (quant && hd % 16))
    return (int)cudaErrorInvalidValue;
  static int given[2][hopper::kMaxDevices];
  const auto kern = quant ? paged_attn_kernel<true> : paged_attn_kernel<false>;
  cudaError_t err = hopper::raise_smem_limit(
      reinterpret_cast<const void*>(kern), p.smem, given[quant]);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  kern<<<dim3(b, nkv, p.splits), kThreads, p.smem, s>>>(
      static_cast<const bf16*>(q), kp, vp, static_cast<const float*>(kps),
      static_cast<const float*>(vps), static_cast<const int*>(table),
      static_cast<const int*>(lens), static_cast<bf16*>(out),
      static_cast<float*>(part), static_cast<int*>(counts), n_pool, bs, nkv,
      hd, nb, tq, g, p.kt, p.pps, p.splits, scale, has_softcap, softcap);
  return (int)cudaGetLastError();
}

const char* paged_attn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
