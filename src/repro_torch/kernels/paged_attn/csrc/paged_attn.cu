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
// tensor-core line, so it is memory-bound -- and at the cell's ~200-token
// rows (~2 us) bound by launch latency.
//
// Design (simple and correct first; splitting each chain across CTAs
// with a merge pass, flash-decoding style, to fill the 132 SMs at small B
// is later work):
//   * the TPU kernel's scalar-prefetch index maps chase the chain along a
//     sequential grid axis; here one CTA owns one (row, KV head) and walks
//     its own row of `table` in a loop, only up to ceil(lens / bs) pages
//     (pages past the chain -- null block 0 -- are never read);
//   * the g * Tq query rows of the KV head are staged once in shared
//     memory as f32; K and V stream through a kStages-deep ring of tiles
//     of ppt pages (ppt * bs ~ 64 keys), one 16-byte cp.async per 8
//     values, so the next tiles load while the current one is reduced; a
//     tile's pages past the chain are zero-filled, never read;
//   * per tile: one thread per (query row, key) dot product over 16-byte
//     K chunks (the start chunk rotated by key, so that the threads of a
//     warp hit different banks), one warp per query row for the online
//     softmax update of (m, a), then every thread rescales and
//     accumulates its own (row, 2 columns) of acc in shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 3;             // cp.async ring depth (tiles)
constexpr int kTileKeys = 64;          // keys a tile aims for
constexpr int kMaxSmem = 232448;       // 227 KB a block on the H100

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

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

size_t smem_bytes(int bs, int hd, int rows, int ppt) {
  const size_t kt = (size_t)ppt * bs;                     // keys a tile
  return 2 * kStages * kt * hd * sizeof(__nv_bfloat16)    // K, V ring
         + (size_t)2 * rows * hd * sizeof(float)          // q, acc
         + (size_t)rows * kt * sizeof(float)              // scores
         + (size_t)3 * rows * sizeof(float);              // m, a, alpha
}

// Pages a tile: ~kTileKeys keys, fewer where shared memory runs out.
int pages_per_tile(int bs, int hd, int rows) {
  int ppt = bs < kTileKeys ? kTileKeys / bs : 1;
  while (ppt > 1 && smem_bytes(bs, hd, rows, ppt) > (size_t)kMaxSmem)
    ppt /= 2;
  return ppt;
}

// grid (B, nkv); query row r of a block is (gi, ti) = (r / tq, r % tq),
// head n * g + gi, position lens[b] - tq + ti.
__global__ void __launch_bounds__(kThreads)
paged_attn_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ kp,
                  const __nv_bfloat16* __restrict__ vp,
                  const int* __restrict__ table,
                  const int* __restrict__ lens,
                  __nv_bfloat16* __restrict__ out, int n_pool, int bs,
                  int nkv, int hd, int nb, int tq, int g, int ppt,
                  float scale, int has_softcap, float softcap) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x;
  const int n = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int rows = g * tq;
  const int nq = nkv * g;
  const int kt = ppt * bs;                  // keys a tile

  __nv_bfloat16* kbuf = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* vbuf = kbuf + (size_t)kStages * kt * hd;
  float* qs = reinterpret_cast<float*>(vbuf + (size_t)kStages * kt * hd);
  float* acc = qs + rows * hd;
  float* sc = acc + rows * hd;
  float* m = sc + rows * kt;
  float* a = m + rows;
  float* alpha = a + rows;

  const int len = lens[b];
  const int npages = len <= 0 ? 0 : min((len + bs - 1) / bs, nb);
  const int ntiles = (npages + ppt - 1) / ppt;
  const int chunks = hd / 8;                // 16-byte pieces of a head row

  auto load_tile = [&](int tile, int stage) {
    __nv_bfloat16* kd = kbuf + (size_t)stage * kt * hd;
    __nv_bfloat16* vd = vbuf + (size_t)stage * kt * hd;
    for (int e = tid; e < kt * chunks; e += kThreads) {
      const int t = e / chunks;             // key within the tile
      const int c = (e - t * chunks) * 8;
      const int j = t / bs;                 // page within the tile
      const int page = tile * ppt + j;
      const bool live = page < npages;
      size_t src = 0;
      if (live) {
        int blk = table[(size_t)b * nb + page];
        blk = min(max(blk, 0), n_pool - 1); // clamp as JAX's gathers do
        src = (((size_t)blk * bs + (t - j * bs)) * nkv + n) * hd + c;
      }
      cp_async16(kd + (size_t)t * hd + c, kp + src, live);
      cp_async16(vd + (size_t)t * hd + c, vp + src, live);
    }
  };

  for (int p = 0; p < kStages - 1; ++p) {
    if (p < ntiles) load_tile(p, p);
    cp_async_commit();
  }
  for (int e = tid; e < rows * hd; e += kThreads) {
    const int r = e / hd;
    const int c = e - r * hd;
    const int gi = r / tq;
    const int ti = r - gi * tq;
    qs[e] = __bfloat162float(
        q[(((size_t)b * tq + ti) * nq + n * g + gi) * hd + c]);
    acc[e] = 0.f;
  }
  for (int r = tid; r < rows; r += kThreads) {
    m[r] = -INFINITY;
    a[r] = 0.f;
  }

  for (int it = 0; it < ntiles; ++it) {
    const int pf = it + kStages - 1;
    if (pf < ntiles) load_tile(pf, pf % kStages);
    cp_async_commit();
    cp_async_wait<kStages - 1>();           // tile `it` has landed
    __syncthreads();
    const __nv_bfloat16* ks = kbuf + (size_t)(it % kStages) * kt * hd;
    const __nv_bfloat16* vs = vbuf + (size_t)(it % kStages) * kt * hd;

    // scores: one thread per (row, key), 8 values a step
    for (int e = tid; e < rows * kt; e += kThreads) {
      const int r = e / kt;
      const int t = e - r * kt;
      const float* qr = qs + r * hd;
      const __nv_bfloat16* kr = ks + (size_t)t * hd;
      float dot = 0.f;
      int ci = t % chunks;                  // rotated start chunk
      for (int i = 0; i < chunks; ++i) {
        const int c = ci * 8;
        const uint4 kv = *reinterpret_cast<const uint4*>(kr + c);
        const float4 q0 = *reinterpret_cast<const float4*>(qr + c);
        const float4 q1 = *reinterpret_cast<const float4*>(qr + c + 4);
        const __nv_bfloat162* k2 =
            reinterpret_cast<const __nv_bfloat162*>(&kv);
        const float2 f0 = __bfloat1622float2(k2[0]);
        const float2 f1 = __bfloat1622float2(k2[1]);
        const float2 f2 = __bfloat1622float2(k2[2]);
        const float2 f3 = __bfloat1622float2(k2[3]);
        dot = fmaf(q0.x, f0.x, dot);
        dot = fmaf(q0.y, f0.y, dot);
        dot = fmaf(q0.z, f1.x, dot);
        dot = fmaf(q0.w, f1.y, dot);
        dot = fmaf(q1.x, f2.x, dot);
        dot = fmaf(q1.y, f2.y, dot);
        dot = fmaf(q1.z, f3.x, dot);
        dot = fmaf(q1.w, f3.y, dot);
        if (++ci == chunks) ci = 0;
      }
      float s = dot * scale;
      if (has_softcap) s = softcap * tanhf(s / softcap);
      const int kpos = it * kt + t;
      const int qpos = len - tq + (r % tq);
      sc[e] = kpos <= qpos ? s : -INFINITY;
    }
    __syncthreads();

    // online softmax: one warp per query row
    for (int r = warp; r < rows; r += kWarps) {
      float* sr = sc + r * kt;
      float smax = -INFINITY;
      for (int t = lane; t < kt; t += 32) smax = fmaxf(smax, sr[t]);
      smax = warp_max(smax);
      const float m_prev = m[r];
      const float m_new = fmaxf(m_prev, smax);
      const float m_safe = m_new == -INFINITY ? 0.f : m_new;
      float sum = 0.f;
      for (int t = lane; t < kt; t += 32) {
        const float pv = expf(sr[t] - m_safe);
        sr[t] = pv;
        sum += pv;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float al = expf(m_prev - m_safe);
        a[r] = a[r] * al + sum;
        m[r] = m_new;
        alpha[r] = al;
      }
    }
    __syncthreads();

    // acc = acc * alpha + p @ v, each thread its own (row, 2 columns)
    const int half = hd / 2;
    for (int e = tid; e < rows * half; e += kThreads) {
      const int r = e / half;
      const int c = (e - r * half) * 2;
      const float* pr = sc + r * kt;
      float2* ap = reinterpret_cast<float2*>(acc + r * hd + c);
      float2 v = *ap;
      v.x *= alpha[r];
      v.y *= alpha[r];
      const __nv_bfloat16* vc = vs + c;
      for (int t = 0; t < kt; ++t) {
        const float p = pr[t];
        const float2 x = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(vc + (size_t)t * hd));
        v.x = fmaf(p, x.x, v.x);
        v.y = fmaf(p, x.y, v.y);
      }
      *ap = v;
    }
    __syncthreads();                        // the stage is free for reloads
  }
  cp_async_wait<0>();
  __syncthreads();                          // (m, a) of rows with no pages

  for (int e = tid; e < rows * hd; e += kThreads) {
    const int r = e / hd;
    const int c = e - r * hd;
    const int gi = r / tq;
    const int ti = r - gi * tq;
    out[(((size_t)b * tq + ti) * nq + n * g + gi) * hd + c] =
        __float2bfloat16_rn(acc[e] / fmaxf(a[r], 1e-30f));
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs, and the most the card allows.
long long paged_attn_smem_bytes(int bs, int hd, int rows) {
  return (long long)smem_bytes(bs, hd, rows, pages_per_tile(bs, hd, rows));
}

int paged_attn_max_smem() { return kMaxSmem; }

// Launches on `stream`; returns the cudaError_t of the launch.
int paged_attn_launch(const void* q, const void* kp, const void* vp,
                      const void* table, const void* lens, void* out, int b,
                      int tq, int nq, int nkv, int hd, int n_pool, int bs,
                      int nb, float scale, int has_softcap, float softcap,
                      void* stream) {
  const int g = nq / nkv;
  const int ppt = pages_per_tile(bs, hd, g * tq);
  const size_t smem = smem_bytes(bs, hd, g * tq, ppt);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(
      paged_attn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  paged_attn_kernel<<<dim3(b, nkv), kThreads, smem, s>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(kp),
      static_cast<const __nv_bfloat16*>(vp), static_cast<const int*>(table),
      static_cast<const int*>(lens), static_cast<__nv_bfloat16*>(out),
      n_pool, bs, nkv, hd, nb, tq, g, ppt, scale, has_softcap, softcap);
  return (int)cudaGetLastError();
}

const char* paged_attn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
