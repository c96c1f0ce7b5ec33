// Streaming per-row top-k of softcap(h @ W^T) for Hopper (sm_90a).
//
// Replaces repro/kernels/sample_topk/kernel.py:_topk_kernel (the Pallas
// TPU kernel).  Same contract: for each row of h, the k largest values of
// the masked (optionally tanh-softcapped) logits as f32, with their global
// vocab ids as i32, sorted descending, ties to the lowest id.  A column is
// live iff local_col < v_orig and local_col + col_offset < valid.  The
// (rows, V) logits never reach device memory: each block holds only its
// own (8, block_v) slice in shared memory.
//
// Bound (H100 SXM, 3.35 TB/s, 989 TFLOP/s bf16): at rows = 8, W is
// 152064 x 1024 bf16 = 311 MB, read once -> ~93 us; the products are
// 2 * 8 * 1024 * 152064 = 2.5 GFLOP -> ~2.5 us on the tensor cores.  The
// kernel is memory-bound, so the design spends everything on streaming W
// once at full width:
//   * the TPU kernel's sequential vocab grid axis has no counterpart here;
//     instead the vocab is split into n_split = ceil(V / block_v) slices,
//     one block each, so a handful of rows still puts ~300 blocks on the
//     132 SMs;
//   * each warp computes 16-column x 8-row logits tiles with
//     mma.sync m16n8k16 (bf16 in, f32 accumulate).  The reduction axis is
//     permuted so that every lane loads 32 contiguous bytes of a W row per
//     64-wide k chunk (full 128-byte lines per row across the 4 lanes of a
//     row group) and h is read from shared memory with the same
//     permutation;
//   * selection is k extraction passes over the slice (one warp per row,
//     each lane caching its own best so that only the winning lane
//     rescans), then a second small kernel merges the (n_split, k)
//     candidates of each row with the same (value desc, id asc) order.
// A NaN logit is treated as -inf, and every written id lies in
// [col_offset, col_offset + v_orig).
//
// The many-row top-1 path (topk_rows_kernel, k = 1 only) computes the same
// function for the MTP accuracy's 4096 rows.  There the bound flips: the
// products are 2 * 4096 * 1024 * 152064 = 1.28 TFLOP -> ~1.29 ms on the
// tensor cores, against ~0.1 ms of bytes, and the decode kernel above,
// which streams W once for every 8 rows (512 times) through mma.sync, took
// 50.2 ms (H100 80GB HBM3, 700 W, chip_smoke.py).  So this path tiles like
// a GEMM:
//   * a CTA owns 128 rows of h and walks a slice of 256-column vocab
//     tiles; one producer thread streams h and W in 64-wide k chunks
//     through a 4-stage TMA ring (128-byte swizzle, mbarrier completion),
//     two consumer warpgroups each issue wgmma m64n256k16 (bf16 in, f32
//     accumulate, both operands from shared memory) for their 64 rows;
//   * the epilogue stays in registers: softcap, mask, NaN -> -inf, and a
//     running (value, id) best per row; each thread scans its columns in
//     ascending id order and replaces only on a strictly greater value,
//     and the quad merges under (value desc, id asc) once at the end;
//   * each (row, vocab slice) writes one partial, and a warp-per-row
//     merge kernel takes the best partial in the same order.  The grid is
//     (row tiles, slices), slices chosen so that ~8 waves of CTAs fill the
//     132 SMs (4096 rows: 32 x 33); CTAs of one slice run side by side and
//     share its W bytes in L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <climits>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kRows = 8;              // h rows per block: the mma n width
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxK = 64;
constexpr int kMergeThreads = 1024;
constexpr int kMaxPerThread = 64;     // candidates per thread (64-bit mask)

__device__ __forceinline__ bool better(float va, int ia, float vb, int ib) {
  return va > vb || (va == vb && ia < ib);
}

__device__ __forceinline__ void mma_bf16_16x8x16(float (&c)[4], uint32_t a0,
                                                 uint32_t a1, uint32_t a2,
                                                 uint32_t a3, uint32_t b0,
                                                 uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Warp-wide arg-best under (value desc, id asc); every lane gets the result.
__device__ __forceinline__ void warp_best(float& v, int& id, int& owner) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    float ov = __shfl_xor_sync(0xffffffffu, v, off);
    int oi = __shfl_xor_sync(0xffffffffu, id, off);
    int oo = __shfl_xor_sync(0xffffffffu, owner, off);
    if (better(ov, oi, v, id)) {
      v = ov;
      id = oi;
      owner = oo;
    }
  }
}

// grid (n_split, ceil(rows / 8)), kThreads threads, dynamic shared memory
// 8 * (d + 8) * 2 bytes of h plus 8 * block_v * 4 bytes of logits.
__global__ void __launch_bounds__(kThreads)
    topk_partial_kernel(const __nv_bfloat16* __restrict__ h,
                        const __nv_bfloat16* __restrict__ w,
                        float* __restrict__ pvals, int* __restrict__ pids,
                        int rows, int d, int v_orig, int valid,
                        int col_offset, int k, int block_v, int n_split,
                        int has_softcap, float softcap) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int hstride = d + 8;  // +16 bytes per row: conflict-free 16 B reads
  __nv_bfloat16* hs = reinterpret_cast<__nv_bfloat16*>(smem);
  float* zs = reinterpret_cast<float*>(smem + (size_t)kRows * hstride * 2);

  const int split = blockIdx.x;
  const int row0 = blockIdx.y * kRows;
  const int s0 = split * block_v;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  // stage this block's rows of h; rows past the end are zeros
  const int dv = d / 8;
  for (int i = tid; i < kRows * dv; i += kThreads) {
    const int r = i / dv;
    const int c = i - r * dv;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < rows)
      val = reinterpret_cast<const uint4*>(h + (size_t)(row0 + r) * d)[c];
    reinterpret_cast<uint4*>(hs + (size_t)r * hstride)[c] = val;
  }
  __syncthreads();

  // logits tiles: lane (g, t) feeds W rows (g, g + 8) of the tile and
  // h row g; physical k = base + 16 t + 4 s + {0..3} is mma step s's
  // logical k {2t, 2t+1, 2t+8, 2t+9} for both operands
  const int g = lane >> 2;
  const int t = lane & 3;
  const int tiles = block_v / 16;
  for (int tile = warp; tile < tiles; tile += kWarps) {
    const int c0 = s0 + tile * 16 + g;
    const int c1 = c0 + 8;
    const __nv_bfloat16* w0 = w + (size_t)min(c0, v_orig - 1) * d + 16 * t;
    const __nv_bfloat16* w1 = w + (size_t)min(c1, v_orig - 1) * d + 16 * t;
    const __nv_bfloat16* hr = hs + (size_t)g * hstride + 16 * t;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int base = 0; base < d; base += 64) {
      const uint4 a0l = __ldg(reinterpret_cast<const uint4*>(w0 + base));
      const uint4 a0h = __ldg(reinterpret_cast<const uint4*>(w0 + base + 8));
      const uint4 a1l = __ldg(reinterpret_cast<const uint4*>(w1 + base));
      const uint4 a1h = __ldg(reinterpret_cast<const uint4*>(w1 + base + 8));
      const uint4 bl = *reinterpret_cast<const uint4*>(hr + base);
      const uint4 bh = *reinterpret_cast<const uint4*>(hr + base + 8);
      mma_bf16_16x8x16(acc, a0l.x, a1l.x, a0l.y, a1l.y, bl.x, bl.y);
      mma_bf16_16x8x16(acc, a0l.z, a1l.z, a0l.w, a1l.w, bl.z, bl.w);
      mma_bf16_16x8x16(acc, a0h.x, a1h.x, a0h.y, a1h.y, bh.x, bh.y);
      mma_bf16_16x8x16(acc, a0h.z, a1h.z, a0h.w, a1h.w, bh.z, bh.w);
    }
    // acc[0..1]: column tile*16 + g, rows 2t, 2t+1; acc[2..3]: column + 8
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int lc = tile * 16 + g + 8 * half;
      const int local = s0 + lc;
      const bool live = local < v_orig && local + col_offset < valid;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float z = acc[2 * half + j];
        if (has_softcap) z = softcap * tanhf(z / softcap);
        if (!live || isnan(z)) z = -INFINITY;
        zs[(2 * t + j) * block_v + lc] = z;
      }
    }
  }
  __syncthreads();

  // selection: warp r extracts row r's top k of this slice
  const int r = warp;
  if (row0 + r >= rows) return;
  const float* zr = zs + (size_t)r * block_v;
  const int per = block_v / 32;
  unsigned long long taken = 0ull;
  float bv = -INFINITY;
  int bj = INT_MAX;
  auto rescan = [&]() {
    bv = -INFINITY;
    bj = INT_MAX;
    for (int i = 0; i < per; ++i) {
      if ((taken >> i) & 1ull) continue;
      const float v = zr[lane + 32 * i];
      if (bj == INT_MAX || v > bv) {  // ascending scan: ties keep low j
        bv = v;
        bj = lane + 32 * i;
      }
    }
  };
  rescan();
  float* outv = pvals + ((size_t)(row0 + r) * n_split + split) * k;
  int* outi = pids + ((size_t)(row0 + r) * n_split + split) * k;
  for (int p = 0; p < k; ++p) {
    float v = bv;
    int j = bj;
    int owner = lane;
    warp_best(v, j, owner);
    if (lane == 0) {
      outv[p] = v;
      outi[p] = min(s0 + j, v_orig - 1) + col_offset;
    }
    if (lane == owner) {
      taken |= 1ull << (j / 32);
      rescan();
    }
  }
}

// grid (rows), kMergeThreads threads: top k of each row's n_cand partials.
__global__ void __launch_bounds__(kMergeThreads)
    topk_merge_kernel(const float* __restrict__ pvals,
                      const int* __restrict__ pids, float* __restrict__ vals,
                      int* __restrict__ ids, int n_cand, int k) {
  __shared__ float sv[kMergeThreads / 32];
  __shared__ int si[kMergeThreads / 32];
  __shared__ int so[kMergeThreads / 32];
  __shared__ int win_owner;
  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const float* cv = pvals + (size_t)row * n_cand;
  const int* ci = pids + (size_t)row * n_cand;
  const int per = (n_cand + kMergeThreads - 1) / kMergeThreads;

  unsigned long long taken = 0ull;
  float bv = -INFINITY;
  int bid = INT_MAX;
  int bslot = -1;
  auto rescan = [&]() {
    bv = -INFINITY;
    bid = INT_MAX;
    bslot = -1;
    for (int i = 0; i < per; ++i) {
      const int c = tid + kMergeThreads * i;
      if (c >= n_cand || ((taken >> i) & 1ull)) continue;
      const float v = cv[c];
      const int id = ci[c];
      if (bslot < 0 || better(v, id, bv, bid)) {
        bv = v;
        bid = id;
        bslot = i;
      }
    }
  };
  rescan();
  for (int p = 0; p < k; ++p) {
    float v = bv;
    int id = bid;
    int owner = tid;
    warp_best(v, id, owner);
    if (lane == 0) {
      sv[warp] = v;
      si[warp] = id;
      so[warp] = owner;
    }
    __syncthreads();
    if (warp == 0) {
      v = sv[lane];
      id = si[lane];
      owner = so[lane];
      warp_best(v, id, owner);
      if (lane == 0) {
        vals[(size_t)row * k + p] = v;
        ids[(size_t)row * k + p] = id;
        win_owner = owner;
      }
    }
    __syncthreads();
    if (tid == win_owner) {
      taken |= 1ull << bslot;
      rescan();
    }
  }
}

// ---------------------------------------------------------------------------
// many-row top-1 path
// ---------------------------------------------------------------------------

constexpr int kRowsM = 128;           // h rows a CTA: two consumer warpgroups
constexpr int kRowsN = 256;           // vocab columns a tile (wgmma n)
constexpr int kRowsK = 64;            // k chunk: one 128-byte swizzle row
constexpr int kRowsStages = 4;
constexpr int kRowsThreads = 384;     // producer warpgroup + 2 consumers
constexpr int kRowsWaves = 8;         // CTAs in flight per SM, times 132
constexpr int kNumSMs = 132;
constexpr int kRowsStageBytes = (kRowsM + kRowsN) * kRowsK * 2;
constexpr size_t kRowsSmem =
    1024 + (size_t)kRowsStages * kRowsStageBytes + 2 * kRowsStages * 8;

// grid (ceil(rows / 128), n_split), kRowsThreads threads, kRowsSmem bytes.
// Slice `split` covers vocab tiles [split * per, (split + 1) * per); each
// row's best masked logit over it goes to pvals/pids[row * n_split + split].
__global__ void __launch_bounds__(kRowsThreads, 1)
    topk_rows_kernel(const __grid_constant__ CUtensorMap hmap,
                     const __grid_constant__ CUtensorMap wmap,
                     float* __restrict__ pvals, int* __restrict__ pids,
                     int rows, int d, int v_orig, int valid, int col_offset,
                     int per, int n_split, int has_softcap, float softcap) {
  using namespace hopper;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  __nv_bfloat16* sA = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sB = sA + kRowsStages * kRowsM * kRowsK;
  uint64_t* full = reinterpret_cast<uint64_t*>(sB + kRowsStages * kRowsN *
                                                        kRowsK);
  uint64_t* empty = full + kRowsStages;

  const int row0 = blockIdx.x * kRowsM;
  const int split = blockIdx.y;
  const int n_tiles = (v_orig + kRowsN - 1) / kRowsN;
  const int t_begin = split * per;
  const int t_end = min(t_begin + per, n_tiles);
  const int nk = d / kRowsK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kRowsStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);        // one arrival per consumer warp
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread keeps the ring full
    if (threadIdx.x == 0) {
      int it = 0;
      for (int tile = t_begin; tile < t_end; ++tile)
        for (int kc = 0; kc < nk; ++kc, ++it) {
          const int s = it % kRowsStages;
          mbar_wait(&empty[s], ((it / kRowsStages) & 1) ^ 1);
          mbar_arrive_tx(&full[s], kRowsStageBytes);
          tma_load_2d(sA + s * kRowsM * kRowsK, &hmap, &full[s],
                      kc * kRowsK, row0);
          tma_load_2d(sB + s * kRowsN * kRowsK, &wmap, &full[s],
                      kc * kRowsK, tile * kRowsN);
        }
    }
    return;
  }

  const int cw = wg - 1;                // consumer: rows cw * 64 ..
  const int wt = threadIdx.x % 128;
  const int lane = wt & 31;
  const int t = lane & 3;
  float acc[128];
  float bv[2] = {-INFINITY, -INFINITY};
  int bi[2] = {INT_MAX, INT_MAX};
  int it = 0;
  for (int tile = t_begin; tile < t_end; ++tile) {
    for (int kc = 0; kc < nk; ++kc, ++it) {
      const int s = it % kRowsStages;
      mbar_wait(&full[s], (it / kRowsStages) & 1);
      const __nv_bfloat16* a = sA + s * kRowsM * kRowsK + cw * 64 * kRowsK;
      const __nv_bfloat16* b = sB + s * kRowsN * kRowsK;
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kRowsK / 16; ++ks)
        wgmma_m64n256k16(acc, desc_b128(a + ks * 16, 16, 1024),
                         desc_b128(b + ks * 16, 16, 1024), kc | ks);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      if (lane == 0) mbar_arrive(&empty[s]);
    }
    // epilogue: columns in ascending order, strictly greater replaces
    const int c_base = tile * kRowsN;
#pragma unroll
    for (int j = 0; j < kRowsN / 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = c_base + 8 * j + 2 * t + c;
        if (col >= v_orig) continue;
        const bool live = col + col_offset < valid;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float z = acc[4 * j + 2 * i + c];
          if (has_softcap) z = softcap * tanhf(z / softcap);
          if (!live || isnan(z)) z = -INFINITY;
          if (bi[i] == INT_MAX || z > bv[i]) {
            bv[i] = z;
            bi[i] = col;
          }
        }
      }
  }
  // merge the quad (the 4 lanes that share a row) and write the partial
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv[i], off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi[i], off);
      if (better(ov, oi, bv[i], bi[i])) {
        bv[i] = ov;
        bi[i] = oi;
      }
    }
    const int row = row0 + cw * 64 + 16 * (wt >> 5) + (lane >> 2) + 8 * i;
    if (t == 0 && row < rows) {
      pvals[(size_t)row * n_split + split] = bv[i];
      pids[(size_t)row * n_split + split] = bi[i] + col_offset;
    }
  }
}

// grid ceil(rows / 8), one warp a row: the best of each row's n_split
// partials under (value desc, id asc).
__global__ void __launch_bounds__(256)
    top1_merge_kernel(const float* __restrict__ pvals,
                      const int* __restrict__ pids, float* __restrict__ vals,
                      int* __restrict__ ids, int rows, int n_split) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  float v = -INFINITY;
  int id = INT_MAX;
  for (int s = lane; s < n_split; s += 32) {
    const float pv = pvals[(size_t)row * n_split + s];
    const int pi = pids[(size_t)row * n_split + s];
    if (better(pv, pi, v, id)) {
      v = pv;
      id = pi;
    }
  }
  int owner = lane;
  warp_best(v, id, owner);
  if (lane == 0) {
    vals[row] = v;
    ids[row] = id;
  }
}

// vocab slices of the many-row path for `rows` rows and `v_orig` columns
int rows_splits(int rows, int v_orig, int* per_out) {
  const int row_tiles = (rows + kRowsM - 1) / kRowsM;
  const int n_tiles = (v_orig + kRowsN - 1) / kRowsN;
  int want = (kRowsWaves * kNumSMs + row_tiles - 1) / row_tiles;
  want = want < 1 ? 1 : (want > n_tiles ? n_tiles : want);
  const int per = (n_tiles + want - 1) / want;
  if (per_out) *per_out = per;
  return (n_tiles + per - 1) / per;
}

}  // namespace

extern "C" {

int sample_topk_max_k() { return kMaxK; }

int sample_topk_max_candidates() { return kMergeThreads * kMaxPerThread; }

// Launches both kernels on `stream`; returns the cudaError_t of the launches.
// pvals/pids are (rows, n_split, k) scratch, vals/ids the (rows, k) result.
int sample_topk_launch(const void* h, const void* w, void* pvals, void* pids,
                       void* vals, void* ids, int rows, int d, int v_orig,
                       int valid, int col_offset, int k, int block_v,
                       int has_softcap, float softcap, void* stream) {
  const int n_split = (v_orig + block_v - 1) / block_v;
  const size_t smem = (size_t)kRows * (d + 8) * 2 + (size_t)kRows * block_v * 4;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(
      topk_partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(n_split, (rows + kRows - 1) / kRows);
  topk_partial_kernel<<<grid, kThreads, smem, s>>>(
      static_cast<const __nv_bfloat16*>(h),
      static_cast<const __nv_bfloat16*>(w), static_cast<float*>(pvals),
      static_cast<int*>(pids), rows, d, v_orig, valid, col_offset, k, block_v,
      n_split, has_softcap, softcap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  topk_merge_kernel<<<rows, kMergeThreads, 0, s>>>(
      static_cast<const float*>(pvals), static_cast<const int*>(pids),
      static_cast<float*>(vals), static_cast<int*>(ids), n_split * k, k);
  return (int)cudaGetLastError();
}

// Many-row top-1 path: the vocab slices a launch over `rows` rows uses;
// the wrapper sizes the (rows, n_split) partials with it.
int sample_topk_rows_splits(int rows, int v_orig) {
  return rows_splits(rows, v_orig, nullptr);
}

// Launches the many-row top-1 kernel and its merge on `stream`; returns a
// cudaError_t.  pvals/pids are (rows, n_split) scratch, vals/ids (rows,).
int sample_topk_rows_launch(const void* h, const void* w, void* pvals,
                            void* pids, void* vals, void* ids, int rows,
                            int d, int v_orig, int valid, int col_offset,
                            int has_softcap, float softcap, void* stream) {
  if (rows < 1 || v_orig < 1 || d < kRowsK || d % kRowsK)
    return (int)cudaErrorInvalidValue;
  CUtensorMap hmap, wmap;
  int err = hopper::make_tmap_bf16(&hmap, h, rows, d, kRowsM);
  if (err) return err;
  err = hopper::make_tmap_bf16(&wmap, w, v_orig, d, kRowsN);
  if (err) return err;
  int per = 0;
  const int n_split = rows_splits(rows, v_orig, &per);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t e = cudaFuncSetAttribute(
      topk_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kRowsSmem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((rows + kRowsM - 1) / kRowsM, n_split);
  topk_rows_kernel<<<grid, kRowsThreads, kRowsSmem, s>>>(
      hmap, wmap, static_cast<float*>(pvals), static_cast<int*>(pids), rows,
      d, v_orig, valid, col_offset, per, n_split, has_softcap, softcap);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  top1_merge_kernel<<<(rows + 7) / 8, 256, 0, s>>>(
      static_cast<const float*>(pvals), static_cast<const int*>(pids),
      static_cast<float*>(vals), static_cast<int*>(ids), rows, n_split);
  return (int)cudaGetLastError();
}

const char* sample_topk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
