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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <climits>
#include <math.h>
#include <stdint.h>

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

const char* sample_topk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
