// Log-probabilities of candidate tokens under softmax(h @ W^T), for Hopper
// (sm_90a), without the (rows, V) logits ever reaching device memory.
//
// Replaces repro/kernels/score_tokens/kernel.py:_score_kernel (the Pallas
// TPU kernel).  Same contract: for each row r of h and its n_cand candidate
// ids ids[r, :],
//   * z = h . w per column (f32 sums of exact bf16 products), then
//     cap * tanh(z / cap) when a softcap is given, then z * inv_temp (the
//     sampler's order: the scored distribution is the one drawn from);
//   * a column is valid iff local < v_orig and local + col_offset < valid;
//   * lse[r] = m + log a over the valid columns (online softmax with the
//     m = -inf guard);
//   * zc[r, p] = the transformed logit of ids[r, p] when that id is a valid
//     column of this shard, else 0 (the ops wrapper masks logp to -inf).
//     Duplicated ids score identically; an id is only ever compared, never
//     used as an address, so -1 pads and ids >= V are harmless.
//
// Bound (H100 SXM, 3.35 TB/s, 989 TFLOP/s bf16): at the speculative
// verifier's 32 rows W is 152064 x 1024 bf16 = 311 MB, read once -> ~93 us;
// the products are 2 * 32 * 1024 * 152064 = 10 GFLOP -> ~10 us on the
// tensor cores.  Memory-bound, so the design (sample_topk.cu's, which
// reaches 80% of this bound at k = 1) spends everything on streaming W
// once at full width:
//   * the TPU kernel's sequential vocab grid axis has no counterpart here:
//     the vocab is cut into n_split = ceil(V / block_v) slices, one block
//     each, and a second small kernel merges the slices' (m, a) in a fixed
//     order; blockIdx.x walks the 32-row blocks of h, so the row blocks of
//     one slice run side by side and share its W bytes in L2;
//   * each warp computes 16-column tiles of logits against every row of the
//     block (up to 4 groups of 8 rows of h, staged in shared memory: as
//     many groups as the rows need and shared memory holds, so 4 at d 1024
//     and 3 at d 4096, where 32 rows of h alone would take 262,656 bytes)
//     with
//     mma.sync m16n8k16, bf16 in, f32 accumulate: one W fragment feeds all
//     row groups.  The reduction axis is permuted so that every lane loads
//     32 contiguous bytes of a W row per 64-wide k chunk, and h is read from
//     shared memory with the same permutation;
//   * the softcap, 1/T, exp and log stay in f32 on the CUDA cores: each
//     lane keeps the (m, a) state of its own rows over its own columns;
//     the tensor cores only form the dot products (no softmax sum is ever
//     accumulated on them: they truncate small addends);
//   * candidates: the ids of the block's rows that fall in the slice are
//     listed in shared memory first, and the one lane that holds such a
//     logit writes it straight to zc.  Exactly one slice owns a valid id,
//     and the merge kernel writes the 0 of every id no slice owns, so each
//     output is written once; there are no float atomics and the merge
//     order is fixed: two calls on the same inputs agree bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kGroupRows = 8;        // h rows of one mma n tile
constexpr int kMaxGroups = 4;
constexpr int kRows = kGroupRows * kMaxGroups;  // most h rows a block
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxCand = 64;         // candidates a row
constexpr int kMergeWarps = 8;       // merge kernel: one warp a row
constexpr int kMaxSmem = 232448;     // H100: 227 KB of dynamic shared memory

__host__ __device__ inline size_t smem_bytes(int groups, int d, int n_cand) {
  return (size_t)groups * kGroupRows * (d + 8) * 2       // h rows
         + (size_t)2 * kWarps * kRows * 4                 // (m, a) per warp
         + (size_t)groups * kGroupRows * n_cand * 2 * 4;  // owned candidates
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

// Merge the online-softmax state (om, oa) into (m, a).
__device__ __forceinline__ void merge_state(float& m, float& a, float om,
                                            float oa) {
  const float mn = fmaxf(m, om);
  const float safe = (mn == -INFINITY) ? 0.f : mn;
  a = a * expf(m - safe) + oa * expf(om - safe);
  m = mn;
}

// grid (ceil(rows / (8 GROUPS)), n_split), kThreads threads, dynamic shared
// memory
// smem_bytes(GROUPS, d, n_cand).  Writes each row's (m, a) over its slice to
// part[(row * n_split + split) * 2 ...] and the logits of the candidates
// the slice owns to zc.
template <int GROUPS>
__global__ void __launch_bounds__(kThreads)
    score_partial_kernel(const bf16* __restrict__ h,
                         const bf16* __restrict__ w,
                         const int* __restrict__ ids, float* __restrict__ part,
                         float* __restrict__ zc, int rows, int d, int v_orig,
                         int valid, int col_offset, int n_cand, int block_v,
                         int n_split, int has_cap, float cap, float inv_temp) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int n_own;
  constexpr int kStaged = GROUPS * kGroupRows;
  const int hstride = d + 8;  // +16 bytes per row: conflict-free 16 B reads
  bf16* hs = reinterpret_cast<bf16*>(smem);
  float* red_m = reinterpret_cast<float*>(smem + (size_t)kStaged * hstride * 2);
  float* red_a = red_m + kWarps * kRows;
  int* own = reinterpret_cast<int*>(red_a + kWarps * kRows);

  const int row0 = blockIdx.x * kStaged;
  const int split = blockIdx.y;
  const int s0 = split * block_v;
  const int s_end = min(s0 + block_v, v_orig);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  if (tid == 0) n_own = 0;
  // stage this block's rows of h; rows past the end are zeros
  const int dv = d / 8;
  for (int i = tid; i < kStaged * dv; i += kThreads) {
    const int r = i / dv;
    const int c = i - r * dv;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < rows)
      val = reinterpret_cast<const uint4*>(h + (size_t)(row0 + r) * d)[c];
    reinterpret_cast<uint4*>(hs + (size_t)r * hstride)[c] = val;
  }
  __syncthreads();
  // list the candidates this slice owns: (index in the block's ids, column
  // within the slice); the list's order is irrelevant, each entry is written
  // by exactly one lane
  for (int i = tid; i < kStaged * n_cand; i += kThreads) {
    const int r = i / n_cand;
    if (row0 + r >= rows) continue;
    const int id = ids[(size_t)row0 * n_cand + i];
    const long long local = (long long)id - col_offset;
    if (local >= s0 && local < s_end && id < valid) {
      const int slot = atomicAdd(&n_own, 1);
      own[2 * slot] = i;
      own[2 * slot + 1] = (int)(local - s0);
    }
  }
  __syncthreads();
  const int nown = n_own;

  // lane (g, t) feeds W rows (g, g + 8) of a tile and h row g of each group;
  // physical k = base + 16 t + 4 s + {0..3} is mma step s's logical k
  // {2t, 2t+1, 2t+8, 2t+9} for both operands.  acc[grp][0..1]: column g,
  // rows 2t, 2t+1 of the group; acc[grp][2..3]: column g + 8.
  const int g = lane >> 2;
  const int t = lane & 3;
  float m[GROUPS][2], a[GROUPS][2];
#pragma unroll
  for (int grp = 0; grp < GROUPS; ++grp)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      m[grp][j] = -INFINITY;
      a[grp][j] = 0.f;
    }

  const int tiles = (s_end - s0 + 15) / 16;
  for (int tile = warp; tile < tiles; tile += kWarps) {
    const int c0 = s0 + tile * 16 + g;
    const int c1 = c0 + 8;
    const bf16* w0 = w + (size_t)min(c0, v_orig - 1) * d + 16 * t;
    const bf16* w1 = w + (size_t)min(c1, v_orig - 1) * d + 16 * t;
    float acc[GROUPS][4];
#pragma unroll
    for (int grp = 0; grp < GROUPS; ++grp)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[grp][i] = 0.f;
#pragma unroll 2
    for (int base = 0; base < d; base += 64) {
      const uint4 a0l = __ldg(reinterpret_cast<const uint4*>(w0 + base));
      const uint4 a0h = __ldg(reinterpret_cast<const uint4*>(w0 + base + 8));
      const uint4 a1l = __ldg(reinterpret_cast<const uint4*>(w1 + base));
      const uint4 a1h = __ldg(reinterpret_cast<const uint4*>(w1 + base + 8));
#pragma unroll
      for (int grp = 0; grp < GROUPS; ++grp) {
        const bf16* hr = hs + (size_t)(grp * kGroupRows + g) * hstride +
                         16 * t + base;
        const uint4 bl = *reinterpret_cast<const uint4*>(hr);
        const uint4 bh = *reinterpret_cast<const uint4*>(hr + 8);
        mma_bf16_16x8x16(acc[grp], a0l.x, a1l.x, a0l.y, a1l.y, bl.x, bl.y);
        mma_bf16_16x8x16(acc[grp], a0l.z, a1l.z, a0l.w, a1l.w, bl.z, bl.w);
        mma_bf16_16x8x16(acc[grp], a0h.x, a1h.x, a0h.y, a1h.y, bh.x, bh.y);
        mma_bf16_16x8x16(acc[grp], a0h.z, a1h.z, a0h.w, a1h.w, bh.z, bh.w);
      }
    }
    const bool live0 = c0 < s_end && c0 + col_offset < valid;
    const bool live1 = c1 < s_end && c1 + col_offset < valid;
#pragma unroll
    for (int grp = 0; grp < GROUPS; ++grp) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float z = acc[grp][i];
        if (has_cap) z = cap * tanhf(z / cap);
        acc[grp][i] = z * inv_temp;
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float z0 = acc[grp][j];
        const float z1 = acc[grp][2 + j];
        if (!(live0 || live1)) continue;
        const float zmax = live0 ? (live1 ? fmaxf(z0, z1) : z0) : z1;
        const float mn = fmaxf(m[grp][j], zmax);
        a[grp][j] = a[grp][j] * expf(m[grp][j] - mn) +
                    (live0 ? expf(z0 - mn) : 0.f) +
                    (live1 ? expf(z1 - mn) : 0.f);
        m[grp][j] = mn;
      }
    }
    // candidate logits held by this tile (the list is uniform per block)
    for (int e = 0; e < nown; ++e) {
      const int col = own[2 * e + 1];
      if ((col >> 4) != tile) continue;
      const int i = own[2 * e];
      const int r = i / n_cand;
      const int cc = col & 15;
      if (g != (cc & 7) || t != ((r & 7) >> 1)) continue;
      const int e_grp = r >> 3;
      const int e_idx = 2 * (cc >> 3) + (r & 1);
      float val = 0.f;
#pragma unroll
      for (int grp = 0; grp < GROUPS; ++grp)
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (grp == e_grp && k == e_idx) val = acc[grp][k];
      zc[(size_t)row0 * n_cand + i] = val;
    }
  }

  // reduce (m, a) over the 8 lanes of a row (lane bits 2..4 are g), then
  // over the warps in a fixed order
#pragma unroll
  for (int grp = 0; grp < GROUPS; ++grp)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        const float om = __shfl_xor_sync(0xffffffffu, m[grp][j], off);
        const float oa = __shfl_xor_sync(0xffffffffu, a[grp][j], off);
        merge_state(m[grp][j], a[grp][j], om, oa);
      }
      if (g == 0) {
        const int r = grp * kGroupRows + 2 * t + j;
        red_m[warp * kRows + r] = m[grp][j];
        red_a[warp * kRows + r] = a[grp][j];
      }
    }
  __syncthreads();
  if (tid < kStaged && row0 + tid < rows) {
    float mm = -INFINITY, aa = 0.f;
    for (int wp = 0; wp < kWarps; ++wp)
      merge_state(mm, aa, red_m[wp * kRows + tid], red_a[wp * kRows + tid]);
    float* out = part + ((size_t)(row0 + tid) * n_split + split) * 2;
    out[0] = mm;
    out[1] = aa;
  }
}

// grid (ceil(rows / kMergeWarps)), one warp a row: lse from the row's
// n_split partial states (lane l merges slices l, l + 32, ... in order, then
// a fixed butterfly), and 0 for every candidate no slice owns.
__global__ void __launch_bounds__(kMergeWarps * 32)
    score_merge_kernel(const float* __restrict__ part,
                       const int* __restrict__ ids, float* __restrict__ lse,
                       float* __restrict__ zc, int rows, int n_split,
                       int n_cand, int v_orig, int valid, int col_offset) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kMergeWarps + warp;
  if (row >= rows) return;
  const float* pr = part + (size_t)row * n_split * 2;
  float m = -INFINITY, a = 0.f;
  for (int s = lane; s < n_split; s += 32)
    merge_state(m, a, pr[2 * s], pr[2 * s + 1]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float om = __shfl_xor_sync(0xffffffffu, m, off);
    const float oa = __shfl_xor_sync(0xffffffffu, a, off);
    merge_state(m, a, om, oa);
  }
  if (lane == 0) lse[row] = m + logf(a);
  for (int p = lane; p < n_cand; p += 32) {
    const int id = ids[(size_t)row * n_cand + p];
    const long long local = (long long)id - col_offset;
    if (!(local >= 0 && local < v_orig && id < valid))
      zc[(size_t)row * n_cand + p] = 0.f;
  }
}

template <int GROUPS>
cudaError_t launch_partial(const bf16* h, const bf16* w, const int* ids,
                           float* part, float* zc, int rows, int d,
                           int v_orig, int valid, int col_offset, int n_cand,
                           int block_v, int n_split, int has_cap, float cap,
                           float inv_temp, cudaStream_t s) {
  const size_t smem = smem_bytes(GROUPS, d, n_cand);
  cudaError_t err = cudaFuncSetAttribute(
      score_partial_kernel<GROUPS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  constexpr int kStaged = GROUPS * kGroupRows;
  dim3 grid((rows + kStaged - 1) / kStaged, n_split);
  score_partial_kernel<GROUPS><<<grid, kThreads, smem, s>>>(
      h, w, ids, part, zc, rows, d, v_orig, valid, col_offset, n_cand,
      block_v, n_split, has_cap, cap, inv_temp);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int score_tokens_max_cand() { return kMaxCand; }

int score_tokens_max_smem() { return kMaxSmem; }

// Row groups of 8 that a launch over `rows` rows stages per block: as many
// as the rows need, at most 4, and no more than fit in shared memory beside
// the candidate list; 0 when not even one group fits.
int score_tokens_groups(int rows, int d, int n_cand) {
  int groups = (rows + kGroupRows - 1) / kGroupRows;
  groups = groups < kMaxGroups ? groups : kMaxGroups;
  while (groups > 0 && smem_bytes(groups, d, n_cand) > (size_t)kMaxSmem)
    --groups;
  return groups;
}

// Shared memory a block of that launch takes (one group's when none fits).
long long score_tokens_smem_bytes(int rows, int d, int n_cand) {
  const int groups = score_tokens_groups(rows, d, n_cand);
  return (long long)smem_bytes(groups > 0 ? groups : 1, d, n_cand);
}

// Launches both kernels on `stream`; returns the cudaError_t of the
// launches.  part is (rows, n_split, 2) f32 scratch, lse (rows,) and
// zc (rows, n_cand) the results; ids is (rows, n_cand) int32.
int score_tokens_launch(const void* h, const void* w, const void* ids,
                        void* part, void* lse, void* zc, int rows, int d,
                        int v_orig, int valid, int col_offset, int n_cand,
                        int block_v, int has_cap, float cap, float inv_temp,
                        void* stream) {
  if (rows < 1 || d % 64 || n_cand < 1 || n_cand > kMaxCand ||
      block_v < 16 || block_v % 16 ||
      score_tokens_smem_bytes(rows, d, n_cand) > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  const int n_split = (v_orig + block_v - 1) / block_v;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const bf16* hp = static_cast<const bf16*>(h);
  const bf16* wp = static_cast<const bf16*>(w);
  const int* ip = static_cast<const int*>(ids);
  float* pp = static_cast<float*>(part);
  float* zp = static_cast<float*>(zc);
  cudaError_t err;
  switch (score_tokens_groups(rows, d, n_cand)) {
    case 1:
      err = launch_partial<1>(hp, wp, ip, pp, zp, rows, d, v_orig, valid,
                              col_offset, n_cand, block_v, n_split, has_cap,
                              cap, inv_temp, s);
      break;
    case 2:
      err = launch_partial<2>(hp, wp, ip, pp, zp, rows, d, v_orig, valid,
                              col_offset, n_cand, block_v, n_split, has_cap,
                              cap, inv_temp, s);
      break;
    case 3:
      err = launch_partial<3>(hp, wp, ip, pp, zp, rows, d, v_orig, valid,
                              col_offset, n_cand, block_v, n_split, has_cap,
                              cap, inv_temp, s);
      break;
    default:
      err = launch_partial<4>(hp, wp, ip, pp, zp, rows, d, v_orig, valid,
                              col_offset, n_cand, block_v, n_split, has_cap,
                              cap, inv_temp, s);
  }
  if (err != cudaSuccess) return (int)err;
  score_merge_kernel<<<(rows + kMergeWarps - 1) / kMergeWarps,
                       kMergeWarps * 32, 0, s>>>(
      pp, ip, static_cast<float*>(lse), zp, rows, n_split, n_cand, v_orig,
      valid, col_offset);
  return (int)cudaGetLastError();
}

const char* score_tokens_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
