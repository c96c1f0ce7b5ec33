// Log-probabilities of candidate tokens under softmax(h @ W^T), for Hopper
// (sm_90a), without the (rows, V) logits ever reaching device memory.
//
// Replaces repro/kernels/score_tokens/kernel.py:_score_kernel (the Pallas
// TPU kernel).  Same contract: for each row r of h and its n_cand candidate
// ids ids[r, :],
//   * z = h . w per column (f32 sums of exact bf16 products), times the
//     column's scale for a quantized head (w_scale: an int8, e4m3 or e5m2
//     W, widened to bf16 in shared memory by wstream.cuh), then
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
// Bound (H100 SXM, 3.35 TB/s, 989 TFLOP/s bf16): W read once.  At the
// speculative verifier's 32 rows against qwen3-0.6b's head (152064 x 1024
// bf16, 311 MB) that is ~93 us, against ~10 us of tensor-core time for
// the 10 GFLOP of products; at paper-lm's d 4096 (V 32768, 268 MB) ~80 us.
// Memory-bound, so the kernel is the shared W stream of
// common/wstream.cuh (a TMA ring of W and h boxes feeding wgmma, shared
// memory independent of d, ~132 CTAs each walking a vocab slice), with
// this epilogue on each 128-column tile:
//   * the softcap, 1/T and validity are applied in f32 on the CUDA cores,
//     and each row's online (m, a) is kept there too, by the fold this
//     kernel shares with sample_topk's return_lse (wstream::RowStates:
//     butterflies over a warp's 16 columns of a row, one lane of the 8
//     that share the row keeping its state);
//   * candidates: the ids of the CTA's rows that fall in its slice are
//     listed in shared memory first (16-bit index, 16-bit column), and the
//     one thread that holds such a logit in its fragment writes it to zc.
//     Exactly one slice owns a valid id, and the merge kernel writes the 0
//     of every id no slice owns, so each output is written once;
//   * at the end of the slice the 8 consumer warps' states of a row merge
//     in warp order; a second small kernel merges the slices in a fixed
//     order (wstream::slices_lse).  No float atomics: two calls on the
//     same inputs agree bit for bit;
//   * any number of candidates a row: past 64 a CTA takes a group of 64
//     (its list in shared memory stays R x 64 entries, and the 16-bit
//     index of an entry stays below 2^14), the groups of a slice as
//     neighbouring CTAs of one launch, group 0 alone folding the lse.  So
//     every group streams W again, through L2 where its neighbours have
//     brought it in (the grid has ceil(P / 64) x the CTAs): time that
//     grows with P / 64, written down beside the bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "wstream.cuh"

namespace {

using wstream::kConsumers;
using wstream::kThreads;

constexpr int kGroup = 64;           // candidates a row a CTA scores
constexpr int kRowsMax = 256;        // rows a row tile
constexpr int kRowsMaxQ = 128;       // ... with a 1-byte W (more threads)
constexpr int kMergeWarps = 8;       // merge kernel: one warp a row
constexpr int kWarps = kConsumers / 32;

// Shared memory beside the ring: the 8 warps' (m, a) of R rows and the
// candidate list (R x n_cand entries at most).
__host__ __device__ inline int epilogue_bytes(int r, int n_cand) {
  return 2 * kWarps * r * 4 + r * n_cand * 4;
}

// candidates a row a CTA takes: all of them up to 64, else groups of 64
__host__ __device__ inline int group_size(int n_cand) {
  return n_cand < kGroup ? n_cand : kGroup;
}

// `rows_max` (a row tile bound) and `per` (W tiles a slice) override the
// kernel's own choices where > 0 (wstream::override_ok).
__host__ __device__ inline int rows_bound(int wb) {
  return wb == 1 ? kRowsMaxQ : kRowsMax;
}

__host__ __device__ inline wstream::Plan plan(int rows, int v, int n_cand,
                                              int wb, int rows_max = 0,
                                              int per = 0) {
  wstream::Plan p = wstream::plan_grid(
      rows, v, rows_max ? rows_max : rows_bound(wb), per);
  wstream::plan_stages(p, epilogue_bytes(p.rows, group_size(n_cand)), wb);
  return p;
}

// grid (row_tiles x groups, slices), kThreads threads, plan(...).smem
// bytes.  blockIdx.x = group * row_tiles + row tile: group g scores the
// candidates [64 g, 64 g + 64) of its rows (all n_cand when n_cand <= 64,
// one group), so the CTAs of one slice stay neighbours in launch order and
// share its W bytes in L2.  Writes each row's (m, a) over its slice to
// part[(row * n_split + split) * 2 ...] (group 0 only) and the logits of
// the group's candidates the slice owns to zc.  W's elements are
// of hopper::WKind `kind` (kQ: a 1-byte kind, and a converter warpgroup
// before the producer warp widens each stage); with `ws` (v_orig f32, or
// null) each column's logit is multiplied by its scale before the softcap.
template <int N, bool kQ>
__global__ void __launch_bounds__(
    kThreads + (kQ ? wstream::converters(N) : 0), 1)
    score_stream_kernel(const __grid_constant__ CUtensorMap wmap,
                        const __grid_constant__ CUtensorMap hmap,
                        const int* __restrict__ ids, float* __restrict__ part,
                        float* __restrict__ zc, const float* __restrict__ ws,
                        int kind, int rows, int d, int v_orig, int valid,
                        int col_offset, int n_cand, int per, int n_split,
                        int stages, int has_cap, float cap, float inv_temp) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ int n_own;
  constexpr int kConv = kQ ? wstream::converters(N) : 0;
  wstream::Ring<N> ring;
  float* red = reinterpret_cast<float*>(wstream::ring_init(
      ring, smem_raw, stages, kind, kConv));             // 2 x kWarps x N
  int* own = reinterpret_cast<int*>(red + 2 * kWarps * N);

  const int gsz = group_size(n_cand);
  const int row_tiles = gridDim.x / ((n_cand + gsz - 1) / gsz);
  const int group = blockIdx.x / row_tiles;
  const int g0 = group * gsz;                  // the group's first candidate
  const int pg = min(gsz, n_cand - g0);        // and its candidates a row
  const int row0 = (blockIdx.x % row_tiles) * N;
  const int split = blockIdx.y;
  const int n_tiles = (v_orig + wstream::kCols - 1) / wstream::kCols;
  const int t_begin = split * per;
  const int t_end = min(t_begin + per, n_tiles);
  const int s0 = t_begin * wstream::kCols;
  const int s_end = min(t_end * wstream::kCols, v_orig);
  // stages a tile: 64 k columns each, 128 for a 1-byte W (the TMA zero
  // fills the k columns past d of a last, half-full stage)
  const int nk = kQ ? (d + 2 * wstream::kChunk - 1) / (2 * wstream::kChunk)
                    : d / wstream::kChunk;
  const int tid = threadIdx.x;
  if (tid == 0) n_own = 0;
  __syncthreads();
  if (tid >= kConsumers + kConv) {
    wstream::produce(ring, &wmap, &hmap, t_begin, t_end, nk, row0);
    return;
  }
  if (kQ && tid >= kConsumers) {
    wstream::convert<N, kConv>(ring, t_begin, t_end, nk, tid - kConsumers);
    return;
  }

  // list the candidates this slice owns while the ring fills: (index in
  // the row tile's share of the group, row * pg + candidate - g0) << 16 |
  // column within the slice; the list's order is irrelevant, each entry is
  // written by exactly one thread
  const int nrows = min(N, rows - row0);
  for (int i = tid; i < nrows * pg; i += kConsumers) {
    const int id = ids[(size_t)(row0 + i / pg) * n_cand + g0 + i % pg];
    const long long local = (long long)id - col_offset;
    if (local >= s0 && local < s_end && id < valid)
      own[atomicAdd(&n_own, 1)] = (i << 16) | (int)(local - s0);
  }
  hopper::bar_sync(1, kConsumers);
  const int nown = n_own;

  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int col_lo = (warp >> 2) * 64 + (warp & 3) * 16 + g;  // + 8 i
  constexpr int NJ = N / 8;
  wstream::RowStates<N> st;
  st.init();

  float acc[N / 2];
  int s = 0, cb = 0;
  uint32_t phase = 0, cphase = 0;
  for (int tile = t_begin; tile < t_end; ++tile) {
    float sc[2];
    wstream::load_scales(sc, ws, tile, col_lo, v_orig);
    wstream::consume_tile<N, kQ>(ring, acc, s, phase, nk, cb, cphase);
    const int c0 = tile * wstream::kCols + col_lo;
    const bool live0 = c0 < v_orig && c0 + col_offset < valid;
    const bool live1 = c0 + 8 < v_orig && c0 + 8 + col_offset < valid;
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      float z = acc[i];
      if (ws) z *= sc[(i >> 1) & 1];
      if (has_cap) z = cap * tanhf(z / cap);
      acc[i] = ((i >> 1) & 1 ? live1 : live0) ? z * inv_temp : -INFINITY;
    }
    if (group == 0) st.fold(acc, g);    // the lse is group 0's
    // candidate logits held by this tile's fragment
    const int tl = tile - t_begin;
    for (int e = 0; e < nown; ++e) {
      const int ent = own[e];
      const int col = ent & 0xffff;
      if ((col >> 7) != tl) continue;
      const int i = ent >> 16;
      const int r = i / pg;
      const int cc = col & 127;
      // the owner: warp cc / 16 (warpgroup cc / 64), lane (cc % 8, r % 8 / 2)
      if ((cc >> 4) != warp || (cc & 7) != g || ((r & 7) >> 1) != t)
        continue;
      const int sel = 2 * ((cc >> 3) & 1) + (r & 1);
      const int jr = r >> 3;
      float val = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (j == jr && q == sel) val = acc[4 * j + q];
      zc[(size_t)(row0 + r) * n_cand + g0 + i % pg] = val;
    }
  }

  // the 8 warps' states of each row, then a fixed warp order
  if (group == 0) st.store(red, part, row0, rows, n_split, split);
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
  const float l =
      wstream::slices_lse(part + (size_t)row * n_split * 2, n_split, lane);
  if (lane == 0) lse[row] = l;
  for (int p = lane; p < n_cand; p += 32) {
    const int id = ids[(size_t)row * n_cand + p];
    const long long local = (long long)id - col_offset;
    if (!(local >= 0 && local < v_orig && id < valid))
      zc[(size_t)row * n_cand + p] = 0.f;
  }
}

template <int N, bool kQ>
cudaError_t launch_stream(const CUtensorMap& wmap, const CUtensorMap& hmap,
                          const int* ids, float* part, float* zc,
                          const float* ws, int kind, int rows, int d,
                          int v_orig, int valid, int col_offset, int n_cand,
                          const wstream::Plan& p, int has_cap, float cap,
                          float inv_temp, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      score_stream_kernel<N, kQ>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return err;
  const int threads = kThreads + (kQ ? wstream::converters(N) : 0);
  const int groups = (n_cand + kGroup - 1) / kGroup;
  score_stream_kernel<N, kQ><<<dim3(p.row_tiles * groups, p.slices), threads,
                               p.smem, s>>>(wmap, hmap, ids, part, zc, ws, kind,
                                    rows, d, v_orig, valid, col_offset,
                                    n_cand, p.per, p.slices, p.stages,
                                    has_cap, cap, inv_temp);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The launch plan for (rows, V, n_cand, bytes a W element; past 64
// candidates a CTA takes a group of 64) under the overrides (rows_max,
// per; 0 keeps the kernel's own): {R, row_tiles, per, slices, stages,
// smem} into out[0..5] (the wrapper's Python mirror must agree).
void score_tokens_plan(int rows, int v_orig, int n_cand, int wb,
                       int rows_max, int per, int* out) {
  const wstream::Plan p = plan(rows, v_orig, n_cand, wb, rows_max, per);
  const int vals[6] = {p.rows, p.row_tiles, p.per, p.slices, p.stages,
                       p.smem};
  for (int i = 0; i < 6; ++i) out[i] = vals[i];
}

// Launches the stream kernel and the merge kernel on `stream` with the
// plan above: rows_max and per are the launch plan's overrides, 0 keeping
// the kernel's own choice, and any other value the kernel cannot take
// returns cudaErrorInvalidValue (never the own plan in its place); returns
// a cudaError_t.  part is (rows, slices, 2) f32
// scratch, lse (rows,) and zc (rows, n_cand) the results; ids is
// (rows, n_cand) int32.  W's elements are of hopper::WKind `kind`; ws,
// when not null, is the (v_orig,) f32 scale of each column.
int score_tokens_launch(const void* h, const void* w, const void* ids,
                        void* part, void* lse, void* zc, int rows, int d,
                        int v_orig, int valid, int col_offset, int n_cand,
                        int has_cap, float cap, float inv_temp,
                        const void* ws, int kind, int rows_max, int per,
                        void* stream) {
  const int wb = kind ? 1 : 2;
  if (rows < 1 || v_orig < 1 || d < wstream::kChunk ||
      d % wstream::kChunk || n_cand < 1 || kind < 0 ||
      kind > hopper::kE5M2 ||
      !wstream::override_ok(rows_max, per, rows_bound(wb)))
    return (int)cudaErrorInvalidValue;
  const wstream::Plan p = plan(rows, v_orig, n_cand, wb, rows_max, per);
  if (p.stages < 2 || p.smem > wstream::kMaxSmem ||
      ((rows_max || per) && p.slices > wstream::kMaxSlices))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int* ip = static_cast<const int*>(ids);
  float* pp = static_cast<float*>(part);
  float* zp = static_cast<float*>(zc);
  const float* wsp = static_cast<const float*>(ws);
  CUtensorMap wmap, hmap;
  int e = wstream::make_maps(&wmap, &hmap, w, h, v_orig, rows, d, p.rows,
                             kind);
  if (e) return e;
  cudaError_t err;
#define SCORE_CALL(n, q)                                                  \
  launch_stream<n, q>(wmap, hmap, ip, pp, zp, wsp, kind, rows, d, v_orig, \
                      valid, col_offset, n_cand, p, has_cap, cap,         \
                      inv_temp, s)
#define SCORE_CASE(n)                                                     \
  case n:                                                                 \
    err = kind ? SCORE_CALL(n, true) : SCORE_CALL(n, false);              \
    break;
  switch (p.rows) {
    SCORE_CASE(8) SCORE_CASE(16) SCORE_CASE(24) SCORE_CASE(32)
    SCORE_CASE(40) SCORE_CASE(48) SCORE_CASE(56) SCORE_CASE(64)
    SCORE_CASE(128)
    case 256:       // bf16 W only: a 1-byte W's row tiles stop at 128
      if (kind) return (int)cudaErrorInvalidValue;
      err = SCORE_CALL(256, false);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef SCORE_CASE
#undef SCORE_CALL
  if (err != cudaSuccess) return (int)err;
  score_merge_kernel<<<(rows + kMergeWarps - 1) / kMergeWarps,
                       kMergeWarps * 32, 0, s>>>(
      pp, ip, static_cast<float*>(lse), zp, rows, p.slices, n_cand, v_orig,
      valid, col_offset);
  return (int)cudaGetLastError();
}

const char* score_tokens_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
