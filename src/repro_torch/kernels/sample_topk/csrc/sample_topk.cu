// Streaming per-row top-k of softcap(h @ W^T) for Hopper (sm_90a).
//
// Replaces repro/kernels/sample_topk/kernel.py:_topk_kernel (the Pallas
// TPU kernel).  Same contract: for each row of h, the k largest values of
// the masked (optionally tanh-softcapped) logits as f32, with their global
// vocab ids as i32, sorted descending, ties to the lowest id.  A column is
// live iff local_col < v_orig and local_col + col_offset < valid.  The
// (rows, V) logits never reach device memory.  A NaN logit is treated as
// -inf, and every written id lies in [col_offset, col_offset + v_orig).
//
// The decode kernel (topk_stream_kernel, k <= 64 and k <= V) takes the few rows
// of a decode step or a speculative verifier (8 to 40).  Bound (H100 SXM,
// 3.35 TB/s, 989 TFLOP/s bf16): W read once, 152064 x 1024 bf16 = 311 MB
// -> ~93 us; the products at 40 rows are 12.5 GFLOP -> ~13 us on the
// tensor cores.  Memory-bound, so its main loop is the shared W stream of
// common/wstream.cuh (a TMA ring of W and h boxes feeding wgmma, shared
// memory independent of d, ~132 CTAs each walking a vocab slice), and the
// selection is built so that its cost does not grow k-fold:
//   * every candidate is one 64-bit key: the logit's f32 bits mapped to an
//     order-preserving u32 above (NaN -> -inf, -0 -> +0), ~local column
//     below.  Larger key = larger value, then lower id, so one u64 compare
//     is the contract's order and ties need no second pass;
//   * k = 1: each thread keeps the best key of each of its rows in
//     registers; the 8 lanes and 8 warps of a row merge by max at the end;
//   * k > 1: the wgmma warps stage each tile's logits in shared memory
//     (R x 128 f32, double-buffered through mbarriers) for 8 selection
//     warps of their own, so the selection of one tile overlaps the
//     products of the next.  The selection warp that owns a row keeps its
//     running top-64 list sorted in shared memory with the list's k-th key
//     as threshold.  A tile's keys above the threshold (all 128 on the
//     first tile, a few after) are compacted by ballot, sorted 32 at a time
//     by a bitonic network across the lanes, and merged into the list by
//     one bitonic merge (the top 64 of two sorted lists of 64 is the
//     bitonic sequence max(A[i], B[63 - i]), sorted in 6 steps); two rows
//     go through the networks together.  Later ids of the slice are always
//     larger, so a key equal to the threshold can never win.  The
//     selection is bound by its instruction throughput, so it has as many
//     warps as the wgmma side;
//   * each (row, slice) writes its top k keys, and a merge kernel (one CTA
//     of 32 warps a row) stages the row's slices x k keys in shared memory
//     and merges them by the same bitonic merge: each warp folds every
//     32nd list into its own, then the warps' lists fold pairwise; at k = 1
//     one warp a row takes the largest key.
// Two options of the JAX kernel serve the request modes (beam search,
// best-of-n, constrained decoding), and cost nothing when not asked for:
//   * allowed_mask, an s8 (rows, v_orig) mask: a 0 entry makes its column
//     -inf before the running list and before the lse, beside the validity
//     clamp.  At k = 1 the wgmma warps load their fragment's mask bytes
//     before a tile's products and read them after; at k > 1 the selection
//     warps read a row's 128 bytes of a tile coalesced.  It adds rows x V
//     bytes (1.2 MB at 8 rows) to W's 311 MB;
//   * return_lse: each (row, slice) also folds an online softmax (m, a)
//     over the same clamped and masked columns (at k = 1 by the wgmma
//     warps, with the fold score_tokens uses, wstream::RowStates; at k > 1
//     by the selection warp that owns the row, over the staged tile), and
//     the merge kernel folds the slices' pairs (wstream::slices_lse) into
//     lse = m + log a: -inf for a row with no live column.
// A quantized head (the JAX kernel's w_scale) is an int8, e4m3 or e5m2 W
// with a (v_orig,) f32 scale a column: the stream carries 1 byte a weight
// (wstream.cuh widens each stage to bf16 in shared memory), and each
// logit is multiplied by its column's scale before the softcap, the mask,
// the selection and the lse, so it combines with both options above.  The
// bound then halves: 155.7 MB of W and 0.61 MB of scales, ~46.7 us.
//
// The list kernel (topk_stream_kernel<8, false, kQ, true>, any k >= 1,
// routed there for k > 64 or k > V) is the decode kernel's W stream and
// staging with another selection, so it takes every option above:
//   * row tiles of 8 rows, one a selection warp, so a row's selection runs
//     on a warp of its own (a 40-row step is 5 row tiles; the row tiles of
//     a slice run side by side and share its W bytes in L2);
//   * each (row, slice) keeps a sorted list of kk = min(k, the slice's
//     columns) keys behind a running threshold, its kk-th key: in shared
//     memory while the 8 lists leave the ring 2 stages (kk <= 2683 on a
//     bf16 head, 1626 on a 1-byte one), else in the global scratch that
//     receives them anyway, so global scratch stays rows x slices x kk
//     keys and no logit is written.  A tile's keys above the threshold (all at first, few once
//     the list is full) are compacted, sorted by a bitonic network in
//     shared memory, and merged into the list in place by rank: a new key
//     goes to its index plus the list keys above it (a binary search), a
//     list key moves down by the new keys above it (a binary search of
//     the sorted new keys), walked from the list's end;
//   * the merge is a tree of launches, each halving the row's lists: a
//     key of a pair of sorted lists lands on its index plus its rank in
//     the other list (ties impossible: a key holds its column), so each
//     output is written once, with no sort and no atomics; a last kernel
//     turns the top k keys into (value, id), -inf and id col_offset past
//     the columns that exist (k > V, as the plain version pads), and
//     folds the lse.
//   Bound: the decode kernel's W read (the selection's work depends on the
//   data: every key of a slice's first tiles, then the few above the
//   threshold).
//
// The many-row top-1 path (topk_rows_kernel, k = 1 only) computes the same
// function for the MTP accuracy's 4096 rows.  There the bound flips: the
// products are 2 * 4096 * 1024 * 152064 = 1.28 TFLOP -> ~1.29 ms on the
// tensor cores, against ~0.1 ms of bytes, and a kernel that streams W once
// for every few rows would read it hundreds of times.  So this path tiles
// like a GEMM, on the main loop it shares with the fused-CE forward
// (common/rowtile.cuh: 128 rows of h by 256-column W tiles a CTA, a
// 4-stage TMA ring fed by one producer thread, two consumer warpgroups on
// wgmma m64n256k16, ~8 waves of CTAs over (row tiles, vocab slices)):
//   * the epilogue stays in registers: softcap, mask, NaN -> -inf, and a
//     running (value, id) best per row; each thread scans its columns in
//     ascending id order and replaces only on a strictly greater value,
//     and the quad merges under (value desc, id asc) once at the end;
//   * each (row, vocab slice) writes one partial, and a warp-per-row
//     merge kernel takes the best partial in the same order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <climits>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"
#include "rowtile.cuh"
#include "wstream.cuh"

namespace {

using u64 = unsigned long long;
using wstream::kConsumers;
using wstream::kThreads;

constexpr int kMaxK = 64;             // the running list of a row
constexpr int kRowsMax = 64;          // rows a row tile of the decode kernel
constexpr int kWarps = kConsumers / 32;
constexpr int kSelWarps = 8;          // k > 1: the selection warps
constexpr int kSelThreads = kConsumers + kSelWarps * 32 + 32;
constexpr int kZld = wstream::kCols + 4;  // staged row stride: no conflicts
constexpr int kMergeThreads = 1024;
constexpr int kMaxSlices = wstream::kMaxSlices;  // plan_grid's bound
constexpr int kMergeLoads =  // keys a merge thread loads
    (kMaxSlices * kMaxK + kMergeThreads - 1) / kMergeThreads;

__device__ __forceinline__ bool better(float va, int ia, float vb, int ib) {
  return va > vb || (va == vb && ia < ib);
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

// ---------------------------------------------------------------------------
// decode kernel: the shared W stream and a key-based selection
// ---------------------------------------------------------------------------

// Shared memory beside the ring.  k = 1: the 8 warps' best key of R rows
// (then, with return_lse, their (m, a) of R rows: as many bytes);
// k > 1: R sorted lists of 64 keys, R thresholds, a compaction scratch of
// 2 x 128 keys a selection warp, 4 mbarriers, two staged R x 128 tiles
// of logits and R (m, a) states.
__host__ __device__ inline int epilogue_bytes(int r, int k) {
  if (k == 1) return kWarps * r * 8;
  return r * kMaxK * 8 + r * 8 + kSelWarps * 2 * wstream::kCols * 8 + 4 * 8 +
         2 * r * kZld * 4 + 2 * r * 4;
}

// The decode kernel's plan; `rows_max` (a row tile bound) and `per` (W
// tiles a slice) override its own choices where > 0 (wstream::override_ok).
__host__ __device__ inline wstream::Plan plan(int rows, int v, int k, int wb,
                                              int rows_max = 0,
                                              int per = 0) {
  wstream::Plan p =
      wstream::plan_grid(rows, v, rows_max ? rows_max : kRowsMax, per);
  wstream::plan_stages(p, epilogue_bytes(p.rows, k), wb);
  return p;
}

// k > 64 (or k > V): the list kernel's row tiles of 8 rows, one a
// selection warp.  Shared memory beside the ring: the 8 rows' lists of kk
// keys when they fit (else they live in global scratch), the warps' 2 x
// 128-key scratch, 4 mbarriers and two staged 8 x 128 tiles of logits.
constexpr int kBigRows = kSelWarps;

__host__ __device__ inline bool big_k(int v, int k) {
  return k > kMaxK || k > v;
}

__host__ __device__ inline int big_epilogue_bytes(int kk, bool lists) {
  return (lists ? kBigRows * kk * 8 : 0) + kSelWarps * 2 * wstream::kCols * 8 +
         4 * 8 + 2 * kBigRows * kZld * 4;
}

// The list kernel's plan: the W stream's grid at 8 rows a tile, each
// (row, slice) list kk = min(k, the slice's columns) keys long, in shared
// memory when the ring still gets 2 stages beside the lists, else in
// global scratch (*in_smem 0).  `per` > 0 overrides the W tiles a slice
// (its row tiles stay 8 rows: the one override bound it takes is 8).
__host__ __device__ inline wstream::Plan plan_big(int rows, int v, int k,
                                                  int wb, int* kk,
                                                  int* in_smem,
                                                  int per = 0) {
  wstream::Plan p = wstream::plan_grid(rows, v, kBigRows, per);
  const int cols = p.per * wstream::kCols;
  *kk = k < cols ? k : cols;
  wstream::plan_stages(p, big_epilogue_bytes(*kk, true), wb);
  *in_smem = p.stages >= 2;
  if (!*in_smem) wstream::plan_stages(p, big_epilogue_bytes(*kk, false), wb);
  return p;
}

// The key of logit z at local column `local` (never 0: -inf maps to
// 0x007fffff above); 0 is "no column".
__device__ __forceinline__ u64 make_key(float z, int local) {
  if (isnan(z)) z = -INFINITY;
  const uint32_t u = __float_as_uint(z + 0.f);      // -0 -> +0
  const uint32_t ord = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((u64)ord << 32) | (uint32_t)(0xffffffffu - (uint32_t)local);
}

__device__ __forceinline__ float key_value(u64 key) {
  const uint32_t ord = (uint32_t)(key >> 32);
  return __uint_as_float((ord & 0x80000000u) ? (ord & 0x7fffffffu) : ~ord);
}

__device__ __forceinline__ int key_local(u64 key) {
  return (int)(0xffffffffu - (uint32_t)key);
}

__device__ __forceinline__ u64 shfl_xor64(u64 x, int m) {
  const uint32_t lo = __shfl_xor_sync(0xffffffffu, (uint32_t)x, m);
  const uint32_t hi = __shfl_xor_sync(0xffffffffu, (uint32_t)(x >> 32), m);
  return ((u64)hi << 32) | lo;
}

__device__ __forceinline__ u64 umax(u64 a, u64 b) { return a > b ? a : b; }
__device__ __forceinline__ u64 umin(u64 a, u64 b) { return a < b ? a : b; }

// NR independent sets of one key a lane, nonzero in lanes < S only ->
// each set's keys sorted descending in lanes 0..S-1 (zeros after them);
// the sets' networks interleave
template <int NR, int S>
__device__ __forceinline__ void sort_desc(u64 (&x)[NR], int lane) {
#pragma unroll
  for (int size = 2; size <= S; size <<= 1)
#pragma unroll
    for (int st = size >> 1; st > 0; st >>= 1) {
      const bool keep_max = ((lane & st) == 0) == ((lane & size) == 0);
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        const u64 o = shfl_xor64(x[r], st);
        x[r] = keep_max ? umax(x[r], o) : umin(x[r], o);
      }
    }
}

// NR bitonic sequences of 64 keys (a0 = element lane, a1 = element 32 +
// lane) -> each sorted descending.
template <int NR>
__device__ __forceinline__ void merge64_desc(u64 (&a0)[NR], u64 (&a1)[NR],
                                             int lane) {
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    const u64 hi = umax(a0[r], a1[r]);
    a1[r] = umin(a0[r], a1[r]);
    a0[r] = hi;
  }
#pragma unroll
  for (int st = 16; st > 0; st >>= 1) {
    const bool lower = (lane & st) == 0;
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      const u64 o0 = shfl_xor64(a0[r], st);
      const u64 o1 = shfl_xor64(a1[r], st);
      a0[r] = lower ? umax(a0[r], o0) : umin(a0[r], o0);
      a1[r] = lower ? umax(a1[r], o1) : umin(a1[r], o1);
    }
  }
}

// (a0, a1) := the top 64 of itself and the sorted list b[0..kb) (kb <= 64,
// missing keys 0), both sorted descending.
__device__ __forceinline__ void fold_list(u64& a0, u64& a1, const u64* b,
                                          int kb, int lane) {
  u64 x0[1] = {umax(a0, 63 - lane < kb ? b[63 - lane] : 0ull)};
  u64 x1[1] = {umax(a1, 31 - lane < kb ? b[31 - lane] : 0ull)};
  merge64_desc(x0, x1, lane);
  a0 = x0[0];
  a1 = x1[0];
}

// The k > 1 selection warps: for each staged tile, warp sw updates rows
// sw, sw + 8, ... two at a time (rows n and n + 8, whose sorting networks
// interleave): the keys above the row's threshold are compacted, sorted
// 32 at a time and merged into the row's sorted list, whose k-th key
// becomes the row's threshold.
// With `mask` (rows x v_orig s8) a 0 entry makes its column -inf; with
// `lse_st` (N m's, then N a's) each row's online softmax over the tile's
// counted columns folds into its state, which only its warp touches.
template <int N>
__device__ void select_tile(const float* zs, u64* lst, u64* thr, u64* sc,
                            float* lse_st, const int8_t* __restrict__ mask,
                            int row0, int rows, int cbase, int v_orig,
                            int valid, int col_offset, int k, int has_softcap,
                            float softcap, int sw, int lane) {
  for (int n0 = sw; n0 < N && row0 + n0 < rows; n0 += 2 * kSelWarps) {
    const int nr[2] = {n0, n0 + kSelWarps};
    const bool has1 = nr[1] < N && row0 + nr[1] < rows;
    u64 key[2][4];
    uint32_t bal[2][4];
    int m[2] = {0, 0};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const bool here = r == 0 || has1;
      const u64 th = here ? thr[nr[r]] : ~0ull;
      float zc[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int col = 32 * q + lane;
        const int local = cbase + col;
        float z = here ? zs[nr[r] * kZld + col] : 0.f;
        if (has_softcap) z = softcap * tanhf(z / softcap);
        bool live = local < v_orig && local + col_offset < valid;
        if (mask && here && live)
          live = mask[(size_t)(row0 + nr[r]) * v_orig + local] != 0;
        zc[q] = live && !isnan(z) ? z : -INFINITY;
        key[r][q] = local < v_orig ? make_key(zc[q], local) : 0ull;
        bal[r][q] = __ballot_sync(0xffffffffu, key[r][q] > th);
        m[r] += __popc(bal[r][q]);
      }
      if (lse_st && here) {
        float mx = fmaxf(fmaxf(zc[0], zc[1]), fmaxf(zc[2], zc[3]));
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float safe = mx == -INFINITY ? 0.f : mx;
        float sum = 0.f;
#pragma unroll
        for (int q = 0; q < 4; ++q) sum += expf(zc[q] - safe);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, off);
        if (lane == 0)
          wstream::merge_state(lse_st[nr[r]], lse_st[N + nr[r]], mx, sum);
      }
    }
    if (m[0] + m[1] == 0) continue;
    const uint32_t below = (1u << lane) - 1u;
    u64 a0[2], a1[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      int base = 0;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if ((bal[r][q] >> lane) & 1u)
          sc[r * wstream::kCols + base + __popc(bal[r][q] & below)] =
              key[r][q];
        base += __popc(bal[r][q]);
      }
      a0[r] = m[r] ? lst[nr[r] * kMaxK + lane] : 0ull;
      a1[r] = m[r] ? lst[nr[r] * kMaxK + 32 + lane] : 0ull;
    }
    __syncwarp();
    const int mm = max(m[0], m[1]);
    for (int c = 0; c < mm; c += 32) {
      u64 x[2];
#pragma unroll
      for (int r = 0; r < 2; ++r)
        x[r] = c + lane < m[r] ? sc[r * wstream::kCols + c + lane] : 0ull;
      sort_desc<2, 32>(x, lane);
#pragma unroll
      for (int r = 0; r < 2; ++r)   // B[31 - lane] of (x, 0, ...)
        a1[r] = umax(a1[r], shfl_xor64(x[r], 31));
      merge64_desc(a0, a1, lane);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const u64 kth =
          __shfl_sync(0xffffffffu, k <= 32 ? a0[r] : a1[r], (k - 1) & 31);
      if (!m[r]) continue;
      lst[nr[r] * kMaxK + lane] = a0[r];
      lst[nr[r] * kMaxK + 32 + lane] = a1[r];
      if (lane == 0) thr[nr[r]] = kth;
    }
    __syncwarp();
  }
}

// ---------------------------------------------------------------------------
// k > 64: lists of kk keys a (row, slice), merged by rank
// ---------------------------------------------------------------------------

// # keys of a[0..n) (sorted descending) above x, and at or above x
__device__ __forceinline__ int count_gt(const u64* a, int n, u64 x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] > x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ int count_ge(const u64* a, int n, u64 x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] >= x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// One warp: sc[0..n) (n a power of two <= 128) sorted descending by a
// bitonic network in shared memory.
__device__ __forceinline__ void sort_smem_desc(u64* sc, int n, int lane) {
  for (int size = 2; size <= n; size <<= 1)
    for (int st = size >> 1; st > 0; st >>= 1) {
      for (int p = lane; p < n / 2; p += 32) {
        const int i = 2 * p - (p & (st - 1)), j = i + st;
        const u64 a = sc[i], b = sc[j];
        if ((i & size) == 0 ? a < b : a > b) {
          sc[i] = b;
          sc[j] = a;
        }
      }
      __syncwarp();
    }
}

// The list kernel's selection of one staged tile for one row, by the warp
// that owns the row: its keys above the threshold `th` (the list's kk-th
// key, 0 while the list is not full) are compacted into sc, sorted, and
// merged into the row's sorted list lst[0..kk) (shared or global memory,
// zero-padded) in place: every new key goes to its index plus the count of
// list keys above it, and every list key at or after the first new key's
// place moves down by the count of new keys above it, the list walked from
// its end in chunks of 32 so that no key is overwritten before it is read;
// keys pushed past kk drop out.  With `lse` the row's online softmax (m, a)
// folds the tile's counted columns; `mrow` is the row's mask (or null).
__device__ void select_big(const float* z, u64* lst, int kk, u64& th,
                           float& m, float& a, bool lse,
                           const int8_t* __restrict__ mrow, int cbase,
                           int v_orig, int valid, int col_offset,
                           int has_softcap, float softcap, u64* sc,
                           int lane) {
  u64 key[4];
  uint32_t bal[4];
  float zc[4];
  int n = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int col = 32 * q + lane;
    const int local = cbase + col;
    float v = z[col];
    if (has_softcap) v = softcap * tanhf(v / softcap);
    bool live = local < v_orig && local + col_offset < valid;
    if (mrow && live) live = mrow[local] != 0;
    zc[q] = live && !isnan(v) ? v : -INFINITY;
    key[q] = local < v_orig ? make_key(zc[q], local) : 0ull;
    bal[q] = __ballot_sync(0xffffffffu, key[q] > th);
    n += __popc(bal[q]);
  }
  if (lse) {
    float mx = fmaxf(fmaxf(zc[0], zc[1]), fmaxf(zc[2], zc[3]));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float safe = mx == -INFINITY ? 0.f : mx;
    float sum = 0.f;
#pragma unroll
    for (int q = 0; q < 4; ++q) sum += expf(zc[q] - safe);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    wstream::merge_state(m, a, mx, sum);
  }
  if (n == 0) return;
  const uint32_t below = (1u << lane) - 1u;
  int base = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if ((bal[q] >> lane) & 1u) sc[base + __popc(bal[q] & below)] = key[q];
    base += __popc(bal[q]);
  }
  int np2 = 1;
  while (np2 < n) np2 <<= 1;
  for (int i = n + lane; i < np2; i += 32) sc[i] = 0ull;
  __syncwarp();
  sort_smem_desc(sc, np2, lane);
  // the new keys' places in the merged list, before the list moves
  u64 b[4];
  int pos[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int j = 32 * q + lane;
    b[q] = j < n ? sc[j] : 0ull;
    pos[q] = j < n ? j + count_gt(lst, kk, b[q]) : kk;
  }
  const int r0 = __shfl_sync(0xffffffffu, pos[0], 0);
  for (int c = ((kk - 1) >> 5) << 5; c >= 0 && c + 31 >= r0; c -= 32) {
    const int i = c + lane;
    const bool act = i >= r0 && i < kk;
    const u64 x = act ? lst[i] : 0ull;
    const int to = act ? i + count_gt(sc, n, x) : i;
    __syncwarp();
    if (act && to != i && to < kk) lst[to] = x;
    __syncwarp();
  }
#pragma unroll
  for (int q = 0; q < 4; ++q)
    if (pos[q] < kk) lst[pos[q]] = b[q];
  __syncwarp();
  th = lst[kk - 1];
}

// grid (row_tiles, slices), kThreads threads (k = 1) or kSelThreads (k >
// 1), plan(...).smem bytes.  Writes the top k keys of each row over its
// slice, sorted descending, to pk[((row * n_split + split) * k ...].
// Threads 0..255 issue the wgmma; at k > 1 threads 256..511 (the selection
// warps) consume the tiles they stage, double-buffered through mbarriers,
// so the selection of tile t overlaps the products of tile t + 1; the last
// warp is the producer.
// With `mask` (rows x v_orig s8, or null) a 0 entry makes its column -inf;
// with `pl` (or null) each (row, slice)'s online softmax (m, a) over its
// counted columns goes to pl[(row * n_split + split) * 2 + {0, 1}].  W's
// elements are of hopper::WKind `kind` (kQ: a 1-byte kind, and a
// converter warpgroup before the producer warp widens each stage); with
// `ws` (v_orig f32, or null) each column's logit is multiplied by its
// scale before the softcap.
// kBig (the list kernel, N = 8): selection warp w owns row w; k is the
// list length kk, and each (row, slice)'s top kk keys, sorted and
// zero-padded, go to pk[((row * n_split + split) * kk ...], the list kept
// there (big_smem 0) or in shared memory and copied out at the end.
template <int N, bool kOne, bool kQ, bool kBig>
__global__ void __launch_bounds__(
    (kOne ? kThreads : kSelThreads) +
        (kQ ? wstream::converters(N) : 0), 1)
    topk_stream_kernel(const __grid_constant__ CUtensorMap wmap,
                       const __grid_constant__ CUtensorMap hmap,
                       u64* __restrict__ pk, const int8_t* __restrict__ mask,
                       float* __restrict__ pl, const float* __restrict__ ws,
                       int kind, int rows, int d, int v_orig, int valid,
                       int col_offset, int k, int per, int n_split,
                       int stages, int has_softcap, float softcap,
                       int big_smem) {
  using namespace hopper;
  static_assert(!kBig || (N == kBigRows && !kOne), "the list kernel");
  extern __shared__ unsigned char smem_raw[];
  constexpr int kConv = kQ ? wstream::converters(N) : 0;
  wstream::Ring<N> ring;
  u64* epi = reinterpret_cast<u64*>(
      wstream::ring_init(ring, smem_raw, stages, kind, kConv));
  u64* lst = epi;                       // k > 1: N x 64 (kBig: N x kk)
  u64* thr = lst + N * kMaxK;           //        N
  u64* scr = kBig ? lst + (big_smem ? (size_t)N * k : 0)
                  : thr + N;            //        8 x 2 x 128
  uint64_t* zbar =                      // full[2], empty[2]
      reinterpret_cast<uint64_t*>(scr + kSelWarps * 2 * wstream::kCols);
  float* zs = reinterpret_cast<float*>(zbar + 4);  // 2 x N x kZld
  float* lse_st = zs + 2 * N * kZld;               // N m's, N a's

  const int row0 = blockIdx.x * N;
  const int split = blockIdx.y;
  const int n_tiles = (v_orig + wstream::kCols - 1) / wstream::kCols;
  const int t_begin = split * per;
  const int t_end = min(t_begin + per, n_tiles);
  // stages a tile: 64 k columns each, 128 for a 1-byte W (the TMA zero
  // fills the k columns past d of a last, half-full stage)
  const int nk = kQ ? (d + 2 * wstream::kChunk - 1) / (2 * wstream::kChunk)
                    : d / wstream::kChunk;
  const int tid = threadIdx.x;
  constexpr int kAll = (kOne ? kThreads : kSelThreads) + kConv;
  if (!kOne) {
    if constexpr (kBig) {
      if (big_smem)
        for (int i = tid; i < N * k; i += kAll) lst[i] = 0ull;
    } else {
      for (int i = tid; i < N * (kMaxK + 1); i += kAll) lst[i] = 0ull;
      for (int i = tid; i < N; i += kAll) {
        lse_st[i] = -INFINITY;
        lse_st[N + i] = 0.f;
      }
    }
    if (tid == 0) {
      for (int b = 0; b < 2; ++b) {
        mbar_init(&zbar[b], kConsumers);       // a tile staged in zs[b]
        mbar_init(&zbar[2 + b], kSelWarps * 32);  // zs[b] read
      }
      fence_mbar_init();
    }
  }
  __syncthreads();
  if (tid >= kAll - 32) {
    wstream::produce(ring, &wmap, &hmap, t_begin, t_end, nk, row0);
    return;
  }
  if (kQ && tid >= kAll - 32 - kConv) {
    wstream::convert<N, kConv>(ring, t_begin, t_end, nk,
                               tid - (kAll - 32 - kConv));
    return;
  }
  const int lane = tid & 31;
  if (!kOne && tid >= kConsumers) {
    const int sw = (tid - kConsumers) >> 5;
    u64* sc = scr + sw * 2 * wstream::kCols;
    if constexpr (kBig) {
      const int row = row0 + sw;
      const bool has = row < rows;
      u64* out = pk + ((size_t)row * n_split + split) * k;
      u64* L = big_smem ? lst + sw * k : out;
      if (has && !big_smem)
        for (int i = lane; i < k; i += 32) L[i] = 0ull;
      __syncwarp();
      u64 th = 0ull;
      float lm = -INFINITY, la = 0.f;
      const int8_t* mrow = mask && has ? mask + (size_t)row * v_orig : nullptr;
      for (int tile = t_begin; tile < t_end; ++tile) {
        const int tl = tile - t_begin;
        mbar_wait(&zbar[tl & 1], (tl >> 1) & 1);
        if (has)
          select_big(zs + (tl & 1) * N * kZld + sw * kZld, L, k, th, lm, la,
                     pl != nullptr, mrow, tile * wstream::kCols, v_orig,
                     valid, col_offset, has_softcap, softcap, sc, lane);
        mbar_arrive(&zbar[2 + (tl & 1)]);
      }
      if (!has) return;
      if (big_smem)
        for (int i = lane; i < k; i += 32) out[i] = L[i];
      if (pl && lane == 0) {
        float* o = pl + ((size_t)row * n_split + split) * 2;
        o[0] = lm;
        o[1] = la;
      }
      return;
    }
    for (int tile = t_begin; tile < t_end; ++tile) {
      const int tl = tile - t_begin;
      mbar_wait(&zbar[tl & 1], (tl >> 1) & 1);
      select_tile<N>(zs + (tl & 1) * N * kZld, lst, thr, sc,
                     pl ? lse_st : nullptr, mask, row0, rows,
                     tile * wstream::kCols, v_orig, valid, col_offset, k,
                     has_softcap, softcap, sw, lane);
      mbar_arrive(&zbar[2 + (tl & 1)]);
    }
    for (int n = sw; n < N && row0 + n < rows; n += kSelWarps) {
      u64* out = pk + ((size_t)(row0 + n) * n_split + split) * k;
      for (int i = lane; i < k; i += 32) out[i] = lst[n * kMaxK + i];
      if (pl && lane == 0) {
        float* o = pl + ((size_t)(row0 + n) * n_split + split) * 2;
        o[0] = lse_st[n];
        o[1] = lse_st[N + n];
      }
    }
    return;
  }

  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int col_lo = (warp >> 2) * 64 + (warp & 3) * 16 + g;  // + 8 i
  constexpr int NJ = N / 8;
  u64 best[kOne ? NJ : 1][2];
#pragma unroll
  for (int j = 0; j < (kOne ? NJ : 1); ++j) best[j][0] = best[j][1] = 0ull;

  wstream::RowStates<N> st;
  st.init();
  float acc[N / 2];
  int s = 0, cb = 0;
  uint32_t phase = 0, cphase = 0;
  for (int tile = t_begin; tile < t_end; ++tile) {
    // k = 1 with a mask: the fragment's mask bytes are loaded before the
    // tile's products and read after them
    int8_t allow[NJ][2][2];
    if (kOne && mask) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int local = tile * wstream::kCols + col_lo + 8 * i;
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int row = row0 + 8 * j + 2 * t + c;
            allow[j][i][c] = row < rows && local < v_orig
                                 ? mask[(size_t)row * v_orig + local]
                                 : (int8_t)1;
          }
      }
    }
    float sc[2];
    wstream::load_scales(sc, ws, tile, col_lo, v_orig);
    wstream::consume_tile<N, kQ>(ring, acc, s, phase, nk, cb, cphase);
    if (kOne) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int local = tile * wstream::kCols + col_lo + 8 * i;
        const bool exists = local < v_orig;
        const bool live = exists && local + col_offset < valid;
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            float z = acc[4 * j + 2 * i + c];
            if (ws) z *= sc[i];
            if (has_softcap) z = softcap * tanhf(z / softcap);
            const bool ok = live && (!mask || allow[j][i][c] != 0);
            z = ok && !isnan(z) ? z : -INFINITY;
            acc[4 * j + 2 * i + c] = z;
            best[j][c] = umax(best[j][c], exists ? make_key(z, local) : 0ull);
          }
      }
      if (pl) st.fold(acc, g);
      continue;
    }
    // stage the tile in zs[tl % 2] once the selection has read it
    const int tl = tile - t_begin;
    float* z = zs + (tl & 1) * N * kZld;
    mbar_wait(&zbar[2 + (tl & 1)], ((tl >> 1) & 1) ^ 1);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < 2; ++c)
          z[(8 * j + 2 * t + c) * kZld + col_lo + 8 * i] =
              ws ? acc[4 * j + 2 * i + c] * sc[i] : acc[4 * j + 2 * i + c];
    mbar_arrive(&zbar[tl & 1]);
  }
  if (!kOne) return;

  // k = 1: the 8 lanes of a row, then the 8 warps (max: any order)
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
#pragma unroll
      for (int off = 4; off < 32; off <<= 1)
        best[j][c] = umax(best[j][c], shfl_xor64(best[j][c], off));
      if (g == 0) epi[warp * N + 8 * j + 2 * t + c] = best[j][c];
    }
  bar_sync(1, kConsumers);
  if (tid < N && row0 + tid < rows) {
    u64 b = 0ull;
    for (int wp = 0; wp < kWarps; ++wp) b = umax(b, epi[wp * N + tid]);
    pk[(size_t)(row0 + tid) * n_split + split] = b;
  }
  if (!pl) return;
  bar_sync(1, kConsumers);   // epi is read; it now takes the (m, a) states
  st.store(reinterpret_cast<float*>(epi), pl, row0, rows, n_split, split);
}

// grid (rows), kMergeThreads threads, n_split * k * 8 bytes of dynamic
// shared memory: the top k of each row's n_split sorted lists.  Each of
// the 32 warps folds every 32nd list into its own, then the warps' lists
// fold pairwise in 5 levels.
__global__ void __launch_bounds__(kMergeThreads)
    topk_stream_merge_kernel(const u64* __restrict__ pk,
                             const float* __restrict__ pl,
                             float* __restrict__ vals, int* __restrict__ ids,
                             float* __restrict__ lse, int n_split, int k,
                             int col_offset) {
  extern __shared__ u64 sp[];
  __shared__ u64 wl[kMergeThreads / 32][kMaxK];
  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const u64* src = pk + (size_t)row * n_split * k;
  const int total = n_split * k;
  u64 buf[kMergeLoads];  // every load in flight at once
#pragma unroll
  for (int j = 0; j < kMergeLoads; ++j) {
    const int i = tid + j * kMergeThreads;
    buf[j] = i < total ? src[i] : 0ull;
  }
#pragma unroll
  for (int j = 0; j < kMergeLoads; ++j) {
    const int i = tid + j * kMergeThreads;
    if (i < total) sp[i] = buf[j];
  }
  __syncthreads();
  u64 a0 = 0ull, a1 = 0ull;
  for (int l = warp; l < n_split; l += kMergeThreads / 32)
    fold_list(a0, a1, sp + l * k, k, lane);
  for (int st = kMergeThreads / 64; st > 0; st >>= 1) {
    if (warp >= st && warp < 2 * st) {
      wl[warp][lane] = a0;
      wl[warp][32 + lane] = a1;
    }
    __syncthreads();
    if (warp < st) fold_list(a0, a1, wl[warp + st], kMaxK, lane);
  }
  if (warp != 0) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = 32 * h + lane;
    if (i >= k) continue;
    const u64 key = h ? a1 : a0;       // never 0: k <= v_orig
    vals[(size_t)row * k + i] = key_value(key);
    ids[(size_t)row * k + i] = key_local(key) + col_offset;
  }
  if (!lse) return;
  const float l =
      wstream::slices_lse(pl + (size_t)row * n_split * 2, n_split, lane);
  if (lane == 0) lse[row] = l;
}

// k = 1: grid ceil(rows / 8), one warp a row takes the largest of the
// row's n_split keys.
__global__ void __launch_bounds__(256)
    key1_merge_kernel(const u64* __restrict__ pk,
                      const float* __restrict__ pl, float* __restrict__ vals,
                      int* __restrict__ ids, float* __restrict__ lse,
                      int rows, int n_split, int col_offset) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  u64 b = 0ull;
  for (int s = lane; s < n_split; s += 32)
    b = umax(b, pk[(size_t)row * n_split + s]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) b = umax(b, shfl_xor64(b, off));
  if (lane == 0) {
    vals[row] = key_value(b);
    ids[row] = key_local(b) + col_offset;
  }
  if (!lse) return;
  const float l =
      wstream::slices_lse(pl + (size_t)row * n_split * 2, n_split, lane);
  if (lane == 0) lse[row] = l;
}

template <int N>
cudaError_t launch_stream(const CUtensorMap& wmap, const CUtensorMap& hmap,
                          u64* pk, const int8_t* mask, float* pl,
                          const float* ws, int kind, int rows, int d,
                          int v_orig, int valid, int col_offset, int k,
                          const wstream::Plan& p, int has_softcap,
                          float softcap, cudaStream_t s) {
  const bool q = kind != hopper::kBf16;
  auto kern = k == 1 ? (q ? topk_stream_kernel<N, true, true, false>
                          : topk_stream_kernel<N, true, false, false>)
                     : (q ? topk_stream_kernel<N, false, true, false>
                          : topk_stream_kernel<N, false, false, false>);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return err;
  const int threads = (k == 1 ? kThreads : kSelThreads) +
                      (q ? wstream::converters(N) : 0);
  kern<<<dim3(p.row_tiles, p.slices), threads, p.smem, s>>>(
      wmap, hmap, pk, mask, pl, ws, kind, rows, d, v_orig, valid, col_offset,
      k, p.per, p.slices, p.stages, has_softcap, softcap, 0);
  return cudaGetLastError();
}

// grid (rows, lists out, ceil(2 len / 256)), 256 threads: one level of the
// list kernel's merge tree.  src holds each row's n_lists sorted,
// zero-padded lists at `stride` keys a row: list i at i * len, all len
// keys long but the last (`last`); out list o = the top len_out (the last
// one: last_out) of lists 2o and 2o + 1, packed the same way in dst.  Each
// key of the pair goes to its index plus the count of the other list's
// keys above it (the first list's at or above it, so its zeros come
// first): the pair's keys land on a permutation of their places, each
// written once, and the places past the list's length drop out.
__global__ void __launch_bounds__(256)
    topk_big_merge_kernel(const u64* __restrict__ src, u64* __restrict__ dst,
                          int n_lists, int len, int last, int len_out,
                          int last_out, int stride) {
  const int row = blockIdx.x;
  const int o = blockIdx.y;
  const int p = blockIdx.z * 256 + threadIdx.x;
  const int ia = 2 * o, ib = 2 * o + 1;
  const int la = ia == n_lists - 1 ? last : len;
  const int lb = ib < n_lists ? (ib == n_lists - 1 ? last : len) : 0;
  const int lo = o == (int)gridDim.y - 1 ? last_out : len_out;
  if (p >= la + lb) return;
  const u64* a = src + (size_t)row * stride + (size_t)ia * len;
  const u64* b = a + len;
  u64 x;
  int at;
  if (p < la) {
    x = a[p];
    at = p + count_gt(b, lb, x);
  } else {
    x = b[p - la];
    at = p - la + count_ge(a, la, x);
  }
  if (at < lo) dst[(size_t)row * stride + (size_t)o * len_out + at] = x;
}

// grid (rows, ceil(k / 256)), 256 threads: the row's top k from its final
// list (flen keys, zero-padded past them): a key's value and global id, and
// -inf with id col_offset where no column is left (k > V, as the plain
// version pads); block (row, 0) also folds the lse.
__global__ void __launch_bounds__(256)
    topk_big_finish_kernel(const u64* __restrict__ fin,
                           const float* __restrict__ pl,
                           float* __restrict__ vals, int* __restrict__ ids,
                           float* __restrict__ lse, int flen, int stride,
                           int n_split, int k, int col_offset) {
  const int row = blockIdx.x;
  const int p = blockIdx.y * 256 + threadIdx.x;
  if (p < k) {
    const u64 key = p < flen ? fin[(size_t)row * stride + p] : 0ull;
    vals[(size_t)row * k + p] = key ? key_value(key) : -INFINITY;
    ids[(size_t)row * k + p] = (key ? key_local(key) : 0) + col_offset;
  }
  if (!lse || blockIdx.y != 0 || threadIdx.x >= 32) return;
  const float l = wstream::slices_lse(pl + (size_t)row * n_split * 2,
                                      n_split, threadIdx.x);
  if (threadIdx.x == 0) lse[row] = l;
}

// ---------------------------------------------------------------------------
// many-row top-1 path
// ---------------------------------------------------------------------------

// grid (ceil(rows / 128), n_split), rowtile::kThreads threads,
// rowtile::kSmem bytes.  Slice `split` covers vocab tiles [split * per,
// (split + 1) * per); each row's best masked logit over it goes to
// pvals/pids[row * n_split + split].
__global__ void __launch_bounds__(rowtile::kThreads, 1)
    topk_rows_kernel(const __grid_constant__ CUtensorMap hmap,
                     const __grid_constant__ CUtensorMap wmap,
                     float* __restrict__ pvals, int* __restrict__ pids,
                     int rows, int d, int v_orig, int valid, int col_offset,
                     int per, int n_split, int has_softcap, float softcap) {
  using rowtile::kCols;
  extern __shared__ unsigned char smem_raw[];
  const rowtile::Ring ring = rowtile::setup(smem_raw);
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
    return;
  }

  const int cw = wg - 1;                // consumer: rows cw * 64 ..
  const int wt = threadIdx.x % 128;
  const int lane = wt & 31;
  const int t = lane & 3;
  float acc[rowtile::kAcc];
  float bv[2] = {-INFINITY, -INFINITY};
  int bi[2] = {INT_MAX, INT_MAX};
  int it = 0;
  for (int tile = t_begin; tile < t_end; ++tile) {
    rowtile::tile_product(acc, ring, cw, nk, it);
    // epilogue: columns in ascending order, strictly greater replaces
    const int c_base = tile * kCols;
#pragma unroll
    for (int j = 0; j < kCols / 8; ++j)
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

}  // namespace

extern "C" {

// The decode kernel's plan for (rows, V, k, bytes a W element) under the
// launch plan's overrides (rows_max, per; 0 keeps the kernel's own), the
// list kernel's where k > 64 or k > V: {R, row_tiles, per, slices,
// stages, smem} into out[0..5] (the wrapper's Python mirror must agree).
void sample_topk_plan(int rows, int v_orig, int k, int wb, int rows_max,
                      int per, int* out) {
  int kk = 0, in_smem = 0;
  const wstream::Plan p =
      big_k(v_orig, k) ? plan_big(rows, v_orig, k, wb, &kk, &in_smem, per)
                       : plan(rows, v_orig, k, wb, rows_max, per);
  const int vals[6] = {p.rows, p.row_tiles, p.per, p.slices, p.stages,
                       p.smem};
  for (int i = 0; i < 6; ++i) out[i] = vals[i];
}

// Launches the decode kernel and its merge on `stream` with the plan
// above: rows_max and per are the launch plan's overrides, 0 keeping the
// kernel's own choice, and any other value the kernel cannot take returns
// cudaErrorInvalidValue (never the own plan in its place); returns a
// cudaError_t.  pk is (rows, slices, k) u64 scratch,
// vals/ids the (rows, k) result.  mask, when not null, is the (rows,
// v_orig) s8 allowed mask; lse, when not null, receives the (rows,) f32
// logsumexp through pl, (rows, slices, 2) f32 scratch.  W's elements are
// of hopper::WKind `kind` (bf16, or 1 byte: int8, e4m3, e5m2); ws, when
// not null, is the (v_orig,) f32 scale of each column.
int sample_topk_launch(const void* h, const void* w, void* pk, void* vals,
                       void* ids, int rows, int d, int v_orig, int valid,
                       int col_offset, int k, int has_softcap, float softcap,
                       const void* mask, void* pl, void* lse, const void* ws,
                       int kind, int rows_max, int per, void* stream) {
  if (rows < 1 || v_orig < 1 || d < wstream::kChunk ||
      d % wstream::kChunk || k < 1 || k > kMaxK || k > v_orig || kind < 0 ||
      kind > hopper::kE5M2 || !wstream::override_ok(rows_max, per, kRowsMax))
    return (int)cudaErrorInvalidValue;
  const wstream::Plan p = plan(rows, v_orig, k, kind ? 1 : 2, rows_max, per);
  if (p.stages < 2 || p.smem > wstream::kMaxSmem || p.slices > kMaxSlices ||
      (lse != nullptr) != (pl != nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  u64* kp = static_cast<u64*>(pk);
  const int8_t* mk = static_cast<const int8_t*>(mask);
  float* lp = static_cast<float*>(pl);
  const float* wsp = static_cast<const float*>(ws);
  CUtensorMap wmap, hmap;
  int e = wstream::make_maps(&wmap, &hmap, w, h, v_orig, rows, d, p.rows,
                             kind);
  if (e) return e;
  cudaError_t err;
#define TOPK_CASE(n)                                                    \
  case n:                                                               \
    err = launch_stream<n>(wmap, hmap, kp, mk, lp, wsp, kind, rows, d,  \
                           v_orig, valid, col_offset, k, p,             \
                           has_softcap, softcap, s);                    \
    break;
  switch (p.rows) {
    TOPK_CASE(8) TOPK_CASE(16) TOPK_CASE(24) TOPK_CASE(32)
    TOPK_CASE(40) TOPK_CASE(48) TOPK_CASE(56) TOPK_CASE(64)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef TOPK_CASE
  if (err != cudaSuccess) return (int)err;
  if (k == 1) {
    key1_merge_kernel<<<(rows + 7) / 8, 256, 0, s>>>(
        kp, lp, static_cast<float*>(vals), static_cast<int*>(ids),
        static_cast<float*>(lse), rows, p.slices, col_offset);
    return (int)cudaGetLastError();
  }
  const int smem = p.slices * k * 8;
  err = cudaFuncSetAttribute(topk_stream_merge_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return (int)err;
  topk_stream_merge_kernel<<<rows, kMergeThreads, smem, s>>>(
      kp, lp, static_cast<float*>(vals), static_cast<int*>(ids),
      static_cast<float*>(lse), p.slices, k, col_offset);
  return (int)cudaGetLastError();
}

// The list kernel (k > 64, or k > V): the same arguments as
// sample_topk_launch for any k >= 1 (rows_max 0 or 8), with pk and pk2 each
// (rows, slices, kk) u64 scratch (kk from sample_topk_big_lists): the stream kernel writes each
// (row, slice)'s sorted top kk into pk, the merge tree halves the lists a
// level between pk and pk2, and the finish kernel writes vals/ids (rows,
// k) and the lse.  Returns a cudaError_t.
int sample_topk_big_launch(const void* h, const void* w, void* pk, void* pk2,
                           void* vals, void* ids, int rows, int d, int v_orig,
                           int valid, int col_offset, int k, int has_softcap,
                           float softcap, const void* mask, void* pl,
                           void* lse, const void* ws, int kind, int rows_max,
                           int per, void* stream) {
  if (rows < 1 || v_orig < 1 || d < wstream::kChunk ||
      d % wstream::kChunk || k < 1 || kind < 0 || kind > hopper::kE5M2 ||
      (lse != nullptr) != (pl != nullptr) ||
      !wstream::override_ok(rows_max, per, kBigRows))
    return (int)cudaErrorInvalidValue;
  int kk = 0, in_smem = 0;
  const wstream::Plan p = plan_big(rows, v_orig, k, kind ? 1 : 2, &kk,
                                   &in_smem, per);
  if (p.stages < 2 || p.smem > wstream::kMaxSmem || p.rows != kBigRows ||
      (per && p.slices > kMaxSlices))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  CUtensorMap wmap, hmap;
  int e = wstream::make_maps(&wmap, &hmap, w, h, v_orig, rows, d, p.rows,
                             kind);
  if (e) return e;
  const bool q = kind != hopper::kBf16;
  auto kern = q ? topk_stream_kernel<kBigRows, false, true, true>
                : topk_stream_kernel<kBigRows, false, false, true>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = kSelThreads + (q ? wstream::converters(kBigRows) : 0);
  u64* a = static_cast<u64*>(pk);
  u64* b = static_cast<u64*>(pk2);
  kern<<<dim3(p.row_tiles, p.slices), threads, p.smem, s>>>(
      wmap, hmap, a, static_cast<const int8_t*>(mask),
      static_cast<float*>(pl), static_cast<const float*>(ws), kind, rows, d,
      v_orig, valid, col_offset, kk, p.per, p.slices, p.stages, has_softcap,
      softcap, in_smem);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int stride = p.slices * kk;
  int n = p.slices, len = kk, last = kk;
  while (n > 1) {
    const int n_out = (n + 1) / 2;
    const int len_out = 2 * len < k ? 2 * len : k;
    const int last_out = n % 2 ? last : (len + last < k ? len + last : k);
    topk_big_merge_kernel<<<dim3(rows, n_out, (2 * len + 255) / 256), 256,
                            0, s>>>(a, b, n, len, last, len_out, last_out,
                                    stride);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    u64* t = a;
    a = b;
    b = t;
    n = n_out;
    len = len_out;
    last = last_out;
  }
  topk_big_finish_kernel<<<dim3(rows, (k + 255) / 256), 256, 0, s>>>(
      a, static_cast<const float*>(pl), static_cast<float*>(vals),
      static_cast<int*>(ids), static_cast<float*>(lse), last, stride,
      p.slices, k, col_offset);
  return (int)cudaGetLastError();
}

// Many-row top-1 path: the vocab slices a launch over `rows` rows uses;
// the wrapper sizes the (rows, n_split) partials with it.
int sample_topk_rows_splits(int rows, int v_orig) {
  return rowtile::splits(rows, v_orig, nullptr);
}

// Launches the many-row top-1 kernel and its merge on `stream`; returns a
// cudaError_t.  pvals/pids are (rows, n_split) scratch, vals/ids (rows,).
int sample_topk_rows_launch(const void* h, const void* w, void* pvals,
                            void* pids, void* vals, void* ids, int rows,
                            int d, int v_orig, int valid, int col_offset,
                            int has_softcap, float softcap, void* stream) {
  if (rows < 1 || v_orig < 1 || d < rowtile::kChunk || d % rowtile::kChunk)
    return (int)cudaErrorInvalidValue;
  CUtensorMap hmap, wmap;
  int err = rowtile::make_maps(&hmap, &wmap, h, w, rows, v_orig, d);
  if (err) return err;
  int per = 0;
  const int n_split = rowtile::splits(rows, v_orig, &per);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t e = cudaFuncSetAttribute(
      topk_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)rowtile::kSmem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((rows + rowtile::kRows - 1) / rowtile::kRows, n_split);
  topk_rows_kernel<<<grid, rowtile::kThreads, rowtile::kSmem, s>>>(
      hmap, wmap, static_cast<float*>(pvals), static_cast<int*>(pids), rows,
      d, v_orig, valid, col_offset, per, n_split, has_softcap, softcap);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  top1_merge_kernel<<<(rows + 7) / 8, 256, 0, s>>>(
      static_cast<const float*>(pvals), static_cast<const int*>(pids),
      static_cast<float*>(vals), static_cast<int*>(ids), rows, n_split);
  return (int)cudaGetLastError();
}

// The list kernel's list length kk and whether its lists live in shared
// memory under the overrides (rows_max, per), into out[0..1] (the Python
// mirror must agree).
void sample_topk_big_lists(int rows, int v_orig, int k, int wb, int rows_max,
                           int per, int* out) {
  (void)rows_max;                       // the list kernel's rows are 8
  plan_big(rows, v_orig, k, wb, &out[0], &out[1], per);
}

const char* sample_topk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
