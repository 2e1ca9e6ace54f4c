// Budgeted flash-decode over a work-item table, for Hopper (sm_90a): the one
// kernel body behind two entry points, which differ only in where a (row,
// kv head, logical block) K/V tile lives.
//
//   flash_decode_paged.cu   TPU kernel flash_decode.py::flash_decode_paged_kernel
//                           (pallas_call :587): tiles from the block pool
//                           [N, Hkv, block, D] through a table [B, T].
//   flash_decode_contig.cu  TPU kernel flash_decode.py::flash_decode_kernel
//                           (pallas_call :294): tiles of the slot cache
//                           [B, Hkv, Smax, D], read in place.
//
// The legacy budgeted decode (sparse_decode.cu) has its own body and
// shares this file's run scans (split_of), reductions and helpers.
//
// What it computes.  For each run of items [L, 6] (batch row, kv head,
// LOGICAL kv block, first, last, valid), the online-softmax attention of the
// run's G query rows (the GQA group of one kv head) over the run's selected
// tiles.  Key positions come from the logical block id; the mask is
// kpos <= pos[row] (and kpos > pos[row] - window with a window).  A run
// starts on `first` and finalizes on `last`, valid or not (the padded table
// from per-slot block ids ends short runs on an invalid row), and returns
// f32 out plus the m / l partials.  Runs that never finalize leave the
// caller's initial values (out 0, m -1e30, l 0).
//
// Quantized caches (as in the reference).  The K/V
// tiles hold int8 or fp8 (e4m3) codes with one f32 scale per (block, kv
// head) tile, read at the same block as the tile (the physical block of the
// pool, or (row, kv head, logical block) of the slot cache).  q is f32, the
// codes are dotted raw, and the scales multiply after the dots, in the
// reference's order: s = (q.codes) * scale * k_scale, pv = (p.codes) *
// v_scale.
//
// Design.  The TPU grid runs in order and carries (acc, m, l) in VMEM from
// one item to the next; CUDA blocks run concurrently, so that carry is not
// legal here.  One CTA is launched per item index.  q.k takes the cache's
// element type (q in f32 for codes) and accumulates in f32; p.V stays true
// f32.  Both layouts run this one body, so paged and contiguous caches
// holding the same values give the same bits.
//   The body splits a run (split mode): the item at position p of
// its run (0 at `first`) belongs to split p / kSplitTiles.  Each CTA finds
// its item's run by two block-wide scans of the item flags (back to the
// run's `first`, forward to its `last`); one whose item does not start a
// split exits, a starting CTA walks its split's items from (acc 0,
// m -1e30, l 0).  A run of one split finalizes as the walk always did.
// Otherwise each split writes its normalized partial (out, m, l) in f32 to
// the workspace at its first item and takes a ticket on its run's counter
// (at the run's first item); the CTA that draws the last ticket merges the
// run's partials in item order by the reference's merge_partials algebra
// (flash_decode.py:699) and resets the counter.  The split is a function of a run's own items only,
// never of an item's index in the table, the bucket length or the order in
// which CTAs finish: the packed and padded tables hold a run's valid items
// in the same order (the padded run's trailing invalid items give partials
// with l = 0, which the merge skips exactly), so they give the same bits,
// and a launch repeats its bits.
//   Workspace: the partials [L, G, D] and [L, G] twice come from the
// wrapper (torch.empty; each is written before it is read).  The counters
// [L] must be zero at launch; the merging CTA leaves its counter at zero,
// so the wrapper keeps one buffer per (device, stream) and adds no fill
// launch (the serve is host-bound), and a CUDA graph of launches replays
// correctly.
// The merge runs across the CTA: the partials' (m, l) are read by all
// threads at once and the weights land in shared memory, then each thread
// sums its output columns over the partials in item order.  L1 is not
// coherent across SMs: after a fence the merging CTA reads the other CTAs'
// partials with ld.global.cg (__ldcg), from L2.
//
// What bounds it.  Decode attention is memory-bound: the least time is the
// bytes of the selected K/V tiles over the card's 3.35 TB/s.  This body
// reads K and V straight from device memory (a key row per thread for
// q.k, strided by D; p.V re-reads V once per group row), so one tile takes
// tens of microseconds on an SM, and a launch lasts as long as its longest
// chain of tiles.  One CTA per run made that chain a whole run (4-20 tiles
// in the served models, on as few as 8 CTAs at Gemma3-1B's one KV head);
// the split cuts it to kSplitTiles tiles plus the merge of at most a run's
// length of partials, on one CTA per split.  Staged K/V, coalesced q.k
// and one V pass per tile, as the legacy decode's body has them, are the
// next step here.
//
// Instantiations: head_dim 32, 64, 128 and 256, each at two GQA group
// bounds (G <= 4 and G <= 8) that size the per-group register arrays.  At
// G = 8, D = 128 a thread keeps 8 output columns and the dynamic shared
// memory is q (4 KB) and the tile's scores (4 KB at 128 keys); at G <= 4,
// D = 256 (Gemma3-1B's G = 4) the same 8 columns, q 4 KB and scores 2 KB.
//
// Sliding windows (Gemma3's local layers): a tile wholly outside the window
// scores -inf everywhere, so its row max stays kNegInf, alpha = exp(0) = 1
// and no p is added; a run whose every tile is outside finalizes to out 0,
// m -1e30, l 0, as the reference's scan, with no NaN.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

namespace decode {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
// GQA group bounds, each a template instantiation: G <= 4 (SmolLM-135M has
// G = 3) keeps the small register arrays, 4 < G <= 8 (Yi-6B has G = 8)
// takes the wider ones.
constexpr int kSmallG = 4, kMaxG = 8;
constexpr float kNegInf = -1e30f;  // the reference's NEG_INF
// Tiles per split of the flash decode's runs (split mode): 1, so a
// launch's chain is one tile plus the merge; 2 was slower at each served
// model's decode shapes (PERF.md §6).  The plain versions use the same
// value (kernels/flash_decode.py SPLIT_TILES).
constexpr int kSplitTiles = 1;

constexpr int D_BATCH = 0, D_KVHEAD = 1, D_KVBLK = 2, D_FIRST = 3,
              D_LAST = 4, D_VALID = 5, DEC_FIELDS = 6;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) { return (float)x; }
__device__ __forceinline__ float to_f32(__nv_fp8_e4m3 x) {
  return static_cast<float>(x);
}
// The element types of a quantized cache: codes dotted raw, scaled after.
template <typename T>
constexpr bool kIsCode =
    std::is_same_v<T, int8_t> || std::is_same_v<T, __nv_fp8_e4m3>;
__device__ __forceinline__ void store(float x, float* dst) { *dst = x; }
__device__ __forceinline__ void store(float x, __nv_bfloat16* dst) {
  *dst = __float2bfloat16(x);
}

// Where a tile lives: find() sets `row0`, the tile's first cache row (in
// units of D elements), and returns whether the logical block is mapped;
// its five-argument form also sets `sidx`, the index of the tile's scale in
// a quantized cache's scales (the tile's index in units of blk rows).
// Offsets stay unsigned (size_t): signed 64-bit offsets cost extra
// sign-extension instructions in the p.V loop that reads from them.

// Tiles of the block pool [N, Hkv, blk, D] through the table [B, Tw].
struct PoolTiles {
  const int* table;
  int Tw, Hkv, blk;
  __device__ bool find(int b, int h, int kvblk, size_t& row0) const {
    int phys = -1;
    if (kvblk >= 0 && kvblk < Tw) phys = table[(size_t)b * Tw + kvblk];
    row0 = ((size_t)phys * Hkv + h) * blk;
    return phys >= 0;
  }
  // scales [N, Hkv]: the physical block's, as its K/V tile
  __device__ bool find(int b, int h, int kvblk, size_t& row0,
                       size_t& sidx) const {
    int phys = -1;
    if (kvblk >= 0 && kvblk < Tw) phys = table[(size_t)b * Tw + kvblk];
    sidx = (size_t)phys * Hkv + h;
    row0 = sidx * blk;
    return phys >= 0;
  }
};

// Tiles of the slot cache [B, Hkv, Smax, D] (Smax a multiple of blk),
// addressed in place; a block outside the cache is unmapped.
struct SlotTiles {
  int Hkv, nblk, blk;
  __device__ bool find(int b, int h, int kvblk, size_t& row0) const {
    row0 = (((size_t)b * Hkv + h) * nblk + kvblk) * blk;
    return kvblk >= 0 && kvblk < nblk;
  }
  // scales [B, Hkv, nblk]: (row, kv head, logical block)
  __device__ bool find(int b, int h, int kvblk, size_t& row0,
                       size_t& sidx) const {
    sidx = ((size_t)b * Hkv + h) * nblk + kvblk;
    row0 = sidx * blk;
    return kvblk >= 0 && kvblk < nblk;
  }
};

// Block-wide max or sum of N per-thread values; every thread gets the
// result.  Must be reached by all threads of the block.  Inlined, so the
// caller's arrays stay in registers instead of a local-memory stack frame.
template <bool kMax, int N>
__device__ __forceinline__ void block_reduce(float (&v)[N], float (*red)[N]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int g = 0; g < N; ++g) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float o = __shfl_xor_sync(0xffffffffu, v[g], off);
      v[g] = kMax ? fmaxf(v[g], o) : v[g] + o;
    }
    if (lane == 0) red[warp][g] = v[g];
  }
  __syncthreads();
#pragma unroll
  for (int g = 0; g < N; ++g) {
    float r = red[0][g];
#pragma unroll
    for (int w = 1; w < kWarps; ++w)
      r = kMax ? fmaxf(r, red[w][g]) : r + red[w][g];
    v[g] = r;
  }
  __syncthreads();
}

// The smallest t in [0, n) with hit(t), or n; every thread of the block
// gets it.  Must be reached by all threads of the block; hit(t) is only
// asked for t < n.
template <class Hit>
__device__ __forceinline__ int first_hit(int n, Hit hit) {
  __shared__ int warp_first[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int base = 0; base < n; base += kThreads) {
    const int t = base + threadIdx.x;
    const unsigned found = __ballot_sync(0xffffffffu, t < n && hit(t));
    if (lane == 0) warp_first[warp] = found ? t + __ffs(found) - 1 : n;
    __syncthreads();
    int best = n;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) best = min(best, warp_first[w]);
    __syncthreads();
    if (best < n) return best;
  }
  return n;
}

// The flash decode's run rule: an item starts a run on `first` and ends it
// on `last`, valid or not.
struct FlashRuns {
  __device__ static bool starts(const int* t) { return t[D_FIRST] == 1; }
  __device__ static bool ends(const int* t) { return t[D_LAST] == 1; }
};

// Split mode: whether item i starts a split of a run that finalizes, and
// that run's first and last items, under the run rule `Rule` (starts /
// ends of an item row).  A run is the items from a start to the next end;
// one whose end comes after another start, or never, does not finalize
// (the reference scan resets and never writes it), and items after an end
// and before the next start (bucket pads) belong to no run.
template <class Rule = FlashRuns>
__device__ __forceinline__ bool split_of(const int* items, int i, int L,
                                         int& first, int& last) {
  auto at = [items](int j) { return items + (size_t)j * DEC_FIELDS; };
  const int back = first_hit(i + 1, [&](int t) {
    return Rule::starts(at(i - t)) || (t > 0 && Rule::ends(at(i - t)));
  });
  if (back > i || (back > 0 && Rule::ends(at(i - back)))) return false;
  if (back % kSplitTiles != 0) return false;
  const int fwd = first_hit(L - i, [&](int t) {
    return Rule::ends(at(i + t)) || (t > 0 && Rule::starts(at(i + t)));
  });
  if (fwd == L - i || (fwd > 0 && Rule::starts(at(i + fwd)))) return false;
  first = i - back;
  last = i + fwd;
  return true;
}

// v[g] for a g known only at run time, without indexing the array (which
// would put it in local memory).
template <int N>
__device__ __forceinline__ float pick(const float (&v)[N], int g) {
  float x = v[0];
#pragma unroll
  for (int j = 1; j < N; ++j)
    if (j == g) x = v[j];
  return x;
}

// A run's (or a split's) output column: acc / l, 0 where l = 0.
__device__ __forceinline__ float normalized(float acc, float l) {
  return l > 0.f ? acc / fmaxf(l, 1e-30f) : 0.f;
}

// Split mode's workspace: each split's normalized partial at its first
// item index (out [L, G, D], m and l [L, G], f32) and each run's ticket
// counter at its first item (int32 [L], zero at launch and left so).
struct SplitWork {
  float* out;
  float* m;
  float* l;
  int* tickets;
};

// Splits of at most this many partials are merged from shared memory at a
// time (their weights, [kMergeChunk][MaxG] floats).
constexpr int kMergeChunk = 32;

// Split mode (see the file comment).
// TQ is q's element type, TK the cache's; with codes (kIsCode<TK>) the
// tile scales come in k_scales / v_scales, otherwise those are unused.
// MaxG (kSmallG or kMaxG) sizes the per-group arrays; G <= MaxG.
template <typename TQ, typename TK, int D, class Tiles, int MaxG>
__global__ void __launch_bounds__(kThreads)
    decode_runs_kernel(const TQ* __restrict__ q,  // [B, Hkv, G, D]
                       const TK* __restrict__ k,  // pool or slot cache
                       const TK* __restrict__ v,
                       const int* __restrict__ items,  // [L, 6]
                       const int* __restrict__ pos,    // [B]
                       float* __restrict__ out,    // [B, Hkv, G, D]
                       float* __restrict__ m_out,  // [B, Hkv, G]
                       float* __restrict__ l_out, int L, int Hkv, int G,
                       int blk, Tiles tiles, float scale, int window,
                       const float* __restrict__ k_scales,
                       const float* __restrict__ v_scales,
                       SplitWork split) {
  constexpr int kAcc = (MaxG * D + kThreads - 1) / kThreads;
  constexpr bool kQuant = kIsCode<TK>;
  const int i = blockIdx.x;
  const int* it = items + (size_t)i * DEC_FIELDS;
  int first, last;  // the run of item i
  if (!split_of(items, i, L, first, last)) return;
  // runs are homogeneous in (row, kv head): the packers emit them so
  const int b = it[D_BATCH], h = it[D_KVHEAD];
  const int tid = threadIdx.x;

  extern __shared__ float smem[];
  float* q_s = smem;           // [G][D] query rows in f32
  float* p_s = smem + G * D;   // [G][blk] scores, then probabilities
  __shared__ float red[kWarps][MaxG];
  __shared__ float m_s[MaxG], l_s[MaxG], alpha_s[MaxG], mnew_s[MaxG];

  const TQ* qb = q + ((size_t)b * Hkv + h) * G * D;
  for (int idx = tid; idx < G * D; idx += kThreads) q_s[idx] = to_f32(qb[idx]);
  if (tid < MaxG) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  float acc[kAcc];
#pragma unroll
  for (int r = 0; r < kAcc; ++r) acc[r] = 0.f;
  const int p = pos[b];
  __syncthreads();

  for (int j = i; j < L; ++j) {
    const int* jt = items + (size_t)j * DEC_FIELDS;
    if (j == i + kSplitTiles || j > last) break;  // the split's items end
    const int kvblk = jt[D_KVBLK];
    size_t row0;
    bool mapped;
    [[maybe_unused]] size_t sidx;
    if constexpr (kQuant)
      mapped = tiles.find(b, h, kvblk, row0, sidx);
    else
      mapped = tiles.find(b, h, kvblk, row0);
    const bool ok = (jt[D_VALID] == 1) && mapped;
    if (ok) {
      const TK* kt = k + row0 * D;
      const TK* vt = v + row0 * D;
      [[maybe_unused]] float ksc, vsc;
      if constexpr (kQuant) {
        ksc = k_scales[sidx];
        vsc = v_scales[sidx];
      }
      float mx[MaxG];
#pragma unroll
      for (int g = 0; g < MaxG; ++g) mx[g] = kNegInf;
      // scores: one key row per thread
      for (int kk = tid; kk < blk; kk += kThreads) {
        const int kpos = kvblk * blk + kk;
        bool msk = kpos <= p;
        if (window > 0) msk = msk && (kpos > p - window);
        float s[MaxG];
#pragma unroll
        for (int g = 0; g < MaxG; ++g) s[g] = 0.f;
        if (msk) {
          const TK* krow = kt + (size_t)kk * D;
#pragma unroll 8
          for (int d = 0; d < D; ++d) {
            const float kf = to_f32(krow[d]);
#pragma unroll
            for (int g = 0; g < MaxG; ++g)
              if (g < G) s[g] = fmaf(q_s[g * D + d], kf, s[g]);
          }
        }
#pragma unroll
        for (int g = 0; g < MaxG; ++g) {
          if (g < G) {
            float sv;
            if constexpr (kQuant)
              sv = msk ? s[g] * scale * ksc : -CUDART_INF_F;
            else
              sv = msk ? s[g] * scale : -CUDART_INF_F;
            p_s[g * blk + kk] = sv;
            mx[g] = fmaxf(mx[g], sv);
          }
        }
      }
      block_reduce<true>(mx, red);
      if (tid < G) {
        const float mn = fmaxf(m_s[tid], mx[tid]);
        mnew_s[tid] = mn;
        alpha_s[tid] = expf(m_s[tid] - mn);
      }
      __syncthreads();
      float ls[MaxG];
#pragma unroll
      for (int g = 0; g < MaxG; ++g) ls[g] = 0.f;
      for (int kk = tid; kk < blk; kk += kThreads) {
#pragma unroll
        for (int g = 0; g < MaxG; ++g) {
          if (g < G) {
            const float sv = p_s[g * blk + kk];
            const float pr = (sv == -CUDART_INF_F) ? 0.f : expf(sv - mnew_s[g]);
            p_s[g * blk + kk] = pr;
            ls[g] += pr;
          }
        }
      }
      block_reduce<false>(ls, red);  // also orders the p_s writes
      // p.V in true f32: thread owns output columns (g, d)
#pragma unroll
      for (int r = 0; r < kAcc; ++r) {
        const int o = tid + r * kThreads;
        if (o < G * D) {
          const int g = o / D, d = o - (o / D) * D;
          const float* pg = p_s + g * blk;
          float pv = 0.f;
          for (int kk = 0; kk < blk; ++kk)
            pv = fmaf(pg[kk], to_f32(vt[(size_t)kk * D + d]), pv);
          if constexpr (kQuant)
            acc[r] = acc[r] * alpha_s[g] + pv * vsc;
          else
            acc[r] = acc[r] * alpha_s[g] + pv;
        }
      }
      if (tid < G) {
        l_s[tid] = l_s[tid] * alpha_s[tid] + ls[tid];
        m_s[tid] = mnew_s[tid];
      }
      __syncthreads();
    }
  }
  float* ob = out + ((size_t)b * Hkv + h) * G * D;
  const size_t mo = ((size_t)b * Hkv + h) * G;
  const int nsplit = (last - first) / kSplitTiles + 1;
  if (nsplit == 1) {  // the run's one split: finalize as a whole run
#pragma unroll
    for (int r = 0; r < kAcc; ++r) {
      const int o = tid + r * kThreads;
      if (o < G * D) ob[o] = normalized(acc[r], l_s[o / D]);
    }
    if (tid < G) {
      m_out[mo + tid] = m_s[tid];
      l_out[mo + tid] = l_s[tid];
    }
    return;
  }
  // this split's partial, then a ticket; the last ticket merges
#pragma unroll
  for (int r = 0; r < kAcc; ++r) {
    const int o = tid + r * kThreads;
    if (o < G * D)
      split.out[(size_t)i * G * D + o] = normalized(acc[r], l_s[o / D]);
  }
  if (tid < G) {
    split.m[(size_t)i * G + tid] = m_s[tid];
    split.l[(size_t)i * G + tid] = l_s[tid];
  }
  __threadfence();
  __syncthreads();
  __shared__ bool merges;
  if (tid == 0) merges = atomicAdd(split.tickets + first, 1) == nsplit - 1;
  __syncthreads();
  if (!merges) return;
  __threadfence();

  // merge_partials over the run's splits s (at item first + s *
  // kSplitTiles), in item order.  A partial is real where l > 0; gm is the
  // max of the real partials' m; each weighs w = exp(m - gm) * l (0 if not
  // real) and out = sum(out * w) / max(sum(w), 1e-30); where at most one
  // is real, out is that partial's out (or 0: a non-real partial's out is
  // 0).  Products and sums rounded one by one, in split order, as the
  // plain version's.  Other CTAs' partials are read from L2 (__ldcg).
  // Inline: out of line (__noinline__) it took the tile walk's registers
  // and spills down but made the launches slower (PERF.md §6).
  auto at = [&](int s) { return (size_t)(first + s * kSplitTiles); };
  float gm[MaxG], nreal[MaxG], only[MaxG];
#pragma unroll
  for (int g = 0; g < MaxG; ++g) {
    gm[g] = kNegInf;
    nreal[g] = 0.f;
    only[g] = -1.f;
  }
  for (int s = tid; s < nsplit; s += kThreads) {
#pragma unroll
    for (int g = 0; g < MaxG; ++g) {
      if (g < G && __ldcg(split.l + at(s) * G + g) > 0.f) {
        gm[g] = fmaxf(gm[g], __ldcg(split.m + at(s) * G + g));
        nreal[g] += 1.f;
        only[g] = (float)s;
      }
    }
  }
  block_reduce<true>(gm, red);
  block_reduce<false>(nreal, red);  // real partials per row (exact)
  block_reduce<true>(only, red);    // with one real partial, its index
  __shared__ float w_s[kMergeChunk][MaxG], den_s[MaxG];
  float num[kAcc];
#pragma unroll
  for (int r = 0; r < kAcc; ++r) num[r] = 0.f;
  float den = 0.f;  // thread g < G: the sum of row g's weights
  for (int c0 = 0; c0 < nsplit; c0 += kMergeChunk) {
    const int nc = min(kMergeChunk, nsplit - c0);
    for (int idx = tid; idx < nc * G; idx += kThreads) {
      const int s = idx / G, g = idx - s * G;
      const float l = __ldcg(split.l + at(c0 + s) * G + g);
      const float m = __ldcg(split.m + at(c0 + s) * G + g);
      w_s[s][g] = l > 0.f ? __fmul_rn(expf(m - pick(gm, g)), l) : 0.f;
    }
    __syncthreads();
    if (tid < G)
      for (int s = 0; s < nc; ++s) den = __fadd_rn(den, w_s[s][tid]);
#pragma unroll
    for (int r = 0; r < kAcc; ++r) {
      const int o = tid + r * kThreads;
      if (o < G * D) {
        const int g = o / D;
#pragma unroll 4
        for (int s = 0; s < nc; ++s)
          num[r] = __fadd_rn(
              num[r], __fmul_rn(__ldcg(split.out + at(c0 + s) * G * D + o),
                                w_s[s][g]));
      }
    }
    __syncthreads();
  }
  if (tid < G) den_s[tid] = den;
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kAcc; ++r) {
    const int o = tid + r * kThreads;
    if (o < G * D) {
      const int g = o / D;
      const float one = pick(only, g);
      ob[o] = pick(nreal, g) > 1.f ? num[r] / fmaxf(den_s[g], 1e-30f)
              : one < 0.f          ? 0.f
                          : __ldcg(split.out + at((int)one) * G * D + o);
    }
  }
  if (tid < G) {
    const float one = pick(only, tid);
    m_out[mo + tid] = pick(gm, tid);
    l_out[mo + tid] = pick(nreal, tid) > 1.f ? den
                      : one < 0.f            ? 0.f
                                  : __ldcg(split.l + at((int)one) * G + tid);
  }
  if (tid == 0) split.tickets[first] = 0;
}

template <typename TQ, typename TK, int D, class Tiles, int MaxG>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* k_scales, const float* v_scales,
                   const int* items, const int* pos, void* out,
                   float* m_out, float* l_out, SplitWork split, int L,
                   int Hkv, int G, int blk, Tiles tiles, float scale,
                   int window, cudaStream_t stream) {
  if (kIsCode<TK> && (k_scales == nullptr || v_scales == nullptr))
    return cudaErrorInvalidValue;
  const size_t smem = (size_t)(G * D + G * blk) * sizeof(float);
  auto kern = decode_runs_kernel<TQ, TK, D, Tiles, MaxG>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<L, kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TK*>(k),
      static_cast<const TK*>(v), items, pos, static_cast<float*>(out), m_out,
      l_out, L, Hkv, G, blk, tiles, scale, window, k_scales, v_scales, split);
  return cudaGetLastError();
}

// dtype: the cache's element type: 0 = bfloat16, 1 = float32 (q shares
// either), 2 = int8 codes, 3 = fp8 e4m3 codes (q float32, with k_scales /
// v_scales); head_dim 32, 64, 128 or 256; G <= kMaxG, taken
// by the kSmallG instantiation up to kSmallG.  `partials` is f32 [L * G *
// (D + 2)] (out [L, G, D], then m and l [L, G]), `tickets` the zeroed
// counters [L].
// Returns the launch's cudaError_t.
template <class Tiles>
cudaError_t dispatch(int dtype, int D, const void* q, const void* k,
                     const void* v, const float* k_scales,
                     const float* v_scales, const int* items, const int* pos,
                     void* out, float* m_out, float* l_out, float* partials,
                     int* tickets, int L, int Hkv, int G,
                     int blk, Tiles tiles, float scale, int window,
                     cudaStream_t stream) {
  if (L <= 0 || G < 1 || G > kMaxG || blk < 1) return cudaErrorInvalidValue;
  if (partials == nullptr || tickets == nullptr) return cudaErrorInvalidValue;
  const size_t n = (size_t)L * G;
  const SplitWork split{partials, partials + n * D, partials + n * (D + 1),
                        tickets};
#define DECODE_LAUNCH(TQ, TK, DD)                                            \
  return G <= kSmallG                                                       \
             ? launch<TQ, TK, DD, Tiles, kSmallG>(                 \
                   q, k, v, k_scales, v_scales, items, pos, out, m_out,     \
                   l_out, split, L, Hkv, G, blk, tiles, scale, window,      \
                   stream)                                                  \
             : launch<TQ, TK, DD, Tiles, kMaxG>(                   \
                   q, k, v, k_scales, v_scales, items, pos, out, m_out,     \
                   l_out, split, L, Hkv, G, blk, tiles, scale, window,      \
                   stream)
#define DECODE_DIMS(DT, TQ, TK)                                              \
  if (dtype == DT && D == 32) DECODE_LAUNCH(TQ, TK, 32);                     \
  if (dtype == DT && D == 64) DECODE_LAUNCH(TQ, TK, 64);                     \
  if (dtype == DT && D == 128) DECODE_LAUNCH(TQ, TK, 128);                   \
  if (dtype == DT && D == 256) DECODE_LAUNCH(TQ, TK, 256)
  DECODE_DIMS(0, __nv_bfloat16, __nv_bfloat16);
  DECODE_DIMS(1, float, float);
  DECODE_DIMS(2, float, int8_t);
  DECODE_DIMS(3, float, __nv_fp8_e4m3);
#undef DECODE_DIMS
#undef DECODE_LAUNCH
  return cudaErrorInvalidValue;
}

}  // namespace decode
