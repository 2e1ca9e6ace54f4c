// Budgeted flash decode over a work-item table, for Hopper (sm_90a): the
// kernel body (decode_runs_kernel) of two entry points, which differ only
// in where a (row, kv head, logical block) K/V tile lives, and the one
// merge of a run's splits (merge_splits), which the legacy decode
// (sparse_decode.cu, TPU kernel sparse_decode.py::sparse_decode_attention)
// calls too.
//
//   flash_decode_paged.cu   TPU kernel flash_decode.py::flash_decode_paged_kernel
//                           (pallas_call :587): tiles from the block pool
//                           [N, Hkv, block, D] through a table [B, T].
//   flash_decode_contig.cu  TPU kernel flash_decode.py::flash_decode_kernel
//                           (pallas_call :294): tiles of the slot cache
//                           [B, Hkv, Smax, D], read in place.
//
// What it computes.  For each run of items [L, 6] (batch row, kv head,
// LOGICAL kv block, first, last, valid), the online-softmax attention of the
// run's G query rows (the GQA group of one kv head) over the run's selected
// tiles.  Key positions come from the logical block id; the mask is
// kpos <= pos[row] (and kpos > pos[row] - window with a window).  Runs
// (FlashRuns) start on `first` and finalize on `last`, valid or not (the
// padded table from per-slot block ids ends short runs on an invalid row).
// Out is f32, with the m / l partials; runs that never finalize leave the
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
// What bounds it.  Per tile the work is 4 G blk D operations on 2 blk D
// elements of K/V: at most 8 operations a byte (bf16, G = 8; 16 over one-
// byte codes), under the ~20 a byte where the H100's f32 CUDA cores meet its
// 3.35 TB/s.  So the least time is the bytes of the selected tiles, and the
// body runs on CUDA cores in f32 (the reference's f32 dots).  At the served
// shapes a launch moves 0.9-10 MB, a few microseconds at the memory rate;
// what a launch costs beyond that is latency: each CTA walks one tile, so a
// launch lasts one CTA's chain of dependent steps (read the item, find the
// tile, copy it, dot, softmax, p.V, merge), and every step that waits on
// the one before it counts.  The design shortens that chain and keeps each
// step's memory traffic in flight at once:
//   - Split runs.  The TPU grid runs in order and carries (acc, m, l) in
//     VMEM from one item to the next; CUDA blocks run concurrently, so one
//     CTA is launched per item index and the item at position p of its run
//     (0 at its start) is split p / kSplitTiles (kSplitTiles = 1: one tile
//     a CTA).  A CTA finds its run by two block-wide scans of the item flags
//     (split_of, back to the run's start, forward to its end); a run of one
//     split finalizes directly, a longer run's splits write their
//     normalized f32 partial (out, m, l) to the workspace at their item and
//     take a ticket on the run's counter, and the CTA that draws the last
//     ticket merges the run (merge_splits) and resets the counter.  The
//     split is a function of a run's own items only, never of the bucket
//     length or of the order in which CTAs finish: the packed and padded
//     tables hold a run's valid items in the same order (the padded run's
//     trailing invalid items give partials with l = 0, which the merge
//     skips exactly), so they give the same bits, and a launch repeats its
//     bits.
//   - Copies first.  Before the run scans, the CTA reads its item, its
//     row's position and (paged) its table entry, and issues K and V each as
//     one bulk copy (cp.async.bulk, completed on an mbarrier): a tile is one
//     contiguous span in both layouts.  Only the keys that count are copied
//     (the span [lo, lo + nk) that pos and the window leave), so a tile
//     wholly outside the window costs no copy.  q's loads fly with them.
//     Where the two tiles do not fit the CTA's shared memory (f32 at D 256,
//     or a large block_kv), K then V go through a two-slot ring of 64-key
//     sub-tiles.  A cache that is not 16-byte aligned is staged by the
//     threads instead.
//   - Coalesced q.k.  A key row is read by D / vector lanes (at most 32),
//     each holding its slice of the G query rows in registers (q is read
//     once per CTA) and reading vectors of K from shared memory; the row's
//     G dot products end in a reduce-scatter of warp shuffles (each halving
//     step sends half the rows' sums), f32 products and sums throughout.
//     A vector is 16 bytes of bf16 / f32 and 8 bytes (8 codes) of int8 /
//     fp8: with q in f32, 16 codes a lane would need 16 q values a group
//     row (128 registers at G = 8) and leave 2 lanes a row at D 32; 8 codes
//     keep the bf16 form's 8 q values a row (64 registers at G = 8), its
//     p.V sums and 4 lanes a row at D 32.
//   - Softmax by pairs.  A thread per (key, row) pair; the rows' max and
//     sum meet by shuffles and one cross-warp step.
//   - One p.V pass.  Each thread owns one column vector for all G rows and
//     one key group; it walks its keys once, reads each V element from
//     shared memory once and accumulates G rows in f32; the key groups'
//     sums meet in shared memory.
//   - Small code.  Each CTA runs every phase once, so a phase's first pass
//     runs from a cold instruction cache, many times slower than warm
//     (PERF.md §6): the once-run phases (the scans, the reductions, the
//     softmax, the merge) are loops, and the q.k and p.V bodies are unrolled
//     only as far as their latency needs.
// Both flash layouts run this one body, so paged and contiguous caches
// holding the same values give the same bits.
//
// Workspace: the partials [L, G, D] and [L, G] twice come from the wrapper
// (torch.empty; each is written before it is read).  The counters [L] must
// be zero at launch; the merging CTA leaves its counter at zero, so the
// wrapper keeps one buffer per (device, stream) and adds no fill launch,
// and a CUDA graph of launches replays correctly.  L1 is not coherent
// across SMs: after a fence the merging CTA reads the other CTAs' partials
// from L2 (__ldcg, cp.async.cg).
//
// Instantiations: head_dim 32, 64, 128 and 256, each at two GQA group
// bounds (G <= 4 and G <= 8) that size the per-group register arrays and
// the scores' row stride.
//
// Sliding windows (Gemma3's local layers): a tile wholly outside the window
// has no key to copy, so its partial is (out 0, m -1e30, l 0), as the
// reference's scan, with no NaN; a run whose every tile is outside
// finalizes to the same.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>
#include <type_traits>

namespace decode {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
// GQA group bounds, each a template instantiation: G <= 4 (SmolLM-135M has
// G = 3) keeps the small register arrays, 4 < G <= 8 (Yi-6B has G = 8)
// takes the wider ones.
constexpr int kSmallG = 4, kMaxG = 8;
constexpr float kNegInf = -1e30f;  // the reference's NEG_INF
// Tiles per split of a run: 1, so a launch's chain is one tile plus the
// merge; 2 was slower at each served model's decode shapes (PERF.md §6).
// The plain versions use the same value (kernels/flash_decode.py
// SPLIT_TILES).
constexpr int kSplitTiles = 1;
// Splits whose (m, l) the merge stages at a time.
constexpr int kMergeChunk = 32;
// Keys a ring sub-tile holds where a whole K and V tile do not fit.
constexpr int kRingKeys = 64;
// Dynamic shared memory a CTA may take: the H100's 227 KB less room for
// the kernel's static arrays.
constexpr int kSmemBudget = 232448 - 4096;

constexpr int D_BATCH = 0, D_KVHEAD = 1, D_KVBLK = 2, D_FIRST = 3,
              D_LAST = 4, D_VALID = 5, DEC_FIELDS = 6;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
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
// units of D elements), and `sidx`, the index of the tile's scale in a
// quantized cache's scales (the tile's index in units of blk rows), and
// returns whether the logical block is mapped.  Offsets stay unsigned
// (size_t): signed 64-bit offsets cost extra sign-extension instructions.

// Tiles of the block pool [N, Hkv, blk, D] through the table [B, Tw];
// scales [N, Hkv]: the physical block's, as its K/V tile.
struct PoolTiles {
  const int* table;
  int Tw, Hkv, blk;
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
// addressed in place; a block outside the cache is unmapped.  Scales
// [B, Hkv, nblk]: (row, kv head, logical block).
struct SlotTiles {
  int Hkv, nblk, blk;
  __device__ bool find(int b, int h, int kvblk, size_t& row0,
                       size_t& sidx) const {
    sidx = ((size_t)b * Hkv + h) * nblk + kvblk;
    row0 = sidx * blk;
    return kvblk >= 0 && kvblk < nblk;
  }
};

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
template <class Rule>
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

__host__ __device__ constexpr int log2i(int x) {
  return x <= 1 ? 0 : 1 + log2i(x / 2);
}

// The thread layout of a T cache at head_dim D.  A lane loads a vector
// `Vec`: 16 bytes of bf16 / f32, 8 bytes (8 codes) of int8 / fp8 (see the
// file comment).
template <typename T, int D>
struct Layout {
  using Vec = std::conditional_t<kIsCode<T>, uint2, uint4>;
  static constexpr int kVec = sizeof(Vec) / sizeof(T);  // elements a vector
  static constexpr int kVecs = D / kVec;                // vectors a row
  // q.k: lanes a key row, vectors a lane, key rows a warp
  static constexpr int kRowLanes = kVecs < 32 ? kVecs : 32;
  static constexpr int kPerLane = kVecs / kRowLanes;
  static constexpr int kRowsPerWarp = 32 / kRowLanes;
  // p.V: one column vector a thread, in one of kGroups key groups
  static constexpr int kGroups = kThreads / kVecs;
  static_assert(kVecs <= kThreads && kVecs % 4 == 0, "head_dim");
};

// A vector of a tile as f32 (bf16 -> f32 is exact: the high half; codes
// convert exactly).
__device__ __forceinline__ void unpack(const uint4& raw, float (&f)[8],
                                       __nv_bfloat16) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    f[2 * j] = __uint_as_float(w[j] << 16);
    f[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
  }
}
__device__ __forceinline__ void unpack(const uint4& raw, float (&f)[4],
                                       float) {
  f[0] = __uint_as_float(raw.x);
  f[1] = __uint_as_float(raw.y);
  f[2] = __uint_as_float(raw.z);
  f[3] = __uint_as_float(raw.w);
}
__device__ __forceinline__ void unpack(const uint2& raw, float (&f)[8],
                                       int8_t) {
  const uint32_t w[2] = {raw.x, raw.y};
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)   // byte e, sign-extended
      f[4 * j + e] = (float)((int)(w[j] << (24 - 8 * e)) >> 24);
}
__device__ __forceinline__ void unpack(const uint2& raw, float (&f)[8],
                                       __nv_fp8_e4m3) {
  const uint32_t w[2] = {raw.x, raw.y};
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {   // e4m3 -> f16 -> f32, both exact
      const __half2_raw hr = __nv_cvt_fp8x2_to_halfraw2(
          (__nv_fp8x2_storage_t)(w[j] >> (16 * e)), __NV_E4M3);
      const float2 f2 = __half22float2(__half2(hr));
      f[4 * j + 2 * e] = f2.x;
      f[4 * j + 2 * e + 1] = f2.y;
    }
}

// Sum v[0, N) over the lanes that differ in the bits O, O/2, ..., kTo of
// the lane index.  While more than one value is left, each step halves
// them: a lane with bit O set keeps (and receives the partner's sums of)
// the upper half, the other the lower half, and `base` counts the values
// skipped; a single value is summed whole.  Afterwards v[0, N >> halvings)
// hold the sums of values base, base + 1, ...
template <int C, int O, int kTo, int N>
__device__ __forceinline__ void reduce_scatter(float (&v)[N], int lane,
                                               int& base) {
  if constexpr (O >= kTo && O >= 1) {
    if constexpr (C > 1) {
      constexpr int kHalf = C / 2;
      const bool up = (lane & O) != 0;
#pragma unroll
      for (int j = 0; j < kHalf; ++j) {
        const float send = up ? v[j] : v[j + kHalf];
        const float keep = up ? v[j + kHalf] : v[j];
        v[j] = keep + __shfl_xor_sync(0xffffffffu, send, O);
      }
      if (up) base += kHalf;
      reduce_scatter<kHalf, O / 2, kTo>(v, lane, base);
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], O);
      reduce_scatter<1, O / 2, kTo>(v, lane, base);
    }
  }
}

// Halving steps of reduce_scatter over `steps` offsets on N values.
__host__ __device__ constexpr int halvings(int N, int steps) {
  return log2i(N) < steps ? log2i(N) : steps;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// One bulk copy of `bytes` (a multiple of 16, both addresses 16-byte
// aligned) from device to shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// 16 bytes from device to shared memory through L2 (cp.async.cg), and the
// wait for every such copy of the thread.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// The dynamic shared memory of one launch: at offset 0 the K/V ring (two
// slots of `ring` keys), which the key groups' p.V sums [kGroups][MaxG][D]
// (f32) take over once the last V sub-tile is read, and the merge's staged
// partials [merge][G][D] (f32) after those; then the tile's scores
// [blk][MaxG] and q [MaxG][D] in f32.
struct Smem {
  int ring;        // keys a ring slot holds: blk (the whole tile) or fewer
  int merge;       // partials the merge stages at a time
  size_t scores;   // byte offsets
  size_t qrows;
  size_t total;
};

template <typename T, int D, int MaxG>
Smem smem_plan(int blk) {
  using Ly = Layout<T, D>;
  const size_t red = (size_t)Ly::kGroups * MaxG * D * sizeof(float);
  const size_t part = (size_t)MaxG * D * sizeof(float);
  for (int ring : {blk, kRingKeys, 16}) {
    if (ring > blk) continue;
    size_t shared = 2 * (size_t)ring * D * sizeof(T);
    shared = shared > red ? shared : red;   // red >= part
    Smem s;
    s.ring = ring;
    s.merge = (int)(shared / part < kMergeChunk ? shared / part
                                                : kMergeChunk);
    s.scores = (shared + 127) & ~(size_t)127;
    s.qrows = s.scores + (((size_t)blk * MaxG * sizeof(float) + 127) &
                          ~(size_t)127);
    s.total = s.qrows + part;
    if (s.total <= (size_t)kSmemBudget) return s;
  }
  return Smem{0, 0, 0, 0, 0};
}

// merge_partials (the reference's, flash_decode.py:699) over a run's
// `nsplit` splits s (the partials at item first + s), in split order, by
// the CTA that drew the run's last ticket; writes out (columns o < G * D
// of ob: f32 for the flash decodes, q's dtype for the legacy one) and,
// with kStats (the flash decodes), the run's m and l (mo[g], lo[g]), then
// resets the run's counter.  A partial is real where l > 0; gm is the real
// partials' max m; each weighs w = exp(m - gm) * l (0 if not real); out =
// sum(out * w) / max(sum(w), 1e-30) and l = sum(w), or, where at most one
// is real, that partial's out and l (0 if none); m = gm (-1e30 if none).
// Products and sums rounded one by one, in split order, as the plain
// version's.  The other CTAs' partials come from L2 into shared memory
// (__ldcg, cp.async.cg; `stage` holds `chunk` partials [G][D] at a time),
// each chunk's copies issued together; the first chunk's outs fly during
// the first pass.  Loops throughout: a CTA runs this once, from a cold
// instruction cache.
template <int MaxG, int D, bool kStats, typename TO>
__device__ __forceinline__ void merge_splits(const SplitWork& split,
                                             int first, int nsplit, int G,
                                             float* stage, int chunk,
                                             TO* ob, float* mo, float* lo) {
  constexpr int kAcc = MaxG * D / kThreads;   // output columns a thread
  static_assert(kSplitTiles == 1, "partials at consecutive items");
  const int tid = threadIdx.x;
  auto at = [&](int s) { return (size_t)(first + s); };
  __shared__ float l_c[kMergeChunk][MaxG], m_c[kMergeChunk][MaxG],
      w_c[kMergeChunk][MaxG];
  __shared__ float gm_s[MaxG], den_s[MaxG];
  __shared__ int nreal_s[MaxG], only_s[MaxG];
  auto stage_lm = [&](int c0, int nc) {
    for (int idx = tid; idx < nc * G; idx += kThreads) {
      const int s = idx / G, g = idx - s * G;
      l_c[s][g] = __ldcg(split.l + at(c0 + s) * G + g);
      m_c[s][g] = __ldcg(split.m + at(c0 + s) * G + g);
    }
  };
  // the outs of splits [c0, c0 + nc): [nc][G][D] f32, contiguous
  auto stage_outs = [&](int c0, int nc) {
    const float* src = split.out + at(c0) * G * D;
    for (int idx = tid; idx < nc * G * D / 4; idx += kThreads)
      cp_async16(stage + idx * 4, src + idx * 4);
  };
  stage_outs(0, min(chunk, nsplit));
  // pass 1, thread g < G: row g's max m over the real partials, their
  // count and the last one
  float gm = kNegInf;
  int nreal = 0, only = -1;
  for (int c0 = 0; c0 < nsplit; c0 += kMergeChunk) {
    const int nc = min(kMergeChunk, nsplit - c0);
    stage_lm(c0, nc);
    __syncthreads();
    if (tid < G) {
      for (int s = 0; s < nc; ++s) {
        if (l_c[s][tid] > 0.f) {
          gm = fmaxf(gm, m_c[s][tid]);
          ++nreal;
          only = c0 + s;
        }
      }
    }
    __syncthreads();
  }
  if (tid < G) {
    gm_s[tid] = gm;
    nreal_s[tid] = nreal;
    only_s[tid] = only;
  }
  // pass 2: the weights and the weighted outs, `chunk` splits at a time;
  // a run of at most kMergeChunk splits keeps pass 1's (m, l)
  const bool kept = nsplit <= kMergeChunk;
  float num[kAcc];
#pragma unroll
  for (int r = 0; r < kAcc; ++r) num[r] = 0.f;
  float den = 0.f;   // thread g < G: the sum of row g's weights
  for (int c0 = 0; c0 < nsplit; c0 += chunk) {
    const int nc = min(chunk, nsplit - c0);
    if (!kept) stage_lm(c0, nc);
    if (c0 > 0) stage_outs(c0, nc);
    cp_async_wait_all();
    __syncthreads();   // also orders gm_s
    const int lm0 = kept ? c0 : 0;   // (m, l) row of split c0
    for (int idx = tid; idx < nc * G; idx += kThreads) {
      const int s = idx / G, g = idx - s * G;
      const float l = l_c[lm0 + s][g];
      w_c[s][g] =
          l > 0.f ? __fmul_rn(expf(m_c[lm0 + s][g] - gm_s[g]), l) : 0.f;
    }
    __syncthreads();
    if (tid < G)
      for (int s = 0; s < nc; ++s) den = __fadd_rn(den, w_c[s][tid]);
    // columns past G * D read other partials' values, never stored
    for (int s = 0; s < nc; ++s) {
#pragma unroll
      for (int r = 0; r < kAcc; ++r) {
        const int o = tid + r * kThreads;
        num[r] = __fadd_rn(num[r],
                           __fmul_rn(stage[s * G * D + o], w_c[s][o / D]));
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
      const int g = o / D, one = only_s[g];
      const float val =
          nreal_s[g] > 1 ? num[r] / fmaxf(den_s[g], 1e-30f)
          : one < 0      ? 0.f
                         : __ldcg(split.out + at(one) * G * D + o);
      store(val, ob + o);
    }
  }
  if (kStats && tid < G) {
    mo[tid] = gm;
    lo[tid] = nreal > 1   ? den
              : only < 0  ? 0.f
                          : __ldcg(split.l + at(only) * G + tid);
  }
  if (tid == 0) split.tickets[first] = 0;
}

// The body (see the file comment).  TQ is q's element type, TK the
// cache's (with codes, kIsCode<TK>, q is f32 and the tile scales come in
// k_scales / v_scales).  Keys count at kpos <= pos[row] and, with
// window > 0, kpos > pos[row] - window.
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
                       const float* __restrict__ v_scales, Smem sm,
                       SplitWork split) {
  using Ly = Layout<TK, D>;
  using Vec = typename Ly::Vec;
  constexpr int kVec = Ly::kVec;
  constexpr bool kQuant = kIsCode<TK>;
  constexpr int kQ = Ly::kPerLane * kVec;        // q elements a lane
  constexpr int kPV = MaxG * kVec;               // p.V sums a thread
  constexpr int kAcc = MaxG * D / kThreads;      // output columns a thread
  static_assert(MaxG * D % kThreads == 0, "columns a thread");
  static_assert(kSplitTiles == 1, "one tile a CTA");
  const int i = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int* it = items + (size_t)i * DEC_FIELDS;
  const int b = it[D_BATCH], h = it[D_KVHEAD], kvblk = it[D_KVBLK];

  extern __shared__ __align__(128) unsigned char smem[];
  TK* slots = reinterpret_cast<TK*>(smem);
  float* red = reinterpret_cast<float*>(smem);      // after the ring
  float* p_s = reinterpret_cast<float*>(smem + sm.scores);  // [blk][MaxG]
  float* q_s = reinterpret_cast<float*>(smem + sm.qrows);   // [MaxG][D]
  __shared__ uint64_t full[2];
  __shared__ float red_s[kWarps][MaxG], l_s[MaxG];

  // the tile's keys that count: [lo, lo + nk) of its rows (none where the
  // item is invalid or its block unmapped)
  size_t row0 = 0, sidx = 0;
  int lo = 0, nk = 0;
  if (it[D_VALID] == 1) {
    const int last_pos = pos[b];
    if (tiles.find(b, h, kvblk, row0, sidx)) {
      const int k0 = kvblk * blk;
      if (window > 0) lo = max(0, last_pos - window + 1 - k0);
      nk = max(0, min(blk, last_pos + 1 - k0) - lo);
    }
  }
  [[maybe_unused]] float ksc = 1.f, vsc = 1.f;
  if constexpr (kQuant) {
    if (nk > 0) {
      ksc = k_scales[sidx];
      vsc = v_scales[sidx];
    }
  }
  const int ring = sm.ring;
  const int nchunk = (nk + ring - 1) / ring;   // K sub-tiles; V as many
  const bool bulk = ((reinterpret_cast<uintptr_t>(k) |
                      reinterpret_cast<uintptr_t>(v)) & 15) == 0;
  const size_t key0 = row0 + lo;
  // chunk c < nchunk is K sub-tile c, then V sub-tile c - nchunk; it goes
  // to slot c % 2
  auto chunk_keys = [&](int c) {
    return min(ring, nk - (c % nchunk) * ring);
  };
  auto chunk_src = [&](int c) {
    return (c < nchunk ? k : v) + (key0 + (size_t)(c % nchunk) * ring) * D;
  };
  auto slot = [&](int c) { return slots + (size_t)(c & 1) * ring * D; };
  auto issue = [&](int c) {
    bulk_copy(slot(c), chunk_src(c),
              (uint32_t)(chunk_keys(c) * D * sizeof(TK)), &full[c & 1]);
  };
  auto wait = [&](int c) {
    if (bulk) {
      mbar_wait(&full[c & 1], (c >> 1) & 1);
    } else {
      const TK* src = chunk_src(c);
      TK* dst = slot(c);
      for (int idx = tid; idx < chunk_keys(c) * D; idx += kThreads)
        dst[idx] = src[idx];
      __syncthreads();
    }
  };
  // the slot is read by every thread: refill it after all are done
  auto release = [&](int c) {
    __syncthreads();
    if (bulk && tid == 0 && c + 2 < 2 * nchunk) issue(c + 2);
  };

  if (bulk && tid == 0 && nk > 0) {
    mbar_init(&full[0]);
    mbar_init(&full[1]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    issue(0);
    issue(1);
  }
  // q's loads fly during the run scans
  constexpr int kQLoads = MaxG * D / kThreads;
  const TQ* qb = q + ((size_t)b * Hkv + h) * G * D;
  float qv[kQLoads];
#pragma unroll
  for (int r = 0; r < kQLoads; ++r) {
    const int idx = tid + r * kThreads;
    qv[r] = idx < G * D ? to_f32(qb[idx]) : 0.f;
  }

  int first, last;
  if (!split_of<FlashRuns>(items, i, L, first, last)) {
    // not in a run that finalizes: let the copies land, then leave
    if (bulk && tid == 0 && nk > 0) {
      mbar_wait(&full[0], 0);
      mbar_wait(&full[1], 0);
    }
    return;
  }
#pragma unroll
  for (int r = 0; r < kQLoads; ++r) q_s[tid + r * kThreads] = qv[r];
  __syncthreads();

  // thread t keeps row gq of the scores: the row's max and sum
  const int gq = tid % MaxG;
  float mrow = kNegInf, lrow = 0.f;
  if (nk > 0) {
    // q.k: kRowLanes lanes a key row; a lane sums its slice of kBatch
    // rows, then one reduce-scatter over the row's lanes ends them all
    const int sub = lane % Ly::kRowLanes;
    float qr[MaxG][kQ];
#pragma unroll
    for (int g = 0; g < MaxG; ++g)
#pragma unroll
      for (int t = 0; t < Ly::kPerLane; ++t)
#pragma unroll
        for (int e = 0; e < kVec; ++e)
          qr[g][t * kVec + e] =
              q_s[g * D + (sub + t * Ly::kRowLanes) * kVec + e];
    constexpr int kBatch =
        16 / MaxG < (4 + Ly::kRowsPerWarp - 1) / Ly::kRowsPerWarp
            ? 16 / MaxG
            : (4 + Ly::kRowsPerWarp - 1) / Ly::kRowsPerWarp;
    constexpr int kN = kBatch * MaxG;
    constexpr int kSteps = log2i(Ly::kRowLanes);
    constexpr int kHalvings = halvings(kN, kSteps);
    constexpr int kKept = kN >> kHalvings;
    // lanes holding the same sums after the plain (non-halving) steps
    constexpr int kDup = (1 << (kSteps - kHalvings)) - 1;
    constexpr int kWarpRows = Ly::kRowsPerWarp * kBatch;
    for (int c = 0; c < nchunk; ++c) {
      wait(c);
      const TK* ks = slot(c);
      const int nkc = chunk_keys(c), kbase = c * ring;
      for (int rb = warp * kWarpRows; rb < nkc; rb += kWarps * kWarpRows) {
        // this lane's rows: r0 + j * kRowsPerWarp
        const int r0 = rb + lane / Ly::kRowLanes;
        float kf[kBatch][kQ];
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
          const int r = r0 + j * Ly::kRowsPerWarp;
#pragma unroll
          for (int t = 0; t < Ly::kPerLane; ++t) {
            Vec raw{};
            if (r < nkc)
              raw = *reinterpret_cast<const Vec*>(
                  ks + (size_t)r * D + (sub + t * Ly::kRowLanes) * kVec);
            float f[kVec];
            unpack(raw, f, TK{});
#pragma unroll
            for (int e = 0; e < kVec; ++e) kf[j][t * kVec + e] = f[e];
          }
        }
        float s[kN];
#pragma unroll
        for (int j = 0; j < kBatch; ++j)
#pragma unroll
          for (int g = 0; g < MaxG; ++g) {
            float a = 0.f;
#pragma unroll
            for (int e = 0; e < kQ; ++e) a = fmaf(qr[g][e], kf[j][e], a);
            s[j * MaxG + g] = a;
          }
        int base = 0;
        reduce_scatter<kN, Ly::kRowLanes / 2, 1>(s, lane, base);
        if ((lane & kDup) == 0) {
#pragma unroll
          for (int n = 0; n < kKept; ++n) {
            const int j = (base + n) / MaxG, g = base + n - j * MaxG;
            const int r = r0 + j * Ly::kRowsPerWarp;
            if (r < nkc) {   // s = (q.k) * scale (* k_scale over codes)
              if constexpr (kQuant)
                p_s[(kbase + r) * MaxG + g] = s[n] * scale * ksc;
              else
                p_s[(kbase + r) * MaxG + g] = s[n] * scale;
            }
          }
        }
      }
      release(c);
    }

    // softmax over the tile's rows: thread t takes the scores of row
    // t % MaxG (kThreads is a multiple of MaxG), the row's threads of a
    // warp meet by shuffles, the warps in shared memory
    for (int idx = tid; idx < nk * MaxG; idx += kThreads)
      mrow = fmaxf(mrow, p_s[idx]);
    for (int off = 16; off >= MaxG; off >>= 1)
      mrow = fmaxf(mrow, __shfl_xor_sync(0xffffffffu, mrow, off));
    if (lane < MaxG) red_s[warp][lane] = mrow;
    __syncthreads();
    for (int w = 0; w < kWarps; ++w) mrow = fmaxf(mrow, red_s[w][gq]);
    for (int idx = tid; idx < nk * MaxG; idx += kThreads) {
      const float p = gq < G ? expf(p_s[idx] - mrow) : 0.f;
      p_s[idx] = p;
      lrow += p;
    }
    for (int off = 16; off >= MaxG; off >>= 1)
      lrow += __shfl_xor_sync(0xffffffffu, lrow, off);
    __syncthreads();   // every read of red_s, every p written
    if (lane < MaxG) red_s[warp][lane] = lrow;

    // p.V: thread (key group kg, column vector cv), f32 sums
    const int cv = tid % Ly::kVecs, kg = tid / Ly::kVecs;
    float acc[kPV];
#pragma unroll
    for (int j = 0; j < kPV; ++j) acc[j] = 0.f;
    for (int c = nchunk; c < 2 * nchunk; ++c) {
      wait(c);
      const TK* vs = slot(c);
      const int nkc = chunk_keys(c), kbase = (c - nchunk) * ring;
#pragma unroll 2
      for (int kk = kg; kk < nkc; kk += Ly::kGroups) {
        const Vec raw = *reinterpret_cast<const Vec*>(
            vs + (size_t)kk * D + cv * kVec);
        float vf[kVec];
        unpack(raw, vf, TK{});
        const float4* pk =
            reinterpret_cast<const float4*>(p_s + (kbase + kk) * MaxG);
#pragma unroll
        for (int g4 = 0; g4 < MaxG / 4; ++g4) {
          const float4 p4 = pk[g4];
          const float pg[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
          for (int gg = 0; gg < 4; ++gg)
#pragma unroll
            for (int e = 0; e < kVec; ++e)
              acc[(g4 * 4 + gg) * kVec + e] =
                  fmaf(pg[gg], vf[e], acc[(g4 * 4 + gg) * kVec + e]);
        }
      }
      release(c);
    }
    // the key groups' sums [kGroups][MaxG][D], summed with the output
#pragma unroll
    for (int g = 0; g < MaxG; ++g)
#pragma unroll
      for (int e = 0; e < kVec; e += 4)
        *reinterpret_cast<float4*>(red + (kg * MaxG + g) * D + cv * kVec +
                                   e) =
            make_float4(acc[g * kVec + e], acc[g * kVec + e + 1],
                        acc[g * kVec + e + 2], acc[g * kVec + e + 3]);
    __syncthreads();
    if (tid < MaxG) {
      float l = 0.f;
      for (int w = 0; w < kWarps; ++w) l += red_s[w][tid];
      l_s[tid] = l;
    }
    __syncthreads();
  }

  // this item's split: the normalized partial (out, m, l); thread t
  // takes the columns o = t + r * kThreads of [MaxG][D] (those past G * D
  // are not stored); pv = (p.V) * v_scale over codes
  const int nsplit = last - first + 1;
  float* ob = out + ((size_t)b * Hkv + h) * G * D;
  const size_t mo = ((size_t)b * Hkv + h) * G;
  const float lrun = nk > 0 && tid < MaxG ? l_s[tid] : 0.f;  // row tid's
  float part[kAcc];
#pragma unroll
  for (int r = 0; r < kAcc; ++r) part[r] = 0.f;
  if (nk > 0) {
#pragma unroll
    for (int r = 0; r < kAcc; ++r) {
      const int o = tid + r * kThreads;
      float a = 0.f;
      for (int w = 0; w < Ly::kGroups; ++w) a += red[w * MaxG * D + o];
      if constexpr (kQuant) a *= vsc;
      part[r] = normalized(a, l_s[o / D]);
    }
  }
  if (nsplit == 1) {   // the run's one split: its output
#pragma unroll
    for (int r = 0; r < kAcc; ++r)
      if (tid + r * kThreads < G * D)
        ob[tid + r * kThreads] = part[r];
    if (tid < G) {
      m_out[mo + tid] = mrow;   // gq == tid
      l_out[mo + tid] = lrun;
    }
    return;
  }
#pragma unroll
  for (int r = 0; r < kAcc; ++r)
    if (tid + r * kThreads < G * D)
      split.out[(size_t)i * G * D + tid + r * kThreads] = part[r];
  if (tid < G) {
    split.m[(size_t)i * G + tid] = mrow;
    split.l[(size_t)i * G + tid] = lrun;
  }
  __threadfence();
  __syncthreads();
  __shared__ bool merges;
  if (tid == 0) merges = atomicAdd(split.tickets + first, 1) == nsplit - 1;
  __syncthreads();
  if (!merges) return;
  __threadfence();
  merge_splits<MaxG, D, true>(split, first, nsplit, G,
                              reinterpret_cast<float*>(smem), sm.merge, ob,
                              m_out + mo, l_out + mo);
}

// One launch's arguments, as the entry points take them.
struct Call {
  const void* q;
  const void* k;
  const void* v;
  const float* k_scales;
  const float* v_scales;
  const int* items;
  const int* pos;
  float* out;
  float* m_out;
  float* l_out;
  float* partials;   // f32 [L * G * (D + 2)]: out [L, G, D], m, l [L, G]
  int* tickets;      // int32 [L], zero at the call and left zero
  int L, Hkv, G, blk;
  float scale;
  int window;
  cudaStream_t stream;
};

template <typename TQ, typename TK, int D, class Tiles, int MaxG>
cudaError_t launch(const Call& c, Tiles tiles) {
  if (kIsCode<TK> && (c.k_scales == nullptr || c.v_scales == nullptr))
    return cudaErrorInvalidValue;
  const Smem sm = smem_plan<TK, D, MaxG>(c.blk);
  if (sm.total == 0) return cudaErrorInvalidValue;
  const size_t n = (size_t)c.L * c.G;
  const SplitWork split{c.partials, c.partials + n * D,
                        c.partials + n * (D + 1), c.tickets};
  auto kern = decode_runs_kernel<TQ, TK, D, Tiles, MaxG>;
  if (sm.total > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sm.total);
    if (e != cudaSuccess) return e;
  }
  kern<<<c.L, kThreads, sm.total, c.stream>>>(
      static_cast<const TQ*>(c.q), static_cast<const TK*>(c.k),
      static_cast<const TK*>(c.v), c.items, c.pos, c.out, c.m_out, c.l_out,
      c.L, c.Hkv, c.G, c.blk,
      tiles, c.scale, c.window, c.k_scales, c.v_scales, sm, split);
  return cudaGetLastError();
}

// The instantiation for head_dim D (32, 64, 128 or 256) and G (the
// kSmallG one up to kSmallG, else the kMaxG one); returns the launch's
// cudaError_t.
template <typename TQ, typename TK, class Tiles>
cudaError_t launch_dims(int D, const Call& c, Tiles tiles) {
  if (c.L <= 0 || c.G < 1 || c.G > kMaxG || c.blk < 1 ||
      c.partials == nullptr || c.tickets == nullptr)
    return cudaErrorInvalidValue;
#define DECODE_LAUNCH(DD)                                                    \
  return c.G <= kSmallG                                                      \
             ? launch<TQ, TK, DD, Tiles, kSmallG>(c, tiles)                  \
             : launch<TQ, TK, DD, Tiles, kMaxG>(c, tiles)
  switch (D) {
    case 32: DECODE_LAUNCH(32);
    case 64: DECODE_LAUNCH(64);
    case 128: DECODE_LAUNCH(128);
    case 256: DECODE_LAUNCH(256);
    default: return cudaErrorInvalidValue;
  }
#undef DECODE_LAUNCH
}

// The flash decodes: dtype, the cache's element type: 0 = bfloat16, 1 =
// float32 (q shares either), 2 = int8 codes, 3 = fp8 e4m3 codes (q
// float32, with k_scales / v_scales); f32 out, m and l.
template <class Tiles>
cudaError_t dispatch(int dtype, int D, const Call& c, Tiles tiles) {
  switch (dtype) {
    case 0:
      return launch_dims<__nv_bfloat16, __nv_bfloat16, Tiles>(D, c, tiles);
    case 1:
      return launch_dims<float, float, Tiles>(D, c, tiles);
    case 2:
      return launch_dims<float, int8_t, Tiles>(D, c, tiles);
    case 3:
      return launch_dims<float, __nv_fp8_e4m3, Tiles>(D, c, tiles);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace decode
