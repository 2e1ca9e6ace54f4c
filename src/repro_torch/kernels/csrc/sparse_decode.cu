// Legacy work-list budgeted decode for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/sparse_decode.py::
// sparse_decode_attention (body _sparse_decode_kernel, pallas_call at
// sparse_decode.py:241), reached through the library entry
// ops.sparse_decode on item tables from build_decode_worklist.
//
// What it computes.  q [B, Hkv, G, D] and the slot caches [B, Hkv, Smax, D]
// are read in place; items [L, 6] (batch row, kv head, logical kv block,
// first, last, valid).  A run starts on `valid & first` and finalizes on
// `valid & last`; a run that meets another `valid & first` before its end,
// or never ends, writes nothing, and items outside runs (bucket pads) are
// skipped.  Each run attends its G query rows over its valid tiles with
// the static mask kpos < cache_len (no per-row position, no window) and
// writes the normalized output in q's dtype; (row, kv head) pairs that no
// run covers keep the wrapper's zeros.  Runs are homogeneous in (row, kv
// head), as build_decode_worklist emits them.
//
// What bounds it.  Per tile the work is 4 G blk D operations on 2 blk D
// elements of K/V: at most 8 operations a byte (bf16, G = 8), under the
// ~20 a byte where the H100's f32 CUDA cores meet its memory rate.  So the
// kernel is bound by the bytes of the selected tiles, and runs on CUDA
// cores in f32 (the reference's f32 dots); a launch should cost about one
// tile's copy and walk plus the run scans and the merge.
//
// Design, one CTA (128 threads) per item, one tile per CTA:
//   - Split runs.  A CTA finds its item's run by the block-wide flag scans
//     of flash_decode.cuh (split_of under the legacy run rule).  The item
//     is its run's split at its position in the run, computed from the
//     initial state; a run of one item finalizes directly, a longer run's
//     splits write their normalized f32 partial (out, m, l) to the
//     workspace at their item and take a ticket on the run's counter, and
//     the last ticket merges the partials in item order by the
//     merge_partials algebra (flash_decode.py:699 of the reference),
//     reading the other CTAs' partials through L2 (__ldcg), and resets the
//     counter.  The counters come zeroed from the wrapper's buffer per
//     (device, stream) and are left so; a launch repeats its bits.
//   - Staged K/V.  A slot-cache tile is one contiguous blk x D span, so K
//     and V each arrive by one bulk copy (cp.async.bulk, completed on an
//     mbarrier), both issued before the run scans, so that the copies fly
//     while the CTA scans and V arrives while q.k runs.  Keys at or past
//     cache_len are neither copied nor read.  Where the two tiles do not
//     fit the CTA's shared memory (f32 at D 256, or a large block_kv), K
//     then V go through a two-slot ring of 64-key sub-tiles.  A cache not
//     16-byte aligned is staged by the threads instead.
//   - Coalesced q.k.  A key row is read by D / (16 B) lanes (at most 32),
//     each holding its 16-byte slice of the G query rows in registers (q is
//     read once per CTA) and reading 16-byte vectors of K from shared
//     memory; the row's G dot products end in a reduce-scatter of warp
//     shuffles (each halving step sends half the rows' sums), f32 products
//     and sums throughout.
//   - One p.V pass.  After the row max and the exponentials (a thread per
//     (key, row) pair, rows met by shuffles and one cross-warp step), each
//     thread owns a 16-byte column vector for all G rows and a key group;
//     it walks its keys once, reads each V element from shared memory once
//     and accumulates G rows in f32; the key groups' sums meet in shared
//     memory.
//   - Small code.  Each CTA runs every phase once, so a phase's first pass
//     runs from a cold instruction cache, many times slower than warm
//     (PERF.md §6): the once-run phases (softmax, the reductions, the
//     merge) are loops, and the q.k and p.V bodies are unrolled only as
//     far as their latency needs.
#include <stdint.h>

#include <initializer_list>

#include "flash_decode.cuh"

namespace legacy {

using decode::D_BATCH;
using decode::D_FIRST;
using decode::D_KVBLK;
using decode::D_KVHEAD;
using decode::D_LAST;
using decode::D_VALID;
using decode::DEC_FIELDS;
using decode::kMergeChunk;
using decode::kNegInf;
using decode::kThreads;
using decode::kWarps;
using decode::SplitWork;

// The legacy run rule: only valid items start or end a run.
struct LegacyRuns {
  __device__ static bool starts(const int* t) {
    return t[D_FIRST] == 1 && t[D_VALID] == 1;
  }
  __device__ static bool ends(const int* t) {
    return t[D_LAST] == 1 && t[D_VALID] == 1;
  }
};

// Keys a ring sub-tile holds where a whole K and V tile do not fit.
constexpr int kRingKeys = 64;
// Dynamic shared memory a CTA may take: the H100's 227 KB less room for
// the kernel's static arrays.
constexpr int kSmemBudget = 232448 - 4096;

__host__ __device__ constexpr int log2i(int x) {
  return x <= 1 ? 0 : 1 + log2i(x / 2);
}

// The thread layout of a T cache at head_dim D.
template <typename T, int D>
struct Layout {
  static constexpr int kVec = 16 / sizeof(T);    // elements in 16 bytes
  static constexpr int kVecs = D / kVec;         // 16-byte vectors a row
  // q.k: lanes a key row, vectors a lane, key rows a warp
  static constexpr int kRowLanes = kVecs < 32 ? kVecs : 32;
  static constexpr int kPerLane = kVecs / kRowLanes;
  static constexpr int kRowsPerWarp = 32 / kRowLanes;
  // p.V: one column vector a thread, in one of kGroups key groups
  static constexpr int kGroups = kThreads / kVecs;
  static_assert(kVecs <= kThreads && kVecs % 4 == 0, "head_dim");
};

// 16 bytes of a tile as f32 (bf16 -> f32 is exact: the high half).
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

template <typename T, int D, int MaxG>
__global__ void __launch_bounds__(kThreads)
    legacy_decode_kernel(const T* __restrict__ q,  // [B, Hkv, G, D]
                         const T* __restrict__ k,  // [B, Hkv, Smax, D]
                         const T* __restrict__ v,
                         const int* __restrict__ items,  // [L, 6]
                         T* __restrict__ out,            // [B, Hkv, G, D]
                         int L, int Hkv, int G, int blk, int nblk,
                         int cache_len, float scale, Smem sm,
                         SplitWork split) {
  using Ly = Layout<T, D>;
  constexpr int kVec = Ly::kVec;
  constexpr int kQ = Ly::kPerLane * kVec;        // q elements a lane
  constexpr int kPV = MaxG * kVec;               // p.V sums a thread
  constexpr int kAcc = MaxG * D / kThreads;      // output columns a thread
  static_assert(MaxG * D % kThreads == 0, "columns a thread");
  const int i = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int* it = items + (size_t)i * DEC_FIELDS;
  const int b = it[D_BATCH], h = it[D_KVHEAD], kvblk = it[D_KVBLK];

  extern __shared__ __align__(128) unsigned char smem[];
  T* slots = reinterpret_cast<T*>(smem);
  float* red = reinterpret_cast<float*>(smem);      // after the ring
  float* stage = reinterpret_cast<float*>(smem);    // after the reduction
  float* p_s = reinterpret_cast<float*>(smem + sm.scores);  // [blk][MaxG]
  float* q_s = reinterpret_cast<float*>(smem + sm.qrows);   // [MaxG][D]
  __shared__ uint64_t full[2];
  __shared__ float red_s[kWarps][MaxG], l_s[MaxG];

  // the tile's keys under kpos < cache_len (none: invalid or unmapped)
  int nk = 0;
  if (it[D_VALID] == 1 && kvblk >= 0 && kvblk < nblk)
    nk = max(0, min(blk, cache_len - kvblk * blk));
  const int ring = sm.ring;
  const int nchunk = (nk + ring - 1) / ring;   // K sub-tiles; V as many
  const bool bulk = ((reinterpret_cast<uintptr_t>(k) |
                      reinterpret_cast<uintptr_t>(v)) & 15) == 0;
  const size_t row0 = (((size_t)b * Hkv + h) * nblk + kvblk) * blk;
  // chunk c < nchunk is K sub-tile c, then V sub-tile c - nchunk; it goes
  // to slot c % 2
  auto chunk_keys = [&](int c) {
    return min(ring, nk - (c % nchunk) * ring);
  };
  auto chunk_src = [&](int c) {
    return (c < nchunk ? k : v) + (row0 + (size_t)(c % nchunk) * ring) * D;
  };
  auto slot = [&](int c) { return slots + (size_t)(c & 1) * ring * D; };
  auto issue = [&](int c) {
    bulk_copy(slot(c), chunk_src(c),
              (uint32_t)(chunk_keys(c) * D * sizeof(T)), &full[c & 1]);
  };
  auto wait = [&](int c) {
    if (bulk) {
      mbar_wait(&full[c & 1], (c >> 1) & 1);
    } else {
      const T* src = chunk_src(c);
      T* dst = slot(c);
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
  const T* qb = q + ((size_t)b * Hkv + h) * G * D;
  float qv[kQLoads];
#pragma unroll
  for (int r = 0; r < kQLoads; ++r) {
    const int idx = tid + r * kThreads;
    qv[r] = idx < G * D ? decode::to_f32(qb[idx]) : 0.f;
  }

  int first, last;
  if (!decode::split_of<LegacyRuns>(items, i, L, first, last)) {
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
    constexpr int kBatch = 16 / MaxG < (4 + Ly::kRowsPerWarp - 1) / Ly::kRowsPerWarp
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
      const T* ks = slot(c);
      const int nkc = chunk_keys(c), key0 = c * ring;
      for (int rb = warp * kWarpRows; rb < nkc; rb += kWarps * kWarpRows) {
        // this lane's rows: r0 + j * kRowsPerWarp
        const int r0 = rb + lane / Ly::kRowLanes;
        float kf[kBatch][kQ];
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
          const int r = r0 + j * Ly::kRowsPerWarp;
#pragma unroll
          for (int t = 0; t < Ly::kPerLane; ++t) {
            uint4 raw = make_uint4(0u, 0u, 0u, 0u);
            if (r < nkc)
              raw = *reinterpret_cast<const uint4*>(
                  ks + (size_t)r * D + (sub + t * Ly::kRowLanes) * kVec);
            float f[kVec];
            unpack(raw, f, T{});
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
            if (r < nkc) p_s[(key0 + r) * MaxG + g] = s[n] * scale;
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
      const T* vs = slot(c);
      const int nkc = chunk_keys(c), key0 = (c - nchunk) * ring;
#pragma unroll 2
      for (int kk = kg; kk < nkc; kk += Ly::kGroups) {
        const uint4 raw = *reinterpret_cast<const uint4*>(
            vs + (size_t)kk * D + cv * kVec);
        float vf[kVec];
        unpack(raw, vf, T{});
        const float4* pk =
            reinterpret_cast<const float4*>(p_s + (key0 + kk) * MaxG);
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
  // are not stored)
  const int nsplit = last - first + 1;
  T* ob = out + ((size_t)b * Hkv + h) * G * D;
  float part[kAcc];
#pragma unroll
  for (int r = 0; r < kAcc; ++r) part[r] = 0.f;
  if (nk > 0) {
#pragma unroll
    for (int r = 0; r < kAcc; ++r) {
      const int o = tid + r * kThreads;
      float a = 0.f;
      for (int w = 0; w < Ly::kGroups; ++w) a += red[w * MaxG * D + o];
      part[r] = decode::normalized(a, l_s[o / D]);
    }
  }
  if (nsplit == 1) {   // the run's one split: its output
#pragma unroll
    for (int r = 0; r < kAcc; ++r)
      if (tid + r * kThreads < G * D)
        decode::store(part[r], ob + tid + r * kThreads);
    return;
  }
#pragma unroll
  for (int r = 0; r < kAcc; ++r)
    if (tid + r * kThreads < G * D)
      split.out[(size_t)i * G * D + tid + r * kThreads] = part[r];
  if (tid < G) {
    split.m[(size_t)i * G + tid] = mrow;   // gq == tid
    split.l[(size_t)i * G + tid] = nk > 0 ? l_s[tid] : 0.f;
  }
  __threadfence();
  __syncthreads();
  __shared__ bool merges;
  if (tid == 0) merges = atomicAdd(split.tickets + first, 1) == nsplit - 1;
  __syncthreads();
  if (!merges) return;
  __threadfence();

  // merge_partials over the run's splits s (item first + s), in item
  // order: a partial is real where l > 0; gm is the real partials' max m;
  // each weighs w = exp(m - gm) * l (0 if not real); out = sum(out * w) /
  // max(sum(w), 1e-30), or, where at most one is real, that partial's out
  // (0 if none).  Products and sums rounded one by one, in split order, as
  // the plain version's.  The other CTAs' partials come from L2 into
  // shared memory (__ldcg, cp.async.cg), each chunk's copies issued
  // together; the first chunk's outs fly during the first pass.  The code
  // is loops: a CTA runs it once, from a cold instruction cache.
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
  stage_outs(0, min(sm.merge, nsplit));
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
  // pass 2: the weights and the weighted outs, sm.merge splits at a time;
  // a run of at most kMergeChunk splits keeps pass 1's (m, l)
  const bool kept = nsplit <= kMergeChunk;
  float num[kAcc];
#pragma unroll
  for (int r = 0; r < kAcc; ++r) num[r] = 0.f;
  float den = 0.f;   // thread g < G: the sum of row g's weights
  for (int c0 = 0; c0 < nsplit; c0 += sm.merge) {
    const int nc = min(sm.merge, nsplit - c0);
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
      decode::store(val, ob + o);
    }
  }
  if (tid == 0) split.tickets[first] = 0;
}

template <typename T, int D, int MaxG>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* items, void* out, SplitWork split, int L,
                   int Hkv, int G, int blk, int nblk, int cache_len,
                   float scale, cudaStream_t stream) {
  const Smem sm = smem_plan<T, D, MaxG>(blk);
  if (sm.total == 0) return cudaErrorInvalidValue;
  auto kern = legacy_decode_kernel<T, D, MaxG>;
  if (sm.total > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sm.total);
    if (e != cudaSuccess) return e;
  }
  kern<<<L, kThreads, sm.total, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), items, static_cast<T*>(out), L, Hkv, G, blk,
      nblk, cache_len, scale, sm, split);
  return cudaGetLastError();
}

}  // namespace legacy

// dtype: 0 = bfloat16, 1 = float32 (q, both caches and out share it);
// head_dim 32, 64, 128 or 256; G <= 8 (a G <= 4 and a G <= 8
// instantiation).  partials: f32 [L * G * (D + 2)] workspace (out [L, G,
// D], then m and l [L, G]); tickets: int32 [L], zero at the call and left
// zero.  Keys at kpos >= cache_len are masked.  Returns the launch's
// cudaError_t.
extern "C" int sparse_decode(const void* q, const void* k_cache,
                             const void* v_cache, const int* items,
                             void* out, float* partials, int* tickets, int L,
                             int Hkv, int G, int D, int block_kv,
                             int max_len, int cache_len, float scale,
                             int dtype, void* stream) {
  if (L <= 0 || G < 1 || G > decode::kMaxG || block_kv < 1 ||
      max_len % block_kv || partials == nullptr || tickets == nullptr)
    return cudaErrorInvalidValue;
  const size_t n = (size_t)L * G;
  const decode::SplitWork split{partials, partials + n * D,
                                partials + n * (D + 1), tickets};
  const int nblk = max_len / block_kv;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define LEGACY_LAUNCH(T, DD)                                                 \
  return G <= decode::kSmallG                                                \
             ? legacy::launch<T, DD, decode::kSmallG>(                       \
                   q, k_cache, v_cache, items, out, split, L, Hkv, G,        \
                   block_kv, nblk, cache_len, scale, st)                     \
             : legacy::launch<T, DD, decode::kMaxG>(                         \
                   q, k_cache, v_cache, items, out, split, L, Hkv, G,        \
                   block_kv, nblk, cache_len, scale, st)
#define LEGACY_DIMS(DT, T)                                                   \
  if (dtype == DT && D == 32) LEGACY_LAUNCH(T, 32);                          \
  if (dtype == DT && D == 64) LEGACY_LAUNCH(T, 64);                          \
  if (dtype == DT && D == 128) LEGACY_LAUNCH(T, 128);                        \
  if (dtype == DT && D == 256) LEGACY_LAUNCH(T, 256)
  LEGACY_DIMS(0, __nv_bfloat16);
  LEGACY_DIMS(1, float);
#undef LEGACY_DIMS
#undef LEGACY_LAUNCH
  return cudaErrorInvalidValue;
}
