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
// Design and bound.  The walk is the one flash_decode.cuh describes (its
// decode_runs_kernel was built from this one): one CTA (128 threads) per
// item walks one tile; K and V each one bulk copy (cp.async.bulk on an
// mbarrier) issued before the run scans (split_of under the legacy run
// rule), only the keys under cache_len, a two-slot ring of 64-key
// sub-tiles where the tiles do not fit; q.k by the lanes of a key row
// (16-byte vectors, q in registers) with a shuffle reduce-scatter; a
// thread per (key, row) pair in the softmax; one p.V pass over V in shared
// memory; a run of several splits merged by the CTA that draws its last
// ticket with merge_splits, the one merge of the three decodes.  It is
// bound, as they are, by the bytes of the selected tiles, and a launch by
// one tile's chain of latencies plus the merge.  The walk stays its own
// rather than the flash decodes' body: run through that body under the
// legacy rule, its f32 form at Yi-6B's shapes took 1.03-1.07x this walk's
// time on an H100 (PERF.md §6).
#include <stdint.h>

#include "flash_decode.cuh"

namespace legacy {

using namespace decode;

// The legacy run rule: only valid items start or end a run.
struct LegacyRuns {
  __device__ static bool starts(const int* t) {
    return t[D_FIRST] == 1 && t[D_VALID] == 1;
  }
  __device__ static bool ends(const int* t) {
    return t[D_LAST] == 1 && t[D_VALID] == 1;
  }
};

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
    qv[r] = idx < G * D ? to_f32(qb[idx]) : 0.f;
  }

  int first, last;
  if (!split_of<LegacyRuns>(items, i, L, first, last)) {
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
      part[r] = normalized(a, l_s[o / D]);
    }
  }
  if (nsplit == 1) {   // the run's one split: its output
#pragma unroll
    for (int r = 0; r < kAcc; ++r)
      if (tid + r * kThreads < G * D)
        store(part[r], ob + tid + r * kThreads);
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

  merge_splits<MaxG, D, false>(split, first, nsplit, G,
                                reinterpret_cast<float*>(smem), sm.merge, ob,
                                nullptr, nullptr);
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
