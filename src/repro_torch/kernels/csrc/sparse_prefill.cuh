// Work-list block-sparse causal prefill attention for Hopper (sm_90a): the
// one kernel body behind two entry points, which differ only in where a
// (kv head, logical block) K/V tile lives.
//
//   sparse_prefill_paged.cu   tiles from the block pool [N, Hkv, block_kv, D]
//                             through the sequence's table [T] (the paged
//                             serving path, the reference's jnp twin
//                             attention/worklist_jnp.py::worklist_attention_paged)
//   sparse_prefill_contig.cu  tiles of contiguous K/V [Hkv, Skv, D], read in
//                             place (the contiguous serving path's
//                             worklist_attention, and the TPU kernel's own
//                             contiguous signature)
//
// Both replace the TPU kernel src/repro/kernels/sparse_prefill.py::
// sparse_prefill_attention (body _sparse_prefill_kernel, pallas_call at
// sparse_prefill.py:165).  The dense flash attention (flash_attention.cu)
// shares this file's tile bodies.
//
// What it computes.  Items [L, 7] (q head, chunk-local q block, LOGICAL kv
// block, first, last, valid, kv head) name (head, q_blk, kv_blk) flash
// tiles; the items of one (head, q_blk) run are contiguous.  Queries sit at
// global positions q_offset + i; the mask is kpos <= qpos, kpos < klim (the
// caller's min(kv_len, cache length)) and i < Sq.  A run initializes on its
// `first` item and writes its normalized tile on its valid `last` item; rows
// of (head, q_blk) pairs no run covers stay at the wrapper's zeros.
//
// Grid.  The TPU's sequential-grid carry of (acc, m, l) becomes a loop over
// a run inside one CTA.  The grid goes over the items, and every CTA whose
// item does not start a run exits at once.  A grid over the run starts
// alone was no faster on the card: both grids fit in one wave at the
// serving chunk (PERF.md §6).
//
// Two bodies, chosen by dtype (a dispatch, not a fallback: a failed build or
// launch raises either way).
//
//  * bf16: tensor cores (namespace tc).  A CTA is one warpgroup (4 warps)
//    and owns 64 query rows of a run's q block (a 128-row block is two
//    CTAs, so the serving chunk's 18 runs fill 36 SMs).  S = Q.K^T and
//    O += P.V are wgmma.mma_async m64n64k16 / m64nDk16 bf16 products with
//    f32 accumulation: q stays in registers as A fragments, K (K-major)
//    and V (N-contiguous, the transpose bit) are B operands in shared
//    memory, read through descriptors with the 128-byte (D = 64) or
//    64-byte (D = 32) swizzle; at D = 128 a tile is two 64-column panels
//    with the 128-byte swizzle (see swz), S takes its k steps 0-3 from
//    panel 0 and 4-7 from panel 1, and P.V is two m64n64k16 products per
//    16-key step, one per panel.  At D = 256 the tile is four such panels
//    and two budgets change (see GroupRows and run_steps): q (64 x 256) is
//    staged in shared memory and S reads it through descriptors, since q's
//    A fragments (64 registers) beside O (128) and S (32) would not fit in
//    255 registers; and the ring holds one 64-key step of K and V per stage
//    (a 128-key bf16 pair is 128 KB), so shared memory is q 32 KB + 2 x (K +
//    V) 64 KB = 160 KB.  P.V is four m64n64k16 per 16 keys, one per panel.
//    P goes from the S accumulator into A
//    fragments as bf16 (l sums the rounded p, so the output is a mean of V
//    rows under the weights P.V used).  The online softmax runs once per
//    64-key step on the S fragment (row max over the quad of lanes sharing
//    a row, alpha = exp2(m_old - m_new), rescale O, add P.V), so each q.k
//    dot is computed once; a row with no kept key yet uses m = 0 for its
//    exponentials, so exp(-inf - -inf) never forms.  K/V tiles go through
//    a 2-stage shared-memory ring filled with cp.async (16 bytes a thread,
//    rows past a ragged tail zero-filled with src-size 0): tile j+1 loads
//    while tile j multiplies.  The CTA skips a 64-key step that lies wholly
//    above its rows' causal diagonal or past klim.
//  * f32: the scalar body (namespace prefill): one thread owns one query
//    row (two threads, a half each, at D = 128), two passes per tile in
//    f32 FMA.  TF32 tensor cores would not hold the f32 results within 1e-4
//    of the plain version.  At D = 256 a CTA takes a 64-row slice of the q
//    block with four threads per row (64 + 64 floats of q and acc each) and
//    stages K/V 64 keys at a time (a 128-key f32 K/V pair is 256 KB).
//
// Both addressings run the same body for a dtype, so they give the same
// bits on equal K/V.
//
// Window form (kWin, a template flag; the sliding-window layers' dense
// prefill, the reference's masked _chunk_attend / flash_scan_attention):
// a key also takes part only if kpos > qpos - window, so row i keeps the
// keys (qpos - window, qpos].  Each row keeps its own diagonal key, so a
// run over a dense list never ends with nothing kept.  The scalar body
// skips a tile that lies wholly below the window of the CTA's first row
// (its rows' windows all start later); the tensor-core body stages no such
// tile (WindowSource) and skips a 64-key step wholly below every row's
// window.  The unwindowed instantiations (kWin false) compile to the code
// they compiled to before the flag: every window term folds away.
//
// Quantized pool (the paged form only, as the reference twin's k_scales /
// v_scales branch).  K/V hold int8 or fp8 (e4m3) codes with one f32 scale
// per (physical block, kv head); an item is one pool block, so every
// 64-key step of a tile shares its scales.  Both codes are exact in bf16.
//  * bf16 q: the tensor-core body with one change at staging: the raw code
//    tile (half the bytes of bf16) goes by cp.async into a 2-stage code
//    ring, and after the wait the CTA converts it in shared memory into
//    the one swizzled bf16 K/V tile the descriptors read (cp.async cannot
//    convert).  The tile's k scale multiplies S after the product and
//    before the row max; its v scale is folded into P before P is rounded
//    to bf16, and l sums the unscaled rounded p.
//  * f32 q: the scalar body over code tiles, in the reference's order,
//    s = (q.codes) * scale * k_scale, p.V accumulated as (p * v_scale).codes.
//
// What bounds it.  The least time is the larger of the bytes of the
// selected K/V blocks (plus q and out) over 3.35 TB/s and the FLOPs of the
// unmasked (query, key) pairs (4 * D each) over the bf16 tensor-core rate.
// At the serving chunk (256 queries, ~5 selected tiles per run) both are
// under a microsecond, so the bf16 kernel is bound by latency: launch, the
// first tile's load, and each CTA's chain of dependent products and
// exponentials per 64-key step.  The f32 body is bound by its own
// instruction rate.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

namespace prefill {

constexpr float kNegInf = -1e30f;  // the reference's NEG_INF
constexpr int F_HEAD = 0, F_QBLK = 1, F_KVBLK = 2, F_FIRST = 3, F_LAST = 4,
              F_VALID = 5, F_KVHEAD = 6, ITEM_FIELDS = 7;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) { return (float)x; }
__device__ __forceinline__ float to_f32(__nv_fp8_e4m3 x) {
  return static_cast<float>(x);
}
__device__ __forceinline__ void from_f32(float x, float* dst) { *dst = x; }
__device__ __forceinline__ void from_f32(float x, __nv_bfloat16* dst) {
  *dst = __float2bfloat16(x);
}
__device__ __forceinline__ void from_f32(float x, int8_t* dst) {
  *dst = (int8_t)x;
}
__device__ __forceinline__ void from_f32(float x, __nv_fp8_e4m3* dst) {
  *dst = __nv_fp8_e4m3(x);
}
// The element types of a quantized pool: codes dotted raw, scaled after.
template <typename T>
constexpr bool kIsCode =
    std::is_same_v<T, int8_t> || std::is_same_v<T, __nv_fp8_e4m3>;

// Tiles of the block pool [N, Hkv, bkv, D] through the table [Tw].
struct PoolTiles {
  static constexpr bool kHasScales = true;
  const int* table;
  int Tw, Hkv, bkv;
  // First row of the tile (in units of D elements), or -1 when unmapped;
  // `rows` is how many of its bkv rows exist.  The reference clamps the
  // logical index into the table; positions past it are masked by klim.
  __device__ long long row0(int kvh, int kvblk, int& rows) const {
    rows = bkv;
    const int phys = table[min(max(kvblk, 0), Tw - 1)];
    return phys < 0 ? -1 : ((long long)phys * Hkv + kvh) * bkv;
  }
  // Index of a mapped tile's scale in scales [N, Hkv]: the same physical
  // block (and kv head) as the tile row0() returned.
  __device__ size_t scale_index(long long row0) const {
    return (size_t)row0 / (size_t)bkv;
  }
};

// Tiles of contiguous K/V [Hkv, Skv, D], in place.  As the reference's
// dynamic_slice of the zero-padded K/V, the tile start is clamped into
// [0, Skv_pad - bkv]; rows past Skv are zero.
struct RowTiles {
  static constexpr bool kHasScales = false;
  int Skv, bkv;
  __device__ long long row0(int kvh, int kvblk, int& rows) const {
    const int nb = (Skv + bkv - 1) / bkv;
    const int start = min(max(kvblk, 0), nb - 1) * bkv;
    rows = min(bkv, Skv - start);
    return (long long)kvh * Skv + start;
  }
};

// ---------------------------------------------------------------------------
// f32: the scalar body
// ---------------------------------------------------------------------------

// Stage `rows` rows of a K and a V tile (row-major [rows, D] at `k`/`v`)
// into shared memory [bkv, D]; rows past `rows` are zero, as in the
// reference's zero-padded cache.  Ends with a barrier.
template <typename T, int D>
__device__ __forceinline__ void stage_tile(T* k_s, T* v_s, const T* k,
                                           const T* v, int rows, int bkv) {
  __syncthreads();  // the previous tile is no longer read
  const int have = rows * D;
  for (int e = threadIdx.x; e < have; e += blockDim.x) {
    k_s[e] = k[e];
    v_s[e] = v[e];
  }
  if (rows < bkv) {
    T zero;
    from_f32(0.f, &zero);
    for (int e = have + threadIdx.x; e < bkv * D; e += blockDim.x) {
      k_s[e] = zero;
      v_s[e] = zero;
    }
  }
  __syncthreads();
}

// Threads per query row of the scalar body: one up to head_dim 64; at 128
// two threads share a row, each holding half of its q and acc (64 + 64
// registers, where one thread per row would need 256 and spill); at 256
// four, a quarter each.
template <int D>
constexpr int kRowSplit = D > 128 ? 4 : D > 64 ? 2 : 1;

// q.k over one thread's share of a row (dims [d0, d0 + D / kSplit) of
// krow); the kSplit threads of a row, neighbouring lanes, sum their parts.
template <typename T, int D, int kSplit>
__device__ __forceinline__ float row_dot(const float (&qr)[D / kSplit],
                                         const T* krow) {
  float s = 0.f;
#pragma unroll
  for (int d = 0; d < D / kSplit; ++d) s = fmaf(qr[d], to_f32(krow[d]), s);
  if constexpr (kSplit == 2)
    s += __shfl_xor_sync(3u << (threadIdx.x & 30), s, 1);
  if constexpr (kSplit == 4) {
    const unsigned quad = 0xFu << (threadIdx.x & 28);
    s += __shfl_xor_sync(quad, s, 1);
    s += __shfl_xor_sync(quad, s, 2);
  }
  return s;
}

// One query row's online-softmax update over one staged tile: keys kk in
// [0, bkv) at positions kbase + kk take part where keep(kpos) holds.  A code
// tile (kIsCode<T>) is rescaled after the dots by its ks / vs.  The thread
// holds dims [d0, d0 + D / kSplit) of the row's q and acc.
template <typename T, int D, int kSplit = 1, class Keep>
__device__ __forceinline__ void row_tile_update(
    const float (&qr)[D / kSplit], float (&acc)[D / kSplit], float& m,
    float& l, const T* k_s, const T* v_s, int bkv, int kbase, float scale,
    Keep keep, float ks = 1.f, float vs = 1.f, int d0 = 0) {
  constexpr bool kQuant = kIsCode<T>;
  constexpr int DT = D / kSplit;
  if constexpr (kSplit == 1) d0 = 0;
  // pass 1: row max over the tile (masked scores count as NEG_INF)
  float mx = kNegInf;
  for (int kk = 0; kk < bkv; ++kk) {
    if (keep(kbase + kk)) {
      const float s = row_dot<T, D, kSplit>(qr, k_s + (size_t)kk * D + d0);
      if constexpr (kQuant)
        mx = fmaxf(mx, s * scale * ks);
      else
        mx = fmaxf(mx, s * scale);
    }
  }
  const float m_new = fmaxf(m, mx);
  const float alpha = expf(m - m_new);
  // pass 2: probabilities and p.V
#pragma unroll
  for (int d = 0; d < DT; ++d) acc[d] *= alpha;
  float lsum = 0.f;
  for (int kk = 0; kk < bkv; ++kk) {
    if (keep(kbase + kk)) {
      const float s = row_dot<T, D, kSplit>(qr, k_s + (size_t)kk * D + d0);
      const T* vrow = v_s + (size_t)kk * D + d0;
      if constexpr (kQuant) {
        const float p = expf(s * scale * ks - m_new);
        lsum += p;
        const float pv = p * vs;
#pragma unroll
        for (int d = 0; d < DT; ++d)
          acc[d] = fmaf(pv, to_f32(vrow[d]), acc[d]);
      } else {
        const float p = expf(s * scale - m_new);
        lsum += p;
#pragma unroll
        for (int d = 0; d < DT; ++d)
          acc[d] = fmaf(p, to_f32(vrow[d]), acc[d]);
      }
    }
  }
  l = l * alpha + lsum;
  m = m_new;
}

// head_dim 256 (kSliced<D>): a CTA owns a 64-row slice of a q block, four
// threads per row, and stages K/V kSliceKeys keys at a time (K + V of a
// 64-key f32 step: 128 KB, where a 128-key tile would take 256 KB).
constexpr int kSliceRows = 64, kSliceKeys = 64;
template <int D>
constexpr bool kSliced = D > 128;

// One query row's online-softmax update over a tile at `k` / `v` (row-major
// [bkv, D], its first `rows` rows existing), staged kSliceKeys keys at a
// time into k_s / v_s; the steps from key position `kend` on, where no row
// of the CTA keeps a key, are skipped.  Every thread of the CTA calls it
// with the same tile (it holds barriers).
template <typename TK, int D, int kSplit, class Keep>
__device__ __forceinline__ void sliced_tile_update(
    const float (&qr)[D / kSplit], float (&acc)[D / kSplit], float& m,
    float& l, TK* k_s, TK* v_s, const TK* k, const TK* v, int rows, int bkv,
    int kbase, int kend, float scale, Keep keep, float ks, float vs,
    int d0) {
  for (int c0 = 0; c0 < bkv && kbase + c0 < kend; c0 += kSliceKeys) {
    const int n = min(kSliceKeys, bkv - c0);
    stage_tile<TK, D>(k_s, v_s, k + (size_t)c0 * D, v + (size_t)c0 * D,
                      max(0, min(rows - c0, n)), n);
    row_tile_update<TK, D, kSplit>(qr, acc, m, l, k_s, v_s, n, kbase + c0,
                                   scale, keep, ks, vs, d0);
  }
}

// T is q's and out's element type, TK the K/V tiles' (T, or codes with
// their scales in k_scales / v_scales).  kRowSplit<D> threads per query
// row: the block has bq * kRowSplit<D> threads, one CTA per item; at
// kSliced<D>, kSliceRows * kRowSplit<D> threads and a CTA per (item,
// 64-row slice of its q block).
template <typename T, typename TK, int D, class Tiles, bool kWin>
__global__ void sparse_prefill_kernel(
    const T* __restrict__ q,   // [H, Sq, D]
    const TK* __restrict__ k,  // pool or [Hkv, Skv, D]
    const TK* __restrict__ v,
    const int* __restrict__ items,  // [L, 7]
    T* __restrict__ out,            // [H, Sq, D], zero-filled by the caller
    int L, int Sq, int bq, int bkv, Tiles tiles, int q_offset, int klim,
    float scale, const float* __restrict__ k_scales,
    const float* __restrict__ v_scales, int window) {
  constexpr bool kSlice = kSliced<D>;
  const int nslices = kSlice ? (bq + kSliceRows - 1) / kSliceRows : 1;
  const int i = kSlice ? blockIdx.x / nslices : blockIdx.x;
  const int slice = kSlice ? blockIdx.x % nslices : 0;
  const int* it = items + (size_t)i * ITEM_FIELDS;
  if (it[F_FIRST] != 1) return;
  // runs are homogeneous in (head, q_blk): build_worklist emits them so
  const int head = it[F_HEAD], qblk = it[F_QBLK];
  constexpr int kSplit = kRowSplit<D>, DT = D / kSplit;
  const int r = slice * kSliceRows + threadIdx.x / kSplit;  // in the block
  const int d0 = (threadIdx.x % kSplit) * DT;  // this thread's dims
  const int qpos = qblk * bq + r;         // chunk-local row
  const bool row_ok = (!kSlice || r < bq) && qpos < Sq;
  const int qg = qpos + q_offset;          // global query position

  extern __shared__ __align__(16) unsigned char smem_raw[];
  TK* k_s = reinterpret_cast<TK*>(smem_raw);  // [bkv or kSliceKeys][D]
  TK* v_s = k_s + (size_t)(kSlice ? kSliceKeys : bkv) * D;

  float qr[DT], acc[DT];
  const T* qrow = q + ((size_t)head * Sq + (row_ok ? qpos : 0)) * D + d0;
#pragma unroll
  for (int d = 0; d < DT; ++d) {
    qr[d] = row_ok ? to_f32(qrow[d]) : 0.f;
    acc[d] = 0.f;
  }
  float m = -CUDART_INF_F, l = 0.f;
  auto keep = [&](int kpos) {
    return row_ok && kpos <= qg && kpos < klim && (!kWin || kpos > qg - window);
  };
  // kWin: the first key position any row of the CTA keeps (its first row's
  // window start); a tile wholly before it is skipped
  const int klo = kWin ? q_offset + qblk * bq + slice * kSliceRows - window + 1
                       : 0;

  for (int j = i; j < L; ++j) {
    const int* jt = items + (size_t)j * ITEM_FIELDS;
    // a new run before this one finalized: the reference scan resets and
    // never writes this run
    if (j > i && jt[F_FIRST] == 1) return;
    const bool valid = jt[F_VALID] == 1;
    const int kvblk = jt[F_KVBLK];
    const bool use = valid && (!kWin || (kvblk + 1) * bkv > klo);
    int rows = 0;
    const long long row0 = use ? tiles.row0(jt[F_KVHEAD], kvblk, rows) : -1;
    if constexpr (kSlice) {
      if (row0 >= 0) {
        float ksc = 1.f, vsc = 1.f;
        if constexpr (kIsCode<TK>) {
          const size_t si = tiles.scale_index(row0);
          ksc = k_scales[si];
          vsc = v_scales[si];
        }
        // no row of the slice keeps a key at or past kend
        const int kend = min(klim, q_offset + qblk * bq +
                                       min(bq, (slice + 1) * kSliceRows));
        sliced_tile_update<TK, D, kSplit>(qr, acc, m, l, k_s, v_s,
                                          k + row0 * D, v + row0 * D, rows,
                                          bkv, kvblk * bkv, kend, scale,
                                          keep, ksc, vsc, d0);
      }
    } else if (row0 >= 0) {
      stage_tile<TK, D>(k_s, v_s, k + row0 * D, v + row0 * D, rows, bkv);
      if constexpr (kIsCode<TK>) {
        const size_t si = tiles.scale_index(row0);
        row_tile_update<TK, D, kSplit>(qr, acc, m, l, k_s, v_s, bkv,
                                       kvblk * bkv, scale, keep,
                                       k_scales[si], v_scales[si], d0);
      } else {
        row_tile_update<TK, D, kSplit>(qr, acc, m, l, k_s, v_s, bkv,
                                       kvblk * bkv, scale, keep, 1.f, 1.f,
                                       d0);
      }
    }
    if (valid && jt[F_LAST] == 1) {
      if (row_ok) {
        T* orow = out + ((size_t)head * Sq + qpos) * D + d0;
#pragma unroll
        for (int d = 0; d < DT; ++d)
          from_f32(l > 0.f ? acc[d] / fmaxf(l, 1e-30f) : 0.f, orow + d);
      }
      return;
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: the tensor-core body
// ---------------------------------------------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;
constexpr int kWarps = 4;            // warps per CTA
constexpr int kRows = 16 * kWarps;   // query rows per CTA, 16 per warp
constexpr int kStep = 64;            // keys per online-softmax step
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous global -> shared copy; with `fill` false the 16
// bytes are zeros (src-size 0: nothing is read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool fill) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(fill ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// wgmma shared-memory matrix descriptor: start address, a leading byte
// offset these layouts do not use, the stride between 8-row groups, and the
// swizzle (1 = 128-byte rows, 2 = 64-byte rows).
__device__ __forceinline__ uint64_t gmma_desc(const void* p, int sbo_bytes,
                                              int swizzle) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | (uint64_t)1 << 16 |
         (uint64_t)((sbo_bytes >> 4) & 0x3FFF) << 32 |
         (uint64_t)swizzle << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep registers that an in-flight wgmma reads or writes where they are
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[i][e])::"memory");
}
template <int N>
__device__ __forceinline__ void reg_fence(unsigned (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[i][e])::"memory");
}

// d[64 x 8N] += a[64 x 16] (registers, bf16) . B[16 x 8N] (shared memory
// through `desc`; TransB = 1: B stored N-contiguous), f32 accumulate; one
// warpgroup.  N = 8 (n64) and N = 4 (n32).
template <int TransB>
__device__ __forceinline__ void wgmma(float (&d)[8][4], const unsigned (&a)[4],
                                      uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1),
        "n"(TransB));
}
template <int TransB>
__device__ __forceinline__ void wgmma(float (&d)[4][4], const unsigned (&a)[4],
                                      uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1),
        "n"(TransB));
}

// d[64 x 64] += A[64 x 16] . B[16 x 64], A and B both from shared memory
// through descriptors (both K-major), f32 accumulate; one warpgroup.
__device__ __forceinline__ void wgmma_ss(float (&d)[8][4], uint64_t adesc,
                                         uint64_t bdesc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(adesc), "l"(bdesc), "r"(1));
}

// The n64 product into panel P of an [N][4] accumulator: dims 64P..64P+63
// of a head_dim-128 (N = 16) or -256 (N = 32) O, whose V tile is 64-column
// panels.
template <int TransB, int P, int N>
__device__ __forceinline__ void wgmma_panel(float (&d)[N][4],
                                            const unsigned (&a)[4],
                                            uint64_t desc) {
  constexpr int o = 8 * P;
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[o][0]), "+f"(d[o][1]), "+f"(d[o][2]), "+f"(d[o][3]),
        "+f"(d[o + 1][0]), "+f"(d[o + 1][1]), "+f"(d[o + 1][2]),
        "+f"(d[o + 1][3]), "+f"(d[o + 2][0]), "+f"(d[o + 2][1]),
        "+f"(d[o + 2][2]), "+f"(d[o + 2][3]), "+f"(d[o + 3][0]),
        "+f"(d[o + 3][1]), "+f"(d[o + 3][2]), "+f"(d[o + 3][3]),
        "+f"(d[o + 4][0]), "+f"(d[o + 4][1]), "+f"(d[o + 4][2]),
        "+f"(d[o + 4][3]), "+f"(d[o + 5][0]), "+f"(d[o + 5][1]),
        "+f"(d[o + 5][2]), "+f"(d[o + 5][3]), "+f"(d[o + 6][0]),
        "+f"(d[o + 6][1]), "+f"(d[o + 6][2]), "+f"(d[o + 6][3]),
        "+f"(d[o + 7][0]), "+f"(d[o + 7][1]), "+f"(d[o + 7][2]),
        "+f"(d[o + 7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1),
        "n"(TransB));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&h);
}

// Element offset of (row r, 16-byte chunk c) in a [rows][D] bf16 tile whose
// chunks are XOR-swizzled as wgmma's 128-byte (D = 64) or 64-byte (D = 32)
// swizzle reads them, the tile starting on a 1024-byte boundary.  A
// head_dim-128 row (256 bytes) is wider than the 128-byte swizzle span: its
// tile is two 64-column panels, interleaved by 8-row group (group g holds
// panel 0's rows 8g..8g+7, 1024 bytes, then panel 1's), each panel's rows
// 128-byte-swizzled.  A 64-key step's K rows are then 8-row groups 2048
// bytes apart, and panel 1 sits 1024 bytes after panel 0 in every group.
// A head_dim-256 row (512 bytes) is four panels the same way: 8-row groups
// 4096 bytes apart, panel p 1024 * p bytes into its group.
template <int D>
__device__ __forceinline__ int swz(int r, int c) {
  static_assert(D == 32 || D == 64 || D == 128 || D == 256,
                "head_dim 32, 64, 128 or 256");
  if constexpr (D >= 128) {
    return (r >> 3) * (8 * D) + (c >> 3) * 512 + (r & 7) * 64 +
           (((c & 7) ^ (r & 7)) << 3);
  } else {
    const int x = D == 64 ? (r & 7) : ((r >> 1) & 3);
    return r * D + ((c ^ x) << 3);
  }
}

// Element offset, from a 64-key step's first K row, of the 16 dims of k
// step kq (the start of wgmma's B operand in S = Q.K^T, and of A where q
// is in shared memory): 32 bytes into the swizzled rows, in panel kq / 4 at
// head_dim 128 and 256.
template <int D>
__device__ __forceinline__ constexpr int k_step_offset(int kq) {
  return D >= 128 ? (kq >> 2) * 512 + (kq & 3) * 16 : kq * 16;
}

// One staged K/V tile: its first row (units of D elements), how many of
// its rows exist, and the position of its key 0.
struct TileRef {
  long long row0;
  int rows, kbase;
};

// Issue the cp.async copies of a tile into K/V stage buffers [bkv_pad][D]
// (rows past `rows` zero-filled) and commit them as one group.
template <int D>
__device__ __forceinline__ void stage_async(bf16* ks, bf16* vs, const bf16* k,
                                            const bf16* v, const TileRef& t,
                                            int bkv) {
  constexpr int CPR = D / 8;  // 16-byte chunks per row
  const bf16* kt = k + t.row0 * D;
  const bf16* vt = v + t.row0 * D;
  for (int e = threadIdx.x; e < bkv * CPR; e += blockDim.x) {
    const int r = e / CPR, c = e % CPR;
    const bool fill = r < t.rows;
    const int off = fill ? r * D + c * 8 : 0;
    cp_async16(ks + swz<D>(r, c), kt + off, fill);
    cp_async16(vs + swz<D>(r, c), vt + off, fill);
  }
  cp_async_commit();
}

// The CTA's 64 query rows, one warpgroup: warp w holds rows 16w..16w+15,
// lane l of it rows g = l/4 and g + 8 (h = 0, 1), as wgmma's register
// fragments do.
template <int D, bool kWin = false>
struct GroupRows {
  // at head_dim 256 q lives in shared memory (q_s, the K tile's panel
  // layout) and S reads it through descriptors: its A fragments (64
  // registers) beside O (128) and S (32) would not fit in 255
  static constexpr bool kQShared = D > 128;
  unsigned qf[kQShared ? 1 : D / 16][4];  // q as A fragments, one per
                                          // 16-dim k step
  float acc[D / 8][4];     // O accumulator, one block per 8 dims (at D =
                           // 128: 64 registers, q's fragments 32)
  float m[2], l[2];        // running max (log2 units), this lane's partial sum
  int qlim[2];             // row h sees keys kpos <= qlim[h]; -1: no row
  int gmax;                // the largest qlim of the CTA
  int qlo[2];              // kWin: row h sees keys kpos >= qlo[h]
  int gmin;                // kWin: the smallest qlo of the CTA
  const bf16* q_s;         // kQShared: q [kRows][D], 1024-byte aligned

  // q rows start at `qbase` (CTA row 0, at position qlim0); CTA rows >=
  // nrows are not computed.  CTA row i sees keys up to qlim0 + i (causal)
  // or all, and with kWin only those past qlim0 + i - window.  With
  // kQShared, q is copied to `q_smem` (zeros past nrows).
  __device__ __forceinline__ void init(const bf16* qbase, int nrows,
                                       int qlim0, bool causal,
                                       bf16* q_smem = nullptr,
                                       int window = 0) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int g = lane >> 2, t = lane & 3;
    const unsigned* rowp[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = warp * 16 + g + 8 * h;
      const bool ok = r < nrows;
      qlim[h] = !ok ? -1 : causal ? qlim0 + r : 0x7fffffff;
      if constexpr (kWin) qlo[h] = qlim0 + r - window + 1;
      rowp[h] = ok ? reinterpret_cast<const unsigned*>(qbase + (size_t)r * D)
                   : nullptr;
      m[h] = -CUDART_INF_F;
      l[h] = 0.f;
    }
    if constexpr (kQShared) {
      constexpr int CPR = D / 8;  // 16-byte chunks per row
      q_s = q_smem;
      for (int e = threadIdx.x; e < kRows * CPR; e += blockDim.x) {
        const int r = e / CPR, c = e % CPR;
        uint4 x = make_uint4(0u, 0u, 0u, 0u);
        if (r < nrows)
          x = *reinterpret_cast<const uint4*>(qbase + (size_t)r * D + c * 8);
        *reinterpret_cast<uint4*>(q_smem + swz<D>(r, c)) = x;
      }
    } else {
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        // a0: (g, 2t) a1: (g+8, 2t) a2: (g, 2t+8) a3: (g+8, 2t+8), 2 bf16
        // each
        qf[ks][0] = rowp[0] ? rowp[0][ks * 8 + t] : 0u;
        qf[ks][1] = rowp[1] ? rowp[1][ks * 8 + t] : 0u;
        qf[ks][2] = rowp[0] ? rowp[0][ks * 8 + 4 + t] : 0u;
        qf[ks][3] = rowp[1] ? rowp[1][ks * 8 + 4 + t] : 0u;
      }
    }
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[dn][e] = 0.f;
    gmax = nrows <= 0 ? -1 : causal ? qlim0 + nrows - 1 : 0x7fffffff;
    if constexpr (kWin) gmin = qlim0 - window + 1;
  }

  // One online-softmax step over the 64 staged keys [c0, c0 + 64) of a tile
  // whose key 0 sits at position kbase.  kScaled (a code tile): the caller
  // folds the tile's k scale into scale_log2, and P.V takes P * v_scale.
  template <bool kScaled = false>
  __device__ __forceinline__ void step(const bf16* ks, const bf16* vs,
                                       int c0, int kbase, int bkv, int klim,
                                       float scale_log2,
                                       float v_scale = 1.f) {
    constexpr int SW = D == 32 ? 2 : 1;  // 64- or 128-byte swizzle
    constexpr int SBO = 8 * D * 2;       // bytes from one 8-row group to next
    const int t = threadIdx.x & 3;
    // S = Q.K^T: D/16 k steps of m64n64k16, B = the step's 64 K rows
    // (K-major; a k step is 32 bytes into the swizzled rows)
    float s[8][4];  // 8 blocks of 8 keys
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] = 0.f;
    reg_fence(s);
    wgmma_fence();
    if constexpr (kQShared) {
#pragma unroll
      for (int kq = 0; kq < D / 16; ++kq)
        wgmma_ss(s, gmma_desc(q_s + k_step_offset<D>(kq), SBO, SW),
                 gmma_desc(ks + c0 * D + k_step_offset<D>(kq), SBO, SW));
    } else {
#pragma unroll
      for (int kq = 0; kq < D / 16; ++kq)
        wgmma<0>(s, qf[kq],
                 gmma_desc(ks + c0 * D + k_step_offset<D>(kq), SBO, SW));
    }
    wgmma_commit();
    wgmma_wait0();
    reg_fence(s);
    // mask by position, scale, row max over the quad sharing a row
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kk = c0 + nb * 8 + 2 * t + (e & 1);
        const int kpos = kbase + kk;
        const bool keep = kk < bkv && kpos < klim && kpos <= qlim[e >> 1] &&
                          (!kWin || kpos >= qlo[e >> 1]);
        s[nb][e] = keep ? s[nb][e] * scale_log2 : -CUDART_INF_F;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[nb][e]);
      }
    float alpha[2], mu[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      mu[h] = m_new == -CUDART_INF_F ? 0.f : m_new;  // no row key kept yet
      alpha[h] = exp2f(m[h] - mu[h]);
      m[h] = m_new;
    }
    // p is rounded to bf16 for P.V, and l sums the rounded values, so the
    // output is a weighted mean of V rows with the weights P.V used (with
    // a v scale, P.V takes p * v_scale, rounded once, and l the rounded p)
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[nb][e] - mu[e >> 1]);
        if constexpr (kScaled) {
          rs[e >> 1] += __bfloat162float(__float2bfloat16_rn(p));
          s[nb][e] = p * v_scale;
        } else {
          s[nb][e] = __bfloat162float(__float2bfloat16_rn(p));
          rs[e >> 1] += s[nb][e];
        }
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + rs[h];
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      acc[dn][0] *= alpha[0];
      acc[dn][1] *= alpha[0];
      acc[dn][2] *= alpha[1];
      acc[dn][3] *= alpha[1];
    }
    // O += P.V: 4 k steps of 16 keys, m64nDk16 (at D = 128 and 256 one
    // m64n64k16 per V panel); P's A fragment of step j is S's accumulator
    // blocks 2j and 2j+1, and B = 16 V rows, stored N-contiguous (the
    // transpose bit)
    unsigned pf[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      pf[j][0] = pack_bf16(s[2 * j][0], s[2 * j][1]);
      pf[j][1] = pack_bf16(s[2 * j][2], s[2 * j][3]);
      pf[j][2] = pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]);
      pf[j][3] = pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3]);
    }
    reg_fence(pf);
    reg_fence(acc);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if constexpr (D >= 128) {
        const bf16* vj = vs + (c0 + 16 * j) * D;
        wgmma_panel<1, 0>(acc, pf[j], gmma_desc(vj, SBO, SW));
        wgmma_panel<1, 1>(acc, pf[j], gmma_desc(vj + 512, SBO, SW));
        if constexpr (D == 256) {
          wgmma_panel<1, 2>(acc, pf[j], gmma_desc(vj + 1024, SBO, SW));
          wgmma_panel<1, 3>(acc, pf[j], gmma_desc(vj + 1536, SBO, SW));
        }
      } else {
        wgmma<1>(acc, pf[j], gmma_desc(vs + (c0 + 16 * j) * D, SBO, SW));
      }
    }
    wgmma_commit();
    wgmma_wait0();
    reg_fence(acc);
    reg_fence(pf);
  }

  // Write the normalized rows (CTA rows < nrows) at `obase` (CTA row 0):
  // acc / max(l, 1e-30), or zeros for a row with l == 0 when zero_empty.
  __device__ __forceinline__ void store(bf16* obase, int nrows,
                                        bool zero_empty) const {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float lt = l[h];
      lt += __shfl_xor_sync(0xffffffffu, lt, 1);
      lt += __shfl_xor_sync(0xffffffffu, lt, 2);
      const int r = warp * 16 + g + 8 * h;
      if (r >= nrows) continue;
      const bool zero = zero_empty && !(lt > 0.f);
      const float den = fmaxf(lt, 1e-30f);
      bf16* orow = obase + (size_t)r * D;
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        const unsigned pk =
            zero ? 0u
                 : pack_bf16(acc[dn][2 * h] / den, acc[dn][2 * h + 1] / den);
        *reinterpret_cast<unsigned*>(orow + dn * 8 + 2 * t) = pk;
      }
    }
  }
};

// The dynamic shared memory from its first 1024-byte boundary on, where the
// swizzle patterns of wgmma start.
__device__ __forceinline__ bf16* align_smem(unsigned char* raw) {
  return reinterpret_cast<bf16*>(raw +
                                 ((1024 - (smem_u32(raw) & 1023)) & 1023));
}

// Stage buffers: K0, V0, K1, V1 (kBufs = 4; the code form's one bf16 K, V
// pair: 2), each [bkv_pad][D].  Rows in [bkv, bkv_pad) are never copied
// into; they are zeroed once here so that the 64-key steps past a tile's
// end multiply zeros.  At head_dim 128 those rows are not one range of the
// panel layout, so they are zeroed chunk by chunk through swz.
template <int D, int kBufs = 4>
__device__ __forceinline__ void zero_tail(bf16* smem, int bkv, int bkv_pad) {
  const size_t tile = (size_t)bkv_pad * D;
  if constexpr (D == 128) {
    constexpr int CPR = D / 8;  // 16-byte chunks per row
    const int tail = (bkv_pad - bkv) * CPR;
    for (int e = threadIdx.x; e < kBufs * tail; e += blockDim.x) {
      const int x = e % tail;
      *reinterpret_cast<uint4*>(smem + (e / tail) * tile +
                                swz<D>(bkv + x / CPR, x % CPR)) =
          make_uint4(0u, 0u, 0u, 0u);
    }
  } else {
    const int tail = (bkv_pad - bkv) * D;
    for (int e = threadIdx.x; e < kBufs * tail; e += blockDim.x)
      smem[(e / tail) * tile + (size_t)bkv * D + e % tail] =
          __float2bfloat16(0.f);
  }
}

// Issue the cp.async copies of a code tile's K and V rows into the code
// ring's buffers [bkv_pad][D] (unswizzled; rows past `rows` zero-filled)
// and commit them as one group.
template <int D, typename TK>
__device__ __forceinline__ void stage_codes_async(TK* kc, TK* vc, const TK* k,
                                                  const TK* v,
                                                  const TileRef& t, int bkv) {
  constexpr int CPR = D / 16;  // 16-byte chunks per row of 1-byte codes
  const TK* kt = k + t.row0 * D;
  const TK* vt = v + t.row0 * D;
  for (int e = threadIdx.x; e < bkv * CPR; e += blockDim.x) {
    const int r = e / CPR, c = e % CPR;
    const bool fill = r < t.rows;
    const int off = r * D + c * 16;
    cp_async16(kc + off, kt + (fill ? off : 0), fill);
    cp_async16(vc + off, vt + (fill ? off : 0), fill);
  }
  cp_async_commit();
}

// Convert a landed code tile [bkv][D] into the swizzled bf16 tile the
// descriptors read (both codes are exact in bf16); 8 codes a thread step.
template <int D, typename TK>
__device__ __forceinline__ void codes_to_bf16(bf16* dst, const TK* src,
                                              int bkv) {
  constexpr int CPR = D / 8;  // 16-byte bf16 chunks per row
  for (int e = threadIdx.x; e < bkv * CPR; e += blockDim.x) {
    const int r = e / CPR, c = e % CPR;
    alignas(8) TK in[8];
    *reinterpret_cast<uint2*>(in) =
        *reinterpret_cast<const uint2*>(src + r * D + c * 8);
    uint4 o;
    o.x = pack_bf16(to_f32(in[0]), to_f32(in[1]));
    o.y = pack_bf16(to_f32(in[2]), to_f32(in[3]));
    o.z = pack_bf16(to_f32(in[4]), to_f32(in[5]));
    o.w = pack_bf16(to_f32(in[6]), to_f32(in[7]));
    *reinterpret_cast<uint4*>(dst + swz<D>(r, c)) = o;
  }
}

// A staged code tile and its (block, kv head) scales.
struct ScaledTile {
  TileRef ref;
  float ks, vs;
};

// The 64-key steps of the tiles `src` yields (TileRef or ScaledTile), for
// the head_dim-256 ring, which stages a step and not a tile: a step is its
// tile with row0, rows and kbase moved to the step's first key, and `keys`
// of its 64 keys lie inside the tile.  Steps no row of the CTA keeps a key
// of (wholly above its causal diagonal `gmax`, at or past klim, or with
// kWin wholly below every row's window, before `gmin`) are skipped, never
// loaded.
__device__ __forceinline__ TileRef& ref_of(TileRef& t) { return t; }
__device__ __forceinline__ TileRef& ref_of(ScaledTile& t) { return t.ref; }

template <class Source, class Tile, bool kWin = false>
struct StepSource {
  Source& src;
  int bkv, klim, gmax;
  Tile tile;
  int c0;  // the next step's first key in `tile`; bkv: take a new tile
  int gmin;

  __device__ __forceinline__ bool next(Tile& t, int& keys) {
    for (;;) {
      if (c0 >= bkv) {
        if (!src.next(tile)) return false;
        c0 = 0;
      }
      const TileRef& r = ref_of(tile);
      const int c = c0, kb = r.kbase + c;
      c0 += kStep;
      if (kb > gmax || kb >= klim || (kWin && kb + kStep <= gmin)) continue;
      t = tile;
      ref_of(t) = TileRef{r.row0 + c, max(0, min(r.rows - c, kStep)), kb};
      keys = min(kStep, bkv - c);
      return true;
    }
  }
};

// run_tiles at head_dim 256: a 2-stage cp.async ring of 64-key K/V steps at
// `ring` ([kStep][D] K0, V0, K1, V1; 128 KB), step j+1 loading while step j
// multiplies.
template <int D, bool kWin, class Source>
__device__ __forceinline__ void run_steps(GroupRows<D, kWin>& w, Source& src,
                                          bf16* ring, const bf16* k,
                                          const bf16* v, int bkv, int klim,
                                          float scale_log2) {
  constexpr size_t kBuf = (size_t)kStep * D;  // one K or V step
  StepSource<Source, TileRef, kWin> steps{src,    bkv, klim, w.gmax,
                                          {},     bkv, kWin ? w.gmin : 0};
  TileRef cur, nxt;
  int ncur = 0, nnxt = 0;
  bool have = steps.next(cur, ncur);
  if (have) stage_async<D>(ring, ring + kBuf, k, v, cur, kStep);
  int s = 0;
  while (have) {
    const bool more = steps.next(nxt, nnxt);
    if (more) {
      bf16* ks = ring + 2 * (s ^ 1) * kBuf;
      stage_async<D>(ks, ks + kBuf, k, v, nxt, kStep);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    // cp.async and q's copy wrote through the generic proxy; wgmma reads
    // through the async one
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // step `cur` has landed for every thread
    const bf16* ks = ring + 2 * s * kBuf;
    w.step(ks, ks + kBuf, 0, cur.kbase, ncur, klim, scale_log2);
    __syncthreads();  // stage s is read out before it is refilled
    cur = nxt;
    ncur = nnxt;
    have = more;
    s ^= 1;
  }
}

// run_code_tiles at head_dim 256: a 2-stage cp.async ring of 64-key code
// steps, each landed step converted into the one bf16 K/V step pair the
// products read.  At `bufs`: bf16 K, V [kStep][D] (64 KB), then code K0,
// V0, K1, V1 [kStep][D] (64 KB).
template <int D, typename TK, bool kWin, class Source>
__device__ __forceinline__ void run_code_steps(GroupRows<D, kWin>& w,
                                               Source& src,
                                               bf16* bufs, const TK* k,
                                               const TK* v, int bkv,
                                               int klim, float scale_log2) {
  constexpr size_t kBuf = (size_t)kStep * D;  // one K or V step
  TK* ring = reinterpret_cast<TK*>(bufs + 2 * kBuf);
  StepSource<Source, ScaledTile, kWin> steps{
      src, bkv, klim, w.gmax, {}, bkv, kWin ? w.gmin : 0};
  ScaledTile cur, nxt;
  int ncur = 0, nnxt = 0;
  bool have = steps.next(cur, ncur);
  if (have) stage_codes_async<D>(ring, ring + kBuf, k, v, cur.ref, kStep);
  int s = 0;
  while (have) {
    const bool more = steps.next(nxt, nnxt);
    if (more) {
      TK* kc = ring + 2 * (s ^ 1) * kBuf;
      stage_codes_async<D>(kc, kc + kBuf, k, v, nxt.ref, kStep);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // code step `cur` has landed for every thread
    const TK* kc = ring + 2 * s * kBuf;
    codes_to_bf16<D>(bufs, kc, kStep);
    codes_to_bf16<D>(bufs + kBuf, kc + kBuf, kStep);
    // the conversion and q's copy wrote through the generic proxy; wgmma
    // reads through the async one
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // the bf16 step is complete
    w.template step<true>(bufs, bufs + kBuf, 0, cur.ref.kbase, ncur, klim,
                          scale_log2 * cur.ks, cur.vs);
    __syncthreads();  // the bf16 step and code stage s are read out
    cur = nxt;
    ncur = nnxt;
    have = more;
    s ^= 1;
  }
}

// Run the CTA's rows over the tiles `src` yields through the 2-stage
// cp.async ring: tile j+1 loads while tile j multiplies.  At head_dim 256
// (q in shared memory at `smem`) the ring after q stages 64-key steps
// instead (run_steps).
template <int D, bool kWin, class Source>
__device__ __forceinline__ void run_tiles(GroupRows<D, kWin>& w, Source& src,
                                          bf16* smem, const bf16* k,
                                          const bf16* v, int bkv, int bkv_pad,
                                          int klim, float scale_log2) {
  if constexpr (GroupRows<D, kWin>::kQShared) {
    run_steps<D>(w, src, smem + kRows * D, k, v, bkv, klim, scale_log2);
  } else {
    const size_t tile = (size_t)bkv_pad * D;
    zero_tail<D>(smem, bkv, bkv_pad);
    TileRef cur, nxt;
    bool have = src.next(cur);
    if (have) stage_async<D>(smem, smem + tile, k, v, cur, bkv);
    int s = 0;
    while (have) {
      const bool more = src.next(nxt);
      if (more) {
        bf16* ks = smem + (size_t)(2 * (s ^ 1)) * tile;
        stage_async<D>(ks, ks + tile, k, v, nxt, bkv);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      // cp.async and the zero tail wrote through the generic proxy; wgmma
      // reads through the async one
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();  // tile `cur` has landed for every thread
      const bf16* ks = smem + (size_t)(2 * s) * tile;
      for (int c0 = 0; c0 < bkv; c0 += kStep) {
        const int kb = cur.kbase + c0;
        // else the step is wholly masked: above the rows' causal diagonal,
        // at or past klim, or (kWin) below every row's window
        if (kb <= w.gmax && kb < klim && (!kWin || kb + kStep > w.gmin))
          w.step(ks, ks + tile, c0, cur.kbase, bkv, klim, scale_log2);
      }
      __syncthreads();  // stage s is read out before it is refilled
      cur = nxt;
      have = more;
      s ^= 1;
    }
  }
}

// Run the CTA's rows over the code tiles `src` yields: a 2-stage cp.async
// ring of raw codes (tile j+1 loads while tile j multiplies), each landed
// tile converted into the one bf16 K/V pair the products read.  Shared
// memory: bf16 K, V [bkv_pad][D], then code K0, V0, K1, V1 [bkv_pad][D].
// At head_dim 256 (q in shared memory at `smem`) the buffers after q hold
// 64-key steps instead (run_code_steps).
template <int D, typename TK, bool kWin, class Source>
__device__ __forceinline__ void run_code_tiles(GroupRows<D, kWin>& w,
                                               Source& src,
                                               bf16* smem, const TK* k,
                                               const TK* v, int bkv,
                                               int bkv_pad, int klim,
                                               float scale_log2) {
  if constexpr (GroupRows<D, kWin>::kQShared) {
    run_code_steps<D, TK>(w, src, smem + kRows * D, k, v, bkv, klim,
                          scale_log2);
  } else {
    const size_t tile = (size_t)bkv_pad * D;
    TK* ring = reinterpret_cast<TK*>(smem + 2 * tile);
    zero_tail<D, 2>(smem, bkv, bkv_pad);
    ScaledTile cur, nxt;
    bool have = src.next(cur);
    if (have) stage_codes_async<D>(ring, ring + tile, k, v, cur.ref, bkv);
    int s = 0;
    while (have) {
      const bool more = src.next(nxt);
      if (more) {
        TK* kc = ring + (size_t)(2 * (s ^ 1)) * tile;
        stage_codes_async<D>(kc, kc + tile, k, v, nxt.ref, bkv);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();  // code tile `cur` has landed for every thread
      const TK* kc = ring + (size_t)(2 * s) * tile;
      codes_to_bf16<D>(smem, kc, bkv);
      codes_to_bf16<D>(smem + tile, kc + tile, bkv);
      // the conversion and the zero tail wrote through the generic proxy;
      // wgmma reads through the async one
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();  // the bf16 tile is complete
      for (int c0 = 0; c0 < bkv; c0 += kStep) {
        const int kb = cur.ref.kbase + c0;
        // else the step is wholly masked (see run_tiles)
        if (kb <= w.gmax && kb < klim && (!kWin || kb + kStep > w.gmin))
          w.template step<true>(smem, smem + tile, c0, cur.ref.kbase, bkv,
                                klim, scale_log2 * cur.ks, cur.vs);
      }
      __syncthreads();  // the bf16 tile and code stage s are read out
      cur = nxt;
      have = more;
      s ^= 1;
    }
  }
}

// The tiles of one work-list run, item by item, with the reference scan's
// rules: a new `first` ends the run unwritten, a valid `last` ends it
// written, invalid items and unmapped tiles stage nothing.
template <class Tiles>
struct ItemSource {
  const int* items;
  int L, start, j, bkv;
  Tiles tiles;
  bool done, write;

  __device__ __forceinline__ bool next(TileRef& t) {
    while (!done && j < L) {
      const int* it = items + (size_t)j * ITEM_FIELDS;
      if (j > start && it[F_FIRST] == 1) {
        done = true;
        break;
      }
      ++j;
      if (it[F_VALID] != 1) continue;
      done = write = it[F_LAST] == 1;
      const int kvblk = it[F_KVBLK];
      int rows = 0;
      const long long row0 = tiles.row0(it[F_KVHEAD], kvblk, rows);
      if (row0 >= 0) {
        t = TileRef{row0, rows, kvblk * bkv};
        return true;
      }
    }
    return false;
  }
};

// ItemSource over a code pool: each tile with its scales, read at the
// tile's own (physical block, kv head).
template <class Tiles>
struct ScaledItemSource {
  ItemSource<Tiles> items;
  const float* k_scales;
  const float* v_scales;

  __device__ __forceinline__ bool next(ScaledTile& t) {
    if (!items.next(t.ref)) return false;
    const size_t si = items.tiles.scale_index(t.ref.row0);
    t.ks = k_scales[si];
    t.vs = v_scales[si];
    return true;
  }
};

// The tiles of `src` (TileRef or ScaledTile) that hold a key at or past
// `klo`: with a window, a tile wholly below every row's window is never
// staged.
template <class Source>
struct WindowSource {
  Source& src;
  int bkv, klo;

  template <class Tile>
  __device__ __forceinline__ bool next(Tile& t) {
    while (src.next(t))
      if (ref_of(t).kbase + bkv > klo) return true;
    return false;
  }
};

// TK: the K/V tiles' element type, bf16 or codes (with k_scales /
// v_scales, unused otherwise).  kWin: the window form (`window` keys).
template <int D, typename TK, class Tiles, bool kWin>
__global__ void __launch_bounds__(kWarps * 32) sparse_prefill_tc_kernel(
    const bf16* __restrict__ q,  // [H, Sq, D]
    const TK* __restrict__ k,    // pool or [Hkv, Skv, D]
    const TK* __restrict__ v,
    const int* __restrict__ items,  // [L, 7]
    bf16* __restrict__ out,         // [H, Sq, D], zero-filled by the caller
    int L, int nslices, int Sq, int bq, int bkv, int bkv_pad, Tiles tiles,
    int q_offset, int klim, float scale_log2,
    const float* __restrict__ k_scales, const float* __restrict__ v_scales,
    int window) {
  const int start = blockIdx.x / nslices, slice = blockIdx.x % nslices;
  const int* it = items + (size_t)start * ITEM_FIELDS;
  if (it[F_FIRST] != 1) return;
  // runs are homogeneous in (head, q_blk): build_worklist emits them so
  const int head = it[F_HEAD];
  const int qrow0 = it[F_QBLK] * bq + slice * kRows;  // chunk-local
  const int nrows = min(kRows, min(bq - slice * kRows, Sq - qrow0));
  if (nrows <= 0) return;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = align_smem(smem_raw);
  const size_t qoff = ((size_t)head * Sq + qrow0) * D;
  GroupRows<D, kWin> w;
  w.init(q + qoff, nrows, qrow0 + q_offset, true, smem, window);
  ItemSource<Tiles> src{items, L, start, start, bkv, tiles, false, false};
  if constexpr (kIsCode<TK>) {
    ScaledItemSource<Tiles> scaled{src, k_scales, v_scales};
    if constexpr (kWin) {
      WindowSource<ScaledItemSource<Tiles>> win{scaled, bkv, w.gmin};
      run_code_tiles<D>(w, win, smem, k, v, bkv, bkv_pad, klim, scale_log2);
    } else {
      run_code_tiles<D>(w, scaled, smem, k, v, bkv, bkv_pad, klim,
                        scale_log2);
    }
    if (scaled.items.write) w.store(out + qoff, nrows, true);
  } else {
    if constexpr (kWin) {
      WindowSource<ItemSource<Tiles>> win{src, bkv, w.gmin};
      run_tiles<D>(w, win, smem, k, v, bkv, bkv_pad, klim, scale_log2);
    } else {
      run_tiles<D>(w, src, smem, k, v, bkv, bkv_pad, klim, scale_log2);
    }
    if (src.write) w.store(out + qoff, nrows, true);
  }
}

// Dynamic shared memory of the bf16 body: two stages of K and V tiles, and
// room to start them on a 1024-byte boundary.  The code form's one bf16
// K/V pair and its 2-stage ring of 1-byte codes take the same bytes.  At
// head_dim 256: q and two stages of K and V 64-key steps (160 KB).
template <int D>
inline size_t smem_bytes(int bkv_pad) {
  if constexpr (GroupRows<D>::kQShared)
    return (size_t)(kRows + 4 * kStep) * D * sizeof(bf16) + 1024;
  else
    return 4 * (size_t)bkv_pad * D * sizeof(bf16) + 1024;
}

inline int pad_keys(int bkv) { return (bkv + kStep - 1) / kStep * kStep; }

}  // namespace tc

template <int D, typename TK, class Tiles, bool kWin>
cudaError_t launch_tc(const void* q, const void* k, const void* v,
                      const float* k_scales, const float* v_scales,
                      const int* items, void* out, int L, int Sq, int bq,
                      int bkv, Tiles tiles, int q_offset, int klim,
                      float scale, int window, cudaStream_t stream) {
  const int bkv_pad = tc::pad_keys(bkv);
  const size_t smem = tc::smem_bytes<D>(bkv_pad);
  auto kern = tc::sparse_prefill_tc_kernel<D, TK, Tiles, kWin>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int nslices = (bq + tc::kRows - 1) / tc::kRows;
  const long long grid = (long long)L * nslices;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  kern<<<(unsigned)grid, tc::kWarps * 32, smem, stream>>>(
      static_cast<const tc::bf16*>(q), static_cast<const TK*>(k),
      static_cast<const TK*>(v), items, static_cast<tc::bf16*>(out),
      L, nslices, Sq, bq, bkv, bkv_pad, tiles, q_offset, klim,
      scale * tc::kLog2e, k_scales, v_scales, window);
  return cudaGetLastError();
}

template <int D, typename TK, class Tiles, bool kWin>
cudaError_t launch_f32(const void* q, const void* k, const void* v,
                       const float* k_scales, const float* v_scales,
                       const int* items, void* out, int L, int Sq, int bq,
                       int bkv, Tiles tiles, int q_offset, int klim,
                       float scale, int window, cudaStream_t stream) {
  constexpr bool kSlice = kSliced<D>;
  const int rows = kSlice ? kSliceRows : bq;  // query rows a CTA
  const int threads = rows * kRowSplit<D>;    // kRowSplit<D> threads a row
  if (threads > 1024) return cudaErrorInvalidValue;
  const size_t smem = 2 * (size_t)(kSlice ? kSliceKeys : bkv) * D * sizeof(TK);
  auto kern = sparse_prefill_kernel<float, TK, D, Tiles, kWin>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const long long grid = (long long)L * ((bq + rows - 1) / rows);
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  kern<<<(unsigned)grid, threads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const TK*>(k),
      static_cast<const TK*>(v), items, static_cast<float*>(out), L, Sq, bq,
      bkv, tiles, q_offset, klim, scale, k_scales, v_scales, window);
  return cudaGetLastError();
}

// dtype: q's (and out's) element type, 0 = bfloat16 (tensor-core body),
// 1 = float32 (scalar body, block_q * kRowSplit<D> <= 1024 up to head_dim
// 128).  kv_dtype: the K/V tiles', equal to dtype, or 2 = int8 / 3 = fp8
// e4m3 codes with k_scales / v_scales (tiles with scales only: the pool).
// head_dim 32, 64, 128 or 256.  window > 0: the window form (keys kpos >
// qpos - window only); < 0: none.  Returns the launch's cudaError_t.
template <class Tiles>
cudaError_t dispatch(int dtype, int kv_dtype, int D, const void* q,
                     const void* k, const void* v, const float* k_scales,
                     const float* v_scales, const int* items, void* out,
                     int L, int Sq, int bq, int bkv, Tiles tiles,
                     int q_offset, int klim, float scale, int window,
                     cudaStream_t stream) {
  if (L <= 0 || bq < 1 || bkv < 1 || window == 0)
    return cudaErrorInvalidValue;
#define PREFILL_LAUNCH(FN, DD, TK)                                          \
  do {                                                                      \
    if (window > 0)                                                         \
      return FN<DD, TK, Tiles, true>(q, k, v, k_scales, v_scales, items,    \
                                     out, L, Sq, bq, bkv, tiles, q_offset,  \
                                     klim, scale, window, stream);          \
    return FN<DD, TK, Tiles, false>(q, k, v, k_scales, v_scales, items,     \
                                    out, L, Sq, bq, bkv, tiles, q_offset,   \
                                    klim, scale, window, stream);           \
  } while (0)
#define PREFILL_DIMS(FN, TK)                                                \
  if (D == 32) PREFILL_LAUNCH(FN, 32, TK);                                  \
  if (D == 64) PREFILL_LAUNCH(FN, 64, TK);                                  \
  if (D == 128) PREFILL_LAUNCH(FN, 128, TK);                                \
  if (D == 256) PREFILL_LAUNCH(FN, 256, TK);                                \
  return cudaErrorInvalidValue
  if (kv_dtype == dtype) {
    if (dtype == 0) { PREFILL_DIMS(launch_tc, tc::bf16); }
    if (dtype == 1) { PREFILL_DIMS(launch_f32, float); }
    return cudaErrorInvalidValue;
  }
  if constexpr (Tiles::kHasScales) {
    if (k_scales == nullptr || v_scales == nullptr)
      return cudaErrorInvalidValue;
    using fp8 = __nv_fp8_e4m3;
    if (dtype == 0 && kv_dtype == 2) { PREFILL_DIMS(launch_tc, int8_t); }
    if (dtype == 0 && kv_dtype == 3) { PREFILL_DIMS(launch_tc, fp8); }
    if (dtype == 1 && kv_dtype == 2) { PREFILL_DIMS(launch_f32, int8_t); }
    if (dtype == 1 && kv_dtype == 3) { PREFILL_DIMS(launch_f32, fp8); }
  }
#undef PREFILL_DIMS
#undef PREFILL_LAUNCH
  return cudaErrorInvalidValue;
}

}  // namespace prefill
