// Dense flash attention for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attn.py::flash_attention
// (body _flash_kernel, pallas_call at flash_attn.py:117), the paper's dense
// baseline, reached through the library entry ops.flash_attention.
//
// What it computes.  q [H, Sq, D] attends k/v [Hkv, Skv, D], query head h
// reading kv head h / n_rep (GQA, no repeated copy).  Queries sit at
// positions 0..Sq-1 and keys at 0..Skv-1; keys at kpos >= Skv are masked,
// and with `causal` so are keys at kpos > qpos.  Output [H, Sq, D] in q's
// dtype, finalized as acc / max(l, 1e-30) (no zeroing, as the reference).
// The window form (a sliding-window layer's dense prefill, as the
// reference's flash_scan_attention(window=) computes it outside Pallas)
// also masks keys at kpos <= qpos - window, and each CTA starts its kv loop
// at the first tile that meets its first row's window, not at tile 0.
//
// Design.  The TPU grid (H, nQ, nKV) carries (acc, m, l) across its
// innermost kv axis; here a CTA loops over the kv tiles, skipping those
// wholly above its rows' causal diagonal.  Both bodies are the sparse
// prefill's (sparse_prefill.cuh), chosen by dtype:
//  * bf16: the tensor-core body (wgmma, one pass per tile, a 2-stage
//    cp.async ring); a CTA (one warpgroup) owns 64 rows of a q block and
//    its tiles are the dense kv blocks 0..last.  The grid goes over (q
//    slice, head) with the last q slices, which walk the most tiles when
//    causal, first, so the longest CTAs do not set the tail;
//  * f32: the scalar body, one thread per query row (two at head_dim 128)
//    and CTA per (q block, head), as before; at head_dim 256 four threads
//    per row, a CTA per (64-row slice of a q block, head), K/V staged 64
//    keys at a time.
//
// What bounds it.  The larger of the bytes (q, K, V read once, out written
// once) over 3.35 TB/s and the FLOPs of the unmasked (query, key) pairs
// (4 * D each) over the bf16 tensor-core rate: at 4096 tokens it is the
// operations.  The bf16 body waits on each product before the softmax
// that follows it (no second warpgroup or ping-pong to overlap them), and
// spends part of each 64-key step on the exponentials and shuffles; the
// f32 body is bound by its own instruction rate.
#include "sparse_prefill.cuh"

namespace {

// kRowSplit<D> threads per query row; a CTA per (q block, head), or at
// prefill::kSliced<D> per (64-row slice of a q block, head) with K/V staged
// prefill::kSliceKeys keys at a time.
template <typename T, int D, bool kWin>
__global__ void flash_attention_kernel(const T* __restrict__ q,
                                       const T* __restrict__ k,
                                       const T* __restrict__ v,
                                       T* __restrict__ out, int Sq, int Skv,
                                       int n_rep, int bq, int bkv,
                                       bool causal, float scale, int window) {
  using prefill::kSliceKeys;
  using prefill::kSliceRows;
  constexpr bool kSlice = prefill::kSliced<D>;
  const int nslices = kSlice ? (bq + kSliceRows - 1) / kSliceRows : 1;
  const int qblk = kSlice ? blockIdx.x / nslices : blockIdx.x;
  const int slice = kSlice ? blockIdx.x % nslices : 0;
  const int head = blockIdx.y, kvh = head / n_rep;
  constexpr int kSplit = prefill::kRowSplit<D>, DT = D / kSplit;
  const int r = slice * kSliceRows + threadIdx.x / kSplit;  // in the block
  const int qpos = qblk * bq + r;
  const int d0 = (threadIdx.x % kSplit) * DT;  // this thread's dims
  const bool row_ok = (!kSlice || r < bq) && qpos < Sq;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* k_s = reinterpret_cast<T*>(smem_raw);  // [bkv or kSliceKeys][D]
  T* v_s = k_s + (size_t)(kSlice ? kSliceKeys : bkv) * D;

  float qr[DT], acc[DT];
  const T* qrow = q + ((size_t)head * Sq + (row_ok ? qpos : 0)) * D + d0;
#pragma unroll
  for (int d = 0; d < DT; ++d) {
    qr[d] = row_ok ? prefill::to_f32(qrow[d]) : 0.f;
    acc[d] = 0.f;
  }
  float m = -CUDART_INF_F, l = 0.f;
  auto keep = [&](int kpos) {
    return row_ok && kpos < Skv && (!causal || kpos <= qpos) &&
           (!kWin || kpos > qpos - window);
  };
  // kWin: the first tile that holds a key of the CTA's first row's window
  const int kfirst =
      kWin ? max(0, qblk * bq + slice * kSliceRows - window + 1) / bkv : 0;
  if constexpr (kSlice) {
    // no row of the slice keeps a key at or past kend
    const int kend = causal ? min(Skv, qblk * bq + min(bq, (slice + 1) *
                                                               kSliceRows))
                            : Skv;
    for (int kb = kfirst; kb * bkv < kend; ++kb) {
      const size_t row0 = (size_t)kvh * Skv + (size_t)kb * bkv;
      prefill::sliced_tile_update<T, D, kSplit>(
          qr, acc, m, l, k_s, v_s, k + row0 * D, v + row0 * D,
          min(bkv, Skv - kb * bkv), bkv, kb * bkv, kend, scale, keep, 1.f,
          1.f, d0);
    }
  } else {
    const int nkv = (Skv + bkv - 1) / bkv;
    // causal: tiles with k_start > q_start + bq - 1 are skipped
    const int last = causal ? min(nkv - 1, (qblk * bq + bq - 1) / bkv)
                            : nkv - 1;
    for (int kb = kfirst; kb <= last; ++kb) {
      const size_t row0 = (size_t)kvh * Skv + (size_t)kb * bkv;
      prefill::stage_tile<T, D>(k_s, v_s, k + row0 * D, v + row0 * D,
                                min(bkv, Skv - kb * bkv), bkv);
      prefill::row_tile_update<T, D, kSplit>(qr, acc, m, l, k_s, v_s, bkv,
                                             kb * bkv, scale, keep, 1.f,
                                             1.f, d0);
    }
  }
  if (row_ok) {
    T* orow = out + ((size_t)head * Sq + qpos) * D + d0;
#pragma unroll
    for (int d = 0; d < DT; ++d)
      prefill::from_f32(acc[d] / fmaxf(l, 1e-30f), orow + d);
  }
}

template <typename T, int D, bool kWin>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int H, int Sq, int Skv, int n_rep, int bq, int bkv,
                   bool causal, float scale, int window,
                   cudaStream_t stream) {
  constexpr bool kSlice = prefill::kSliced<D>;
  const int rows = kSlice ? prefill::kSliceRows : bq;  // query rows a CTA
  const int threads = rows * prefill::kRowSplit<D>;
  if (threads > 1024) return cudaErrorInvalidValue;
  const size_t smem =
      2 * (size_t)(kSlice ? prefill::kSliceKeys : bkv) * D * sizeof(T);
  auto kern = flash_attention_kernel<T, D, kWin>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const long long nx =
      (long long)((Sq + bq - 1) / bq) * ((bq + rows - 1) / rows);
  if (nx > 0x7fffffffLL) return cudaErrorInvalidValue;
  kern<<<dim3((unsigned)nx, H), threads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Sq, Skv, n_rep, bq,
      bkv, causal, scale, window);
  return cudaGetLastError();
}

// The dense kv tiles 0..last of one kv head [Skv, D] at row `base`.
struct DenseSource {
  long long base;
  int Skv, bkv, kb, last;
  __device__ __forceinline__ bool next(prefill::tc::TileRef& t) {
    if (kb > last) return false;
    t = prefill::tc::TileRef{base + (long long)kb * bkv,
                             min(bkv, Skv - kb * bkv), kb * bkv};
    ++kb;
    return true;
  }
};

template <int D, bool kWin>
__global__ void __launch_bounds__(prefill::tc::kWarps * 32)
    flash_attention_tc_kernel(const __nv_bfloat16* __restrict__ q,
                              const __nv_bfloat16* __restrict__ k,
                              const __nv_bfloat16* __restrict__ v,
                              __nv_bfloat16* __restrict__ out, int H, int Sq,
                              int Skv, int n_rep, int bq, int bkv,
                              int bkv_pad, int nslices, int total,
                              bool causal, float scale_log2, int window) {
  using namespace prefill::tc;
  const int head = blockIdx.x % H;
  const int idx = total - 1 - (int)(blockIdx.x / H);  // last q slices first
  const int qblk = idx / nslices, slice = idx % nslices;
  const int qrow0 = qblk * bq + slice * kRows;
  const int nrows = min(kRows, min(bq - slice * kRows, Sq - qrow0));
  if (nrows <= 0) return;
  const int nkv = (Skv + bkv - 1) / bkv;
  // causal: tiles past the slice's last row are wholly masked
  const int last = causal ? min(nkv - 1, (qrow0 + nrows - 1) / bkv)
                          : nkv - 1;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = align_smem(smem_raw);
  const size_t qoff = ((size_t)head * Sq + qrow0) * D;
  GroupRows<D, kWin> w;
  w.init(q + qoff, nrows, qrow0, causal, smem, window);
  // kWin: the first tile that holds a key of the slice's first row's window
  const int first = kWin ? max(0, qrow0 - window + 1) / bkv : 0;
  DenseSource src{(long long)(head / n_rep) * Skv, Skv, bkv, first, last};
  run_tiles<D>(w, src, smem, k, v, bkv, bkv_pad, Skv, scale_log2);
  w.store(out + qoff, nrows, false);
}

template <int D, bool kWin>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* out,
                      int H, int Sq, int Skv, int n_rep, int bq, int bkv,
                      bool causal, float scale, int window,
                      cudaStream_t stream) {
  namespace tc = prefill::tc;
  const int bkv_pad = tc::pad_keys(bkv);
  const size_t smem = tc::smem_bytes<D>(bkv_pad);
  auto kern = flash_attention_tc_kernel<D, kWin>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int nslices = (bq + tc::kRows - 1) / tc::kRows;
  const long long total = (long long)((Sq + bq - 1) / bq) * nslices;
  if (total * H > 0x7fffffffLL) return cudaErrorInvalidValue;
  kern<<<(unsigned)(total * H), tc::kWarps * 32, smem, stream>>>(
      static_cast<const tc::bf16*>(q), static_cast<const tc::bf16*>(k),
      static_cast<const tc::bf16*>(v), static_cast<tc::bf16*>(out), H, Sq,
      Skv, n_rep, bq, bkv, bkv_pad, nslices, (int)total, causal,
      scale * tc::kLog2e, window);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = bfloat16 (tensor-core body), 1 = float32 (scalar body, one
// thread per query row up to head_dim 64, two at 128 (block_q <= 1024 or
// 512), four at 256 over 64-row slices); q, k, v and out share it; head_dim
// 32, 64, 128 or 256.  window > 0: the window form (keys kpos > qpos -
// window only); < 0: none.  Returns the launch's cudaError_t.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, int H, int Hkv, int Sq, int Skv,
                               int D, int block_q, int block_kv, int causal,
                               float scale, int dtype, int window,
                               void* stream) {
  if (H < 1 || Hkv < 1 || H % Hkv || Sq < 1 || Skv < 1 || block_q < 1 ||
      block_kv < 1 || window == 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_rep = H / Hkv;
  const bool c = causal != 0;
#define FLASH_LAUNCH(FN, ...)                                               \
  do {                                                                      \
    if (window > 0)                                                         \
      return FN<__VA_ARGS__, true>(q, k, v, out, H, Sq, Skv, n_rep,         \
                                   block_q, block_kv, c, scale, window, s); \
    return FN<__VA_ARGS__, false>(q, k, v, out, H, Sq, Skv, n_rep, block_q, \
                                  block_kv, c, scale, window, s);           \
  } while (0)
  if (dtype == 0 && D == 32) FLASH_LAUNCH(launch_tc, 32);
  if (dtype == 0 && D == 64) FLASH_LAUNCH(launch_tc, 64);
  if (dtype == 0 && D == 128) FLASH_LAUNCH(launch_tc, 128);
  if (dtype == 0 && D == 256) FLASH_LAUNCH(launch_tc, 256);
  if (dtype == 1 && D == 32) FLASH_LAUNCH(launch, float, 32);
  if (dtype == 1 && D == 64) FLASH_LAUNCH(launch, float, 64);
  if (dtype == 1 && D == 128) FLASH_LAUNCH(launch, float, 128);
  if (dtype == 1 && D == 256) FLASH_LAUNCH(launch, float, 256);
#undef FLASH_LAUNCH
  return cudaErrorInvalidValue;
}
