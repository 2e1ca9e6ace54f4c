"""The CUDA kernels against their plain PyTorch versions on the card.

These tests need an NVIDIA GPU and skip elsewhere; they import no JAX, so
they run where the port runs:
``PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py``.  The input
helpers here are shared with ``test_torch_kernels.py``, which holds the
plain versions against the JAX reference on the CPU.
"""
import numpy as np
import pytest
import torch

from repro_torch.attention.policies import strided_policy
from repro_torch.core import worklist as wl
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attn import (
    flash_attention, flash_attention_reference)
from repro_torch.kernels.flash_decode import (
    flash_decode_kernel, flash_decode_paged_kernel, packed_decode_attention,
    packed_decode_attention_paged)
from repro_torch.kernels.sparse_decode import (
    build_decode_worklist, sparse_decode_attention, sparse_decode_reference)
from repro_torch.kernels.sparse_prefill import (
    sparse_prefill_attention, sparse_prefill_paged, worklist_attention,
    worklist_attention_paged)

torch.set_num_threads(1)

BLK = 128


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel against its plain "
                    "version)")
    return torch.device("cuda")


def decode_case(seed, B=3, Hkv=2, G=3, D=32, T=4, holes=False, pad=8,
                layout="packed"):
    """Pool, tables, positions and an item table whose every (row, kv
    head) run selects at least one block: cost-packed with ``pad`` extra
    replicate-last padding rows, or the padded fixed-stride layout whose
    short runs end on an invalid row carrying ``last``, or (``layout="ids"``)
    the per-slot block ids ``[B, Hkv, T]`` themselves; optional -1 table
    entries."""
    rng = np.random.default_rng(seed)
    N = B * T + 1
    q = rng.standard_normal((B, Hkv * G, 1, D)).astype(np.float32)
    kp = rng.standard_normal((N, Hkv, BLK, D)).astype(np.float32)
    vp = rng.standard_normal((N, Hkv, BLK, D)).astype(np.float32)
    pos = rng.integers(BLK, T * BLK, size=B).astype(np.int32)
    perm = rng.permutation(N - 1)
    table = np.full((B, T), -1, np.int32)
    ids = np.full((B, Hkv, T), -1, np.int32)
    for b in range(B):
        nb = int(pos[b]) // BLK + 1
        table[b, :nb] = perm[b * T:b * T + nb]
        for h in range(Hkv):
            n = int(rng.integers(1, nb + 1))
            ids[b, h, :n] = np.sort(rng.choice(nb, size=n, replace=False))
    if holes:
        table[0, 0] = -1
        table[B - 1, int(pos[B - 1]) // BLK] = -1
    if layout == "ids":
        return q, kp, vp, ids, table, pos
    if layout == "padded":
        return q, kp, vp, wl.padded_decode_items(ids), table, pos
    packed = wl.pack_decode_items(ids, num_shards=2, block=BLK)
    items = wl.extend_packed_items(packed.items,
                                   packed.padded_length + pad)
    return q, kp, vp, items.reshape(-1, wl.DEC_FIELDS), table, pos


def as_torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def quant_codes(x, kind):
    """Codes spread over the range of ``kind`` from a float32 array: int8
    values, or the raw bytes (uint8) of fp8 e4m3 values."""
    if kind == "int8":
        return np.clip(np.round(x * 40.0), -127, 127).astype(np.int8)
    t = torch.from_numpy(np.clip(x * 100.0, -448, 448).astype(np.float32))
    return t.to(torch.float8_e4m3fn).view(torch.uint8).numpy()


def code_scales(rng, shape, kind):
    """Per-(block, kv head) scales, different from block to block, that
    dequantize :func:`quant_codes` of N(0, 1) data to 0.25-1x that data:
    no larger than the bf16 checks' N(0, 1) values, the range of their
    2^-6 tolerance."""
    per_unit = 40.0 if kind == "int8" else 100.0   # quant_codes' factor
    return (rng.uniform(0.25, 1.0, size=shape) / per_unit).astype(
        np.float32)


def code_tensor(codes, kind):
    """A numpy code array from :func:`quant_codes` as a torch tensor of
    the code dtype."""
    dtype = torch.int8 if kind == "int8" else torch.float8_e4m3fn
    return torch.from_numpy(np.ascontiguousarray(codes).view(np.uint8)).view(
        dtype)


def as_slot_cache(pool, table):
    """The slot cache ``[B, Hkv, T*BLK, D]`` holding what ``table [B, T]``
    maps from ``pool [N, Hkv, BLK, D]`` (zeros where unmapped), so the two
    layouts hold the same values."""
    B, T = table.shape
    N, hkv, blk, D = pool.shape
    cache = np.zeros((B, hkv, T * blk, D), pool.dtype)
    for b in range(B):
        for j in range(T):
            if table[b, j] >= 0:
                cache[b, :, j * blk:(j + 1) * blk] = pool[table[b, j]]
    return cache


def prefill_case(seed, H=4, Hkv=2, D=32, prompt=640, q_offset=256,
                  chunk=256, drop_run=True, hole=False):
    """A chunk's q, the pool holding the sequence, its table and the chunk
    work list sliced from the prompt's full list (optionally with one
    (head, q_blk) run dropped, so its rows are uncovered)."""
    rng = np.random.default_rng(seed)
    T = -(-prompt // BLK) + 1
    N = T + 2
    q = rng.standard_normal((H, chunk, D)).astype(np.float32)
    kp = rng.standard_normal((N, Hkv, BLK, D)).astype(np.float32)
    vp = rng.standard_normal((N, Hkv, BLK, D)).astype(np.float32)
    table = np.full((T,), -1, np.int32)
    nmap = -(-prompt // BLK)
    table[:nmap] = rng.permutation(N - 1)[:nmap]
    if hole:
        table[1] = -1
    nq = -(-prompt // BLK)
    sels = [strided_policy(h, 2 + h, nq, nq) for h in range(H)]
    full = wl.build_worklist(sels, np.zeros(H, np.int64), 1, nq, nq, BLK,
                             kv_head_of_head=np.arange(H) // (H // Hkv))
    items = wl.chunk_items(full.items[0], q_offset // BLK, chunk // BLK)
    if drop_run:
        keep = ~((items[:, wl.F_HEAD] == 1) & (items[:, wl.F_QBLK] == 0))
        items = items[keep]
    items = wl.chunk_items(items, 0, chunk // BLK, pad_to=len(items) + 5)
    return q, kp, vp, items, table


# head_dim 64 is SmolLM-135M's, 32 its SMOKE size's, 128 Yi-6B's, 256
# Gemma3-1B's: the four the kernels dispatch.  The decode's GQA group G runs
# under a bound of 4 (SmolLM-135M's 3, Gemma3-1B's 4) or of 8 (Yi-6B's 8);
# the prefill's takes any group (2 is the cases' own, 8 Yi-6B's)
@pytest.mark.parametrize("G", [3, 8])
@pytest.mark.parametrize("D", [32, 64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("holes,window,layout", [
    (False, None, "packed"), (True, 200, "packed"), (True, None, "padded")])
def test_cuda_decode_kernel_matches_plain(cuda, dtype, holes, window,
                                          layout, D, G):
    q, kp, vp, items, table, pos = (t.to(cuda) for t in as_torch(
        *decode_case(5, G=G, D=D, holes=holes, layout=layout)))
    q = q.reshape(3, 2, G, D).to(dtype)
    kp, vp = kp.to(dtype), vp.to(dtype)
    before = flash_decode_paged_kernel.launches
    got = flash_decode_paged_kernel(q, kp, vp, items, table, pos,
                                    block_kv=BLK, window=window)
    assert flash_decode_paged_kernel.launches == before + 1
    want = packed_decode_attention_paged(q, kp, vp, items, table, pos,
                                         block_kv=BLK, window=window)
    for g, w in zip(got, want):     # f32 sums in another order
        torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("G", [2, 8])
@pytest.mark.parametrize("D", [32, 64, 128, 256])
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 2.0 ** -6)])
def test_cuda_prefill_kernel_matches_plain(cuda, dtype, atol, D, G):
    q, kp, vp, items, table = (t.to(cuda) for t in as_torch(
        *prefill_case(6, H=2 * G, D=D, hole=True)))
    args = (q.to(dtype), kp.to(dtype), vp.to(dtype), items, table)
    kw = dict(q_offset=256, kv_len=600)
    before = sparse_prefill_paged.launches
    got = sparse_prefill_paged(*args, **kw)
    assert sparse_prefill_paged.launches == before + 1
    want = worklist_attention_paged(*args, **kw)
    # bf16 output: one bf16 ulp at |x| < 4 where the f32 sums round apart
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=0)


def test_cuda_identity_table_prefill_matches_plain(cuda):
    rng = np.random.default_rng(7)
    H, Hkv, S, D = 4, 2, 384, 64
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to(cuda) for s in ((H, S, D), (Hkv, S, D), (Hkv, S, D)))
    nq = S // BLK
    sels = [strided_policy(h, 1 + h % 2, nq, nq) for h in range(H)]
    full = wl.build_worklist(sels, np.zeros(H, np.int64), 1, nq, nq, BLK,
                             kv_head_of_head=np.arange(H) // 2)
    items = torch.from_numpy(full.items[0]).to(cuda)
    got = sparse_prefill_attention(q, k, v, items)
    as_pool = lambda t: t.reshape(Hkv, nq, BLK, D).transpose(
        0, 1).contiguous()                                # noqa: E731
    want = worklist_attention_paged(
        q, as_pool(k), as_pool(v), items,
        torch.arange(nq, dtype=torch.int32, device=cuda), kv_len=S)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("G", [3, 8])
@pytest.mark.parametrize("D", [32, 64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("window,layout", [
    (None, "packed"), (200, "packed"), (None, "padded")])
def test_cuda_contiguous_decode_kernel_matches_plain(cuda, dtype, window,
                                                     layout, D, G):
    q, kp, vp, items, table, pos = decode_case(8, G=G, D=D, layout=layout)
    kc, vc = as_slot_cache(kp, table), as_slot_cache(vp, table)
    q, kp, vp, kc, vc, items, table, pos = (t.to(cuda) for t in as_torch(
        q, kp, vp, kc, vc, items, table, pos))
    q = q.reshape(3, 2, G, D).to(dtype)
    kp, vp, kc, vc = (t.to(dtype) for t in (kp, vp, kc, vc))
    before = flash_decode_kernel.launches
    got = flash_decode_kernel(q, kc, vc, items, pos, block_kv=BLK,
                              window=window)
    assert flash_decode_kernel.launches == before + 1
    want = packed_decode_attention(q, kc, vc, items, pos, block_kv=BLK,
                                   window=window)
    for g, w in zip(got, want):     # f32 sums in another order
        torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-5)
    paged = flash_decode_paged_kernel(q, kp, vp, items, table, pos,
                                      block_kv=BLK, window=window)
    for a, b in zip(got, paged):
        assert torch.equal(a, b), "one body: both layouts, the same bits"


@pytest.mark.parametrize("form", ["packed", "ids"])
def test_cuda_decode_layouts_give_the_same_bits(cuda, form):
    """The paged and contiguous kernels run one body: on equal cache
    contents they agree bit for bit, from packed items and from ids."""
    q, kp, vp, sel, table, pos = decode_case(
        9, D=64, layout="packed" if form == "packed" else "ids")
    kc, vc = as_slot_cache(kp, table), as_slot_cache(vp, table)
    q, kp, vp, kc, vc, sel, table, pos = (t.to(cuda) for t in as_torch(
        q, kp, vp, kc, vc, sel, table, pos))
    bf = torch.bfloat16
    q, kp, vp, kc, vc = (t.to(bf) for t in (q, kp, vp, kc, vc))
    if form == "packed":
        paged = ops.flash_decode_packed_paged(q, kp, vp, sel, table, pos,
                                              block_kv=BLK, partials=True)
        contig = ops.flash_decode_packed(q, kc, vc, sel, pos, block_kv=BLK,
                                         partials=True)
    else:
        paged = ops.flash_decode_paged(q, kp, vp, sel, table, pos,
                                       block_kv=BLK, partials=True)
        contig = ops.flash_decode(q, kc, vc, sel, pos, block_kv=BLK,
                                  partials=True)
    for a, b in zip(paged, contig):
        assert torch.equal(a, b)


@pytest.mark.parametrize("G", [2, 8])
@pytest.mark.parametrize("D", [32, 64, 128, 256])
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 2.0 ** -6)])
def test_cuda_contiguous_prefill_kernel_matches_plain(cuda, dtype, atol, D,
                                                      G):
    q, kp, vp, items, table = prefill_case(10, H=2 * G, D=D)
    kc = as_slot_cache(kp, table[None])[0]
    vc = as_slot_cache(vp, table[None])[0]
    args = [t.to(cuda) for t in as_torch(q, kc, vc, items)]
    args[:3] = [t.to(dtype) for t in args[:3]]
    kw = dict(q_offset=256, kv_len=600)
    before = sparse_prefill_attention.launches
    got = sparse_prefill_attention(*args, **kw)
    assert sparse_prefill_attention.launches == before + 1
    want = worklist_attention(*args, **kw)
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)
    table_t = torch.from_numpy(table).to(cuda)
    paged = sparse_prefill_paged(
        args[0], *(torch.from_numpy(t).to(cuda, dtype) for t in (kp, vp)),
        args[3], table_t, **kw)
    assert torch.equal(got, paged), "one body: both layouts, the same bits"


@pytest.mark.parametrize("G", [3, 8])
@pytest.mark.parametrize("D", [32, 64, 128, 256])
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 2.0 ** -6)])
@pytest.mark.parametrize("causal,sq,skv", [
    (True, 384, 384), (False, 384, 384), (True, 200, 330),
    (False, 330, 200)])
def test_cuda_flash_attention_matches_plain(cuda, dtype, atol, causal, sq,
                                            skv, D, G):
    rng = np.random.default_rng(11)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to(cuda, dtype) for s in ((2 * G, sq, D), (2, skv, D),
                                          (2, skv, D)))
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal)
    assert flash_attention.launches == before + 1
    want = flash_attention_reference(q, k, v, causal=causal)
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)


@pytest.mark.parametrize("G", [3, 8])
@pytest.mark.parametrize("D", [32, 64, 128, 256])
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 2.0 ** -6)])
def test_cuda_sparse_decode_matches_plain(cuda, dtype, atol, D, G):
    rng = np.random.default_rng(12)
    B, Hkv, S, cache_len = 3, 2, 4 * BLK, 3 * BLK + 17
    q, kc, vc = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                 .to(cuda, dtype) for s in ((B, Hkv, G, D), (B, Hkv, S, D),
                                            (B, Hkv, S, D)))
    sels = [[np.sort(rng.choice(4, size=1 + (b + h) % 4, replace=False))
             for h in range(Hkv)] for b in range(B)]
    sels[1][0] = np.array([], np.int64)              # an uncovered pair
    items = torch.from_numpy(build_decode_worklist(
        sels, num_devices=1, kv_heads_per_device=Hkv, block=BLK).items[0])
    items = items.to(cuda)
    before = sparse_decode_attention.launches
    got = sparse_decode_attention(q, kc, vc, items, cache_len=cache_len)
    assert sparse_decode_attention.launches == before + 1
    want = sparse_decode_reference(q, kc, vc, items, cache_len=cache_len)
    assert got.dtype == dtype and not got[1, 0].any()
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)


@pytest.mark.parametrize("D", [64, 256])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("layout", ["paged", "contiguous"])
def test_cuda_window_decode_outside_tiles(cuda, dtype, layout, D):
    """A sliding window (Gemma3's local layers) at a position past it: a
    run that starts on tiles wholly outside the window (the strided
    policy's sink block 0, then block 1) and a run with no kept key at all.
    No NaN; the empty run keeps m = -1e30, l = 0, out 0; both layouts give
    the plain version's values and each other's bits."""
    rng = np.random.default_rng(22)
    B, Hkv, G, T, window = 2, 1, 4, 8, 200
    N = B * T + 1
    q = rng.standard_normal((B, Hkv, G, D)).astype(np.float32)
    kp, vp = (rng.standard_normal((N, Hkv, BLK, D)).astype(np.float32)
              for _ in range(2))
    table = rng.permutation(N - 1)[:B * T].reshape(B, T).astype(np.int32)
    pos = np.array([7 * BLK + 50, 6 * BLK + 3], np.int32)
    # (row, kv head, logical block, first, last, valid)
    items = np.array([
        [0, 0, 0, 1, 0, 1],     # the sink: wholly outside the window
        [0, 0, 1, 0, 0, 1],     # outside
        [0, 0, 5, 0, 0, 1],     # straddles pos - window
        [0, 0, 7, 0, 1, 1],     # the newest block
        [1, 0, 0, 1, 0, 1],     # outside only: nothing kept
        [1, 0, 2, 0, 1, 1],
    ], np.int32)
    kc, vc = as_slot_cache(kp, table), as_slot_cache(vp, table)
    q, kp, vp, kc, vc, items, table, pos = (t.to(cuda) for t in as_torch(
        q, kp, vp, kc, vc, items, table, pos))
    q, kp, vp, kc, vc = (t.to(dtype) for t in (q, kp, vp, kc, vc))
    kw = dict(block_kv=BLK, window=window)
    if layout == "paged":
        got = flash_decode_paged_kernel(q, kp, vp, items, table, pos, **kw)
        want = packed_decode_attention_paged(q, kp, vp, items, table, pos,
                                             **kw)
    else:
        got = flash_decode_kernel(q, kc, vc, items, pos, **kw)
        want = packed_decode_attention(q, kc, vc, items, pos, **kw)
    out, m, l = got
    assert all(bool(t.isfinite().all()) for t in got)
    assert bool((m[1] == -1e30).all()) and not l[1].any() and not out[1].any()
    assert bool((l[0] > 0).all())
    for g, w in zip(got, want):     # f32 sums in another order
        torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-5)
    other = (flash_decode_kernel(q, kc, vc, items, pos, **kw)
             if layout == "paged"
             else flash_decode_paged_kernel(q, kp, vp, items, table, pos,
                                            **kw))
    for a, b in zip(got, other):
        assert torch.equal(a, b), "one body: both layouts, the same bits"


# -- the split decode: runs cut across CTAs, partials merged in item order ----

def long_run_case(seed, G, D, layout):
    """Two rows of 24 logical blocks, 2 kv heads, selections of 1, 24, 13
    and 7 blocks (runs of up to 24 tiles, so the kernels split and merge),
    a window-free pool, and the item table: cost-packed on two shards with
    bucket pads (first = last = valid = 0), or the padded table from
    ids."""
    rng = np.random.default_rng(seed)
    B, Hkv, T = 2, 2, 24
    N = B * T + 1
    q = rng.standard_normal((B, Hkv, G, D)).astype(np.float32)
    kp, vp = (rng.standard_normal((N, Hkv, BLK, D)).astype(np.float32)
              for _ in range(2))
    pos = np.array([T * BLK - 1, 20 * BLK + 5], np.int32)
    table = rng.permutation(N - 1)[:B * T].reshape(B, T).astype(np.int32)
    ids = np.full((B, Hkv, T), -1, np.int32)
    for (b, h), n in zip(((0, 0), (0, 1), (1, 0), (1, 1)), (1, 24, 13, 7)):
        nb = int(pos[b]) // BLK + 1
        ids[b, h, :n] = np.sort(rng.choice(nb, size=n, replace=False))
    if layout == "padded":
        items = wl.padded_decode_items(ids)
    else:
        packed = wl.pack_decode_items(ids, num_shards=2, block=BLK)
        items = wl.extend_packed_items(
            packed.items, packed.padded_length + 9).reshape(-1, wl.DEC_FIELDS)
    return q, kp, vp, items, table, pos


@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("G", [3, 8])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("layout,window", [("packed", None),
                                           ("packed", 600), ("padded", None)])
def test_cuda_split_decode_long_runs(cuda, dtype, layout, window, G, D):
    """Runs of up to 24 tiles, a packed bucket with pad rows or the padded
    table: both kernels against the split plain version, and each other's
    bits."""
    q, kp, vp, items, table, pos = long_run_case(23, G, D, layout)
    kc, vc = as_slot_cache(kp, table), as_slot_cache(vp, table)
    q, kp, vp, kc, vc, items, table, pos = (t.to(cuda) for t in as_torch(
        q, kp, vp, kc, vc, items, table, pos))
    q, kp, vp, kc, vc = (t.to(dtype) for t in (q, kp, vp, kc, vc))
    kw = dict(block_kv=BLK, window=window)
    got = flash_decode_paged_kernel(q, kp, vp, items, table, pos, **kw)
    want = packed_decode_attention_paged(q, kp, vp, items, table, pos, **kw)
    for g, w in zip(got, want):     # f32 sums in another order
        torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-5)
    contig = flash_decode_kernel(q, kc, vc, items, pos, **kw)
    for a, b in zip(got, contig):
        assert torch.equal(a, b), "one body: both layouts, the same bits"


@pytest.mark.parametrize("layout", ["paged", "contiguous"])
@pytest.mark.parametrize("D", [64, 256])
def test_cuda_split_decode_repeats_and_replays(cuda, layout, D):
    """The same launch twice, and a CUDA graph of two launches replayed
    twice, give the same bits: the merge order does not depend on which
    CTA finishes last, and every run's counter is back at zero after each
    launch."""
    from repro_torch.kernels import flash_decode as fd
    q, kp, vp, items, table, pos = long_run_case(24, 4, D, "packed")
    kc, vc = as_slot_cache(kp, table), as_slot_cache(vp, table)
    q, kp, vp, kc, vc, items, table, pos = (t.to(cuda) for t in as_torch(
        q, kp, vp, kc, vc, items, table, pos))
    q, kp, vp, kc, vc = (t.to(torch.bfloat16) for t in (q, kp, vp, kc, vc))
    if layout == "paged":
        run = lambda: flash_decode_paged_kernel(  # noqa: E731
            q, kp, vp, items, table, pos, block_kv=BLK)
    else:
        run = lambda: flash_decode_kernel(  # noqa: E731
            q, kc, vc, items, pos, block_kv=BLK)
    first, second = run(), run()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = [run(), run()]
    replays = []
    for _ in range(2):
        graph.replay()
        replays += [tuple(t.clone() for t in r) for r in captured]
    torch.cuda.synchronize()
    for other in (second, *replays):
        for a, b in zip(first, other):
            assert torch.equal(a, b)
    for tickets in fd._TICKETS.values():   # eager and capture streams
        assert not tickets.any(), "counters left at zero"


def test_cuda_split_decode_two_streams(cuda):
    """Launches on two streams at once take separate run counters: each
    stream's results equal a launch alone, bit for bit."""
    q, kp, vp, items, table, pos = long_run_case(25, 4, 128, "packed")
    q, kp, vp, items, table, pos = (t.to(cuda) for t in as_torch(
        q, kp, vp, items, table, pos))
    q, kp, vp = (t.to(torch.bfloat16) for t in (q, kp, vp))
    run = lambda: flash_decode_paged_kernel(  # noqa: E731
        q, kp, vp, items, table, pos, block_kv=BLK)
    alone = run()
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream() for _ in range(2)]
    got = []
    for _ in range(4):
        for s in streams:
            s.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(s):
                got.append(run())
    torch.cuda.synchronize()
    for other in got:
        for a, b in zip(alone, other):
            assert torch.equal(a, b)


# -- the staged walk of #1 / #3: copy spans, the ring, code forms ------------

def span_case(seed, G, D, blk=BLK, B=3, Hkv=2, T=6):
    """q, pools and a table, positions inside a tile (neither its first nor
    its last key), a window whose start falls inside a tile, and per-slot
    ids ``[B, Hkv, T]`` that select the sink, the tile holding the window
    start and the newest tile (so copy spans are cut by pos and by the
    window) with -1 holes between them; returns numpy arrays and the
    window."""
    rng = np.random.default_rng(seed)
    N = B * T + 1
    q = rng.standard_normal((B, Hkv, G, D)).astype(np.float32)
    kp, vp = (rng.standard_normal((N, Hkv, blk, D)).astype(np.float32)
              for _ in range(2))
    pos = (rng.integers(3, T, size=B) * blk
           + rng.integers(1, blk - 1, size=B)).astype(np.int32)
    window = 2 * blk - blk // 3
    table = np.full((B, T), -1, np.int32)
    perm = rng.permutation(N - 1)
    ids = np.full((B, Hkv, T), -1, np.int32)
    for b in range(B):
        if (pos[b] - window + 1) % blk == 0:     # the start inside a tile
            pos[b] += 1
        nb = int(pos[b]) // blk + 1
        table[b, :nb] = perm[b * T:b * T + nb]
        start = (int(pos[b]) - window + 1) // blk
        for h in range(Hkv):
            sel = sorted({0, start, nb - 1} | set(
                rng.choice(nb, size=int(rng.integers(0, nb)),
                           replace=False).tolist()))
            row, holes = [], T - len(sel)
            for j in sel:               # in order, holes between
                row.append(j)
                if holes > 0 and j != sel[-1]:
                    row.append(-1)
                    holes -= 1
            ids[b, h, :len(row)] = row
    return q, kp, vp, ids, table, pos, window


def span_tables(ids, blk):
    """The packed table of ``ids`` with its holes dropped (bucket pads
    after) and the padded table of ``ids`` holes and all: one run a (row,
    kv head) in both, its valid items in the same order."""
    from repro_torch.kernels.flash_decode import decode_items_from_ids
    kept = np.full_like(ids, -1)
    for b, h in np.ndindex(ids.shape[:2]):
        sel = ids[b, h][ids[b, h] >= 0]
        kept[b, h, :len(sel)] = sel
    packed = wl.pack_decode_items(kept, num_shards=2, block=blk)
    items = wl.extend_packed_items(
        packed.items, packed.padded_length + 7).reshape(-1, wl.DEC_FIELDS)
    return items, decode_items_from_ids(torch.from_numpy(ids)).numpy()


def span_tensors(cuda, kind, q, kp, vp, table, seed):
    """q and the pool in ``kind`` (bf16 / f32, or int8 / fp8 codes with
    per-(block, kv head) scales), the slot caches (and their scales) of the
    same contents; returns (q, paged K/V, paged scale kwargs, slot K/V,
    slot scale kwargs)."""
    B, T = table.shape
    if kind in ("int8", "fp8"):
        rng = np.random.default_rng(300 + seed)
        q = rng.uniform(-1.0, 1.0, size=q.shape).astype(np.float32)
        ks, vs = (code_scales(rng, kp.shape[:2], kind) for _ in range(2))
        codes = [quant_codes(p, kind) for p in (kp, vp)]
        pk, pv = (code_tensor(c, kind).to(cuda) for c in codes)
        sk, sv = (code_tensor(as_slot_cache(c.view(np.uint8), table), kind)
                  .to(cuda) for c in codes)
        slot = [np.stack([np.where(table[b][None, :] >= 0,
                                   s[np.maximum(table[b], 0)].T, 1.0)
                          for b in range(B)]).astype(np.float32)
                for s in (ks, vs)]
        pool_kw = dict(zip(("k_scales", "v_scales"),
                           (t.to(cuda) for t in as_torch(ks, vs))))
        slot_kw = dict(zip(("k_scales", "v_scales"),
                           (t.to(cuda) for t in as_torch(*slot))))
        return (torch.from_numpy(q).to(cuda), pk, pv, pool_kw, sk, sv,
                slot_kw)
    dtype = torch.bfloat16 if kind == "bf16" else torch.float32
    kc, vc = as_slot_cache(kp, table), as_slot_cache(vp, table)
    q, kp, vp, kc, vc = (t.to(cuda, dtype) for t in as_torch(q, kp, vp, kc,
                                                             vc))
    return q, kp, vp, {}, kc, vc, {}


def check_spans(cuda, kind, G, D, blk, window, seed):
    """#1 and #3 on a :func:`span_case`: the packed table and the padded
    table from ids with -1 holes, each within 1e-4 of its plain version;
    packed == padded and paged == contiguous bit for bit."""
    q, kp, vp, ids, table, pos, win = span_case(seed, G, D, blk)
    items, padded = span_tables(ids, blk)
    q, kp, vp, pool_kw, kc, vc, slot_kw = span_tensors(cuda, kind, q, kp, vp,
                                                       table, seed)
    items, padded, table, pos = (t.to(cuda) for t in as_torch(
        items, padded, table, pos))
    kw = dict(block_kv=blk, window=win if window else None)
    got = {}
    for tag, it in (("packed", items), ("padded", padded)):
        got[tag] = flash_decode_paged_kernel(q, kp, vp, it, table, pos,
                                             **pool_kw, **kw)
        want = packed_decode_attention_paged(q, kp, vp, it, table, pos,
                                             **pool_kw, **kw)
        for g, w in zip(got[tag], want):     # f32 sums in another order
            torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-5)
        contig = flash_decode_kernel(q, kc, vc, it, pos, **slot_kw, **kw)
        want = packed_decode_attention(q, kc, vc, it, pos, **slot_kw, **kw)
        for g, w in zip(contig, want):
            torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-5)
        for a, b in zip(got[tag], contig):
            assert torch.equal(a, b), "one body: both layouts, the same bits"
    assert bool((got["packed"][2] > 0).all()), "every pair keeps a key"
    for a, b in zip(got["packed"], got["padded"]):
        assert torch.equal(a, b), "packed == padded, bit for bit"


@pytest.mark.parametrize("G", [4, 5, 8])
@pytest.mark.parametrize("D", [32, 64, 128, 256])
@pytest.mark.parametrize("kind", ["bf16", "f32", "int8", "fp8"])
@pytest.mark.parametrize("window", [False, True])
def test_cuda_decode_copy_spans(cuda, kind, window, D, G):
    """Copy spans cut by pos inside the newest tile and, with a window, by
    the window's start inside a tile (tiles wholly before it copy nothing);
    every element type at every head_dim, G 4 (Gemma3-1B, Minitron-8B), 5
    (Llama4-Scout) and 8 (Yi-6B)."""
    check_spans(cuda, kind, G, D, BLK, window, 70 + D + G)


@pytest.mark.parametrize("kind,D,blk", [("f32", 256, BLK), ("f32", 128, 256),
                                        ("bf16", 256, 256),
                                        ("bf16", 128, 512)])
@pytest.mark.parametrize("G", [5, 8])
@pytest.mark.parametrize("window", [False, True])
def test_cuda_decode_ring_forms(cuda, kind, D, blk, G, window):
    """K and V tiles that do not fit the CTA's shared memory together (f32
    at D 256, or a block_kv of 256 / 512) go through the two-slot ring of
    64-key sub-tiles, spans cut by pos and the window included."""
    check_spans(cuda, kind, G, D, blk, window, 90 + D + blk)


# -- the legacy decode (#5): runs split across CTAs, K/V tiles staged --------

def legacy_case(seed, G, D, blk=BLK, flags=False):
    """q, slot caches of 26 blocks and the legacy item table of two rows
    over 3 kv heads selecting 1, 24, none, 13, 7 and 5 blocks (runs of up
    to 24 tiles, one uncovered pair), the last run ending on the partly
    masked block 24 and the wholly masked block 25 of ``cache_len``; with
    ``flags`` an invalid plain, ``first`` and ``last`` item inside the
    24-tile run.  Returns numpy arrays and ``cache_len``."""
    rng = np.random.default_rng(seed)
    B, Hkv, nblk = 2, 3, 26
    cache_len = 24 * blk + blk // 2 + 1
    q = rng.standard_normal((B, Hkv, G, D)).astype(np.float32)
    kc, vc = (rng.standard_normal((B, Hkv, nblk * blk, D)).astype(np.float32)
              for _ in range(2))
    sels = [[np.sort(rng.choice(24, size=n, replace=False)) for n in row]
            for row in ((1, 24, 0), (13, 7, 5))]
    sels[1][2] = np.array([0, 3, 9, 24, 25])
    items = build_decode_worklist(sels, num_devices=1, kv_heads_per_device=Hkv,
                                  block=blk).items[0]
    if flags:
        for off, field in ((3, None), (9, wl.D_FIRST), (15, wl.D_LAST)):
            items[1 + off, wl.D_VALID] = 0
            if field is not None:
                items[1 + off, field] = 1
    return q, kc, vc, items, cache_len


def legacy_tensors(cuda, dtype, q, kc, vc, items):
    q, kc, vc, items = (t.to(cuda) for t in as_torch(q, kc, vc, items))
    return q.to(dtype), kc.to(dtype), vc.to(dtype), items


@pytest.mark.parametrize("flags", [False, True])
@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("G", [3, 8])
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 2.0 ** -6)])
def test_cuda_sparse_decode_long_runs(cuda, dtype, atol, G, D, flags):
    """Runs of up to 24 tiles split across CTAs (f32 at D 256 through the
    64-key sub-tile ring), an uncovered pair, a partly and a wholly masked
    tile, the table's pads and invalid flags inside a run: against the
    plain version, one launch counted."""
    q, kc, vc, items, cache_len = legacy_case(31 + D, G, D, flags=flags)
    q, kc, vc, items = legacy_tensors(cuda, dtype, q, kc, vc, items)
    before = sparse_decode_attention.launches
    got = sparse_decode_attention(q, kc, vc, items, cache_len=cache_len)
    assert sparse_decode_attention.launches == before + 1
    want = sparse_decode_reference(q, kc, vc, items, cache_len=cache_len)
    assert got.dtype == dtype and not got[0, 2].any()
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)


@pytest.mark.parametrize("blk", [16, 64, 256])
@pytest.mark.parametrize("D", [128, 256])
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 2.0 ** -6)])
def test_cuda_sparse_decode_block_kv(cuda, dtype, atol, D, blk):
    """block_kv other than 128: whole tiles staged (16, 64; bf16 D 128 at
    256), or through the sub-tile ring where K and V do not fit (256 at
    D 256, and f32 at D 128)."""
    q, kc, vc, items, cache_len = legacy_case(41 + blk, 8, D, blk=blk)
    q, kc, vc, items = legacy_tensors(cuda, dtype, q, kc, vc, items)
    got = sparse_decode_attention(q, kc, vc, items, cache_len=cache_len,
                                  block_kv=blk)
    want = sparse_decode_reference(q, kc, vc, items, cache_len=cache_len,
                                   block_kv=blk)
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)


@pytest.mark.parametrize("n", [32, 33, 40])
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 2.0 ** -6)])
def test_cuda_sparse_decode_runs_past_a_merge_chunk(cuda, dtype, atol, n):
    """A run of 32, 33 and 40 tiles (16-key blocks): the merge stages at
    most 32 splits' (m, l) at a time, so the longer runs take both its
    passes in chunks."""
    rng = np.random.default_rng(60 + n)
    B, Hkv, G, D, blk, nblk = 2, 1, 4, 64, 16, 48
    q = rng.standard_normal((B, Hkv, G, D)).astype(np.float32)
    kc, vc = (rng.standard_normal((B, Hkv, nblk * blk, D)).astype(np.float32)
              for _ in range(2))
    sels = [[np.sort(rng.choice(nblk, size=n, replace=False))],
            [np.arange(3)]]
    items = build_decode_worklist(sels, num_devices=1, kv_heads_per_device=1,
                                  block=blk).items[0]
    q, kc, vc, items = legacy_tensors(cuda, dtype, q, kc, vc, items)
    cache_len = nblk * blk - 5
    got = sparse_decode_attention(q, kc, vc, items, cache_len=cache_len,
                                  block_kv=blk)
    want = sparse_decode_reference(q, kc, vc, items, cache_len=cache_len,
                                   block_kv=blk)
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)


@pytest.mark.parametrize("D", [64, 256])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_sparse_decode_repeats_and_replays(cuda, dtype, D):
    """The same launch twice, and a CUDA graph of two launches replayed
    twice, give the same bits, and every run's counter is back at zero
    after each launch."""
    from repro_torch.kernels import flash_decode as fd
    q, kc, vc, items, cache_len = legacy_case(51, 4, D)
    q, kc, vc, items = legacy_tensors(cuda, dtype, q, kc, vc, items)
    run = lambda: sparse_decode_attention(  # noqa: E731
        q, kc, vc, items, cache_len=cache_len)
    first, second = run(), run()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = [run(), run()]
    replays = []
    for _ in range(2):
        graph.replay()
        replays += [r.clone() for r in captured]
    torch.cuda.synchronize()
    for other in (second, *replays):
        assert torch.equal(first, other)
    for tickets in fd._TICKETS.values():   # eager and capture streams
        assert not tickets.any(), "counters left at zero"


def test_cuda_sparse_decode_two_streams(cuda):
    """Launches on two streams at once take separate run counters: each
    stream's results equal a launch alone, bit for bit."""
    q, kc, vc, items, cache_len = legacy_case(52, 8, 128)
    q, kc, vc, items = legacy_tensors(cuda, torch.bfloat16, q, kc, vc, items)
    run = lambda: sparse_decode_attention(  # noqa: E731
        q, kc, vc, items, cache_len=cache_len)
    alone = run()
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream() for _ in range(2)]
    got = []
    for _ in range(4):
        for s in streams:
            s.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(s):
                got.append(run())
    torch.cuda.synchronize()
    for other in got:
        assert torch.equal(alone, other)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_sparse_decode_unaligned_caches(cuda, dtype):
    """Caches that are contiguous but not 16-byte aligned (a view one
    element into a buffer) cannot be bulk-copied: the kernel stages them by
    its threads and gives the aligned launch's bits."""
    q, kc, vc, items, cache_len = legacy_case(53, 3, 64)
    q, kc, vc, items = legacy_tensors(cuda, dtype, q, kc, vc, items)
    shifted = []
    for c in (kc, vc):
        buf = torch.empty(c.numel() + 1, dtype=dtype, device=cuda)
        view = buf[1:].view(c.shape)
        view.copy_(c)
        assert view.is_contiguous() and view.data_ptr() % 16
        shifted.append(view)
    want = sparse_decode_attention(q, kc, vc, items, cache_len=cache_len)
    got = sparse_decode_attention(q, *shifted, items, cache_len=cache_len)
    assert torch.equal(got, want)


# -- the bf16 tensor-core prefill / flash body --------------------------------

BF16_ATOL = 2.0 ** -6   # bf16 output: one bf16 ulp at |x| < 4


def _tc_prefill(cuda, q, kp, vp, items, table, *, q_offset, kv_len, blk=BLK,
                layouts=True):
    """Run the bf16 paged kernel and hold it within the bf16 tolerance of
    its plain version; with ``layouts`` check that the contiguous kernel
    over K/V cut at ``kv_len`` (a ragged last tile of fewer than ``blk``
    rows) gives the same bits (not with -1 entries below kv_len, which the
    contiguous layout has no way to express)."""
    kc = as_slot_cache(kp, table[None])[0][:, :kv_len]
    vc = as_slot_cache(vp, table[None])[0][:, :kv_len]
    q, kp, vp, kc, vc = (t.to(cuda, torch.bfloat16) for t in as_torch(
        q, kp, vp, kc, vc))
    items_t, table_t = (t.to(cuda) for t in as_torch(items, table))
    kw = dict(block_q=blk, block_kv=blk, q_offset=q_offset, kv_len=kv_len)
    got = sparse_prefill_paged(q, kp, vp, items_t, table_t, **kw)
    if layouts:
        contig = sparse_prefill_attention(q, kc, vc, items_t, **kw)
        assert torch.equal(got, contig), "one body: both layouts, same bits"
    want = worklist_attention_paged(q, kp, vp, items_t, table_t, **kw)
    torch.testing.assert_close(got.float(), want.float(), atol=BF16_ATOL,
                               rtol=0)
    return got


@pytest.mark.parametrize("G", [2, 8])
@pytest.mark.parametrize("D", [32, 64, 128, 256])
@pytest.mark.parametrize("q_offset", [0, 2048])
@pytest.mark.parametrize("hole", [False, True])
def test_cuda_tc_prefill_matches_plain(cuda, D, q_offset, hole, G):
    """An uncovered run, replicate-last padding rows, kv_len inside the
    chunk, a contiguous last tile of fewer than block_kv rows, and -1
    table entries."""
    chunk = 256
    q, kp, vp, items, table = prefill_case(
        13, H=2 * G, D=D, prompt=q_offset + chunk, q_offset=q_offset, chunk=chunk,
        hole=hole)
    got = _tc_prefill(cuda, q, kp, vp, items, table, q_offset=q_offset,
                      kv_len=q_offset + chunk - 40, layouts=not hole)
    assert not got[1, :BLK].any(), "an uncovered run's rows stay zero"


@pytest.mark.parametrize("D", [32, 64, 128, 256])
def test_cuda_tc_prefill_fully_masked_tiles(cuda, D):
    """A run whose first tile lies wholly above the causal diagonal, and a
    run with no kept key at all (its rows are written as zeros)."""
    rng = np.random.default_rng(14)
    H, Hkv, T = 2, 1, 4
    q = rng.standard_normal((H, 2 * BLK, D)).astype(np.float32)
    kp, vp = (rng.standard_normal((T + 1, Hkv, BLK, D)).astype(np.float32)
              for _ in range(2))
    table = rng.permutation(T).astype(np.int32)
    # (head, q_blk, kv_blk, first, last, valid, kv_head)
    items = np.array([
        [0, 0, 3, 1, 0, 1, 0],     # wholly in the future of q block 0
        [0, 0, 0, 0, 1, 1, 0],     # the diagonal
        [0, 1, 2, 1, 0, 1, 0],     # future
        [0, 1, 1, 0, 1, 1, 0],     # diagonal
        [1, 0, 2, 1, 0, 1, 0],     # future only: no key kept
        [1, 0, 3, 0, 1, 1, 0],
        [1, 1, 0, 1, 1, 1, 0],     # the sink only
    ], np.int32)
    got = _tc_prefill(cuda, q, kp, vp, items, table, q_offset=0,
                      kv_len=2 * BLK)
    assert not got[1, :BLK].any(), "rows with no kept key are zeros"
    assert got[0].abs().sum() > 0


@pytest.mark.parametrize("D", [32, 64, 128, 256])
def test_cuda_tc_prefill_odd_blocks(cuda, D):
    """block_q = block_kv = 80: q blocks that are not whole 64-row CTA
    slices and tiles that end inside a 64-key step."""
    blk, prompt, H, Hkv = 80, 400, 4, 2
    rng = np.random.default_rng(15)
    nq = -(-prompt // blk)
    q = rng.standard_normal((H, prompt, D)).astype(np.float32)
    kp, vp = (rng.standard_normal((nq + 1, Hkv, blk, D)).astype(np.float32)
              for _ in range(2))
    table = rng.permutation(nq).astype(np.int32)
    sels = [strided_policy(h, 2, nq, nq) for h in range(H)]
    items = wl.build_worklist(sels, np.zeros(H, np.int64), 1, nq, nq, blk,
                              kv_head_of_head=np.arange(H) // 2).items[0]
    _tc_prefill(cuda, q, kp, vp, items, table, q_offset=0, kv_len=prompt,
                blk=blk)


@pytest.mark.parametrize("D", [32, 64, 128, 256])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,skv,bq,bkv", [
    (1000, 3001, 128, 128), (333, 517, 96, 80)])
def test_cuda_tc_flash_attention_ragged(cuda, D, causal, sq, skv, bq, bkv):
    rng = np.random.default_rng(16)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to(cuda, torch.bfloat16)
               for s in ((6, sq, D), (2, skv, D), (2, skv, D)))
    kw = dict(causal=causal, block_q=bq, block_kv=bkv)
    got = flash_attention(q, k, v, **kw)
    want = flash_attention_reference(q, k, v, **kw)
    torch.testing.assert_close(got.float(), want.float(), atol=BF16_ATOL,
                               rtol=0)


# -- the codes-and-scales forms (int8 / fp8 pools with per-block scales) ----

def _quant_decode(cuda, seed, kind, D, G=3, **kw):
    """A decode case over a code pool on the card: q in (-1, 1), codes and
    one scale per (block, kv head)."""
    q, kp, vp, items, table, pos = decode_case(seed, G=G, D=D, **kw)
    rng = np.random.default_rng(300 + seed)
    q = rng.uniform(-1.0, 1.0, size=q.shape).astype(np.float32)
    ks, vs = (code_scales(rng, kp.shape[:2], kind) for _ in range(2))
    kc, vc = (code_tensor(quant_codes(p, kind), kind).to(cuda)
              for p in (kp, vp))
    q, ks, vs, items, table, pos = (t.to(cuda) for t in as_torch(
        q, ks, vs, items, table, pos))
    return q.reshape(3, 2, G, D), kc, vc, ks, vs, items, table, pos


@pytest.mark.parametrize("G", [3, 8])
@pytest.mark.parametrize("D", [32, 64, 128, 256])
@pytest.mark.parametrize("kind", ["int8", "fp8"])
@pytest.mark.parametrize("holes,window,layout", [
    (False, None, "packed"), (True, 200, "packed"), (True, None, "padded")])
def test_cuda_quant_decode_kernel_matches_plain(cuda, kind, holes, window,
                                                layout, D, G):
    """#1 over a code pool: scales at the physical block, -1 entries."""
    q, kc, vc, ks, vs, items, table, pos = _quant_decode(
        cuda, 17, kind, D, G, holes=holes, layout=layout)
    kw = dict(block_kv=BLK, window=window, k_scales=ks, v_scales=vs)
    before = flash_decode_paged_kernel.launches_by_dtype.get(
        str(kc.dtype)[6:], 0)
    got = flash_decode_paged_kernel(q, kc, vc, items, table, pos, **kw)
    assert flash_decode_paged_kernel.launches_by_dtype[
        str(kc.dtype)[6:]] == before + 1
    want = packed_decode_attention_paged(q, kc, vc, items, table, pos, **kw)
    for g, w in zip(got, want):     # f32 sums in another order
        torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("G", [3, 8])
@pytest.mark.parametrize("D", [32, 64, 128, 256])
@pytest.mark.parametrize("kind", ["int8", "fp8"])
@pytest.mark.parametrize("window,layout", [(None, "packed"),
                                           (200, "padded")])
def test_cuda_quant_contiguous_decode_matches_plain(cuda, kind, window,
                                                    layout, D, G):
    """#3 over a code slot cache: scales per (row, kv head, block), and
    the same bits as #1 on equal contents."""
    q, kc, vc, ks, vs, items, table, pos = _quant_decode(
        cuda, 18, kind, D, G, layout=layout)
    tb = table.cpu().numpy()
    slot = lambda p: code_tensor(as_slot_cache(  # noqa: E731
        p.view(torch.uint8).cpu().numpy(), tb), kind).to(cuda)
    B, T = tb.shape
    idx = table.clamp_min(0).long()
    mapped = (table >= 0)[:, None, :]
    sk, sv = (torch.where(mapped, s[idx].permute(0, 2, 1), 1.0).contiguous()
              for s in (ks, vs))                       # [B, Hkv, T]
    kw = dict(block_kv=BLK, window=window)
    got = flash_decode_kernel(q, slot(kc), slot(vc), items, pos,
                              k_scales=sk, v_scales=sv, **kw)
    want = packed_decode_attention(q, slot(kc), slot(vc), items, pos,
                                   k_scales=sk, v_scales=sv, **kw)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-5)
    paged = flash_decode_paged_kernel(q, kc, vc, items, table, pos,
                                      k_scales=ks, v_scales=vs, **kw)
    for a, b in zip(got, paged):
        assert torch.equal(a, b), "one body: both layouts, the same bits"


@pytest.mark.parametrize("G", [2, 8])
@pytest.mark.parametrize("D", [32, 64, 128, 256])
@pytest.mark.parametrize("kind", ["int8", "fp8"])
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 2.0 ** -6)])
@pytest.mark.parametrize("q_offset,hole", [(0, False), (2048, True)])
def test_cuda_quant_prefill_matches_plain(cuda, kind, dtype, atol, q_offset,
                                          hole, D, G):
    """#2 paged over a code pool: the tensor-core body (bf16 q) and the
    scalar one (f32 q), an uncovered run, -1 table entries, kv_len inside
    the chunk."""
    chunk = 256
    q, kp, vp, items, table = prefill_case(
        19, H=2 * G, D=D, prompt=q_offset + chunk, q_offset=q_offset, chunk=chunk,
        hole=hole)
    rng = np.random.default_rng(19)
    ks, vs = (code_scales(rng, kp.shape[:2], kind) for _ in range(2))
    kc, vc = (code_tensor(quant_codes(p, kind), kind).to(cuda)
              for p in (kp, vp))
    q, ks, vs, items, table = (t.to(cuda) for t in as_torch(
        q, ks, vs, items, table))
    kw = dict(q_offset=q_offset, kv_len=q_offset + chunk - 40, k_scales=ks,
              v_scales=vs)
    q = q.to(dtype)
    got = sparse_prefill_paged(q, kc, vc, items, table, **kw)
    want = worklist_attention_paged(q, kc, vc, items, table, **kw)
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)
    assert not got[1, :BLK].any(), "an uncovered run's rows stay zero"


@pytest.mark.parametrize("kind", ["int8", "fp8"])
def test_cuda_quant_prefill_odd_blocks(cuda, kind):
    """block_kv = 80 and 96: code tiles that end inside a 64-key step,
    every step of a tile under the tile's one scale."""
    for blk in (80, 96):
        prompt, H, Hkv, D = 400, 4, 2, 64
        rng = np.random.default_rng(20 + blk)
        nq = -(-prompt // blk)
        q = torch.from_numpy(rng.uniform(-1, 1, (H, prompt, D)).astype(
            np.float32)).to(cuda, torch.bfloat16)
        kc, vc = (code_tensor(quant_codes(rng.standard_normal(
            (nq + 1, Hkv, blk, D)).astype(np.float32), kind), kind).to(cuda)
            for _ in range(2))
        ks, vs = (torch.from_numpy(code_scales(rng, (nq + 1, Hkv),
                                               kind)).to(cuda)
                  for _ in range(2))
        table = torch.from_numpy(rng.permutation(nq).astype(np.int32)).to(
            cuda)
        sels = [strided_policy(h, 2, nq, nq) for h in range(H)]
        items = torch.from_numpy(wl.build_worklist(
            sels, np.zeros(H, np.int64), 1, nq, nq, blk,
            kv_head_of_head=np.arange(H) // 2).items[0]).to(cuda)
        kw = dict(block_q=blk, block_kv=blk, q_offset=0, kv_len=prompt,
                  k_scales=ks, v_scales=vs)
        got = sparse_prefill_paged(q, kc, vc, items, table, **kw)
        want = worklist_attention_paged(q, kc, vc, items, table, **kw)
        torch.testing.assert_close(got.float(), want.float(),
                                   atol=2.0 ** -6, rtol=0)


def test_cuda_quant_wrappers_refuse_without_a_kernel(cuda):
    """A code pool without scales, or scales with a bf16 pool, raises on
    the card instead of running another path."""
    q, kc, vc, ks, vs, items, table, pos = _quant_decode(cuda, 21, "int8",
                                                         64)
    with pytest.raises(ValueError, match="needs k_scales"):
        flash_decode_paged_kernel(q, kc, vc, items, table, pos,
                                  block_kv=BLK)
    with pytest.raises(ValueError, match="int8/fp8 codes"):
        flash_decode_paged_kernel(q, kc.float(), vc.float(), items, table,
                                  pos, block_kv=BLK, k_scales=ks,
                                  v_scales=vs)


@pytest.mark.parametrize("layout", ["paged", "contiguous"])
def test_cuda_quant_smoke_serve_matches_cpu(cuda, layout):
    """A SMOKE float32 serve at kv_dtype int8: the card's greedy tokens
    equal the plain versions' on the CPU, and the quantized kernels ran."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.core.sparsity import synthetic_head_curves
    from repro_torch.models.transformer import init_params
    from repro_torch.serving import Engine, EngineConfig, SamplingParams
    cfg = dataclasses.replace(get_config("smollm-135m", smoke=True),
                              dtype=torch.float32)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, size=n) for n in (300, 40)]
    decode = flash_decode_paged_kernel if layout == "paged" \
        else flash_decode_kernel
    before = decode.launches_by_dtype.get("int8", 0)
    outs = []
    for dev in (cuda, torch.device("cpu")):
        eng = Engine(cfg, init_params(cfg, seed=1, device=dev),
                     EngineConfig(max_seq_len=1024, num_slots=4,
                                  budget_per_head=256, kv_dtype="int8",
                                  cache_layout=layout),
                     synthetic_head_curves(cfg.num_layers, cfg.num_heads),
                     device=dev)
        outs.append([r.generated for r in eng.serve(
            prompts, SamplingParams(max_tokens=8))])
    assert outs[0] == outs[1]
    assert decode.launches_by_dtype.get("int8", 0) > before


# -- shapes no kernel is built for, and serves at Yi-6B's and Gemma3-1B's
# widths ---------------------------------------------------------------------


def test_cuda_wrappers_refuse_unbuilt_shapes(cuda):
    """head_dim 16, 96 and 512 and G > 8 raise on the card: no kernel is
    built for them and nothing else runs in their place."""
    for dh, g in ((16, 8), (96, 4), (512, 4), (128, 9)):
        q = torch.zeros((1, 1, g, dh), device=cuda, dtype=torch.bfloat16)
        kc = torch.zeros((1, 1, BLK, dh), device=cuda, dtype=torch.bfloat16)
        items = torch.zeros((1, 6), device=cuda, dtype=torch.int32)
        pos = torch.zeros((1,), device=cuda, dtype=torch.int32)
        with pytest.raises(ValueError, match="head_dim 32/64/128/256"):
            flash_decode_kernel(q, kc, kc, items, pos, block_kv=BLK)
    q = torch.zeros((2, 8, 512), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim 32/64/128/256"):
        flash_attention(q, q, q)


@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_cuda_yi_two_layer_f32_serve_matches_cpu(cuda, kind):
    """Yi-6B's widths and G at 2 layers, float32, a small vocabulary: the
    card's greedy tokens (the head_dim-128 f32 kernels) equal the plain
    versions' on the CPU."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.core.sparsity import synthetic_head_curves
    from repro_torch.models.transformer import init_params
    from repro_torch.serving import Engine, EngineConfig, SamplingParams
    cfg = dataclasses.replace(get_config("yi-6b"), num_layers=2,
                              vocab_size=512, dtype=torch.float32)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, size=n) for n in (300, 40)]
    before = flash_decode_paged_kernel.launches
    outs = []
    for dev in (cuda, torch.device("cpu")):
        eng = Engine(cfg, init_params(cfg, seed=2, device=dev),
                     EngineConfig(max_seq_len=1024, num_slots=4,
                                  budget_per_head=256, kv_dtype=kind),
                     synthetic_head_curves(cfg.num_layers, cfg.num_heads),
                     device=dev)
        outs.append([r.generated for r in eng.serve(
            prompts, SamplingParams(max_tokens=6))])
    assert outs[0] == outs[1]
    assert flash_decode_paged_kernel.launches > before


@pytest.mark.parametrize("layout", ["paged", "contiguous"])
def test_cuda_gemma3_six_layer_f32_serve_matches_cpu(cuda, layout):
    """Gemma3-1B's widths (head_dim 256, G = 4, one kv head) at 6 layers,
    one LLLLLG period, float32, a small vocabulary, a prompt longer than the
    512-token window: the card's greedy tokens (the head_dim-256 f32
    kernels, windowed decode on the five local layers) equal the plain
    versions' on the CPU."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.core.sparsity import synthetic_head_curves
    from repro_torch.models.transformer import init_params
    from repro_torch.serving import Engine, EngineConfig, SamplingParams
    cfg = dataclasses.replace(get_config("gemma3-1b"), num_layers=6,
                              vocab_size=512, dtype=torch.float32)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab_size, size=n) for n in (600, 40)]
    decode = flash_decode_paged_kernel if layout == "paged" \
        else flash_decode_kernel
    before = decode.launches
    outs = []
    for dev in (cuda, torch.device("cpu")):
        eng = Engine(cfg, init_params(cfg, seed=4, device=dev),
                     EngineConfig(max_seq_len=1024, num_slots=4,
                                  budget_per_head=256, cache_layout=layout),
                     synthetic_head_curves(cfg.num_layers, cfg.num_heads),
                     device=dev)
        outs.append([r.generated for r in eng.serve(
            prompts, SamplingParams(max_tokens=6))])
    assert outs[0] == outs[1]
    assert decode.launches > before


# -- the head-parallel degree: D shards' packed lists end to end -------------

def sharded_case(seed, shards):
    """Random per-slot selections (4 rows x 4 kv heads, G 2, head_dim 64)
    packed on ``shards`` shards, each shard's list padded to one pow2
    bucket, the shards end to end as the engine's decode table: pad rows
    lie between one shard's last run and the next shard's first."""
    q, kp, vp, ids, table, pos = decode_case(seed, B=4, Hkv=4, G=2, D=64,
                                             T=6, layout="ids")
    packed = wl.pack_decode_items(ids, num_shards=shards, block=BLK)
    items = wl.extend_packed_items(
        packed.items, wl.pow2_bucket(packed.padded_length)).reshape(
            -1, wl.DEC_FIELDS)
    valid = items[:, wl.D_VALID]
    assert (valid[:np.flatnonzero(valid)[-1]] == 0).any()
    return q.reshape(4, 4, 2, 64), kp, vp, items, table, pos


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shards", [2, 4])
def test_cuda_decode_on_sharded_tables(cuda, shards, dtype):
    """#1 and #3 on a D-shard table: each within 1e-4 of its plain
    version, two launches the same bits, paged == contiguous bit for
    bit."""
    q, kp, vp, items, table, pos = sharded_case(30 + shards, shards)
    kc, vc = as_slot_cache(kp, table), as_slot_cache(vp, table)
    q, kp, vp, kc, vc, items, table, pos = (t.to(cuda) for t in as_torch(
        q, kp, vp, kc, vc, items, table, pos))
    q, kp, vp, kc, vc = (t.to(dtype) for t in (q, kp, vp, kc, vc))
    paged = flash_decode_paged_kernel(q, kp, vp, items, table, pos,
                                      block_kv=BLK)
    want = packed_decode_attention_paged(q, kp, vp, items, table, pos,
                                         block_kv=BLK)
    for g, w in zip(paged, want):     # f32 sums in another order
        torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-5)
    contig = flash_decode_kernel(q, kc, vc, items, pos, block_kv=BLK)
    want = packed_decode_attention(q, kc, vc, items, pos, block_kv=BLK)
    for g, w in zip(contig, want):
        torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-5)
    again = flash_decode_paged_kernel(q, kp, vp, items, table, pos,
                                      block_kv=BLK)
    for a, b, c in zip(paged, again, contig):
        assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.parametrize("layout", ["paged", "contiguous"])
@pytest.mark.parametrize("shards", [2, 4])
def test_cuda_sharded_f32_serve_matches_cpu(cuda, shards, layout):
    """8 heads over 4 KV heads (head_dim 32, G 2) at D = 2 and 4, float32:
    the card's greedy tokens equal the plain versions' on the CPU, and the
    decode kernel ran."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.core.sparsity import synthetic_head_curves
    from repro_torch.models.transformer import init_params
    from repro_torch.serving import Engine, EngineConfig, SamplingParams
    cfg = dataclasses.replace(get_config("smollm-135m", smoke=True),
                              num_heads=8, num_kv_heads=4,
                              dtype=torch.float32)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, size=n)
               for n in (300, 40, 250, 120)]
    decode = flash_decode_paged_kernel if layout == "paged" \
        else flash_decode_kernel
    before = decode.launches
    outs = []
    for dev in (cuda, torch.device("cpu")):
        eng = Engine(cfg, init_params(cfg, seed=5, device=dev),
                     EngineConfig(max_seq_len=1024, num_slots=4,
                                  budget_per_head=256, cache_layout=layout,
                                  num_model_shards=shards),
                     synthetic_head_curves(cfg.num_layers, cfg.num_heads),
                     device=dev)
        outs.append([r.generated for r in eng.serve(
            prompts, SamplingParams(max_tokens=10))])
    assert outs[0] == outs[1]
    assert decode.launches > before


# -- the paper's baselines: dense attention, monolithic prefill, exact
# buckets, stochastic sampling ----------------------------------------------

@pytest.mark.parametrize("D,G", [(64, 3), (128, 8)])
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 2.0 ** -6)])
@pytest.mark.parametrize("S", [513, 1010, 3500, 512, 1024, 4096])
def test_cuda_flash_attention_prompt_buckets(cuda, dtype, atol, S, D, G):
    """#4 as the dense monolithic prefill runs it: causal, Sq = Skv = the
    prompt bucket, at exact (ragged: not a multiple of 128) and pow2
    lengths, against its plain version."""
    rng = np.random.default_rng(S)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to(cuda, dtype) for s in ((2 * G, S, D), (2, S, D),
                                          (2, S, D)))
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=True)
    assert flash_attention.launches == before + 1
    want = flash_attention_reference(q, k, v, causal=True)
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)


def dense_chunk_case(seed, H=6, Hkv=2, D=64, q_offset=256, chunk=256,
                     real=200, kind=None):
    """A dense chunk (``real`` rows of a ``chunk`` bucket at ``q_offset``)
    over a pool holding the sequence, its table, the slot row holding the
    same values, and the dense causal work list of its real q blocks; with
    ``kind`` the pool holds int8 / fp8 codes and per-block scales."""
    from repro_torch.models.transformer import dense_chunk_items
    rng = np.random.default_rng(seed)
    nblk = (q_offset + chunk) // BLK
    T, N = nblk + 1, nblk + 3
    q = rng.standard_normal((H, chunk, D)).astype(np.float32)
    kp = rng.standard_normal((N, Hkv, BLK, D)).astype(np.float32)
    vp = rng.standard_normal((N, Hkv, BLK, D)).astype(np.float32)
    table = np.full((T,), -1, np.int32)
    table[:nblk] = rng.permutation(N - 1)[:nblk]
    items = dense_chunk_items(H, H // Hkv, block_q=BLK, block_kv=BLK,
                              q_offset=q_offset, q_blocks=-(-real // BLK))
    scales = None
    if kind is not None:
        kp, vp = quant_codes(kp, kind), quant_codes(vp, kind)
        scales = [code_scales(rng, (N, Hkv), kind) for _ in range(2)]
    return q, kp, vp, items, table, scales


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 2.0 ** -6)])
@pytest.mark.parametrize("q_offset,real", [(0, 256), (256, 200),
                                           (512, 44)])
def test_cuda_dense_chunk_list_through_prefill(cuda, dtype, atol, q_offset,
                                               real):
    """#2 over the dense causal chunk list, paged and contiguous, each
    against its plain version, and the two layouts bit for bit."""
    q, kp, vp, items, table, _ = dense_chunk_case(40 + q_offset,
                                                  q_offset=q_offset,
                                                  real=real)
    kc = as_slot_cache(kp, table[None])[0]
    vc = as_slot_cache(vp, table[None])[0]
    q, kp, vp, kc, vc, items, table = (t.to(cuda) for t in as_torch(
        q, kp, vp, kc, vc, items, table))
    q, kp, vp, kc, vc = (t.to(dtype) for t in (q, kp, vp, kc, vc))
    kw = dict(q_offset=q_offset, kv_len=q_offset + real)
    paged = sparse_prefill_paged(q, kp, vp, items, table, **kw)
    torch.testing.assert_close(
        paged[:, :real].float(),
        worklist_attention_paged(q, kp, vp, items, table, **kw)[
            :, :real].float(), atol=atol, rtol=0)
    contig = sparse_prefill_attention(q, kc, vc, items, **kw)
    torch.testing.assert_close(
        contig[:, :real].float(),
        worklist_attention(q, kc, vc, items, **kw)[:, :real].float(),
        atol=atol, rtol=0)
    assert torch.equal(paged, contig)


@pytest.mark.parametrize("kind", ["int8", "fp8"])
def test_cuda_dense_chunk_list_over_codes(cuda, kind):
    """The paged #2 code form over the dense chunk list (bf16 q, tolerance
    2^-6, as the other code-form checks)."""
    q, kp, vp, items, table, (ks, vs) = dense_chunk_case(50, kind=kind)
    kp, vp = code_tensor(kp, kind).to(cuda), code_tensor(vp, kind).to(cuda)
    q, items, table, ks, vs = (t.to(cuda) for t in as_torch(
        q, items, table, ks, vs))
    q = q.to(torch.bfloat16)
    kw = dict(q_offset=256, kv_len=456, k_scales=ks, v_scales=vs)
    got = sparse_prefill_paged(q, kp, vp, items, table, **kw)
    want = worklist_attention_paged(q, kp, vp, items, table, **kw)
    torch.testing.assert_close(got[:, :200].float(), want[:, :200].float(),
                               atol=2.0 ** -6, rtol=0)


@pytest.mark.parametrize("dtype,kind", [(torch.bfloat16, None),
                                        (torch.float32, None),
                                        (torch.float32, "int8"),
                                        (torch.float32, "fp8")])
def test_cuda_dense_decode_from_full_ids(cuda, dtype, kind):
    """#1 and #3 over dense decode's table (every resident block of each
    active row, one row inactive): each within 1e-4 of its plain version,
    paged == contiguous bit for bit; with ``kind`` the code forms (q
    float32, as the engine passes it over codes)."""
    from repro_torch.models.transformer import dense_decode_items
    B, Hkv, G, D, T = 4, 2, 3, 64, 8
    rng = np.random.default_rng(60)
    N = B * T + 1
    q = rng.standard_normal((B, Hkv * G, 1, D)).astype(np.float32)
    kp = rng.standard_normal((N, Hkv, BLK, D)).astype(np.float32)
    vp = rng.standard_normal((N, Hkv, BLK, D)).astype(np.float32)
    pos = np.array([3 * BLK + 5, 0, T * BLK - 1, BLK], np.int32)
    act = np.array([True, False, True, True])
    table = np.full((B, T), -1, np.int32)
    perm = rng.permutation(N - 1)
    for b in range(B):
        nb = int(pos[b]) // BLK + 1
        table[b, :nb] = perm[b * T:b * T + nb]
    items = dense_decode_items(pos, act, Hkv, BLK)
    scales = {}
    if kind is not None:
        kp, vp = quant_codes(kp, kind), quant_codes(vp, kind)
        ks, vs = (code_scales(rng, (N, Hkv), kind) for _ in range(2))
    kc, vc = as_slot_cache(kp, table), as_slot_cache(vp, table)

    def slot_scales(s):
        """The slot cache's scales [B, Hkv, T]: each row's blocks'."""
        return np.stack([np.where(table[b][None, :] >= 0,
                                  s[np.maximum(table[b], 0)].T, 1.0)
                         for b in range(B)]).astype(np.float32)

    cscales = {}
    if kind is None:
        kp, vp, kc, vc = (t.to(cuda, dtype) for t in as_torch(kp, vp, kc,
                                                              vc))
        q = q.astype(np.float32)
    else:
        kp, vp, kc, vc = (code_tensor(t, kind).to(cuda)
                          for t in (kp, vp, kc, vc))
        scales = dict(zip(("k_scales", "v_scales"), (
            t.to(cuda) for t in as_torch(ks, vs))))
        cscales = dict(zip(("k_scales", "v_scales"), (
            t.to(cuda) for t in as_torch(slot_scales(ks), slot_scales(vs)))))
    q, items, table, pos = (t.to(cuda) for t in as_torch(q, items, table,
                                                         pos))
    if kind is None:
        q = q.to(dtype)
    qg = q.reshape(B, Hkv, G, D)
    paged = flash_decode_paged_kernel(qg, kp, vp, items, table, pos,
                                      block_kv=BLK, **scales)
    want = packed_decode_attention_paged(qg, kp, vp, items, table, pos,
                                         block_kv=BLK, **scales)
    contig = flash_decode_kernel(qg, kc, vc, items, pos, block_kv=BLK,
                                 **cscales)
    want_c = packed_decode_attention(qg, kc, vc, items, pos, block_kv=BLK,
                                     **cscales)
    rows = torch.from_numpy(act).to(cuda)
    for got, w in ((paged, want), (contig, want_c)):
        torch.testing.assert_close(got[0][rows], w[0][rows], atol=1e-4,
                                   rtol=1e-5)
    for a, c in zip(paged, contig):
        assert torch.equal(a, c)


def _baseline_serve(dev, dtype=torch.float32, max_tokens=8, sampling=None,
                    **kw):
    """A SMOKE serve of three prompts (300, 513, 40 tokens) on ``dev``:
    its tokens."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.core.sparsity import synthetic_head_curves
    from repro_torch.models.transformer import init_params
    from repro_torch.serving import Engine, EngineConfig, SamplingParams
    cfg = dataclasses.replace(get_config("smollm-135m", smoke=True),
                              dtype=dtype)
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, cfg.vocab_size, size=n)
               for n in (300, 513, 40)]
    eng = Engine(cfg, init_params(cfg, seed=6, device=dev),
                 EngineConfig(max_seq_len=1024, num_slots=4,
                              budget_per_head=256, **kw),
                 synthetic_head_curves(cfg.num_layers, cfg.num_heads),
                 device=dev)
    sampling = sampling or SamplingParams(max_tokens=max_tokens)
    return [r.generated for r in eng.serve(prompts, sampling)]


@pytest.mark.parametrize("mode", [
    dict(attention="dense"),
    dict(attention="dense", prefill_mode="monolithic"),
    dict(attention="dense", prefill_mode="monolithic",
         prefill_buckets="exact"),
    dict(prefill_mode="monolithic"),
    dict(attention="dense", kv_dtype="int8")])
def test_cuda_baseline_serves_match_cpu_and_layouts(cuda, mode):
    """SMOKE float32 serves of the baselines: the card's greedy tokens
    equal the plain versions' on the CPU, paged == contiguous on the card,
    and a dense monolithic serve launched #4."""
    before = flash_attention.launches
    got = _baseline_serve(cuda, **mode)
    assert got == _baseline_serve(cuda, cache_layout="contiguous", **mode)
    assert got == _baseline_serve(torch.device("cpu"), **mode)
    if mode.get("prefill_mode") == "monolithic" and "attention" in mode:
        assert flash_attention.launches > before


@pytest.mark.parametrize("layout", ["paged", "contiguous"])
def test_cuda_bf16_chunked_equals_monolithic(cuda, layout):
    """Sparse attention in bf16 on the card: chunked == monolithic (pow2
    and exact buckets) greedy tokens, bit for bit."""
    kw = dict(dtype=torch.bfloat16, cache_layout=layout, max_tokens=12)
    base = _baseline_serve(cuda, **kw)
    assert base == _baseline_serve(cuda, prefill_mode="monolithic", **kw)
    assert base == _baseline_serve(cuda, prefill_mode="monolithic",
                                   prefill_buckets="exact", **kw)


def test_cuda_sampling_on_the_card(cuda):
    """The sampler on CUDA logits with a CUDA generator: seeded draws
    repeat and stay on the card, greedy is the argmax; a seeded stochastic
    serve repeats itself, and greedy serves are unchanged by the seed."""
    from repro_torch.serving import SamplingParams
    from repro_torch.serving.sampler import filter_logits, sample
    logits = torch.randn((64, 1000), generator=torch.Generator().manual_seed(
        0)).to(cuda)
    p = SamplingParams(temperature=0.8, top_k=50, top_p=0.95)
    draw = lambda: sample(logits, p, torch.Generator(  # noqa: E731
        device=cuda).manual_seed(9))
    a = draw()
    assert a.device.type == "cuda" and torch.equal(a, draw())
    assert torch.isfinite(filter_logits(logits, p).gather(
        1, a.long()[:, None])).all()
    assert torch.equal(sample(logits, SamplingParams()),
                       logits.argmax(-1).int())
    sp = SamplingParams(temperature=0.8, top_k=50, top_p=0.95, max_tokens=8)
    one = _baseline_serve(cuda, sampling=sp)
    assert one == _baseline_serve(cuda, sampling=sp)
    assert one != _baseline_serve(cuda, sampling=sp, seed=1)
    assert _baseline_serve(cuda) == _baseline_serve(cuda, seed=5)


# -- the window forms of #2 and #4 (the sliding-window layers' dense prefill) -

@pytest.mark.parametrize("D", [32, 64, 128, 256])
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, BF16_ATOL)])
@pytest.mark.parametrize("window,q_offset,real", [
    (100, 512, 200), (128, 256, 256), (300, 0, 256), (1000, 512, 44)])
def test_cuda_window_dense_chunk_matches_plain(cuda, dtype, atol, window,
                                               q_offset, real, D):
    """#2's window form over a dense chunk list, paged and contiguous, each
    against its plain version (windows shorter than a tile, one tile, more
    than the chunk, and past every key), and the layouts bit for bit."""
    q, kp, vp, items, table, _ = dense_chunk_case(
        60 + window, H=4, Hkv=1, D=D, q_offset=q_offset, real=real)
    kc = as_slot_cache(kp, table[None])[0]
    vc = as_slot_cache(vp, table[None])[0]
    q, kp, vp, kc, vc, items, table = (t.to(cuda) for t in as_torch(
        q, kp, vp, kc, vc, items, table))
    q, kp, vp, kc, vc = (t.to(dtype) for t in (q, kp, vp, kc, vc))
    kw = dict(q_offset=q_offset, kv_len=q_offset + real, window=window)
    paged = sparse_prefill_paged(q, kp, vp, items, table, **kw)
    torch.testing.assert_close(
        paged[:, :real].float(),
        worklist_attention_paged(q, kp, vp, items, table, **kw)[
            :, :real].float(), atol=atol, rtol=0)
    contig = sparse_prefill_attention(q, kc, vc, items, **kw)
    torch.testing.assert_close(
        contig[:, :real].float(),
        worklist_attention(q, kc, vc, items, **kw)[:, :real].float(),
        atol=atol, rtol=0)
    assert torch.equal(paged, contig)
    assert sparse_prefill_paged.launches_by_dtype.get("window", 0) > 0


@pytest.mark.parametrize("D", [32, 64, 128, 256])
@pytest.mark.parametrize("kind", ["int8", "fp8"])
def test_cuda_window_dense_chunk_over_codes(cuda, kind, D):
    """#2 paged's code forms with a window (bf16 q, tolerance 2^-6)."""
    q, kp, vp, items, table, (ks, vs) = dense_chunk_case(
        70, H=4, Hkv=1, D=D, kind=kind)
    kp, vp = code_tensor(kp, kind).to(cuda), code_tensor(vp, kind).to(cuda)
    q, items, table, ks, vs = (t.to(cuda) for t in as_torch(
        q, items, table, ks, vs))
    q = q.to(torch.bfloat16)
    kw = dict(q_offset=256, kv_len=456, k_scales=ks, v_scales=vs, window=150)
    got = sparse_prefill_paged(q, kp, vp, items, table, **kw)
    want = worklist_attention_paged(q, kp, vp, items, table, **kw)
    torch.testing.assert_close(got[:, :200].float(), want[:, :200].float(),
                               atol=BF16_ATOL, rtol=0)


@pytest.mark.parametrize("D", [32, 64, 128, 256])
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, BF16_ATOL)])
@pytest.mark.parametrize("causal,sq,skv,bq,bkv,window", [
    (True, 1000, 1000, 128, 128, 100), (True, 513, 513, 128, 128, 512),
    (True, 333, 517, 96, 80, 64), (False, 300, 700, 128, 128, 200)])
def test_cuda_window_flash_attention_matches_plain(cuda, dtype, atol, causal,
                                                   sq, skv, bq, bkv, window,
                                                   D):
    """#4's window form: ragged lengths, odd blocks, a window below one
    tile and the non-causal mask."""
    rng = np.random.default_rng(17 + window)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to(cuda, dtype)
               for s in ((4, sq, D), (1, skv, D), (1, skv, D)))
    kw = dict(causal=causal, block_q=bq, block_kv=bkv, window=window)
    got = flash_attention(q, k, v, **kw)
    want = flash_attention_reference(q, k, v, **kw)
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)


# -- the offline profiling stage and the preemption swap tier -----------------

@pytest.mark.parametrize("S", [57, 1024])
def test_cuda_device_curve_equals_numpy(cuda, S):
    """``recovery_curves_torch`` on the card (float64 sort and prefix sum)
    against the numpy ``recovery_curve`` of each head, within 1e-9, over
    causal maps with underflowed entries inside the prefix."""
    from repro_torch.core.sparsity import recovery_curve, recovery_curves_torch
    rng = np.random.default_rng(S)
    logits = rng.standard_normal((3, S, S)) * rng.uniform(0.5, 8.0, (3, 1, 1))
    logits = np.where(np.tril(np.ones((S, S), bool)), logits, -np.inf)
    w = np.exp(logits - logits.max(-1, keepdims=True))
    w[rng.random(w.shape) < 0.05] = 0.0
    w[..., 0] += (w.sum(-1) == 0)
    maps = (w / w.sum(-1, keepdims=True)).astype(np.float32)
    got = recovery_curves_torch(torch.from_numpy(maps).to(cuda))
    want = np.stack([recovery_curve(maps[h]) for h in range(3)])
    np.testing.assert_allclose(got, want, atol=1e-9, rtol=0)


def test_cuda_profile_matches_cpu(cuda):
    """SMOKE float32 profiling forward (the flash attention kernel runs the
    attention, the maps are plain ops) and ``profile_model`` on the card:
    curves within 1e-5 of the CPU's from the same weights and tokens."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.core.sparsity import profile_model
    from repro_torch.models import transformer as tfm
    cfg = dataclasses.replace(get_config("smollm-135m", smoke=True),
                              dtype=torch.float32)
    params = tfm.init_params(cfg, seed=2, device="cpu")
    dev_params = tfm.init_params(cfg, seed=2, device=cuda)
    rng = np.random.default_rng(2)
    batches = [rng.integers(0, cfg.vocab_size, size=n) for n in (300, 170)]
    before = flash_attention.launches
    got = profile_model(lambda t: tfm.attention_maps_of(dev_params, t, cfg),
                        batches)
    assert flash_attention.launches > before
    want = profile_model(lambda t: tfm.attention_maps_of(params, t, cfg),
                         batches)
    np.testing.assert_allclose(got.curves, want.curves, atol=1e-5, rtol=0)


def _swap_engine(dev, layout, kv, **kw):
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.core.sparsity import synthetic_head_curves
    from repro_torch.models.transformer import init_params
    from repro_torch.serving import Engine, EngineConfig
    cfg = dataclasses.replace(get_config("smollm-135m", smoke=True),
                              dtype=torch.float32)
    kw.setdefault("preemption", True)
    return Engine(cfg, init_params(cfg, seed=4, device=dev),
                  EngineConfig(max_seq_len=1024, budget_per_head=256,
                               cache_layout=layout, kv_dtype=kv, **kw),
                  synthetic_head_curves(cfg.num_layers, cfg.num_heads),
                  device=dev)


@pytest.mark.parametrize("layout", ["paged", "contiguous"])
@pytest.mark.parametrize("kv", ["bf16", "int8", "fp8"])
def test_cuda_pinned_swap_roundtrip_bit_for_bit(cuda, layout, kv):
    """The swap hooks on the card: the host copy lands in pinned buffers
    and equals the device state it was taken from; after the ids (slot) are
    overwritten by another tenant, swap-in restores the sequence's codes and
    scales bit for bit into freshly mapped blocks (another slot)."""
    from repro_torch.core.quant import code_bits
    eng = _swap_engine(cuda, layout, kv, num_slots=2)
    b = eng.make_batcher()
    gen = torch.Generator(device=cuda).manual_seed(0)

    def scribble():
        for t in ((eng.kv.pool, eng.kv.scales) if eng.paged
                  else (eng.cache, eng.cache_scales)):
            if t is not None:
                bits = code_bits(t) if t.element_size() == 1 else t
                bits.copy_(torch.randint(-100, 100, bits.shape,
                                         generator=gen, device=cuda)
                           .to(bits.dtype))

    def state(rid, slot, n):
        blk = eng.ecfg.block
        if eng.paged:
            ids = torch.tensor(eng.kv.alloc.table(rid), device=cuda)
            parts = (eng.kv.pool.index_select(2, ids),
                     None if eng.kv.scales is None
                     else eng.kv.scales.index_select(2, ids))
        else:
            nb = -(-n // blk)
            parts = (eng.cache[:, :, slot, :, :nb * blk],
                     None if eng.cache_scales is None
                     else eng.cache_scales[:, :, slot, :, :nb])
        return [None if p is None else
                (code_bits(p) if p.element_size() == 1 else p).clone()
                for p in parts]

    scribble()
    n = 300
    b.alloc.admit(7, n, 20)
    want = state(7, 1, n)
    eng._swap_out_seq(7, 1, n)
    data, scales = eng.host_copy(7)
    assert data.is_pinned() and (scales is None or scales.is_pinned())
    assert torch.equal(data.to(cuda).reshape(want[0].shape), want[0])
    b.alloc.swap_out(7)
    b.alloc.admit(8, 500, 0)              # another tenant takes the ids
    scribble()
    b.alloc.swap_in(7, 20)
    eng._swap_in_seq(7, 0, n)
    got = state(7, 0, n)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            assert torch.equal(g, w)
    st = eng.swap_stats
    assert st["blocks_in"] == st["blocks_out"] == 3
    assert st["bytes_in"] == st["bytes_out"] > 0
    eng._reap_transfers(wait=True)
    assert eng._swap_in_flight == [] and eng._host_swaps == {}


@pytest.mark.parametrize("layout", ["paged", "contiguous"])
@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_cuda_preempted_serve_matches_cpu(cuda, layout, kv):
    """A SMOKE float32 serve whose decoding batch request is swapped out
    for a later interactive arrival and swapped back: the card's tokens
    equal the card's uninterrupted serve and the CPU's preempted serve;
    the decode and prefill kernels launched."""
    from repro_torch.serving import SamplingParams
    from repro_torch.serving.scheduler import Request
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 512, size=n) for n in (300, 250, 200)]
    tight = (dict(num_slots=4, num_kv_blocks=6) if layout == "paged"
             else dict(num_slots=2))

    def drive(dev, **kw):
        eng = _swap_engine(dev, layout, kv, **kw)
        sp = SamplingParams(max_tokens=12)
        b = eng.make_batcher()
        pf, df = eng.step_fns(sp)
        for i in range(2):
            b.submit(Request(rid=i, prompt=np.asarray(prompts[i], np.int32),
                             sampling=sp, priority="batch"))
        done = []
        while b.busy and not (b.prefilling is None and len(b.active) == 2):
            done.extend(b.tick(pf, df))
        done.extend(b.tick(pf, df))
        b.submit(Request(rid=2, prompt=np.asarray(prompts[2], np.int32),
                         sampling=sp, priority="interactive"))
        done.extend(b.run(pf, df))
        return {r.rid: r.generated for r in done}, eng

    dec = flash_decode_paged_kernel if layout == "paged" else \
        flash_decode_kernel
    before = dec.launches
    got, eng = drive(cuda, **tight)
    assert dec.launches > before
    assert eng.swap_stats["swapped_out"] >= 1
    assert eng.swap_stats["blocks_in"] == eng.swap_stats["blocks_out"]
    assert got == drive(cuda, **tight, preemption=False)[0]
    assert got == drive(torch.device("cpu"), **tight)[0]


def _striped_step_case(S, seed=5, B=3, T=8):
    """A SMOKE float32 model, a pool of ``4 * T`` blocks in ``S`` stripes,
    rows whose blocks are spread over the stripes (row 2's all on stripe
    0, so its pairs are masked in every other stripe), per-layer per-slot
    selections and each layer's per-stripe packed lists."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_params
    cfg = dataclasses.replace(get_config("smollm-135m", smoke=True),
                              dtype=torch.float32, num_heads=4,
                              num_kv_heads=2)
    params = init_params(cfg, seed=seed, device="cpu")
    rng = np.random.default_rng(seed)
    N = 4 * T
    size = N // S
    pool = torch.from_numpy(rng.standard_normal(
        (cfg.num_layers, 2, N + 1, cfg.num_kv_heads, BLK, cfg.head_dim_))
        .astype(np.float32))
    pos = np.array([7 * BLK + 5, 3 * BLK + 70, 2 * BLK + 1], np.int32)
    table = np.full((B, T), -1, np.int32)
    free = list(rng.permutation(N))
    for b in range(B):
        for j in range(int(pos[b]) // BLK + 1):
            if b == 2:
                table[b, j] = next(i for i in free if i < size)
            else:
                table[b, j] = free[0]
            free.remove(table[b, j])
    ids = np.full((cfg.num_layers, B, cfg.num_kv_heads, 5), -1, np.int32)
    for l in range(cfg.num_layers):
        for b in range(B):
            nb = int(pos[b]) // BLK + 1
            for h in range(cfg.num_kv_heads):
                n = int(rng.integers(1, min(nb, 5) + 1))
                sel = np.sort(rng.choice(nb, size=n, replace=False))
                ids[l, b, h, :n] = sel
    stripe_of = np.where(table >= 0, table // size, -1)
    lists = [wl.pack_decode_items_2d(ids[l], stripe_of, num_stripes=S,
                                     block=BLK) for l in range(cfg.num_layers)]
    width = max(x.padded_length for x in lists)
    packed = np.stack([wl.extend_packed_items(x.stripe_items(), width)
                       for x in lists])
    token = rng.integers(0, cfg.vocab_size, size=B)
    return cfg, params, pool, pos, table, ids, packed, token, size


@pytest.mark.parametrize("S", [2, 4])
@pytest.mark.parametrize("work", ["packed", "ids", "dense"])
def test_cuda_striped_decode_step_matches_plain(cuda, S, work):
    """The paged decode step with S stripes on the card (S passes of #1 a
    layer, the partials merged) against the same step's plain versions on
    the CPU, within 1e-4, its token writes too; #1 launched S times a
    layer; and the unstriped step on the card agrees within 1e-4."""
    from repro_torch.models import transformer as tfm
    cfg, params, pool, pos, table, ids, packed, token, size = \
        _striped_step_case(S)
    kw = {"packed": dict(packed_items=packed), "ids": dict(block_ids=ids),
          "dense": {}}[work]

    def to(tree, dev):
        if isinstance(tree, dict):
            return {k: to(v, dev) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to(v, dev) for v in tree]
        return tree.to(dev)

    def step(dev, stripes, pool_in):
        p = to(params, dev)
        args = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                for k, v in kw.items()}
        if stripes == 1 and work == "packed":
            return None, None
        pl = pool_in.clone().to(dev)
        logits = tfm.decode_step_paged(
            p, pl, torch.from_numpy(token).to(dev),
            torch.from_numpy(pos).to(dev), torch.from_numpy(table).to(dev),
            cfg, seq_stripes=stripes, stripe_size=size, **args)
        return logits.cpu(), pl.cpu()

    before = flash_decode_paged_kernel.launches
    got, got_pool = step(cuda, S, pool)
    assert flash_decode_paged_kernel.launches - before == S * cfg.num_layers
    want, want_pool = step(torch.device("cpu"), S, pool)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
    # the token writes: the card's and the CPU's projections of the same
    # rows, sums taken in another order
    torch.testing.assert_close(got_pool, want_pool, rtol=0, atol=1e-4)
    one, _ = step(cuda, 1, pool)
    if one is not None:
        torch.testing.assert_close(got, one, rtol=0, atol=1e-4)


def test_cuda_fully_masked_stripe_drops_out_of_the_merge(cuda):
    """#1 on the card under a stripe-masked table: a (row, kv head) none of
    whose blocks that stripe holds comes back as (0, -1e30, 0), and the
    merge of the stripes' partials keeps the other stripe's output bitwise
    for it and equals the unstriped launch within 1e-5 elsewhere."""
    from repro_torch.models.transformer import _merge_stripe_partials
    q, kp, vp, ids, table, pos = decode_case(11, B=3, Hkv=2, G=3, D=64,
                                             layout="ids")
    N = kp.shape[0] - 1
    size = -(-N // 2)
    # row 0's blocks all on stripe 0: rows 1, 2 keep theirs
    t = table.copy()
    owned = t[0] >= 0
    low = [i for i in range(size) if i not in set(t[1:].ravel())]
    t[0, owned] = low[:int(owned.sum())]
    q, kp, vp, ids, t, pos = (x.to(cuda) for x in as_torch(
        q, kp, vp, ids, t, pos))
    parts = []
    for s in range(2):
        mine = torch.where((t >= 0) & (t // size == s), t, -1)
        parts.append(ops.flash_decode_paged(q, kp, vp, ids, mine, pos,
                                            block_kv=BLK, partials=True))
    out1, m1, l1 = parts[1]
    assert (l1[0] == 0).all() and (m1[0] <= -1e29).all()
    assert not out1[0].any()
    merged = _merge_stripe_partials(parts, 3, 2, 64, torch.float32)
    assert torch.equal(merged[0], parts[0][0][0])
    whole = ops.flash_decode_paged(q, kp, vp, ids, t, pos, block_kv=BLK,
                                   partials=True)[0]
    torch.testing.assert_close(merged, whole, rtol=0, atol=1e-5)


def test_cuda_prefix_cache_on_equals_off(cuda):
    """A SMOKE float32 engine on the card serving shared-prefix traffic
    twice: the cache-on tokens equal the cache-off ones bit for bit and the
    CPU's cache-on serve's; the second serve hits; #1 and #2 launched."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.core.sparsity import synthetic_head_curves
    from repro_torch.models.transformer import init_params
    from repro_torch.serving import Engine, EngineConfig, SamplingParams
    cfg = dataclasses.replace(get_config("smollm-135m", smoke=True),
                              dtype=torch.float32)
    params = init_params(cfg, seed=6, device="cpu")
    rng = np.random.default_rng(6)
    shared = rng.integers(0, cfg.vocab_size, size=256)
    prompts = [np.concatenate([shared, rng.integers(0, cfg.vocab_size,
                                                    size=n)])
               for n in (40, 200, 129)]

    def serve(dev, on, S=2):
        eng = Engine(cfg, params,
                     EngineConfig(max_seq_len=1024, budget_per_head=256,
                                  prefix_cache=on, seq_shards=S),
                     synthetic_head_curves(cfg.num_layers, cfg.num_heads),
                     device=dev)
        out = [[r.generated for r in eng.serve(
            prompts, SamplingParams(max_tokens=10))] for _ in range(2)]
        return out, eng

    before = (flash_decode_paged_kernel.launches,
              sparse_prefill_paged.launches)
    on, eng = serve(cuda, True)
    assert flash_decode_paged_kernel.launches > before[0]
    assert sparse_prefill_paged.launches > before[1]
    assert eng._batcher.stats.prefix_hits == len(prompts)
    off, _ = serve(cuda, False)
    assert on == off
    cpu, _ = serve(torch.device("cpu"), True)
    assert on == cpu


# -- faults (§2.13): stale non-finite values, the sentinel, the scrub --------

def stale_nan_outputs(dev, dtype=torch.float32, D=64, blk=64, nan=True):
    """Each paged / contiguous attention form over a cache whose last,
    partly filled block holds NaN past the sequence's length (the state of
    a recycled block the fault path did not scrub): ``{form: all outputs
    finite}``.  Keys past the length are masked, so a kernel that never
    multiplies a masked key's value row stays finite, and one whose p.V
    multiplies it by a zero weight gives ``0 x NaN = NaN``.  Forms: ``#1``
    (paged decode), ``#3`` (contiguous decode), ``#2`` (paged sparse
    prefill).  ``nan=False`` leaves the block clean (the control)."""
    g = torch.Generator().manual_seed(0)
    Hkv, G, T = 2, 2, 3
    n = 2 * blk + blk // 2           # the third block is half filled
    rnd = lambda *s: torch.randn(*s, generator=g).to(dtype)   # noqa: E731
    kp, vp = rnd(T + 1, Hkv, blk, D), rnd(T + 1, Hkv, blk, D)
    table = torch.tensor([[1, 3, 0]], dtype=torch.int32)
    if nan:
        vp[0, :, n - 2 * blk:] = torch.nan  # physical block 0, past n
    pos = torch.tensor([n - 1], dtype=torch.int32)
    ids = torch.arange(T, dtype=torch.int32).expand(1, Hkv, T).contiguous()
    items = flash_decode_items(ids)
    q = rnd(1, Hkv, G, D)
    out = {}
    got = flash_decode_paged_kernel(
        q.to(dev), kp.to(dev), vp.to(dev), items.to(dev), table.to(dev),
        pos.to(dev), block_kv=blk)[0]
    out["#1"] = bool(torch.isfinite(got).all())
    kc = torch.cat([kp[int(b)] for b in table[0]], dim=1)[None]
    vc = torch.cat([vp[int(b)] for b in table[0]], dim=1)[None]
    got = flash_decode_kernel(q.to(dev), kc.to(dev), vc.to(dev),
                              items.to(dev), pos.to(dev), block_kv=blk)[0]
    out["#3"] = bool(torch.isfinite(got).all())
    # a final prefill chunk: the last q block's rows attend every block
    # (the causal list), keys past n masked
    qs = rnd(Hkv * G, blk, D)
    rows = []
    for h in range(Hkv * G):
        for kb in range(T):
            rows.append([h, 0, kb, int(kb == 0), int(kb == T - 1), 1,
                         h // G])
    pitems = torch.tensor(rows, dtype=torch.int32)
    got = sparse_prefill_paged(
        qs.to(dev), kp.to(dev), vp.to(dev), pitems.to(dev),
        table[0].to(dev), block_q=blk, block_kv=blk, q_offset=n - blk,
        kv_len=n)
    out["#2"] = bool(torch.isfinite(got[:, :blk]).all())
    return out


def flash_decode_items(block_ids):
    from repro_torch.kernels.flash_decode import decode_items_from_ids
    return decode_items_from_ids(block_ids)


def test_cuda_stale_nan_past_the_length_leaks(cuda):
    """On the card the bf16 prefill's tensor-core P.V takes the whole V
    tile, multiplying a masked key's zero weight into its value row: a NaN
    past the length in a recycled block poisons its output, which is why
    the engine scrubs a failed sequence's blocks before they free.  The
    decode forms (#1 / #3) copy no key past the position and the f32
    prefill's scalar body stops at the length: both stay finite.  (The
    plain versions leak in every form: ``tests/test_torch_faults.py``.)"""
    leaks = {torch.float32: {"#1": True, "#3": True, "#2": True},
             torch.bfloat16: {"#1": True, "#3": True, "#2": False}}
    for dtype, want in leaks.items():
        assert stale_nan_outputs(cuda, dtype, nan=False) == {
            "#1": True, "#3": True, "#2": True}
        assert stale_nan_outputs(cuda, dtype) == want


def _fault_parts(dev):
    """The SMOKE float32 config, its seeded weights on ``dev`` and the
    synthetic profile of the card fault tests."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.core.sparsity import synthetic_head_curves
    from repro_torch.models.transformer import init_params
    cfg = dataclasses.replace(get_config("smollm-135m", smoke=True),
                              dtype=torch.float32)
    return (cfg, init_params(cfg, seed=4, device=dev),
            synthetic_head_curves(cfg.num_layers, cfg.num_heads))


def _fault_config(layout="paged", kv="bf16", **kw):
    from repro_torch.serving import EngineConfig
    return EngineConfig(max_seq_len=1024, budget_per_head=256,
                        cache_layout=layout, kv_dtype=kv, **kw)


def _fault_engine(dev, layout="paged", kv="bf16", **kw):
    from repro_torch.serving import Engine
    cfg, params, profile = _fault_parts(dev)
    return Engine(cfg, params, _fault_config(layout, kv, **kw), profile,
                  device=dev)


def test_cuda_sentinel_flags_ride_the_token_copy(cuda):
    """The sentinel's finite flags are computed on the card and cross in
    the one device-to-host copy of the sampled tokens: a decode call with
    a NaN row copies once, and flags that row's slot alone."""
    from repro_torch.serving import SamplingParams
    eng = _fault_engine(cuda)
    logits = torch.randn(4, 512, device=cuda)
    logits[2, 7] = torch.nan
    copies = []
    real = torch.Tensor.cpu

    def counted(t, *a, **k):
        copies.append(tuple(t.shape))
        return real(t, *a, **k)
    torch.Tensor.cpu = counted
    try:
        toks = eng._sample(logits, SamplingParams(),
                           [(r, r) for r in range(4)])
    finally:
        torch.Tensor.cpu = real
    assert copies == [(2, 4)]
    want = logits.argmax(-1).tolist()
    assert [toks[r] for r in (0, 1, 3)] == [want[r] for r in (0, 1, 3)]
    assert eng.take_quarantine() == {2: "nonfinite_logits"}


@pytest.mark.parametrize("layout", ["paged", "contiguous"])
@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_cuda_scrub_zeroes_codes_and_resets_scales(cuda, layout, kv):
    """``_release_seq`` on the card: every block a failed sequence held
    alone (its slot row, contiguous) reads codes 0 and scales 1 after the
    scrub, and nothing else changed."""
    from repro_torch.core.quant import code_bits
    eng = _fault_engine(cuda, layout, kv)
    b = eng.make_batcher()
    b.alloc.admit(3, 300, 0)
    codes, scales = eng._live_cache()
    bits = code_bits(codes) if codes.element_size() == 1 else codes
    bits.copy_(torch.randint(1, 100, bits.shape, device=cuda)
               .to(bits.dtype))
    if scales is not None:
        scales.fill_(3.0)
    before = (bits.clone(), None if scales is None else scales.clone())
    if layout == "paged":
        at = torch.tensor(b.alloc.table(3), device=cuda)
        eng._release_seq(3, None)
    else:
        at = torch.tensor([1], device=cuda)
        eng._release_seq(3, 1)
    torch.cuda.synchronize()
    assert not bits.index_select(2, at).any()
    keep = torch.ones(bits.shape[2], dtype=torch.bool, device=cuda)
    keep[at] = False
    assert torch.equal(bits[:, :, keep], before[0][:, :, keep])
    if scales is not None:
        assert (scales.index_select(2, at) == 1.0).all()
        assert torch.equal(scales[:, :, keep], before[1][:, :, keep])


@pytest.mark.parametrize("layout", ["paged", "contiguous"])
def test_cuda_snapshot_restore_resumes(cuda, layout, tmp_path):
    """A SMOKE float32 engine on the card ticks part way, is saved, freed
    and restored on the card; the restored engine finishes with the
    uninterrupted serve's tokens."""
    import numpy as np
    from repro_torch.serving import SamplingParams
    from repro_torch.serving.scheduler import Request
    from repro_torch.serving.snapshot import restore_serving, save_serving
    sp = SamplingParams(max_tokens=16)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 512, size=n) for n in (300, 200, 130)]
    want = {r.rid: r.generated
            for r in _fault_engine(cuda, layout).serve(prompts, sp)}
    eng = _fault_engine(cuda, layout)
    b = eng.make_batcher()
    pf, df = eng.step_fns(sp)
    for i, p in enumerate(prompts):
        b.submit(Request(rid=i, prompt=np.asarray(p, np.int32),
                         sampling=sp))
    done = []
    while not (len(b.active) == len(prompts) and b.replan_safe
               and eng._decode_ticks >= 4):
        done.extend(b.tick(pf, df))
    path = save_serving(str(tmp_path), eng, b)
    del eng, b, pf, df
    torch.cuda.empty_cache()
    cfg, params, profile = _fault_parts(cuda)
    eng, b = restore_serving(path, cfg, params, _fault_config(layout),
                             profile, device=cuda)
    pf, df = eng.step_fns(sp)
    while b.busy:
        done.extend(b.tick(pf, df))
    assert {r.rid: r.generated for r in done} == want


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m",
                                  "llama4-scout-17b-a16e"])
@pytest.mark.parametrize("n", [8, 256])
def test_cuda_moe_ffn_bf16_matches_cpu_f32(cuda, arch, n):
    """The MoE FFN at the model's widths (one layer's experts, bf16 on the
    card) against its float32 CPU run on the same bf16 values: within two
    bf16 ulps at |x| < 4 on the rows both devices route alike (at most 1%
    routed otherwise: f32 router sums in another order), and two card
    calls equal bit for bit (the combine adds each row's experts in a
    fixed order, no atomics)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    from repro_torch.models.transformer import init_params
    cfg = dataclasses.replace(get_config(arch), num_layers=1, vocab_size=8)
    p = init_params(cfg, seed=0, device=cuda, host_rng=False)[
        "layers"][0]["moe"]
    x = torch.randn((1, n, cfg.d_model), device=cuda).to(torch.bfloat16)
    got = moe.moe_ffn(x, p, cfg.moe)
    assert torch.equal(got, moe.moe_ffn(x, p, cfg.moe))
    cpu_p = {k: v.float().cpu() for k, v in p.items()}
    want = moe.moe_ffn(x.float().cpu(), cpu_p, cfg.moe)
    alike = (moe.route(x[0], p["router"], cfg.moe)[0].cpu()
             == moe.route(x[0].float().cpu(), cpu_p["router"],
                          cfg.moe)[0]).all(-1)
    assert alike.sum() >= 0.99 * n
    err = (got[0].float().cpu() - want[0])[alike].abs().max().item()
    assert err <= 2.0 ** -5


def test_cuda_granite_width_f32_serve_matches_cpu(cuda):
    """Granite-MoE-1B's widths at 2 layers in float32, both layouts: the
    card's greedy tokens (the MoE FFN and the kernels' f32 forms at
    head_dim 64) == the plain versions' on the CPU."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.core.sparsity import synthetic_head_curves
    from repro_torch.models.transformer import init_params
    from repro_torch.serving import Engine, EngineConfig, SamplingParams
    cfg = dataclasses.replace(get_config("granite-moe-1b-a400m"),
                              num_layers=2, dtype=torch.float32)
    params = init_params(cfg, seed=3, device="cpu")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, size=n) for n in (300, 40)]

    def serve(dev, layout):
        eng = Engine(cfg, params,
                     EngineConfig(max_seq_len=1024, num_slots=4,
                                  budget_per_head=256, cache_layout=layout),
                     synthetic_head_curves(cfg.num_layers, cfg.num_heads),
                     device=dev)
        return [r.generated for r in eng.serve(
            prompts, SamplingParams(max_tokens=6))]

    for layout in ("paged", "contiguous"):
        assert serve(cuda, layout) == serve(torch.device("cpu"), layout)


def _mesh_islands_rank(env, record_dir):
    """On one of 2 gloo ranks sharing the card: the prefill island over
    this rank's heads and KV groups, and the paged island over its pool
    stripe; its inputs and outputs saved for the parent."""
    import os
    from repro_torch.launch.mesh import Mesh
    from repro_torch.serving import sharded_attention as isl
    m = Mesh(env, model=2)
    d = m.axis_index("model")
    dev = env.device
    gen = torch.Generator(device=dev).manual_seed(5)
    randn = lambda *s: torch.randn(s, generator=gen, device=dev).to(  # noqa
        torch.bfloat16)
    q, k, v = randn(1, 8, 512, 64), randn(1, 4, 512, 64), randn(1, 4, 512, 64)
    lists = wl.worklist_from_budgets(
        np.array([512, 256, 384, 128, 512, 256, 128, 384]), num_devices=2,
        seq_len=512, block=BLK, policy_fn=strided_policy, group_size=2)
    items = torch.from_numpy(lists.items[d:d + 1, None]).to(dev)
    pre = (0, q[:, 4 * d:4 * d + 4], k[:, 2 * d:2 * d + 2],
           v[:, 2 * d:2 * d + 2], items)
    out = isl.hplb_prefill_attention()(*pre)
    qd, kp, vp = randn(4, 8, 1, 64), randn(32, 4, BLK, 64), randn(
        32, 4, BLK, 64)
    rng = np.random.default_rng(5)
    table = torch.from_numpy(rng.permutation(32).reshape(4, 8).astype(
        np.int32)).to(dev)
    pos = torch.tensor([1000, 700, 300, 129], dtype=torch.int32, device=dev)
    ids = torch.arange(8, dtype=torch.int32, device=dev)[None, None].expand(
        4, 4, 8).contiguous()
    paged = (qd, kp[16 * d:16 * d + 16], vp[16 * d:16 * d + 16], ids, table,
             pos)
    dec = isl.flash_decode_attention_paged(m, seq_axes=("model",))(*paged)
    path = os.path.join(record_dir, f"rank{d}.pt")
    torch.save({"pre": [x.cpu() if torch.is_tensor(x) else x for x in pre],
                "out": out.cpu(), "paged": [x.cpu() for x in paged],
                "full": (kp.cpu(), vp.cpu()), "dec": dec.cpu()}, path)
    return path


def test_cuda_mesh_islands_on_one_card(cuda, tmp_path):
    """Two gloo ranks on one card: each rank's prefill island output equals
    the contiguous prefill kernel launched here on its inputs, bit for
    bit; the paged island's merged output equals the paged decode over the
    whole pool within one bf16 step, and misses it with a stripe
    dropped."""
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_decode import merge_partials
    from repro_torch.launch.mesh import spawn
    from repro_torch.serving import sharded_attention as isl
    build.build()
    paths = spawn(_mesh_islands_rank, world_size=2, backend="gloo",
                  device="cuda:0", timeout_s=120, args=(str(tmp_path),))
    recs = [torch.load(p, map_location=cuda, weights_only=False)
            for p in paths]
    for rec in recs:
        l, q, k, v, items = rec["pre"]
        want = sparse_prefill_attention(q[0].contiguous(), k[0].contiguous(),
                                        v[0].contiguous(), items[0, l])
        assert torch.equal(rec["out"][0], want)
    qd, _, _, ids, table, pos = recs[0]["paged"]
    kp, vp = recs[0]["full"]
    want = ops.flash_decode_paged(qd, kp, vp, ids, table, pos)
    parts = [ops.flash_decode_paged(
        qd, r["paged"][1], r["paged"][2], ids,
        isl.local_table(table, 16 * i, 16), pos, partials=True)
        for i, r in enumerate(recs)]
    merged = merge_partials(torch.stack([o.reshape(4, 4, 2, 64)
                                         for o, _, _ in parts]),
                            torch.stack([p[1] for p in parts]),
                            torch.stack([p[2] for p in parts]))[0]
    for rec in recs:
        assert torch.equal(rec["dec"], recs[0]["dec"])
        assert (rec["dec"].float() - want.float()).abs().max() <= 2.0 ** -6
    assert (merged.reshape(4, 8, 1, 64).float()
            - recs[0]["dec"].float()).abs().max() <= 2.0 ** -6
    assert (parts[1][0].reshape(4, 8, 1, 64).float()
            - want.float()).abs().max() > 2.0 ** -6
