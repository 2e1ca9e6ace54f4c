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


# head_dim 64 is SmolLM-135M's, 32 its SMOKE size's: the two the kernels
# dispatch
@pytest.mark.parametrize("D", [32, 64])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("holes,window,layout", [
    (False, None, "packed"), (True, 200, "packed"), (True, None, "padded")])
def test_cuda_decode_kernel_matches_plain(cuda, dtype, holes, window,
                                          layout, D):
    q, kp, vp, items, table, pos = (t.to(cuda) for t in as_torch(
        *decode_case(5, D=D, holes=holes, layout=layout)))
    q = q.reshape(3, 2, 3, D).to(dtype)
    kp, vp = kp.to(dtype), vp.to(dtype)
    before = flash_decode_paged_kernel.launches
    got = flash_decode_paged_kernel(q, kp, vp, items, table, pos,
                                    block_kv=BLK, window=window)
    assert flash_decode_paged_kernel.launches == before + 1
    want = packed_decode_attention_paged(q, kp, vp, items, table, pos,
                                         block_kv=BLK, window=window)
    for g, w in zip(got, want):     # f32 sums in another order
        torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("D", [32, 64])
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 2.0 ** -6)])
def test_cuda_prefill_kernel_matches_plain(cuda, dtype, atol, D):
    q, kp, vp, items, table = (t.to(cuda) for t in as_torch(
        *prefill_case(6, D=D, hole=True)))
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


@pytest.mark.parametrize("D", [32, 64])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("window,layout", [
    (None, "packed"), (200, "packed"), (None, "padded")])
def test_cuda_contiguous_decode_kernel_matches_plain(cuda, dtype, window,
                                                     layout, D):
    q, kp, vp, items, table, pos = decode_case(8, D=D, layout=layout)
    kc, vc = as_slot_cache(kp, table), as_slot_cache(vp, table)
    q, kc, vc, items, pos = (t.to(cuda) for t in as_torch(
        q, kc, vc, items, pos))
    q = q.reshape(3, 2, 3, D).to(dtype)
    kc, vc = kc.to(dtype), vc.to(dtype)
    before = flash_decode_kernel.launches
    got = flash_decode_kernel(q, kc, vc, items, pos, block_kv=BLK,
                              window=window)
    assert flash_decode_kernel.launches == before + 1
    want = packed_decode_attention(q, kc, vc, items, pos, block_kv=BLK,
                                   window=window)
    for g, w in zip(got, want):     # f32 sums in another order
        torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-5)


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


@pytest.mark.parametrize("D", [32, 64])
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 2.0 ** -6)])
def test_cuda_contiguous_prefill_kernel_matches_plain(cuda, dtype, atol, D):
    q, kp, vp, items, table = prefill_case(10, D=D)
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


@pytest.mark.parametrize("D", [32, 64])
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 2.0 ** -6)])
@pytest.mark.parametrize("causal,sq,skv", [
    (True, 384, 384), (False, 384, 384), (True, 200, 330),
    (False, 330, 200)])
def test_cuda_flash_attention_matches_plain(cuda, dtype, atol, causal, sq,
                                            skv, D):
    rng = np.random.default_rng(11)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to(cuda, dtype) for s in ((6, sq, D), (2, skv, D),
                                          (2, skv, D)))
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal)
    assert flash_attention.launches == before + 1
    want = flash_attention_reference(q, k, v, causal=causal)
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)


@pytest.mark.parametrize("D", [32, 64])
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 2.0 ** -6)])
def test_cuda_sparse_decode_matches_plain(cuda, dtype, atol, D):
    rng = np.random.default_rng(12)
    B, Hkv, G, S, cache_len = 3, 2, 3, 4 * BLK, 3 * BLK + 17
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
