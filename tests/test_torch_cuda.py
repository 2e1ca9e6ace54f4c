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
from repro_torch.kernels.flash_decode import (
    flash_decode_paged_kernel, packed_decode_attention_paged)
from repro_torch.kernels.sparse_prefill import (
    sparse_prefill_attention, sparse_prefill_paged, worklist_attention_paged)

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
    short runs end on an invalid row carrying ``last``; optional -1 table
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
    if layout == "padded":
        return q, kp, vp, wl.padded_decode_items(ids), table, pos
    packed = wl.pack_decode_items(ids, num_shards=2, block=BLK)
    items = wl.extend_packed_items(packed.items,
                                   packed.padded_length + pad)
    return q, kp, vp, items.reshape(-1, wl.DEC_FIELDS), table, pos


def as_torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


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
