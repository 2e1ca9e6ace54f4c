"""The port's two attention kernels against the JAX reference.

On the CPU each wrapper runs its plain PyTorch version; these tests hold
that version against the reference on the same numpy-seeded inputs: the
Pallas decode kernel in interpret mode, the jnp scan the reference's
chunked prefill runs, and the Pallas sparse-prefill kernel in interpret
mode.  Tolerance 2e-5 (float32): the same tiles and masks, sums taken in
another order.  The CUDA kernels are held against these plain versions on
the card by ``test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.attention.worklist_jnp import worklist_attention_paged as ref_wap
from repro.kernels import ops as ref_ops
from repro_torch.core import worklist as wl
from repro_torch.attention.policies import strided_policy
from repro_torch.kernels import build, ops
from repro_torch.kernels.flash_decode import flash_decode_paged_kernel
from repro_torch.kernels.sparse_prefill import (
    sparse_prefill_attention, sparse_prefill_paged)
from test_torch_cuda import as_torch, decode_case, prefill_case

torch.set_num_threads(1)

BLK = 128
TOL = 2e-5


@pytest.mark.parametrize("seed,holes,window,layout", [
    (0, False, None, "packed"), (1, True, None, "packed"),
    (2, False, 200, "packed"), (3, True, 300, "packed"),
    (4, True, None, "padded"), (5, False, 200, "padded")])
def test_decode_matches_pallas_kernel(seed, holes, window, layout):
    """Packed tables, and padded ones whose short runs finalize on an
    invalid ``last`` row."""
    q, kp, vp, items, table, pos = decode_case(seed, holes=holes,
                                               layout=layout)
    want = ref_ops.flash_decode_packed_paged(
        *map(jnp.asarray, (q, kp, vp, items, table, pos)), block_kv=BLK,
        window=window, partials=True, use_kernel=True, interpret=True)
    got = ops.flash_decode_packed_paged(
        *as_torch(q, kp, vp, items, table, pos), block_kv=BLK,
        window=window, partials=True)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL,
                                   rtol=TOL)


def test_decode_padding_rows_and_padded_table_are_inert():
    """Replicate-last padding rows change nothing, and the padded
    fixed-stride table (invalid rows carrying ``last``) gives the packed
    table's result bit for bit."""
    q, kp, vp, items, table, pos = decode_case(4, pad=0)
    outs = [ops.flash_decode_packed_paged(
        *as_torch(q, kp, vp, it, table, pos), block_kv=BLK)
        for it in (items, decode_case(4, pad=24)[3],
                   decode_case(4, layout="padded")[3])]
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])


@pytest.mark.parametrize("seed,q_offset,kv_len,hole", [
    (0, 0, 200, False),      # short kv_len inside the chunk
    (1, 256, 456, False),    # nonzero offset, partial last chunk
    (2, 384, 640, True),     # offset past a -1 table entry
])
def test_paged_prefill_matches_reference_scan(seed, q_offset, kv_len, hole):
    q, kp, vp, items, table = prefill_case(seed, q_offset=q_offset,
                                           hole=hole)
    want = ref_wap(*map(jnp.asarray, (q, kp, vp, items, table)),
                   block_q=BLK, block_kv=BLK, q_offset=q_offset,
                   kv_len=kv_len)
    got = ops.sparse_prefill(*as_torch(q, kp, vp, items, table),
                             block_q=BLK, block_kv=BLK, q_offset=q_offset,
                             kv_len=kv_len)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)
    assert not got[1, :BLK].any(), "uncovered (head, q_blk) rows are zero"


@pytest.mark.parametrize("seed,S", [(0, 256), (1, 384)])
def test_identity_table_prefill_matches_pallas_kernel(seed, S):
    rng = np.random.default_rng(seed)
    H, Hkv, D = 4, 2, 32
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((H, S, D), (Hkv, S, D), (Hkv, S, D)))
    nq = S // BLK
    sels = [strided_policy(h, 1 + h % 2, nq, nq) for h in range(H)]
    sels[3][1] = np.array([], np.int64)             # (head 3, q_blk 1) bare
    full = wl.build_worklist(sels, np.zeros(H, np.int64), 1, nq, nq, BLK,
                             kv_head_of_head=np.arange(H) // 2)
    items = full.items[0]
    want = np.asarray(ref_ops.sparse_prefill(
        *map(jnp.asarray, (q, k, v, items)), interpret=True))
    got = sparse_prefill_attention(*as_torch(q, k, v, items)).numpy()
    covered = np.ones((H, S), bool)
    covered[3, BLK:2 * BLK] = False     # Pallas leaves uncovered tiles unset
    np.testing.assert_allclose(got[covered], want[covered], atol=TOL,
                               rtol=TOL)
    assert not got[~covered].any()


def test_wrappers_refuse_devices_without_a_kernel():
    """A tensor that is neither on the CPU nor on CUDA raises: the plain
    version runs only for CPU tensors."""
    q, kp, vp, items, table, pos = (t.to("meta") for t in as_torch(
        *decode_case(0)))
    with pytest.raises(ValueError, match="CPU or CUDA"):
        flash_decode_paged_kernel(q.reshape(3, 2, 3, 32), kp, vp, items,
                                  table, pos, block_kv=BLK)
    q, kp, vp, items, table = (t.to("meta") for t in as_torch(
        *prefill_case(0)))
    with pytest.raises(ValueError, match="CPU or CUDA"):
        sparse_prefill_paged(q, kp, vp, items, table)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.nvcc()
