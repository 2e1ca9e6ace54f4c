"""The port's slot-cache decode (TPU kernel #3), the per-slot block-id forms
of both decode layouts and the contiguous sparse prefill, against the JAX
reference.

On the CPU each wrapper runs its plain PyTorch version; these tests hold
it against the reference on the same numpy-seeded inputs: the jnp twins
(``flash_decode_reference``, ``packed_decode_attention``,
``flash_decode_paged_reference``, ``worklist_attention``) within 1e-5, and
the Pallas kernels in interpret mode within 1e-5 (float32: the same tiles
and masks, sums taken in another order).  The CUDA kernels are held
against these plain versions on the card by ``test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.attention.worklist_jnp import worklist_attention as ref_wa
from repro.kernels import ops as ref_ops
from repro.kernels.flash_decode import (
    decode_items_from_ids as ref_items_from_ids)
from repro_torch.core import worklist as wl
from repro_torch.kernels import ops
from repro_torch.kernels.flash_decode import (
    decode_items_from_ids, flash_decode_kernel)
from repro_torch.kernels.sparse_prefill import sparse_prefill_attention
from test_torch_cuda import as_slot_cache, as_torch, decode_case, prefill_case

torch.set_num_threads(1)

BLK = 128
TOL = 1e-5


def _close(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL,
                                   rtol=TOL)


@pytest.mark.parametrize("seed,empty_row", [(0, False), (1, True),
                                            (2, False)])
def test_decode_items_from_ids_equal_reference(seed, empty_row):
    rng = np.random.default_rng(seed)
    ids = rng.integers(-1, 9, size=(3, 2, 5)).astype(np.int32)
    ids = -np.sort(-ids, axis=-1)          # -1 pads trail
    if empty_row:
        ids[1, 0] = -1                     # an empty selection
    got = decode_items_from_ids(torch.from_numpy(ids))
    want = np.asarray(ref_items_from_ids(jnp.asarray(ids)))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(got.numpy(), wl.padded_decode_items(ids))


def _slot_case(seed, layout):
    q, kp, vp, sel, table, pos = decode_case(seed, layout=layout)
    return q, as_slot_cache(kp, table), as_slot_cache(vp, table), sel, pos


@pytest.mark.parametrize("seed,window", [(0, None), (1, 200), (2, 300)])
def test_contiguous_decode_ids_form_matches_reference(seed, window):
    """``ops.flash_decode`` (ids -> padded items -> the slot-cache decode)
    against the jnp twin and the Pallas kernel in interpret mode."""
    q, kc, vc, ids, pos = _slot_case(seed, "ids")
    ids[0, 1] = -1                         # an empty (row, head) selection
    got = ops.flash_decode(*as_torch(q, kc, vc, ids, pos), block_kv=BLK,
                           window=window, partials=True)
    args = [jnp.asarray(a) for a in (q, kc, vc, ids, pos)]
    for use_kernel in (False, True):
        _close(got, ref_ops.flash_decode(
            *args, block_kv=BLK, window=window, partials=True,
            use_kernel=use_kernel, interpret=True))
    assert not got[0][0, 3:6].any()        # row 0, kv head 1: out 0
    assert (got[1][0, 1] == -1e30).all() and not got[2][0, 1].any()


@pytest.mark.parametrize("seed,window,pad", [(3, None, 8), (4, 250, 0),
                                             (5, None, 24)])
def test_contiguous_decode_packed_matches_reference(seed, window, pad):
    """``ops.flash_decode_packed`` over cost-packed items (with replicate-
    last padding rows) against the jnp twin and the Pallas kernel."""
    q, kp, vp, items, table, pos = decode_case(seed, pad=pad)
    kc, vc = as_slot_cache(kp, table), as_slot_cache(vp, table)
    got = ops.flash_decode_packed(*as_torch(q, kc, vc, items, pos),
                                  block_kv=BLK, window=window, partials=True)
    args = [jnp.asarray(a) for a in (q, kc, vc, items, pos)]
    for use_kernel in (False, True):
        _close(got, ref_ops.flash_decode_packed(
            *args, block_kv=BLK, window=window, partials=True,
            use_kernel=use_kernel, interpret=True))


@pytest.mark.parametrize("seed,holes,window", [(6, False, None),
                                               (7, True, 200)])
def test_paged_decode_ids_form_matches_reference(seed, holes, window):
    """``ops.flash_decode_paged`` (ids -> padded items -> the pool decode)
    against ``flash_decode_paged_reference`` and the Pallas kernel."""
    q, kp, vp, ids, table, pos = decode_case(seed, holes=holes,
                                             layout="ids")
    got = ops.flash_decode_paged(*as_torch(q, kp, vp, ids, table, pos),
                                 block_kv=BLK, window=window, partials=True)
    args = [jnp.asarray(a) for a in (q, kp, vp, ids, table, pos)]
    for use_kernel in (False, True):
        _close(got, ref_ops.flash_decode_paged(
            *args, block_kv=BLK, window=window, partials=True,
            use_kernel=use_kernel, interpret=True))


def test_decode_layouts_and_forms_agree_bitwise():
    """Inside the port, the slot cache and the pool holding the same values
    give the same bits, and so do the packed and padded tables of one
    selection (the reference's paged == contiguous and packed == padded)."""
    q, kp, vp, ids, table, pos = decode_case(8, layout="ids")
    kc, vc = as_slot_cache(kp, table), as_slot_cache(vp, table)
    packed = wl.pack_decode_items(ids, num_shards=2, block=BLK)
    items = wl.extend_packed_items(packed.items, packed.padded_length + 8)
    items = items.reshape(-1, wl.DEC_FIELDS)
    q, kp, vp, kc, vc, ids, items, table, pos = as_torch(
        q, kp, vp, kc, vc, ids, items, table, pos)
    outs = [ops.flash_decode(q, kc, vc, ids, pos, partials=True),
            ops.flash_decode_packed(q, kc, vc, items, pos, partials=True),
            ops.flash_decode_paged(q, kp, vp, ids, table, pos,
                                   partials=True),
            ops.flash_decode_packed_paged(q, kp, vp, items, table, pos,
                                          partials=True)]
    for other in outs[1:]:
        for a, b in zip(outs[0], other):
            assert torch.equal(a, b)


@pytest.mark.parametrize("seed,q_offset,kv_len", [
    (0, 0, 200), (1, 256, 456), (2, 384, 640)])
def test_contiguous_prefill_matches_reference_scan(seed, q_offset, kv_len):
    """The contiguous sparse prefill, in place over ``[Hkv, Skv, D]`` with
    the chunk's ``q_offset`` / ``kv_len``, against ``worklist_attention``;
    and equal to the paged form over a pool holding the same values."""
    q, kp, vp, items, table = prefill_case(seed, q_offset=q_offset)
    kc = as_slot_cache(kp, table[None])[0]
    vc = as_slot_cache(vp, table[None])[0]
    got = sparse_prefill_attention(*as_torch(q, kc, vc, items),
                                   q_offset=q_offset, kv_len=kv_len)
    want = ref_wa(*map(jnp.asarray, (q, kc, vc, items)), block_q=BLK,
                  block_kv=BLK, q_offset=q_offset, kv_len=kv_len)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)
    paged = ops.sparse_prefill(*as_torch(q, kp, vp, items, table),
                               q_offset=q_offset, kv_len=kv_len)
    assert torch.equal(got, paged)


@pytest.mark.parametrize("seed,S", [(3, 200), (4, 384)])
def test_contiguous_prefill_ragged_matches_pallas_kernel(seed, S):
    """At q_offset 0 the contiguous form is the TPU kernel's own signature:
    against the Pallas kernel in interpret mode, Skv ragged or whole."""
    rng = np.random.default_rng(seed)
    H, Hkv, D = 4, 2, 32
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((H, S, D), (Hkv, S, D), (Hkv, S, D)))
    nq = -(-S // BLK)
    sels = [np.arange(max(0, qb - h), qb + 1) for h in range(H)
            for qb in range(nq)]
    sels = [sels[h * nq:(h + 1) * nq] for h in range(H)]
    full = wl.build_worklist(sels, np.zeros(H, np.int64), 1, nq, nq, BLK,
                             kv_head_of_head=np.arange(H) // 2)
    items = full.items[0]
    want = np.asarray(ref_ops.sparse_prefill(
        *map(jnp.asarray, (q, k, v, items)), interpret=True))
    got = sparse_prefill_attention(*as_torch(q, k, v, items)).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_slot_wrappers_refuse_what_the_kernels_do_not_take():
    q, kc, vc, items, pos = (torch.from_numpy(a) for a in
                             _slot_case(0, "packed"))
    q = q.reshape(3, 2, 3, 32)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        flash_decode_kernel(*(t.to("meta") for t in (q, kc, vc, items, pos)))
    with pytest.raises(ValueError, match="int32"):
        flash_decode_kernel(q, kc, vc, items.long(), pos)
    with pytest.raises(ValueError, match="does not match"):
        flash_decode_kernel(q, kc[:, :1].contiguous(), vc[:, :1].contiguous(),
                            items, pos)
    with pytest.raises(ValueError, match="whole 128-row blocks"):
        flash_decode_kernel(q, kc[:, :, :200].contiguous(),
                            vc[:, :, :200].contiguous(), items, pos)
    pq, kp, vp, pitems, table = prefill_case(0)
    kc, vc = (as_slot_cache(t, table[None])[0] for t in (kp, vp))
    with pytest.raises(ValueError, match="CPU or CUDA"):
        sparse_prefill_attention(*(t.to("meta") for t in as_torch(
            pq, kc, vc, pitems)))
    with pytest.raises(ValueError, match="K/V must be"):
        sparse_prefill_attention(*as_torch(pq, kp, vp, pitems))
