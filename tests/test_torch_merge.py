"""The port's ``merge_partials`` and the flash decode's split plain version
against the JAX reference.

The CUDA decode kernels (#1 paged, #3 contiguous) cut each run into splits
of ``flash_decode.SPLIT_TILES`` items and merge the splits' partials in
item order by the reference's ``merge_partials`` algebra; their plain
versions run the same split algebra on the CPU.  These tests hold, on the
same numpy-seeded inputs:

- ``merge_partials`` against the reference's within 1e-5 (float32: the
  same algebra, sums taken in shard order here), its single-shard result
  bitwise, and an all-masked merge as zeros without NaN;
- the split plain decode at 1, 2 and 3 tiles per split, over runs of 1-20
  tiles with windows, unmapped table entries and bucket pads, against the
  reference's jnp twins ``flash_decode_paged_reference`` /
  ``flash_decode_reference`` within ``TOL`` of ``test_torch_kernels.py``;
- packed and padded item tables, and paged and contiguous caches, bit for
  bit under the split plain version.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels.flash_decode import (
    flash_decode_paged_reference as ref_paged,
    flash_decode_reference as ref_contig, merge_partials as ref_merge)
from repro_torch.core import worklist as wl
from repro_torch.kernels import flash_decode as fd
from test_torch_cuda import as_slot_cache, as_torch
from test_torch_kernels import TOL

torch.set_num_threads(1)

BLK = 16           # small tiles: runs of 20 tiles stay cheap on the CPU
NEG_INF = -1e30


def _partials(seed, S, masked=(), inf_masked=(), shape=(3, 2)):
    """Random shard partials ``outs [S, *shape, D]``, ``ms`` / ``ls [S,
    *shape]``; the shards in ``masked`` (m -1e30) and ``inf_masked`` (m
    -inf) are fully masked, l 0 and out 0, at every position."""
    rng = np.random.default_rng(seed)
    outs = rng.standard_normal((S, *shape, 8)).astype(np.float32)
    ms = rng.uniform(-3.0, 3.0, size=(S, *shape)).astype(np.float32)
    ls = rng.uniform(0.5, 40.0, size=(S, *shape)).astype(np.float32)
    for s, m in [(s, NEG_INF) for s in masked] + [
            (s, -np.inf) for s in inf_masked]:
        outs[s], ms[s], ls[s] = 0.0, m, 0.0
    return outs, ms, ls


@pytest.mark.parametrize("S,masked,inf_masked", [
    (2, (), ()), (5, (1,), (3,)), (7, (0, 6), (2, 3)), (4, (3,), ())])
def test_merge_partials_matches_reference(S, masked, inf_masked):
    outs, ms, ls = _partials(S, S, masked, inf_masked)
    want = np.asarray(ref_merge(*map(jnp.asarray,
                                                  (outs, ms, ls))))
    out, m, l = fd.merge_partials(*as_torch(outs, ms, ls))
    np.testing.assert_allclose(out.numpy(), want, atol=TOL, rtol=TOL)
    real = ls > 0
    gm = np.where(real, ms, NEG_INF).max(axis=0)
    w = np.where(real, np.exp(ms - gm), 0.0) * ls
    np.testing.assert_array_equal(m.numpy(), gm)      # a max: exact
    np.testing.assert_allclose(l.numpy(), w.sum(axis=0), rtol=TOL)


@pytest.mark.parametrize("S,real", [(1, 0), (3, 1), (6, 5), (6, 0)])
def test_merge_partials_single_real_shard_bitwise(S, real):
    """At most one real shard: its out, m and l come back bitwise, as the
    reference's out does; the masked shards carry -1e30 or -inf."""
    others = [s for s in range(S) if s != real]
    outs, ms, ls = _partials(10 + S, S, others[::2], others[1::2])
    want = np.asarray(ref_merge(*map(jnp.asarray,
                                                  (outs, ms, ls))))
    out, m, l = fd.merge_partials(*as_torch(outs, ms, ls))
    assert np.array_equal(out.numpy(), outs[real])
    assert np.array_equal(want, outs[real])
    assert np.array_equal(m.numpy(), ms[real])
    assert np.array_equal(l.numpy(), ls[real])


@pytest.mark.parametrize("S", [1, 4])
def test_merge_partials_all_masked_is_zero(S):
    outs, ms, ls = _partials(20 + S, S, range(0, S, 2), range(1, S, 2))
    out, m, l = fd.merge_partials(*as_torch(outs, ms, ls))
    want = np.asarray(ref_merge(*map(jnp.asarray,
                                                  (outs, ms, ls))))
    assert not out.isnan().any() and not out.any() and not want.any()
    assert bool((m == NEG_INF).all()) and not l.any()


def _long_runs_case(seed, holes):
    """Two rows of 24 logical blocks (positions 383 and 300: the second
    row's newest block partly masked), 2 kv heads, G = 2, head_dim 16:
    per-(row, kv head) selections of 1 to 20 blocks, sorted, -1 padded;
    with ``holes`` two mapped blocks of the selections are -1 in the
    table."""
    rng = np.random.default_rng(seed)
    B, Hkv, G, D, T = 2, 2, 2, 16, 24
    N = B * T + 1
    q = rng.standard_normal((B, Hkv, G, D)).astype(np.float32)
    kp, vp = (rng.standard_normal((N, Hkv, BLK, D)).astype(np.float32)
              for _ in range(2))
    pos = np.array([383, 300], np.int32)
    table = rng.permutation(N - 1)[:B * T].reshape(B, T).astype(np.int32)
    counts = np.array([[1, 20], [13, 7]])
    ids = np.full((B, Hkv, 20), -1, np.int32)
    for b in range(B):
        nb = int(pos[b]) // BLK + 1
        for h in range(Hkv):
            n = counts[b, h]
            ids[b, h, :n] = np.sort(rng.choice(nb, size=n, replace=False))
    if holes:
        table[0, ids[0, 1, 3]] = -1
        table[1, ids[1, 0, 0]] = -1
    return q, kp, vp, ids, table, pos


def _packed_with_pads(ids):
    """The cost-packed items of ``ids`` on two shards, each padded out by
    bucket pads (``extend_packed_items``: first = last = valid = 0)."""
    packed = wl.pack_decode_items(ids, num_shards=2, block=BLK)
    items = wl.extend_packed_items(packed.items, packed.padded_length + 5)
    return items.reshape(-1, wl.DEC_FIELDS)


@pytest.mark.parametrize("split", [1, 2, 3])
@pytest.mark.parametrize("window,holes", [(None, False), (100, False),
                                          (None, True), (150, True)])
def test_split_paged_decode_matches_reference(monkeypatch, split, window,
                                              holes):
    """Padded (from ids) and packed (with bucket pads) tables over the pool
    against the reference's ``flash_decode_paged_reference``."""
    monkeypatch.setattr(fd, "SPLIT_TILES", split)
    q, kp, vp, ids, table, pos = _long_runs_case(split, holes)
    kw = dict(block_kv=BLK, window=window)
    want = ref_paged(
        *map(jnp.asarray, (q, kp, vp, ids, table, pos)), **kw)
    tq, tk, tv, tids, ttb, tpos = as_torch(q, kp, vp, ids, table, pos)
    padded = fd.flash_decode_paged_reference(tq, tk, tv, tids, ttb, tpos,
                                             **kw)
    packed = fd.flash_decode_paged_kernel(
        tq, tk, tv, torch.from_numpy(_packed_with_pads(ids)), ttb, tpos,
        **kw)
    for g, w in zip(padded, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL,
                                   rtol=TOL)
    for a, b in zip(packed, padded):
        assert torch.equal(a, b), "packed == padded, bit for bit"


@pytest.mark.parametrize("split", [1, 2, 3])
@pytest.mark.parametrize("window", [None, 200])
def test_split_contiguous_decode_matches_reference_and_paged(
        monkeypatch, split, window):
    """The slot cache holding the pool's blocks: against the reference's
    ``flash_decode_reference``, and bit for bit the paged result, from
    padded and from packed tables."""
    monkeypatch.setattr(fd, "SPLIT_TILES", split)
    q, kp, vp, ids, table, pos = _long_runs_case(10 + split, False)
    kc, vc = as_slot_cache(kp, table), as_slot_cache(vp, table)
    kw = dict(block_kv=BLK, window=window)
    want = ref_contig(
        *map(jnp.asarray, (q, kc, vc, ids, pos)), **kw)
    tq, tkp, tvp, tkc, tvc, tids, ttb, tpos, items = as_torch(
        q, kp, vp, kc, vc, ids, table, pos, _packed_with_pads(ids))
    got = fd.flash_decode_reference(tq, tkc, tvc, tids, tpos, **kw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL,
                                   rtol=TOL)
    others = (fd.flash_decode_paged_reference(tq, tkp, tvp, tids, ttb, tpos,
                                              **kw),
              fd.flash_decode_kernel(tq, tkc, tvc, items, tpos, **kw),
              fd.flash_decode_paged_kernel(tq, tkp, tvp, items, ttb, tpos,
                                           **kw))
    for other in others:
        for a, b in zip(got, other):
            assert torch.equal(a, b), "paged == contiguous, packed == padded"


@pytest.mark.parametrize("split", [1, 2, 3])
def test_split_decode_runs_and_scan_order(monkeypatch, split):
    """The split result against the reference-order scan (``decode_scan``,
    one running state per run) within ``TOL``; a run of at most
    ``split`` tiles gives the scan's bits; runs cut short by a new
    ``first`` and items after a ``last`` (pads) write nothing."""
    monkeypatch.setattr(fd, "SPLIT_TILES", split)
    q, kp, vp, ids, table, pos = _long_runs_case(30 + split, False)
    items = _packed_with_pads(ids)
    rows = items.tolist()
    assert fd.decode_runs(rows) == [
        (f, j) for f, j in zip(np.flatnonzero(items[:, wl.D_FIRST]),
                               np.flatnonzero(items[:, wl.D_LAST]))]
    tq, tk, tv, titems, ttb, tpos = as_torch(q, kp, vp, items, table, pos)
    tile = lambda b, h, blk: (  # noqa: E731
        None if table[b, blk] < 0 else
        (tk[table[b, blk], h], tv[table[b, blk], h], None, None))
    kw = dict(block_kv=BLK, scale=16 ** -0.5)
    got = fd.split_decode_scan(tq, tile, titems, pos.tolist(), **kw)
    want = fd.decode_scan(tq, tile, titems, pos.tolist(), **kw)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=TOL, rtol=TOL)
    for f, last in fd.decode_runs(rows):
        if last - f < split:
            b, h = rows[f][wl.D_BATCH], rows[f][wl.D_KVHEAD]
            assert all(torch.equal(g[b, h], w[b, h])
                       for g, w in zip(got, want))
    # a run cut short by a new first, then an orphan last: neither writes
    cut = np.array([[0, 0, 0, 1, 0, 1], [0, 0, 1, 0, 0, 1],
                    [0, 1, 2, 1, 1, 1], [1, 0, 0, 0, 1, 1]], np.int32)
    assert fd.decode_runs(cut.tolist()) == [(2, 2)]
    out, m, l = fd.split_decode_scan(tq, tile, torch.from_numpy(cut),
                                     pos.tolist(), **kw)
    written = l > 0
    assert written[0, 1].all() and not written[0, 0].any()
    assert not written[1].any() and not out[1].any()
