"""The legacy budgeted decode (TPU kernel #5) as the port's split algebra.

The CUDA kernel (``csrc/sparse_decode.cu``) splits each run across CTAs,
one item a CTA, and merges the items' partials in item order by the
``merge_partials`` algebra; its plain version
(``kernels.sparse_decode.sparse_decode_reference``) runs the same split
algebra under the legacy run rule (a run starts on ``valid & first`` and
ends on ``valid & last``).  These tests hold, on numpy-seeded inputs:

- the split plain version against the reference's Pallas kernel in
  interpret mode (``repro.kernels.ops.sparse_decode``) within ``TOL`` =
  1e-5 (float32: the same tiles and masks, sums taken in another order):
  runs of 1-20 tiles, G 3 and 8, head_dim 32 / 64 / 128 / 256, an
  uncovered (row, kv head) pair (zero in the port; the Pallas kernel
  leaves it unwritten, so it is not compared), ``cache_len`` not a
  multiple of ``block_kv`` (a partly and a wholly masked tile), the
  table's trailing pads, and invalid ``first`` / ``last`` / plain items
  inside runs; and on a table of corners (invalid flags, a run cut short,
  an orphan valid ``last``, pads), the pairs that both write;
- the legacy run rule of ``decode_runs`` against a direct per-item scan
  (the CUDA kernel's ``split_of``: back to the run's start, forward to its
  end) on tables with invalid ``first`` or ``last`` items.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels import ops as ref_ops
from repro_torch.core import worklist as wl
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import ops

torch.set_num_threads(1)

BLK = 16          # small tiles: runs of 20 tiles stay cheap on the CPU
TOL = 1e-5
# (row, kv head) -> selected blocks: 1, 20, none, 13, 7 and 4 tiles; the
# last run holds the partly masked block 23 and the wholly masked block 24
# of cache_len 370 (23 blocks and 2 keys)
NBLK, CACHE_LEN = 25, 370
SIZES = ((1, 20, 0), (13, 7, 4))


def _case(seed, G, D, flags):
    """q, slot caches and the legacy item table of ``SIZES`` on one device
    (padded to a multiple of 8 by pads), with ``flags`` some items inside
    the 20-tile run marked invalid: one plain, one ``first`` and one
    ``last``, none of which starts, ends or adds to the run."""
    rng = np.random.default_rng(seed)
    B, Hkv = len(SIZES), len(SIZES[0])
    q = rng.standard_normal((B, Hkv, G, D)).astype(np.float32)
    kc, vc = (rng.standard_normal((B, Hkv, NBLK * BLK, D)).astype(np.float32)
              for _ in range(2))
    sels = [[np.sort(rng.choice(NBLK - 2, size=n, replace=False))
             for n in row] for row in SIZES]
    sels[1][2] = np.array([0, 5, NBLK - 2, NBLK - 1])
    items = ops.build_decode_worklist(sels, num_devices=1,
                                      kv_heads_per_device=Hkv,
                                      block=BLK).items[0]
    assert len(items) % 8 == 0 and items[-1, wl.D_VALID] == 0   # pads
    if flags:
        start = 1                                    # the 20-tile run
        for off, field in ((3, None), (7, wl.D_FIRST), (12, wl.D_LAST)):
            items[start + off, wl.D_VALID] = 0
            if field is not None:
                items[start + off, field] = 1
    return q, kc, vc, items


@pytest.mark.parametrize("flags", [False, True])
@pytest.mark.parametrize("D", [32, 64, 128, 256])
@pytest.mark.parametrize("G", [3, 8])
def test_legacy_split_matches_pallas_kernel(G, D, flags):
    q, kc, vc, items = _case(G + D, G, D, flags)
    want = np.asarray(ref_ops.sparse_decode(
        *map(jnp.asarray, (q, kc, vc, items)), cache_len=CACHE_LEN,
        block_kv=BLK, interpret=True))
    got = ops.sparse_decode(*(torch.from_numpy(a) for a in
                              (q, kc, vc, items)), cache_len=CACHE_LEN,
                            block_kv=BLK)
    assert got.shape == q.shape and got.dtype == torch.float32
    covered = np.array([[n > 0 for n in row] for row in SIZES])
    np.testing.assert_allclose(got.numpy()[covered], want[covered],
                               atol=TOL, rtol=TOL)
    assert not got.numpy()[~covered].any()
    runs = fd.decode_runs(items.tolist(), legacy=True)
    assert sorted(last - first + 1 for first, last in runs) == [
        1, 4, 7, 13, 20]


def _kernel_run_of(rows, i, legacy):
    """The run of item ``i`` as the CUDA kernels find it (``split_of``):
    back to the nearest start (not past an end), forward to the nearest
    end (not past a start); None outside a run that finalizes."""
    def counts(r):
        return not legacy or r[wl.D_VALID] == 1

    def starts(j):
        return rows[j][wl.D_FIRST] == 1 and counts(rows[j])

    def ends(j):
        return rows[j][wl.D_LAST] == 1 and counts(rows[j])

    back = next((t for t in range(i + 1)
                 if starts(i - t) or (t > 0 and ends(i - t))), None)
    if back is None or (back > 0 and ends(i - back)):
        return None
    fwd = next((t for t in range(len(rows) - i)
                if ends(i + t) or (t > 0 and starts(i + t))), None)
    if fwd is None or (fwd > 0 and starts(i + fwd)):
        return None
    return i - back, i + fwd


def _flag_table(seed, L=48):
    """Random (first, last, valid) flags: many items are invalid, among
    them ``first`` and ``last`` ones, with runs cut short, orphan ends and
    pads."""
    rng = np.random.default_rng(seed)
    rows = np.zeros((L, wl.DEC_FIELDS), np.int32)
    rows[:, wl.D_KVBLK] = np.arange(L)
    rows[:, wl.D_FIRST] = rng.random(L) < 0.3
    rows[:, wl.D_LAST] = rng.random(L) < 0.3
    rows[:, wl.D_VALID] = rng.random(L) < 0.7
    return rows


# (first, last, valid) rows: an invalid first inside a run, an invalid
# last, a run cut short by a valid first, an orphan valid last, pads
CORNERS = np.array([
    [1, 0, 1], [1, 0, 0], [0, 1, 0], [0, 1, 1],     # run (0, 3)
    [1, 1, 0], [0, 1, 1],                            # orphan valid last
    [1, 0, 1], [0, 0, 1], [1, 0, 1], [0, 1, 1],      # cut at 8; run (8, 9)
    [0, 0, 0], [0, 0, 0],                            # pads
    [1, 1, 1],                                       # one-item run
    [1, 0, 1], [0, 0, 1],                            # never ends
], np.int32)


@pytest.mark.parametrize("legacy", [True, False])
@pytest.mark.parametrize("seed", [None, 0, 1, 2, 3])
def test_decode_runs_match_the_kernels_scan(seed, legacy):
    if seed is None:
        rows = np.zeros((len(CORNERS), wl.DEC_FIELDS), np.int32)
        rows[:, [wl.D_FIRST, wl.D_LAST, wl.D_VALID]] = CORNERS
    else:
        rows = _flag_table(seed)
    rows = rows.tolist()
    runs = fd.decode_runs(rows, legacy=legacy)
    of = [_kernel_run_of(rows, i, legacy) for i in range(len(rows))]
    assert runs == sorted({r for r in of if r is not None})
    for first, last in runs:
        assert of[first:last + 1] == [(first, last)] * (last - first + 1)
    assert sum(r is not None for r in of) == sum(
        last - first + 1 for first, last in runs)
    if seed is None and legacy:
        assert runs == [(0, 3), (8, 9), (12, 12)]


def _corner_items():
    """The corner table as legacy items, each item its own (row, kv head)
    pair's block 0 except inside a run, which is one pair over blocks 0, 1,
    ...; and its runs."""
    items = np.zeros((len(CORNERS), wl.DEC_FIELDS), np.int32)
    items[:, [wl.D_FIRST, wl.D_LAST, wl.D_VALID]] = CORNERS
    items[:, wl.D_BATCH] = np.arange(len(CORNERS))
    runs = fd.decode_runs(items.tolist(), legacy=True)
    for first, last in runs:          # a run is one (row, kv head)
        items[first:last + 1, wl.D_BATCH] = first
        items[first:last + 1, wl.D_KVBLK] = np.arange(last - first + 1)
    return items, runs


def test_legacy_split_writes_only_its_runs():
    """The corner table: only the runs' pairs are written, each with its
    run's tiles."""
    rng = np.random.default_rng(7)
    L, G, D = len(CORNERS), 2, 32
    items, runs = _corner_items()
    q = torch.from_numpy(rng.standard_normal((L, 1, G, D)).astype(np.float32))
    kc, vc = (torch.from_numpy(rng.standard_normal((L, 1, 4 * 8, D)).astype(
        np.float32)) for _ in range(2))
    out = ops.sparse_decode(q, kc, vc, torch.from_numpy(items),
                            cache_len=4 * 8, block_kv=8)
    written = sorted(int(b) for b in torch.nonzero(out.abs().sum((1, 2, 3))))
    assert written == [first for first, _ in runs]


ORPHAN_LAST = 5     # CORNERS' valid ``last`` after the finished run (0, 3)


@pytest.mark.parametrize("G", [3, 8])
def test_legacy_split_corners_match_pallas_kernel(G):
    """The corner table against the Pallas kernel in interpret mode, at a
    ``cache_len`` that masks part of run (0, 3)'s last tile: the pairs
    that both write (the runs') agree within ``TOL``.  At the orphan valid
    ``last`` the Pallas kernel finalizes the state carried from the run
    before and the port writes nothing (a departure, ``ROADMAP.md`` §3);
    the other pairs the Pallas kernel leaves unwritten."""
    rng = np.random.default_rng(G)
    L, D = len(CORNERS), 64
    items, runs = _corner_items()
    q = rng.standard_normal((L, 1, G, D)).astype(np.float32)
    kc, vc = (rng.standard_normal((L, 1, 4 * 8, D)).astype(np.float32)
              for _ in range(2))
    want = np.asarray(ref_ops.sparse_decode(
        *map(jnp.asarray, (q, kc, vc, items)), cache_len=30, block_kv=8,
        interpret=True))
    got = ops.sparse_decode(*(torch.from_numpy(a) for a in
                              (q, kc, vc, items)), cache_len=30,
                            block_kv=8).numpy()
    ran = [first for first, _ in runs]
    assert ran == [0, 8, 12]
    np.testing.assert_allclose(got[ran], want[ran], atol=TOL, rtol=TOL)
    assert not np.delete(got, ran, axis=0).any()
    assert np.isfinite(want[ORPHAN_LAST]).all()
