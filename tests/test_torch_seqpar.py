"""Sequence stripes (§2.11) in the port: the paged pool split into
``seq_shards`` stripes of block ids, one partial pass of the paged decode a
stripe, partials merged.  Held against the JAX reference at SMOKE sizes in
float32:

- ``best_partition_2d`` / ``lpt_bound_2d`` give the reference's device_of
  and loads, and at one stripe ``best_partition``'s; the reference's
  ``refine_partition_2d`` does not share ``refine_partition``'s stale
  busiest-device fault (``ROADMAP.md`` §3);
- ``pack_decode_items_2d`` gives the reference's items, lengths and
  per-axis imbalances, with and without ``phys_of_block``;
- the striped ``BlockAllocator`` routes, frees and swaps blocks as the
  reference's does, and its audit finds a foreign id in a stripe's list;
- ``_merge_stripe_partials`` matches the reference within 1e-6, a fully
  masked stripe included;
- ``Engine.serve`` at S = 2 and 4 (packed, padded, dense), at D = 2 x S =
  2, on Gemma3-1B's windowed layers, across a mid-run head move and
  across preempt -> swap -> resume: the JAX engine's greedy tokens and
  ``decode_bubble_stats``, and inside the port the unstriped serve's
  tokens;
- the contiguous layout refuses stripes, the pool rounds up to a stripe
  multiple, and the launcher's ``--seq-shards`` reaches the engine.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs.gemma3_1b import SMOKE as REF_GEMMA
from repro.core import partition as ref_part
from repro.core import worklist as ref_wl
from repro.models import transformer as ref_tfm
from repro.serving import Engine as RefEngine
from repro.serving import EngineConfig as RefEngineConfig
from repro.serving import SamplingParams as RefSamplingParams
from repro.serving import kv_cache as ref_kv
from repro.serving import scheduler as ref_sched
from repro_torch.configs import get_config
from repro_torch.core import partition, worklist
from repro_torch.core.sparsity import synthetic_head_curves
from repro_torch.launch import serve as launch_serve
from repro_torch.models import transformer as tfm
from repro_torch.serving import Engine, EngineConfig, SamplingParams
from repro_torch.serving import kv_cache, scheduler
from repro_torch.weights import params_from_jax
from test_torch_head_parallel import (
    FULL_BUDGET, GlobalIdEngine, model, port_engine, ref_engine)
from test_torch_preemption import drive_interrupt
from test_torch_replan import _force_at, _swap_shards

torch.set_num_threads(1)

NAME = "h8kv4"                 # 8 heads over 4 KV heads, 2 layers, f32
MAX_TOKENS = 12


# -- core: the 2D partitioner and packer ------------------------------------

def _weights_2d(seed, n, ds):
    rng = np.random.default_rng(seed)
    w = rng.integers(0, 40, size=(n, ds))
    w[np.arange(n), rng.integers(0, ds, size=n)] += 1   # no all-zero row
    return w


@pytest.mark.parametrize("dm,ds", [(1, 2), (2, 2), (2, 3), (4, 2), (3, 4)])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_best_partition_2d_equals_reference(dm, ds, seed):
    w = _weights_2d(seed, 17, ds)
    got = partition.best_partition_2d(w, dm)
    want = ref_part.best_partition_2d(w, dm)
    np.testing.assert_array_equal(got.device_of, want.device_of)
    np.testing.assert_array_equal(got.loads, want.loads)
    assert got.method == want.method
    assert (got.makespan, got.imbalance, got.model_imbalance,
            got.stripe_imbalance) == (want.makespan, want.imbalance,
                                      want.model_imbalance,
                                      want.stripe_imbalance)
    assert partition.lpt_bound_2d(w, dm) == ref_part.lpt_bound_2d(w, dm)
    assert got.makespan <= partition.lpt_bound_2d(w, dm)


@pytest.mark.parametrize("dm", [2, 3])
def test_best_partition_2d_at_one_stripe_is_best_partition(dm):
    w = _weights_2d(5, 13, 1)
    got = partition.best_partition_2d(w, dm)
    one = partition.best_partition(w[:, 0], dm)
    np.testing.assert_array_equal(got.device_of, one.device_of)
    np.testing.assert_array_equal(got.loads[:, 0], one.loads)
    assert got.method == one.method + "@seq1"


def test_refine_2d_has_no_stale_busiest_device_fault():
    """The reference's ``refine_partition`` raises on this instance (it
    keeps moving items of a device that is no longer the busiest;
    ``ROADMAP.md`` §3), and ``best_partition_2d`` inherits that at one
    stripe; the port's stops there.  ``refine_partition_2d`` accepts one
    move a round and re-derives the busiest shard, so it returns, on one
    stripe and on two, and the port's copy gives its result."""
    w1 = np.array([1, 1, 3, 13, 21, 23, 27, 29])
    with pytest.raises(ValueError):
        ref_part.best_partition(w1, 2)
    with pytest.raises(ValueError):
        ref_part.best_partition_2d(w1[:, None], 2)
    got = partition.best_partition_2d(w1[:, None], 2)
    assert got.makespan <= partition.lpt_bound_2d(w1[:, None], 2)
    w2 = np.stack([w1 // 2, w1 - w1 // 2], axis=1)
    for w in (w1[:, None], w2):
        for seed in (ref_part.lpt_partition, ref_part.kk_partition):
            a = seed(w.sum(axis=1), 2)
            ref_a2 = ref_part.Assignment2D(
                a.device_of.copy(), ref_part._loads_2d(w, a.device_of, 2))
            port_a2 = partition.Assignment2D(
                a.device_of.copy(), partition._loads_2d(w, a.device_of, 2))
            want = ref_part.refine_partition_2d(w, ref_a2)
            have = partition.refine_partition_2d(w, port_a2)
            np.testing.assert_array_equal(have.device_of, want.device_of)
            np.testing.assert_array_equal(have.loads, want.loads)
    want = ref_part.best_partition_2d(w2, 2)
    np.testing.assert_array_equal(
        partition.best_partition_2d(w2, 2).device_of, want.device_of)


def _selection_case(seed, B=4, hkv=3, T=6, S=2):
    """Per-slot selections ``[B, Hkv, nb]`` (-1 trailing), block tables with
    two rows sharing their leading blocks, and their stripe placement."""
    rng = np.random.default_rng(seed)
    ids = np.full((B, hkv, 4), -1, np.int32)
    for b in range(B):
        for h in range(hkv):
            n = int(rng.integers(0, 5))
            ids[b, h, :n] = np.sort(rng.choice(T, size=n, replace=False))
    perm = rng.permutation(4 * T).astype(np.int32)
    table = perm[:B * T].reshape(B, T).copy()
    table[1, :3] = table[0, :3]                     # a shared prefix
    table[3, 5] = -1                                # one unmapped position
    stripe_of = np.where(table >= 0, table // (4 * T // S), -1)
    return ids, table, stripe_of.astype(np.int32)


@pytest.mark.parametrize("dm,S", [(1, 2), (2, 2), (2, 3), (1, 4)])
@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("seed", [0, 3])
def test_pack_decode_items_2d_equals_reference(dm, S, shared, seed):
    ids, table, stripe_of = _selection_case(seed, S=S)
    kw = dict(num_stripes=S, num_shards=dm, block=64,
              bytes_per_block=2.0 * 64 * 32 * 2,
              phys_of_block=table if shared else None)
    got = worklist.pack_decode_items_2d(ids, stripe_of, **kw)
    want = ref_wl.pack_decode_items_2d(ids, stripe_of, **kw)
    np.testing.assert_array_equal(got.items, want.items)
    np.testing.assert_array_equal(got.lengths, want.lengths)
    np.testing.assert_array_equal(got.stripe_items(), want.stripe_items())
    assert (got.imbalance, got.model_imbalance, got.stripe_imbalance,
            got.padding_waste) == (want.imbalance, want.model_imbalance,
                                   want.stripe_imbalance,
                                   want.padding_waste)
    # each stripe's list names only blocks that stripe holds
    for s in range(S):
        it = got.stripe_items()[s]
        real = it[it[:, worklist.D_VALID] == 1]
        rows, blks = real[:, worklist.D_BATCH], real[:, worklist.D_KVBLK]
        assert (stripe_of[rows, blks] == s).all()


def test_pack_decode_items_phys_of_block_equals_reference():
    """The 1D packer's charge-once weights (now fed by the engine)."""
    ids, table, _ = _selection_case(7)
    for dm in (1, 2):
        kw = dict(num_shards=dm, block=64, phys_of_block=table)
        got = worklist.pack_decode_items(ids, **kw)
        want = ref_wl.pack_decode_items(ids, **kw)
        np.testing.assert_array_equal(got.items, want.items)
        np.testing.assert_array_equal(got.lengths, want.lengths)


# -- the striped allocator ---------------------------------------------------

def _striped_stream(alloc):
    """Admit, grow, free and swap on a 3-stripe pool; returns what the
    allocator reports along the way."""
    seen = []
    alloc.admit(0, 40, 20)
    alloc.admit(1, 10, 30)
    for _ in range(20):
        alloc.append_token(0)
        alloc.append_token(1)
    seen.append((alloc.table(0), alloc.table(1),
                 alloc.free_blocks_per_stripe(), alloc.stripe_counts(0)))
    alloc.free(1)
    alloc.admit(2, 17, 0)
    seen.append((alloc.table(2), alloc.free_blocks_per_stripe()))
    alloc.swap_out(0)
    seen.append((alloc.free_blocks_per_stripe(), alloc.host_tokens(0)))
    alloc.admit(3, 20, 0)
    alloc.swap_in(0, 4)
    seen.append((alloc.table(0), alloc.table(3),
                 alloc.free_blocks_per_stripe(),
                 [alloc.stripe_of(b) for b in alloc.table(0)],
                 sorted(b for f in alloc._free for b in f), alloc.audit(strict=False)))
    return seen


def test_striped_allocator_equals_reference():
    got = _striped_stream(kv_cache.BlockAllocator(15, 8, stripes=3))
    want = _striped_stream(ref_kv.BlockAllocator(15, 8, stripes=3))
    assert got == want
    assert got[-1][-1] == []


def test_striped_audit_finds_a_foreign_free_id():
    a = kv_cache.BlockAllocator(12, 4, stripes=3)
    a._free[0][0], a._free[2][0] = a._free[2][0], a._free[0][0]
    fails = a.audit(strict=False)
    assert any("stripe ownership" in f for f in fails)
    with pytest.raises(ValueError):
        kv_cache.BlockAllocator(10, 4, stripes=3)


# -- the stripe merge ----------------------------------------------------------

@pytest.mark.parametrize("S", [2, 3, 4])
def test_merge_stripe_partials_equals_reference(S):
    """Per-stripe partials of B=3 rows, 2 kv heads, G=2: a (row, head) held
    by one stripe, one held by none, stripes wholly masked."""
    B, hkv, G, dh = 3, 2, 2, 16
    rng = np.random.default_rng(S)
    parts = []
    for s in range(S):
        out = rng.standard_normal((B, hkv * G, 1, dh)).astype(np.float32)
        m = rng.standard_normal((B, hkv, G)).astype(np.float32)
        l = rng.uniform(0.5, 4.0, (B, hkv, G)).astype(np.float32)
        masked = np.zeros((B, hkv, G), bool)
        masked[0, 0] = s != 1          # row 0 head 0: stripe 1 alone
        masked[1, 1] = True            # row 1 head 1: no stripe
        if s == S - 1:
            masked[:] = True           # the last stripe holds nothing
        m[masked], l[masked] = -1e30, 0.0
        out.reshape(B, hkv, G, dh)[masked] = 0.0
        parts.append((out, m, l))
    want = np.asarray(ref_tfm._merge_stripe_partials(
        [tuple(jnp.asarray(x) for x in p) for p in parts], B, hkv, dh,
        jnp.float32))
    got = tfm._merge_stripe_partials(
        [tuple(torch.from_numpy(x) for x in p) for p in parts], B, hkv, dh,
        torch.float32).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # the pair one stripe holds keeps that stripe's output bitwise; the
    # pair none holds is zeros
    np.testing.assert_array_equal(got.reshape(B, hkv, G, dh)[0, 0],
                                  parts[1][0].reshape(B, hkv, G, dh)[0, 0])
    assert not got.reshape(B, hkv, G, dh)[1, 1].any()


def _placed(placement, seed=9, B=1, hkv=2, G=3, dh=32, nb=4, S=2):
    """One row's ``nb`` logical blocks (the same contents) placed on a pool
    of ``2 * nb`` blocks in ``S`` stripes by ``placement`` (the stripe of
    each logical block): q, pools, ids, the stripes' masked tables, pos."""
    rng = np.random.default_rng(seed)
    blk = 64
    q = rng.standard_normal((B, hkv * G, 1, dh)).astype(np.float32)
    kv = rng.standard_normal((2, nb, hkv, blk, dh)).astype(np.float32)
    size = 2 * nb // S
    taken = [0] * S
    table = np.full((B, nb), -1, np.int32)
    pools = np.zeros((2, 2 * nb + 1, hkv, blk, dh), np.float32)
    for j, st in enumerate(placement):
        table[0, j] = st * size + taken[st]
        taken[st] += 1
        pools[:, table[0, j]] = kv[:, j]
    ids = np.tile(np.arange(nb, dtype=np.int32), (B, hkv, 1))
    tables = [np.where((table >= 0) & (table // size == s), table, -1)
              for s in range(S)]
    pos = np.array([nb * blk - 1], np.int32)
    return q, pools, ids, tables, pos


def test_striped_bits_depend_on_block_placement():
    """The same logical K/V merged from stripes grouped two ways ({0, 1} |
    {2, 3} against {0, 2} | {1, 3}): the reference's striped decode and the
    port's each give other bits for the two placements (the partials
    associate differently), equal within 1e-5; so at S > 1 a prefix hit,
    whose shared blocks sit where their first holder put them, need not
    give the cache-off serve's bits (``ROADMAP.md`` §3)."""
    from repro.kernels import ops as ref_ops
    from repro_torch.kernels import ops
    outs = {}
    for placement in ((0, 0, 1, 1), (0, 1, 0, 1)):
        q, pools, ids, tables, pos = _placed(placement)
        ref_parts = [ref_ops.flash_decode_paged(
            jnp.asarray(q), jnp.asarray(pools[0]), jnp.asarray(pools[1]),
            jnp.asarray(ids), jnp.asarray(t), jnp.asarray(pos), block_kv=64,
            partials=True) for t in tables]
        port_parts = [ops.flash_decode_paged(
            *(torch.from_numpy(x) for x in (q, pools[0], pools[1], ids, t,
                                            pos)), block_kv=64,
            partials=True) for t in tables]
        outs[placement] = (
            np.asarray(ref_tfm._merge_stripe_partials(ref_parts, 1, 2, 32,
                                                      jnp.float32)),
            tfm._merge_stripe_partials(port_parts, 1, 2, 32,
                                       torch.float32).numpy())
    (ref_a, port_a), (ref_b, port_b) = outs.values()
    for a, b in ((ref_a, ref_b), (port_a, port_b)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
        assert not np.array_equal(a, b)
    np.testing.assert_allclose(port_a, ref_a, rtol=0, atol=1e-6)


# -- Engine.serve against the JAX engine -----------------------------------

@functools.lru_cache(maxsize=None)
def port_striped(d, S, worklist="packed", attention="sparse",
                 budget=256):
    eng = port_engine(NAME, d, budget, seq_shards=S,
                      decode_worklist=worklist, attention=attention)
    done = eng.serve(list(model(NAME)[4]),
                     SamplingParams(max_tokens=MAX_TOKENS))
    assert eng.kv.audit() == [] and eng.kv.alloc.allocated_blocks == 0
    return [r.generated for r in done], eng.decode_bubble_stats


@functools.lru_cache(maxsize=None)
def ref_striped(d, S, worklist="packed", attention="sparse"):
    eng = ref_engine(NAME, d, seq_shards=S, decode_worklist=worklist,
                     attention=attention)
    done = eng.serve(list(model(NAME)[4]),
                     RefSamplingParams(max_tokens=MAX_TOKENS))
    return [r.generated for r in done], eng.decode_bubble_stats


def _stats_equal(got, want):
    """Every reference key of a feature the port runs, equal."""
    assert set(want) - set(got) == set()
    for key, value in got.items():
        assert value == want[key], key


@pytest.mark.parametrize("d,S,worklist,attention", [
    (1, 2, "packed", "sparse"), (1, 4, "packed", "sparse"),
    (1, 2, "padded", "sparse"), (1, 4, "padded", "sparse"),
    (1, 2, "packed", "dense"), (1, 4, "packed", "dense"),
    (2, 2, "packed", "sparse")])
def test_striped_serve_equals_reference(d, S, worklist, attention):
    """The JAX engine's tokens and bubble stats at the same S (at D = 2 the
    global-id engine); the port's unstriped tokens too."""
    got, stats = port_striped(d, S, worklist, attention)
    want, want_stats = ref_striped(d, S, worklist, attention)
    assert got == want
    assert got == port_striped(d, 1, worklist, attention)[0]
    _stats_equal(stats, want_stats)
    assert stats["seq_shards"] == S
    assert stats["merge_collectives"] > 0
    if attention == "sparse":
        assert stats["merge_collectives"] == (model(NAME)[2].num_layers
                                              * stats["ticks"])
    if worklist == "packed" and attention == "sparse":
        assert {"model_imbalance", "stripe_imbalance"} <= set(
            stats["last_tick"])
        assert stats["mean_stripe_imbalance"] >= 1.0


def test_striped_launches_one_decode_pass_a_stripe(monkeypatch):
    """S partial passes of the paged decode a layer, each with
    ``partials``; unstriped, one."""
    from repro_torch.kernels import ops
    calls = []
    real = ops.flash_decode_packed_paged

    def spy(*a, **k):
        calls.append(k.get("partials", False))
        return real(*a, **k)

    monkeypatch.setattr(ops, "flash_decode_packed_paged", spy)
    cfg = model(NAME)[2]
    for S in (1, 3):
        calls.clear()
        eng = port_engine(NAME, 1, seq_shards=S)
        eng.serve(list(model(NAME)[4])[:2], SamplingParams(max_tokens=3))
        ticks = eng.decode_stats["ticks"]
        assert len(calls) == S * cfg.num_layers * ticks
        assert all(calls) == (S > 1)


GEMMA = dataclasses.replace(get_config("gemma3-1b", smoke=True),
                            dtype=torch.float32)
REF_GEMMA32 = dataclasses.replace(REF_GEMMA, dtype=jnp.float32)


@functools.lru_cache(maxsize=None)
def gemma_setup():
    ref_params = ref_tfm.init_params(jax.random.PRNGKey(0), REF_GEMMA32)
    params = params_from_jax(jax.tree.map(np.asarray, ref_params), GEMMA,
                             device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, GEMMA.vocab_size, size=n)
               for n in (300, 40, 250)]
    return ref_params, params, prompts


@pytest.mark.parametrize("attention", ["sparse", "dense"])
def test_gemma3_windows_striped_equal_reference(attention):
    """Gemma3-1B SMOKE (``LLLLLG``, window 128) at S = 2: a window's blocks
    may sit on any stripe; tokens equal the port's at S = 1 (which
    ``test_torch_gemma3.py`` holds to the JAX engine's) and, dense (the
    masked-table passes), the JAX engine's at S = 2."""
    ref_params, params, prompts = gemma_setup()
    kw = dict(max_seq_len=1024, num_slots=4, budget_per_head=256,
              attention=attention)
    prof = synthetic_head_curves(GEMMA.num_layers, GEMMA.num_heads)
    got = {}
    for S in (1, 2):
        eng = Engine(GEMMA, params, EngineConfig(**kw, seq_shards=S),
                     prof if attention == "sparse" else None, device="cpu")
        got[S] = [r.generated for r in eng.serve(
            prompts, SamplingParams(max_tokens=10))]
    assert got[2] == got[1]
    if attention == "dense":
        ref = RefEngine(REF_GEMMA32, ref_params,
                        RefEngineConfig(**kw, seq_shards=2))
        want = [r.generated for r in ref.serve(
            prompts, RefSamplingParams(max_tokens=10))]
        assert got[2] == want


def test_head_move_mid_run_striped_equals_reference():
    """D = 2 x S = 2 at full budgets: the shards' KV groups exchanged at
    the first safe point from decode tick 4 gathers the pool's kv-head
    axis (stripes do not move); tokens equal the unstriped frozen serve
    and the global-id JAX engine making the same move at S = 2."""
    prompts = list(model(NAME)[4])
    sp = SamplingParams(max_tokens=MAX_TOKENS)
    eng = port_engine(NAME, 2, FULL_BUDGET, seq_shards=2)
    _force_at(eng, 4, _swap_shards)
    got = [r.generated for r in eng.serve(prompts, sp)]
    assert eng.epoch == eng.replans == 1
    frozen = port_engine(NAME, 2, FULL_BUDGET)
    assert got == [r.generated for r in frozen.serve(prompts, sp)]
    ref = ref_engine(NAME, 2, FULL_BUDGET, GlobalIdEngine, seq_shards=2)
    _force_at(ref, 4, _swap_shards)
    want = [r.generated for r in ref.serve(
        prompts, RefSamplingParams(max_tokens=MAX_TOKENS))]
    assert ref.epoch == 1 and got == want


def test_preempt_swap_resume_striped_equals_reference():
    """S = 2 in a pool of 6 blocks (rounded to the stripes): a decoding
    batch request is preempted by an interactive arrival, swapped out (its
    blocks back to their stripes), and swapped into fresh blocks that may
    sit on other stripes.  Tokens equal the uninterrupted unstriped serve
    and the JAX engine's striped preempted serve; the swap stats are the
    reference's."""
    prompts = [model(NAME)[4][i] for i in (0, 2, 3)]
    kw = dict(seq_shards=2, num_kv_blocks=6, preemption=True)
    sp = SamplingParams(max_tokens=MAX_TOKENS)
    frozen, _ = drive_interrupt(port_engine(NAME, 1), prompts,
                                scheduler.Request, sp)
    eng = port_engine(NAME, 1, **kw)
    got, b = drive_interrupt(eng, prompts, scheduler.Request, sp)
    ref = ref_engine(NAME, 1, cls=RefEngine, **kw)
    want, rb = drive_interrupt(ref, prompts, ref_sched.Request,
                               RefSamplingParams(max_tokens=MAX_TOKENS))
    assert b.stats.preempted >= 1 and b.stats.resumed >= 1
    assert got == frozen == want
    assert eng.swap_stats["blocks_out"] == ref.swap_stats["blocks_out"]
    assert eng.swap_stats["swapped_in"] == ref.swap_stats["swapped_in"]
    assert eng.kv.audit() == [] and b.alloc.free_blocks == 6


# -- configuration ---------------------------------------------------------

def test_pool_rounds_up_to_a_stripe_multiple():
    eng = port_engine(NAME, 1, seq_shards=3, num_kv_blocks=10)
    assert eng.kv.num_blocks == 12 and eng.kv.pool.shape[2] == 13
    assert eng.kv.stripes == 3 and eng.kv.stripe_size == 4
    assert eng.kv.alloc.free_blocks_per_stripe() == [4, 4, 4]


def test_contiguous_layout_and_bad_degree_raise():
    with pytest.raises(ValueError, match="paged"):
        port_engine(NAME, 1, seq_shards=2, cache_layout="contiguous")
    with pytest.raises(ValueError, match="seq_shards"):
        EngineConfig(seq_shards=0).check_supported()
    for S in (1, 2, 4):
        EngineConfig(seq_shards=S).check_supported()


def test_launcher_seq_shards_reach_the_engine(capsys):
    done = launch_serve.main(["--arch", "smollm-135m", "--smoke",
                              "--device", "cpu", "--requests", "3",
                              "--max-tokens", "4", "--seq-shards", "2"])
    assert len(done) == 3 and all(len(r.generated) == 4 for r in done)
    out = capsys.readouterr().out
    assert "2D decode: head imbalance" in out and "seq merges" in out
