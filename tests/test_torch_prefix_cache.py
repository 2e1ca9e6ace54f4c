"""The radix prefix cache (§2.14) in the port: refcounted sharing of the
KV blocks of cached whole-block prompt prefixes, prefill from the first
block that differs.  Held against the JAX reference at SMOKE sizes in
float32 (8 heads over 4 KV heads, 2 layers, block 64):

- ``RadixPrefixCache`` and the sharing ``BlockAllocator``: the reference's
  unit cases (walk, one-token cap, LRU unwinding, referenced blocks never
  evicted, subtree invalidation, the evictable-hit discount, the shared
  count, audits of planted refcount faults), the same results as the
  reference's on one admit / share / free / swap stream, and the host-only
  warm-hit admission through the port's ``ContinuousBatcher``;
- ``Engine.serve`` with the cache on, over bf16 / int8 / fp8 caches,
  chunked and monolithic prefill, S = 1 and 2 seq stripes, two serves on
  one engine (the second hits the tree the first left): the JAX engine's
  tokens, scheduler counters and tree counters; inside the port the
  cache-off serve's tokens bit for bit (except where a hit is another
  computation, in the reference too: a quantized cache with monolithic
  prefill), and no prefill or decode write ever lands in a block another
  holder references;
- a preempted hit victim keeps its shared prefix resident and swaps only
  its private tail; a head move while it is on the host flushes the tree
  and re-arranges its copy once, as the global-id JAX engine does;
- the contiguous layout refuses the cache; the launcher's
  ``--prefix-cache`` traffic hits.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs.smollm_135m import SMOKE as REF_SMOKE
from repro.core.sparsity import synthetic_head_curves as ref_curves
from repro.models import transformer as ref_tfm
from repro.serving import Engine as RefEngine
from repro.serving import EngineConfig as RefEngineConfig
from repro.serving import SamplingParams as RefSamplingParams
from repro.serving import kv_cache as ref_kv
from repro.serving import prefix_tree as ref_tree
from repro.serving import scheduler as ref_sched
from repro_torch.configs import get_config
from repro_torch.core.sparsity import synthetic_head_curves
from repro_torch.launch import serve as launch_serve
from repro_torch.models import transformer as tfm
from repro_torch.serving import Engine, EngineConfig, SamplingParams
from repro_torch.serving import scheduler
from repro_torch.serving.kv_cache import BlockAllocator, IntegrityError
from repro_torch.serving.prefix_tree import RadixPrefixCache
from repro_torch.weights import params_from_jax
from test_torch_head_parallel import GlobalIdEngine
from test_torch_preemption import drive_interrupt
from test_torch_replan import _swap_shards

torch.set_num_threads(1)

# unrolled: the reference's scan-mode monolithic prefill runs layer 0's
# work list on every layer (ROADMAP.md section 3)
REF_CFG = dataclasses.replace(REF_SMOKE, dtype=jnp.float32, num_heads=8,
                              num_kv_heads=4, layer_loop="unroll")
CFG = dataclasses.replace(get_config("smollm-135m", smoke=True),
                          dtype=torch.float32, num_heads=8, num_kv_heads=4)
KW = dict(attention="sparse", budget_per_head=256, block=64, floor=64,
          max_seq_len=512, num_slots=4, prefill_chunk_tokens=128)
MAX_TOKENS = 8


@functools.lru_cache(maxsize=None)
def weights():
    ref_params = ref_tfm.init_params(jax.random.PRNGKey(0), REF_CFG)
    params = params_from_jax(jax.tree.map(np.asarray, ref_params), CFG,
                             device="cpu")
    return ref_params, params


def shared_prompts(shared_tokens=128, tails=(20, 35, 50), seed=0):
    """Prompts continuing one ``shared_tokens`` prefix, and one
    unrelated."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, CFG.vocab_size, size=(shared_tokens,))
    out = [np.concatenate([shared, rng.integers(0, CFG.vocab_size,
                                                size=(n,))])
           for n in tails]
    out.append(rng.integers(0, CFG.vocab_size, size=(60,)))
    return out


def port(prefix=True, **kw):
    return Engine(CFG, weights()[1], EngineConfig(**{**KW, **kw},
                                                  prefix_cache=prefix),
                  synthetic_head_curves(CFG.num_layers, CFG.num_heads),
                  device="cpu")


def ref(prefix=True, cls=RefEngine, **kw):
    return cls(REF_CFG, weights()[0], RefEngineConfig(**{**KW, **kw},
                                                      prefix_cache=prefix),
               profile=ref_curves(CFG.num_layers, CFG.num_heads))


def tokens(done):
    return {r.rid: list(r.generated) for r in done}


# -- the tree and the sharing allocator -----------------------------------

def seed_prompt(alloc, tree, prompt, sid):
    """Admit and register one prompt as the scheduler does."""
    hit_ids, hit = tree.match(prompt)
    alloc.admit(sid, len(prompt), max_new_tokens=0, shared=hit_ids)
    tree.insert(prompt, alloc.table(sid))
    return hit


def test_match_insert_walk():
    alloc = BlockAllocator(16, 4)
    tree = RadixPrefixCache(alloc, 4)
    p = np.arange(10, dtype=np.int32)        # 2 full blocks + tail
    assert seed_prompt(alloc, tree, p, 0) == 0
    assert tree.num_blocks == 2
    ids, hit = tree.match(p)                 # both full blocks hit
    assert hit == 8 and len(ids) == 2
    alloc.admit(1, len(p), shared=ids)
    assert alloc.refcount(ids[0]) == 2
    # divergence inside block 1: only block 0 matches
    q = np.concatenate([p[:6], [99, 98, 97, 96]]).astype(np.int32)
    ids_q, hit_q = tree.match(q)
    assert hit_q == 4 and ids_q == [tree.match(p)[0][0]]
    assert alloc.audit() == []


def test_match_leaves_one_token_to_prefill():
    alloc = BlockAllocator(16, 4)
    tree = RadixPrefixCache(alloc, 4)
    p = np.arange(8, dtype=np.int32)         # exactly 2 blocks
    seed_prompt(alloc, tree, p, 0)
    ids, hit = tree.match(p)
    assert hit == 4 and len(ids) == 1        # capped at (8 - 1) // 4


def test_lru_eviction_unwinds_cold_leaves():
    alloc = BlockAllocator(16, 4)
    tree = RadixPrefixCache(alloc, 4)
    a = np.arange(9, dtype=np.int32)
    b = (np.arange(9, dtype=np.int32) + 100) % 256
    seed_prompt(alloc, tree, a, 0)
    seed_prompt(alloc, tree, b, 1)
    alloc.free(0)
    alloc.free(1)
    assert alloc.evictable_blocks == 4 and alloc.free_blocks == 12
    tree.match(a)                            # b becomes LRU
    assert tree.evict(1) == 1
    assert tree.match(b)[1] == 4             # b lost its leaf only
    assert tree.match(a)[1] == 8
    alloc.evict_fn = tree.evict              # a full admission drains it
    alloc.admit(2, 16 * 4)
    assert tree.num_blocks == 0
    assert alloc.audit() == []


def test_eviction_never_takes_referenced_blocks():
    alloc = BlockAllocator(8, 4)
    tree = RadixPrefixCache(alloc, 4)
    seed_prompt(alloc, tree, np.arange(9, dtype=np.int32), 0)
    assert tree.evict(4) == 0 and tree.num_blocks == 2


def test_invalidate_drops_whole_subtree():
    alloc = BlockAllocator(16, 4)
    tree = RadixPrefixCache(alloc, 4)
    p = np.arange(13, dtype=np.int32)        # 3 full blocks
    seed_prompt(alloc, tree, p, 0)
    root_bid = tree.match(p)[0][0]
    alloc.free(0)
    assert tree.invalidate_blocks([root_bid]) == 3 and tree.num_blocks == 0
    assert alloc.free_blocks == 16
    assert alloc.audit() == []


def test_evictable_hit_is_not_double_counted():
    """A hit on a retired (evictable) prefix does not discount the
    admission need: ``available_blocks`` already counts those blocks.  A
    referenced hit does."""
    alloc = BlockAllocator(4, 4)
    tree = RadixPrefixCache(alloc, 4)
    alloc.evict_fn = tree.evict
    p = np.arange(9, dtype=np.int32)         # 3 blocks, 2 cacheable
    seed_prompt(alloc, tree, p, 0)
    alloc.free(0)
    assert alloc.available_blocks == 4
    hit_ids, _ = tree.match(p)
    assert len(hit_ids) == 2 and alloc.shared_discount(hit_ids) == 0
    with pytest.raises(MemoryError):
        alloc.admit(1, len(p), max_new_tokens=12, shared=hit_ids)
    assert alloc.audit() == [] and alloc.available_blocks == 4
    hit_ids, _ = tree.match(p)
    alloc.admit(2, len(p), shared=hit_ids)
    hit_ids, _ = tree.match(p)
    assert alloc.shared_discount(hit_ids) == 2
    alloc.admit(3, len(p), shared=hit_ids)
    assert alloc.audit() == [] and alloc.available_blocks == 0


def test_shared_block_count_tracks_multiholder_blocks():
    alloc = BlockAllocator(8, 4)
    tree = RadixPrefixCache(alloc, 4)
    p = np.arange(9, dtype=np.int32)
    seed_prompt(alloc, tree, p, 0)
    assert alloc.shared_block_count == 0
    ids, _ = tree.match(p)
    alloc.admit(1, len(p), shared=ids)
    assert alloc.shared_block_count == 2
    alloc.free(0)
    assert alloc.shared_block_count == 0
    alloc.free(1)
    assert alloc.shared_block_count == 0 and alloc.audit() == []


@pytest.mark.parametrize("fault,message", [
    ("refcount", "refcount drift"), ("free", "free/referenced overlap")])
def test_audit_catches_refcount_faults(fault, message):
    alloc = BlockAllocator(8, 4)
    alloc.admit(0, 8)
    if fault == "refcount":
        alloc._refcnt[alloc.table(0)[0]] += 1
    else:
        alloc._free[0].append(alloc.table(0)[0])
    with pytest.raises(IntegrityError) as ei:
        alloc.audit()
    assert any(message in f for f in ei.value.failures)


def _sharing_stream(alloc, tree):
    """Admit, share, free, evict and swap on one pool: what the allocator
    and the tree report along the way."""
    seen = []
    p = np.arange(21, dtype=np.int32)
    q = np.concatenate([p[:12], np.arange(50, 59)]).astype(np.int32)
    seen.append(seed_prompt(alloc, tree, p, 0))
    ids, hit = tree.match(q)
    alloc.admit(1, len(q), 8, shared=ids)
    tree.insert(q, alloc.table(1))
    seen.append((hit, ids, alloc.table(1), alloc.shared_block_count,
                 alloc.shared_discount(ids), alloc.swap_split(1),
                 alloc.swap_release_estimate(1), alloc.release_estimate(1)))
    alloc.swap_out(1)
    seen.append((alloc.host_shared_blocks(1), alloc.free_blocks,
                 alloc.host_allocated_blocks, alloc.audit(strict=False)))
    alloc.free(0)
    seen.append((alloc.evictable_blocks, sorted(alloc.evictable_ids()),
                 alloc.free_blocks))
    alloc.admit(2, 30, 0)
    seen.append((alloc.swap_in(1, 8), alloc.table(1), tree.evict(2),
                 alloc.audit(strict=False), dict(tree.stats)))
    return seen


def test_sharing_stream_equals_reference():
    a = BlockAllocator(16, 4, stripes=2)
    got = _sharing_stream(a, RadixPrefixCache(a, 4))
    r = ref_kv.BlockAllocator(16, 4, stripes=2)
    want = _sharing_stream(r, ref_tree.RadixPrefixCache(r, 4))
    assert got == want
    assert got[1][5][0] and got[-1][3] == []


def test_warm_hits_serialize_in_a_tight_pool():
    """Two arrivals hitting two retired prefixes, in a pool that holds one
    worst case at a time: the second waits for the first instead of
    overcommitting the pool (host-only, stub steps)."""
    block = 4
    alloc = BlockAllocator(8, block)
    tree = RadixPrefixCache(alloc, block)
    alloc.evict_fn = tree.evict
    p1 = np.arange(9, dtype=np.int32)
    p2 = np.arange(9, dtype=np.int32) + 100
    for sid, p in enumerate((p1, p2)):       # warm, then retire
        seed_prompt(alloc, tree, p, sid)
        alloc.free(sid)
    assert alloc.evictable_blocks == 4 and alloc.available_blocks == 8
    b = scheduler.ContinuousBatcher(
        num_slots=4, num_blocks=8, max_seq_len=64, block=block,
        token_budget=None, allocator=alloc, prefix_cache=tree)
    sp = SamplingParams(max_tokens=11)       # 9 + 11 tokens = 5 blocks
    for rid, p in enumerate((p1, p2)):
        b.submit(scheduler.Request(rid=rid, prompt=p, sampling=sp))
    headroom = []

    def on_tick():
        headroom.append(alloc.available_blocks)
        assert alloc.audit() == []

    done = b.run(lambda toks, slot, off, final, n: 0 if final else None,
                 lambda slots, toks, pos: np.zeros(len(slots), np.int32),
                 on_tick=on_tick)
    assert sorted(r.rid for r in done) == [0, 1]
    assert min(headroom) >= 0 and b.stats.prefix_hits == 2
    assert alloc.free_blocks + alloc.evictable_blocks == 8


# -- Engine.serve: cache on against the JAX engine and against cache off ---

COMBOS = [(kv, mode, S) for kv in ("bf16", "int8", "fp8")
          for mode in ("chunked", "monolithic") for S in (1, 2)]


@functools.lru_cache(maxsize=None)
def served(kv, mode, S, prefix=True, reference=False):
    """Two serves of the shared-prefix traffic on one engine: tokens of
    each, the scheduler's and the tree's counters after each."""
    kw = dict(kv_dtype=kv, prefill_mode=mode, seq_shards=S)
    eng = (ref(prefix, **kw) if reference else port(prefix, **kw))
    sp = (RefSamplingParams if reference else SamplingParams)(
        max_tokens=MAX_TOKENS)
    out = []
    for _ in range(2):
        done = eng.serve(shared_prompts(), sp)
        st = eng._batcher.stats
        pf = eng.decode_bubble_stats["prefix"]
        out.append((tokens(done), (st.prefix_hits, st.prefix_hit_tokens,
                                   st.prefill_tokens, st.prefill_chunks),
                    pf))
    if not reference:
        assert eng.kv.audit() == []
    return out


def same_computation(kv, mode):
    """Whether a hit computes what a miss does.  A quantized monolithic
    miss attends the prompt's full-precision K/V (quantized only when it
    lands in the pool), while a hit's tail, a chunk, attends the shared
    prefix's codes: in the reference as in the port (``ROADMAP.md`` §3)."""
    return kv == "bf16" or mode == "chunked"


@pytest.mark.parametrize("kv,mode,S", COMBOS)
def test_cache_serves_equal_reference_and_cache_off(kv, mode, S):
    """Both serves: the JAX engine's tokens, hit and prefill counters and
    tree counters (its striped serve, S = 2: stripes change neither, and
    the port's S = 1 and S = 2 serves give the same); the cache-off port
    serve's tokens bit for bit wherever a hit computes what a miss does;
    the second serve hits the warm tree."""
    got = served(kv, mode, S)
    want = served(kv, mode, 2, reference=True)
    off = served(kv, mode, S, prefix=False)
    assert got == served(kv, mode, 3 - S)
    for (g_tok, g_st, g_pf), (w_tok, w_st, w_pf), (o_tok, o_st, o_pf) in zip(
            got, want, off):
        assert g_tok == w_tok
        if same_computation(kv, mode):
            assert g_tok == o_tok
        assert g_st == w_st and g_pf == w_pf
        assert o_pf is None and o_st[:2] == (0, 0)
        # prefill work drops by exactly the hit tokens
        assert g_st[2] == o_st[2] - g_st[1]
    (_, first, _), (_, second, pf) = got
    assert first[0] >= 2 and second[0] > first[0]
    assert pf["nodes"] >= 2 and pf["flushes"] == 0


def test_quantized_monolithic_hit_is_another_computation():
    """The reference's own cache-on and cache-off serves part on this
    traffic with an fp8 cache and monolithic prefill (a hit's tail attends
    the prefix's codes, a miss the full-precision K/V), as the port's do:
    the port follows the reference, not the cache-off serve."""
    on, on_ref = served("fp8", "monolithic", 2), served(
        "fp8", "monolithic", 2, reference=True)
    off, off_ref = served("fp8", "monolithic", 2, prefix=False), served(
        "fp8", "monolithic", 2, prefix=False, reference=True)
    assert on[0][0] == on_ref[0][0] and off[0][0] == off_ref[0][0]
    assert on_ref[0][0] != off_ref[0][0]


def test_no_write_lands_in_a_shared_block(monkeypatch):
    """Copy-on-write by construction: every block a prefill chunk or a
    decode token writes has refcount 1 (the block after a hit is freshly
    mapped); the hits do happen."""
    eng = port(kv_dtype="int8", seq_shards=2)
    rc = eng.kv.alloc.refcount
    writes = []
    real_chunk, real_decode = tfm.prefill_chunk_paged, tfm.decode_step_paged

    def chunk(params, pool, toks, table, q_offset, cfg, **kw):
        nblk = toks.shape[1] // pool.shape[4]
        ids = table[q_offset // pool.shape[4]:][:nblk].tolist()
        writes.extend(rc(b) for b in ids if b >= 0)
        return real_chunk(params, pool, toks, table, q_offset, cfg, **kw)

    def decode(params, pool, token, pos, table, cfg, active=None, **kw):
        blk = pool.shape[4]
        for b in np.flatnonzero(active.numpy()):
            writes.append(rc(int(table[b, int(pos[b]) // blk])))
        return real_decode(params, pool, token, pos, table, cfg,
                           active=active, **kw)

    monkeypatch.setattr(tfm, "prefill_chunk_paged", chunk)
    monkeypatch.setattr(tfm, "decode_step_paged", decode)
    for _ in range(2):
        eng.serve(shared_prompts(), SamplingParams(max_tokens=MAX_TOKENS))
    assert eng.prefix.stats["hits"] >= 4 and writes
    assert set(writes) == {1}


# -- preemption and epochs with sharing --------------------------------------

def preempt_prompts():
    rng = np.random.default_rng(3)
    shared = rng.integers(0, CFG.vocab_size, size=(128,))
    prompts = [np.concatenate([shared, rng.integers(0, CFG.vocab_size,
                                                    size=(n,))])
               for n in (40, 30)]
    # the interactive arrival needs 3 blocks; in a 6-block pool the
    # cache-on residents (3 + 2 shared + 1 private) leave 2 free, so both
    # serves preempt
    prompts.append(rng.integers(0, CFG.vocab_size, size=(150,)))
    return prompts


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_hit_victim_swaps_only_its_private_tail(kv):
    """The preempted hit victim swaps fewer blocks than the cache-off run
    (its shared prefix stays resident), exactly its private tail's bytes,
    resumes with the uninterrupted tokens, and leaves the pool clean."""
    sp = SamplingParams(max_tokens=12)
    frozen, _ = drive_interrupt(port(kv_dtype=kv), preempt_prompts(),
                                scheduler.Request, sp)
    blocks_out = {}
    for on in (False, True):
        eng = port(on, kv_dtype=kv, preemption=True, num_kv_blocks=6)
        victims = []
        real = eng._swap_out_seq

        def spy(rid, slot, resident):
            victims.append(eng.kv.alloc.swap_split(rid))
            return real(rid, slot, resident)

        eng._swap_out_seq = spy              # make_batcher wires the hook
        got, b = drive_interrupt(eng, preempt_prompts(), scheduler.Request,
                                 sp)
        assert got == frozen
        assert b.stats.preempted >= 1 and b.stats.resumed >= 1
        st = eng.swap_stats
        assert st["blocks_in"] == st["blocks_out"] > 0
        blocks_out[on] = st["blocks_out"]
        assert eng.kv.audit() == [] and b.alloc.host_allocated_blocks == 0
        if on:
            retained, private = victims[0]
            assert retained, "the victim held no shared prefix"
            per_block = eng.kv.pool[:, :, :1].numel() * \
                eng.kv.pool.element_size()
            if eng.kv.scales is not None:
                per_block += eng.kv.scales[:, :, :1].numel() * 4
            assert st["bytes_out"] == len(private) * per_block
    assert blocks_out[True] < blocks_out[False]


def test_head_move_while_hit_victim_is_out_flushes_and_remaps_once():
    """D = 2: a head move lands while the preempted hit victim sits on the
    host; the swap flushes the tree, the victim's private host copy is
    re-arranged once, and tokens equal the ample frozen serve and the
    global-id JAX engine making the same move."""
    prompts = preempt_prompts()
    sp = SamplingParams(max_tokens=12)
    kw = dict(num_model_shards=2)
    frozen = tokens(port(**kw).serve(
        prompts, sp, priorities=["batch", "batch", "interactive"]))

    def move(eng, b):
        if (not eng.replans and eng.swap_stats["swapped_out"]
                and not eng.swap_stats["swapped_in"] and b.replan_safe):
            assert eng.replan_now(plan=_swap_shards(eng.plan))

    tight = dict(kw, preemption=True, num_kv_blocks=6)
    eng = port(**tight)
    got, _ = drive_interrupt(eng, prompts, scheduler.Request, sp,
                             on_tick=lambda b: move(eng, b))
    assert eng.replans == 1 and eng.swap_stats["epoch_remaps"] == 1
    assert eng.prefix.stats["flushes"] == 1
    assert got == frozen
    r = ref(cls=GlobalIdEngine, **tight)
    want, _ = drive_interrupt(r, prompts, ref_sched.Request,
                              RefSamplingParams(max_tokens=12),
                              on_tick=lambda b: move(r, b))
    assert r.prefix.stats["flushes"] == 1 and got == want


# -- configuration ---------------------------------------------------------

def test_contiguous_layout_refuses_the_cache():
    with pytest.raises(ValueError, match="paged"):
        port(cache_layout="contiguous")
    EngineConfig(prefix_cache=True).check_supported()


def test_launcher_prefix_cache_traffic_hits(capsys):
    done = launch_serve.main(["--arch", "smollm-135m", "--smoke",
                              "--device", "cpu", "--requests", "6",
                              "--max-tokens", "3", "--prefix-cache"])
    assert len(done) == 6 and all(len(r.generated) == 3 for r in done)
    out = capsys.readouterr().out
    line = next(l for l in out.splitlines() if l.startswith("prefix cache:"))
    assert int(line.split()[2].split("/")[0]) > 0
    with pytest.raises(SystemExit):
        launch_serve.main(["--arch", "smollm-135m", "--smoke", "--device",
                           "cpu", "--prefix-cache", "--prompt-lens", "40"])
