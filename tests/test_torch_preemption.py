"""Overload serving in the port (§2.10): priority classes, SLO admission,
preemption with KV swap to the host tier, against the JAX reference at
SMOKE sizes in float32 — the port's counterpart of
``tests/test_preemption.py``.

- A decoding ``batch`` request preempted by a later ``interactive`` arrival
  is swapped out and back in: on both layouts, both prefill modes, bf16 and
  int8 caches (codes and scales move together), every request's greedy
  tokens equal the port's uninterrupted serve AND the JAX engine's
  preempted serve; both tiers audit clean afterwards.
- A mid-prefill victim is discarded (no host traffic) and restarts.
- A head move (D = 2, the shards' KV groups exchanged) while a victim sits
  on the host is re-arranged exactly once at swap-in (``epoch_remaps`` 1)
  and keeps the frozen tokens, as the global-id JAX engine does; skipping
  the remap changes them.  Without an epoch change there is no remap.
- ``host_swap_blocks=0``: no swap, no deadlock.  SLO admission's deferral
  completes all four requests.
- The port's and the reference's ``ContinuousBatcher`` on one fake clock
  with stub step functions make the same admit / defer / preempt / resume
  / shed decisions, tick by tick.
- ``BlockAllocator``'s host tier equals the reference's through a sequence
  of swaps, and its audit finds planted violations on either tier.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs.smollm_135m import SMOKE as REF_SMOKE
from repro.core import sparsity as ref_sparsity
from repro.models import transformer as ref_tfm
from repro.serving import Engine as RefEngine
from repro.serving import EngineConfig as RefEngineConfig
from repro.serving import SamplingParams as RefSamplingParams
from repro.serving import kv_cache as ref_kv
from repro.serving import scheduler as ref_sched
from repro_torch.configs import get_config
from repro_torch.core import sparsity
from repro_torch.launch import serve as launch_serve
from repro_torch.serving import Engine, EngineConfig, SamplingParams
from repro_torch.serving import kv_cache, scheduler
from repro_torch.weights import params_from_jax
from test_torch_head_parallel import FULL_BUDGET, GlobalIdEngine, model
from test_torch_replan import _swap_shards

torch.set_num_threads(1)

# unrolled: the reference's scan-mode monolithic prefill runs layer 0's
# work list on every layer (ROADMAP.md section 3)
REF_CFG = dataclasses.replace(REF_SMOKE, dtype=jnp.float32,
                              layer_loop="unroll")
CFG = dataclasses.replace(get_config("smollm-135m", smoke=True),
                          dtype=torch.float32)
KW = dict(max_seq_len=1024, budget_per_head=256)
# two batch prompts (3 + 3 blocks with their 12 new tokens) fill the tight
# pool of 6 blocks; the interactive arrival (2 blocks) preempts one
PROMPT_LENS = (300, 250, 200)
TIGHT_BLOCKS = 6
MAX_TOKENS = 12


@pytest.fixture(scope="module")
def setup():
    ref_params = ref_tfm.init_params(jax.random.PRNGKey(0), REF_CFG)
    params = params_from_jax(jax.tree.map(np.asarray, ref_params), CFG,
                             device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, CFG.vocab_size, size=n) for n in PROMPT_LENS]
    return ref_params, params, prompts


def _geometry(layout, tight):
    """Tight: the paged pool holds the two batch requests and no more; the
    contiguous cache has two slots.  Ample (tight=False): the paged pool
    at its default size (the contiguous layout keeps its two slots, so the
    decode batch has the same rows)."""
    if layout == "paged":
        return dict(num_slots=4, num_kv_blocks=TIGHT_BLOCKS if tight else None)
    return dict(num_slots=2)


def _port(params, layout, mode, kv="bf16", tight=True, preemption=True,
          **kw):
    return Engine(CFG, params, EngineConfig(
        **KW, **_geometry(layout, tight), cache_layout=layout,
        prefill_mode=mode, kv_dtype=kv, preemption=preemption, **kw),
        sparsity.synthetic_head_curves(CFG.num_layers, CFG.num_heads),
        device="cpu")


def _ref(ref_params, layout, mode, kv="bf16", **kw):
    return RefEngine(REF_CFG, ref_params, RefEngineConfig(
        **KW, **_geometry(layout, True), cache_layout=layout,
        prefill_mode=mode, kv_dtype=kv, preemption=True, **kw),
        profile=ref_sparsity.synthetic_head_curves(CFG.num_layers,
                                                   CFG.num_heads))


def drive_interrupt(eng, prompts, request_cls, sp, on_tick=None):
    """Two batch-class requests run until both decode; then an interactive
    arrival (the third prompt) comes, and the batcher drains.  ``on_tick``
    runs after every tick from the arrival on.  Returns the tokens by rid
    and the batcher."""
    b = eng.make_batcher()
    pf, df = eng.step_fns(sp)
    for i, p in enumerate(prompts[:2]):
        b.submit(request_cls(rid=i, prompt=np.asarray(p, np.int32),
                             sampling=sp, priority="batch"))
    done = []
    while b.busy and not (b.prefilling is None and len(b.active) == 2):
        done.extend(b.tick(pf, df))
    done.extend(b.tick(pf, df))
    b.submit(request_cls(rid=2, prompt=np.asarray(prompts[2], np.int32),
                         sampling=sp, priority="interactive"))
    ticks = 0
    while b.busy and ticks < 10_000:
        done.extend(b.tick(pf, df))
        ticks += 1
        if on_tick is not None:
            on_tick(b)
    assert not b.busy
    return {r.rid: list(r.generated) for r in done}, b


def _port_tokens(eng, prompts, on_tick=None):
    return drive_interrupt(eng, prompts, scheduler.Request,
                           SamplingParams(max_tokens=MAX_TOKENS), on_tick)


def _assert_clean(eng, b):
    """Both tiers restored: nothing mapped, nothing on the host, audit
    clean."""
    fails = eng.kv.audit(strict=False) if eng.paged else b.alloc.audit(False)
    assert fails == []
    assert b.alloc.free_blocks == b.alloc.num_blocks
    assert b.alloc.host_allocated_blocks == 0 and b.alloc.swapped_seqs == ()
    assert eng._host_swaps == {}


@pytest.mark.parametrize("layout,mode,kv", [
    ("paged", "chunked", "bf16"), ("paged", "monolithic", "bf16"),
    ("contiguous", "chunked", "bf16"), ("contiguous", "monolithic", "bf16"),
    ("paged", "chunked", "int8"), ("contiguous", "chunked", "int8")])
def test_swap_roundtrip_equals_uninterrupted_and_reference(setup, layout,
                                                           mode, kv):
    """Preempt a decoding batch request, swap its KV (codes and scales) to
    the host, resume: tokens equal the uninterrupted serve's and the JAX
    engine's preempted serve's; the swap stats and per-class counters
    equal the reference's."""
    ref_params, params, prompts = setup
    frozen, _ = _port_tokens(_port(params, layout, mode, kv, tight=False,
                                   preemption=False), prompts)
    eng = _port(params, layout, mode, kv)
    got, b = _port_tokens(eng, prompts)
    ref = _ref(ref_params, layout, mode, kv)
    want, rb = drive_interrupt(ref, prompts, ref_sched.Request,
                               RefSamplingParams(max_tokens=MAX_TOKENS))
    assert b.stats.preempted >= 1 and b.stats.resumed >= 1
    st = eng.swap_stats
    assert st["swapped_out"] >= 1 and st["blocks_out"] > 0
    assert st["blocks_in"] == st["blocks_out"]
    assert st["bytes_in"] == st["bytes_out"] > 0
    assert got == frozen, "preempt/resume diverged from the frozen serve"
    assert got == want, "the port's preempted serve left the JAX engine's"
    # the byte counts differ only by the reference's pow2 swap buckets
    for key in ("swapped_out", "swapped_in", "blocks_out", "blocks_in",
                "epoch_remaps"):
        assert st[key] == ref.swap_stats[key], key
    bs, rbs = eng.decode_bubble_stats, ref.decode_bubble_stats
    assert bs["swap"] == st and bs["per_class"] == rbs["per_class"]
    pc = b.stats.per_class["batch"]
    assert pc["preempted"] >= 1 and pc["resumed"] >= 1
    assert pc["swapped_out_blocks"] == st["blocks_out"]
    _assert_clean(eng, b)


def test_mid_prefill_victim_discarded_and_restarts(setup):
    """A victim caught mid-prefill is discarded (no host traffic, its
    blocks free at once) and its restarted prefill gives the uninterrupted
    tokens, as in the JAX engine."""
    ref_params, params, _ = setup
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, CFG.vocab_size, size=n) for n in (600, 80)]
    sp = SamplingParams(max_tokens=16)

    def run(eng, request_cls, sp):
        b = eng.make_batcher()
        pf, df = eng.step_fns(sp)
        # 600 tokens = 3 chunks of 256, reserving 5 of the 6 blocks
        b.submit(request_cls(rid=0, prompt=np.asarray(prompts[0], np.int32),
                             sampling=sp, priority="batch"))
        done = list(b.tick(pf, df))
        assert b.prefilling is not None
        b.submit(request_cls(rid=1, prompt=np.asarray(prompts[1], np.int32),
                             sampling=sp, priority="interactive"))
        done.extend(b.run(pf, df))
        return {r.rid: list(r.generated) for r in done}, b, done

    frozen = [r.generated for r in _port(
        params, "paged", "chunked", tight=False, preemption=False).serve(
            prompts, sp)]
    eng = _port(params, "paged", "chunked")
    got, b, done = run(eng, scheduler.Request, sp)
    assert b.stats.preempted >= 1
    assert next(r for r in done if r.rid == 0).preemptions >= 1
    assert eng.swap_stats["swapped_out"] == 0
    assert b.stats.per_class["batch"]["swapped_out_blocks"] == 0
    assert [got[0], got[1]] == frozen
    want, _, _ = run(_ref(ref_params, "paged", "chunked"), ref_sched.Request,
                     RefSamplingParams(max_tokens=16))
    assert got == want
    assert b.alloc.free_blocks == b.alloc.num_blocks


def _straddle(eng, prompts, skip_remap=False):
    """The interrupt drive with a head move (the shards' KV groups
    exchanged) at the first safe point while the victim is on the host.
    ``skip_remap``: the planted fault, the host copy restored as taken."""
    moved = []

    def on_tick(b):
        if (not moved and eng.swap_stats["swapped_out"]
                and not eng.swap_stats["swapped_in"] and b.replan_safe):
            assert eng.replan_now(plan=_swap_shards(eng.plan))
            moved.append(True)

    if skip_remap:
        swap_in = eng._swap_in_seq

        def unmapped(rid, slot, resident):
            eng._host_swaps[rid]["arrange"] = eng._kv_arrange.copy()
            return swap_in(rid, slot, resident)
        eng._swap_in_seq = unmapped
    request_cls = (scheduler.Request if isinstance(eng, Engine)
                   else ref_sched.Request)
    sp = (SamplingParams if isinstance(eng, Engine) else RefSamplingParams)(
        max_tokens=MAX_TOKENS)
    got, b = drive_interrupt(eng, prompts, request_cls, sp, on_tick)
    assert moved, "the head move never straddled the host residency"
    return got, b


def _sharded(name, layout, tight, preemption, ref=False):
    """A D = 2 engine of ``test_torch_head_parallel``'s ``name`` layout at
    full budgets (sparse == dense, so a head move changes no result), the
    port's or the global-id JAX engine's."""
    ref_cfg, ref_params, cfg, params, _ = model(name)
    kw = dict(max_seq_len=1024, budget_per_head=FULL_BUDGET,
              num_model_shards=2, cache_layout=layout, preemption=preemption,
              **_geometry(layout, tight))
    if ref:
        return GlobalIdEngine(ref_cfg, ref_params, RefEngineConfig(**kw),
                              profile=ref_sparsity.synthetic_head_curves(
                                  cfg.num_layers, cfg.num_heads))
    return Engine(cfg, params, EngineConfig(**kw),
                  sparsity.synthetic_head_curves(cfg.num_layers,
                                                 cfg.num_heads),
                  device="cpu")


@pytest.mark.parametrize("layout", ["paged", "contiguous"])
def test_swap_straddling_epoch_remaps_exactly_once(layout):
    """D = 2 at full budgets, KV groups exchanged while the victim is on
    the host: swap-in re-arranges the copy once (``epoch_remaps`` 1), the
    tokens stay the frozen serve's and equal the global-id JAX engine's
    making the same move; restoring the copy as taken changes them."""
    name = "h8kv4"
    prompts = [model(name)[4][i] for i in (0, 2, 3)]
    frozen, _ = drive_interrupt(
        _sharded(name, layout, False, False), prompts, scheduler.Request,
        SamplingParams(max_tokens=MAX_TOKENS))
    eng = _sharded(name, layout, True, True)
    got, b = _straddle(eng, prompts)
    assert eng.epoch == eng.replans == 1
    assert eng.swap_stats["epoch_remaps"] == 1 and b.stats.resumed >= 1
    assert got == frozen, "the epoch-straddling swap diverged"
    ref = _sharded(name, layout, True, True, ref=True)
    want, _ = _straddle(ref, prompts)
    assert ref.swap_stats["epoch_remaps"] == 1 and got == want
    _assert_clean(eng, b)
    control = _sharded(name, layout, True, True)
    bad, _ = _straddle(control, prompts, skip_remap=True)
    assert control.swap_stats["epoch_remaps"] == 0
    assert bad != frozen, "the planted fault (no remap) kept the tokens"


@pytest.mark.parametrize("layout", ["paged", "contiguous"])
def test_no_epoch_change_means_no_remap(setup, layout):
    _, params, prompts = setup
    eng = _port(params, layout, "chunked")
    _, b = _port_tokens(eng, prompts)
    assert b.stats.resumed >= 1
    assert eng.swap_stats["epoch_remaps"] == 0


def test_host_tier_capacity_bounds_swap(setup):
    """``host_swap_blocks=0``: a decoding victim cannot be swapped, so the
    interactive arrival waits; nothing deadlocks and the tokens are the
    uninterrupted ones."""
    _, params, prompts = setup
    eng = _port(params, "paged", "chunked", host_swap_blocks=0)
    got, b = _port_tokens(eng, prompts)
    assert eng.swap_stats["swapped_out"] == 0 and b.stats.preempted == 0
    assert b.stats.completed == 3
    frozen, _ = _port_tokens(_port(params, "paged", "chunked", tight=False,
                                   preemption=False), prompts)
    assert got == frozen


def test_slo_admission_completes_deferred_requests(setup):
    """Under SLO admission with measured EMAs, lower-class work may be
    deferred, never rejected here: all four requests complete with the
    tokens of a FIFO serve."""
    _, params, _ = setup
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, CFG.vocab_size, size=n)
               for n in (100, 90, 80, 70)]
    sp = SamplingParams(max_tokens=12)
    eng = Engine(CFG, params, EngineConfig(
        **KW, num_slots=4, admission="slo", preemption=True),
        sparsity.synthetic_head_curves(CFG.num_layers, CFG.num_heads),
        device="cpu")
    done = eng.serve(prompts, sp, priorities=["interactive", "batch",
                                              "batch", "interactive"])
    assert all(not r.rejected and len(r.generated) == 12 for r in done)
    assert eng._batcher.stats.completed == 4
    fifo = _port(params, "paged", "chunked", tight=False, preemption=False)
    assert [r.generated for r in done] == [
        r.generated for r in fifo.serve(prompts, sp)]


@pytest.mark.parametrize("layout", ["paged", "contiguous"])
@pytest.mark.parametrize("kv", ["bf16", "int8", "fp8"])
def test_overload_config_builds_engine(setup, layout, kv):
    """``EngineConfig(preemption=True, admission="slo", host_swap_blocks=N)``
    builds an engine whose batcher takes the policy, the hooks and the
    host tier's capacity."""
    cfg = EngineConfig(**KW, num_slots=2, cache_layout=layout, kv_dtype=kv,
                       preemption=True, admission="slo", host_swap_blocks=7)
    cfg.check_supported()
    eng = Engine(CFG, setup[1], cfg,
                 sparsity.synthetic_head_curves(CFG.num_layers, CFG.num_heads),
                 device="cpu")
    b = eng.make_batcher()
    assert (b.admission, b.preemption) == ("slo", True)
    assert b.alloc.host_blocks == 7 and b.alloc.host_free_blocks == 7
    assert b.swap_out_fn == eng._swap_out_seq
    assert b.swap_in_fn == eng._swap_in_seq
    assert set(b.classes) == {"interactive", "standard", "batch"}


# -- the scheduler on a fake clock ---------------------------------------------

def _classes(mod):
    """A class table with a shed deadline and two batch classes sharing a
    level by stride weight."""
    pc = mod.PriorityClass
    return (pc("interactive", 0, ttft_target_s=0.5, itl_target_s=0.06),
            pc("standard", 1, ttft_target_s=2.0, itl_target_s=0.4,
               reject_after_s=0.3),
            pc("batch", 2, ttft_target_s=30.0, itl_target_s=2.0),
            pc("bulk", 2, ttft_target_s=30.0, itl_target_s=2.0, weight=2.0))


# (tick, class, prompt length, max tokens) of the request stream
STREAM = [(0, "batch", 250, 40), (0, "bulk", 60, 30), (0, "standard", 40, 9),
          (2, "bulk", 50, 12), (7, "interactive", 120, 10),
          (3, "standard", 100, 8), (5, "batch", 45, 25),
          (6, "interactive", 30, 6), (8, "standard", 200, 10),
          (9, "bulk", 35, 14), (12, "interactive", 120, 9),
          (14, "standard", 60, 7), (15, "batch", 300, 5),
          (20, "interactive", 20, 4), (22, "standard", 30, 30)]


def _trace(mod, admission, token_budget):
    # ``mod``: a package's Request, PriorityClass, ContinuousBatcher and
    # SamplingParams
    """Drive ``mod``'s ContinuousBatcher over :data:`STREAM` on a fake
    clock (a prefill chunk costs 1 ms a token, a decode tick 20 ms + 2 ms
    a row) with stub steps and accounting-only swap hooks that log their
    calls.  Returns one record per tick."""
    now = [0.0]
    log = []
    b = mod.ContinuousBatcher(
        num_slots=4, num_blocks=24, max_seq_len=512, block=16,
        token_budget=token_budget, classes=_classes(mod),
        admission=admission, preemption=True, host_blocks=30,
        swap_out_fn=lambda rid, slot, n: log.append(("out", rid, slot, n)),
        swap_in_fn=lambda rid, slot, n: log.append(("in", rid, slot, n)),
        clock=lambda: now[0])

    def prefill(toks, slot, q_offset, is_final, prompt_len):
        now[0] += 1e-3 * toks.shape[1]
        log.append(("prefill", slot, q_offset, toks.shape[1], is_final))
        return int(toks[0, -1]) % 97 if is_final else None

    def decode(slots, toks, pos):
        now[0] += 0.02 + 2e-3 * len(slots)
        log.append(("decode", tuple(slots), tuple(pos)))
        return (np.asarray(toks) * 3 + np.asarray(pos)) % 97

    rng = np.random.default_rng(5)
    stream = [(t, c, rng.integers(0, 97, size=n).astype(np.int32), m)
              for t, c, n, m in sorted(STREAM, key=lambda e: e[0])]
    sp_cls = mod.SamplingParams
    records, tick = [], 0
    while tick < 400 and (stream or b.busy):
        for t, c, prompt, m in [s for s in stream if s[0] == tick]:
            b.submit(mod.Request(rid=len(STREAM) - len(stream),
                                 prompt=prompt, sampling=sp_cls(max_tokens=m),
                                 priority=c))
            stream.pop(0)
        del log[:]
        fin = b.tick(prefill, decode)
        st = dataclasses.asdict(b.stats)
        records.append({
            "log": list(log),
            "finished": [(r.rid, r.rejected, r.reject_reason,
                          tuple(r.generated), r.preemptions) for r in fin],
            "active": sorted(b.active), "prefilling": (
                b.prefilling.rid if b.prefilling is not None else None),
            "queued": [r.rid for r in b.pending],
            "preempted": {k: [r.rid for r in q]
                          for k, q in b._preempted.items()},
            "stats": {k: st[k] for k in (
                "admitted", "completed", "rejected", "decode_steps",
                "prefill_tokens", "prefill_chunks", "preempted", "resumed",
                "deferred", "swapped_out_blocks", "swapped_in_blocks",
                "per_class")},
            "emas": (b.ema_decode_s, b.ema_prefill_s_per_tok),
            "alloc": (b.alloc.free_blocks, b.alloc.available_blocks,
                      b.alloc.host_allocated_blocks),
        })
        assert b.alloc.audit(strict=False) == []
        tick += 1
    assert not b.busy and not stream
    return records


@pytest.mark.parametrize("admission", ["fifo", "slo"])
@pytest.mark.parametrize("token_budget", [64, None],
                         ids=["chunked", "monolithic"])
def test_scheduler_trace_equals_reference(admission, token_budget):
    """The port's and the reference's schedulers make the same decisions,
    tick by tick: prefill chunks and decode batches, admissions, SLO
    deferrals, preemptions (swap and discard), resumes, sheds, finished
    requests and their tokens, the EMAs and the allocator's counts."""
    got, want = (_trace(types.SimpleNamespace(
        Request=m.Request, PriorityClass=m.PriorityClass,
        ContinuousBatcher=m.ContinuousBatcher, SamplingParams=sp),
        admission, token_budget)
        for m, sp in ((scheduler, SamplingParams),
                      (ref_sched, RefSamplingParams)))
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a == b, f"tick {i}"
    last = got[-1]["stats"]
    assert last["preempted"] >= 1 and last["resumed"] >= 1
    if admission == "slo" and token_budget is not None:
        assert last["deferred"] >= 1
        assert any(f[2] == "slo_timeout" for rec in got
                   for f in rec["finished"])


# -- the allocator's host tier --------------------------------------------------

def _alloc_ops(alloc):
    """One sequence of admissions, decode growth, swaps, resumes and frees;
    returns the state after each step."""
    out = []

    def snap():
        out.append((alloc.free_blocks, alloc.available_blocks,
                    alloc.host_allocated_blocks, alloc.host_free_blocks,
                    sorted(alloc.swapped_seqs),
                    {s: list(alloc.table(s)) for s in range(4)},
                    [alloc.host_tokens(s) for s in range(4)],
                    [alloc.release_estimate(s) for s in range(4)],
                    [alloc.swap_release_estimate(s) for s in range(4)]))
    alloc.admit(0, 40, 30)
    alloc.admit(1, 17, 5)
    for _ in range(9):
        alloc.append_token(0)
    snap()
    assert alloc.swap_split(0) == ([], alloc.table(0))
    assert alloc.swap_out(0) == 4
    snap()
    alloc.admit(2, 33, 10)
    snap()
    alloc.free(1)
    assert alloc.can_swap_in(0, 21)
    alloc.swap_in(0, 21)
    snap()
    alloc.swap_out(2)
    alloc.free(2)
    alloc.free(0)
    snap()
    return out


def test_allocator_host_tier_equals_reference():
    got = _alloc_ops(kv_cache.BlockAllocator(12, 16, host_blocks=8))
    want = _alloc_ops(ref_kv.BlockAllocator(12, 16, host_blocks=8))
    assert got == want
    a = kv_cache.BlockAllocator(4, 16, host_blocks=1)
    a.admit(0, 20, 0)
    assert not a.can_swap_out(0)
    with pytest.raises(MemoryError, match="host swap tier"):
        a.swap_out(0)
    with pytest.raises(ValueError, match="not swapped out"):
        a.swap_in(0)


def test_allocator_audit_across_both_tiers():
    """The audit is clean through swaps and finds planted violations of
    either tier: a sequence on both, a host hold of the wrong size, the
    host cap exceeded; ``PagedKVCache.audit`` reports the allocator's."""
    a = kv_cache.BlockAllocator(8, 16, host_blocks=3)
    a.admit(0, 40, 0)
    a.admit(1, 10, 6)
    a.swap_out(0)
    assert a.audit() == [] and a.host_allocated_blocks == 3
    a._lens[0] = 40                           # on both tiers
    assert any("dual accounting" in f for f in a.audit(strict=False))
    del a._lens[0]
    a._host_nblk[0] = 2
    assert any("host conservation" in f for f in a.audit(strict=False))
    a._host_nblk[0] = 4
    fails = a.audit(strict=False)
    assert any("host cap" in f for f in fails)
    with pytest.raises(kv_cache.IntegrityError):
        a.audit()
    cache = kv_cache.PagedKVCache(lambda n: torch.zeros(1, 2, n, 1, 16, 4),
                                  num_blocks=4, block=16, table_width=4,
                                  host_blocks=2)
    cache.alloc.admit(5, 30, 0)
    cache.alloc.swap_out(5)
    assert cache.audit() == []
    cache.alloc._host_lens[5] = 60
    assert any("host conservation" in f for f in cache.audit(strict=False))


def test_launcher_overload_flags_reach_engine_config(monkeypatch, capsys):
    """``--admission``, ``--preemption``, ``--host-blocks`` and
    ``--kv-blocks`` become the engine's config; the prompts take the
    classes in turn and the run prints its preemption summary."""
    seen = {}

    class Spy(Engine):
        def __init__(self, cfg, params, ecfg, *args, **kw):
            seen["ecfg"] = ecfg
            super().__init__(cfg, params, ecfg, *args, **kw)

        def serve(self, prompts, sampling, priorities=None):
            seen["priorities"] = priorities
            return super().serve(prompts, sampling, priorities)

    monkeypatch.setattr(launch_serve, "Engine", Spy)
    launch_serve.main(["--arch", "smollm-135m", "--smoke", "--device", "cpu",
                       "--prompt-lens", "300,250,40,60", "--max-tokens", "6",
                       "--admission", "slo", "--preemption",
                       "--host-blocks", "9", "--kv-blocks", "12"])
    ecfg = seen["ecfg"]
    assert (ecfg.admission, ecfg.preemption, ecfg.host_swap_blocks,
            ecfg.num_kv_blocks) == ("slo", True, 9, 12)
    assert seen["priorities"] == ["interactive", "standard", "batch",
                                  "interactive"]
    assert "preemption: 0 swapped out / 0 back in" in capsys.readouterr().out
