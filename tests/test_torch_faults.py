"""Faults and self-healing (§2.13) in the port, held against the JAX
reference on the CPU — the port's counterpart of ``tests/test_faults.py``,
at its ``CFG`` (2 layers, d_model 64, 4 heads over 2, ``block_kv`` 64) in
float32, with its engine settings (block 64, budget 128, 256-token
sequences, chunked prefill, audits every 2 decode ticks).

For the same ``FaultPlan`` and traffic the port's serve gives the JAX
engine's outcome: the failed rids and their ``fail_reason``, the tokens of
every request, ``injector.events`` (which invocation of which seam fired)
and ``fault_stats``:

- swap transfers (a preempting drive on a tight pool): a fault within
  ``swap_retries`` heals, one past it discards the victim and requeues it
  (the same tokens, recomputed), a delay changes nothing;
- KV corruption, paged / contiguous x bf16 / int8 x NaN / Inf: only the
  victim fails, the others keep the clean serve's tokens, the pool audits
  clean and a second serve on the engine gives the clean tokens; with the
  recovery probe on, the probe's health bit quarantines first
  (``probe_nonfinite``);
- a poisoned prefill fails its request with no tokens; an admission fault
  rolls back and retries; an epoch-swap fault rolls back (at D = 2, where
  the reference's prefill differs, the tokens are held inside the port:
  against an engine that adopted the moved plan directly);
- a corrupted SHARED prefix block fails every holder and invalidates the
  tree, and a later serve misses and gives the clean tokens.

Inside the port: a disabled (or idle) injector and ``sentinels=False``
change no token over dense / sparse / windowed x paged / contiguous x
bf16 / int8; the auditor flags planted faults; and the plain versions of
#1, #3 and #2 leak a stale NaN past a sequence's length into their output
(``0 x NaN``), as the kernels do on the card: the scrub is load-bearing.

Each JAX engine is built once a module and re-armed between cases.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.core.sparsity import synthetic_head_curves as ref_curves
from repro.models.transformer import TransformerConfig as RefConfig
from repro.models.transformer import init_params as ref_init
from repro.serving import Engine as RefEngine
from repro.serving import EngineConfig as RefEngineConfig
from repro.serving import SamplingParams as RefSamplingParams
from repro.serving import faults as ref_faults
from repro.serving.scheduler import Request as RefRequest
from repro_torch.configs import TransformerConfig
from repro_torch.core.planner import LayerPlan
from repro_torch.core.sparsity import synthetic_head_curves
from repro_torch.serving import Engine, EngineConfig, SamplingParams
from repro_torch.serving.faults import (
    FaultInjector, FaultPlan, FaultSpec, IntegrityError)
from repro_torch.serving.kv_cache import BlockAllocator
from repro_torch.serving.scheduler import Request
from repro_torch.weights import params_from_jax
from test_torch_cuda import stale_nan_outputs

torch.set_num_threads(1)

REF_CFG = RefConfig(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                    d_ff=128, vocab_size=256, layer_loop="unroll",
                    block_kv=64, dtype=jnp.float32)
CFG = TransformerConfig(num_layers=2, d_model=64, num_heads=4,
                        num_kv_heads=2, d_ff=128, vocab_size=256,
                        block_kv=64, dtype=torch.float32)
WINDOW = dict(attn_pattern="GL", local_window=160)
SP = dict(max_tokens=8)
PREEMPT = dict(max_seq_len=512, budget_per_head=256, preemption=True)


@functools.lru_cache(maxsize=None)
def weights(windowed: bool = False):
    rcfg = dataclasses.replace(REF_CFG, **WINDOW) if windowed else REF_CFG
    cfg = dataclasses.replace(CFG, **WINDOW) if windowed else CFG
    ref_params = ref_init(jax.random.PRNGKey(0), rcfg)
    return (rcfg, ref_params, cfg,
            params_from_jax(jax.tree.map(np.asarray, ref_params), cfg,
                            device="cpu"))


def prompts(lens=(60, 52, 44)):
    rng = np.random.default_rng(0)
    return [rng.integers(0, CFG.vocab_size, size=(n,)) for n in lens]


def preempt_prompts():
    return prompts((100, 90, 80))


def shared_prompts():
    """Two prompts continuing one 128-token prefix, and one unrelated."""
    rng = np.random.default_rng(0)
    shared = rng.integers(0, CFG.vocab_size, size=(128,))
    out = [np.concatenate([shared, rng.integers(0, CFG.vocab_size,
                                                size=(n,))])
           for n in (30, 40)]
    return out + [rng.integers(0, CFG.vocab_size, size=(60,))]


def settings(layout="paged", kv_dtype="bf16", attention="sparse",
             tight=False, shards=1, **kw) -> dict:
    """The reference test's ``_mk`` engine settings."""
    out = dict(attention=attention, budget_per_head=128, block=64, floor=64,
               max_seq_len=256, prefill_mode="chunked",
               prefill_chunk_tokens=128, cache_layout=layout,
               kv_dtype=kv_dtype, admission="fifo",
               num_model_shards=shards, audit_every=2)
    if layout == "paged":
        out.update(num_slots=4, num_kv_blocks=5 if tight else None)
    else:
        out.update(num_slots=2 if tight else 4)
    out.update(kw)
    return out


def port(inj=None, windowed=False, **kw) -> Engine:
    s = settings(**kw)
    cfg, params = weights(windowed)[2:]
    prof = (synthetic_head_curves(CFG.num_layers, CFG.num_heads)
            if s["attention"] == "sparse" else None)
    return Engine(cfg, params, EngineConfig(**s), prof, device="cpu",
                  injector=inj)


_REF_ENGINES: dict = {}


def ref(inj=None, fresh=False, **kw) -> RefEngine:
    """The JAX engine of these settings, built once and re-armed with
    ``inj`` (its counters reset, as a fresh engine's); ``fresh`` builds a
    new one (its plan or tree is about to change)."""
    key = tuple(sorted(kw.items()))
    eng = None if fresh else _REF_ENGINES.get(key)
    if eng is None:
        rcfg, rparams = weights()[:2]
        s = settings(**kw)
        eng = RefEngine(rcfg, rparams, RefEngineConfig(**s),
                        profile=(ref_curves(CFG.num_layers, CFG.num_heads)
                                 if s["attention"] == "sparse" else None))
        if not fresh:
            _REF_ENGINES[key] = eng
    eng.injector = inj
    if eng.kv is not None:
        eng.kv.alloc.injector = inj
    eng.fault_stats = dict.fromkeys(eng.fault_stats, 0)
    eng.swap_stats = dict.fromkeys(eng.swap_stats, 0)
    eng._decode_ticks = eng._ticks_since_replan = 0
    eng._last_audit_activity = -1
    return eng


def injectors(*specs):
    """The port's injector and the reference's, over the same plan."""
    port_plan = FaultPlan(specs=tuple(specs))
    ref_plan = ref_faults.FaultPlan.from_json(port_plan.to_json())
    return FaultInjector(port_plan), ref_faults.FaultInjector(ref_plan)


def tokens(done):
    return {r.rid: list(r.generated) for r in done}


def outcome(eng, done, inj) -> dict:
    return {"failed": {r.rid: r.fail_reason for r in done if r.failed},
            "rejected": sorted(r.rid for r in done if r.rejected),
            "tokens": tokens(done),
            "events": list(inj.events) if inj is not None else [],
            "faults": dict(eng.fault_stats)}


def drive_preempting(eng, ps, sp, request_cls, interrupt_tick=6):
    """The reference test's drive: two batch decodes, then an interactive
    arrival the tight pool cannot hold beside them."""
    b = eng.make_batcher()
    pf, df = eng.step_fns(sp)
    for i, p in enumerate(ps[:2]):
        b.submit(request_cls(rid=i, prompt=np.asarray(p, np.int32),
                             sampling=sp, priority="batch"))
    done, ticks = [], 0
    while ticks < interrupt_tick and b.busy:
        done.extend(b.tick(pf, df))
        ticks += 1
    b.submit(request_cls(rid=2, prompt=np.asarray(ps[2], np.int32),
                         sampling=sp, priority="interactive"))
    while b.busy and ticks < 10_000:
        done.extend(b.tick(pf, df))
        ticks += 1
    assert not b.busy
    return done, b


@functools.lru_cache(maxsize=None)
def clean(**kw):
    """The port's fault-free tokens of ``prompts()`` (8 tokens each)."""
    return tokens(port(**kw).serve(prompts(), SamplingParams(**SP)))


@functools.lru_cache(maxsize=None)
def clean_preempt():
    """The port's uninterrupted (ample pool) tokens of the preempting
    traffic, 12 tokens each."""
    return tokens(port(**PREEMPT).serve(preempt_prompts(),
                                        SamplingParams(max_tokens=12)))


# -- the fault plan ----------------------------------------------------------

def test_fault_plan_equals_the_reference_and_round_trips():
    got = FaultPlan.random(7, 0.1, horizon=30, max_rid=12)
    want = ref_faults.FaultPlan.random(7, 0.1, horizon=30, max_rid=12)
    assert got.to_json() == want.to_json()
    assert FaultPlan.from_json(got.to_json()).to_json() == got.to_json()
    a = FaultInjector(got)
    c = ref_faults.FaultInjector(want)
    for i in range(50):
        for seam in ref_faults.SEAMS:
            assert ((a.fire(seam, rid=i % 5) is None)
                    == (c.fire(seam, rid=i % 5) is None))
    assert a.events == c.events and a.enabled == c.enabled


# -- a disabled injector is invisible ----------------------------------------

@pytest.mark.parametrize("policy,layout,kv_dtype", [
    ("sparse", "paged", "bf16"),
    ("sparse", "paged", "int8"),
    ("sparse", "contiguous", "bf16"),
    ("sparse", "contiguous", "int8"),
    ("dense", "paged", "bf16"),
    ("dense", "contiguous", "bf16"),
    ("windowed", "paged", "bf16"),
    ("windowed", "paged", "int8"),
    ("windowed", "contiguous", "bf16"),
])
def test_disabled_injector_bitwise_invisible(policy, layout, kv_dtype):
    """No injector, an armed one whose only spec never fires, an empty
    plan, and the sentinels off: the same tokens."""
    kw = dict(windowed=policy == "windowed", layout=layout,
              kv_dtype=kv_dtype,
              attention="dense" if policy == "dense" else "sparse")
    sp = SamplingParams(**SP)
    want = tokens(port(**kw).serve(prompts(), sp))
    idle = FaultInjector(FaultPlan(specs=(
        FaultSpec(seam="kv_corrupt", after=10_000),)))
    assert tokens(port(idle, **kw).serve(prompts(), sp)) == want
    assert not idle.events
    empty = FaultInjector(FaultPlan())
    assert tokens(port(empty, **kw).serve(prompts(), sp)) == want
    assert tokens(port(sentinels=False, **kw).serve(prompts(), sp)) == want


def test_disabled_injector_equals_the_reference():
    mine, theirs = injectors(FaultSpec(seam="kv_corrupt", after=10_000))
    eng = port(mine)
    got = outcome(eng, eng.serve(prompts(), SamplingParams(**SP)), mine)
    r = ref(theirs)
    want = outcome(r, r.serve(prompts(), RefSamplingParams(**SP)), theirs)
    assert got == want and got["tokens"] == clean()
    assert got["faults"]["audits"] > 0            # the periodic audit ran


# -- swap transfers ------------------------------------------------------------

def preempting_outcomes(*specs, **kw):
    mine, theirs = injectors(*specs)
    eng = port(mine, tight=True, **PREEMPT, **kw)
    done, b = drive_preempting(eng, preempt_prompts(),
                               SamplingParams(max_tokens=12), Request)
    r = ref(theirs, tight=True, **PREEMPT, **kw)
    rdone, rb = drive_preempting(r, preempt_prompts(),
                                 RefSamplingParams(max_tokens=12),
                                 RefRequest)
    got, want = outcome(eng, done, mine), outcome(r, rdone, theirs)
    assert got == want
    assert b.stats.per_class == rb.stats.per_class
    assert got["tokens"] == clean_preempt()
    eng.audit()
    return eng, b, mine


@pytest.mark.parametrize("seam", ["swap_out_transfer", "swap_in_transfer"])
def test_swap_transfer_retry_heals(seam):
    eng, b, inj = preempting_outcomes(FaultSpec(seam=seam, times=2),
                                      swap_retries=2)
    assert eng.swap_stats["swapped_out"] > 0, "the drive never preempted"
    assert b.stats.failed == 0 and b.stats.swap_discards == 0
    assert inj.fired(seam) == 2
    assert eng.fault_stats["swap_recoveries"] >= 1
    assert eng.fault_stats["swap_giveups"] == 0


@pytest.mark.parametrize("seam", ["swap_out_transfer", "swap_in_transfer"])
def test_swap_transfer_exhaustion_discards_and_requeues(seam):
    eng, b, inj = preempting_outcomes(FaultSpec(seam=seam, times=3),
                                      swap_retries=2)
    assert b.stats.failed == 0 and b.stats.swap_discards >= 1
    assert b.stats.per_class["batch"]["swap_discards"] >= 1
    assert eng.fault_stats["swap_giveups"] >= 1
    assert b.alloc.free_blocks == b.alloc.num_blocks
    assert not eng._host_swaps, "orphaned host copy after a discard"


def test_swap_transfer_delay_is_benign():
    eng, b, inj = preempting_outcomes(
        FaultSpec(seam="swap_out_transfer", mode="delay", value=0.01))
    assert b.stats.failed == 0 and b.stats.swap_discards == 0
    assert inj.fired("swap_out_transfer") == 1


# -- KV corruption, poison, admission --------------------------------------------

@pytest.mark.parametrize("layout", ["paged", "contiguous"])
@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("mode", ["nan", "inf"])
def test_kv_corruption_quarantines_only_the_victim(layout, kv_dtype, mode):
    kw = dict(layout=layout, kv_dtype=kv_dtype)
    mine, theirs = injectors(FaultSpec(seam="kv_corrupt", mode=mode,
                                       after=2))
    eng = port(mine, **kw)
    done = eng.serve(prompts(), SamplingParams(**SP))
    r = ref(theirs, **kw)
    got = outcome(eng, done, mine)
    assert got == outcome(r, r.serve(prompts(), RefSamplingParams(**SP)),
                          theirs)
    assert len(got["failed"]) == 1
    assert set(got["failed"].values()) <= {"nonfinite_logits",
                                           "probe_nonfinite"}
    want = clean(**kw)
    assert all(got["tokens"][rid] == want[rid] for rid in want
               if rid not in got["failed"])
    assert eng.fault_stats["sentinel_trips"] >= 1
    eng.audit()
    # the scrub left the recycled storage clean: a second serve on the same
    # engine (the spec is spent) gives the clean tokens
    assert not mine.enabled
    assert tokens(eng.serve(prompts(), SamplingParams(**SP))) == want


def test_probe_nonfinite_quarantines_before_the_logits():
    """With the recovery probe every tick, the probe reads the corrupted
    block first: the victim fails ``probe_nonfinite``, as in the
    reference."""
    mine, theirs = injectors(FaultSpec(seam="kv_corrupt", after=2))
    eng = port(mine, telemetry_every=1)
    got = outcome(eng, eng.serve(prompts(), SamplingParams(**SP)), mine)
    r = ref(theirs, telemetry_every=1)
    assert got == outcome(r, r.serve(prompts(), RefSamplingParams(**SP)),
                          theirs)
    assert list(got["failed"].values()) == ["probe_nonfinite"]


def test_poisoned_request_fails_structurally():
    mine, theirs = injectors(FaultSpec(seam="poison_request", rid=1))
    eng = port(mine)
    done = eng.serve(prompts(), SamplingParams(**SP))
    r = ref(theirs)
    got = outcome(eng, done, mine)
    assert got == outcome(r, r.serve(prompts(), RefSamplingParams(**SP)),
                          theirs)
    by_rid = {d.rid: d for d in done}
    assert by_rid[1].failed and not by_rid[1].generated
    assert {k: v for k, v in got["tokens"].items() if k != 1} == {
        0: clean()[0], 2: clean()[2]}
    eng.audit()


def test_admission_alloc_fault_rolls_back_and_retries():
    mine, theirs = injectors(FaultSpec(seam="admission_alloc", times=1))
    eng = port(mine)
    done = eng.serve(prompts(), SamplingParams(**SP))
    r = ref(theirs)
    got = outcome(eng, done, mine)
    assert got == outcome(r, r.serve(prompts(), RefSamplingParams(**SP)),
                          theirs)
    assert got["tokens"] == clean() and not got["failed"]
    assert mine.fired("admission_alloc") == 1
    assert eng.kv.alloc.free_blocks == eng.kv.alloc.num_blocks
    eng.audit()


# -- the epoch swap ------------------------------------------------------------

def moved_plan(plan, layer_plan=LayerPlan):
    """A pure head move: the same budgets, the two shards' KV groups
    traded."""
    layers = []
    for lp in plan.layers:
        perm = np.array([2, 3, 0, 1], np.int64)
        inv = np.empty_like(perm)
        inv[perm] = np.arange(plan.num_heads)
        borig = np.zeros_like(lp.budgets)
        borig[lp.perm] = lp.budgets
        layers.append(layer_plan(
            perm=perm, inv_perm=inv, budgets=borig[perm],
            kv_perm=np.array([1, 0], np.int64),
            device_loads=lp.device_loads.copy(),
            assignment=lp.assignment))
    return dataclasses.replace(plan, layers=layers)


def test_epoch_swap_failure_rolls_back():
    from repro.core.planner import LayerPlan as RefLayerPlan
    mine, theirs = injectors(FaultSpec(seam="epoch_swap", times=1))
    eng = port(mine, shards=2)
    sp = SamplingParams(**SP)
    before = tokens(eng.serve(prompts(), sp))
    old_plan, old_epoch, old_params = eng.plan, eng.epoch, eng.params
    pool = eng.kv.pool
    assert eng.replan_now(plan=moved_plan(eng.plan)) is False
    assert eng.plan is old_plan and eng.epoch == old_epoch
    assert eng.params is old_params and eng.kv.pool is pool
    assert eng.fault_stats["replan_rollbacks"] == 1
    assert tokens(eng.serve(prompts(), sp)) == before
    assert eng.replan_now(plan=moved_plan(eng.plan)) is True
    assert eng.epoch == old_epoch + 1
    ctrl = port(shards=2)
    assert ctrl.replan_now(plan=moved_plan(ctrl.plan)) is True
    assert tokens(eng.serve(prompts(), sp)) == tokens(ctrl.serve(prompts(),
                                                                 sp))
    # the reference fires the same seam and counts the same: its tokens at
    # D = 2 are another computation (its prefill addresses the first
    # shard's heads only, ROADMAP.md section 3)
    r = ref(theirs, shards=2, fresh=True)
    r.serve(prompts(), RefSamplingParams(**SP))
    assert r.replan_now(plan=moved_plan(r.plan, RefLayerPlan)) is False
    r.serve(prompts(), RefSamplingParams(**SP))
    assert r.replan_now(plan=moved_plan(r.plan, RefLayerPlan)) is True
    r.serve(prompts(), RefSamplingParams(**SP))
    assert mine.events == theirs.events
    assert eng.fault_stats == r.fault_stats


# -- the auditor ---------------------------------------------------------------

def test_auditor_flags_double_mapped_block():
    alloc = BlockAllocator(8, 64)
    alloc.admit(0, 100, max_new_tokens=0)
    alloc.admit(1, 100, max_new_tokens=0)
    alloc._tables[1][0] = alloc._tables[0][0]
    with pytest.raises(IntegrityError) as ei:
        alloc.audit(strict=True)
    assert any("refcount" in f or "double" in f for f in ei.value.failures)
    assert not alloc.conserves()


def test_auditor_flags_free_list_leak():
    alloc = BlockAllocator(8, 64)
    alloc.admit(0, 100, max_new_tokens=0)
    assert alloc.conserves()
    alloc._free[0].append(alloc._tables[0][0])
    with pytest.raises(IntegrityError):
        alloc.audit(strict=True)


def test_auditor_flags_host_tier_mismatch():
    eng = port(tight=True, **PREEMPT)
    drive_preempting(eng, preempt_prompts(), SamplingParams(max_tokens=12),
                     Request)
    assert eng.swap_stats["swapped_out"] > 0
    eng.audit()
    eng._host_swaps[99] = {"data": torch.zeros(1), "scales": None,
                           "tokens": 64, "shared_blocks": 0,
                           "arrange": np.zeros(1), "event": None}
    with pytest.raises(IntegrityError):
        eng.audit()
    eng._host_swaps.pop(99)
    eng.audit()


# -- a shared prefix block -----------------------------------------------------

def test_corrupt_shared_block_fails_all_holders():
    kw = dict(budget_per_head=256, max_seq_len=512, prefix_cache=True,
              audit_every=1)
    sp = SamplingParams(max_tokens=10)
    want = tokens(port(**kw).serve(shared_prompts(), sp))
    mine, theirs = injectors(FaultSpec(seam="kv_corrupt", mode="nan",
                                       after=2))
    eng = port(mine, **kw)
    got = outcome(eng, eng.serve(shared_prompts(), sp), mine)
    r = ref(theirs, fresh=True, **kw)
    assert got == outcome(r, r.serve(shared_prompts(),
                                     RefSamplingParams(max_tokens=10)),
                          theirs)
    assert set(got["failed"]) == {0, 1}
    assert got["tokens"][2] == want[2]
    assert eng.prefix.stats["invalidated_blocks"] >= 1
    assert eng.prefix.stats == r.prefix.stats
    eng.audit()
    # the poisoned node is gone: the same prefix misses, prefills again and
    # gives the clean tokens
    hits = eng.prefix.stats["hits"]
    done = eng.serve(shared_prompts()[:1], sp)
    assert eng.prefix.stats["hits"] == hits
    assert tokens(done) == {0: want[0]}


# -- the scrub is load-bearing -------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_versions_leak_a_stale_nan_past_the_length(dtype):
    """A NaN past a sequence's length in its last block reaches the output
    of the plain versions of #1, #3 and #2 on the CPU (their p.V multiplies
    a masked key's zero weight into its value row, as the kernels do on
    the card): the engine's scrub, not the masking, keeps a recycled block
    from poisoning its next tenant."""
    cpu = torch.device("cpu")
    assert stale_nan_outputs(cpu, dtype, nan=False) == {
        "#1": True, "#3": True, "#2": True}
    assert stale_nan_outputs(cpu, dtype) == {
        "#1": False, "#3": False, "#2": False}


def test_skipped_scrub_poisons_a_recycled_block():
    """The planted control of the scrub on the CPU: the failed victim's
    corrupted block is moved second from the top of the free list, so the
    next request (60 prompt tokens, 8 new) maps it when its decode crosses
    into a second block.  A prefill writes whole blocks, but decode writes
    one position a tick: not scrubbed, the NaN past the new length reaches
    the output (the sentinel trips); scrubbed, the serve gives the clean
    tokens."""
    sp = SamplingParams(max_tokens=8)
    nxt = [prompts()[0]]
    want = tokens(port().serve(nxt, sp))
    for scrub in (True, False):
        inj = FaultInjector(FaultPlan(specs=(
            FaultSpec(seam="kv_corrupt", mode="nan", after=2),)))
        eng = port(inj)
        dirty, release = [], eng._release_seq

        def spy(rid, slot, eng=eng, dirty=dirty, release=release,
                scrub=scrub):
            dirty.extend(eng.kv.alloc.table(rid))
            if scrub:
                release(rid, slot)
        eng._release_seq = spy               # make_batcher wires the hook
        assert sum(r.failed for r in eng.serve(prompts(), sp)) == 1
        free = eng.kv.alloc._free[0]
        for b in dirty:
            free.remove(b)
            free.insert(len(free) - 1, b)    # popped second
        got = eng.serve(nxt, sp)
        assert eng.kv.alloc.table(0) == [] and dirty
        if scrub:
            assert tokens(got) == want and not got[0].failed
        else:
            assert got[0].failed
            assert got[0].fail_reason == "nonfinite_logits"
