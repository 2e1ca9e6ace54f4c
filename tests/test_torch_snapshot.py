"""Crash-consistent serving snapshots (§2.13) in the port, at the
reference fault tests' ``CFG`` in float32 (``tests/test_torch_faults.py``):

- an engine ticked part way, saved, deleted and restored finishes with the
  uninterrupted run's tokens, bit for bit: paged bf16 and int8, contiguous
  bf16, the prefix cache at S = 2 seq stripes (whose restored tree still
  hits, and gives the tokens of a warm engine), stochastic sampling (the
  generator's state travels), and a sequence on the host tier;
- the checkpoint policy writes at the reference's ticks, only at safe
  points, and its latest snapshot restores and drains;
- ``BlockAllocator.snapshot_state()`` and ``RadixPrefixCache.snapshot_state()``
  equal the reference's at the same tick (stripes, refcounts and cache
  pins included);
- the port restores a snapshot the JAX engine wrote (paged, contiguous
  int8, a victim on the host) and finishes with the JAX engine's tokens.
"""
import os

import numpy as np
import pytest
import torch

from repro.serving import SamplingParams as RefSamplingParams
from repro.serving import snapshot as ref_snapshot
from repro.serving.scheduler import Request as RefRequest
from repro_torch.core.sparsity import synthetic_head_curves
from repro_torch.serving import EngineConfig, SamplingParams
from repro_torch.serving.scheduler import Request
from repro_torch.serving.snapshot import (
    latest_snapshot, restore_serving, save_serving)
from test_torch_faults import (
    CFG, PREEMPT, port, preempt_prompts, prompts, ref, settings,
    shared_prompts, tokens, weights)

torch.set_num_threads(1)

STOCHASTIC = dict(temperature=0.8, top_k=50, top_p=0.95)
PREFIX = dict(budget_per_head=256, max_seq_len=512, prefix_cache=True,
              seq_shards=2, audit_every=1)


def start(eng, ps, sp, request_cls=Request, priorities=None):
    b = eng.make_batcher()
    for i, p in enumerate(ps):
        b.submit(request_cls(rid=i, prompt=np.asarray(p, np.int32),
                             sampling=sp,
                             priority=(priorities[i] if priorities
                                       else "standard")))
    return b, *eng.step_fns(sp)


def run(eng, b, pf, df, until=None):
    """Tick (with the engine's per-tick policy) until ``until(b)`` holds
    at a safe point, or until drained.  Returns the finished requests."""
    done = []
    while b.busy:
        if until is not None and b.replan_safe and until(b):
            break
        done.extend(b.tick(pf, df))
        eng.on_tick(b)
    return done


def start_preempting(eng, sp, request_cls=Request):
    """The preempting drive of ``test_torch_faults``: two batch requests
    tick six times, then an interactive arrival the tight pool cannot
    hold beside them is submitted.  Returns the batcher, the step
    functions and the requests finished so far."""
    ps = preempt_prompts()
    b, pf, df = start(eng, ps[:2], sp, request_cls, ("batch", "batch"))
    done = []
    for _ in range(6):
        done.extend(b.tick(pf, df))
        eng.on_tick(b)
    b.submit(request_cls(rid=2, prompt=np.asarray(ps[2], np.int32),
                         sampling=sp, priority="interactive"))
    return b, pf, df, done


def on_host(b) -> bool:
    return bool(b.alloc.swapped_seqs)


def restore(path, **kw):
    cfg, params = weights()[2:]
    return restore_serving(path, cfg, params,
                           EngineConfig(**settings(**kw)),
                           synthetic_head_curves(CFG.num_layers,
                                                 CFG.num_heads),
                           device="cpu")


def mid_stream(eng):
    """Stop once six decode ticks ran and requests are decoding."""
    return lambda b: eng._decode_ticks >= 6 and bool(b.active)


CASES = {
    "paged-bf16": (dict(), prompts, dict(max_tokens=16)),
    "paged-int8": (dict(kv_dtype="int8"), prompts, dict(max_tokens=16)),
    "contiguous-bf16": (dict(layout="contiguous"), prompts,
                        dict(max_tokens=16)),
    "prefix-S2": (PREFIX, shared_prompts, dict(max_tokens=16)),
    "stochastic": (dict(), prompts, dict(max_tokens=16, **STOCHASTIC)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_restore_resumes_bit_for_bit(case, tmp_path):
    kw, traffic, spk = CASES[case]
    sp = SamplingParams(**spk)
    eng = port(**kw)
    want = tokens(run(eng, *start(eng, traffic(), sp)))
    assert len(want) == len(traffic())
    eng = port(**kw)
    b, pf, df = start(eng, traffic(), sp)
    done = run(eng, b, pf, df, until=mid_stream(eng))
    assert b.active, "the crash must land mid-stream"
    path = save_serving(str(tmp_path), eng, b)
    hits = eng.prefix.stats["hits"] if eng.prefix is not None else None
    del eng, b, pf, df
    eng, b = restore(path, **kw)
    pf, df = eng.step_fns(sp)
    done += run(eng, b, pf, df)
    assert tokens(done) == want
    eng.audit()
    if hits is not None:
        # the restored tree still hits: a later request on the shared
        # prefix maps it and gives the warm engine's tokens
        assert hits > 0 and eng.prefix.num_blocks > 0
        before = eng.prefix.stats["hits"]
        b.submit(Request(rid=100, prompt=np.asarray(shared_prompts()[0],
                                                    np.int32), sampling=sp))
        again = tokens(run(eng, b, pf, df))
        assert eng.prefix.stats["hits"] > before
        assert again[100] == want[0]


def test_restore_with_a_sequence_on_the_host(tmp_path):
    """Saved while a preempted victim sits on the host tier: its copy
    travels in the snapshot and swaps back in after the restore."""
    sp = SamplingParams(max_tokens=12)
    kw = dict(tight=True, **PREEMPT)
    eng = port(**kw)
    b, pf, df, done = start_preempting(eng, sp)
    done += run(eng, b, pf, df, until=on_host)
    assert b.alloc.swapped_seqs and b.busy
    path = save_serving(str(tmp_path), eng, b)
    want = tokens(done + run(eng, b, pf, df))
    eng, b = restore(path, **kw)
    assert set(eng._host_swaps) == set(b.alloc.swapped_seqs)
    pf, df = eng.step_fns(sp)
    rest = tokens(run(eng, b, pf, df))
    assert eng.swap_stats["swapped_in"] >= 1
    assert rest and all(rest[rid] == want[rid] for rid in rest)
    eng.audit()


def test_checkpoint_policy_writes_at_safe_boundaries(tmp_path):
    """Every ``checkpoint_every`` decode ticks at a safe point, as the JAX
    engine does (the same snapshot names); the latest restores and
    drains."""
    sp = SamplingParams(max_tokens=12)
    mine, theirs = tmp_path / "port", tmp_path / "ref"
    eng = port(checkpoint_dir=str(mine), checkpoint_every=3)
    eng.serve(prompts(), sp)
    r = ref(checkpoint_dir=str(theirs), checkpoint_every=3)
    r.serve(prompts(), RefSamplingParams(max_tokens=12))
    assert eng.fault_stats["checkpoints"] == r.fault_stats["checkpoints"] > 0
    assert sorted(os.listdir(mine)) == sorted(os.listdir(theirs))
    path = latest_snapshot(str(mine))
    assert path is not None and not any(".tmp." in f
                                        for f in os.listdir(mine))
    eng, b = restore(path, checkpoint_dir=str(tmp_path / "again"))
    pf, df = eng.step_fns(sp)
    run(eng, b, pf, df)
    assert not b.busy


def test_allocator_and_tree_state_equal_the_reference():
    """Tick by tick through the shared-prefix traffic at S = 2: the
    allocator's snapshot (free-list order per stripe, tables, reservations,
    cache pins) and the tree's (keys, block ids, LRU clocks) equal the JAX
    engine's."""
    sp = SamplingParams(max_tokens=10)
    eng = port(**PREFIX)
    b, pf, df = start(eng, shared_prompts(), sp)
    r = ref(fresh=True, **PREFIX)
    rb, rpf, rdf = start(r, shared_prompts(), RefSamplingParams(max_tokens=10),
                         RefRequest)
    ticks = 0
    while b.busy or rb.busy:
        b.tick(pf, df)
        rb.tick(rpf, rdf)
        ticks += 1
        assert b.alloc.snapshot_state() == rb.alloc.snapshot_state(), ticks
        assert eng.prefix.snapshot_state() == r.prefix.snapshot_state()
    assert eng.prefix.num_blocks > 0 and ticks > 5


@pytest.mark.parametrize("kind", ["paged", "contiguous-int8", "on-host"])
def test_port_restores_a_jax_snapshot(kind, tmp_path):
    """The JAX engine ticks part way and writes its snapshot; the port
    restores it (the reference's keys, bf16 bits, meta inside the archive)
    and finishes with the JAX engine's uninterrupted tokens."""
    kw = {"paged": dict(),
          "contiguous-int8": dict(layout="contiguous", kv_dtype="int8"),
          "on-host": dict(tight=True, **PREEMPT)}[kind]
    n = 12 if kind == "on-host" else 16
    rsp = RefSamplingParams(max_tokens=n)

    def drive(r):
        if kind == "on-host":
            return start_preempting(r, rsp, RefRequest)
        return (*start(r, prompts(), rsp, RefRequest), [])
    r = ref(**kw)
    rb, rpf, rdf, done = drive(r)
    want = tokens(done + run(r, rb, rpf, rdf))
    r = ref(**kw)
    rb, rpf, rdf, done = drive(r)
    done += run(r, rb, rpf, rdf,
                until=on_host if kind == "on-host" else mid_stream(r))
    path = ref_snapshot.save_serving(str(tmp_path), r, rb)
    eng, b = restore(path, **kw)
    if kind == "on-host":
        assert eng._host_swaps
    pf, df = eng.step_fns(SamplingParams(max_tokens=n))
    done += run(eng, b, pf, df)
    assert tokens(done) == want
    eng.audit()
