"""Chaos conservation of the port's scheduler (§2.13), the port's
counterpart of ``tests/test_faults_props.py`` as a seeded sweep.

From a seed come a request stream (class-tagged, staggered arrivals,
over-length outliers) and a fault schedule (admission exhaustion through
the allocator's ``admission_alloc`` seam, swap transfers failing in the
engine hooks, sentinel quarantines of random slots).  At EVERY tick
``completed + rejected + failed`` equals the requests handed back and the
allocator's two tiers audit clean; after the drain every request came
back, the pool is whole and the host tier empty.

The reference's own scheduler fails this sweep at seeds 79, 193, 221 and
4999: ``_resume_preempted`` pops a request off its preempted queue and
calls ``alloc.swap_in``, whose ``admission_alloc`` seam raises
``InjectedAllocError``; the allocator rolls back, but nothing catches the
error, so it escapes ``tick()`` with the request in no queue.  The port
puts the request back at the head of its queue and retries next tick;
:func:`test_reference_resume_swap_in_fault_escapes` records the
reference's fault.
"""
import numpy as np
import pytest

from repro_torch.serving.faults import (
    FaultInjector, FaultPlan, InjectedAllocError, TransferError)
from repro_torch.serving.sampler import SamplingParams
from repro_torch.serving.scheduler import (
    DEFAULT_CLASSES, ContinuousBatcher, Request)

SEEDS = list(range(60)) + [79, 193, 221, 4999]


class ChaoticFake:
    """Slot-accurate fake engine with fault hooks: swap transfers consult
    the injector (raising TransferError as the engine's exhausted retry
    gate does), and a seeded sentinel quarantines active slots."""

    def __init__(self, b: ContinuousBatcher, rng, injector,
                 sentinel_p: float):
        self.b = b
        self.rng = rng
        self.injector = injector
        self.sentinel_p = sentinel_p
        self.on_fail_calls: list[tuple] = []

    def prefill(self, toks, slot, q_offset, is_final, prompt_len):
        return int(self.rng.integers(0, 50)) if is_final else None

    def decode(self, slots, toks, pos):
        return self.rng.integers(0, 50, size=len(slots)).astype(np.int32)

    def swap_out(self, rid, slot, resident):
        if self.injector.fire("swap_out_transfer", rid=rid) is not None:
            raise TransferError("swap_out_transfer", "injected", rid=rid)

    def swap_in(self, rid, slot, resident):
        if self.injector.fire("swap_in_transfer", rid=rid) is not None:
            raise TransferError("swap_in_transfer", "injected", rid=rid)

    def sentinel(self):
        out = {}
        for slot in list(self.b._rid_of):
            if self.rng.random() < self.sentinel_p:
                out[slot] = "injected_sentinel"
        return out

    def on_fail(self, rid, slot):
        self.on_fail_calls.append((rid, slot))


def chaos_stream(seed: int):
    """The reference helper's stream and schedule, drawn in its order from
    the same seed, on the port's scheduler."""
    rng = np.random.default_rng(seed)
    num_slots = int(rng.integers(1, 4))
    max_seq_len, block = 512, 128
    num_blocks = int(rng.integers(num_slots + 1, num_slots * 4 + 1))
    n = int(rng.integers(4, 16))
    plan = FaultPlan.random(
        seed, rate=float(rng.uniform(0.0, 0.15)), horizon=40,
        seams=("admission_alloc", "swap_out_transfer",
               "swap_in_transfer"), max_rid=n)
    injector = FaultInjector(plan)
    b = ContinuousBatcher(
        num_slots=num_slots, num_blocks=num_blocks,
        max_seq_len=max_seq_len, block=block,
        token_budget=[None, 128, 256][int(rng.integers(0, 3))],
        admission=["fifo", "slo"][int(rng.integers(0, 2))],
        preemption=True,
        host_blocks=[None, 0, 4][int(rng.integers(0, 3))])
    eng = ChaoticFake(b, rng, injector,
                      sentinel_p=float(rng.uniform(0.0, 0.06)))
    b.swap_out_fn = eng.swap_out
    b.swap_in_fn = eng.swap_in
    b.sentinel_fn = eng.sentinel
    b.on_fail_fn = eng.on_fail
    b.alloc.injector = injector
    names = [c.name for c in DEFAULT_CLASSES]
    reqs = []
    for i in range(n):
        length = (int(rng.integers(max_seq_len, max_seq_len * 2))
                  if rng.random() < 1 / 8
                  else int(rng.integers(1, 400)))
        reqs.append(Request(
            rid=i, prompt=np.arange(length) % 256,
            sampling=SamplingParams(max_tokens=int(rng.integers(1, 8))),
            priority=names[int(rng.integers(0, len(names)))]))
    return b, eng, reqs


@pytest.mark.parametrize("seed", SEEDS)
def test_chaos_conservation_every_tick(seed):
    b, eng, reqs = chaos_stream(seed)
    rng = np.random.default_rng(seed + 1)
    cut = int(rng.integers(0, len(reqs) + 1))
    for r in reqs[:cut]:
        b.submit(r)
    done: list[Request] = []
    ticks = 0
    submitted_rest = False
    while (b.busy or not submitted_rest) and ticks < 5_000:
        done.extend(b.tick(eng.prefill, eng.decode))
        ticks += 1
        if not submitted_rest and ticks >= int(rng.integers(1, 6)):
            for r in reqs[cut:]:
                b.submit(r)
            submitted_rest = True
        st = b.stats
        assert st.completed + st.rejected + st.failed == len(done), \
            "a request left the system without being handed back"
        assert b.alloc.conserves(), "two-tier conservation broke"
    assert not b.busy, "the chaos stream did not drain"
    st = b.stats
    assert sorted(r.rid for r in done) == sorted(r.rid for r in reqs)
    assert st.completed + st.rejected + st.failed == len(reqs)
    assert b.alloc.free_blocks == b.alloc.num_blocks
    assert b.alloc.host_allocated_blocks == 0
    assert b.alloc.swapped_seqs == () and b._slot_of == {}
    failed = [r for r in done if r.failed]
    assert len(failed) == st.failed
    assert all(r.done and r.fail_reason for r in failed)
    assert len(eng.on_fail_calls) >= len(failed)
    per = b.stats.per_class
    assert sum(c["submitted"] for c in per.values()) == len(reqs)
    for name, c in per.items():
        assert c["completed"] + c["rejected"] + c["failed"] == \
            c["submitted"], name


def test_the_sweep_reaches_the_resume_fault():
    """Seed 79's stream does hit a swap-in admission fault, which the port
    survives: the repair is exercised, not just the happy path."""
    b, eng, reqs = chaos_stream(79)
    rng = np.random.default_rng(80)
    cut = int(rng.integers(0, len(reqs) + 1))
    for r in reqs[:cut]:
        b.submit(r)
    resumes, real = [], b.alloc.swap_in

    def spy(rid, n):
        try:
            return real(rid, n)
        except InjectedAllocError:
            resumes.append(rid)
            raise
    b.alloc.swap_in = spy
    ticks, rest = 0, False
    while (b.busy or not rest) and ticks < 5_000:
        b.tick(eng.prefill, eng.decode)
        ticks += 1
        if not rest and ticks >= int(rng.integers(1, 6)):
            for r in reqs[cut:]:
                b.submit(r)
            rest = True
    assert resumes and not b.busy


def test_reference_resume_swap_in_fault_escapes():
    """The reference's fault, recorded: its chaos helper at seed 79 raises
    ``InjectedAllocError`` out of ``tick()`` (its ``_resume_preempted``
    does not catch the swap-in's admission fault)."""
    from repro.serving.faults import InjectedAllocError as RefAllocError
    from test_faults_props import _chaos_conservation_every_tick
    with pytest.raises(RefAllocError):
        _chaos_conservation_every_tick(79)
