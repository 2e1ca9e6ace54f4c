"""Continuous-batching scheduler: chunked prefill + mixed prefill/decode
ticks (Sarathi-style), with graceful degradation under overload (§2.10) —
the reference's ``serving/scheduler.py`` without its fault hooks (§2.13)
and prefix cache (§2.14).

Each tick runs at most one prefill CHUNK plus the full decode batch.
Prompts split into block-aligned chunks (only the final chunk may be
partial) of ``max(block, token_budget - num_active_decodes)`` tokens, so a
long prompt is amortized over many ticks while decodes keep stepping.
``token_budget=None`` is monolithic prefill: every admitted prompt is
prefilled whole, at admission, as one final chunk.

Overload layer.  Requests carry a :class:`PriorityClass` (per-class TTFT /
ITL targets), queued one deque per class.  Three composable policies:

- ``admission="fifo"`` (default): class-blind global arrival order, the
  degradation baseline;
- ``admission="slo"``: classes admit in level order (0 = most urgent;
  stride weights share a level), a cost-model gate DEFERS a class whose
  prefill would break a strictly-higher active class's ITL target, and
  requests that out-wait their class deadline are shed (rejected with
  ``reject_reason="slo_timeout"``) after the admission pass;
- ``preemption=True``: when a request cannot be placed, strictly-lower
  class work is preempted: a mid-prefill victim is discarded back to the
  head of its queue (restart-on-resume), a decoding victim is swapped out
  (the engine copies its mapped blocks to the host tier, ``swap_out_fn``,
  then the allocator migrates its accounting) and its slot frees.  Resume
  reverses it (``swap_in_fn`` after :meth:`BlockAllocator.swap_in`) and
  re-enters the decode batch with no re-prefill.

Contracts kept from the reference: over-length requests are rejected but
still returned (``completed + rejected == submitted``); the token sampled at
prefill passes the same completion check as decode tokens; admission
reserves a request's worst case (prompt + max_tokens) and maps only the
prompt's blocks, every decode tick accounts the token it writes via
``append_token`` before the device step, and completion frees the blocks.
The clock is injected (``clock``), and it times the cost model's EMAs.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from collections import deque
from typing import Callable

import numpy as np

from repro_torch.serving.kv_cache import BlockAllocator
from repro_torch.serving.sampler import SamplingParams

log = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class PriorityClass:
    """One service class: scheduling level + the SLOs admission protects.

    ``level``: 0 is most urgent; SLO admission scans levels ascending and
    preemption only ever claims victims of a strictly GREATER level.
    ``weight``: stride-scheduling share among classes at the SAME level
    (per admission, a class consumes ``1/weight`` of a stride pass; the
    class with the least consumed stride goes first).
    ``ttft_target_s`` / ``itl_target_s``: per-class targets — the SLO gate
    defers lower classes when they would break a higher class's ITL.
    ``reject_after_s``: queue residency after which a still-unplaceable
    request is shed; None derives ``ttft_target_s * reject_slack``.
    """
    name: str
    level: int
    ttft_target_s: float
    itl_target_s: float
    weight: float = 1.0
    reject_after_s: float | None = None


DEFAULT_CLASSES: tuple[PriorityClass, ...] = (
    PriorityClass("interactive", 0, ttft_target_s=0.5, itl_target_s=0.1),
    PriorityClass("standard", 1, ttft_target_s=2.0, itl_target_s=0.4),
    PriorityClass("batch", 2, ttft_target_s=30.0, itl_target_s=2.0),
)


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                  # [S] int32
    sampling: SamplingParams = dataclasses.field(
        default_factory=SamplingParams)
    priority: str = "standard"          # PriorityClass name
    # filled during execution:
    generated: list[int] = dataclasses.field(default_factory=list)
    done: bool = False
    rejected: bool = False              # refused (over-length / SLO shed)
    reject_reason: str | None = None    # over_length|over_capacity|slo_timeout
    prefill_pos: int = 0                # prompt tokens prefilled so far
    preemptions: int = 0                # times swapped out or discarded
    # scheduler-clock telemetry: t_done is stamped at retire AND at
    # rejection, so queue_delay reports time-to-rejection for shed requests
    t_submit: float | None = None
    t_done: float | None = None
    token_times: list[float] = dataclasses.field(default_factory=list)

    @property
    def ttft(self) -> float | None:
        if self.t_submit is None or not self.token_times:
            return None
        return self.token_times[0] - self.t_submit

    @property
    def itl(self) -> list[float]:
        return list(np.diff(self.token_times)) if len(
            self.token_times) > 1 else []

    @property
    def queue_delay(self) -> float | None:
        """Submit -> first token, or submit -> rejection for requests that
        never produced one (time-to-rejection per class)."""
        if self.t_submit is None:
            return None
        if self.token_times:
            return self.token_times[0] - self.t_submit
        if self.t_done is not None:
            return self.t_done - self.t_submit
        return None


def _class_counters() -> dict[str, int]:
    """The reference's per-class counters; ``failed`` and
    ``swap_discards`` belong to the fault layer (§2.13) and stay 0."""
    return {"submitted": 0, "admitted": 0, "completed": 0, "rejected": 0,
            "failed": 0, "preempted": 0, "resumed": 0, "swap_discards": 0,
            "swapped_out_blocks": 0, "swapped_in_blocks": 0}


@dataclasses.dataclass
class SchedulerStats:
    admitted: int = 0
    completed: int = 0
    rejected: int = 0
    decode_steps: int = 0
    prefill_tokens: int = 0
    prefill_chunks: int = 0
    preempted: int = 0
    resumed: int = 0
    deferred: int = 0                   # SLO-gate admission deferrals
    swapped_out_blocks: int = 0
    swapped_in_blocks: int = 0
    per_class: dict[str, dict[str, int]] = dataclasses.field(
        default_factory=dict)


class ContinuousBatcher:
    """Drives (prefill_chunk_fn, decode_fn) over a stream of requests.

    prefill_chunk_fn(tokens[1, C], slot, q_offset, is_final, prompt_len)
        -> first sampled token when ``is_final`` else None
    decode_fn(active_slots, tokens, positions) -> next tokens (per slot)

    ``token_budget``: per-tick token budget shared by one prefill chunk and
    the decode batch, or None for monolithic prefill (whole prompts at
    admission).  ``allocator``: share the engine's pool allocator so
    admission and the device pool count the same blocks.

    Overload knobs: ``classes`` (the PriorityClass table), ``admission``
    ("fifo" | "slo"), ``preemption`` (allow swap-out of strictly-lower
    classes), ``host_blocks`` (the private allocator's swap-tier cap),
    ``swap_out_fn(rid, slot, resident_tokens)`` / ``swap_in_fn(rid, slot,
    resident_tokens)``: engine hooks that move the victim's mapped blocks
    device <-> host around the allocator's accounting swap (None =
    accounting only, for host-side tests).
    """

    def __init__(self, *, num_slots: int, num_blocks: int,
                 max_seq_len: int, token_budget: int | None,
                 block: int = 128,
                 allocator: BlockAllocator | None = None,
                 classes: tuple[PriorityClass, ...] = DEFAULT_CLASSES,
                 admission: str = "fifo",
                 preemption: bool = False,
                 reject_slack: float = 8.0,
                 host_blocks: int | None = None,
                 swap_out_fn: Callable | None = None,
                 swap_in_fn: Callable | None = None,
                 clock: Callable[[], float] = time.monotonic):
        if admission not in ("fifo", "slo"):
            raise ValueError(f"unknown admission policy {admission!r}")
        self.alloc = allocator or BlockAllocator(num_blocks, block,
                                                 host_blocks=host_blocks)
        self.max_seq_len = max_seq_len
        self.block = block
        self.token_budget = token_budget
        self.classes: dict[str, PriorityClass] = {c.name: c for c in classes}
        self.admission = admission
        self.preemption = preemption
        self.reject_slack = reject_slack
        self.swap_out_fn = swap_out_fn
        self.swap_in_fn = swap_in_fn
        self._queues: dict[str, deque[Request]] = {
            c.name: deque() for c in classes}
        self._preempted: dict[str, deque[Request]] = {
            c.name: deque() for c in classes}
        self._stride: dict[str, float] = {c.name: 0.0 for c in classes}
        self._arrival: dict[int, int] = {}  # rid -> global FIFO order
        self.active: dict[int, Request] = {}
        self.prefilling: Request | None = None
        self.lengths: dict[int, int] = {}
        self.stats = SchedulerStats()
        self._slots_free = list(range(num_slots))
        self._slot_of: dict[int, int] = {}
        self._rid_of: dict[int, int] = {}   # inverse: slot -> rid
        self._clock = clock
        # cost-model EMAs (measured in tick; None until first observation)
        self.ema_decode_s: float | None = None
        self.ema_prefill_s_per_tok: float | None = None

    def rid_of_slot(self, slot: int) -> int:
        """The request bound to ``slot`` (the paged engine maps slots to
        block tables through this)."""
        return self._rid_of[slot]

    def submit(self, req: Request):
        if req.priority not in self.classes:
            raise KeyError(f"unknown priority class {req.priority!r}")
        req.t_submit = self._clock()
        self._arrival[req.rid] = len(self._arrival)
        self._queues[req.priority].append(req)
        self._cstat(req.priority)["submitted"] += 1

    def _cstat(self, name: str) -> dict[str, int]:
        return self.stats.per_class.setdefault(name, _class_counters())

    @property
    def pending(self) -> list[Request]:
        """Queued (not yet admitted) requests of every class, in arrival
        order."""
        reqs = [r for q in self._queues.values() for r in q]
        return sorted(reqs, key=lambda r: self._arrival[r.rid])

    @property
    def busy(self) -> bool:
        return bool(any(self._queues.values())
                    or any(self._preempted.values())
                    or self.active or self.prefilling)

    @property
    def replan_safe(self) -> bool:
        """True at a plan-epoch swap safe point: no prefill chunk sequence
        is in flight, so no prompt's chunks straddle two epochs (a
        prompt's chunk work lists are slices of one epoch's lists; decode
        selections are re-derived every tick, so resident decodes swap
        cleanly).  Sequences swapped out to the host may straddle a swap:
        the engine re-arranges their host copy once, at swap-in."""
        return self.prefilling is None

    def preview_next_decode(self):
        """Best-effort ``(slots, positions)`` of the next tick's decode
        batch, so the engine can plan that tick while this one's step runs
        on the card.

        Called from inside this tick's ``decode_fn`` (lengths not yet
        advanced): each active request decodes next at its current length.
        Completions this tick and a prefill finishing into the batch are
        ignored; a wrong guess only means the real signature is planned at
        the next tick.  None when nothing is decoding."""
        if not self.active:
            return None
        rids = sorted(self.active)
        return [self._slot_of[r] for r in rids], [self.lengths[r]
                                                  for r in rids]

    def _record_token(self, req: Request, token: int) -> bool:
        """Append a sampled token; True iff the request just completed."""
        req.generated.append(int(token))
        req.token_times.append(self._clock())
        sp = req.sampling
        return (len(req.generated) >= sp.max_tokens
                or (sp.stop_token is not None
                    and int(token) == sp.stop_token))

    # -- admission order -----------------------------------------------------
    def _class_order(self) -> list[PriorityClass]:
        """SLO admission scan order: strictly by level; stride passes
        (admissions / weight) share a level between equal-level classes."""
        return sorted(self.classes.values(),
                      key=lambda c: (c.level, self._stride[c.name], c.name))

    def _next_pending(self) -> tuple[PriorityClass, deque] | None:
        """The queue to admit from next, or None when all are empty.  fifo:
        the queue whose head arrived first, class-blind; slo: class
        order."""
        if self.admission == "fifo":
            heads = [(self._arrival[q[0].rid], name)
                     for name, q in self._queues.items() if q]
            if not heads:
                return None
            name = min(heads)[1]
            return self.classes[name], self._queues[name]
        for pc in self._class_order():
            if self._queues[pc.name]:
                return pc, self._queues[pc.name]
        return None

    def _higher_waiting(self, level: int) -> bool:
        """Any strictly-higher class with queued or preempted work?"""
        return any((self._queues[c.name] or self._preempted[c.name])
                   for c in self.classes.values() if c.level < level)

    def _slo_deferred(self, pc: PriorityClass, req: Request) -> bool:
        """Cost-model admission gate: defer class ``pc`` when the predicted
        tick latency (decode EMA + chunk tokens x prefill-per-token EMA)
        would break a strictly-higher ACTIVE class's ITL target.  Off until
        both EMAs have observations."""
        if self.admission != "slo":
            return False
        higher = [self.classes[r.priority].itl_target_s
                  for r in self.active.values()
                  if self.classes[r.priority].level < pc.level]
        if self.prefilling is not None:
            ppc = self.classes[self.prefilling.priority]
            if ppc.level < pc.level:
                higher.append(ppc.itl_target_s)
        if (not higher or self.ema_decode_s is None
                or self.ema_prefill_s_per_tok is None):
            return False
        chunk = (len(req.prompt) if self.token_budget is None
                 else min(len(req.prompt), max(self.block, self.token_budget)))
        pred = self.ema_decode_s + chunk * self.ema_prefill_s_per_tok
        return pred > min(higher)

    # -- preemption ----------------------------------------------------------
    def _victims(self, pc: PriorityClass) -> list[Request]:
        """Preemption candidates for an arrival of class ``pc``: strictly
        LOWER-priority work only, cheapest progress loss first — the
        mid-prefill sequence (discarded, not swapped) ahead of decoding
        sequences, then lowest class, then latest arrival (LIFO)."""
        cands = [r for r in self.active.values()
                 if self.classes[r.priority].level > pc.level]
        if (self.prefilling is not None and
                self.classes[self.prefilling.priority].level > pc.level):
            cands.append(self.prefilling)
        return sorted(cands, key=lambda r: (
            r is not self.prefilling,
            -self.classes[r.priority].level,
            -(r.t_submit or 0.0)))

    def _make_room(self, pc: PriorityClass, req: Request) -> bool:
        """Secure a slot + blocks (+ the prefill slot, in chunked mode) for
        ``req``, preempting strictly-lower-class work when allowed.
        Victims are simulated first and only preempted when the plan
        actually fits, so a hopeless arrival never thrashes the pool."""
        need = self.alloc.blocks_needed(
            len(req.prompt) + req.sampling.max_tokens)
        free_slots = len(self._slots_free)
        avail = self.alloc.available_blocks
        prefill_busy = self.prefilling is not None
        host_free = self.alloc.host_free_blocks   # None = unbounded

        def fits() -> bool:
            return (free_slots >= 1 and avail >= need
                    and not (self.token_budget is not None and prefill_busy))

        if fits():
            return True
        if not self.preemption:
            return False
        chosen: list[Request] = []
        for v in self._victims(pc):
            if fits():
                break
            if v is self.prefilling:
                prefill_busy = False
                # discard releases everything it holds
                avail += self.alloc.release_estimate(v.rid)
            else:
                vblk = len(self.alloc.swap_split(v.rid)[1])
                if host_free is not None:
                    if vblk > host_free:
                        continue   # the host tier can't hold this victim
                    host_free -= vblk
                avail += self.alloc.swap_release_estimate(v.rid)
            free_slots += 1
            chosen.append(v)
        if not fits():
            return False
        for v in chosen:
            self._preempt(v)
        return True

    def _preempt(self, req: Request):
        """Evict ``req``.  Mid-prefill: discard the partial chunk state
        (restart-on-resume: blocks free at once, the prompt is still in
        ``req.prompt``) back to the HEAD of its class queue.  Decoding:
        swap its mapped blocks to the host tier (engine hook first, while
        the ids are still valid; then the allocator migrates the accounting
        and the ids become reusable) and park it on the resume queue; its
        generated tokens stay on the request, so resume continues with no
        re-prefill."""
        name = req.priority
        req.preemptions += 1
        self.stats.preempted += 1
        self._cstat(name)["preempted"] += 1
        slot = self._slot_of.pop(req.rid)
        self._rid_of.pop(slot, None)
        self._slots_free.append(slot)
        if req is self.prefilling:
            self.prefilling = None
            req.prefill_pos = 0
            self.alloc.free(req.rid)
            self._queues[name].appendleft(req)
            log.info("preempt (discard) mid-prefill rid=%d class=%s",
                     req.rid, name)
            return
        resident = self.alloc.seq_tokens(req.rid)
        if self.swap_out_fn is not None:
            self.swap_out_fn(req.rid, slot, resident)
        # the ids are released here while the hook's gather may still be in
        # flight on the card: stream order keeps a new tenant's writes to a
        # recycled id (queued later on the same stream) from landing before
        # the gather has read it
        nblk = self.alloc.swap_out(req.rid)
        self.stats.swapped_out_blocks += nblk
        self._cstat(name)["swapped_out_blocks"] += nblk
        self.active.pop(req.rid, None)
        self.lengths.pop(req.rid, None)
        self._preempted[name].append(req)
        log.info("preempt (swap-out) rid=%d class=%s blocks=%d resident=%d",
                 req.rid, name, nblk, resident)

    def _resume_preempted(self):
        """Swap preempted sequences back in, class order, before any new
        admission of the same-or-lower class: they hold generation
        progress.  A class's resumes wait while a strictly-higher class
        has work waiting (it gets first claim on the freed capacity)."""
        for pc in self._class_order():
            q = self._preempted[pc.name]
            while q:
                if self._higher_waiting(pc.level) or not self._slots_free:
                    return
                req = q[0]
                remaining = req.sampling.max_tokens - len(req.generated)
                if not self.alloc.can_swap_in(req.rid, remaining):
                    break   # not enough device headroom yet
                q.popleft()
                resident = self.alloc.host_tokens(req.rid)
                ids = self.alloc.swap_in(req.rid, remaining)
                slot = self._slots_free.pop()
                self._slot_of[req.rid] = slot
                self._rid_of[slot] = req.rid
                if self.swap_in_fn is not None:
                    self.swap_in_fn(req.rid, slot, resident)
                # resident counts tokens IN cache; lengths counts the
                # pending not-yet-written token too (generated[-1] decodes
                # next at position == resident)
                self.lengths[req.rid] = resident + 1
                self.active[req.rid] = req
                self.stats.resumed += 1
                self._cstat(pc.name)["resumed"] += 1
                self.stats.swapped_in_blocks += len(ids)
                self._cstat(pc.name)["swapped_in_blocks"] += len(ids)
                log.info("resume (swap-in) rid=%d class=%s blocks=%d",
                         req.rid, pc.name, len(ids))

    def _reject(self, req: Request, reason: str, finished: list[Request]):
        req.done = True
        req.rejected = True
        req.reject_reason = reason
        req.t_done = self._clock()
        self.stats.rejected += 1
        self._cstat(req.priority)["rejected"] += 1
        finished.append(req)
        log.warning("request %d rejected (%s) class=%s after %.3fs queued",
                    req.rid, reason, req.priority, req.queue_delay or 0.0)

    def _shed_expired(self, finished: list[Request]):
        """Last-resort rejection (slo mode, AFTER the admission pass): a
        queued request that out-waited its class deadline and still could
        not be placed is shed, so its class reports fast failure instead of
        unbounded queueing.  FIFO within a class means only heads can be
        oldest, so pop while expired."""
        now = self._clock()
        for name, q in self._queues.items():
            pc = self.classes[name]
            limit = (pc.reject_after_s if pc.reject_after_s is not None
                     else pc.ttft_target_s * self.reject_slack)
            while q and now - q[0].t_submit > limit:
                self._reject(q.popleft(), "slo_timeout", finished)

    # -- lifecycle -----------------------------------------------------------
    def _admit(self, prefill_chunk_fn, finished: list[Request]):
        """Claim slots and blocks for pending requests.  Chunked mode holds
        at most one sequence mid-prefill (its chunks run in
        :meth:`_prefill_step`); monolithic mode prefills each admitted
        prompt whole, here.  Preempted sequences resume first; the scan
        stops at the first class that is deferred or capacity-blocked
        (lower classes must not overtake it into the pool), then expired
        waiters are shed (slo mode only)."""
        self._resume_preempted()
        while True:
            nxt = self._next_pending()
            if nxt is None:
                break
            pc, q = nxt
            req = q[0]
            need = len(req.prompt) + req.sampling.max_tokens
            if need > self.max_seq_len:
                q.popleft()
                self._reject(req, "over_length", finished)
                continue
            if self.alloc.blocks_needed(need) > self.alloc.num_blocks:
                # can never fit, even with the pool to itself
                q.popleft()
                self._reject(req, "over_capacity", finished)
                continue
            if self._slo_deferred(pc, req):
                self.stats.deferred += 1
                break
            if not self._make_room(pc, req):
                break  # wait for frees (shed may reject on deadline below)
            slot = self._slots_free.pop()
            self._slot_of[req.rid] = slot
            self._rid_of[slot] = req.rid
            # reserve the worst case, map the prompt's blocks now (decode
            # blocks map lazily via append_token at block boundaries)
            self.alloc.admit(req.rid, len(req.prompt),
                             req.sampling.max_tokens)
            q.popleft()
            self.stats.admitted += 1
            self._cstat(pc.name)["admitted"] += 1
            self._stride[pc.name] += 1.0 / pc.weight
            req.prefill_pos = 0
            if self.token_budget is None:
                t0 = self._clock()
                first = prefill_chunk_fn(req.prompt[None], slot, 0, True,
                                         len(req.prompt))
                self._observe_prefill(self._clock() - t0, len(req.prompt))
                req.prefill_pos = len(req.prompt)
                self.stats.prefill_tokens += len(req.prompt)
                self.stats.prefill_chunks += 1
                self._finish_prefill(req, first, finished)
            else:
                self.prefilling = req
        if self.admission == "slo":
            self._shed_expired(finished)

    def _prefill_step(self, prefill_chunk_fn, finished: list[Request]):
        """Run at most one prefill chunk, sized to the tick's leftover token
        budget (decodes reserve one token each)."""
        req = self.prefilling
        if req is None:
            return
        remaining = len(req.prompt) - req.prefill_pos
        budget = max(self.block, self.token_budget - len(self.active))
        chunk = min(remaining, budget)
        final = chunk == remaining
        if not final:
            # non-final chunks stay block-aligned so every chunk's cache
            # offset is a block boundary (work-list slicing relies on it)
            chunk = (chunk // self.block) * self.block
        toks = req.prompt[None, req.prefill_pos:req.prefill_pos + chunk]
        t0 = self._clock()
        first = prefill_chunk_fn(toks, self._slot_of[req.rid],
                                 req.prefill_pos, final, len(req.prompt))
        self._observe_prefill(self._clock() - t0, chunk)
        req.prefill_pos += chunk
        self.stats.prefill_tokens += chunk
        self.stats.prefill_chunks += 1
        if final:
            self.prefilling = None
            self._finish_prefill(req, first, finished)

    def _finish_prefill(self, req: Request, first, finished: list[Request]):
        """Prefill done: record the first sampled token and either retire
        the request (the completion check decode uses) or activate it."""
        self.lengths[req.rid] = len(req.prompt) + 1
        if self._record_token(req, int(first)):
            self._retire(req)
            finished.append(req)
        else:
            self.active[req.rid] = req

    def _retire(self, req: Request):
        req.done = True
        req.t_done = self._clock()
        slot = self._slot_of.pop(req.rid)
        self._rid_of.pop(slot, None)
        self._slots_free.append(slot)
        self.alloc.free(req.rid)
        self.active.pop(req.rid, None)
        self.lengths.pop(req.rid, None)
        self.stats.completed += 1
        self._cstat(req.priority)["completed"] += 1

    # -- cost model ----------------------------------------------------------
    def _observe_prefill(self, dt: float, tokens: int):
        if tokens <= 0:
            return
        per_tok = dt / tokens
        self.ema_prefill_s_per_tok = (
            per_tok if self.ema_prefill_s_per_tok is None
            else 0.7 * self.ema_prefill_s_per_tok + 0.3 * per_tok)

    def _observe_decode(self, dt: float):
        self.ema_decode_s = (dt if self.ema_decode_s is None
                             else 0.7 * self.ema_decode_s + 0.3 * dt)

    def tick(self, prefill_chunk_fn: Callable,
             decode_fn: Callable) -> list[Request]:
        """One scheduler iteration; returns the requests finished this tick
        (completed and rejected)."""
        finished: list[Request] = []
        self._admit(prefill_chunk_fn, finished)
        if self.token_budget is not None:
            self._prefill_step(prefill_chunk_fn, finished)
        if self.active:
            rids = sorted(self.active)
            slots = [self._slot_of[r] for r in rids]
            tokens = np.array([self.active[r].generated[-1] for r in rids],
                              np.int32)
            positions = np.array([self.lengths[r] - 1 for r in rids],
                                 np.int32)
            # account the token each decode writes BEFORE the device step:
            # a boundary-crossing write needs its block mapped
            for r in rids:
                self.alloc.append_token(r)
            t0 = self._clock()
            nxt = decode_fn(slots, tokens, positions)
            self._observe_decode(self._clock() - t0)
            self.stats.decode_steps += 1
            done_now = []
            for r, t in zip(rids, np.asarray(nxt)):
                req = self.active[r]
                self.lengths[r] += 1
                if self._record_token(req, int(t)):
                    done_now.append(req)
            for req in done_now:
                self._retire(req)
                finished.append(req)
        return finished

    def run(self, prefill_chunk_fn, decode_fn, max_ticks: int = 100_000,
            on_tick: Callable[[], None] | None = None):
        """Drain all requests; returns finished requests in finish order.
        ``on_tick`` runs after every tick: the engine's replan policy (the
        tick boundary is the plan-epoch swap point)."""
        done = []
        ticks = 0
        while self.busy and ticks < max_ticks:
            done.extend(self.tick(prefill_chunk_fn, decode_fn))
            if on_tick is not None:
                on_tick()
            ticks += 1
        return done
