"""Continuous-batching scheduler: chunked prefill + mixed prefill/decode
ticks (Sarathi-style) — the main-path subset of the reference's
``serving/scheduler.py`` (FIFO admission; no priority classes, preemption,
prefix cache or fault hooks yet).

Each tick runs at most one prefill CHUNK plus the full decode batch.
Prompts split into block-aligned chunks (only the final chunk may be
partial) of ``max(block, token_budget - num_active_decodes)`` tokens, so a
long prompt is amortized over many ticks while decodes keep stepping.

Contracts kept from the reference: over-length requests are rejected but
still returned (``completed + rejected == submitted``); the token sampled at
prefill passes the same completion check as decode tokens; admission
reserves a request's worst case (prompt + max_tokens) and maps only the
prompt's blocks, every decode tick accounts the token it writes via
``append_token`` before the device step, and completion frees the blocks.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable

import numpy as np

from repro_torch.serving.kv_cache import BlockAllocator
from repro_torch.serving.sampler import SamplingParams


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                  # [S] int32
    sampling: SamplingParams = dataclasses.field(
        default_factory=SamplingParams)
    # filled during execution:
    generated: list[int] = dataclasses.field(default_factory=list)
    done: bool = False
    rejected: bool = False              # refused before any work
    reject_reason: str | None = None    # over_length | over_capacity
    prefill_pos: int = 0                # prompt tokens prefilled so far
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


@dataclasses.dataclass
class SchedulerStats:
    admitted: int = 0
    completed: int = 0
    rejected: int = 0
    decode_steps: int = 0
    prefill_tokens: int = 0
    prefill_chunks: int = 0


class ContinuousBatcher:
    """Drives (prefill_chunk_fn, decode_fn) over a stream of requests.

    prefill_chunk_fn(tokens[1, C], slot, q_offset, is_final, prompt_len)
        -> first sampled token when ``is_final`` else None
    decode_fn(active_slots, tokens, positions) -> next tokens (per slot)

    ``token_budget``: per-tick token budget shared by one prefill chunk and
    the decode batch.  ``allocator``: share the engine's pool allocator so
    admission and the device pool count the same blocks.
    """

    def __init__(self, *, num_slots: int, num_blocks: int,
                 max_seq_len: int, token_budget: int, block: int = 128,
                 allocator: BlockAllocator | None = None,
                 clock: Callable[[], float] = time.monotonic):
        self.alloc = allocator or BlockAllocator(num_blocks, block)
        self.max_seq_len = max_seq_len
        self.block = block
        self.token_budget = token_budget
        self._queue: deque[Request] = deque()
        self.active: dict[int, Request] = {}
        self.prefilling: Request | None = None
        self.lengths: dict[int, int] = {}
        self.stats = SchedulerStats()
        self._slots_free = list(range(num_slots))
        self._slot_of: dict[int, int] = {}
        self._rid_of: dict[int, int] = {}   # inverse: slot -> rid
        self._clock = clock

    def rid_of_slot(self, slot: int) -> int:
        """The request bound to ``slot`` (the paged engine maps slots to
        block tables through this)."""
        return self._rid_of[slot]

    def submit(self, req: Request):
        req.t_submit = self._clock()
        self._queue.append(req)

    @property
    def busy(self) -> bool:
        return bool(self._queue or self.active or self.prefilling)

    def _record_token(self, req: Request, token: int) -> bool:
        """Append a sampled token; True iff the request just completed."""
        req.generated.append(int(token))
        req.token_times.append(self._clock())
        sp = req.sampling
        return (len(req.generated) >= sp.max_tokens
                or (sp.stop_token is not None
                    and int(token) == sp.stop_token))

    def _reject(self, req: Request, reason: str, finished: list[Request]):
        req.done = True
        req.rejected = True
        req.reject_reason = reason
        req.t_done = self._clock()
        self.stats.rejected += 1
        finished.append(req)

    def _admit(self, finished: list[Request]):
        """Claim a slot and blocks for queued requests, in arrival order,
        while one fits; at most one sequence is mid-prefill at a time."""
        while self._queue:
            req = self._queue[0]
            need = len(req.prompt) + req.sampling.max_tokens
            if need > self.max_seq_len:
                self._reject(self._queue.popleft(), "over_length", finished)
                continue
            if self.alloc.blocks_needed(need) > self.alloc.num_blocks:
                self._reject(self._queue.popleft(), "over_capacity", finished)
                continue
            if (not self._slots_free or self.prefilling is not None
                    or self.alloc.available_blocks
                    < self.alloc.blocks_needed(need)):
                break
            slot = self._slots_free.pop()
            self.alloc.admit(req.rid, len(req.prompt),
                             req.sampling.max_tokens)
            self._slot_of[req.rid] = slot
            self._rid_of[slot] = req.rid
            self._queue.popleft()
            self.stats.admitted += 1
            req.prefill_pos = 0
            self.prefilling = req

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
        first = prefill_chunk_fn(toks, self._slot_of[req.rid],
                                 req.prefill_pos, final, len(req.prompt))
        req.prefill_pos += chunk
        self.stats.prefill_tokens += chunk
        self.stats.prefill_chunks += 1
        if final:
            self.prefilling = None
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

    def tick(self, prefill_chunk_fn: Callable,
             decode_fn: Callable) -> list[Request]:
        """One scheduler iteration; returns the requests finished this tick
        (completed and rejected)."""
        finished: list[Request] = []
        self._admit(finished)
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
            nxt = decode_fn(slots, tokens, positions)
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

    def run(self, prefill_chunk_fn, decode_fn, max_ticks: int = 100_000):
        """Drain all requests; returns finished requests in finish order."""
        done = []
        ticks = 0
        while self.busy and ticks < max_ticks:
            done.extend(self.tick(prefill_chunk_fn, decode_fn))
            ticks += 1
        return done
