"""Paged KV-cache memory: the host block allocator and the device pool.

The main-path subset of the reference's ``serving/kv_cache.py``:

- :class:`BlockAllocator` — host bookkeeping of a fixed pool of
  ``block``-token cache blocks, the one source of truth for KV memory.  A
  sequence is admitted with a reservation for its worst case (prompt + max
  new tokens) but maps physical blocks only as tokens land: prompt blocks
  at admission, decode blocks one at a time in :meth:`append_token`.
  Conservation invariant (:meth:`audit`): every block is free, referenced
  (by block tables or retained shared prefixes, its refcount the number of
  holders) or evictable (cached by the prefix tree, unreferenced), and
  every live sequence maps ``ceil(len/block)`` blocks.

  Sequence stripes (§2.11): the pool splits into ``stripes`` contiguous id
  ranges, each with its own free list; a block's stripe is a function of
  its id (:meth:`stripe_of`) and growth routes to the stripe with the most
  free blocks.  Prefix sharing (§2.14): ``admit(..., shared=ids)`` seeds a
  table with resident blocks by refcount, :meth:`free` returns a block
  only when its last holder drops it, and blocks the radix tree pins
  (:meth:`cache_block`) turn evictable instead of free, reclaimed through
  ``evict_fn`` before :meth:`_grow` gives up.

  The host swap tier (overload preemption, §2.10): :meth:`swap_out`
  releases a sequence's private device blocks and its unmapped reservation
  back to the pool and moves its token accounting to the host tier
  (``host_blocks`` caps it; None = unbounded); its leading shared run stays
  resident (:meth:`swap_split`).  :meth:`swap_in` re-admits it later with a
  fresh reservation, re-links the retained prefix and maps fresh blocks for
  the private tail (ids generally differ: the engine restores the device
  copy by scatter).  A sequence is never accounted on both tiers, and the
  audit extends to the host tier.

  Faults (§2.13): ``injector`` (a
  :class:`~repro_torch.serving.faults.FaultInjector`, None by default)
  fires the ``admission_alloc`` seam inside admission-time growth (admit
  and swap-in, which roll back); :meth:`snapshot_state` /
  :meth:`load_state` carry the whole accounting, free-list order
  included, through a serving snapshot.
- :class:`PagedKVCache` — the device pool ``[L, 2, num_blocks+1, Hkv,
  block, Dh]`` whose last block is the trash block, addressed through the
  allocator's tables (one block-id namespace down to the kernels).  A
  quantized pool keeps its per-(block, kv head) scales ``[L, 2,
  num_blocks+1, Hkv]`` beside the codes, indexed by the same block ids, so
  a shared block shares its scales.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.serving.faults import InjectedAllocError, IntegrityError


@dataclasses.dataclass
class BlockAllocator:
    num_blocks: int
    block: int = 128
    host_blocks: int | None = None   # swap-tier capacity (None = unbounded)
    # sequence-parallel striping (DESIGN.md §2.11): the pool is split into
    # ``stripes`` contiguous id ranges, stripe s owning blocks
    # ``[s * stripe_size, (s+1) * stripe_size)``.  Each stripe maps to one
    # `seq`-axis shard of the device pool, so block id -> owning device is
    # a pure function of the id (``stripe_of``) and reserve/map/free/swap
    # all route to the owning stripe's free list.  stripes == 1 is the
    # pre-§2.11 single-pool behavior exactly.
    stripes: int = 1

    def __post_init__(self):
        if self.stripes < 1:
            raise ValueError(f"stripes must be >= 1, got {self.stripes}")
        if self.num_blocks % self.stripes:
            raise ValueError(
                f"num_blocks {self.num_blocks} not divisible by "
                f"stripes {self.stripes} — stripe-owned pools need equal "
                f"contiguous id ranges per seq shard")
        self.stripe_size = self.num_blocks // self.stripes
        # per-stripe free lists; stripe s owns [s*size, (s+1)*size)
        self._free: list[list[int]] = [
            list(range(s * self.stripe_size, (s + 1) * self.stripe_size))
            for s in range(self.stripes)]
        self._tables: dict[int, list[int]] = {}
        self._lens: dict[int, int] = {}       # cache-resident tokens
        self._reserved: dict[int, int] = {}   # worst-case blocks per seq
        self._host_lens: dict[int, int] = {}  # swapped-out resident tokens
        self._host_nblk: dict[int, int] = {}  # host blocks held per seq
        # prefix sharing (DESIGN.md §2.14): per-block reference counts
        # (table occurrences + retained shared prefixes of swapped seqs),
        # the set of blocks pinned by the prefix tree, and the evictable
        # subset (cached AND unreferenced — resident but reclaimable).
        self._refcnt: dict[int, int] = {}
        self._cached: set[int] = set()
        self._evictable: set[int] = set()
        # count of blocks with refcount >= 2 — lets per-tick hot paths
        # (the engine's sharing signature) skip their per-block refcount
        # scans entirely while nothing is actually shared
        self._shared_cnt = 0
        # swapped-out seqs keep their shared prefix blocks RESIDENT (only
        # private tails move to the host tier); the retained ids live here
        # and keep their refcounts until swap-in or free
        self._host_shared: dict[int, list[int]] = {}
        # cache-eviction hook: the prefix tree wires ``evict_fn(n) -> int``
        # here so pool pressure drains LRU cache subtrees before any
        # MemoryError (and therefore before the scheduler ever preempts)
        self.evict_fn = None
        # fault-injection hook (§2.13): the engine wires its FaultInjector
        # here so the "admission_alloc" seam can exhaust the pool
        # MID-MAPPING.  None (the default) costs one attribute read.
        self.injector = None

    # -- stripe views -------------------------------------------------------
    def stripe_of(self, block_id: int) -> int:
        """Owning stripe (= seq-axis shard) of a pool block id."""
        return int(block_id) // self.stripe_size

    def free_blocks_per_stripe(self) -> list[int]:
        return [len(f) for f in self._free]

    def stripe_counts(self, seq_id: int) -> list[int]:
        """Mapped blocks of ``seq_id`` per stripe — the engine's stripe
        signature input (and the per-axis balance telemetry)."""
        counts = [0] * self.stripes
        for b in self._tables.get(seq_id, ()):
            counts[self.stripe_of(b)] += 1
        return counts

    def _return_blocks(self, ids) -> None:
        """Route freed blocks back to their owning stripes' free lists."""
        for b in ids:
            self._free[self.stripe_of(b)].append(b)

    # -- refcounts + prefix-cache pinning (DESIGN.md §2.14) -----------------
    def _incref(self, block_id: int) -> None:
        c = self._refcnt.get(block_id, 0)
        if c == 0:
            # a newly-referenced cached block is no longer reclaimable
            self._evictable.discard(block_id)
        elif c == 1:
            self._shared_cnt += 1
        self._refcnt[block_id] = c + 1

    def _decref(self, block_id: int) -> None:
        c = self._refcnt[block_id] - 1
        if c > 0:
            if c == 1:
                self._shared_cnt -= 1
            self._refcnt[block_id] = c
            return
        del self._refcnt[block_id]
        if block_id in self._cached:
            # tree-pinned content stays resident for future prefix hits
            self._evictable.add(block_id)
        else:
            self._return_blocks([block_id])

    def refcount(self, block_id: int) -> int:
        return self._refcnt.get(block_id, 0)

    @property
    def shared_block_count(self) -> int:
        """Blocks currently referenced by more than one holder."""
        return self._shared_cnt

    def shared_discount(self, shared) -> int:
        """Admission headroom discount for a matched prefix: only the
        currently REFERENCED hit blocks (refcount > 0) cost nothing to
        map — they are in neither the free lists nor the evictable set,
        so ``available_blocks`` never counted them.  An evictable hit
        (refcount 0, tree-cached only — a retired prefix) IS counted in
        ``available_blocks``, and mapping it consumes that headroom
        exactly like a fresh block; discounting it too would
        double-count, drive ``available_blocks`` negative, and break the
        guarantee that decode growth can never exhaust the pool."""
        return sum(1 for b in shared if self._refcnt.get(int(b), 0) > 0)

    def is_cached(self, block_id: int) -> bool:
        return block_id in self._cached

    def cached_ids(self) -> set[int]:
        return set(self._cached)

    def evictable_ids(self) -> set[int]:
        """Blocks that are cached AND unreferenced (maintained
        incrementally) — the prefix tree seeds its eviction heap from
        this instead of rescanning every node."""
        return set(self._evictable)

    def cache_block(self, block_id: int) -> None:
        """Pin a mapped block as prefix-tree content: when its refcount
        later drops to zero it becomes evictable instead of free.
        Idempotent."""
        self._cached.add(block_id)
        if self._refcnt.get(block_id, 0) == 0:
            self._evictable.add(block_id)

    def uncache_block(self, block_id: int) -> None:
        """Drop the prefix-tree pin (eviction or invalidation); an
        unreferenced block returns to its stripe's free list now."""
        self._cached.discard(block_id)
        if block_id in self._evictable:
            self._evictable.discard(block_id)
            self._return_blocks([block_id])

    # -- accounting views ---------------------------------------------------
    @property
    def free_blocks(self) -> int:
        """Physically unmapped blocks (all stripes)."""
        return sum(len(f) for f in self._free)

    @property
    def allocated_blocks(self) -> int:
        return self.num_blocks - self.free_blocks

    @property
    def reserved_unmapped(self) -> int:
        """Blocks promised to admitted sequences but not yet mapped."""
        return sum(r - len(self._tables.get(s, ()))
                   for s, r in self._reserved.items())

    @property
    def evictable_blocks(self) -> int:
        """Cache-pinned blocks with no referencing sequence — resident
        content that :meth:`_grow` can reclaim on demand via ``evict_fn``."""
        return len(self._evictable)

    @property
    def available_blocks(self) -> int:
        """Admission headroom: free + evictable minus outstanding
        reservations.  Using this (not ``free_blocks``) for admission
        guarantees decode growth can never exhaust the pool
        mid-generation; counting evictables means cache eviction absorbs
        pool pressure before admission control ever preempts."""
        return self.free_blocks + self.evictable_blocks \
            - self.reserved_unmapped

    def blocks_needed(self, num_tokens: int) -> int:
        return -(-num_tokens // self.block)

    def seq_tokens(self, seq_id: int) -> int:
        """Cache-resident tokens accounted to ``seq_id``."""
        return self._lens.get(seq_id, 0)

    def release_estimate(self, seq_id: int) -> int:
        """Exact ``available_blocks`` gain if ``seq_id`` were freed: its
        unmapped reservation plus every mapped block whose refcount drops
        to zero (cached blocks turn evictable, which still counts)."""
        t = self._tables.get(seq_id, [])
        r = self._reserved.get(seq_id, 0)
        solo = sum(1 for b in t if self._refcnt.get(b, 0) == 1)
        return r - len(t) + solo

    def swap_release_estimate(self, seq_id: int) -> int:
        """Exact ``available_blocks`` gain if ``seq_id`` were swapped out:
        the full reservation minus the shared prefix blocks that stay
        resident (and keep their refcounts) on its behalf."""
        retained, _ = self.swap_split(seq_id)
        return self._reserved.get(seq_id, 0) - len(retained)

    # -- host swap tier -----------------------------------------------------
    @property
    def swapped_seqs(self) -> tuple[int, ...]:
        return tuple(self._host_lens)

    @property
    def host_allocated_blocks(self) -> int:
        return sum(self._host_nblk.values())

    @property
    def host_free_blocks(self) -> int | None:
        """Remaining swap-tier capacity (None = unbounded)."""
        if self.host_blocks is None:
            return None
        return self.host_blocks - self.host_allocated_blocks

    def host_tokens(self, seq_id: int) -> int:
        """Resident tokens held on the host tier for ``seq_id``."""
        return self._host_lens.get(seq_id, 0)

    def host_shared_blocks(self, seq_id: int) -> int:
        """Shared prefix blocks a swapped-out ``seq_id`` keeps resident."""
        return len(self._host_shared.get(seq_id, ()))

    def swap_split(self, seq_id: int) -> tuple[list[int], list[int]]:
        """Partition ``seq_id``'s table into ``(retained, private)``: the
        leading run of blocks that are tree-cached or shared with another
        holder stays resident on swap-out (their payloads exist on device
        for every other holder already — copying them to host would be
        pure waste), and only the private tail actually transfers.  The
        split is a prefix run because sharing itself is prefix-shaped: a
        block past the first private one can only be private too."""
        table = self._tables.get(seq_id, [])
        k = 0
        for b in table:
            if b in self._cached or self._refcnt.get(b, 0) >= 2:
                k += 1
            else:
                break
        return list(table[:k]), list(table[k:])

    def can_swap_out(self, seq_id: int) -> bool:
        if seq_id not in self._lens:
            return False
        if self.host_blocks is None:
            return True
        _, private = self.swap_split(seq_id)
        return self.host_allocated_blocks + len(private) <= self.host_blocks

    def swap_out(self, seq_id: int) -> int:
        """Move ``seq_id`` from the device tier to the host tier: its
        PRIVATE mapped blocks return to the free pool, its unmapped
        reservation is dropped, and the token accounting migrates.  Shared
        prefix blocks stay resident (still refcounted, recorded in
        ``_host_shared``) so resume re-links them by identity.  Returns
        the number of private device blocks released (= host blocks now
        held).  The caller must copy the private payloads to host BEFORE
        calling this — those ids are reusable the moment this returns."""
        if seq_id in self._host_lens:
            raise ValueError(f"seq {seq_id} already swapped out")
        if not self.can_swap_out(seq_id):
            raise MemoryError(
                f"host swap tier exhausted: seq {seq_id} needs "
                f"{len(self.swap_split(seq_id)[1])}, "
                f"free {self.host_free_blocks}")
        retained, private = self.swap_split(seq_id)
        self._tables.pop(seq_id)
        for b in private:
            self._decref(b)
        if retained:
            self._host_shared[seq_id] = retained
        self._host_lens[seq_id] = self._lens.pop(seq_id)
        self._host_nblk[seq_id] = len(private)
        self._reserved.pop(seq_id)
        return len(private)

    def can_swap_in(self, seq_id: int, max_new_tokens: int = 0) -> bool:
        if seq_id not in self._host_lens:
            return False
        total = self.blocks_needed(self._host_lens[seq_id] + max_new_tokens)
        shared = len(self._host_shared.get(seq_id, ()))
        return total - shared <= self.available_blocks

    def swap_in(self, seq_id: int, max_new_tokens: int = 0) -> list[int]:
        """Re-admit ``seq_id`` from the host tier: take a fresh worst-case
        reservation (resident + remaining new tokens), re-link its retained
        shared prefix blocks by identity, and map fresh device blocks for
        the private resident tail.  Returns the FRESH block ids only — the
        engine scatters the host copy into them (the shared prefix never
        left the device)."""
        if seq_id not in self._host_lens:
            raise ValueError(f"seq {seq_id} not swapped out")
        resident = self._host_lens[seq_id]
        shared = self._host_shared.pop(seq_id, [])
        total = self.blocks_needed(resident + max_new_tokens)
        if total - len(shared) > self.available_blocks:
            if shared:
                self._host_shared[seq_id] = shared
            raise MemoryError(
                f"KV pool exhausted: swap-in needs "
                f"{total - len(shared)}, available {self.available_blocks}")
        self._reserved[seq_id] = total
        # the retained ids re-enter the table carrying the refcounts the
        # host hold kept for them — no incref/decref on this transfer
        self._tables[seq_id] = list(shared)
        self._lens[seq_id] = 0
        try:
            self._grow(seq_id, self.blocks_needed(resident) - len(shared),
                       admission=True)
        except MemoryError:
            # partial-failure rollback: freshly-mapped blocks return to
            # their stripes, the retained prefix goes back to the host
            # hold, and the host-tier accounting was never touched — the
            # sequence is still cleanly swapped out
            t = self._tables.pop(seq_id)
            for b in t[len(shared):]:
                self._decref(b)
            if shared:
                self._host_shared[seq_id] = shared
            self._lens.pop(seq_id, None)
            self._reserved.pop(seq_id, None)
            raise
        self._lens[seq_id] = resident
        del self._host_lens[seq_id]
        del self._host_nblk[seq_id]
        return list(self._tables[seq_id][len(shared):])

    def _rollback_partial(self, seq_id: int) -> None:
        """Undo a partially-failed admit: decref whatever blocks were
        mapped (shared prefix blocks return to their prior holders /
        evictable state, fresh ones to their stripes) and drop the
        device-tier entries.  (Before this existed, a mid-mapping
        ``MemoryError`` leaked a phantom reservation that permanently
        shrank ``available_blocks``.)"""
        for b in self._tables.pop(seq_id, []):
            self._decref(b)
        self._lens.pop(seq_id, None)
        self._reserved.pop(seq_id, None)

    def conserves(self) -> bool:
        """True iff :meth:`audit` finds nothing (the boolean view the
        chaos tests poll every tick)."""
        return not self.audit(strict=False)

    def audit(self, strict: bool = True) -> list[str]:
        """Full invariant audit of both tiers: returns the list of
        violated invariants, raising :class:`IntegrityError` when
        ``strict`` and anything failed.

        Checks: two-tier conservation (device blocks match live lengths,
        host blocks match swapped lengths minus retained shared prefixes),
        the refcount cross-check (per-block refcount == number of tables /
        host holds referencing it; free lists disjoint from any referenced
        or cached block; free + referenced + evictable == pool), COW
        discipline (no block twice in one table), evictable == cached ∧
        unreferenced, stripe ownership (every id in the free list of the
        stripe owning its range), per-sequence table/length/reservation
        agreement, no sequence on both tiers, and the host-tier cap."""
        fails: list[str] = []
        # -- refcount cross-check (DESIGN.md §2.14) ----------------------
        # ground truth: occurrences across live tables + the shared
        # prefixes retained on behalf of swapped-out sequences
        want: dict[int, int] = {}
        for t in self._tables.values():
            for b in t:
                want[b] = want.get(b, 0) + 1
        for hs in self._host_shared.values():
            for b in hs:
                want[b] = want.get(b, 0) + 1
        if self._refcnt != want:
            bad = sorted(b for b in set(self._refcnt) | set(want)
                         if self._refcnt.get(b) != want.get(b))
            fails.append(
                f"refcount drift (un-refcounted double-map, or a leaked "
                f"hold): stored != referencing holds for blocks {bad[:8]}")
        want_shared = sum(1 for c in want.values() if c >= 2)
        if self._shared_cnt != want_shared:
            fails.append(
                f"shared-count drift: {self._shared_cnt} tracked != "
                f"{want_shared} blocks with >= 2 holds")
        # COW discipline: a block may be shared ACROSS tables, never
        # duplicated WITHIN one (each table position is distinct content)
        for sid, t in self._tables.items():
            if len(t) != len(set(t)):
                fails.append(f"double-map: seq {sid} maps a block twice "
                             "in its own table")
        referenced = set(want)
        want_evict = {b for b in self._cached if b not in referenced}
        if self._evictable != want_evict:
            fails.append(
                f"evictable drift: {sorted(self._evictable)[:8]} != "
                f"cached∧unreferenced {sorted(want_evict)[:8]}")
        free_ids = [b for f in self._free for b in f]
        if len(free_ids) != len(set(free_ids)):
            fails.append("double-free: a block id appears twice in the "
                         "free lists")
        overlap = (referenced | self._cached) & set(free_ids)
        if overlap:
            fails.append(f"free/referenced overlap: {sorted(overlap)[:8]}")
        universe = referenced | self._evictable | set(free_ids)
        if len(universe) != self.num_blocks or (
                universe and (min(universe) < 0
                              or max(universe) >= self.num_blocks)):
            fails.append(
                f"pool partition: free+referenced+evictable covers "
                f"{len(universe)} ids, pool has {self.num_blocks}")
        # -- device tier conservation ------------------------------------
        # distinct-block form (the multiplicity form only holds without
        # sharing; per-seq exact table sizes are checked below)
        if self.allocated_blocks != len(referenced | self._evictable):
            fails.append(
                f"device conservation: allocated {self.allocated_blocks} "
                f"!= referenced+evictable "
                f"{len(referenced | self._evictable)}")
        # -- stripe ownership --------------------------------------------
        for s in range(self.stripes):
            strays = [b for b in self._free[s] if self.stripe_of(b) != s]
            if strays:
                fails.append(f"stripe ownership: stripe {s} free list "
                             f"holds foreign ids {strays[:8]}")
        # -- per-sequence agreement --------------------------------------
        for sid, n in self._lens.items():
            t = self._tables.get(sid)
            if t is None:
                fails.append(f"seq {sid}: has a length but no table")
                continue
            if len(t) != self.blocks_needed(n) and n > 0:
                fails.append(f"seq {sid}: {len(t)} mapped blocks != "
                             f"ceil({n}/{self.block})")
            if len(t) > self._reserved.get(sid, 0):
                fails.append(f"seq {sid}: mapped {len(t)} past its "
                             f"reservation {self._reserved.get(sid, 0)}")
        for sid in self._tables:
            if sid not in self._lens:
                fails.append(f"seq {sid}: has a table but no length")
        # -- host tier ---------------------------------------------------
        for sid, n in self._host_lens.items():
            shared = len(self._host_shared.get(sid, ()))
            if self._host_nblk.get(sid) != self.blocks_needed(n) - shared:
                fails.append(
                    f"host conservation: seq {sid} holds "
                    f"{self._host_nblk.get(sid)} host blocks != "
                    f"ceil({n}/{self.block}) - {shared} retained")
        strays = set(self._host_shared) - set(self._host_lens)
        if strays:
            fails.append(f"host hold without host seq: {sorted(strays)}")
        dual = set(self._lens) & set(self._host_lens)
        if dual:
            fails.append(f"dual accounting: seqs {sorted(dual)} on both "
                         "tiers")
        if (self.host_blocks is not None
                and self.host_allocated_blocks > self.host_blocks):
            fails.append(
                f"host cap: {self.host_allocated_blocks} blocks held > "
                f"capacity {self.host_blocks}")
        if strict and fails:
            raise IntegrityError(fails)
        return fails

    # -- checkpoint (§2.13) ---------------------------------------
    def snapshot_state(self) -> dict:
        """JSON-serializable snapshot of the full accounting state —
        free-list ORDER included, so a restored allocator hands out the
        same ids in the same order as the uninterrupted one."""
        return {
            "free": [list(f) for f in self._free],
            "tables": {str(k): list(v) for k, v in self._tables.items()},
            "lens": {str(k): v for k, v in self._lens.items()},
            "reserved": {str(k): v for k, v in self._reserved.items()},
            "host_lens": {str(k): v for k, v in self._host_lens.items()},
            "host_nblk": {str(k): v for k, v in self._host_nblk.items()},
            # prefix sharing (§2.14): refcounts + evictable are derivable
            # (recomputed at load) — only the cache pins and retained
            # shared prefixes are primary state
            "cached": sorted(self._cached),
            "host_shared": {str(k): list(v)
                            for k, v in self._host_shared.items()},
        }

    def load_state(self, state: dict) -> None:
        """Adopt a :meth:`snapshot_state` snapshot (geometry must match),
        then audit it — a corrupt checkpoint fails loudly at restore."""
        self._free = [list(map(int, f)) for f in state["free"]]
        self._tables = {int(k): list(map(int, v))
                        for k, v in state["tables"].items()}
        self._lens = {int(k): int(v) for k, v in state["lens"].items()}
        self._reserved = {int(k): int(v)
                          for k, v in state["reserved"].items()}
        self._host_lens = {int(k): int(v)
                           for k, v in state["host_lens"].items()}
        self._host_nblk = {int(k): int(v)
                           for k, v in state["host_nblk"].items()}
        self._cached = set(map(int, state.get("cached", ())))
        self._host_shared = {int(k): list(map(int, v))
                             for k, v in state.get("host_shared",
                                                   {}).items()}
        refs: dict[int, int] = {}
        for t in self._tables.values():
            for b in t:
                refs[b] = refs.get(b, 0) + 1
        for hs in self._host_shared.values():
            for b in hs:
                refs[b] = refs.get(b, 0) + 1
        self._refcnt = refs
        self._shared_cnt = sum(1 for c in refs.values() if c >= 2)
        self._evictable = {b for b in self._cached if b not in refs}
        self.audit()

    # -- lifecycle ----------------------------------------------------------
    def admit(self, seq_id: int, prompt_tokens: int,
              max_new_tokens: int = 0, shared=()) -> list[int]:
        """Reserve the worst case, map the prompt's blocks now.

        The reservation (``prompt + max_new`` blocks) is an accounting
        upper bound — no specific block ids are held — so unfilled headroom
        stays usable by the admission of later arrivals only once this
        sequence frees.  ``shared`` is an already-resident prefix
        from the radix tree (DESIGN.md §2.14): those ids seed the table by
        identity (increfed, so eviction can no longer take them) and only
        the remaining prompt blocks are freshly mapped.  Returns the full
        mapped prompt block table (shared prefix first).
        """
        if seq_id in self._reserved:
            raise ValueError(f"seq {seq_id} already admitted")
        shared = list(shared)
        total = self.blocks_needed(prompt_tokens + max_new_tokens)
        # only REFERENCED hit blocks discount: an evictable hit already
        # counts in available_blocks and pays like a fresh block
        # (shared_discount) — discounting it too would double-count
        discount = self.shared_discount(shared)
        if total - discount > self.available_blocks:
            raise MemoryError(
                f"KV pool exhausted: need {total - discount}, "
                f"available {self.available_blocks}")
        self._reserved[seq_id] = total
        table = self._tables[seq_id] = []
        self._lens[seq_id] = 0
        for b in shared:
            self._incref(b)
            table.append(b)
        try:
            self._grow(seq_id, self.blocks_needed(prompt_tokens) - len(shared),
                       admission=True)
        except MemoryError:
            # partial-failure rollback (see _rollback_partial): admission
            # either fully lands or leaves no trace
            self._rollback_partial(seq_id)
            raise
        self._lens[seq_id] = prompt_tokens
        return list(self._tables[seq_id])

    def _grow(self, seq_id: int, n_new: int, *,
              admission: bool = False) -> None:
        if n_new > self.free_blocks and self.evict_fn is not None \
                and self._evictable:
            # pool pressure drains the prefix cache (LRU subtrees) before
            # any MemoryError reaches admission control or decode growth —
            # the "eviction feeds _make_room before preemption" ordering
            self.evict_fn(n_new - self.free_blocks)
        if n_new > self.free_blocks:
            raise MemoryError(
                f"KV pool exhausted: need {n_new}, free {self.free_blocks}")
        table = self._tables[seq_id]
        if len(table) + n_new > self._reserved[seq_id]:
            raise MemoryError(
                f"seq {seq_id} grows past its reservation "
                f"({len(table)}+{n_new} > {self._reserved[seq_id]})")
        # fault seam "admission_alloc" (§2.13): a fired spec exhausts the
        # pool after HALF the requested blocks mapped, the partial failure
        # the admit / swap-in rollback must clean up.  Only admission-time
        # growth consults it (those callers roll back and retry next tick);
        # append_token's mid-decode growth has no retry above it
        inj = self.injector
        fault_at = None
        if admission and inj is not None and inj.enabled:
            if inj.fire("admission_alloc", rid=seq_id) is not None:
                fault_at = n_new // 2
        for i in range(n_new):
            if fault_at is not None and i >= fault_at:
                raise InjectedAllocError(
                    f"injected pool exhaustion after {i}/{n_new} blocks",
                    rid=seq_id)
            s = self._growth_stripe(table)
            if not self._free[s]:
                raise MemoryError("KV pool exhausted: all stripes empty")
            b = self._free[s].pop()
            self._refcnt[b] = 1
            table.append(b)

    def _growth_stripe(self, table: list[int]) -> int:
        """The stripe a block appended to ``table`` comes from: the one with
        the most headroom (deterministic: ties break to the lowest stripe
        index), so a long sequence's blocks spread across the seq shards
        and the per-stripe decode load stays balanced — the placement half
        of the 2D packer's job (DESIGN.md §2.11).  stripes == 1 reduces to
        the old single-free-list pop."""
        return max(range(self.stripes), key=lambda i: (len(self._free[i]),
                                                       -i))

    def append_token(self, seq_id: int) -> None:
        """Account one more cache-resident token; map a fresh block exactly
        when the new token crosses a block boundary.  Called by the
        scheduler for every active sequence on every decode tick (the token
        the decode step writes at its current position).  Exception-safe:
        a refused growth (past the reservation, or an exhausted pool)
        leaves the accounting untouched."""
        new_len = self._lens[seq_id] + 1
        need = self.blocks_needed(new_len)
        have = len(self._tables[seq_id])
        if need > have:
            self._grow(seq_id, need - have)
        self._lens[seq_id] = new_len

    def table(self, seq_id: int) -> list[int]:
        return self._tables.get(seq_id, [])

    def free(self, seq_id: int) -> None:
        """Release everything ``seq_id`` holds, on whichever tier.  Each
        block is decrefed: shared blocks stay with their other holders,
        tree-cached blocks turn evictable (cache retention — the whole
        point of retiring without scrubbing), and exclusive uncached
        blocks return to their stripe's free list."""
        for b in self._tables.pop(seq_id, []):
            self._decref(b)
        for b in self._host_shared.pop(seq_id, []):
            self._decref(b)
        self._lens.pop(seq_id, None)
        self._reserved.pop(seq_id, None)
        self._host_lens.pop(seq_id, None)
        self._host_nblk.pop(seq_id, None)


class PagedKVCache:
    """Device block pool + host block tables (one id namespace).

    ``make_pool_fn(total_blocks)`` builds the device pool; ``num_blocks``
    usable blocks are managed by the embedded :class:`BlockAllocator`, and
    one extra physical block, index ``num_blocks`` (:attr:`trash_block`),
    absorbs writes of inactive decode rows.  ``table_width`` (=
    ``max_seq_len // block``) fixes the width of every table row;
    ``stripes`` splits the usable blocks into that many seq stripes.
    A quantized pool also passes ``make_scales_fn(total_blocks)``, which
    builds :attr:`scales` ``[L, 2, total_blocks, Hkv]`` float32: a scale is
    a property of the block it describes, so the allocator needs no state
    for it.  ``scales`` is None for a full-precision pool.
    """

    def __init__(self, make_pool_fn, *, num_blocks: int, block: int,
                 table_width: int, make_scales_fn=None,
                 host_blocks: int | None = None, stripes: int = 1):
        self.pool = make_pool_fn(num_blocks + 1)
        self.scales = (None if make_scales_fn is None
                       else make_scales_fn(num_blocks + 1))
        self.alloc = BlockAllocator(num_blocks, block,
                                    host_blocks=host_blocks,
                                    stripes=stripes)
        self.block = block
        self.trash_block = num_blocks
        self.table_width = table_width
        self.stripes = stripes
        self.stripe_size = self.alloc.stripe_size

    @property
    def num_blocks(self) -> int:
        return self.alloc.num_blocks

    def table_row(self, seq_id: int) -> np.ndarray:
        """``[table_width]`` int32 pool block ids, -1 padded."""
        row = np.full((self.table_width,), -1, np.int32)
        t = self.alloc.table(seq_id)
        row[:len(t)] = t
        return row

    def replace_pool(self, pool, scales=None) -> None:
        """Adopt a new device pool (and, quantized, its scales) of the same
        shape and dtype: a plan-epoch swap's gather of the kv-head axis
        returns new tensors.  Codes and scales move together: a quantized
        pool takes both, a full-precision one neither."""
        if pool.shape != self.pool.shape or pool.dtype != self.pool.dtype:
            raise ValueError(f"pool {tuple(pool.shape)} {pool.dtype} does not "
                             f"replace {tuple(self.pool.shape)} "
                             f"{self.pool.dtype}")
        if (scales is None) != (self.scales is None) or (
                scales is not None and scales.shape != self.scales.shape):
            raise ValueError("a quantized pool's codes and scales are "
                             "replaced together, of the same shapes")
        self.pool = pool
        self.scales = scales

    def audit(self, strict: bool = True) -> list[str]:
        """Allocator accounting plus the pool's block axis (usable blocks
        plus the trash block) and, for a quantized pool, scales whose shape
        agrees with the codes' ``[:4]`` (scales that drifted from their
        codes would dequantize garbage silently)."""
        fails = self.alloc.audit(strict=False)
        if self.pool.shape[2] != self.num_blocks + 1:
            fails.append(f"pool shape: block axis {self.pool.shape[2]} != "
                         f"num_blocks+trash {self.num_blocks + 1}")
        if (self.scales is not None
                and tuple(self.scales.shape) != tuple(self.pool.shape[:4])):
            fails.append(f"scale/code shape disagreement: scales "
                         f"{tuple(self.scales.shape)} != codes "
                         f"{tuple(self.pool.shape[:4])}")
        if strict and fails:
            raise IntegrityError(fails)
        return fails

    def pool_bytes(self) -> int:
        """Resident device bytes of the cache: codes and scales."""
        total = self.pool.numel() * self.pool.element_size()
        if self.scales is not None:
            total += self.scales.numel() * self.scales.element_size()
        return total
