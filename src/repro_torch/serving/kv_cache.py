"""Paged KV-cache memory: the host block allocator and the device pool.

The main-path subset of the reference's ``serving/kv_cache.py``:

- :class:`BlockAllocator` — host bookkeeping of a fixed pool of
  ``block``-token cache blocks, the one source of truth for KV memory.  A
  sequence is admitted with a reservation for its worst case (prompt + max
  new tokens) but maps physical blocks only as tokens land: prompt blocks
  at admission, decode blocks one at a time in :meth:`append_token`.
  Conservation invariant (:meth:`audit`): every block is free or mapped by
  exactly one table, and every live sequence maps ``ceil(len/block)``
  blocks.  Ownership is exclusive here (no prefix sharing, no stripes).

  The host swap tier (overload preemption, §2.10): :meth:`swap_out`
  releases a sequence's device blocks and its unmapped reservation back to
  the pool and moves its token accounting to the host tier (``host_blocks``
  caps it; None = unbounded); :meth:`swap_in` re-admits it later with a
  fresh reservation and freshly mapped blocks (ids generally differ: the
  engine restores the device copy by scatter).  A sequence is never
  accounted on both tiers, and the audit extends to the host tier.  Without
  prefix sharing every block is private, so :meth:`swap_split` keeps
  nothing resident.
- :class:`PagedKVCache` — the device pool ``[L, 2, num_blocks+1, Hkv,
  block, Dh]`` whose last block is the trash block, addressed through the
  allocator's tables (one block-id namespace down to the kernels).  A
  quantized pool keeps its per-(block, kv head) scales ``[L, 2,
  num_blocks+1, Hkv]`` beside the codes, indexed by the same block ids.
"""
from __future__ import annotations

import dataclasses

import numpy as np


class IntegrityError(RuntimeError):
    """The allocator's accounting violated an invariant."""

    def __init__(self, failures: list[str]):
        super().__init__("; ".join(failures))
        self.failures = failures


@dataclasses.dataclass
class BlockAllocator:
    num_blocks: int
    block: int = 128
    host_blocks: int | None = None   # swap-tier capacity (None = unbounded)

    def __post_init__(self):
        self._free: list[int] = list(range(self.num_blocks))
        self._tables: dict[int, list[int]] = {}
        self._lens: dict[int, int] = {}       # cache-resident tokens
        self._reserved: dict[int, int] = {}   # worst-case blocks per seq
        self._host_lens: dict[int, int] = {}  # swapped-out resident tokens
        self._host_nblk: dict[int, int] = {}  # host blocks held per seq

    # -- accounting views ---------------------------------------------------
    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def allocated_blocks(self) -> int:
        return self.num_blocks - self.free_blocks

    @property
    def reserved_unmapped(self) -> int:
        """Blocks promised to admitted sequences but not yet mapped."""
        return sum(r - len(self._tables.get(s, ()))
                   for s, r in self._reserved.items())

    @property
    def available_blocks(self) -> int:
        """Admission headroom: free minus outstanding reservations, so
        decode growth can never exhaust the pool mid-generation."""
        return self.free_blocks - self.reserved_unmapped

    def blocks_needed(self, num_tokens: int) -> int:
        return -(-num_tokens // self.block)

    def seq_tokens(self, seq_id: int) -> int:
        """Cache-resident tokens accounted to ``seq_id``."""
        return self._lens.get(seq_id, 0)

    def release_estimate(self, seq_id: int) -> int:
        """Exact ``available_blocks`` gain if ``seq_id`` were freed: its
        whole reservation (every mapped block is its own)."""
        return self._reserved.get(seq_id, 0)

    def swap_release_estimate(self, seq_id: int) -> int:
        """Exact ``available_blocks`` gain if ``seq_id`` were swapped out:
        the full reservation minus the blocks that stay resident
        (:meth:`swap_split`; none without prefix sharing)."""
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

    def swap_split(self, seq_id: int) -> tuple[list[int], list[int]]:
        """Partition ``seq_id``'s table into ``(retained, private)``: the
        blocks that stay resident on swap-out and those that transfer.
        Without prefix sharing every block is private, so ``retained`` is
        empty (the reference's signature, which the prefix cache fills)."""
        return [], list(self._tables.get(seq_id, []))

    def can_swap_out(self, seq_id: int) -> bool:
        if seq_id not in self._lens:
            return False
        if self.host_blocks is None:
            return True
        _, private = self.swap_split(seq_id)
        return self.host_allocated_blocks + len(private) <= self.host_blocks

    def swap_out(self, seq_id: int) -> int:
        """Move ``seq_id`` from the device tier to the host tier: its mapped
        blocks return to the free pool, its unmapped reservation is
        dropped, and the token accounting migrates.  Returns the number of
        device blocks released (= host blocks now held).  The caller must
        copy the payloads to the host BEFORE calling this: those ids are
        reusable the moment this returns."""
        if seq_id in self._host_lens:
            raise ValueError(f"seq {seq_id} already swapped out")
        if not self.can_swap_out(seq_id):
            raise MemoryError(
                f"host swap tier exhausted: seq {seq_id} needs "
                f"{len(self.swap_split(seq_id)[1])}, "
                f"free {self.host_free_blocks}")
        _, private = self.swap_split(seq_id)
        self._tables.pop(seq_id)
        self._free.extend(private)
        self._host_lens[seq_id] = self._lens.pop(seq_id)
        self._host_nblk[seq_id] = len(private)
        self._reserved.pop(seq_id)
        return len(private)

    def can_swap_in(self, seq_id: int, max_new_tokens: int = 0) -> bool:
        if seq_id not in self._host_lens:
            return False
        total = self.blocks_needed(self._host_lens[seq_id] + max_new_tokens)
        return total <= self.available_blocks

    def swap_in(self, seq_id: int, max_new_tokens: int = 0) -> list[int]:
        """Re-admit ``seq_id`` from the host tier: take a fresh worst-case
        reservation (resident + remaining new tokens) and map fresh device
        blocks for the resident tokens.  Returns the fresh block ids, which
        the engine scatters the host copy into.  A refused mapping leaves
        the sequence cleanly swapped out."""
        if seq_id not in self._host_lens:
            raise ValueError(f"seq {seq_id} not swapped out")
        resident = self._host_lens[seq_id]
        total = self.blocks_needed(resident + max_new_tokens)
        if total > self.available_blocks:
            raise MemoryError(
                f"KV pool exhausted: swap-in needs {total}, available "
                f"{self.available_blocks}")
        self._reserved[seq_id] = total
        self._tables[seq_id] = []
        self._lens[seq_id] = 0
        try:
            self._grow(seq_id, self.blocks_needed(resident))
        except MemoryError:
            self._free.extend(self._tables.pop(seq_id))
            self._lens.pop(seq_id, None)
            self._reserved.pop(seq_id, None)
            raise
        self._lens[seq_id] = resident
        del self._host_lens[seq_id]
        del self._host_nblk[seq_id]
        return list(self._tables[seq_id])

    # -- lifecycle ----------------------------------------------------------
    def admit(self, seq_id: int, prompt_tokens: int,
              max_new_tokens: int = 0) -> list[int]:
        """Reserve the worst case, map the prompt's blocks now; returns the
        mapped prompt block table."""
        if seq_id in self._reserved:
            raise ValueError(f"seq {seq_id} already admitted")
        total = self.blocks_needed(prompt_tokens + max_new_tokens)
        if total > self.available_blocks:
            raise MemoryError(f"KV pool exhausted: need {total}, "
                              f"available {self.available_blocks}")
        self._reserved[seq_id] = total
        self._tables[seq_id] = []
        self._lens[seq_id] = 0
        self._grow(seq_id, self.blocks_needed(prompt_tokens))
        self._lens[seq_id] = prompt_tokens
        return list(self._tables[seq_id])

    def _grow(self, seq_id: int, n_new: int) -> None:
        if n_new > self.free_blocks:
            raise MemoryError(
                f"KV pool exhausted: need {n_new}, free {self.free_blocks}")
        table = self._tables[seq_id]
        if len(table) + n_new > self._reserved[seq_id]:
            raise MemoryError(
                f"seq {seq_id} grows past its reservation "
                f"({len(table)}+{n_new} > {self._reserved[seq_id]})")
        for _ in range(n_new):
            table.append(self._free.pop())

    def append_token(self, seq_id: int) -> None:
        """Account one more cache-resident token; map a fresh block exactly
        when the token crosses a block boundary.  A refused growth leaves
        the accounting untouched."""
        new_len = self._lens[seq_id] + 1
        need = self.blocks_needed(new_len)
        have = len(self._tables[seq_id])
        if need > have:
            self._grow(seq_id, need - have)
        self._lens[seq_id] = new_len

    def table(self, seq_id: int) -> list[int]:
        return self._tables.get(seq_id, [])

    def free(self, seq_id: int) -> None:
        """Release everything ``seq_id`` holds, on whichever tier."""
        self._free.extend(self._tables.pop(seq_id, []))
        self._lens.pop(seq_id, None)
        self._reserved.pop(seq_id, None)
        self._host_lens.pop(seq_id, None)
        self._host_nblk.pop(seq_id, None)

    def audit(self, strict: bool = True) -> list[str]:
        """Conservation audit of both tiers: free and mapped blocks
        partition the pool, no block is mapped twice, every sequence maps
        ``ceil(len/block)`` blocks within its reservation, every swapped
        sequence holds ``ceil(len/block)`` host blocks, no sequence is on
        both tiers, and the host tier stays within ``host_blocks``.
        Returns the violations; ``strict`` raises :class:`IntegrityError`
        on any."""
        fails: list[str] = []
        mapped = [b for t in self._tables.values() for b in t]
        if len(mapped) != len(set(mapped)):
            fails.append("double-map: a block is in two tables (or twice in "
                         "one)")
        if len(self._free) != len(set(self._free)):
            fails.append("double-free: a block id appears twice in the free "
                         "list")
        overlap = set(mapped) & set(self._free)
        if overlap:
            fails.append(f"free/mapped overlap: {sorted(overlap)[:8]}")
        universe = set(mapped) | set(self._free)
        if universe != set(range(self.num_blocks)):
            fails.append(f"pool partition: free+mapped covers {len(universe)}"
                         f" ids, pool has {self.num_blocks}")
        if self.allocated_blocks != sum(
                self.blocks_needed(n) for n in self._lens.values()):
            fails.append("device conservation: allocated blocks != "
                         "sum(ceil(len/block)) over live sequences")
        for sid, n in self._lens.items():
            t = self._tables.get(sid)
            if t is None:
                fails.append(f"seq {sid}: has a length but no table")
                continue
            if len(t) != self.blocks_needed(n):
                fails.append(f"seq {sid}: {len(t)} mapped blocks != "
                             f"ceil({n}/{self.block})")
            if len(t) > self._reserved.get(sid, 0):
                fails.append(f"seq {sid}: mapped {len(t)} past its "
                             f"reservation {self._reserved.get(sid, 0)}")
        for sid in self._tables:
            if sid not in self._lens:
                fails.append(f"seq {sid}: has a table but no length")
        for sid, n in self._host_lens.items():
            if self._host_nblk.get(sid) != self.blocks_needed(n):
                fails.append(f"host conservation: seq {sid} holds "
                             f"{self._host_nblk.get(sid)} host blocks != "
                             f"ceil({n}/{self.block})")
        dual = set(self._lens) & set(self._host_lens)
        if dual:
            fails.append(f"dual accounting: seqs {sorted(dual)} on both "
                         "tiers")
        if (self.host_blocks is not None
                and self.host_allocated_blocks > self.host_blocks):
            fails.append(f"host cap: {self.host_allocated_blocks} blocks "
                         f"held > capacity {self.host_blocks}")
        if strict and fails:
            raise IntegrityError(fails)
        return fails


class PagedKVCache:
    """Device block pool + host block tables (one id namespace).

    ``make_pool_fn(total_blocks)`` builds the device pool; ``num_blocks``
    usable blocks are managed by the embedded :class:`BlockAllocator`, and
    one extra physical block, index ``num_blocks`` (:attr:`trash_block`),
    absorbs writes of inactive decode rows.  ``table_width`` (=
    ``max_seq_len // block``) fixes the width of every table row.
    A quantized pool also passes ``make_scales_fn(total_blocks)``, which
    builds :attr:`scales` ``[L, 2, total_blocks, Hkv]`` float32: a scale is
    a property of the block it describes, so the allocator needs no state
    for it.  ``scales`` is None for a full-precision pool.
    """

    def __init__(self, make_pool_fn, *, num_blocks: int, block: int,
                 table_width: int, make_scales_fn=None,
                 host_blocks: int | None = None):
        self.pool = make_pool_fn(num_blocks + 1)
        self.scales = (None if make_scales_fn is None
                       else make_scales_fn(num_blocks + 1))
        self.alloc = BlockAllocator(num_blocks, block,
                                    host_blocks=host_blocks)
        self.block = block
        self.trash_block = num_blocks
        self.table_width = table_width

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
