"""Paged KV-cache memory: the host block allocator and the device pool.

The main-path subset of the reference's ``serving/kv_cache.py``:

- :class:`BlockAllocator` — host bookkeeping of a fixed pool of
  ``block``-token cache blocks, the one source of truth for KV memory.  A
  sequence is admitted with a reservation for its worst case (prompt + max
  new tokens) but maps physical blocks only as tokens land: prompt blocks
  at admission, decode blocks one at a time in :meth:`append_token`.
  Conservation invariant (:meth:`audit`): every block is free or mapped by
  exactly one table, and every live sequence maps ``ceil(len/block)``
  blocks.  Ownership is exclusive here (no prefix sharing, no stripes, no
  host swap tier yet).
- :class:`PagedKVCache` — the device pool ``[L, 2, num_blocks+1, Hkv,
  block, Dh]`` whose last block is the trash block, addressed through the
  allocator's tables (one block-id namespace down to the kernels).
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

    def __post_init__(self):
        self._free: list[int] = list(range(self.num_blocks))
        self._tables: dict[int, list[int]] = {}
        self._lens: dict[int, int] = {}       # cache-resident tokens
        self._reserved: dict[int, int] = {}   # worst-case blocks per seq

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
        return self._lens.get(seq_id, 0)

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
        """Release everything ``seq_id`` holds."""
        self._free.extend(self._tables.pop(seq_id, []))
        self._lens.pop(seq_id, None)
        self._reserved.pop(seq_id, None)

    def audit(self, strict: bool = True) -> list[str]:
        """Conservation audit: free and mapped blocks partition the pool, no
        block is mapped twice, and every sequence maps ``ceil(len/block)``
        blocks within its reservation.  Returns the violations; ``strict``
        raises :class:`IntegrityError` on any."""
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
    """

    def __init__(self, make_pool_fn, *, num_blocks: int, block: int,
                 table_width: int):
        self.pool = make_pool_fn(num_blocks + 1)
        self.alloc = BlockAllocator(num_blocks, block)
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

    def audit(self, strict: bool = True) -> list[str]:
        """Allocator accounting plus the pool's block axis (usable blocks
        plus the trash block)."""
        fails = self.alloc.audit(strict=False)
        if self.pool.shape[2] != self.num_blocks + 1:
            fails.append(f"pool shape: block axis {self.pool.shape[2]} != "
                         f"num_blocks+trash {self.num_blocks + 1}")
        if strict and fails:
            raise IntegrityError(fails)
        return fails
