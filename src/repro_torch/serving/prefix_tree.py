"""Radix-tree prefix cache over full prompt blocks (DESIGN.md §2.14): a
copy of the reference package's ``serving/prefix_tree.py``, its
checkpoint state (§2.13) included.

The tree maps *block-granular prompt content* to resident pool blocks:
each node owns exactly one physical block of the paged KV pool and is
keyed by the raw token bytes of that block (an exact content key — a
lossy hash would admit collisions straight into the KV reuse path).  A
path from the root spells out a prompt prefix in whole blocks, so the
longest cached prefix of a new prompt is a single downward walk.

Ownership contract with
:class:`~repro_torch.serving.kv_cache.BlockAllocator`:

- The tree never holds refcounts.  It *pins* blocks via
  ``alloc.cache_block`` so a block whose last referencing sequence frees
  turns **evictable** (resident, reusable content) instead of returning
  to the free list.
- Admission increfs matched blocks (``admit(..., shared=ids)``) before
  any fresh mapping, so eviction — which only takes refcount-0 leaves —
  can never steal a prefix between ``match`` and ``admit``.
- Copy-on-write degenerates to write-into-private-block by construction:
  :meth:`match` caps the hit at ``(len(prompt) - 1) // block`` full
  blocks, so the block holding the final prompt token (where prefill
  produces the sampling logits) and every decode token after it is
  always freshly mapped and private.  Shared blocks are therefore
  *never* written, only read.
- :meth:`insert` only registers blocks wholly covered by the prompt
  (``len(prompt) // block``) — blocks the owning sequence will never
  write again.

Eviction is LRU over unreferenced leaves (dropping a leaf may expose its
parent as the next candidate, so deep cold chains unwind back-to-front);
it is wired as ``alloc.evict_fn`` so pool pressure inside ``_grow``
drains the cache before admission control ever preempts a running
sequence.  Invalidation (fault quarantine, §2.13) drops a node AND its
whole subtree — descendants are only reachable through the corrupted
prefix — so a poisoned block can never be handed to a future admission.
"""
from __future__ import annotations

import heapq

import numpy as np


class _Node:
    __slots__ = ("key", "block_id", "children", "parent", "last_used")

    def __init__(self, key, block_id, parent, last_used):
        self.key = key
        self.block_id = block_id
        self.children: dict[bytes, _Node] = {}
        self.parent = parent
        self.last_used = last_used


class RadixPrefixCache:
    """Content-keyed radix tree over full prompt blocks of a paged pool."""

    def __init__(self, alloc, block: int):
        self.alloc = alloc
        self.block = block
        self.root = _Node(None, -1, None, 0)
        self._nodes: dict[int, _Node] = {}   # block_id -> owning node
        self._clock = 0                      # logical LRU time
        self.stats = {
            "lookups": 0, "hits": 0, "hit_blocks": 0, "hit_tokens": 0,
            "inserted_blocks": 0, "evicted_blocks": 0,
            "invalidated_blocks": 0, "flushes": 0,
        }

    # -- content keys -------------------------------------------------------
    def _key(self, tokens) -> bytes:
        """Exact content key of one full block of prompt tokens."""
        return np.ascontiguousarray(
            np.asarray(tokens, np.int32)).tobytes()

    @property
    def num_blocks(self) -> int:
        return len(self._nodes)

    def block_ids(self) -> set[int]:
        return set(self._nodes)

    # -- lookup / registration ----------------------------------------------
    def match(self, prompt) -> tuple[list[int], int]:
        """Longest cached prefix of ``prompt`` in whole blocks: returns
        ``(block_ids, hit_tokens)`` with ``hit_tokens = len(ids) * block``.
        The walk is capped at ``(len(prompt) - 1) // block`` so at least
        one prompt token always remains to prefill (the final chunk must
        run to produce this request's first-token logits — and its block,
        the COW boundary, stays private)."""
        self.stats["lookups"] += 1
        prompt = np.asarray(prompt)
        limit = max(0, (len(prompt) - 1) // self.block)
        self._clock += 1
        node, ids = self.root, []
        for i in range(limit):
            child = node.children.get(
                self._key(prompt[i * self.block:(i + 1) * self.block]))
            if child is None:
                break
            child.last_used = self._clock
            ids.append(child.block_id)
            node = child
        if ids:
            self.stats["hits"] += 1
            self.stats["hit_blocks"] += len(ids)
            self.stats["hit_tokens"] += len(ids) * self.block
        return ids, len(ids) * self.block

    def insert(self, prompt, table) -> int:
        """Register a fully-prefilled prompt's whole blocks; returns how
        many were newly cached.  Existing nodes just get an LRU touch (a
        concurrent identical prefill keeps its private copy — blocks are
        never re-pointed after the fact).  Blocks that are shared but lost
        their node (fault invalidation raced this prefill) stop the walk:
        re-caching possibly-poisoned content is never worth it."""
        prompt = np.asarray(prompt)
        self._clock += 1
        node, added = self.root, 0
        for i in range(len(prompt) // self.block):
            key = self._key(prompt[i * self.block:(i + 1) * self.block])
            child = node.children.get(key)
            if child is None:
                bid = int(table[i])
                if self.alloc.refcount(bid) != 1 or self.alloc.is_cached(
                        bid) or bid in self._nodes:
                    break
                child = _Node(key, bid, node, self._clock)
                node.children[key] = child
                self._nodes[bid] = child
                self.alloc.cache_block(bid)
                added += 1
            else:
                child.last_used = self._clock
            node = child
        self.stats["inserted_blocks"] += added
        return added

    # -- reclamation ---------------------------------------------------------
    def _drop(self, node: _Node) -> None:
        node.parent.children.pop(node.key, None)
        self._nodes.pop(node.block_id, None)
        self.alloc.uncache_block(node.block_id)

    def evict(self, need: int) -> int:
        """LRU-evict unreferenced leaves until ``need`` blocks returned to
        the free lists (or nothing evictable remains).  Wired as
        ``alloc.evict_fn``.  One pass over the allocator's evictable set
        (cached AND unreferenced, maintained incrementally) seeds a
        min-heap keyed by LRU stamp; each drop pops in O(log E) and
        pushes the parent it may expose — an eviction burst is
        O(E + need log E), not the old O(nodes) rescan per freed block
        (O(nodes^2) on the admission/decode hot path).  LRU stamps can't
        move mid-call (evict runs synchronously inside ``_grow``), so
        heap entries only go stale through this call's own drops, which
        the pop-time revalidation skips."""
        freed = 0
        heap = []
        for bid in self.alloc.evictable_ids():
            node = self._nodes.get(bid)
            if node is not None and not node.children:
                heap.append((node.last_used, bid))
        heapq.heapify(heap)
        while freed < need and heap:
            _, bid = heapq.heappop(heap)
            node = self._nodes.get(bid)
            if (node is None or node.children
                    or self.alloc.refcount(bid) != 0):
                continue
            parent = node.parent
            self._drop(node)
            freed += 1
            # dropping the last child exposes the parent as the next
            # candidate (deep cold chains unwind back-to-front); a parent
            # had children at seed time, so this is its only push
            if (parent is not self.root and not parent.children
                    and self.alloc.refcount(parent.block_id) == 0):
                heapq.heappush(heap, (parent.last_used, parent.block_id))
        self.stats["evicted_blocks"] += freed
        return freed

    def _drop_subtree(self, node: _Node) -> int:
        node.parent.children.pop(node.key, None)
        count, stack = 0, [node]
        while stack:
            cur = stack.pop()
            stack.extend(cur.children.values())
            cur.children = {}
            self._nodes.pop(cur.block_id, None)
            self.alloc.uncache_block(cur.block_id)
            count += 1
        return count

    def invalidate_blocks(self, ids) -> int:
        """Fault quarantine (§2.13): drop every node owning one of ``ids``
        plus its whole subtree, so corrupted content (and anything only
        reachable through it) can never seed a future prefix hit.
        Returns the number of nodes dropped."""
        count = 0
        for bid in ids:
            node = self._nodes.get(int(bid))
            if node is not None:
                count += self._drop_subtree(node)
        self.stats["invalidated_blocks"] += count
        return count

    def flush(self) -> int:
        """Drop every node.  Called at epoch swaps: cached prefix KV was
        computed under the OLD epoch's per-head budgets, and a prefill
        under the new plan would not reproduce it bitwise — flushing is
        what keeps cache-enabled greedy decoding identical to
        cache-disabled across replans."""
        count = 0
        for node in list(self.root.children.values()):
            count += self._drop_subtree(node)
        self.stats["flushes"] += 1
        return count

    # -- checkpoint (§2.13) --------------------------------------------------
    def snapshot_state(self) -> dict:
        """JSON-serializable tree state, parent-before-child, with LRU
        clocks — a restored server keeps its hits warm AND evicts in the
        same order as the uninterrupted one."""
        nodes: list[dict] = []

        def walk(node: _Node, parent_idx: int) -> None:
            idx = len(nodes)
            nodes.append({
                "block": node.block_id,
                "tokens": np.frombuffer(node.key, np.int32).tolist(),
                "parent": parent_idx,
                "last_used": node.last_used,
            })
            for child in node.children.values():
                walk(child, idx)

        for child in self.root.children.values():
            walk(child, -1)
        return {"clock": self._clock, "nodes": nodes}

    def load_state(self, state: dict) -> None:
        """Adopt a :meth:`snapshot_state` snapshot.  The allocator's state
        (including cache pins) must already be restored; ``cache_block``
        is idempotent so re-pinning here is safe."""
        for node in list(self.root.children.values()):
            self._drop_subtree(node)
        self._clock = int(state["clock"])
        flat: list[_Node] = []
        for rec in state["nodes"]:
            parent = self.root if rec["parent"] < 0 else flat[rec["parent"]]
            key = np.asarray(rec["tokens"], np.int32).tobytes()
            node = _Node(key, int(rec["block"]), parent,
                         int(rec["last_used"]))
            parent.children[key] = node
            self._nodes[node.block_id] = node
            self.alloc.cache_block(node.block_id)
            flat.append(node)
