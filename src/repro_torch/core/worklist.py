"""Flattened sparse-attention work lists: the host-side item encodings that
feed both attention kernels.

A copy of the reference package's ``core/worklist.py`` (the functions the
serving main path uses), kept here so the port never imports the reference.
Item encodings are unchanged, so the host packers feed both packages:

    prefill item [:, F_*]: head, q_blk, kv_blk, first, last, valid, kv_head
    decode item  [:, D_*]: batch_row, kv_head, kv_blk, first, last, valid

Items of one run ((head, q_blk) for prefill, (row, kv_head) for decode) are
contiguous and in ascending kv-block order; padding rows replicate the last
real item with first/last/valid = 0.
"""
from __future__ import annotations

import dataclasses

import numpy as np

ITEM_FIELDS = 7
F_HEAD, F_QBLK, F_KVBLK, F_FIRST, F_LAST, F_VALID, F_KVHEAD = range(ITEM_FIELDS)

# Decode work items (DESIGN.md §2.8): one item = one (batch_row, kv_head,
# kv_block) matvec tile.  The constants live here (host-side, numpy-only)
# and the kernel modules import them, so the packers never import torch.
DEC_FIELDS = 6
D_BATCH, D_KVHEAD, D_KVBLK, D_FIRST, D_LAST, D_VALID = range(DEC_FIELDS)


def pow2_bucket(n: int, lo: int = 8, hi: int | None = None) -> int:
    """Smallest power of two >= ``n`` (floored at ``lo``, capped at ``hi``).

    The decode item tables are padded to these buckets so mixed-length
    continuous-batching ticks reuse O(log worst-case) compiled programs
    instead of one per distinct item count — the same policy the engine's
    prefill buckets use for prompt lengths.
    """
    b = max(1, int(lo))
    n = max(int(n), 1)
    while b < n:
        b *= 2
    return b if hi is None else min(b, max(int(hi), int(lo)))


def blocks_for_budget(budgets: np.ndarray, block: int) -> np.ndarray:
    """Token budgets -> per-head kv-block counts (ceil)."""
    b = np.asarray(budgets, dtype=np.int64)
    return np.maximum(-(-b // block), 1)


@dataclasses.dataclass
class WorkList:
    """Per-device padded work-lists for one attention layer.

    items:      ``[D, L_pad, ITEM_FIELDS]`` int32.
    lengths:    ``[D]`` true (unpadded) item counts.
    num_q_blocks, num_kv_blocks, block: geometry.
    """

    items: np.ndarray
    lengths: np.ndarray
    num_q_blocks: int
    num_kv_blocks: int
    block: int

    @property
    def num_devices(self) -> int:
        return self.items.shape[0]

    @property
    def padded_length(self) -> int:
        return self.items.shape[1]

    @property
    def total_real_items(self) -> int:
        return int(self.lengths.sum())

    @property
    def padded_total(self) -> int:
        return self.padded_length * self.num_devices

    @property
    def padding_waste(self) -> float:
        """Fraction of grid steps that are padding — the SPMD bubble that
        S-HPLB minimizes (= the paper's resource wastage, exactly)."""
        tot = self.padded_total
        return 1.0 - self.total_real_items / tot if tot else 0.0

    @property
    def imbalance(self) -> float:
        mean = float(self.lengths.mean())
        return float(self.lengths.max() / mean) if mean > 0 else 1.0


def _items_for_head(
    head_local: int,
    kv_head_local: int,
    q_blocks: int,
    kv_block_ids: list[np.ndarray],
) -> np.ndarray:
    """Items for one head given its selected kv blocks per q block."""
    rows = []
    for qb in range(q_blocks):
        sel = np.asarray(kv_block_ids[qb], dtype=np.int64)
        n = len(sel)
        if n == 0:
            continue
        it = np.zeros((n, ITEM_FIELDS), dtype=np.int32)
        it[:, F_HEAD] = head_local
        it[:, F_QBLK] = qb
        it[:, F_KVBLK] = np.sort(sel)
        it[0, F_FIRST] = 1
        it[-1, F_LAST] = 1
        it[:, F_VALID] = 1
        it[:, F_KVHEAD] = kv_head_local
        rows.append(it)
    if not rows:
        return np.zeros((0, ITEM_FIELDS), dtype=np.int32)
    return np.concatenate(rows, axis=0)


def build_worklist(
    selections: list[list[np.ndarray]],
    device_of_head: np.ndarray,
    num_devices: int,
    num_q_blocks: int,
    num_kv_blocks: int,
    block: int,
    pad_multiple: int = 8,
    kv_head_of_head: np.ndarray | None = None,
    kv_local: bool = True,
) -> WorkList:
    """Build per-device padded work-lists.

    Parameters
    ----------
    selections:
        ``selections[h][qb]`` = array of kv block ids head ``h`` attends to
        at query block ``qb`` (already budget-limited by the policy).
    device_of_head:
        ``[H]`` device index per head (slot order from the HPLB plan:
        ``slot // heads_per_device``).
    pad_multiple:
        pad L_pad up so the kernel grid length is a friendly multiple.
    kv_head_of_head:
        ``[H]`` kv-head per q-head slot (GQA).  Default: identity (MHA).
    kv_local:
        True (kv_group mode): kv heads are SHARDED with their q heads; item
        kv indices are remapped to device-local first-seen order.
        False (kv_replication mode): kv heads are replicated on every
        device; item kv indices stay GLOBAL.
    """
    H = len(selections)
    if kv_head_of_head is None:
        kv_head_of_head = np.arange(H, dtype=np.int64)
    per_dev: list[list[np.ndarray]] = [[] for _ in range(num_devices)]
    heads_seen_per_dev = np.zeros(num_devices, dtype=np.int64)
    kv_local_map: list[dict[int, int]] = [dict() for _ in range(num_devices)]
    for h in range(H):
        d = int(device_of_head[h])
        head_local = int(heads_seen_per_dev[d])
        heads_seen_per_dev[d] += 1
        kv_g = int(kv_head_of_head[h])
        if kv_local:
            if kv_g not in kv_local_map[d]:
                kv_local_map[d][kv_g] = len(kv_local_map[d])
            kv_idx = kv_local_map[d][kv_g]
        else:
            kv_idx = kv_g
        it = _items_for_head(head_local, kv_idx, num_q_blocks, selections[h])
        if len(it):
            per_dev[d].append(it)
    dev_items = [
        np.concatenate(g, axis=0) if g else np.zeros((0, ITEM_FIELDS), np.int32)
        for g in per_dev
    ]
    lengths = np.array([len(x) for x in dev_items], dtype=np.int64)
    L_pad = int(lengths.max()) if len(lengths) else 0
    L_pad = max(pad_multiple, -(-L_pad // pad_multiple) * pad_multiple)
    items = np.zeros((num_devices, L_pad, ITEM_FIELDS), dtype=np.int32)
    for d, x in enumerate(dev_items):
        items[d, : len(x)] = x
        if len(x):
            # padding replicates the last real item's indices (valid=0):
            # keeps the Pallas out-tile index constant so the finalized tile
            # is not flushed-then-clobbered by a stray index change.
            pad_row = x[-1].copy()
            pad_row[F_FIRST] = 0
            pad_row[F_LAST] = 0
            pad_row[F_VALID] = 0
            items[d, len(x):] = pad_row
    return WorkList(
        items=items, lengths=lengths,
        num_q_blocks=num_q_blocks, num_kv_blocks=num_kv_blocks, block=block,
    )


def worklist_from_budgets(
    budgets_slot_order: np.ndarray,
    *,
    num_devices: int,
    seq_len: int,
    block: int,
    policy_fn,
    pad_multiple: int = 8,
    group_size: int = 1,
    kv_head_of_head: np.ndarray | None = None,
    kv_local: bool = True,
) -> WorkList:
    """Convenience: budgets (slot order) + a selection policy -> WorkList.

    ``policy_fn(head_slot, num_blocks_budget, num_q_blocks, num_kv_blocks)
    -> list over q_blocks of kv-block-id arrays``.  The causal structure
    (kv_blk <= q_blk) is the policy's responsibility.  ``group_size``: GQA
    query heads per kv head (kv_group mode: slot order groups them
    contiguously).  ``kv_head_of_head`` overrides the mapping (slot order)
    — required in kv_replication mode where the permutation is per-q-head;
    pair it with ``kv_local=False``.
    """
    H = len(budgets_slot_order)
    assert H % num_devices == 0
    heads_per_dev = H // num_devices
    nq = -(-seq_len // block)
    nkv = nq
    nb = blocks_for_budget(budgets_slot_order, block)
    selections = [
        policy_fn(h, int(nb[h]), nq, nkv) for h in range(H)
    ]
    device_of_head = np.arange(H) // heads_per_dev
    if kv_head_of_head is None:
        kv_head_of_head = np.arange(H) // group_size
    return build_worklist(
        selections, device_of_head, num_devices, nq, nkv, block,
        pad_multiple=pad_multiple, kv_head_of_head=kv_head_of_head,
        kv_local=kv_local,
    )


def chunk_items(items: np.ndarray, q_blk_start: int, q_blk_count: int,
                pad_to: int | None = None) -> np.ndarray:
    """Slice a flattened work-list to the q-block window ``[q_blk_start,
    q_blk_start + q_blk_count)`` — the chunked-prefill view of a full-prompt
    list (DESIGN.md §2.6).

    ``items``: one device's ``[N, ITEM_FIELDS]`` list.  Kept items have
    F_QBLK remapped to chunk-local indices; F_KVBLK stays GLOBAL (the chunk
    attends the whole resident KV prefix).  (head, q_blk) groups are kept
    intact, so the F_FIRST/F_LAST accumulator protocol survives the slice.
    ``pad_to`` pads with the last real item replicated at valid=0 (the same
    convention as :func:`build_worklist`); chunk lists padded to one width
    enter the jitted chunk prefill as DATA, so varying chunk offsets never
    recompile.
    """
    it = np.asarray(items).reshape(-1, ITEM_FIELDS)
    keep = ((it[:, F_VALID] == 1)
            & (it[:, F_QBLK] >= q_blk_start)
            & (it[:, F_QBLK] < q_blk_start + q_blk_count))
    out = it[keep].copy()
    out[:, F_QBLK] -= q_blk_start
    if pad_to is None:
        return out
    if len(out) > pad_to:
        raise ValueError(
            f"chunk work-list ({len(out)} items) exceeds pad_to={pad_to}")
    padded = np.zeros((pad_to, ITEM_FIELDS), dtype=np.int32)
    padded[: len(out)] = out
    if len(out):
        pad_row = out[-1].copy()
        pad_row[F_FIRST] = 0
        pad_row[F_LAST] = 0
        pad_row[F_VALID] = 0
        padded[len(out):] = pad_row
    return padded


def chunk_item_counts(items: np.ndarray, num_q_blocks: int) -> np.ndarray:
    """Per-q-block real-item counts of one device's list ``[N, 7]`` —
    sliding-window sums over this give the compile-time item cap for a
    chunk bucket (``Engine._chunk_item_cap``)."""
    it = np.asarray(items).reshape(-1, ITEM_FIELDS)
    real = it[it[:, F_VALID] == 1]
    return np.bincount(real[:, F_QBLK], minlength=num_q_blocks)[:num_q_blocks]


def build_row_worklist(
    selections: list[list[np.ndarray]],
    *,
    num_devices: int,
    num_q_blocks: int,
    num_kv_blocks: int,
    block: int,
    kv_head_of_head: np.ndarray | None = None,
    pad_multiple: int = 8,
) -> WorkList:
    """Row-mode work-lists: partition (head, q_block) ROWS across devices.

    Beyond-paper generalization of HPLB for archs whose head count does not
    divide the model axis (gemma3-1b: 4 heads over 16 shards; llama4: 40
    over 16): the atoms of the multiway partition are (head, q_blk) rows
    with weight = that row's tile count, balanced by the same
    best-partition machinery.  q/k/v are REPLICATED inside the island and
    each shard contributes only its rows; outputs combine by psum (disjoint
    tiles).  Item head/kv indices are GLOBAL.
    """
    from repro_torch.core.partition import best_partition

    H = len(selections)
    if kv_head_of_head is None:
        kv_head_of_head = np.arange(H, dtype=np.int64)
    rows = []        # (h, qb, tiles)
    for h in range(H):
        for qb in range(num_q_blocks):
            n = len(selections[h][qb])
            if n:
                rows.append((h, qb, n))
    weights = np.array([r[2] for r in rows], dtype=np.int64)
    asg = best_partition(weights, num_devices)
    per_dev: list[list[np.ndarray]] = [[] for _ in range(num_devices)]
    for (h, qb, _), d in zip(rows, asg.device_of):
        sel = np.sort(np.asarray(selections[h][qb], dtype=np.int64))
        it = np.zeros((len(sel), ITEM_FIELDS), dtype=np.int32)
        it[:, F_HEAD] = h
        it[:, F_QBLK] = qb
        it[:, F_KVBLK] = sel
        it[0, F_FIRST] = 1
        it[-1, F_LAST] = 1
        it[:, F_VALID] = 1
        it[:, F_KVHEAD] = kv_head_of_head[h]
        per_dev[int(d)].append(it)
    dev_items = [
        np.concatenate(g, axis=0) if g else np.zeros((0, ITEM_FIELDS),
                                                     np.int32)
        for g in per_dev
    ]
    lengths = np.array([len(x) for x in dev_items], dtype=np.int64)
    L_pad = int(lengths.max()) if len(lengths) else 0
    L_pad = max(pad_multiple, -(-L_pad // pad_multiple) * pad_multiple)
    items = np.zeros((num_devices, L_pad, ITEM_FIELDS), dtype=np.int32)
    for d, x in enumerate(dev_items):
        items[d, : len(x)] = x
        if len(x):
            pad_row = x[-1].copy()
            pad_row[F_FIRST] = 0
            pad_row[F_LAST] = 0
            pad_row[F_VALID] = 0
            items[d, len(x):] = pad_row
    return WorkList(items=items, lengths=lengths,
                    num_q_blocks=num_q_blocks, num_kv_blocks=num_kv_blocks,
                    block=block)



# ---------------------------------------------------------------------------
# Cost-packed ragged decode worklists (DESIGN.md §2.8)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PackedDecodeWorkList:
    """Per-shard cost-packed decode item lists for one attention layer.

    items:   ``[D, L_pad, DEC_FIELDS]`` int32 — one (batch_row, kv_head,
             kv_block) tile per row, runs of one (row, kv_head) contiguous
             and in ascending kv_block order; padding rows replicate the
             shard's last real item with first/last/valid = 0.
    lengths: ``[D]`` true (unpadded) item counts per shard.
    """

    items: np.ndarray
    lengths: np.ndarray
    block: int

    @property
    def num_shards(self) -> int:
        return self.items.shape[0]

    @property
    def padded_length(self) -> int:
        return self.items.shape[1]

    @property
    def total_real_items(self) -> int:
        return int(self.lengths.sum())

    @property
    def padded_total(self) -> int:
        return self.padded_length * self.num_shards

    @property
    def padding_waste(self) -> float:
        """Fraction of grid steps that are padding — the decode-phase SPMD
        bubble (same definition as :class:`WorkList.padding_waste`)."""
        tot = self.padded_total
        return 1.0 - self.total_real_items / tot if tot else 0.0

    @property
    def imbalance(self) -> float:
        mean = float(self.lengths.mean())
        return float(self.lengths.max() / mean) if mean > 0 else 1.0

    def flat(self) -> np.ndarray:
        """Shards concatenated ``[D * L_pad, DEC_FIELDS]`` — the single-host
        execution order (runs stay contiguous; shard padding rows are inert
        valid=0 replicas, exactly like in-shard padding)."""
        return self.items.reshape(-1, DEC_FIELDS)


def pack_decode_items(
    block_ids: np.ndarray,
    *,
    num_shards: int = 1,
    block: int = 128,
    bucket: int | None = None,
    pad_multiple: int = 8,
    shard_of_kvhead: np.ndarray | None = None,
    kvhead_local: bool = False,
    bytes_per_block: float | None = None,
    phys_of_block: np.ndarray | None = None,
) -> PackedDecodeWorkList:
    """Flatten per-slot decode selections into cost-packed ragged lists.

    ``block_ids``: ``[B, Hkv, nb]`` int32 selected kv blocks per (batch
    row, kv head), -1 padding TRAILING (the engine's per-slot selection
    layout).  Each (row, head) with >= 1 selected block becomes one
    contiguous run of items; runs are assigned to shards by
    :func:`repro.core.partition.best_partition` over their true block
    counts — so each shard's grid length is proportional to its share of
    the total selected blocks, not ``Hkv x max-budget x worst-slot``.

    ``shard_of_kvhead``: ``[Hkv]`` pins every head's runs to a fixed shard
    (head-parallel islands, where the cache shard owning the head must
    execute it); packing freedom then only removes padding.  ``None`` packs
    freely across heads AND batch rows (single-device grids, replicated or
    pool-sharded caches).  ``kvhead_local`` remaps item kv-head indices to
    shard-local first-seen order (head-sharded caches — pair it with
    ``shard_of_kvhead``); the default keeps them GLOBAL.  ``bucket`` fixes
    the padded per-shard length (compile bucketing); it must be >= the
    longest shard's run total.

    ``bytes_per_block`` (§2.12 byte-true packing): the pool's REAL HBM
    bytes streamed per selected kv block (K+V codes plus amortized
    per-block scales, see ``repro.core.quant.kv_dtype_bytes``).  Weights
    become bytes instead of block counts, so the partition balances what
    the memory system actually pays.

    ``phys_of_block`` (§2.14 charge-once packing): ``[B, T]`` physical
    pool ids per LOGICAL block position of each row (-1 unmapped — the
    allocator tables, exactly what the paged executor indexes with).
    When given, a prefix-SHARED physical block is charged to a kv head's
    cost once no matter how many batch rows reference it: each run's
    weight becomes its count of first-seen physical ids within its head
    (floor 1 — every run still pays its launch/output cost).  Items are
    untouched; kv blocks stay logical.

    The dedup is a deliberate cost-model approximation when packing
    freely across shards (``shard_of_kvhead=None``): it keys seen blocks
    per kv head BEFORE the partition, but ``best_partition`` may then
    place two runs of that head on different model shards — each shard
    streams the shared block once while the weights charged it once
    globally, slightly understating those shards' true bytes.  An exact
    per-(head, shard) dedup would need the assignment the weights
    themselves produce (circular).  With ``shard_of_kvhead`` pinned
    (head-parallel islands) every run of a head lands on one shard and
    the charge is exact.
    """
    from repro_torch.core.partition import best_partition

    ids = np.asarray(block_ids)
    assert ids.ndim == 3, f"block_ids must be [B, Hkv, nb], got {ids.shape}"
    B, hkv, nb = ids.shape
    counts = (ids >= 0).sum(axis=-1)                      # [B, Hkv]
    runs = [(b, h, int(counts[b, h]))
            for b in range(B) for h in range(hkv) if counts[b, h] > 0]
    weights = np.array([r[2] for r in runs], dtype=np.int64)
    if phys_of_block is not None:
        pob = np.asarray(phys_of_block)
        # keyed per kv head, pre-partition: exact when the head's runs
        # all land on one shard (shard_of_kvhead pinned, or 1 shard);
        # otherwise a documented understatement — see the docstring
        seen: dict[int, set[int]] = {}
        fresh_w = []
        for b, h, _ in runs:       # b-major order — deterministic dedup
            sel = ids[b, h][ids[b, h] >= 0].astype(np.int64)
            held = seen.setdefault(h, set())
            fresh = 0
            for p in pob[b, sel].tolist():
                if p >= 0 and p not in held:
                    held.add(p)
                    fresh += 1
            fresh_w.append(max(1, fresh))
        weights = np.array(fresh_w, dtype=np.int64)
    if bytes_per_block is not None:
        # byte-true weights (§2.12): scale selected-block counts by the
        # pool's real per-block HBM footprint (K+V codes + amortized
        # per-block scales).  Uniform dtype => positive scaling, so the
        # partition is unchanged; the weights read in bytes.
        weights = np.maximum(
            1, np.round(weights * float(bytes_per_block))).astype(np.int64)
    if shard_of_kvhead is None:
        asg = best_partition(weights, num_shards).device_of
    else:
        shard_of_kvhead = np.asarray(shard_of_kvhead)
        asg = np.array([int(shard_of_kvhead[h]) for _, h, _ in runs],
                       dtype=np.int64)
    per_shard: list[list[np.ndarray]] = [[] for _ in range(num_shards)]
    kv_local_map: list[dict[int, int]] = [dict() for _ in range(num_shards)]
    for (b, h, n), d in zip(runs, asg):
        d = int(d)
        if kvhead_local:
            if h not in kv_local_map[d]:
                kv_local_map[d][h] = len(kv_local_map[d])
            h_idx = kv_local_map[d][h]
        else:
            h_idx = h
        sel = np.sort(ids[b, h][ids[b, h] >= 0].astype(np.int64))
        it = np.zeros((n, DEC_FIELDS), dtype=np.int32)
        it[:, D_BATCH] = b
        it[:, D_KVHEAD] = h_idx
        it[:, D_KVBLK] = sel
        it[0, D_FIRST] = 1
        it[-1, D_LAST] = 1
        it[:, D_VALID] = 1
        per_shard[int(d)].append(it)
    dev_items = [
        np.concatenate(g, axis=0) if g else np.zeros((0, DEC_FIELDS),
                                                     np.int32)
        for g in per_shard
    ]
    lengths = np.array([len(x) for x in dev_items], dtype=np.int64)
    L_pad = int(lengths.max()) if len(lengths) else 0
    L_pad = max(pad_multiple, -(-L_pad // pad_multiple) * pad_multiple)
    if bucket is not None:
        assert bucket >= L_pad, (
            f"bucket {bucket} < packed shard length {L_pad}")
        L_pad = int(bucket)
    items = np.zeros((num_shards, L_pad, DEC_FIELDS), dtype=np.int32)
    for d, x in enumerate(dev_items):
        items[d, : len(x)] = x
        if len(x):
            # padding replicates the last real item (valid=0): the Pallas
            # out-tile index must not jump to an already-finalized tile.
            pad_row = x[-1].copy()
            pad_row[D_FIRST] = 0
            pad_row[D_LAST] = 0
            pad_row[D_VALID] = 0
            items[d, len(x):] = pad_row
    return PackedDecodeWorkList(items=items, lengths=lengths, block=block)


@dataclasses.dataclass
class PackedDecodeWorkList2D:
    """Per-(model shard, seq stripe) cost-packed decode lists for one layer
    (DESIGN.md §2.11).

    items:   ``[Dm, S, L_pad, DEC_FIELDS]`` int32 — cell (d, s) holds the
             runs assigned to model shard d whose kv blocks live on stripe
             s (kv blocks stay LOGICAL; the executor resolves them through
             the per-slot table, and stripe membership is a property of
             the PHYSICAL id, so a cell's items never reference another
             stripe's blocks).
    lengths: ``[Dm, S]`` true (unpadded) item counts per cell.
    """

    items: np.ndarray
    lengths: np.ndarray
    block: int

    @property
    def num_shards(self) -> int:
        return self.items.shape[0]

    @property
    def num_stripes(self) -> int:
        return self.items.shape[1]

    @property
    def padded_length(self) -> int:
        return self.items.shape[2]

    @property
    def total_real_items(self) -> int:
        return int(self.lengths.sum())

    @property
    def padded_total(self) -> int:
        return self.padded_length * self.num_shards * self.num_stripes

    @property
    def padding_waste(self) -> float:
        tot = self.padded_total
        return 1.0 - self.total_real_items / tot if tot else 0.0

    @property
    def imbalance(self) -> float:
        """max cell / mean cell — the 2D SPMD bubble."""
        mean = float(self.lengths.mean())
        return float(self.lengths.max() / mean) if mean > 0 else 1.0

    @property
    def model_imbalance(self) -> float:
        """Head-axis imbalance: per-model-shard totals (over stripes)."""
        m = self.lengths.sum(axis=1).astype(np.float64)
        mean = float(m.mean())
        return float(m.max() / mean) if mean > 0 else 1.0

    @property
    def stripe_imbalance(self) -> float:
        """Seq-axis imbalance: per-stripe totals (over model shards)."""
        s = self.lengths.sum(axis=0).astype(np.float64)
        mean = float(s.mean())
        return float(s.max() / mean) if mean > 0 else 1.0

    def stripe_items(self) -> np.ndarray:
        """``[S, Dm * L_pad, DEC_FIELDS]`` — the single-host execution
        layout: per stripe, all model shards' lists concatenated (the 1D
        :meth:`PackedDecodeWorkList.flat` applied within each stripe).
        The engine runs one partial pass per stripe and merges the
        ``(out, m, l)`` partials."""
        return np.swapaxes(self.items, 0, 1).reshape(
            self.num_stripes, -1, DEC_FIELDS)


def pack_decode_items_2d(
    block_ids: np.ndarray,
    stripe_of_block: np.ndarray,
    *,
    num_stripes: int,
    num_shards: int = 1,
    block: int = 128,
    bucket: int | None = None,
    pad_multiple: int = 8,
    shard_of_kvhead: np.ndarray | None = None,
    kvhead_local: bool = False,
    bytes_per_block: float | None = None,
    phys_of_block: np.ndarray | None = None,
) -> PackedDecodeWorkList2D:
    """2D (model x seq) twin of :func:`pack_decode_items`.

    ``block_ids [B, Hkv, nb]``: LOGICAL selected kv blocks per (batch row,
    kv head), -1 trailing padding.  ``stripe_of_block [B, T]``: owning seq
    stripe of each LOGICAL block position of each row (-1 for unmapped) —
    derived from the stripe-aware allocator's tables
    (``BlockAllocator.stripe_of``), since a block computes on the shard
    that physically holds it.  Each (row, head) run splits into per-stripe
    sub-runs; the run's per-stripe block counts form its weight VECTOR and
    :func:`repro_torch.core.partition.best_partition_2d` picks its model shard
    to minimize the max (shard, stripe) CELL — the padded 2D grid.
    ``shard_of_kvhead`` pins runs to head-owning shards (islands);
    ``kvhead_local`` remaps kv-head ids shard-local, as in the 1D packer.
    Selections pointing at unmapped blocks (stripe -1) are dropped — the
    1D executor would mask them via the table's -1 anyway.
    """
    from repro_torch.core.partition import best_partition_2d

    ids = np.asarray(block_ids)
    assert ids.ndim == 3, f"block_ids must be [B, Hkv, nb], got {ids.shape}"
    B, hkv, nb = ids.shape
    sob = np.asarray(stripe_of_block)
    assert sob.ndim == 2 and sob.shape[0] == B, \
        f"stripe_of_block must be [B, T], got {sob.shape}"
    # per-run, per-stripe sorted logical block lists
    runs: list[tuple[int, int, list[np.ndarray]]] = []   # (b, h, per-stripe)
    for b in range(B):
        for h in range(hkv):
            sel = ids[b, h][ids[b, h] >= 0].astype(np.int64)
            if not len(sel):
                continue
            stripes_of_sel = sob[b, sel]
            per_stripe = [np.sort(sel[stripes_of_sel == s])
                          for s in range(num_stripes)]
            if sum(len(p) for p in per_stripe):
                runs.append((b, h, per_stripe))
    W = np.array([[len(p) for p in per_stripe]
                  for _, _, per_stripe in runs],
                 dtype=np.int64).reshape(len(runs), num_stripes)
    if phys_of_block is not None:
        # charge-once (§2.14), per (kv head, stripe) cell: a shared
        # physical block streams once per head per stripe regardless of
        # how many rows reference it.  The stripe key is exact (stripe
        # is a property of the physical id); the head key carries the
        # same free-packing approximation as pack_decode_items — exact
        # only when shard_of_kvhead pins each head's runs to one shard
        pob = np.asarray(phys_of_block)
        seen2: dict[tuple[int, int], set[int]] = {}
        for ridx, (b, h, per_stripe) in enumerate(runs):
            for s, sel in enumerate(per_stripe):
                if not len(sel):
                    continue
                held = seen2.setdefault((h, s), set())
                fresh = 0
                for p in pob[b, np.asarray(sel, np.int64)].tolist():
                    if p >= 0 and p not in held:
                        held.add(p)
                        fresh += 1
                W[ridx, s] = max(1, fresh)
    if bytes_per_block is not None:
        # byte-true cell weights (§2.12) — see pack_decode_items
        W = np.maximum((W > 0).astype(np.int64),
                       np.round(W * float(bytes_per_block)).astype(np.int64))
    if shard_of_kvhead is None:
        asg = best_partition_2d(W, num_shards).device_of
    else:
        shard_of_kvhead = np.asarray(shard_of_kvhead)
        asg = np.array([int(shard_of_kvhead[h]) for _, h, _ in runs],
                       dtype=np.int64)
    per_cell: list[list[list[np.ndarray]]] = [
        [[] for _ in range(num_stripes)] for _ in range(num_shards)]
    kv_local_map: list[dict[int, int]] = [dict() for _ in range(num_shards)]
    for (b, h, per_stripe), d in zip(runs, asg):
        d = int(d)
        if kvhead_local:
            if h not in kv_local_map[d]:
                kv_local_map[d][h] = len(kv_local_map[d])
            h_idx = kv_local_map[d][h]
        else:
            h_idx = h
        for s, sel in enumerate(per_stripe):
            n = len(sel)
            if n == 0:
                continue
            it = np.zeros((n, DEC_FIELDS), dtype=np.int32)
            it[:, D_BATCH] = b
            it[:, D_KVHEAD] = h_idx
            it[:, D_KVBLK] = sel
            it[0, D_FIRST] = 1
            it[-1, D_LAST] = 1
            it[:, D_VALID] = 1
            per_cell[d][s].append(it)
    cell_items = [[np.concatenate(g, axis=0) if g
                   else np.zeros((0, DEC_FIELDS), np.int32)
                   for g in row] for row in per_cell]
    lengths = np.array([[len(x) for x in row] for row in cell_items],
                       dtype=np.int64).reshape(num_shards, num_stripes)
    L_pad = int(lengths.max()) if lengths.size else 0
    L_pad = max(pad_multiple, -(-L_pad // pad_multiple) * pad_multiple)
    if bucket is not None:
        assert bucket >= L_pad, (
            f"bucket {bucket} < packed cell length {L_pad}")
        L_pad = int(bucket)
    items = np.zeros((num_shards, num_stripes, L_pad, DEC_FIELDS),
                     dtype=np.int32)
    for d in range(num_shards):
        for s in range(num_stripes):
            x = cell_items[d][s]
            items[d, s, : len(x)] = x
            if len(x):
                pad_row = x[-1].copy()
                pad_row[D_FIRST] = 0
                pad_row[D_LAST] = 0
                pad_row[D_VALID] = 0
                items[d, s, len(x):] = pad_row
    return PackedDecodeWorkList2D(items=items, lengths=lengths, block=block)


def extend_packed_items(items: np.ndarray, width: int) -> np.ndarray:
    """Pad per-shard item lists ``[D, L, DEC_FIELDS]`` out to ``[D, width,
    DEC_FIELDS]`` with the replicate-last valid=0 convention (flags zeroed
    whether the trailing row was a real item or already padding).  Used to
    equalize per-layer packed lists onto one compile bucket."""
    it = np.asarray(items)
    D, L, _ = it.shape
    assert width >= L, f"cannot shrink items from {L} to {width}"
    if width == L:
        return it
    out = np.zeros((D, width, DEC_FIELDS), dtype=np.int32)
    out[:, :L] = it
    for d in range(D):
        pad_row = it[d, -1].copy()
        pad_row[D_FIRST] = 0
        pad_row[D_LAST] = 0
        pad_row[D_VALID] = 0
        out[d, L:] = pad_row
    return out


def padded_decode_items(block_ids: np.ndarray) -> np.ndarray:
    """Host twin of ``kernels.flash_decode.decode_items_from_ids``: the
    PADDED fixed-stride item table ``[B*Hkv*nb, DEC_FIELDS]`` (row
    ``(b, h, j)`` at index ``(b*Hkv + h)*nb + j``; -1 selections become
    valid=0 rows but still occupy grid steps).  This is the baseline grid
    the packed lists shrink — benchmarks execute both through one
    executor so the packed-vs-padded latency delta is purely grid length.
    """
    ids = np.asarray(block_ids)
    B, hkv, nb = ids.shape
    flat = ids.reshape(-1).astype(np.int64)
    n = flat.shape[0]
    j = np.arange(n) % nb
    bh = np.arange(n) // nb
    items = np.zeros((n, DEC_FIELDS), dtype=np.int32)
    items[:, D_BATCH] = bh // hkv
    items[:, D_KVHEAD] = bh % hkv
    items[:, D_KVBLK] = np.maximum(flat, 0)
    items[:, D_FIRST] = (j == 0)
    items[:, D_LAST] = (j == nb - 1)
    items[:, D_VALID] = (flat >= 0)
    return items

