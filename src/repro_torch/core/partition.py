"""Head -> device assignment: multiway number partitioning (paper §3.3).
A copy of the reference package's ``core/partition.py``: the 1D
partitioners and the 2D (model shard x seq stripe) packer of §2.11.

The objective is the load-imbalance ratio ``I = max_d L_d / mean_d L_d``;
:func:`best_partition` runs LPT (the paper's greedy) and Karmarkar–Karp,
each refined by pairwise moves and swaps, and keeps the better one.  The
decode packer reuses it to balance cost-packed item lists.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
from typing import Sequence

import numpy as np


@dataclasses.dataclass
class Assignment:
    """Result of a head->device partitioning.

    device_of:  ``[N]`` int device index per item.
    loads:      ``[D]`` total budget per device.
    method:     provenance string.
    """

    device_of: np.ndarray
    loads: np.ndarray
    method: str = ""

    @property
    def num_devices(self) -> int:
        return len(self.loads)

    @property
    def imbalance(self) -> float:
        """Paper's objective: I = max_d L_d / mean_d L_d (>= 1)."""
        mean = float(self.loads.mean())
        if mean <= 0:
            return 1.0
        return float(self.loads.max() / mean)

    @property
    def makespan(self) -> int:
        """max_d L_d — under SPMD this is the padded grid length every
        device executes (DESIGN.md §2.1), the true cost on TPU."""
        return int(self.loads.max())

    def groups(self) -> list[list[int]]:
        """Items per device."""
        out: list[list[int]] = [[] for _ in range(self.num_devices)]
        for i, d in enumerate(self.device_of):
            out[int(d)].append(i)
        return out


def _loads_of(weights: np.ndarray, device_of: np.ndarray, D: int) -> np.ndarray:
    loads = np.zeros(D, dtype=np.int64)
    np.add.at(loads, device_of, weights)
    return loads


# ---------------------------------------------------------------------------
# Baseline: what naive head-parallelism does (paper Fig. 8)
# ---------------------------------------------------------------------------

def naive_partition(weights: Sequence[int], num_devices: int,
                    mode: str = "contiguous") -> Assignment:
    """Sequential assignment ignoring weights — the vanilla HP layout.

    ``contiguous``: heads [0..N/D) on device 0, etc. (vLLM/SGLang TP layout).
    ``round_robin``: head i -> device i % D.
    """
    w = np.asarray(weights, dtype=np.int64)
    N, D = len(w), num_devices
    if mode == "contiguous":
        per = -(-N // D)  # ceil
        device_of = np.minimum(np.arange(N) // per, D - 1)
    elif mode == "round_robin":
        device_of = np.arange(N) % D
    else:
        raise ValueError(f"unknown naive mode {mode!r}")
    device_of = device_of.astype(np.int64)
    return Assignment(device_of, _loads_of(w, device_of, D), f"naive-{mode}")


# ---------------------------------------------------------------------------
# Paper: LPT greedy
# ---------------------------------------------------------------------------

def lpt_partition(weights: Sequence[int], num_devices: int) -> Assignment:
    """Greedy LPT (paper §3.3): descending weights onto least-loaded device.

    Heap-based: O(N log N) sort + O(N log D) placement, exactly the
    complexity the paper quotes.
    """
    w = np.asarray(weights, dtype=np.int64)
    N, D = len(w), num_devices
    order = np.argsort(-w, kind="stable")
    device_of = np.zeros(N, dtype=np.int64)
    # heap of (load, device); ties broken by device id for determinism
    heap: list[tuple[int, int]] = [(0, d) for d in range(D)]
    heapq.heapify(heap)
    for i in order:
        load, d = heapq.heappop(heap)
        device_of[i] = d
        heapq.heappush(heap, (load + int(w[i]), d))
    return Assignment(device_of, _loads_of(w, device_of, D), "lpt")


# ---------------------------------------------------------------------------
# Beyond paper: Karmarkar–Karp largest differencing (multiway)
# ---------------------------------------------------------------------------

def kk_partition(weights: Sequence[int], num_devices: int) -> Assignment:
    """Karmarkar–Karp largest differencing method, generalized to D-way.

    Maintain a max-heap of partial solutions, each a D-tuple of (load, items)
    sorted descending; repeatedly merge the two with the largest spread by
    combining largest-with-smallest.  Strictly better than LPT on adversarial
    inputs; same asymptotic cost here (N heads is small).
    """
    w = np.asarray(weights, dtype=np.int64)
    N, D = len(w), num_devices
    if N == 0:
        return Assignment(np.zeros(0, np.int64), np.zeros(D, np.int64), "kk")
    # Each entry: (-spread, tiebreak, loads_desc tuple, groups list aligned to loads)
    counter = itertools.count()
    heap = []
    for i in range(N):
        loads = [int(w[i])] + [0] * (D - 1)
        groups: list[list[int]] = [[i]] + [[] for _ in range(D - 1)]
        heapq.heappush(heap, (-(loads[0] - loads[-1]), next(counter), loads, groups))
    while len(heap) > 1:
        _, _, la, ga = heapq.heappop(heap)
        _, _, lb, gb = heapq.heappop(heap)
        # combine: largest of a with smallest of b, etc. (anti-aligned merge)
        loads = [la[j] + lb[D - 1 - j] for j in range(D)]
        groups = [ga[j] + gb[D - 1 - j] for j in range(D)]
        # re-sort descending by load
        order = sorted(range(D), key=lambda j: -loads[j])
        loads = [loads[j] for j in order]
        groups = [groups[j] for j in order]
        heapq.heappush(heap, (-(loads[0] - loads[-1]), next(counter), loads, groups))
    _, _, loads, groups = heap[0]
    device_of = np.zeros(N, dtype=np.int64)
    for d, g in enumerate(groups):
        for i in g:
            device_of[i] = d
    return Assignment(device_of, _loads_of(w, device_of, D), "kk")


# ---------------------------------------------------------------------------
# Beyond paper: pairwise move/swap refinement (local search)
# ---------------------------------------------------------------------------

def refine_partition(weights: Sequence[int], assignment: Assignment,
                     max_rounds: int = 50) -> Assignment:
    """Improve an assignment with single-item moves and pairwise swaps.

    Classic multiway-partition local search (cf. paper ref [5], Cong & Lim):
    repeatedly try (a) moving one item from the max-loaded device to the
    min-loaded one, (b) swapping an item between max and any other device,
    accepting any change that reduces the makespan.  Converges quickly — each
    accepted step strictly reduces ``max_d L_d``.

    Deviation from the reference: the move pass (a) stops once an accepted
    move changes the busiest device, where the reference goes on moving
    items of the old busiest device as if they sat on the new one and can
    raise ``ValueError``; wherever the reference returns, the results agree.
    """
    w = np.asarray(weights, dtype=np.int64)
    device_of = assignment.device_of.copy()
    D = assignment.num_devices
    loads = _loads_of(w, device_of, D)
    groups = [list(np.where(device_of == d)[0]) for d in range(D)]

    for _ in range(max_rounds):
        improved = False
        dmax = int(np.argmax(loads))
        # (a) single moves off the busiest device
        for i in sorted(groups[dmax], key=lambda i: -w[i]):
            dmin = int(np.argmin(loads))
            if dmax == dmin:
                break
            new_max_side = loads[dmax] - w[i]
            new_min_side = loads[dmin] + w[i]
            if max(new_max_side, new_min_side) < loads[dmax]:
                groups[dmax].remove(i)
                groups[dmin].append(i)
                device_of[i] = dmin
                loads[dmax] = new_max_side
                loads[dmin] = new_min_side
                improved = True
                if int(np.argmax(loads)) != dmax:
                    break
        # (b) pairwise swaps busiest <-> every other
        dmax = int(np.argmax(loads))
        for d in range(D):
            if d == dmax:
                continue
            best = None  # (new_makespan_pair, i, j)
            for i in groups[dmax]:
                for j in groups[d]:
                    delta = int(w[i] - w[j])
                    if delta <= 0:
                        continue
                    na, nb = loads[dmax] - delta, loads[d] + delta
                    if max(na, nb) < loads[dmax]:
                        cand = (max(na, nb), i, j)
                        if best is None or cand < best:
                            best = cand
            if best is not None:
                _, i, j = best
                groups[dmax].remove(i)
                groups[d].remove(j)
                groups[dmax].append(j)
                groups[d].append(i)
                device_of[i], device_of[j] = d, dmax
                delta = int(w[i] - w[j])
                loads[dmax] -= delta
                loads[d] += delta
                improved = True
                dmax = int(np.argmax(loads))
        if not improved:
            break
    return Assignment(device_of, loads, assignment.method + "+refine")


# ---------------------------------------------------------------------------
# Exact DP oracle (small instances only)
# ---------------------------------------------------------------------------

def dp_partition(weights: Sequence[int], num_devices: int,
                 max_states: int = 2_000_000) -> Assignment:
    """Exact multiway partition via DP over load vectors (test oracle).

    State: sorted tuple of device loads after placing a prefix of items
    (items sorted descending for pruning).  Complexity O(N * L^{D-1}) as in
    the paper's discussion — only feasible for small N, D, L.  Raises if the
    state space exceeds ``max_states``.
    """
    w = np.asarray(weights, dtype=np.int64)
    N, D = len(w), num_devices
    order = np.argsort(-w, kind="stable")
    # states keyed by SORTED load tuple (dedup/symmetry); value carries the
    # UNSORTED load vector + assignment with consistent device labels.
    states: dict[tuple, tuple[list[int], np.ndarray]] = {
        tuple([0] * D): ([0] * D, np.full(N, -1, np.int64))
    }
    for i in order:
        nxt: dict[tuple, tuple[list[int], np.ndarray]] = {}
        for _, (loads, assign) in states.items():
            seen_loads = set()
            for d in range(D):
                if loads[d] in seen_loads:  # symmetry pruning
                    continue
                seen_loads.add(loads[d])
                nl = list(loads)
                nl[d] += int(w[i])
                key = tuple(sorted(nl))
                if key not in nxt:  # same load vector => equivalent state
                    na = assign.copy()
                    na[i] = d
                    nxt[key] = (nl, na)
        if len(nxt) > max_states:
            raise ValueError(
                f"dp_partition state space {len(nxt)} exceeds {max_states}")
        states = nxt
    best_key = min(states, key=lambda k: (max(k), k))
    _, best_assign = states[best_key]
    loads = _loads_of(w, best_assign, D)
    return Assignment(best_assign, loads, "dp-exact")


def lpt_bound(weights: Sequence[int], num_devices: int) -> float:
    """Upper bound on greedy list-scheduling makespan (Graham):

        max_d L_d  <=  sum(w) / D  +  (1 - 1/D) * max(w)

    Every partitioner in this module (LPT, KK, refinement, best) satisfies
    it, so property tests use it as the contract the cost-packed decode
    worklists must honor: no shard's grid exceeds its fair share by more
    than one maximal run.
    """
    w = np.asarray(weights, dtype=np.int64)
    if len(w) == 0:
        return 0.0
    D = num_devices
    return float(w.sum()) / D + (1.0 - 1.0 / D) * float(w.max())


# ---------------------------------------------------------------------------
# 2D head x sequence packing (DESIGN.md §2.11)
# ---------------------------------------------------------------------------
#
# Sequence-parallel long context adds a second mesh axis: each item (a
# (slot, kv_head) decode run) carries a WEIGHT VECTOR over the `seq`
# stripes — W[i, s] = how many of item i's selected kv blocks live on
# stripe s.  The stripe coordinate of the work is FIXED by data placement
# (a block is computed where it resides); the packer only chooses the
# item's model shard.  The objective generalizes to the max CELL load
#
#     min max_{(d, s)} L_{d,s},   L_{d,s} = sum_{i: dev(i)=d} W[i, s]
#
# because under SPMD every (model, seq) device executes its cell's padded
# grid — the 2D makespan is the grid length everyone pays.


@dataclasses.dataclass
class Assignment2D:
    """Result of a 2D (model x seq) partitioning.

    device_of: ``[N]`` model-shard index per item (the free axis).
    loads:     ``[Dm, Ds]`` per-cell load (stripe axis fixed by the data).
    method:    provenance string.
    """

    device_of: np.ndarray
    loads: np.ndarray
    method: str = ""

    @property
    def num_devices(self) -> int:
        return self.loads.shape[0]

    @property
    def num_stripes(self) -> int:
        return self.loads.shape[1]

    @property
    def makespan(self) -> int:
        """max cell load — the padded 2D grid length under SPMD."""
        return int(self.loads.max())

    @property
    def imbalance(self) -> float:
        """max cell / mean cell (>= 1) — the 2D analogue of the paper's I."""
        mean = float(self.loads.mean())
        return float(self.loads.max() / mean) if mean > 0 else 1.0

    @property
    def model_loads(self) -> np.ndarray:
        """``[Dm]`` per-model-shard totals (summed over stripes)."""
        return self.loads.sum(axis=1)

    @property
    def stripe_loads(self) -> np.ndarray:
        """``[Ds]`` per-stripe totals (summed over model shards)."""
        return self.loads.sum(axis=0)

    @property
    def model_imbalance(self) -> float:
        m = self.model_loads.astype(np.float64)
        mean = float(m.mean())
        return float(m.max() / mean) if mean > 0 else 1.0

    @property
    def stripe_imbalance(self) -> float:
        s = self.stripe_loads.astype(np.float64)
        mean = float(s.mean())
        return float(s.max() / mean) if mean > 0 else 1.0


def _loads_2d(W: np.ndarray, device_of: np.ndarray, Dm: int) -> np.ndarray:
    loads = np.zeros((Dm, W.shape[1]), dtype=np.int64)
    np.add.at(loads, device_of, W)
    return loads


def lpt_bound_2d(weights_2d: np.ndarray, num_devices: int) -> float:
    """2D packer contract: ``max cell load <= lpt_bound(row totals, Dm)``.

    Any cell's load is bounded by its model shard's TOTAL (the sum of the
    shard's cells), and placing items by their row totals with LPT keeps
    every shard total within Graham's bound — so seeding from LPT-on-totals
    and only accepting refinement steps that strictly reduce the max cell
    preserves the 1D contract verbatim on the harder 2D objective.  The
    property tests (the reference's tests/test_core_partition.py) hold every 2D packer
    output to this bound.
    """
    W = np.asarray(weights_2d, dtype=np.int64)
    if W.size == 0:
        return 0.0
    return lpt_bound(W.sum(axis=1), num_devices)


def refine_partition_2d(weights_2d: np.ndarray, assignment: Assignment2D,
                        max_rounds: int = 50) -> Assignment2D:
    """Local search on the 2D objective: move single items off the model
    shard holding the max cell, accepting only strict max-cell reductions
    (so :func:`lpt_bound_2d` is preserved by construction)."""
    W = np.asarray(weights_2d, dtype=np.int64)
    device_of = assignment.device_of.copy()
    Dm = assignment.num_devices
    loads = _loads_2d(W, device_of, Dm)

    for _ in range(max_rounds):
        cur = int(loads.max())
        row_max = loads.max(axis=1)
        dmax = int(np.argmax(row_max))
        moved = False
        # one accepted move per round: the max cell may migrate to another
        # shard, so the candidate item set must be re-derived from scratch
        for i in sorted(np.where(device_of == dmax)[0],
                        key=lambda i: -int(W[i].sum())):
            best = None  # (new_global_max, target shard)
            for d in range(Dm):
                if d == dmax:
                    continue
                na = int((loads[dmax] - W[i]).max())
                nb = int((loads[d] + W[i]).max())
                rest = max((int(row_max[r]) for r in range(Dm)
                            if r not in (dmax, d)), default=0)
                tot = max(na, nb, rest)
                if tot < cur and (best is None or tot < best[0]):
                    best = (tot, d)
            if best is not None:
                _, d = best
                loads[dmax] -= W[i]
                loads[d] += W[i]
                device_of[i] = d
                moved = True
                break
        if not moved:
            break
    return Assignment2D(device_of, loads, assignment.method + "+refine2d")


def best_partition_2d(weights_2d: np.ndarray,
                      num_devices: int) -> Assignment2D:
    """Production 2D entry point: LPT and KK on the items' ROW TOTALS
    (each within Graham's bound on the totals, hence on every cell), then
    max-cell local search; keep the best by (makespan, imbalance).

    ``weights_2d [N, Ds]``: per-item per-stripe weights.  Degenerates
    EXACTLY to :func:`best_partition` at ``Ds == 1`` (same device_of),
    which is the seq==1 compatibility contract the property tests pin.
    """
    W = np.asarray(weights_2d, dtype=np.int64)
    if W.ndim != 2:
        raise ValueError(f"weights_2d must be [N, Ds], got {W.shape}")
    N, Ds = W.shape
    Dm = num_devices
    if Ds == 1:
        a = best_partition(W[:, 0], Dm)
        return Assignment2D(a.device_of, a.loads[:, None],
                            a.method + "@seq1")
    totals = W.sum(axis=1)
    seeds = [lpt_partition(totals, Dm)]
    if N <= 1024:
        seeds.append(kk_partition(totals, Dm))
    cands = []
    for s in seeds:
        a2 = Assignment2D(s.device_of.copy(), _loads_2d(W, s.device_of, Dm),
                          s.method + "@2d")
        cands.append(refine_partition_2d(W, a2) if N <= 1024 else a2)
    best = min(cands, key=lambda a: (a.makespan, a.imbalance))
    # the LPT seed is always among the candidates and refinement never
    # raises the max cell, so the winner inherits lpt_bound_2d
    return best

# ---------------------------------------------------------------------------
# Production entry point
# ---------------------------------------------------------------------------

def best_partition(weights: Sequence[int], num_devices: int) -> Assignment:
    """LPT (paper) and KK (beyond-paper), each + refinement; return the best.

    Deterministic.  For small instances (head counts) both run plus local
    search; for large ones (row-mode: thousands of (head, q_blk) atoms) the
    O(n^2/D^2) pairwise-swap refinement is skipped — LPT alone is already
    within one atom of optimal when n >> D.
    """
    w = np.asarray(weights, dtype=np.int64)
    if len(w) > 1024:
        cands = [lpt_partition(w, num_devices)]
    else:
        cands = [
            refine_partition(w, lpt_partition(w, num_devices)),
            refine_partition(w, kk_partition(w, num_devices)),
        ]
    return min(cands, key=lambda a: (a.makespan, a.imbalance))
