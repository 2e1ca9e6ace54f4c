"""Adaptive head budget allocation (paper §3.2): a copy of the reference
package's ``core/budget.py``.

Given per-head recovery curves (offline profile) and a *global* token budget
``K_total = num_heads * k``, assign each head a budget ``b_h`` with
``sum(b_h) == K_total`` so that the minimum per-head recovery ratio is
maximized — the paper's **max–min budget shifting**.  Budgets are in tokens,
quantized to ``block`` multiples, floored at ``floor`` and capped at
``seq_len``.
"""
from __future__ import annotations

import dataclasses
import numpy as np

from repro_torch.core.sparsity import HeadSparsityProfile


@dataclasses.dataclass
class AllocationResult:
    """Output of a budget allocator.

    budgets:    ``[H]`` int tokens per head (block-quantized).
    recovery:   ``[H]`` predicted recovery ratio at those budgets.
    iterations: number of transfer iterations (greedy) / bisection steps.
    total:      sum of budgets actually allocated.
    """

    budgets: np.ndarray
    recovery: np.ndarray
    iterations: int
    total: int

    @property
    def min_recovery(self) -> float:
        return float(self.recovery.min())

    @property
    def mean_recovery(self) -> float:
        return float(self.recovery.mean())


def _as_curves(profile: HeadSparsityProfile | tuple, layer: int | None):
    """Accept a profile (+layer) or a raw ``(curves[H,G], grid[G])`` tuple."""
    if isinstance(profile, HeadSparsityProfile):
        assert layer is not None, "pass layer= when giving a HeadSparsityProfile"
        return profile.curves[layer], profile.grid
    curves, grid = profile
    return np.asarray(curves, dtype=np.float64), np.asarray(grid, dtype=np.float64)


def _recovery_tokens(curves: np.ndarray, grid: np.ndarray, seq_len: int,
                     budgets: np.ndarray) -> np.ndarray:
    """Vectorized per-head recovery at token budgets (interp on frac grid)."""
    fracs = np.clip(budgets / float(seq_len), 0.0, 1.0)
    out = np.empty(curves.shape[0])
    for h in range(curves.shape[0]):
        out[h] = np.interp(fracs[h], grid, curves[h])
    return out


def _quantize(budgets: np.ndarray, block: int, floor: int, seq_len: int) -> np.ndarray:
    b = np.ceil(np.asarray(budgets, dtype=np.float64) / block) * block
    return np.clip(b, floor, seq_len).astype(np.int64)


# ---------------------------------------------------------------------------
# Baselines
# ---------------------------------------------------------------------------

def uniform_allocation(
    profile, *, layer: int | None = None, k: int, seq_len: int,
    block: int = 128, floor: int = 128,
) -> AllocationResult:
    """Top-k baseline: identical budget ``k`` on every head (paper §2.3)."""
    curves, grid = _as_curves(profile, layer)
    H = curves.shape[0]
    budgets = _quantize(np.full(H, k), block, floor, seq_len)
    rec = _recovery_tokens(curves, grid, seq_len, budgets)
    return AllocationResult(budgets, rec, 0, int(budgets.sum()))


def topp_allocation(
    profile, *, layer: int | None = None, p: float, seq_len: int,
    block: int = 128, floor: int = 128,
) -> AllocationResult:
    """Top-p baseline's *budget cost*: per-head tokens to reach recovery p.

    This is the idealized cost of XAttention-style methods — note it has no
    global budget constraint, so its total varies per layer (the source of
    the load imbalance in paper Fig. 4).
    """
    curves, grid = _as_curves(profile, layer)
    H = curves.shape[0]
    budgets = np.empty(H)
    for h in range(H):
        budgets[h] = np.interp(
            p, curves[h], grid, left=grid[0], right=1.0
        ) * seq_len
    budgets = _quantize(budgets, block, floor, seq_len)
    rec = _recovery_tokens(curves, grid, seq_len, budgets)
    return AllocationResult(budgets, rec, 0, int(budgets.sum()))


# ---------------------------------------------------------------------------
# Paper: iterative max-min transfer (Fig. 7)
# ---------------------------------------------------------------------------

def maxmin_allocation(
    profile, *, layer: int | None = None, total: int, seq_len: int,
    block: int = 128, floor: int = 128, max_iters: int = 100_000,
    init_budgets: np.ndarray | None = None,
) -> AllocationResult:
    """The paper's iterative max-min budget shifting (§3.2, Fig. 7).

    Start from the uniform split of ``total``; repeatedly move one ``block``
    quantum from the head with the *highest* recovery (most over-provisioned,
    donor) to the head with the *lowest* recovery (receiver).  Stop when

    (i)  the transfer no longer yields benefit — the donor would become the
         new minimum (paper's dashed-line condition); or
    (ii) no donor can give without violating the ``floor``.

    ``init_budgets`` warm-starts the transfer loop from an existing
    allocation instead of the uniform split — the incremental replanning
    path (DESIGN.md §2.9): when the live profile has drifted only mildly
    from the one the previous epoch was planned on, the previous budgets
    are near-optimal and the loop converges in a handful of transfers
    instead of O(total/block).  The warm start is re-centered onto
    ``total`` first, so a replan can also change the global budget.
    """
    curves, grid = _as_curves(profile, layer)
    H = curves.shape[0]
    if init_budgets is not None:
        assert len(init_budgets) == H, (
            f"warm start has {len(init_budgets)} heads, curves {H}")
        budgets = _quantize(np.asarray(init_budgets, np.float64),
                            block, floor, seq_len)
        budgets = _rebalance_total(budgets, total, block, floor, seq_len,
                                   curves=curves, grid=grid)
    else:
        base = max(floor, int(round(total / H)))
        budgets = _quantize(np.full(H, base), block, floor, seq_len)
        # Re-center onto the global total as closely as quantization allows.
        budgets = _rebalance_total(budgets, total, block, floor, seq_len)

    rec = _recovery_tokens(curves, grid, seq_len, budgets)
    iters = 0
    while iters < max_iters:
        iters += 1
        recv = int(np.argmin(rec))
        # donor: highest recovery among heads that can still give a block
        can_give = budgets - block >= floor
        can_give[recv] = False
        if not can_give.any():
            break  # condition (ii): everyone at the floor
        donor_candidates = np.where(can_give)[0]
        donor = int(donor_candidates[np.argmax(rec[donor_candidates])])
        if budgets[recv] + block > seq_len:
            break  # receiver saturated: nothing to improve
        # tentative transfer
        new_donor_rec = np.interp(
            (budgets[donor] - block) / seq_len, grid, curves[donor])
        new_recv_rec = np.interp(
            (budgets[recv] + block) / seq_len, grid, curves[recv])
        old_min = rec[recv]
        others = np.delete(rec, [donor, recv])
        others_min = float(others.min()) if others.size else np.inf
        new_min = min(float(new_donor_rec), float(new_recv_rec), others_min)
        if new_min <= old_min + 1e-12:
            break  # condition (i): donor becomes the new minimum — no benefit
        budgets[donor] -= block
        budgets[recv] += block
        rec[donor] = new_donor_rec
        rec[recv] = new_recv_rec
    return AllocationResult(budgets, rec, iters, int(budgets.sum()))


# ---------------------------------------------------------------------------
# Beyond paper: exact water-filling max-min solver
# ---------------------------------------------------------------------------

def waterfill_allocation(
    profile, *, layer: int | None = None, total: int, seq_len: int,
    block: int = 128, floor: int = 128, tol: float = 1e-6,
) -> AllocationResult:
    """Exact continuous max-min allocation via bisection on the water level.

    At the optimum every head is either (a) at the floor, (b) at the ceiling
    ``seq_len``, or (c) at the budget whose recovery equals the common level
    ``r*``.  Monotone curves make ``spend(r*)`` monotone, so bisect on r*,
    then block-quantize and spend any quantization slack on the lowest-
    recovery heads.  Serves as oracle for :func:`maxmin_allocation` (the
    greedy must come within one block-quantum of this optimum).
    """
    curves, grid = _as_curves(profile, layer)
    H = curves.shape[0]

    def budget_for(h: int, r: float) -> float:
        # smallest fraction with recovery >= r (inverse interp), in tokens
        c = curves[h]
        if r <= c[0]:
            return float(floor)
        if r >= c[-1]:
            return float(seq_len)
        f = np.interp(r, c, grid)
        return float(np.clip(f * seq_len, floor, seq_len))

    def spend(r: float) -> float:
        return sum(budget_for(h, r) for h in range(H))

    lo, hi = 0.0, 1.0
    it = 0
    while hi - lo > tol and it < 200:
        it += 1
        mid = 0.5 * (lo + hi)
        if spend(mid) <= total:
            lo = mid
        else:
            hi = mid
    budgets = np.array([budget_for(h, lo) for h in range(H)])
    budgets = _quantize(budgets, block, floor, seq_len)
    budgets = _rebalance_total(budgets, total, block, floor, seq_len,
                               curves=curves, grid=grid)
    rec = _recovery_tokens(curves, grid, seq_len, budgets)
    return AllocationResult(budgets, rec, it, int(budgets.sum()))


def _rebalance_total(
    budgets: np.ndarray, total: int, block: int, floor: int, seq_len: int,
    curves: np.ndarray | None = None, grid: np.ndarray | None = None,
) -> np.ndarray:
    """Adjust block-quantized budgets to sum as close to ``total`` as possible.

    Surplus is taken from (or deficit given to) heads chosen greedily: when
    curves are provided, give to the lowest-recovery head / take from the
    highest-recovery head; otherwise round-robin.  Never violates floor/cap.
    """
    budgets = budgets.copy()
    H = len(budgets)
    max_steps = max(1000, 8 * H)  # slack after quantization is O(H) blocks

    def rec_of(b):
        if curves is None:
            return np.zeros(H)
        return _recovery_tokens(curves, grid, seq_len, b)

    guard = 0
    while budgets.sum() + block <= total and guard < max_steps:
        guard += 1
        r = rec_of(budgets)
        order = np.argsort(r) if curves is not None else np.arange(H)
        for h in order:
            if budgets[h] + block <= seq_len:
                budgets[h] += block
                break
        else:
            break
    while budgets.sum() - block >= total and guard < max_steps:
        guard += 1
        # Take from the head whose recovery AFTER the removal stays highest
        # (max-min-preserving) — NOT from the currently-highest head, whose
        # recovery may cliff once pushed to the floor (sparse heads).
        if curves is not None:
            can = budgets - block >= floor
            if not can.any():
                break
            cand = np.where(can)[0]
            after = np.array([
                np.interp((budgets[h] - block) / seq_len, grid, curves[h])
                for h in cand
            ])
            budgets[cand[np.argmax(after)]] -= block
        else:
            for h in range(H):
                if budgets[h] - block >= floor:
                    budgets[h] -= block
                    break
            else:
                break
    return budgets
