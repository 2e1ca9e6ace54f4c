"""S-HPLB deployment planner: budgets + partitioning -> executable plan.
A copy of the reference package's ``core/planner.py``: plan construction,
the composable deltas between plan epochs (``plans_equal``,
``plan_delta``, ``PlanDelta``), the weight permutation and the plan's JSON
form (``HPLBPlan.to_json`` / ``from_json``, which a serving snapshot
carries).

Placement is a head permutation applied once to the attention projections:
device ``d`` owns the permuted head slots ``[d*Hd, (d+1)*Hd)``.  Under GQA
the atoms of the partition are KV groups (weight = sum of their query-head
budgets), partitioned under an equal-count constraint.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Sequence

import numpy as np

from repro_torch.core.budget import AllocationResult, maxmin_allocation, uniform_allocation
from repro_torch.core.partition import Assignment, naive_partition
from repro_torch.core.sparsity import HeadSparsityProfile


@dataclasses.dataclass
class LayerPlan:
    """Per-layer S-HPLB placement."""

    perm: np.ndarray           # [H] original head index for each slot
    inv_perm: np.ndarray       # [H] slot index for each original head
    budgets: np.ndarray        # [H] token budgets in SLOT order
    kv_perm: np.ndarray        # [H_kv] original kv-head index per kv slot
    device_loads: np.ndarray   # [D] sum of budgets (tokens) per device
    assignment: Assignment     # atoms -> device (for introspection)

    @property
    def imbalance(self) -> float:
        mean = float(self.device_loads.mean())
        return float(self.device_loads.max() / mean) if mean > 0 else 1.0

    @property
    def makespan_tokens(self) -> int:
        return int(self.device_loads.max())


@dataclasses.dataclass
class HPLBPlan:
    """Whole-model S-HPLB plan (one LayerPlan per attention layer)."""

    layers: list[LayerPlan]
    num_devices: int
    num_heads: int
    num_kv_heads: int
    block: int
    seq_len: int
    mode: str                      # "kv_group" | "kv_replication"
    partitioner: str
    allocator: str
    epoch: int = 0                 # plan-epoch version (DESIGN.md §2.9)

    @property
    def num_layers(self) -> int:
        return len(self.layers)

    @property
    def mean_imbalance(self) -> float:
        return float(np.mean([l.imbalance for l in self.layers]))

    @property
    def max_imbalance(self) -> float:
        return float(np.max([l.imbalance for l in self.layers]))

    def budgets_by_original_head(self, layer: int) -> np.ndarray:
        """``[H]`` budgets indexed by ORIGINAL head id."""
        lp = self.layers[layer]
        out = np.zeros_like(lp.budgets)
        out[lp.perm] = lp.budgets
        return out

    def device_of_slot(self, slot: int) -> int:
        heads_per_dev = self.num_heads // self.num_devices
        return slot // heads_per_dev

    def to_json(self) -> str:
        return json.dumps(
            {
                "num_devices": self.num_devices,
                "num_heads": self.num_heads,
                "num_kv_heads": self.num_kv_heads,
                "block": self.block,
                "seq_len": self.seq_len,
                "mode": self.mode,
                "partitioner": self.partitioner,
                "allocator": self.allocator,
                "epoch": self.epoch,
                "layers": [
                    {
                        "perm": lp.perm.tolist(),
                        "budgets": lp.budgets.tolist(),
                        "kv_perm": lp.kv_perm.tolist(),
                        "device_loads": lp.device_loads.tolist(),
                    }
                    for lp in self.layers
                ],
            }
        )

    @staticmethod
    def from_json(s: str) -> "HPLBPlan":
        d = json.loads(s)
        layers = []
        for lp in d["layers"]:
            perm = np.asarray(lp["perm"], np.int64)
            inv = np.empty_like(perm)
            inv[perm] = np.arange(len(perm))
            loads = np.asarray(lp["device_loads"], np.int64)
            layers.append(
                LayerPlan(
                    perm=perm,
                    inv_perm=inv,
                    budgets=np.asarray(lp["budgets"], np.int64),
                    kv_perm=np.asarray(lp["kv_perm"], np.int64),
                    device_loads=loads,
                    assignment=Assignment(
                        np.zeros(0, np.int64), loads, "loaded"),
                )
            )
        return HPLBPlan(
            layers=layers,
            num_devices=d["num_devices"],
            num_heads=d["num_heads"],
            num_kv_heads=d["num_kv_heads"],
            block=d["block"],
            seq_len=d["seq_len"],
            mode=d["mode"],
            partitioner=d["partitioner"],
            allocator=d["allocator"],
            epoch=int(d.get("epoch", 0)),
        )


# ---------------------------------------------------------------------------
# Equal-count constrained partitioning (SPMD equal shapes)
# ---------------------------------------------------------------------------

def _balanced_partition_equal_count(
    weights: np.ndarray, num_devices: int, partitioner: str
) -> Assignment:
    """Partition with the SPMD constraint |H_d| identical for all d.

    Under XLA SPMD each model-axis shard must own exactly ``N / D`` head
    slots (the permuted weight tensor is split evenly).  We therefore run the
    unconstrained partitioner for guidance, then enforce the count constraint
    with a greedy slot-filling pass: process items in descending weight,
    place each on the least-loaded device that still has free slots.

    This is LPT-with-capacities; for the paper's unconstrained objective it
    is a (1 + (D-1)/cap)-approximation and in practice within a block of the
    unconstrained optimum whenever N >> D.
    """
    w = np.asarray(weights, dtype=np.int64)
    N, D = len(w), num_devices
    assert N % D == 0, f"equal-count partition needs D | N ({N} % {D})"
    cap = N // D

    if partitioner == "naive":
        return naive_partition(w, D, mode="contiguous")

    order = np.argsort(-w, kind="stable")
    device_of = np.full(N, -1, np.int64)
    loads = np.zeros(D, np.int64)
    counts = np.zeros(D, np.int64)
    for i in order:
        open_devs = np.where(counts < cap)[0]
        d = int(open_devs[np.argmin(loads[open_devs])])
        device_of[i] = d
        loads[d] += int(w[i])
        counts[d] += 1

    # Local refinement under the count constraint: swap items between the
    # busiest device and others when it reduces the makespan (moves would
    # violate counts, so swaps only).
    groups = [list(np.where(device_of == d)[0]) for d in range(D)]
    for _ in range(50):
        improved = False
        dmax = int(np.argmax(loads))
        for d in range(D):
            if d == dmax:
                continue
            best = None
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
                groups[dmax].remove(i); groups[d].remove(j)
                groups[dmax].append(j); groups[d].append(i)
                device_of[i], device_of[j] = d, dmax
                delta = int(w[i] - w[j])
                loads[dmax] -= delta; loads[d] += delta
                improved = True
                dmax = int(np.argmax(loads))
        if not improved:
            break
    return Assignment(device_of, loads, f"{partitioner}-eqcount")


# ---------------------------------------------------------------------------
# Plan construction
# ---------------------------------------------------------------------------

def make_plan(
    profile: HeadSparsityProfile,
    *,
    num_devices: int,
    num_kv_heads: int | None = None,
    seq_len: int,
    total_budget_per_head: int,
    block: int = 128,
    floor: int = 128,
    allocator: str = "maxmin",
    partitioner: str = "best",
    layers: Sequence[int] | None = None,
    prev_plan: "HPLBPlan | None" = None,
    epoch: int = 0,
) -> HPLBPlan:
    """Build the full S-HPLB plan for a model.

    Parameters
    ----------
    profile:
        offline per-head sparsity profile ``[L, H, G]``.
    num_devices:
        size of the ``model`` mesh axis that shards attention heads.
    num_kv_heads:
        GQA group count (None / == H means MHA).
    seq_len:
        context length the plan targets (budgets are tokens of this context).
    total_budget_per_head:
        ``k`` — the uniform top-k budget whose total ``H*k`` the adaptive
        allocator redistributes (paper: same overall compute as top-k).
    allocator:
        "maxmin" (paper), "uniform" (top-k baseline — still load-balanced,
        trivially), see ``repro.core.budget``.
    partitioner:
        "best" (LPT+KK+refine — production default), "lpt" (paper),
        "naive" (vanilla HP baseline).
    layers:
        subset of layers to plan (default: all).
    prev_plan:
        warm-start the allocator from this plan's budgets (incremental
        replanning, DESIGN.md §2.9): when the profile drifted mildly the
        transfer loop starts near its fixed point.  Geometry (H, Hkv, D,
        block) must match.
    epoch:
        plan-epoch version stamped on the result.
    """
    H = profile.num_heads
    Hkv = num_kv_heads if num_kv_heads is not None else H
    assert H % Hkv == 0, f"H={H} not divisible by KV heads {Hkv}"
    group_size = H // Hkv
    L = profile.num_layers
    layer_ids = list(range(L)) if layers is None else list(layers)

    # GQA colocation: atoms are KV groups unless there are too few of them,
    # then fall back to per-query-head atoms with KV replication.
    if Hkv % num_devices == 0:
        mode = "kv_group"
        atoms_per_dev_ok = True
    elif H % num_devices == 0:
        mode = "kv_replication"
        atoms_per_dev_ok = True
    else:
        raise ValueError(
            f"cannot shard H={H} (kv={Hkv}) over {num_devices} devices")
    del atoms_per_dev_ok

    if prev_plan is not None:
        assert (prev_plan.num_heads == H
                and prev_plan.num_kv_heads == Hkv
                and prev_plan.num_devices == num_devices
                and prev_plan.block == block), \
            "prev_plan geometry mismatch — cannot warm-start"

    total = int(total_budget_per_head) * H
    plans: list[LayerPlan] = []
    for l in layer_ids:
        init = (prev_plan.budgets_by_original_head(l)
                if prev_plan is not None else None)
        if allocator == "maxmin":
            alloc: AllocationResult = maxmin_allocation(
                profile, layer=l, total=total, seq_len=seq_len,
                block=block, floor=floor, init_budgets=init)
        elif allocator == "uniform":
            alloc = uniform_allocation(
                profile, layer=l, k=total_budget_per_head, seq_len=seq_len,
                block=block, floor=floor)
        else:
            raise ValueError(f"unknown allocator {allocator!r}")
        budgets = alloc.budgets  # [H] by original head id

        if mode == "kv_group":
            # atom g = KV group g; weight = sum of its query heads' budgets
            atom_w = budgets.reshape(Hkv, group_size).sum(axis=1)
            asg = _balanced_partition_equal_count(atom_w, num_devices, partitioner)
            # expand atoms -> head slots: device d's groups, each contributing
            # its `group_size` query heads contiguously (KV colocated).
            perm = []
            kv_perm = []
            for d in range(num_devices):
                for g in sorted(np.where(asg.device_of == d)[0]):
                    kv_perm.append(g)
                    base = g * group_size
                    perm.extend(range(base, base + group_size))
            perm = np.asarray(perm, np.int64)
            kv_perm = np.asarray(kv_perm, np.int64)
        else:  # kv_replication: atoms are query heads; KV heads replicated
            asg = _balanced_partition_equal_count(budgets, num_devices, partitioner)
            perm = []
            for d in range(num_devices):
                perm.extend(sorted(np.where(asg.device_of == d)[0]))
            perm = np.asarray(perm, np.int64)
            kv_perm = np.arange(Hkv, dtype=np.int64)  # replicated, no permute

        inv = np.empty_like(perm)
        inv[perm] = np.arange(H)
        slot_budgets = budgets[perm]
        heads_per_dev = H // num_devices
        device_loads = slot_budgets.reshape(num_devices, heads_per_dev).sum(axis=1)
        plans.append(
            LayerPlan(
                perm=perm, inv_perm=inv, budgets=slot_budgets,
                kv_perm=kv_perm, device_loads=device_loads, assignment=asg,
            )
        )
    return HPLBPlan(
        layers=plans, num_devices=num_devices, num_heads=H,
        num_kv_heads=Hkv, block=block, seq_len=seq_len, mode=mode,
        partitioner=partitioner, allocator=allocator, epoch=epoch,
    )


# ---------------------------------------------------------------------------
# Plan epochs: composable deltas between plans (DESIGN.md §2.9)
# ---------------------------------------------------------------------------

def plans_equal(a: HPLBPlan, b: HPLBPlan) -> bool:
    """Same placement AND budgets on every layer (epoch tags ignored) —
    the replanner's no-op check."""
    if len(a.layers) != len(b.layers):
        return False
    return all(
        np.array_equal(la.perm, lb.perm)
        and np.array_equal(la.kv_perm, lb.kv_perm)
        and np.array_equal(la.budgets, lb.budgets)
        for la, lb in zip(a.layers, b.layers))


def plan_delta(old: HPLBPlan, new: HPLBPlan) -> "PlanDelta":
    """The slot-order shuffle taking epoch ``old`` to epoch ``new``.

    Weights permuted by ``old`` hold original head ``old.perm[s]`` in slot
    ``s``; the new epoch wants ``new.perm[s]`` there.  The delta slot
    permutation is therefore ``old.inv_perm[new.perm]`` (and likewise for
    kv heads), satisfying the composition law

        ``old.perm[delta.perm] == new.perm``.

    Each per-layer delta is packaged as a :class:`LayerPlan` (carrying the
    NEW epoch's slot-order budgets/loads), so applying an epoch swap is the
    very same host-side :func:`permute_attention_params` call used at
    engine init — jitted model code never changes.  The resident KV
    cache's kv-head axis must be gathered by ``delta.kv_perm`` per layer
    (in ``kv_replication`` mode kv heads are never permuted, so the cache
    is untouched).
    """
    assert old.num_heads == new.num_heads, "head-count mismatch"
    assert old.num_kv_heads == new.num_kv_heads, "kv-head-count mismatch"
    assert old.mode == new.mode, (
        f"cannot delta across modes ({old.mode} -> {new.mode})")
    layers = []
    identity = True
    for lo, ln in zip(old.layers, new.layers):
        d_perm = lo.inv_perm[ln.perm]
        if old.mode == "kv_replication":
            d_kv = np.arange(len(lo.kv_perm), dtype=np.int64)
        else:
            kv_inv = np.empty_like(lo.kv_perm)
            kv_inv[lo.kv_perm] = np.arange(len(lo.kv_perm))
            d_kv = kv_inv[ln.kv_perm]
        identity = (identity
                    and np.array_equal(d_perm, np.arange(len(d_perm)))
                    and np.array_equal(d_kv, np.arange(len(d_kv))))
        inv = np.empty_like(d_perm)
        inv[d_perm] = np.arange(len(d_perm))
        layers.append(LayerPlan(
            perm=d_perm, inv_perm=inv, budgets=ln.budgets.copy(),
            kv_perm=d_kv, device_loads=ln.device_loads.copy(),
            assignment=ln.assignment))
    return PlanDelta(layers=layers, from_epoch=old.epoch,
                     to_epoch=new.epoch, identity=identity,
                     mode=new.mode)


@dataclasses.dataclass
class PlanDelta:
    """Composable epoch-to-epoch permutation delta (see :func:`plan_delta`).

    ``layers[l].perm`` / ``.kv_perm`` are SLOT-ORDER shuffles over the
    previous epoch's layout; ``identity`` is True when the swap moves no
    head (budget-only replan — params and cache stay put).
    """

    layers: list[LayerPlan]
    from_epoch: int
    to_epoch: int
    identity: bool
    mode: str

    def kv_perm_table(self) -> np.ndarray:
        """``[L, Hkv]`` per-layer kv-slot shuffle — the gather indices for
        re-permuting the resident KV cache's kv-head axis on-device."""
        return np.stack([lp.kv_perm for lp in self.layers]).astype(np.int32)


# ---------------------------------------------------------------------------
# Applying a plan to model parameters (weight-layout permutation)
# ---------------------------------------------------------------------------

def permute_attention_params(
    wq: np.ndarray, wk: np.ndarray, wv: np.ndarray, wo: np.ndarray,
    layer_plan: LayerPlan, head_dim: int, group_size: int,
    kv_replicated: bool = False,
):
    """Permute one layer's attention projections into HPLB slot order.

    Shapes (canonical):
      wq: [d_model, H * Dh]     — query projection, heads along columns
      wk: [d_model, Hkv * Dh]
      wv: [d_model, Hkv * Dh]
      wo: [H * Dh, d_model]     — output projection, heads along rows

    The same permutation applied to wq columns and wo rows cancels out —
    the model function is exactly preserved (up to fp addition order).
    """
    perm, kv_perm = layer_plan.perm, layer_plan.kv_perm
    H = len(perm)

    def pc(w, p, dh):  # permute head-blocks of columns
        d0 = w.shape[0]
        return w.reshape(d0, len(p), dh)[:, p, :].reshape(d0, len(p) * dh)

    def pr(w, p, dh):  # permute head-blocks of rows
        d1 = w.shape[1]
        return w.reshape(len(p), dh, d1)[p].reshape(len(p) * dh, d1)

    wq2 = pc(wq, perm, head_dim)
    wo2 = pr(wo, perm, head_dim)
    if kv_replicated:
        wk2, wv2 = wk, wv
    else:
        wk2 = pc(wk, kv_perm, head_dim)
        wv2 = pc(wv, kv_perm, head_dim)
    return wq2, wk2, wv2, wo2


def plan_summary(plan: HPLBPlan, baseline_partitioner: str = "naive") -> dict:
    """Imbalance metrics of the plan vs the naive-HP baseline.

    Returns per-plan aggregates including the padded-grid saving: on TPU the
    compiled sparse-attention grid has length ``max_d L_d`` (DESIGN.md §2.1),
    so ``saving = 1 - makespan(plan) / makespan(naive)`` is the fraction of
    grid steps (hence latency, at fixed tile cost) S-HPLB removes.
    """
    naive_makespans, plan_makespans = [], []
    naive_imb, plan_imb = [], []
    H, D = plan.num_heads, plan.num_devices
    gsz = H // plan.num_kv_heads
    for lp in plan.layers:
        budgets_orig = np.zeros_like(lp.budgets)
        budgets_orig[lp.perm] = lp.budgets
        if plan.mode == "kv_group":
            atom_w = budgets_orig.reshape(plan.num_kv_heads, gsz).sum(axis=1)
        else:
            atom_w = budgets_orig
        nv = naive_partition(atom_w, D, mode="contiguous")
        naive_makespans.append(nv.makespan)
        naive_imb.append(nv.imbalance)
        plan_makespans.append(lp.makespan_tokens)
        plan_imb.append(lp.imbalance)
    naive_total = float(np.sum(naive_makespans))
    plan_total = float(np.sum(plan_makespans))
    return {
        "mode": plan.mode,
        "allocator": plan.allocator,
        "partitioner": plan.partitioner,
        "mean_imbalance_naive": float(np.mean(naive_imb)),
        "mean_imbalance_plan": float(np.mean(plan_imb)),
        "max_imbalance_naive": float(np.max(naive_imb)),
        "max_imbalance_plan": float(np.max(plan_imb)),
        "makespan_tokens_naive": naive_total,
        "makespan_tokens_plan": plan_total,
        "padded_grid_saving": 1.0 - plan_total / max(naive_total, 1e-9),
    }
