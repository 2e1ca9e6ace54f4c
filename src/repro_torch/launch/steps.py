"""Step builders of the S-HPLB serving path on a mesh: the serving half of
the reference's ``launch/steps.py`` for ``module="transformer"``.

The reference builds, for an (arch x shape) cell, a function to ``jit``
with abstract inputs and sharding trees.  Here every rank is a process
that already holds its blocks, so a builder returns what one rank runs
(:class:`RankStep`): its own work lists or block ids, and a callable over
its local params and cache.

- :func:`build_prefill_step`: the S-HPLB sparse prefill through the
  prefill islands, in one of three list modes.  ``kv_group`` (the kv heads
  divide ``model``): each rank its KV groups, local head and kv ids.
  ``kv_replication`` (they do not, the q heads do): each rank its q heads
  over every kv head, item kv ids global (``lp.perm // G``).  ``rows``
  (the q heads do not divide ``model`` either, or ``force_rows``): (head, q
  block) rows over ``model``, weights unpermuted and q / k / v whole.
- :func:`build_decode_step`: the budgeted decode.  Where the cache's
  sequence is sharded (:func:`repro_torch.sharding.specs.cache_spec`:
  ``model`` when the kv heads do not divide it, ``seq`` on a 2D mesh) it
  runs the seq-sharded island over the plan's sink + recent blocks
  (:func:`_decode_block_ids_sharded`); else, as the reference's cell, dense
  decode (windowed on an 'L' layer), through the head-sharded packed island
  over every block of the cache, packed per rank.  ``kv_dtype`` int8 / fp8 takes the
  codes-and-scales forms.
- :func:`run_on_mesh` spawns the ranks, draws seeded weights (every rank
  the same full tensors, keeping its blocks, so the weights do not depend
  on the mesh), runs the prefill and a few greedy decode steps, and
  returns each rank's tokens, kernel launches and island times.

    python -m repro_torch.launch.steps --arch yi-6b --shape prefill_32k \\
        --model 4 --layers 4 --batch 1 --backend gloo --device cuda:0
    python -m repro_torch.launch.steps --arch gemma3-1b --smoke \\
        --shape prefill_32k --seq-len 512 --batch 1 --model 2 \\
        --backend gloo --device cpu

``gloo`` with every rank on ``cuda:0`` shares one card (collectives staged
through host memory); ``nccl`` needs a card a rank.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Callable

import numpy as np
import torch

from repro_torch.attention.policies import policy_by_name
from repro_torch.configs import SHAPES, ArchSpec, ShapeSpec, get_spec
from repro_torch.core import quant
from repro_torch.core.planner import (
    HPLBPlan, make_plan, permute_attention_params)
from repro_torch.core.sparsity import synthetic_head_curves
from repro_torch.core.worklist import (
    blocks_for_budget, build_row_worklist, extend_packed_items,
    pack_decode_items, worklist_from_budgets)
from repro_torch.launch.mesh import Mesh, spawn
from repro_torch.models import transformer as tfm
from repro_torch.models.common import merge_heads
from repro_torch.serving import sharded_attention as isl
from repro_torch.sharding import specs as sh

# Serving plan defaults (the paper's setting: k = 4096 at 32k+ contexts)
SERVE_BUDGET_PER_HEAD = 4096
BLOCK = 128


def _hp_degree(cfg, model_shards: int) -> int:
    """Head-parallel degree for the plan: the mesh's model size when head
    atoms divide it, else 1 (row mode partitions (head, q_blk) rows across
    the mesh instead; budgets are device-count-independent)."""
    H, Hkv = cfg.num_heads, cfg.num_kv_heads
    if H % model_shards == 0 and (Hkv % model_shards == 0
                                  or H % model_shards == 0):
        return model_shards
    return 1


def _serve_plan(spec: ArchSpec, seq_len: int, model_shards: int,
                allocator: str = "maxmin", partitioner: str = "best",
                budget: int | None = None):
    """HPLB plan for serving cells (synthetic profile: planning is
    profile-shape-agnostic; real deployments feed measured profiles).
    ``budget`` replaces ``SERVE_BUDGET_PER_HEAD``."""
    cfg = spec.full
    prof = synthetic_head_curves(cfg.num_layers, cfg.num_heads)
    hp = _hp_degree(cfg, model_shards)
    k = SERVE_BUDGET_PER_HEAD if budget is None else budget
    return make_plan(
        prof, num_devices=hp, num_kv_heads=cfg.num_kv_heads,
        seq_len=seq_len, total_budget_per_head=min(k, seq_len),
        block=BLOCK, allocator=allocator, partitioner=partitioner,
    ), cfg


@dataclasses.dataclass
class RankStep:
    """What one rank runs.  ``mode``: the prefill list mode ("kv_group",
    "kv_replication", "rows") or the decode branch ("seq", "heads");
    ``work``: this rank's lists (prefill ``[1, L, Lpad, 7]``; decode
    ``[L, 1, Lpad, DEC_FIELDS]`` packed items or ``[L, 1, Hkv_loc,
    nb_loc]`` block ids); ``fn``: the step over local params (see the
    builders); ``meta``: every rank's prefill lists and the plan's
    imbalance, or the decode cache's spec and sequence axes."""

    name: str
    kind: str
    mode: str
    plan: HPLBPlan
    fn: Callable
    work: torch.Tensor
    meta: dict


class IslandLog:
    """Times every island call of a rank (CUDA events on the card, the host
    clock on the CPU) and keeps one layer's island inputs and output
    (``record_layer``, first call) for a check outside the rank.  A
    decode island's inputs are ``(q, kc, vc, work, pos, ks, vs)`` as the
    island takes them (q gathered and in original head order where the
    step does so), a prefill island's ``(l, q, k, v, work)``."""

    def __init__(self, device: torch.device, record_layer: int | None = None):
        self.cuda = device.type == "cuda"
        self.record_layer = record_layer
        self.record: dict | None = None
        self._marks: list = []

    def run(self, l: int, fn, *args):
        if self.cuda:
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            out = fn(*args)
            end.record()
            self._marks.append((start, end))
        else:
            t0 = time.perf_counter()
            out = fn(*args)
            self._marks.append((t0, time.perf_counter()))
        if l == self.record_layer and self.record is None:
            self.record = {"layer": l, "inputs": args, "output": out}
        return out

    def take_ms(self) -> list[float]:
        """Each call's milliseconds since the last take (synchronises)."""
        if self.cuda:
            torch.cuda.synchronize()
            ms = [s.elapsed_time(e) for s, e in self._marks]
        else:
            ms = [(e - s) * 1e3 for s, e in self._marks]
        self._marks = []
        return ms


def record_wo(log: IslandLog, l: int, o, params, cfg, mesh) -> None:
    """At the recorded layer, where ``wo`` is row-sharded, add this rank's
    partial product of island rows ``o [B, H_loc, R, Dh]`` and its sum over
    ``model`` (:meth:`Mesh.all_reduce`, as the model sums it) to the
    record."""
    rec = log.record
    if rec is None or rec["layer"] != l or "wo_sum" in rec:
        return
    wo = params["layers"][l]["attn"]["wo"]
    if wo.shape[0] == cfg.num_heads * cfg.head_dim_:
        return
    part = merge_heads(o) @ wo
    rec.update(wo=wo, wo_rows=o, wo_partial=part,
               wo_sum=mesh.all_reduce(part, "model"))


# ---------------------------------------------------------------------------
# Prefill
# ---------------------------------------------------------------------------

def prefill_lists(spec: ArchSpec, seq_len: int, model_shards: int, *,
                  allocator: str = "maxmin", partitioner: str = "best",
                  force_rows: bool = False, budget: int | None = None):
    """The reference's per-layer, per-rank prefill work lists
    (``steps.py:222-262``): ``(plan, cfg, mode, items [n_model, L, Lpad,
    7] int32)``, pad rows replicating each rank's last row with valid 0."""
    S = seq_len
    plan, cfg = _serve_plan(spec, S, model_shards, allocator=allocator,
                            partitioner=partitioner, budget=budget)
    pol = policy_by_name("strided")
    row_mode = force_rows or plan.num_devices != model_shards
    kv_sharded = (not row_mode) and plan.mode == "kv_group"
    wls = []
    nq = -(-S // BLOCK)
    for l in range(cfg.num_layers):
        lp = plan.layers[l]
        if row_mode:
            # weights stay unpermuted (q/k/v whole in the island), so
            # budgets and ids are in original head order
            budgets_orig = plan.budgets_by_original_head(l)
            nb = blocks_for_budget(budgets_orig, BLOCK)
            sels = [pol(h, int(nb[h]), nq, nq)
                    for h in range(cfg.num_heads)]
            wls.append(build_row_worklist(
                sels, num_devices=model_shards, num_q_blocks=nq,
                num_kv_blocks=nq, block=BLOCK,
                kv_head_of_head=np.arange(cfg.num_heads) // cfg.group_size))
        elif kv_sharded:
            wls.append(worklist_from_budgets(
                lp.budgets, num_devices=model_shards, seq_len=S,
                block=BLOCK, policy_fn=pol, group_size=cfg.group_size))
        else:
            # kv_replication: kv index = original kv head (global,
            # replicated on every rank)
            wls.append(worklist_from_budgets(
                lp.budgets, num_devices=model_shards, seq_len=S,
                block=BLOCK, policy_fn=pol, group_size=cfg.group_size,
                kv_head_of_head=lp.perm // cfg.group_size, kv_local=False))
    lpad = max(w.padded_length for w in wls)
    items = np.zeros((model_shards, cfg.num_layers, lpad, 7), np.int32)
    for l, w in enumerate(wls):
        items[:, l, :w.padded_length] = w.items
        for d in range(model_shards):
            items[d, l, w.padded_length:] = items[d, l, w.padded_length - 1]
            items[d, l, w.padded_length:, 3:6] = 0
    mode = "rows" if row_mode else plan.mode
    return plan, cfg, mode, items


def build_prefill_step(spec: ArchSpec, shape: ShapeSpec, mesh: Mesh, *,
                       allocator: str = "maxmin", partitioner: str = "best",
                       force_rows: bool = False, budget: int | None = None,
                       log: IslandLog | None = None) -> RankStep:
    """This rank's S-HPLB sparse prefill of ``shape``'s sequence length.
    ``fn(params, tokens, cache_len=None) -> (logits [B_l, V], cache)``
    over this rank's blocks (:func:`repro_torch.sharding.specs.
    shard_params` of the plan-permuted weights, ``mode`` of the step) and
    its rows of ``tokens``; the cache holds the kv heads the rank
    computes."""
    model_shards = mesh.size("model")
    plan, cfg, mode, items = prefill_lists(
        spec, shape.seq_len, model_shards, allocator=allocator,
        partitioner=partitioner, force_rows=force_rows, budget=budget)
    d = mesh.axis_index("model")
    work = torch.from_numpy(items[d:d + 1]).to(mesh.device)
    if mode == "rows":
        attend = isl.hplb_prefill_attention_rows(
            mesh, block_q=BLOCK, block_kv=BLOCK)
    else:
        # one island for both modes: the lists' kv ids address the K/V
        attend = isl.hplb_prefill_attention(block_q=BLOCK, block_kv=BLOCK)
    log = log or IslandLog(mesh.device)

    def fn(params, tokens, cache_len: int | None = None):
        def override(l, q, k, v):
            o = log.run(l, attend, l, q, k, v, work)
            record_wo(log, l, o[:, :, -BLOCK:], params, cfg, mesh)
            return o
        return tfm.prefill(params, tokens, cfg, cache_len=cache_len,
                           attn_override=override, mesh=mesh)

    return RankStep(
        name=f"{spec.arch_id}:{shape.name}:prefill", kind="prefill",
        mode=mode, plan=plan, fn=fn, work=work,
        meta={"items": items, "worklist_lpad": int(items.shape[2]),
              "plan_imbalance": plan.mean_imbalance})


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def _decode_block_ids_sharded(plan, cfg, cache_len: int, n_shards: int):
    """Per-shard decode block lists [L, n_shards, Hkv, nb_loc], -1 padded.

    Budget per kv head = max over its q heads; blocks = sink + recent.
    Blocks are assigned to the seq-shard that OWNS them (global block id //
    blocks_per_shard) — the HPLB-balanced analogue for sequence sharding.
    """
    gsz = cfg.group_size
    nkv_blocks = cache_len // BLOCK
    blocks_per_shard = nkv_blocks // n_shards
    hkv = cfg.num_kv_heads
    budgets = np.stack([
        lp.budgets.reshape(hkv, gsz).max(axis=1) for lp in plan.layers
    ])  # [L, Hkv]
    nb = np.minimum(-(-budgets // BLOCK), nkv_blocks)
    nb_loc = 1
    L = nb.shape[0]
    ids_layers = []
    for l in range(L):
        shard_lists = [[[] for _ in range(hkv)] for _ in range(n_shards)]
        for h in range(hkv):
            n = int(nb[l, h])
            sel = [0] + list(range(nkv_blocks - (n - 1), nkv_blocks))
            sel = sorted(set(b for b in sel if 0 <= b < nkv_blocks))[:n]
            for b in sel:
                s = min(b // max(blocks_per_shard, 1), n_shards - 1)
                shard_lists[s][h].append(b)
        nb_loc = max(nb_loc, max(len(shard_lists[s][h])
                                 for s in range(n_shards)
                                 for h in range(hkv)))
        ids_layers.append(shard_lists)
    ids = np.full((L, n_shards, hkv, nb_loc), -1, np.int32)
    for l, shard_lists in enumerate(ids_layers):
        for s in range(n_shards):
            for h in range(hkv):
                v = shard_lists[s][h]
                ids[l, s, h, :len(v)] = v
    return ids


def _dense_block_ids(L: int, hkv: int, cache_len: int):
    """Every block of the cache for every layer and kv head: ``[L, Hkv,
    nb]``."""
    ids = np.arange(cache_len // BLOCK, dtype=np.int32)
    return np.broadcast_to(ids, (L, hkv, ids.shape[0])).copy()


def _axes_of(entry) -> tuple:
    return () if entry is None else (
        (entry,) if isinstance(entry, str) else tuple(entry))


def build_decode_step(spec: ArchSpec, shape: ShapeSpec, mesh: Mesh, *,
                      kv_dtype: str | None = None,
                      plan: HPLBPlan | None = None,
                      budget: int | None = None, rows: bool = False,
                      log: IslandLog | None = None) -> RankStep:
    """This rank's decode step against a cache of ``shape.seq_len``
    positions and ``shape.global_batch`` rows.

    ``fn(params, cache, token, pos, scales=None) -> logits [B_l, V]``:
    this rank's blocks of the params, of the cache ``[L, 2, B, Hkv, S,
    Dh]`` and (``kv_dtype`` int8 / fp8) of its scales ``[L, 2, B, Hkv, S /
    BLOCK]`` under ``meta["cache_spec"]``, its rows' tokens and positions
    ``[B_l]`` int32; the token's K/V is written in place.  ``plan``: the
    prefill's plan, where the decode continues a prefill; ``rows``: the
    params are row mode's (q / k / v / ``wo`` whole, original head order),
    so q reaches the island whole."""
    S, B = shape.seq_len, shape.global_batch
    model_shards = mesh.size("model")
    if plan is None:
        plan, _ = _serve_plan(spec, S, model_shards, budget=budget)
    cfg = spec.full
    L, hkv = cfg.num_layers, cfg.num_kv_heads
    kv_dtype = kv_dtype or "bf16"
    cspec = sh.cache_spec((L, 2, B, hkv, S, cfg.head_dim_), mesh)
    seq_axes = _axes_of(cspec[4])
    heads_sharded = cspec[3] is not None
    h_loc = hkv // mesh.size("model") if heads_sharded else hkv
    h_lo = mesh.axis_index("model") * h_loc if heads_sharded else 0
    log = log or IslandLog(mesh.device)
    dev = mesh.device
    if seq_axes:
        n_sh = mesh.size(seq_axes)
        sidx = mesh.axis_index(seq_axes)
        ids = _decode_block_ids_sharded(plan, cfg, S, n_sh)
        work = torch.from_numpy(
            ids[:, sidx:sidx + 1, h_lo:h_lo + h_loc].copy()).to(dev)
        attend = isl.flash_decode_attention(mesh, block_kv=BLOCK,
                                            seq_axes=seq_axes)
        seq_offset = sidx * (S // n_sh)
        # q whole where the cache holds every kv head; a kv_replication
        # plan moves q heads across groups, so they go back to their
        # original order to meet their kv heads (slot s of the weights is
        # original head perm[s])
        gather_q = not (heads_sharded or rows) and plan.num_devices > 1
        reorder = gather_q and plan.mode == "kv_replication"
        H_loc = cfg.num_heads // model_shards

        def island(l, q, kc, vc, ks, vs, pos):
            if gather_q:
                q = mesh.all_gather(q, "model", dim=1)
            if reorder:
                q = q[:, torch.as_tensor(plan.layers[l].inv_perm)]
            o = log.run(l, attend, q, kc, vc, work[l], pos, ks, vs)
            if reorder:
                o = o[:, torch.as_tensor(plan.layers[l].perm)]
            if gather_q:
                lo = mesh.axis_index("model") * H_loc
                o = o[:, lo:lo + H_loc]
            return o
        branch = "seq"
    else:
        # the reference lowers this cell as dense decode: every block
        ids1 = _dense_block_ids(L, hkv, S)
        b_loc = B // mesh.size(_axes_of(cspec[2])) if cspec[2] else B
        lists = [pack_decode_items(
            np.broadcast_to(ids1[l], (b_loc,) + ids1[l].shape).copy(),
            num_shards=model_shards, block=BLOCK,
            shard_of_kvhead=np.arange(hkv) // h_loc,
            kvhead_local=True).items for l in range(L)]
        width = max(x.shape[1] for x in lists)
        items = np.stack([extend_packed_items(x, width) for x in lists])
        d = mesh.axis_index("model")
        work = torch.from_numpy(items[:, d:d + 1].copy()).to(dev)
        attend = isl.hplb_decode_attention_packed(block_kv=BLOCK)
        seq_offset = None

        H_loc = cfg.num_heads // model_shards

        whole = rows and model_shards > 1

        def island(l, q, kc, vc, ks, vs, pos):
            # whole q (row-mode weights): this rank's heads, o gathered
            if whole:
                q = q[:, d * H_loc:(d + 1) * H_loc].contiguous()
            o = log.run(l, attend, q, kc, vc, work[l], pos, ks, vs,
                        tfm._window_of(cfg, l))
            return mesh.all_gather(o, "model", dim=1) if whole else o
        branch = "heads"

    def fn(params, cache, token, pos, scales=None):
        def override(l, q, kc, vc, ks=None, vs=None):
            o = island(l, q, kc, vc, ks, vs, pos)
            record_wo(log, l, o, params, cfg, mesh)
            return o
        out = tfm.decode_step(params, cache, token, pos, cfg, scales=scales,
                              kv_dtype=kv_dtype, attn_override=override,
                              mesh=mesh, seq_offset=seq_offset)
        return out[0] if scales is not None else out

    return RankStep(
        name=f"{spec.arch_id}:{shape.name}:decode", kind="decode",
        mode=branch, plan=plan, fn=fn, work=work,
        meta={"cache_spec": cspec, "seq_axes": list(seq_axes),
              "kv_dtype": kv_dtype})


# ---------------------------------------------------------------------------
# Running the steps on a mesh
# ---------------------------------------------------------------------------

def seeded_tokens(vocab: int, shape: tuple, seed: int) -> np.ndarray:
    """The prompt (or first decode) tokens of a run: int64 from numpy's
    generator at ``seed``."""
    return np.random.default_rng(seed).integers(
        0, vocab, size=shape).astype(np.int64)


def seeded_cache(cfg, batch: int, seq_len: int, seed: int,
                 device: torch.device) -> torch.Tensor:
    """A decode cell's cache ``[L, 2, B, Hkv, S, Dh]`` of standard normals
    in ``cfg.dtype`` (original kv-head order): numpy's generator on the
    CPU, a torch generator on a card (no host draw of billions)."""
    shape = (cfg.num_layers, 2, batch, cfg.num_kv_heads, seq_len,
             cfg.head_dim_)
    if device.type == "cpu":
        x = np.random.default_rng(seed).standard_normal(shape,
                                                        dtype=np.float32)
        return torch.from_numpy(x).to(cfg.dtype)
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape, generator=gen, device=device).to(cfg.dtype)


def plan_params(cfg, seed: int, device: torch.device, plan: HPLBPlan,
                mode: str) -> dict:
    """The full seeded weights (``tfm.init_params``; numpy's generator on
    the CPU, a torch generator on a card), attention heads permuted into
    the plan's slot order unless ``mode`` is "rows"."""
    params = tfm.init_params(cfg, seed=seed, device=device,
                             host_rng=device.type == "cpu")
    if mode != "rows":
        for l, lp in enumerate(params["layers"]):
            a = lp["attn"]
            a["wq"], a["wk"], a["wv"], a["wo"] = permute_attention_params(
                a["wq"], a["wk"], a["wv"], a["wo"], plan.layers[l],
                cfg.head_dim_, cfg.group_size,
                kv_replicated=mode == "kv_replication")
    return params


def permute_cache(cache: torch.Tensor, plan: HPLBPlan, mode: str):
    """A cache in original kv-head order, moved into the plan's kv slot
    order (``kv_group``; the other modes keep every kv head in place)."""
    if mode != "kv_group":
        return cache
    return tfm.permute_cache_kv_heads(cache, np.stack(
        [lp.kv_perm for lp in plan.layers]))


@dataclasses.dataclass(frozen=True)
class MeshJob:
    """One :func:`run_on_mesh` call, as every rank receives it."""

    arch: str
    shapes: tuple
    model: int
    seq: int
    data: int
    layers: int | None
    batch: int | None
    seed: int
    steps: int
    kv_dtype: str | None
    smoke: bool
    dtype: str | None
    budget: int | None
    force_rows: bool
    record_layer: int | None
    record_dir: str | None
    return_logits: bool

    @property
    def world_size(self) -> int:
        return self.data * self.model * self.seq

    def run(self, env) -> dict:
        return mesh_rank(env, self)


@dataclasses.dataclass(frozen=True)
class IslandJob:
    """The islands alone (:func:`island_rank`) as a job of 4 ranks."""

    heads: int
    kv_heads: int
    head_dim: int
    seed: int
    record_dir: str
    rows: int = 8
    cache_len: int = 4096
    world_size: int = 4

    def run(self, env) -> dict:
        return island_rank(env, self.heads, self.kv_heads, self.head_dim,
                           self.seed, self.record_dir, self.rows,
                           self.cache_len)


def job_spec(job: MeshJob) -> ArchSpec:
    """The job's arch with its config cut (``layers``) and retyped
    (``dtype``), as ``full``; ``smoke`` takes the SMOKE config."""
    spec = get_spec(job.arch)
    cfg = spec.smoke if job.smoke else spec.full
    if job.layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=job.layers)
    if job.dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=getattr(torch, job.dtype))
    return dataclasses.replace(spec, full=cfg)


def _launch_counts() -> dict:
    from repro_torch.kernels.flash_decode import (
        flash_decode_kernel, flash_decode_paged_kernel)
    from repro_torch.kernels.sparse_prefill import sparse_prefill_attention
    return {"sparse_prefill_contig": sparse_prefill_attention,
            "flash_decode_contig": flash_decode_kernel,
            "flash_decode_paged": flash_decode_paged_kernel}


def _cuda_sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _run_shape(spec, shape, mesh, job, log_p, log_d) -> dict:
    """One shape of a job on this rank: prefill + greedy decode steps
    (a prefill shape), or greedy decode steps over a seeded cache (a
    decode shape)."""
    from repro_torch.kernels.build import reset_launches
    cfg, dev = spec.full, mesh.device
    counters = _launch_counts()
    reset_launches(*counters.values())
    B = job.batch or shape.global_batch
    bspec = sh.batch_specs({"t": torch.empty(B, 1)}, mesh)["t"]
    bax = _axes_of(bspec[0])
    b_loc = B // mesh.size(bax) if bax else B
    b_lo = mesh.axis_index(bax) * b_loc if bax else 0
    rows = slice(b_lo, b_lo + b_loc)
    out = {"shape": shape.name, "logits": [], "tokens": []}
    S = shape.seq_len
    if shape.kind == "prefill":
        pstep = build_prefill_step(spec, shape, mesh, budget=job.budget,
                                   force_rows=job.force_rows, log=log_p)
        plan, mode = pstep.plan, pstep.mode
        # the decode's cache: the prompt and the decode steps, in whole
        # blocks over every rank of its sequence axes
        seq_axes = sh.cache_seq_axes(B, cfg.num_kv_heads, mesh)
        step = BLOCK * (mesh.size(seq_axes) if seq_axes else 1)
        cache_len = -(-(S + job.steps) // step) * step
        dshape = ShapeSpec(f"{shape.name}+decode", cache_len, B, "decode")
        dstep = build_decode_step(spec, dshape, mesh, kv_dtype=job.kv_dtype,
                                  plan=plan, rows=mode == "rows", log=log_d)
        params = sh.shard_params(plan_params(cfg, job.seed, dev, plan, mode),
                                 mesh, mode)
        tokens = torch.from_numpy(seeded_tokens(
            cfg.vocab_size, (B, S), job.seed + 1)[rows]).to(dev)
        _cuda_sync(dev)
        t0 = time.perf_counter()
        logits, pcache = pstep.fn(params, tokens, cache_len=cache_len)
        _cuda_sync(dev)
        out["prefill_s"] = time.perf_counter() - t0
        out["prefill_island_ms"] = log_p.take_ms()
        out["mode"] = mode
        # the prefill's cache holds this rank's rows and, in kv_group, its
        # kv heads; keep the decode's block of it
        cut = list(dstep.meta["cache_spec"])
        cut[2] = None
        if mode == "kv_group":
            cut[3] = None
        cache = sh.local_slice(pcache, tuple(cut), mesh)
        del pcache
        first = logits.argmax(-1)
        pos0 = S
    else:
        plan, _ = _serve_plan(spec, S, mesh.size("model"), budget=job.budget)
        mode = ("rows" if job.force_rows
                or plan.num_devices != mesh.size("model") else plan.mode)
        dstep = build_decode_step(spec, ShapeSpec(shape.name, S, B, "decode"),
                                  mesh, kv_dtype=job.kv_dtype, plan=plan,
                                  rows=mode == "rows", log=log_d)
        params = sh.shard_params(plan_params(cfg, job.seed, dev, plan, mode),
                                 mesh, mode)
        full = permute_cache(seeded_cache(cfg, B, S, job.seed + 2, dev),
                             plan, mode)
        cache = sh.local_slice(full, dstep.meta["cache_spec"], mesh)
        del full
        first = torch.from_numpy(seeded_tokens(
            cfg.vocab_size, (B,), job.seed + 3)[rows]).to(dev)
        logits = None
        pos0 = S - job.steps
        out["mode"] = mode
    scales = None
    if job.kv_dtype is not None and quant.is_quantized(job.kv_dtype):
        cache, scales = quant.quantize_seq_cache(cache, BLOCK, job.kv_dtype)
    out["branch"] = dstep.mode
    if logits is not None and job.return_logits:
        out["logits"].append(logits.float().cpu())
    token = first
    out["tokens"].append(token.cpu().tolist())
    _cuda_sync(dev)
    t0 = time.perf_counter()
    for t in range(job.steps):
        pos = torch.full((b_loc,), pos0 + t, dtype=torch.int32, device=dev)
        logits = dstep.fn(params, cache, token, pos, scales)
        if job.return_logits:
            out["logits"].append(logits.float().cpu())
        token = logits.argmax(-1)
        out["tokens"].append(token.cpu().tolist())
    _cuda_sync(dev)
    out["decode_s"] = time.perf_counter() - t0
    out["decode_island_ms"] = log_d.take_ms()
    out["launches"] = {k: w.launches for k, w in counters.items()}
    if mesh.rank == 0:
        out["device_loads"] = [lp.device_loads.tolist() for lp in plan.layers]
        out["imbalance"] = plan.mean_imbalance
    return out


def _record(log: IslandLog, mesh: Mesh, job: MeshJob,
            tag: str) -> str | None:
    """Save a rank's recorded island call (inputs, output, and where the
    layer's ``wo`` is row-sharded its partial product and their sum) to
    the job's record directory; returns the file."""
    if log.record is None or job.record_dir is None:
        return None
    cpu = lambda x: x.detach().cpu() if torch.is_tensor(x) else x  # noqa
    rec = {k: (tuple(cpu(a) for a in v) if isinstance(v, tuple) else cpu(v))
           for k, v in log.record.items()}
    path = os.path.join(job.record_dir, f"{tag}-rank{mesh.rank}.pt")
    torch.save(rec, path)
    return path


def mesh_rank(env, job: MeshJob) -> dict:
    """One rank of :func:`run_on_mesh` (run by :func:`spawn`)."""
    mesh = Mesh(env, data=job.data, model=job.model, seq=job.seq)
    spec = job_spec(job)
    res = {"rank": mesh.rank, "coords": dict(mesh.coords),
           "backend": mesh.backend, "runs": []}
    for shape in job.shapes:
        log_p = IslandLog(mesh.device, job.record_layer)
        log_d = IslandLog(mesh.device, job.record_layer)
        run = _run_shape(spec, shape, mesh, job, log_p, log_d)
        for tag, log in (("prefill", log_p), ("decode", log_d)):
            run[f"{tag}_record"] = _record(
                log, mesh, job, f"{job.arch}-{shape.name}-{tag}")
        res["runs"].append(run)
    return res


def island_rank(env, heads: int, kv_heads: int, head_dim: int, seed: int,
                record_dir: str, rows: int = 8,
                cache_len: int = 4096) -> dict:
    """The islands alone on one rank of 4, on seeded inputs at a model's
    widths (bf16, blocks of ``BLOCK``), for a check outside the ranks: the
    paged island (pool stripes over ``model``, rows over ``data``, a 2 x 2
    mesh), the 2D island (heads over ``model``, stripes over ``seq``), the
    int8 packed decode island (heads over ``model``, rows over ``data``),
    the repermute and the swap gather and scatter (kv heads over
    ``model``).  Every rank draws the same full inputs and keeps its
    blocks; it saves its blocks, outputs and coordinates to
    ``record_dir`` and returns each island's milliseconds."""
    from repro_torch.kernels.build import reset_launches
    counters = _launch_counts()
    reset_launches(*counters.values())
    dev = env.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    rng = np.random.default_rng(seed)
    B, H, HKV, D, T = rows, heads, kv_heads, head_dim, cache_len // BLOCK
    N = B * T
    randn = lambda *shape: torch.randn(  # noqa: E731
        shape, generator=gen, device=dev).to(torch.bfloat16)
    q, kp, vp = randn(B, H, 1, D), randn(N, HKV, BLOCK, D), randn(
        N, HKV, BLOCK, D)
    kc, vc = randn(B, HKV, cache_len, D), randn(B, HKV, cache_len, D)
    table = torch.from_numpy(rng.permutation(N).reshape(B, T).astype(
        np.int32)).to(dev)
    pos_np = rng.integers(BLOCK, cache_len, size=B).astype(np.int32)
    pos = torch.from_numpy(pos_np).to(dev)
    ids_np = np.full((B, HKV, T), -1, np.int32)
    for b in range(B):
        last = int(pos_np[b]) // BLOCK
        for h in range(HKV):
            n = int(rng.integers(1, last + 2))
            ids_np[b, h, :n] = np.sort(rng.choice(last + 1, size=n,
                                                  replace=False))
    ids = torch.from_numpy(ids_np).to(dev)
    rec, ms = {}, {}

    def timed(name, fn, *args):
        start, end = (torch.cuda.Event(enable_timing=True)
                      if dev.type == "cuda" else None for _ in range(2))
        t0 = time.perf_counter()
        if start is not None:
            start.record()
        out = fn(*args)
        if start is not None:
            end.record()
            torch.cuda.synchronize(dev)
            ms[name] = start.elapsed_time(end)
        else:
            ms[name] = (time.perf_counter() - t0) * 1e3
        return out

    def blk(x, dim, mesh, axis):
        n = mesh.size(axis)
        size = x.shape[dim] // n
        return x.narrow(dim, mesh.axis_index(axis) * size, size).contiguous()

    m = Mesh(env, data=2, model=2)
    rows_ = lambda x: blk(x, 0, m, "data")  # noqa: E731
    args = (rows_(q), blk(kp, 0, m, "model"), blk(vp, 0, m, "model"),
            rows_(ids), rows_(table), rows_(pos))
    rec["paged"] = {"args": args, "out": timed(
        "paged", isl.flash_decode_attention_paged(m, block_kv=BLOCK), *args)}
    kc8, ks = quant.quantize_seq_cache(kc[None, None], BLOCK, "int8")
    vc8, vs = quant.quantize_seq_cache(vc[None, None], BLOCK, "int8")
    d = m.axis_index("model")
    local = lambda x: rows_(blk(x, 1, m, "model"))  # noqa: E731
    items = pack_decode_items(
        ids_np[rows_(torch.arange(B)).numpy()], num_shards=2, block=BLOCK,
        shard_of_kvhead=np.arange(HKV) // (HKV // 2), kvhead_local=True).items
    args = (local(q), local(kc8[0, 0]), local(vc8[0, 0]),
            torch.from_numpy(items[d:d + 1]).to(dev), rows_(pos),
            local(ks[0, 0]), local(vs[0, 0]))
    rec["packed8"] = {"args": args, "out": timed(
        "packed8", isl.hplb_decode_attention_packed(block_kv=BLOCK),
        *args)}
    cache = randn(2, 2, 2, HKV, 512, D)
    kv_perm = np.stack([np.roll(np.arange(HKV), 1 + l) for l in range(2)])
    rec["reperm"] = {"full": cache, "kv_perm": kv_perm, "out": timed(
        "reperm", isl.hplb_repermute_kv_cache(m), blk(cache, 3, m, "model"),
        kv_perm)}
    pool = randn(2, 2, 64, HKV, BLOCK, D)
    swap_ids, new_ids = [5, 2, 7, 63], [0, 3, 1, 63]
    local_pool = blk(pool, 3, m, "model")
    _, blocks = timed("swap_gather", isl.hplb_swap_gather_kv_blocks,
                      local_pool, swap_ids)
    back = timed("swap_scatter", isl.hplb_swap_scatter_kv_blocks,
                 local_pool.clone(), blocks, new_ids)
    rec["swap"] = {"full": pool, "ids": swap_ids, "new_ids": new_ids,
                   "blocks": blocks, "pool": back}
    m2 = Mesh(env, model=2, seq=2)
    args = (blk(q, 1, m2, "model"),
            blk(blk(kp, 0, m2, "seq"), 1, m2, "model"),
            blk(blk(vp, 0, m2, "seq"), 1, m2, "model"),
            blk(ids, 1, m2, "model"), table, pos)
    rec["twod"] = {"args": args, "out": timed(
        "twod", isl.flash_decode_attention_2d(m2, block_kv=BLOCK), *args)}
    cpu = lambda x: x.cpu() if torch.is_tensor(x) else x  # noqa: E731
    rec = {k: {kk: (tuple(cpu(a) for a in vv) if isinstance(vv, tuple)
                    else cpu(vv)) for kk, vv in v.items()}
           for k, v in rec.items()}
    rec["coords"] = {"paged": dict(m.coords), "twod": dict(m2.coords)}
    path = os.path.join(record_dir, f"islands-rank{env.rank}.pt")
    torch.save(rec, path)
    return {"rank": env.rank, "ms": ms, "record": path,
            "launches": {k: w.launches for k, w in counters.items()}}


def run_jobs(env, jobs) -> list:
    """Every job of ``jobs`` in turn on this rank (run by :func:`spawn`):
    one process group, each job with its own mesh."""
    return [job.run(env) for job in jobs]


def run_mesh_jobs(jobs, *, backend: str, device: str,
                  timeout_s: float) -> list[list]:
    """Spawn the ranks once and run ``jobs`` (:class:`MeshJob` /
    :class:`IslandJob`, all of one world size) in turn; returns each
    job's results by rank.  One spawn saves each later job the ranks'
    start (an interpreter, torch, a CUDA context each)."""
    worlds = {job.world_size for job in jobs}
    if len(worlds) != 1:
        raise ValueError(f"jobs of one spawn need one world size, got "
                         f"{sorted(worlds)}")
    res = spawn(run_jobs, world_size=worlds.pop(), backend=backend,
                device=device, timeout_s=timeout_s, args=(tuple(jobs),))
    return [[r[j] for r in res] for j in range(len(jobs))]


def make_job(arch: str, shape, *, model: int, seq: int = 1, data: int = 1,
             layers: int | None = None, batch: int | None = None,
             seed: int = 0, steps: int = 4, kv_dtype: str | None = None,
             smoke: bool = False, dtype: str | None = None,
             budget: int | None = None, force_rows: bool = False,
             record_layer: int | None = None, record_dir: str | None = None,
             return_logits: bool = False) -> MeshJob:
    """The :class:`MeshJob` of :func:`run_on_mesh`'s arguments."""
    shapes = shape if isinstance(shape, (list, tuple)) else (shape,)
    shapes = tuple(SHAPES[s] if isinstance(s, str) else s for s in shapes)
    return MeshJob(arch, shapes, model, seq, data, layers, batch, seed,
                   steps, kv_dtype, smoke, dtype, budget, force_rows,
                   record_layer, record_dir, return_logits)


def run_on_mesh(arch: str, shape, *, backend: str = "nccl",
                device: str = "cuda", timeout_s: float = 600.0,
                **kw) -> list[dict]:
    """Spawn ``data * model * seq`` ranks and run ``arch`` at ``shape`` (a
    name of :data:`repro_torch.configs.SHAPES`, a :class:`ShapeSpec`, or
    a sequence of them, run in turn by the same ranks) on the mesh
    (``kw``: :func:`make_job`'s ``model``, ``seq``, ``data``, ...).

    A prefill shape runs the sparse prefill of ``batch`` (default the
    shape's) seeded prompts and ``steps`` greedy decode steps after it; a
    decode shape runs ``steps`` greedy steps over a seeded cache, ending at
    position ``seq_len - 1``.  ``layers`` keeps the first layers,
    ``smoke`` takes the SMOKE config, ``dtype`` retypes it ("float32"),
    ``budget`` replaces ``SERVE_BUDGET_PER_HEAD``.  With ``record_layer``
    each rank saves that layer's first island call (inputs and output)
    under ``record_dir``.  Build the CUDA kernels before calling.

    Returns each rank's result, by rank: its coordinates and, per shape,
    the greedy tokens, the list mode and decode branch, kernel launches,
    island milliseconds (each call), wall seconds and (rank 0) the plan's
    ``device_loads`` and mean imbalance."""
    return run_mesh_jobs([make_job(arch, shape, **kw)], backend=backend,
                         device=device, timeout_s=timeout_s)[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Run the S-HPLB prefill and sparse decode steps of an "
                    "arch on a mesh of ranks.")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True, action="append",
                    help=f"one of {sorted(SHAPES)}; repeat to run several")
    ap.add_argument("--model", type=int, required=True)
    ap.add_argument("--seq", type=int, default=1)
    ap.add_argument("--data", type=int, default=1)
    ap.add_argument("--layers", type=int)
    ap.add_argument("--batch", type=int)
    ap.add_argument("--seq-len", type=int,
                    help="cut every shape's sequence to this length")
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--kv-dtype", choices=("bf16", "int8", "fp8"))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--backend", choices=("gloo", "nccl"), default="nccl")
    ap.add_argument("--device", default="cuda",
                    help="cuda (a card a rank), cuda:K (every rank on "
                         "card K; gloo only) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--timeout", type=float, default=900.0)
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda":
        from repro_torch.kernels import build
        build.build()
    shapes = [SHAPES[s] for s in args.shape]
    if args.seq_len:
        shapes = [dataclasses.replace(s, seq_len=args.seq_len)
                  for s in shapes]
    t0 = time.perf_counter()
    ranks = run_on_mesh(
        args.arch, shapes, model=args.model, seq=args.seq,
        data=args.data, layers=args.layers, batch=args.batch,
        backend=args.backend, device=args.device, seed=args.seed,
        steps=args.steps, kv_dtype=args.kv_dtype, smoke=args.smoke,
        timeout_s=args.timeout)
    print(f"{args.arch} on data={args.data} x model={args.model} x "
          f"seq={args.seq} ({args.backend}, {args.device}): "
          f"{time.perf_counter() - t0:.1f} s")
    for i, run0 in enumerate(ranks[0]["runs"]):
        loads = np.asarray(run0["device_loads"])
        print(f"{run0['shape']}: mode {run0['mode']}, decode branch "
              f"{run0['branch']}; plan device_loads (layer 0) "
              f"{loads[0].tolist()}, mean imbalance {run0['imbalance']:.4f}")
        for r in ranks:
            run = r["runs"][i]
            print(f"  rank {r['rank']} {r['coords']}: prefill island "
                  f"{sum(run.get('prefill_island_ms', [0.0])):.3f} ms, "
                  f"decode island {sum(run['decode_island_ms']):.3f} ms, "
                  f"launches {json.dumps(run['launches'])}")
        print(f"  greedy tokens: {run0['tokens']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
