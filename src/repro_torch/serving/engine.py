"""S-HPLB serving engine: plan-driven sparse chunked prefill + budgeted
decode over a paged KV pool or a contiguous slot cache, with continuous
batching.

The subset of the reference's ``serving/engine.py`` that the port runs:
sparse attention planned by S-HPLB (per-head budgets + head permutation),
chunked prefill whose per-chunk work lists are slices of the prompt
bucket's lists, and decode over either cost-packed work lists padded to pow2
item buckets (``decode_worklist="packed"``, the default) or the padded
per-slot block-id grid (``"padded"``, the step-invariant baseline).  The
paper's baselines run too: ``attention="dense"`` (no plan; dense chunks
through the sparse prefill kernel on a dense causal work list, monolithic
prefill through the dense flash attention kernel, both windowed on a
sliding-window layer, decode over every resident block),
``prefill_mode="monolithic"``
(whole prompts at admission) and ``prefill_buckets="exact"`` (the prompt's
own length as its bucket).  Sampling is greedy or stochastic (temperature,
top-k, top-p) from one ``torch.Generator`` on the device, seeded by
``EngineConfig.seed``.  The
KV cache is the paged pool (``cache_layout="paged"``, the default) or the
contiguous slot cache (``"contiguous"``, the parity baseline: chunks build
in a one-sequence staging cache merged into the slot row at the final
chunk).  The cache holds bf16 (the model dtype) or, with ``kv_dtype``
"int8" / "fp8", quantized codes with one float32 scale per (block, kv
head) tile, which the attention kernels apply after their dots.  Host
planning is numpy; device state (permuted params, cache) lives on
``device``, which defaults to CUDA.

``num_model_shards`` = D is the head-parallel degree, emulated on one
device as the reference does: the plan places KV groups on D shards, the
packed decode table is the D shards' lists end to end (``[L, D*bucket]``,
pads between them), and ``decode_bubble_stats`` reads the grid's padding
and the shards' imbalance.  D must divide the KV heads (``kv_group``
placement).

The plan is epoch-versioned (§2.9), as the reference's: every
``telemetry_every`` decode ticks a probe (``tfm.decode_telemetry``) reads
the pre-step resident cache and folds each head's realized recovery into an
:class:`OnlineSparsityEstimator`; ``replan_every`` forces, and drift of the
online profile against the plan's basis past ``drift_threshold`` triggers,
a replan at a scheduler safe point (no prefill in flight).  A swap applies
the plan delta to the attention weights and gathers the resident cache's
kv-head axis once, bumps ``epoch`` and purges the plan-dependent memos.

Under overload (§2.10) requests carry priority classes; ``admission="slo"``
defers and sheds by class, and ``preemption`` swaps a decoding victim's KV
(its pool blocks, paged; its slot rows, contiguous; codes and scales
together) to a pinned host tier and back (:meth:`Engine._swap_out_seq` /
:meth:`Engine._swap_in_seq`).  A host copy taken under an earlier plan
epoch is re-arranged once at swap-in against the cumulative kv-head
arrangement.

Sequence stripes (§2.11, ``seq_shards`` = S, paged only): the pool's
blocks split into S stripes of contiguous ids, growth goes to the stripe
with the most free blocks, and decode runs one partial pass of the paged
decode kernel a stripe, merged by the flash-decoding combine: the packed
grid packs each (slot, kv head) run's per-stripe sub-runs onto (shard,
stripe) cells (:func:`~repro_torch.core.worklist.pack_decode_items_2d`),
the padded grid and dense decode mask the table to each stripe's blocks.
The radix prefix cache (§2.14, ``prefix_cache``, paged only) maps the
longest cached whole-block prefix of an admitted prompt by refcount and
starts its prefill at the first block that differs; the tree outlives a
``serve`` call, drains under pool pressure before preemption, and is
flushed at an epoch swap.  A swapped-out hit keeps its shared prefix
resident and moves only its private tail.

Faults and self-healing (§2.13): ``Engine(..., injector=)`` takes a
:class:`~repro_torch.serving.faults.FaultInjector` whose six seams fire at
the reference's points (swap transfers, admission growth, KV corruption
before a decode step, the epoch swap, a prefill's logits), each guarded by
``injector.enabled``, so an engine without one runs exactly as before.
``sentinels`` (default on) checks every sampled row's logits for
non-finite values on the device and brings the flags back in the same
copy as the tokens; a flagged slot is quarantined (``take_quarantine``)
and the scheduler fails only that request, whose blocks
:meth:`Engine._release_seq` scrubs (codes 0, scales 1) before they free:
the plain versions (and the bf16 prefill kernel's P.V over a whole tile)
multiply a masked key's zero weight into its value row, so a stale NaN in
a recycled block would poison its next tenant.  The
probe's health bit quarantines too (``probe_nonfinite``).  Swap transfers
retry ``swap_retries`` times (``swap_backoff_s`` doubling), then the
scheduler discards and requeues the victim; ``audit`` checks the allocator,
the pool's shapes, the host tier and the prefix tree every
``audit_every`` decode ticks and at swap and replan boundaries; an epoch
swap builds its permuted weights and gathered pool before it commits any,
so a failed one leaves the old epoch serving (``replan_rollbacks``);
``checkpoint_dir`` / ``checkpoint_every`` write crash-consistent snapshots
(:mod:`repro_torch.serving.snapshot`) at safe points.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from collections import OrderedDict

import numpy as np
import torch

from repro_torch.attention.policies import policy_by_name
from repro_torch.configs import TransformerConfig
from repro_torch.core import quant
from repro_torch.core.planner import (
    HPLBPlan, make_plan, permute_attention_params, plan_delta, plans_equal)
from repro_torch.core.sparsity import (
    HeadSparsityProfile, OnlineSparsityEstimator)
from repro_torch.core.worklist import (
    DEC_FIELDS, WorkList, blocks_for_budget, chunk_item_counts, chunk_items,
    extend_packed_items, pack_decode_items, pack_decode_items_2d,
    pow2_bucket, worklist_from_budgets)
from repro_torch.models import transformer as tfm
from repro_torch.serving.faults import (
    EpochSwapError, FaultInjector, IntegrityError, TransferError)
from repro_torch.serving.kv_cache import PagedKVCache
from repro_torch.serving.prefix_tree import RadixPrefixCache
from repro_torch.serving.sampler import SamplingParams, sample
from repro_torch.serving.scheduler import (
    DEFAULT_CLASSES, ContinuousBatcher, Request)

log = logging.getLogger(__name__)


@dataclasses.dataclass
class EngineConfig:
    attention: str = "sparse"        # "sparse" (S-HPLB) | "dense"
    policy: str = "strided"          # static selection policy
    budget_per_head: int = 512       # k — the uniform-equivalent budget
    block: int = 128
    floor: int = 128
    allocator: str = "maxmin"        # paper | "uniform" (top-k baseline)
    partitioner: str = "best"        # "best" | "lpt" (paper) | "naive"
    num_model_shards: int = 1        # HP degree for planning
    max_seq_len: int = 4096
    num_slots: int = 8
    # prefill bucket policy: "pow2" pads prompts up to the next power of
    # two; "exact" takes each prompt's own length (its work lists too)
    prefill_buckets: str = "pow2"
    # chunked prefill (Sarathi-style mixed ticks): each scheduler tick runs
    # at most one prefill chunk of <= prefill_chunk_tokens alongside the
    # full decode batch, so admissions never stall decodes.  "monolithic"
    # prefills whole prompts at admission (the benchmark baseline).
    prefill_mode: str = "chunked"    # "chunked" | "monolithic"
    prefill_chunk_tokens: int = 256  # per-tick token budget (chunk cap)
    cache_layout: str = "paged"
    num_kv_blocks: int | None = None  # None = num_slots * max_seq / block
    kv_dtype: str = "bf16"
    decode_worklist: str = "packed"
    seed: int = 0                    # the sampling generator's seed
    # plan epochs: every N decode ticks one recovery probe folds into the
    # online estimator (0 = telemetry off); replan every N decode ticks,
    # and / or when the online profile's drift against the plan's basis
    # reaches the threshold (drift needs telemetry).  Both None = the plan
    # stays frozen.  Swaps happen only at scheduler safe points
    telemetry_every: int = 0
    replan_every: int | None = None
    drift_threshold: float | None = None
    # admission policy: "fifo" (class-blind arrival order — the baseline)
    # or "slo" (class-level order + cost-model deferral + deadline shed).
    admission: str = "fifo"
    # allow preemption of strictly-lower-priority work when a request
    # cannot be placed: decoding victims swap their mapped KV blocks to a
    # pinned-host tier and resume later bitwise-identically; mid-prefill
    # victims are discarded back to their queue head.
    preemption: bool = False
    # host swap-tier capacity in blocks (None = unbounded).
    host_swap_blocks: int | None = None
    # sequence stripes (paged only): the pool splits into seq_shards
    # stripes of contiguous block ids; decode runs one partial pass a
    # stripe and merges (out, m, l).  1 = the unstriped path
    seq_shards: int = 1
    # radix prefix cache (paged only): admission maps the longest cached
    # whole-block prefix by refcount and prefills from the divergence;
    # unreferenced cached blocks evict (LRU) before preemption
    prefix_cache: bool = False
    # -- faults (§2.13) ----------------------------------------------------
    # per-step numerical sentinels: every sampled row's logits are checked
    # for NaN / Inf on the device, the flags riding the tokens' copy; a
    # flagged sequence alone is quarantined
    sentinels: bool = True
    # host swap transfers retry this many times, the backoff doubling from
    # swap_backoff_s (0 = no sleep), before the scheduler discards the
    # victim and requeues it
    swap_retries: int = 3
    swap_backoff_s: float = 0.0
    # invariant audits every N decode ticks, plus swap and replan
    # boundaries; 0 = off.  A violation raises IntegrityError
    audit_every: int = 0
    # crash-consistent snapshots every N decode ticks at a safe point into
    # checkpoint_dir; None / 0 = off
    checkpoint_dir: str | None = None
    checkpoint_every: int = 0

    def check_supported(self) -> None:
        """Raise ``NotImplementedError`` for option values the port does
        not run, ``ValueError`` for a ``seq_shards`` below 1."""
        ported = {"attention": ("sparse", "dense"),
                  "prefill_buckets": ("pow2", "exact"),
                  "prefill_mode": ("chunked", "monolithic"),
                  "cache_layout": ("paged", "contiguous"),
                  "kv_dtype": ("bf16", "int8", "fp8"),
                  "decode_worklist": ("packed", "padded"),
                  "admission": ("fifo", "slo"),
                  "preemption": (False, True),
                  "prefix_cache": (False, True)}
        for name, values in ported.items():
            got = getattr(self, name)
            if got not in values:
                raise NotImplementedError(
                    f"EngineConfig.{name}={got!r} is not ported yet "
                    f"(the port runs {name} in {values!r})")
        if int(self.seq_shards) != self.seq_shards or self.seq_shards < 1:
            raise ValueError(f"seq_shards must be an integer >= 1, got "
                             f"{self.seq_shards!r}")


class Engine:
    """Single-model serving engine for the dense GQA transformer.

    ``device`` holds the params and the KV pool; it defaults to CUDA and
    the engine raises when CUDA is absent.  Pass ``device="cpu"`` to run
    every kernel's plain PyTorch version instead.  ``profile`` is required
    for sparse attention; dense attention plans nothing.  ``injector``
    arms the fault seams (None: none fires).
    """

    def __init__(self, cfg: TransformerConfig, params: dict,
                 engine_cfg: EngineConfig,
                 profile: HeadSparsityProfile | None,
                 device: str | torch.device = "cuda",
                 injector: FaultInjector | None = None):
        engine_cfg.check_supported()
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Engine device is CUDA but no CUDA device is "
                               "available; pass device='cpu' explicitly to "
                               "run the plain PyTorch kernels")
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {self.device}")
        ecfg = engine_cfg
        self.sparse = ecfg.attention == "sparse"
        if self.sparse and profile is None:
            raise ValueError("sparse attention needs a sparsity profile")
        if ecfg.max_seq_len % ecfg.block:
            raise ValueError("chunked prefill needs max_seq_len % block "
                             "== 0")
        # attention tiles must match the work-list granularity: items
        # address tiles in units of engine_cfg.block
        if cfg.block_q != ecfg.block or cfg.block_kv != ecfg.block:
            cfg = dataclasses.replace(cfg, block_q=ecfg.block,
                                      block_kv=ecfg.block)
        self.cfg = cfg
        self.ecfg = ecfg
        # faults: every seam guards on ``injector is None or not
        # injector.enabled`` before touching anything
        self.injector = injector
        # slots the sentinels flagged this step, drained by the scheduler
        # (sentinel_fn) right after the step returns
        self._quarantine: dict[int, str] = {}
        self.fault_stats = {
            "sentinel_trips": 0,       # slots quarantined by sentinels
            "swap_faults": 0,          # transfer attempts that faulted
            "swap_retries": 0,         # retry attempts issued
            "swap_recoveries": 0,      # transfers healed by a retry
            "swap_giveups": 0,         # retries exhausted -> TransferError
            "audits": 0,               # invariant audits run (all passed)
            "replan_rollbacks": 0,     # epoch swaps rolled back
            "corruptions_injected": 0,  # kv_corrupt seam firings
            "checkpoints": 0,          # snapshots written
        }
        self._last_audit_activity = -1  # forces an audit on the first tick
        if self.sparse and cfg.num_kv_heads % ecfg.num_model_shards:
            raise NotImplementedError(
                f"EngineConfig.num_model_shards={ecfg.num_model_shards} is "
                f"not ported for {cfg.num_kv_heads} KV heads: it needs the "
                f"kv_replication placement, which permutes q heads freely, "
                f"while the one-device attention pairs q slot s with kv "
                f"head s // G (the port runs degrees that divide the KV "
                f"heads here; kv_replication runs on a mesh of ranks: "
                f"repro_torch.launch.steps)")
        # dense attention has no plan and keeps the heads in place
        self.plan: HPLBPlan | None = None
        # the offline profile, and the one the live plan was derived from
        # (the drift reference: after a swap drift is measured against the
        # new plan's basis, so a one-time shift does not re-trigger)
        self.profile = self._plan_profile = profile
        self.epoch = 0
        self.telemetry: OnlineSparsityEstimator | None = None
        if self.sparse:
            self.plan = make_plan(
                profile, num_devices=ecfg.num_model_shards,
                num_kv_heads=cfg.num_kv_heads, seq_len=ecfg.max_seq_len,
                total_budget_per_head=ecfg.budget_per_head,
                block=ecfg.block, floor=ecfg.floor,
                allocator=ecfg.allocator, partitioner=ecfg.partitioner,
                epoch=0)
            self.telemetry = OnlineSparsityEstimator(cfg.num_layers,
                                                     cfg.num_heads)
        self.params = self._permute_params(params)
        self.paged = ecfg.cache_layout == "paged"
        if not self.paged and (ecfg.seq_shards > 1 or ecfg.prefix_cache):
            raise ValueError(
                "seq_shards > 1 and prefix_cache need cache_layout='paged' "
                "(stripes own ranges of the block pool; sharing aliases "
                "pool blocks in block tables)")
        # the radix prefix cache: built once by make_batcher (it outlives a
        # serve call); None = sharing off
        self.prefix: RadixPrefixCache | None = None
        # quantized KV: codes in kv_cache_dtype with per-(block, kv head)
        # scales beside them; "bf16" has no scales tensor at all
        self.quantized = quant.is_quantized(ecfg.kv_dtype)
        kv_store = quant.kv_cache_dtype(ecfg.kv_dtype)
        self.cache_scales = None
        if self.paged:
            nblocks = (ecfg.num_kv_blocks
                       or ecfg.num_slots * (ecfg.max_seq_len // ecfg.block))
            # stripes tile the pool exactly: round the usable block count
            # UP to a seq_shards multiple (capacity is an admission
            # guarantee, so never down)
            nblocks = -(-nblocks // ecfg.seq_shards) * ecfg.seq_shards
            self.kv = PagedKVCache(
                lambda n: tfm.init_paged_cache(cfg, n, ecfg.block,
                                               device=self.device,
                                               dtype=kv_store),
                num_blocks=nblocks, block=ecfg.block,
                table_width=ecfg.max_seq_len // ecfg.block,
                make_scales_fn=((lambda n: tfm.init_paged_scales(
                    cfg, n, device=self.device)) if self.quantized
                    else None),
                host_blocks=ecfg.host_swap_blocks, stripes=ecfg.seq_shards)
            # the allocator fires the admission_alloc seam inside _grow
            self.kv.alloc.injector = injector
        else:
            # every slot reserves a max_seq_len row; chunks build in a
            # one-sequence staging cache (the scheduler prefills one
            # sequence at a time), so decode never sees a mid-prefill row.
            # Quantized: the staging row stays full precision and is
            # quantized once, on its copy into the slot
            self.kv = None
            if self.quantized and ecfg.block != cfg.block_kv:
                raise ValueError("a quantized slot cache needs the engine "
                                 "block == the model's block_kv (one scale "
                                 "grid)")
            self.cache = tfm.init_cache(cfg, ecfg.num_slots,
                                        ecfg.max_seq_len, device=self.device,
                                        dtype=kv_store)
            if self.quantized:
                self.cache_scales = tfm.init_cache_scales(
                    cfg, ecfg.num_slots, ecfg.max_seq_len, ecfg.block,
                    device=self.device)
            self._staging = tfm.init_cache(cfg, 1, ecfg.max_seq_len,
                                           device=self.device)
        # byte-true packing weight: the K+V bytes one selected block
        # streams at decode (codes plus their amortized scales)
        self._kv_block_bytes = (
            2.0 * ecfg.block * cfg.head_dim_
            * quant.kv_dtype_bytes(ecfg.kv_dtype, block=ecfg.block,
                                   head_dim=cfg.head_dim_))
        self._batcher: ContinuousBatcher | None = None
        # host planning memos (all derive from the live plan epoch and are
        # purged at a swap, _purge_plan_memos): prompt-bucket work lists,
        # chunk slices and their item caps, decode selections per resident
        # block count, and an LRU of packed decode plans keyed by the
        # per-slot block counts and, with stripes or sharing, the block
        # placement (_plan_key)
        self._worklists_cache: dict[int, list[WorkList]] = {}
        self._prefill_items_cache: dict[int, list[torch.Tensor]] = {}
        self._chunk_cap: dict[int, int] = {}
        self._chunk_wl_cache: dict[tuple, torch.Tensor] = {}
        self._decode_ids_by_nblocks: dict[int, np.ndarray] = {}
        self._nb_cap: int | None = None
        self._packed_plan_cache: OrderedDict = OrderedDict()
        self._packed_plan_cap = 256
        # per-tick decode bubble telemetry, read by decode_bubble_stats
        self.decode_stats = {"ticks": 0, "real_items": 0, "grid_items": 0,
                             "padded_grid_items": 0, "imbalance_sum": 0.0,
                             "head_imb_sum": 0.0, "stripe_imb_sum": 0.0,
                             "merge_collectives": 0,
                             "plan_hits": 0, "plan_misses": 0,
                             "plan_prefetches": 0, "last": {}}
        # the stochastic sampler's generator (the reference's PRNGKey(0))
        self.rng = torch.Generator(device=self.device).manual_seed(ecfg.seed)
        # plan-epoch state: decode ticks, ticks since the last replan, the
        # per-epoch stats and the memoized drift reading
        self._decode_ticks = 0
        self._ticks_since_replan = 0
        self._epoch_stats: dict[int, dict] = {0: self._fresh_epoch_stats()}
        self._last_drift: tuple | None = None
        self.replans = 0
        # the preemption swap tier (§2.10): host copies of swapped-out
        # sequences' KV, keyed by rid, and the transfers whose pinned
        # buffers must outlive their copies.  _kv_arrange is the CUMULATIVE
        # kv-head arrangement of the resident cache across plan epochs
        # (arrange[l, h] = original kv head living in slot h), so a host
        # copy taken under one epoch is re-arranged EXACTLY ONCE at
        # swap-in, however many epoch swaps passed
        self._host_swaps: dict[int, dict] = {}
        self._swap_in_flight: list[tuple] = []
        self._kv_arrange = np.tile(np.arange(cfg.num_kv_heads),
                                   (cfg.num_layers, 1))
        self.swap_stats = {"swapped_out": 0, "swapped_in": 0,
                           "blocks_out": 0, "blocks_in": 0,
                           "bytes_out": 0, "bytes_in": 0,
                           "epoch_remaps": 0}

    # -- offline artifacts -------------------------------------------------
    @staticmethod
    def _fresh_epoch_stats() -> dict:
        return {"ticks": 0, "telemetry_samples": 0, "recovery_sum": 0.0,
                "recovery_ticks": 0, "drift": None}

    def _permute_params(self, params: dict, layer_plans=None) -> dict:
        """Apply a head permutation to every layer's attention projections
        (a new params dict on the device; the input is not modified): the
        plan's (engine init), or ``layer_plans``, an epoch swap's
        :class:`~repro_torch.core.planner.PlanDelta` layers applied to the
        already-permuted weights.  Without a plan (dense) the heads stay in
        place."""
        cfg = self.cfg
        to = lambda t: t.to(self.device).contiguous()    # noqa: E731
        if layer_plans is None and self.plan is not None:
            layer_plans = self.plan.layers
        layers = []
        for l, lp in enumerate(params["layers"]):
            ap = lp["attn"]
            wq, wk, wv, wo = ap["wq"], ap["wk"], ap["wv"], ap["wo"]
            if layer_plans is not None:
                wq, wk, wv, wo = permute_attention_params(
                    wq, wk, wv, wo, layer_plans[l], cfg.head_dim_,
                    cfg.group_size,
                    kv_replicated=self.plan.mode == "kv_replication")
            ffn = "moe" if cfg.moe is not None else "mlp"
            layers.append({
                "attn": {"wq": to(wq), "wk": to(wk), "wv": to(wv),
                         "wo": to(wo)},
                "ln1": to(lp["ln1"]), "ln2": to(lp["ln2"]),
                ffn: {k: to(v) for k, v in lp[ffn].items()}})
        out = {k: to(v) for k, v in params.items() if k != "layers"}
        out["layers"] = layers
        return out

    def worklists_for(self, seq_len: int) -> list[WorkList]:
        """Per-layer work lists for a prefill of ``seq_len``, memoized by
        the prompt's pow2 bucket.

        One list on global ids: every item names its slot head and its kv
        head.  At D shards this is, item for item, the shards' lists in
        shard order with shard d's head ids offset by d*H/D and its kv head
        ids by d*Hkv/D (a ``kv_group`` shard holds slots [d*H/D,
        (d+1)*H/D) and their KV groups, and the policy takes the global
        slot).  The reference's single-host engine concatenates the shard
        lists with their device-local ids instead, so at D > 1 its items
        address only the first shard's heads (``ROADMAP.md`` §3)."""
        bucket = self._prefill_bucket(seq_len)
        got = self._worklists_cache.get(bucket)
        if got is None:
            pol = policy_by_name(self.ecfg.policy)
            got = [worklist_from_budgets(
                self.plan.layers[l].budgets, num_devices=1, seq_len=bucket,
                block=self.ecfg.block, policy_fn=pol,
                group_size=self.cfg.group_size)
                for l in range(self.cfg.num_layers)]
            self._worklists_cache[bucket] = got
        return got

    def decode_block_ids(self, cache_len: int,
                         nb_pad: int | None = None) -> np.ndarray:
        """``[L, Hkv, nb]`` selected decode blocks (-1 pad): per kv head the
        max budget of its q heads; the newest block always, plus the sink
        and the most recent blocks within budget."""
        cfg = self.cfg
        nkv_blocks = -(-cache_len // self.ecfg.block)
        per_layer = []
        nb_max = 1
        for l in range(cfg.num_layers):
            budgets = self.plan.layers[l].budgets.reshape(
                cfg.num_kv_heads, cfg.group_size).max(axis=1)
            nb = np.minimum(blocks_for_budget(budgets, self.ecfg.block),
                            nkv_blocks)
            nb_max = max(nb_max, int(nb.max()))
            per_layer.append(nb)
        width = nb_max if nb_pad is None else nb_pad
        ids = np.full((cfg.num_layers, cfg.num_kv_heads, width), -1,
                      np.int32)
        for l, nb in enumerate(per_layer):
            for h in range(cfg.num_kv_heads):
                n = min(int(nb[h]), width)
                recent = range(max(0, nkv_blocks - max(1, n - 1)), nkv_blocks)
                sel = sorted(set(([0] if n > 1 else []) + list(recent)))[:n]
                ids[l, h, :len(sel)] = sel
        return ids

    def _decode_ids_for_nblocks(self, nblocks: int) -> np.ndarray:
        """Memoized selection for a slot holding ``nblocks`` blocks, padded
        to the plan's max-budget width."""
        if self._nb_cap is None:
            self._nb_cap = self.decode_block_ids(
                self.ecfg.max_seq_len).shape[-1]
        nblocks = max(1, min(nblocks,
                             self.ecfg.max_seq_len // self.ecfg.block))
        got = self._decode_ids_by_nblocks.get(nblocks)
        if got is None:
            got = self.decode_block_ids(nblocks * self.ecfg.block,
                                        nb_pad=self._nb_cap)
            self._decode_ids_by_nblocks[nblocks] = got
        return got

    # -- cost-packed decode work lists -------------------------------------
    def _nb_sig(self, pos_all: np.ndarray) -> tuple[int, ...]:
        """Per-slot resident block counts — the packed-plan cache key."""
        blk = self.ecfg.block
        cap = self.ecfg.max_seq_len // blk
        return tuple(max(1, min(-(-(int(p) + 1) // blk), cap))
                     for p in pos_all)

    def _packed_item_cap(self) -> int:
        """Worst-case packed item count of one layer, rounded up to the
        packer's pad multiple of 8."""
        cap = self.ecfg.num_slots * self.cfg.num_kv_heads * self._nb_cap
        return -(-cap // 8) * 8

    def _build_packed_plan(self, nb_sig: tuple[int, ...],
                           phys_of_block: np.ndarray | None = None):
        """One tick's decode work: per layer, every slot's selection packed
        into (row, kv_head, kv_block) runs and best-partitioned across the
        model shards, all layers padded onto one pow2 item bucket a shard.
        ``phys_of_block`` (``[B, T]`` block tables, prefix sharing on)
        charges a shared pool block once per kv head however many rows
        alias it.  Returns ``(items [L, D*bucket, DEC_FIELDS] on device,
        stats)``: the tick's bubble telemetry, as the reference computes
        it."""
        cfg, ecfg = self.cfg, self.ecfg
        per_slot = [self._decode_ids_for_nblocks(nb) for nb in nb_sig]
        bids = np.stack(per_slot, axis=1)       # [L, B, Hkv, nb_cap]
        wls = [pack_decode_items(bids[l], num_shards=ecfg.num_model_shards,
                                 block=ecfg.block,
                                 bytes_per_block=self._kv_block_bytes,
                                 phys_of_block=phys_of_block)
               for l in range(cfg.num_layers)]
        bucket = pow2_bucket(max(wl.padded_length for wl in wls),
                             lo=8, hi=self._packed_item_cap())
        items = np.stack([
            extend_packed_items(wl.items, bucket).reshape(-1, DEC_FIELDS)
            for wl in wls])
        real = sum(wl.total_real_items for wl in wls)
        grid = cfg.num_layers * ecfg.num_model_shards * bucket
        # the padded baseline's grid: every (slot, kv head) at the
        # max-budget selection width, every layer
        padded_grid = int(bids.size)
        stats = {
            "epoch": self.epoch,
            "bucket": bucket,
            "real_items": real,
            "grid_items": grid,
            "padded_grid_items": padded_grid,
            "padding_waste": 1.0 - real / grid if grid else 0.0,
            "padded_path_waste": (1.0 - real / padded_grid
                                  if padded_grid else 0.0),
            "imbalance": float(np.mean([wl.imbalance for wl in wls])),
        }
        return torch.from_numpy(items).to(self.device), stats

    def _stripe_of_table(self, table: np.ndarray) -> np.ndarray:
        """``[B, T]`` owning stripe of each LOGICAL block position (-1 for
        unmapped): stripe membership is a property of the physical id."""
        t = np.asarray(table)
        return np.where(t >= 0, t // self.kv.stripe_size, -1).astype(np.int32)

    def _build_packed_plan_2d(self, nb_sig: tuple[int, ...],
                              stripe_of: np.ndarray,
                              phys_of_block: np.ndarray | None = None):
        """The striped twin of :meth:`_build_packed_plan`: each (slot, kv
        head) run splits into per-stripe sub-runs (the stripe is fixed by
        where the block lives), ``best_partition_2d`` picks model shards to
        minimize the largest (shard, stripe) cell, and every cell pads onto
        one pow2 bucket.  Returns ``(items [L, S, D*bucket, DEC_FIELDS] on
        device, stats)``: axis 1 is the stripe axis the decode step runs
        one pass over each of."""
        cfg, ecfg = self.cfg, self.ecfg
        S, Dm = ecfg.seq_shards, ecfg.num_model_shards
        per_slot = [self._decode_ids_for_nblocks(nb) for nb in nb_sig]
        bids = np.stack(per_slot, axis=1)       # [L, B, Hkv, nb_cap]
        wls = [pack_decode_items_2d(bids[l], stripe_of, num_stripes=S,
                                    num_shards=Dm, block=ecfg.block,
                                    bytes_per_block=self._kv_block_bytes,
                                    phys_of_block=phys_of_block)
               for l in range(cfg.num_layers)]
        bucket = pow2_bucket(max(wl.padded_length for wl in wls),
                             lo=8, hi=self._packed_item_cap())

        def flat(wl):
            # [Dm, S, Lp, F] -> each cell padded to the bucket -> [S,
            # Dm*bucket, F]: stripe s's pass runs its shards' lists end to
            # end, as the unstriped grid does
            ext = extend_packed_items(
                wl.items.reshape(Dm * S, wl.padded_length, DEC_FIELDS),
                bucket)
            return np.swapaxes(ext.reshape(Dm, S, bucket, DEC_FIELDS),
                               0, 1).reshape(S, Dm * bucket, DEC_FIELDS)

        items = np.ascontiguousarray(np.stack([flat(wl) for wl in wls]))
        real = sum(wl.total_real_items for wl in wls)
        grid = cfg.num_layers * Dm * S * bucket
        padded_grid = int(bids.size)
        stats = {
            "epoch": self.epoch,
            "bucket": bucket,
            "real_items": real,
            "grid_items": grid,
            "padded_grid_items": padded_grid,
            "padding_waste": 1.0 - real / grid if grid else 0.0,
            "padded_path_waste": (1.0 - real / padded_grid
                                  if padded_grid else 0.0),
            "imbalance": float(np.mean([wl.imbalance for wl in wls])),
            "model_imbalance": float(np.mean(
                [wl.model_imbalance for wl in wls])),
            "stripe_imbalance": float(np.mean(
                [wl.stripe_imbalance for wl in wls])),
        }
        return torch.from_numpy(items).to(self.device), stats

    def _share_sig(self, table: np.ndarray | None):
        """Sharing signature of a tick's block tables: per slot row, the
        (logical index, physical id) pairs of blocks held more than once.
        Only these change the packer's charge-once weights, so keying plans
        on them (not the whole tables) keeps the memo hitting across id
        churn.  None when sharing is off."""
        if table is None or self.prefix is None:
            return None
        tab = np.asarray(table)
        if self.kv.alloc.shared_block_count == 0:
            # nothing is multiply held: every row's signature is empty
            return ((),) * tab.shape[0]
        rc = self.kv.alloc.refcount
        return tuple(tuple((i, b) for i, b in enumerate(row)
                           if b >= 0 and rc(b) >= 2)
                     for row in tab.tolist())

    def _plan_key(self, nb_sig: tuple[int, ...],
                  stripe_of: np.ndarray | None, share_sig=None) -> tuple:
        """The reference's plan memo key without its epoch (the memo is
        purged at an epoch swap): (block counts[, stripe placement][,
        sharing signature]).  A striped plan is valid only for the
        placement it was packed against (a swap-in maps other ids), and the
        sharing signature does the same for the charge-once weights."""
        key = ((nb_sig,) if stripe_of is None
               else (nb_sig, tuple(map(tuple, stripe_of.tolist()))))
        if share_sig is not None:
            key += (share_sig,)
        return key

    def _tick_table(self, slots) -> np.ndarray:
        """``[num_slots, T]`` int32 block tables of ``slots``; -1 rows for
        unbound slots, whose writes go to the trash block."""
        tbl = np.full((self.ecfg.num_slots, self.kv.table_width), -1,
                      np.int32)
        for s in slots:
            tbl[s] = self._table_for_slot(s)
        return tbl

    def _padded_tick_stats(self, bids: np.ndarray) -> dict:
        """Bubble telemetry of a padded-path tick: real vs padded grid
        items, and the (slot, kv head) run imbalance the packing removes."""
        real = int((bids >= 0).sum())
        grid = int(bids.size)
        counts = (bids >= 0).sum(axis=-1).astype(np.float64)  # [L, B, Hkv]
        mean = counts.mean() if counts.size else 0.0
        return {
            "epoch": self.epoch,
            "bucket": int(bids.shape[-1]),
            "real_items": real,
            "grid_items": grid,
            "padded_grid_items": grid,
            "padding_waste": 1.0 - real / grid if grid else 0.0,
            "padded_path_waste": 1.0 - real / grid if grid else 0.0,
            "imbalance": float(counts.max() / mean) if mean > 0 else 1.0,
        }

    def _plan_for(self, nb_sig: tuple[int, ...],
                  stripe_of: np.ndarray | None = None,
                  prefetch: bool = False, table: np.ndarray | None = None):
        """The LRU-memoized packed plan of a tick (:meth:`_plan_key`):
        unstriped, or striped on ``stripe_of``; ``table`` (prefix sharing
        on) feeds the charge-once packing.  A prefetch that builds a plan
        counts as a prefetch, not a miss, and one that finds it counts
        nothing."""
        share_sig = self._share_sig(table)
        pob = table if share_sig is not None else None
        key = self._plan_key(nb_sig, stripe_of, share_sig)
        got = self._packed_plan_cache.get(key)
        if got is None:
            got = (self._build_packed_plan(nb_sig, phys_of_block=pob)
                   if stripe_of is None
                   else self._build_packed_plan_2d(nb_sig, stripe_of,
                                                   phys_of_block=pob))
            self._packed_plan_cache[key] = got
            if len(self._packed_plan_cache) > self._packed_plan_cap:
                self._packed_plan_cache.popitem(last=False)
            self.decode_stats["plan_prefetches" if prefetch
                              else "plan_misses"] += 1
        else:
            self._packed_plan_cache.move_to_end(key)
            if not prefetch:
                self.decode_stats["plan_hits"] += 1
        return got

    def _prefetch_next_plan(self) -> None:
        """Build the next tick's packed plan while this tick's layers run
        on the card (the kernels are queued; the host blocks later, at
        sampling).  The scheduler's preview is best-effort: a wrong guess
        (or a slot that maps a new block first, which shifts the stripe or
        sharing signature) only means the real key is planned at the next
        tick."""
        if self._batcher is None:
            return
        preview = self._batcher.preview_next_decode()
        if not preview:
            return
        slots, positions = preview
        pos_all = np.zeros((self.ecfg.num_slots,), np.int32)
        pos_all[list(slots)] = positions
        sig = self._nb_sig(pos_all)
        stripe_of = table = None
        if self.paged and (self.ecfg.seq_shards > 1
                           or self.prefix is not None):
            table = self._tick_table(slots)
            if self.ecfg.seq_shards > 1:
                stripe_of = self._stripe_of_table(table)
        key = self._plan_key(sig, stripe_of, self._share_sig(table))
        if key not in self._packed_plan_cache:
            self._plan_for(sig, stripe_of, prefetch=True, table=table)

    def _record_tick(self, stats: dict) -> None:
        s = self.decode_stats
        s["ticks"] += 1
        s["real_items"] += stats["real_items"]
        s["grid_items"] += stats["grid_items"]
        s["padded_grid_items"] += stats["padded_grid_items"]
        s["imbalance_sum"] += stats["imbalance"]
        # per-axis parts: an unstriped tick's imbalance is all head-axis;
        # a striped packed tick records both marginals
        s["head_imb_sum"] += stats.get("model_imbalance", stats["imbalance"])
        s["stripe_imb_sum"] += stats.get("stripe_imbalance", 1.0)
        s["last"] = stats
        self._epoch_stats[self.epoch]["ticks"] += 1

    @property
    def decode_bubble_stats(self) -> dict:
        """Decode-grid bubble telemetry over the ticks so far: the share of
        executed grid items that were padding, the share the padded
        baseline would have paid, their grids' ratio, and the mean
        imbalance of the shards' item counts, with its head-axis and
        stripe-axis marginals and the stripe merges run; the plan epochs':
        the live epoch, the replans, the online estimator's realized
        recovery, the latest drift reading and per-epoch aggregates; the
        swap tier's volume, the per-class counters and the prefix tree's
        counters (the reference's keys for the features the port runs)."""
        s = self.decode_stats
        grid, real, padded = (s["grid_items"], s["real_items"],
                              s["padded_grid_items"])
        ticks = s["ticks"]
        mean = lambda k: s[k] / ticks if ticks else 1.0   # noqa: E731
        epochs = {e: {"ticks": es["ticks"],
                      "telemetry_samples": es["telemetry_samples"],
                      "realized_recovery": (es["recovery_sum"]
                                            / es["recovery_ticks"]
                                            if es["recovery_ticks"] else None),
                      "drift": es["drift"]}
                  for e, es in self._epoch_stats.items()}
        tel = self.telemetry
        return {
            "ticks": s["ticks"],
            "padding_waste": 1.0 - real / grid if grid else 0.0,
            "padded_path_waste": 1.0 - real / padded if padded else 0.0,
            "grid_vs_padded": grid / padded if padded else 1.0,
            "mean_imbalance": mean("imbalance_sum"),
            "seq_shards": self.ecfg.seq_shards,
            "mean_head_imbalance": mean("head_imb_sum"),
            "mean_stripe_imbalance": mean("stripe_imb_sum"),
            "merge_collectives": s["merge_collectives"],
            "plan_hits": s["plan_hits"],
            "plan_misses": s["plan_misses"],
            "plan_prefetches": s["plan_prefetches"],
            "last_tick": s["last"],
            "epoch": self.epoch,
            "replans": self.replans,
            "realized_recovery": (tel.realized_recovery()
                                  if tel is not None and tel.total_samples
                                  else None),
            "drift": self._last_drift[1] if self._last_drift else None,
            "epochs": epochs,
            # overload (§2.10): host-tier swap volume and the scheduler's
            # per-class admission / preemption counters
            "swap": dict(self.swap_stats),
            # faults (§2.13): sentinel trips, swap retry outcomes, audits,
            # rollbacks, and the injected fault count beside them
            "faults": dict(self.fault_stats),
            "injected_events": (len(self.injector.events)
                                if self.injector is not None else 0),
            "per_class": ({k: dict(v) for k, v in
                           self._batcher.stats.per_class.items()}
                          if self._batcher is not None else {}),
            # the radix prefix cache: its counters, the live tree size and
            # the evictable (cached, unreferenced) block count
            "prefix": (dict(self.prefix.stats, nodes=self.prefix.num_blocks,
                            evictable=self.kv.alloc.evictable_blocks)
                       if self.prefix is not None else None),
        }

    # -- plan epochs: telemetry, drift, replanning --------------------------
    def _dispatch_telemetry(self, slots, tok_all, pos_all, bids, table=None):
        """Queue the recovery probe (:func:`tfm.decode_telemetry`) over the
        PRE-STEP resident cache with this tick's selections ``bids [L, B,
        Hkv, nb]``; it runs before the decode step on the same stream, so
        it reads the cache the step then writes.  Returns the pending
        ``(rec, frac, fin, rows)``, folded after the step is queued."""
        dev = self.device
        pos = torch.from_numpy(pos_all).to(dev)
        cache, scales = ((self.kv.pool, self.kv.scales) if self.paged
                         else (self.cache, self.cache_scales))
        rec, frac, fin = tfm.decode_telemetry(
            self.params, cache, torch.from_numpy(tok_all).to(dev), pos,
            self.cfg, block_ids=torch.from_numpy(bids).to(dev),
            cache_len=pos, table=table, scales=scales, with_health=True)
        return rec, frac, fin, list(slots)

    def _fold_telemetry(self, pending) -> None:
        """Fold a probe's samples of the rows whose estimator forward stayed
        finite into the estimator, in ORIGINAL head order: the probe ran on
        permuted weights, so its head h is slot h, original head
        ``perm[h]`` of the layer's plan.  With ``sentinels`` a row whose
        estimator forward went non-finite is quarantined
        (``probe_nonfinite``) even if its logits look clean this tick."""
        rec, frac, fin, rows = pending
        fin = fin.cpu().numpy()
        if self.ecfg.sentinels:
            for r in rows:
                if not fin[r] and int(r) not in self._quarantine:
                    self._quarantine[int(r)] = "probe_nonfinite"
                    self.fault_stats["sentinel_trips"] += 1
        rows = [r for r in rows if fin[r]]
        if not rows:
            return
        rec = rec.cpu().numpy().astype(np.float64)[:, rows, :]
        frac = frac.cpu().numpy().astype(np.float64)[:, rows, :]
        if not (np.isfinite(rec).all() and np.isfinite(frac).all()):
            rec = np.nan_to_num(rec, nan=0.0, posinf=1.0, neginf=0.0)
            frac = np.nan_to_num(frac, nan=0.0, posinf=1.0, neginf=0.0)
        rec_o, frac_o = np.empty_like(rec), np.empty_like(frac)
        for l, lp in enumerate(self.plan.layers):
            rec_o[l][:, lp.perm] = rec[l]
            frac_o[l][:, lp.perm] = frac[l]
        self.telemetry.update(rec_o, frac_o)
        es = self._epoch_stats[self.epoch]
        es["telemetry_samples"] += len(rows)
        es["recovery_sum"] += float(rec.mean())
        es["recovery_ticks"] += 1

    def _maybe_replan(self, batcher=None) -> bool:
        """The replan policy, once per scheduler tick (:meth:`serve` wires
        it): only at a safe point, when ``replan_every`` ticks have passed
        or the drift reading reaches ``drift_threshold``.  Returns True when
        an epoch swap happened."""
        ecfg = self.ecfg
        if self.plan is None or (ecfg.replan_every is None
                                 and ecfg.drift_threshold is None):
            return False
        batcher = batcher or self._batcher
        if batcher is not None and not batcher.replan_safe:
            return False
        due = (ecfg.replan_every is not None
               and self._ticks_since_replan >= ecfg.replan_every)
        if (not due and ecfg.drift_threshold is not None
                and self.telemetry.total_samples):
            # drift moves only when samples were folded: memoized by the
            # sample count and the epoch
            n = (self.telemetry.total_samples, self.epoch)
            if self._last_drift is None or self._last_drift[0] != n:
                self._last_drift = (
                    n, self.telemetry.drift_vs(self._plan_profile))
            drift = self._last_drift[1]
            self._epoch_stats[self.epoch]["drift"] = drift["drift"]
            due = drift["drift"] >= ecfg.drift_threshold
        if not due:
            return False
        return self.replan_now()

    def replan_now(self, profile: HeadSparsityProfile | None = None, *,
                   plan: HPLBPlan | None = None) -> bool:
        """Re-derive budgets and head placement and swap the engine onto
        the new plan epoch in flight.

        ``profile``: plan on it; default the online estimator's curves,
        falling back to the offline profile for heads not observed enough.
        The allocator warm-starts from the live plan's budgets.  ``plan``
        skips planning and swaps onto that plan (its geometry must be the
        engine's).  A plan equal to the live one (placement and budgets)
        changes nothing and returns False, as does a swap that failed and
        rolled back (``fault_stats["replan_rollbacks"]``)."""
        if self.plan is None:
            raise ValueError("replanning needs a sparse engine")
        self._ticks_since_replan = 0
        if plan is not None:
            new_plan = dataclasses.replace(plan, epoch=self.epoch + 1)
        else:
            if profile is None:
                profile = self.telemetry.to_profile(fallback=self.profile)
            ecfg = self.ecfg
            new_plan = make_plan(
                profile, num_devices=ecfg.num_model_shards,
                num_kv_heads=self.cfg.num_kv_heads, seq_len=ecfg.max_seq_len,
                total_budget_per_head=ecfg.budget_per_head,
                block=ecfg.block, floor=ecfg.floor,
                allocator=ecfg.allocator, partitioner=ecfg.partitioner,
                prev_plan=self.plan, epoch=self.epoch + 1)
        if plans_equal(self.plan, new_plan):
            return False
        try:
            self._apply_epoch(new_plan)
        except EpochSwapError as e:
            # nothing was committed: the old epoch keeps serving and the
            # next policy trigger retries
            self.fault_stats["replan_rollbacks"] += 1
            log.warning("epoch swap failed (%s); keeping epoch %d serving",
                        e, self.epoch)
            return False
        self.maybe_audit(boundary=True)
        if profile is not None:
            self._plan_profile = profile
        return True

    def _apply_epoch(self, new_plan: HPLBPlan) -> None:
        """Swap onto ``new_plan``: apply the plan delta to the attention
        weights, gather the resident cache's kv-head axis once (codes and
        scales together) and compose it into ``_kv_arrange``, bump the
        epoch, purge the memos of the dead epoch and flush the prefix tree.
        The staging row of the contiguous layout holds no live sequence at a
        safe point, so it is not gathered.

        Commit last: the ``epoch_swap`` seam fires before anything, and the
        permuted weights and the gathered cache are built beside the live
        ones and adopted together at the end, so a failure part way (the
        seam, or the card running out of memory for the gathered pool)
        raises :class:`EpochSwapError` with the old epoch intact."""
        inj = self.injector
        if inj is not None and inj.enabled:
            if inj.fire("epoch_swap") is not None:
                raise EpochSwapError(
                    "epoch_swap", f"injected swap failure at epoch "
                    f"{self.epoch} -> {new_plan.epoch}")
        delta = plan_delta(self.plan, new_plan)
        new_params, new_cache, new_arrange = self.params, None, None
        if not delta.identity:
            try:
                new_params = self._permute_params(self.params,
                                                  layer_plans=delta.layers)
                kv_tbl = delta.kv_perm_table()
                if not (kv_tbl == np.arange(kv_tbl.shape[1])).all():
                    new_cache = self._permute_cache(kv_tbl)
                    # the cumulative arrangement: slot h then holds what
                    # slot kv_tbl[l, h] held.  Host copies of swapped-out
                    # sequences are not touched; swap-in re-arranges them
                    # against this record exactly once
                    new_arrange = np.take_along_axis(
                        self._kv_arrange, np.asarray(kv_tbl), axis=1)
            except torch.cuda.OutOfMemoryError as e:
                raise EpochSwapError("epoch_swap", f"out of device memory "
                                     f"building epoch {new_plan.epoch}: "
                                     f"{e}") from e
        self.params = new_params
        if new_cache is not None:
            self._adopt_cache(*new_cache)
            self._kv_arrange = new_arrange
        self.plan = new_plan
        self.epoch = new_plan.epoch
        self.replans += 1
        self._epoch_stats[self.epoch] = self._fresh_epoch_stats()
        self._purge_plan_memos()
        if self.prefix is not None:
            # cached prefix KV was computed under the old epoch's budgets
            # and head placement, which a new-epoch prefill would not
            # reproduce: the tree drops everything (unreferenced blocks free
            # now, shared ones as their holders finish)
            self.prefix.flush()

    def _live_cache(self):
        """``(codes, scales)`` of the resident cache: the pool (paged) or
        the slot cache (contiguous); scales None at full precision."""
        if self.paged:
            return self.kv.pool, self.kv.scales
        return self.cache, self.cache_scales

    def _permute_cache(self, kv_tbl: np.ndarray):
        """The resident cache's kv-head axis gathered by ``kv_tbl [L,
        Hkv]`` (new slot -> previous slot), its scales with it: new tensors
        ``(codes, scales)``, the live ones untouched."""
        codes, scales = self._live_cache()
        return (tfm.permute_cache_kv_heads(codes, kv_tbl),
                None if scales is None
                else tfm.permute_cache_scales(scales, kv_tbl))

    def _adopt_cache(self, codes, scales) -> None:
        """Make ``(codes, scales)`` the resident cache (same shapes and
        dtypes as the live one)."""
        if self.paged:
            self.kv.replace_pool(codes, scales)
        else:
            self.cache, self.cache_scales = codes, scales

    def _purge_plan_memos(self) -> None:
        """Drop every host memo derived from a plan epoch's budgets (work
        lists, chunk slices and caps, decode selections and their width,
        packed decode plans): the live epoch rebuilds them on demand."""
        for memo in (self._worklists_cache, self._prefill_items_cache,
                     self._chunk_cap, self._chunk_wl_cache,
                     self._decode_ids_by_nblocks, self._packed_plan_cache):
            memo.clear()
        self._nb_cap = None

    # -- chunked prefill ----------------------------------------------------
    def _prefill_bucket(self, seq_len: int) -> int:
        """A prompt's bucket: the next power of two (floored at one block,
        capped at max_seq_len), or its own length under ``"exact"``."""
        if self.ecfg.prefill_buckets == "exact":
            return seq_len
        b = self.ecfg.block
        while b < seq_len:
            b *= 2
        return min(b, self.ecfg.max_seq_len)

    def _chunk_bucket(self, chunk_len: int, q_offset: int) -> int:
        """Pow2 chunk bucket, capped at the cache rows left after
        ``q_offset`` (a block multiple, so the bucket spans whole q
        blocks)."""
        b = self.ecfg.block
        while b < chunk_len:
            b *= 2
        room = self.ecfg.max_seq_len - q_offset
        if chunk_len > room:
            raise ValueError("chunk overruns the sequence's cache")
        return min(b, room)

    def _chunk_item_cap(self, nqc: int) -> int:
        """Fixed item width for a chunk of ``nqc`` q blocks: the most items
        any nqc-block q window holds at max_seq_len, rounded up to 8."""
        got = self._chunk_cap.get(nqc)
        if got is not None:
            return got
        wls = self.worklists_for(self._prefill_bucket(self.ecfg.max_seq_len))
        nmax = self.ecfg.max_seq_len // self.ecfg.block
        cap = 1
        for wl in wls:
            counts = chunk_item_counts(wl.items, nmax)
            win = np.convolve(counts, np.ones(min(nqc, nmax), np.int64),
                              mode="valid")
            cap = max(cap, int(win.max()))
        cap = -(-cap // 8) * 8
        self._chunk_cap[nqc] = cap
        return cap

    def _chunk_worklists(self, prompt_len: int, q_offset: int,
                         bucket: int) -> torch.Tensor:
        """``[L, P, ITEM_FIELDS]`` chunk work lists on device: the prompt
        bucket's lists sliced to this chunk's q-block window, padded to the
        chunk's item cap.  Memoized."""
        blk = self.ecfg.block
        pbucket = self._prefill_bucket(prompt_len)
        nqc, ob = bucket // blk, q_offset // blk
        key = (pbucket, ob, nqc)
        got = self._chunk_wl_cache.get(key)
        if got is None:
            cap = self._chunk_item_cap(nqc)
            full = self.worklists_for(pbucket)
            got = torch.from_numpy(np.stack([
                chunk_items(wl.items, ob, nqc, pad_to=cap)
                for wl in full])).to(self.device)
            self._chunk_wl_cache[key] = got
        return got

    def _prefill_items(self, bucket: int) -> list[torch.Tensor]:
        """Per-layer ``[P, ITEM_FIELDS]`` work lists of a monolithic prefill
        at ``bucket``, on device.  Memoized."""
        got = self._prefill_items_cache.get(bucket)
        if got is None:
            got = [torch.from_numpy(
                wl.items.reshape(-1, wl.items.shape[-1])).to(self.device)
                for wl in self.worklists_for(bucket)]
            self._prefill_items_cache[bucket] = got
        return got

    def _table_for_slot(self, slot: int) -> np.ndarray:
        """``[T]`` int32 pool block ids (-1 pad) of the sequence in
        ``slot``."""
        return self.kv.table_row(self._batcher.rid_of_slot(slot))

    # -- preemption: KV swap to pinned host memory (§2.10) -----------------
    # A preempted decode's KV is gathered on the device (its mapped pool
    # blocks by id, paged; its slot rows, contiguous; codes and scales by
    # the same ids) and copied into pinned host buffers by non-blocking
    # copies on the current stream, each transfer followed by a recorded
    # event; then the allocator recycles the ids.  Swap-in copies the host
    # buffers back into the freshly mapped blocks (other ids: identity is
    # the block table) or the newly claimed slot.  Exact block counts: the
    # reference's pow2 swap buckets only bound its compiled programs.

    def _to_host(self, t: torch.Tensor) -> torch.Tensor:
        """A host copy of ``t``: a pinned buffer filled by a non-blocking
        copy on the current stream (CUDA), or a clone on the CPU."""
        if self.device.type != "cuda":
            return t.clone()
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        return host

    def _transfer_event(self):
        """An event recorded after the transfers just queued on the current
        stream (None on the CPU, whose copies are done when queued)."""
        if self.device.type != "cuda":
            return None
        ev = torch.cuda.Event()
        ev.record()
        return ev

    def _reap_transfers(self, wait: bool = False) -> None:
        """Release the pinned buffers of swap-ins whose copies have
        completed (all of them, waiting, with ``wait``)."""
        live = []
        for ev, rec in self._swap_in_flight:
            if wait:
                ev.synchronize()
            elif not ev.query():
                live.append((ev, rec))
        self._swap_in_flight = live

    def host_copy(self, rid: int):
        """The host copy ``(data, scales)`` of swapped-out ``rid``, once its
        transfer has completed (codes as int8 bits; scales None for a
        full-precision cache).  The host reads a copy only through this."""
        rec = self._host_swaps[rid]
        if rec["event"] is not None:
            rec["event"].synchronize()
        return rec["data"], rec["scales"]

    def _swap_out_seq(self, rid: int, slot: int, resident: int) -> None:
        """Batcher swap-out hook: copy the sequence's resident KV state to
        the host BEFORE the allocator recycles its blocks.  Paged: gather
        its private mapped pool blocks (the leading shared prefix,
        :meth:`BlockAllocator.swap_split`, stays resident for its other
        holders and is not copied); contiguous: slice its slot rows (whole
        blocks: the tokens past ``resident`` ride along, masked by
        position).  The transfer gate fires first: a give-up leaves no host
        record and no pinned buffer."""
        self._transfer_gate("swap_out_transfer", rid)
        self._reap_transfers()
        blk = self.ecfg.block
        sdata = None
        shared_n = 0
        if self.paged:
            retained, private = self.kv.alloc.swap_split(rid)
            shared_n = len(retained)
            nblk = len(private)
            ids = torch.tensor(private, dtype=torch.long, device=self.device)
            data = _bits(self.kv.pool).index_select(2, ids)
            sdata = (self.kv.scales.index_select(2, ids) if self.quantized
                     else None)
            if nblk:
                data = self._to_host(data)
                sdata = None if sdata is None else self._to_host(sdata)
            else:
                # wholly shared: nothing moves; an empty payload keeps the
                # swap-in bookkeeping uniform
                data = data.cpu()
                sdata = None if sdata is None else sdata.cpu()
        else:
            nblk = -(-resident // blk)
            rows = slice(slot, slot + 1)
            data = self._to_host(
                _bits(self.cache)[:, :, rows, :, :nblk * blk])
            if self.quantized:
                sdata = self._to_host(self.cache_scales[:, :, rows, :, :nblk])
        # the gather is queued before any later write on this stream, so
        # the ids the allocator releases after this hook (and a new tenant
        # may map at once) are not overwritten before it has read them
        self._host_swaps[rid] = {"data": data, "scales": sdata,
                                 "tokens": resident,
                                 "shared_blocks": shared_n,
                                 "arrange": self._kv_arrange.copy(),
                                 "event": self._transfer_event()}
        st = self.swap_stats
        st["swapped_out"] += 1
        st["blocks_out"] += nblk
        st["bytes_out"] += _nbytes(data) + _nbytes(sdata)

    def _swap_in_seq(self, rid: int, slot: int, resident: int) -> None:
        """Batcher swap-in hook: restore the host copy into the freshly
        mapped blocks past the retained shared prefix (paged) or the newly
        claimed slot (contiguous).  If plan epochs gathered the resident
        cache's kv heads while the sequence was out, the copy is
        re-arranged here on the device: exactly once, against the
        cumulative arrangement, codes and scales alike (the retained
        prefix never left the pool, so the epoch gather already moved
        it).  The transfer gate fires before the host record is taken, so a
        give-up keeps the copy for the scheduler's discard."""
        self._transfer_gate("swap_in_transfer", rid)
        self._reap_transfers()
        rec = self._host_swaps.pop(rid)
        if rec["tokens"] != resident:
            raise ValueError(f"swap-in length mismatch: {rec['tokens']} != "
                             f"{resident}")
        data = rec["data"].to(self.device, non_blocking=True)
        sdata = (None if rec["scales"] is None
                 else rec["scales"].to(self.device, non_blocking=True))
        # the pinned buffers must outlive their copies: held until the
        # event recorded after them has completed
        ev = self._transfer_event()
        if ev is not None:
            self._swap_in_flight.append((ev, rec))
        if not np.array_equal(rec["arrange"], self._kv_arrange):
            # rel[l, h] = where (in the host copy) the kv head now wanted
            # at slot h was stored when the copy was taken
            inv = np.argsort(rec["arrange"], axis=1)
            rel = np.take_along_axis(inv, self._kv_arrange, axis=1)
            data = tfm.permute_cache_kv_heads(data, rel)
            if sdata is not None:
                sdata = tfm.permute_cache_scales(sdata, rel)
            self.swap_stats["epoch_remaps"] += 1
        if self.paged:
            # the allocator re-linked the retained prefix by identity and
            # mapped fresh ids for the private tail only
            ids = self.kv.alloc.table(rid)[rec["shared_blocks"]:]
            nblk = len(ids)
            if nblk != data.shape[2]:
                raise ValueError(f"swap-in block mismatch: {nblk} != "
                                 f"{data.shape[2]}")
            if nblk:
                idx = torch.tensor(ids, dtype=torch.long, device=self.device)
                _bits(self.kv.pool)[:, :, idx] = data
                if sdata is not None:
                    self.kv.scales[:, :, idx] = sdata
        else:
            nblk = -(-resident // self.ecfg.block)
            rows = slice(slot, slot + 1)
            _bits(self.cache)[:, :, rows, :, :data.shape[4]] = data
            if sdata is not None:
                self.cache_scales[:, :, rows, :, :nblk] = sdata
        st = self.swap_stats
        st["swapped_in"] += 1
        st["blocks_in"] += nblk
        st["bytes_in"] += _nbytes(data) + _nbytes(sdata)

    # -- faults: transfer gate, sentinels, seams, scrub, audits (§2.13) -------
    def _transfer_gate(self, seam: str, rid: int) -> None:
        """Bounded retry with backoff around a host <-> device transfer:
        each attempt re-fires ``seam``, so a spec hitting ``times <=
        swap_retries`` attempts heals and one past the budget raises
        :class:`TransferError` (the scheduler discards and requeues).  Fires
        before any device work, so nothing is left half moved."""
        inj = self.injector
        if inj is None or not inj.enabled:
            return
        retries = self.ecfg.swap_retries
        for attempt in range(retries + 1):
            spec = inj.fire(seam, rid=rid)
            if spec is None:
                if attempt:
                    self.fault_stats["swap_recoveries"] += 1
                    log.info("%s rid=%d recovered on retry %d", seam, rid,
                             attempt)
                return
            if spec.mode == "delay":
                time.sleep(spec.value)
                return
            self.fault_stats["swap_faults"] += 1
            if attempt < retries:
                self.fault_stats["swap_retries"] += 1
                if self.ecfg.swap_backoff_s > 0:
                    time.sleep(self.ecfg.swap_backoff_s * (2 ** attempt))
        self.fault_stats["swap_giveups"] += 1
        raise TransferError(
            seam, f"transfer failed after {retries + 1} attempts", rid=rid)

    def take_quarantine(self) -> dict[int, str]:
        """Drain the sentinel flags raised by the last step (the batcher's
        ``sentinel_fn``): ``{slot: fail_reason}``, then cleared."""
        got, self._quarantine = self._quarantine, {}
        return got

    def _sample(self, logits: torch.Tensor, sampling: SamplingParams,
                row_slots) -> np.ndarray:
        """Sample ``logits [B, V]`` on the device and return the tokens on
        the host.  With ``sentinels``, each row's all-finite flag is
        computed on the device and crosses in the same copy as the tokens
        (one transfer a step, as without the check); a row of
        ``row_slots`` ((row, slot) pairs) with a non-finite logit flags its
        slot ``nonfinite_logits``."""
        toks = sample(logits, sampling, self.rng)
        if not self.ecfg.sentinels:
            return toks.cpu().numpy()
        fin = torch.isfinite(logits).all(dim=-1).to(toks.dtype)
        toks, fin = torch.stack([toks, fin]).cpu().numpy()
        for row, s in row_slots:
            if not fin[row] and int(s) not in self._quarantine:
                self._quarantine[int(s)] = "nonfinite_logits"
                self.fault_stats["sentinel_trips"] += 1
        return toks

    def _poison_gate(self, logits: torch.Tensor, slot: int) -> torch.Tensor:
        """``poison_request`` seam: a fired spec turns THIS prefill's logits
        into NaN (a request whose inputs drive the network into garbage);
        the sentinel must catch it.  A rid-scoped spec poisons only its
        victim."""
        inj = self.injector
        if inj is None or not inj.enabled:
            return logits
        rid = None
        if self._batcher is not None:
            try:
                rid = self._batcher.rid_of_slot(slot)
            except KeyError:
                rid = None
        spec = inj.fire("poison_request", rid=rid)
        if spec is None:
            return logits
        if spec.rid is not None and rid is not None and spec.rid != rid:
            return logits
        return torch.full_like(logits, torch.nan)

    def _maybe_corrupt(self, slots) -> None:
        """``kv_corrupt`` seam, before a decode step (and its probe): set
        one victim's OLDEST block (paged; its slot row, contiguous) to NaN
        / Inf on the VALUE plane, the codes of a full-precision cache or
        the scales of a quantized one.  The first block always holds
        attended prompt tokens, so the fault shows this tick; a value keeps
        the scores finite and rides the accumulator into the victim's
        logits (a poisoned key would make ``l`` non-finite, which the
        kernels' masked-row guard zeroes).  With the prefix cache the
        oldest block may be shared: every holder then trips its sentinel."""
        inj = self.injector
        if inj is None or not inj.enabled:
            return
        spec = inj.fire("kv_corrupt")
        if spec is None:
            return
        slots = list(slots)
        if not slots:
            return
        victim = slots[0]
        if spec.rid is not None and self._batcher is not None:
            for s in slots:
                if self._batcher.rid_of_slot(s) == spec.rid:
                    victim = s
                    break
        bad = torch.inf if spec.mode == "inf" else torch.nan
        codes, scales = self._live_cache()
        if self.paged:
            rid = (self._batcher.rid_of_slot(victim)
                   if self._batcher is not None else None)
            ids = self.kv.alloc.table(rid) if rid is not None else []
            if not ids:
                return
            at = int(ids[0])
        else:
            at = victim
        if scales is not None:
            scales[:, 1, at] = bad
        else:
            codes[:, 1, at] = bad
        self.fault_stats["corruptions_injected"] += 1
        log.warning("injected kv_corrupt (%s) into slot %d", spec.mode,
                    victim)

    def _release_seq(self, rid: int, slot: int | None) -> None:
        """Batcher ``on_fail_fn``, for a quarantined or discarded sequence
        while its block table is valid: drop its host copy and SCRUB its
        blocks (codes 0, scales 1) before they recycle.  The plain versions
        (and the bf16 prefill kernel's P.V over a whole tile) multiply a
        masked key's zero weight into its value row (0 x NaN is NaN), so a
        stale NaN in a block handed to a later sequence would poison it.
        The scrub is queued on the stream ahead of any later
        write.  Prefix sharing: only blocks about to free are scrubbed, not
        one another holder references or the tree keeps (the fault path
        invalidates the tree first, so a corrupted block is uncached by
        now and is scrubbed when its last holder drops it)."""
        rec = self._host_swaps.pop(rid, None)
        if rec is not None and rec["event"] is not None:
            rec["event"].synchronize()    # its pinned buffer may be in use
        codes, scales = self._live_cache()
        if self.paged:
            alloc = self.kv.alloc
            ids = [b for b in alloc.table(rid)
                   if alloc.refcount(b) == 1 and not alloc.is_cached(b)]
            if not ids:
                return
            at = torch.tensor(ids, dtype=torch.long, device=self.device)
        elif slot is not None:
            at = slot
        else:
            return
        _bits(codes)[:, :, at] = 0
        if scales is not None:
            scales[:, :, at] = 1.0

    def audit(self, strict: bool = True) -> list[str]:
        """Engine-level invariant audit: the allocator's two-tier
        conservation, refcount, stripe and double-map checks, the pool's
        shapes, the host tier (every allocator-swapped sequence has exactly
        one host copy whose tokens and retained prefix agree) and the
        prefix tree's pins.  Returns the violations; ``strict`` raises
        :class:`IntegrityError` on any."""
        if self.paged:
            fails = self.kv.audit(strict=False)
            alloc = self.kv.alloc
        else:
            alloc = (self._batcher.alloc if self._batcher is not None
                     else None)
            fails = alloc.audit(strict=False) if alloc is not None else []
            if (self.cache_scales is not None and tuple(
                    self.cache_scales.shape[:4]) != tuple(
                        self.cache.shape[:4])):
                fails.append(
                    f"contiguous scales shape "
                    f"{tuple(self.cache_scales.shape)} disagrees with cache "
                    f"{tuple(self.cache.shape)}")
        if alloc is not None:
            swapped = set(alloc.swapped_seqs)
            held = set(self._host_swaps)
            for rid in sorted(swapped - held):
                fails.append(f"seq {rid} swapped-out in allocator but has "
                             "no host copy")
            for rid in sorted(held - swapped):
                fails.append(f"seq {rid} has a host copy but is not "
                             "swapped-out in the allocator")
            for rid in sorted(swapped & held):
                rec = self._host_swaps[rid]
                if alloc.host_tokens(rid) != rec["tokens"]:
                    fails.append(
                        f"seq {rid} host tokens disagree: allocator "
                        f"{alloc.host_tokens(rid)} vs copy "
                        f"{rec['tokens']}")
                if self.paged:
                    shn = rec.get("shared_blocks", 0)
                    if shn != alloc.host_shared_blocks(rid):
                        fails.append(
                            f"seq {rid} retained-prefix disagree: "
                            f"allocator {alloc.host_shared_blocks(rid)} "
                            f"vs copy {shn}")
                    want = alloc.blocks_needed(rec["tokens"]) - shn
                    if rec["data"].shape[2] != want:
                        fails.append(
                            f"seq {rid} host payload holds "
                            f"{rec['data'].shape[2]} blocks, expected "
                            f"{want}")
        if self.prefix is not None:
            tree_ids = self.prefix.block_ids()
            pinned = self.kv.alloc.cached_ids()
            if tree_ids != pinned:
                fails.append(
                    f"prefix tree / allocator pin drift: tree-only "
                    f"{sorted(tree_ids - pinned)}, alloc-only "
                    f"{sorted(pinned - tree_ids)}")
        if fails and strict:
            raise IntegrityError(fails)
        if not fails:
            self.fault_stats["audits"] += 1
        return fails

    def maybe_audit(self, boundary: bool = False) -> None:
        """Every ``audit_every`` decode ticks, and at a swap or replan
        ``boundary``, when auditing is on."""
        ae = self.ecfg.audit_every
        if ae <= 0:
            return
        if boundary or (self._decode_ticks and self._decode_ticks % ae == 0):
            self.audit(strict=True)

    def _maybe_checkpoint(self, batcher) -> None:
        """Every ``checkpoint_every`` decode ticks at a safe point (no
        prefill in flight, the point epoch swaps use), write a snapshot
        into ``checkpoint_dir``."""
        ecfg = self.ecfg
        if (not ecfg.checkpoint_dir or ecfg.checkpoint_every <= 0
                or self._decode_ticks == 0
                or self._decode_ticks % ecfg.checkpoint_every != 0
                or not batcher.replan_safe):
            return
        from repro_torch.serving import snapshot  # it imports this module
        snapshot.save_serving(ecfg.checkpoint_dir, self, batcher)
        self.fault_stats["checkpoints"] += 1

    def on_tick(self, batcher) -> None:
        """The per-tick policy (:meth:`serve` wires it; a caller driving
        ``tick`` may call it): the replan policy, audits (periodic, and at a
        swap or replan boundary) and checkpoints at safe points."""
        self._maybe_replan(batcher)
        if self.ecfg.audit_every > 0:
            activity = (self.swap_stats["swapped_out"]
                        + self.swap_stats["swapped_in"] + self.replans)
            boundary = activity != self._last_audit_activity
            self._last_audit_activity = activity
            self.maybe_audit(boundary=boundary)
        self._maybe_checkpoint(batcher)

    # -- device steps ---------------------------------------------------------
    def prefill_into_slot(self, tokens: np.ndarray, slot: int,
                          sampling: SamplingParams = SamplingParams()) -> int:
        """Monolithic prefill of one whole prompt at its bucket into its
        cache (the sequence's pool blocks, paged; the slot's row,
        contiguous); returns the first sampled token.  The sequence cache
        spans the bucket rounded up to whole blocks; a quantized cache
        takes its codes and scales at the scatter (paged) or the slot
        insert (contiguous), as the reference quantizes once."""
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        S = tokens.shape[0]
        blk = self.ecfg.block
        bucket = self._prefill_bucket(S)
        toks = np.zeros((1, bucket), np.int64)
        toks[0, :S] = tokens
        logits, seq = tfm.prefill(
            self.params, torch.from_numpy(toks).to(self.device), self.cfg,
            cache_len=-(-bucket // blk) * blk,
            sparse_items=self._prefill_items(bucket) if self.sparse else None,
            last_index=S - 1)
        if self.paged:
            table = torch.from_numpy(self._table_for_slot(slot)).to(
                self.device)
            if self.quantized:
                tfm.scatter_seq_cache_paged(
                    self.kv.pool, seq, table, scales=self.kv.scales,
                    kv_dtype=self.ecfg.kv_dtype)
            else:
                tfm.scatter_seq_cache_paged(self.kv.pool, seq, table)
        elif self.quantized:
            n = seq.shape[4]
            codes, sc = quant.quantize_seq_cache(seq, blk,
                                                 self.ecfg.kv_dtype)
            quant.code_bits(self.cache)[:, :, slot, :, :n] = \
                quant.code_bits(codes)[:, :, 0]
            self.cache_scales[:, :, slot, :, :n // blk] = sc[:, :, 0]
        else:
            self.cache[:, :, slot, :, :seq.shape[4]] = seq[:, :, 0]
        logits = self._poison_gate(logits, slot)
        return int(self._sample(logits, sampling, [(0, slot)])[0])

    def prefill_chunk_into_slot(self, tokens: np.ndarray, slot: int,
                                q_offset: int, prompt_len: int,
                                sampling: SamplingParams = SamplingParams(),
                                is_final: bool = True) -> int | None:
        """Prefill one chunk of a sequence straight into its pool blocks.
        Returns the first sampled token when ``is_final``, else None."""
        tokens = np.asarray(tokens, np.int32)
        c = tokens.shape[-1]
        bucket = self._chunk_bucket(c, q_offset)
        toks = np.zeros((1, bucket), np.int64)
        toks[0, :c] = tokens
        # dense: None, and the model runs its dense causal chunk list
        items = (self._chunk_worklists(prompt_len, q_offset, bucket)
                 if self.sparse else None)
        toks = torch.from_numpy(toks).to(self.device)
        if self.paged:
            table = torch.from_numpy(self._table_for_slot(slot)).to(
                self.device)
            qkw = ({"scales": self.kv.scales, "kv_dtype": self.ecfg.kv_dtype}
                   if self.quantized else {})
            logits = tfm.prefill_chunk_paged(
                self.params, self.kv.pool, toks, table, q_offset, self.cfg,
                kv_len=q_offset + c, sparse_items=items, last_index=c - 1,
                **qkw)
            if self.quantized:
                logits = logits[0]
        else:
            logits = tfm.prefill_chunk(
                self.params, self._staging, toks, 0, q_offset, self.cfg,
                kv_len=q_offset + c, sparse_items=items, last_index=c - 1)
        if not is_final:
            return None
        if not self.paged:
            # one copy lands the staged sequence in its slot row; stale
            # staging rows past it are masked by position, like bucket
            # padding (and, quantized, share its last block's scale, as in
            # the reference)
            if self.quantized:
                codes, sc = quant.quantize_seq_cache(
                    self._staging, self.ecfg.block, self.ecfg.kv_dtype)
                quant.code_bits(self.cache)[:, :, slot] = \
                    quant.code_bits(codes)[:, :, 0]
                self.cache_scales[:, :, slot] = sc[:, :, 0]
            else:
                self.cache[:, :, slot] = self._staging[:, :, 0]
        logits = self._poison_gate(logits, slot)
        return int(self._sample(logits, sampling, [(0, slot)])[0])

    def decode_slots(self, slots, tokens, positions,
                     sampling: SamplingParams = SamplingParams()):
        """Advance all slots one step; returns sampled tokens for
        ``slots``."""
        ecfg = self.ecfg
        tok_all = np.zeros((ecfg.num_slots,), np.int64)
        pos_all = np.zeros((ecfg.num_slots,), np.int32)
        act_all = np.zeros((ecfg.num_slots,), bool)
        tok_all[list(slots)] = tokens
        pos_all[list(slots)] = positions
        act_all[list(slots)] = True   # padding rows must not write KV
        dev = self.device
        self._decode_ticks += 1
        self._ticks_since_replan += 1
        table = tbl = None
        if self.paged:
            tbl = self._tick_table(slots)
            table = torch.from_numpy(tbl).to(dev)
        # the kv_corrupt seam fires before the probe and the step, so both
        # read the corrupted block
        self._maybe_corrupt(slots)
        pending = None
        if (self.sparse and ecfg.telemetry_every > 0
                and self._decode_ticks % ecfg.telemetry_every == 0):
            # the recovery probe over the pre-step cache, with this tick's
            # position-aware selections
            bids = np.stack([self._decode_ids_for_nblocks(n)
                             for n in self._nb_sig(pos_all)], axis=1)
            pending = self._dispatch_telemetry(slots, tok_all, pos_all, bids,
                                               table)
        packed = self.sparse and ecfg.decode_worklist == "packed"
        striped = self.paged and ecfg.seq_shards > 1
        stats = None
        if not self.sparse:
            # dense: every resident block of each active row, one table
            # for all layers (per-slot ids, striped: each stripe's pass
            # masks the table); no plan, so no bubble telemetry (as the
            # reference records none)
            dense = (tfm.dense_decode_ids if striped
                     else tfm.dense_decode_items)(
                pos_all, act_all, self.cfg.num_kv_heads, ecfg.block)
            work = {"block_ids" if striped else "packed_items":
                    torch.from_numpy(dense).to(dev).expand(
                        self.cfg.num_layers, *dense.shape)}
        elif packed:
            stripe_of = self._stripe_of_table(tbl) if striped else None
            items, stats = self._plan_for(self._nb_sig(pos_all), stripe_of,
                                          table=tbl)
            work = {"packed_items": items}
        else:
            # padded baseline: every slot's position-aware selection at the
            # plan's max-budget width, refreshed at block boundaries
            bids = np.stack([self._decode_ids_for_nblocks(n)
                             for n in self._nb_sig(pos_all)], axis=1)
            stats = self._padded_tick_stats(bids)
            work = {"block_ids": torch.from_numpy(bids).to(dev)}
        args = (torch.from_numpy(tok_all).to(dev),
                torch.from_numpy(pos_all).to(dev))
        act = torch.from_numpy(act_all).to(dev)
        if self.quantized:
            work["scales"] = (self.kv.scales if self.paged
                              else self.cache_scales)
            work["kv_dtype"] = ecfg.kv_dtype
        if striped:
            work["seq_stripes"] = ecfg.seq_shards
            work["stripe_size"] = self.kv.stripe_size
        if self.paged:
            logits = tfm.decode_step_paged(
                self.params, self.kv.pool, *args, table, self.cfg,
                active=act, **work)
        else:
            logits = tfm.decode_step(self.params, self.cache, *args,
                                     self.cfg, active=act, **work)
        if self.quantized:
            logits = logits[0]
        if stats is not None:
            self._record_tick(stats)
        if striped:
            # one (out, m, l) merge a layer: on a seq-sharded mesh the one
            # collective along the seq axis
            self.decode_stats["merge_collectives"] += self.cfg.num_layers
        if packed:
            # the step's kernels are queued on the stream: plan the next
            # tick now, before sampling waits for them
            self._prefetch_next_plan()
        if pending is not None:
            self._fold_telemetry(pending)
        return self._sample(logits, sampling,
                            [(s, s) for s in slots])[list(slots)]

    def kv_bytes(self) -> int:
        """Resident device bytes of the KV cache: the pool's codes and
        scales (paged), or the slot cache, its scales and the staging row
        (contiguous)."""
        if self.paged:
            return self.kv.pool_bytes()
        parts = [self.cache, self._staging]
        if self.cache_scales is not None:
            parts.append(self.cache_scales)
        return sum(t.numel() * t.element_size() for t in parts)

    # -- serving loop ---------------------------------------------------------
    def make_batcher(self, classes=None) -> ContinuousBatcher:
        """A ContinuousBatcher for this engine.  Paged: it shares the pool's
        allocator, so admission and the device pool count the same blocks.
        Contiguous: its allocator is private accounting over
        ``num_slots * max_seq_len / block`` blocks.  Monolithic prefill
        takes no chunk budget (whole prompts at admission).  ``classes``
        overrides :data:`~repro_torch.serving.scheduler.DEFAULT_CLASSES`;
        the admission policy, preemption, the host tier's capacity and the
        swap hooks come from the engine's config; the sentinel drain and
        the fail hook are always wired.  With ``prefix_cache``
        the radix tree is built on the first call and kept (it outlives a
        serve call, so cached prefixes stay warm), and the allocator drains
        it under pool pressure (``evict_fn``) before admission preempts."""
        ecfg = self.ecfg
        if ecfg.prefix_cache and self.prefix is None:
            self.prefix = RadixPrefixCache(self.kv.alloc, ecfg.block)
            self.kv.alloc.evict_fn = self.prefix.evict
        self._batcher = ContinuousBatcher(
            num_slots=ecfg.num_slots,
            num_blocks=(self.kv.num_blocks if self.paged else
                        ecfg.num_slots * (ecfg.max_seq_len // ecfg.block)),
            max_seq_len=ecfg.max_seq_len, block=ecfg.block,
            token_budget=(ecfg.prefill_chunk_tokens
                          if ecfg.prefill_mode == "chunked" else None),
            allocator=self.kv.alloc if self.paged else None,
            classes=DEFAULT_CLASSES if classes is None else classes,
            admission=ecfg.admission, preemption=ecfg.preemption,
            host_blocks=ecfg.host_swap_blocks,
            swap_out_fn=self._swap_out_seq if ecfg.preemption else None,
            swap_in_fn=self._swap_in_seq if ecfg.preemption else None,
            sentinel_fn=self.take_quarantine, on_fail_fn=self._release_seq,
            prefix_cache=self.prefix)
        if not self.paged:
            # the contiguous layout's allocator is the batcher's own
            # accounting: wire the admission_alloc seam there
            self._batcher.alloc.injector = self.injector
        return self._batcher

    def step_fns(self, sampling: SamplingParams = SamplingParams()):
        """(prefill_chunk_fn, decode_fn) closures for a ContinuousBatcher.
        Monolithic mode gets each whole prompt as one final chunk at offset
        0 and prefills it at its bucket.  A prefix hit in monolithic mode
        comes at ``q_offset`` = the hit tokens, already resident in shared
        blocks: its tail runs as one final chunk whose work lists are
        sliced from the monolithic plan (a monolithic prefill would rewrite
        the shared blocks)."""
        def prefill_chunk(toks, slot, q_offset, is_final, prompt_len):
            if self.ecfg.prefill_mode == "monolithic" and not q_offset:
                return self.prefill_into_slot(toks[0], slot, sampling)
            if self.ecfg.prefill_mode == "monolithic":
                return self.prefill_chunk_into_slot(
                    toks[0], slot, q_offset, prompt_len, sampling,
                    is_final=True)
            return self.prefill_chunk_into_slot(
                toks[0], slot, q_offset, prompt_len, sampling,
                is_final=is_final)

        def decode(slots, toks, pos):
            return self.decode_slots(slots, toks, pos, sampling)

        return prefill_chunk, decode

    def serve(self, prompts: list[np.ndarray],
              sampling: SamplingParams = SamplingParams(),
              priorities: list[str] | None = None) -> list[Request]:
        """Continuous-batching serve of a list of prompts.  Returns one
        Request per prompt in input order: completed requests carry their
        generated tokens, over-length (or, under SLO admission, shed) ones
        come back ``rejected``.  ``priorities`` names each prompt's
        :class:`~repro_torch.serving.scheduler.PriorityClass` (default
        "standard").  The per-tick policy (:meth:`on_tick`: replans, audits,
        checkpoints) runs after every tick; a request a fault killed comes
        back ``failed`` with its ``fail_reason``."""
        batcher = self.make_batcher()
        for i, pr in enumerate(prompts):
            batcher.submit(Request(
                rid=i, prompt=np.asarray(pr, np.int32), sampling=sampling,
                priority=priorities[i] if priorities else "standard"))
        done = batcher.run(*self.step_fns(sampling),
                           on_tick=lambda: self.on_tick(batcher))
        self._reap_transfers(wait=True)
        return sorted(done, key=lambda r: r.rid)


def _bits(t: torch.Tensor) -> torch.Tensor:
    """``t``, or its int8 view for one-byte codes (gathers and scatters of
    int8 and fp8 codes move the same bits)."""
    return quant.code_bits(t) if t.element_size() == 1 else t


def _nbytes(t: torch.Tensor | None) -> int:
    return 0 if t is None else t.numel() * t.element_size()
