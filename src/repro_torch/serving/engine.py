"""S-HPLB serving engine: plan-driven sparse chunked prefill + budgeted
decode over a paged KV pool or a contiguous slot cache, with continuous
batching.

The subset of the reference's ``serving/engine.py`` that the port runs:
sparse attention planned by S-HPLB (per-head budgets + head permutation),
chunked prefill whose per-chunk work lists are slices of the prompt
bucket's lists, and decode over either cost-packed work lists padded to pow2
item buckets (``decode_worklist="packed"``, the default) or the padded
per-slot block-id grid (``"padded"``, the step-invariant baseline).  The
KV cache is the paged pool (``cache_layout="paged"``, the default) or the
contiguous slot cache (``"contiguous"``, the parity baseline: chunks build
in a one-sequence staging cache merged into the slot row at the final
chunk).  Host planning is numpy; device state (permuted params, cache)
lives on ``device``, which defaults to CUDA.  Other ``EngineConfig``
options raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict

import numpy as np
import torch

from repro_torch.attention.policies import policy_by_name
from repro_torch.configs import TransformerConfig
from repro_torch.core.planner import HPLBPlan, make_plan, \
    permute_attention_params
from repro_torch.core.sparsity import HeadSparsityProfile
from repro_torch.core.worklist import (
    DEC_FIELDS, WorkList, blocks_for_budget, chunk_item_counts, chunk_items,
    extend_packed_items, pack_decode_items, pow2_bucket,
    worklist_from_budgets)
from repro_torch.models import transformer as tfm
from repro_torch.serving.kv_cache import PagedKVCache
from repro_torch.serving import sampler
from repro_torch.serving.sampler import SamplingParams, sample
from repro_torch.serving.scheduler import ContinuousBatcher, Request


@dataclasses.dataclass
class EngineConfig:
    attention: str = "sparse"        # S-HPLB sparse attention
    policy: str = "strided"          # static selection policy
    budget_per_head: int = 512       # k — the uniform-equivalent budget
    block: int = 128
    floor: int = 128
    allocator: str = "maxmin"        # paper | "uniform" (top-k baseline)
    partitioner: str = "best"        # "best" | "lpt" (paper) | "naive"
    num_model_shards: int = 1        # HP degree for planning
    max_seq_len: int = 4096
    num_slots: int = 8
    prefill_buckets: str = "pow2"
    prefill_mode: str = "chunked"
    prefill_chunk_tokens: int = 256  # per-tick token budget (chunk cap)
    cache_layout: str = "paged"
    num_kv_blocks: int | None = None  # None = num_slots * max_seq / block
    kv_dtype: str = "bf16"
    decode_worklist: str = "packed"
    # reference options whose non-default values are not ported yet
    seq_shards: int = 1
    replan_every: int | None = None
    drift_threshold: float | None = None
    preemption: bool = False
    prefix_cache: bool = False

    def check_supported(self) -> None:
        """Raise ``NotImplementedError`` for options the port does not run
        yet."""
        ported = {"attention": ("sparse",), "prefill_buckets": ("pow2",),
                  "prefill_mode": ("chunked",),
                  "cache_layout": ("paged", "contiguous"),
                  "kv_dtype": ("bf16",),
                  "decode_worklist": ("packed", "padded"),
                  "num_model_shards": (1,), "seq_shards": (1,),
                  "replan_every": (None,), "drift_threshold": (None,),
                  "preemption": (False,), "prefix_cache": (False,)}
        for name, values in ported.items():
            got = getattr(self, name)
            if got not in values:
                raise NotImplementedError(
                    f"EngineConfig.{name}={got!r} is not ported yet "
                    f"(the port runs {name} in {values!r})")


class Engine:
    """Single-model serving engine for the dense GQA transformer.

    ``device`` holds the params and the KV pool; it defaults to CUDA and
    the engine raises when CUDA is absent.  Pass ``device="cpu"`` to run
    every kernel's plain PyTorch version instead.
    """

    def __init__(self, cfg: TransformerConfig, params: dict,
                 engine_cfg: EngineConfig, profile: HeadSparsityProfile,
                 device: str | torch.device = "cuda"):
        engine_cfg.check_supported()
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Engine device is CUDA but no CUDA device is "
                               "available; pass device='cpu' explicitly to "
                               "run the plain PyTorch kernels")
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {self.device}")
        if profile is None:
            raise ValueError("sparse attention needs a sparsity profile")
        ecfg = engine_cfg
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
        self.plan: HPLBPlan = make_plan(
            profile, num_devices=ecfg.num_model_shards,
            num_kv_heads=cfg.num_kv_heads, seq_len=ecfg.max_seq_len,
            total_budget_per_head=ecfg.budget_per_head, block=ecfg.block,
            floor=ecfg.floor, allocator=ecfg.allocator,
            partitioner=ecfg.partitioner)
        self.params = self._permute_params(params)
        self.paged = ecfg.cache_layout == "paged"
        if self.paged:
            nblocks = (ecfg.num_kv_blocks
                       or ecfg.num_slots * (ecfg.max_seq_len // ecfg.block))
            self.kv = PagedKVCache(
                lambda n: tfm.init_paged_cache(cfg, n, ecfg.block,
                                               device=self.device),
                num_blocks=nblocks, block=ecfg.block,
                table_width=ecfg.max_seq_len // ecfg.block)
        else:
            # every slot reserves a max_seq_len row; chunks build in a
            # one-sequence staging cache (the scheduler prefills one
            # sequence at a time), so decode never sees a mid-prefill row
            self.kv = None
            self.cache = tfm.init_cache(cfg, ecfg.num_slots,
                                        ecfg.max_seq_len, device=self.device)
            self._staging = tfm.init_cache(cfg, 1, ecfg.max_seq_len,
                                           device=self.device)
        self._batcher: ContinuousBatcher | None = None
        # host planning memos: prompt-bucket work lists, chunk slices and
        # their item caps, decode selections per resident block count, and
        # an LRU of packed decode plans keyed by the per-slot block counts
        self._worklists_cache: dict[int, list[WorkList]] = {}
        self._chunk_cap: dict[int, int] = {}
        self._chunk_wl_cache: dict[tuple, torch.Tensor] = {}
        self._decode_ids_by_nblocks: dict[int, np.ndarray] = {}
        self._nb_cap: int | None = None
        self._packed_plan_cache: OrderedDict = OrderedDict()
        self._packed_plan_cap = 256
        self.decode_stats = {"ticks": 0, "real_items": 0, "grid_items": 0,
                             "plan_hits": 0, "plan_misses": 0}

    # -- offline artifacts -------------------------------------------------
    def _permute_params(self, params: dict) -> dict:
        """Apply the plan's head permutation to every layer's attention
        projections (a new params dict; the input is not modified)."""
        cfg = self.cfg
        to = lambda t: t.to(self.device).contiguous()    # noqa: E731
        layers = []
        for lp, layer_plan in zip(params["layers"], self.plan.layers):
            ap = lp["attn"]
            wq, wk, wv, wo = permute_attention_params(
                ap["wq"], ap["wk"], ap["wv"], ap["wo"], layer_plan,
                cfg.head_dim_, cfg.group_size,
                kv_replicated=self.plan.mode == "kv_replication")
            layers.append({
                "attn": {"wq": to(wq), "wk": to(wk), "wv": to(wv),
                         "wo": to(wo)},
                "ln1": to(lp["ln1"]), "ln2": to(lp["ln2"]),
                "mlp": {k: to(v) for k, v in lp["mlp"].items()}})
        out = {k: to(v) for k, v in params.items() if k != "layers"}
        out["layers"] = layers
        return out

    def worklists_for(self, seq_len: int) -> list[WorkList]:
        """Per-layer work lists for a prefill of ``seq_len``, memoized by
        the prompt's pow2 bucket."""
        bucket = self._prefill_bucket(seq_len)
        got = self._worklists_cache.get(bucket)
        if got is None:
            pol = policy_by_name(self.ecfg.policy)
            got = [worklist_from_budgets(
                self.plan.layers[l].budgets,
                num_devices=self.ecfg.num_model_shards, seq_len=bucket,
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

    def _build_packed_plan(self, nb_sig: tuple[int, ...]):
        """One tick's decode work: per layer, every slot's selection packed
        into (row, kv_head, kv_block) runs, all layers padded onto one pow2
        item bucket.  Returns ``(items [L, bucket, DEC_FIELDS] on device,
        real item count)``."""
        cfg, ecfg = self.cfg, self.ecfg
        per_slot = [self._decode_ids_for_nblocks(nb) for nb in nb_sig]
        bids = np.stack(per_slot, axis=1)       # [L, B, Hkv, nb_cap]
        # byte-true packing weight: K+V bytes one selected bf16 block streams
        kv_block_bytes = 2.0 * ecfg.block * cfg.head_dim_ * 2.0
        wls = [pack_decode_items(bids[l], num_shards=ecfg.num_model_shards,
                                 block=ecfg.block,
                                 bytes_per_block=kv_block_bytes)
               for l in range(cfg.num_layers)]
        bucket = pow2_bucket(max(wl.padded_length for wl in wls),
                             lo=8, hi=self._packed_item_cap())
        items = np.stack([
            extend_packed_items(wl.items, bucket).reshape(-1, DEC_FIELDS)
            for wl in wls])
        real = sum(wl.total_real_items for wl in wls)
        return torch.from_numpy(items).to(self.device), real

    def _plan_for(self, nb_sig: tuple[int, ...]):
        got = self._packed_plan_cache.get(nb_sig)
        if got is None:
            got = self._build_packed_plan(nb_sig)
            self._packed_plan_cache[nb_sig] = got
            if len(self._packed_plan_cache) > self._packed_plan_cap:
                self._packed_plan_cache.popitem(last=False)
            self.decode_stats["plan_misses"] += 1
        else:
            self._packed_plan_cache.move_to_end(nb_sig)
            self.decode_stats["plan_hits"] += 1
        return got

    # -- chunked prefill ----------------------------------------------------
    def _prefill_bucket(self, seq_len: int) -> int:
        """Next power of two (floored at one block, capped at max_seq_len)."""
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

    def _table_for_slot(self, slot: int) -> np.ndarray:
        """``[T]`` int32 pool block ids (-1 pad) of the sequence in
        ``slot``."""
        return self.kv.table_row(self._batcher.rid_of_slot(slot))

    # -- device steps ---------------------------------------------------------
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
        items = self._chunk_worklists(prompt_len, q_offset, bucket)
        toks = torch.from_numpy(toks).to(self.device)
        if self.paged:
            table = torch.from_numpy(self._table_for_slot(slot)).to(
                self.device)
            logits = tfm.prefill_chunk_paged(
                self.params, self.kv.pool, toks, table, q_offset, self.cfg,
                kv_len=q_offset + c, sparse_items=items, last_index=c - 1)
        else:
            logits = tfm.prefill_chunk(
                self.params, self._staging, toks, 0, q_offset, self.cfg,
                kv_len=q_offset + c, sparse_items=items, last_index=c - 1)
        if not is_final:
            return None
        if not self.paged:
            # one copy lands the staged sequence in its slot row; stale
            # staging rows past it are masked by position, like bucket
            # padding
            self.cache[:, :, slot] = self._staging[:, :, 0]
        return int(sample(logits, sampling)[0])

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
        if ecfg.decode_worklist == "packed":
            items, real = self._plan_for(self._nb_sig(pos_all))
            grid = items.shape[0] * items.shape[1]
            work = {"packed_items": items}
        else:
            # padded baseline: every slot's position-aware selection at the
            # plan's max-budget width, refreshed at block boundaries
            bids = np.stack([self._decode_ids_for_nblocks(n)
                             for n in self._nb_sig(pos_all)], axis=1)
            real, grid = int((bids >= 0).sum()), int(bids.size)
            work = {"block_ids": torch.from_numpy(bids).to(dev)}
        args = (torch.from_numpy(tok_all).to(dev),
                torch.from_numpy(pos_all).to(dev))
        act = torch.from_numpy(act_all).to(dev)
        if self.paged:
            # -1 rows for unbound slots route their writes into the trash
            # block
            table = np.full((ecfg.num_slots, self.kv.table_width), -1,
                            np.int32)
            for s in slots:
                table[s] = self._table_for_slot(s)
            logits = tfm.decode_step_paged(
                self.params, self.kv.pool, *args,
                torch.from_numpy(table).to(dev), self.cfg, active=act,
                **work)
        else:
            logits = tfm.decode_step(self.params, self.cache, *args,
                                     self.cfg, active=act, **work)
        st = self.decode_stats
        st["ticks"] += 1
        st["real_items"] += real
        st["grid_items"] += grid
        return sample(logits, sampling).cpu().numpy()[list(slots)]

    # -- serving loop ---------------------------------------------------------
    def make_batcher(self) -> ContinuousBatcher:
        """A ContinuousBatcher for this engine.  Paged: it shares the pool's
        allocator, so admission and the device pool count the same blocks.
        Contiguous: its allocator is private accounting over
        ``num_slots * max_seq_len / block`` blocks."""
        ecfg = self.ecfg
        self._batcher = ContinuousBatcher(
            num_slots=ecfg.num_slots,
            num_blocks=(self.kv.num_blocks if self.paged else
                        ecfg.num_slots * (ecfg.max_seq_len // ecfg.block)),
            max_seq_len=ecfg.max_seq_len, block=ecfg.block,
            token_budget=ecfg.prefill_chunk_tokens,
            allocator=self.kv.alloc if self.paged else None)
        return self._batcher

    def step_fns(self, sampling: SamplingParams = SamplingParams()):
        """(prefill_chunk_fn, decode_fn) closures for a ContinuousBatcher."""
        def prefill_chunk(toks, slot, q_offset, is_final, prompt_len):
            return self.prefill_chunk_into_slot(
                toks[0], slot, q_offset, prompt_len, sampling,
                is_final=is_final)

        def decode(slots, toks, pos):
            return self.decode_slots(slots, toks, pos, sampling)

        return prefill_chunk, decode

    def serve(self, prompts: list[np.ndarray],
              sampling: SamplingParams = SamplingParams()) -> list[Request]:
        """Continuous-batching serve of a list of prompts.  Returns one
        Request per prompt in input order: completed requests carry their
        generated tokens, over-length ones come back ``rejected``."""
        sampler.check_supported(sampling)
        batcher = self.make_batcher()
        for i, pr in enumerate(prompts):
            batcher.submit(Request(rid=i, prompt=np.asarray(pr, np.int32),
                                   sampling=sampling))
        done = batcher.run(*self.step_fns(sampling))
        return sorted(done, key=lambda r: r.rid)
