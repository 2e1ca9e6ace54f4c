"""Crash-consistent serving checkpoints (DESIGN.md §2.13): the reference
package's ``serving/snapshot.py`` for the port's engine.

A serving engine's durable state lies in five places: the device KV cache
(codes and, quantized, scales), the allocator's two-tier block accounting
(and the radix prefix tree), the scheduler's queues, slots and in-flight
requests, the host swap tier, and the plan epoch (placement and the
cumulative kv-head arrangement).  :func:`save_serving` snapshots all of
them at a safe tick boundary (no prefill in flight, the point epoch swaps
use) into one ``.npz`` written to a temporary name and renamed, so a kill
mid-save never tears the previous snapshot.

:func:`restore_serving` builds a fresh engine from the ORIGINAL params and
profile, replays the saved plan as one epoch swap (plan deltas are
determined by their end points, so the restored weights equal the crashed
engine's bit for bit), adopts the saved cache, allocator, tree, scheduler
and host tier, and returns an ``(engine, batcher)`` pair that resumes the
in-flight decodes with the tokens of the uninterrupted run.

The layout is the reference's, so the port restores a snapshot the JAX
engine wrote: array keys ``cache/pool``, ``cache/scales``,
``engine/kv_arrange``, ``hswap/<rid>/{data,scales,arrange}`` and
``req/<rid>/{prompt,generated}``; bfloat16 stored as its 16 bits under a
``#bf16`` key suffix; the JSON metadata inside the archive as a uint8
array under ``meta#json``; ``FORMAT_VERSION`` 2.  The port adds two
things: the sampling generator's state under ``engine/torch_rng`` (in
place of the reference's JAX key, ``engine/rng``, which it does not read),
and float8 codes as their 8 bits under a ``#fp8`` suffix.
"""
from __future__ import annotations

import dataclasses
import json
import logging
import os
import time
from collections import deque

import numpy as np
import torch

from repro_torch.core.planner import HPLBPlan, plans_equal
from repro_torch.serving.sampler import SamplingParams
from repro_torch.serving.scheduler import Request, SchedulerStats

log = logging.getLogger(__name__)

FORMAT_VERSION = 2           # v2: prefix-tree state + retained-prefix counts
_COMPAT_VERSIONS = (1, 2)    # v1 snapshots load (no sharing to restore)
_BF16_SUFFIX = "#bf16"
_FP8_SUFFIX = "#fp8"
_META_KEY = "meta#json"
_RNG_KEY = "engine/torch_rng"


def _enc(arrays: dict, key: str, t) -> None:
    """Stash one tensor (or array) on the host, bfloat16 as its 16 bits and
    float8 as its 8 bits under their key suffixes (npz holds neither)."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            arrays[key + _BF16_SUFFIX] = t.view(torch.int16).numpy().view(
                np.uint16)
            return
        if t.element_size() == 1 and t.is_floating_point():
            arrays[key + _FP8_SUFFIX] = t.view(torch.uint8).numpy()
            return
        t = t.numpy()
    arrays[key] = np.asarray(t)


def _dec(z, key: str, dtype: torch.dtype | None = None) -> torch.Tensor:
    """The tensor under ``key`` on the host: a ``#bf16`` entry as
    bfloat16, a ``#fp8`` one as ``dtype`` (its float8 type), else as
    stored.  ``dtype`` casts a plain entry (never a bit pattern)."""
    if key + _BF16_SUFFIX in z.files:
        return torch.from_numpy(
            z[key + _BF16_SUFFIX].view(np.int16).copy()).view(torch.bfloat16)
    if key + _FP8_SUFFIX in z.files:
        return torch.from_numpy(z[key + _FP8_SUFFIX].copy()).view(dtype)
    t = torch.from_numpy(np.array(z[key]))
    return t if dtype is None or dtype.itemsize == 1 else t.to(dtype)


def _has(z, key: str) -> bool:
    return any(key + sfx in z.files for sfx in ("", _BF16_SUFFIX,
                                                 _FP8_SUFFIX))


def _req_meta(req: Request, arrival: int) -> dict:
    return {
        "priority": req.priority,
        "sampling": dataclasses.asdict(req.sampling),
        "prefill_pos": int(req.prefill_pos),
        "preemptions": int(req.preemptions),
        "arrival": int(arrival),
        "t_submit": req.t_submit,
        "token_times": list(req.token_times),
    }


def save_serving(directory: str, engine, batcher,
                 tag: str | None = None) -> str:
    """Snapshot the whole serving state at a safe tick boundary (between
    ticks, ``batcher.replan_safe``: the engine's checkpoint policy keeps
    this; direct callers must too).  Pending host copies are waited for
    first.  Returns the written path (``serving_<decode_ticks>.npz``, or
    ``serving_<tag>.npz``)."""
    if not batcher.replan_safe:
        raise ValueError("serving snapshots only at safe points (no prefill "
                         "in flight)")
    os.makedirs(directory, exist_ok=True)
    engine._reap_transfers(wait=True)
    arrays: dict[str, np.ndarray] = {}

    # -- device cache (codes and scales together, like every move) -------
    codes, scales = engine._live_cache()
    _enc(arrays, "cache/pool", codes)
    if scales is not None:
        _enc(arrays, "cache/scales", scales)
    _enc(arrays, _RNG_KEY, engine.rng.get_state())
    _enc(arrays, "engine/kv_arrange", engine._kv_arrange)

    # -- host swap tier ----------------------------------------------------
    hswap_meta = {}
    for rid, rec in engine._host_swaps.items():
        data, sdata = engine.host_copy(rid)
        _enc(arrays, f"hswap/{rid}/data", data)
        if sdata is not None:
            _enc(arrays, f"hswap/{rid}/scales", sdata)
        _enc(arrays, f"hswap/{rid}/arrange", rec["arrange"])
        hswap_meta[str(rid)] = {
            "tokens": int(rec["tokens"]),
            # blocks the swapped sequence keeps resident (shared prefix);
            # swap-in scatters the host payload past them
            "shared_blocks": int(rec.get("shared_blocks", 0)),
        }

    # -- scheduler: every request not yet finished --------------------------
    reqs: dict[int, Request] = {}
    for q in batcher._queues.values():
        for r in q:
            reqs[r.rid] = r
    for q in batcher._preempted.values():
        for r in q:
            reqs[r.rid] = r
    reqs.update(batcher.active)
    req_meta = {}
    for rid, r in reqs.items():
        _enc(arrays, f"req/{rid}/prompt", np.asarray(r.prompt, np.int32))
        _enc(arrays, f"req/{rid}/generated",
             np.asarray(r.generated, np.int32))
        req_meta[str(rid)] = _req_meta(r, batcher._arrival[rid])

    meta = {
        "version": FORMAT_VERSION,
        "time": time.time(),
        "engine": {
            "epoch": int(engine.epoch),
            "decode_ticks": int(engine._decode_ticks),
            "ticks_since_replan": int(engine._ticks_since_replan),
            "replans": int(engine.replans),
            "plan": (engine.plan.to_json() if engine.plan is not None
                     else None),
        },
        "alloc": batcher.alloc.snapshot_state(),
        # the radix prefix cache: the whole tree (content keys, block ids,
        # LRU clocks), so a restored server keeps its hits warm and evicts
        # in the order the uninterrupted one would
        "prefix_tree": (engine.prefix.snapshot_state()
                        if engine.prefix is not None else None),
        "hswap_tokens": hswap_meta,
        "requests": req_meta,
        "scheduler": {
            "queues": {n: [r.rid for r in q]
                       for n, q in batcher._queues.items()},
            "preempted": {n: [r.rid for r in q]
                          for n, q in batcher._preempted.items()},
            "active": sorted(batcher.active),
            "lengths": {str(k): int(v) for k, v in batcher.lengths.items()},
            "slots_free": list(batcher._slots_free),
            "slot_of": {str(k): int(v)
                        for k, v in batcher._slot_of.items()},
            "arrivals": int(batcher._arrivals),
            "stride": dict(batcher._stride),
            "ema_decode_s": batcher.ema_decode_s,
            "ema_prefill_s_per_tok": batcher.ema_prefill_s_per_tok,
            "stats": dataclasses.asdict(batcher.stats),
        },
    }
    arrays[_META_KEY] = np.frombuffer(
        json.dumps(meta).encode("utf-8"), dtype=np.uint8)

    name = f"serving_{tag if tag is not None else engine._decode_ticks}.npz"
    path = os.path.join(directory, name)
    tmp = path + f".tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.rename(tmp, path)   # atomic: a crash mid-save leaves the old file
    log.info("serving snapshot -> %s (%d arrays, %d in-flight requests)",
             path, len(arrays), len(reqs))
    return path


def latest_snapshot(directory: str) -> str | None:
    """The most recently written ``serving_*.npz`` in ``directory``."""
    if not os.path.isdir(directory):
        return None
    cands = [os.path.join(directory, f) for f in os.listdir(directory)
             if f.startswith("serving_") and f.endswith(".npz")]
    return max(cands, key=os.path.getmtime) if cands else None


def restore_serving(path: str, cfg, params, engine_cfg, profile=None,
                    classes=None, injector=None,
                    device: str | torch.device = "cuda"):
    """Rebuild a serving engine and batcher on ``device`` from a
    :func:`save_serving` snapshot (the port's, or the reference's: see the
    module docstring).  ``cfg`` / ``params`` / ``engine_cfg`` / ``profile``
    are those the crashed engine was launched with (params un-permuted,
    the offline profile); the snapshot replays its plan on top of them.
    Returns ``(engine, batcher)``, ready to tick; the restored state is
    audited first, so a torn or corrupt snapshot fails here."""
    from repro_torch.serving.engine import Engine

    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(bytes(z[_META_KEY].tobytes()).decode("utf-8"))
        if meta["version"] not in _COMPAT_VERSIONS:
            raise ValueError(f"snapshot version {meta['version']} not in "
                             f"{_COMPAT_VERSIONS}")
        em = meta["engine"]
        eng = Engine(cfg, params, engine_cfg, profile, device=device,
                     injector=injector)

        # -- plan epoch: replay the saved placement as one delta swap ------
        if em["plan"] is not None:
            saved_plan = HPLBPlan.from_json(em["plan"])
            if eng.plan is not None and not plans_equal(eng.plan,
                                                        saved_plan):
                eng.replan_now(plan=saved_plan)
        if eng.plan is not None and eng.epoch != em["epoch"]:
            eng.plan = dataclasses.replace(eng.plan, epoch=em["epoch"])
            eng.epoch = em["epoch"]
            eng._epoch_stats.setdefault(em["epoch"],
                                        eng._fresh_epoch_stats())
            eng._purge_plan_memos()
        eng.replans = em["replans"]
        eng._decode_ticks = em["decode_ticks"]
        eng._ticks_since_replan = em["ticks_since_replan"]
        eng._kv_arrange = np.array(z["engine/kv_arrange"])
        if _has(z, _RNG_KEY):
            eng.rng.set_state(_dec(z, _RNG_KEY))

        # -- device cache --------------------------------------------------
        codes, scales = eng._live_cache()
        new_codes = _dec(z, "cache/pool", codes.dtype).to(eng.device)
        new_scales = (None if scales is None else
                      _dec(z, "cache/scales", scales.dtype).to(eng.device))
        eng._adopt_cache(new_codes, new_scales)

        # -- host swap tier (host copies hold one-byte codes as int8) ------
        eng._host_swaps = {}
        blk = eng.ecfg.block
        for rid_s, hm in meta["hswap_tokens"].items():
            rid = int(rid_s)
            if not isinstance(hm, dict):   # v1: a bare token count
                hm = {"tokens": hm, "shared_blocks": 0}
            data = _dec(z, f"hswap/{rid}/data", codes.dtype)
            if data.element_size() == 1:
                data = data.view(torch.int8)
            sdata = (_dec(z, f"hswap/{rid}/scales", torch.float32)
                     if _has(z, f"hswap/{rid}/scales") else None)
            if not eng.paged:
                # the reference's slot copies span a pow2 bucket of blocks:
                # keep the resident blocks the swap-in writes
                nblk = -(-int(hm["tokens"]) // blk)
                data = data[:, :, :, :, :nblk * blk]
                sdata = None if sdata is None else sdata[..., :nblk]
            eng._host_swaps[rid] = {
                "data": data, "scales": sdata,
                "tokens": int(hm["tokens"]),
                "shared_blocks": int(hm.get("shared_blocks", 0)),
                "arrange": np.array(z[f"hswap/{rid}/arrange"]),
                "event": None,
            }

        # -- scheduler, allocator, prefix tree -----------------------------
        b = eng.make_batcher(classes)
        b.alloc.load_state(meta["alloc"])   # audits itself
        if eng.prefix is not None and meta.get("prefix_tree"):
            # after the allocator: its cache pins are restored already
            # (cache_block is idempotent), and the final audit checks that
            # tree and pins agree
            eng.prefix.load_state(meta["prefix_tree"])
        reqs: dict[int, Request] = {}
        arrival: dict[int, int] = {}
        for rid_s, rm in meta["requests"].items():
            rid = int(rid_s)
            req = Request(rid=rid,
                          prompt=np.array(z[f"req/{rid}/prompt"]),
                          sampling=SamplingParams(**rm["sampling"]),
                          priority=rm["priority"])
            req.generated = [int(t) for t in z[f"req/{rid}/generated"]]
            req.prefill_pos = rm["prefill_pos"]
            req.preemptions = rm["preemptions"]
            req.t_submit = rm["t_submit"]
            req.token_times = list(rm["token_times"])
            reqs[rid] = req
            arrival[rid] = rm["arrival"]
        sm = meta["scheduler"]
        for name, rids in sm["queues"].items():
            b._queues[name] = deque(reqs[r] for r in rids)
        for name, rids in sm["preempted"].items():
            b._preempted[name] = deque(reqs[r] for r in rids)
        b.active = {r: reqs[r] for r in sm["active"]}
        b.prefilling = None   # snapshots happen only at safe points
        b.lengths = {int(k): v for k, v in sm["lengths"].items()}
        b._slots_free = list(sm["slots_free"])
        b._slot_of = {int(k): v for k, v in sm["slot_of"].items()}
        b._rid_of = {v: k for k, v in b._slot_of.items()}
        b._arrival = arrival
        b._arrivals = sm["arrivals"]
        b._stride = dict(sm["stride"])
        b.ema_decode_s = sm["ema_decode_s"]
        b.ema_prefill_s_per_tok = sm["ema_prefill_s_per_tok"]
        st = dict(sm["stats"])
        per_class = st.pop("per_class", {})
        b.stats = SchedulerStats(**st)
        b.stats.per_class = {k: dict(v) for k, v in per_class.items()}
    eng.audit()
    log.info("restored serving state from %s: epoch=%d tick=%d (%d active, "
             "%d queued, %d swapped)", path, eng.epoch, eng._decode_ticks,
             len(b.active), sum(len(q) for q in b._queues.values()),
             len(eng._host_swaps))
    return eng, b
