"""Static KV-block selection policies (host-side numpy), copied from the
reference package's ``attention/policies.py``.

A policy answers: given head h's block budget nb at query block qb, which
kv blocks participate?  All selections are causal (kv_blk <= q_blk) and
deterministic.  The dynamic score estimators (Quest, antidiagonal) are not
ported yet.
"""
from __future__ import annotations

import functools

import numpy as np


@functools.lru_cache(maxsize=4096)
def _streaming_cached(head, nb, nq, nkv, sink_blocks):
    return _streaming_impl(head, nb, nq, nkv, sink_blocks)


def streaming_policy(head: int, nb: int, nq: int, nkv: int,
                     sink_blocks: int = 1) -> list[np.ndarray]:
    return _streaming_cached(int(head), int(nb), int(nq), int(nkv),
                             int(sink_blocks))


def _streaming_impl(head: int, nb: int, nq: int, nkv: int,
                    sink_blocks: int = 1) -> list[np.ndarray]:
    """sink + recent blocks under a per-head block budget ``nb``."""
    out = []
    for qb in range(nq):
        avail = qb + 1  # causal: blocks 0..qb
        n = min(nb, avail)
        n_sink = min(sink_blocks, n)
        n_recent = n - n_sink
        sel = list(range(n_sink))
        sel += list(range(qb - n_recent + 1, qb + 1))
        out.append(np.unique(np.asarray(sel, dtype=np.int64)))
    return out


@functools.lru_cache(maxsize=4096)
def _strided_cached(head, nb, nq, nkv, sink_blocks, local_blocks):
    return _strided_impl(head, nb, nq, nkv, sink_blocks, local_blocks)


def strided_policy(head: int, nb: int, nq: int, nkv: int,
                   sink_blocks: int = 1, local_blocks: int = 2
                   ) -> list[np.ndarray]:
    return _strided_cached(int(head), int(nb), int(nq), int(nkv),
                           int(sink_blocks), int(local_blocks))


def _strided_impl(head: int, nb: int, nq: int, nkv: int,
                  sink_blocks: int = 1, local_blocks: int = 2
                  ) -> list[np.ndarray]:
    """sink + local diagonal band + strided middle blocks (vertical-ish).

    The stride phase is head-dependent so different heads cover different
    columns — the block-granular analogue of per-head vertical lines.
    """
    out = []
    for qb in range(nq):
        avail = qb + 1
        n = min(nb, avail)
        sel = set(range(min(sink_blocks, n)))
        for i in range(local_blocks):
            if len(sel) >= n:
                break
            b = qb - i
            if b >= 0:
                sel.add(b)
        middle = [b for b in range(sink_blocks, qb - local_blocks + 1)]
        if middle and len(sel) < n:
            want = n - len(sel)
            stride = max(1, len(middle) // want)
            phase = head % stride
            for b in middle[phase::stride]:
                if len(sel) >= n:
                    break
                sel.add(b)
            # fill any remainder densely from the most recent middle blocks
            for b in reversed(middle):
                if len(sel) >= n:
                    break
                sel.add(b)
        out.append(np.array(sorted(sel), dtype=np.int64))
    return out


def policy_by_name(name: str):
    """Static policy factory for the engine / dry-run."""
    if name == "streaming":
        return streaming_policy
    if name == "strided":
        return strided_policy
    raise ValueError(f"unknown static policy {name!r}")
