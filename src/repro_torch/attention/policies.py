"""KV-block selection policies, copied from the reference package's
``attention/policies.py``.

A policy answers: given head h's block budget nb at query block qb, which
kv blocks participate?  The static policies (streaming, strided) are
host-side numpy.  The dynamic score estimators are torch ops on the
tensors' device: :func:`quest_block_scores` (Quest's per-block key min /
max upper bound, the summary the plan-epoch telemetry probe uses) and
:func:`antidiagonal_block_scores` (XAttention's strided antidiagonal
sums); :func:`topk_select` turns scores into selections under per-head
block budgets.  All selections are causal (kv_blk <= q_blk) and
deterministic.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=4096)
def _streaming_cached(head, nb, nq, nkv, sink_blocks):
    return _streaming_impl(head, nb, nq, nkv, sink_blocks)


def streaming_policy(head: int, nb: int, nq: int, nkv: int,
                     sink_blocks: int = 1) -> list[np.ndarray]:
    # a new list each call: a caller that replaces an entry must not
    # change what the memo hands the next caller
    return list(_streaming_cached(int(head), int(nb), int(nq), int(nkv),
                                  int(sink_blocks)))


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
    return list(_strided_cached(int(head), int(nb), int(nq), int(nkv),
                                int(sink_blocks), int(local_blocks)))


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


# ---------------------------------------------------------------------------
# Dynamic score estimators (torch, on the tensors' device)
# ---------------------------------------------------------------------------

def quest_block_scores(q: torch.Tensor, k: torch.Tensor, block: int,
                       k_scales: torch.Tensor | None = None) -> torch.Tensor:
    """Quest-style block upper-bound scores.

    q: [H, Sq, Dh]; k: [Hkv, Skv, Dh] -> scores [H, nq, nkv] (f32).
    Per kv block: elementwise min/max over keys; score of (q, blk) =
    sum_d max(q_d * min_d, q_d * max_d), maxed over queries in the q block.
    Key rows past Skv (padding of the last block) enter no summary, and a
    block with none of its keys is summarized as zeros.

    With a quantized cache pass ``k_scales [Hkv, Skv/block]`` (codes in
    ``k``): the summaries are taken on the dequantized keys (scales are per
    block and positive).
    """
    hq, sq, dh = q.shape
    hkv, skv, _ = k.shape
    n_rep = hq // hkv
    qp = F.pad(q.float(), (0, 0, 0, (-sq) % block))
    kp = F.pad(k.float(), (0, 0, 0, (-skv) % block))
    nq, nkv = qp.shape[1] // block, kp.shape[1] // block
    kb = kp.reshape(hkv, nkv, block, dh)
    if k_scales is not None:
        ks = F.pad(k_scales.float(), (0, nkv - k_scales.shape[1]), value=1.0)
        kb = kb * ks[:, :, None, None]
    kreal = (torch.arange(nkv * block, device=k.device) < skv).reshape(
        nkv, block)
    kmask = kreal[None, :, :, None]
    kmin = torch.where(kmask, kb, torch.inf).amin(dim=2)   # [Hkv, nkv, dh]
    kmax = torch.where(kmask, kb, -torch.inf).amax(dim=2)
    has_real = kreal.any(dim=1)[None, :, None]
    kmin = torch.where(has_real, kmin, 0.0).repeat_interleave(n_rep, dim=0)
    kmax = torch.where(has_real, kmax, 0.0).repeat_interleave(n_rep, dim=0)
    qb = qp.reshape(hq, nq, block, dh)
    # sum_d max(q_d kmin_d, q_d kmax_d) = relu(q).kmax + min(q, 0).kmin
    ub = (torch.einsum("hqbd,hkd->hqbk", qb.clamp_min(0.0), kmax)
          + torch.einsum("hqbd,hkd->hqbk", qb.clamp_max(0.0), kmin))
    return ub.amax(dim=2)


def antidiagonal_block_scores(q: torch.Tensor, k: torch.Tensor, block: int,
                              stride: int = 16) -> torch.Tensor:
    """XAttention-style antidiagonal importance estimate per tile.

    Sums ``block/stride`` antidiagonal strips of each (q_blk, kv_blk) logits
    tile using strided row/col subsampling, at block granularity:
    score[h, qb, kb] = the largest antidiagonal sum of the subsampled tile.
    q: [H, Sq, Dh]; k: [Hkv, Skv, Dh] -> [H, nq, nkv] (f32).
    """
    hq, sq, dh = q.shape
    hkv, skv, _ = k.shape
    n_rep = hq // hkv
    qp = F.pad(q.float(), (0, 0, 0, (-sq) % block))
    kp = F.pad(k.float(), (0, 0, 0, (-skv) % block))
    nq, nkv = qp.shape[1] // block, kp.shape[1] // block
    qs = qp.reshape(hq, nq, block, dh)[:, :, ::stride, :]
    ks = kp.reshape(hkv, nkv, block, dh)[:, :, ::stride, :]
    ks = ks.repeat_interleave(n_rep, dim=0)
    s = torch.einsum("hqad,hkbd->hqkab", qs, ks) * dh ** -0.5
    bs = s.shape[-1]
    ar = torch.arange(bs, device=q.device)
    idx = (ar[:, None] + ar[None, :]) % bs      # [i, j] -> antidiagonal id
    oh = (idx[..., None] == ar[None, None, :]).float()
    sums = torch.einsum("hqkab,abd->hqkd", s, oh)
    return sums.amax(dim=-1)


def topk_select(scores, budgets_blocks, *, keep_sink: bool = True,
                keep_local: bool = True) -> list[list[np.ndarray]]:
    """Scores [H, nq, nkv] (numpy or a tensor) + per-head block budgets ->
    selections.

    Per (head, q_blk): rank causal blocks by score desc, keep the top
    ``nb[h]`` (always including block 0 and the diagonal block when asked).
    """
    if isinstance(scores, torch.Tensor):
        scores = scores.detach().cpu().numpy()
    scores = np.asarray(scores)
    H, nq, nkv = scores.shape
    budgets_blocks = np.asarray(budgets_blocks, dtype=np.int64)
    out: list[list[np.ndarray]] = []
    for h in range(H):
        rows = []
        for qb in range(nq):
            avail = qb + 1
            nb = int(min(budgets_blocks[h], avail))
            forced = []
            if keep_sink:
                forced.append(0)
            if keep_local:
                forced.append(qb)
            forced = sorted(set(b for b in forced if b <= qb))
            s = scores[h, qb, :avail].copy()
            s[forced] = np.inf  # force-keep
            order = np.argsort(-s, kind="stable")[:nb]
            rows.append(np.sort(order).astype(np.int64))
        out.append(rows)
    return out


def policy_by_name(name: str):
    """Static policy factory for the engine / dry-run."""
    if name == "streaming":
        return streaming_policy
    if name == "strided":
        return strided_policy
    raise ValueError(f"unknown static policy {name!r}")
