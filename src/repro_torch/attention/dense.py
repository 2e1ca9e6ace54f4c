"""Softmax attention maps for the offline profiling stage: the reference's
``attention/dense.py::attention_maps`` in plain torch ops.

Profiling needs every probability of every (query, key) pair, so this is
the plain product and softmax, not a kernel: an offline step off the
serving path.
"""
from __future__ import annotations

import torch

# the reference's masked-logit value (``repro/attention/masks.py``)
NEG_INF = -1e30


def repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """GQA: repeat kv heads along the head axis (``[..., Hkv, S, D]`` ->
    ``[..., Hkv*n_rep, S, D]``, each kv head ``n_rep`` times in a row)."""
    return k if n_rep == 1 else k.repeat_interleave(n_rep, dim=-3)


def attention_maps(q: torch.Tensor, k: torch.Tensor, *, causal: bool = True,
                   scale: float | None = None) -> torch.Tensor:
    """Post-softmax attention probabilities ``[..., Hq, Sq, Skv]`` float32
    of ``q [..., Hq, Sq, Dh]`` against ``k [..., Hkv, Skv, Dh]``: float32
    logits, the causal mask at :data:`NEG_INF`, softmax over the keys."""
    *_, hq, sq, dh = q.shape
    k = repeat_kv(k, hq // k.shape[-3])
    scale = (dh ** -0.5) if scale is None else scale
    logits = torch.einsum("...hqd,...hkd->...hqk", q.to(torch.float32),
                          k.to(torch.float32)) * scale
    if causal:
        skv = k.shape[-2]
        cm = (torch.arange(skv, device=q.device)[None, :]
              <= torch.arange(sq, device=q.device)[:, None])
        logits = torch.where(cm, logits, NEG_INF)
    return torch.softmax(logits, dim=-1)
