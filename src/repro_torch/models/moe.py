"""Mixture-of-Experts FFN with capacity-based sorted dispatch: the
reference's ``models/moe.py`` in PyTorch.

Every row of a call is routed together:

1. router: an f32 product, softmax, the top ``experts_per_token`` experts a
   row (ties to the lower expert id) and their renormalized gates;
2. the (row, choice) pairs sorted stably by expert, each pair's rank in
   its expert's run;
3. each expert takes at most ``capacity`` rows, ``_capacity(B * S)``: pairs
   ranked past it are DROPPED (the dump slot ``E * C``), so what a row gets
   depends on every row before it in the call;
4. the experts' SwiGLU FFNs as three batched products over ``[E, C, d]``;
5. each row's kept expert outputs, times their gates, summed in ascending
   expert order in the experts' dtype (the reference's scatter-add in slot
   order).  The combine is a gather and ``experts_per_token`` adds, not
   ``index_add_``: CUDA's atomics would sum in a varying order, and the
   paged and contiguous serves must give the same bits.

The products are plain large ``torch.bmm`` calls, as the reference's are
``jnp.einsum`` outside any Pallas kernel.  The training loss
(``return_aux``) is not ported.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs import MoEConfig


def _capacity(num_tokens: int, cfg: MoEConfig) -> int:
    """Rows an expert takes in a call of ``num_tokens`` rows: the
    reference's rounding (half up, then up to a multiple of 8, at least
    8)."""
    c = cfg.experts_per_token * num_tokens / cfg.num_experts
    c = int(c * cfg.capacity_factor + 0.5)
    return max(8, -(-c // 8) * 8)


def route(xf: torch.Tensor, router: torch.Tensor, cfg: MoEConfig):
    """Router and dispatch of ``xf [N, d]``: returns ``(slot [N, k] int64,
    gate [N, k] float32)``, each row's choices in ascending expert order;
    ``slot`` is ``expert * C + rank`` for a kept pair and ``E * C`` for a
    dropped one."""
    N = xf.shape[0]
    E, k = cfg.num_experts, cfg.experts_per_token
    C = _capacity(N, cfg)
    probs = torch.softmax(xf.float() @ router, dim=-1)            # [N, E]
    # jax.lax.top_k: descending, the lower index first on a tie
    gate, expert = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, expert = gate[:, :k], expert[:, :k]
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
    flat = expert.reshape(-1)
    order = torch.sort(flat, stable=True).indices                 # by expert
    se = flat[order]
    starts = torch.searchsorted(se, torch.arange(E, device=xf.device))
    rank = torch.arange(N * k, device=xf.device) - starts[se]
    slot_sorted = torch.where(rank < C, se * C + rank, E * C)
    slot = torch.empty_like(slot_sorted)
    slot[order] = slot_sorted
    slot = slot.view(N, k)
    by_expert = expert.argsort(dim=-1)                            # k distinct
    return slot.gather(1, by_expert), gate.gather(1, by_expert)


def _dispatch(xf: torch.Tensor, token_of_slot: torch.Tensor, E: int, C: int,
              quantize: bool) -> torch.Tensor:
    """The ``[E, C, d]`` rows each expert takes (zeros in unfilled slots),
    optionally through the int8 per-row round trip."""
    N, d = xf.shape
    if quantize:
        x32 = xf.float()
        scales = x32.abs().amax(-1, keepdim=True).clamp_min(1e-12) / 127.0
        x8 = torch.clamp(torch.round(x32 / scales), -127, 127).to(torch.int8)
        x8 = torch.cat([x8, x8.new_zeros((1, d))])
        spad = torch.cat([scales, scales.new_ones((1, 1))])
        xe = x8[token_of_slot].float() * spad[token_of_slot]
        return xe.to(xf.dtype).view(E, C, d)
    xpad = torch.cat([xf, xf.new_zeros((1, d))])
    return xpad[token_of_slot].view(E, C, d)


def moe_ffn(x: torch.Tensor, p: dict, cfg: MoEConfig) -> torch.Tensor:
    """``x [B, S, d]`` -> ``[B, S, d]``: the reference's ``moe_ffn`` with
    the params ``p`` (``router [d, E]`` float32, ``gate`` / ``up [E, d, f]``,
    ``down [E, f, d]``), all ``B * S`` rows routed together."""
    B, S, d = x.shape
    N = B * S
    E = cfg.num_experts
    C = _capacity(N, cfg)
    xf = x.reshape(N, d)
    slot, gate = route(xf, p["router"], cfg)
    # the row each slot takes (N: no row; the dump slot's entry is junk)
    token_of_slot = torch.full((E * C + 1,), N, dtype=torch.long,
                               device=x.device)
    token_of_slot[slot.reshape(-1)] = torch.arange(
        N, device=x.device).repeat_interleave(cfg.experts_per_token)
    xe = _dispatch(xf, token_of_slot[:E * C], E, C, cfg.quantize_dispatch)
    h = F.silu(torch.bmm(xe, p["gate"])) * torch.bmm(xe, p["up"])
    ye = torch.bmm(h, p["down"]).view(E * C, d)
    ye = torch.cat([ye, ye.new_zeros((1, d))])            # dump slot -> 0
    part = ye[slot] * gate.to(ye.dtype)[..., None]         # [N, k, d]
    out = torch.zeros_like(xf, dtype=ye.dtype)
    for j in range(cfg.experts_per_token):
        out = out + part[:, j]
    return out.view(B, S, d).to(x.dtype)
