"""Token sampling: greedy, or temperature / top-k / top-p and a categorical
draw, the reference's ``serving/sampler.py`` in PyTorch.

The cut (:func:`filter_logits`) follows the reference's order and tie
rules: temperature, then top-k keeping every logit ``>=`` the k-th largest
(ties at the k-th all kept, so more than k may survive), then top-p
keeping every logit ``>=`` the cutoff logit, the first in descending order
whose softmax cumsum reaches ``top_p``.  The draw is a categorical sample
by the Gumbel-max rule (``jax.random.categorical``'s) from an explicit
``torch.Generator`` on the logits' device, so it stays on the card; its
bits are the generator's, not JAX's.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    temperature: float = 0.0     # 0 => greedy
    top_k: int = 0               # 0 => disabled
    top_p: float = 1.0           # 1 => disabled
    max_tokens: int = 64
    stop_token: int | None = None


def filter_logits(logits: torch.Tensor,
                  params: SamplingParams) -> torch.Tensor:
    """logits [B, V] -> the tempered logits with every token outside the
    top-k / top-p support at -inf (``params.temperature`` > 0)."""
    logits = logits / params.temperature
    if params.top_k > 0:
        k = min(params.top_k, logits.shape[-1])
        kth = torch.sort(logits, dim=-1).values[:, -k][:, None]
        logits = torch.where(logits >= kth, logits, -torch.inf)
    if params.top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        csum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        # the first index whose cumsum reaches top_p (0 if none does)
        cutoff_idx = torch.argmax((csum >= params.top_p).to(torch.int8),
                                  dim=-1)
        cutoff = sorted_logits.gather(-1, cutoff_idx[:, None])
        logits = torch.where(logits >= cutoff, logits, -torch.inf)
    return logits


def sample(logits: torch.Tensor, params: SamplingParams,
           generator: torch.Generator | None = None) -> torch.Tensor:
    """logits [B, V] -> tokens [B] int32.  Greedy (``temperature <= 0``):
    the argmax, first index on ties, drawing nothing.  Otherwise one
    categorical draw per row over :func:`filter_logits`, with uniforms
    from ``generator`` (required, on the logits' device)."""
    if params.temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    if generator is None:
        raise ValueError("stochastic sampling needs a torch.Generator")
    logits = filter_logits(logits.float(), params)
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    tiny = torch.finfo(torch.float32).tiny
    gumbel = -torch.log(-torch.log(u.clamp_min(tiny)))
    return torch.argmax(logits + gumbel, dim=-1).to(torch.int32)
