"""Rotary position embeddings (split-halves convention, Llama-family)."""
from __future__ import annotations

import torch


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """Apply RoPE to ``x [..., S, Dh]`` at ``positions``.

    ``positions`` broadcasts against ``x[..., :1]``'s leading shape with the
    sequence axis last: ``[S]`` for one sequence, ``[B, 1, 1]`` for one
    position per batch row of a ``[B, H, 1, Dh]`` decode step.  Angles are
    computed in float32, like the reference.
    """
    dh = x.shape[-1]
    half = dh // 2
    inv = 1.0 / (theta ** (torch.arange(0, dh, 2, dtype=torch.float32,
                                        device=x.device) / dh))
    freqs = positions.to(torch.float32)[..., None] * inv   # [..., S, half]
    cos, sin = torch.cos(freqs), torch.sin(freqs)
    x1, x2 = x[..., :half], x[..., half:]
    xr1 = x1 * cos - x2 * sin
    xr2 = x2 * cos + x1 * sin
    return torch.cat([xr1, xr2], dim=-1).to(x.dtype)
