"""Token sampling (greedy)."""
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


def check_supported(params: SamplingParams) -> None:
    """Raise ``NotImplementedError`` unless ``params`` is greedy."""
    if params.temperature > 0.0 or params.top_k > 0 or params.top_p < 1.0:
        raise NotImplementedError(
            "stochastic sampling is not ported yet: use temperature=0")


def sample(logits: torch.Tensor, params: SamplingParams) -> torch.Tensor:
    """logits [B, V] -> tokens [B] int32 (greedy argmax, first index on
    ties like the reference)."""
    check_supported(params)
    return torch.argmax(logits, dim=-1).to(torch.int32)
