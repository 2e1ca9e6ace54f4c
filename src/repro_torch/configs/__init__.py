"""Model configurations the port serves: the transformer config type and
the registry of supported architectures."""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """The reference ``TransformerConfig`` fields the serving path reads
    (dense-FFN GQA decoder, global causal attention)."""

    name: str = "lm"
    num_layers: int = 2
    d_model: int = 256
    num_heads: int = 4
    num_kv_heads: int = 2
    d_ff: int = 512
    vocab_size: int = 1024
    head_dim: int | None = None
    rope_theta: float = 10000.0
    dtype: torch.dtype = torch.bfloat16
    block_q: int = 128
    block_kv: int = 128
    tie_embeddings: bool = True

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def group_size(self) -> int:
        return self.num_heads // self.num_kv_heads

    @property
    def num_params(self) -> int:
        """Exact parameter count (embeddings included once if tied)."""
        dh = self.head_dim_
        attn = self.d_model * dh * (self.num_heads * 2 + self.num_kv_heads * 2)
        per_layer = attn + 3 * self.d_model * self.d_ff + 2 * self.d_model
        embed = self.vocab_size * self.d_model
        head = 0 if self.tie_embeddings else embed
        return self.num_layers * per_layer + embed + head + self.d_model


def _registry():
    from repro_torch.configs import smollm_135m
    return {"smollm-135m": {"full": smollm_135m.FULL,
                            "smoke": smollm_135m.SMOKE}}


def get_config(arch: str, smoke: bool = False) -> TransformerConfig:
    """The FULL (published widths) or SMOKE (CPU test size) config of
    ``arch``; raises ``KeyError`` naming the supported archs otherwise."""
    reg = _registry()
    if arch not in reg:
        raise KeyError(f"unknown arch {arch!r}; the port serves {sorted(reg)}")
    return reg[arch]["smoke" if smoke else "full"]
