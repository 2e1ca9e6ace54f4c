"""Model configurations the port serves: the transformer and MoE config
types and the registry of supported architectures."""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """The reference's ``MoEConfig`` (``models/moe.py``): ``num_experts``
    experts, each token routed to its top ``experts_per_token``; an expert
    takes at most ``capacity`` rows of a call (:func:`repro_torch.models.moe.
    _capacity`), sized by ``capacity_factor``.  ``router_aux_weight`` weighs
    the training load-balancing loss (not computed by the serving path);
    ``quantize_dispatch`` round-trips the dispatched rows through int8 per
    token."""

    num_experts: int
    experts_per_token: int
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    quantize_dispatch: bool = False


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """The reference ``TransformerConfig`` fields the serving path reads
    (GQA decoder).  ``attn_pattern`` is cycled over the layers: 'G' global
    causal attention, 'L' causal attention within the last
    ``local_window`` positions (the decode kernels' ``window``).  The FFN
    is SwiGLU, or with ``moe`` a mixture of SwiGLU experts."""

    name: str = "lm"
    num_layers: int = 2
    d_model: int = 256
    num_heads: int = 4
    num_kv_heads: int = 2
    d_ff: int = 512
    vocab_size: int = 1024
    head_dim: int | None = None
    rope_theta: float = 10000.0
    attn_pattern: str = "G"
    local_window: int = 4096
    moe: MoEConfig | None = None
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

    def layer_kind(self, layer: int) -> str:
        return self.attn_pattern[layer % len(self.attn_pattern)]

    def _count(self, experts: int) -> int:
        """Parameters with ``experts`` expert FFNs a MoE layer (a dense
        layer has one FFN and no router)."""
        dh = self.head_dim_
        attn = self.d_model * dh * (self.num_heads * 2 + self.num_kv_heads * 2)
        ffn = 3 * self.d_model * self.d_ff
        if self.moe is not None:
            ffn = self.d_model * self.moe.num_experts + ffn * experts
        per_layer = attn + ffn + 2 * self.d_model
        embed = self.vocab_size * self.d_model
        head = 0 if self.tie_embeddings else embed
        return self.num_layers * per_layer + embed + head + self.d_model

    @property
    def num_params(self) -> int:
        """Exact parameter count (embeddings included once if tied)."""
        return self._count(self.moe.num_experts if self.moe else 1)

    @property
    def num_active_params(self) -> int:
        """Parameters a token runs through (a MoE layer's router and its
        ``experts_per_token`` experts): the reference's ``active_params``."""
        return self._count(self.moe.experts_per_token if self.moe else 1)


def _registry():
    from repro_torch.configs import (
        gemma3_1b, granite_moe_1b, llama4_scout, minitron_8b, smollm_135m,
        yi_6b)
    return {name: {"full": mod.FULL, "smoke": mod.SMOKE}
            for name, mod in (("smollm-135m", smollm_135m),
                              ("yi-6b", yi_6b),
                              ("gemma3-1b", gemma3_1b),
                              ("granite-moe-1b-a400m", granite_moe_1b),
                              ("llama4-scout-17b-a16e", llama4_scout),
                              ("minitron-8b", minitron_8b))}


def get_config(arch: str, smoke: bool = False) -> TransformerConfig:
    """The FULL (published widths) or SMOKE (CPU test size) config of
    ``arch``; raises ``KeyError`` naming the supported archs otherwise."""
    reg = _registry()
    if arch not in reg:
        raise KeyError(f"unknown arch {arch!r}; the port serves {sorted(reg)}")
    return reg[arch]["smoke" if smoke else "full"]
