"""Shared model building blocks (plain functions on tensors).

Weight layout follows the reference: projections are ``[in, out]`` with
heads along the output columns of Q/K/V and the input rows of O.
Activations run in the weights' dtype with float32 normalization
statistics and float32 logits.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6):
    xf = x.to(torch.float32)
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * w.to(torch.float32)).to(x.dtype)


def swiglu(x, w_gate, w_up, w_down):
    """SwiGLU MLP: down( silu(x @ gate) * (x @ up) )."""
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[..., S, H*D] -> [..., H, S, D]"""
    *b, s, hd = x.shape
    return x.reshape(*b, s, num_heads, hd // num_heads).transpose(-3, -2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """[..., H, S, D] -> [..., S, H*D]"""
    *b, h, s, d = x.shape
    return x.transpose(-3, -2).reshape(*b, s, h * d)
