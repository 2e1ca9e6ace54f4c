"""Attention helpers around the kernels: RoPE and static block policies."""
