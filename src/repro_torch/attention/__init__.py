"""Attention helpers around the kernels: RoPE, static block policies and
the profiling stage's softmax maps."""
