"""PyTorch/CUDA port of the S-HPLB serving system.

A second package beside the JAX reference (``src/repro``): the same host
planning (profiles, budgets, head partitioning, work lists), a PyTorch model
and serving engine, and hand-written CUDA kernels for the two attention
functions of the serving main path.  Importing it sets no global torch state
and builds nothing: kernels compile at first use on the card.
"""
