"""Hand-written CUDA kernels of the serving main path, each beside its plain
PyTorch version.  Models and the engine call through ``kernels.ops``."""
