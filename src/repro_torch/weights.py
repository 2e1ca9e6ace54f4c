"""Convert the JAX reference's parameter pytree into the port's tensors."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs import TransformerConfig


def _to_tensor(a, device) -> torch.Tensor:
    a = np.array(a)   # a writable, contiguous copy
    if a.dtype.name == "bfloat16":
        # ml_dtypes.bfloat16 has no torch counterpart in numpy: move the raw
        # bits as int16 and reinterpret them (the snapshot format's trick)
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(
            device)
    return torch.from_numpy(a).to(device)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def params_from_jax(np_params: dict, cfg: TransformerConfig,
                    device: str | torch.device = "cuda") -> dict:
    """The reference's transformer params with numpy leaves -> the port's
    param dict on ``device``.

    ``np_params`` is the JAX pytree with every leaf already a numpy array
    (bfloat16 leaves as ``ml_dtypes.bfloat16``).  Stacked layers (the
    reference's scan layout, every leaf ``[L, ...]``) and per-layer lists
    are both accepted; the result always holds a list of per-layer dicts.
    Values and dtypes are kept bit for bit.
    """
    layers = np_params["layers"]
    if isinstance(layers, dict):
        layers = [_tree_map(lambda a, l=l: np.asarray(a)[l], layers)
                  for l in range(cfg.num_layers)]
    if len(layers) != cfg.num_layers:
        raise ValueError(f"params hold {len(layers)} layers, config "
                         f"{cfg.num_layers}")
    conv = lambda a: _to_tensor(a, device)          # noqa: E731
    out = {k: _tree_map(conv, v) for k, v in np_params.items()
           if k != "layers"}
    out["layers"] = [_tree_map(conv, lp) for lp in layers]
    return out
