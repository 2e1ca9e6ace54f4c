"""Sharding rules for the transformer family's parameters, inputs and KV
cache: the counterpart of the reference's ``sharding/specs.py``.

A spec is a tuple with one entry a dimension: ``None`` (replicated), a
mesh axis name, or a tuple of names (the dimension split over their
product, row-major in mesh order).  Rules are chosen by the leaf's path
(``layers/[3]/attn/wq``) and rank, then sanitised against the mesh: a
dimension its axes do not divide stays replicated, as in the reference.

Axis conventions (the reference's, over the port's mesh):

    batch-like dims    -> 'data'
    head / ffn / vocab -> 'model'   [tensor parallel; heads in plan order]
    experts            -> 'model'   [the rule; see shard_params]
    cache sequence     -> 'model' when the kv heads do not divide it, and
                          'seq' (the 2D mesh's stripe axis) when present

:func:`shard_params` and :func:`local_slice` cut full tensors into this
rank's blocks.  The reference hands GSPMD whole specs and lets it insert
the collectives; here the few places where a rank needs a whole weight
are explicit (:func:`shard_params`).
"""
from __future__ import annotations

import math
import re

import torch

# (path regex, {rank: logical spec}), checked in order; the attention,
# dense-MLP, MoE and embedding entries of the reference's _PARAM_RULES
_PARAM_RULES: list[tuple[str, dict[int, tuple]]] = [
    (r".*(wq|wk|wv)$",        {2: (None, "model"), 3: (None, None, "model")}),
    (r".*wo$",                {2: ("model", None), 3: (None, "model", None)}),
    (r".*moe/(gate|up|down)$", {3: ("model", None, None),
                                4: (None, "model", None, None)}),
    (r".*router$",            {2: (None, None), 3: (None, None, None)}),
    (r".*(gate|up)$",         {2: (None, "model"), 3: (None, None, "model")}),
    (r".*down$",              {2: ("model", None), 3: (None, "model", None)}),
    (r".*embed$",             {2: ("model", None)}),
    (r".*lm_head$",           {2: (None, "model")}),
]
BATCH_AXES = ("data",)
LIST_MODES = ("kv_group", "kv_replication", "rows")


def _sizes(mesh) -> dict[str, int]:
    """Axis sizes of a :class:`repro_torch.launch.mesh.Mesh` or a dict."""
    return dict(mesh if isinstance(mesh, dict) else mesh.shape)


def _entry(axes: tuple):
    return axes[0] if len(axes) == 1 else tuple(axes)


def _resolve(logical: tuple, shape: tuple, sizes: dict[str, int]) -> tuple:
    """Logical -> physical spec: ``"batch"`` becomes the batch axes, and an
    axis that does not divide its dimension is dropped (replicated)."""
    out = []
    for ax, dim in zip(logical, shape):
        axes = (tuple(a for a in BATCH_AXES if a in sizes) if ax == "batch"
                else () if ax is None else (ax,))
        total = math.prod(sizes.get(a, 1) for a in axes)
        ok = axes and all(a in sizes for a in axes) and dim % total == 0
        out.append(_entry(axes) if ok else None)
    return tuple(out)


def _map(fn, tree, path=""):
    if isinstance(tree, dict):
        return {k: _map(fn, v, f"{path}/{k}" if path else k)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v, f"{path}/[{i}]")
                          for i, v in enumerate(tree))
    return fn(path, tree)


def param_spec(path: str, shape: tuple, mesh) -> tuple:
    """The spec of the parameter at ``path`` (``/``-joined keys, list
    indices as ``[i]``) with ``shape``; replicated if no rule matches."""
    for pat, by_rank in _PARAM_RULES:
        if re.match(pat, path) and len(shape) in by_rank:
            return _resolve(by_rank[len(shape)], tuple(shape), _sizes(mesh))
    return (None,) * len(shape)   # norms, scalars


def param_specs(params, mesh):
    """The tree of specs matching a parameter tree (tensors or shapes)."""
    return _map(lambda p, x: param_spec(p, tuple(x.shape), mesh), params)


def batch_specs(batch, mesh):
    """Inputs: the leading dimension over the batch axes, the rest
    replicated."""
    return _map(lambda p, x: _resolve(
        ("batch",) + (None,) * (len(x.shape) - 1), tuple(x.shape),
        _sizes(mesh)), batch)


def cache_seq_axes(batch: int, kv_heads: int, mesh) -> tuple:
    """The axes :func:`cache_spec` puts on a cache's sequence, in mesh
    order, where their product divides it: ``data`` when the batch does
    not divide over it, ``model`` when the kv heads do not, and ``seq``."""
    sizes = _sizes(mesh)
    axes = []
    data = tuple(a for a in BATCH_AXES if sizes.get(a, 1) > 1)
    if data and batch % math.prod(sizes[a] for a in data):
        axes.extend(data)
    model = sizes.get("model", 1)
    if model > 1 and kv_heads % model:
        axes.append("model")
    if sizes.get("seq", 1) > 1:
        axes.append("seq")
    return tuple(axes)


def cache_spec(shape: tuple, mesh) -> tuple:
    """The spec of a contiguous KV cache ``[L, 2, B, Hkv, S, Dh]`` (the
    reference's ``cache_specs``): the batch over ``data`` when it divides,
    else ``data`` joins the sequence; ``model`` on the kv heads when they
    divide, else on the sequence; ``seq`` (when present) on the sequence
    (:func:`cache_seq_axes`, if their product divides it)."""
    sizes = _sizes(mesh)
    rank = len(shape)
    b_idx, h_idx, s_idx = rank - 4, rank - 3, rank - 2
    spec = [None] * rank
    data = tuple(a for a in BATCH_AXES if sizes.get(a, 1) > 1)
    if data and shape[b_idx] % math.prod(sizes[a] for a in data) == 0:
        spec[b_idx] = _entry(data)
    model = sizes.get("model", 1)
    if model > 1 and shape[h_idx] % model == 0:
        spec[h_idx] = "model"
    seq_axes = cache_seq_axes(shape[b_idx], shape[h_idx], sizes)
    if seq_axes and shape[s_idx] % math.prod(sizes[a] for a in seq_axes) == 0:
        spec[s_idx] = _entry(seq_axes)
    return tuple(spec)


def cache_specs(cache, mesh):
    """Specs of a tree of KV caches (see :func:`cache_spec`)."""
    return _map(lambda p, x: cache_spec(tuple(x.shape), mesh), cache)


def _axes_of(entry) -> tuple:
    return () if entry is None else (
        (entry,) if isinstance(entry, str) else tuple(entry))


def local_slice(x: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """This rank's block of the full tensor ``x`` under ``spec``: each
    sharded dimension cut into the axes' size and the block at this rank's
    index taken.  A sliced block is a copy (the full tensor can be freed);
    an unsliced ``x`` is returned as it is."""
    out = x
    for dim, entry in enumerate(spec):
        axes = _axes_of(entry)
        if not axes:
            continue
        n = mesh.size(axes)
        if x.shape[dim] % n:
            raise ValueError(f"dimension {dim} of {tuple(x.shape)} does not "
                             f"split over {axes} ({n} ranks)")
        size = x.shape[dim] // n
        out = out.narrow(dim, mesh.axis_index(axes) * size, size)
    return x if out is x else out.clone()


def attention_specs(path: str, spec: tuple, mode: str) -> tuple:
    """The spec a list mode gives an attention or expert weight: in
    ``kv_replication`` every rank holds every kv head (``wk`` / ``wv``
    whole), in ``rows`` q / k / v are replicated in the island (``wq``,
    ``wk``, ``wv`` and ``wo`` whole).  MoE experts are held whole: the
    expert-parallel forward is not ported, so every rank runs every
    expert."""
    if mode not in LIST_MODES:
        raise ValueError(f"mode must be one of {LIST_MODES}, got {mode!r}")
    whole = (None,) * len(spec)
    if re.match(r".*moe/(gate|up|down)$", path):
        return whole
    if mode == "kv_replication" and re.match(r".*attn/(wk|wv)$", path):
        return whole
    if mode == "rows" and re.match(r".*attn/(wq|wk|wv|wo)$", path):
        return whole
    return spec


def shard_params(params, mesh, mode: str):
    """This rank's blocks of the full parameter tree ``params`` (in plan
    slot order where the plan permutes heads) for the prefill list
    ``mode`` ("kv_group", "kv_replication" or "rows"): the Megatron layout
    of :func:`param_specs` with the whole weights of
    :func:`attention_specs`.  The model's tensor-parallel form reads what
    each weight holds from its shape."""
    return _map(lambda p, x: local_slice(x, attention_specs(
        p, param_spec(p, tuple(x.shape), mesh), mode), mesh), params)
