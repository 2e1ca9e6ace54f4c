"""Gemma3-1B through the port: its config and layer pattern, the
head_dim-256 / G = 4 / one-kv-head shapes of the kernels' plain versions
against the JAX reference, and the whole slice at the reference's
Gemma3-1B SMOKE size in float32.

- ``get_config("gemma3-1b")`` equals the reference's FULL and SMOKE on
  every field the port has, ``num_params`` included, and the port's
  per-layer decode window (``_window_of``) is the reference's on every
  layer;
- the plain decode (#1 paged, #3 contiguous, codes too, with and without a
  window) and prefill (#2) versions at head_dim 256, G = 4 and Hkv = 1
  against the Pallas kernels in interpret mode and the reference's jnp
  twins, tolerance 1e-5 (float32, the same tiles and masks, sums taken in
  another order);
- ``Engine.serve`` with weights from ``params_from_jax``: greedy tokens
  equal to the JAX ``Engine``'s (``LLLLLG``, window 128) on both layouts and
  both decode grids, and at ``kv_dtype`` int8, with prompts of 300 and 250
  tokens, longer than the window, and one of 40; inside the port, paged ==
  contiguous and packed == padded.

Run alone on the CPU (about a minute on one core):
``PYTHONPATH=src:tests JAX_PLATFORMS=cpu python -m pytest -q
tests/test_torch_gemma3.py``.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.attention.worklist_jnp import worklist_attention_paged as ref_wap
from repro.configs.gemma3_1b import FULL as REF_FULL
from repro.configs.gemma3_1b import SMOKE as REF_SMOKE
from repro.core.sparsity import synthetic_head_curves as ref_curves
from repro.kernels import ops as ref_ops
from repro.models.transformer import _window_of as ref_window_of
from repro.models.transformer import init_params as ref_init
from repro.serving import Engine as RefEngine
from repro.serving import EngineConfig as RefEngineConfig
from repro.serving import SamplingParams as RefSamplingParams
from repro_torch.attention.policies import strided_policy
from repro_torch.configs import TransformerConfig, get_config
from repro_torch.core import worklist as wl
from repro_torch.core.sparsity import synthetic_head_curves
from repro_torch.kernels import ops
from repro_torch.kernels.flash_decode import (
    packed_decode_attention, packed_decode_attention_paged)
from repro_torch.kernels.sparse_prefill import sparse_prefill_attention
from repro_torch.launch import serve as launch_serve
from repro_torch.models.transformer import _window_of
from repro_torch.serving import Engine, EngineConfig, SamplingParams
from repro_torch.weights import params_from_jax
from test_torch_cuda import (
    as_slot_cache, as_torch, code_tensor, decode_case, prefill_case,
    quant_codes)

torch.set_num_threads(1)

BLK = 128
TOL = 1e-5
D, G = 256, 4                    # Gemma3-1B's head_dim and GQA group
CFG = dataclasses.replace(get_config("gemma3-1b", smoke=True),
                          dtype=torch.float32)
KW = dict(max_seq_len=1024, num_slots=4, budget_per_head=256)
# 300 and 250 (+ 10 decoded) reach past the SMOKE window of 128, so the
# local layers' decode drops keys; 40 stays inside it
PROMPT_LENS = (300, 40, 250)
MAX_TOKENS = 10


@pytest.mark.parametrize("smoke,ref", [(False, REF_FULL), (True, REF_SMOKE)])
def test_config_equals_the_reference(smoke, ref):
    got = get_config("gemma3-1b", smoke=smoke)
    for f in dataclasses.fields(TransformerConfig):
        want = getattr(ref, f.name)
        have = getattr(got, f.name)
        if f.name == "dtype":
            assert str(have).removeprefix("torch.") == jnp.dtype(want).name
        else:
            assert have == want, f.name
    assert got.num_params == ref.num_params
    assert (got.head_dim_, got.group_size) == ((256, 4) if not smoke
                                               else (32, 4))
    assert [got.layer_kind(l) for l in range(got.num_layers)] == [
        ref.layer_kind(l) for l in range(ref.num_layers)]


@pytest.mark.parametrize("smoke,ref", [(False, REF_FULL), (True, REF_SMOKE)])
def test_window_of_each_layer_equals_the_reference(smoke, ref):
    """Five windowed layers to one global, cycled; the other archs have no
    window on any layer."""
    cfg = get_config("gemma3-1b", smoke=smoke)
    got = [_window_of(cfg, l) for l in range(cfg.num_layers)]
    assert got == [ref_window_of(ref, l) for l in range(ref.num_layers)]
    assert got[:6] == [ref.local_window] * 5 + [None]
    assert all(_window_of(get_config(a), l) is None
               for a in ("smollm-135m", "yi-6b") for l in range(4))


def test_launcher_serves_gemma3_smoke_on_cpu(capsys):
    done = launch_serve.main(["--arch", "gemma3-1b", "--smoke", "--device",
                              "cpu", "--requests", "2", "--max-tokens", "3"])
    assert [len(r.generated) for r in done] == [3, 3]
    assert "served 2 requests" in capsys.readouterr().out


# -- the plain kernels at head_dim 256, G = 4, one kv head --------------------

def _gemma_decode(seed, **kw):
    """A decode case at Gemma3-1B's head_dim and group, one kv head, 3
    rows."""
    q, kp, vp, items, table, pos = decode_case(seed, Hkv=1, G=G, D=D, **kw)
    return q.reshape(3, 1, G, D), kp, vp, items, table, pos


@pytest.mark.parametrize("seed,holes,window,layout", [
    (1, True, 200, "packed"), (2, False, 100, "padded"),
    (3, True, None, "packed")])
def test_paged_decode_d256_matches_pallas_kernel(seed, holes, window,
                                                 layout):
    q, kp, vp, items, table, pos = _gemma_decode(seed, holes=holes,
                                                 layout=layout)
    want = ref_ops.flash_decode_packed_paged(
        *map(jnp.asarray, (q.reshape(3, G, 1, D), kp, vp, items, table,
                           pos)), block_kv=BLK, window=window,
        partials=True, use_kernel=True, interpret=True)
    got = packed_decode_attention_paged(*as_torch(q, kp, vp, items, table,
                                                  pos), block_kv=BLK,
                                        window=window)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.reshape(w.shape).numpy(), np.asarray(w),
                                   atol=TOL, rtol=TOL)


@pytest.mark.parametrize("kind,window", [("int8", 150), ("fp8", None)])
def test_code_decode_d256_matches_pallas_kernel(kind, window):
    """#1 over a code pool (|q| < 1, one scale per (block, kv head)), and
    #3 over the same values in a slot cache: the same bits."""
    q, kp, vp, items, table, pos = _gemma_decode(4)
    rng = np.random.default_rng(4)
    q = rng.uniform(-1.0, 1.0, size=q.shape).astype(np.float32)
    kc, vc = quant_codes(kp, kind), quant_codes(vp, kind)
    ks, vs = (rng.uniform(1e-3, 5e-2, size=kp.shape[:2]).astype(np.float32)
              for _ in range(2))
    np_code = {"int8": np.int8, "fp8": jnp.float8_e4m3fn}[kind]
    want = ref_ops.flash_decode_packed_paged(
        jnp.asarray(q.reshape(3, G, 1, D)),
        *(jnp.asarray(c.view(np_code)) for c in (kc, vc)),
        *map(jnp.asarray, (items, table, pos)), block_kv=BLK, window=window,
        partials=True, use_kernel=True, interpret=True,
        k_scales=jnp.asarray(ks), v_scales=jnp.asarray(vs))
    args = (torch.from_numpy(q), code_tensor(kc, kind), code_tensor(vc, kind),
            *as_torch(items, table, pos))
    got = packed_decode_attention_paged(
        *args, block_kv=BLK, window=window, k_scales=torch.from_numpy(ks),
        v_scales=torch.from_numpy(vs))
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.reshape(w.shape).numpy(), np.asarray(w),
                                   atol=TOL, rtol=TOL)
    # the slot cache of the same values: scales per (row, kv head, block)
    B, T = table.shape
    sk = np.ones((B, 1, T), np.float32)
    sv = np.ones_like(sk)
    for b in range(B):
        for j in range(T):
            if table[b, j] >= 0:
                sk[b, :, j], sv[b, :, j] = ks[table[b, j]], vs[table[b, j]]
    slot = packed_decode_attention(
        torch.from_numpy(q), code_tensor(as_slot_cache(kc, table), kind),
        code_tensor(as_slot_cache(vc, table), kind), *as_torch(items, pos),
        block_kv=BLK, window=window, k_scales=torch.from_numpy(sk),
        v_scales=torch.from_numpy(sv))
    for a, b in zip(got, slot):
        assert torch.equal(a, b), "paged == contiguous, bit for bit"


@pytest.mark.parametrize("window", [None, 200])
def test_contiguous_decode_d256_matches_pallas_and_paged(window):
    """#3 over the slot cache at Gemma3-1B's shapes: the Pallas kernel,
    and the paged plain version's bits on equal contents."""
    q, kp, vp, items, table, pos = _gemma_decode(5, layout="padded")
    kc, vc = as_slot_cache(kp, table), as_slot_cache(vp, table)
    want = ref_ops.flash_decode_packed(
        *map(jnp.asarray, (q.reshape(3, G, 1, D), kc, vc, items, pos)),
        block_kv=BLK, window=window, partials=True, use_kernel=True,
        interpret=True)
    got = packed_decode_attention(*as_torch(q, kc, vc, items, pos),
                                  block_kv=BLK, window=window)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.reshape(w.shape).numpy(), np.asarray(w),
                                   atol=TOL, rtol=TOL)
    paged = packed_decode_attention_paged(*as_torch(q, kp, vp, items, table,
                                                    pos), block_kv=BLK,
                                          window=window)
    for a, b in zip(got, paged):
        assert torch.equal(a, b), "paged == contiguous, bit for bit"


@pytest.mark.parametrize("seed,q_offset,kv_len,hole", [
    (0, 0, 200, False), (1, 256, 456, True)])
def test_paged_prefill_d256_matches_reference_scan(seed, q_offset, kv_len,
                                                   hole):
    """#2 at 4 query heads over one kv head, head_dim 256, against the jnp
    twin the reference's chunked prefill runs."""
    q, kp, vp, items, table = prefill_case(seed, H=G, Hkv=1, D=D,
                                           q_offset=q_offset, hole=hole)
    want = ref_wap(*map(jnp.asarray, (q, kp, vp, items, table)),
                   block_q=BLK, block_kv=BLK, q_offset=q_offset,
                   kv_len=kv_len)
    got = ops.sparse_prefill(*as_torch(q, kp, vp, items, table),
                             block_q=BLK, block_kv=BLK, q_offset=q_offset,
                             kv_len=kv_len)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


def test_contiguous_prefill_d256_matches_pallas_kernel():
    """#2 in its own contiguous signature at 4 heads over one kv head,
    head_dim 256: the Pallas kernel in interpret mode."""
    rng = np.random.default_rng(6)
    S = 256
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((G, S, D), (1, S, D), (1, S, D)))
    nq = S // BLK
    sels = [strided_policy(h, 1 + h % 2, nq, nq) for h in range(G)]
    full = wl.build_worklist(sels, np.zeros(G, np.int64), 1, nq, nq, BLK,
                             kv_head_of_head=np.zeros(G, np.int64))
    items = full.items[0]
    want = np.asarray(ref_ops.sparse_prefill(
        *map(jnp.asarray, (q, k, v, items)), interpret=True))
    got = sparse_prefill_attention(*as_torch(q, k, v, items)).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


# -- the whole slice at the Gemma3-1B SMOKE size -----------------------------

@pytest.fixture(scope="module")
def setup():
    ref_cfg = dataclasses.replace(REF_SMOKE, dtype=jnp.float32)
    ref_params = ref_init(jax.random.PRNGKey(0), ref_cfg)
    params = params_from_jax(jax.tree.map(np.asarray, ref_params), CFG,
                             device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, CFG.vocab_size, size=n) for n in PROMPT_LENS]
    return ref_cfg, ref_params, params, prompts


@pytest.fixture(scope="module")
def served(setup):
    """The reference's serves (paged, contiguous, paged int8) and the
    port's at each of those x packed / padded."""
    ref_cfg, ref_params, params, prompts = setup
    want, got = {}, {}
    for tag, kw in (("paged", {}), ("contiguous",
                                    {"cache_layout": "contiguous"}),
                    ("int8", {"kv_dtype": "int8"})):
        ref = RefEngine(ref_cfg, ref_params, RefEngineConfig(**KW, **kw),
                        profile=ref_curves(CFG.num_layers, CFG.num_heads))
        want[tag] = [r.generated for r in ref.serve(
            prompts, RefSamplingParams(max_tokens=MAX_TOKENS))]
        for worklist in ("packed", "padded"):
            eng = Engine(CFG, params,
                         EngineConfig(**KW, decode_worklist=worklist, **kw),
                         synthetic_head_curves(CFG.num_layers,
                                               CFG.num_heads),
                         device="cpu")
            got[tag, worklist] = [r.generated for r in eng.serve(
                prompts, SamplingParams(max_tokens=MAX_TOKENS))]
    return want, got


@pytest.mark.parametrize("tag", ["paged", "contiguous", "int8"])
@pytest.mark.parametrize("worklist", ["packed", "padded"])
def test_greedy_tokens_equal_reference_engine(served, tag, worklist):
    want, got = served
    assert got[tag, worklist] == want[tag]
    assert all(len(t) == MAX_TOKENS for t in got[tag, worklist])


def test_layouts_and_decode_grids_agree_inside_the_port(served):
    _, got = served
    base = got["paged", "packed"]
    assert all(got[k] == base for k in (("paged", "padded"),
                                        ("contiguous", "packed"),
                                        ("contiguous", "padded")))
    assert got["int8", "packed"] == got["int8", "padded"]


def test_window_changes_the_tokens(setup, served):
    """The windowed decode is what makes the port's tokens the reference's:
    the same weights served with every layer global give other tokens for
    a prompt longer than the window, and the same for one inside it."""
    _, _, params, prompts = setup
    _, got = served
    cfg = dataclasses.replace(CFG, attn_pattern="G")
    eng = Engine(cfg, params, EngineConfig(**KW),
                 synthetic_head_curves(cfg.num_layers, cfg.num_heads),
                 device="cpu")
    glob = [r.generated for r in eng.serve(
        prompts, SamplingParams(max_tokens=MAX_TOKENS))]
    windowed = got["paged", "packed"]
    assert glob[1] == windowed[1]
    assert glob[0] != windowed[0] and glob[2] != windowed[2]
