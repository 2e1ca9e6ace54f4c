"""The windowed dense prefill in the port: the sliding-window layers' dense
chunks (#2's window form) and monolithic prefill (#4's window form)
against the JAX reference, which computes both outside Pallas.

- The plain #2 over a dense causal chunk list with ``window`` (paged over
  float32 / bf16 / int8 / fp8 pools, and contiguous) against the
  reference's masked ``_chunk_attend`` (the mask of its dense chunked
  prefill, ``src/repro/models/transformer.py``, ``kpos > qpos - window``),
  windows smaller than, equal to and larger than the 256-row chunk:
  float32 within 1e-5 (the same pairs, one softmax against an online
  one); a bf16 pool within 1e-5 of the reference on the same bf16 values,
  and its bf16 output within one bf16 rounding.
- The plain #4 with ``window`` against ``flash_scan_attention(window=)``,
  causal, a ragged length: float32 within 1e-5.
- Gemma3-1B SMOKE (``LLLLLG``, window 128) with ``attention="dense"``:
  ``Engine.serve`` greedy tokens equal to the JAX ``Engine``'s, paged and
  contiguous, chunked and monolithic, with prompts past the window.

Run alone on the CPU: ``PYTHONPATH=src:tests JAX_PLATFORMS=cpu python -m
pytest -q tests/test_torch_window_prefill.py``.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.attention.flash_scan import flash_scan_attention
from repro.configs.gemma3_1b import SMOKE as REF_SMOKE
from repro.models.transformer import _chunk_attend
from repro.models.transformer import init_params as ref_init
from repro.serving import Engine as RefEngine
from repro.serving import EngineConfig as RefEngineConfig
from repro.serving import SamplingParams as RefSamplingParams
from repro_torch.configs import get_config
from repro_torch.core import quant
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attn import flash_attention_reference
from repro_torch.kernels.sparse_prefill import worklist_attention_paged
from repro_torch.models.transformer import dense_chunk_items
from repro_torch.serving import Engine, EngineConfig, SamplingParams
from repro_torch.weights import params_from_jax

torch.set_num_threads(1)

BLK = 128
TOL = 1e-5
H, HKV, D = 4, 1, 32           # Gemma3's grouping (G = 4, one kv head)
C, Q_OFFSET = 256, 512         # a chunk of 256 rows after 512 resident
WINDOWS = (100, 256, 600)      # smaller than, equal to, larger than C


def _chunk_case(seed, real=C):
    """A dense chunk at ``Q_OFFSET`` of ``real`` rows: q, the pool in a
    shuffled table, the same K/V as contiguous rows, and the dense causal
    chunk list."""
    rng = np.random.default_rng(seed)
    T = (Q_OFFSET + C) // BLK + 1
    N = T + 2
    q = rng.standard_normal((H, C, D)).astype(np.float32)
    kp = rng.standard_normal((N, HKV, BLK, D)).astype(np.float32)
    vp = rng.standard_normal((N, HKV, BLK, D)).astype(np.float32)
    table = np.full((T,), -1, np.int32)
    nmap = (Q_OFFSET + C) // BLK
    table[:nmap] = rng.permutation(N - 1)[:nmap]
    items = dense_chunk_items(H, H // HKV, block_q=BLK, block_kv=BLK,
                              q_offset=Q_OFFSET, q_blocks=-(-real // BLK))
    return q, kp, vp, table, items


def _rows(pool, table):
    """The sequence's K or V rows ``[Hkv, T*BLK, D]`` through the table
    (zeros where unmapped)."""
    out = np.zeros((pool.shape[1], table.shape[0] * BLK, pool.shape[3]),
                   pool.dtype)
    for j, p in enumerate(table):
        if p >= 0:
            out[:, j * BLK:(j + 1) * BLK] = pool[p]
    return out


def _ref_chunk(q, k, v, kv_len, window):
    """The reference's dense chunk attention: ``_chunk_attend`` under the
    mask its ``prefill_chunk*`` builds for a windowed layer."""
    kpos = jnp.arange(k.shape[1])
    positions = Q_OFFSET + jnp.arange(C)
    valid = ((kpos[None, :] <= positions[:, None])
             & (kpos[None, :] < kv_len))
    if window is not None:
        valid = valid & (kpos[None, :] > positions[:, None] - window)
    out = _chunk_attend(jnp.asarray(q)[None], jnp.asarray(k)[None],
                        jnp.asarray(v)[None], valid[None, None], None)
    return np.asarray(out[0])


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("real", [C, 200])
def test_dense_chunk_f32_matches_reference_mask(window, real):
    """#2's plain versions, paged and contiguous, over the dense causal
    chunk list: the reference's masked dense chunk, rows past ``real``
    aside (the engine reads only real rows)."""
    q, kp, vp, table, items = _chunk_case(window + real, real)
    kv_len = Q_OFFSET + real
    want = _ref_chunk(q, _rows(kp, table), _rows(vp, table), kv_len, window)
    kw = dict(block_q=BLK, block_kv=BLK, q_offset=Q_OFFSET, kv_len=kv_len,
              window=window)
    paged = ops.sparse_prefill(*_t(q, kp, vp, items, table), **kw).numpy()
    np.testing.assert_allclose(paged[:, :real], want[:, :real], atol=TOL,
                               rtol=TOL)
    contig = ops.sparse_prefill_contiguous(
        *_t(q, _rows(kp, table), _rows(vp, table), items), **kw).numpy()
    np.testing.assert_array_equal(contig, paged)


@pytest.mark.parametrize("window", WINDOWS)
def test_dense_chunk_window_masks_only_keys_past_it(window):
    """The window changes the output where it drops keys (every window
    here is shorter than the 768 keys the last rows see), and nowhere
    else: rows whose whole causal prefix lies inside the window equal the
    unwindowed rows."""
    q, kp, vp, table, items = _chunk_case(7)
    kw = dict(block_q=BLK, block_kv=BLK, q_offset=Q_OFFSET,
              kv_len=Q_OFFSET + C)
    args = _t(q, kp, vp, items, table)
    win = worklist_attention_paged(*args, window=window, **kw).numpy()
    full = worklist_attention_paged(*args, **kw).numpy()
    qpos = Q_OFFSET + np.arange(C)
    inside = qpos < window                  # keys 0..qpos all kept
    np.testing.assert_array_equal(win[:, inside], full[:, inside])
    assert not np.allclose(win[:, ~inside], full[:, ~inside])


@pytest.mark.parametrize("kind", ["bf16", "int8", "fp8"])
@pytest.mark.parametrize("window", [100, 600])
def test_dense_chunk_pools_match_reference_mask(kind, window):
    """A bf16 pool (q bf16) and int8 / fp8 code pools with their scales (q
    float32): the reference's masked dense chunk over the same values
    (dequantized as its paged dense chunk does, codes times the tile's
    scale in float32)."""
    q, kp, vp, table, items = _chunk_case(11)
    kw = dict(block_q=BLK, block_kv=BLK, q_offset=Q_OFFSET,
              kv_len=Q_OFFSET + C, window=window)
    if kind == "bf16":
        qt, kt, vt = (torch.from_numpy(a).to(torch.bfloat16)
                      for a in (q, kp, vp))
        got = ops.sparse_prefill(qt, kt, vt, *_t(items, table), **kw)
        kf, vf = kt.float().numpy(), vt.float().numpy()
        want = _ref_chunk(qt.float().numpy(), _rows(kf, table),
                          _rows(vf, table), Q_OFFSET + C, window)
        plain = worklist_attention_paged(qt.float(), kt, vt,
                                         *_t(items, table), **kw)
        np.testing.assert_allclose(plain.numpy(), want, atol=TOL, rtol=TOL)
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(), want, atol=2 ** -7,
                                   rtol=2 ** -7)
        return
    kc, ks = quant.quantize_pool_blocks(torch.from_numpy(kp), kind)
    vc, vs = quant.quantize_pool_blocks(torch.from_numpy(vp), kind)
    got = ops.sparse_prefill(torch.from_numpy(q), kc, vc, *_t(items, table),
                             k_scales=ks, v_scales=vs, **kw).numpy()
    deq = lambda c, s: quant.dequantize_tiles(c, s).numpy()  # noqa: E731
    want = _ref_chunk(q, _rows(deq(kc, ks), table), _rows(deq(vc, vs), table),
                      Q_OFFSET + C, window)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("window", [100, 128, 700])
def test_flash_attention_window_matches_flash_scan(window):
    """#4's plain version with a window: the reference's
    ``flash_scan_attention(window=)``, causal, at a ragged length."""
    rng = np.random.default_rng(window)
    S = 600
    q = rng.standard_normal((H, S, D)).astype(np.float32)
    k, v = (rng.standard_normal((HKV, S, D)).astype(np.float32)
            for _ in range(2))
    want = np.asarray(flash_scan_attention(
        *(jnp.asarray(a)[None] for a in (q, k, v)), causal=True,
        window=window, block_q=BLK, block_kv=BLK))[0]
    got = ops.flash_attention(*_t(q, k, v), causal=True, block_q=BLK,
                              block_kv=BLK, window=window).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    full = flash_attention_reference(*_t(q, k, v), causal=True).numpy()
    if window >= S:       # every row's whole prefix lies in the window
        np.testing.assert_array_equal(got, full)
    else:
        assert not np.allclose(got, full)


def test_window_below_one_raises():
    q, kp, vp, table, items = _chunk_case(0)
    with pytest.raises(ValueError, match="window"):
        ops.sparse_prefill(*_t(q, kp, vp, items, table), block_q=BLK,
                           block_kv=BLK, q_offset=Q_OFFSET, window=0)
    with pytest.raises(ValueError, match="window"):
        ops.flash_attention(*_t(q, q[:1], q[:1]), window=0)


# -- Gemma3-1B SMOKE with dense attention -------------------------------------

CFG = dataclasses.replace(get_config("gemma3-1b", smoke=True),
                          dtype=torch.float32)
KW = dict(max_seq_len=1024, num_slots=4, budget_per_head=256,
          attention="dense")
# 300 and 250 reach past the 128-token window of the 'L' layers (300 in two
# chunks); 40 lies inside it
PROMPT_LENS = (300, 40, 250)
MAX_TOKENS = 6


@pytest.fixture(scope="module")
def setup():
    ref_cfg = dataclasses.replace(REF_SMOKE, dtype=jnp.float32)
    assert ref_cfg.loop_mode == "unroll"     # each layer its own window
    ref_params = ref_init(jax.random.PRNGKey(0), ref_cfg)
    params = params_from_jax(jax.tree.map(np.asarray, ref_params), CFG,
                             device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, CFG.vocab_size, size=n) for n in PROMPT_LENS]
    return ref_cfg, ref_params, params, prompts


@pytest.mark.parametrize("layout", ["paged", "contiguous"])
@pytest.mark.parametrize("mode", ["chunked", "monolithic"])
def test_dense_gemma3_tokens_equal_reference_engine(setup, layout, mode):
    """Windowed dense prefill (#2's window form over dense chunks, #4's
    over the prompt bucket) and windowed dense decode: the JAX engine's
    greedy tokens."""
    ref_cfg, ref_params, params, prompts = setup
    kw = dict(KW, cache_layout=layout, prefill_mode=mode)
    ref = RefEngine(ref_cfg, ref_params, RefEngineConfig(**kw))
    want = [r.generated for r in ref.serve(
        prompts, RefSamplingParams(max_tokens=MAX_TOKENS))]
    eng = Engine(CFG, params, EngineConfig(**kw), None, device="cpu")
    got = [r.generated for r in eng.serve(
        prompts, SamplingParams(max_tokens=MAX_TOKENS))]
    assert got == want
    assert all(len(t) == MAX_TOKENS for t in got)
    assert eng.plan is None
