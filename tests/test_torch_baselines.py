"""The paper's baselines in the port: dense attention, monolithic prefill
and exact prefill buckets, against the JAX reference at the SMOKE size in
float32.

``Engine.serve`` greedy tokens must EQUAL the JAX engine's (dense x both
layouts x bf16 / int8, monolithic x sparse / dense x both layouts, exact
buckets, and one head-parallel degree against the JAX engine with global
prefill ids); the model functions (``prefill``, dense ``prefill_chunk*`` /
``decode_step*``, ``scatter_seq_cache_paged``) give the reference's logits
and caches within 1e-4 (f32: the same operations, sums in another order);
inside the port chunked == monolithic and pow2 == exact tokens bit for bit
for sparse attention; dense attention serves a sliding-window config.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs.smollm_135m import SMOKE as REF_SMOKE
from repro.core.sparsity import synthetic_head_curves as ref_curves
from repro.models import transformer as ref_tfm
from repro.serving import Engine as RefEngine
from repro.serving import EngineConfig as RefEngineConfig
from repro.serving import SamplingParams as RefSamplingParams
from repro_torch.configs import get_config
from repro_torch.core import quant
from repro_torch.core import worklist as wl
from repro_torch.core.sparsity import synthetic_head_curves
from repro_torch.models import transformer as tfm
from repro_torch.serving import Engine, EngineConfig, SamplingParams
from repro_torch.weights import params_from_jax
from test_torch_head_parallel import GlobalIdEngine
from test_torch_model import _chunk_items

torch.set_num_threads(1)

BLK = 128
TOL = 1e-4
# the reference's python layer loop: its scan loop runs layer 0's work list
# on every layer of a monolithic sparse prefill (ROADMAP.md §3;
# test_reference_scan_prefill_reuses_layer0_lists)
REF_CFG = dataclasses.replace(REF_SMOKE, dtype=jnp.float32,
                              layer_loop="unroll")
CFG = dataclasses.replace(get_config("smollm-135m", smoke=True),
                          dtype=torch.float32)
KW = dict(max_seq_len=1024, num_slots=4, budget_per_head=256)
# 300 spans two chunks and a partly written block; 250 + 10 crosses a
# 128-block boundary during decode; 40 is one partial block; 513 is one
# token past a pow2 bucket (exact buckets: 513 rows, 5 q blocks)
PROMPT_LENS = (300, 40, 250, 513)
MAX_TOKENS = 10


@pytest.fixture(scope="module")
def setup():
    ref_params = ref_tfm.init_params(jax.random.PRNGKey(0), REF_CFG)
    params = params_from_jax(jax.tree.map(np.asarray, ref_params), CFG,
                             device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, CFG.vocab_size, size=n) for n in PROMPT_LENS]
    return ref_params, params, prompts


def ref_tokens(setup, cls=RefEngine, cfg=REF_CFG, params=None, **kw):
    sparse = kw.get("attention", "sparse") == "sparse"
    eng = cls(cfg, setup[0] if params is None else params,
              RefEngineConfig(**{**KW, **kw}),
              profile=(ref_curves(cfg.num_layers, cfg.num_heads) if sparse
                       else None))
    done = eng.serve(setup[2], RefSamplingParams(max_tokens=MAX_TOKENS))
    return [r.generated for r in done], eng


def port_serve(setup, cfg=CFG, params=None, **kw):
    sparse = kw.get("attention", "sparse") == "sparse"
    eng = Engine(cfg, setup[1] if params is None else params,
                 EngineConfig(**{**KW, **kw}),
                 (synthetic_head_curves(cfg.num_layers, cfg.num_heads)
                  if sparse else None), device="cpu")
    done = eng.serve(setup[2], SamplingParams(max_tokens=MAX_TOKENS))
    assert all(len(r.generated) == MAX_TOKENS for r in done)
    return [r.generated for r in done], eng


ENGINE_CASES = [
    *(dict(attention="dense", cache_layout=layout, kv_dtype=kind)
      for layout in ("paged", "contiguous") for kind in ("bf16", "int8")),
    *(dict(attention=attn, prefill_mode="monolithic", cache_layout=layout)
      for attn in ("sparse", "dense") for layout in ("paged", "contiguous")),
    dict(prefill_buckets="exact"),
]


@pytest.mark.parametrize("case", ENGINE_CASES,
                         ids=lambda c: ",".join(map(str, c.values())))
def test_greedy_tokens_equal_reference_engine(setup, case):
    """Greedy tokens equal; a dense engine's decode bubble stats are the
    reference's (no plan, no ticks recorded) on every key the port
    holds."""
    got, eng = port_serve(setup, **case)
    want, ref = ref_tokens(setup, **case)
    assert got == want
    if eng.paged:
        assert eng.kv.audit() == [] and eng.kv.alloc.allocated_blocks == 0
    if not eng.sparse:
        ref_stats = ref.decode_bubble_stats
        assert eng.decode_bubble_stats == {
            k: ref_stats[k] for k in eng.decode_bubble_stats}


def test_head_parallel_monolithic_equals_global_id_reference():
    """Monolithic sparse prefill at D = 3 (9 heads over 3 KV heads, one KV
    group a shard) runs the prompt bucket's global-id lists: the tokens of
    the JAX engine whose prefill ids are global."""
    ref_cfg = dataclasses.replace(REF_CFG, num_heads=9, num_kv_heads=3)
    assert ref_cfg.loop_mode == "unroll"
    cfg = dataclasses.replace(CFG, num_heads=9, num_kv_heads=3)
    ref_params = ref_tfm.init_params(jax.random.PRNGKey(1), ref_cfg)
    params = params_from_jax(jax.tree.map(np.asarray, ref_params), cfg,
                             device="cpu")
    rng = np.random.default_rng(1)
    setup = (ref_params, params,
             [rng.integers(0, cfg.vocab_size, size=n) for n in (300, 130)])
    kw = dict(prefill_mode="monolithic", num_model_shards=3)
    got, _ = port_serve(setup, cfg, **kw)
    assert got == ref_tokens(setup, GlobalIdEngine, ref_cfg, **kw)[0]


@pytest.mark.parametrize("layout", ["paged", "contiguous"])
def test_chunked_equals_monolithic_and_exact_inside_port(setup, layout):
    """Sparse attention: chunk lists are slices of the prompt bucket's
    lists and exact lists are prefixes of the pow2 ones, so chunked ==
    monolithic and pow2 == exact greedy tokens, bit for bit."""
    base, _ = port_serve(setup, cache_layout=layout)
    for kw in (dict(prefill_mode="monolithic"),
               dict(prefill_mode="monolithic", prefill_buckets="exact")):
        got, eng = port_serve(setup, cache_layout=layout, **kw)
        assert got == base
        assert eng._batcher.stats.prefill_chunks == len(PROMPT_LENS)


def test_dense_layouts_agree_bit_for_bit(setup):
    """Dense and monolithic: paged == contiguous, and a dense engine keeps
    no plan and records no decode ticks (as the reference's)."""
    for kw in (dict(attention="dense"),
               dict(attention="dense", prefill_mode="monolithic"),
               dict(prefill_mode="monolithic", kv_dtype="int8")):
        paged, eng = port_serve(setup, cache_layout="paged", **kw)
        contig, _ = port_serve(setup, cache_layout="contiguous", **kw)
        assert paged == contig
    dense, eng = port_serve(setup, attention="dense")
    assert eng.plan is None and eng.decode_bubble_stats["ticks"] == 0


def test_windowed_dense_raises():
    """Gemma3-1B's LLLLLG windows: dense attention no longer raises (the
    windowed dense prefill is ported; its tokens are held to the JAX
    engine's in ``test_torch_window_prefill.py``).  A dense engine serves,
    monolithic and chunked prefill give equal tokens (#4's and #2's window
    forms over the same keys), ``tfm.prefill`` windows its 'L' layers (a
    prompt past the window gives other logits than the same weights with
    every layer global), and sparse attention still serves."""
    cfg = dataclasses.replace(get_config("gemma3-1b", smoke=True),
                              dtype=torch.float32)
    params = tfm.init_params(cfg, seed=0, device="cpu")
    prompt = [np.arange(200) % cfg.vocab_size]
    tokens = {}
    for mode in ("monolithic", "chunked"):
        eng = Engine(cfg, params, EngineConfig(**KW, attention="dense",
                                               prefill_mode=mode), None,
                     device="cpu")
        done = eng.serve(prompt, SamplingParams(max_tokens=2))
        tokens[mode] = done[0].generated
        assert len(tokens[mode]) == 2
    assert tokens["monolithic"] == tokens["chunked"]
    toks = torch.from_numpy(prompt[0][None])
    win, _ = tfm.prefill(params, toks, cfg)
    glob, _ = tfm.prefill(params, toks,
                          dataclasses.replace(cfg, attn_pattern="G"))
    assert torch.isfinite(win).all() and not torch.allclose(win, glob)
    eng = Engine(cfg, params, EngineConfig(**KW, prefill_mode="monolithic"),
                 synthetic_head_curves(cfg.num_layers, cfg.num_heads),
                 device="cpu")
    done = eng.serve(prompt, SamplingParams(max_tokens=2))
    assert len(done[0].generated) == 2


def test_monolithic_prefill_stop_token_and_rejection(setup):
    """Monolithic admission keeps the scheduler's contracts: a stop token
    sampled at prefill ends the request with one token, and an
    over-length request comes back rejected."""
    _, eng = port_serve(setup, prefill_mode="monolithic")
    first = eng.serve([setup[2][0]], SamplingParams(max_tokens=4))
    stop = first[0].generated[0]
    done = eng.serve([setup[2][0], np.arange(1022) % 512],
                     SamplingParams(max_tokens=4, stop_token=stop))
    assert done[0].generated == [stop]
    assert done[1].rejected and done[1].reject_reason == "over_length"


@pytest.mark.parametrize("q_offset,q_blocks", [(0, 1), (0, 3), (256, 2),
                                               (384, 1)])
def test_dense_chunk_items_cover_the_causal_prefix(q_offset, q_blocks):
    """Every (head, q block) of the chunk runs once over kv blocks 0 ..
    its diagonal, in order, on its GQA kv head."""
    H, G = 6, 3
    it = tfm.dense_chunk_items(H, G, block_q=BLK, block_kv=BLK,
                               q_offset=q_offset, q_blocks=q_blocks)
    assert (it[:, wl.F_VALID] == 1).all()
    assert np.array_equal(it[:, wl.F_KVHEAD], it[:, wl.F_HEAD] // G)
    runs = np.flatnonzero(it[:, wl.F_FIRST])
    assert len(runs) == H * q_blocks
    for r, start in enumerate(runs):
        end = runs[r + 1] if r + 1 < len(runs) else len(it)
        run = it[start:end]
        qb = run[0, wl.F_QBLK]
        assert (run[:, wl.F_HEAD] == r // q_blocks).all()
        assert np.array_equal(run[:, wl.F_KVBLK],
                              np.arange(q_offset // BLK + qb + 1))
        assert run[-1, wl.F_LAST] == 1 and run[:-1, wl.F_LAST].sum() == 0


def test_dense_decode_items_cover_resident_blocks():
    pos = np.array([300, 0, 127, 128])
    act = np.array([True, False, True, True])
    it = tfm.dense_decode_items(pos, act, 2, BLK)
    real = it[it[:, wl.D_VALID] == 1]
    got = {(b, h): sorted(real[(real[:, wl.D_BATCH] == b)
                               & (real[:, wl.D_KVHEAD] == h), wl.D_KVBLK])
           for b in range(4) for h in range(2)}
    want = {0: [0, 1, 2], 1: [], 2: [0], 3: [0, 1]}
    assert got == {(b, h): want[b] for b in range(4) for h in range(2)}
    assert len(it) == 4 * 2 * 3                  # the widest row's width


# ---------------------------------------------------------------------------
# model functions against the reference's
# ---------------------------------------------------------------------------

def _tokens(seed, n):
    return np.random.default_rng(seed).integers(0, CFG.vocab_size, size=n)


@pytest.mark.parametrize("attn", ["sparse", "dense"])
@pytest.mark.parametrize("S", [256, 300])
def test_prefill_matches_reference(setup, attn, S):
    """Monolithic prefill at a bucket (and a ragged exact one): logits at
    the last real row and the sequence cache, padded to whole blocks."""
    ref_params, params, _ = setup
    toks = _tokens(S, S)[None].astype(np.int32)
    cache_len = -(-S // BLK) * BLK
    items = None
    if attn == "sparse":
        items = _chunk_items(S, 0, cache_len)[:, :, :]
    kw = dict(cache_len=cache_len, last_index=S - 7)
    want, ref_cache = ref_tfm.prefill(
        ref_params, jnp.asarray(toks), REF_CFG,
        sparse_items=None if items is None else list(jnp.asarray(items)),
        **kw)
    got, cache = tfm.prefill(
        params, torch.from_numpy(toks).long(), CFG,
        sparse_items=None if items is None else torch.from_numpy(items),
        **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(cache.numpy(), np.asarray(ref_cache),
                               atol=1e-5)


def test_reference_scan_prefill_reuses_layer0_lists(setup):
    """A fault of the reference, recorded: with its scan layer loop (every
    uniform config) ``prefill`` attends layer 0's work list on every layer
    (``layer(x, lp, 0)``), so a monolithic sparse serve departs from the
    chunked one wherever the layers' lists differ.  Its scan logits equal
    the port's with layer 0's list everywhere, and differ from the
    per-layer lists' that both its python loop and the port run."""
    ref_params, params, _ = setup
    S = 512
    toks = _tokens(S, S)[None].astype(np.int32)
    items = _chunk_items(S, 0, S)
    assert not np.array_equal(items[0], items[1])
    scan_cfg = dataclasses.replace(REF_CFG, layer_loop="scan")
    stacked = {**ref_params, "layers": jax.tree.map(
        lambda *xs: jnp.stack(xs), *ref_params["layers"])}
    scan, _ = ref_tfm.prefill(stacked, jnp.asarray(toks), scan_cfg,
                              sparse_items=list(jnp.asarray(items)))
    torch_toks = torch.from_numpy(toks).long()
    layer0, _ = tfm.prefill(params, torch_toks, CFG,
                            sparse_items=[torch.from_numpy(items[0])] * 2)
    per_layer, _ = tfm.prefill(params, torch_toks, CFG,
                               sparse_items=torch.from_numpy(items))
    np.testing.assert_allclose(layer0.numpy(), np.asarray(scan), atol=TOL,
                               rtol=TOL)
    assert np.abs(per_layer.numpy() - np.asarray(scan)).max() > 100 * TOL


@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_scatter_seq_cache_paged_matches_reference(kind):
    rng = np.random.default_rng(5)
    L, hkv, S, dh, N = 2, 1, 3 * BLK, 32, 6
    seq = rng.standard_normal((L, 2, 1, hkv, S, dh)).astype(np.float32)
    table = np.array([4, 1, -1, -1], np.int32)
    pool = np.zeros((L, 2, N, hkv, BLK, dh), np.float32)
    scales = np.ones((L, 2, N, hkv), np.float32)
    if kind == "bf16":
        want = ref_tfm.scatter_seq_cache_paged(
            jnp.asarray(pool), jnp.asarray(seq), jnp.asarray(table))
        got = tfm.scatter_seq_cache_paged(
            torch.from_numpy(pool), torch.from_numpy(seq),
            torch.from_numpy(table))
        assert np.array_equal(got.numpy()[:, :, :N - 1],
                              np.asarray(want)[:, :, :N - 1])
        return
    codes = np.zeros(pool.shape, np.int8)
    want_p, want_s = ref_tfm.scatter_seq_cache_paged(
        jnp.asarray(codes), jnp.asarray(seq), jnp.asarray(table),
        scales=jnp.asarray(scales), kv_dtype=kind)
    got_p, got_s = tfm.scatter_seq_cache_paged(
        torch.from_numpy(codes), torch.from_numpy(seq),
        torch.from_numpy(table), scales=torch.from_numpy(scales),
        kv_dtype=kind)
    assert np.array_equal(got_p.numpy()[:, :, :N - 1],
                          np.asarray(want_p)[:, :, :N - 1])
    np.testing.assert_allclose(got_s.numpy()[:, :, :N - 1],
                               np.asarray(want_s)[:, :, :N - 1], rtol=1e-6)


@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_dense_paged_prefill_then_decode_match_reference(setup, kind):
    """Two dense chunks of one prompt into the pool (the second ragged),
    then one dense decode step of two rows (one inactive): logits and the
    sequence's blocks agree with the reference."""
    ref_params, params, _ = setup
    tokens = _tokens(3, 300)
    T, N = 4, 10
    table = np.full((T,), -1, np.int32)
    table[:3] = [7, 2, 5]
    qz = kind != "bf16"
    ref_pool = ref_tfm.init_paged_cache(
        REF_CFG, N, BLK, dtype=jnp.int8 if qz else None)
    pool = tfm.init_paged_cache(CFG, N, BLK, device="cpu",
                                dtype=quant.kv_cache_dtype(kind))
    ref_sc = ref_tfm.init_paged_scales(REF_CFG, N) if qz else None
    sc = tfm.init_paged_scales(CFG, N, device="cpu") if qz else None
    qkw = dict(kv_dtype=kind) if qz else {}
    for q_offset, chunk, real in ((0, 256, 256), (256, 128, 44)):
        toks = np.zeros((1, chunk), np.int32)
        toks[0, :real] = tokens[q_offset:q_offset + real]
        kw = dict(kv_len=q_offset + real, last_index=real - 1, **qkw)
        out = ref_tfm.prefill_chunk_paged(
            ref_params, ref_pool, jnp.asarray(toks), jnp.asarray(table),
            q_offset, REF_CFG, scales=ref_sc, **kw)
        want, ref_pool = out[0], out[1]
        ref_sc = out[2] if qz else None
        got = tfm.prefill_chunk_paged(
            params, pool, torch.from_numpy(toks).long(),
            torch.from_numpy(table), q_offset, CFG, scales=sc, **kw)
        got = got[0] if qz else got
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                                   rtol=TOL)
    dtable = np.full((2, T), -1, np.int32)
    dtable[0] = table
    pos = np.array([300, 0], np.int32)
    token = np.array([int(tokens[-1]), 0], np.int32)
    act = np.array([True, False])
    out = ref_tfm.decode_step_paged(
        ref_params, ref_pool, jnp.asarray(token), jnp.asarray(pos),
        jnp.asarray(dtable), REF_CFG, active=jnp.asarray(act), scales=ref_sc,
        **qkw)
    got = tfm.decode_step_paged(
        params, pool, torch.from_numpy(token).long(), torch.from_numpy(pos),
        torch.from_numpy(dtable), CFG, active=torch.from_numpy(act),
        scales=sc, **qkw)
    got = got[0] if qz else got
    np.testing.assert_allclose(got[0].numpy(), np.asarray(out[0])[0],
                               atol=TOL, rtol=TOL)
    ref_blocks = np.asarray(out[1])[:, :, [7, 2, 5]]
    if qz:
        # K/V differ by f32 rounding, so a code next to a rounding boundary
        # may land one step away: the dequantized blocks agree within one
        # step, and few codes move
        codes = quant.code_bits(pool)[:, :, [7, 2, 5]].numpy()
        ref_s = np.asarray(out[2])[:, :, [7, 2, 5]]
        got_s = sc[:, :, [7, 2, 5]].numpy()
        np.testing.assert_allclose(got_s, ref_s, rtol=1e-4)
        deq = lambda c, s: c.astype(np.float32) * s[..., None, None]
        np.testing.assert_allclose(deq(codes, got_s), deq(ref_blocks, ref_s),
                                   atol=float(ref_s.max()) * 1.001)
        assert (codes != ref_blocks).mean() < 1e-3
    else:
        np.testing.assert_allclose(pool[:, :, [7, 2, 5]].numpy(), ref_blocks,
                                   atol=1e-5)


def test_dense_contiguous_prefill_then_decode_match_reference(setup):
    """The same on the slot cache: two dense chunks into slot 1, then a
    dense decode step of both slots (slot 0 inactive)."""
    ref_params, params, _ = setup
    tokens = _tokens(4, 300)
    smax = 512
    ref_cache = ref_tfm.init_cache(REF_CFG, 2, smax)
    cache = tfm.init_cache(CFG, 2, smax, device="cpu")
    for q_offset, chunk, real in ((0, 256, 256), (256, 128, 44)):
        toks = np.zeros((1, chunk), np.int32)
        toks[0, :real] = tokens[q_offset:q_offset + real]
        kw = dict(kv_len=q_offset + real, last_index=real - 1)
        want, ref_cache = ref_tfm.prefill_chunk(
            ref_params, ref_cache, jnp.asarray(toks), 1, q_offset, REF_CFG,
            **kw)
        got = tfm.prefill_chunk(params, cache, torch.from_numpy(toks).long(),
                                1, q_offset, CFG, **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                                   rtol=TOL)
    pos = np.array([0, 300], np.int32)
    token = np.array([0, int(tokens[-1])], np.int32)
    act = np.array([False, True])
    want, ref_cache = ref_tfm.decode_step(
        ref_params, ref_cache, jnp.asarray(token), jnp.asarray(pos), REF_CFG,
        active=jnp.asarray(act))
    got = tfm.decode_step(params, cache, torch.from_numpy(token).long(),
                          torch.from_numpy(pos), CFG,
                          active=torch.from_numpy(act))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want)[1],
                               atol=TOL, rtol=TOL)
    np.testing.assert_allclose(cache[:, :, 1, :, :301].numpy(),
                               np.asarray(ref_cache)[:, :, 1, :, :301],
                               atol=1e-5)


@pytest.mark.parametrize("option", [
    dict(attention="dense"), dict(prefill_mode="monolithic"),
    dict(prefill_buckets="exact"),
    dict(attention="dense", prefill_mode="monolithic",
         prefill_buckets="exact")])
def test_check_supported_accepts_the_baselines(option):
    EngineConfig(**option).check_supported()
    with pytest.raises(NotImplementedError, match="not ported"):
        EngineConfig(**option, seq_shards=2).check_supported()


def test_launcher_serves_the_baselines(capsys):
    from repro_torch.launch import serve as launch_serve
    done = launch_serve.main(["--arch", "smollm-135m", "--smoke",
                              "--device", "cpu", "--prompt-lens", "5,130",
                              "--max-tokens", "2", "--attention", "dense",
                              "--prefill-mode", "monolithic",
                              "--prefill-buckets", "exact"])
    assert [len(r.generated) for r in done] == [2, 2]
    out = capsys.readouterr().out
    assert "dense attention, no plan" in out and "over 0 ticks" in out
