"""Plan epochs in the port: online recovery telemetry, drift and in-flight
replanning, against the JAX reference at SMOKE sizes in float32.

- The copies of ``plans_equal`` / ``plan_delta`` / ``PlanDelta`` and the
  dynamic policies (``quest_block_scores``, ``antidiagonal_block_scores``,
  ``topk_select``) equal the reference's on seeded inputs (scores within
  1e-5: float32 sums in another order); the ``OnlineSparsityEstimator``
  copy is held equal in ``test_torch_core.py``.
- ``permute_cache_kv_heads`` / ``permute_cache_scales`` give the
  reference's gathers bit for bit; ``decode_telemetry``'s ``rec`` /
  ``frac`` / ``fin`` are the reference's within 1e-5 over paged and
  contiguous caches, full precision and int8 codes, and a contiguous
  ``Smax`` that is not a block multiple.
- Serves: ``telemetry_every`` + ``replan_every`` (and a drift threshold
  that never fires) give the JAX engine's tokens, epochs and estimator EMAs
  (within 1e-6); a forced head move at D = 2 (the two shards' KV groups
  exchanged, full budgets) keeps the frozen engine's tokens on both
  layouts and equals the global-id JAX engine making the same move; a
  budget swap mid-batch equals the JAX engine's; the policy waits for a
  safe point; a swap purges the dead epoch's memos.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.attention import policies as ref_policies
from repro.configs.smollm_135m import SMOKE as REF_SMOKE
from repro.core import planner as ref_planner
from repro.core import sparsity as ref_sparsity
from repro.models import transformer as ref_tfm
from repro.serving import Engine as RefEngine
from repro.serving import EngineConfig as RefEngineConfig
from repro.serving import SamplingParams as RefSamplingParams
from repro_torch.attention import policies
from repro_torch.configs import get_config
from repro_torch.core import planner, sparsity
from repro_torch.launch import serve as launch_serve
from repro_torch.models import transformer as tfm
from repro_torch.serving import Engine, EngineConfig, SamplingParams
from repro_torch.serving.kv_cache import PagedKVCache
from repro_torch.weights import params_from_jax
from test_torch_head_parallel import (
    FULL_BUDGET, GlobalIdEngine, model, port_engine, port_served,
    ref_engine)

torch.set_num_threads(1)

BLK = 128
TOL = 1e-5
REF_CFG = dataclasses.replace(REF_SMOKE, dtype=jnp.float32)
CFG = dataclasses.replace(get_config("smollm-135m", smoke=True),
                          dtype=torch.float32)
KW = dict(max_seq_len=1024, num_slots=4, budget_per_head=256)
PROMPT_LENS = (300, 40, 250, 513)
MAX_TOKENS = 16


@pytest.fixture(scope="module")
def setup():
    ref_params = ref_tfm.init_params(jax.random.PRNGKey(0), REF_CFG)
    params = params_from_jax(jax.tree.map(np.asarray, ref_params), CFG,
                             device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, CFG.vocab_size, size=n) for n in PROMPT_LENS]
    return ref_params, params, prompts


# -- the copies of the host modules -------------------------------------------

@pytest.mark.parametrize("devices,kv", [(2, 4), (4, 4), (1, 2)])
def test_plan_delta_equals_reference(devices, kv):
    """An incremental replan's delta (slot perms, kv perms, identity, the
    cache's gather table) and ``plans_equal``, for plans the two packages
    make from the same profiles."""
    L, H = 3, 8
    kw = dict(num_devices=devices, num_kv_heads=kv, seq_len=4096,
              total_budget_per_head=512, block=BLK)
    old = planner.make_plan(sparsity.synthetic_head_curves(L, H, seed=0),
                            **kw)
    ref_old = ref_planner.make_plan(
        ref_sparsity.synthetic_head_curves(L, H, seed=0), **kw)
    new = planner.make_plan(sparsity.synthetic_head_curves(L, H, seed=9),
                            prev_plan=old, epoch=1, **kw)
    ref_new = ref_planner.make_plan(
        ref_sparsity.synthetic_head_curves(L, H, seed=9), prev_plan=ref_old,
        epoch=1, **kw)
    got, want = planner.plan_delta(old, new), ref_planner.plan_delta(ref_old,
                                                                     ref_new)
    assert (got.identity, got.from_epoch, got.to_epoch, got.mode) == (
        want.identity, want.from_epoch, want.to_epoch, want.mode)
    for a, b in zip(got.layers, want.layers):
        for f in ("perm", "inv_perm", "budgets", "kv_perm", "device_loads"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        np.testing.assert_array_equal(old.layers[0].perm[
            got.layers[0].perm], new.layers[0].perm)
    np.testing.assert_array_equal(got.kv_perm_table(), want.kv_perm_table())
    assert planner.plans_equal(old, dataclasses.replace(old, epoch=3))
    assert planner.plans_equal(old, new) == ref_planner.plans_equal(ref_old,
                                                                    ref_new)


@pytest.mark.parametrize("scaled", [False, True])
def test_dynamic_policies_equal_reference(scaled):
    """Quest's upper bounds (a ragged last block; int8 codes with per-block
    scales), the antidiagonal estimate and top-k selection."""
    rng = np.random.default_rng(3 + scaled)
    H, hkv, D, S = 4, 2, 32, 300
    q = rng.standard_normal((H, S, D)).astype(np.float32)
    if scaled:
        k = rng.integers(-127, 128, (hkv, S, D)).astype(np.int8)
        ks = rng.uniform(0.005, 0.02, (hkv, -(-S // BLK))).astype(np.float32)
    else:
        k = rng.standard_normal((hkv, S, D)).astype(np.float32)
        ks = None
    want = np.asarray(ref_policies.quest_block_scores(
        jnp.asarray(q), jnp.asarray(k), BLK,
        None if ks is None else jnp.asarray(ks)))
    got = policies.quest_block_scores(
        torch.from_numpy(q), torch.from_numpy(k), BLK,
        None if ks is None else torch.from_numpy(ks)).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    if not scaled:
        np.testing.assert_allclose(
            policies.antidiagonal_block_scores(
                torch.from_numpy(q), torch.from_numpy(k), BLK).numpy(),
            np.asarray(ref_policies.antidiagonal_block_scores(
                jnp.asarray(q), jnp.asarray(k), BLK)), atol=1e-4, rtol=TOL)
    budgets = np.array([1, 2, 3, 2])
    for a, b in zip(policies.topk_select(torch.from_numpy(want.copy()),
                                         budgets),
                    ref_policies.topk_select(want, budgets)):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("kind", ["f32", "fp8"])
def test_cache_permutations_equal_reference(kind):
    rng = np.random.default_rng(5)
    L, hkv = 2, 4
    x = rng.standard_normal((L, 2, 6, hkv, 8, 16)).astype(np.float32)
    perm = np.stack([rng.permutation(hkv) for _ in range(L)]).astype(np.int32)
    t = torch.from_numpy(x)
    if kind == "fp8":
        t = t.to(torch.float8_e4m3fn)
        x = t.float().numpy()
    got = tfm.permute_cache_kv_heads(t, perm)
    assert got.dtype == t.dtype and got.shape == t.shape
    want = np.asarray(ref_tfm.permute_cache_kv_heads(jnp.asarray(x), perm))
    np.testing.assert_array_equal(got.float().numpy(), want)
    sc = rng.uniform(size=(L, 2, 6, hkv, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        tfm.permute_cache_scales(torch.from_numpy(sc), perm).numpy(),
        np.asarray(ref_tfm.permute_cache_scales(jnp.asarray(sc), perm)))


def test_pool_replacement_keeps_codes_and_scales_together():
    mk = lambda n: torch.zeros((1, 2, n, 1, 4, 8), dtype=torch.int8)  # noqa
    kv = PagedKVCache(mk, num_blocks=3, block=4, table_width=2,
                      make_scales_fn=lambda n: torch.ones((1, 2, n, 1)))
    pool, scales = mk(4) + 1, torch.full((1, 2, 4, 1), 2.0)
    with pytest.raises(ValueError, match="together"):
        kv.replace_pool(pool)
    with pytest.raises(ValueError, match="does not replace"):
        kv.replace_pool(pool[:, :, :3], scales)
    kv.replace_pool(pool, scales)
    assert kv.pool is pool and kv.scales is scales and kv.audit() == []


# -- the recovery probe -------------------------------------------------------

def _probe_case(seed, layout, kind, smax=None):
    """A resident cache of 4 rows (one empty) and each row's selections:
    the sink and the newest block, as the engine's decode tables hold."""
    rng = np.random.default_rng(seed)
    L, hkv, D = CFG.num_layers, CFG.num_kv_heads, CFG.head_dim_
    clen = np.array([300, 0, 129, 513], np.int32)
    B, T = len(clen), 5
    tok = rng.integers(0, CFG.vocab_size, B)
    bids = np.full((L, B, hkv, 3), -1, np.int32)
    for b in range(B):
        nb = -(-max(int(clen[b]), 1) // BLK)
        sel = sorted({0, nb - 1, max(0, nb - 2)})
        bids[:, b, :, :len(sel)] = sel
    table = None
    if layout == "paged":
        N = B * T + 1
        shape = (L, 2, N, hkv, BLK, D)
        table = np.full((B, T), -1, np.int32)
        free = rng.permutation(N - 1)
        for b in range(B):
            nb = -(-int(clen[b]) // BLK)
            table[b, :nb] = free[b * T:b * T + nb]
        sshape = (L, 2, N, hkv)
    else:
        smax = smax or T * BLK
        shape = (L, 2, B, hkv, smax, D)
        sshape = (L, 2, B, hkv, smax // BLK)
    if kind == "int8":
        cache = rng.integers(-127, 128, shape).astype(np.int8)
        scales = rng.uniform(0.005, 0.03, sshape).astype(np.float32)
    else:
        cache = rng.standard_normal(shape).astype(np.float32)
        scales = None
    return tok, clen, bids, cache, scales, table


@pytest.mark.parametrize("layout,kind,smax", [
    ("paged", "f32", None), ("paged", "int8", None),
    ("contiguous", "f32", None), ("contiguous", "int8", None),
    ("contiguous", "f32", 600)])
def test_decode_telemetry_equals_reference(setup, layout, kind, smax):
    """``rec`` / ``frac`` on every row with a resident prefix, and ``fin`` on
    every row, within 1e-5 of the reference's probe (f32 weights; an int8
    cache's summaries and forward over its dequantized values)."""
    ref_params, params, _ = setup
    tok, clen, bids, cache, scales, table = _probe_case(
        len(layout) + len(kind), layout, kind, smax)
    kw = {} if table is None else {"table": table}
    want = ref_tfm.decode_telemetry(
        ref_params, jnp.asarray(cache), jnp.asarray(tok), jnp.asarray(clen),
        REF_CFG, block_ids=jnp.asarray(bids), cache_len=jnp.asarray(clen),
        scales=None if scales is None else jnp.asarray(scales),
        with_health=True, **{k: jnp.asarray(v) for k, v in kw.items()})
    got = tfm.decode_telemetry(
        params, torch.from_numpy(cache), torch.from_numpy(tok),
        torch.from_numpy(clen), CFG, block_ids=torch.from_numpy(bids),
        cache_len=torch.from_numpy(clen),
        scales=None if scales is None else torch.from_numpy(scales),
        with_health=True, **{k: torch.from_numpy(v) for k, v in kw.items()})
    rows = clen > 0
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy()[:, rows], np.asarray(w)[:, rows],
                                   atol=TOL, rtol=TOL)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert 0 < got[0][:, rows].min() and got[0].max() <= 1 + TOL


# -- serves -------------------------------------------------------------------

def _serve_pair(setup, **kw):
    """The JAX engine's and the port's serves of one config."""
    ref_params, params, prompts = setup
    ref = RefEngine(REF_CFG, ref_params, RefEngineConfig(**KW, **kw),
                    profile=ref_sparsity.synthetic_head_curves(
                        CFG.num_layers, CFG.num_heads))
    want = [r.generated for r in ref.serve(
        prompts, RefSamplingParams(max_tokens=MAX_TOKENS))]
    eng = Engine(CFG, params, EngineConfig(**KW, **kw),
                 sparsity.synthetic_head_curves(CFG.num_layers,
                                                CFG.num_heads),
                 device="cpu")
    got = [r.generated for r in eng.serve(
        prompts, SamplingParams(max_tokens=MAX_TOKENS))]
    return ref, want, eng, got


@pytest.mark.parametrize("case", [
    dict(telemetry_every=2, replan_every=6),
    dict(telemetry_every=2, replan_every=6, cache_layout="contiguous"),
    dict(telemetry_every=2, replan_every=6, kv_dtype="int8"),
    dict(telemetry_every=2, drift_threshold=float("inf"))],
    ids=lambda c: ",".join(f"{k}={v}" for k, v in c.items()))
def test_replanning_serve_equals_reference_engine(setup, case):
    """Tokens, the epoch and replan counts, the estimator's EMAs (within
    1e-6) and the plan-epoch bubble keys equal the JAX engine's.  An
    infinite drift threshold never replans, yet records the drift."""
    ref, want, eng, got = _serve_pair(setup, **case)
    assert got == want
    assert (eng.epoch, eng.replans) == (ref.epoch, ref.replans)
    np.testing.assert_array_equal(eng.telemetry.count, ref.telemetry.count)
    for name in ("rec_ema", "frac_ema"):
        np.testing.assert_allclose(getattr(eng.telemetry, name),
                                   getattr(ref.telemetry, name), atol=1e-6)
    bs, rbs = eng.decode_bubble_stats, ref.decode_bubble_stats
    assert bs["realized_recovery"] == pytest.approx(rbs["realized_recovery"],
                                                    abs=1e-6)
    assert bs["epochs"].keys() == rbs["epochs"].keys()
    for e, es in bs["epochs"].items():
        assert es["ticks"] == rbs["epochs"][e]["ticks"]
        assert es["telemetry_samples"] == rbs["epochs"][e]["telemetry_samples"]
    if "replan_every" in case:
        assert eng.epoch >= 1
    else:
        assert eng.epoch == eng.replans == 0
        # the budgets behind the drift reading interpolate the fitted
        # curves, which moves the EMAs' 1e-7 differences to ~1e-6
        assert bs["drift"]["drift"] == pytest.approx(rbs["drift"]["drift"],
                                                     abs=1e-5)
        assert bs["epochs"][0]["drift"] is not None


def _swap_shards(plan):
    """``plan`` at D = 2 with the two shards' KV groups exchanged: every
    slot and kv slot moves to the other shard with its budget."""
    layers = []
    for lp in plan.layers:
        H, hkv = len(lp.perm), len(lp.kv_perm)
        s = np.r_[H // 2:H, :H // 2]
        perm = lp.perm[s]
        inv = np.empty_like(perm)
        inv[perm] = np.arange(H)
        layers.append(dataclasses.replace(
            lp, perm=perm, inv_perm=inv, budgets=lp.budgets[s],
            kv_perm=lp.kv_perm[np.r_[hkv // 2:hkv, :hkv // 2]],
            device_loads=lp.device_loads[::-1].copy()))
    return dataclasses.replace(plan, layers=layers)


def _force_at(eng, tick, make_plan):
    """Make ``eng``'s replan policy swap once, onto ``make_plan(eng.plan)``,
    at the first safe point at or after decode tick ``tick``."""
    def policy(batcher=None):
        if (eng.replans == 0 and eng._decode_ticks >= tick
                and (batcher or eng._batcher).replan_safe):
            return eng.replan_now(plan=make_plan(eng.plan))
        return False
    eng._maybe_replan = policy


@pytest.mark.parametrize("layout", ["paged", "contiguous"])
def test_forced_head_move_keeps_tokens(layout):
    """D = 2 at full budgets: exchanging the shards' KV groups mid-serve
    permutes the weights and gathers the resident cache's kv heads; the
    greedy tokens stay the frozen engine's, and equal those of the
    global-id JAX engine making the same move."""
    name = "h8kv4"
    prompts = list(model(name)[4])
    eng = port_engine(name, 2, FULL_BUDGET, cache_layout=layout)
    _force_at(eng, 4, _swap_shards)
    before = eng.plan.layers[0].kv_perm.copy()
    got = [r.generated for r in eng.serve(
        prompts, SamplingParams(max_tokens=12))]
    assert eng.epoch == eng.replans == 1
    np.testing.assert_array_equal(eng.plan.layers[0].kv_perm,
                                  before[np.r_[2:4, :2]])
    frozen, _ = port_served(name, 2, layout, budget=FULL_BUDGET)
    assert got == frozen
    ref = ref_engine(name, 2, FULL_BUDGET, GlobalIdEngine,
                     cache_layout=layout)
    _force_at(ref, 4, _swap_shards)
    want = [r.generated for r in ref.serve(
        prompts, RefSamplingParams(max_tokens=12))]
    assert ref.epoch == 1 and got == want


def _swap_budgets(plan):
    """``plan`` with its budgets moved: each layer's rotated by one head,
    and the last layer's cut to one block a head (decode selections
    narrow there)."""
    layers = [dataclasses.replace(lp, budgets=np.roll(lp.budgets, 1))
              for lp in plan.layers]
    layers[-1].budgets[:] = plan.block
    return dataclasses.replace(plan, layers=layers)


def test_budget_swap_mid_batch_equals_reference(setup):
    """A replan onto other budgets at the first safe point from decode
    tick 5, requests resident: the JAX engine's tokens and epochs."""
    ref_params, params, prompts = setup
    ref = RefEngine(REF_CFG, ref_params, RefEngineConfig(**KW),
                    profile=ref_sparsity.synthetic_head_curves(
                        CFG.num_layers, CFG.num_heads))
    _force_at(ref, 5, _swap_budgets)
    want = [r.generated for r in ref.serve(
        prompts, RefSamplingParams(max_tokens=MAX_TOKENS))]
    eng = Engine(CFG, params, EngineConfig(**KW),
                 sparsity.synthetic_head_curves(CFG.num_layers,
                                                CFG.num_heads), device="cpu")
    old = eng.plan
    _force_at(eng, 5, _swap_budgets)
    got = [r.generated for r in eng.serve(
        prompts, SamplingParams(max_tokens=MAX_TOKENS))]
    assert eng.epoch == ref.epoch == 1 and got == want
    assert not planner.plans_equal(old, eng.plan)
    assert eng.decode_bubble_stats["epochs"][1]["ticks"] > 0


def test_replan_waits_for_a_safe_point(setup):
    """``replan_safe`` is False while a prompt's chunks are in flight, and
    the policy calls no replan then; the first tick after the last chunk
    replans."""
    _, params, _ = setup
    eng = Engine(CFG, params, EngineConfig(**KW, replan_every=1),
                 sparsity.synthetic_head_curves(CFG.num_layers,
                                                CFG.num_heads), device="cpu")
    calls = []
    eng.replan_now = lambda *a, **k: calls.append(eng._decode_ticks) or False
    batcher = eng.make_batcher()
    from repro_torch.serving.scheduler import Request
    batcher.submit(Request(rid=0, prompt=np.arange(40, dtype=np.int32),
                           sampling=SamplingParams(max_tokens=8)))
    batcher.submit(Request(rid=1, prompt=np.arange(600, dtype=np.int32) % 97,
                           sampling=SamplingParams(max_tokens=8)))
    fns = eng.step_fns()
    safe = []
    while batcher.busy:
        batcher.tick(*fns)
        safe.append(batcher.replan_safe)
        assert batcher.replan_safe == (batcher.prefilling is None)
        eng._maybe_replan(batcher)
        assert len(calls) == sum(safe), "a replan only at a safe point"
    assert False in safe and calls and calls[0] >= 1


def test_swap_purges_dead_epoch_memos():
    """After a swap every plan-dependent memo is empty; the next serve
    rebuilds them under the new epoch."""
    name = "h8kv4"
    eng = port_engine(name, 2)
    prompts = list(model(name)[4])
    eng.serve(prompts, SamplingParams(max_tokens=4))
    memos = ("_worklists_cache", "_chunk_cap", "_chunk_wl_cache",
             "_decode_ids_by_nblocks", "_packed_plan_cache")
    assert all(getattr(eng, m) for m in memos)
    assert eng.replan_now(plan=_swap_shards(eng.plan))
    assert not any(getattr(eng, m) for m in memos)
    assert eng._nb_cap is None and not eng._prefill_items_cache
    assert not eng.replan_now(plan=eng.plan), "an equal plan is a no-op"
    done = eng.serve(prompts, SamplingParams(max_tokens=4))
    assert all(len(r.generated) == 4 for r in done)
    assert eng.epoch == 1 and all(getattr(eng, m) for m in memos)
    assert eng.decode_stats["last"]["epoch"] == 1


@pytest.mark.parametrize("option", [
    {"drift_threshold": 0.5, "telemetry_every": 2}, {"replan_every": 8}])
def test_replan_options_serve(setup, option):
    """The plan-epoch options that ``check_supported`` refused before they
    were ported: an engine takes them and serves."""
    _, params, prompts = setup
    eng = Engine(CFG, params, EngineConfig(**KW, **option),
                 sparsity.synthetic_head_curves(CFG.num_layers,
                                                CFG.num_heads), device="cpu")
    done = eng.serve(prompts[:2], SamplingParams(max_tokens=4))
    assert all(len(r.generated) == 4 for r in done)


def test_launcher_replans_on_cpu(capsys):
    launch_serve.main(["--arch", "smollm-135m", "--smoke", "--device", "cpu",
                       "--prompt-lens", "300,40", "--max-tokens", "12",
                       "--telemetry-every", "2", "--replan-every", "4",
                       "--drift-threshold", "0.5"])
    out = capsys.readouterr().out
    assert "replan(s), realized recovery" in out and "drift" in out
    with pytest.raises(SystemExit):
        launch_serve.main(["--arch", "smollm-135m", "--smoke", "--device",
                           "cpu", "--drift-threshold", "0.5"])
