"""The port's copied host planning (``repro_torch.core``, its static
policies) against the reference's: the same inputs give EQUAL outputs —
profiles, budgets, partitions, plans, prefill work lists and chunk slices,
packed decode work lists, the online sparsity estimator."""
import numpy as np
import pytest
import torch

from repro.attention import policies as ref_pol
from repro.core import partition as ref_part
from repro.core import planner as ref_plan
from repro.core import sparsity as ref_sp
from repro.core import worklist as ref_wl
from repro_torch.attention import policies as pol
from repro_torch.core import partition as part
from repro_torch.core import planner as plan
from repro_torch.core import sparsity as sp
from repro_torch.core import worklist as wl

torch.set_num_threads(1)

SEEDS = [0, 1, 2]


def _plans(seed, allocator="maxmin", partitioner="best", devices=1,
           L=3, H=9, Hkv=3, seq=4096, budget=512):
    kw = dict(num_devices=devices, num_kv_heads=Hkv, seq_len=seq,
              total_budget_per_head=budget, block=128, floor=128,
              allocator=allocator, partitioner=partitioner)
    return (ref_plan.make_plan(ref_sp.synthetic_head_curves(L, H, seed=seed),
                               **kw),
            plan.make_plan(sp.synthetic_head_curves(L, H, seed=seed), **kw))


@pytest.mark.parametrize("seed", SEEDS)
def test_synthetic_profiles_equal(seed):
    a = ref_sp.synthetic_head_curves(4, 9, seed=seed)
    b = sp.synthetic_head_curves(4, 9, seed=seed)
    assert np.array_equal(a.curves, b.curves)
    assert np.array_equal(a.grid, b.grid)
    assert a.budget_for_recovery(1, 2, 0.9) == b.budget_for_recovery(
        1, 2, 0.9)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("allocator,partitioner,devices", [
    ("maxmin", "best", 1), ("maxmin", "best", 3), ("uniform", "lpt", 3),
    ("maxmin", "naive", 3)])
def test_plans_equal(seed, allocator, partitioner, devices):
    a, b = _plans(seed, allocator, partitioner, devices)
    assert (a.mode, a.num_devices) == (b.mode, b.num_devices)
    for la, lb in zip(a.layers, b.layers):
        for f in ("perm", "inv_perm", "budgets", "kv_perm", "device_loads"):
            assert np.array_equal(getattr(la, f), getattr(lb, f)), f
    assert ref_plan.plan_summary(a) == plan.plan_summary(b)


@pytest.mark.parametrize("seed", SEEDS)
def test_best_partition_equal(seed):
    w = np.random.default_rng(seed).integers(1, 40, size=24)
    for d in (2, 3, 5):
        a, b = ref_part.best_partition(w, d), part.best_partition(w, d)
        assert np.array_equal(a.device_of, b.device_of)
        assert np.array_equal(a.loads, b.loads)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("policy", ["strided", "streaming"])
def test_prefill_worklists_and_chunks_equal(seed, policy):
    a, b = _plans(seed, seq=2048)
    for la, lb in zip(a.layers, b.layers):
        wa = ref_wl.worklist_from_budgets(
            la.budgets, num_devices=1, seq_len=1024, block=128,
            policy_fn=ref_pol.policy_by_name(policy), group_size=3)
        wb = wl.worklist_from_budgets(
            lb.budgets, num_devices=1, seq_len=1024, block=128,
            policy_fn=pol.policy_by_name(policy), group_size=3)
        assert np.array_equal(wa.items, wb.items)
        assert np.array_equal(wa.lengths, wb.lengths)
        assert np.array_equal(ref_wl.chunk_item_counts(wa.items, 8),
                              wl.chunk_item_counts(wb.items, 8))
        for ob, nqc in ((0, 2), (3, 2), (6, 2), (4, 4)):
            ca = ref_wl.chunk_items(wa.items, ob, nqc, pad_to=160)
            cb = wl.chunk_items(wb.items, ob, nqc, pad_to=160)
            assert np.array_equal(ca, cb)


def _block_ids(seed, B=6, Hkv=3, nb=5, T=12):
    """[B, Hkv, nb] sorted selections with trailing -1 padding."""
    rng = np.random.default_rng(seed)
    ids = np.full((B, Hkv, nb), -1, np.int32)
    for b in range(B):
        for h in range(Hkv):
            n = int(rng.integers(0 if (b + h) % 4 == 3 else 1, nb + 1))
            ids[b, h, :n] = np.sort(rng.choice(T, size=n, replace=False))
    return ids


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shards", [1, 2])
def test_packed_decode_items_equal(seed, shards):
    ids = _block_ids(seed)
    phys = np.random.default_rng(seed + 7).permutation(6 * 12).reshape(6, 12)
    for kw in ({}, {"bytes_per_block": 2.0 * 128 * 64 * 2},
               {"phys_of_block": phys}):
        a = ref_wl.pack_decode_items(ids, num_shards=shards, block=128, **kw)
        b = wl.pack_decode_items(ids, num_shards=shards, block=128, **kw)
        assert np.array_equal(a.items, b.items)
        assert np.array_equal(a.lengths, b.lengths)
        width = ref_wl.pow2_bucket(a.padded_length, lo=8)
        assert width == wl.pow2_bucket(b.padded_length, lo=8)
        assert np.array_equal(ref_wl.extend_packed_items(a.items, width),
                              wl.extend_packed_items(b.items, width))
    assert np.array_equal(ref_wl.padded_decode_items(ids),
                          wl.padded_decode_items(ids))
    budgets = np.array([100, 128, 129, 1000])
    assert np.array_equal(ref_wl.blocks_for_budget(budgets, 128),
                          wl.blocks_for_budget(budgets, 128))


def test_permute_attention_params_on_torch_weights():
    """The copied permutation applied to torch weights equals the
    reference applied to numpy weights."""
    a, b = _plans(0)
    rng = np.random.default_rng(0)
    d, H, Hkv, dh = 16, 9, 3, 4
    ws = [rng.standard_normal(s).astype(np.float32) for s in
          ((d, H * dh), (d, Hkv * dh), (d, Hkv * dh), (H * dh, d))]
    want = ref_plan.permute_attention_params(*ws, a.layers[1], dh, 3)
    got = plan.permute_attention_params(*map(torch.from_numpy, ws),
                                        b.layers[1], dh, 3)
    for x, y in zip(want, got):
        assert np.array_equal(x, y.numpy())


def _telemetry_batches(seed, L=3, B=4, H=6, n=12):
    rng = np.random.default_rng(seed)
    for t in range(n):
        rec = rng.uniform(0.2, 1.0, (L, B, H))
        frac = rng.uniform(0.01, 0.6, (L, B, H)) * (1 + t % 3) / 3
        rec[rng.random((L, B, H)) < 0.1] = np.nan      # empty rows
        yield (rec, frac) if t % 4 else (rec[:, 0], frac[:, 0])


@pytest.mark.parametrize("seed", SEEDS)
def test_online_estimator_equal(seed):
    """The plan epochs' online estimator: EMAs, counts, realized recovery,
    fitted betas, the live profile and the drift reading over seeded
    batches ([L, B, H] and [L, H], with non-finite entries) are EQUAL; the
    state (EMAs and counts) copied into a fresh estimator gives the same
    profile and drift."""
    L, H = 3, 6
    ref = ref_sp.OnlineSparsityEstimator(L, H)
    got = sp.OnlineSparsityEstimator(L, H)
    offline = sp.synthetic_head_curves(L, H, seed=2)
    ref_off = ref_sp.synthetic_head_curves(L, H, seed=2)
    for rec, frac in _telemetry_batches(seed):
        ref.update(rec, frac)
        got.update(rec, frac)
    for name in ("rec_ema", "frac_ema", "count"):
        np.testing.assert_array_equal(getattr(got, name), getattr(ref, name))
    assert got.total_samples == ref.total_samples > 0
    assert got.realized_recovery() == ref.realized_recovery()
    np.testing.assert_array_equal(got.head_betas(), ref.head_betas())
    np.testing.assert_array_equal(got.to_profile(fallback=offline).curves,
                                  ref.to_profile(fallback=ref_off).curves)
    assert got.drift_vs(offline) == ref.drift_vs(ref_off)
    copy = sp.OnlineSparsityEstimator(L, H)
    copy.rec_ema, copy.frac_ema = got.rec_ema.copy(), got.frac_ema.copy()
    copy.count = got.count.copy()
    np.testing.assert_array_equal(copy.to_profile(fallback=offline).curves,
                                  got.to_profile(fallback=offline).curves)
    assert copy.drift_vs(offline) == got.drift_vs(offline)
    fresh = sp.OnlineSparsityEstimator(L, H)
    assert np.isnan(fresh.realized_recovery())
    assert fresh.drift_vs(offline)["drift"] == 0.0


def _causal_maps(seed, L=2, H=3, S=40, zeros=True):
    """Seeded softmax maps ``[L, H, S, S]``, causal (zeros above the
    diagonal) and, with ``zeros``, some underflowed entries inside the
    prefix (a row's valid length counts only positive weights)."""
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((L, H, S, S)) * rng.uniform(0.5, 8.0,
                                                             (L, H, 1, 1))
    logits = np.where(np.tril(np.ones((S, S), bool)), logits, -np.inf)
    w = np.exp(logits - logits.max(-1, keepdims=True))
    if zeros:
        w[rng.random(w.shape) < 0.05] = 0.0
    w[..., 0] += (w.sum(-1) == 0)              # no all-zero row
    return (w / w.sum(-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("seed", SEEDS)
def test_recovery_curve_and_profiles_equal(seed):
    """The offline profiling stage's numpy copies: ``recovery_curve`` on a
    default and a custom grid, ``profile_attention_weights`` of ``[L, H,
    Q, K]`` and ``[H, Q, K]`` maps and ``profile_model``'s sample-weighted
    merge over two batches equal the reference's bit for bit."""
    maps = _causal_maps(seed)
    grid = np.linspace(0.0, 1.0, 11)
    for g in (None, grid):
        np.testing.assert_array_equal(sp.recovery_curve(maps[0, 1], g),
                                      ref_sp.recovery_curve(maps[0, 1], g))
    for a in (maps, maps[1]):
        got = sp.profile_attention_weights(a, meta={"m": 1})
        want = ref_sp.profile_attention_weights(a, meta={"m": 1})
        np.testing.assert_array_equal(got.curves, want.curves)
        assert (got.num_samples, got.meta) == (want.num_samples, want.meta)
    batches = [_causal_maps(seed + 10, S=24), _causal_maps(seed + 20, S=40)]
    fn = {id(b): b for b in batches}
    got = sp.profile_model(lambda t: fn[id(t)], batches)
    want = ref_sp.profile_model(lambda t: fn[id(t)], batches)
    np.testing.assert_array_equal(got.curves, want.curves)
    assert got.num_samples == want.num_samples == 64


@pytest.mark.parametrize("policy", ["strided", "streaming"])
def test_policy_memo_hands_out_fresh_lists(policy):
    """The memoized static policies return a new list each call: a caller
    that replaces an entry (a test baring a tile) leaves the next caller's
    selection, and so a later engine's work lists, as they were."""
    fn = pol.policy_by_name(policy)
    first = fn(3, 2, 4, 4)
    want = [a.copy() for a in first]
    first[1] = np.array([], np.int64)
    again = fn(3, 2, 4, 4)
    assert again is not first
    for a, b in zip(again, want):
        assert np.array_equal(a, b)
