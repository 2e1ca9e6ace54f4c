"""The head-parallel degree: ``EngineConfig(num_model_shards=D)`` places
KV groups on D shards (``kv_group``), emulated on one device.  The port's
``Engine.serve`` against the JAX engine with its prefill ids made global,
at 2 layers in float32 on two head layouts (9 heads over 3 KV heads at D =
1, 3; 8 over 4 at D = 1, 2, 4), its decode bubble telemetry against the
reference's, its prefill work lists on global ids, and the refusal of the
``kv_replication`` placement.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs.smollm_135m import SMOKE as REF_SMOKE
from repro.core.sparsity import synthetic_head_curves as ref_curves
from repro.core.worklist import F_HEAD as REF_F_HEAD
from repro.core.worklist import F_KVHEAD as REF_F_KVHEAD
from repro.models.transformer import init_params as ref_init
from repro.serving import Engine as RefEngine
from repro.serving import EngineConfig as RefEngineConfig
from repro.serving import SamplingParams as RefSamplingParams
from repro_torch.attention.policies import strided_policy
from repro_torch.configs import get_config
from repro_torch.core import worklist as wl
from repro_torch.core.sparsity import synthetic_head_curves
from repro_torch.launch import serve as launch_serve
from repro_torch.models.transformer import init_params
from repro_torch.serving import Engine, EngineConfig, SamplingParams
from repro_torch.weights import params_from_jax

torch.set_num_threads(1)

# (heads, KV heads) of each layout, and the degrees that divide its KV heads
HEADS = {"h9kv3": (9, 3), "h8kv4": (8, 4)}
DEGREES = {"h9kv3": (1, 3), "h8kv4": (1, 2, 4)}
SHARDED = [(name, d) for name, ds in DEGREES.items() for d in ds if d > 1]
EVERY_D = [(name, d) for name, ds in DEGREES.items() for d in ds]
KW = dict(max_seq_len=1024, num_slots=4)
BUDGET = 256
FULL_BUDGET = KW["max_seq_len"]          # sparse == dense
# 300 spans two chunks; 250 + 12 and 120 + 12 cross a 128-block boundary
# during decode; 40 is a single partial block
PROMPT_LENS = (300, 40, 250, 120)
MAX_TOKENS = 12
GRIDS = [("paged", "packed"), ("paged", "padded"),
         ("contiguous", "packed"), ("contiguous", "padded")]
# the reference's decode_bubble_stats keys of features the port does not
# run yet: none since the fault layer (faults, injected_events); each came
# with its feature (swap and per_class with preemption, merge_collectives
# and prefix with seq stripes and the prefix cache)
UNPORTED_KEYS: set = set()


class GlobalIdEngine(RefEngine):
    """The JAX engine with its prefill work lists on global ids.

    The reference's single-host ``worklists_for`` concatenates the D shards'
    lists with device-local head and kv head ids, so at D > 1 every shard's
    items address heads ``[0, H/D)`` and the other heads are never attended
    (``ROADMAP.md`` §3, the reference's D > 1 prefill fault).  Here shard d's
    ids are offset by d*H/D and d*Hkv/D; nothing else changes."""

    def worklists_for(self, seq_len):
        out = []
        for lst in super().worklists_for(seq_len):
            it = np.array(lst.items)
            d = np.arange(it.shape[0])[:, None]
            it[:, :, REF_F_HEAD] += d * (self.cfg.num_heads // it.shape[0])
            it[:, :, REF_F_KVHEAD] += d * (self.cfg.num_kv_heads
                                           // it.shape[0])
            out.append(dataclasses.replace(lst, items=it))
        return out


@functools.lru_cache(maxsize=None)
def model(name):
    """The layout's reference config and params, the port's config and
    params (the same weights), and the prompts."""
    h, hkv = HEADS[name]
    ref_cfg = dataclasses.replace(REF_SMOKE, dtype=jnp.float32,
                                  num_heads=h, num_kv_heads=hkv)
    cfg = dataclasses.replace(get_config("smollm-135m", smoke=True),
                              dtype=torch.float32, num_heads=h,
                              num_kv_heads=hkv)
    assert cfg.num_layers == 2
    ref_params = ref_init(jax.random.PRNGKey(0), ref_cfg)
    params = params_from_jax(jax.tree.map(np.asarray, ref_params), cfg,
                             device="cpu")
    rng = np.random.default_rng(0)
    prompts = tuple(rng.integers(0, cfg.vocab_size, size=n)
                    for n in PROMPT_LENS)
    return ref_cfg, ref_params, cfg, params, prompts


def ref_engine(name, d, budget=BUDGET, cls=GlobalIdEngine, **kw):
    ref_cfg, ref_params, cfg, _, _ = model(name)
    return cls(ref_cfg, ref_params,
               RefEngineConfig(**KW, budget_per_head=budget,
                               num_model_shards=d, **kw),
               profile=ref_curves(cfg.num_layers, cfg.num_heads))


def port_engine(name, d, budget=BUDGET, **kw):
    _, _, cfg, params, _ = model(name)
    return Engine(cfg, params,
                  EngineConfig(**KW, budget_per_head=budget,
                               num_model_shards=d, **kw),
                  synthetic_head_curves(cfg.num_layers, cfg.num_heads),
                  device="cpu")


@functools.lru_cache(maxsize=None)
def ref_served(name, d, layout="paged", worklist="packed", budget=BUDGET,
               global_ids=True):
    """Greedy tokens and decode bubble stats of the JAX engine."""
    eng = ref_engine(name, d, budget,
                     GlobalIdEngine if global_ids else RefEngine,
                     cache_layout=layout, decode_worklist=worklist)
    done = eng.serve(list(model(name)[4]),
                     RefSamplingParams(max_tokens=MAX_TOKENS))
    return [r.generated for r in done], eng.decode_bubble_stats


@functools.lru_cache(maxsize=None)
def port_served(name, d, layout="paged", worklist="packed", budget=BUDGET):
    eng = port_engine(name, d, budget, cache_layout=layout,
                      decode_worklist=worklist)
    done = eng.serve(list(model(name)[4]),
                     SamplingParams(max_tokens=MAX_TOKENS))
    assert all(len(r.generated) == MAX_TOKENS for r in done)
    return [r.generated for r in done], eng.decode_bubble_stats


@pytest.mark.parametrize("layout,worklist", GRIDS)
@pytest.mark.parametrize("name,d", SHARDED)
def test_tokens_equal_global_id_reference(name, d, layout, worklist):
    """At D > 1 the port serves the tokens of the JAX engine whose prefill
    ids are global, on both layouts and both decode grids."""
    want, _ = ref_served(name, d, layout, worklist)
    got, _ = port_served(name, d, layout, worklist)
    assert got == want


@pytest.mark.parametrize("worklist", ["packed", "padded"])
@pytest.mark.parametrize("name,d", EVERY_D)
def test_bubble_stats_equal_reference(name, d, worklist):
    """``decode_bubble_stats`` equals the reference's on every key both
    hold, the plan epochs' (epoch, replans, realized recovery, drift, the
    per-epoch stats) and ``last_tick``'s epoch included."""
    _, want = ref_served(name, d, "paged", worklist)
    _, got = port_served(name, d, "paged", worklist)
    assert set(want) - set(got) == UNPORTED_KEYS
    assert set(got) <= set(want)
    for key, value in got.items():
        assert value == want[key], key
    assert got["epoch"] == 0 and got["epochs"][0]["ticks"] == got["ticks"]
    assert got["ticks"] > 0 and 0 <= got["padding_waste"] < 1
    if worklist == "packed":
        # every tick after the first finds its plan built: by the previous
        # tick's prefetch, or cached
        assert got["plan_prefetches"] > 0
        assert got["plan_hits"] + got["plan_misses"] == got["ticks"]
        assert got["grid_vs_padded"] < 1
        assert got["last_tick"]["grid_items"] % (
            d * model(name)[2].num_layers) == 0
    else:
        assert got["plan_prefetches"] == got["plan_hits"] == 0
        assert got["grid_vs_padded"] == 1.0


@pytest.mark.parametrize("name,d", SHARDED)
def test_full_budget_tokens_do_not_depend_on_the_degree(name, d):
    """At ``budget_per_head = max_seq_len`` sparse attention is dense, so
    the placement cannot change a token: the port's tokens at D equal its
    tokens at D = 1 and the JAX engine's at D = 1."""
    at_d, _ = port_served(name, d, budget=FULL_BUDGET)
    at_1, _ = port_served(name, 1, budget=FULL_BUDGET)
    want, _ = ref_served(name, 1, budget=FULL_BUDGET, global_ids=False)
    assert at_d == at_1 == want


def shard_lists_on_global_ids(items, h, hkv):
    """The valid items of ``[D, L, 7]`` per-shard lists with device-local
    ids, in shard order, with shard d's ids offset by d*H/D and
    d*Hkv/D."""
    items = np.asarray(items)
    out = []
    for d, shard in enumerate(items):
        it = shard[shard[:, wl.F_VALID] == 1].copy()
        it[:, wl.F_HEAD] += d * (h // len(items))
        it[:, wl.F_KVHEAD] += d * (hkv // len(items))
        out.append(it)
    return np.concatenate(out)


@pytest.mark.parametrize("hkv,g,d", [(3, 3, 3), (4, 2, 2), (4, 2, 4),
                                     (4, 8, 2), (6, 3, 3)])
def test_one_list_is_the_shard_lists_with_offsets(hkv, g, d):
    """A work list built at one device is, item for item, the valid items
    of the D shards' lists with their ids made global (the policy takes
    the global slot; a kv_group shard holds slots [d*H/D, (d+1)*H/D))."""
    h = hkv * g
    rng = np.random.default_rng(hkv * 100 + g * 10 + d)
    budgets = rng.integers(1, 9, size=h) * 128
    for seq_len in (512, 1024):
        kw = dict(seq_len=seq_len, block=128, policy_fn=strided_policy,
                  group_size=g)
        one = wl.worklist_from_budgets(budgets, num_devices=1, **kw)
        shards = wl.worklist_from_budgets(budgets, num_devices=d, **kw)
        assert shards.items[:, :, wl.F_HEAD].max() < h // d
        np.testing.assert_array_equal(
            one.items[0][one.items[0][:, wl.F_VALID] == 1],
            shard_lists_on_global_ids(shards.items, h, hkv))


@pytest.mark.parametrize("name,d", SHARDED)
def test_prefill_lists_address_global_heads(name, d):
    """The port's prefill lists are the reference's D-shard lists with the
    offsets added, and its chunk lists equal the global-id JAX engine's,
    pads included."""
    h, hkv = HEADS[name]
    ref = ref_engine(name, d, cls=RefEngine)
    glob = ref_engine(name, d)
    eng = port_engine(name, d)
    for bucket in (128, 512, 1024):
        for mine, theirs in zip(eng.worklists_for(bucket),
                                ref.worklists_for(bucket)):
            assert mine.items.shape[0] == 1
            np.testing.assert_array_equal(
                mine.items[0][mine.items[0][:, wl.F_VALID] == 1],
                shard_lists_on_global_ids(theirs.items, h, hkv))
            assert set(mine.items[0][:, wl.F_HEAD]) == set(range(h))
    for prompt_len, q_offset, bucket in ((300, 0, 256), (300, 256, 128),
                                         (1000, 768, 256), (40, 0, 128)):
        np.testing.assert_array_equal(
            eng._chunk_worklists(prompt_len, q_offset, bucket).numpy(),
            glob._chunk_worklists(prompt_len, q_offset, bucket))


def test_reference_prefill_fault_is_recorded():
    """The reference's own D = 2 prefill lists address only heads [0,
    H/D) and kv heads [0, Hkv/D), and at full budgets (sparse == dense)
    its D = 2 tokens differ from its D = 1 tokens.  A fix of the reference
    will show here."""
    h, hkv = HEADS["h8kv4"]
    ref = ref_engine("h8kv4", 2, cls=RefEngine)
    for lst in ref.worklists_for(1024):
        it = np.asarray(lst.items).reshape(-1, wl.ITEM_FIELDS)
        it = it[it[:, wl.F_VALID] == 1]
        assert it[:, wl.F_HEAD].max() == h // 2 - 1
        assert it[:, wl.F_KVHEAD].max() == hkv // 2 - 1
    at_2, _ = ref_served("h8kv4", 2, budget=FULL_BUDGET, global_ids=False)
    at_1, _ = ref_served("h8kv4", 1, budget=FULL_BUDGET, global_ids=False)
    assert at_2 != at_1


@pytest.mark.parametrize("cfg_name,d", [("gemma3-1b", 2), ("h8kv4", 8),
                                        ("h9kv3", 9)])
def test_kv_replication_raises(cfg_name, d):
    """A degree that does not divide the KV heads needs the kv_replication
    placement, which the one-device attention cannot serve: the engine
    refuses it before it reads a weight."""
    cfg = (get_config(cfg_name) if cfg_name == "gemma3-1b"
           else model(cfg_name)[2])
    assert cfg.num_kv_heads % d and cfg.num_heads % d == 0
    with pytest.raises(NotImplementedError, match="not ported"):
        Engine(cfg, None, EngineConfig(**KW, num_model_shards=d),
               synthetic_head_curves(cfg.num_layers, cfg.num_heads),
               device="cpu")


def test_prefetch_previews_the_next_decode():
    """Each decode tick's preview (taken inside the step, before sampling)
    names the next tick's slots and positions whenever the batch does not
    change between them."""
    eng = port_engine("h8kv4", 2)
    calls, previews = [], []
    decode = eng.decode_slots

    def recorded(slots, tokens, positions, sampling=SamplingParams()):
        calls.append((list(slots), [int(p) for p in positions]))
        previews.append(eng._batcher.preview_next_decode())
        return decode(slots, tokens, positions, sampling)

    eng.decode_slots = recorded
    eng.serve(list(model("h8kv4")[4]), SamplingParams(max_tokens=MAX_TOKENS))
    matched = 0
    for (slots, pos), preview, (nslots, npos) in zip(calls, previews,
                                                     calls[1:]):
        assert preview == (slots, [p + 1 for p in pos])
        if nslots == slots:
            assert (nslots, npos) == (preview[0], list(preview[1]))
            matched += 1
    assert matched > 0
    stats = eng.decode_bubble_stats
    assert stats["plan_prefetches"] > 0 and stats["ticks"] == len(calls)


def test_launcher_prints_the_bubble_stats(capsys):
    launch_serve.main(["--arch", "smollm-135m", "--smoke", "--device",
                       "cpu", "--requests", "2", "--max-tokens", "3"])
    out = capsys.readouterr().out
    assert "decode bubbles: padding waste" in out
    assert "plan hits" in out
