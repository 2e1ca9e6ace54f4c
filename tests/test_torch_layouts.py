"""The contiguous slot-cache layout and the padded decode grid, as a slice:
the port's ``prefill_chunk`` / ``decode_step`` and ``Engine.serve`` against
the JAX reference at the SMOKE size in float32, and inside the port the
reference's invariants paged == contiguous and packed == padded (equal
greedy tokens).  Tolerance 1e-4 on float32 logits: the same operations,
sums taken in another order."""
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
from repro_torch.core import worklist as wl
from repro_torch.core.sparsity import synthetic_head_curves
from repro_torch.models import transformer as tfm
from repro_torch.serving import Engine, EngineConfig, SamplingParams
from repro_torch.weights import params_from_jax
from test_torch_model import _chunk_items

torch.set_num_threads(1)

BLK = 128
REF_CFG = dataclasses.replace(REF_SMOKE, dtype=jnp.float32)
CFG = dataclasses.replace(get_config("smollm-135m", smoke=True),
                          dtype=torch.float32)
KW = dict(max_seq_len=1024, num_slots=4, budget_per_head=256)
# 300 spans two chunks; 250 + 12 and 120 + 12 cross a 128-block boundary
# during decode; 40 is a single partial block
PROMPT_LENS = (300, 40, 250, 120, 520)
COMBOS = [("contiguous", "packed"), ("paged", "padded"),
          ("contiguous", "padded")]


@pytest.fixture(scope="module")
def ref_params():
    return ref_tfm.init_params(jax.random.PRNGKey(0), REF_CFG)


@pytest.fixture(scope="module")
def params(ref_params):
    return params_from_jax(jax.tree.map(np.asarray, ref_params), CFG,
                           device="cpu")


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.default_rng(0)
    return [rng.integers(0, CFG.vocab_size, size=n) for n in PROMPT_LENS]


@pytest.mark.parametrize("form", ["packed", "ids"])
def test_contiguous_prefill_then_decode_match_reference(ref_params, params,
                                                        form):
    """Two chunks of one prompt into slot 1 of a 3-slot cache, then one
    decode step (slot 1 continues, slots 0 and 2 idle): logits and the
    written cache agree with the reference, and idle rows keep every
    value."""
    rng = np.random.default_rng(4)
    prompt, smax, slot = 300, 512, 1
    tokens = rng.integers(0, CFG.vocab_size, size=prompt)
    ref_cache = ref_tfm.init_cache(REF_CFG, 3, smax)
    cache = tfm.init_cache(CFG, 3, smax, device="cpu")
    for q_offset, chunk, real in ((0, 256, 256), (256, 128, 44)):
        toks = np.zeros((1, chunk), np.int32)
        toks[0, :real] = tokens[q_offset:q_offset + real]
        items = _chunk_items(prompt, q_offset, chunk)
        kw = dict(kv_len=q_offset + real, last_index=real - 1)
        want, ref_cache = ref_tfm.prefill_chunk(
            ref_params, ref_cache, jnp.asarray(toks), slot, q_offset,
            REF_CFG, sparse_items=jnp.asarray(items), **kw)
        got = tfm.prefill_chunk(
            params, cache, torch.from_numpy(toks).long(), slot, q_offset,
            CFG, sparse_items=torch.from_numpy(items), **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(cache[:, :, slot, :, :prompt].numpy(),
                               np.asarray(ref_cache)[:, :, slot, :, :prompt],
                               atol=1e-5)

    cache[:, :, [0, 2]] = torch.randn(cache[:, :, [0, 2]].shape)
    idle = cache[:, :, [0, 2]].clone()               # rows with contents
    ref_cache = jnp.asarray(cache.numpy())
    pos = np.array([5, prompt, 0], np.int32)
    ids = np.full((CFG.num_layers, 3, 1, 3), -1, np.int32)
    ids[:, :, 0, 0] = 0
    ids[:, slot, 0] = [0, 1, 2]
    token = np.array([3, int(tokens[-1]), 0], np.int32)
    act = np.array([False, True, False])
    if form == "packed":
        sel = np.stack([wl.extend_packed_items(
            wl.pack_decode_items(ids[l], block=BLK).items, 16)[0]
            for l in range(CFG.num_layers)])
        ref_kw, kw = ({"packed_items": jnp.asarray(sel)},
                      {"packed_items": torch.from_numpy(sel)})
    else:
        ref_kw, kw = ({"block_ids": jnp.asarray(ids)},
                      {"block_ids": torch.from_numpy(ids)})
    want, ref_cache = ref_tfm.decode_step(
        ref_params, ref_cache, jnp.asarray(token), jnp.asarray(pos),
        REF_CFG, active=jnp.asarray(act), **ref_kw)
    got = tfm.decode_step(
        params, cache, torch.from_numpy(token).long(), torch.from_numpy(pos),
        CFG, active=torch.from_numpy(act), **kw)
    np.testing.assert_allclose(got[slot].numpy(), np.asarray(want)[slot],
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(cache[:, :, slot, :, :prompt + 1].numpy(),
                               np.asarray(ref_cache)[:, :, slot, :,
                                                     :prompt + 1], atol=1e-5)
    assert torch.equal(cache[:, :, [0, 2]], idle)


@pytest.fixture(scope="module")
def port_tokens(params, prompts):
    """Greedy tokens of every (layout, decode work list) the port serves,
    and the engines."""
    out = {}
    for layout in ("paged", "contiguous"):
        for worklist in ("packed", "padded"):
            eng = Engine(CFG, params,
                         EngineConfig(**KW, cache_layout=layout,
                                      decode_worklist=worklist),
                         synthetic_head_curves(CFG.num_layers,
                                               CFG.num_heads),
                         device="cpu")
            done = eng.serve(prompts, SamplingParams(max_tokens=12))
            out[layout, worklist] = ([r.generated for r in done], eng)
    return out


@pytest.mark.parametrize("layout,worklist", COMBOS)
def test_greedy_tokens_equal_reference_engine(ref_params, prompts,
                                              port_tokens, layout,
                                              worklist):
    ref = RefEngine(REF_CFG, ref_params,
                    RefEngineConfig(**KW, cache_layout=layout,
                                    decode_worklist=worklist),
                    profile=ref_curves(CFG.num_layers, CFG.num_heads))
    want = [r.generated for r in ref.serve(
        prompts, RefSamplingParams(max_tokens=12))]
    got, _ = port_tokens[layout, worklist]
    assert got == want
    assert all(len(t) == 12 for t in got)


@pytest.mark.parametrize("layout,worklist", COMBOS)
def test_layouts_and_work_lists_give_the_same_tokens(port_tokens, layout,
                                                     worklist):
    """paged == contiguous and packed == padded, inside the port."""
    assert port_tokens[layout, worklist][0] == \
        port_tokens["paged", "packed"][0]


@pytest.mark.parametrize("layout,worklist", COMBOS)
def test_serve_accounts_every_block_and_grid_item(port_tokens, layout,
                                                  worklist):
    _, eng = port_tokens[layout, worklist]
    alloc = eng._batcher.alloc
    assert alloc.audit() == [] and alloc.allocated_blocks == 0
    assert (eng.kv is None) == (layout == "contiguous")
    st, packed = eng.decode_stats, port_tokens["paged", "packed"][1]
    assert st["ticks"] == packed.decode_stats["ticks"]
    assert st["real_items"] == packed.decode_stats["real_items"]
    if worklist == "padded":
        # every slot at the plan's max-budget width: a grid of L x B x
        # Hkv x nb_cap items per tick, never smaller than the packed one
        nb_cap = eng._decode_ids_for_nblocks(1).shape[-1]
        assert st["grid_items"] == st["ticks"] * CFG.num_layers * \
            KW["num_slots"] * CFG.num_kv_heads * nb_cap
        assert st["grid_items"] >= packed.decode_stats["grid_items"]


@pytest.mark.parametrize("option", [
    {"cache_layout": "contiguous"}, {"decode_worklist": "padded"},
    {"cache_layout": "contiguous", "decode_worklist": "padded"}])
def test_check_supported_accepts_the_ported_options(option):
    EngineConfig(**option).check_supported()
    with pytest.raises(NotImplementedError, match="not ported"):
        EngineConfig(**option, prefix_cache=True).check_supported()


def test_launcher_serves_the_new_options_on_cpu(capsys):
    from repro_torch.launch import serve as launch_serve
    done = launch_serve.main(["--arch", "smollm-135m", "--smoke",
                              "--device", "cpu", "--prompt-lens", "5,130",
                              "--max-tokens", "2", "--cache-layout",
                              "contiguous", "--decode-worklist", "padded"])
    assert [len(r.generated) for r in done] == [2, 2]
    assert "served 2 requests" in capsys.readouterr().out
