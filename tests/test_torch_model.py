"""The port's model against the JAX reference at the SMOKE size.

``params_from_jax`` moves the reference's params bit for bit; the model
building blocks agree elementwise; ``prefill_chunk_paged`` and
``decode_step_paged`` give the reference's logits and pool contents on the
same tokens, tables and work lists.  Tolerance 1e-4 on float32 logits: the
same operations, matmul and attention sums taken in another order.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.attention.rope import apply_rope as ref_rope
from repro.configs.smollm_135m import SMOKE as REF_SMOKE
from repro.models import common as ref_common
from repro.models import transformer as ref_tfm
from repro_torch.attention.policies import strided_policy
from repro_torch.attention.rope import apply_rope
from repro_torch.configs import get_config
from repro_torch.core import worklist as wl
from repro_torch.models import common
from repro_torch.models import transformer as tfm
from repro_torch.weights import params_from_jax

torch.set_num_threads(1)

BLK = 128
REF_CFG = dataclasses.replace(REF_SMOKE, dtype=jnp.float32)
CFG = dataclasses.replace(get_config("smollm-135m", smoke=True),
                          dtype=torch.float32)


@pytest.fixture(scope="module")
def ref_params():
    return ref_tfm.init_params(jax.random.PRNGKey(0), REF_CFG)


@pytest.fixture(scope="module")
def params(ref_params):
    return params_from_jax(jax.tree.map(np.asarray, ref_params), CFG,
                           device="cpu")


def test_params_from_jax_is_bit_exact_in_bf16():
    jp = jax.tree.map(np.asarray, ref_tfm.init_params(
        jax.random.PRNGKey(1), REF_SMOKE))              # bf16, stacked
    tp = params_from_jax(jp, get_config("smollm-135m", smoke=True),
                         device="cpu")
    assert len(tp["layers"]) == REF_SMOKE.num_layers
    for l in range(REF_SMOKE.num_layers):
        for grp, name in (("attn", "wq"), ("attn", "wo"), ("mlp", "down")):
            want = jp["layers"][grp][name][l]
            got = tp["layers"][l][grp][name]
            assert got.dtype == torch.bfloat16
            assert np.array_equal(got.view(torch.int16).numpy(),
                                  want.view(np.int16))
        assert np.array_equal(tp["layers"][l]["ln1"].numpy(),
                              jp["layers"]["ln1"][l])
    assert np.array_equal(tp["embed"].view(torch.int16).numpy(),
                          jp["embed"].view(np.int16))


def test_params_from_jax_takes_per_layer_lists():
    """The reference's unrolled layout (a list of per-layer dicts)
    converts to the same tensors as its stacked scan layout."""
    key = jax.random.PRNGKey(2)
    stacked = jax.tree.map(np.asarray, ref_tfm.init_params(key, REF_CFG))
    unrolled = {**stacked, "layers": [
        jax.tree.map(lambda a, l=l: a[l], stacked["layers"])
        for l in range(REF_CFG.num_layers)]}
    a = params_from_jax(stacked, CFG, device="cpu")
    b = params_from_jax(unrolled, CFG, device="cpu")
    for la, lb in zip(a["layers"], b["layers"]):
        assert torch.equal(la["attn"]["wk"], lb["attn"]["wk"])
        assert torch.equal(la["mlp"]["up"], lb["mlp"]["up"])
    with pytest.raises(ValueError, match="layers"):
        params_from_jax({**stacked, "layers": unrolled["layers"][:1]}, CFG,
                        device="cpu")


def test_building_blocks_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 3, 5, 32)).astype(np.float32)
    w = rng.standard_normal(32).astype(np.float32)
    pos = np.arange(7, 12)
    np.testing.assert_allclose(
        common.rmsnorm(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
        np.asarray(ref_common.rmsnorm(jnp.asarray(x), jnp.asarray(w))),
        atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(
        apply_rope(torch.from_numpy(x), torch.from_numpy(pos)).numpy(),
        np.asarray(ref_rope(jnp.asarray(x), jnp.asarray(pos))),
        atol=1e-5, rtol=1e-5)
    g, u, d = (rng.standard_normal(s).astype(np.float32)
               for s in ((32, 16), (32, 16), (16, 32)))
    np.testing.assert_allclose(
        common.swiglu(*map(torch.from_numpy, (x, g, u, d))).numpy(),
        np.asarray(ref_common.swiglu(*map(jnp.asarray, (x, g, u, d)))),
        atol=1e-4, rtol=1e-5)
    h = rng.standard_normal((2, 5, 96)).astype(np.float32)
    split = common.split_heads(torch.from_numpy(h), 3)
    assert np.array_equal(split.numpy(),
                          np.asarray(ref_common.split_heads(h, 3)))
    assert np.array_equal(common.merge_heads(split).numpy(), h)


def _chunk_items(prompt, q_offset, chunk):
    """[L, P, 7] chunk work lists sliced from the prompt's full lists."""
    nq = -(-prompt // BLK)
    lists = []
    for layer in range(CFG.num_layers):
        sels = [strided_policy(h, 2 + (h + layer) % 3, nq, nq)
                for h in range(CFG.num_heads)]
        full = wl.build_worklist(
            sels, np.zeros(CFG.num_heads, np.int64), 1, nq, nq, BLK,
            kv_head_of_head=np.zeros(CFG.num_heads, np.int64))
        lists.append(wl.chunk_items(full.items[0], q_offset // BLK,
                                    chunk // BLK, pad_to=64))
    return np.stack(lists)


def test_prefill_then_decode_match_reference(ref_params, params):
    """Two chunks of one prompt, then one decode step of two rows (one
    inactive): logits and the written pool agree with the reference."""
    rng = np.random.default_rng(3)
    T, N = 4, 10
    prompt = 300
    tokens = rng.integers(0, CFG.vocab_size, size=prompt)
    table = np.full((T,), -1, np.int32)
    table[:3] = [7, 2, 5]
    ref_pool = ref_tfm.init_paged_cache(REF_CFG, N, BLK)
    pool = tfm.init_paged_cache(CFG, N, BLK, device="cpu")
    for q_offset, chunk, real in ((0, 256, 256), (256, 128, 44)):
        toks = np.zeros((1, chunk), np.int32)
        toks[0, :real] = tokens[q_offset:q_offset + real]
        items = _chunk_items(prompt, q_offset, chunk)
        kw = dict(kv_len=q_offset + real, last_index=real - 1)
        want, ref_pool = ref_tfm.prefill_chunk_paged(
            ref_params, ref_pool, jnp.asarray(toks), jnp.asarray(table),
            q_offset, REF_CFG, sparse_items=jnp.asarray(items), **kw)
        got = tfm.prefill_chunk_paged(
            params, pool, torch.from_numpy(toks).long(),
            torch.from_numpy(table), q_offset, CFG,
            sparse_items=torch.from_numpy(items), **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-4, rtol=1e-4)
    for b in (7, 2, 5):         # the sequence's blocks (trash is junk)
        np.testing.assert_allclose(pool[:, :, b].numpy(),
                                   np.asarray(ref_pool)[:, :, b], atol=1e-5)

    # decode: row 0 continues the prompt at position 300, row 1 is idle
    dtable = np.full((2, T), -1, np.int32)
    dtable[0] = table
    pos = np.array([prompt, 0], np.int32)
    ids = np.full((CFG.num_layers, 2, 1, 3), -1, np.int32)
    ids[:, 0, 0] = [0, 1, 2]
    items = np.stack([wl.extend_packed_items(
        wl.pack_decode_items(ids[l], block=BLK).items, 16)[0]
        for l in range(CFG.num_layers)])
    token = np.array([int(tokens[-1]), 0], np.int32)
    act = np.array([True, False])
    want, ref_pool = ref_tfm.decode_step_paged(
        ref_params, ref_pool, jnp.asarray(token), jnp.asarray(pos),
        jnp.asarray(dtable), REF_CFG, packed_items=jnp.asarray(items),
        active=jnp.asarray(act))
    got = tfm.decode_step_paged(
        params, pool, torch.from_numpy(token).long(), torch.from_numpy(pos),
        torch.from_numpy(dtable), CFG, packed_items=torch.from_numpy(items),
        active=torch.from_numpy(act))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want)[0],
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(pool[:, :, 5].numpy(),
                               np.asarray(ref_pool)[:, :, 5], atol=1e-5)


def test_attn_override_hooks_match_the_one_device_steps(params):
    """``prefill`` / ``decode_step`` with an ``attn_override`` that runs
    the kernels they run themselves give the same bits, and the override
    sees the reference's arguments: (l, q [B, H, S, D], k, v) and (l, q
    [B, H, 1, D], kc, vc) over the written cache."""
    from repro_torch.kernels import ops
    S, B = 300, 2
    rng = np.random.default_rng(4)
    tokens = torch.from_numpy(rng.integers(0, CFG.vocab_size, (B, S)))
    want, cache_want = tfm.prefill(params, tokens, CFG, cache_len=512)
    seen = []

    def dense(l, q, k, v):
        seen.append((l, tuple(q.shape), tuple(k.shape)))
        o = torch.empty_like(q)
        for b in range(q.shape[0]):
            o[b] = ops.flash_attention(
                q[b].contiguous(), k[b].contiguous(), v[b].contiguous(),
                causal=True, block_q=CFG.block_q, block_kv=CFG.block_kv,
                window=tfm._window_of(CFG, l))
        return o
    got, cache = tfm.prefill(params, tokens, CFG, cache_len=512,
                             attn_override=dense)
    assert torch.equal(got, want) and torch.equal(cache, cache_want)
    assert seen == [(l, (B, 3, S, 32), (B, 1, S, 32)) for l in range(2)]
    token = want.argmax(-1)
    pos = torch.full((B,), S, dtype=torch.int32)
    c1 = cache.clone()
    want = tfm.decode_step(params, c1, token, pos, CFG)
    ids = torch.from_numpy(tfm.dense_decode_ids(
        pos.numpy(), np.ones(B, bool), CFG.num_kv_heads, BLK))

    def decode(l, q, kc, vc):
        assert q.shape == (B, 3, 1, 32) and kc.shape == (B, 1, 512, 32)
        return ops.flash_decode(q, kc, vc, ids, pos, block_kv=BLK,
                                window=tfm._window_of(CFG, l))
    c2 = cache.clone()
    got = tfm.decode_step(params, c2, token, pos, CFG, attn_override=decode)
    assert torch.equal(got, want) and torch.equal(c1, c2)


def test_seq_offset_writes_only_the_held_positions(params):
    """A rank holding positions [256, 512) of the sequence writes a row's
    token only where it holds the row's position, at the local offset."""
    B = 2
    cache = torch.zeros((2, 2, B, 1, 256, 32))
    token = torch.tensor([5, 7])
    pos = torch.tensor([300, 100], dtype=torch.int32)
    seen = []
    tfm.decode_step(params, cache, token, pos, CFG, seq_offset=256,
                    attn_override=lambda l, q, kc, vc: seen.append(l)
                    or torch.zeros_like(q))
    assert seen == [0, 1]
    written = cache.abs().sum(dim=(0, 1, 3, 5))          # [B, 256]
    assert written[0].nonzero().flatten().tolist() == [300 - 256]
    assert written[1].abs().sum() == 0
