"""Yi-6B through the port: its config, the head_dim-128 / G = 8 shapes of
the kernels' plain versions against the JAX reference, and the whole
slice at the reference's Yi-6B SMOKE size in float32.

- ``get_config("yi-6b")`` equals the reference's FULL and SMOKE on every
  field the port has, ``num_params`` included;
- the plain decode (#1 paged, #3 contiguous, codes too) and prefill (#2)
  versions at head_dim 128 and G = 8 against the Pallas kernels in
  interpret mode and the reference's jnp twins, tolerance 1e-5 (float32,
  the same tiles and masks, sums taken in another order);
- ``Engine.serve`` with weights from ``params_from_jax``: greedy tokens
  equal to the JAX ``Engine``'s on both layouts and both decode grids, and
  at ``kv_dtype`` int8; inside the port, paged == contiguous and packed ==
  padded;
- the CUDA wrappers' argument checks, run on CPU tensors: head_dim 128 and
  G = 8 pass (and head_dim 256, Gemma3-1B's), head_dim 16 / 96 / 512 and
  G > 8 are refused.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.attention.worklist_jnp import worklist_attention_paged as ref_wap
from repro.configs.yi_6b import FULL as REF_FULL
from repro.configs.yi_6b import SMOKE as REF_SMOKE
from repro.core.sparsity import synthetic_head_curves as ref_curves
from repro.kernels import ops as ref_ops
from repro.models.transformer import init_params as ref_init
from repro.serving import Engine as RefEngine
from repro.serving import EngineConfig as RefEngineConfig
from repro.serving import SamplingParams as RefSamplingParams
from repro_torch.attention.policies import strided_policy
from repro_torch.configs import TransformerConfig, get_config
from repro_torch.core import worklist as wl
from repro_torch.core.sparsity import synthetic_head_curves
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attn import check_flash_kernel_args
from repro_torch.kernels.flash_decode import (
    check_decode_kernel_args, packed_decode_attention,
    packed_decode_attention_paged)
from repro_torch.kernels.sparse_prefill import (
    check_prefill_kernel_args, sparse_prefill_attention)
from repro_torch.launch import serve as launch_serve
from repro_torch.models.transformer import init_params
from repro_torch.serving import Engine, EngineConfig, SamplingParams
from repro_torch.weights import params_from_jax
from test_torch_cuda import (
    as_slot_cache, as_torch, code_tensor, decode_case, prefill_case,
    quant_codes)

torch.set_num_threads(1)

BLK = 128
TOL = 1e-5
D, G = 128, 8                    # Yi-6B's head_dim and GQA group
CFG = dataclasses.replace(get_config("yi-6b", smoke=True),
                          dtype=torch.float32)
KW = dict(max_seq_len=1024, num_slots=4, budget_per_head=256)
# 300 spans two chunks and its last block is partly written at prefill;
# 250 + 10 crosses a 128-block boundary during decode; 40 is one partial
# block
PROMPT_LENS = (300, 40, 250)
MAX_TOKENS = 10


@pytest.mark.parametrize("smoke,ref", [(False, REF_FULL), (True, REF_SMOKE)])
def test_config_equals_the_reference(smoke, ref):
    got = get_config("yi-6b", smoke=smoke)
    for f in dataclasses.fields(TransformerConfig):
        want = getattr(ref, f.name)
        have = getattr(got, f.name)
        if f.name == "dtype":
            assert str(have).removeprefix("torch.") == jnp.dtype(want).name
        else:
            assert have == want, f.name
    assert got.num_params == ref.num_params
    assert (got.head_dim_, got.group_size) == ((128, 8) if not smoke
                                               else (16, 8))


def test_launcher_serves_yi_smoke_on_cpu(capsys):
    done = launch_serve.main(["--arch", "yi-6b", "--smoke", "--device",
                              "cpu", "--requests", "2", "--max-tokens", "3"])
    assert [len(r.generated) for r in done] == [3, 3]
    assert "served 2 requests" in capsys.readouterr().out


def test_init_params_device_generator_draw():
    """``host_rng=False`` (how Yi-6B's full-width weights are drawn on the
    card) gives the numpy draw's tree, shapes, dtypes and scales, the same
    values for a seed and others for another seed."""
    cfg = get_config("yi-6b", smoke=True)
    host = init_params(cfg, seed=0, device="cpu")
    dev = init_params(cfg, seed=0, device="cpu", host_rng=False)
    flat = lambda p: jax.tree_util.tree_leaves_with_path(  # noqa: E731
        p, is_leaf=lambda x: isinstance(x, torch.Tensor))
    assert ([(k, v.shape, v.dtype) for k, v in flat(host)]
            == [(k, v.shape, v.dtype) for k, v in flat(dev)])
    again = init_params(cfg, seed=0, device="cpu", host_rng=False)
    other = init_params(cfg, seed=1, device="cpu", host_rng=False)
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(flat(dev),
                                                           flat(again)))
    assert not torch.equal(dev["embed"], other["embed"])
    for h, d in ((host["lm_head"], dev["lm_head"]),
                 (host["layers"][0]["mlp"]["down"],
                  dev["layers"][0]["mlp"]["down"])):
        assert abs(d.float().std() / h.float().std() - 1) < 0.05


# -- the plain kernels at head_dim 128, G = 8 --------------------------------

def _yi_decode(seed, **kw):
    """A decode case at Yi-6B's head_dim and group, 2 kv heads, 3 rows."""
    q, kp, vp, items, table, pos = decode_case(seed, Hkv=2, G=G, D=D, **kw)
    return q.reshape(3, 2, G, D), kp, vp, items, table, pos


@pytest.mark.parametrize("seed,holes,window,layout", [
    (1, True, 200, "packed"), (2, True, None, "padded")])
def test_paged_decode_d128_g8_matches_pallas_kernel(seed, holes, window,
                                                    layout):
    q, kp, vp, items, table, pos = _yi_decode(seed, holes=holes,
                                              layout=layout)
    want = ref_ops.flash_decode_packed_paged(
        *map(jnp.asarray, (q.reshape(3, 2 * G, 1, D), kp, vp, items, table,
                           pos)), block_kv=BLK, window=window,
        partials=True, use_kernel=True, interpret=True)
    got = packed_decode_attention_paged(*as_torch(q, kp, vp, items, table,
                                                  pos), block_kv=BLK,
                                        window=window)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.reshape(w.shape).numpy(), np.asarray(w),
                                   atol=TOL, rtol=TOL)


@pytest.mark.parametrize("kind", ["int8", "fp8"])
def test_code_decode_d128_g8_matches_pallas_kernel(kind):
    """#1 over a code pool (|q| < 1, one scale per (block, kv head)), and
    #3 over the same values in a slot cache: the same bits."""
    q, kp, vp, items, table, pos = _yi_decode(3)
    rng = np.random.default_rng(3)
    q = rng.uniform(-1.0, 1.0, size=q.shape).astype(np.float32)
    kc, vc = quant_codes(kp, kind), quant_codes(vp, kind)
    ks, vs = (rng.uniform(1e-3, 5e-2, size=kp.shape[:2]).astype(np.float32)
              for _ in range(2))
    np_code = {"int8": np.int8, "fp8": jnp.float8_e4m3fn}[kind]
    want = ref_ops.flash_decode_packed_paged(
        jnp.asarray(q.reshape(3, 2 * G, 1, D)),
        *(jnp.asarray(c.view(np_code)) for c in (kc, vc)),
        *map(jnp.asarray, (items, table, pos)), block_kv=BLK, partials=True,
        use_kernel=True, interpret=True, k_scales=jnp.asarray(ks),
        v_scales=jnp.asarray(vs))
    args = (torch.from_numpy(q), code_tensor(kc, kind), code_tensor(vc, kind),
            *as_torch(items, table, pos))
    got = packed_decode_attention_paged(
        *args, block_kv=BLK, k_scales=torch.from_numpy(ks),
        v_scales=torch.from_numpy(vs))
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.reshape(w.shape).numpy(), np.asarray(w),
                                   atol=TOL, rtol=TOL)
    # the slot cache of the same values: scales per (row, kv head, block)
    tb = table
    B, T = tb.shape
    sk = np.ones((B, 2, T), np.float32)
    sv = np.ones_like(sk)
    for b in range(B):
        for j in range(T):
            if tb[b, j] >= 0:
                sk[b, :, j], sv[b, :, j] = ks[tb[b, j]], vs[tb[b, j]]
    slot = packed_decode_attention(
        torch.from_numpy(q), code_tensor(as_slot_cache(kc, tb), kind),
        code_tensor(as_slot_cache(vc, tb), kind), *as_torch(items, pos),
        block_kv=BLK, k_scales=torch.from_numpy(sk),
        v_scales=torch.from_numpy(sv))
    for a, b in zip(got, slot):
        assert torch.equal(a, b), "paged == contiguous, bit for bit"


def test_contiguous_decode_d128_g8_matches_pallas_and_paged():
    """#3 over the slot cache at Yi-6B's shapes: the Pallas kernel, and
    the paged plain version's bits on equal contents."""
    q, kp, vp, items, table, pos = _yi_decode(4, layout="padded")
    kc, vc = as_slot_cache(kp, table), as_slot_cache(vp, table)
    want = ref_ops.flash_decode_packed(
        *map(jnp.asarray, (q.reshape(3, 2 * G, 1, D), kc, vc, items, pos)),
        block_kv=BLK, partials=True, use_kernel=True, interpret=True)
    got = packed_decode_attention(*as_torch(q, kc, vc, items, pos),
                                  block_kv=BLK)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.reshape(w.shape).numpy(), np.asarray(w),
                                   atol=TOL, rtol=TOL)
    paged = packed_decode_attention_paged(*as_torch(q, kp, vp, items, table,
                                                    pos), block_kv=BLK)
    for a, b in zip(got, paged):
        assert torch.equal(a, b), "paged == contiguous, bit for bit"


@pytest.mark.parametrize("seed,q_offset,kv_len,hole", [
    (0, 0, 200, False), (1, 256, 456, True)])
def test_paged_prefill_d128_g8_matches_reference_scan(seed, q_offset, kv_len,
                                                      hole):
    """#2 at 8 query heads over one kv head, head_dim 128, against the
    jnp twin the reference's chunked prefill runs."""
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


def test_contiguous_prefill_d128_g8_matches_pallas_kernel():
    """#2 in its own contiguous signature at 8 heads over one kv head,
    head_dim 128: the Pallas kernel in interpret mode."""
    rng = np.random.default_rng(5)
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


# -- the CUDA wrappers' argument checks, on CPU tensors ------------------------

def _decode_q(dh, g, dtype=torch.bfloat16):
    return torch.empty((1, 1, g, dh), dtype=dtype)


@pytest.mark.parametrize("dh,g,ok", [
    (128, 8, True), (128, 5, True), (64, 3, True), (32, 8, True),
    (16, 8, False), (256, 8, True), (96, 8, False), (128, 9, False),
    (64, 16, False)])
def test_decode_kernels_take_head_dim_128_and_g_8(dh, g, ok):
    """#1, #3 and #5 share one check: bf16 / f32 caches and int8 codes
    with scales alike."""
    for dtype, codes in ((torch.bfloat16, None), (torch.float32, None),
                         (torch.int8, torch.ones(1))):
        q = _decode_q(dh, g, torch.float32 if codes is not None else dtype)
        k = torch.empty((1, 1, BLK, dh), dtype=dtype)
        if ok:
            check_decode_kernel_args("flash_decode_paged", q, k, codes)
        else:
            with pytest.raises(ValueError, match="head_dim 32/64/128/256"):
                check_decode_kernel_args("flash_decode_paged", q, k, codes)


@pytest.mark.parametrize("dh,ok", [(32, True), (64, True), (128, True),
                                   (256, True), (16, False), (512, False)])
def test_prefill_and_flash_kernels_take_head_dim_128(dh, ok):
    """#2 (both layouts, codes too) and #4; at head_dim 128 a float32
    block holds at most 512 query rows (two threads per row), at 256 1024
    (a CTA takes a 64-row slice of the block)."""
    q, k = (torch.empty((2, 4, dh), dtype=torch.bfloat16) for _ in range(2))
    i8 = torch.empty((2, 4, dh), dtype=torch.int8)
    calls = [lambda: check_prefill_kernel_args("sparse_prefill_paged", q, k,
                                               128),
             lambda: check_prefill_kernel_args("sparse_prefill_paged", q, i8,
                                               128, torch.ones(1)),
             lambda: check_flash_kernel_args(q, k, k, 128)]
    for call in calls:
        if ok:
            call()
        else:
            with pytest.raises(ValueError, match="head_dim 32/64/128/256"):
                call()
    qf, kf = q.float(), k.float()
    limit = 512 if dh == 128 else 1024
    if ok:
        check_prefill_kernel_args("sparse_prefill_contig", qf, kf, limit)
        check_flash_kernel_args(qf, kf, kf, limit)
        with pytest.raises(ValueError, match="block_q"):
            check_prefill_kernel_args("sparse_prefill_contig", qf, kf,
                                      limit + 1)
        with pytest.raises(ValueError, match="block_q"):
            check_flash_kernel_args(qf, kf, kf, limit + 1)


# -- the whole slice at the Yi-6B SMOKE size ---------------------------------

@pytest.fixture(scope="module")
def setup():
    ref_cfg = dataclasses.replace(REF_SMOKE, dtype=jnp.float32)
    ref_params = ref_init(jax.random.PRNGKey(0), ref_cfg)
    params = params_from_jax(jax.tree.map(np.asarray, ref_params), CFG,
                             device="cpu")
    assert "lm_head" in params                   # untied embeddings
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
