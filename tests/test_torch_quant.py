"""The quantized KV pool's math and kernels' plain versions against the JAX
reference.

``repro_torch.core.quant`` against ``repro.core.quant`` on the same
numpy-seeded tiles (codes bit for bit, scales equal), and the plain
versions of the codes-and-scales forms of the decode kernels (#1 paged, #3
contiguous) and of the paged sparse prefill (#2) against the reference:
the Pallas decode kernels in interpret mode, the jnp twins, and the jnp
``worklist_attention_paged`` the quantized chunked prefill runs.  Decode
and prefill tolerance 1e-5 (float32 sums in another order).  q has
``|q| < 1``, so a q cast to the code dtype would show.
"""
import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.attention.worklist_jnp import worklist_attention_paged as ref_wap
from repro.core import quant as ref_quant
from repro.kernels import ops as ref_ops
from repro_torch.core import quant
from repro_torch.kernels import ops
from repro_torch.kernels.flash_decode import flash_decode_paged_kernel
from test_torch_cuda import (
    as_slot_cache, as_torch, code_tensor, decode_case, prefill_case,
    quant_codes)

torch.set_num_threads(1)

BLK = 128
TOL = 1e-5
KINDS = ["int8", "fp8"]
_NP_CODES = {"int8": np.int8, "fp8": ml_dtypes.float8_e4m3fn}


def bits(x) -> np.ndarray:
    """The raw bytes of a code array (torch or JAX), to compare codes bit
    for bit whatever their dtype."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.uint8).numpy() if x.element_size() == 1 \
            else x.numpy()
    return np.asarray(x).view(np.uint8)


def tiles(seed, shape=(2, 3, 16, 32)):
    """Random tiles over several magnitudes, one of them all zero."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    x *= np.float32(10.0) ** rng.integers(-3, 3, size=shape[:-2] + (1, 1))
    x[(0,) * (len(shape) - 2)] = 0.0
    return x


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("seed", [0, 1])
def test_quantize_tiles_codes_and_scales_equal(kind, seed):
    x = tiles(seed)
    want_c, want_s = ref_quant.quantize_tiles(jnp.asarray(x), kind)
    got_c, got_s = quant.quantize_tiles(torch.from_numpy(x), kind)
    assert got_c.dtype == quant.KV_DTYPES[kind]
    np.testing.assert_array_equal(bits(got_c), bits(want_c))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    assert got_s[(0,) * (x.ndim - 2)] == 1.0, "an all-zero tile: scale 1"
    np.testing.assert_array_equal(
        quant.dequantize_tiles(got_c, got_s).numpy(),
        np.asarray(ref_quant.dequantize_tiles(want_c, want_s)))


@pytest.mark.parametrize("kind", KINDS)
def test_pool_and_seq_cache_quantizers_equal(kind):
    pool = tiles(2, (5, 3, 16, 32))                     # [N, Hkv, blk, Dh]
    want = ref_quant.quantize_pool_blocks(jnp.asarray(pool), kind)
    got = quant.quantize_pool_blocks(torch.from_numpy(pool), kind)
    np.testing.assert_array_equal(bits(got[0]), bits(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    cache = tiles(3, (2, 2, 2, 3, 64, 32))          # [L, 2, B, Hkv, S, Dh]
    want = ref_quant.quantize_seq_cache(jnp.asarray(cache), 16, kind)
    got = quant.quantize_seq_cache(torch.from_numpy(cache), 16, kind)
    assert tuple(got[1].shape) == (2, 2, 2, 3, 4)
    np.testing.assert_array_equal(bits(got[0]), bits(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("kind", KINDS)
def test_insert_token_requant_equal(kind):
    """Rows that start a block (offs 0), rows that append into it with and
    without growing its scale, an all-zero block, and a token far larger
    than the block's range."""
    rng = np.random.default_rng(4)
    B, hkv, blk, dh = 5, 2, 16, 32
    codes, sc = ref_quant.quantize_tiles(jnp.asarray(tiles(5, (B, hkv, blk,
                                                                dh))), kind)
    tok = rng.standard_normal((B, hkv, dh)).astype(np.float32) * 0.01
    tok[3] *= 1e4                                # outgrows the block's range
    tok[4, 0] = 0.0                              # an all-zero token
    offs = np.array([0, 5, 15, 7, 0], np.int32)
    want_c, want_s = ref_quant.insert_token_requant(
        codes, sc, jnp.asarray(tok), jnp.asarray(offs), kind)
    got_c, got_s = quant.insert_token_requant(
        code_tensor(np.array(codes), kind),
        torch.from_numpy(np.array(sc)), torch.from_numpy(tok),
        torch.from_numpy(offs), kind)
    np.testing.assert_array_equal(bits(got_c), bits(want_c))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    assert (got_s[3] > torch.from_numpy(np.array(sc))[3]).all()
    assert not bits(got_c)[0, :, 1:].any(), "offs 0 resets the block"


@pytest.mark.parametrize("kind", ["bf16", "int8", "fp8"])
def test_dtype_table_bytes_and_error_bound_equal(kind):
    assert quant.is_quantized(kind) == ref_quant.is_quantized(kind)
    for blk, dh in ((128, 64), (64, 32)):
        assert quant.kv_dtype_bytes(kind, block=blk, head_dim=dh) == \
            ref_quant.kv_dtype_bytes(kind, block=blk, head_dim=dh)
    if kind != "bf16":
        assert quant.roundtrip_error_bound(kind) == \
            ref_quant.roundtrip_error_bound(kind)
        assert quant.QMAX[kind] == ref_quant.QMAX[kind]
        assert quant.kv_cache_dtype(kind) == quant.KV_DTYPES[kind]
    else:
        assert quant.kv_cache_dtype(kind, torch.float32) == torch.float32
    with pytest.raises(ValueError, match="kv_dtype"):
        quant.is_quantized("int4")


def _jax(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _jax_codes(kind, *codes):
    """Code bits from :func:`quant_codes` as JAX arrays of the code
    dtype."""
    return [jnp.asarray(c.view(_NP_CODES[kind])) for c in codes]


def _decode_inputs(seed, kind, **kw):
    """A decode case over a code pool: ``|q| < 1``, codes from numpy and
    one scale per (block, kv head)."""
    q, kp, vp, items, table, pos = decode_case(seed, **kw)
    rng = np.random.default_rng(100 + seed)
    q = rng.uniform(-1.0, 1.0, size=q.shape).astype(np.float32)
    kc, vc = quant_codes(kp, kind), quant_codes(vp, kind)
    ks, vs = (rng.uniform(1e-3, 5e-2, size=kp.shape[:2]).astype(np.float32)
              for _ in range(2))
    return q, kc, vc, ks, vs, items, table, pos


def _close(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL,
                                   rtol=TOL)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("seed,holes,window,layout,use_kernel", [
    (0, False, None, "packed", True), (1, True, 300, "packed", True),
    (2, True, None, "padded", True), (3, False, None, "packed", False),
    (4, True, 200, "padded", False)])
def test_paged_decode_with_scales_matches_reference(kind, seed, holes,
                                                    window, layout,
                                                    use_kernel):
    """#1's plain version: the Pallas kernel in interpret mode and the jnp
    twin, on packed and padded item tables, -1 table entries and a
    window."""
    q, kc, vc, ks, vs, items, table, pos = _decode_inputs(
        seed, kind, holes=holes, layout=layout)
    want = ref_ops.flash_decode_packed_paged(
        jnp.asarray(q), *_jax_codes(kind, kc, vc),
        *_jax(items, table, pos), block_kv=BLK, window=window,
        partials=True, use_kernel=use_kernel, interpret=True,
        k_scales=jnp.asarray(ks), v_scales=jnp.asarray(vs))
    got = ops.flash_decode_packed_paged(
        torch.from_numpy(q), code_tensor(kc, kind), code_tensor(vc, kind),
        *as_torch(items, table, pos), block_kv=BLK, window=window,
        partials=True, k_scales=torch.from_numpy(ks),
        v_scales=torch.from_numpy(vs))
    _close(got, want)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("use_kernel", [True, False])
def test_paged_decode_from_block_ids_with_scales(kind, use_kernel):
    """The per-slot block-id form: the Pallas kernel from ids and the
    reference's ``flash_decode_paged_reference``."""
    q, kc, vc, ks, vs, ids, table, pos = _decode_inputs(
        5, kind, holes=True, layout="ids")
    want = ref_ops.flash_decode_paged(
        jnp.asarray(q), *_jax_codes(kind, kc, vc), *_jax(ids, table, pos),
        block_kv=BLK, partials=True,
        use_kernel=use_kernel, interpret=True, k_scales=jnp.asarray(ks),
        v_scales=jnp.asarray(vs))
    got = ops.flash_decode_paged(
        torch.from_numpy(q), code_tensor(kc, kind), code_tensor(vc, kind),
        *as_torch(ids, table, pos), block_kv=BLK, partials=True,
        k_scales=torch.from_numpy(ks), v_scales=torch.from_numpy(vs))
    _close(got, want)


def _slot_inputs(seed, kind, layout):
    """The same values as a slot cache ``[B, Hkv, T*BLK, D]`` with scales
    ``[B, Hkv, T]`` (1.0 where unmapped)."""
    q, kc, vc, ks, vs, items, table, pos = _decode_inputs(seed, kind,
                                                          layout=layout)
    B, T = table.shape
    sk = np.ones((B, kc.shape[1], T), np.float32)
    sv = np.ones_like(sk)
    for b in range(B):
        for j in range(T):
            if table[b, j] >= 0:
                sk[b, :, j], sv[b, :, j] = ks[table[b, j]], vs[table[b, j]]
    return (q, as_slot_cache(kc, table), as_slot_cache(vc, table), sk, sv,
            items, pos)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("seed,window,layout,use_kernel", [
    (6, None, "packed", True), (7, 200, "padded", True),
    (8, None, "packed", False)])
def test_contiguous_decode_with_scales_matches_reference(kind, seed, window,
                                                         layout, use_kernel):
    """#3's plain version over the slot cache, scales per (row, kv head,
    logical block)."""
    q, kc, vc, sk, sv, items, pos = _slot_inputs(seed, kind, layout)
    want = ref_ops.flash_decode_packed(
        jnp.asarray(q), *_jax_codes(kind, kc, vc), *_jax(items, pos),
        block_kv=BLK, window=window,
        partials=True, use_kernel=use_kernel, interpret=True,
        k_scales=jnp.asarray(sk), v_scales=jnp.asarray(sv))
    got = ops.flash_decode_packed(
        torch.from_numpy(q), code_tensor(kc, kind), code_tensor(vc, kind),
        *as_torch(items, pos), block_kv=BLK, window=window, partials=True,
        k_scales=torch.from_numpy(sk), v_scales=torch.from_numpy(sv))
    _close(got, want)


@pytest.mark.parametrize("kind", KINDS)
def test_decode_q_is_not_cast_to_the_code_dtype(kind):
    """With |q| < 1 an int8 cast would zero q: the result would be the
    plain mean of V.  The port takes q in float32 over codes."""
    q, kc, vc, ks, vs, items, table, pos = _decode_inputs(0, kind)
    args = (code_tensor(kc, kind), code_tensor(vc, kind),
            *as_torch(items, table, pos))
    kw = dict(block_kv=BLK, partials=True, k_scales=torch.from_numpy(ks),
              v_scales=torch.from_numpy(vs))
    got = ops.flash_decode_packed_paged(torch.from_numpy(q), *args, **kw)
    cast = ops.flash_decode_packed_paged(
        torch.from_numpy(q).to(quant.KV_DTYPES[kind]).float(), *args, **kw)
    assert not torch.allclose(got[0], cast[0], atol=1e-3)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("seed,q_offset,kv_len,hole", [
    (0, 0, 200, False), (1, 256, 456, False), (2, 384, 640, True)])
def test_paged_prefill_with_scales_matches_reference_twin(kind, seed,
                                                          q_offset, kv_len,
                                                          hole):
    """#2's plain version against ``worklist_attention_paged`` with
    ``k_scales`` / ``v_scales`` (the quantized chunked prefill's twin)."""
    q, kp, vp, items, table = prefill_case(seed, q_offset=q_offset,
                                           hole=hole)
    rng = np.random.default_rng(200 + seed)
    q = rng.uniform(-1.0, 1.0, size=q.shape).astype(np.float32)
    kc, vc = quant_codes(kp, kind), quant_codes(vp, kind)
    ks, vs = (rng.uniform(1e-3, 5e-2, size=kp.shape[:2]).astype(np.float32)
              for _ in range(2))
    want = ref_wap(jnp.asarray(q), *_jax_codes(kind, kc, vc),
                   *_jax(items, table), block_q=BLK,
                   block_kv=BLK, q_offset=q_offset, kv_len=kv_len,
                   k_scales=jnp.asarray(ks), v_scales=jnp.asarray(vs))
    got = ops.sparse_prefill(
        torch.from_numpy(q), code_tensor(kc, kind), code_tensor(vc, kind),
        *as_torch(items, table), block_q=BLK, block_kv=BLK,
        q_offset=q_offset, kv_len=kv_len, k_scales=torch.from_numpy(ks),
        v_scales=torch.from_numpy(vs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


def test_wrappers_check_the_scales():
    """Scales come both or neither, float32 of the pool's [N, Hkv], and a
    code pool needs them; the CPU path runs only for CPU tensors."""
    q, kc, vc, ks, vs, items, table, pos = _decode_inputs(0, "int8")
    qt = torch.from_numpy(q).reshape(3, 2, 3, 32)
    kc, vc = code_tensor(kc, "int8"), code_tensor(vc, "int8")
    items, table, pos = as_torch(items, table, pos)
    ks, vs = torch.from_numpy(ks), torch.from_numpy(vs)
    run = lambda **kw: flash_decode_paged_kernel(  # noqa: E731
        qt, kc, vc, items, table, pos, block_kv=BLK, **kw)
    with pytest.raises(ValueError, match="needs k_scales"):
        run()
    with pytest.raises(ValueError, match="both"):
        run(k_scales=ks)
    with pytest.raises(ValueError, match="float32"):
        run(k_scales=ks[:-1], v_scales=vs[:-1])
    with pytest.raises(ValueError, match="int8/fp8 codes"):
        flash_decode_paged_kernel(qt, kc.float(), vc.float(), items, table,
                                  pos, block_kv=BLK, k_scales=ks,
                                  v_scales=vs)
    meta = [t.to("meta") for t in (qt, kc, vc, items, table, pos, ks, vs)]
    with pytest.raises(ValueError, match="CPU or CUDA"):
        flash_decode_paged_kernel(*meta[:6], block_kv=BLK, k_scales=meta[6],
                                  v_scales=meta[7])
