"""The port's dense flash attention (TPU kernel #4) and legacy budgeted
decode (TPU kernel #5), the kernels behind the library entry points
``ops.flash_attention`` and ``ops.sparse_decode``, against the JAX
reference's Pallas kernels in interpret mode on numpy-seeded inputs.

On the CPU each wrapper runs its plain PyTorch version.  Tolerance 1e-5
(float32: the same tiles and masks, sums taken in another order).  The
CUDA kernels are held against these plain versions on the card by
``test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels import ops as ref_ops
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attn import flash_attention
from repro_torch.kernels.sparse_decode import sparse_decode_attention

torch.set_num_threads(1)

BLK = 128
TOL = 1e-5


@pytest.mark.parametrize("causal,sq,skv,hq,hkv", [
    (True, 256, 256, 4, 2),      # causal, whole blocks, GQA 2
    (False, 256, 256, 4, 2),     # non-causal
    (True, 200, 330, 6, 2),      # ragged, Sq != Skv (queries from 0)
    (False, 330, 200, 3, 1),     # ragged the other way, GQA 3
    (True, 130, 130, 2, 2),      # one query row past a block
])
def test_flash_attention_matches_pallas_kernel(causal, sq, skv, hq, hkv):
    rng = np.random.default_rng(sq + skv + hq)
    D = 32
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((hq, sq, D), (hkv, skv, D), (hkv, skv, D)))
    want = np.asarray(ref_ops.flash_attention(
        *map(jnp.asarray, (q, k, v)), causal=causal, interpret=True))
    got = ops.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                              causal=causal)
    assert got.shape == (hq, sq, D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)


def test_flash_attention_keeps_bf16_and_refuses_bad_shapes():
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((4, 64, 32), (2, 64, 32), (2, 64, 32)))
    out = flash_attention(q.bfloat16(), k.bfloat16(), v.bfloat16())
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out.float(), flash_attention(q, k, v),
                               atol=2.0 ** -6, rtol=0)
    with pytest.raises(ValueError, match="H % Hkv"):
        flash_attention(q[:3].contiguous(), k, v)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))


def _selections(rng, B, Hkv, nblk):
    return [[np.sort(rng.choice(nblk, size=int(rng.integers(1, nblk + 1)),
                                replace=False)) for _ in range(Hkv)]
            for _ in range(B)]


@pytest.mark.parametrize("seed,num_devices,pad_multiple", [
    (0, 1, 8), (1, 2, 8), (2, 1, 16)])
def test_build_decode_worklist_equals_reference(seed, num_devices,
                                                pad_multiple):
    rng = np.random.default_rng(seed)
    sels = _selections(rng, 3, 4, 5)
    sels[1][2] = np.array([], np.int64)
    got = ops.build_decode_worklist(sels, num_devices=num_devices,
                                    kv_heads_per_device=4 // num_devices,
                                    block=BLK, pad_multiple=pad_multiple)
    want = ref_ops.build_decode_worklist(
        sels, num_devices=num_devices, kv_heads_per_device=4 // num_devices,
        block=BLK, pad_multiple=pad_multiple)
    assert np.array_equal(got.items, want.items)
    assert np.array_equal(got.lengths, want.lengths)
    assert (got.padded_length, got.padded_total, got.padding_waste,
            got.imbalance) == (want.padded_length, want.padded_total,
                               want.padding_waste, want.imbalance)


@pytest.mark.parametrize("seed,cache_len,dtype", [
    (0, 3 * BLK + 17, np.float32), (1, 4 * BLK, np.float32),
    (2, 2 * BLK + 1, np.float32)])
def test_sparse_decode_matches_pallas_kernel(seed, cache_len, dtype):
    """Budgeted decode with a static cache length; one (row, kv head) pair
    selects nothing, so its output tile stays zero in the port (the Pallas
    kernel leaves it unwritten, so it is not compared)."""
    rng = np.random.default_rng(seed)
    B, Hkv, G, D, S = 3, 2, 3, 32, 4 * BLK
    q, kc, vc = (rng.standard_normal(s).astype(dtype)
                 for s in ((B, Hkv, G, D), (B, Hkv, S, D), (B, Hkv, S, D)))
    sels = _selections(rng, B, Hkv, 4)
    sels[2][1] = np.array([], np.int64)
    items = ops.build_decode_worklist(sels, num_devices=1,
                                      kv_heads_per_device=Hkv,
                                      block=BLK).items[0]
    want = np.asarray(ref_ops.sparse_decode(
        *map(jnp.asarray, (q, kc, vc, items)), cache_len=cache_len,
        interpret=True))
    got = ops.sparse_decode(*(torch.from_numpy(a) for a in
                              (q, kc, vc, items)), cache_len=cache_len)
    covered = np.ones((B, Hkv), bool)
    covered[2, 1] = False
    np.testing.assert_allclose(got.numpy()[covered], want[covered],
                               atol=TOL, rtol=TOL)
    assert not got[2, 1].any()


def test_sparse_decode_refuses_what_the_kernel_does_not_take():
    rng = np.random.default_rng(3)
    q, kc, vc = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                 for s in ((2, 1, 3, 32), (2, 1, 256, 32), (2, 1, 256, 32)))
    items = torch.from_numpy(ops.build_decode_worklist(
        [[np.array([0, 1])], [np.array([1])]], num_devices=1,
        kv_heads_per_device=1, block=BLK).items[0])
    with pytest.raises(ValueError, match="cache_len"):
        sparse_decode_attention(q, kc, vc, items, cache_len=300)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        sparse_decode_attention(*(t.to("meta") for t in (q, kc, vc, items)),
                                cache_len=200)
