"""The quantized KV pool through the whole slice: the port's ``Engine`` at
``kv_dtype`` int8 and fp8 against the JAX ``Engine`` at the SMOKE size in
float32, on both cache layouts (greedy tokens must be equal), the
byte-true packing weight, and the invariants inside the port: packed ==
padded at int8 on each layout, and ``kv_dtype="bf16"`` without a scales
tensor."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs.smollm_135m import SMOKE as REF_SMOKE
from repro.core.sparsity import synthetic_head_curves as ref_curves
from repro.models.transformer import init_params as ref_init
from repro.serving import Engine as RefEngine
from repro.serving import EngineConfig as RefEngineConfig
from repro.serving import SamplingParams as RefSamplingParams
from repro_torch.configs import get_config
from repro_torch.core.sparsity import synthetic_head_curves
from repro_torch.launch import serve as launch_serve
from repro_torch.serving import Engine, EngineConfig, SamplingParams
from repro_torch.serving.kv_cache import IntegrityError
from repro_torch.weights import params_from_jax

torch.set_num_threads(1)

CFG = dataclasses.replace(get_config("smollm-135m", smoke=True),
                          dtype=torch.float32)
KW = dict(max_seq_len=1024, num_slots=4, budget_per_head=256)
# 300 spans two chunks and its last block is partly written at prefill;
# 250 + 10 crosses a 128-block boundary during decode
PROMPT_LENS = (300, 40, 250)
MAX_TOKENS = 10


@pytest.fixture(scope="module")
def setup():
    ref_cfg = dataclasses.replace(REF_SMOKE, dtype=jnp.float32)
    ref_params = ref_init(jax.random.PRNGKey(0), ref_cfg)
    params = params_from_jax(jax.tree.map(np.asarray, ref_params), CFG,
                             device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, CFG.vocab_size, size=n) for n in PROMPT_LENS]
    return ref_cfg, ref_params, params, prompts


def ref_engine(setup, **kw):
    ref_cfg, ref_params, _, _ = setup
    return RefEngine(ref_cfg, ref_params, RefEngineConfig(**KW, **kw),
                     profile=ref_curves(CFG.num_layers, CFG.num_heads))


def port_engine(setup, **kw):
    return Engine(CFG, setup[2], EngineConfig(**KW, **kw),
                  synthetic_head_curves(CFG.num_layers, CFG.num_heads),
                  device="cpu")


@pytest.fixture(scope="module")
def port_served(setup):
    """The port's serves at int8: both layouts, both decode grids."""
    out = {}
    for layout in ("paged", "contiguous"):
        for worklist in ("packed", "padded"):
            eng = port_engine(setup, kv_dtype="int8", cache_layout=layout,
                              decode_worklist=worklist)
            done = eng.serve(setup[3], SamplingParams(max_tokens=MAX_TOKENS))
            out[layout, worklist] = ([r.generated for r in done], eng)
    return out


@pytest.mark.parametrize("kind", ["int8", "fp8"])
@pytest.mark.parametrize("layout", ["paged", "contiguous"])
def test_greedy_tokens_equal_reference_engine(setup, port_served, kind,
                                              layout):
    want = [r.generated for r in ref_engine(
        setup, kv_dtype=kind, cache_layout=layout).serve(
        setup[3], RefSamplingParams(max_tokens=MAX_TOKENS))]
    if kind == "int8":
        got = port_served[layout, "packed"][0]
    else:
        got = [r.generated for r in port_engine(
            setup, kv_dtype=kind, cache_layout=layout).serve(
            setup[3], SamplingParams(max_tokens=MAX_TOKENS))]
    assert got == want
    assert all(len(t) == MAX_TOKENS for t in got)


@pytest.mark.parametrize("layout", ["paged", "contiguous"])
def test_packed_and_padded_give_the_same_tokens(port_served, layout):
    assert port_served[layout, "padded"][0] == \
        port_served[layout, "packed"][0]


@pytest.mark.parametrize("layout", ["paged", "contiguous"])
def test_quantized_cache_holds_codes_and_scales(port_served, layout):
    """Codes in int8, float32 scales beside them, every block returned and
    the accounting clean after the serve."""
    eng = port_served[layout, "packed"][1]
    assert eng.quantized
    if layout == "paged":
        assert eng.kv.pool.dtype == torch.int8
        assert tuple(eng.kv.scales.shape) == tuple(eng.kv.pool.shape[:4])
        assert eng.kv.audit() == [] and eng.kv.alloc.allocated_blocks == 0
        written = eng.kv.scales[:, :, :-1] != 1.0          # not the trash
    else:
        assert eng.cache.dtype == torch.int8
        assert eng._staging.dtype == torch.float32, "staging stays exact"
        assert tuple(eng.cache_scales.shape) == tuple(
            eng.cache.shape[:4]) + (KW["max_seq_len"] // 128,)
        written = eng.cache_scales != 1.0
    assert written.any() and (eng.kv.scales if eng.paged
                              else eng.cache_scales).dtype == torch.float32


def test_packed_items_equal_reference_engine_at_int8(setup):
    """The byte-true packing weight: the port's packed decode items at
    int8 equal the reference engine's on the same slot block counts."""
    ref = ref_engine(setup, kv_dtype="int8")
    eng = port_engine(setup, kv_dtype="int8")
    assert eng._kv_block_bytes == ref._kv_block_bytes
    bf16 = port_engine(setup)
    assert eng._kv_block_bytes < bf16._kv_block_bytes
    for sig in ((3, 1, 2, 1), (8, 8, 1, 5), (1, 1, 1, 1)):
        want, _ = ref._build_packed_plan(sig)
        got, stats = eng._build_packed_plan(sig)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert stats["real_items"] > 0


def test_bf16_has_no_scales_and_keeps_its_tokens(setup):
    """``kv_dtype="bf16"`` builds no scales tensor and serves the reference
    engine's tokens, as before the quantized pool existed."""
    eng = port_engine(setup, kv_dtype="bf16")
    assert not eng.quantized and eng.kv.scales is None
    assert eng.cache_scales is None
    got = [r.generated for r in eng.serve(
        setup[3], SamplingParams(max_tokens=MAX_TOKENS))]
    want = [r.generated for r in ref_engine(setup).serve(
        setup[3], RefSamplingParams(max_tokens=MAX_TOKENS))]
    assert got == want


def test_resident_bytes_and_scale_audit(port_served):
    """The int8 pool's resident bytes are its codes and scales, a quarter
    of the float32 pool's plus the scales; an audit fails on scales whose
    shape drifted from the codes'."""
    eng = port_served["paged", "packed"][1]
    codes, scales = eng.kv.pool, eng.kv.scales
    assert eng.kv_bytes() == codes.numel() + 4 * scales.numel()
    eng.kv.scales = scales[:, :, :-1]
    try:
        with pytest.raises(IntegrityError, match="scale/code shape"):
            eng.kv.audit()
    finally:
        eng.kv.scales = scales
    assert eng.kv.audit() == []
    contig = port_served["contiguous", "packed"][1]
    assert contig.kv_bytes() == (contig.cache.numel()
                                 + 4 * contig.cache_scales.numel()
                                 + 4 * contig._staging.numel())


def test_contiguous_quantized_needs_one_scale_grid(setup):
    """The quantized slot cache's scale tiles are the model's block_kv
    wide: a cache of part blocks is refused."""
    from repro_torch.models import transformer as tfm
    with pytest.raises(ValueError, match="max_len % block"):
        tfm.init_cache_scales(CFG, 2, 1000, 128, device="cpu")
    with pytest.raises(NotImplementedError, match="not ported"):
        EngineConfig(kv_dtype="int4").check_supported()


def test_launcher_serves_kv_dtype_on_cpu(capsys):
    done = launch_serve.main(["--arch", "smollm-135m", "--smoke",
                              "--device", "cpu", "--prompt-lens", "5,130",
                              "--max-tokens", "2", "--kv-dtype", "fp8",
                              "--cache-layout", "contiguous"])
    assert [len(r.generated) for r in done] == [2, 2]
    assert "KV cache fp8" in capsys.readouterr().out
