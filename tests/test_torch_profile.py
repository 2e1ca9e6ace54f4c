"""The offline profiling stage in the port (paper §2.4): softmax maps from
the profiling forward, recovery curves, the profile, and a serve planned
from it, against the JAX reference at SMOKE sizes in float32.

- ``tfm.attention_maps_of`` (``tfm.prefill(..., maps_out=)``) gives the
  reference's ``forward(..., maps_out=)`` maps within 1e-5 on SmolLM-135M
  and Gemma3-1B (``LLLLLG``, window 128; the prompt is longer), and the
  maps of an 'L' layer are unwindowed, as the reference's are (a quirk the
  port copies: ``attention_maps(q, k)`` takes no window);
- ``profile_attention_weights`` of the port's maps (numpy, and a torch
  tensor through ``recovery_curves_torch``) is within 1e-6 of the
  reference's curves, and ``profile_model`` over two calibration prompts
  equals the reference's sample-weighted merge within 1e-6;
- the torch curve equals the numpy ``recovery_curve`` within 1e-9;
- an ``Engine`` planned from the port's own profile makes the JAX
  ``Engine``'s plan from the reference's profile (budgets and
  permutations) and the same greedy tokens.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs.gemma3_1b import SMOKE as REF_GEMMA
from repro.configs.smollm_135m import SMOKE as REF_SMOL
from repro.core import sparsity as ref_sp
from repro.models import transformer as ref_tfm
from repro.serving import Engine as RefEngine
from repro.serving import EngineConfig as RefEngineConfig
from repro.serving import SamplingParams as RefSamplingParams
from repro_torch.configs import get_config
from repro_torch.core import sparsity as sp
from repro_torch.models import transformer as tfm
from repro_torch.serving import Engine, EngineConfig, SamplingParams
from repro_torch.weights import params_from_jax
from test_torch_core import _causal_maps

torch.set_num_threads(1)

TOL = 1e-5
REFS = {"smollm-135m": REF_SMOL, "gemma3-1b": REF_GEMMA}
ARCHS = tuple(REFS)
# two calibration prompts; 300 reaches past Gemma3-1B SMOKE's window of 128
CALIB_LENS = (300, 170)
KW = dict(max_seq_len=1024, num_slots=4, budget_per_head=256)
SERVE_LENS = (300, 40, 250)
MAX_TOKENS = 8


@functools.lru_cache(maxsize=None)
def model(arch):
    """The reference config and params, the port's (the same weights), and
    the calibration prompts."""
    # the reference's profiling forward unrolls its layers (per-layer params)
    ref_cfg = dataclasses.replace(REFS[arch], dtype=jnp.float32,
                                  layer_loop="unroll")
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              dtype=torch.float32)
    ref_params = ref_tfm.init_params(jax.random.PRNGKey(0), ref_cfg)
    params = params_from_jax(jax.tree.map(np.asarray, ref_params), cfg,
                             device="cpu")
    rng = np.random.default_rng(7)
    calib = tuple(rng.integers(0, cfg.vocab_size, size=n) for n in CALIB_LENS)
    return ref_cfg, ref_params, cfg, params, calib


def ref_maps(arch, tokens):
    """``[L, H, S, S]`` maps of the reference's profiling forward."""
    ref_cfg, ref_params, *_ = model(arch)
    maps: list = []
    ref_tfm.forward(ref_params, jnp.asarray(np.asarray(tokens)[None]),
                    ref_cfg, maps_out=maps)
    return np.stack([np.asarray(m[0]) for m in maps])


@functools.lru_cache(maxsize=None)
def profiles(arch):
    """The reference's and the port's profiles over the calibration
    prompts (the port's maps as torch tensors: its device path)."""
    *_, cfg, params, calib = model(arch)
    want = ref_sp.profile_model(lambda t: ref_maps(arch, t), calib)
    got = sp.profile_model(lambda t: tfm.attention_maps_of(params, t, cfg),
                           calib)
    return want, got


@pytest.mark.parametrize("arch", ARCHS)
def test_maps_equal_reference_forward(arch):
    *_, cfg, params, calib = model(arch)
    got = tfm.attention_maps_of(params, calib[0], cfg)
    want = ref_maps(arch, calib[0])
    assert got.shape == (cfg.num_layers, cfg.num_heads, CALIB_LENS[0],
                         CALIB_LENS[0]) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)
    np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, atol=1e-5)
    assert (got.triu(1) == 0).all()


def test_local_layer_maps_are_unwindowed():
    """The reference's quirk, copied: an 'L' layer's maps are causal but
    not windowed, though its attention is (the window is 128; row 299
    keeps weight on keys 128 and more positions back), in the reference's
    maps as in the port's."""
    *_, cfg, params, calib = model("gemma3-1b")
    got = tfm.attention_maps_of(params, calib[0], cfg)
    want = ref_maps("gemma3-1b", calib[0])
    win = cfg.local_window
    for l in range(cfg.num_layers):
        assert cfg.layer_kind(l) in "LG"
        row = CALIB_LENS[0] - 1
        outside = slice(0, row - win + 1)
        assert (got[l, :, row, outside] > 0).all()
        assert (want[l, :, row, outside] > 0).all()
    assert cfg.layer_kind(0) == "L"


@pytest.mark.parametrize("arch", ARCHS)
def test_curves_equal_reference(arch):
    """Curves of one prompt's maps: the numpy path and the torch path of
    ``profile_attention_weights`` against the reference's on its own
    maps."""
    *_, cfg, params, calib = model(arch)
    maps = tfm.attention_maps_of(params, calib[0], cfg)
    want = ref_sp.profile_attention_weights(ref_maps(arch, calib[0]))
    for a in (maps, maps.numpy()):
        got = sp.profile_attention_weights(a)
        assert got.num_samples == want.num_samples == CALIB_LENS[0]
        np.testing.assert_allclose(got.curves, want.curves, atol=1e-6,
                                   rtol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_profile_model_equals_reference_merge(arch):
    want, got = profiles(arch)
    assert got.num_samples == want.num_samples == sum(CALIB_LENS)
    np.testing.assert_allclose(got.curves, want.curves, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(got.grid, want.grid)
    # a curve is non-decreasing, within [0, 1], and reaches 1 at frac 1
    assert (np.diff(got.curves, axis=-1) >= 0).all()
    assert got.curves.min() >= 0 and got.curves.max() <= 1 + 1e-12
    np.testing.assert_allclose(got.curves[..., -1], 1.0, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("grid", [None, np.linspace(0.0, 1.0, 17)])
def test_torch_curve_equals_numpy(seed, grid):
    """``recovery_curves_torch`` over every head at once against
    ``recovery_curve`` per head: seeded maps with underflowed entries
    inside the causal prefix, and a model's maps."""
    maps = _causal_maps(seed, L=2, H=3, S=57)
    *_, cfg, params, calib = model("smollm-135m")
    for a in (maps, tfm.attention_maps_of(params, calib[1], cfg).numpy()):
        got = sp.recovery_curves_torch(torch.from_numpy(a), grid)
        want = np.array([[sp.recovery_curve(a[l, h], grid)
                          for h in range(a.shape[1])]
                         for l in range(a.shape[0])])
        np.testing.assert_allclose(got, want, atol=1e-9, rtol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_planned_from_own_profile(arch):
    """The port plans from the profile it measured, the JAX engine from
    the reference's: equal plans (every layer's budgets, permutations, kv
    permutation) and equal greedy tokens."""
    ref_cfg, ref_params, cfg, params, _ = model(arch)
    want_prof, got_prof = profiles(arch)
    ref = RefEngine(ref_cfg, ref_params, RefEngineConfig(**KW),
                    profile=want_prof)
    eng = Engine(cfg, params, EngineConfig(**KW), got_prof, device="cpu")
    for a, b in zip(eng.plan.layers, ref.plan.layers):
        for f in ("perm", "inv_perm", "budgets", "kv_perm"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    # a measured profile is not the synthetic one: the plan differs
    synth = Engine(cfg, params, EngineConfig(**KW),
                   sp.synthetic_head_curves(cfg.num_layers, cfg.num_heads),
                   device="cpu")
    assert any(not np.array_equal(a.budgets, b.budgets)
               for a, b in zip(eng.plan.layers, synth.plan.layers))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=n) for n in SERVE_LENS]
    got = [r.generated for r in eng.serve(
        prompts, SamplingParams(max_tokens=MAX_TOKENS))]
    want = [r.generated for r in ref.serve(
        prompts, RefSamplingParams(max_tokens=MAX_TOKENS))]
    assert got == want
    assert all(len(t) == MAX_TOKENS for t in got)
