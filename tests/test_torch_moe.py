"""The rest of the transformer family through the port: the MoE FFN
(Granite-MoE-1B, Llama4-Scout) and Minitron-8B, against the JAX reference.

- ``get_config`` of the three archs equals the reference's FULL and SMOKE
  on every field the port has, the MoE config's too, and the total and
  active parameter counts;
- ``moe_ffn`` against ``repro.models.moe.moe_ffn`` in float32 within 1e-5:
  top-8 of 32, top-1 of 16 and top-2 of 4 experts, 8 (a decode step),
  256 (a chunk) and 77 rows, with and without the int8 dispatch round
  trip; and a router skewed to one expert, which forces drops, whose kept
  (row, expert) pairs (read off the output, each expert writing its own
  columns) must be the reference's exactly;
- ``params_from_jax`` carries the ``moe`` subtree bit for bit (the router
  float32), from per-layer and stacked layouts; ``init_params`` draws the
  reference's MoE shapes, dtypes and scales on both generators;
- ``Engine.serve`` with weights from ``params_from_jax``: greedy tokens
  equal to the JAX ``Engine``'s for the SMOKE configs of the three archs,
  paged and contiguous, chunked and monolithic, packed and padded decode,
  and Granite-MoE-1B at ``kv_dtype`` int8; inside the port, paged ==
  contiguous and packed == padded;
- an expert's capacity is a function of the rows routed together, so for
  a MoE model chunked and monolithic prefill route other rows and can
  give other tokens: recorded on Llama4-Scout's SMOKE, where the
  reference and the port part alike;
- the profiling forward (``tfm.prefill(..., maps_out=)``) of Granite-MoE-1B
  against the reference's ``forward(..., maps_out=)``; the launcher serves
  the three archs' SMOKE configs on the CPU.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs import granite_moe_1b as ref_granite
from repro.configs import llama4_scout as ref_scout
from repro.configs import minitron_8b as ref_minitron
from repro.core.sparsity import synthetic_head_curves as ref_curves
from repro.models import moe as ref_moe
from repro.models import transformer as ref_tfm
from repro.serving import Engine as RefEngine
from repro.serving import EngineConfig as RefEngineConfig
from repro.serving import SamplingParams as RefSamplingParams
from repro_torch.configs import MoEConfig, TransformerConfig, get_config
from repro_torch.core.sparsity import synthetic_head_curves
from repro_torch.launch import serve as launch_serve
from repro_torch.models import moe
from repro_torch.models import transformer as tfm
from repro_torch.serving import Engine, EngineConfig, SamplingParams
from repro_torch.weights import params_from_jax

torch.set_num_threads(1)

TOL = 1e-5
REFS = {"granite-moe-1b-a400m": ref_granite,
        "llama4-scout-17b-a16e": ref_scout, "minitron-8b": ref_minitron}
ARCHS = tuple(REFS)
KW = dict(max_seq_len=1024, num_slots=4, budget_per_head=256)
# 300 spans two chunks (a 256-row and a 64-row bucket) and one 512-row
# monolithic bucket; 40 is one partial block; 250 + 10 crosses a block
PROMPT_LENS = (300, 40, 250)
MAX_TOKENS = 10
# the serves (EngineConfig options), each by the port with packed and
# padded decode; the JAX engine serves all but "contiguous" for every arch,
# that one for CONTIG_ARCH (G = 5) and "int8" for INT8_ARCH: the port's
# contiguous serves of the others are held to the JAX paged tokens
SERVES = {"paged": {}, "contiguous": {"cache_layout": "contiguous"},
          "monolithic": {"prefill_mode": "monolithic"}}
CONTIG_ARCH = "llama4-scout-17b-a16e"
INT8_ARCH = "granite-moe-1b-a400m"


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("smoke", [False, True])
def test_config_equals_the_reference(arch, smoke):
    got = get_config(arch, smoke=smoke)
    ref = REFS[arch].SMOKE if smoke else REFS[arch].FULL
    for f in dataclasses.fields(TransformerConfig):
        want, have = getattr(ref, f.name), getattr(got, f.name)
        if f.name == "dtype":
            assert str(have).removeprefix("torch.") == jnp.dtype(want).name
        elif f.name == "moe" and want is not None:
            assert dataclasses.asdict(have) == dataclasses.asdict(want)
        else:
            assert have == want, f.name
    assert got.num_params == ref.num_params
    assert got.num_active_params == ref.active_params


@pytest.mark.parametrize("n", [1, 7, 8, 77, 128, 256, 300, 512, 4096])
@pytest.mark.parametrize("e,k", [(32, 8), (16, 1), (4, 2)])
def test_capacity_equals_the_reference(n, e, k):
    assert (moe._capacity(n, MoEConfig(e, k))
            == ref_moe._capacity(n, ref_moe.MoEConfig(e, k)))


def _moe_case(seed, n, e, k, d, f, skew=False):
    """``x [1, n, d]`` and f32 expert params; with ``skew`` the router
    favours expert 0 for every row (drops) and expert ``j``'s down
    projection writes only output columns ``[j * d / e, (j + 1) * d / e)``,
    so the output shows which pairs were kept."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((1, n, d)).astype(np.float32)
    router = (rng.standard_normal((d, e)) / np.sqrt(d)).astype(np.float32)
    p = {"router": router,
         "gate": (rng.standard_normal((e, d, f)) / np.sqrt(d)).astype(
             np.float32),
         "up": (rng.standard_normal((e, d, f)) / np.sqrt(d)).astype(
             np.float32),
         "down": (rng.standard_normal((e, f, d)) / np.sqrt(f)).astype(
             np.float32)}
    if skew:
        x[..., 0] = np.abs(x[..., 0]) + 2.0
        router[0, 0] = 8.0
        w = d // e
        for j in range(e):
            keep = np.zeros(d, bool)
            keep[j * w:(j + 1) * w] = True
            p["down"][j][:, ~keep] = 0.0
    return x, p


# jitted: one compile a case instead of one a primitive and shape
_ref_moe_ffn = jax.jit(ref_moe.moe_ffn, static_argnums=2)
_ref_init = jax.jit(ref_tfm.init_params, static_argnums=1)


def _both(x, p, e, k, quantize=False):
    """The reference's and the port's outputs (numpy)."""
    want = _ref_moe_ffn(jnp.asarray(x), {n: jnp.asarray(a)
                                         for n, a in p.items()},
                        ref_moe.MoEConfig(e, k, quantize_dispatch=quantize))
    got = moe.moe_ffn(torch.from_numpy(x), {n: torch.from_numpy(a)
                                            for n, a in p.items()},
                      MoEConfig(e, k, quantize_dispatch=quantize))
    return np.asarray(want), got.numpy()


@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("n", [8, 256, 77])
@pytest.mark.parametrize("e,k,d,f", [(32, 8, 64, 48), (16, 1, 80, 64),
                                     (4, 2, 64, 96)])
def test_moe_ffn_matches_reference(e, k, d, f, n, quantize):
    x, p = _moe_case(e * 1000 + n, n, e, k, d, f)
    want, got = _both(x, p, e, k, quantize)
    assert got.shape == want.shape == x.shape
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def _kept_pairs(out, e):
    """The (row, expert) pairs whose expert wrote its columns of ``out``."""
    w = out.shape[-1] // e
    blocks = np.abs(out[0]).reshape(out.shape[1], e, w).max(-1)
    return {(int(r), int(j)) for r, j in zip(*np.nonzero(blocks))}


@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("e,k,n", [(4, 2, 256), (16, 1, 77), (32, 8, 256)])
def test_forced_drops_keep_the_reference_pairs(e, k, n, quantize):
    x, p = _moe_case(7, n, e, k, 64 if e != 16 else 80, 32, skew=True)
    want, got = _both(x, p, e, k, quantize)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    kept = _kept_pairs(want, e)
    assert _kept_pairs(got, e) == kept
    # the port's own routing names the same pairs, and some were dropped
    cfg = MoEConfig(e, k, quantize_dispatch=quantize)
    C = moe._capacity(n, cfg)
    slot, _ = moe.route(torch.from_numpy(x[0]), torch.from_numpy(p["router"]),
                        cfg)
    routed = {(r, int(s) // C) for r in range(n) for s in slot[r]
              if s < e * C}
    assert routed == kept
    assert len(kept) < n * k
    assert max(sum(1 for _, j in kept if j == x_) for x_ in range(e)) == C


def test_params_from_jax_carries_the_moe_subtree():
    """bf16 experts and the f32 router bit for bit, from the per-layer
    list and from the stacked (scan) layout."""
    ref_cfg = ref_granite.SMOKE
    cfg = get_config("granite-moe-1b-a400m", smoke=True)
    for layer_loop in ("unroll", "scan"):
        rp = _ref_init(jax.random.PRNGKey(1), dataclasses.replace(
            ref_cfg, layer_loop=layer_loop))
        p = params_from_jax(jax.tree.map(np.asarray, rp), cfg, device="cpu")
        for l in range(cfg.num_layers):
            rl = (rp["layers"][l] if layer_loop == "unroll" else
                  jax.tree.map(lambda a, l=l: a[l], rp["layers"]))
            got = p["layers"][l]["moe"]
            assert set(got) == {"router", "gate", "up", "down"}
            assert got["router"].dtype == torch.float32
            assert np.array_equal(got["router"].numpy(),
                                  np.asarray(rl["moe"]["router"]))
            for name in ("gate", "up", "down"):
                assert got[name].dtype == torch.bfloat16
                assert np.array_equal(
                    got[name].view(torch.int16).numpy(),
                    np.asarray(rl["moe"][name]).view(np.int16))
            assert "mlp" not in p["layers"][l]


@pytest.mark.parametrize("host_rng", [True, False])
def test_init_params_moe_shapes_and_scales(host_rng):
    cfg = dataclasses.replace(get_config("granite-moe-1b-a400m", smoke=True),
                              d_model=256, d_ff=384)
    p = tfm.init_params(cfg, seed=0, device="cpu", host_rng=host_rng)
    ref = _ref_init(jax.random.PRNGKey(0), dataclasses.replace(
        ref_granite.SMOKE, d_model=256, d_ff=384))
    for lp, rl in zip(p["layers"], ref["layers"]):
        for name, t in lp["moe"].items():
            want = np.asarray(rl["moe"][name])
            assert tuple(t.shape) == want.shape
            assert str(t.dtype).removeprefix("torch.") == want.dtype.name
            assert abs(t.float().std().item() / want.astype(np.float32).std()
                       - 1) < 0.05, name


# -- Engine.serve against the JAX engine at the SMOKE sizes -------------------

@pytest.fixture(scope="module", params=ARCHS)
def served(request):
    """One arch's JAX serves (``SERVES``, and int8 for ``INT8_ARCH``) and
    the port's at each of those x packed / padded, on the same weights."""
    arch = request.param
    # unrolled: the reference's scan monolithic prefill reuses layer 0's
    # work list (ROADMAP.md §3)
    ref_cfg = dataclasses.replace(REFS[arch].SMOKE, dtype=jnp.float32,
                                  layer_loop="unroll")
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              dtype=torch.float32)
    ref_params = ref_tfm.init_params(jax.random.PRNGKey(0), ref_cfg)
    params = params_from_jax(jax.tree.map(np.asarray, ref_params), cfg,
                             device="cpu")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, size=n) for n in PROMPT_LENS]
    serves = dict(SERVES)
    if arch == INT8_ARCH:
        serves["int8"] = {"kv_dtype": "int8"}
    want, got = {}, {}
    for tag, kw in serves.items():
        if tag != "contiguous" or arch == CONTIG_ARCH:
            ref = RefEngine(ref_cfg, ref_params, RefEngineConfig(**KW, **kw),
                            profile=ref_curves(cfg.num_layers,
                                               cfg.num_heads))
            want[tag] = [r.generated for r in ref.serve(
                prompts, RefSamplingParams(max_tokens=MAX_TOKENS))]
        for worklist in ("packed", "padded"):
            eng = Engine(cfg, params,
                         EngineConfig(**KW, decode_worklist=worklist, **kw),
                         synthetic_head_curves(cfg.num_layers,
                                               cfg.num_heads), device="cpu")
            got[tag, worklist] = [r.generated for r in eng.serve(
                prompts, SamplingParams(max_tokens=MAX_TOKENS))]
    return arch, want, got


@pytest.mark.parametrize("tag", [*SERVES, "int8"])
@pytest.mark.parametrize("worklist", ["packed", "padded"])
def test_greedy_tokens_equal_reference_engine(served, tag, worklist):
    arch, want, got = served
    if tag == "int8" and arch != INT8_ARCH:
        return
    if tag == "contiguous" and arch != CONTIG_ARCH:
        tag = "paged"
    elif tag == "contiguous":
        assert want["contiguous"] == want["paged"]
    assert got[tag, worklist] == want[tag]
    assert all(len(t) == MAX_TOKENS for t in got[tag, worklist])


def test_layouts_and_decode_grids_agree_inside_the_port(served):
    _, _, got = served
    base = got["paged", "packed"]
    assert all(got[k] == base for k in (("paged", "padded"),
                                        ("contiguous", "packed"),
                                        ("contiguous", "padded")))
    assert got["monolithic", "packed"] == got["monolithic", "padded"]


def test_moe_chunked_and_monolithic_route_other_rows(served):
    """A chunk routes its 256-row (or 64-row) bucket, the monolithic
    prefill the 512-row prompt bucket: capacities differ, so do the
    drops.  On both MoE SMOKE configs the 300-token prompt's tokens part
    between the modes in the reference and the port alike (its first
    token still agrees); the shorter prompts take one bucket of the same
    rows either way and agree.  The dense Minitron-8B keeps chunked ==
    monolithic."""
    arch, want, got = served
    same = [a == b for a, b in zip(want["paged"], want["monolithic"])]
    assert [a == b for a, b in zip(got["paged", "packed"],
                                   got["monolithic", "packed"])] == same
    if get_config(arch).moe is not None:
        assert same == [False, True, True]
        assert want["paged"][0][0] == want["monolithic"][0][0]
    else:
        assert all(same)


def test_maps_forward_equals_reference():
    """The profiling forward of a MoE model routes the prompt's rows
    together, as the reference's ``forward`` does: layer 1's maps see
    layer 0's drops."""
    ref_cfg = dataclasses.replace(ref_granite.SMOKE, dtype=jnp.float32)
    cfg = dataclasses.replace(get_config("granite-moe-1b-a400m", smoke=True),
                              dtype=torch.float32)
    ref_params = ref_tfm.init_params(jax.random.PRNGKey(2), ref_cfg)
    params = params_from_jax(jax.tree.map(np.asarray, ref_params), cfg,
                             device="cpu")
    tokens = np.random.default_rng(3).integers(0, cfg.vocab_size, size=300)
    @jax.jit
    def ref_maps(p, t):
        maps: list = []
        ref_tfm.forward(p, t, ref_cfg, maps_out=maps)
        return maps

    want = np.stack([np.asarray(m[0]) for m in ref_maps(
        ref_params, jnp.asarray(tokens[None]))])
    got = tfm.attention_maps_of(params, tokens, cfg)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_serves_smoke_on_cpu(arch, capsys):
    done = launch_serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                              "--requests", "2", "--max-tokens", "3"])
    assert [len(r.generated) for r in done] == [3, 3]
    out = capsys.readouterr().out
    cfg = get_config(arch, smoke=True)
    assert "served 2 requests" in out
    assert (f"{cfg.num_params} params, {cfg.num_active_params} active a "
            f"token" in out)
