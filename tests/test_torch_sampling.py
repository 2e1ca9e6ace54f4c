"""Stochastic sampling: the port's ``filter_logits`` against a transcription
of the reference's cut run through JAX (the same support, ties included),
its draws against the reference's ``sample`` in distribution (chi-square
tests on fixed seeds, so the test is deterministic), greedy unchanged and
drawing nothing, and the engine's seeded draws on the CPU."""
import dataclasses

import numpy as np
import pytest
import torch
from scipy import stats

import jax
import jax.numpy as jnp
from repro.serving.sampler import SamplingParams as RefSamplingParams
from repro.serving.sampler import sample as ref_sample
from repro_torch.configs import get_config
from repro_torch.core.sparsity import synthetic_head_curves
from repro_torch.launch import serve as launch_serve
from repro_torch.models.transformer import init_params
from repro_torch.serving import Engine, EngineConfig, SamplingParams
from repro_torch.serving.sampler import filter_logits, sample

torch.set_num_threads(1)

# chi-square p-values below this floor fail (fixed seeds: each test draws
# the same samples on every run)
P_FLOOR = 1e-3
DRAWS = 20000
# fixed logits with ties: at the 3rd / 5th largest (top-k), and around the
# top-p cutoffs; 2.0 appears three times, 0.5 twice
LOGITS = np.array([[2.0, 1.0, 2.0, 0.5, 3.0, 2.0, 0.5, -1.0, 1.5, -3.0],
                   [0.0, 0.0, 0.0, 0.0, 1.0, 1.0, -2.0, 4.0, 0.0, -0.5]],
                  np.float32)
CUTS = [SamplingParams(temperature=1.0),
        SamplingParams(temperature=0.7, top_k=3),
        SamplingParams(temperature=1.0, top_k=2),
        SamplingParams(temperature=1.0, top_k=50),
        SamplingParams(temperature=1.3, top_p=0.6),
        SamplingParams(temperature=1.0, top_p=0.95),
        SamplingParams(temperature=0.8, top_k=5, top_p=0.9),
        SamplingParams(temperature=2.0, top_k=4, top_p=0.3)]
CUT_IDS = [f"t{p.temperature}-k{p.top_k}-p{p.top_p}" for p in CUTS]


def ref_filter(logits, p):
    """The reference's cut, ``src/repro/serving/sampler.py:22-34``,
    transcribed and run through JAX."""
    logits = logits / p.temperature
    if p.top_k > 0:
        kth = jnp.sort(logits, axis=-1)[:, -p.top_k][:, None]
        logits = jnp.where(logits >= kth, logits, -jnp.inf)
    if p.top_p < 1.0:
        sorted_logits = jnp.sort(logits, axis=-1)[:, ::-1]
        probs = jax.nn.softmax(sorted_logits, axis=-1)
        csum = jnp.cumsum(probs, axis=-1)
        cutoff_idx = jnp.argmax(csum >= p.top_p, axis=-1)
        cutoff = jnp.take_along_axis(sorted_logits, cutoff_idx[:, None],
                                     axis=-1)
        logits = jnp.where(logits >= cutoff, logits, -jnp.inf)
    return np.asarray(logits)


def ref_params(p: SamplingParams) -> RefSamplingParams:
    return RefSamplingParams(temperature=p.temperature, top_k=p.top_k,
                             top_p=p.top_p)


@pytest.mark.parametrize("p", CUTS, ids=CUT_IDS)
def test_filter_keeps_the_reference_support(p):
    want = ref_filter(jnp.asarray(LOGITS), p)
    got = filter_logits(torch.from_numpy(LOGITS), p).numpy()
    assert np.array_equal(np.isfinite(got), np.isfinite(want))
    np.testing.assert_allclose(got[np.isfinite(got)],
                               want[np.isfinite(want)], rtol=1e-6)


def test_filter_keeps_ties_at_the_kth():
    """Three logits tie at the 2nd largest: top-k 2 keeps all four, where
    ``torch.topk``'s exactly-k would keep two."""
    got = filter_logits(torch.from_numpy(LOGITS[:1]),
                        SamplingParams(temperature=1.0, top_k=2))
    assert np.flatnonzero(np.isfinite(got.numpy()[0])).tolist() == [0, 2, 4,
                                                                     5]


def _draws(p, row, seed):
    """``DRAWS`` tokens of one logits row from each side: the port's (its
    generator seeded) and the reference's (one key, one draw per row)."""
    logits = np.repeat(LOGITS[row:row + 1], DRAWS, axis=0)
    gen = torch.Generator().manual_seed(seed)
    got = sample(torch.from_numpy(logits), p, gen).numpy()
    want = np.asarray(ref_sample(jnp.asarray(logits),
                                 jax.random.PRNGKey(seed), ref_params(p)))
    return got, want


@pytest.mark.parametrize("p", CUTS, ids=CUT_IDS)
@pytest.mark.parametrize("row", [0, 1])
def test_draws_match_reference_in_distribution(p, row):
    """Two-sample chi-square over the support, and each side's
    goodness of fit to the cut's softmax; no draw leaves the support."""
    got, want = _draws(p, row, seed=7)
    support = np.isfinite(ref_filter(jnp.asarray(LOGITS[row:row + 1]),
                                     p)[0])
    assert support[got].all() and support[want].all()
    V = LOGITS.shape[1]
    counts = np.stack([np.bincount(got, minlength=V),
                       np.bincount(want, minlength=V)])[:, support]
    if counts.shape[1] > 1:
        assert stats.chi2_contingency(counts).pvalue > P_FLOOR
    probs = torch.softmax(filter_logits(
        torch.from_numpy(LOGITS[row:row + 1]), p).double(),
        -1).numpy()[0][support]
    for c in counts:
        if len(c) > 1:
            expect = probs / probs.sum() * c.sum()
            assert stats.chisquare(c, expect).pvalue > P_FLOOR


def test_greedy_is_the_argmax_and_draws_nothing():
    """temperature 0 (top-k / top-p ignored, as in the reference): the
    first maximal index, and the generator's state is left as it was."""
    gen = torch.Generator().manual_seed(3)
    state = gen.get_state()
    logits = torch.from_numpy(LOGITS)
    for p in (SamplingParams(), SamplingParams(top_k=2, top_p=0.5)):
        got = sample(logits, p, gen)
        assert got.dtype == torch.int32
        assert got.tolist() == [4, 7]
        assert got.tolist() == np.asarray(ref_sample(
            jnp.asarray(LOGITS), jax.random.PRNGKey(0),
            ref_params(p))).tolist()
    tied = torch.tensor([[1.0, 3.0, 3.0, 0.0]])
    assert sample(tied, SamplingParams()).tolist() == [1]
    assert torch.equal(gen.get_state(), state)
    with pytest.raises(ValueError, match="Generator"):
        sample(logits, SamplingParams(temperature=1.0))


def test_seeded_draws_repeat_and_differ():
    logits = torch.from_numpy(np.repeat(LOGITS, 64, axis=0))
    p = SamplingParams(temperature=1.0)
    a = sample(logits, p, torch.Generator().manual_seed(11))
    b = sample(logits, p, torch.Generator().manual_seed(11))
    c = sample(logits, p, torch.Generator().manual_seed(12))
    assert torch.equal(a, b) and not torch.equal(a, c)


CFG = dataclasses.replace(get_config("smollm-135m", smoke=True),
                          dtype=torch.float32)
KW = dict(max_seq_len=1024, num_slots=4, budget_per_head=256)


def _serve(p, seed=0, **kw):
    eng = Engine(CFG, init_params(CFG, seed=0, device="cpu"),
                 EngineConfig(**KW, seed=seed, **kw),
                 synthetic_head_curves(CFG.num_layers, CFG.num_heads),
                 device="cpu")
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, CFG.vocab_size, size=n) for n in (300, 40)]
    return [r.generated for r in eng.serve(prompts, p)]


@pytest.mark.parametrize("layout", ["paged", "contiguous"])
def test_engine_seeded_serves(layout):
    """The engine's generator: one seed repeats its serve token for token,
    another does not; top-k 1 is greedy; the seed leaves greedy alone."""
    p = SamplingParams(temperature=0.8, top_k=50, top_p=0.95, max_tokens=8)
    a = _serve(p, cache_layout=layout)
    assert a == _serve(p, cache_layout=layout)
    assert a != _serve(p, seed=1, cache_layout=layout)
    greedy = _serve(SamplingParams(max_tokens=8), cache_layout=layout)
    assert greedy == _serve(SamplingParams(max_tokens=8), seed=5,
                            cache_layout=layout)
    assert _serve(SamplingParams(temperature=1.0, top_k=1, max_tokens=8),
                  cache_layout=layout) == greedy


def test_launcher_samples(capsys):
    args = ["--arch", "smollm-135m", "--smoke", "--device", "cpu",
            "--prompt-lens", "40,130", "--max-tokens", "4",
            "--temperature", "0.8", "--top-k", "50", "--top-p", "0.95"]
    a = launch_serve.main(args + ["--sample-seed", "3"])
    b = launch_serve.main(args + ["--sample-seed", "3"])
    assert [r.generated for r in a] == [r.generated for r in b]
    assert "served 2 requests" in capsys.readouterr().out
