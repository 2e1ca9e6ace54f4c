"""The whole slice: the port's ``Engine.serve`` against the JAX ``Engine``
at the SMOKE size in float32, plus the engine's device contract, its
unsupported options, the launcher and the pool accounting."""
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
from repro_torch.models.transformer import init_params
from repro_torch.serving import Engine, EngineConfig, SamplingParams
from repro_torch.serving.kv_cache import BlockAllocator, IntegrityError
from repro_torch.weights import params_from_jax

torch.set_num_threads(1)

CFG = dataclasses.replace(get_config("smollm-135m", smoke=True),
                          dtype=torch.float32)
KW = dict(max_seq_len=1024, num_slots=4, budget_per_head=256)
# 300 spans two chunks; 250 + 12 and 120 + 12 cross a 128-block boundary
# during decode; 40 is a single partial block
PROMPT_LENS = (300, 40, 250, 120, 520)


@pytest.fixture(scope="module")
def served():
    """The same prompts through both engines, greedy, 12 tokens each."""
    ref_cfg = dataclasses.replace(REF_SMOKE, dtype=jnp.float32)
    ref_params = ref_init(jax.random.PRNGKey(0), ref_cfg)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, CFG.vocab_size, size=n) for n in PROMPT_LENS]
    ref = RefEngine(ref_cfg, ref_params, RefEngineConfig(**KW),
                    profile=ref_curves(CFG.num_layers, CFG.num_heads))
    want = ref.serve(prompts, RefSamplingParams(max_tokens=12))
    eng = Engine(CFG, params_from_jax(jax.tree.map(np.asarray, ref_params),
                                      CFG, device="cpu"),
                 EngineConfig(**KW),
                 synthetic_head_curves(CFG.num_layers, CFG.num_heads),
                 device="cpu")
    got = eng.serve(prompts, SamplingParams(max_tokens=12))
    return want, got, eng


def test_greedy_tokens_equal_reference_engine(served):
    want, got, _ = served
    assert [r.generated for r in got] == [r.generated for r in want]
    assert all(len(r.generated) == 12 for r in got)


def test_serve_frees_every_block_and_audits_clean(served):
    _, _, eng = served
    assert eng.kv.audit() == []
    assert eng.kv.alloc.allocated_blocks == 0
    st = eng.decode_stats
    assert st["ticks"] > 0 and 0 < st["real_items"] <= st["grid_items"]
    assert eng._batcher.stats.prefill_chunks > len(PROMPT_LENS)


def test_engine_defaults_to_cuda():
    """Without ``device`` the engine runs on CUDA, and raises where there
    is none instead of running on the CPU."""
    params = init_params(CFG, seed=0, device="cpu")
    prof = synthetic_head_curves(CFG.num_layers, CFG.num_heads)
    if torch.cuda.is_available():
        assert Engine(CFG, params, EngineConfig(**KW), prof).device.type \
            == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Engine(CFG, params, EngineConfig(**KW), prof)


# the plan-epoch options (drift_threshold, replan_every) serve since they
# were ported: tests/test_torch_replan.py::test_replan_options_serve; so do
# preemption and SLO admission: tests/test_torch_preemption.py, and seq
# stripes and the prefix cache: tests/test_torch_seqpar.py,
# tests/test_torch_prefix_cache.py (values neither package has stand in
# their place)
@pytest.mark.parametrize("option", [
    {"num_model_shards": 2}, {"num_model_shards": 3},
    {"decode_worklist": "ragged"}, {"kv_dtype": "int4"}, {"admission": "edf"},
    {"cache_layout": "ring"}])
def test_unported_options_raise(option):
    with pytest.raises(NotImplementedError, match="not ported"):
        Engine(CFG, init_params(CFG, seed=0, device="cpu"),
               EngineConfig(**KW, **option),
               synthetic_head_curves(CFG.num_layers, CFG.num_heads),
               device="cpu")


def test_over_length_request_comes_back_rejected():
    eng = Engine(CFG, init_params(CFG, seed=0, device="cpu"),
                 EngineConfig(**KW),
                 synthetic_head_curves(CFG.num_layers, CFG.num_heads),
                 device="cpu")
    done = eng.serve([np.arange(1020) % 512, np.arange(30)],
                     SamplingParams(max_tokens=8))
    assert done[0].rejected and done[0].reject_reason == "over_length"
    assert not done[0].generated and len(done[1].generated) == 8


def test_allocator_reserves_maps_lazily_and_audits():
    a = BlockAllocator(num_blocks=6, block=4)
    assert a.admit(0, prompt_tokens=5, max_new_tokens=4) == [5, 4]
    assert a.available_blocks == 6 - 3
    for _ in range(3):
        a.append_token(0)
    assert a.table(0) == [5, 4] and a.seq_tokens(0) == 8
    a.append_token(0)                          # crosses into block 3
    assert a.table(0) == [5, 4, 3]
    with pytest.raises(MemoryError, match="reservation"):
        for _ in range(4):
            a.append_token(0)
    assert a.audit() == []
    a._tables[0].append(0)                     # corrupt: unaccounted map
    with pytest.raises(IntegrityError):
        a.audit()


def test_launcher_runs_on_cpu_and_refuses_missing_cuda(capsys):
    done = launch_serve.main(["--arch", "smollm-135m", "--smoke",
                              "--device", "cpu", "--requests", "2",
                              "--max-tokens", "3", "--profile"])
    assert [len(r.generated) for r in done] == [3, 3]
    out = capsys.readouterr().out
    assert "served 2 requests" in out
    assert "no device kernel recorded" in out    # CPU: nothing to time
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit):
            launch_serve.main(["--arch", "smollm-135m", "--smoke"])


def test_launcher_defaults_and_prompt_lens(monkeypatch, capsys):
    """The launcher builds its engine with ``EngineConfig()``'s budget,
    sequence length and slots, and ``--prompt-lens`` sets the traffic."""
    seen = []

    def engine(cfg, params, ecfg, curves, device, injector=None):
        seen.append(ecfg)
        return Engine(cfg, params, ecfg, curves, device=device,
                      injector=injector)

    monkeypatch.setattr(launch_serve, "Engine", engine)
    done = launch_serve.main(["--arch", "smollm-135m", "--smoke",
                              "--device", "cpu", "--prompt-lens", "5,130",
                              "--max-tokens", "2"])
    assert seen == [EngineConfig()]
    assert [len(r.prompt) for r in done] == [5, 130]
    assert [len(r.generated) for r in done] == [2, 2]
    assert "served 2 requests" in capsys.readouterr().out
