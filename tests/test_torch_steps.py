"""The port's mesh step builders (``repro_torch.launch.steps``) on the CPU
over 2 and 4 ``gloo`` ranks, SMOKE configs in float32, against the
reference's ``build_prefill_step(...).fn`` / ``build_decode_step(...).fn``
run under ``jax.jit`` with their ``in_shardings`` on a host mesh of the
same shape (one subprocess for the file, 8 host devices):

- the prefill work lists of all three list modes equal the reference's
  item for item (SmolLM-135M: 3 heads, row mode; Minitron-8B: 8 / 2 heads,
  ``kv_group`` at 2 ranks, ``kv_replication`` at 4; Gemma3-1B: 4 / 1,
  ``kv_replication``; Yi-6B: 8 / 1 with its untied, vocab-parallel
  ``lm_head``; ``force_rows``);
- the prefill and decode logits equal the reference step's within
  ``LOGIT_ATOL`` (f32; sums across ranks run in another order);
- at full budget (the budget covers the sequence) the sparse mesh prefill
  equals the dense one-process prefill;
- the mesh result equals the one-process result of the same lists
  (flattened to global ids) and block selections.

The reference's steps run on a mesh of GSPMD's Auto axes: under jax 0.9's
default Explicit axes its prefill's embedding take from a vocab-sharded
table raises.  Both decode the head-sharded cell (kv heads dividing ``model``) densely;
the seq-sharded cell attends the plan's sink and recent blocks."""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import ShapeSpec
from repro_torch.core import quant
from repro_torch.launch import steps
from repro_torch.models import transformer as tfm

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
S, B, BUDGET, SEED = 512, 2, 256, 3
S_FULL = 256                   # min(BUDGET, S_FULL) covers the sequence
LOGIT_ATOL = 2e-4
DEADLINE = 120
CASES = [("smollm-135m", 2), ("smollm-135m", 4), ("minitron-8b", 2),
         ("minitron-8b", 4), ("gemma3-1b", 2), ("gemma3-1b", 4),
         ("yi-6b", 2)]
# int8 KV cache: the head-sharded (Minitron-8B at 2) and the seq-sharded
# (Gemma3-1B at 2) decode over codes and scales
QUANT_CASES = [("minitron-8b", 2), ("gemma3-1b", 2)]
# the same cases on meshes of other shapes (4 ranks: data x model x seq),
# against the reference's step on a mesh of that shape
GRID_CASES = [("minitron-8b", 2, 1), ("gemma3-1b", 1, 2),
              ("minitron-8b", 1, 2)]
MODES = {("smollm-135m", 2): "rows", ("smollm-135m", 4): "rows",
         ("minitron-8b", 2): "kv_group", ("minitron-8b", 4): "kv_replication",
         ("gemma3-1b", 2): "kv_replication", ("gemma3-1b", 4):
         "kv_replication", ("yi-6b", 2): "kv_replication"}


def _spec(arch):
    """The port's ArchSpec with the SMOKE config in float32 as ``full``."""
    return steps.job_spec(steps.make_job(arch, (), model=1, smoke=True,
                                         dtype="float32", budget=BUDGET))


def _flat(params) -> dict:
    out = {k: v.numpy() for k, v in params.items() if k != "layers"}
    for l, lp in enumerate(params["layers"]):
        for k, v in lp.items():
            if isinstance(v, dict):
                for kk, vv in v.items():
                    out[f"layers.{l}.{k}.{kk}"] = vv.numpy()
            else:
                out[f"layers.{l}.{k}"] = v.numpy()
    return out


def case_inputs(arch, D):
    """What the port's ranks draw for the case, drawn again here for the
    reference: plan-permuted weights, prompts, the decode cache and
    token, and the port's lists."""
    spec = _spec(arch)
    cfg = spec.full
    plan, _, mode, items = steps.prefill_lists(spec, S, D, budget=BUDGET)
    params = steps.plan_params(cfg, SEED, torch.device("cpu"), plan, mode)
    cache = steps.permute_cache(steps.seeded_cache(
        cfg, B, S, SEED + 2, torch.device("cpu")), plan, mode)
    return dict(spec=spec, plan=plan, mode=mode, items=items, params=params,
                tokens=steps.seeded_tokens(cfg.vocab_size, (B, S), SEED + 1),
                cache=cache,
                token=steps.seeded_tokens(cfg.vocab_size, (B,), SEED + 3))


JAX_SCRIPT = r"""
import dataclasses, sys, warnings; warnings.filterwarnings("ignore")
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import AxisType
from repro.sharding.compat import set_mesh
from repro.configs import registry
from repro.configs.shapes import ShapeSpec
from repro.launch import steps as rs
from repro.attention.policies import policy_by_name
from repro.core.worklist import (blocks_for_budget, build_row_worklist,
                                 worklist_from_budgets)
S, B, BUDGET = int(sys.argv[3]), int(sys.argv[4]), int(sys.argv[5])
rs.SERVE_BUDGET_PER_HEAD = BUDGET
out = {}

def ref_items(spec, S, D, force_rows):
    # the reference's list building, steps.py:222-262 (its items are a
    # step input the builder does not return)
    plan, cfg = rs._serve_plan(spec, S, D)
    pol = policy_by_name("strided")
    row_mode = force_rows or plan.num_devices != D
    kv_sharded = (not row_mode) and plan.mode == "kv_group"
    wls, nq = [], -(-S // rs.BLOCK)
    for l in range(cfg.num_layers):
        lp = plan.layers[l]
        if row_mode:
            nb = blocks_for_budget(plan.budgets_by_original_head(l), rs.BLOCK)
            sels = [pol(h, int(nb[h]), nq, nq) for h in range(cfg.num_heads)]
            wls.append(build_row_worklist(
                sels, num_devices=D, num_q_blocks=nq, num_kv_blocks=nq,
                block=rs.BLOCK,
                kv_head_of_head=np.arange(cfg.num_heads) // cfg.group_size))
        elif kv_sharded:
            wls.append(worklist_from_budgets(
                lp.budgets, num_devices=D, seq_len=S, block=rs.BLOCK,
                policy_fn=pol, group_size=cfg.group_size))
        else:
            wls.append(worklist_from_budgets(
                lp.budgets, num_devices=D, seq_len=S, block=rs.BLOCK,
                policy_fn=pol, group_size=cfg.group_size,
                kv_head_of_head=lp.perm // cfg.group_size, kv_local=False))
    lpad = max(w.padded_length for w in wls)
    items = np.zeros((D, cfg.num_layers, lpad, 7), np.int32)
    for l, w in enumerate(wls):
        items[:, l, :w.padded_length] = w.items
        for d in range(D):
            items[d, l, w.padded_length:] = items[d, l, w.padded_length - 1]
            items[d, l, w.padded_length:, 3:6] = 0
    return plan, cfg, items

def tree(x):
    layers = {}
    top = {}
    for k, v in x.items():
        if k.startswith("layers."):
            _, l, *rest = k.split(".")
            d = layers.setdefault(int(l), {})
            if len(rest) == 2:
                d.setdefault(rest[0], {})[rest[1]] = jnp.asarray(v)
            else:
                d[rest[0]] = jnp.asarray(v)
        else:
            top[k] = jnp.asarray(v)
    top["layers"] = [layers[l] for l in sorted(layers)]
    return top

for name in sys.argv[6:]:
    arch, D, force, *extra = name.split(":")
    base = f"{arch}_{D}_{force}"
    D, force = int(D), force == "rows"
    spec = registry.get(arch)
    cfg = dataclasses.replace(spec.smoke, dtype=jnp.float32,
                              layer_loop="unroll")
    spec = dataclasses.replace(spec, full=cfg)
    # data x model (x seq): "data2" / "seq2" run the case's step on a mesh
    # of that shape; GSPMD's Auto axes: jax 0.9's default Explicit axes
    # refuse the step's embedding take from a vocab-sharded table
    shape = (2 if "data2" in extra else 1, D) + (
        (2,) if "seq2" in extra else ())
    names = ("data", "model", "seq")[:len(shape)]
    mesh = jax.make_mesh(shape, names, axis_types=(AxisType.Auto,) * len(shape),
                         devices=jax.devices()[:int(np.prod(shape))])
    if "int8" in extra:
        # the int8 decode step over the case's codes and scales
        x = dict(np.load(f"{sys.argv[1]}/{base}.npz"))
        q8 = dict(np.load(f"{sys.argv[1]}/{base}_int8.npz"))
        params = tree({k[2:]: v for k, v in x.items()
                       if k.startswith("u." if "u.embed" in x else "p.")})
        ds = rs.build_decode_step(spec, ShapeSpec("d", S, B, "decode"), mesh,
                                  kv_dtype="int8")
        plan, _ = rs._serve_plan(spec, S, D)
        with set_mesh(mesh):
            put = lambda a, s: jax.device_put(a, s)
            args = [put(params, ds.in_shardings["params"]),
                    (put(jnp.asarray(q8["codes"]), ds.in_shardings["cache"][0]),
                     put(jnp.asarray(q8["scales"]), ds.in_shardings["cache"][1])),
                    put(jnp.asarray(x["token"], jnp.int32),
                        ds.in_shardings["token"])]
            if "ids" in ds.abstract:
                n_sh = int(np.prod([mesh.shape[a]
                                    for a in ds.meta["seq_axes"]]))
                args.append(put(jnp.asarray(rs._decode_block_ids_sharded(
                    plan, cfg, S, n_sh)), ds.in_shardings["ids"]))
            logits, _ = jax.jit(ds.fn)(*args)
        out[f"{name}/decode"] = np.asarray(logits)
        continue
    plan, _, items = ref_items(spec, S, D, force)
    out[f"{name}/items"] = items
    x = dict(np.load(f"{sys.argv[1]}/{base}.npz"))
    params = tree({k[2:]: v for k, v in x.items() if k.startswith("p.")})
    ps = rs.build_prefill_step(spec, ShapeSpec("p", S, B, "prefill"), mesh,
                               force_rows=force)
    if force:
        # row mode over unpermuted weights: the prefill alone
        with set_mesh(mesh):
            put = lambda a, s: jax.device_put(a, s)
            logits, _ = jax.jit(ps.fn)(
                put(params, ps.in_shardings["params"]),
                put(jnp.asarray(x["tokens"], jnp.int32),
                    ps.in_shardings["tokens"]),
                put(jnp.asarray(items), ps.in_shardings["items"]))
        out[f"{name}/prefill"] = np.asarray(logits)
        continue
    ds = rs.build_decode_step(spec, ShapeSpec("d", S, B, "decode"), mesh)
    with set_mesh(mesh):
        put = lambda a, s: jax.device_put(a, s)
        logits, _ = jax.jit(ps.fn)(
            put(params, ps.in_shardings["params"]),
            put(jnp.asarray(x["tokens"], jnp.int32), ps.in_shardings["tokens"]),
            put(jnp.asarray(items), ps.in_shardings["items"]))
        out[f"{name}/prefill"] = np.asarray(logits)
        args = [put(params, ds.in_shardings["params"]),
                put(jnp.asarray(x["cache"]), ds.in_shardings["cache"]),
                put(jnp.asarray(x["token"], jnp.int32),
                    ds.in_shardings["token"])]
        if "ids" in ds.abstract:
            n_sh = int(np.prod([mesh.shape[a] for a in ds.meta["seq_axes"]]))
            ids = rs._decode_block_ids_sharded(plan, cfg, S, n_sh)
            out[f"{name}/ids"] = ids
            args.append(put(jnp.asarray(ids), ds.in_shardings["ids"]))
        out[f"{name}/branch"] = np.array(ds.meta["seq_axes"] != [] if
                                         "seq_axes" in ds.meta else False)
        logits, _ = jax.jit(ds.fn)(*args)
        out[f"{name}/decode"] = np.asarray(logits)
        if any(k.startswith("u.") for k in x):
            # kv_replication: the same step over unpermuted weights, where
            # q head s is original head s and meets kv head s // G
            args[0] = put(tree({k[2:]: v for k, v in x.items()
                                if k.startswith("u.")}),
                          ds.in_shardings["params"])
            logits, _ = jax.jit(ds.fn)(*args)
            out[f"{name}/decode_unpermuted"] = np.asarray(logits)
np.savez(sys.argv[2], **out)
print("JAX_OK")
"""


def _case_name(arch, D, force=False):
    return f"{arch}:{D}:{'rows' if force else 'plan'}"


def _grid_name(arch, data, seq):
    """A ``GRID_CASES`` case's name: the model-2 case on data x 2 x seq."""
    return _case_name(arch, 2) + (":data2" if data > 1 else ":seq2")


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's lists, prefill and decode logits of every case."""
    tmp = tmp_path_factory.mktemp("steps")
    names, inputs = [], {}
    for arch, D in CASES:
        x = case_inputs(arch, D)
        inputs[(arch, D)] = x
        name = _case_name(arch, D)
        if (arch, D) in QUANT_CASES:
            codes, scales = quant.quantize_seq_cache(x["cache"], 128, "int8")
            np.savez(tmp / f"{name.replace(':', '_')}_int8.npz",
                     codes=codes.numpy(), scales=scales.numpy())
            names.append(name + ":int8")
        unperm = {}
        if x["mode"] == "kv_replication":
            unperm = _flat(steps.plan_params(x["spec"].full, SEED,
                                             torch.device("cpu"), x["plan"],
                                             "rows"))
        np.savez(tmp / f"{name.replace(':', '_')}.npz",
                 tokens=x["tokens"], cache=x["cache"].numpy(),
                 token=x["token"],
                 **{f"p.{k}": v for k, v in _flat(x["params"]).items()},
                 **{f"u.{k}": v for k, v in unperm.items()})
        names.append(name)
    # force_rows: row mode over unpermuted weights
    x = inputs[("minitron-8b", 2)]
    force = _case_name("minitron-8b", 2, force=True)
    np.savez(tmp / f"{force.replace(':', '_')}.npz", tokens=x["tokens"],
             **{f"p.{k}": v for k, v in _flat(steps.plan_params(
                 x["spec"].full, SEED, torch.device("cpu"), x["plan"],
                 "rows")).items()})
    names.append(force)
    names += [_grid_name(*case) for case in GRID_CASES]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-c", JAX_SCRIPT, str(tmp), str(tmp / "out.npz"),
         str(S), str(B), str(BUDGET), *names],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert res.returncode == 0 and "JAX_OK" in res.stdout, res.stderr[-4000:]
    return dict(np.load(tmp / "out.npz")), inputs


@pytest.fixture(scope="module")
def mesh_runs():
    """Each case's mesh run: the prefill (and one decode step after it) at
    S, the decode step over the seeded cache at S, the prefill at full
    budget."""
    shapes = (ShapeSpec("p", S, B, "prefill"), ShapeSpec("d", S, B, "decode"),
              ShapeSpec("full", S_FULL, B, "prefill"))
    return {case: steps.run_on_mesh(
        case[0], shapes, model=case[1], backend="gloo", device="cpu",
        seed=SEED, steps=1, smoke=True, dtype="float32", budget=BUDGET,
        return_logits=True, timeout_s=DEADLINE) for case in CASES}


@pytest.fixture(scope="module")
def quant_runs():
    """The int8 cases' decode step over the seeded cache's codes."""
    return {case: steps.run_on_mesh(
        case[0], (ShapeSpec("d", S, B, "decode"),), model=case[1],
        backend="gloo", device="cpu", seed=SEED, steps=1, smoke=True,
        dtype="float32", budget=BUDGET, kv_dtype="int8", return_logits=True,
        timeout_s=DEADLINE) for case in QUANT_CASES}


@pytest.fixture(scope="module")
def grid_runs():
    """The ``GRID_CASES`` in one spawn of 4 ranks, and the ``force_rows``
    run of Minitron-8B at ``model=2``: each the prefill (and one decode
    step after it) at S and the decode step over the seeded cache."""
    shapes = (ShapeSpec("p", S, B, "prefill"), ShapeSpec("d", S, B, "decode"))
    kw = dict(seed=SEED, steps=1, smoke=True, dtype="float32",
              budget=BUDGET, return_logits=True)
    jobs = [steps.make_job(arch, shapes, model=2, data=data, seq=seq, **kw)
            for arch, data, seq in GRID_CASES]
    res = steps.run_mesh_jobs(jobs, backend="gloo", device="cpu",
                              timeout_s=DEADLINE)
    out = dict(zip(GRID_CASES, res))
    out["force_rows"] = steps.run_on_mesh(
        "minitron-8b", shapes, model=2, force_rows=True, backend="gloo",
        device="cpu", timeout_s=DEADLINE, **kw)
    return out


def _grid_logits(ranks, run: int, call: int):
    """The logits of a call, each ``data`` group's rows in data order (the
    ranks of a group, over ``model`` and ``seq``, hold the same)."""
    rows = []
    for g in sorted({r["coords"]["data"] for r in ranks}):
        mine = [r for r in ranks if r["coords"]["data"] == g]
        rows.append(_rank_logits(mine, run, call))
    return np.concatenate(rows)


@pytest.mark.parametrize("arch,data,seq", GRID_CASES)
def test_grid_prefill_logits_equal_reference_step(reference, grid_runs,
                                                  arch, data, seq):
    """The prefill on data x model x seq (rows over ``data``; the ``seq``
    ranks run their ``model`` group's lists) against the reference's step
    on a mesh of that shape."""
    ref, _ = reference
    ranks = grid_runs[(arch, data, seq)]
    assert len(ranks) == 4
    assert ranks[0]["runs"][0]["mode"] == MODES[(arch, 2)]
    np.testing.assert_allclose(_grid_logits(ranks, 0, 0),
                               ref[f"{_grid_name(arch, data, seq)}/prefill"],
                               atol=LOGIT_ATOL, rtol=0)


@pytest.mark.parametrize("arch,data,seq", GRID_CASES)
def test_grid_decode_logits(reference, grid_runs, arch, data, seq):
    """The decode step on data x model x seq.  Minitron-8B's rows over
    ``data`` (head-sharded cell) and Gemma3-1B's cache striped over
    (``model``, ``seq``) against the reference's step on a mesh of that
    shape; Minitron-8B at ``model=2`` x ``seq=2`` stripes its cache over
    ``seq`` and attends the plan's sink and recent blocks, which the
    reference's step, placing nothing on ``seq``, decodes densely: held
    against one process attending that selection."""
    ref, inputs = reference
    ranks = grid_runs[(arch, data, seq)]
    name = _grid_name(arch, data, seq)
    got = _grid_logits(ranks, 1, 0)
    branch = ranks[0]["runs"][1]["branch"]
    if arch == "minitron-8b" and seq > 1:
        assert branch == "seq" and not bool(ref[f"{name}/branch"])
        x = inputs[(arch, 2)]
        cfg = x["spec"].full
        ids = steps._decode_block_ids_sharded(x["plan"], cfg, S, 1)[:, 0]
        block_ids = torch.from_numpy(np.broadcast_to(
            ids[:, None], (cfg.num_layers, B) + ids.shape[1:]).copy())
        want = tfm.decode_step(x["params"], x["cache"].clone(),
                               torch.from_numpy(x["token"]),
                               torch.full((B,), S - 1, dtype=torch.int32),
                               _unwindowed(cfg), block_ids=block_ids)
        np.testing.assert_allclose(got, want.numpy(), atol=LOGIT_ATOL, rtol=0)
        return
    assert branch == ("heads" if arch == "minitron-8b" else "seq")
    np.testing.assert_allclose(got, ref[f"{name}/decode"], atol=LOGIT_ATOL,
                               rtol=0)


def test_force_rows_run_equals_reference_step(reference, grid_runs):
    """``force_rows`` through ``run_on_mesh``: Minitron-8B at ``model=2``
    (a ``kv_group`` plan) prefills in row mode over unpermuted weights,
    against the reference's ``build_prefill_step(..., force_rows=True)``;
    its decode step (whole q, each rank's heads) equals the reference's
    step over the plan-permuted weights, the same model."""
    ref, _ = reference
    ranks = grid_runs["force_rows"]
    assert [r["mode"] for r in ranks[0]["runs"]] == ["rows", "rows"]
    np.testing.assert_allclose(
        _rank_logits(ranks, 0, 0),
        ref[f"{_case_name('minitron-8b', 2, True)}/prefill"],
        atol=LOGIT_ATOL, rtol=0)
    np.testing.assert_allclose(
        _rank_logits(ranks, 1, 0), ref[f"{_case_name('minitron-8b', 2)}"
                                       f"/decode"], atol=LOGIT_ATOL, rtol=0)


@pytest.mark.parametrize("arch,D", QUANT_CASES)
def test_int8_decode_logits_equal_reference_step(reference, quant_runs,
                                                 arch, D):
    """The decode step over an int8 cache (codes and one scale a block
    tile, the token requantized into its tile) in both branches, against
    the reference's ``build_decode_step(..., kv_dtype="int8")``; in
    kv_replication over unpermuted weights (one kv head here, so the
    same)."""
    ref, _ = reference
    ranks = quant_runs[(arch, D)]
    assert ranks[0]["runs"][0]["branch"] == ("heads" if arch == "minitron-8b"
                                             else "seq")
    np.testing.assert_allclose(_rank_logits(ranks, 0, 0),
                               ref[f"{_case_name(arch, D)}:int8/decode"],
                               atol=LOGIT_ATOL, rtol=0)


@pytest.mark.parametrize("arch,D", CASES)
def test_prefill_lists_equal_reference(reference, arch, D):
    ref, inputs = reference
    x = inputs[(arch, D)]
    assert x["mode"] == MODES[(arch, D)]
    assert np.array_equal(x["items"], ref[f"{_case_name(arch, D)}/items"])


def test_force_rows_lists_equal_reference(reference):
    ref, _ = reference
    _, _, mode, items = steps.prefill_lists(_spec("minitron-8b"), S, 2,
                                            budget=BUDGET, force_rows=True)
    assert mode == "rows"
    assert np.array_equal(items, ref[f"{_case_name('minitron-8b', 2, True)}"
                                     f"/items"])


def _rank_logits(ranks, run: int, call: int):
    """The logits every rank returned for a call (all equal: the logits
    are gathered over ``model``)."""
    got = [r["runs"][run]["logits"][call].numpy() for r in ranks]
    for g in got[1:]:
        assert np.array_equal(g, got[0])
    return got[0]


@pytest.mark.parametrize("arch,D", CASES)
def test_prefill_logits_equal_reference_step(reference, mesh_runs, arch, D):
    ref, _ = reference
    ranks = mesh_runs[(arch, D)]
    assert ranks[0]["runs"][0]["mode"] == MODES[(arch, D)]
    np.testing.assert_allclose(_rank_logits(ranks, 0, 0),
                               ref[f"{_case_name(arch, D)}/prefill"],
                               atol=LOGIT_ATOL, rtol=0)


@pytest.mark.parametrize("arch,D", CASES)
def test_decode_logits_equal_reference_step(reference, mesh_runs, arch, D):
    """One decode step at position S - 1 over the seeded cache: the
    seq-sharded island where the kv heads do not divide ``model``, the
    head-sharded packed island where they do.  A kv_replication plan's
    weights put original head perm[s] in q slot s; the port meets each q
    head with its own kv head, which the reference's step does over
    unpermuted weights (``decode_unpermuted``; with one kv head, as
    Gemma3-1B and Yi-6B have, over the permuted ones too)."""
    ref, inputs = reference
    ranks = mesh_runs[(arch, D)]
    name = _case_name(arch, D)
    branch = ranks[0]["runs"][1]["branch"]
    cfg = inputs[(arch, D)]["spec"].full
    assert branch == ("heads" if cfg.num_kv_heads % D == 0 else "seq")
    assert bool(ref[f"{name}/branch"]) == (branch == "seq")
    got = _rank_logits(ranks, 1, 0)
    want = ref.get(f"{name}/decode_unpermuted", ref[f"{name}/decode"])
    np.testing.assert_allclose(got, want, atol=LOGIT_ATOL, rtol=0)
    if cfg.num_kv_heads == 1 or MODES[(arch, D)] != "kv_replication":
        np.testing.assert_allclose(got, ref[f"{name}/decode"],
                                   atol=LOGIT_ATOL, rtol=0)


def test_reference_kv_replication_decode_pairs_slots_with_groups(reference):
    """Recorded fault of the reference (ROADMAP.md §3): its seq-sharded
    decode island groups q slot s with kv head s // G, but a
    kv_replication plan's permuted weights (the layout its prefill lists
    address, kv ids ``perm // G``) put original head perm[s] in slot s.
    Minitron-8B's 8 heads over 2 kv heads at 4 ranks move heads across
    groups, so the step over permuted weights is another model."""
    ref, inputs = reference
    name = _case_name("minitron-8b", 4)
    assert any(not np.array_equal(lp.perm // 4, np.arange(8) // 4)
               for lp in inputs[("minitron-8b", 4)]["plan"].layers)
    diff = np.abs(ref[f"{name}/decode"]
                  - ref[f"{name}/decode_unpermuted"]).max()
    assert diff > 0.05, diff


def _unwindowed(cfg):
    """``cfg`` with every layer global: the prefill and seq-sharded decode
    islands, like the reference's, take no sliding window, so Gemma3-1B's
    'L' layers attend unwindowed there (the sparse prefill does on one
    device too)."""
    return dataclasses.replace(cfg, attn_pattern="G")


def _global_lists(items, mode, cfg, D):
    """The ranks' prefill lists of each layer as one list over global
    head and kv ids (a one-process sparse prefill runs it)."""
    hq, hk = cfg.num_heads // D, cfg.num_kv_heads // D
    out = []
    for l in range(items.shape[1]):
        parts = []
        for d in range(D):
            it = items[d, l].copy()
            if mode != "rows":
                it[:, 0] += d * hq
            if mode == "kv_group":
                it[:, 6] += d * hk
            parts.append(it)
        out.append(torch.from_numpy(np.concatenate(parts)))
    return out


@pytest.mark.parametrize("arch,D", CASES)
def test_mesh_prefill_equals_one_process_lists(reference, mesh_runs, arch,
                                               D):
    """The D-rank prefill equals one process running the same lists (global
    ids) over the whole, equally permuted weights."""
    _, inputs = reference
    x = inputs[(arch, D)]
    cfg = x["spec"].full
    lists = _global_lists(x["items"], x["mode"], cfg, D)
    want, _ = tfm.prefill(x["params"], torch.from_numpy(x["tokens"]), cfg,
                          sparse_items=lists)
    np.testing.assert_allclose(_rank_logits(mesh_runs[(arch, D)], 0, 0),
                               want.numpy(), atol=LOGIT_ATOL, rtol=0)


@pytest.mark.parametrize("arch,D", CASES)
def test_mesh_decode_equals_one_process_selection(reference, mesh_runs,
                                                  arch, D):
    """The D-rank decode step equals one process attending the same block
    selection over the whole cache (the seq-sharded branch: the plan's
    ``_decode_block_ids_sharded`` at one shard; the head-sharded one:
    every block): in kv_replication over unpermuted weights, so every q
    head meets its own kv head."""
    _, inputs = reference
    x = inputs[(arch, D)]
    cfg, plan, mode = x["spec"].full, x["plan"], x["mode"]
    ids = (steps._dense_block_ids(cfg.num_layers, cfg.num_kv_heads, S)
           if cfg.num_kv_heads % D == 0
           else steps._decode_block_ids_sharded(plan, cfg, S, 1)[:, 0])
    params, cache = x["params"], x["cache"].clone()
    if mode == "kv_replication":
        params = steps.plan_params(cfg, SEED, torch.device("cpu"), plan,
                                   "rows")
    block_ids = torch.from_numpy(np.broadcast_to(
        ids[:, None], (cfg.num_layers, B) + ids.shape[1:]).copy())
    heads = cfg.num_kv_heads % D == 0          # the head-sharded cell
    want = tfm.decode_step(params, cache, torch.from_numpy(x["token"]),
                           torch.full((B,), S - 1, dtype=torch.int32),
                           cfg if heads else _unwindowed(cfg),
                           block_ids=block_ids)
    np.testing.assert_allclose(_rank_logits(mesh_runs[(arch, D)], 1, 0),
                               want.numpy(), atol=LOGIT_ATOL, rtol=0)


@pytest.mark.parametrize("arch,D", CASES)
def test_full_budget_mesh_prefill_equals_dense(mesh_runs, arch, D):
    """Where the budget covers the sequence every list is the full causal
    one, and the sparse mesh prefill is dense attention."""
    spec = _spec(arch)
    cfg = spec.full
    params = tfm.init_params(cfg, seed=SEED, device="cpu")
    tokens = steps.seeded_tokens(cfg.vocab_size, (B, S_FULL), SEED + 1)
    want, _ = tfm.prefill(params, torch.from_numpy(tokens), _unwindowed(cfg))
    np.testing.assert_allclose(_rank_logits(mesh_runs[(arch, D)], 2, 0),
                               want.numpy(), atol=LOGIT_ATOL, rtol=0)


@pytest.mark.parametrize("arch,D", CASES)
def test_greedy_tokens_independent_of_degree(mesh_runs, arch, D):
    """Every rank holds the same greedy tokens, and the degree-2 and
    degree-4 runs of an arch give the same first token at full budget (the
    weights do not depend on the mesh; the decode after it may attend
    other blocks, as the plans differ)."""
    ranks = mesh_runs[(arch, D)]
    for r in ranks[1:]:
        assert [x["tokens"] for x in r["runs"]] == [
            x["tokens"] for x in ranks[0]["runs"]]
    twin = mesh_runs.get((arch, 6 - D))
    if twin is not None:
        assert (ranks[0]["runs"][2]["tokens"][0]
                == twin[0]["runs"][2]["tokens"][0])
    assert ranks[0]["runs"][0]["launches"] == {
        "sparse_prefill_contig": 0, "flash_decode_contig": 0,
        "flash_decode_paged": 0}   # the CPU runs the plain versions
