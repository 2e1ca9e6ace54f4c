"""The port stands alone: ``repro_torch``, its launcher and ``chip_smoke``
import with ``jax`` and ``repro`` blocked, no source under
``src/repro_torch/`` (or ``chip_smoke.py``) imports either, and importing
the package changes no global torch state."""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _modules():
    for p in sorted(PORT.rglob("*.py")):
        rel = p.relative_to(ROOT / "src").with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def _run(code: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)


@pytest.fixture(scope="module")
def blocked_import():
    """One interpreter with ``jax`` and ``repro`` blocked imports every
    module of the port and ``chip_smoke``, and reports whether the global
    torch state moved."""
    mods = list(_modules())
    code = "\n".join([
        "import importlib, json, sys, torch",
        "sys.modules['jax'] = None",
        "sys.modules['repro'] = None",
        "state = lambda: [str(torch.get_default_dtype()),"
        " torch.get_num_threads(), torch.get_float32_matmul_precision(),"
        " str(torch.get_default_device())]",
        "before = state()",
        f"for m in {mods!r}: importlib.import_module(m)",
        "import chip_smoke",
        "jax = [k for k, v in sys.modules.items() if v is not None"
        " and (k == 'jax' or k.startswith('jax.'))]",
        "print(json.dumps({'n': len(" + repr(mods) + "), 'jax': jax,"
        " 'before': before, 'after': state()}))",
    ])
    return _run(code)


def test_port_imports_with_jax_and_reference_blocked(blocked_import):
    assert blocked_import.returncode == 0, blocked_import.stderr
    got = json.loads(blocked_import.stdout)
    assert got["n"] >= 20 and got["jax"] == []


def test_blocked_import_covers_every_kernel_module():
    """Each kernel wrapper module, and each CUDA source `build` compiles,
    is part of the port that imports without JAX."""
    from repro_torch.kernels import build
    mods = set(_modules())
    for name in ("flash_decode", "sparse_prefill", "flash_attn",
                 "sparse_decode", "ops", "build"):
        assert f"repro_torch.kernels.{name}" in mods
    assert sorted(p.stem for p in build.CSRC.glob("*.cu")) == sorted(
        build.KERNEL_SOURCES)


def test_blocked_import_covers_every_serving_module():
    """The serving modules, the radix prefix tree, the fault layer and the
    snapshots among them, are part of the port that imports without JAX;
    the engine builds its tree from the port's own copy, and the allocator
    raises the fault layer's one ``IntegrityError``."""
    from repro_torch.serving import engine, faults, kv_cache, prefix_tree
    mods = set(_modules())
    for name in ("engine", "faults", "kv_cache", "prefix_tree", "sampler",
                 "scheduler", "snapshot"):
        assert f"repro_torch.serving.{name}" in mods
    assert engine.RadixPrefixCache is prefix_tree.RadixPrefixCache
    assert kv_cache.IntegrityError is faults.IntegrityError


def test_blocked_import_covers_the_mesh_modules():
    """The multi-GPU islands' modules (the mesh, the sharding rules, the
    islands and the step builders) are part of the port that imports
    without JAX and the reference; the step builders run the port's own
    islands and mesh."""
    from repro_torch.launch import mesh, steps
    from repro_torch.serving import sharded_attention
    mods = set(_modules())
    for name in ("repro_torch.launch.mesh", "repro_torch.launch.steps",
                 "repro_torch.sharding.specs",
                 "repro_torch.serving.sharded_attention"):
        assert name in mods
    assert steps.isl is sharded_attention and steps.spawn is mesh.spawn


def test_no_source_imports_jax_or_the_reference():
    bad = []
    for path in SOURCES:
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for n in names:
                if n.split(".")[0] in ("jax", "jaxlib", "repro"):
                    bad.append(f"{path.relative_to(ROOT)}:{node.lineno} {n}")
    assert not bad, bad


def test_import_sets_no_global_torch_state(blocked_import):
    got = json.loads(blocked_import.stdout)
    assert got["before"] == got["after"]


def test_chip_smoke_refuses_to_run_without_a_gpu():
    """Without CUDA the proof script exits non-zero and prints no result."""
    if torch.cuda.is_available():
        return
    res = _run("import runpy; runpy.run_path('chip_smoke.py', "
               "run_name='__main__')")
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
