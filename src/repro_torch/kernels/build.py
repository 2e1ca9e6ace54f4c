"""Build the port's CUDA kernels with ``nvcc`` at first use, load them with
``ctypes``.

Each ``csrc/<name>.cu`` has a plain C entry point ``<name>`` and compiles on
its own into ``build/repro_torch/lib<name>-<hash>.so`` under the checkout
(the hash covers the source, the shared ``csrc/*.cuh`` headers and the
flags, so an edited source or header rebuilds).
Nothing here runs at import: the CPU tests import every module on a machine
without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
KERNEL_SOURCES = ("flash_decode_paged", "flash_decode_contig",
                  "sparse_prefill_paged", "sparse_prefill_contig",
                  "flash_attention", "sparse_decode")

_loaded: dict[str, ctypes._CFuncPtr] = {}


def nvcc() -> str:
    """Path of ``nvcc``: on ``PATH``, else under ``CUDA_HOME`` (default
    ``/usr/local/cuda``)."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    cand = home / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found on PATH or under CUDA_HOME: the CUDA kernels build "
        "only where the CUDA toolkit is installed")


def library_path(name: str) -> Path:
    src = b"".join(p.read_bytes() for p in [
        CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))])
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names=KERNEL_SOURCES) -> dict[str, str]:
    """Compile every library of ``names`` that is not built yet, one
    ``nvcc`` per source, all started together.  Returns each compiled
    source's compiler output (``ptxas`` register and spill lines); raises
    ``RuntimeError`` with the compiler's message if any build fails."""
    procs = {}
    for name in names:
        lib = library_path(name)
        if lib.exists():
            continue
        lib.parent.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, lib)
    logs, errors = {}, []
    for name, (proc, tmp, lib) in procs.items():
        logs[name], _ = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            errors.append(f"{name}: nvcc exited {proc.returncode}\n"
                          f"{logs[name]}")
        else:
            os.replace(tmp, lib)
    if errors:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(errors))
    return logs


def kernel_function(name: str, argtypes) -> ctypes._CFuncPtr:
    """The C entry point ``name`` of ``lib<name>``, built on first use, with
    its ``argtypes`` declared and an ``int`` (cudaError_t) result."""
    fn = _loaded.get(name)
    if fn is None:
        build([name])
        fn = getattr(ctypes.CDLL(str(library_path(name))), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _loaded[name] = fn
    return fn


def check_launch(name: str, err: int) -> None:
    """Raise if a kernel's C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")
