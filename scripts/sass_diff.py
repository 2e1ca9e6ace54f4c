#!/usr/bin/env python3
"""Compare the compiled SASS of the port's CUDA kernels between two trees.

    python3 scripts/sass_diff.py OTHER_ROOT [library ...]

Builds the kernel libraries of this checkout and of ``OTHER_ROOT`` (another
checkout of the repository, e.g. the parent commit unpacked with
``git archive``) with each tree's own ``repro_torch.kernels.build``, dumps
both with ``cuobjdump -sass`` and, for every kernel function of OTHER_ROOT,
reports whether this tree has a function with the same instructions
(addresses and encodings dropped; template arguments may differ, so
functions are matched by their code, not by name).  Where none matches, it
prints the diff against this tree's closest function.  Needs the CUDA
toolkit (``nvcc``, ``cuobjdump``, ``cu++filt``); prints ``SASS: N of M
functions identical`` per library and exits 0 either way.
"""
import difflib
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
ADDR = re.compile(r"/\*[0-9a-f]{4,}\*/|/\* 0x[0-9a-f]+ \*/")


def build(root: Path, names) -> dict:
    """Build ``names`` in the tree at ``root``; return their library
    paths."""
    code = ("import json, sys; from repro_torch.kernels import build; "
            "build.build(sys.argv[1:]); print(json.dumps({n: "
            "str(build.library_path(n)) for n in sys.argv[1:]}))")
    out = subprocess.run([sys.executable, "-c", code, *names], cwd=root,
                         env=dict(os.environ, PYTHONPATH=str(root / "src")),
                         capture_output=True, text=True, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def functions(lib: str) -> dict:
    """Demangled function name -> normalized SASS lines."""
    cuda = Path(shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc").parent
    sass = subprocess.run([str(cuda / "cuobjdump"), "-sass", lib],
                          capture_output=True, text=True, check=True).stdout
    funcs, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            mangled = line.split("Function :", 1)[1].strip()
            name = subprocess.run([str(cuda / "cu++filt"), mangled],
                                  capture_output=True,
                                  text=True).stdout.strip() or mangled
            funcs[name] = []
        elif name is not None:
            text = ADDR.sub("", line).strip()
            if text and not text.startswith(("..", "/*")):
                funcs[name].append(text)
    return funcs


def main(argv) -> int:
    other = Path(argv[0]).resolve()
    names = argv[1:] or ["flash_decode_paged", "flash_decode_contig",
                         "sparse_decode", "sparse_prefill_paged",
                         "sparse_prefill_contig", "flash_attention"]
    mine, theirs = build(HERE, names), build(other, names)
    for name in names:
        a, b = functions(theirs[name]), functions(mine[name])
        same = 0
        for fa, code in a.items():
            match = [fb for fb, cb in b.items() if cb == code]
            if match:
                same += 1
                print(f"{name}: {fa}\n    == {match[0]} "
                      f"({len(code)} instructions)")
                continue
            near = max(b, key=lambda fb: difflib.SequenceMatcher(
                None, code, b[fb], autojunk=False).ratio())
            diff = list(difflib.unified_diff(code, b[near], lineterm="",
                                             n=1))
            print(f"{name}: {fa}\n    != closest {near} ({len(code)} vs "
                  f"{len(b[near])} instructions, {len(diff)} diff lines)")
            for line in diff[:80]:
                print(f"      {line}")
        print(f"SASS {name}: {same} of {len(a)} functions of {other.name} "
              f"identical here ({len(b)} functions here)")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
