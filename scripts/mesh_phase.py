#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s phase 15 alone: the multi-GPU islands, every
rank a process on the one card over gloo, with all its checks and prints
(``chip_smoke.mesh_phases``), after the card's name and power limit and
the kernels' build.

    python3 scripts/mesh_phase.py

Needs one NVIDIA GPU; exits non-zero where a check fails.
"""
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("FAIL: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import chip_smoke
    from repro_torch.kernels import build
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), torch.__version__, torch.version.cuda)
    t0 = time.time()
    build.build()
    print(f"build {time.time() - t0:.1f} s")
    t0 = time.time()
    chip_smoke.mesh_phases(torch.device("cuda:0"))
    print(f"phase 15: {time.time() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
