#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s decode kernel checks alone: #1 paged and #3
contiguous (bf16; f32 at Yi-6B's and Gemma3-1B's shapes; int8 and fp8) and
#5 at each model's shapes, then #1 / #3 at Llama4-Scout's and Minitron-8B's,
with all their checks and timing prints, after the card's name and power
limit and the decode kernels' build (and, where the tree's ``chip_smoke``
has it, each decode function's registers and spills).

    python3 scripts/decode_phase.py [ROOT]

ROOT (default: this checkout) is the tree whose ``chip_smoke.py`` and
kernels run, e.g. a parent commit unpacked with ``git archive``, so that
two trees are timed in one call on one card (parent, change, change,
parent).  Each model's engine plans layer 0's decode work as
``chip_smoke.py`` does (SmolLM-135M at full width, Yi-6B and Gemma3-1B at
their float32 parity depth, Scout and Minitron-8B at one layer).  Needs one
NVIDIA GPU; exits non-zero where a check fails.
"""
import dataclasses
import subprocess
import sys
import time
from pathlib import Path

DECODE_LIBS = ("flash_decode_paged", "flash_decode_contig", "sparse_decode")


def main(argv) -> int:
    root = Path(argv[0] if argv else Path(__file__).parents[1]).resolve()
    sys.path[:0] = [str(root / "src"), str(root)]
    import torch
    if not torch.cuda.is_available():
        print("FAIL: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.models.transformer import init_params
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(f"tree {root}: {smi.stdout.strip()}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    t0 = time.time()
    logs = build.build(DECODE_LIBS)
    print(f"build {time.time() - t0:.1f} s")
    if hasattr(cs, "decode_registers"):
        cs.decode_registers(build, logs)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    gen = torch.Generator().manual_seed(0)
    t_all = time.time()
    for sh in (cs.SMOL, cs.YI, cs.GEMMA, cs.SCOUT, cs.MINITRON):
        t0 = time.time()
        if sh is cs.SMOL:
            cfg = get_config(sh.arch)
        elif sh in (cs.YI, cs.GEMMA):
            cfg = cs.parity_config(sh)
        else:
            cfg = dataclasses.replace(get_config(sh.arch), num_layers=1)
        params = init_params(cfg, seed=0, device=dev, host_rng=False)
        eng = cs.build_engine(cfg, params, dev)  # layer 0's plan: any depth
        dtypes = ((torch.bfloat16, torch.float32) if sh in (cs.YI, cs.GEMMA)
                  else (torch.bfloat16,))
        cs.check_decode(eng, gen, dev, {}, sh, dtypes)
        if sh in (cs.SMOL, cs.YI, cs.GEMMA):
            cs.check_quant_decode(eng, gen, dev, {}, sh)
            cs.check_sparse_decode(eng, gen, dev, {}, sh)
        del eng, params
        torch.cuda.empty_cache()
        print(f"decode phase ({sh.arch}): {time.time() - t0:.1f} s")
    print(f"decode phases: {time.time() - t_all:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
