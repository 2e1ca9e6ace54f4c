"""Serve synthetic requests through the port's engine.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \
        [--smoke] [--device cuda|cpu] [--budget 512] [--requests 8] \
        [--prompt-lens 300,1010,3500] [--cache-layout paged|contiguous] \
        [--decode-worklist packed|padded] [--profile]

Weights are random, drawn from ``--seed``; the sparsity profile is the
synthetic one.  Prompts have the lengths ``--prompt-lens`` gives, else
``--requests`` lengths drawn from [32, 128).  Budget, sequence length and
slots, the cache layout and the decode work list default to
``EngineConfig()``'s.  The default device is CUDA; ``--device cpu`` runs every
kernel's plain PyTorch version.  ``--profile`` runs the serve under
``torch.profiler`` and prints the device busy share of the wall time and
the device time by kernel.
"""
from __future__ import annotations

import argparse
import contextlib
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.planner import plan_summary
from repro_torch.core.sparsity import synthetic_head_curves
from repro_torch.models.transformer import init_params
from repro_torch.serving import Engine, EngineConfig, SamplingParams


def main(argv=None) -> list:
    defaults = EngineConfig()
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="the CPU test size of the arch, not its full width")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--budget", type=int, default=defaults.budget_per_head)
    ap.add_argument("--max-seq", type=int, default=defaults.max_seq_len)
    ap.add_argument("--slots", type=int, default=defaults.num_slots)
    ap.add_argument("--cache-layout", default=defaults.cache_layout,
                    choices=("paged", "contiguous"))
    ap.add_argument("--decode-worklist", default=defaults.decode_worklist,
                    choices=("packed", "padded"))
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-lens", default=None,
                    help="comma-separated prompt lengths (overrides "
                         "--requests)")
    ap.add_argument("--max-tokens", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="print device busy share and time by kernel")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        ap.error("no CUDA device is available; pass --device cpu to run the "
                 "plain PyTorch kernels")
    cfg = get_config(args.arch, smoke=args.smoke)
    eng = Engine(cfg, init_params(cfg, seed=args.seed, device=device),
                 EngineConfig(budget_per_head=args.budget,
                              max_seq_len=args.max_seq,
                              num_slots=args.slots,
                              cache_layout=args.cache_layout,
                              decode_worklist=args.decode_worklist),
                 synthetic_head_curves(cfg.num_layers, cfg.num_heads),
                 device=device)
    rng = np.random.default_rng(args.seed)
    lens = ([int(n) for n in args.prompt_lens.split(",")]
            if args.prompt_lens else
            [int(n) for n in rng.integers(32, 128, size=args.requests)])
    prompts = [rng.integers(0, cfg.vocab_size, size=(n,)) for n in lens]
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = (torch.profiler.profile(activities=acts) if args.profile
            else contextlib.nullcontext())
    with prof:
        t0 = time.perf_counter()
        done = eng.serve(prompts, SamplingParams(max_tokens=args.max_tokens))
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0
    n_tok = sum(len(r.generated) for r in done)
    ps = plan_summary(eng.plan)
    print(f"served {len(done)} requests, {n_tok} tokens in {dt:.2f}s "
          f"({n_tok / dt:.1f} tok/s) on {device}; plan imbalance "
          f"{ps['mean_imbalance_plan']:.3f} (naive "
          f"{ps['mean_imbalance_naive']:.3f}); decode grid "
          f"{eng.decode_stats['real_items']}/{eng.decode_stats['grid_items']}"
          f" real/padded items")
    if args.profile:
        _print_profile(prof, dt)
    return done


def _print_profile(prof, wall: float, top: int = 10) -> None:
    """Device busy share of ``wall`` and the ``top`` kernels by device time
    (CUDA kernel events only; none are recorded on the CPU)."""
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.device_time_total > 0]
    if not kernels:
        print("profile: no device kernel recorded (device time not "
              "measured)")
        return
    busy = sum(e.device_time_total for e in kernels) / 1e6
    print(f"profile: device busy {busy:.3f} s of {wall:.3f} s wall "
          f"({100 * busy / wall:.1f}%), profiler on")
    for e in sorted(kernels, key=lambda e: -e.device_time_total)[:top]:
        print(f"  {e.device_time_total / 1e3:10.2f} ms {e.count:8d}x  "
              f"{e.key[:100]}")


if __name__ == "__main__":
    main()
