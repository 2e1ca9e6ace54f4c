"""Serve synthetic requests through the port's engine.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \
        [--smoke] [--device cuda|cpu] [--budget 512] [--requests 8] \
        [--prompt-lens 300,1010,3500] [--cache-layout paged|contiguous] \
        [--decode-worklist packed|padded] [--kv-dtype bf16|int8|fp8] \
        [--attention sparse|dense] [--prefill-mode chunked|monolithic] \
        [--prefill-buckets pow2|exact] [--temperature 0.8 --top-k 50 \
        --top-p 0.95 --sample-seed 0] [--telemetry-every 4 \
        --replan-every 16 --drift-threshold 0.5] [--admission fifo|slo \
        --preemption --host-blocks N --kv-blocks N] [--seq-shards S] \
        [--prefix-cache] [--fault-plan PLAN --audit-every N \
        --swap-retries N --checkpoint-dir DIR --checkpoint-every N] \
        [--profile]

Weights and prompts are random, drawn from ``--seed``; the sparsity profile
is the synthetic one.  Prompts have the lengths ``--prompt-lens`` gives,
else ``--requests`` lengths drawn from [32, 128).  Budget, sequence length
and slots, the attention (S-HPLB sparse or the dense baseline), the
prefill mode and buckets, the cache layout, the decode work list and the
KV storage dtype (``--kv-dtype``: int8 / fp8 codes with per-block scales,
or bf16) default to ``EngineConfig()``'s.  Sampling is greedy unless
``--temperature`` > 0 (then ``--top-k`` / ``--top-p`` cut, and the draws
come from the engine's generator, seeded by ``--sample-seed``).  Plan epochs:
``--telemetry-every N`` probes the realized recovery every N decode ticks,
``--replan-every N`` replans every N decode ticks and ``--drift-threshold``
when the online profile drifts that far (it needs telemetry).  Overload:
prompts take the priority classes interactive, standard, batch in turn;
``--admission slo`` admits by class with cost-model deferral and deadline
shedding, ``--preemption`` lets a higher class preempt lower-class work
(decodes swap their KV to a pinned host tier of ``--host-blocks`` blocks,
unbounded by default), and ``--kv-blocks`` sizes the paged pool.
``--seq-shards S`` stripes the paged pool over S seq stripes (one decode
pass a stripe, partials merged).  ``--prefix-cache`` shares the KV blocks of
cached prompt prefixes by refcount, and the traffic becomes the
reference's agent pattern: four requests in five continue one shared
256-token prompt with a tail of 16-47 tokens, the fifth is a unique prompt
of 32-127 tokens (``--requests`` of them; not with ``--prompt-lens``).
Faults (§2.13): ``--fault-plan`` arms a fault injector from a JSON file, an
inline JSON string or ``random:SEED:RATE`` (a seeded schedule over all six
seams); ``--audit-every N`` audits the engine every N decode ticks and at
swap and replan boundaries; ``--swap-retries`` bounds a swap transfer's
retries; ``--checkpoint-dir`` / ``--checkpoint-every N`` write a snapshot
every N decode ticks.  Then a ``faults:`` line gives the injected events,
the failed requests and the fault counters, and each failed request its
reason.  The
default device is CUDA; ``--device cpu`` runs every kernel's plain PyTorch version.
After the serve it prints the plan's imbalance (sparse) and the decode
grid's bubble stats (``Engine.decode_bubble_stats``: with the plan's epoch,
its replans and the realized recovery), and with preemption the swaps;
with stripes the per-axis imbalance and the merges, with the prefix cache
its hits.
``--profile`` runs the serve under
``torch.profiler`` and prints the device busy share of the wall time and
the device time by kernel.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.planner import plan_summary
from repro_torch.core.sparsity import synthetic_head_curves
from repro_torch.models.transformer import init_params
from repro_torch.serving import Engine, EngineConfig, SamplingParams
from repro_torch.serving.faults import FaultInjector, FaultPlan


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
    ap.add_argument("--kv-dtype", default=defaults.kv_dtype,
                    choices=("bf16", "int8", "fp8"))
    ap.add_argument("--attention", default=defaults.attention,
                    choices=("sparse", "dense"))
    ap.add_argument("--prefill-mode", default=defaults.prefill_mode,
                    choices=("chunked", "monolithic"))
    ap.add_argument("--prefill-buckets", default=defaults.prefill_buckets,
                    choices=("pow2", "exact"))
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="0 samples greedily")
    ap.add_argument("--top-k", type=int, default=0, help="0: no cut")
    ap.add_argument("--top-p", type=float, default=1.0, help="1: no cut")
    ap.add_argument("--sample-seed", type=int, default=defaults.seed,
                    help="seed of the engine's sampling generator")
    ap.add_argument("--telemetry-every", type=int,
                    default=defaults.telemetry_every,
                    help="probe realized recovery every N decode ticks "
                         "(0 = telemetry off)")
    ap.add_argument("--replan-every", type=int, default=None,
                    help="force an in-flight replan every N decode ticks")
    ap.add_argument("--drift-threshold", type=float, default=None,
                    help="replan when the online-vs-offline profile drift "
                         "reaches this value (needs --telemetry-every)")
    ap.add_argument("--admission", default=defaults.admission,
                    choices=("fifo", "slo"),
                    help="class-blind arrival order (fifo) or SLO-aware "
                         "class scheduling with cost-model deferral and "
                         "deadline shedding (slo)")
    ap.add_argument("--preemption", action="store_true",
                    help="allow preempting strictly-lower-priority work "
                         "(decodes swap their KV blocks to a pinned host "
                         "tier and resume with the same tokens)")
    ap.add_argument("--host-blocks", type=int, default=None,
                    help="host swap-tier capacity in KV blocks (default: "
                         "unbounded)")
    ap.add_argument("--kv-blocks", type=int, default=None,
                    help="paged KV pool size in blocks (default: slots * "
                         "max_seq / block)")
    ap.add_argument("--seq-shards", type=int, default=defaults.seq_shards,
                    help="stripe the paged KV pool over N seq stripes (1 = "
                         "unstriped); greedy tokens are the same at any N")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="share cached prompt-prefix KV blocks by refcount "
                         "(paged); the traffic continues one shared prompt "
                         "in 80%% of requests")
    ap.add_argument("--fault-plan", default=None,
                    help="fault-injection plan: a JSON file, an inline "
                         "JSON string, or 'random:SEED:RATE' for a seeded "
                         "schedule over all seams")
    ap.add_argument("--audit-every", type=int, default=defaults.audit_every,
                    help="audit the engine's invariants every N decode "
                         "ticks and at swap / replan boundaries (0 = off)")
    ap.add_argument("--swap-retries", type=int,
                    default=defaults.swap_retries,
                    help="retries of a host swap transfer before the "
                         "victim is discarded and requeued")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="directory of crash-consistent serving snapshots")
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help="snapshot every N decode ticks into "
                         "--checkpoint-dir (0 = off)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-lens", default=None,
                    help="comma-separated prompt lengths (overrides "
                         "--requests)")
    ap.add_argument("--max-tokens", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the weights and the prompts")
    ap.add_argument("--profile", action="store_true",
                    help="print device busy share and time by kernel")
    args = ap.parse_args(argv)
    if args.drift_threshold is not None and args.telemetry_every <= 0:
        ap.error("--drift-threshold needs --telemetry-every > 0")
    if args.seq_shards < 1:
        ap.error("--seq-shards must be >= 1")
    if args.prefix_cache and args.prompt_lens:
        ap.error("--prefix-cache draws its own traffic; drop --prompt-lens")
    if args.checkpoint_every > 0 and not args.checkpoint_dir:
        ap.error("--checkpoint-every needs --checkpoint-dir")
    injector = None
    if args.fault_plan:
        injector = FaultInjector(fault_plan(args.fault_plan))
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
                              decode_worklist=args.decode_worklist,
                              kv_dtype=args.kv_dtype,
                              attention=args.attention,
                              prefill_mode=args.prefill_mode,
                              prefill_buckets=args.prefill_buckets,
                              seed=args.sample_seed,
                              telemetry_every=args.telemetry_every,
                              replan_every=args.replan_every,
                              drift_threshold=args.drift_threshold,
                              admission=args.admission,
                              preemption=args.preemption,
                              host_swap_blocks=args.host_blocks,
                              num_kv_blocks=args.kv_blocks,
                              seq_shards=args.seq_shards,
                              prefix_cache=args.prefix_cache,
                              audit_every=args.audit_every,
                              swap_retries=args.swap_retries,
                              checkpoint_dir=args.checkpoint_dir,
                              checkpoint_every=args.checkpoint_every),
                 synthetic_head_curves(cfg.num_layers, cfg.num_heads),
                 device=device, injector=injector)
    rng = np.random.default_rng(args.seed)
    lens = ([int(n) for n in args.prompt_lens.split(",")]
            if args.prompt_lens else
            [int(n) for n in rng.integers(32, 128, size=args.requests)])
    prompts = [rng.integers(0, cfg.vocab_size, size=(n,)) for n in lens]
    if args.prefix_cache:
        prompts = agent_prompts(rng, cfg.vocab_size, args.requests)
    classes = ("interactive", "standard", "batch")
    priorities = [classes[i % len(classes)] for i in range(len(prompts))]
    # on the card only the CUDA activity: the report reads kernel events
    # alone, and host-side op events of a full serve take the profiler
    # minutes to post-process
    act = torch.profiler.ProfilerActivity
    acts = [act.CUDA if device.type == "cuda" else act.CPU]
    prof = (torch.profiler.profile(activities=acts) if args.profile
            else contextlib.nullcontext())
    with prof:
        t0 = time.perf_counter()
        done = eng.serve(prompts, SamplingParams(
            max_tokens=args.max_tokens, temperature=args.temperature,
            top_k=args.top_k, top_p=args.top_p), priorities=priorities)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0
    n_tok = sum(len(r.generated) for r in done)
    if eng.plan is None:
        plan = "dense attention, no plan"
    else:
        ps = plan_summary(eng.plan)
        plan = (f"plan imbalance {ps['mean_imbalance_plan']:.3f} (naive "
                f"{ps['mean_imbalance_naive']:.3f})")
    print(f"served {len(done)} requests, {n_tok} tokens in {dt:.2f}s "
          f"({n_tok / dt:.1f} tok/s) on {device}; {plan}; decode grid "
          f"{eng.decode_stats['real_items']}/{eng.decode_stats['grid_items']}"
          f" real/padded items; KV cache {args.kv_dtype}, "
          f"{eng.kv_bytes() / 2**20:.1f} MiB resident")
    bs = eng.decode_bubble_stats
    print(bubble_line(bs))
    if bs["swap"]["swapped_out"] or args.preemption:
        sw = bs["swap"]
        print(f"preemption: {sw['swapped_out']} swapped out / "
              f"{sw['swapped_in']} back in ({sw['blocks_out']} blocks, "
              f"{sw['bytes_out'] / 1024:.1f} KiB to host)")
    if args.seq_shards > 1:
        print(f"2D decode: head imbalance {bs['mean_head_imbalance']:.4f}, "
              f"stripe imbalance {bs['mean_stripe_imbalance']:.4f}, "
              f"{bs['merge_collectives']} seq merges")
    if bs["prefix"] is not None:
        ps = bs["prefix"]
        print(f"prefix cache: {ps['hits']}/{ps['lookups']} lookups hit "
              f"({ps['hit_tokens']} tokens mapped for free), {ps['nodes']} "
              f"blocks in tree, {ps['evicted_blocks']} evicted")
    n_failed = sum(1 for r in done if r.failed)
    if injector is not None or args.audit_every or n_failed:
        print(faults_line(bs, n_failed))
        for r in done:
            if r.failed:
                print(f"  rid {r.rid} failed: {r.fail_reason}")
    if args.profile:
        _print_profile(prof, dt)
    return done


def fault_plan(spec: str) -> FaultPlan:
    """``--fault-plan``: ``random:SEED:RATE``, a JSON file, or inline
    JSON."""
    if spec.startswith("random:"):
        _, seed, rate = spec.split(":")
        return FaultPlan.random(int(seed), float(rate))
    if os.path.exists(spec):
        return FaultPlan.load(spec)
    return FaultPlan.from_json(spec)


def faults_line(bs: dict, n_failed: int) -> str:
    """One line of ``decode_bubble_stats``' fault counters."""
    fs = bs["faults"]
    return (f"faults: {bs['injected_events']} injected events, {n_failed} "
            f"failed requests, {fs['sentinel_trips']} sentinel trips, "
            f"{fs['corruptions_injected']} corruptions, "
            f"{fs['swap_retries']} swap retries ({fs['swap_recoveries']} "
            f"recovered / {fs['swap_giveups']} gave up), {fs['audits']} "
            f"clean audits, {fs['replan_rollbacks']} replan rollbacks, "
            f"{fs['checkpoints']} checkpoints")


def agent_prompts(rng, vocab: int, n: int, shared_tokens: int = 256):
    """The reference launcher's prefix-cache traffic: request i continues
    one shared ``shared_tokens``-token prompt with a tail of 16-47 tokens,
    except every fifth (i % 5 == 0), a unique prompt of 32-127 tokens."""
    shared = rng.integers(0, vocab, size=(shared_tokens,))
    out = []
    for i in range(n):
        if i % 5:
            tail = rng.integers(0, vocab, size=(int(rng.integers(16, 48)),))
            out.append(np.concatenate([shared, tail]))
        else:
            out.append(rng.integers(0, vocab,
                                    size=(int(rng.integers(32, 128)),)))
    return out


def bubble_line(bs: dict) -> str:
    """One line of ``Engine.decode_bubble_stats``: the decode grid's
    bubbles and the plan's epoch, replans and realized recovery (and the
    latest drift reading, where one was taken)."""
    rec = bs["realized_recovery"]
    rec = "not probed" if rec is None else f"{rec:.4f}"
    drift = ("" if bs["drift"] is None
             else f", drift {bs['drift']['drift']:.4f}")
    return (f"decode bubbles: padding waste {bs['padding_waste']:.4f} "
            f"(padded path {bs['padded_path_waste']:.4f}), grid vs padded "
            f"{bs['grid_vs_padded']:.4f}, mean shard imbalance "
            f"{bs['mean_imbalance']:.4f} over {bs['ticks']} ticks; plan hits "
            f"{bs['plan_hits']}, misses {bs['plan_misses']}, prefetches "
            f"{bs['plan_prefetches']}; epoch {bs['epoch']} after "
            f"{bs['replans']} replan(s), realized recovery {rec}{drift}")


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
