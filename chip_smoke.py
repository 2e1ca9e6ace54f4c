#!/usr/bin/env python3
"""Proof that the PyTorch/CUDA port (``src/repro_torch``) starts and is
right on an NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. device: require CUDA, print the card's ``name, power.limit``;
2. build: compile every CUDA kernel from ``src/repro_torch/kernels/csrc``
   (one ``nvcc`` per source, started together), print ``ptxas``'s register
   and spill lines under each kernel function's name, and count the tensor-core instructions (HMMA/HGMMA in
   ``cuobjdump -sass``) of the bf16 prefill and flash-attention kernels:
   none fails the run;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the shapes its path gives it (SmolLM-135M: 9 heads, 3 KV heads,
   head_dim 64, ``max_seq_len`` 4096, 8 rows, budget 512), with the stated
   tolerances; kernel, plain-version and library (SDPA) times, and each
   kernel's bound.  The paged and contiguous decode and prefill kernels
   must also agree bit for bit on equal cache contents; each decode form
   (#1, #3 and the legacy #5) prints its CTAs a launch (one per item;
   those that walk a split of the run) and its longest run in tiles, and
   two launches of the same inputs must give the same bits.  Then the
   codes-and-scales forms at int8 and fp8 (quantized KV pool): #1 and #3
   against their plain versions (tolerance 1e-4) and each other, #2 paged
   (bf16 q, tolerance 2^-6), each timed beside its bound (codes at one
   byte plus the scales) and SDPA on the dequantized bf16 K/V;
4. library path: ``ops.flash_attention`` and ``ops.sparse_decode``, the
   only entry points of the dense and legacy kernels, launch them;
5. serve: the full-width SmolLM-135M with seeded random bf16 weights
   serves 8 requests (300-3500 prompt tokens, 32 greedy tokens each)
   through ``Engine.serve`` four times: paged + packed decode (the
   default), contiguous + packed, paged + padded, contiguous + padded.
   Every request completes, each serve's kernels launched, the block
   accounting audits clean, and all four give the same greedy tokens; then
   the same traffic with a quantized KV cache: int8 and fp8, paged and
   contiguous (packed decode; the model's first ``CUT_LAYERS`` layers),
   each completing every request through the quantized kernels, with the
   cache's resident bytes; then SMOKE-size float32 serves on the card, paged and
   contiguous, in bf16 and int8, must give the same greedy tokens as the
   same serves on the CPU (plain versions); int8 / fp8 ones replay the
   CPU's tokens and hold the logit differences' median and max, which two
   planted controls must fail (q rounded to bf16: the median; one decode
   call's output shifted by 1.0: the max);
6. Yi-6B (32 heads over 4 KV heads: G = 8, head_dim 128) with random
   weights from a seeded torch generator on the card: phases 3 and 4 at
   its shapes,
   with the f32 forms of #1, #2 and #3 checked, timed and bounded too;
   Yi-6B's widths at 2 layers in float32, paged and contiguous, bf16 /
   int8 / fp8 caches: the card's greedy tokens (the head_dim-128 f32 and
   code kernels) must equal the plain versions' on the CPU; then three
   full-width serves of the same 8 prompts (paged bf16, the main path;
   contiguous bf16, whose tokens must equal the paged serve's; paged int8
   through the code forms, at ``CUT_LAYERS``), each completing every
   request;
7. Gemma3-1B (4 heads over 1 KV head: G = 4, head_dim 256; five
   sliding-window layers of 512 positions to one global) the same way:
   phases 3 and 4 at its shapes (the decodes also with its window), its
   widths at 6 layers (one ``LLLLLG`` period) in float32 with a prompt
   longer than the window (card tokens == CPU tokens, bf16 / int8 / fp8
   caches, both layouts; and dense attention, monolithic and chunked, both
   layouts, through the window forms of #4 and #2), and three full-width
   serves (26 layers; the int8 one 12);
8. the head-parallel degree (``num_model_shards`` = D: KV groups placed on
   D shards, emulated on the one card; the packed decode table holds the D
   shards' lists end to end, pads between them): #1 and #3 (bf16, f32) on
   the layer-0 table of a Yi-6B engine at D = 4 against their plain
   versions, paged == contiguous and launch == launch bit for bit, with
   the table's runs, pads between shards and CTAs printed; Yi-6B's widths
   at 2 layers in float32 at D = 4 (bf16 cache, both layouts: card tokens
   == CPU tokens); full-width serves at D > 1 at the model's first
   ``CUT_LAYERS`` layers (``SHARDED_SERVES``: Yi-6B
   at D = 4 paged packed, paged padded and contiguous packed, at D = 2
   paged packed; SmolLM-135M at D = 3 paged and contiguous packed), the
   serves of one D giving equal tokens.  Every serve prints its decode
   bubble stats (``Engine.decode_bubble_stats``: padding waste, the padded
   path's, grid vs padded, mean shard imbalance, plan hits / misses /
   prefetches), the D = 1 serves' included;
9. the paper's baselines and stochastic sampling (SmolLM-135M, and Yi-6B
   and Gemma3-1B after their own serves): #4 causal at the dense
   monolithic prefill's prompt buckets (exact 513 / 1010 / 3500, pow2 1024
   / 4096), #2 paged and contiguous over a dense chunk's causal list, #1
   and #3 over dense decode's table of every resident block (bf16 and int8
   codes), each against its plain version and the layouts bit for bit, #4
   timed at each bucket; at Gemma3-1B's shapes all of them in their window
   forms (window 512, its 'L' layers'; #2 paged's int8 / fp8 code forms
   too), #4 at 4096 and #2 on the dense chunk timed beside SDPA under the
   windowed boolean mask and a bound over the pairs inside the window;
   full-width serves (``BASELINE_SERVES``): dense attention with
   monolithic prefill (SmolLM-135M paged, contiguous, paged int8 and paged
   with exact buckets, the last two at ``CUT_LAYERS``; Yi-6B paged;
   Gemma3-1B paged, its baseline serves at ``CUT_LAYERS``), whose #4
   launches are counted, the paged and contiguous ones giving equal
   tokens, Gemma3-1B's dense chunked serves (paged and contiguous: equal
   tokens; against the monolithic serve's reported), each windowed serve
   launching its
   prefill kernel's window form, and sparse monolithic serves, whose tokens
   must equal the chunked serve's of their layout; SmolLM-135M's
   stochastic serve (temperature 0.8, top-k 50, top-p 0.95, the engine's
   generator seeded 0; the four prompts of at most 1010 tokens) twice,
   which must repeat itself; and SMOKE float32 dense serves (monolithic
   and chunked, both layouts) whose card tokens must equal the CPU's;
10. plan epochs: SmolLM-135M paged with ``REPLAN`` (a recovery probe
    every 4 decode ticks, a replan every 16) completes every request and
    reaches epoch 1 or later, every probe's estimator forward launching
    #1; it prints the bubble stats, realized recovery and epochs, and a
    probe tick's host time against a plain decode tick's; a SMOKE float32
    replanning serve gives the CPU's tokens and epochs on the card; and
    Yi-6B at D = 4 (``HEAD_MOVE``, ``CUT_LAYERS``) moves its KV groups one
    shard on mid-serve: replaying the frozen serve's tokens, its logits
    stay within ``HEAD_MOVE_ATOL`` of the frozen serve's (the median over
    the live requests' rows; the median over every row, finished slots'
    too, is printed beside it), which a planted control (the pool gathered
    by a wrong kv-head table) must fail, a free moved serve's tokens are
    reported, and the swap's parts (weights, the pool's kv-head gather) are
    timed;
11. the offline profiling stage and overload serving: SmolLM-135M's
    profiling forward (``tfm.prefill(..., maps_out=)``, #4 once a layer)
    over two seeded calibration prompts of 1024 tokens and
    ``profile_model`` on the card, every curve non-decreasing, within [0,
    1] and 1 at frac 1; each layer's heterogeneity and the plan's budget
    spread printed, and the 8 prompts served from that profile; a SMOKE
    float32 profile whose card curves lie within ``PROFILE_ATOL`` of the
    CPU's; preempted serves (``PREEMPT_SERVES``, at the model's first
    ``CUT_LAYERS`` layers: SmolLM-135M paged and contiguous bf16, after its
    plan epochs; Yi-6B paged int8, after its head move): two batch requests and
    a later interactive arrival that swaps one out to pinned host memory
    and back, whose greedy tokens must equal the uninterrupted serve's,
    with the swaps' card times, bytes and rates printed, both tiers
    audited clean, and a planted control (the host copy rolled by one
    block) that must change them; and Yi-6B at D = 4 (``STRADDLE``, the
    same depth) with phase 10's head move forced while the victim is on
    the host: one remap at swap-in, tokens equal to the serve whose
    victim's copy stays on the card and moves with the cache, and a
    control without the remap that must differ;
12. sequence stripes and the prefix cache (``STRIPE_SERVES``,
    ``PREFIX_SERVES``; at full depth but SmolLM-135M S = 4 padded, the
    int8, monolithic and S = 2 prefix serves and the preempted hit victim,
    Yi-6B D = 4 x S = 2 and its prefix serve, and Gemma3-1B dense S = 2, at
    ``CUT_LAYERS``): striped serves
    (SmolLM-135M S = 2 packed and S = 4 padded, Yi-6B D = 4 x S = 2,
    Gemma3-1B dense S = 2) replay their
    unstriped twin's greedy tokens and hold ``STRIPE_ATOL`` on each live
    row and model call's largest logit difference, which a planted control
    (one stripe's partial left out of the merge) must fail; each prints the
    greedy tokens that agree, the per-axis imbalances and merges, and #1's
    launches, which must be S a layer and decode tick.  Prefix serves
    (SmolLM-135M bf16 chunked, int8 chunked, bf16 sparse monolithic, bf16
    chunked at S = 2; Yi-6B bf16 chunked): a shared prompt of 2048 seeded
    tokens warms the tree in a first ``serve`` call, then 8 requests
    continue it; the cache-on tokens must equal the cache-off engine's bit
    for bit (at S = 2, where the stripe merge rounds by where the blocks
    sit, each request's stripes are printed on and off: those placed alike
    must give equal tokens, and with every block placed by its logical
    index all must), every request must hit, and the hits must save
    prefill chunks and #2 launches (printed with the tree's counters and
    the hit requests' TTFT on and off).  A preempted hit victim
    (SmolLM-135M) must keep its
    cached blocks resident, swap exactly its private tail's bytes and give
    the cache-off tokens, while two planted controls (its host copy zeroed;
    the hit ids mapped rotated) must change them.  SMOKE
    float32 parity on the card against the CPU with S = 2 and with the
    cache (bf16 and int8, whose controls run);
13. faults and self-healing (SmolLM-135M; ``FAULT_LENS``, four requests
    of 300-1500 tokens, ``FAULT_TOKENS`` each; at full depth the
    empty-plan, first corruption and first restore serves, the rest at
    ``CUT_LAYERS``): an engine with an empty-plan injector gives phase
    5's default tokens, and the sentinel's cost a decode tick is printed;
    ``kv_corrupt`` (NaN; Inf on the int8 pool's scales; the contiguous
    layout) fails exactly one request with a sentinel's reason, the
    others and a second serve keep the clean tokens, the victim's
    released blocks read codes 0 and scales 1, and with the scrub skipped
    a later request mapping the corrupted block must part or fail; a
    poisoned prefill fails alone with no tokens; on phase 11's preempted
    shape a swap-out fault heals and a swap-in failing past its retries
    is discarded and recomputed to the uninterrupted tokens, the host
    tier empty after; at D = 3 an ``epoch_swap`` fault rolls back (params,
    plan, epoch and pool kept), then the swap lands and serves as an
    engine that adopted the plan directly; crash and restore (paged bf16
    and int8, contiguous, the prefix cache at S = 2 whose restored tree
    hits, stochastic sampling) resumes bit for bit, printing each
    snapshot's bytes and save / restore seconds, while the restored tables
    rotated by one must part; a corrupted shared prefix block fails both
    holders and a later request misses; a chaos serve
    (``FaultPlan.random(seed=0, rate=0.05)``, preemption, SLO admission,
    the prefix cache, an audit every tick) hands back every request at
    every tick and its completed ones keep the clean tokens; SMOKE float32
    card == CPU for a corrupted and a restored serve.  Each serve prints
    its fault counters, injected events and failed requests;
14. the rest of the transformer family (``FAMILY_SERVES``), weights from a
    seeded torch generator on the card: Granite-MoE-1B's widths at 2
    layers in float32, paged and contiguous (card tokens == CPU tokens,
    the MoE FFN on both); then each model at full width, one at a time:
    Granite-MoE-1B (24 layers, 32 experts, top 8; D 64, G 2) serves phase
    5's traffic paged and contiguous (equal tokens) and dense monolithic
    (through #4; its tokens reported: a MoE model's chunks route other
    rows than the prompt bucket); Llama4-Scout (its first 4 of 48 layers,
    16 experts, top 1; D 128, G 5) paged and contiguous (equal tokens);
    Minitron-8B (its first 8 of 32 layers; D 128, G 4) paged.  Before its
    serves each MoE model's layer-0 ``moe_ffn`` runs in bf16 on the card
    against its float32 CPU run (``MOE_ROWS``, ``MOE_ATOL``; two card
    calls bit for bit; the pairs dropped printed, and each serve's), and
    Llama4-Scout's and Minitron-8B's engines hold #1 and #3 to their plain
    versions at their G (5, 4) and head_dim 128, timed (not forms of the
    kernels line);
15. mesh (the multi-GPU islands on one card): every rank a process on
    ``cuda:0``, the ``gloo`` backend staging each collective through host
    memory (``repro_torch.launch.steps.run_on_mesh``; ``MESH_RUNS``, full
    width, cut depth and batch): Yi-6B at ``model=4`` (``kv_group``, one
    KV group a rank) prefills 32768 tokens and decodes (the head-sharded
    branch) at 32768 cache positions for 8 rows; Gemma3-1B at ``model=2``
    (``kv_replication``, global kv ids) prefills 8192 tokens and decodes
    through the seq-sharded island (#3 partials merged over 2 ranks);
    SmolLM-135M at ``model=2`` prefills 8192 tokens in row mode; then the islands alone
    at Yi-6B's widths on 4 ranks (``island_rank``: the paged island over 2
    stripes, the 2D island over 2 x 2, the int8 packed decode, repermute,
    swap gather and scatter); then a one-rank NCCL mesh runs a Yi-6B
    prefill and decode.  Each rank records its layer-0 island calls: a
    head-sharded island's output must equal, bit for bit, the same kernel
    launched here on the rank's inputs; a merged output (#1 / #3 partials,
    row mode's tiles) and the ``wo`` sum over ``model`` must agree with the
    one-process result (``MESH_MERGE_ATOL``, ``MESH_REDUCE_RTOL``), and the
    same merge with any one rank's part dropped must not; every rank must launch
    its kernels and hold the same greedy tokens.  Each rank's island
    milliseconds print beside the plan's ``device_loads``: the ranks
    contend for one card's SMs, so these are not the paper's cross-GPU
    bubble.

Each kernel form of the last JSON line but one is named ``<kernel>``,
``<kernel>.<kind>`` (``int8``, ``fp8``, ``f32``) and, at Yi-6B's and
Gemma3-1B's shapes, ``...@yi-6b`` / ``...@gemma3-1b``, and the window
forms ``<kernel>.window@gemma3-1b``; its ``launches`` are those of the run
that launches it on a serving path (a full-width serve; for #4 the dense
monolithic paged serve, whose 'G' layers run the unwindowed form and 'L'
layers the window form; for #2's window forms the dense chunked serve of
their layout; the library-path run for #5; the float32 parity serves for
the f32 forms and the code decodes no full-width serve runs; the paged
int8 serve for the bf16-q fp8 prefill, which no serve launches, so its
count is 0).  A kernel's plain name counts its launches but those of its
window form.

The last two lines are a JSON object of per-kernel numbers and the card
line, then ``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""
import contextlib
import dataclasses
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate
BF16_FLOP_PER_S = 989e12       # dense bf16 tensor-core peak
F32_FLOP_PER_S = 67e12         # float32 outside the tensor cores
F32_ATOL = 1e-4                # f32 output: sums taken in another order
BF16_ATOL = 2.0 ** -6          # bf16 output: one bf16 ulp at |x| < 4
# A quantized float32 parity serve, the card replaying the CPU's tokens,
# gives each model call and row its largest card-vs-CPU logit difference.
# Sound serves differ as the K/V the two devices quantize differ by f32
# rounding, so codes next to a rounding boundary land one step apart (the
# paged pool requantizes a block per decode token, so there the noise
# reaches every call).  The median difference must stay under the model's
# QUANT_MEDIAN_ATOL, set between its sound serves' largest median and that
# of the planted control (q rounded to bf16 in the code decodes), which
# every parity with an int8 cache runs and must refuse; the largest under
# QUANT_LOGIT_ATOL, twice the largest sound reading, against a fault
# confined to a few rows (PERF.md §6, PR 20).
QUANT_LOGIT_ATOL = 3e-2
QUANT_MEDIAN_ATOL = {"smollm-135m-smoke": 5e-4, "yi-6b": 1.5e-3,
                     "gemma3-1b": 5.6e-3}
B, BLK, SMAX = 8, 128, 4096    # decode rows, KV block, max_seq_len


@dataclasses.dataclass(frozen=True)
class Shapes:
    """A model's attention shapes for the kernel phases, the suffix of its
    kernel-form names, and the decode checks' sliding window (the model's
    own where it has one)."""
    arch: str
    H: int
    HKV: int
    D: int
    tag: str
    window: int = 640

    @property
    def G(self) -> int:
        return self.H // self.HKV


SMOL = Shapes("smollm-135m", 9, 3, 64, "")
YI = Shapes("yi-6b", 32, 4, 128, "@yi-6b")
GEMMA = Shapes("gemma3-1b", 4, 1, 256, "@gemma3-1b", 512)
SERVE_LENS = (300, 1010, 3500, 2048, 700, 1500, 2900, 513)
# dense flash attention checks: (tag, causal, Sq, Skv); the first is timed
FLASH_CASES = (("causal,4096", True, 4096, 4096),
               ("non-causal,4096", False, 4096, 4096),
               ("causal,ragged 1000x3001", True, 1000, 3001))
SERVES = (("paged", "packed"), ("contiguous", "packed"),
          ("paged", "padded"), ("contiguous", "padded"))
# Yi-6B's and Gemma3-1B's full-width serves: (cache layout, KV dtype), all
# packed decode
FULL_SERVES = (("paged", "bf16"), ("contiguous", "bf16"), ("paged", "int8"))
# (the int8 serve at CUT_LAYERS)
QUANT_KINDS = ("int8", "fp8")
# the head-parallel degrees served at full width (``num_model_shards`` = D,
# KV groups placed on D shards, emulated on the one card), bf16: per model,
# each D with its (cache layout, decode work list) serves, whose greedy
# tokens must be equal
SHARDED_SERVES = {
    "smollm-135m": ((3, (("paged", "packed"), ("contiguous", "packed"))),),
    "yi-6b": ((4, (("paged", "packed"), ("paged", "padded"),
                   ("contiguous", "packed"))),
              (2, (("paged", "packed"),)))}
# Yi-6B's degree whose layer-0 packed table holds #1 / #3 to their plain
# versions, and that of its float32 parity
SHARDED_CHECK = 4
# the depth that keeps the whole script near its share of the time limit:
# the head-parallel serves (phase 8), SmolLM-135M's quantized serves (phase
# 5), Yi-6B's and Gemma3-1B's int8 serves (phases 6 and 7), the marked
# baseline serves (phase 9), Yi-6B's head move (phase 10), the preempted
# serves (phase 11), phase 12's secondary serves (SmolLM-135M S = 4 padded,
# int8, monolithic and S = 2 prefix and the preempted hit victim, Yi-6B D =
# 4 x S = 2 and prefix, Gemma3-1B dense S = 2) and phase 13's run the
# model's first CUT_LAYERS layers at full width (the default serves, the
# path of the kernels line's bf16 launches, and the first serve of most
# features keep every layer); Gemma3-1B's 12 layers are two LLLLLG periods
CUT_LAYERS = {"smollm-135m": 8, "yi-6b": 8, "gemma3-1b": 12}
# the paper's baselines served at full width (phase 9), per model: (tag,
# cut to CUT_LAYERS, EngineConfig options).  Dense serves prefill
# monolithically, so the dense flash attention (#4) runs on the prompt
# bucket; the first is the serve whose #4 launches the kernels line reads
BASELINE_SERVES = {
    "smollm-135m": (
        ("dense,monolithic,paged", False,
         dict(attention="dense", prefill_mode="monolithic")),
        ("dense,monolithic,contiguous", False,
         dict(attention="dense", prefill_mode="monolithic",
              cache_layout="contiguous")),
        ("dense,monolithic,paged,int8", True,
         dict(attention="dense", prefill_mode="monolithic", kv_dtype="int8")),
        ("dense,monolithic,exact,paged", True,
         dict(attention="dense", prefill_mode="monolithic",
              prefill_buckets="exact")),
        ("sparse,monolithic,paged", False, dict(prefill_mode="monolithic")),
        ("sparse,monolithic,contiguous", False,
         dict(prefill_mode="monolithic", cache_layout="contiguous"))),
    "yi-6b": (
        ("dense,monolithic,paged", False,
         dict(attention="dense", prefill_mode="monolithic")),
        ("sparse,monolithic,paged", False, dict(prefill_mode="monolithic"))),
    # the windowed dense prefill: #4's window form on the prompt bucket
    # (monolithic), #2's over dense chunks (chunked, both layouts)
    "gemma3-1b": (
        ("dense,monolithic,paged", True,
         dict(attention="dense", prefill_mode="monolithic")),
        ("dense,chunked,paged", True, dict(attention="dense")),
        ("dense,chunked,contiguous", True,
         dict(attention="dense", cache_layout="contiguous")))}
# the kernels whose window forms a sliding-window model's dense prefill
# runs on its 'L' layers (the kernels line's "<kernel>.window@<model>")
WINDOW_KERNELS = ("flash_attention", "sparse_prefill_paged",
                  "sparse_prefill_contig")
# plan epochs (phase 10): SmolLM-135M's replanning serve, and the model and
# degree of the forced head move (its KV groups rotated across the shards
# mid-serve, at the first tick from HEAD_MOVE_TICK with every prompt
# prefilled: a moved head's prefill lists would select other blocks, as the
# strided policy takes the slot, but a decode selection moves with its KV
# group); the moved serve replays the frozen serve's tokens and its
# logits must stay within HEAD_MOVE_ATOL of the frozen serve's (median,
# max): a moved wo sums the heads in another order, so bf16 logits differ
# by rounding; the max limit is half the planted one-call fault of the
# quantized parity (an output shifted by 1.0)
REPLAN = dict(telemetry_every=4, replan_every=16)
HEAD_MOVE = {"yi-6b": 4}
HEAD_MOVE_TICK = 12
HEAD_MOVE_ATOL = (0.1, 0.5)
# the offline profiling stage and overload serving (phase 11): two seeded
# calibration prompts of CALIB_TOKENS for SmolLM-135M's profile (curves
# within PROFILE_ATOL of the CPU's in the SMOKE float32 parity); the
# preempted serves (per model, (cache layout, KV dtype)): two batch prompts
# and a later interactive one, PREEMPT_LENS, 32 tokens each, on a pool of
# PREEMPT_BLOCKS that holds both batch requests (23 + 28 blocks) and not
# the arrival too (12), or on two slots (contiguous); the model and degree
# of the head move that straddles a victim's host residency, whose serves
# take STRADDLE_TOKENS (24 + 28 + 13 blocks): the first batch request then
# outlives the arrival's prefill, and the victim stays on the host past it
CALIB_TOKENS = 1024
PROFILE_ATOL = 1e-5
PREEMPT_LENS = (2900, 3500, 1500)
PREEMPT_BLOCKS = 56
PREEMPT_SERVES = {"smollm-135m": (("paged", "bf16"), ("contiguous", "bf16")),
                  "yi-6b": (("paged", "int8"),)}
STRADDLE = {"yi-6b": 4}
STRADDLE_TOKENS = 64
# the prompt buckets #4 takes in those serves: exact (ragged) lengths of
# SERVE_LENS and pow2 buckets
FLASH_BUCKETS = (513, 1010, 3500, 1024, 4096)
# sequence stripes (phase 12): per model, (tag, cut to CUT_LAYERS, the
# striped serve's EngineConfig options, its unstriped twin's, with the
# planted control).  The striped serve replays its twin's greedy tokens;
# each model call and live row's largest logit difference must hold
# STRIPE_ATOL (median, max), set above the sound readings and far below
# the control's (one stripe's partial left out of the merge) (PERF.md §6)
STRIPE_SERVES = {
    "smollm-135m": (("S=2,packed", False, dict(seq_shards=2), {}, False),
                    ("S=4,padded", True, dict(seq_shards=4,
                                              decode_worklist="padded"),
                     dict(decode_worklist="padded"), True)),
    "yi-6b": (("D=4,S=2", True, dict(num_model_shards=4, seq_shards=2),
               dict(num_model_shards=4), False),),
    "gemma3-1b": (("dense,S=2", True, dict(attention="dense", seq_shards=2),
                   dict(attention="dense"), False),)}
STRIPE_ATOL = (0.1, 0.25)
# the default serve's sampled logits by (model, depth) (phase 5), which
# phase 12's first striped serve replays instead of serving its twin again
DEFAULT_LOGITS: dict = {}
# the prefix cache (phase 12): a shared prompt of PREFIX_SHARED seeded
# tokens (16 blocks), then PREFIX_TAILS tails of 64-700 tokens, 32 greedy
# tokens each; per model, (tag, cut to CUT_LAYERS, EngineConfig options of
# both the cache-on and the cache-off engine).  Cache on must give the
# cache-off tokens bit for bit; striped (the stripe merge rounds by where
# the blocks sit), every request whose blocks sit on the same stripes on
# and off must, and every request must with blocks placed by logical index
PREFIX_SHARED = 2048
PREFIX_TAILS = 8
PREFIX_SERVES = {
    "smollm-135m": (("bf16,chunked", False, {}),
                    ("int8,chunked", True, dict(kv_dtype="int8")),
                    ("bf16,monolithic", True,
                     dict(prefill_mode="monolithic")),
                    ("bf16,chunked,S=2", True, dict(seq_shards=2))),
    "yi-6b": (("bf16,chunked", True, {}),)}
# the stochastic serve (phase 9): temperature, top-k, top-p
STOCHASTIC = dict(temperature=0.8, top_k=50, top_p=0.95)
# faults and self-healing (phase 13): SmolLM-135M's fault traffic (four
# requests of at most 1500 tokens, FAULT_TOKENS greedy tokens each), the
# decode tick a crash-and-restore run is saved at, and the chaos serve's
# pool
FAULT_LENS = (1500, 700, 1010, 300)
FAULT_TOKENS = 24
SNAPSHOT_TICK = 6
CHAOS_BLOCKS = 40
# the rest of the transformer family (phase 14): per model, its attention
# shapes, the depth served at full width (None: every layer; Llama4-Scout's
# 48 layers, ~203 GB of bf16 weights, do not fit one 80 GB card) and its
# serves (tag, EngineConfig options) of phase 5's traffic; a contiguous
# serve must give the paged serve's tokens bit for bit (both route the
# same rows through the MoE FFN).  Chunked == monolithic does not hold for
# a MoE model (a chunk routes other rows than the prompt bucket, so an
# expert's capacity and its drops differ: ROADMAP.md §3), so the dense
# monolithic serve's tokens are reported, not compared
GRANITE = Shapes("granite-moe-1b-a400m", 16, 8, 64, "@granite-moe-1b")
SCOUT = Shapes("llama4-scout-17b-a16e", 40, 8, 128, "@llama4-scout")
MINITRON = Shapes("minitron-8b", 32, 8, 128, "@minitron-8b")
FAMILY_SERVES = {
    GRANITE: (None, (("paged,packed", {}),
                     ("contiguous,packed", dict(cache_layout="contiguous")),
                     ("dense,monolithic,paged",
                      dict(attention="dense", prefill_mode="monolithic")))),
    SCOUT: (4, (("paged,packed", {}),
                ("contiguous,packed", dict(cache_layout="contiguous")))),
    MINITRON: (8, (("paged,packed", {}),))}
# the D 128 decode forms no earlier phase checks against their plain
# versions: G = 5 (the G <= 8 instantiation) and G = 4 (G <= 4)
FAMILY_DECODE_CHECKS = (SCOUT, MINITRON)
# the MoE FFN on the card in bf16 against its CPU run in float32 on the
# same inputs: rows a call (a decode step of 8 slots, a 256-row chunk),
# the largest difference allowed on rows routed alike (two bf16 ulps at
# |x| < 4: the experts' products and the combine round to bf16), and the
# rows a call that may be routed otherwise (f32 router sums taken in
# another order can swap two experts at a near-tie)
MOE_ROWS = (8, 256)
MOE_ATOL = 2.0 ** -5
MOE_REROUTED = 0.01
# Granite-MoE-1B's float32 parity: its widths at 2 layers, the prompts
FAMILY_PARITY = (2, (300, 40, 130))
# the multi-GPU islands (phase 15): per run (arch, model degree, layers,
# shapes as (name, seq_len, batch, kind)); Yi-6B at the reference's
# prefill_32k and decode_32k lengths, batch cut from 32 / 128 to 1 / 8;
# Gemma3-1B and SmolLM-135M prefill a quarter of that (8192 tokens); depth
# cut (PERF.md §4)
MESH_RUNS = (
    ("yi-6b", 4, 2, (("prefill_32k", 32768, 1, "prefill"),
                     ("decode_32k", 32768, 8, "decode"))),
    ("gemma3-1b", 2, 2, (("prefill_8k", 8192, 1, "prefill"),)),
    ("smollm-135m", 2, 2, (("prefill_8k", 8192, 1, "prefill"),)))
MESH_STEPS = 2                 # greedy decode steps after each prefill
MESH_TIMEOUT = 300             # seconds a spawn of ranks may take
# phase 15's merged outputs (#1 / #3 partials merged over ranks, row
# tiles summed) against one process, max abs: sound merges read at most
# 2.441e-4, a merge with any one rank's part dropped at least 5.585e-2
# (the least: Gemma3-1B's seq-sharded decode without the rank that holds
# only the sink block)
MESH_MERGE_ATOL = 2.0 ** -10
# the wo sum over model against one process's product, max abs relative to
# the product's largest |value|: the bf16 partials, each rounded, summed in
# bf16 land 1-2 bf16 steps off (sound sums read at most 8.368e-3, 2^-8 would
# refuse them), a sum with any one rank's partial left out at least 0.415
MESH_REDUCE_RTOL = 2.0 ** -6
# the kernels each serve must launch (the first two are also the
# default path's); a quantized cache runs the codes-and-scales forms
# ("<kernel>.<kind>") but the contiguous prefill, which reads the
# full-precision staging row
SERVE_KERNELS = {
    ("paged", "bf16"): ("flash_decode_paged", "sparse_prefill_paged"),
    ("contiguous", "bf16"): ("flash_decode_contig", "sparse_prefill_contig"),
    **{("paged", k): (f"flash_decode_paged.{k}", f"sparse_prefill_paged.{k}")
       for k in QUANT_KINDS},
    **{("contiguous", k): (f"flash_decode_contig.{k}",
                           "sparse_prefill_contig") for k in QUANT_KINDS}}
# the libraries whose bf16 kernels must run on tensor cores
TENSOR_CORE_LIBS = ("sparse_prefill_paged", "sparse_prefill_contig",
                    "flash_attention")
# each kernel and the TPU kernel it replaces
KERNELS = {
    "flash_decode_paged": "src/repro/kernels/flash_decode.py:510",
    "sparse_prefill_paged": "src/repro/kernels/sparse_prefill.py:111",
    "flash_decode_contig": "src/repro/kernels/flash_decode.py:214",
    "sparse_prefill_contig": "src/repro/kernels/sparse_prefill.py:111",
    "flash_attention": "src/repro/kernels/flash_attn.py:83",
    "sparse_decode": "src/repro/kernels/sparse_decode.py:190"}
CODE_KERNELS = ("flash_decode_paged", "flash_decode_contig",
                "sparse_prefill_paged")
PATH_KERNELS = ("flash_decode_paged", "sparse_prefill_paged",
                "flash_decode_contig", "sparse_prefill_contig")
# every kernel form of the kernels line: SmolLM-135M's bf16 kernels and
# code forms, then Yi-6B's and Gemma3-1B's bf16 kernels, f32 forms and code
# forms
FORMS = (*KERNELS,
         *(f"{n}.{k}" for n in CODE_KERNELS for k in QUANT_KINDS),
         *(f for sh in (YI, GEMMA) for f in (
             *(f"{n}{sh.tag}" for n in KERNELS),
             *(f"{n}.f32{sh.tag}" for n in PATH_KERNELS),
             *(f"{n}.{k}{sh.tag}" for n in CODE_KERNELS
               for k in QUANT_KINDS))),
         *(f"{n}.window{GEMMA.tag}" for n in WINDOW_KERNELS))
# a form's kind -> the key of its wrapper's launches_by_dtype ("window":
# the window form's launches, whatever the dtype)
KIND_DTYPES = {"int8": "int8", "fp8": "float8_e4m3fn", "f32": "float32",
               "window": "window"}


def form(kernel: str, kind: str | None, sh: Shapes) -> str:
    """The name of a kernel form: ``<kernel>[.<kind>]<shape tag>``."""
    return f"{kernel}{'.' + kind if kind else ''}{sh.tag}"


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def counters():
    """Each kernel's wrapper, whose ``launches`` counts its launches."""
    from repro_torch.kernels.flash_attn import flash_attention
    from repro_torch.kernels.flash_decode import (
        flash_decode_kernel, flash_decode_paged_kernel)
    from repro_torch.kernels.sparse_decode import sparse_decode_attention
    from repro_torch.kernels.sparse_prefill import (
        sparse_prefill_attention, sparse_prefill_paged)
    return {"flash_decode_paged": flash_decode_paged_kernel,
            "sparse_prefill_paged": sparse_prefill_paged,
            "flash_decode_contig": flash_decode_kernel,
            "sparse_prefill_contig": sparse_prefill_attention,
            "flash_attention": flash_attention,
            "sparse_decode": sparse_decode_attention}


def reset_counts():
    from repro_torch.kernels.build import reset_launches
    reset_launches(*counters().values())


def read_counts(names):
    """Launches of each form name: a kernel's (its launches but those of
    its window form) or, for ``<kernel>.<kind>``, those over ``kind``'s K/V
    dtype, or of the window form (the shape tag names the run, not a
    count)."""
    c, got = counters(), {}
    for n in names:
        base, _, kind = n.partition("@")[0].partition(".")
        by = c[base].launches_by_dtype
        got[n] = (by.get(KIND_DTYPES[kind], 0) if kind
                  else c[base].launches - by.get("window", 0))
    return got


def time_ms(fn, *, graph: bool, reps: int = 20) -> float:
    """Mean time of one call of ``fn`` on the card, after a warm-up call:
    ``reps`` calls captured in a CUDA graph and replayed (device time
    only), or, for code that syncs with the host, ``reps`` plain calls
    between two events."""
    import torch
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(reps):
                fn()
        g.replay()
        torch.cuda.synchronize()
        start.record()
        g.replay()
        end.record()
    else:
        start.record()
        for _ in range(reps):
            fn()
        end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes: float, bf16_flops: float, f32_flops: float):
    """The least time for the work: each byte moved once at the memory
    rate, or the operations at each type's peak rate, whichever is longer.
    Returns (ms, "bytes" or "operations")."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = bf16_flops / BF16_FLOP_PER_S + f32_flops / F32_FLOP_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def check(name: str, tag: str, got, want, atol: float) -> float:
    """Max abs difference of two tensors, or of the outputs of two decode
    ``(out, m, l)`` triples with m and l compared relative to ``|x| + 1``;
    fails above ``atol``."""
    import torch
    torch.cuda.synchronize()
    if not isinstance(got, tuple):
        got, want = (got,), (want,)
    err = max(((g.float() - w.float()).abs() / (w.float().abs() + 1 if i
                                                 else 1)).max().item()
              for i, (g, w) in enumerate(zip(got, want)))
    print(f"{name}[{tag}]: max abs err {err:.3e} (tolerance {atol:g})")
    if not err <= atol:
        fail(f"{name} disagrees with its plain version ({tag}: {err:.3e})")
    return err


def measure(results, name, kernel, plain, library, nbytes, bf16_flops,
            f32_flops, err, note=""):
    """Time the kernel (CUDA graph), its plain version (host-synced) and
    one library call on the same work; record them with the bound."""
    ms = time_ms(kernel, graph=True)
    plain_ms = time_ms(plain, graph=False, reps=3)
    library_ms = time_ms(library, graph=True)
    bms, by = bound_ms(nbytes, bf16_flops, f32_flops)
    print(f"{name} timing{note}: kernel {ms:.4f} ms, plain {plain_ms:.3f} "
          f"ms, SDPA {library_ms:.4f} ms, bound {bms * 1e3:.2f} us ({by})")
    results[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bms, "bound_by": by,
                     "library_ms": library_ms}


def tensor_core_counts(kbuild) -> None:
    """Count HMMA/HGMMA instructions per kernel function in the SASS of the
    built prefill and flash-attention libraries (``cuobjdump -sass``); fail
    if a bf16 kernel has none, so a scalar body cannot pass as the
    tensor-core one."""
    cuobjdump = Path(kbuild.nvcc()).with_name("cuobjdump")
    for name in TENSOR_CORE_LIBS:
        sass = subprocess.run(
            [str(cuobjdump), "-sass", str(kbuild.library_path(name))],
            capture_output=True, text=True, timeout=300)
        if sass.returncode != 0:
            fail(f"cuobjdump -sass {name}: {sass.stderr.strip()}")
        counts, func = {}, None
        for line in sass.stdout.splitlines():
            if "Function :" in line:
                func = line.split("Function :", 1)[1].strip()
                counts[func] = 0
            elif func is not None and ("HMMA" in line or "HGMMA" in line):
                counts[func] += 1
        bf16 = {f: n for f, n in counts.items() if "nv_bfloat16" in f}
        other = sum(n for f, n in counts.items() if f not in bf16)
        print(f"tensor-core instructions in {name}: bf16 kernels "
              f"{sorted(bf16.values())}, other kernels {other}")
        if not bf16 or min(bf16.values()) == 0:
            fail(f"{name}: a bf16 kernel has no tensor-core instruction")


DECODE_LIBS = ("flash_decode_paged", "flash_decode_contig", "sparse_decode")


def decode_registers(kbuild, logs) -> None:
    """Registers and spills of each decode function (#1, #3, #5) from the
    build's ``ptxas`` lines, one line a function (names demangled with
    ``cu++filt``), then how many spill; a build served from the cache
    printed no ``ptxas`` lines, and then says so."""
    import re
    filt = Path(kbuild.nvcc()).with_name("cu++filt")
    rows = []
    for lib in DECODE_LIBS:
        func = spill = None
        for line in logs.get(lib, "").splitlines():
            if "entry function" in line:
                func = line.split("'")[1]
            elif func and "spill stores" in line:
                spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes "
                                  r"spill loads", line).groups()
            elif func and spill and "registers" in line:
                regs = re.search(r"Used (\d+) registers", line).group(1)
                rows.append((lib, func, int(regs), *map(int, spill)))
                func = spill = None
    if not rows:
        print("decode functions: registers and spills not read in this run "
              "(no ptxas lines: the build was served from the cache)")
        return
    for lib, func, regs, stores, loads in rows:
        name = (subprocess.run([str(filt), func], capture_output=True,
                               text=True).stdout.strip()
                if filt.exists() else "") or func
        print(f"  registers[{lib}] {name.split('>(')[0]}>: {regs} "
              f"registers, {stores} B spill stores, {loads} B spill loads")
    spilling = [r for r in rows if r[3] or r[4]]
    print(f"decode functions: {len(rows)}, {len(spilling)} spilling"
          + (f" (at most {max(r[3] for r in spilling)} B stores)"
             if spilling else ""))


def random_table(gen, rows: int, nblocks, pool_blocks: int, width: int):
    """[rows, width] int32 tables: row r maps its nblocks[r] logical blocks
    to distinct random physical blocks, -1 after."""
    import torch
    perm = torch.randperm(pool_blocks, generator=gen)
    table = torch.full((rows, width), -1, dtype=torch.int32)
    at = 0
    for r in range(rows):
        n = int(nblocks[r])
        table[r, :n] = perm[at:at + n].to(torch.int32)
        at += n
    return table


def slot_rows(pool, table):
    """The slot cache ``[rows, Hkv, T*blk, D]`` holding what ``table`` maps
    from ``pool`` (zeros where unmapped)."""
    rows, T = table.shape
    g = pool[table.clamp_min(0).long()]                 # [rows, T, Hkv, ..]
    g = g * (table >= 0)[:, :, None, None, None].to(g.dtype)
    return g.permute(0, 2, 1, 3, 4).reshape(rows, pool.shape[1],
                                            T * pool.shape[2],
                                            pool.shape[3]).contiguous()


def decode_mask(items, table, pos, sh: Shapes, window=None):
    """Boolean ``[B, H, 1, T*blk]`` mask of the (row, key) pairs the items
    select (with ``window``, only keys past ``pos - window``), and the
    selected (physical block, kv head) tiles."""
    import numpy as np
    it_np, tb_np, pos_np = (t.cpu().numpy() for t in (items, table, pos))
    T = tb_np.shape[1]
    kpos = np.arange(T * BLK)
    mask = np.zeros((tb_np.shape[0], sh.H, 1, T * BLK), bool)
    tiles = set()
    for b, h, lb, _, _, valid in it_np:
        if valid and tb_np[b, lb] >= 0:
            tiles.add((int(tb_np[b, lb]), int(h)))
            sl = slice(lb * BLK, (lb + 1) * BLK)
            kept = kpos[sl] <= pos_np[b]
            if window:
                kept &= kpos[sl] > pos_np[b] - window
            mask[b, h * sh.G:(h + 1) * sh.G, 0, sl] = kept
    return mask, tiles


def kept_rows(mask, sh: Shapes) -> int:
    """The K/V rows a decode must read: the keys ``mask`` keeps for each
    (row, kv head), read once for its G query rows (the kernels copy only
    those, not the rest of a selected tile)."""
    return int(mask[:, ::sh.G].sum())


def decode_bound(items, table, mask, with_table: bool, sh: Shapes,
                 elem: int):
    """Bytes: q, the kept K/V rows (:func:`kept_rows`, ``elem`` bytes an
    element), the item table (and block table), positions and the f32
    (out, m, l); operations: the unmasked (query row, key) pairs, q.k on
    bf16 inputs at the tensor rate (f32 inputs at the f32 rate), p.V in
    true f32 (the kernel's contract) at the f32 rate.  Returns (bytes, bf16
    operations, f32 operations)."""
    rows = kept_rows(mask, sh)
    nbytes = (B * sh.H * sh.D * elem + rows * 2 * sh.D * elem
              + items.numel() * 4 + (table.numel() * 4 if with_table else 0)
              + B * 4 + B * sh.H * (sh.D + 2) * 4)
    flops = 2 * sh.D * int(mask.sum())
    return (nbytes, flops, flops) if elem == 2 else (nbytes, 0, 2 * flops)


def split_report(name: str, launch, items, legacy: bool = False) -> None:
    """A decode form's grid (one CTA per item), the CTAs that walk a split
    of at most ``SPLIT_TILES`` tiles, its longest run in tiles (under the
    legacy decode's run rule with ``legacy``), and whether two launches of
    the same inputs give the same bits; fails if not."""
    import torch
    from repro_torch.kernels.flash_decode import SPLIT_TILES, decode_runs
    lens = [last - first + 1 for first, last in decode_runs(
        items.cpu().tolist(), legacy)]
    splits = sum(-(-n // SPLIT_TILES) for n in lens)
    first, again = launch(), launch()
    if not isinstance(first, tuple):
        first, again = (first,), (again,)
    same = all(torch.equal(a, b) for a, b in zip(first, again))
    print(f"{name}: {items.shape[0]} CTAs a launch, {splits} walking a "
          f"split of <= {SPLIT_TILES} tiles, {len(lens)} runs, longest "
          f"{max(lens)} tiles; two launches {'==' if same else '!='} bit "
          f"for bit")
    if not same:
        fail(f"{name}: two launches of the same inputs differ")


def decode_case(eng, gen, dev, sh: Shapes, mag=None):
    """Layer 0's decode work of the engine at 8 rows of 3000-4096 tokens:
    positions, the block table, packed items, the padded table from
    per-slot block ids, the table with -1 entries, and float32 K/V pools
    (N(0, 1), or scaled per tile by ``mag``) and q."""
    import numpy as np
    import torch
    from repro_torch.kernels.flash_decode import decode_items_from_ids
    T = SMAX // BLK
    N = B * T + 1
    pos = torch.randint(3000, SMAX, (B,), generator=gen, dtype=torch.int32)
    nblocks = (pos + 1 + BLK - 1) // BLK
    table = random_table(gen, B, nblocks, N - 1, T).to(dev)
    pos = pos.to(dev)
    shape = (N, sh.HKV, BLK, sh.D)
    if mag:
        scale = mag[0] + (mag[1] - mag[0]) * torch.rand(
            (N, sh.HKV, 1, 1), generator=gen)
        kf = torch.randn(shape, generator=gen) * scale
        vf = torch.randn(shape, generator=gen) * scale
    else:
        kf, vf = (torch.randn(shape, generator=gen) for _ in range(2))
    q = torch.randn((B, sh.HKV, sh.G, sh.D), generator=gen)
    sig = eng._nb_sig(pos.cpu().numpy())
    items = eng._plan_for(sig)[0][0].contiguous()       # layer 0's list
    bids = torch.from_numpy(np.stack(
        [eng._decode_ids_for_nblocks(n)[0] for n in sig])).to(dev)
    padded = decode_items_from_ids(bids)
    holes = table.clone()
    holes[:4, 0] = -1                                    # unmapped sinks
    for r in range(4, B):
        holes[r, int(nblocks[r]) - 1] = -1               # unmapped newest
    return pos, table, items, padded, holes, kf.to(dev), vf.to(dev), q.to(dev)


def time_table_forms(name, launch, plain, sdpa_of, items, padded, table,
                     pos, errs, sh: Shapes, bound_of) -> None:
    """#1 on the padded table from per-slot block ids and in its window
    form (``sh.window``), each timed (printed, not in the kernels line)
    beside SDPA over the same kept (row, key) pairs (``sdpa_of(mask)``) and
    its bound (``bound_of(items, mask, ntiles)`` -> bytes, bf16 and f32
    operations over the kept K/V rows).  ``launch`` / ``plain`` take the
    items and the window's keywords; ``errs`` each form's checked error."""
    import torch
    for tag, it, win in (("padded", padded, None),
                         ("window", items, sh.window)):
        kw = {} if win is None else {"window": win}
        mask, tiles = decode_mask(it, table, pos, sh, win)
        mask_t = torch.from_numpy(mask).to(table.device)
        nbytes, bf, f32 = bound_of(it, mask, len(tiles))
        measure({}, f"{name}[{tag}]",
                lambda it=it, kw=kw: launch(it, **kw),
                lambda it=it, kw=kw: plain(it, **kw),
                lambda mask_t=mask_t: sdpa_of(mask_t), nbytes, bf, f32,
                errs[tag], f" ({len(tiles)} selected tiles, "
                f"{kept_rows(mask, sh)} K/V rows)")


def check_decode(eng, gen, dev, results, sh: Shapes, dtypes):
    """The paged (#1) and contiguous (#3) decode kernels on the engine's
    layer-0 work at 8 rows of 3000-4096 tokens, q and caches in each of
    ``dtypes``: packed items, the padded table from per-slot block ids, -1
    table entries, a window; the two layouts bit for bit on equal cache
    contents; each form timed beside its bound and SDPA (#1 also on the
    padded table and in its window form)."""
    import torch
    from repro_torch.kernels.flash_decode import (
        flash_decode_kernel, flash_decode_paged_kernel,
        packed_decode_attention, packed_decode_attention_paged)
    pos, table, items, padded, holes, kf, vf, qf = decode_case(eng, gen, dev,
                                                               sh)
    mask, tiles = decode_mask(items, table, pos, sh)
    mask_t = torch.from_numpy(mask).to(dev)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for dtype in dtypes:
        kind = None if dtype == torch.bfloat16 else "f32"
        sfx = "" if kind is None else f",{kind}"
        q, kp, vp = (t.to(dtype) for t in (qf, kf, vf))
        kc, vc = slot_rows(kp, table), slot_rows(vp, table)

        def paged(fn, it, tb=table, **kw):
            return fn(q, kp, vp, it, tb, pos, block_kv=BLK, **kw)

        def contig(fn, it, **kw):
            return fn(q, kc, vc, it, pos, block_kv=BLK, **kw)

        errs = {}
        pname = form("flash_decode_paged", kind, sh)
        cname = form("flash_decode_contig", kind, sh)
        for tag, it, tb, kw in (("packed", items, table, {}),
                                ("padded", padded, table, {}),
                                ("unmapped", items, holes, {}),
                                ("window", items, table,
                                 {"window": sh.window})):
            errs["paged", tag] = check(
                pname, tag, paged(flash_decode_paged_kernel, it, tb, **kw),
                paged(packed_decode_attention_paged, it, tb, **kw), F32_ATOL)
        for tag, it, kw in (("packed", items, {}), ("padded", padded, {}),
                            ("window", items, {"window": sh.window})):
            got = contig(flash_decode_kernel, it, **kw)
            errs["contig", tag] = check(
                cname, tag, got, contig(packed_decode_attention, it, **kw),
                F32_ATOL)
            same = all(torch.equal(a, b) for a, b in zip(
                got, paged(flash_decode_paged_kernel, it, **kw)))
            print(f"decode{sh.tag}[{tag}{sfx}]: contiguous "
                  f"{'==' if same else '!='} paged, bit for bit")
            if not same:
                fail(f"the contiguous and paged decode kernels differ "
                     f"({sh.arch}, {tag}{sfx})")
        split_report(pname, lambda: paged(flash_decode_paged_kernel, items),
                     items)
        split_report(cname, lambda: contig(flash_decode_kernel, items),
                     items)
        qs = q.reshape(B, sh.H, 1, sh.D)
        elem = q.element_size()
        # library yardstick: SDPA over the same selected keys as a mask on
        # K/V gathered from the pool beforehand (the gather is not timed)
        nbytes, bf, f32 = decode_bound(items, table, mask, True, sh, elem)
        measure(results, pname,
                lambda: paged(flash_decode_paged_kernel, items),
                lambda: paged(packed_decode_attention_paged, items),
                lambda: sdpa(qs, kc, vc, attn_mask=mask_t, enable_gqa=True),
                nbytes, bf, f32, errs["paged", "packed"],
                f" ({len(tiles)} selected tiles)")
        time_table_forms(
            pname,
            lambda it, **kw: paged(flash_decode_paged_kernel, it, **kw),
            lambda it, **kw: paged(packed_decode_attention_paged, it, **kw),
            lambda m: sdpa(qs, kc, vc, attn_mask=m, enable_gqa=True),
            items, padded, table, pos,
            {t: errs["paged", t] for t in ("padded", "window")}, sh,
            lambda it, m, nt: decode_bound(it, table, m, True, sh, elem))
        nbytes, bf, f32 = decode_bound(items, table, mask, False, sh, elem)
        measure(results, cname,
                lambda: contig(flash_decode_kernel, items),
                lambda: contig(packed_decode_attention, items),
                lambda: sdpa(qs, kc, vc, attn_mask=mask_t, enable_gqa=True),
                nbytes, bf, f32, errs["contig", "packed"])


def prefill_mask(items, table, q_off, C, kv_len, T, sh: Shapes):
    """Boolean ``[H, C, T*blk]`` mask of the (query, key) pairs the items
    select, the selected (physical block, kv head) tiles and the valid
    item count."""
    import numpy as np
    it_np, tb_np = items.cpu().numpy(), table.cpu().numpy()
    qpos = q_off + np.arange(C)
    kpos = np.arange(T * BLK)
    mask = np.zeros((sh.H, C, T * BLK), bool)
    tiles, nvalid = set(), 0
    for h, qb, lb, _, _, valid, kvh in it_np:
        if valid and tb_np[lb] >= 0:
            nvalid += 1
            tiles.add((int(tb_np[lb]), int(kvh)))
            rs = slice(qb * BLK, (qb + 1) * BLK)
            sl = slice(lb * BLK, (lb + 1) * BLK)
            mask[h, rs, sl] = ((kpos[None, sl] <= qpos[rs, None])
                               & (kpos[None, sl] < kv_len))
    return mask, tiles, nvalid


def run_lengths(items):
    """The valid items (tiles) of each run of a prefill work list."""
    import numpy as np
    from repro_torch.core.worklist import F_FIRST, F_VALID
    it = items.cpu().numpy()
    starts = np.flatnonzero(it[:, F_FIRST] == 1)
    valid = np.concatenate([[0], np.cumsum(it[:, F_VALID] == 1)])
    ends = np.append(starts[1:], len(it))
    return [int(n) for n in valid[ends] - valid[starts]]


def check_prefill(eng, gen, dev, results, sh: Shapes, timed_dtypes):
    """The paged (#2) and contiguous sparse prefill kernels on a 256-token
    chunk of a 2304-token prompt at q_offset 0 and 2048, bf16 and f32, over
    the engine's chunk work lists; the contiguous form reads the slot row
    [Hkv, 4096, D] in place, and the two layouts agree bit for bit.  The
    forms in ``timed_dtypes`` are timed at q_offset 2048 beside their bound
    and SDPA."""
    import torch
    from repro_torch.kernels.sparse_prefill import (
        sparse_prefill_attention, sparse_prefill_paged, worklist_attention,
        worklist_attention_paged)
    C, prompt = 256, 2304
    T = SMAX // BLK
    N = T + 1
    table = random_table(gen, 1, [prompt // BLK], N - 1, T)[0].to(dev)
    shape = (N, sh.HKV, BLK, sh.D)
    kp = torch.randn(shape, generator=gen).to(dev, torch.bfloat16)
    vp = torch.randn(shape, generator=gen).to(dev, torch.bfloat16)
    kc, vc = slot_rows(kp, table[None])[0], slot_rows(vp, table[None])[0]
    q = torch.randn((sh.H, C, sh.D), generator=gen).to(dev, torch.bfloat16)
    pname = lambda dt: form("sparse_prefill_paged",  # noqa: E731
                            None if dt == torch.bfloat16 else "f32", sh)
    cname = lambda dt: form("sparse_prefill_contig",  # noqa: E731
                            None if dt == torch.bfloat16 else "f32", sh)
    errs, timed = {}, {}
    for q_offset in (0, 2048):
        items = eng._chunk_worklists(prompt, q_offset, C)[0].contiguous()
        kw = dict(block_q=BLK, block_kv=BLK, q_offset=q_offset,
                  kv_len=q_offset + C)
        timed[q_offset] = items
        for dtype, atol in ((torch.bfloat16, BF16_ATOL),
                            (torch.float32, F32_ATOL)):
            tag = f"q_offset={q_offset},{str(dtype)[6:]}"
            qd, pk, pv, ck, cv = (t.to(dtype) for t in (q, kp, vp, kc, vc))
            got_p = sparse_prefill_paged(qd, pk, pv, items, table, **kw)
            errs["paged", tag] = check(
                pname(torch.bfloat16), tag, got_p,
                worklist_attention_paged(qd, pk, pv, items, table, **kw),
                atol)
            got_c = sparse_prefill_attention(qd, ck, cv, items, **kw)
            errs["contig", tag] = check(
                cname(torch.bfloat16), tag, got_c,
                worklist_attention(qd, ck, cv, items, **kw), atol)
            if not torch.equal(got_p, got_c):
                fail(f"the contiguous and paged prefill kernels differ "
                     f"({sh.arch}, {tag})")
            print(f"prefill{sh.tag}[{tag}]: contiguous == paged, bit for bit")

    # the kernel is bound by each CTA's serial chain of tiles: time it at
    # both offsets beside the longest run's tile count
    for q_offset, items in timed.items():
        kw = dict(block_q=BLK, block_kv=BLK, q_offset=q_offset,
                  kv_len=q_offset + C)
        ms = time_ms(lambda: sparse_prefill_paged(q, kp, vp, items, table,
                                                  **kw), graph=True)
        print(f"{pname(torch.bfloat16)} at q_offset {q_offset}: longest "
              f"run {max(run_lengths(items))} tiles, kernel {ms:.4f} ms")
    items = timed[2048]
    kw = dict(block_q=BLK, block_kv=BLK, q_offset=2048, kv_len=2048 + C)
    mask, tiles, nvalid = prefill_mask(items, table, 2048, C, 2048 + C, T,
                                       sh)
    mask_t = torch.from_numpy(mask[None]).to(dev)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    # unmasked (query, key) pairs only; bf16: both products on bf16 inputs
    # at the tensor rate (p may be rounded to bf16 within the bf16
    # tolerance); f32: both at the f32 rate
    flops = 2 * sh.D * int(mask.sum())
    note = f" (chunk {C} at q_offset 2048, {nvalid} tiles)"
    for dtype in timed_dtypes:
        qd, pk, pv, ck, cv = (t.to(dtype) for t in (q, kp, vp, kc, vc))
        elem = qd.element_size()
        base = (2 * qd.numel() * elem + len(tiles) * 2 * BLK * sh.D * elem
                + items.numel() * 4)
        ops = (2 * flops, 0) if elem == 2 else (0, 2 * flops)
        tag = f"q_offset=2048,{str(dtype)[6:]}"
        library = (lambda qd=qd, ck=ck, cv=cv: sdpa(
            qd[None], ck[None], cv[None], attn_mask=mask_t,
            enable_gqa=True))
        measure(results, pname(dtype),
                lambda qd=qd, pk=pk, pv=pv: sparse_prefill_paged(
                    qd, pk, pv, items, table, **kw),
                lambda qd=qd, pk=pk, pv=pv: worklist_attention_paged(
                    qd, pk, pv, items, table, **kw),
                library, base + table.numel() * 4, *ops,
                errs["paged", tag], note)
        measure(results, cname(dtype),
                lambda qd=qd, ck=ck, cv=cv: sparse_prefill_attention(
                    qd, ck, cv, items, **kw),
                lambda qd=qd, ck=ck, cv=cv: worklist_attention(
                    qd, ck, cv, items, **kw),
                library, base, *ops, errs["contig", tag], note)


def quant_pool(pool, kind):
    """Codes and per-(block, kv head) scales of a bf16 pool ``[N, Hkv, blk,
    D]``, as the engine stores it, and the dequantized bf16 pool the
    library yardstick reads."""
    import torch
    from repro_torch.core import quant
    codes, scales = quant.quantize_pool_blocks(pool, kind)
    deq = quant.dequantize_tiles(codes, scales).to(torch.bfloat16)
    return codes, scales, deq


def slot_scales(scales, table):
    """Scales ``[rows, Hkv, T]`` of the slot cache :func:`slot_rows`
    builds from a pool's scales ``[N, Hkv]`` (1.0 where unmapped)."""
    import torch
    got = scales[table.clamp_min(0).long()].permute(0, 2, 1)
    return torch.where((table >= 0)[:, None, :], got, 1.0).contiguous()


def check_quant_decode(eng, gen, dev, results, sh: Shapes):
    """#1 and #3 over int8 / fp8 codes with per-block scales at the engine's
    layer-0 shapes (8 rows of 3000-4096 tokens): packed items, the padded
    table, -1 table entries, a window; the two layouts bit for bit; each
    form timed beside its bound and SDPA on the dequantized bf16 K/V (#1
    also on the padded table and in its window form)."""
    import torch
    from repro_torch.kernels.flash_decode import (
        flash_decode_kernel, flash_decode_paged_kernel,
        packed_decode_attention, packed_decode_attention_paged)
    # magnitudes that differ from block to block, so the scales do too
    # (0.25-1x the N(0, 1) values of the bf16 checks)
    pos, table, items, padded, holes, kf, vf, q = decode_case(
        eng, gen, dev, sh, mag=(0.25, 1.0))
    kf, vf, q = (t.to(torch.bfloat16) for t in (kf, vf, q))
    mask, tiles = decode_mask(items, table, pos, sh)
    mask_t = torch.from_numpy(mask).to(dev)
    qs = q.reshape(B, sh.H, 1, sh.D)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for kind in QUANT_KINDS:
        kc, ks, kdq = quant_pool(kf, kind)
        vc, vs, vdq = quant_pool(vf, kind)
        ck, cv = slot_rows(kc.view(torch.int8), table).view(kc.dtype), \
            slot_rows(vc.view(torch.int8), table).view(vc.dtype)
        sk, sv = slot_scales(ks, table), slot_scales(vs, table)

        def paged(fn, it, tb=table, **kw):
            return fn(q, kc, vc, it, tb, pos, block_kv=BLK, k_scales=ks,
                      v_scales=vs, **kw)

        def contig(fn, it, **kw):
            return fn(q, ck, cv, it, pos, block_kv=BLK, k_scales=sk,
                      v_scales=sv, **kw)

        errs = {}
        pname = form("flash_decode_paged", kind, sh)
        cname = form("flash_decode_contig", kind, sh)
        win = {"window": sh.window}
        for tag, it, tb, kw in (("packed", items, table, {}),
                                ("padded", padded, table, {}),
                                ("unmapped", items, holes, {}),
                                ("window", items, table, win)):
            errs["paged", tag] = check(
                pname, tag, paged(flash_decode_paged_kernel, it, tb, **kw),
                paged(packed_decode_attention_paged, it, tb, **kw), F32_ATOL)
        for tag, it, kw in (("packed", items, {}), ("padded", padded, {}),
                            ("window", items, win)):
            got = contig(flash_decode_kernel, it, **kw)
            errs["contig", tag] = check(
                cname, tag, got, contig(packed_decode_attention, it, **kw),
                F32_ATOL)
            same = all(torch.equal(a, b) for a, b in zip(
                got, paged(flash_decode_paged_kernel, it, **kw)))
            print(f"decode.{kind}{sh.tag}[{tag}]: contiguous "
                  f"{'==' if same else '!='} paged, bit for bit")
            if not same:
                fail(f"the {kind} contiguous and paged decode kernels "
                     f"differ ({sh.arch}, {tag})")
        split_report(pname, lambda: paged(flash_decode_paged_kernel, items),
                     items)
        split_report(cname, lambda: contig(flash_decode_kernel, items),
                     items)
        kdc, vdc = slot_rows(kdq, table), slot_rows(vdq, table)
        time_table_forms(
            pname,
            lambda it, **kw: paged(flash_decode_paged_kernel, it, **kw),
            lambda it, **kw: paged(packed_decode_attention_paged, it, **kw),
            lambda m: sdpa(qs, kdc, vdc, attn_mask=m, enable_gqa=True),
            items, padded, table, pos,
            {t: errs["paged", t] for t in ("padded", "window")}, sh,
            lambda it, m, nt: (quant_decode_bytes(it, table, m, nt, True,
                                                  sh),
                               0, 4 * sh.D * int(m.sum())))
        for name, layout in ((pname, paged), (cname, contig)):
            kern = flash_decode_paged_kernel if layout is paged \
                else flash_decode_kernel
            plain = packed_decode_attention_paged if layout is paged \
                else packed_decode_attention
            nbytes = quant_decode_bytes(items, table, mask, len(tiles),
                                        layout is paged, sh)
            flops = 2 * sh.D * int(mask.sum())
            measure(results, name,
                    lambda kern=kern, layout=layout: layout(kern, items),
                    lambda plain=plain, layout=layout: layout(plain, items),
                    lambda: sdpa(qs, kdc, vdc, attn_mask=mask_t,
                                 enable_gqa=True),
                    nbytes, 0, 2 * flops,
                    errs["paged" if layout is paged else "contig",
                         "packed"], f" ({len(tiles)} selected tiles)")


def quant_decode_bytes(items, table, mask, ntiles, with_table: bool,
                       sh: Shapes):
    """Bytes of a codes-and-scales decode: q (float32, as the kernel reads
    it), the kept K/V rows (:func:`kept_rows`) at one byte a code, the two
    float32 scales of each of the ``ntiles`` selected tiles, the item table
    (and block table), positions, and the f32 (out, m, l)."""
    return (B * sh.H * sh.D * 4 + 2 * (kept_rows(mask, sh) * sh.D + ntiles * 4)
            + items.numel() * 4 + (table.numel() * 4 if with_table else 0)
            + B * 4 + B * sh.H * (sh.D + 2) * 4)


def check_quant_prefill(eng, gen, dev, results, sh: Shapes):
    """#2 paged over int8 / fp8 code pools with per-block scales: a
    256-token chunk at q_offset 0 and 2048 against the plain version (bf16
    q), timed at 2048 beside its bound and SDPA on the dequantized K/V."""
    import torch
    from repro_torch.kernels.sparse_prefill import (
        sparse_prefill_paged, worklist_attention_paged)
    C, prompt = 256, 2304
    T = SMAX // BLK
    N = T + 1
    table = random_table(gen, 1, [prompt // BLK], N - 1, T)[0].to(dev)
    shape = (N, sh.HKV, BLK, sh.D)
    mag = 0.25 + 0.75 * torch.rand((N, sh.HKV, 1, 1), generator=gen)
    kf = (torch.randn(shape, generator=gen) * mag).to(dev, torch.bfloat16)
    vf = (torch.randn(shape, generator=gen) * mag).to(dev, torch.bfloat16)
    q = torch.randn((sh.H, C, sh.D), generator=gen).to(dev, torch.bfloat16)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for kind in QUANT_KINDS:
        name = form("sparse_prefill_paged", kind, sh)
        kc, ks, kdq = quant_pool(kf, kind)
        vc, vs, vdq = quant_pool(vf, kind)
        errs, timed = {}, {}
        for q_offset in (0, 2048):
            items = eng._chunk_worklists(prompt, q_offset, C)[0].contiguous()
            kw = dict(block_q=BLK, block_kv=BLK, q_offset=q_offset,
                      kv_len=q_offset + C, k_scales=ks, v_scales=vs)
            timed[q_offset] = (items, kw)
            errs[q_offset] = check(
                name, f"q_offset={q_offset}",
                sparse_prefill_paged(q, kc, vc, items, table, **kw),
                worklist_attention_paged(q, kc, vc, items, table, **kw),
                BF16_ATOL)
        items, kw = timed[2048]
        mask, tiles, nvalid = prefill_mask(items, table, 2048, C, 2048 + C,
                                           T, sh)
        mask_t = torch.from_numpy(mask[None]).to(dev)
        kdc = slot_rows(kdq, table[None])[0]
        vdc = slot_rows(vdq, table[None])[0]
        flops = 2 * sh.D * int(mask.sum())
        nbytes = (2 * q.numel() * 2 + len(tiles) * 2 * (BLK * sh.D + 4)
                  + items.numel() * 4 + table.numel() * 4)
        measure(results, name,
                lambda: sparse_prefill_paged(q, kc, vc, items, table, **kw),
                lambda: worklist_attention_paged(q, kc, vc, items, table,
                                                 **kw),
                lambda: sdpa(q[None], kdc[None], vdc[None],
                             attn_mask=mask_t, enable_gqa=True),
                nbytes, 2 * flops, 0, errs[2048],
                f" (chunk {C} at q_offset 2048, {nvalid} tiles)")


def check_flash_attention(gen, dev, results, sh: Shapes):
    """The dense flash attention (#4) at the model's heads over its KV
    heads: causal and not at Sq = Skv = 4096, and a ragged causal case
    with Sq != Skv."""
    import torch
    from repro_torch.kernels.flash_attn import (
        flash_attention, flash_attention_reference)
    name = form("flash_attention", None, sh)
    errs = {}
    for tag, causal, sq, skv in FLASH_CASES:
        q = torch.randn((sh.H, sq, sh.D), generator=gen).to(dev)
        k = torch.randn((sh.HKV, skv, sh.D), generator=gen).to(dev)
        v = torch.randn((sh.HKV, skv, sh.D), generator=gen).to(dev)
        for dtype, atol in ((torch.bfloat16, BF16_ATOL),
                            (torch.float32, F32_ATOL)):
            args = [t.to(dtype) for t in (q, k, v)]
            errs[tag, dtype] = check(
                name, f"{tag},{str(dtype)[6:]}",
                flash_attention(*args, causal=causal),
                flash_attention_reference(*args, causal=causal), atol)
    tag, _, S, _ = FLASH_CASES[0]
    q, k, v = (torch.randn(s, generator=gen).to(dev, torch.bfloat16)
               for s in ((sh.H, S, sh.D), (sh.HKV, S, sh.D),
                         (sh.HKV, S, sh.D)))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    pairs = sh.H * S * (S + 1) // 2                      # causal, unmasked
    measure(results, name,
            lambda: flash_attention(q, k, v, causal=True),
            lambda: flash_attention_reference(q, k, v, causal=True),
            lambda: sdpa(q[None], k[None], v[None], is_causal=True,
                         enable_gqa=True),
            (2 * q.numel() + k.numel() + v.numel()) * 2, 4 * sh.D * pairs, 0,
            errs[tag, torch.bfloat16], f" ({tag})")


def legacy_case(eng, gen, dev, sh: Shapes, cache_len=4000):
    """The legacy decode's full-width work: 8 rows, one static cache
    length, each (row, kv head) the engine's layer-0 selection."""
    import torch
    from repro_torch.kernels.sparse_decode import build_decode_worklist
    q, kc, vc = (torch.randn(s, generator=gen).to(dev, torch.bfloat16)
                 for s in ((B, sh.HKV, sh.G, sh.D), (B, sh.HKV, SMAX, sh.D),
                           (B, sh.HKV, SMAX, sh.D)))
    ids = eng.decode_block_ids(cache_len)[0]             # [Hkv, nb]
    sels = [[ids[h][ids[h] >= 0] for h in range(sh.HKV)] for _ in range(B)]
    items = torch.from_numpy(build_decode_worklist(
        sels, num_devices=1, kv_heads_per_device=sh.HKV,
        block=BLK).items[0])
    return q, kc, vc, items.to(dev), cache_len


def check_sparse_decode(eng, gen, dev, results, sh: Shapes):
    """The legacy budgeted decode (#5) at full width, bf16 and f32, each
    against its plain version, repeated bit for bit and timed (the f32
    form printed only)."""
    import torch
    from repro_torch.kernels.sparse_decode import (
        sparse_decode_attention, sparse_decode_reference)
    name = form("sparse_decode", None, sh)
    q, kc, vc, items, cache_len = legacy_case(eng, gen, dev, sh)
    errs = {}
    for dtype, atol in ((torch.bfloat16, BF16_ATOL),
                        (torch.float32, F32_ATOL)):
        args = [t.to(dtype) for t in (q, kc, vc)]
        errs[dtype] = check(
            name, str(dtype)[6:],
            sparse_decode_attention(*args, items, cache_len=cache_len),
            sparse_decode_reference(*args, items, cache_len=cache_len), atol)
        split_report(f"{name}[{str(dtype)[6:]}]",
                     lambda: sparse_decode_attention(*args, items,
                                                     cache_len=cache_len),
                     items, legacy=True)
    pos = torch.full((B,), cache_len - 1, dtype=torch.int32)
    ident = torch.arange(SMAX // BLK, dtype=torch.int32).expand(B, -1)
    mask, _ = decode_mask(items, ident, pos, sh)
    mask_t = torch.from_numpy(mask).to(dev)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qs = q.reshape(B, sh.H, 1, sh.D)
    flops = 2 * sh.D * int(mask.sum())
    # bytes: q, the K/V rows of the selected keys below cache_len (the
    # kernel neither copies nor reads the rest of a tile; the mask repeats
    # each (row, kv head)'s keys for its G query rows), the items, out in
    # q's dtype
    keys = int(mask.sum()) // sh.G
    nbytes = (2 * q.numel() * 2 + keys * 2 * sh.D * 2 + items.numel() * 4)
    measure(results, name,
            lambda: sparse_decode_attention(q, kc, vc, items,
                                            cache_len=cache_len),
            lambda: sparse_decode_reference(q, kc, vc, items,
                                            cache_len=cache_len),
            lambda: sdpa(qs, kc, vc, attn_mask=mask_t, enable_gqa=True),
            nbytes, flops, flops, errs[torch.bfloat16])
    # the f32 form, timed and printed only (the library path runs bf16):
    # twice the bytes, both products at the f32 rate
    f32 = [t.float() for t in (q, kc, vc)]
    measure({}, f"{name}[f32]",
            lambda: sparse_decode_attention(*f32, items, cache_len=cache_len),
            lambda: sparse_decode_reference(*f32, items, cache_len=cache_len),
            lambda: sdpa(f32[0].reshape(qs.shape), f32[1], f32[2],
                         attn_mask=mask_t, enable_gqa=True),
            2 * nbytes - items.numel() * 4, 0, 2 * flops,
            errs[torch.float32])


def run_library_path(eng, gen, dev, sh: Shapes):
    """The dense and legacy kernels run only behind the library entry
    points: drive each once at full width and count the launches."""
    import torch
    from repro_torch.kernels import ops
    q, k, v = (torch.randn(s, generator=gen).to(dev, torch.bfloat16)
               for s in ((sh.H, SMAX, sh.D), (sh.HKV, SMAX, sh.D),
                         (sh.HKV, SMAX, sh.D)))
    lq, lk, lv, items, cache_len = legacy_case(eng, gen, dev, sh)
    reset_counts()
    out = ops.flash_attention(q, k, v, causal=True)
    dec = ops.sparse_decode(lq, lk, lv, items, cache_len=cache_len)
    torch.cuda.synchronize()
    names = [form(n, None, sh) for n in ("flash_attention", "sparse_decode")]
    launches = read_counts(names)
    ok = (tuple(out.shape) == (sh.H, SMAX, sh.D)
          and bool(out.isfinite().all()) and bool(dec.isfinite().all()))
    print(f"library path{sh.tag}: ops.flash_attention + ops.sparse_decode, "
          f"launches {launches}, outputs {'finite' if ok else 'BAD'}")
    if not ok or not all(launches.values()):
        fail(f"a library kernel did not run: {launches}")
    return launches


def check_kernels(eng, gen, dev, results, sh: Shapes, dtypes):
    """Phases 3 and 4 at ``sh``'s shapes: every kernel form against its
    plain version, timed; the decode and prefill forms of ``dtypes``
    timed (bf16 and, with float32, the f32 forms).  Returns the library
    path's launches."""
    import torch
    t0 = time.time()
    check_decode(eng, gen, dev, results, sh, dtypes)
    check_prefill(eng, gen, dev, results, sh, dtypes)
    check_quant_decode(eng, gen, dev, results, sh)
    check_quant_prefill(eng, gen, dev, results, sh)
    check_flash_attention(gen, dev, results, sh)
    check_sparse_decode(eng, gen, dev, results, sh)
    print(f"kernel checks ({sh.arch}): {time.time() - t0:.1f} s")
    launches = run_library_path(eng, gen, dev, sh)
    torch.cuda.empty_cache()
    return launches


def build_engine(cfg, params, dev, profile=None, injector=None, **kw):
    """A full-width engine: ``EngineConfig()`` with 8 slots of 4096 tokens
    and the options ``kw``, planned from ``profile`` (default the synthetic
    curves), with the fault injector ``injector`` (default none)."""
    from repro_torch.core.sparsity import synthetic_head_curves
    from repro_torch.serving import Engine, EngineConfig
    kw = {"max_seq_len": SMAX, "num_slots": B, **kw}
    return Engine(cfg, params, EngineConfig(**kw),
                  profile or synthetic_head_curves(cfg.num_layers,
                                                   cfg.num_heads),
                  device=dev, injector=injector)


def cut_depth(cfg, params, arch: str):
    """The model cut to its first ``CUT_LAYERS[arch]`` layers: the config
    and the params (the same tensors, not copied)."""
    n = CUT_LAYERS[arch]
    print(f"{cfg.name}: depth cut to {n} of {cfg.num_layers} layers")
    return (dataclasses.replace(cfg, num_layers=n),
            dict(params, layers=params["layers"][:n]))


def serve_kernels(ecfg) -> tuple[str, str]:
    """The decode and prefill kernel forms a serve of ``ecfg`` runs: its
    layout's (and KV dtype's) decode, and its chunk prefill, or in
    monolithic mode the contiguous sparse prefill over the sequence's own
    K/V (sparse) or the dense flash attention (dense)."""
    decode, chunk = SERVE_KERNELS[ecfg.cache_layout, ecfg.kv_dtype]
    if ecfg.prefill_mode == "chunked":
        return decode, chunk
    return decode, ("sparse_prefill_contig" if ecfg.attention == "sparse"
                    else "flash_attention")


def run_serve(eng, prompts, tag, sh: Shapes, also=(), sampling=None):
    """Serve ``prompts`` (32 tokens each, greedy unless ``sampling``);
    check completion, the launches of the serve's kernels
    (:func:`serve_kernels`) and the block accounting.  Returns the tokens
    and the launch counts, with those of the forms ``also`` (read, not
    required)."""
    import numpy as np
    import torch
    from repro_torch.launch.serve import bubble_line
    from repro_torch.serving import SamplingParams
    sp = sampling or SamplingParams(max_tokens=32)
    names = [n + sh.tag for n in serve_kernels(eng.ecfg)]
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.time()
    done = eng.serve(prompts, sp)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = read_counts(names)
    ok = [r for r in done if r.done and not r.rejected
          and len(r.generated) == sp.max_tokens
          and all(0 <= t < eng.cfg.vocab_size for t in r.generated)]
    ttft = [r.ttft for r in done]
    itl = [x for r in done for x in r.itl]
    st, bs = eng.decode_stats, eng._batcher.stats
    tag = f"{sh.arch}:{tag}" if sh.tag else tag
    print(f"serve[{tag}]: {len(ok)}/{len(prompts)} requests complete in "
          f"{wall:.2f} s; TTFT mean {np.mean(ttft):.3f} s max "
          f"{np.max(ttft):.3f} s (host clock, queueing included); ITL mean "
          f"{1e3 * np.mean(itl):.2f} ms; "
          f"{sum(len(r.generated) for r in done) / wall:.1f} tokens/s over "
          f"the whole serve; decode grid {st['real_items']} real / "
          f"{st['grid_items']} items over {st['ticks']} ticks")
    print(f"serve[{tag}]: D={eng.ecfg.num_model_shards}, "
          f"{bubble_line(eng.decode_bubble_stats)}")
    print(f"serve[{tag}]: launches {launches}: {bs.prefill_chunks} prefill "
          f"{'chunks' if eng.ecfg.prefill_mode == 'chunked' else 'prompts'}, "
          f"{bs.decode_steps} decode ticks; KV cache "
          f"{eng.ecfg.kv_dtype}, {eng.kv_bytes()} bytes resident")
    alloc = eng._batcher.alloc
    fails = eng.kv.audit(strict=False) if eng.paged else alloc.audit(False)
    print(f"serve[{tag}]: block audit {'clean' if not fails else fails}, "
          f"{alloc.allocated_blocks} blocks still mapped")
    if len(ok) != len(prompts):
        fail(f"{tag}: not every request completed with 32 in-vocab tokens")
    if not all(launches.values()):
        fail(f"{tag}: a kernel of the path never launched: {launches}")
    if fails or alloc.allocated_blocks:
        fail(f"{tag}: block audit failed: {fails}")
    others = read_counts(also)
    if others:
        print(f"serve[{tag}]: launches of other forms {others}")
    return [r.generated for r in done], {**launches, **others}


def serve_prompts(cfg):
    import numpy as np
    rng = np.random.default_rng(0)
    # 1010 + 32 crosses the 1024 block boundary during decode
    prompts = [rng.integers(0, cfg.vocab_size, size=n) for n in SERVE_LENS]
    print(f"serve prompts ({cfg.name}): lens {list(SERVE_LENS)}")
    return prompts


def run_serves(cfg, params, dev):
    """SmolLM-135M's four full-width serves (all must give the default's
    tokens), then its quantized serves.  Returns the launches and the
    tokens of the bf16 serves by (layout, worklist) tag.  The default
    serve's sampled logits are kept in ``DEFAULT_LOGITS``: the unstriped
    twin of phase 12's first striped serve."""
    prompts = serve_prompts(cfg)
    tokens, launches = {}, {}
    for layout, worklist in SERVES:
        tag = f"{layout},{worklist}"
        eng = build_engine(cfg, params, dev, cache_layout=layout,
                           decode_worklist=worklist)
        record = (sampled_logits(DEFAULT_LOGITS.setdefault(
            (cfg.name, cfg.num_layers), []))
                  if tag == "paged,packed" else contextlib.nullcontext())
        with record:
            tokens[tag], got = run_serve(eng, prompts, tag, SMOL)
        if worklist == "packed":
            launches.update(got)          # the packed serves' counts
        del eng
    base = tokens["paged,packed"]
    for tag, toks in tokens.items():
        same = toks == base
        print(f"serve[{tag}]: greedy tokens {'==' if same else '!='} "
              f"paged,packed")
        if not same:
            fail(f"{tag} tokens differ from the paged packed serve")
    # the quantized KV cache: tokens differ from bf16's by design (and
    # between the layouts: the paged pool quantizes each chunk as it lands,
    # the contiguous one its staging row once); the first CUT_LAYERS layers
    qcfg, qparams = cut_depth(cfg, params, cfg.name)
    for kind in QUANT_KINDS:
        for layout in ("paged", "contiguous"):
            eng = build_engine(qcfg, qparams, dev, cache_layout=layout,
                               kv_dtype=kind)
            _, got = run_serve(eng, prompts, f"{layout},packed,{kind}", SMOL)
            launches.update({n: c for n, c in got.items() if "." in n})
            del eng
    return launches, tokens


def run_full_serves(cfg, params, dev, sh: Shapes):
    """A model's full-width serves (``FULL_SERVES``, packed decode): the
    contiguous bf16 serve must give the paged one's tokens, and the code
    serves (at ``CUT_LAYERS``) complete every request through the code
    forms.  The int8
    serve also reads the bf16-q fp8 prefill's count, which no serve here
    launches (the kernels line's launches are all from serves).  Returns
    the launches and the tokens by (layout, KV dtype)."""
    import torch
    prompts = serve_prompts(cfg)
    tokens, launches = {}, {}
    for layout, kind in FULL_SERVES:
        tag = f"{layout},packed,{kind}"
        model = (cfg, params) if kind == "bf16" else cut_depth(cfg, params,
                                                               sh.arch)
        eng = build_engine(*model, dev, cache_layout=layout, kv_dtype=kind)
        also = ([form("sparse_prefill_paged", "fp8", sh)]
                if kind == "int8" else [])
        tokens[layout, kind], got = run_serve(eng, prompts, tag, sh, also)
        launches.update(got)
        del eng
        torch.cuda.empty_cache()
    same = tokens["contiguous", "bf16"] == tokens["paged", "bf16"]
    print(f"serve[{sh.arch}:contiguous,packed,bf16]: greedy tokens "
          f"{'==' if same else '!='} paged,packed,bf16")
    if not same:
        fail(f"{sh.arch}: the contiguous tokens differ from the paged "
             f"serve's")
    return launches, tokens


def check_sharded_decode(eng, gen, dev, sh: Shapes):
    """#1 and #3 on the layer-0 packed table of an engine at D shards: the
    shards' lists end to end, each padded to the bucket, so pad rows lie
    between one shard's last run and the next shard's first.  In bf16 and
    f32, each against its plain version (``F32_ATOL``), paged == contiguous
    and launch == launch bit for bit."""
    import numpy as np
    import torch
    from repro_torch.core.worklist import D_VALID
    from repro_torch.kernels.flash_decode import (
        flash_decode_kernel, flash_decode_paged_kernel,
        packed_decode_attention, packed_decode_attention_paged)
    d = eng.ecfg.num_model_shards
    pos, table, items, _, _, kf, vf, qf = decode_case(eng, gen, dev, sh)
    valid = items[:, D_VALID].cpu().numpy()
    per = items.shape[0] // d
    inner = int((valid[:np.flatnonzero(valid)[-1]] == 0).sum())
    print(f"decode{sh.tag}[D={d}]: {items.shape[0]} items = {d} shards x "
          f"bucket {per}; real items a shard "
          f"{[int(valid[i * per:(i + 1) * per].sum()) for i in range(d)]}; "
          f"{inner} pad rows between shard lists")
    if not inner:
        fail(f"{sh.arch}: the D={d} table holds no pad between shards")
    for dtype in (torch.bfloat16, torch.float32):
        kind = None if dtype == torch.bfloat16 else "f32"
        q, kp, vp = (t.to(dtype) for t in (qf, kf, vf))
        kc, vc = slot_rows(kp, table), slot_rows(vp, table)
        paged = lambda: flash_decode_paged_kernel(  # noqa: E731
            q, kp, vp, items, table, pos, block_kv=BLK)
        contig = lambda: flash_decode_kernel(  # noqa: E731
            q, kc, vc, items, pos, block_kv=BLK)
        tag = f"D={d}{',' + kind if kind else ''}"
        pname = form("flash_decode_paged", kind, sh)
        cname = form("flash_decode_contig", kind, sh)
        got = paged()
        check(pname, tag, got, packed_decode_attention_paged(
            q, kp, vp, items, table, pos, block_kv=BLK), F32_ATOL)
        check(cname, tag, contig(), packed_decode_attention(
            q, kc, vc, items, pos, block_kv=BLK), F32_ATOL)
        same = all(torch.equal(a, b) for a, b in zip(got, contig()))
        print(f"decode{sh.tag}[{tag}]: contiguous {'==' if same else '!='} "
              f"paged, bit for bit")
        if not same:
            fail(f"the contiguous and paged decode kernels differ on the "
                 f"D={d} table ({sh.arch}, {tag})")
        split_report(f"{pname}[{tag}]", paged, items)
        split_report(f"{cname}[{tag}]", contig, items)


def run_sharded_serves(cfg, params, dev, sh: Shapes):
    """The model's full-width serves at each head-parallel degree of
    ``SHARDED_SERVES`` (bf16, 8 prompts, 32 greedy tokens; the first
    ``CUT_LAYERS`` layers): every request
    completes through the path's kernels, and the serves of one degree
    give equal tokens (a split is a position in its run, so the decode
    grid and the layout change no bit).  Each prints its bubble stats,
    beside the same model's D = 1 serve."""
    import torch
    prompts = serve_prompts(cfg)
    cfg, params = cut_depth(cfg, params, sh.arch)
    for d, serves in SHARDED_SERVES[sh.arch]:
        tokens = {}
        for layout, worklist in serves:
            eng = build_engine(cfg, params, dev, cache_layout=layout,
                               decode_worklist=worklist, num_model_shards=d)
            tokens[layout, worklist], _ = run_serve(
                eng, prompts, f"{layout},{worklist},D={d}", sh)
            del eng
            torch.cuda.empty_cache()
        (base, want), *rest = tokens.items()
        for key, got in rest:
            same = got == want
            print(f"serve[{sh.arch}:{','.join(key)},D={d}]: greedy tokens "
                  f"{'==' if same else '!='} {','.join(base)},D={d}")
            if not same:
                fail(f"{sh.arch} at D={d}: the {','.join(key)} tokens "
                     f"differ from the {','.join(base)} serve's")


def window_pairs(sq: int, skv: int, q_offset: int, kv_len: int,
                 window: int | None):
    """Boolean ``[sq, skv]`` mask of the (query, key) pairs a causal dense
    prefill keeps: queries at ``q_offset + i``, keys below ``kv_len`` and,
    with ``window``, past ``qpos - window``."""
    import torch
    qpos = q_offset + torch.arange(sq)[:, None]
    kpos = torch.arange(skv)[None, :]
    keep = (kpos <= qpos) & (kpos < kv_len)
    if window is not None:
        keep &= kpos > qpos - window
    return keep


def check_baselines(gen, dev, sh: Shapes, results=None,
                    window: int | None = None):
    """Phase 9's kernel checks at ``sh``'s shapes (printed; with
    ``window``, the window forms' numbers also go to ``results`` for the
    kernels line): #4 causal at the dense monolithic prefill's buckets
    (``FLASH_BUCKETS``), bf16 and f32 against its plain version, the bf16
    form timed beside its bound and SDPA at each; #2 paged and contiguous
    over a dense chunk's causal list (256 rows at q_offset 2048, 200 of
    them real), bf16 and f32 (with ``window``, the int8 / fp8 code forms
    of #2 paged too), the layouts bit for bit; #1 and #3 over dense
    decode's table (8 rows at ``SERVE_LENS`` + 16, every resident block),
    bf16 and int8 codes, the layouts bit for bit.  ``window`` (a
    sliding-window model's, as its 'L' layers pass it) runs every kernel
    in its window form, SDPA under the windowed boolean mask and the bound
    over the pairs inside the window."""
    import numpy as np
    import torch
    from repro_torch.kernels.flash_attn import (
        flash_attention, flash_attention_reference)
    from repro_torch.kernels.flash_decode import (
        flash_decode_kernel, flash_decode_paged_kernel,
        packed_decode_attention, packed_decode_attention_paged)
    from repro_torch.kernels.sparse_prefill import (
        sparse_prefill_attention, sparse_prefill_paged, worklist_attention,
        worklist_attention_paged)
    from repro_torch.models.transformer import (
        dense_chunk_items, dense_decode_items)
    t0 = time.time()
    wkind = None if window is None else "window"
    wtag = "" if window is None else f",window {window}"
    results = {} if results is None else results
    sdpa = torch.nn.functional.scaled_dot_product_attention
    name = form("flash_attention", wkind, sh)
    for S in FLASH_BUCKETS:
        q, k, v = (torch.randn(s, generator=gen).to(dev) for s in (
            (sh.H, S, sh.D), (sh.HKV, S, sh.D), (sh.HKV, S, sh.D)))
        errs = {}
        for dtype, atol in ((torch.bfloat16, BF16_ATOL),
                            (torch.float32, F32_ATOL)):
            args = [t.to(dtype) for t in (q, k, v)]
            errs[dtype] = check(
                name, f"causal,{S},{str(dtype)[6:]}{wtag}",
                flash_attention(*args, causal=True, window=window),
                flash_attention_reference(*args, causal=True, window=window),
                atol)
        q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
        keep = window_pairs(S, S, 0, S, window)
        mask = keep.to(dev) if window is not None else None
        measure(results if S == FLASH_BUCKETS[-1] and window else {},
                f"{name}[causal,{S}]",
                lambda: flash_attention(q, k, v, causal=True, window=window),
                lambda: flash_attention_reference(q, k, v, causal=True,
                                                  window=window),
                lambda: sdpa(q[None], k[None], v[None], attn_mask=mask,
                             is_causal=mask is None, enable_gqa=True),
                (2 * q.numel() + k.numel() + v.numel()) * 2,
                4 * sh.D * sh.H * int(keep.sum()), 0, errs[torch.bfloat16])
    if window is not None:
        results[name] = results.pop(f"{name}[causal,{FLASH_BUCKETS[-1]}]")

    C, q_off, real = 256, 2048, 200
    T = SMAX // BLK
    N = T + 1
    table = random_table(gen, 1, [(q_off + C) // BLK], N - 1, T)[0].to(dev)
    kp, vp = (torch.randn((N, sh.HKV, BLK, sh.D), generator=gen).to(dev)
              for _ in range(2))
    kc, vc = slot_rows(kp, table[None])[0], slot_rows(vp, table[None])[0]
    q = torch.randn((sh.H, C, sh.D), generator=gen).to(dev)
    items = torch.from_numpy(dense_chunk_items(
        sh.H, sh.G, block_q=BLK, block_kv=BLK, q_offset=q_off,
        q_blocks=-(-real // BLK))).to(dev)
    kw = dict(block_q=BLK, block_kv=BLK, q_offset=q_off, kv_len=q_off + real,
              window=window)
    pname = form("sparse_prefill_paged", wkind, sh)
    cname = form("sparse_prefill_contig", wkind, sh)
    errs = {}
    for dtype, atol in ((torch.bfloat16, BF16_ATOL),
                        (torch.float32, F32_ATOL)):
        tag = f"dense chunk,{str(dtype)[6:]}{wtag}"
        qd, pk, pv, ck, cv = (t.to(dtype) for t in (q, kp, vp, kc, vc))
        got_p = sparse_prefill_paged(qd, pk, pv, items, table, **kw)
        errs["paged", dtype] = check(
            pname, tag, got_p,
            worklist_attention_paged(qd, pk, pv, items, table, **kw), atol)
        got_c = sparse_prefill_attention(qd, ck, cv, items, **kw)
        errs["contig", dtype] = check(
            cname, tag, got_c, worklist_attention(qd, ck, cv, items, **kw),
            atol)
        if not torch.equal(got_p, got_c):
            fail(f"the prefill layouts differ on a dense chunk ({sh.arch}, "
                 f"{tag})")
    qb, pk, pv, ck, cv = (t.to(torch.bfloat16) for t in (q, kp, vp, kc, vc))
    if window is not None:
        for kind in QUANT_KINDS:
            codes_k, ks, _ = quant_pool(pk, kind)
            codes_v, vs, _ = quant_pool(pv, kind)
            ckw = dict(kw, k_scales=ks, v_scales=vs)
            check(form("sparse_prefill_paged", kind, sh),
                  f"dense chunk,{kind}{wtag}",
                  sparse_prefill_paged(qb, codes_k, codes_v, items, table,
                                       **ckw),
                  worklist_attention_paged(qb, codes_k, codes_v, items,
                                           table, **ckw), BF16_ATOL)
        # the bound and SDPA over the pairs the chunk's real rows keep
        keep = window_pairs(C, T * BLK, q_off, q_off + real, window)
        keep[real:] = False
        tiles = int(keep.reshape(C, T, BLK).any(dim=(0, 2)).sum())
        mask = keep.to(dev)[None]
        nbytes = (2 * qb.numel() * 2 + tiles * sh.HKV * 2 * BLK * sh.D * 2
                  + items.numel() * 4)
        flops = 4 * sh.D * sh.H * int(keep.sum())
        note = f" (dense chunk {C} at q_offset {q_off}, {real} real{wtag})"
        measure(results, pname,
                lambda: sparse_prefill_paged(qb, pk, pv, items, table, **kw),
                lambda: worklist_attention_paged(qb, pk, pv, items, table,
                                                 **kw),
                lambda: sdpa(qb[None], ck[None], cv[None], attn_mask=mask,
                             enable_gqa=True),
                nbytes + table.numel() * 4, flops, 0,
                errs["paged", torch.bfloat16], note)
        measure(results, cname,
                lambda: sparse_prefill_attention(qb, ck, cv, items, **kw),
                lambda: worklist_attention(qb, ck, cv, items, **kw),
                lambda: sdpa(qb[None], ck[None], cv[None], attn_mask=mask,
                             enable_gqa=True),
                nbytes, flops, 0, errs["contig", torch.bfloat16], note)
    ms = time_ms(lambda: sparse_prefill_paged(qb, pk, pv, items, table, **kw),
                 graph=True)
    print(f"{pname}[dense chunk{wtag}]: {items.shape[0]} items, longest run "
          f"{max(run_lengths(items))} tiles, contiguous == paged bit for "
          f"bit, kernel {ms:.4f} ms")

    pos_np = np.array(SERVE_LENS, np.int32) + 16
    act = np.ones(B, bool)
    table = random_table(gen, B, pos_np // BLK + 1, B * T, T).to(dev)
    items = torch.from_numpy(dense_decode_items(pos_np, act, sh.HKV,
                                                BLK)).to(dev)
    pos = torch.from_numpy(pos_np).to(dev)
    shape = (B * T + 1, sh.HKV, BLK, sh.D)
    kf, vf = (torch.randn(shape, generator=gen).to(dev, torch.bfloat16)
              for _ in range(2))
    q = torch.randn((B, sh.HKV, sh.G, sh.D), generator=gen).to(
        dev, torch.bfloat16)
    for kind in (None, "int8"):
        if kind is None:
            kp, vp, sc = kf, vf, {}
            ck, cv, csc = slot_rows(kf, table), slot_rows(vf, table), {}
        else:
            kp, ks, _ = quant_pool(kf, kind)
            vp, vs, _ = quant_pool(vf, kind)
            sc = dict(k_scales=ks, v_scales=vs)
            ck, cv = (slot_rows(t.view(torch.int8), table).view(t.dtype)
                      for t in (kp, vp))
            csc = dict(k_scales=slot_scales(ks, table),
                       v_scales=slot_scales(vs, table))
        tag = f"dense decode{',' + kind if kind else ''}{wtag}"
        dkw = dict(block_kv=BLK, window=window)
        got_p = flash_decode_paged_kernel(q, kp, vp, items, table, pos,
                                          **dkw, **sc)
        check(form("flash_decode_paged", kind, sh), tag, got_p,
              packed_decode_attention_paged(q, kp, vp, items, table, pos,
                                            **dkw, **sc), F32_ATOL)
        got_c = flash_decode_kernel(q, ck, cv, items, pos, **dkw, **csc)
        check(form("flash_decode_contig", kind, sh), tag, got_c,
              packed_decode_attention(q, ck, cv, items, pos, **dkw, **csc),
              F32_ATOL)
        if not all(torch.equal(a, b) for a, b in zip(got_p, got_c)):
            fail(f"the decode layouts differ on dense decode's table "
                 f"({sh.arch}, {tag})")
        ms = time_ms(lambda: flash_decode_paged_kernel(
            q, kp, vp, items, table, pos, **dkw, **sc), graph=True)
        print(f"{form('flash_decode_paged', kind, sh)}[{tag}]: "
              f"{items.shape[0]} items ({int(items[:, 5].sum())} valid), "
              f"contiguous == paged bit for bit, kernel {ms:.4f} ms")
    print(f"baseline kernel checks ({sh.arch}): {time.time() - t0:.1f} s")


def run_baseline_serves(cfg, params, dev, sh: Shapes, chunked):
    """Phase 9's full-width serves of the paper's baselines
    (``BASELINE_SERVES``, 8 prompts, 32 greedy tokens; the marked ones at
    ``CUT_LAYERS``, compared only with serves of their depth): each completes
    every request through its path's kernels (dense monolithic: #4 on the
    prompt bucket; on a sliding-window model each dense serve also through
    its prefill kernel's window form).  The dense paged and contiguous
    serves give equal tokens, and each sparse monolithic serve the tokens
    of the chunked serve of its layout (``chunked``: tokens by layout); the
    dense serves' other pairs are reported.  Returns the #4 launches of the
    first and each window form's launches of the first serve running it."""
    import torch
    prompts = serve_prompts(cfg)
    fa = form("flash_attention", None, sh)
    windowed = "L" in cfg.attn_pattern
    tokens, launches, depth, cut = {}, {}, {}, None
    for tag, short, options in BASELINE_SERVES[sh.arch]:
        if short:
            cut = cut or cut_depth(cfg, params, sh.arch)
        model = cut if short else (cfg, params)
        depth[tag] = model[0].num_layers
        eng = build_engine(*model, dev, **options)
        wins = ([form(serve_kernels(eng.ecfg)[1], "window", sh)]
                if windowed and not eng.sparse else [])
        tokens[tag], got = run_serve(eng, prompts, tag, sh, also=[fa, *wins])
        if not all(got[w] for w in wins):
            fail(f"{sh.arch}:{tag}: a window form never launched: {got}")
        for n in (fa, *wins):
            launches.setdefault(n, got[n])
        del eng
        torch.cuda.empty_cache()

    def same(tag, want, other, required):
        eq = tokens[tag] == want
        print(f"serve[{sh.arch}:{tag}]: greedy tokens {'==' if eq else '!='} "
              f"{other}{'' if required else ' (reported)'}")
        if required and not eq:
            fail(f"{sh.arch}: the {tag} tokens differ from {other}'s")

    for tag, _, options in BASELINE_SERVES[sh.arch]:
        layout = options.get("cache_layout", "paged")
        if options.get("attention") != "dense":
            same(tag, chunked[layout], f"the chunked {layout} serve", True)
    for tag, base, required in (
            ("dense,monolithic,contiguous", "dense,monolithic,paged", True),
            ("dense,monolithic,exact,paged", "dense,monolithic,paged",
             False),
            ("dense,monolithic,paged", "sparse,monolithic,paged", False),
            ("dense,chunked,contiguous", "dense,chunked,paged", True),
            # #4 and #2 are different kernels: reported
            ("dense,chunked,paged", "dense,monolithic,paged", False)):
        if tag in tokens and base in tokens and depth[tag] == depth[base]:
            same(tag, tokens[base], base, required)
    return launches


def run_stochastic_serves(cfg, params, dev, sh: Shapes):
    """Phase 9's stochastic serve (``STOCHASTIC``, the engine's generator
    seeded 0) of the serve prompts of at most 1010 tokens, twice: it must
    repeat itself token for token."""
    import torch
    from repro_torch.serving import SamplingParams
    prompts = [p for p in serve_prompts(cfg) if len(p) <= 1010]
    sp = SamplingParams(max_tokens=32, **STOCHASTIC)
    runs = []
    for i in range(2):
        eng = build_engine(cfg, params, dev, seed=0)
        runs.append(run_serve(eng, prompts, f"paged,packed,sampled,run {i}",
                              sh, sampling=sp)[0])
        del eng
        torch.cuda.empty_cache()
    eq = runs[0] == runs[1]
    print(f"serve[sampled {STOCHASTIC}]: seed 0 twice, tokens "
          f"{'==' if eq else '!='}")
    if not eq:
        fail("the seeded stochastic serve did not repeat itself")


def to_device(tree, dev):
    """A params tree (dicts, lists of tensors) with every tensor copied to
    ``dev``: the same weights on the card and on the CPU."""
    if isinstance(tree, dict):
        return {k: to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_device(v, dev) for v in tree]
    return tree.to(dev)


@contextlib.contextmanager
def sampled_logits(record: list, forced: list | None = None):
    """While the block runs, append the logits each model call's tokens are
    sampled from (float32, on the CPU) to ``record``.  With ``forced``
    (another serve's record), call i takes the greedy tokens of
    ``forced[i]`` instead of its own: the serve replays that serve's
    tokens."""
    from repro_torch.serving import engine as serving
    sample = serving.sample

    def recorded(logits, params, generator=None):
        tokens = sample(logits, params, generator)
        if forced is not None:
            tokens = forced[len(record)].argmax(-1).to(tokens)
        record.append(logits.float().cpu())
        return tokens

    serving.sample = recorded
    try:
        yield record
    finally:
        serving.sample = sample


@contextlib.contextmanager
def bf16_q_code_decodes():
    """The quantized parity's planted control: while the block runs, the
    decodes (#1 / #3, the code forms in a quantized serve) take q rounded
    to bf16, a fault of the size of reading q at the wrong precision."""
    import torch
    from repro_torch.kernels import ops
    names = ("flash_decode", "flash_decode_packed", "flash_decode_paged",
             "flash_decode_packed_paged")
    orig = {n: getattr(ops, n) for n in names}

    def rounded(fn):
        def call(q, *args, **kw):
            return fn(q.to(torch.bfloat16).to(q.dtype), *args, **kw)
        return call

    for n in names:
        setattr(ops, n, rounded(orig[n]))
    try:
        yield
    finally:
        for n, fn in orig.items():
            setattr(ops, n, fn)


@contextlib.contextmanager
def faulted_decode_call():
    """The max check's planted control: while the block runs, the first
    decode call (layer 0 of the first decode tick) returns its output with
    1.0 added to every row, a large fault confined to the few rows of one
    model call."""
    from repro_torch.kernels import ops
    names = ("flash_decode", "flash_decode_packed", "flash_decode_paged",
             "flash_decode_packed_paged")
    orig = {n: getattr(ops, n) for n in names}
    calls = []

    def faulted(fn):
        def call(*args, **kw):
            out = fn(*args, **kw)
            calls.append(None)
            return out + 1.0 if len(calls) == 1 else out
        return call

    for n in names:
        setattr(ops, n, faulted(orig[n]))
    try:
        yield
    finally:
        for n, fn in orig.items():
            setattr(ops, n, fn)


def forced_logit_diff(card, cpu, live=None) -> tuple[float, float, int]:
    """A teacher-forced serve's card-vs-CPU logit differences, each model
    call and row's largest: their median and maximum (NaN if any is NaN),
    and the rows whose greedy argmax differs (near-ties within them).
    ``live``: per model call, the rows a live request samples (None: every
    row), so the finished slots' rows of a decode call count nothing."""
    import torch
    if len(card) != len(cpu):
        fail(f"{len(card)} model calls on the card, {len(cpu)} on the CPU")
    live = live or [None] * len(card)
    pairs = [(a, b) if r is None else (a[r], b[r])
             for a, b, r in zip(card, cpu, live)]
    rows = torch.cat([(a - b).abs().amax(-1) for a, b in pairs])
    flips = sum(int((a.argmax(-1) != b.argmax(-1)).sum()) for a, b in pairs)
    return rows.median().item(), rows.max().item(), flips


def live_rows(eng, card: list) -> dict:
    """Record, by the index its logits take in ``card`` (a
    :func:`sampled_logits` record), each decode call's live rows: the
    slots of its requests."""
    rows, inner = {}, eng.decode_slots

    def decode(slots, *args, **kw):
        rows[len(card)] = list(slots)
        return inner(slots, *args, **kw)
    eng.decode_slots = decode
    return rows


def smoke_parity(cfg, dev, prompts, kinds, params, max_tokens, tag,
                 shards=1, layouts=("paged", "contiguous"), **options):
    """float32 serves of ``cfg`` on the card and on the CPU (plain
    versions), paged and contiguous, at each KV dtype of ``kinds``, with
    the card's weights ``params`` (copied to the CPU).  bf16 cache: the
    greedy tokens must be equal (sums in another order only).  int8 / fp8:
    the card replays the CPU's tokens (greedy tokens could part at a
    near-tie, as codes one step apart move the logits a little) and the
    logit differences of every model call must hold ``QUANT_MEDIAN_ATOL``
    and ``QUANT_LOGIT_ATOL``; then two planted controls, each a paged int8
    serve, must fail that check: q rounded to bf16 in the code decodes
    (:func:`bf16_q_code_decodes`, a fault on every call, for the median)
    and one decode call's output shifted by 1.0
    (:func:`faulted_decode_call`, a fault on a few rows, which the max
    must refuse).  ``shards``: the engines' head-parallel degree;
    ``layouts``: the cache layouts served; ``options``: further
    ``EngineConfig`` options of every serve."""
    import torch
    from repro_torch.core.sparsity import synthetic_head_curves
    from repro_torch.serving import Engine, EngineConfig, SamplingParams
    cpu = torch.device("cpu")
    cpu_params = to_device(params, cpu)
    med_atol = QUANT_MEDIAN_ATOL.get(cfg.name)

    def serve(d, layout, kind, forced=None):
        eng = Engine(cfg, params if d == dev else cpu_params,
                     EngineConfig(max_seq_len=1024, num_slots=4,
                                  budget_per_head=256, cache_layout=layout,
                                  kv_dtype=kind, num_model_shards=shards,
                                  **options),
                     synthetic_head_curves(cfg.num_layers, cfg.num_heads),
                     device=d)
        with sampled_logits([], forced) as rec:
            out = [r.generated for r in eng.serve(
                prompts, SamplingParams(max_tokens=max_tokens))]
        return out, rec

    def held(sub, card, rec) -> tuple[bool, bool]:
        """Whether the median and the max of the logit differences hold
        their limits."""
        med, worst, flips = forced_logit_diff(card, rec)
        ok = (med <= med_atol, worst <= QUANT_LOGIT_ATOL)
        print(f"{sub}: card replaying the CPU's tokens over {len(rec)} model "
              f"calls, logit difference median {med:.3e} (tolerance "
              f"{med_atol:g}), max {worst:.3e} (tolerance "
              f"{QUANT_LOGIT_ATOL:g}); greedy argmax differs in {flips} "
              f"rows: {'held' if all(ok) else 'NOT held'}")
        return ok

    records = {}
    for kind in kinds:
        for layout in layouts:
            sub = f"{tag} f32 serve[{layout},{kind}]"
            want, rec = records[layout, kind] = serve(cpu, layout, kind)
            if kind == "bf16":
                got, _ = serve(dev, layout, kind)
                same = got == want
                print(f"{sub}: card tokens {'==' if same else '!='} CPU "
                      f"plain-version tokens")
                if not same:
                    fail(f"{tag} {layout},{kind}: card {got} != cpu {want}")
                continue
            got, card = serve(dev, layout, kind, forced=rec)
            if got != want:
                fail(f"{sub}: the card did not replay the CPU's tokens")
            if not all(held(sub, card, rec)):
                fail(f"{sub}: card and CPU logits differ beyond tolerance")
    if "int8" in kinds:
        rec = records["paged", "int8"][1]
        sub = f"{tag} f32 serve[paged,int8] control"
        with bf16_q_code_decodes():
            _, card = serve(dev, "paged", "int8", forced=rec)
        if all(held(f"{sub} (q rounded to bf16 in the code decodes)", card,
                    rec)):
            fail(f"{tag}: the quantized parity check passes its planted "
                 f"control")
        with faulted_decode_call():
            _, card = serve(dev, "paged", "int8", forced=rec)
        med_ok, max_ok = held(f"{sub} (one decode call's output + 1.0)",
                              card, rec)
        print(f"{sub}: the max {'holds' if max_ok else 'refuses'} the "
              f"one-call fault, the median alone "
              f"{'holds' if med_ok else 'refuses'} it")
        if max_ok:
            fail(f"{tag}: the max check passes its planted control (a "
                 f"fault on one decode call's rows)")


def serve_smoke_parity(dev):
    """SMOKE float32, both layouts, bf16 and int8 caches: greedy tokens on
    the card == the plain versions on the CPU."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_params
    cfg = dataclasses.replace(get_config("smollm-135m", smoke=True),
                              dtype=torch.float32)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, size=n)
               for n in (300, 40, 520, 129)]
    smoke_parity(cfg, dev, prompts, ("bf16", "int8"),
                 init_params(cfg, seed=1, device=dev), 12, "smoke")


def dense_smoke_parity(dev):
    """Phase 9's float32 dense pair: SMOKE dense serves, monolithic (#4 on
    the prompt bucket) and chunked (#2 over dense causal lists), both
    layouts, bf16 cache: greedy tokens on the card == the plain versions'
    on the CPU."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_params
    cfg = dataclasses.replace(get_config("smollm-135m", smoke=True),
                              dtype=torch.float32)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, size=n)
               for n in (300, 40, 520, 129)]
    params = init_params(cfg, seed=1, device=dev)
    reset_counts()
    for mode in ("monolithic", "chunked"):
        smoke_parity(cfg, dev, prompts, ("bf16",), params, 12,
                     f"smoke dense {mode}", attention="dense",
                     prefill_mode=mode)
    launches = read_counts([form(n, "f32", SMOL) for n in PATH_KERNELS]
                           + ["flash_attention"])
    print(f"smoke dense f32 parity: launches {launches}")
    if not all(launches.values()):
        fail(f"smoke dense f32 parity: a kernel never launched: {launches}")


def replan_smoke_parity(dev):
    """Phase 10's float32 pair: SMOKE serves with telemetry and
    ``replan_every`` (paged, bf16 cache) on the CPU (plain versions) and on
    the card: equal greedy tokens and the same epochs, at least one swap."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.sparsity import synthetic_head_curves
    from repro_torch.models.transformer import init_params
    from repro_torch.serving import Engine, EngineConfig, SamplingParams
    cfg = dataclasses.replace(get_config("smollm-135m", smoke=True),
                              dtype=torch.float32)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, size=n)
               for n in (300, 40, 250, 513)]
    params = init_params(cfg, seed=1, device=dev)
    runs = []
    for d, p in ((torch.device("cpu"), to_device(params, "cpu")),
                 (dev, params)):
        eng = Engine(cfg, p, EngineConfig(
            max_seq_len=1024, num_slots=4, budget_per_head=256,
            telemetry_every=2, replan_every=6),
            synthetic_head_curves(cfg.num_layers, cfg.num_heads), device=d)
        runs.append(([r.generated for r in eng.serve(
            prompts, SamplingParams(max_tokens=20))], eng.epoch, eng.replans))
    (cpu_toks, cpu_epoch, _), (toks, epoch, replans) = runs
    same = toks == cpu_toks
    print(f"smoke replanning f32 serve[paged,bf16]: card epoch {epoch} after "
          f"{replans} replan(s), CPU epoch {cpu_epoch}; card tokens "
          f"{'==' if same else '!='} CPU plain-version tokens")
    if not same or epoch != cpu_epoch or epoch < 1:
        fail("the replanning f32 serve: card and CPU differ, or no swap")


def time_decode_ticks(eng) -> list:
    """Record each decode tick's host time (the step ends with its sampled
    tokens on the host): ``(tick, seconds)`` per call of
    ``eng.decode_slots``."""
    ticks, inner = [], eng.decode_slots

    def timed(*args, **kw):
        t0 = time.perf_counter()
        out = inner(*args, **kw)
        ticks.append((eng._decode_ticks, time.perf_counter() - t0))
        return out
    eng.decode_slots = timed
    return ticks


def timed_swap_parts(eng) -> dict:
    """Time an epoch swap's parts on the card: the weights' permutation
    (``_permute_params``) and the cache's kv-head gather
    (``_permute_cache``), each between synchronizations; seconds per
    part, appended per swap."""
    import torch
    parts = {"params": [], "cache": []}
    for part, attr in (("params", "_permute_params"),
                       ("cache", "_permute_cache")):
        def timed(*args, _inner=getattr(eng, attr), _part=part, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = _inner(*args, **kw)
            torch.cuda.synchronize()
            parts[_part].append(time.perf_counter() - t0)
            return out
        setattr(eng, attr, timed)
    return parts


def run_replan_serve(cfg, params, dev, sh: Shapes):
    """Phase 10 at full width: a paged serve with telemetry and replanning
    (``REPLAN``) completes every request through the path's kernels and
    reaches epoch 1 or later; the probe's estimator forward launches the
    decode kernel (#1) on every probe.  Prints the bubble stats, the
    realized recovery, the epochs, and a probe tick's host time against a
    plain decode tick's."""
    import numpy as np
    prompts = serve_prompts(cfg)
    eng = build_engine(cfg, params, dev, **REPLAN)
    ticks = time_decode_ticks(eng)
    swaps = timed_swap_parts(eng)
    dec, per_probe = counters()["flash_decode_paged"], []
    dispatch = eng._dispatch_telemetry

    def probe(*args, **kw):
        n = dec.launches
        out = dispatch(*args, **kw)
        per_probe.append(dec.launches - n)
        return out
    eng._dispatch_telemetry = probe
    run_serve(eng, prompts, "paged,packed,replanning", sh)
    every = REPLAN["telemetry_every"]
    probed = [t for k, t in ticks if k % every == 0]
    plain = [t for k, t in ticks if k % every]
    bs = eng.decode_bubble_stats
    print(f"serve[replanning {REPLAN}]: epoch {eng.epoch} after "
          f"{eng.replans} replan(s) over {bs['ticks']} decode ticks; "
          f"realized recovery {bs['realized_recovery']}; drift "
          f"{bs['drift']}; epochs {bs['epochs']}")
    print(f"serve[replanning]: {len(probed)} probe ticks, host time median "
          f"{1e3 * np.median(probed):.2f} ms (mean "
          f"{1e3 * np.mean(probed):.2f}), plain decode ticks {len(plain)}: "
          f"median {1e3 * np.median(plain):.2f} ms (mean "
          f"{1e3 * np.mean(plain):.2f}); the probes launched #1 "
          f"{sum(per_probe)} times ({per_probe[:3]}... a probe); swaps: "
          f"params {[round(1e3 * t, 2) for t in swaps['params']]} ms, "
          f"cache {[round(1e3 * t, 2) for t in swaps['cache']]} ms")
    if eng.epoch < 1:
        fail("the replanning serve never swapped its plan epoch")
    if not per_probe or not all(per_probe):
        fail(f"a probe's estimator forward did not launch #1: {per_probe}")


def rotate_shards(plan):
    """``plan`` with every shard's KV groups (slots and kv slots, with
    their budgets) moved to the next shard."""
    import numpy as np
    layers = []
    for lp in plan.layers:
        H, hkv = len(lp.perm), len(lp.kv_perm)
        s = np.roll(np.arange(H), H // plan.num_devices)
        perm = lp.perm[s]
        inv = np.empty_like(perm)
        inv[perm] = np.arange(H)
        layers.append(dataclasses.replace(
            lp, perm=perm, inv_perm=inv, budgets=lp.budgets[s],
            kv_perm=lp.kv_perm[np.roll(np.arange(hkv),
                                       hkv // plan.num_devices)],
            device_loads=np.roll(lp.device_loads, 1)))
    return dataclasses.replace(plan, layers=layers)


def run_head_move(cfg, params, dev, sh: Shapes):
    """Phase 10's forced head move at full width (``HEAD_MOVE``, the
    model's first ``CUT_LAYERS`` layers): at the
    first safe point from decode tick ``HEAD_MOVE_TICK`` with every prompt
    prefilled (nothing queued or in flight) the engine swaps
    onto its plan with the KV groups rotated across the shards (weights
    permuted, the resident pool's kv heads gathered once).  Against the
    frozen serve: the moved serve replaying the frozen serve's tokens holds
    its logits within ``HEAD_MOVE_ATOL`` (median over the live requests'
    rows, max), and a free moved serve's tokens are reported; a planted
    control, the replayed move with the pool gathered by a wrong kv-head
    table (each layer's rolled by one slot), must fail the check.  Prints
    the swap's parts' times."""
    import numpy as np
    import torch
    d = HEAD_MOVE[sh.arch]
    prompts = serve_prompts(cfg)
    eng = build_engine(cfg, params, dev, num_model_shards=d)
    with sampled_logits([]) as frozen:
        want, _ = run_serve(eng, prompts, f"paged,packed,D={d},frozen", sh)
    pool_gb = eng.kv.pool_bytes() / 1e9
    del eng
    torch.cuda.empty_cache()
    for replay, control in ((True, False), (False, False), (True, True)):
        eng = build_engine(cfg, params, dev, num_model_shards=d)
        swaps = timed_swap_parts(eng)
        if control:
            gather = eng._permute_cache
            eng._permute_cache = lambda tbl, _g=gather: _g(
                np.roll(tbl, 1, axis=1))
        card, moved_at = [], []
        live = live_rows(eng, card)

        def policy(batcher=None, eng=eng, card=card, moved_at=moved_at):
            batcher = batcher or eng._batcher
            if (eng.replans or eng._decode_ticks < HEAD_MOVE_TICK
                    or not batcher.replan_safe or batcher.pending):
                return False
            moved_at.append(len(card))      # the first moved model call
            return eng.replan_now(plan=rotate_shards(eng.plan))
        eng._maybe_replan = policy
        tag = (f"paged,packed,D={d},head move{',replayed' if replay else ''}"
               f"{',control: wrong kv-head table' if control else ''}")
        with sampled_logits(card, frozen if replay else None):
            got, _ = run_serve(eng, prompts, tag, sh)
        print(f"serve[{sh.arch}:{tag}]: epoch {eng.epoch} after "
              f"{eng.replans} swap(s) at tick >= {HEAD_MOVE_TICK}; swap "
              f"parts: weights {1e3 * sum(swaps['params']):.2f} ms, cache "
              f"gather {1e3 * sum(swaps['cache']):.2f} ms ({pool_gb:.2f} GB "
              f"pool)")
        if eng.epoch != 1 or not swaps["cache"]:
            fail(f"{sh.arch}: the forced head move did not swap the epoch "
                 f"and gather the cache")
        if replay:
            at = moved_at[0]
            old_med = forced_logit_diff(card[at:], frozen[at:])[0]
            med, worst, flips = forced_logit_diff(
                card[at:], frozen[at:],
                [live.get(i) for i in range(at, len(card))])
            ok = med <= HEAD_MOVE_ATOL[0] and worst <= HEAD_MOVE_ATOL[1]
            print(f"serve[{sh.arch}:{tag}]: logits against the frozen "
                  f"serve's over the {len(card) - at} model calls after the "
                  f"move (of {len(card)}), live rows: median "
                  f"{med:.3e} (over every row, finished slots' too: "
                  f"{old_med:.3e}), max {worst:.3e} (limits "
                  f"{HEAD_MOVE_ATOL}); greedy argmax differs in {flips} "
                  f"live rows: {'held' if ok else 'NOT held'}")
            if control and ok:
                fail(f"{sh.arch}: the head-move check passes its planted "
                     f"control (the pool gathered by a wrong kv-head "
                     f"table)")
            if not control and not ok:
                fail(f"{sh.arch}: the moved serve's logits leave the frozen "
                     f"serve's beyond the limit")
        else:
            same = sum(a == b for a, b in zip(got, want))
            first = min((next(i for i, (x, y) in enumerate(zip(a, b))
                              if x != y) for a, b in zip(got, want)
                         if a != b), default=None)
            print(f"serve[{sh.arch}:{tag}]: greedy tokens equal the frozen "
                  f"serve's in {same} of {len(want)} requests (reported; "
                  f"first departure at token {first})")
        del eng
        torch.cuda.empty_cache()


def calibration_prompts(cfg, n: int = 2):
    """The profiling stage's seeded calibration prompts."""
    import numpy as np
    rng = np.random.default_rng(11)
    return [rng.integers(0, cfg.vocab_size, size=CALIB_TOKENS)
            for _ in range(n)]


def check_curves(tag, prof) -> None:
    """A measured profile's curves are non-decreasing on the grid, within
    [0, 1], and reach 1 at frac 1 (within 1e-6)."""
    import numpy as np
    c = prof.curves
    steps = np.diff(c, axis=-1).min()
    at_one = np.abs(c[..., -1] - 1.0).max()
    print(f"{tag}: {c.shape[0]} layers x {c.shape[1]} heads x {c.shape[2]} "
          f"grid points over {prof.num_samples} query rows; smallest step "
          f"{steps:.3e}, range [{c.min():.6f}, {c.max():.6f}], largest "
          f"|recovery(1) - 1| {at_one:.3e}")
    if steps < 0 or c.min() < 0 or c.max() > 1 + 1e-6 or at_one > 1e-6:
        fail(f"{tag}: a recovery curve decreases, leaves [0, 1] or misses "
             f"1 at frac 1")


def run_profile(cfg, params, dev):
    """Phase 11's offline profiling stage at full width: the profiling
    forward (``tfm.prefill(..., maps_out=)``, whose attention launches #4)
    of two seeded calibration prompts, ``profile_model`` on the card, the
    curves checked; each layer's heterogeneity and the plan's budget spread
    printed; then the 8 serve prompts served from that profile."""
    import numpy as np
    import torch
    from repro_torch.core.sparsity import profile_model
    from repro_torch.models import transformer as tfm
    calib = calibration_prompts(cfg)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.time()
    prof = profile_model(lambda t: tfm.attention_maps_of(params, t, cfg),
                         calib)
    torch.cuda.synchronize()
    flash = read_counts(["flash_attention"])["flash_attention"]
    tag = f"profile[{cfg.name}]"
    print(f"{tag}: {len(calib)} calibration prompts of {CALIB_TOKENS} "
          f"tokens in {time.time() - t0:.2f} s, #4 launched {flash} times")
    if flash != len(calib) * cfg.num_layers:
        fail(f"{tag}: the profiling forward did not launch #4 once a layer")
    check_curves(tag, prof)
    het = [prof.heterogeneity(l) for l in range(cfg.num_layers)]
    print(f"{tag}: heterogeneity (max / min budget at recovery 0.9) by "
          f"layer: {[round(h, 2) for h in het]}")
    eng = build_engine(cfg, params, dev, profile=prof)
    budgets = np.stack([lp.budgets for lp in eng.plan.layers])
    spread = budgets.max(axis=1) / budgets.min(axis=1)
    print(f"{tag}: plan budgets {budgets.min()}-{budgets.max()} tokens a "
          f"head (median {np.median(budgets):.0f}); max / min in a layer "
          f"{spread.min():.2f}-{spread.max():.2f} (mean {spread.mean():.2f})")
    run_serve(eng, serve_prompts(cfg), "paged,packed,measured profile",
              SMOL)


def profile_smoke_parity(dev):
    """Phase 11's float32 pair: SMOKE profiles of the same seeded weights
    and calibration tokens on the card and on the CPU: curves within
    ``PROFILE_ATOL``."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.sparsity import profile_model
    from repro_torch.models import transformer as tfm
    cfg = dataclasses.replace(get_config("smollm-135m", smoke=True),
                              dtype=torch.float32)
    params = tfm.init_params(cfg, seed=5, device=dev)
    calib = calibration_prompts(cfg)
    got, want = (profile_model(
        lambda t, p=p: tfm.attention_maps_of(p, t, cfg), calib)
        for p in (params, to_device(params, "cpu")))
    diff = float(np.abs(got.curves - want.curves).max())
    print(f"smoke profile f32: card curves against the CPU's, largest "
          f"difference {diff:.3e} (tolerance {PROFILE_ATOL:g})")
    if not diff <= PROFILE_ATOL:
        fail("the SMOKE f32 profile: card and CPU curves differ")


def preempt_prompts(cfg):
    import numpy as np
    rng = np.random.default_rng(12)
    return [rng.integers(0, cfg.vocab_size, size=n) for n in PREEMPT_LENS]


def drive_interrupt(eng, prompts, sp, on_tick=None):
    """Two batch-class requests run until both decode; then the
    interactive one arrives and the batcher drains (``on_tick`` after each
    tick from the arrival on).  Returns the tokens in rid order and the
    batcher."""
    import numpy as np
    from repro_torch.serving.scheduler import Request
    b = eng.make_batcher()
    pf, df = eng.step_fns(sp)
    for i in range(2):
        b.submit(Request(rid=i, prompt=np.asarray(prompts[i], np.int32),
                         sampling=sp, priority="batch"))
    done = []
    while b.busy and not (b.prefilling is None and len(b.active) == 2):
        done.extend(b.tick(pf, df))
    done.extend(b.tick(pf, df))
    b.submit(Request(rid=2, prompt=np.asarray(prompts[2], np.int32),
                     sampling=sp, priority="interactive"))
    while b.busy:
        done.extend(b.tick(pf, df))
        if on_tick is not None:
            on_tick(b)
    return [r.generated for r in sorted(done, key=lambda r: r.rid)], b


def timed_swaps(eng) -> list:
    """Time each swap hook on the card between CUDA events (the gather or
    scatter and the pinned copy; a swap-out also waits for its pinned host
    buffer, which the first swap of a size in the process allocates and
    later ones take from torch's cache), host clock beside it:
    ``(direction, ms, host ms, bytes)`` per call."""
    import torch
    out = []
    for way, attr in (("out", "_swap_out_seq"), ("in", "_swap_in_seq")):
        def timed(*args, _inner=getattr(eng, attr), _way=way, **kw):
            key = f"bytes_{_way}"
            n0 = eng.swap_stats[key]
            torch.cuda.synchronize()
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            t0 = time.perf_counter()
            start.record()
            _inner(*args, **kw)
            end.record()
            torch.cuda.synchronize()
            out.append((_way, start.elapsed_time(end),
                        1e3 * (time.perf_counter() - t0),
                        eng.swap_stats[key] - n0))
        setattr(eng, attr, timed)
    return out


def rolled_host_copy(eng) -> None:
    """The preemption check's planted control: at swap-in the host copy is
    rolled by one block along its block axis (each block restored one block
    off), codes and scales alike."""
    import torch
    inner = eng._swap_in_seq

    def swap_in(rid, slot, resident):
        data, scales = eng.host_copy(rid)
        axis, shift = (2, 1) if eng.paged else (4, eng.ecfg.block)
        data.copy_(torch.roll(data, shift, axis))
        if scales is not None:
            scales.copy_(torch.roll(scales, 1, axis))
        return inner(rid, slot, resident)
    eng._swap_in_seq = swap_in


def run_preempted(cfg, params, dev, sh: Shapes, layout: str, kind: str):
    """Phase 11's preempted serve of one setting at full width, three
    times: uninterrupted (the default pool, or, contiguous, the same two
    slots, without preemption), preempted (the tight pool; the interactive
    arrival swaps a decoding batch request's KV to the pinned host tier and
    back), and the planted control (the host copy rolled by one block at
    swap-in).  The preempted tokens must equal the uninterrupted ones for
    every request, with a swap out and back of equal blocks and a clean
    audit of both tiers, and the path's kernels launched; the control's
    must not.  Prints the swaps' card times, bytes and bytes per second."""
    import numpy as np
    import torch
    from repro_torch.serving import SamplingParams
    sp = SamplingParams(max_tokens=32)
    prompts = preempt_prompts(cfg)
    geom = (dict(num_kv_blocks=PREEMPT_BLOCKS) if layout == "paged"
            else dict(num_slots=2))
    tag = f"{sh.arch}:{layout},{kind},preempted"
    runs = {}
    for name, kw in (("uninterrupted", dict(
            num_kv_blocks=None) if layout == "paged" else geom),
            ("preempted", dict(geom, preemption=True)),
            ("control", dict(geom, preemption=True))):
        eng = build_engine(cfg, params, dev, cache_layout=layout,
                           kv_dtype=kind, **kw)
        swaps = timed_swaps(eng)
        if name == "control":
            rolled_host_copy(eng)
        names = [n + sh.tag for n in serve_kernels(eng.ecfg)]
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.time()
        toks, b = drive_interrupt(eng, prompts, sp)
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = read_counts(names)
        fails = (eng.kv.audit(strict=False) if eng.paged
                 else b.alloc.audit(False))
        st = eng.swap_stats
        pool = (f"pool of {eng.kv.num_blocks} blocks" if eng.paged
                else f"{eng.ecfg.num_slots} slots")
        print(f"serve[{tag}] {name}: {pool}, {wall:.2f} s; preempted "
              f"{b.stats.preempted}, resumed {b.stats.resumed}; swap "
              f"{st['swapped_out']} out / {st['swapped_in']} in, blocks "
              f"{st['blocks_out']} / {st['blocks_in']}, epoch remaps "
              f"{st['epoch_remaps']}; launches {launches}; audit "
              f"{'clean' if not fails else fails}, {b.alloc.allocated_blocks} "
              f"blocks mapped, {b.alloc.host_allocated_blocks} on the host")
        for way, ms, host_ms, nbytes in swaps:
            print(f"serve[{tag}] {name}: swap-{way} {nbytes} bytes, card "
                  f"{ms:.3f} ms ({nbytes / ms / 1e6:.2f} GB/s), host "
                  f"{host_ms:.3f} ms")
        if (not all(len(t) == 32 for t in toks) or not all(launches.values())
                or fails or b.alloc.allocated_blocks
                or b.alloc.host_allocated_blocks or eng._host_swaps):
            fail(f"{tag} {name}: a request did not complete, a kernel of "
                 f"the path never launched, or the tiers did not audit "
                 f"clean")
        if name != "uninterrupted" and (
                st["swapped_out"] < 1
                or st["blocks_in"] != st["blocks_out"]):
            fail(f"{tag} {name}: no swap out and back of equal blocks")
        runs[name] = toks
        # the batcher's swap hooks refer back to the engine: collect the
        # cycle, so its pool and pinned buffers return to torch's caches
        del eng, b
        gc.collect()
        torch.cuda.empty_cache()
    want = runs["uninterrupted"]
    same = [a == b for a, b in zip(runs["preempted"], want)]
    moved = [a == b for a, b in zip(runs["control"], want)]
    print(f"serve[{tag}]: preempted tokens == uninterrupted for requests "
          f"{same}; control (host copy rolled by one block): {moved}")
    if not all(same):
        fail(f"{tag}: the preempted serve's tokens differ from the "
             f"uninterrupted serve's")
    if all(moved):
        fail(f"{tag}: the planted control (host copy rolled by one block) "
             f"kept the tokens")


def parked_on_device(eng) -> None:
    """The straddle check's reference path: a victim's copy stays on the
    card (``_to_host`` a device clone) and every epoch swap gathers it with
    the resident cache by the swap's own kv table, so swap-in finds it in
    the live arrangement and remaps nothing."""
    import numpy as np
    from repro_torch.models import transformer as tfm
    eng._to_host = lambda t: t.clone()
    gather = eng._permute_cache

    def permute(kv_tbl):
        gathered = gather(kv_tbl)
        for rec in eng._host_swaps.values():
            rec["data"] = tfm.permute_cache_kv_heads(rec["data"], kv_tbl)
            if rec["scales"] is not None:
                rec["scales"] = tfm.permute_cache_scales(rec["scales"],
                                                         kv_tbl)
            rec["arrange"] = np.take_along_axis(
                rec["arrange"], np.asarray(kv_tbl), axis=1)
        return gathered
    eng._permute_cache = permute


def skipped_remap(eng) -> None:
    """The straddle check's planted control: swap-in restores the host copy
    as it was taken (its arrangement overwritten by the live one)."""
    inner = eng._swap_in_seq

    def swap_in(rid, slot, resident):
        eng._host_swaps[rid]["arrange"] = eng._kv_arrange.copy()
        return inner(rid, slot, resident)
    eng._swap_in_seq = swap_in


def run_straddle(cfg, params, dev, sh: Shapes):
    """Phase 11's epoch straddle at full width (``STRADDLE``: Yi-6B paged
    at D = 4): the preempted serve of :func:`run_preempted`, with phase
    10's head move (:func:`rotate_shards`) forced at the first safe point
    while the victim is on the host.  Its tokens must equal those of the
    same serve whose victim's copy stays on the card and moves with the
    resident cache (:func:`parked_on_device`), with exactly one remap at
    swap-in; a control restoring the copy unmapped must differ."""
    import torch
    from repro_torch.serving import SamplingParams
    d = STRADDLE[sh.arch]
    sp = SamplingParams(max_tokens=STRADDLE_TOKENS)
    prompts = preempt_prompts(cfg)
    tag = f"{sh.arch}:paged,bf16,D={d},preempted,head move"
    runs = {}
    for name, plant in (("host tier", None), ("parked on the card",
                                              parked_on_device),
                        ("control: no remap", skipped_remap)):
        eng = build_engine(cfg, params, dev, num_model_shards=d,
                           preemption=True, num_kv_blocks=PREEMPT_BLOCKS)
        if plant is not None:
            plant(eng)
        swaps = timed_swap_parts(eng)
        moved = []

        def on_tick(b, eng=eng, moved=moved):
            if (not moved and eng.swap_stats["swapped_out"]
                    and not eng.swap_stats["swapped_in"] and b.replan_safe):
                moved.append(eng._decode_ticks)
                eng.replan_now(plan=rotate_shards(eng.plan))
        t0 = time.time()
        toks, b = drive_interrupt(eng, prompts, sp, on_tick)
        torch.cuda.synchronize()
        st = eng.swap_stats
        fails = eng.kv.audit(strict=False)
        print(f"serve[{tag}] {name}: {time.time() - t0:.2f} s; head move at "
              f"decode tick {moved}, epoch {eng.epoch}; swap "
              f"{st['swapped_out']} out / {st['swapped_in']} in, epoch "
              f"remaps {st['epoch_remaps']}; swap parts: weights "
              f"{1e3 * sum(swaps['params']):.2f} ms, cache gather "
              f"{1e3 * sum(swaps['cache']):.2f} ms; audit "
              f"{'clean' if not fails else fails}")
        want_remaps = 1 if plant is None else 0
        if (not moved or eng.epoch != 1 or fails
                or st["epoch_remaps"] != want_remaps
                or not all(len(t) == STRADDLE_TOKENS for t in toks)):
            fail(f"{tag} {name}: no head move during the host residency, "
                 f"{st['epoch_remaps']} remaps (want {want_remaps}), or an "
                 f"unclean audit")
        runs[name] = toks
        del eng, b
        gc.collect()
        torch.cuda.empty_cache()
    want = runs["parked on the card"]
    same = [a == b for a, b in zip(runs["host tier"], want)]
    ctrl = [a == b for a, b in zip(runs["control: no remap"], want)]
    print(f"serve[{tag}]: host-tier tokens == parked-on-the-card tokens for "
          f"requests {same}; control (no remap): {ctrl}")
    if not all(same):
        fail(f"{tag}: the epoch-straddling swap's tokens differ")
    if all(ctrl):
        fail(f"{tag}: the planted control (no remap) kept the tokens")


def dense_f32_parity(dev, params, sh: Shapes):
    """A sliding-window model's widths at ``PARITY``'s depth in float32
    with dense attention, monolithic (#4, windowed on 'L' layers) and
    chunked (#2 over dense causal lists, windowed), both layouts, bf16
    cache: the card's tokens == the plain versions' on the CPU.  Every
    window form and f32 path form launches."""
    import numpy as np
    cfg = parity_config(sh)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, size=n)
               for n in PARITY[sh.arch][1]]
    tag = f"{sh.arch} {cfg.num_layers}-layer dense"
    t0 = time.time()
    reset_counts()
    for mode in ("monolithic", "chunked"):
        smoke_parity(cfg, dev, prompts, ("bf16",), params, 8,
                     f"{tag} {mode}", attention="dense", prefill_mode=mode)
    launches = read_counts([form(n, "window", sh) for n in WINDOW_KERNELS]
                           + [form(n, "f32", sh) for n in PATH_KERNELS])
    print(f"{tag} f32 parity: launches {launches}, "
          f"{time.time() - t0:.1f} s")
    if not all(launches.values()):
        fail(f"{tag}: a kernel form never launched: {launches}")


# the float32 parity models: (layers, prompt lengths); Gemma3-1B's 6
# layers are one LLLLLG period, and its 700-token prompt reaches past the
# 512-token window of the local layers' decode
PARITY = {"yi-6b": (2, (200, 40, 130)), "gemma3-1b": (6, (700, 40, 260))}


def parity_config(sh: Shapes):
    """The model's widths and G at ``PARITY``'s depth, in float32."""
    import torch
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(sh.arch),
                               num_layers=PARITY[sh.arch][0],
                               dtype=torch.float32)


def f32_parity(dev, params, sh: Shapes):
    """The model's widths and G at ``PARITY``'s depth in float32, both
    layouts, bf16 / int8 / fp8 caches: the card's tokens (the model's
    head_dim in the f32 and code kernels) == the plain versions' on the
    CPU.  Returns the launches of the f32 forms and of the code decodes no
    full-width serve runs (the code decodes take q in float32 whatever the
    model's dtype)."""
    import numpy as np
    cfg = parity_config(sh)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, size=n)
               for n in PARITY[sh.arch][1]]
    tag = f"{sh.arch} {cfg.num_layers}-layer"
    t0 = time.time()
    reset_counts()
    smoke_parity(cfg, dev, prompts, ("bf16",) + QUANT_KINDS, params, 8, tag)
    launches = read_counts(
        [form(n, "f32", sh) for n in PATH_KERNELS]
        + [form("flash_decode_contig", k, sh) for k in QUANT_KINDS]
        + [form("flash_decode_paged", "fp8", sh)])
    print(f"{tag} f32 parity: launches {launches}, "
          f"{time.time() - t0:.1f} s")
    if not all(launches.values()):
        fail(f"{tag}: a kernel form never launched: {launches}")
    return launches


def sharded_parity(dev, params, sh: Shapes):
    """The model's widths at ``PARITY``'s depth in float32 at the degree
    ``SHARDED_CHECK``, bf16 cache, both layouts: the card's tokens == the
    plain versions' on the CPU."""
    import numpy as np
    cfg = parity_config(sh)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, size=n)
               for n in PARITY[sh.arch][1]]
    tag = f"{sh.arch} {cfg.num_layers}-layer D={SHARDED_CHECK}"
    reset_counts()
    smoke_parity(cfg, dev, prompts, ("bf16",), params, 8, tag,
                 shards=SHARDED_CHECK)
    launches = read_counts([form(n, "f32", sh) for n in PATH_KERNELS])
    print(f"{tag} f32 parity: launches {launches}")
    if not all(launches.values()):
        fail(f"{tag}: a kernel form never launched: {launches}")


@contextlib.contextmanager
def dropped_stripe():
    """The stripe check's planted control: while the block runs, the
    striped decode's merge leaves out the last stripe's partial (the blocks
    that stripe holds are never attended)."""
    from repro_torch.models import transformer as tfm
    merge = tfm._merge_stripe_partials
    tfm._merge_stripe_partials = lambda parts, *a: merge(parts[:-1], *a)
    try:
        yield
    finally:
        tfm._merge_stripe_partials = merge


def run_striped(cfg, params, dev, sh: Shapes, tag: str, kw: dict,
                twin_kw: dict, control: bool):
    """Phase 12's striped serve of one setting: the unstriped twin (its
    logits recorded), then the striped serve replaying the twin's greedy
    tokens, whose largest logit difference a live row and model call must
    hold ``STRIPE_ATOL`` (median, max) (an unstriped default twin at full
    depth is the recorded serve of phase 5); prints the greedy tokens that
    agree (the rows whose own argmax is the twin's token), the per-axis
    imbalances and merges, and #1's launches, which must be S a layer and
    decode tick.  With ``control`` the replay runs again with one stripe's
    partial left out of the merge, which must fail the limits."""
    import torch
    prompts = serve_prompts(cfg)
    S = kw["seq_shards"]
    ref = (DEFAULT_LOGITS.get((cfg.name, cfg.num_layers)) if not twin_kw
           else None)
    if ref:
        print(f"serve[{sh.arch}:{tag}]: the twin is the default paged "
              f"packed serve of phase 5 (its logits recorded there)")
    else:
        twin = build_engine(cfg, params, dev, **twin_kw)
        with sampled_logits([]) as ref:
            run_serve(twin, prompts, f"{tag},twin S=1", sh)
        del twin
        torch.cuda.empty_cache()
    runs = (("sound", contextlib.nullcontext),) + (
        (("control: a stripe left out of the merge", dropped_stripe),)
        if control else ())
    for name, ctx in runs:
        eng = build_engine(cfg, params, dev, **kw)
        card = []
        live = live_rows(eng, card)
        with sampled_logits(card, ref), ctx():
            _, launches = run_serve(eng, prompts, f"{tag},{name}", sh)
        rows = [live.get(i) for i in range(len(card))]
        med, worst, flips = forced_logit_diff(card, ref, rows)
        total = sum(c.shape[0] if r is None else len(r)
                    for c, r in zip(card, rows))
        ok = med <= STRIPE_ATOL[0] and worst <= STRIPE_ATOL[1]
        bs = eng.decode_bubble_stats
        n1 = launches["flash_decode_paged" + sh.tag]
        want = S * cfg.num_layers * eng._batcher.stats.decode_steps
        print(f"serve[{sh.arch}:{tag},{name}]: replaying the S=1 twin's "
              f"tokens over {len(card)} model calls: greedy tokens agree "
              f"in {total - flips} of {total} live rows; logit difference "
              f"median {med:.3e}, max {worst:.3e} (limits {STRIPE_ATOL}): "
              f"{'held' if ok else 'NOT held'}; mean head imbalance "
              f"{bs['mean_head_imbalance']:.4f}, mean stripe imbalance "
              f"{bs['mean_stripe_imbalance']:.4f}, merge collectives "
              f"{bs['merge_collectives']}; #1 launches {n1} (S x layers x "
              f"decode ticks = {want})")
        if n1 != want or bs["merge_collectives"] != (
                cfg.num_layers * eng._batcher.stats.decode_steps):
            fail(f"{sh.arch}:{tag}: #1 did not launch once a stripe, layer "
                 f"and tick")
        if name == "sound" and not ok:
            fail(f"{sh.arch}:{tag}: the striped serve's logits leave the "
                 f"unstriped twin's beyond the limits")
        if name != "sound" and ok:
            fail(f"{sh.arch}:{tag}: the stripe check passes its planted "
                 f"control")
        del eng
        torch.cuda.empty_cache()


def prefix_traffic(cfg):
    """Phase 12's prefix traffic: the warming request and the
    ``PREFIX_TAILS`` requests, each the shared seeded prompt of
    ``PREFIX_SHARED`` tokens and a seeded tail of 64-700 tokens."""
    import numpy as np
    rng = np.random.default_rng(27)
    shared = rng.integers(0, cfg.vocab_size, size=PREFIX_SHARED)
    tails = [int(n) for n in rng.integers(64, 701, size=PREFIX_TAILS + 1)]
    prompts = [np.concatenate([shared, rng.integers(0, cfg.vocab_size,
                                                    size=n)])
               for n in tails]
    return prompts[:1], prompts[1:]


def prefix_serve(eng, calls, tag: str, sh: Shapes):
    """The two ``serve`` calls of ``calls`` on one engine (32 greedy
    tokens each): completion, the tokens of each call, the second call's
    TTFTs (host clock), prefill chunks and #1 / #2 launches, each
    request's block placement (the stripe of each block of its table when
    it frees, which holds every block its decode ticks read), and a clean
    block audit (cached blocks stay mapped as evictable)."""
    import torch
    from repro_torch.serving import SamplingParams
    sp = SamplingParams(max_tokens=32)
    alloc = eng.kv.alloc
    free = alloc.free
    out = []
    for prompts in calls:
        placed = {}

        def spy(rid, _placed=placed):
            _placed[rid] = "".join(str(alloc.stripe_of(b))
                                   for b in alloc.table(rid))
            return free(rid)
        alloc.free = spy
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.time()
        done = eng.serve(prompts, sp)
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = read_counts([
            form("flash_decode_paged", None, sh),
            form("sparse_prefill_paged", None, sh),
            form("sparse_prefill_contig", None, sh),
            *(form(n, eng.ecfg.kv_dtype, sh) for n in (
                "flash_decode_paged", "sparse_prefill_paged")
              if eng.quantized)])
        if not all(r.done and not r.rejected and len(r.generated) == 32
                   for r in done):
            fail(f"{tag}: not every request completed")
        out.append(([r.generated for r in done], [r.ttft for r in done],
                    eng._batcher.stats.prefill_chunks, launches, wall,
                    [placed[r.rid] for r in done]))
    alloc.free = free
    fails = eng.kv.audit(strict=False)
    if fails or alloc.allocated_blocks != alloc.evictable_blocks:
        fail(f"{tag}: block audit failed: {fails}")
    return out


@contextlib.contextmanager
def logical_placement():
    """The striped prefix check's witness: while the block runs, a block
    appended to a table comes from stripe (its logical index mod S) (the
    most free stripe if that one is empty), so a hit's shared blocks and a
    cache-off serve's own blocks sit on the same stripes."""
    from repro_torch.serving.kv_cache import BlockAllocator
    routed = BlockAllocator._growth_stripe

    def logical(self, table):
        s = len(table) % self.stripes
        return s if self._free[s] else routed(self, table)
    BlockAllocator._growth_stripe = logical
    try:
        yield
    finally:
        BlockAllocator._growth_stripe = routed


def run_prefix(cfg, params, dev, sh: Shapes, tag: str, kw: dict):
    """Phase 12's prefix serve of one setting: the warming call (one
    request) then the ``PREFIX_TAILS`` requests, on a cache-on engine and
    on a cache-off engine of the same options.  Every request of the second
    call must hit, the hits must save prefill work, and #1 and #2 must
    launch; prints the tree's counters, prefill chunks and #2 launches on
    and off, and the hit requests' TTFT on and off.  Tokens must be equal
    bit for bit in both calls, but striped: there a hit's shared blocks sit
    on the stripes its first holder's growth chose and the cache-off
    serve's on others, and the stripe merge rounds by placement
    (``ROADMAP.md`` §3).  So a striped setting prints each request's
    placement on and off, and every request whose placement is the same on
    and off must give the same tokens; then both engines serve again with
    every block placed by its logical index (:func:`logical_placement`),
    where all placements agree and every request's tokens must."""
    import numpy as np
    import torch
    calls = prefix_traffic(cfg)
    striped = kw.get("seq_shards", 1) > 1
    got = {}
    for rule in ("routed", "logical") if striped else ("routed",):
        for on in (False, True):
            eng = build_engine(cfg, params, dev, prefix_cache=on, **kw)
            with (logical_placement() if rule == "logical"
                  else contextlib.nullcontext()):
                got[rule, on] = prefix_serve(eng, calls,
                                             f"{sh.arch}:{tag}", sh)
            if on and rule == "routed":
                pf = eng.decode_bubble_stats["prefix"]
                hits = eng._batcher.stats.prefix_hits
            del eng
            torch.cuda.empty_cache()
    on, off = got["routed", True], got["routed", False]
    same = [a[0] == b[0] for a, b in zip(on, off)]
    (_, ttft_on, chunks_on, l_on, wall_on, _) = on[1]
    (_, ttft_off, chunks_off, l_off, wall_off, _) = off[1]
    print(f"prefix[{sh.arch}:{tag}]: tree hits {pf['hits']} of "
          f"{pf['lookups']} lookups, {pf['hit_tokens']} hit tokens, "
          f"{pf['nodes']} nodes ({pf['evictable']} evictable); second call: "
          f"{hits} of {PREFIX_TAILS} requests hit, prefill chunks "
          f"{chunks_on} on / {chunks_off} off, launches on {l_on}, off "
          f"{l_off}; hit requests' TTFT mean {np.mean(ttft_on):.3f} s on / "
          f"{np.mean(ttft_off):.3f} s off, max {np.max(ttft_on):.3f} / "
          f"{np.max(ttft_off):.3f} s (host clock, queueing included); wall "
          f"{wall_on:.2f} / {wall_off:.2f} s; tokens on == off in the two "
          f"calls: {same}")
    for rule in ("routed", "logical") if striped else ():
        parted = []
        for c, (a, b) in enumerate(zip(got[rule, True], got[rule, False])):
            for rid, (ta, tb, pa, pb) in enumerate(zip(a[0], b[0], a[5],
                                                       b[5])):
                k = PREFIX_SHARED // BLK
                print(f"prefix[{sh.arch}:{tag}] {rule} placement, call {c} "
                      f"request {rid}: stripes on {pa[:k]}|{pa[k:]}, off "
                      f"{pb[:k]}|{pb[k:]}: placement "
                      f"{'same' if pa == pb else 'differs'}, tokens "
                      f"{'equal' if ta == tb else 'PART'}")
                if ta != tb:
                    parted.append((c, rid, pa == pb))
        print(f"prefix[{sh.arch}:{tag}] {rule} placement: requests whose "
              f"tokens part on / off (call, request, same placement): "
              f"{parted}")
        if any(p for *_, p in parted):
            fail(f"{sh.arch}:{tag}: a request whose blocks sit on the same "
                 f"stripes on and off gave other tokens")
        if rule == "logical" and (parted or any(
                pa != pb for a, b in zip(got[rule, True], got[rule, False])
                for pa, pb in zip(a[5], b[5]))):
            fail(f"{sh.arch}:{tag}: placed by logical index, a request's "
                 f"placement or tokens differ on and off")
    if not striped and not all(same):
        fail(f"{sh.arch}:{tag}: the prefix cache changed greedy tokens")
    n1, n2, n2c = (form(n, None, sh) for n in (
        "flash_decode_paged", "sparse_prefill_paged", "sparse_prefill_contig"))
    if hits != PREFIX_TAILS or not l_on[n1]:
        fail(f"{sh.arch}:{tag}: a request missed the warm tree, or #1 never "
             f"launched")
    # monolithic: a hit's tail runs as one chunk through #2 paged, a miss
    # through the contiguous prefill; chunked: fewer chunks, fewer #2
    saved = ((l_on[n2] > 0 and l_on[n2c] == 0 and l_off[n2c] > 0)
             if kw.get("prefill_mode") == "monolithic"
             else (0 < l_on[n2] < l_off[n2] and chunks_on < chunks_off))
    if not saved:
        fail(f"{sh.arch}:{tag}: the hits did not save prefill work")


def zeroed_host_copy(eng) -> None:
    """The prefix preemption's planted control: at swap-in the host copy
    (a hit victim's private tail, often one block, which a roll by one
    block would leave as it is) is zeros, as if its transfer never
    landed."""
    inner = eng._swap_in_seq

    def swap_in(rid, slot, resident):
        eng.host_copy(rid)[0].zero_()
        return inner(rid, slot, resident)
    eng._swap_in_seq = swap_in


@contextlib.contextmanager
def rotated_hit_ids():
    """The prefix check's planted control: while the block runs, the
    tree's matched block ids are mapped in a rotated order (each hit block
    read one position off)."""
    from repro_torch.serving.prefix_tree import RadixPrefixCache
    match = RadixPrefixCache.match

    def rotated(self, prompt):
        ids, hit = match(self, prompt)
        return ids[1:] + ids[:1], hit
    RadixPrefixCache.match = rotated
    try:
        yield
    finally:
        RadixPrefixCache.match = match


def run_prefix_preempted(cfg, params, dev, sh: Shapes):
    """Phase 12's preempted hit victim: two batch requests continuing the
    shared prompt (the second hits the first's blocks), then an
    interactive arrival, in a pool one block short of holding all three,
    where the hit's swap makes room.  The victim keeps its shared prefix
    resident: the bytes swapped out must be its private tail's blocks times
    a block's bytes, and every request's tokens must equal the
    uninterrupted cache-off serve's.  Two planted controls must change the
    victim's: the host copy zeroed, and the hit ids mapped in a rotated
    order."""
    import torch
    from repro_torch.serving import SamplingParams
    sp = SamplingParams(max_tokens=32)
    import numpy as np
    rng = np.random.default_rng(28)
    shared = prefix_traffic(cfg)[0][0][:PREFIX_SHARED]
    # the hit's private tail spans several blocks, so a copy rolled by one
    # block moves its contents
    prompts = [np.concatenate([shared, rng.integers(0, cfg.vocab_size,
                                                    size=n)])
               for n in (400, 600)]
    prompts.append(rng.integers(0, cfg.vocab_size, size=1500))
    need = [-(-(len(p) + 32) // BLK) for p in prompts]
    # the residents (the hit maps only its private blocks) and the
    # arrival overfill the pool by one block
    pool = need[0] + need[1] - PREFIX_SHARED // BLK + need[2] - 1
    tag = f"{sh.arch}:bf16,prefix,preempted"
    runs = {}
    for name, kw, ctx in (
            ("uninterrupted, cache off", dict(prefix_cache=False),
             contextlib.nullcontext),
            ("preempted", dict(prefix_cache=True, preemption=True,
                               num_kv_blocks=pool),
             contextlib.nullcontext),
            ("control: host copy zeroed", dict(
                prefix_cache=True, preemption=True,
                num_kv_blocks=pool), contextlib.nullcontext),
            ("control: hit ids rotated", dict(
                prefix_cache=True, preemption=True,
                num_kv_blocks=pool), rotated_hit_ids)):
        eng = build_engine(cfg, params, dev, **kw)
        victims = []
        inner = eng._swap_out_seq

        def spy(rid, slot, resident, _eng=eng, _inner=inner):
            victims.append((rid, _eng.kv.alloc.swap_split(rid)))
            return _inner(rid, slot, resident)
        eng._swap_out_seq = spy
        if name == "control: host copy zeroed":
            zeroed_host_copy(eng)
        torch.cuda.synchronize()
        t0 = time.time()
        with ctx():
            toks, b = drive_interrupt(eng, prompts, sp)
        torch.cuda.synchronize()
        st = eng.swap_stats
        block_bytes = (eng.kv.pool[:, :, :1].numel()
                       * eng.kv.pool.element_size())
        hits = b.stats.prefix_hits
        print(f"serve[{tag}] {name}: {time.time() - t0:.2f} s; hits {hits}, "
              f"preempted {b.stats.preempted}, resumed {b.stats.resumed}; "
              f"victims (rid, retained, private blocks) "
              f"{[(r, len(a), len(p)) for r, (a, p) in victims]}; swapped "
              f"{st['blocks_out']} blocks / {st['bytes_out']} bytes out "
              f"({block_bytes} bytes a block), {st['blocks_in']} in")
        if not all(len(t) == 32 for t in toks) or eng.kv.audit(strict=False):
            fail(f"{tag} {name}: a request did not complete or the pool did "
                 f"not audit clean")
        if kw.get("preemption"):
            if not victims or b.stats.resumed < 1 or hits < 1:
                fail(f"{tag} {name}: no hit, no swap out or no resume")
            rid, (retained, private) = victims[0]
            if name == "preempted" and (
                    rid != 1 or not retained or st["bytes_out"]
                    != len(private) * block_bytes
                    or st["blocks_in"] != st["blocks_out"]):
                fail(f"{tag}: the hit victim did not swap exactly its "
                     f"private tail")
        runs[name] = toks
        del eng, b
        gc.collect()
        torch.cuda.empty_cache()
    want = runs["uninterrupted, cache off"]
    verdicts = {n: [a == b for a, b in zip(t, want)] for n, t in runs.items()}
    print(f"serve[{tag}]: tokens == the uninterrupted cache-off serve's, by "
          f"request: {verdicts}")
    if not all(verdicts["preempted"]):
        fail(f"{tag}: the preempted hit victim's tokens changed")
    for n in ("control: host copy zeroed", "control: hit ids rotated"):
        if verdicts[n][1]:
            fail(f"{tag}: the planted control ({n}) kept the victim's "
                 f"tokens")


def seq_prefix_parity(dev):
    """SMOKE float32, paged: a serve with two seq stripes (bf16 cache), and
    serves of shared-prefix traffic with the prefix cache (bf16 and int8
    caches, whose planted controls run): the card's tokens == the CPU's
    plain versions' (int8: replayed, logits within the limits)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_params
    cfg = dataclasses.replace(get_config("smollm-135m", smoke=True),
                              dtype=torch.float32)
    params = init_params(cfg, seed=1, device=dev)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, size=n)
               for n in (300, 40, 520, 129)]
    smoke_parity(cfg, dev, prompts, ("bf16",), params, 12, "smoke S=2",
                 layouts=("paged",), seq_shards=2)
    shared = rng.integers(0, cfg.vocab_size, size=256)
    prompts = [np.concatenate([shared, rng.integers(0, cfg.vocab_size,
                                                    size=n)])
               for n in (40, 300, 129)] + prompts[1:2]
    smoke_parity(cfg, dev, prompts, ("bf16", "int8"), params, 12,
                 "smoke prefix cache", layouts=("paged",), prefix_cache=True)


def seq_prefix_phases(cfg, params, dev, sh: Shapes):
    """Phase 12 for one model: its ``STRIPE_SERVES`` and
    ``PREFIX_SERVES`` (secondary ones at ``CUT_LAYERS``), and for
    SmolLM-135M the preempted hit victim and the float32 parity."""
    t0 = time.time()
    cut = None
    for tag, short, kw, twin_kw, control in STRIPE_SERVES.get(sh.arch, ()):
        if short:
            cut = cut or cut_depth(cfg, params, sh.arch)
        run_striped(*(cut if short else (cfg, params)), dev, sh, tag, kw,
                    twin_kw, control)
    for tag, short, kw in PREFIX_SERVES.get(sh.arch, ()):
        if short:
            cut = cut or cut_depth(cfg, params, sh.arch)
        run_prefix(*(cut if short else (cfg, params)), dev, sh, tag, kw)
    if sh.arch == "smollm-135m":
        run_prefix_preempted(*(cut or cut_depth(cfg, params, sh.arch)), dev,
                             sh)
        seq_prefix_parity(dev)
    print(f"stripe and prefix phases ({cfg.name}): {time.time() - t0:.1f} s")


# -- phase 13: faults and self-healing (§2.13) -------------------------------

def fault_prompts(cfg, lens=FAULT_LENS, seed=13):
    import numpy as np
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, size=n) for n in lens]


def armed(*specs):
    """A fault injector over ``specs`` (none: an empty plan)."""
    from repro_torch.serving.faults import FaultInjector, FaultPlan
    return FaultInjector(FaultPlan(specs=tuple(specs)))


def fault_report(tag: str, eng, done) -> dict:
    """Print a serve's fault counters, injected events and failed rids
    with their reasons; return ``{rid: fail_reason}``."""
    from repro_torch.launch.serve import faults_line
    bs = eng.decode_bubble_stats
    failed = {r.rid: r.fail_reason for r in done if r.failed}
    print(f"faults[{tag}]: {faults_line(bs, len(failed))}; injected_events "
          f"{bs['injected_events']}; failed {failed or 'none'}")
    return failed


def fault_serve(eng, prompts, tag: str, sampling=None):
    """``eng.serve`` of ``prompts`` (``FAULT_TOKENS`` greedy tokens unless
    ``sampling``); prints the fault report and the time.  Returns the
    tokens by rid and the failed rids' reasons."""
    import torch
    from repro_torch.serving import SamplingParams
    sp = sampling or SamplingParams(max_tokens=FAULT_TOKENS)
    torch.cuda.synchronize()
    t0 = time.time()
    done = eng.serve(prompts, sp)
    torch.cuda.synchronize()
    print(f"faults[{tag}]: {len(done)} requests in {time.time() - t0:.2f} s")
    failed = fault_report(tag, eng, done)
    return {r.rid: list(r.generated) for r in done}, failed


def free_card() -> None:
    """Return the pools of engines just deleted to the card (an engine and
    its batcher refer to each other: collect the cycle first)."""
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def sentinel_cost(eng, dev, reps: int = 200) -> None:
    """The sentinel's cost per decode tick, alone: ``Engine._sample`` on a
    decode call's logits ``[8, vocab]`` with the check off and on, in
    turns (off, on, on, off), host clock around calls that each end in
    the tokens' copy to the host."""
    import torch
    from repro_torch.serving import SamplingParams
    logits = torch.randn(B, eng.cfg.vocab_size, device=dev)
    rows = [(s, s) for s in range(B)]
    sp = SamplingParams()
    times = {False: [], True: []}
    for on in (False, True, True, False):
        eng.ecfg.sentinels = on
        for _ in range(10):
            eng._sample(logits, sp, rows)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            eng._sample(logits, sp, rows)
        times[on].append(1e3 * (time.perf_counter() - t0) / reps)
    eng.ecfg.sentinels = True
    off, on = (min(times[False]), min(times[True]))
    print(f"sentinel cost: sampling a decode tick's logits [{B}, "
          f"{eng.cfg.vocab_size}] takes {off:.4f} ms without the check and "
          f"{on:.4f} ms with it ({on - off:+.4f} ms a tick; host clock, one "
          f"device-to-host copy either way; best of two runs of {reps})")


def run_disabled(cfg, params, dev, want) -> None:
    """Phase 13.1: an engine with an empty-plan injector (and the default
    sentinels) serves phase 5's traffic with its recorded tokens."""
    inj = armed()
    eng = build_engine(cfg, params, dev, injector=inj)
    got, _ = run_serve(eng, serve_prompts(cfg), "paged,packed,empty plan",
                       SMOL)
    fault_report("paged,packed,empty plan", eng, [])
    print(f"faults[empty plan]: greedy tokens {'==' if got == want else '!='}"
          f" phase 5's default serve; {len(inj.events)} events")
    if got != want or inj.events:
        fail("an engine with an empty-plan injector changed phase 5's tokens")
    sentinel_cost(eng, dev)
    del eng
    free_card()


def watch_scrub(eng) -> list:
    """Wrap ``_release_seq`` to read, right after it, the blocks (slot
    row) it scrubbed: ``(rid, ids, codes all 0, scales all 1)`` per
    release."""
    import torch
    from repro_torch.core.quant import code_bits
    seen, inner = [], eng._release_seq

    def release(rid, slot):
        if eng.paged:
            alloc = eng.kv.alloc
            ids = [b for b in alloc.table(rid)
                   if alloc.refcount(b) == 1 and not alloc.is_cached(b)]
        else:
            ids = [slot]
        inner(rid, slot)
        codes, scales = eng._live_cache()
        at = torch.tensor(ids, device=eng.device)
        bits = code_bits(codes) if codes.element_size() == 1 else codes
        zero = not bool(bits.index_select(2, at).any())
        ones = scales is None or bool(
            (scales.index_select(2, at) == 1.0).all())
        seen.append((rid, ids, zero, ones))
    eng._release_seq = release
    return seen


def run_kv_corrupt(cfg, params, dev, cut) -> dict:
    """Phase 13.2: ``kv_corrupt`` (NaN, full depth paged bf16; Inf on the
    int8 pool's scales, and NaN on the contiguous layout, both cut):
    exactly one request fails with a sentinel's reason, every other gives
    the clean serve's tokens, the victim's released blocks read codes 0
    and scales 1, the engine audits clean and serves the clean tokens
    again.  Returns the clean serves' tokens by tag (the cut paged bf16
    one for the control and the poisoned serve; all for the restores)."""
    from repro_torch.serving.faults import FaultSpec
    prompts = fault_prompts(cfg)
    cleans = {}
    for tag, (c, p), kw, mode in (
            ("paged,bf16", (cfg, params), {}, "nan"),
            ("paged,bf16,cut", cut, {}, None),
            ("paged,int8,cut", cut, {"kv_dtype": "int8"}, "inf"),
            ("contiguous,bf16,cut", cut, {"cache_layout": "contiguous"},
             "nan")):
        eng = build_engine(c, p, dev, **kw)
        clean, _ = fault_serve(eng, prompts, f"{tag} clean")
        cleans[tag] = clean
        del eng
        free_card()
        if mode is None:
            continue
        inj = armed(FaultSpec(seam="kv_corrupt", mode=mode, after=2))
        eng = build_engine(c, p, dev, injector=inj, **kw)
        scrubs = watch_scrub(eng)
        got, failed = fault_serve(eng, prompts, f"{tag} kv_corrupt {mode}")
        same = {rid: got[rid] == clean[rid] for rid in got
                if rid not in failed}
        audit = eng.audit(strict=False)
        print(f"faults[{tag} kv_corrupt {mode}]: others == clean {same}; "
              f"scrubbed {[(rid, len(ids), z, o) for rid, ids, z, o in scrubs]}"
              f" (rid, blocks, codes 0, scales 1); audit "
              f"{'clean' if not audit else audit}")
        if (len(failed) != 1 or not set(failed.values())
                <= {"nonfinite_logits", "probe_nonfinite"}
                or not all(same.values()) or audit):
            fail(f"{tag}: the corruption did not fail exactly one request "
                 f"with the others unchanged and a clean audit")
        if not scrubs or not all(z and o for _, _, z, o in scrubs):
            fail(f"{tag}: the victim's released blocks are not scrubbed")
        again, failed = fault_serve(eng, prompts, f"{tag} second serve")
        print(f"faults[{tag} second serve]: tokens "
              f"{'==' if again == clean else '!='} the clean serve's")
        if again != clean or failed:
            fail(f"{tag}: the engine's second serve after the corruption "
                 f"differs from the clean serve")
        del eng
        free_card()
    return cleans


def scrub_control(cfg, params, dev, clean) -> None:
    """Phase 13.2's planted control (cut): the scrub skipped, the
    victim's corrupted block (NaN in every value row) is recycled twice
    into the next request (1010 prompt tokens: eight blocks, the last
    holding 114).  First as its ninth block, which its decode crosses into
    and writes one position a tick: the decode kernels copy no key past the
    position, so the stale rows past it never reach an output.  Then as its
    eighth, the prompt's last and partly filled block: the final chunk
    scatters its whole 256-row bucket, padding rows included, before the
    bf16 prefill (#2) takes the whole V tile into its P.V, so no stale row
    is left to read.  Both serves must keep the clean tokens: on the card
    no served path reads a recycled block's stale rows, and the scrub
    guards the plain versions (CPU: ``tests/test_torch_faults.py``) and
    #2's whole-tile P.V over a partly written block
    (``test_cuda_stale_nan_past_the_length_leaks``).  (The fault serve
    itself may already recycle the block into another request:
    printed.)"""
    from repro_torch.serving.faults import FaultSpec
    prompts = fault_prompts(cfg)
    inj = armed(FaultSpec(seam="kv_corrupt", mode="nan", after=2))
    eng = build_engine(cfg, params, dev, injector=inj)
    dirty = []

    def unscrubbed(rid, slot):
        if not dirty:                       # the corrupted victim's block
            dirty.append(eng.kv.alloc.table(rid)[0])
    eng._release_seq = unscrubbed
    got, failed = fault_serve(eng, prompts, "control: scrub skipped")
    parted = [rid for rid in got if rid not in failed
              and got[rid] != clean[rid]]
    print(f"faults[control]: the fault serve itself failed {sorted(failed)}"
          f" and parted {parted} (the scrubbed serve fails one, parts "
          f"none)")
    nxt = prompts[2]
    k = eng.kv.alloc.blocks_needed(len(nxt))
    for where, before in (("decode block", k), ("last prefill block", k - 1)):
        free = eng.kv.alloc._free[0]
        free.remove(dirty[0])
        free.insert(len(free) - before, dirty[0])   # popped after `before`
        got, failed = fault_serve(eng, [nxt], f"control: dirty {where}")
        parted = bool(failed) or got[0] != clean[2]
        print(f"faults[control]: block {dirty[0]} recycled unscrubbed into "
              f"the next request's {where}: "
              f"{'parted' if parted else 'kept'} (failed {failed or 'none'})")
        if parted:
            fail(f"a serve read the recycled dirty block's stale rows as "
                 f"its {where} (the skipped-scrub control parted from the "
                 f"clean tokens)")
    del eng
    free_card()


def run_poison(cfg, params, dev, clean) -> None:
    """Phase 13.3 (cut): ``poison_request`` on rid 1 fails it with no
    tokens; the others give the clean tokens."""
    from repro_torch.serving.faults import FaultSpec
    prompts = fault_prompts(cfg)
    eng = build_engine(cfg, params, dev,
                       injector=armed(FaultSpec(seam="poison_request",
                                                rid=1)))
    got, failed = fault_serve(eng, prompts, "paged,bf16,cut poison rid 1")
    others = all(got[r] == clean[r] for r in got if r != 1)
    if list(failed) != [1] or got[1] or not others:
        fail("the poisoned request did not fail alone with no tokens")
    del eng
    free_card()


def run_swap_faults(cfg, params, dev) -> None:
    """Phase 13.4 (cut), phase 11's preempted shape (56-block pool, two
    batch requests and a later interactive one): one ``swap_out_transfer``
    fault heals on a retry; ``swap_in_transfer`` failing past
    ``swap_retries`` discards the victim and requeues it, and its
    recomputed tokens are the uninterrupted serve's; the host tier ends
    empty."""
    from repro_torch.serving import SamplingParams
    from repro_torch.serving.faults import FaultSpec
    sp = SamplingParams(max_tokens=32)     # phase 11's, which preempts
    prompts = preempt_prompts(cfg)
    eng = build_engine(cfg, params, dev)
    want, _ = drive_interrupt(eng, prompts, sp)
    del eng
    free_card()
    retries = 3
    for tag, spec, key in (
            ("swap-out fault once", FaultSpec(seam="swap_out_transfer"),
             "swap_recoveries"),
            ("swap-in fault past the retries",
             FaultSpec(seam="swap_in_transfer", times=retries + 1),
             "swap_giveups")):
        inj = armed(spec)
        eng = build_engine(cfg, params, dev, injector=inj,
                           num_kv_blocks=PREEMPT_BLOCKS, preemption=True,
                           swap_retries=retries)
        t0 = time.time()
        got, b = drive_interrupt(eng, prompts, sp)
        fault_report(tag, eng, [])
        fs = eng.fault_stats
        discards = b.stats.per_class["batch"]["swap_discards"]
        print(f"faults[{tag}]: {time.time() - t0:.2f} s; swaps "
              f"{eng.swap_stats['swapped_out']} out / "
              f"{eng.swap_stats['swapped_in']} in, batch swap_discards "
              f"{discards}; tokens {'==' if got == want else '!='} the "
              f"uninterrupted serve's; host tier {len(eng._host_swaps)} "
              f"copies, {b.alloc.host_allocated_blocks} blocks")
        if (got != want or fs[key] != 1 or eng._host_swaps
                or b.alloc.host_allocated_blocks
                or discards != (key == "swap_giveups")):
            fail(f"{tag}: the swap fault did not {'heal' if key == 'swap_recoveries' else 'discard and recompute'} "
                 f"with the uninterrupted tokens")
        del eng, b
        free_card()


def run_epoch_rollback(cfg, params, dev) -> None:
    """Phase 13.5 (cut, D = 3: one KV group a shard): the first
    ``replan_now`` to the shards-rotated plan fails at the ``epoch_swap``
    seam and returns False with the params object and the epoch
    unchanged; the engine serves on; the next one lands, and the serve
    equals a control engine that adopted the moved plan directly."""
    from repro_torch.serving.faults import FaultSpec
    prompts = fault_prompts(cfg)
    eng = build_engine(cfg, params, dev, num_model_shards=3,
                       injector=armed(FaultSpec(seam="epoch_swap")))
    before, _ = fault_serve(eng, prompts, "D=3 before the swap")
    plan, epoch, weights, pool = eng.plan, eng.epoch, eng.params, eng.kv.pool
    t0 = time.time()
    ok = eng.replan_now(plan=rotate_shards(eng.plan))
    kept = (eng.plan is plan and eng.epoch == epoch
            and eng.params is weights and eng.kv.pool is pool)
    print(f"faults[epoch swap]: failed swap returned {ok} in "
          f"{time.time() - t0:.3f} s; plan, epoch, params and pool kept: "
          f"{kept}; rollbacks {eng.fault_stats['replan_rollbacks']}")
    if ok or not kept or eng.fault_stats["replan_rollbacks"] != 1:
        fail("the failed epoch swap did not roll back")
    same, _ = fault_serve(eng, prompts, "D=3 after the rollback")
    landed = eng.replan_now(plan=rotate_shards(eng.plan))
    moved, _ = fault_serve(eng, prompts, "D=3 after the swap landed")
    del eng
    free_card()
    ctrl = build_engine(cfg, params, dev, num_model_shards=3)
    ctrl.replan_now(plan=rotate_shards(ctrl.plan))
    want, _ = fault_serve(ctrl, prompts, "D=3 control, moved plan adopted")
    del ctrl
    free_card()
    print(f"faults[epoch swap]: after the rollback tokens "
          f"{'==' if same == before else '!='} before; second swap "
          f"{'landed' if landed else 'refused'}; its serve "
          f"{'==' if moved == want else '!='} the control's")
    if same != before or not landed or moved != want:
        fail("the engine did not serve on and then land the swap cleanly")


def shared_prefix_prompts(cfg, tails, unique, seed=14, shared=1024):
    import numpy as np
    rng = np.random.default_rng(seed)
    pre = rng.integers(0, cfg.vocab_size, size=shared)
    return ([np.concatenate([pre, rng.integers(0, cfg.vocab_size, size=n)])
             for n in tails]
            + [rng.integers(0, cfg.vocab_size, size=n) for n in unique])


def tick_until(eng, b, pf, df, done: list, until) -> None:
    while b.busy and not (b.replan_safe and until(b)):
        done.extend(b.tick(pf, df))


def snapshot_variant(cfg, params, dev, tag, kw, prompts, sp, want=None,
                     hit=None, control=False) -> None:
    """One crash and restore of phase 13.6: a run saved at a safe point
    once ``SNAPSHOT_TICK`` decode ticks passed with every request
    decoding, freed, restored on the card and finished, whose tokens must
    equal ``want`` (the uninterrupted run's; None: a tick-driven run first
    gives them).  ``hit``: a prompt served after the restored run, which
    must hit the restored prefix tree.  ``control``: the snapshot is
    restored a second time with the tables rotated by one, whose tokens
    must part.  Prints the snapshot's bytes and its save and restore
    times."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    from repro_torch.core.sparsity import synthetic_head_curves
    from repro_torch.serving.scheduler import Request
    from repro_torch.serving.snapshot import restore_serving, save_serving

    def start():
        eng = build_engine(cfg, params, dev, **kw)
        b = eng.make_batcher()
        for i, p in enumerate(prompts):
            b.submit(Request(rid=i, prompt=np.asarray(p, np.int32),
                             sampling=sp))
        return eng, b, *eng.step_fns(sp)

    if want is None:
        eng, b, pf, df = start()
        done = []
        tick_until(eng, b, pf, df, done, lambda b: False)
        want = {r.rid: r.generated for r in done}
        del eng, b, pf, df
        free_card()
    eng, b, pf, df = start()
    before = []
    tick_until(eng, b, pf, df, before, lambda b: (
        eng._decode_ticks >= SNAPSHOT_TICK
        and len(b.active) == len(prompts)))
    if len(b.active) != len(prompts):
        fail(f"snapshot[{tag}]: the crash point is not mid-stream")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_snapshot_")
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = save_serving(tmp, eng, b)
        t_save = time.perf_counter() - t0
        nbytes = Path(path).stat().st_size
        ecfg = eng.ecfg
        del eng, b, pf, df
        free_card()
        for rotated in ((False, True) if control else (False,)):
            t0 = time.perf_counter()
            eng, b = restore_serving(
                path, cfg, params, ecfg,
                synthetic_head_curves(cfg.num_layers, cfg.num_heads),
                device=dev)
            torch.cuda.synchronize()
            t_restore = time.perf_counter() - t0
            if rotated:
                for rid, t in b.alloc._tables.items():
                    if len(t) > 1:
                        b.alloc._tables[rid] = t[1:] + t[:1]
            pf, df = eng.step_fns(sp)
            done = list(before)
            tick_until(eng, b, pf, df, done, lambda b: False)
            same = {r.rid: r.generated for r in done} == want
            label = f"{tag}{', tables rotated (control)' if rotated else ''}"
            fault_report(f"snapshot {label}", eng, done)
            print(f"snapshot[{label}]: {nbytes} bytes at decode tick "
                  f"{SNAPSHOT_TICK}, saved in {t_save:.2f} s, restored in "
                  f"{t_restore:.2f} s (host clock, the pool copied to the "
                  f"host and back); restored tokens "
                  f"{'==' if same else '!='} uninterrupted")
            if same == rotated:
                fail(f"snapshot[{label}]: the restored serve "
                     f"{'kept' if rotated else 'changed'} the tokens")
            if hit is not None:
                hits = eng.prefix.stats["hits"]
                b.submit(Request(rid=len(prompts),
                                 prompt=np.asarray(hit, np.int32),
                                 sampling=sp))
                tick_until(eng, b, pf, df, [], lambda b: False)
                print(f"snapshot[{label}]: a request on the shared prefix "
                      f"after the restore: "
                      f"{eng.prefix.stats['hits'] - hits} hit(s)")
                if eng.prefix.stats["hits"] <= hits:
                    fail(f"snapshot[{label}]: the restored prefix tree did "
                         f"not hit")
            del eng, b, pf, df
            free_card()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def run_restores(cfg, params, dev, cut, clean) -> None:
    """Phase 13.6: crash and restore, tokens equal to the uninterrupted
    run's (``clean``: phase 13.2's clean serves of the same traffic, by
    tag): paged bf16 (full depth; and its rotated-tables control), paged
    int8, contiguous bf16, paged bf16 with the prefix cache at S = 2 (the
    restored tree hits), stochastic sampling (all cut)."""
    from repro_torch.serving import SamplingParams
    prompts = fault_prompts(cfg)
    greedy = SamplingParams(max_tokens=FAULT_TOKENS)
    stoch = SamplingParams(max_tokens=FAULT_TOKENS, **STOCHASTIC)
    shared = shared_prefix_prompts(cfg, (300, 500), (700,))
    for (c, p), tag, kw, ps, sp, extra in (
            ((cfg, params), "paged,bf16", {}, prompts, greedy,
             dict(want=clean["paged,bf16"], control=True)),
            (cut, "paged,int8,cut", {"kv_dtype": "int8"}, prompts, greedy,
             dict(want=clean["paged,int8,cut"])),
            (cut, "contiguous,bf16,cut", {"cache_layout": "contiguous"},
             prompts, greedy, dict(want=clean["contiguous,bf16,cut"])),
            (cut, "paged,bf16,prefix,S=2,cut",
             {"prefix_cache": True, "seq_shards": 2}, shared, greedy,
             dict(hit=shared[0])),
            (cut, "paged,bf16,stochastic,cut", {}, prompts, stoch, {})):
        snapshot_variant(c, p, dev, tag, kw, ps, sp, **extra)


def run_shared_corrupt(cfg, params, dev) -> None:
    """Phase 13.7 (cut, the prefix cache): ``kv_corrupt`` in the shared
    prefix block of two holders, once all three requests decode, fails
    both and invalidates the tree; the unrelated request keeps its clean
    tokens; a later request on the same prefix misses and gives the clean
    tokens."""
    from repro_torch.serving.faults import FaultSpec
    prompts = shared_prefix_prompts(cfg, (300, 500), (700,))
    eng = build_engine(cfg, params, dev, prefix_cache=True)
    widths, inner = [], eng.decode_slots

    def decode(slots, *a, **k):
        widths.append(len(slots))
        return inner(slots, *a, **k)
    eng.decode_slots = decode
    clean, _ = fault_serve(eng, prompts, "prefix,cut clean")
    del eng
    free_card()
    if len(prompts) not in widths:
        fail("prefix,cut: the clean serve never decoded all its requests "
             "at once")
    at = widths.index(len(prompts))
    eng = build_engine(cfg, params, dev, prefix_cache=True, injector=armed(
        FaultSpec(seam="kv_corrupt", mode="nan", after=at)))
    got, failed = fault_serve(eng, prompts, f"prefix,cut kv_corrupt at "
                              f"decode tick {at}")
    inval = eng.prefix.stats["invalidated_blocks"]
    hits = eng.prefix.stats["hits"]
    again, refail = fault_serve(eng, prompts[:1], "prefix,cut later request")
    missed = eng.prefix.stats["hits"] == hits
    print(f"faults[prefix,cut]: failed {sorted(failed)}, invalidated "
          f"{inval} blocks; unrelated tokens "
          f"{'==' if got[2] == clean[2] else '!='} clean; the later request "
          f"{'missed' if missed else 'hit'} and its tokens "
          f"{'==' if again[0] == clean[0] else '!='} clean")
    if (sorted(failed) != [0, 1] or inval < 1 or got[2] != clean[2]
            or not missed or again[0] != clean[0] or refail):
        fail("a corrupted shared block did not fail both holders alone, or "
             "the tree kept it")
    del eng
    free_card()


def run_chaos(cfg, params, dev) -> None:
    """Phase 13.8 (cut): ``FaultPlan.random(seed=0, rate=0.05)`` over all
    six seams on an engine with preemption, SLO admission, the prefix
    cache and an audit every tick: batch requests, then interactive and
    standard ones into a pool of ``CHAOS_BLOCKS``.  At every tick
    completed + rejected + failed equals the requests handed back and
    every audit passes; every completed request gives the clean serve's
    tokens (fifo, no faults)."""
    import numpy as np
    from repro_torch.serving import SamplingParams
    from repro_torch.serving.faults import FaultInjector, FaultPlan
    from repro_torch.serving.scheduler import Request
    sp = SamplingParams(max_tokens=FAULT_TOKENS)
    prompts = shared_prefix_prompts(cfg, (300, 500, 200), (1500, 700, 1010),
                                    shared=512)
    classes = ("batch", "batch", "batch", "interactive", "standard",
               "interactive")

    def drive(eng, check):
        b = eng.make_batcher()
        pf, df = eng.step_fns(sp)
        done = []
        for i in range(3):
            b.submit(Request(rid=i, prompt=np.asarray(prompts[i], np.int32),
                             sampling=sp, priority=classes[i]))
        ticks = 0
        while b.busy or ticks <= 6:
            if ticks == 6:
                for i in range(3, len(prompts)):
                    b.submit(Request(rid=i,
                                     prompt=np.asarray(prompts[i], np.int32),
                                     sampling=sp, priority=classes[i]))
            done.extend(b.tick(pf, df))
            eng.on_tick(b)
            ticks += 1
            st = b.stats
            if check and st.completed + st.rejected + st.failed != len(done):
                fail(f"chaos: at tick {ticks} completed {st.completed} + "
                     f"rejected {st.rejected} + failed {st.failed} != "
                     f"{len(done)} handed back")
        return done, b, ticks

    eng = build_engine(cfg, params, dev, prefix_cache=True,
                       num_kv_blocks=CHAOS_BLOCKS, preemption=True)
    clean, _, _ = drive(eng, False)
    clean = {r.rid: r.generated for r in clean}
    del eng
    free_card()
    plan = FaultPlan.random(seed=0, rate=0.05)
    inj = FaultInjector(plan)
    eng = build_engine(cfg, params, dev, injector=inj, prefix_cache=True,
                       num_kv_blocks=CHAOS_BLOCKS, preemption=True,
                       admission="slo", audit_every=1)
    t0 = time.time()
    done, b, ticks = drive(eng, True)
    failed = fault_report("chaos", eng, done)
    ok = [r.rid for r in done if r.done and not r.failed and not r.rejected]
    same = {rid: clean[rid] == next(r.generated for r in done
                                    if r.rid == rid) for rid in ok}
    seams = sorted({e["seam"] for e in inj.events})
    print(f"faults[chaos]: {len(plan.specs)} specs, {len(inj.events)} fired "
          f"({seams}); {ticks} ticks in {time.time() - t0:.2f} s, every tick "
          f"audited ({eng.fault_stats['audits']} clean audits); completed "
          f"{len(ok)}, rejected {b.stats.rejected}, failed {sorted(failed)}, "
          f"preempted {b.stats.preempted}, swap discards "
          f"{b.stats.swap_discards}; completed == clean {same}")
    if sorted(r.rid for r in done) != list(range(len(prompts))):
        fail("chaos: a request was not handed back")
    if not all(same.values()):
        fail("chaos: a completed request's tokens differ from the clean "
             "serve's")
    del eng, b
    free_card()


def fault_smoke_parity(dev) -> None:
    """Phase 13.9: SMOKE float32 (paged, bf16 cache): a ``kv_corrupt``
    serve fails the same request with the same tokens for the others on
    the card as on the CPU, and a serve saved, freed and restored on the
    card gives the CPU's uninterrupted tokens."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.sparsity import synthetic_head_curves
    from repro_torch.models.transformer import init_params
    from repro_torch.serving import Engine, EngineConfig, SamplingParams
    from repro_torch.serving.faults import FaultSpec
    from repro_torch.serving.scheduler import Request
    from repro_torch.serving.snapshot import restore_serving, save_serving
    cfg = dataclasses.replace(get_config("smollm-135m", smoke=True),
                              dtype=torch.float32)
    params = init_params(cfg, seed=1, device=dev)
    cpu = torch.device("cpu")
    weights = {dev: params, cpu: to_device(params, cpu)}
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, size=n)
               for n in (300, 40, 520, 129)]
    sp = SamplingParams(max_tokens=12)
    ecfg = EngineConfig(max_seq_len=1024, num_slots=4, budget_per_head=256)
    curves = synthetic_head_curves(cfg.num_layers, cfg.num_heads)

    def engine(d, inj=None):
        return Engine(cfg, weights[d], dataclasses.replace(ecfg), curves,
                      device=d, injector=inj)

    outs = {}
    for name, d in (("cpu", cpu), ("card", dev)):
        eng = engine(d, armed(FaultSpec(seam="kv_corrupt", after=2)))
        done = eng.serve(prompts, sp)
        outs[name] = ({r.rid: r.fail_reason for r in done if r.failed},
                      {r.rid: r.generated for r in done})
    print(f"smoke f32 kv_corrupt: failed {outs['cpu'][0]} on the CPU, "
          f"{outs['card'][0]} on the card; tokens "
          f"{'==' if outs['cpu'] == outs['card'] else '!='}")
    if outs["cpu"] != outs["card"] or len(outs["cpu"][0]) != 1:
        fail("smoke f32 kv_corrupt: card and CPU outcomes differ")
    want = {r.rid: r.generated for r in engine(cpu).serve(prompts, sp)}
    eng = engine(dev)
    b = eng.make_batcher()
    pf, df = eng.step_fns(sp)
    for i, p in enumerate(prompts):
        b.submit(Request(rid=i, prompt=np.asarray(p, np.int32), sampling=sp))
    done = []
    tick_until(eng, b, pf, df, done,
               lambda b: eng._decode_ticks >= SNAPSHOT_TICK and b.active)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_snapshot_")
    try:
        path = save_serving(tmp, eng, b)
        del eng, b, pf, df
        free_card()
        eng, b = restore_serving(path, cfg, params, dataclasses.replace(ecfg),
                                 curves, device=dev)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    pf, df = eng.step_fns(sp)
    tick_until(eng, b, pf, df, done, lambda b: False)
    got = {r.rid: r.generated for r in done}
    print(f"smoke f32 restored on the card: tokens "
          f"{'==' if got == want else '!='} the CPU's uninterrupted serve")
    if got != want:
        fail("smoke f32: the card's restored serve differs from the CPU's")
    del eng, b, pf, df
    free_card()


def fault_phases(cfg, params, dev, default_tokens) -> None:
    """Phase 13 for SmolLM-135M (the secondary serves at ``CUT_LAYERS``)."""
    t0 = time.time()
    run_disabled(cfg, params, dev, default_tokens)
    cut = cut_depth(cfg, params, cfg.name)
    cleans = run_kv_corrupt(cfg, params, dev, cut)
    scrub_control(*cut, dev, cleans["paged,bf16,cut"])
    run_poison(*cut, dev, cleans["paged,bf16,cut"])
    run_swap_faults(*cut, dev)
    run_epoch_rollback(*cut, dev)
    run_restores(cfg, params, dev, cut, cleans)
    run_shared_corrupt(*cut, dev)
    run_chaos(*cut, dev)
    fault_smoke_parity(dev)
    print(f"fault phases ({cfg.name}): {time.time() - t0:.1f} s")


# -- phase 14: the rest of the transformer family ----------------------------

def moe_card_check(p, moe_cfg, sh: Shapes, gen, dev) -> None:
    """``moe_ffn`` on the card in bf16 (the model's layer-0 experts ``p``)
    against its CPU run in float32 on the same bf16 inputs and weights,
    ``MOE_ROWS`` rows a call: the largest difference over the rows both
    route alike within ``MOE_ATOL``, at most ``MOE_REROUTED`` of the rows
    routed otherwise, and two card calls equal bit for bit (the combine
    sums each row's experts in a fixed order).  Prints the capacity and
    the pairs dropped in each call."""
    import torch
    from repro_torch.models import moe
    cpu_p = {k: v.float().cpu() for k, v in p.items()}
    E, k = moe_cfg.num_experts, moe_cfg.experts_per_token
    d = p["down"].shape[2]
    for n in MOE_ROWS:
        x = torch.randn((1, n, d), generator=gen).to(dev, torch.bfloat16)
        got = moe.moe_ffn(x, p, moe_cfg)
        same = torch.equal(got, moe.moe_ffn(x, p, moe_cfg))
        want = moe.moe_ffn(x.float().cpu(), cpu_p, moe_cfg)
        C = moe._capacity(n, moe_cfg)
        slot = moe.route(x[0], p["router"], moe_cfg)[0].cpu()
        alike = (slot == moe.route(x[0].float().cpu(), cpu_p["router"],
                                   moe_cfg)[0]).all(-1)
        err = (got[0].float().cpu() - want[0])[alike].abs().max().item()
        moved = n - int(alike.sum())
        print(f"moe{sh.tag}[{n} rows]: {E} experts, top {k}, capacity {C}: "
              f"{int((slot == E * C).sum())} of {n * k} pairs dropped on the "
              f"card; bf16 card vs f32 CPU max abs err {err:.3e} over "
              f"{n - moved} rows routed alike (tolerance {MOE_ATOL:g}), "
              f"{moved} routed otherwise; two card calls "
              f"{'==' if same else '!='} bit for bit")
        if not same:
            fail(f"{sh.arch}: two card calls of moe_ffn differ")
        if not err <= MOE_ATOL or moved > MOE_REROUTED * n:
            fail(f"{sh.arch}: moe_ffn on the card leaves its CPU run "
                 f"({err:.3e}, {moved} rows routed otherwise)")


@contextlib.contextmanager
def counted_drops():
    """While the block runs, count the MoE FFN's calls, routed pairs and
    dropped pairs (a running sum on the device, read once at the end)."""
    from repro_torch.models import moe
    route, got, per_call = moe.route, {"calls": 0, "pairs": 0}, []

    def counted(xf, router, cfg):
        slot, gate = route(xf, router, cfg)
        C = moe._capacity(xf.shape[0], cfg)
        per_call.append((slot == cfg.num_experts * C).sum())
        got["calls"] += 1
        got["pairs"] += slot.numel()
        return slot, gate

    moe.route = counted
    try:
        yield got
    finally:
        moe.route = route
        counts = [int(c) for c in per_call]
        got["dropped"] = sum(counts)
        got["dropping"] = sum(c > 0 for c in counts)


def granite_parity(dev) -> None:
    """Granite-MoE-1B's widths at ``FAMILY_PARITY``'s depth in float32,
    paged and contiguous: the card's greedy tokens == the plain versions'
    on the CPU (the MoE FFN on both devices)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_params
    depth, lens = FAMILY_PARITY
    cfg = dataclasses.replace(get_config(GRANITE.arch), num_layers=depth,
                              dtype=torch.float32)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, size=n) for n in lens]
    smoke_parity(cfg, dev, prompts, ("bf16",),
                 init_params(cfg, seed=3, device=dev, host_rng=False), 8,
                 f"{GRANITE.arch} {depth}-layer")


def family_model(dev, gen, sh: Shapes) -> None:
    """One model of phase 14 at full width and its ``FAMILY_SERVES``
    depth, weights from a seeded torch generator on the card: the MoE
    check (a MoE model), the decode kernels against their plain versions
    at its shapes (``FAMILY_DECODE_CHECKS``), its serves (contiguous ==
    paged bit for bit; a MoE model's dropped pairs printed); the weights
    freed after."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_params
    t0 = time.time()
    depth, serves = FAMILY_SERVES[sh]
    full = get_config(sh.arch)
    cfg = full if depth is None else dataclasses.replace(full,
                                                         num_layers=depth)
    params = init_params(cfg, seed=0, device=dev, host_rng=False)
    torch.cuda.synchronize()
    print(f"full-width {cfg.name}: {cfg.num_layers} of {full.num_layers} "
          f"layers, {cfg.num_params / 1e9:.3f}B params "
          f"({full.num_params / 1e9:.3f}B at full depth), "
          f"{cfg.num_active_params / 1e9:.3f}B active a token; "
          f"{torch.cuda.memory_allocated(dev) / 1e9:.1f} GB on the card; "
          f"weight init {time.time() - t0:.1f} s")
    if cfg.moe is not None:
        moe_card_check(params["layers"][0]["moe"], cfg.moe, sh, gen, dev)
    prompts = serve_prompts(cfg)
    tokens = {}
    for tag, kw in serves:
        eng = build_engine(cfg, params, dev, **kw)
        if sh in FAMILY_DECODE_CHECKS and not tokens:
            check_decode(eng, gen, dev, {}, sh, (torch.bfloat16,))
        with counted_drops() as drops:
            tokens[tag], _ = run_serve(eng, prompts, tag, sh)
        if cfg.moe is not None:
            print(f"serve[{sh.arch}:{tag}]: MoE FFN calls "
                  f"{drops['calls']}, pairs dropped {int(drops['dropped'])} "
                  f"of {drops['pairs']} routed (pad rows of the buckets "
                  f"included), in {drops['dropping']} calls")
        del eng
        free_card()
    if "contiguous,packed" in tokens:
        same = tokens["contiguous,packed"] == tokens["paged,packed"]
        print(f"serve[{sh.arch}:contiguous,packed]: greedy tokens "
              f"{'==' if same else '!='} paged,packed")
        if not same:
            fail(f"{sh.arch}: the contiguous tokens differ from the paged "
                 f"serve's")
    del params
    free_card()
    print(f"transformer-family phases ({cfg.name}): "
          f"{time.time() - t0:.1f} s")


def family_phases(dev, gen) -> None:
    """Phase 14: Granite-MoE-1B's float32 parity, then each model of
    ``FAMILY_SERVES``."""
    t0 = time.time()
    granite_parity(dev)
    print(f"transformer-family parity ({GRANITE.arch}): "
          f"{time.time() - t0:.1f} s")
    for sh in FAMILY_SERVES:
        family_model(dev, gen, sh)


# -- phase 15: the multi-GPU islands on one card ------------------------------

def mesh_loaded(paths, dev):
    """Each rank's record (``torch.save``) on the card, by rank."""
    import torch
    return [torch.load(p, map_location=dev, weights_only=False)
            for p in paths]


def bits_equal(name: str, got, want) -> None:
    import torch
    torch.cuda.synchronize()
    same = torch.equal(got, want)
    print(f"{name}: {'bit for bit' if same else 'DIFFERS from'} the same "
          f"work done here")
    if not same:
        fail(f"{name}: a rank's island output differs from the same work "
             f"done here on its inputs")


def merged_check(name: str, got, parts, merge, want) -> None:
    """A merged output ``got`` against this process's merge of the ranks'
    ``parts`` and against the one-process result ``want``, within
    ``MESH_MERGE_ATOL``; the planted controls, the merge with each rank's
    part left out in turn, must each miss ``want`` by more."""
    atol = MESH_MERGE_ATOL
    mine = merge(parts)
    err_m = (got.float() - mine.float()).abs().max().item()
    err = (got.float() - want.float()).abs().max().item()
    ctls = [(merge(parts[:i] + parts[i + 1:]).float()
             - want.float()).abs().max().item() for i in range(len(parts))]
    print(f"{name}: merged vs one process max abs err {err:.3e}, vs the "
          f"ranks' parts merged here {err_m:.3e} (tolerance {atol:g}); "
          f"controls, each rank's part dropped in turn: "
          f"{', '.join(f'{c:.3e}' for c in ctls)}")
    if not (err <= atol and err_m <= atol):
        fail(f"{name}: the merged output misses the one-process result "
             f"({err:.3e}, {err_m:.3e})")
    if not min(ctls) > atol:
        fail(f"{name}: the control dropping rank {ctls.index(min(ctls))}'s "
             f"part passed ({min(ctls):.3e})")


def decode_merge(parts):
    """The flash-decoding merge of ``(out, m, l)`` partials in rank order
    (``merge_partials``), as ``[B, H, 1, D]`` bf16."""
    import torch
    from repro_torch.kernels.flash_decode import merge_partials
    B, hkv, G = parts[0][1].shape
    dh = parts[0][0].shape[-1]
    out = merge_partials(torch.stack([o.reshape(B, hkv, G, dh)
                                      for o, _, _ in parts]),
                         torch.stack([m for _, m, _ in parts]),
                         torch.stack([l for _, _, l in parts]))[0]
    return out.reshape(B, hkv * G, 1, dh).to(torch.bfloat16)


def union_ids(ids):
    """The shards' global block ids ``[1, Hkv, nb]`` joined: ``[Hkv, n]``
    ascending, -1 trailing."""
    import torch
    x = torch.cat([i[0] for i in ids], dim=-1)
    big = torch.iinfo(torch.int32).max
    x = torch.where(x < 0, big, x).sort(dim=-1).values
    return torch.where(x == big, -1, x).to(torch.int32)


def check_wo_sum(name: str, recs) -> None:
    """The ranks' ``wo`` partial products summed over ``model`` against
    one process's product of the gathered island rows and ``wo``, relative
    to the product's largest ``|value|``; the controls, the sum with each
    rank's partial left out in turn, must each miss it."""
    import torch
    from repro_torch.models.common import merge_heads
    got = recs[0]["wo_sum"].float()
    want = (merge_heads(torch.cat([r["wo_rows"] for r in recs], dim=1))
            @ torch.cat([r["wo"] for r in recs], dim=0)).float()
    top = want.abs().max().item()
    err = (got - want).abs().max().item() / top
    ctls = [(sum(r["wo_partial"].float() for j, r in enumerate(recs)
                 if j != i) - want).abs().max().item() / top
            for i in range(len(recs))]
    same = all(torch.equal(r["wo_sum"], recs[0]["wo_sum"]) for r in recs)
    print(f"{name}: wo summed over model vs one process: max err "
          f"{err:.3e} of max |x| {top:.4g} (tolerance {MESH_REDUCE_RTOL:g})"
          f", ranks equal {same}; controls, each rank's partial left out in "
          f"turn: {', '.join(f'{c:.3e}' for c in ctls)}")
    if not (err <= MESH_REDUCE_RTOL and same):
        fail(f"{name}: the wo sum misses the one-process product")
    if not min(ctls) > MESH_REDUCE_RTOL:
        fail(f"{name}: the control leaving out rank "
             f"{ctls.index(min(ctls))}'s partial passed ({min(ctls):.3e})")


def check_mesh_records(tag: str, run0: dict, runs, dev) -> None:
    """The checks of one shape's recorded layer-0 island calls: prefill,
    then the first decode step."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.sparse_prefill import sparse_prefill_attention
    from repro_torch.serving import sharded_attention as isl
    for kind in ("prefill", "decode"):
        paths = [r[f"{kind}_record"] for r in runs]
        if paths[0] is None:
            continue
        recs = mesh_loaded(paths, dev)
        name = f"mesh[{tag}:{kind}]"
        if kind == "prefill" and run0["mode"] == "rows":
            parts = [isl.hplb_prefill_attention()(*r["inputs"])
                     for r in recs]
            l, q, k, v, _ = recs[0]["inputs"]
            every = torch.cat([r["inputs"][4][0, l] for r in recs])
            want = torch.stack([sparse_prefill_attention(
                q[b].contiguous(), k[b].contiguous(), v[b].contiguous(),
                every) for b in range(q.shape[0])])
            merged_check(name + " rows", recs[0]["output"], parts,
                         lambda ps: sum(p.float() for p in ps).to(
                             torch.bfloat16), want)
        elif kind == "prefill":
            for r, rec in enumerate(recs):
                bits_equal(f"{name} rank {r}", rec["output"],
                           isl.hplb_prefill_attention()(*rec["inputs"]))
        elif run0["branch"] == "heads":
            for r, rec in enumerate(recs):
                bits_equal(f"{name} rank {r}", rec["output"],
                           isl.hplb_decode_attention_packed()(
                               *rec["inputs"]))
        else:
            q, _, _, _, pos, _, _ = recs[0]["inputs"]
            parts = [isl.seq_shard_partials(
                q, r["inputs"][1], r["inputs"][2], r["inputs"][3], pos, i,
                block_kv=BLK) for i, r in enumerate(recs)]
            ids = union_ids([r["inputs"][3] for r in recs])
            want = ops.flash_decode(
                q, torch.cat([r["inputs"][1] for r in recs], dim=2),
                torch.cat([r["inputs"][2] for r in recs], dim=2),
                ids[None].expand(q.shape[0], -1, -1).contiguous(), pos,
                block_kv=BLK)
            merged_check(name + " seq", recs[0]["output"], parts,
                         decode_merge, want)
        if "wo_sum" in recs[0]:
            check_wo_sum(name, recs)
        del recs
        free_card()


def check_mesh_launches(tag: str, run: dict, want: dict) -> None:
    """Each of ``want``'s kernels launched at least that often on a
    rank."""
    short = [k for k, n in want.items() if run["launches"].get(k, 0) < n]
    if short:
        fail(f"{tag}: kernels {short} launched less than {want}: "
             f"{run['launches']}")


def mesh_job(arch: str, model: int, layers: int, shapes, record_dir):
    """The ``MeshJob`` of a ``MESH_RUNS`` entry (gloo, every rank on the
    card; layer 0's island calls recorded)."""
    from repro_torch.configs import ShapeSpec
    from repro_torch.launch.steps import make_job
    return make_job(arch, [ShapeSpec(*sh) for sh in shapes], model=model,
                    layers=layers, seed=0, steps=MESH_STEPS, record_layer=0,
                    record_dir=record_dir)


def check_mesh_run(job, ranks, dev) -> None:
    """The prints and checks of one ``MESH_RUNS`` entry's ranks."""
    t0 = time.time()
    arch, model, layers = job.arch, job.model, job.layers
    for i, sp in enumerate(job.shapes):
        run0 = ranks[0]["runs"][i]
        tag = f"{arch}[model={model}]:{sp.name}"
        print(f"mesh[{tag}]: {layers} layers, batch {sp.global_batch}, "
              f"{sp.seq_len} positions; list mode {run0['mode']}, decode "
              f"branch {run0['branch']}; plan device_loads (layer 0) "
              f"{run0['device_loads'][0]}, mean imbalance "
              f"{run0['imbalance']:.4f}")
        for r in ranks:
            run = r["runs"][i]
            pre = run.get("prefill_island_ms", [])
            dec = run["decode_island_ms"]
            print(f"  rank {r['rank']}: island ms (ranks contend for one "
                  f"card's SMs: not the cross-GPU bubble) prefill "
                  f"{sum(pre):.3f} (layer 0 {pre[0] if pre else 0:.3f}), "
                  f"decode {sum(dec):.3f} over {len(dec)} calls; walls "
                  f"prefill {run.get('prefill_s', 0):.3f} s, decode "
                  f"{run['decode_s']:.3f} s; launches {run['launches']}")
            if run["tokens"] != run0["tokens"]:
                fail(f"mesh[{tag}]: rank {r['rank']} holds other tokens")
            want = {"flash_decode_contig": MESH_STEPS * layers}
            if sp.kind == "prefill":
                want["sparse_prefill_contig"] = layers
            check_mesh_launches(f"mesh[{tag}] rank {r['rank']}", run, want)
        print(f"  greedy tokens: {run0['tokens']}")
        check_mesh_records(tag, run0, [r["runs"][i] for r in ranks], dev)
    print(f"mesh checks ({arch}, model={model}): {time.time() - t0:.1f} s")


def check_islands_alone(ranks, dev) -> None:
    """The islands alone at Yi-6B's widths on 4 ranks (``island_rank``)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import permute_cache_kv_heads
    from repro_torch.serving import sharded_attention as isl
    t0 = time.time()
    for r in ranks:
        print(f"mesh[islands@yi-6b] rank {r['rank']}: island ms "
              f"{ {k: round(v, 4) for k, v in r['ms'].items()} }, launches "
              f"{r['launches']}")
        check_mesh_launches(f"mesh[islands] rank {r['rank']}", r,
                            {"flash_decode_paged": 2,
                             "flash_decode_contig": 1})
    recs = mesh_loaded([r["record"] for r in ranks], dev)
    for key, group, stripe in (("paged", "data", "model"),
                               ("twod", "model", "seq")):
        for g in (0, 1):
            mine = sorted((r for r in recs if r["coords"][key][group] == g),
                          key=lambda r: r["coords"][key][stripe])
            q, _, _, ids, table, pos = mine[0][key]["args"]
            n_loc = mine[0][key]["args"][1].shape[0]
            parts = [ops.flash_decode_paged(
                q, r[key]["args"][1], r[key]["args"][2], ids,
                isl.local_table(table, i * n_loc, n_loc), pos,
                partials=True) for i, r in enumerate(mine)]
            want = ops.flash_decode_paged(
                q, torch.cat([r[key]["args"][1] for r in mine]),
                torch.cat([r[key]["args"][2] for r in mine]), ids, table,
                pos)
            merged_check(f"mesh[islands:{key} {group} {g}]",
                         mine[0][key]["out"], parts, decode_merge, want)
    for r, rec in enumerate(recs):
        bits_equal(f"mesh[islands:packed8] rank {r}", rec["packed8"]["out"],
                   isl.hplb_decode_attention_packed()(
                       *rec["packed8"]["args"]))
    by_model = sorted((r for r in recs if r["coords"]["paged"]["data"] == 0),
                      key=lambda r: r["coords"]["paged"]["model"])
    rp = by_model[0]["reperm"]
    bits_equal("mesh[islands:repermute] vs permute_cache_kv_heads",
               torch.cat([r["reperm"]["out"] for r in by_model], dim=3),
               permute_cache_kv_heads(rp["full"], rp["kv_perm"]))
    sw = by_model[0]["swap"]
    blocks = torch.cat([r["swap"]["blocks"] for r in by_model], dim=3)
    bits_equal("mesh[islands:swap gather] vs a take", blocks,
               sw["full"][:, :, sw["ids"]])
    after = sw["full"].clone()
    after[:, :, sw["new_ids"]] = blocks
    bits_equal("mesh[islands:swap scatter] vs a put",
               torch.cat([r["swap"]["pool"] for r in by_model], dim=3),
               after)
    del recs
    free_card()
    print(f"mesh checks (islands alone): {time.time() - t0:.1f} s")


def run_nccl_mesh() -> None:
    """A one-rank NCCL mesh (card 0) runs a Yi-6B prefill and decode: the
    NCCL process group initialises and the step runs on the card."""
    from repro_torch.configs import ShapeSpec
    from repro_torch.launch.steps import run_on_mesh
    t0 = time.time()
    ranks = run_on_mesh("yi-6b", ShapeSpec("prefill_4k", 4096, 1, "prefill"),
                        model=1, layers=1, backend="nccl", device="cuda",
                        seed=0, steps=MESH_STEPS, timeout_s=MESH_TIMEOUT)
    run = ranks[0]["runs"][0]
    print(f"mesh[yi-6b nccl, 1 rank]: backend {ranks[0]['backend']}, "
          f"launches {run['launches']}, greedy tokens {run['tokens']}, "
          f"{time.time() - t0:.1f} s")
    if ranks[0]["backend"] != "nccl":
        fail("the one-rank mesh did not run on nccl")
    check_mesh_launches("mesh[nccl]", run, {"sparse_prefill_contig": 1,
                                            "flash_decode_contig": 2})


def mesh_phases(dev) -> None:
    """Phase 15: the ``MESH_RUNS`` of a world size, and on 4 ranks the
    islands alone, in one spawn each (a spawn costs the ranks' start);
    then the NCCL mesh.  The ranks' records go to a temporary directory,
    removed after."""
    import shutil
    import tempfile
    from repro_torch.launch.steps import IslandJob, run_mesh_jobs
    t0 = time.time()
    rdir = tempfile.mkdtemp(prefix="mesh-records-")
    try:
        for world in (4, 2):
            t1 = time.time()
            jobs = [mesh_job(*run, rdir) for run in MESH_RUNS
                    if run[1] == world]
            if world == 4:
                jobs.append(IslandJob(YI.H, YI.HKV, YI.D, 1, rdir))
            results = run_mesh_jobs(jobs, backend="gloo", device="cuda:0",
                                    timeout_s=MESH_TIMEOUT)
            print(f"mesh phase ({world} ranks: "
                  f"{', '.join(getattr(j, 'arch', 'islands') for j in jobs)}"
                  f"): ranks {time.time() - t1:.1f} s")
            for job, ranks in zip(jobs, results):
                if isinstance(job, IslandJob):
                    check_islands_alone(ranks, dev)
                else:
                    check_mesh_run(job, ranks, dev)
        run_nccl_mesh()
    finally:
        shutil.rmtree(rdir, ignore_errors=True)
    print(f"mesh phases: {time.time() - t0:.1f} s")


def model_phases(dev, gen, results, sh: Shapes):
    """Phases 6 / 7 of a model: the kernel checks at its shapes (bf16 and
    f32 forms timed) and the float32 parity at ``PARITY``'s depth, with
    weights from a torch generator on the card (no check compares them
    with another device's but the parity, which copies the card's to the
    CPU); then its full-width serves.  A model of ``SHARDED_SERVES`` also
    runs phase 8's checks at its shapes and its serves at D > 1, and a
    model of ``BASELINE_SERVES`` phase 9's kernel checks and serves.
    Returns the launches of the kernels line (none from phase 8)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_params
    t0 = time.time()
    cfg = parity_config(sh)
    params = init_params(cfg, seed=3, device=dev, host_rng=False)
    eng = build_engine(cfg, params, dev)     # layer 0's plan: any depth
    launches = check_kernels(eng, gen, dev, results, sh,
                             (torch.bfloat16, torch.float32))
    del eng
    launches.update(f32_parity(dev, params, sh))
    windowed = "L" in cfg.attn_pattern
    if windowed:
        dense_f32_parity(dev, params, sh)
    print(f"kernel and parity phases ({sh.arch}): {time.time() - t0:.1f} s")
    sharded = sh.arch in SHARDED_SERVES
    if sharded:
        t0 = time.time()
        check_sharded_decode(build_engine(cfg, params, dev,
                                          num_model_shards=SHARDED_CHECK),
                             gen, dev, sh)
        sharded_parity(dev, params, sh)
        t_sharded = time.time() - t0
    del params

    t0 = time.time()
    cfg = get_config(sh.arch)
    params = init_params(cfg, seed=0, device=dev, host_rng=False)
    torch.cuda.synchronize()
    print(f"full-width {cfg.name}: {cfg.num_params / 1e9:.3f}B params, "
          f"weight init {1e3 * (time.time() - t0):.1f} ms (seeded torch "
          f"generator on the card)")
    t0 = time.time()
    got, full_tokens = run_full_serves(cfg, params, dev, sh)
    launches.update(got)
    print(f"serve phases ({cfg.name}): {time.time() - t0:.1f} s")
    if sh.arch in BASELINE_SERVES:
        t0 = time.time()
        check_baselines(gen, dev, sh, results,
                        cfg.local_window if windowed else None)
        launches.update(run_baseline_serves(
            cfg, params, dev, sh, {"paged": full_tokens["paged", "bf16"],
                                   "contiguous": full_tokens["contiguous",
                                                             "bf16"]}))
        print(f"baseline phases ({cfg.name}): {time.time() - t0:.1f} s")
    if sharded:
        t0 = time.time()
        run_sharded_serves(cfg, params, dev, sh)
        t_sharded += time.time() - t0
        print(f"head-parallel phases ({cfg.name}): {t_sharded:.1f} s")
    if sh.arch in HEAD_MOVE:
        t0 = time.time()
        run_head_move(*cut_depth(cfg, params, sh.arch), dev, sh)
        print(f"plan-epoch phases ({cfg.name}): {time.time() - t0:.1f} s")
    if sh.arch in PREEMPT_SERVES or sh.arch in STRADDLE:
        t0 = time.time()
        ocfg, oparams = cut_depth(cfg, params, sh.arch)
        for layout, kind in PREEMPT_SERVES.get(sh.arch, ()):
            run_preempted(ocfg, oparams, dev, sh, layout, kind)
        if sh.arch in STRADDLE:
            run_straddle(ocfg, oparams, dev, sh)
        del oparams
        print(f"overload phases ({cfg.name}): {time.time() - t0:.1f} s")
    if sh.arch in STRIPE_SERVES or sh.arch in PREFIX_SERVES:
        seq_prefix_phases(cfg, params, dev, sh)
    del params
    torch.cuda.empty_cache()
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false: this script needs "
              "an NVIDIA GPU", file=sys.stderr)
        return 2
    try:
        from repro_torch.kernels import build as kbuild
    except ImportError as e:
        fail(f"cannot import the port (run from the repo root): {e}")
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_params
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = (smi.stdout.strip().splitlines() or ["nvidia-smi: no output"])[0]
    print(f"device: {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}; {card}")
    t_start = time.time()

    t0 = time.time()
    logs = kbuild.build()
    print(f"build: {len(logs)} kernels compiled in {time.time() - t0:.1f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if any(w in line for w in ("entry function", "registers",
                                       "spill")):
                print(f"  {name}: {line.strip()}")
    decode_registers(kbuild, logs)
    tensor_core_counts(kbuild)

    results = {}
    gen = torch.Generator().manual_seed(0)
    t0 = time.time()
    cfg = get_config("smollm-135m")
    params = init_params(cfg, seed=0, device=dev)
    eng = build_engine(cfg, params, dev)     # its planner makes the work
    print(f"full-width {cfg.name}: {cfg.num_params / 1e6:.1f}M params, "
          f"set-up {time.time() - t0:.1f} s")
    launches = check_kernels(eng, gen, dev, results, SMOL,
                             (torch.bfloat16,))
    del eng

    t0 = time.time()
    got, tokens = run_serves(cfg, params, dev)
    launches.update(got)
    serve_smoke_parity(dev)
    print(f"serve phases ({cfg.name}): {time.time() - t0:.1f} s")
    t0 = time.time()
    run_sharded_serves(cfg, params, dev, SMOL)
    print(f"head-parallel phases ({cfg.name}): {time.time() - t0:.1f} s")
    t0 = time.time()
    check_baselines(gen, dev, SMOL)
    launches.update(run_baseline_serves(
        cfg, params, dev, SMOL, {"paged": tokens["paged,packed"],
                                 "contiguous": tokens["contiguous,packed"]}))
    run_stochastic_serves(cfg, params, dev, SMOL)
    dense_smoke_parity(dev)
    print(f"baseline phases ({cfg.name}): {time.time() - t0:.1f} s")
    t0 = time.time()
    run_replan_serve(cfg, params, dev, SMOL)
    replan_smoke_parity(dev)
    print(f"plan-epoch phases ({cfg.name}): {time.time() - t0:.1f} s")
    t0 = time.time()
    run_profile(cfg, params, dev)
    profile_smoke_parity(dev)
    for layout, kind in PREEMPT_SERVES[cfg.name]:
        run_preempted(*cut_depth(cfg, params, cfg.name), dev, SMOL, layout,
                      kind)
    print(f"profiling and overload phases ({cfg.name}): "
          f"{time.time() - t0:.1f} s")
    seq_prefix_phases(cfg, params, dev, SMOL)
    fault_phases(cfg, params, dev, tokens["paged,packed"])
    del params

    for sh in (YI, GEMMA):
        launches.update(model_phases(dev, gen, results, sh))
    family_phases(dev, gen)
    mesh_phases(dev)
    print(f"chip_smoke: {time.time() - t_start:.1f} s after the device "
          f"check")

    src = "src/repro_torch/kernels/csrc/"
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda",
         "source": f"{src}{name.partition('.')[0].partition('@')[0]}.cu",
         "replaces": KERNELS[name.partition('.')[0].partition('@')[0]],
         "launches": launches[name], **results[name]} for name in FORMS]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
