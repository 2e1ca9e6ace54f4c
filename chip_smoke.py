#!/usr/bin/env python3
"""Proof that the PyTorch/CUDA port (``src/repro_torch``) starts and is
right on an NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. device: require CUDA, print the card's ``name, power.limit``;
2. build: compile every CUDA kernel from ``src/repro_torch/kernels/csrc``
   (one ``nvcc`` per source, started together);
3. kernels: each kernel against its plain PyTorch version on the card, at
   the shapes the serving main path gives it, with the stated tolerances;
   kernel, plain-version and library (SDPA) times, and each kernel's bound;
4. serve: the full-width SmolLM-135M with seeded random bf16 weights
   serves 8 requests (300-3500 prompt tokens, 32 greedy tokens each)
   through ``Engine.serve``; every request completes, both kernels
   launched, the pool audit is clean; then a SMOKE-size float32 serve on
   the card must give the same greedy tokens as the same serve on the CPU
   (plain versions).

The last two lines are a JSON object of per-kernel numbers and the card
line, then ``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate
BF16_FLOP_PER_S = 989e12       # dense bf16 tensor-core peak
F32_FLOP_PER_S = 67e12         # float32 outside the tensor cores
DECODE_ATOL = 1e-4             # f32 out: sums taken in another order
PREFILL_F32_ATOL = 1e-4        # f32 inputs and output: sum order only
PREFILL_BF16_ATOL = 2.0 ** -6  # bf16 output: one bf16 ulp at |x| < 4


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


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


def check_decode(eng, gen, dev, results):
    import numpy as np
    import torch
    from repro_torch.core.worklist import padded_decode_items
    from repro_torch.kernels.flash_decode import (
        flash_decode_paged_kernel, packed_decode_attention_paged)
    B, Hkv, G, D, blk = 8, 3, 3, 64, 128
    T = eng.ecfg.max_seq_len // blk
    N = B * T + 1
    pos = torch.randint(3000, 4096, (B,), generator=gen, dtype=torch.int32)
    nblocks = (pos + 1 + blk - 1) // blk
    table = random_table(gen, B, nblocks, N - 1, T).to(dev)
    pos = pos.to(dev)
    kp = torch.randn((N, Hkv, blk, D), generator=gen).to(dev, torch.bfloat16)
    vp = torch.randn((N, Hkv, blk, D), generator=gen).to(dev, torch.bfloat16)
    q = torch.randn((B, Hkv, G, D), generator=gen).to(dev, torch.bfloat16)
    sig = eng._nb_sig(pos.cpu().numpy())
    items = eng._plan_for(sig)[0][0].contiguous()       # layer 0's list
    bids = np.stack([eng._decode_ids_for_nblocks(n)[0] for n in sig])
    padded = torch.from_numpy(padded_decode_items(bids)).to(dev)
    holes = table.clone()
    holes[:4, 0] = -1                                    # unmapped sinks
    for r in range(4, B):
        holes[r, int(nblocks[r]) - 1] = -1               # unmapped newest

    def run(fn, it, tb, **kw):
        return fn(q, kp, vp, it, tb, pos, block_kv=blk, **kw)

    cases = [("packed", items, table, {}), ("padded", padded, table, {}),
             ("unmapped", items, holes, {}),
             ("window", items, table, {"window": 640})]
    errs = {}
    for name, it, tb, kw in cases:
        got = run(flash_decode_paged_kernel, it, tb, **kw)
        want = run(packed_decode_attention_paged, it, tb, **kw)
        torch.cuda.synchronize()
        err = max((got[0] - want[0]).abs().max().item(),
                  ((got[2] - want[2]).abs() / (want[2].abs() + 1)).max()
                  .item())
        m_ok = bool(((got[1] - want[1]).abs() <= 1e-4 * (
            want[1].abs() + 1)).all())
        print(f"decode[{name}]: items {it.shape[0]}, max abs err {err:.3e} "
              f"(tolerance {DECODE_ATOL:g}), m {'ok' if m_ok else 'BAD'}")
        if not err <= DECODE_ATOL or not m_ok:
            fail(f"flash_decode_paged disagrees with its plain version "
                 f"({name}: {err:.3e})")
        errs[name] = err

    ms = time_ms(lambda: run(flash_decode_paged_kernel, items, table),
                 graph=True)
    plain_ms = time_ms(lambda: run(packed_decode_attention_paged, items,
                                   table), graph=False, reps=3)
    # library yardstick: SDPA over the same selected blocks, as a mask on
    # K/V gathered from the pool beforehand (the gather is not timed)
    it_np = items.cpu().numpy()
    tb_np, pos_np = table.cpu().numpy(), pos.cpu().numpy()
    kpos = np.arange(T * blk)
    mask = np.zeros((B, Hkv * G, 1, T * blk), bool)
    tiles = set()
    for b, h, lb, _, _, valid in it_np:
        if valid and tb_np[b, lb] >= 0:
            tiles.add((int(tb_np[b, lb]), int(h)))
            sl = slice(lb * blk, (lb + 1) * blk)
            mask[b, h * G:(h + 1) * G, 0, sl] = kpos[sl] <= pos_np[b]
    gather = lambda p: p[table.clamp_min(0).long()].permute(
        0, 2, 1, 3, 4).reshape(B, Hkv, T * blk, D)       # noqa: E731
    kg, vg = gather(kp), gather(vp)
    qs = q.reshape(B, Hkv * G, 1, D)
    mask_t = torch.from_numpy(mask).to(dev)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = time_ms(lambda: sdpa(qs, kg, vg, attn_mask=mask_t,
                                      enable_gqa=True), graph=True)
    ntiles = len(tiles)
    nbytes = (q.numel() * 2 + ntiles * 2 * blk * D * 2 + it_np.size * 4
              + tb_np.size * 4 + B * 4 + B * Hkv * G * (D + 2) * 4)
    # unmasked (query row, key) pairs only; q.k on bf16 inputs at the
    # tensor rate, p.V in true f32 (the kernel's contract) at the f32 rate
    flops = 2 * D * int(mask.sum())
    bms, by = bound_ms(nbytes, flops, flops)
    print(f"decode timing: kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, "
          f"SDPA {library_ms:.4f} ms, bound {bms * 1e3:.2f} us ({by}), "
          f"{ntiles} selected tiles")
    results["flash_decode_paged"] = {
        "max_abs_err": errs["packed"], "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bms, "bound_by": by, "library_ms": library_ms}


def check_prefill(eng, gen, dev, results):
    import numpy as np
    import torch
    from repro_torch.kernels.sparse_prefill import (
        sparse_prefill_attention, sparse_prefill_paged,
        worklist_attention_paged)
    H, Hkv, D, blk, C = 9, 3, 64, 128, 256
    T = eng.ecfg.max_seq_len // blk
    prompt = 2304
    nlog = prompt // blk
    N = T + 1
    table = random_table(gen, 1, [nlog], N - 1, T)[0].to(dev)
    kp = torch.randn((N, Hkv, blk, D), generator=gen).to(dev, torch.bfloat16)
    vp = torch.randn((N, Hkv, blk, D), generator=gen).to(dev, torch.bfloat16)
    q = torch.randn((H, C, D), generator=gen).to(dev, torch.bfloat16)
    errs, timed = {}, None
    for q_offset in (0, 2048):
        items = eng._chunk_worklists(prompt, q_offset, C)[0].contiguous()
        kw = dict(block_q=blk, block_kv=blk, q_offset=q_offset,
                  kv_len=q_offset + C)
        for dtype, atol in ((torch.bfloat16, PREFILL_BF16_ATOL),
                            (torch.float32, PREFILL_F32_ATOL)):
            args = (q.to(dtype), kp.to(dtype), vp.to(dtype), items, table)
            got = sparse_prefill_paged(*args, **kw)
            want = worklist_attention_paged(*args, **kw)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            tag = f"q_offset={q_offset},{str(dtype)[6:]}"
            print(f"prefill[{tag}]: items {items.shape[0]}, max abs err "
                  f"{err:.3e} (tolerance {atol:g})")
            if not err <= atol:
                fail(f"sparse_prefill_paged disagrees with its plain "
                     f"version ({tag}: {err:.3e})")
            errs[tag] = err
        timed = (items, kw)
    # the contiguous form: the same kernel over an identity table
    S = 512
    k = torch.randn((Hkv, S, D), generator=gen).to(dev, torch.bfloat16)
    v = torch.randn((Hkv, S, D), generator=gen).to(dev, torch.bfloat16)
    qi = torch.randn((H, S, D), generator=gen).to(dev, torch.bfloat16)
    full = torch.from_numpy(
        eng.worklists_for(S)[0].items.reshape(-1, 7)).to(dev)
    got = sparse_prefill_attention(qi, k, v, full)
    as_pool = lambda t: t.reshape(Hkv, S // blk, blk, D).transpose(
        0, 1).contiguous()                                # noqa: E731
    want = worklist_attention_paged(
        qi, as_pool(k), as_pool(v), full,
        torch.arange(S // blk, dtype=torch.int32, device=dev), kv_len=S)
    err = (got.float() - want.float()).abs().max().item()
    print(f"prefill[identity table, S={S}]: max abs err {err:.3e} "
          f"(tolerance {PREFILL_BF16_ATOL:g})")
    if not err <= PREFILL_BF16_ATOL:
        fail(f"sparse_prefill_attention disagrees ({err:.3e})")

    items, kw = timed                                    # q_offset 2048
    args = (q, kp, vp, items, table)
    ms = time_ms(lambda: sparse_prefill_paged(*args, **kw), graph=True)
    plain_ms = time_ms(lambda: worklist_attention_paged(*args, **kw),
                       graph=False, reps=3)
    it_np, tb_np = items.cpu().numpy(), table.cpu().numpy()
    q_off, kv_len = kw["q_offset"], kw["kv_len"]
    qpos = q_off + np.arange(C)
    kpos = np.arange(T * blk)
    mask = np.zeros((H, C, T * blk), bool)
    tiles, nvalid = set(), 0
    for h, qb, lb, _, _, valid, kvh in it_np:
        if valid and tb_np[lb] >= 0:
            nvalid += 1
            tiles.add((int(tb_np[lb]), int(kvh)))
            rs, sl = slice(qb * blk, (qb + 1) * blk), slice(lb * blk,
                                                           (lb + 1) * blk)
            mask[h, rs, sl] = ((kpos[None, sl] <= qpos[rs, None])
                               & (kpos[None, sl] < kv_len))
    kg = kp[table.clamp_min(0).long()].transpose(0, 1).reshape(
        1, Hkv, T * blk, D)
    vg = vp[table.clamp_min(0).long()].transpose(0, 1).reshape(
        1, Hkv, T * blk, D)
    mask_t = torch.from_numpy(mask[None]).to(dev)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = time_ms(lambda: sdpa(q[None], kg, vg, attn_mask=mask_t,
                                      enable_gqa=True), graph=True)
    nbytes = (2 * q.numel() * 2 + len(tiles) * 2 * blk * D * 2
              + it_np.size * 4 + tb_np.size * 4)
    # unmasked (query, key) pairs only; both products on bf16 inputs at
    # the tensor rate (p may be rounded to bf16 within the bf16 tolerance)
    flops = 2 * D * int(mask.sum())
    bms, by = bound_ms(nbytes, 2 * flops, 0)
    print(f"prefill timing (chunk {C} at q_offset {q_off}): kernel "
          f"{ms:.4f} ms, plain {plain_ms:.3f} ms, SDPA {library_ms:.4f} ms, "
          f"bound {bms * 1e3:.2f} us ({by}), {nvalid} tiles")
    results["sparse_prefill_paged"] = {
        "max_abs_err": errs["q_offset=2048,bfloat16"], "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
        "library_ms": library_ms}


def build_engine(dev):
    """The full-width engine with a default EngineConfig (its planner also
    makes the kernel checks' work lists)."""
    from repro_torch.configs import get_config
    from repro_torch.core.sparsity import synthetic_head_curves
    from repro_torch.models.transformer import init_params
    from repro_torch.serving import Engine, EngineConfig
    cfg = get_config("smollm-135m")
    t0 = time.time()
    params = init_params(cfg, seed=0, device=dev)
    eng = Engine(cfg, params, EngineConfig(max_seq_len=4096, num_slots=8),
                 synthetic_head_curves(cfg.num_layers, cfg.num_heads),
                 device=dev)
    print(f"full-width {cfg.name}: {cfg.num_params / 1e6:.1f}M params, "
          f"pool {tuple(eng.kv.pool.shape)} {eng.kv.pool.dtype}, "
          f"set-up {time.time() - t0:.1f} s")
    return eng


def run_serve(eng, dev):
    import numpy as np
    import torch
    from repro_torch.kernels.flash_decode import flash_decode_paged_kernel
    from repro_torch.kernels.sparse_prefill import sparse_prefill_paged
    from repro_torch.serving import SamplingParams
    rng = np.random.default_rng(0)
    # 1010 + 32 crosses the 1024 block boundary during decode
    lens = (300, 1010, 3500, 2048, 700, 1500, 2900, 513)
    prompts = [rng.integers(0, eng.cfg.vocab_size, size=n) for n in lens]
    sp = SamplingParams(max_tokens=32)
    flash_decode_paged_kernel.launches = 0
    sparse_prefill_paged.launches = 0
    torch.cuda.synchronize()
    t0 = time.time()
    done = eng.serve(prompts, sp)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {"flash_decode_paged": flash_decode_paged_kernel.launches,
                "sparse_prefill_paged": sparse_prefill_paged.launches}
    ok = [r for r in done if r.done and not r.rejected
          and len(r.generated) == sp.max_tokens
          and all(0 <= t < eng.cfg.vocab_size for t in r.generated)]
    ttft = [r.ttft for r in done]
    itl = [x for r in done for x in r.itl]
    st = eng.decode_stats
    print(f"serve: {len(ok)}/{len(prompts)} requests complete in "
          f"{wall:.2f} s, prompt lens {list(lens)}")
    print(f"serve: TTFT mean {np.mean(ttft):.3f} s max {np.max(ttft):.3f} s "
          f"(host clock, queueing included); ITL mean "
          f"{1e3 * np.mean(itl):.2f} ms; decode "
          f"{sum(len(r.generated) for r in done) / wall:.1f} tokens/s "
          f"over the whole serve, {st['ticks']} decode ticks, decode plan "
          f"cache {st['plan_hits']} hits / {st['plan_misses']} misses")
    bs = eng._batcher.stats
    print(f"serve: launches {launches}: {bs.prefill_chunks} prefill chunks "
          f"and {bs.decode_steps} decode ticks, "
          f"{launches['sparse_prefill_paged'] / bs.prefill_chunks:g} "
          f"prefill launches per chunk, "
          f"{launches['flash_decode_paged'] / bs.decode_steps:g} decode "
          f"launches per tick")
    fails = eng.kv.audit(strict=False)
    alloc = eng.kv.alloc
    print(f"serve: pool audit {'clean' if not fails else fails}, "
          f"{alloc.allocated_blocks} blocks still mapped")
    if len(ok) != len(prompts):
        fail("not every request completed with 32 in-vocab tokens")
    if not all(launches.values()):
        fail(f"a kernel of the main path never launched: {launches}")
    if fails or alloc.allocated_blocks:
        fail(f"pool audit failed: {fails}")
    return launches


def serve_smoke_parity(dev):
    """SMOKE float32: greedy tokens on the card == the plain versions on
    the CPU (sums in another order only)."""
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
               for n in (300, 40, 520, 129)]
    outs = {}
    for d in (dev, torch.device("cpu")):
        eng = Engine(cfg, init_params(cfg, seed=1, device=d),
                     EngineConfig(max_seq_len=1024, num_slots=4,
                                  budget_per_head=256),
                     synthetic_head_curves(cfg.num_layers, cfg.num_heads),
                     device=d)
        outs[d.type] = [r.generated for r in eng.serve(
            prompts, SamplingParams(max_tokens=12))]
    same = outs["cuda"] == outs["cpu"]
    print(f"smoke f32 serve: card tokens {'==' if same else '!='} CPU "
          f"plain-version tokens")
    if not same:
        fail(f"card {outs['cuda']} != cpu {outs['cpu']}")


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

    t0 = time.time()
    logs = kbuild.build()
    print(f"build: {len(logs)} kernels compiled in {time.time() - t0:.1f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    results = {}
    gen = torch.Generator().manual_seed(0)
    t0 = time.time()
    eng = build_engine(dev)
    check_decode(eng, gen, dev, results)
    check_prefill(eng, gen, dev, results)
    print(f"kernel checks: {time.time() - t0:.1f} s")

    t0 = time.time()
    launches = run_serve(eng, dev)
    serve_smoke_parity(dev)
    print(f"serve phases: {time.time() - t0:.1f} s")

    src = "src/repro_torch/kernels/csrc/"
    replaces = {
        "flash_decode_paged": "src/repro/kernels/flash_decode.py:510",
        "sparse_prefill_paged": "src/repro/kernels/sparse_prefill.py:111"}
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": f"{src}{name}.cu",
         "replaces": replaces[name], "launches": launches[name],
         **results[name]} for name in replaces]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
