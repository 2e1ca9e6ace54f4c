#!/usr/bin/env python3
"""Proof that the PyTorch/CUDA port (``src/repro_torch``) starts and is
right on an NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. device: require CUDA, print the card's ``name, power.limit``;
2. build: compile every CUDA kernel from ``src/repro_torch/kernels/csrc``
   (one ``nvcc`` per source, started together);
3. kernels: each kernel against its plain PyTorch version on the card, at
   the shapes its path gives it (SmolLM-135M: 9 heads, 3 KV heads,
   head_dim 64, ``max_seq_len`` 4096, 8 rows, budget 512), with the stated
   tolerances; kernel, plain-version and library (SDPA) times, and each
   kernel's bound.  The paged and contiguous decode and prefill kernels
   must also agree bit for bit on equal cache contents;
4. library path: ``ops.flash_attention`` and ``ops.sparse_decode``, the
   only entry points of the dense and legacy kernels, launch them;
5. serve: the full-width SmolLM-135M with seeded random bf16 weights
   serves 8 requests (300-3500 prompt tokens, 32 greedy tokens each)
   through ``Engine.serve`` four times: paged + packed decode (the
   default), contiguous + packed, paged + padded, contiguous + padded.
   Every request completes, each serve's kernels launched, the block
   accounting audits clean, and all four give the same greedy tokens; then
   SMOKE-size float32 serves on the card, paged and contiguous, must give
   the same greedy tokens as the same serves on the CPU (plain versions).

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
F32_ATOL = 1e-4                # f32 output: sums taken in another order
BF16_ATOL = 2.0 ** -6          # bf16 output: one bf16 ulp at |x| < 4
B, H, HKV, D, BLK = 8, 9, 3, 64, 128   # SmolLM-135M decode shapes
SMAX = 4096
SERVE_LENS = (300, 1010, 3500, 2048, 700, 1500, 2900, 513)
# dense flash attention checks: (tag, causal, Sq, Skv); the first is timed
FLASH_CASES = (("causal,4096", True, 4096, 4096),
               ("non-causal,4096", False, 4096, 4096),
               ("causal,ragged 1000x3001", True, 1000, 3001))
SERVES = (("paged", "packed"), ("contiguous", "packed"),
          ("paged", "padded"), ("contiguous", "padded"))
# the kernels each serve must launch (the first two are also the
# default path's)
SERVE_KERNELS = {
    "paged": ("flash_decode_paged", "sparse_prefill_paged"),
    "contiguous": ("flash_decode_contig", "sparse_prefill_contig")}
REPLACES = {
    "flash_decode_paged": "src/repro/kernels/flash_decode.py:510",
    "sparse_prefill_paged": "src/repro/kernels/sparse_prefill.py:111",
    "flash_decode_contig": "src/repro/kernels/flash_decode.py:214",
    "sparse_prefill_contig": "src/repro/kernels/sparse_prefill.py:111",
    "flash_attention": "src/repro/kernels/flash_attn.py:83",
    "sparse_decode": "src/repro/kernels/sparse_decode.py:190"}


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
    for fn in counters().values():
        fn.launches = 0


def read_counts(names):
    c = counters()
    return {n: c[n].launches for n in names}


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


def decode_mask(items, table, pos, G):
    """Boolean ``[B, Hkv*G, 1, T*blk]`` mask of the (row, key) pairs the
    items select, and the selected (physical block, kv head) tiles."""
    import numpy as np
    it_np, tb_np, pos_np = (t.cpu().numpy() for t in (items, table, pos))
    T = tb_np.shape[1]
    kpos = np.arange(T * BLK)
    mask = np.zeros((tb_np.shape[0], HKV * G, 1, T * BLK), bool)
    tiles = set()
    for b, h, lb, _, _, valid in it_np:
        if valid and tb_np[b, lb] >= 0:
            tiles.add((int(tb_np[b, lb]), int(h)))
            sl = slice(lb * BLK, (lb + 1) * BLK)
            mask[b, h * G:(h + 1) * G, 0, sl] = kpos[sl] <= pos_np[b]
    return mask, tiles


def decode_bound(q, items, table, mask, ntiles, with_table: bool):
    """Bytes: q, the selected K/V tiles, the item table (and block table),
    positions and the f32 (out, m, l); operations: the unmasked (query
    row, key) pairs, q.k on bf16 inputs at the tensor rate, p.V in true
    f32 (the kernel's contract) at the f32 rate."""
    G = q.shape[2]
    nbytes = (q.numel() * 2 + ntiles * 2 * BLK * D * 2 + items.numel() * 4
              + (table.numel() * 4 if with_table else 0) + B * 4
              + B * HKV * G * (D + 2) * 4)
    flops = 2 * D * int(mask.sum())
    return nbytes, flops, flops


def check_decode(eng, gen, dev, results):
    """The paged (#1) and contiguous (#3) decode kernels on the engine's
    layer-0 work at 8 rows of 3000-4096 tokens: packed items, the padded
    table from per-slot block ids, -1 table entries, a window; and the two
    layouts bit for bit on equal cache contents."""
    import numpy as np
    import torch
    from repro_torch.kernels.flash_decode import (
        decode_items_from_ids, flash_decode_kernel, flash_decode_paged_kernel,
        packed_decode_attention, packed_decode_attention_paged)
    G = H // HKV
    T = SMAX // BLK
    N = B * T + 1
    pos = torch.randint(3000, SMAX, (B,), generator=gen, dtype=torch.int32)
    nblocks = (pos + 1 + BLK - 1) // BLK
    table = random_table(gen, B, nblocks, N - 1, T).to(dev)
    pos = pos.to(dev)
    kp = torch.randn((N, HKV, BLK, D), generator=gen).to(dev, torch.bfloat16)
    vp = torch.randn((N, HKV, BLK, D), generator=gen).to(dev, torch.bfloat16)
    kc, vc = slot_rows(kp, table), slot_rows(vp, table)
    q = torch.randn((B, HKV, G, D), generator=gen).to(dev, torch.bfloat16)
    sig = eng._nb_sig(pos.cpu().numpy())
    items = eng._plan_for(sig)[0][0].contiguous()       # layer 0's list
    bids = torch.from_numpy(np.stack(
        [eng._decode_ids_for_nblocks(n)[0] for n in sig])).to(dev)
    padded = decode_items_from_ids(bids)
    holes = table.clone()
    holes[:4, 0] = -1                                    # unmapped sinks
    for r in range(4, B):
        holes[r, int(nblocks[r]) - 1] = -1               # unmapped newest

    def paged(fn, it, tb=table, **kw):
        return fn(q, kp, vp, it, tb, pos, block_kv=BLK, **kw)

    def contig(fn, it, **kw):
        return fn(q, kc, vc, it, pos, block_kv=BLK, **kw)

    errs = {}
    for tag, it, tb, kw in (("packed", items, table, {}),
                            ("padded", padded, table, {}),
                            ("unmapped", items, holes, {}),
                            ("window", items, table, {"window": 640})):
        errs["paged", tag] = check(
            "flash_decode_paged", tag,
            paged(flash_decode_paged_kernel, it, tb, **kw),
            paged(packed_decode_attention_paged, it, tb, **kw), F32_ATOL)
    for tag, it, kw in (("packed", items, {}), ("padded", padded, {}),
                        ("window", items, {"window": 640})):
        got = contig(flash_decode_kernel, it, **kw)
        errs["contig", tag] = check("flash_decode_contig", tag, got,
                                    contig(packed_decode_attention, it, **kw),
                                    F32_ATOL)
        same = all(torch.equal(a, b) for a, b in zip(
            got, paged(flash_decode_paged_kernel, it, **kw)))
        print(f"decode[{tag}]: contiguous {'==' if same else '!='} paged, "
              f"bit for bit")
        if not same:
            fail(f"the contiguous and paged decode kernels differ ({tag})")

    mask, tiles = decode_mask(items, table, pos, G)
    mask_t = torch.from_numpy(mask).to(dev)
    qs = q.reshape(B, HKV * G, 1, D)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    nbytes, bf, f32 = decode_bound(q, items, table, mask, len(tiles), True)
    # library yardstick: SDPA over the same selected keys as a mask on K/V
    # gathered from the pool beforehand (the gather is not timed)
    measure(results, "flash_decode_paged",
            lambda: paged(flash_decode_paged_kernel, items),
            lambda: paged(packed_decode_attention_paged, items),
            lambda: sdpa(qs, kc, vc, attn_mask=mask_t, enable_gqa=True),
            nbytes, bf, f32, errs["paged", "packed"],
            f" ({len(tiles)} selected tiles)")
    nbytes, bf, f32 = decode_bound(q, items, table, mask, len(tiles), False)
    measure(results, "flash_decode_contig",
            lambda: contig(flash_decode_kernel, items),
            lambda: contig(packed_decode_attention, items),
            lambda: sdpa(qs, kc, vc, attn_mask=mask_t, enable_gqa=True),
            nbytes, bf, f32, errs["contig", "packed"])


def prefill_mask(items, table, q_off, C, kv_len, T):
    """Boolean ``[H, C, T*blk]`` mask of the (query, key) pairs the items
    select, the selected (physical block, kv head) tiles and the valid
    item count."""
    import numpy as np
    it_np, tb_np = items.cpu().numpy(), table.cpu().numpy()
    qpos = q_off + np.arange(C)
    kpos = np.arange(T * BLK)
    mask = np.zeros((H, C, T * BLK), bool)
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


def check_prefill(eng, gen, dev, results):
    """The paged (#2) and contiguous sparse prefill kernels on a 256-token
    chunk of a 2304-token prompt at q_offset 0 and 2048, bf16 and f32; the
    contiguous form reads the slot row [Hkv, 4096, D] in place, and the
    two layouts agree bit for bit."""
    import torch
    from repro_torch.kernels.sparse_prefill import (
        sparse_prefill_attention, sparse_prefill_paged, worklist_attention,
        worklist_attention_paged)
    C, prompt = 256, 2304
    T = SMAX // BLK
    N = T + 1
    table = random_table(gen, 1, [prompt // BLK], N - 1, T)[0].to(dev)
    kp = torch.randn((N, HKV, BLK, D), generator=gen).to(dev, torch.bfloat16)
    vp = torch.randn((N, HKV, BLK, D), generator=gen).to(dev, torch.bfloat16)
    kc, vc = slot_rows(kp, table[None])[0], slot_rows(vp, table[None])[0]
    q = torch.randn((H, C, D), generator=gen).to(dev, torch.bfloat16)
    errs, timed = {}, {}
    for q_offset in (0, 2048):
        items = eng._chunk_worklists(prompt, q_offset, C)[0].contiguous()
        kw = dict(block_q=BLK, block_kv=BLK, q_offset=q_offset,
                  kv_len=q_offset + C)
        timed[q_offset] = (items, kw)
        for dtype, atol in ((torch.bfloat16, BF16_ATOL),
                            (torch.float32, F32_ATOL)):
            tag = f"q_offset={q_offset},{str(dtype)[6:]}"
            qd, pk, pv, ck, cv = (t.to(dtype) for t in (q, kp, vp, kc, vc))
            got_p = sparse_prefill_paged(qd, pk, pv, items, table, **kw)
            errs["paged", tag] = check(
                "sparse_prefill_paged", tag, got_p,
                worklist_attention_paged(qd, pk, pv, items, table, **kw),
                atol)
            got_c = sparse_prefill_attention(qd, ck, cv, items, **kw)
            errs["contig", tag] = check(
                "sparse_prefill_contig", tag, got_c,
                worklist_attention(qd, ck, cv, items, **kw), atol)
            if not torch.equal(got_p, got_c):
                fail(f"the contiguous and paged prefill kernels differ "
                     f"({tag})")
            print(f"prefill[{tag}]: contiguous == paged, bit for bit")

    items, kw = timed[2048]
    mask, tiles, nvalid = prefill_mask(items, table, 2048, C, 2048 + C, T)
    mask_t = torch.from_numpy(mask[None]).to(dev)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library = lambda: sdpa(q[None], kc[None], vc[None],  # noqa: E731
                           attn_mask=mask_t, enable_gqa=True)
    # unmasked (query, key) pairs only; both products on bf16 inputs at
    # the tensor rate (p may be rounded to bf16 within the bf16 tolerance)
    flops = 2 * D * int(mask.sum())
    base = 2 * q.numel() * 2 + len(tiles) * 2 * BLK * D * 2 + items.numel() * 4
    note = f" (chunk {C} at q_offset 2048, {nvalid} tiles)"
    measure(results, "sparse_prefill_paged",
            lambda: sparse_prefill_paged(q, kp, vp, items, table, **kw),
            lambda: worklist_attention_paged(q, kp, vp, items, table, **kw),
            library, base + table.numel() * 4, 2 * flops, 0,
            errs["paged", "q_offset=2048,bfloat16"], note)
    measure(results, "sparse_prefill_contig",
            lambda: sparse_prefill_attention(q, kc, vc, items, **kw),
            lambda: worklist_attention(q, kc, vc, items, **kw),
            library, base, 2 * flops, 0,
            errs["contig", "q_offset=2048,bfloat16"], note)


def check_flash_attention(gen, dev, results):
    """The dense flash attention (#4) at 9 heads over 3 KV heads: causal
    and not at Sq = Skv = 4096, and a ragged causal case with Sq != Skv."""
    import torch
    from repro_torch.kernels.flash_attn import (
        flash_attention, flash_attention_reference)
    errs = {}
    for tag, causal, sq, skv in FLASH_CASES:
        q = torch.randn((H, sq, D), generator=gen).to(dev)
        k = torch.randn((HKV, skv, D), generator=gen).to(dev)
        v = torch.randn((HKV, skv, D), generator=gen).to(dev)
        for dtype, atol in ((torch.bfloat16, BF16_ATOL),
                            (torch.float32, F32_ATOL)):
            args = [t.to(dtype) for t in (q, k, v)]
            errs[tag, dtype] = check(
                "flash_attention", f"{tag},{str(dtype)[6:]}",
                flash_attention(*args, causal=causal),
                flash_attention_reference(*args, causal=causal), atol)
    tag, _, S, _ = FLASH_CASES[0]
    q, k, v = (torch.randn(s, generator=gen).to(dev, torch.bfloat16)
               for s in ((H, S, D), (HKV, S, D), (HKV, S, D)))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    pairs = H * S * (S + 1) // 2                         # causal, unmasked
    measure(results, "flash_attention",
            lambda: flash_attention(q, k, v, causal=True),
            lambda: flash_attention_reference(q, k, v, causal=True),
            lambda: sdpa(q[None], k[None], v[None], is_causal=True,
                         enable_gqa=True),
            (2 * q.numel() + k.numel() + v.numel()) * 2, 4 * D * pairs, 0,
            errs[tag, torch.bfloat16], f" ({tag})")


def legacy_case(eng, gen, dev, cache_len=4000):
    """The legacy decode's full-width work: 8 rows, one static cache
    length, each (row, kv head) the engine's layer-0 selection."""
    import torch
    from repro_torch.kernels.sparse_decode import build_decode_worklist
    G = H // HKV
    q, kc, vc = (torch.randn(s, generator=gen).to(dev, torch.bfloat16)
                 for s in ((B, HKV, G, D), (B, HKV, SMAX, D),
                           (B, HKV, SMAX, D)))
    ids = eng.decode_block_ids(cache_len)[0]             # [Hkv, nb]
    sels = [[ids[h][ids[h] >= 0] for h in range(HKV)] for _ in range(B)]
    items = torch.from_numpy(build_decode_worklist(
        sels, num_devices=1, kv_heads_per_device=HKV, block=BLK).items[0])
    return q, kc, vc, items.to(dev), cache_len


def check_sparse_decode(eng, gen, dev, results):
    """The legacy budgeted decode (#5) at full width, bf16 and f32."""
    import torch
    from repro_torch.kernels.sparse_decode import (
        sparse_decode_attention, sparse_decode_reference)
    q, kc, vc, items, cache_len = legacy_case(eng, gen, dev)
    errs = {}
    for dtype, atol in ((torch.bfloat16, BF16_ATOL),
                        (torch.float32, F32_ATOL)):
        args = [t.to(dtype) for t in (q, kc, vc)]
        errs[dtype] = check(
            "sparse_decode", str(dtype)[6:],
            sparse_decode_attention(*args, items, cache_len=cache_len),
            sparse_decode_reference(*args, items, cache_len=cache_len), atol)
    G = H // HKV
    pos = torch.full((B,), cache_len - 1, dtype=torch.int32)
    ident = torch.arange(SMAX // BLK, dtype=torch.int32).expand(B, -1)
    mask, tiles = decode_mask(items, ident, pos, G)
    mask_t = torch.from_numpy(mask).to(dev)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qs = q.reshape(B, HKV * G, 1, D)
    flops = 2 * D * int(mask.sum())
    # bytes: q, the selected tiles, the items, out in q's dtype
    nbytes = (2 * q.numel() * 2 + len(tiles) * B * 2 * BLK * D * 2
              + items.numel() * 4)
    measure(results, "sparse_decode",
            lambda: sparse_decode_attention(q, kc, vc, items,
                                            cache_len=cache_len),
            lambda: sparse_decode_reference(q, kc, vc, items,
                                            cache_len=cache_len),
            lambda: sdpa(qs, kc, vc, attn_mask=mask_t, enable_gqa=True),
            nbytes, flops, flops, errs[torch.bfloat16])


def run_library_path(eng, gen, dev):
    """The dense and legacy kernels run only behind the library entry
    points: drive each once at full width and count the launches."""
    import torch
    from repro_torch.kernels import ops
    q, k, v = (torch.randn(s, generator=gen).to(dev, torch.bfloat16)
               for s in ((H, SMAX, D), (HKV, SMAX, D), (HKV, SMAX, D)))
    lq, lk, lv, items, cache_len = legacy_case(eng, gen, dev)
    reset_counts()
    out = ops.flash_attention(q, k, v, causal=True)
    dec = ops.sparse_decode(lq, lk, lv, items, cache_len=cache_len)
    torch.cuda.synchronize()
    launches = read_counts(("flash_attention", "sparse_decode"))
    ok = (tuple(out.shape) == (H, SMAX, D) and bool(out.isfinite().all())
          and bool(dec.isfinite().all()))
    print(f"library path: ops.flash_attention + ops.sparse_decode, "
          f"launches {launches}, outputs {'finite' if ok else 'BAD'}")
    if not ok or not all(launches.values()):
        fail(f"a library kernel did not run: {launches}")
    return launches


def build_engine(cfg, params, dev, **kw):
    """A full-width engine: ``EngineConfig()`` with 8 slots of 4096 tokens
    and the options ``kw``."""
    from repro_torch.core.sparsity import synthetic_head_curves
    from repro_torch.serving import Engine, EngineConfig
    return Engine(cfg, params, EngineConfig(max_seq_len=SMAX, num_slots=B,
                                            **kw),
                  synthetic_head_curves(cfg.num_layers, cfg.num_heads),
                  device=dev)


def run_serve(eng, prompts, tag):
    """Serve ``prompts`` (32 greedy tokens each); check completion, the
    launches of this layout's kernels and the block accounting.  Returns
    the tokens and the launch counts."""
    import numpy as np
    import torch
    from repro_torch.serving import SamplingParams
    sp = SamplingParams(max_tokens=32)
    names = SERVE_KERNELS[eng.ecfg.cache_layout]
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
    print(f"serve[{tag}]: {len(ok)}/{len(prompts)} requests complete in "
          f"{wall:.2f} s; TTFT mean {np.mean(ttft):.3f} s max "
          f"{np.max(ttft):.3f} s (host clock, queueing included); ITL mean "
          f"{1e3 * np.mean(itl):.2f} ms; "
          f"{sum(len(r.generated) for r in done) / wall:.1f} tokens/s over "
          f"the whole serve; decode grid {st['real_items']} real / "
          f"{st['grid_items']} items over {st['ticks']} ticks")
    print(f"serve[{tag}]: launches {launches}: {bs.prefill_chunks} prefill "
          f"chunks, {bs.decode_steps} decode ticks")
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
    return [r.generated for r in done], launches


def run_serves(cfg, params, dev):
    """The four full-width serves; all must give the default's tokens."""
    import numpy as np
    rng = np.random.default_rng(0)
    # 1010 + 32 crosses the 1024 block boundary during decode
    prompts = [rng.integers(0, cfg.vocab_size, size=n) for n in SERVE_LENS]
    print(f"serve prompts: lens {list(SERVE_LENS)}")
    tokens, launches = {}, {}
    for layout, worklist in SERVES:
        tag = f"{layout},{worklist}"
        eng = build_engine(cfg, params, dev, cache_layout=layout,
                           decode_worklist=worklist)
        tokens[tag], got = run_serve(eng, prompts, tag)
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
    return launches


def serve_smoke_parity(dev):
    """SMOKE float32, both layouts: greedy tokens on the card == the plain
    versions on the CPU (sums in another order only)."""
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
    for layout in ("paged", "contiguous"):
        outs = {}
        for d in (dev, torch.device("cpu")):
            eng = Engine(cfg, init_params(cfg, seed=1, device=d),
                         EngineConfig(max_seq_len=1024, num_slots=4,
                                      budget_per_head=256,
                                      cache_layout=layout),
                         synthetic_head_curves(cfg.num_layers, cfg.num_heads),
                         device=d)
            outs[d.type] = [r.generated for r in eng.serve(
                prompts, SamplingParams(max_tokens=12))]
        same = outs["cuda"] == outs["cpu"]
        print(f"smoke f32 serve[{layout}]: card tokens "
              f"{'==' if same else '!='} CPU plain-version tokens")
        if not same:
            fail(f"{layout}: card {outs['cuda']} != cpu {outs['cpu']}")


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
    cfg = get_config("smollm-135m")
    params = init_params(cfg, seed=0, device=dev)
    eng = build_engine(cfg, params, dev)     # its planner makes the work
    print(f"full-width {cfg.name}: {cfg.num_params / 1e6:.1f}M params, "
          f"set-up {time.time() - t0:.1f} s")
    check_decode(eng, gen, dev, results)
    check_prefill(eng, gen, dev, results)
    check_flash_attention(gen, dev, results)
    check_sparse_decode(eng, gen, dev, results)
    print(f"kernel checks: {time.time() - t0:.1f} s")
    launches = run_library_path(eng, gen, dev)
    del eng

    t0 = time.time()
    launches.update(run_serves(cfg, params, dev))
    serve_smoke_parity(dev)
    print(f"serve phases: {time.time() - t0:.1f} s")

    src = "src/repro_torch/kernels/csrc/"
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": f"{src}{name}.cu",
         "replaces": REPLACES[name], "launches": launches[name],
         **results[name]} for name in REPLACES]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
