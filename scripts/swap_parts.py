#!/usr/bin/env python3
"""Time the parts of a preemption swap on the card, at the shapes of
``chip_smoke.py``'s preempted serves: one victim of 28 blocks of
SmolLM-135M's bf16 pool (30 layers, 3 KV heads, head_dim 64) and of
Yi-6B's int8 pool (32 layers, 4 KV heads, head_dim 128).

    python3 scripts/swap_parts.py

For each: the gather of the victim's blocks on the card
(``index_select`` on the block axis, as ``Engine._swap_out_seq`` does;
indexing that axis and a flat ``[L*2, N, -1]`` view beside it), the
pinned host allocation (the first one of the process and a cached one),
the
device-to-host copy into the pinned buffer, the host-to-device copy back
and the scatter into other block ids; then a contiguous slot row's slice
copied to the host directly and made contiguous first.  Card times come
from CUDA events, host times from the host clock; needs one NVIDIA GPU.
"""
import subprocess
import sys
import time

import torch

BLOCK, NBLK = 128, 28
SHAPES = {"smollm-135m bf16": (30, 3, 64, torch.bfloat16),
          "yi-6b int8": (32, 4, 128, torch.int8)}


def timed(fn, reps: int = 5):
    """Mean card and host milliseconds of ``fn`` over ``reps`` calls after
    a warm-up call (the first launch of a kernel in a process also loads
    it); its last result."""
    out = fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0 = time.perf_counter()
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return (start.elapsed_time(end) / reps,
            1e3 * (time.perf_counter() - t0) / reps, out)


def rate(nbytes: int, ms: float) -> str:
    return f"{ms:.3f} ms ({nbytes / ms / 1e6:.2f} GB/s)"


def main() -> int:
    if not torch.cuda.is_available():
        print("FAIL: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"{torch.cuda.get_device_name(0)}; {smi}; torch {torch.__version__}")
    gen = torch.Generator(device=dev).manual_seed(0)
    for name, (L, hkv, dh, dtype) in SHAPES.items():
        pool = torch.randint(-100, 100, (L, 2, 2 * NBLK + 1, hkv, BLOCK, dh),
                             generator=gen, device=dev).to(dtype)
        ids = torch.arange(NBLK, 2 * NBLK, device=dev)
        ms, _, blocks = timed(lambda: pool.index_select(2, ids))
        nbytes = blocks.numel() * blocks.element_size()
        print(f"{name}: victim {nbytes} bytes; gather by index_select "
              f"{rate(2 * nbytes, ms)} read + write")
        flat = pool.view(L * 2, pool.shape[2], -1)
        for how, fn in (("indexing the block axis", lambda: pool[:, :, ids]),
                        ("a flat view", lambda: flat[:, ids].view(
                            blocks.shape))):
            ms, _, other = timed(fn)
            assert torch.equal(other, blocks)
            print(f"{name}: gather by {how} {rate(2 * nbytes, ms)}")
        for i in range(2):
            t0 = time.perf_counter()
            host = torch.empty(blocks.shape, dtype=dtype, pin_memory=True)
            alloc = 1e3 * (time.perf_counter() - t0)
            ms, _, _ = timed(lambda: host.copy_(blocks, non_blocking=True))
            back_ms, _, _ = timed(lambda: blocks.copy_(host,
                                                       non_blocking=True))
            print(f"{name}: pinned allocation {i} {alloc:.3f} ms (host); "
                  f"device-to-host {rate(nbytes, ms)}; host-to-device "
                  f"{rate(nbytes, back_ms)}")
            del host
        fresh = torch.arange(0, NBLK, device=dev)
        ms, _, _ = timed(lambda: pool.__setitem__((slice(None), slice(None),
                                                   fresh), blocks))
        print(f"{name}: scatter into other ids {rate(2 * nbytes, ms)}")
        cache = torch.zeros((L, 2, 2, hkv, NBLK * BLOCK + 512, dh),
                            dtype=dtype, device=dev)
        row = cache[:, :, 1:2, :, :NBLK * BLOCK]
        host = torch.empty(row.shape, dtype=dtype, pin_memory=True)
        ms, _, _ = timed(lambda: host.copy_(row, non_blocking=True))
        print(f"{name}: slot row slice to the host directly "
              f"{rate(nbytes, ms)}")
        ms, _, _ = timed(lambda: host.copy_(row.contiguous(),
                                            non_blocking=True))
        print(f"{name}: slot row made contiguous, then to the host "
              f"{rate(nbytes, ms)}")
        del pool, blocks, other, cache, host
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
