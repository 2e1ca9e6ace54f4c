"""The shape of the chunk work lists that the prefill kernels' grid relies on.

On the card the prefill kernels launch one CTA per item (per 64-row slice
of its q block in bf16); a CTA whose item starts a run walks the run's
items and writes its (head, q_blk) rows on the run's valid ``last`` item,
and every other CTA exits at once.  That is right only if the lists the
engine hands them keep each run whole: it starts on a ``first`` item, its
items share (head, q_blk, kv_head), it ends on a valid ``last`` item, no
(head, q_blk) pair has two runs, and the padding rows start no run.  These
CPU tests hold ``Engine._chunk_worklists`` to that at several prompt
lengths and chunk offsets, and check that it memoizes each list.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import worklist as wl
from repro_torch.core.sparsity import synthetic_head_curves
from repro_torch.models.transformer import init_params
from repro_torch.serving import Engine, EngineConfig

torch.set_num_threads(1)

CFG = dataclasses.replace(get_config("smollm-135m", smoke=True),
                          dtype=torch.float32)
CHUNK = 256


@pytest.fixture(scope="module")
def engine():
    cpu = torch.device("cpu")
    return Engine(CFG, init_params(CFG, seed=0, device=cpu),
                  EngineConfig(max_seq_len=1024, num_slots=2,
                               budget_per_head=256),
                  synthetic_head_curves(CFG.num_layers, CFG.num_heads),
                  device=cpu)


def _runs(items):
    """The runs of one list as lists of item indices, and the padding rows
    (every row after the last valid one)."""
    valid = np.flatnonzero(items[:, wl.F_VALID] == 1)
    end = int(valid[-1]) + 1 if len(valid) else 0
    starts = np.flatnonzero(items[:end, wl.F_FIRST] == 1)
    bounds = np.append(starts, end)
    return ([list(range(a, b)) for a, b in zip(bounds[:-1], bounds[1:])],
            items[end:])


@pytest.mark.parametrize("prompt,q_offset", [
    (300, 0), (300, 256), (700, 0), (700, 512), (1000, 0), (1000, 256),
    (1000, 512), (1000, 768)])
def test_chunk_lists_keep_runs_whole(engine, prompt, q_offset):
    bucket = engine._chunk_bucket(min(CHUNK, prompt - q_offset), q_offset)
    got = engine._chunk_worklists(prompt, q_offset, bucket)
    assert engine._chunk_worklists(prompt, q_offset, bucket) is got
    assert got.dtype == torch.int32 and got.shape[0] == CFG.num_layers
    nqc, blk = bucket // CFG.block_q, CFG.block_kv
    for items in got.numpy():
        runs, pad = _runs(items)
        assert runs and runs[0][0] == 0, "the list starts with a run"
        assert not pad[:, [wl.F_FIRST, wl.F_LAST, wl.F_VALID]].any(), \
            "padding rows start, end and count nothing"
        seen = set()
        for run in runs:
            it = items[run]
            key = tuple(it[0, [wl.F_HEAD, wl.F_QBLK, wl.F_KVHEAD]])
            assert (it[:, [wl.F_HEAD, wl.F_QBLK, wl.F_KVHEAD]] == key).all()
            assert key[:2] not in seen, "one run per (head, q_blk)"
            seen.add(key[:2])
            assert 0 <= key[1] < nqc
            assert it[:, wl.F_VALID].all()
            assert it[-1, wl.F_LAST] == 1 and not it[:-1, wl.F_LAST].any()
            # causal: no kv block starts past the q block's last query
            last_q = q_offset + (key[1] + 1) * CFG.block_q - 1
            assert (it[:, wl.F_KVBLK] * blk <= last_q).all()
