"""The nine S-HPLB attention islands of the port
(``repro_torch.serving.sharded_attention``) over 2 and 4 ``gloo`` ranks on
the CPU, against the reference's ``shard_map`` islands on a host mesh of
the same shape, on the same seeded float32 inputs: within 1e-5, the swap
gather and scatter and the repermute bit for bit.

The reference runs in one subprocess for the file, with
``XLA_FLAGS=--xla_force_host_platform_device_count=8`` set before it
imports jax; inputs and outputs pass through ``.npz`` files.  The port's
ranks run in one :func:`repro_torch.launch.mesh.spawn` per world size,
each rank running every case of its world and returning its output
blocks."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.attention.policies import strided_policy
from repro_torch.core import quant
from repro_torch.core.worklist import (
    build_row_worklist, pack_decode_items, worklist_from_budgets)
from repro_torch.launch.mesh import Mesh, spawn

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
ATOL = 1e-5
B, H, HKV, D, BLK = 2, 8, 4, 32, 128
S, SMAX = 512, 512
DEADLINE = 120


def _sparse_ids(rng, rows, hkv, nblk, pos):
    """Per (row, kv head) a random subset of the blocks up to the row's
    position (sink first), sorted, -1 padded: ``[rows, hkv, nblk]``."""
    ids = np.full((rows, hkv, nblk), -1, np.int32)
    for b in range(rows):
        last = int(pos[b]) // BLK
        for h in range(hkv):
            sel = sorted({0, last} | set(
                rng.choice(last + 1, size=min(2, last + 1),
                           replace=False).tolist()))
            ids[b, h, :len(sel)] = sel
    return ids


def _code_tiles(x, kind="int8"):
    """A slot cache ``[B, Hkv, S, D]`` -> int8 codes and scales ``[B, Hkv,
    S / BLK]`` (the port's quantizer, equal to the reference's)."""
    t = torch.from_numpy(x).reshape(x.shape[0], x.shape[1], -1, BLK,
                                    x.shape[3])
    codes, scales = quant.quantize_tiles(t, kind)
    return codes.reshape(x.shape).numpy(), scales.numpy()


def make_inputs(path: Path) -> dict:
    rng = np.random.default_rng(0)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    x = {"q": f(B, H, S, D), "k": f(B, HKV, S, D), "v": f(B, HKV, S, D),
         "qd": f(B, H, 1, D), "kc": f(B, HKV, SMAX, D),
         "vc": f(B, HKV, SMAX, D), "pos": np.array([500, 300], np.int32)}
    nblk, nq = SMAX // BLK, S // BLK
    budgets = np.array([512, 256, 384, 128, 512, 256, 128, 384])
    perm = rng.permutation(H)
    sels = [strided_policy(h, int(budgets[h]) // BLK, nq, nq)
            for h in range(H)]
    for n in (2, 4):
        for l, shift in enumerate((0, 3)):     # two layers of lists
            b = np.roll(budgets, shift)
            g = worklist_from_budgets(b, num_devices=n, seq_len=S, block=BLK,
                                      policy_fn=strided_policy, group_size=2)
            r = worklist_from_budgets(b, num_devices=n, seq_len=S, block=BLK,
                                      policy_fn=strided_policy, group_size=2,
                                      kv_head_of_head=np.roll(perm, shift) // 2,
                                      kv_local=False)
            w = build_row_worklist(sels[shift:] + sels[:shift],
                                   num_devices=n, num_q_blocks=nq,
                                   num_kv_blocks=nq, block=BLK,
                                   kv_head_of_head=np.arange(H) // 2)
            for name, wl in (("group", g), ("repl", r), ("rows", w)):
                x[f"items_{name}_{n}_{l}"] = wl.items
        for name in ("group", "repl", "rows"):
            ls = [x.pop(f"items_{name}_{n}_{l}") for l in (0, 1)]
            lp = max(a.shape[1] for a in ls)
            x[f"items_{name}_{n}"] = np.stack([np.concatenate(
                [a, np.repeat(a[:, -1:] * [1, 1, 1, 0, 0, 0, 1],
                              lp - a.shape[1], axis=1)], axis=1)
                for a in ls], axis=1).astype(np.int32)  # [n, 2, Lpad, 7]
    ids = _sparse_ids(rng, B, HKV, nblk, x["pos"])
    x["ids"] = ids
    for n in (2, 4):
        x[f"packed_{n}"] = pack_decode_items(
            ids, num_shards=n, block=BLK,
            shard_of_kvhead=np.arange(HKV) // (HKV // n),
            kvhead_local=True).items
        # the contiguous seq island: each shard's global block ids [n, Hkv,
        # nb_loc] (the reference's shared-across-rows layout)
        per = nblk // n
        sh = np.full((n, HKV, per), -1, np.int32)
        for s in range(n):
            for h in range(HKV):
                own = [b for b in ids[0, h] if b >= 0 and b // per == s]
                sh[s, h, :len(own)] = own
        x[f"seqids_{n}"] = sh
    x["kc8"], x["kscale"] = _code_tiles(x["kc"])
    x["vc8"], x["vscale"] = _code_tiles(x["vc"])
    # the paged pool: every row's blocks at permuted physical ids
    T = SMAX // BLK
    N = B * T
    phys = rng.permutation(N).reshape(B, T).astype(np.int32)
    kp, vp = np.zeros((2, N, HKV, BLK, D), np.float32)
    for b in range(B):
        for j in range(T):
            kp[phys[b, j]] = x["kc"][b, :, j * BLK:(j + 1) * BLK]
            vp[phys[b, j]] = x["vc"][b, :, j * BLK:(j + 1) * BLK]
    x["kp"], x["vp"], x["table"] = kp, vp, phys
    # a row whose blocks all sit on one stripe: the others drop out
    x["table_one"] = np.stack([phys[0], np.sort(phys.reshape(-1))[:T]])
    kq, ks = quant.quantize_tiles(torch.from_numpy(kp), "int8")
    vq, vs = quant.quantize_tiles(torch.from_numpy(vp), "int8")
    x["kp8"], x["vp8"] = kq.numpy(), vq.numpy()
    x["kps"], x["vps"] = ks.numpy(), vs.numpy()
    # the cache moves
    x["rep_cache"] = f(2, 2, 2, 8, 64, 16)
    x["rep_perm"] = np.stack([rng.permutation(8) for _ in range(2)]
                             ).astype(np.int32)
    x["swap_pool"] = f(2, 2, 9, 4, 16, 8)
    x["swap_ids"] = np.array([5, 2, 7, 8], np.int32)
    x["swap_new"] = np.array([0, 3, 1, 8], np.int32)
    np.savez(path, **x)
    return x


# the reference's side, one subprocess: every island on meshes of 2 and 4
# devices (and the 2D island at model 1 / 2 x seq 2)
JAX_SCRIPT = r"""
import sys, warnings; warnings.filterwarnings("ignore")
import numpy as np, jax, jax.numpy as jnp
from repro.sharding.compat import set_mesh
from repro.serving import sharded_attention as sa
x = dict(np.load(sys.argv[1]))
out = {}
def mesh(*shape, names=("data", "model")):
    n = int(np.prod(shape))
    return jax.make_mesh(shape, names, devices=jax.devices()[:n])
J = lambda a: jnp.asarray(a)
for n in (2, 4):
    m = mesh(1, n)
    with set_mesh(m):
        for name, kv in (("group", True), ("repl", False)):
            f = sa.hplb_prefill_attention(m, kv_sharded=kv)
            out[f"prefill_{name}_{n}"] = np.asarray(jax.jit(
                lambda q, k, v, it: f(1, q, k, v, it))(
                J(x["q"]), J(x["k"]), J(x["v"]), J(x[f"items_{name}_{n}"])))
        f = sa.hplb_prefill_attention_rows(m)
        out[f"prefill_rows_{n}"] = np.asarray(jax.jit(
            lambda q, k, v, it: f(1, q, k, v, it))(
            J(x["q"]), J(x["k"]), J(x["v"]), J(x[f"items_rows_{n}"])))
        f = sa.hplb_decode_attention_packed(m)
        out[f"packed_{n}"] = np.asarray(jax.jit(f)(
            J(x["qd"]), J(x["kc"]), J(x["vc"]), J(x[f"packed_{n}"]),
            J(x["pos"])))
        out[f"packed8_{n}"] = np.asarray(jax.jit(f)(
            J(x["qd"]), J(x["kc8"]), J(x["vc8"]), J(x[f"packed_{n}"]),
            J(x["pos"]), J(x["kscale"]), J(x["vscale"])))
        f = sa.flash_decode_attention(m, seq_axes=("model",))
        out[f"contig_{n}"] = np.asarray(jax.jit(
            lambda *a: f(*a, x["pos"]))(
            J(x["qd"]), J(x["kc"]), J(x["vc"]), J(x[f"seqids_{n}"])))
        f = sa.flash_decode_attention_paged(m, seq_axes=("model",))
        for t in ("table", "table_one"):
            out[f"paged_{t}_{n}"] = np.asarray(jax.jit(f)(
                J(x["qd"]), J(x["kp"]), J(x["vp"]), J(x["ids"]), J(x[t]),
                J(x["pos"])))
        out[f"paged8_{n}"] = np.asarray(jax.jit(f)(
            J(x["qd"]), J(x["kp8"]), J(x["vp8"]), J(x["ids"]),
            J(x["table"]), J(x["pos"]), J(x["kps"]), J(x["vps"])))
        rep = sa.hplb_repermute_kv_cache(m)
        out[f"reperm_{n}"] = np.asarray(jax.jit(rep)(
            J(x["rep_cache"]), J(x["rep_perm"])))
        g = sa.hplb_swap_gather_kv_blocks(m)
        s = sa.hplb_swap_scatter_kv_blocks(m)
        pool, blocks = jax.jit(g)(J(x["swap_pool"]), x["swap_ids"])
        out[f"swap_blocks_{n}"] = np.asarray(blocks)
        out[f"swap_pool_{n}"] = np.asarray(jax.jit(s)(
            pool, blocks, J(x["swap_new"])))
for mm in (1, 2):
    m = mesh(1, mm, 2, names=("data", "model", "seq"))
    f = sa.flash_decode_attention_2d(m)
    with set_mesh(m):
        for t in ("table", "table_one"):
            out[f"twod_{t}_{mm}"] = np.asarray(jax.jit(f)(
                J(x["qd"]), J(x["kp"]), J(x["vp"]), J(x["ids"]), J(x[t]),
                J(x["pos"])))
        out[f"twod8_{mm}"] = np.asarray(jax.jit(f)(
            J(x["qd"]), J(x["kp8"]), J(x["vp8"]), J(x["ids"]),
            J(x["table"]), J(x["pos"]), J(x["kps"]), J(x["vps"])))
np.savez(sys.argv[2], **out)
print("JAX_OK")
"""


def _blk(a, axis, i, n):
    """Block i of n of ``a`` along ``axis`` (a numpy copy)."""
    size = a.shape[axis] // n
    return np.take(a, np.arange(i * size, (i + 1) * size), axis=axis)


def islands_rank(env, path):
    """Every case of this world size on one rank: its blocks of the
    inputs in, its output blocks out."""
    from repro_torch.serving import sharded_attention as sa
    x = dict(np.load(path))
    T = torch.from_numpy
    n = env.world_size
    m = Mesh(env, model=n)
    d = m.axis_index("model")
    hq, hk = H // n, HKV // n
    out = {}
    q = T(_blk(x["q"], 1, d, n))
    for name, kv in (("group", True), ("repl", False)):
        k = T(_blk(x["k"], 1, d, n)) if kv else T(x["k"])
        v = T(_blk(x["v"], 1, d, n)) if kv else T(x["v"])
        f = sa.hplb_prefill_attention()
        out[f"prefill_{name}"] = f(
            1, q, k, v, T(x[f"items_{name}_{n}"][d:d + 1])).numpy()
    f = sa.hplb_prefill_attention_rows(m)
    out["prefill_rows"] = f(1, T(x["q"]), T(x["k"]), T(x["v"]),
                            T(x[f"items_rows_{n}"][d:d + 1])).numpy()
    qd = T(_blk(x["qd"], 1, d, n))
    pos = T(x["pos"])
    f = sa.hplb_decode_attention_packed()
    it = T(x[f"packed_{n}"][d:d + 1])
    out["packed"] = f(qd, T(_blk(x["kc"], 1, d, n)), T(_blk(x["vc"], 1, d, n)),
                      it, pos).numpy()
    out["packed8"] = f(qd, T(_blk(x["kc8"], 1, d, n)),
                       T(_blk(x["vc8"], 1, d, n)), it, pos,
                       T(_blk(x["kscale"], 1, d, n)),
                       T(_blk(x["vscale"], 1, d, n))).numpy()
    f = sa.flash_decode_attention(m, seq_axes=("model",))
    out["contig"] = f(T(x["qd"]), T(_blk(x["kc"], 2, d, n)),
                      T(_blk(x["vc"], 2, d, n)),
                      T(x[f"seqids_{n}"][d:d + 1]), pos).numpy()
    f = sa.flash_decode_attention_paged(m, seq_axes=("model",))
    for t in ("table", "table_one"):
        out[f"paged_{t}"] = f(T(x["qd"]), T(_blk(x["kp"], 0, d, n)),
                              T(_blk(x["vp"], 0, d, n)), T(x["ids"]),
                              T(x[t]), pos).numpy()
    out["paged8"] = f(T(x["qd"]), T(_blk(x["kp8"], 0, d, n)),
                      T(_blk(x["vp8"], 0, d, n)), T(x["ids"]),
                      T(x["table"]), pos, T(_blk(x["kps"], 0, d, n)),
                      T(_blk(x["vps"], 0, d, n))).numpy()
    rep = sa.hplb_repermute_kv_cache(m)
    out["reperm"] = rep(T(_blk(x["rep_cache"], 3, d, n)),
                        x["rep_perm"]).numpy()
    g = sa.hplb_swap_gather_kv_blocks
    s = sa.hplb_swap_scatter_kv_blocks
    pool, blocks = g(T(_blk(x["swap_pool"], 3, d, n)), x["swap_ids"])
    out["swap_blocks"] = blocks.numpy()
    out["swap_pool"] = s(pool.clone(), blocks, x["swap_new"]).numpy()
    # the 2D island: model = n // 2 x seq = 2
    mm = n // 2
    m2 = Mesh(env, model=mm, seq=2)
    dm, ds = m2.axis_index("model"), m2.axis_index("seq")
    f = sa.flash_decode_attention_2d(m2)
    q2 = T(_blk(x["qd"], 1, dm, mm))
    ids2 = T(_blk(x["ids"], 1, dm, mm))

    def pool2(a):
        return T(_blk(_blk(a, 0, ds, 2), 1, dm, mm))
    for t in ("table", "table_one"):
        out[f"twod_{t}"] = f(q2, pool2(x["kp"]), pool2(x["vp"]), ids2,
                             T(x[t]), pos).numpy()
    out["twod8"] = f(q2, pool2(x["kp8"]), pool2(x["vp8"]), ids2,
                     T(x["table"]), pos, pool2(x["kps"]),
                     pool2(x["vps"])).numpy()
    return {"coords": dict(m.coords), "coords2": dict(m2.coords), **out}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("islands")
    inputs = make_inputs(tmp / "in.npz")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-c", JAX_SCRIPT,
                          str(tmp / "in.npz"), str(tmp / "out.npz")],
                         env=env, cwd=ROOT, capture_output=True, text=True,
                         timeout=600)
    assert res.returncode == 0 and "JAX_OK" in res.stdout, res.stderr[-3000:]
    ref = dict(np.load(tmp / "out.npz"))
    ranks = {n: spawn(islands_rank, world_size=n, backend="gloo",
                      device="cpu", timeout_s=DEADLINE,
                      args=(str(tmp / "in.npz"),)) for n in (2, 4)}
    return inputs, ref, ranks


def _by_model(ranks, key):
    """The output blocks of the ranks along ``model``, concatenated on the
    head axis (rank order is model order at seq 1)."""
    return np.concatenate([r[key] for r in ranks], axis=1)


def _same_on_all(ranks, key):
    for r in ranks[1:]:
        assert np.array_equal(r[key], ranks[0][key]), key
    return ranks[0][key]


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("mode", ["group", "repl"])
def test_prefill_island(data, n, mode):
    """The reference's ``kv_sharded`` True (kv_group: local heads and kv
    ids) and False (kv_replication: every kv head, global kv ids) against
    the port's one island over the same blocks: each rank's heads."""
    _, ref, ranks = data
    got = _by_model(ranks[n], f"prefill_{mode}")
    np.testing.assert_allclose(got, ref[f"prefill_{mode}_{n}"], atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("n", [2, 4])
def test_prefill_rows_island(data, n):
    """Row mode: (head, q block) rows over ``model``, tiles summed; every
    rank holds the whole output."""
    _, ref, ranks = data
    got = _same_on_all(ranks[n], "prefill_rows")
    np.testing.assert_allclose(got, ref[f"prefill_rows_{n}"], atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("kind", ["", "8"])
def test_packed_decode_island(data, n, kind):
    """The head-sharded packed decode, float32 and int8 codes + scales."""
    _, ref, ranks = data
    got = _by_model(ranks[n], f"packed{kind}")
    np.testing.assert_allclose(got, ref[f"packed{kind}_{n}"], atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("n", [2, 4])
def test_seq_sharded_decode_island(data, n):
    """``flash_decode_attention``: the slot cache sharded on its sequence,
    partials merged over ``model``."""
    _, ref, ranks = data
    got = _same_on_all(ranks[n], "contig")
    np.testing.assert_allclose(got, ref[f"contig_{n}"], atol=ATOL, rtol=0)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("key", ["paged_table", "paged_table_one", "paged8"])
def test_paged_decode_island(data, n, key):
    """The pool sharded on its block axis: tables remapped per stripe;
    ``table_one`` puts a row's blocks on one stripe, so the other stripes
    drop out of its merge; int8 codes with their scales' stripe."""
    _, ref, ranks = data
    got = _same_on_all(ranks[n], key)
    want = ref[f"{key}_{n}"]
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("key", ["twod_table", "twod_table_one", "twod8"])
def test_2d_decode_island(data, n, key):
    """Heads over ``model`` (n / 2), pool stripes over ``seq`` (2): merged
    along ``seq`` only."""
    _, ref, ranks = data
    mm = n // 2
    per_model = [r for r in ranks[n] if r["coords2"]["seq"] == 0]
    for r in ranks[n]:
        twin = per_model[r["coords2"]["model"]]
        assert np.array_equal(r[key], twin[key])
    got = np.concatenate([r[key] for r in per_model], axis=1)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref[f"{key}_{mm}"], atol=ATOL, rtol=0)


@pytest.mark.parametrize("n", [2, 4])
def test_repermute_island(data, n):
    """The epoch swap's kv-head gather moves heads across ranks exactly."""
    inputs, ref, ranks = data
    got = np.concatenate([r["reperm"] for r in ranks[n]], axis=3)
    assert np.array_equal(got, ref[f"reperm_{n}"])
    want = np.stack([inputs["rep_cache"][l][:, :, inputs["rep_perm"][l]]
                     for l in range(2)])
    assert np.array_equal(got, want)


@pytest.mark.parametrize("n", [2, 4])
def test_swap_islands_bit_for_bit(data, n):
    """Swap gather and scatter are shard-local and bit-exact: the gathered
    blocks are the plain take, the scatter round trip lands them at the
    new ids, both equal to the reference's bits."""
    inputs, ref, ranks = data
    blocks = np.concatenate([r["swap_blocks"] for r in ranks[n]], axis=3)
    pool = np.concatenate([r["swap_pool"] for r in ranks[n]], axis=3)
    assert np.array_equal(blocks, ref[f"swap_blocks_{n}"])
    assert np.array_equal(pool, ref[f"swap_pool_{n}"])
    assert np.array_equal(blocks, inputs["swap_pool"][:, :, inputs["swap_ids"]])
    back = pool[:, :, inputs["swap_new"][:3]]
    assert np.array_equal(back, inputs["swap_pool"][:, :,
                                                    inputs["swap_ids"][:3]])
