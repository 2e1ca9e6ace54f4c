"""The port's process-group mesh (``repro_torch.launch.mesh``) on the CPU:
the reference's factorization and head-divide errors, the collectives
(``psum`` / ``pmax`` / ``all_gather`` / ``all_reduce``) over
``model``, ``seq`` and (``model``, ``seq``) on a 2 x 2 ``gloo`` mesh, the
placement check (``nccl`` with two ranks on one device raises, without
NCCL), no CUDA fallback, and ``spawn``'s deadline: a rank that raises or
hangs makes it raise in time.  Every spawn has a deadline of at most
120 s, so no test can hang the suite."""
import time

import numpy as np
import pytest
import torch

from repro.launch import mesh as ref_mesh
from repro_torch.launch import mesh as M

torch.set_num_threads(1)

DEADLINE = 120
CPU = torch.device("cpu")


def _env(n: int) -> M.RankEnv:
    """A rank's environment with no process group: enough for the checks
    that raise before a mesh is made."""
    return M.RankEnv(0, n, "gloo", CPU, (CPU,) * n)


def _message(fn, *args, **kw) -> str:
    with pytest.raises(ValueError) as e:
        fn(*args, **kw)
    return str(e.value)


@pytest.mark.parametrize("n,axes", [
    (4, {"data": 2, "model": 3}), (8, {"model": 2, "seq": 2}),
    (2, {"data": 0, "model": 2}), (1, {"data": 1, "model": 4, "seq": 1})])
def test_factorization_errors_match_reference(n, axes):
    """The same ValueError text as the reference's, up to its remedy
    clause, which names the rank count to start instead of an XLA flag."""
    ref = _message(ref_mesh._check_factorization, n, axes)
    got = _message(M._check_factorization, n, axes)
    head = ref.split("(e.g.")[0]
    assert got.split("(e.g.")[0] == head
    if "(e.g." in ref:
        assert f"world_size={int(np.prod(list(axes.values())))}" in got


@pytest.mark.parametrize("kv,model", [(3, 2), (1, 4), (8, 3)])
def test_head_divide_errors_match_reference(kv, model):
    assert (_message(M.validate_heads_divide, kv, model)
            == _message(ref_mesh.validate_heads_divide, kv, model))
    M.validate_heads_divide(kv, 1)     # a divisor passes


def _head(msg: str) -> str:
    return msg.split("(e.g.")[0]


@pytest.mark.parametrize("fn,kw", [
    ("make_host_mesh", dict(model=3)), ("make_host_mesh", dict(data=3)),
    ("make_host_mesh", dict(model=0)), ("make_host_mesh", dict(data=0)),
    ("make_host_mesh_2d", dict(model=0, seq=1)),
    ("make_host_mesh_2d", dict(model=1, seq=3)),
    ("make_host_mesh_2d", dict(model=2, seq=2, data=1))])
def test_host_mesh_errors_match_reference(fn, kw):
    """Over as many ranks as the reference sees devices, the mesh makers
    raise its errors (up to the factorization's remedy clause) before any
    process group is needed."""
    import jax
    n = len(jax.devices())
    assert _head(_message(getattr(M, fn), _env(n), **kw)) == _head(
        _message(getattr(ref_mesh, fn), **kw))


def test_mesh_2d_validates_kv_heads():
    with pytest.raises(ValueError) as e:
        M.make_host_mesh_2d(_env(2), model=2, seq=1, num_kv_heads=3)
    assert str(e.value) == _message(ref_mesh.validate_heads_divide, 3, 2)


def test_placement_check():
    """nccl: a CUDA device a rank, none shared; gloo: anything.  The check
    itself, with no NCCL and no card needed."""
    two = [torch.device("cuda", 0), torch.device("cuda", 0)]
    with pytest.raises(ValueError, match="one card per rank"):
        M.check_placement("nccl", two)
    with pytest.raises(ValueError, match="only on CUDA"):
        M.check_placement("nccl", [CPU, CPU])
    with pytest.raises(ValueError, match="backend must be"):
        M.check_placement("mpi", [CPU])
    M.check_placement("nccl", [torch.device("cuda", 0),
                               torch.device("cuda", 1)])
    M.check_placement("gloo", two)
    M.check_placement("gloo", [CPU, CPU])


def test_no_cuda_fallback():
    """Asking for CUDA where there is none raises; only device='cpu' runs
    on the CPU."""
    assert M.rank_devices("cpu", 3) == [CPU] * 3
    if torch.cuda.is_available():
        return
    for dev in ("cuda", "cuda:0"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            M.rank_devices(dev, 2)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            M.spawn(_collectives, world_size=2, backend="gloo", device=dev,
                    timeout_s=DEADLINE)


def _collectives(env):
    """On a 2 x 2 (model x seq) mesh: coordinates, and psum / pmax /
    all_gather over model, seq and (model, seq) of bf16, f32 and int32."""
    m = M.Mesh(env, model=2, seq=2)
    r = float(env.rank)
    out = {"coords": dict(m.coords),
           "index": {a: m.axis_index(a) for a in
                     ("data", "model", "seq", ("model", "seq"))},
           "size": {a: m.size(a) for a in ("model", "seq",
                                            ("model", "seq"))}}
    for dt in (torch.bfloat16, torch.float32):
        x = torch.full((2, 3), r + 0.5, dtype=dt)
        for ax in ("model", "seq", ("model", "seq")):
            key = f"{dt}-{ax}"
            out[f"psum-{key}"] = m.psum(x, ax).float().numpy()
            out[f"pmax-{key}"] = m.pmax(x, ax).float().numpy()
            out[f"gather-{key}"] = m.all_gather(x, ax, dim=1).float().numpy()
            out[f"allreduce-{key}"] = m.all_reduce(x, ax).float().numpy()
            assert m.psum(x, ax).dtype == dt == m.all_reduce(x, ax).dtype
    ints = torch.arange(3, dtype=torch.int32) + 10 * env.rank
    out["gather-int"] = m.all_gather(ints, ("model", "seq"), dim=0).numpy()
    try:
        m.axis_index(("seq", "model"))
    except ValueError:
        out["order_checked"] = True
    return out


@pytest.fixture(scope="module")
def collectives():
    t0 = time.monotonic()
    res = M.spawn(_collectives, world_size=4, backend="gloo", device="cpu",
                  timeout_s=DEADLINE)
    return res, time.monotonic() - t0


def test_coordinates_row_major(collectives):
    res, _ = collectives
    for rank, r in enumerate(res):
        assert r["coords"] == {"data": 0, "model": rank // 2,
                               "seq": rank % 2}
        assert r["index"] == {"data": 0, "model": rank // 2,
                              "seq": rank % 2, ("model", "seq"): rank}
        assert r["size"] == {"model": 2, "seq": 2, ("model", "seq"): 4}
        assert r["order_checked"]


def _members(rank, ax):
    """The ranks sharing ``rank``'s coordinates off ``ax``, in axis order."""
    m, s = rank // 2, rank % 2
    if ax == "model":
        return [s, 2 + s]
    if ax == "seq":
        return [2 * m, 2 * m + 1]
    return [0, 1, 2, 3]


@pytest.mark.parametrize("dt", ["torch.bfloat16", "torch.float32"])
@pytest.mark.parametrize("axis", ["model", "seq", ("model", "seq")])
def test_collectives(collectives, dt, axis):
    res, _ = collectives
    for rank, r in enumerate(res):
        peers = _members(rank, axis)
        vals = [p + 0.5 for p in peers]
        key = f"{dt}-{axis}"
        assert np.all(r[f"psum-{key}"] == sum(vals)), key
        assert np.all(r[f"pmax-{key}"] == max(vals)), key
        assert np.all(r[f"allreduce-{key}"] == sum(vals)), key
        want = np.concatenate([np.full((2, 3), v, np.float32) for v in vals],
                              axis=1)
        assert np.array_equal(r[f"gather-{key}"], want), key


def test_gather_moves_raw_bits(collectives):
    res, _ = collectives
    for r in res:
        assert r["gather-int"].tolist() == [
            10 * k + i for k in range(4) for i in range(3)]


def _raises(env):
    if env.rank == 1:
        raise KeyError("planted")
    time.sleep(60)


def _hangs(env):
    if env.rank == 0:
        time.sleep(600)
    return env.rank


def test_failed_rank_raises_within_deadline():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="(?s)rank 1 failed.*planted"):
        M.spawn(_raises, world_size=2, backend="gloo", device="cpu",
                timeout_s=DEADLINE)
    assert time.monotonic() - t0 < 45


def test_hung_rank_raises_at_deadline():
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="1 of 2 ranks"):
        M.spawn(_hangs, world_size=2, backend="gloo", device="cpu",
                timeout_s=20)
    assert time.monotonic() - t0 < 40
