"""Process-group meshes for the multi-GPU islands: the counterpart of the
reference's ``launch/mesh.py`` over ``torch.distributed`` ranks.

The reference lays a ``jax.make_mesh`` over its devices and runs each
island under ``shard_map``.  Here every rank is one process, started by
:func:`spawn`, and a :class:`Mesh` names its coordinate on each of the axes
(``data``, ``model``, ``seq``) and gives it the collectives an island
needs over an axis or a tuple of axes: :meth:`Mesh.psum`,
:meth:`Mesh.pmax` and :meth:`Mesh.all_gather`, the counterparts of
``jax.lax.psum`` / ``pmax`` / ``all_gather``.

Backends are explicit; no code picks one or moves a rank on its own.
``nccl`` needs one card per rank, and a mesh whose ranks share a device
raises (:func:`check_placement`).  ``gloo`` may put every rank on one card
(``device="cuda:0"``): its collectives run on host memory, so each one
copies a CUDA tensor to the host and back, the same way for every
collective (gloo has no CUDA ``all_gather``).  Only the transport differs:
every rank launches its own kernels on the card.

The islands' sums and maxima (:meth:`Mesh.psum`, :meth:`Mesh.pmax`) are an
``all_gather`` followed by a float32 fold in rank order, so every rank of
an axis gets the same bits on every backend and a merge does not depend on
the backend's reduction order.  The tensor-parallel model's sums over
whole activations (:meth:`Mesh.all_reduce`) take the backend's own
all-reduce in the tensor's dtype, which moves fewer bytes.

The factorization checks raise the reference's errors, over the world
size instead of ``jax.devices()``.
"""
from __future__ import annotations

import dataclasses
import datetime
import itertools
import math
import os
import queue as queue_mod
import shutil
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

AXES = ("data", "model", "seq")
BACKENDS = ("gloo", "nccl")


def _check_factorization(n: int, axes: dict[str, int]) -> None:
    """Reject axis sizes that do not factor the rank count, with the fix
    spelled out (which size to change, what the product is)."""
    prod = 1
    for v in axes.values():
        if v < 1:
            raise ValueError(
                f"mesh axis sizes must be >= 1, got {axes}")
        prod *= v
    if prod != n:
        parts = " * ".join(f"{k}={v}" for k, v in axes.items())
        raise ValueError(
            f"mesh factorization {parts} = {prod} does not match the "
            f"{n} visible device(s); pick axis sizes whose product is "
            f"{n} (e.g. lower --seq-shards, or start {prod} ranks: "
            f"spawn(..., world_size={prod}))")


def validate_heads_divide(num_kv_heads: int, model: int) -> None:
    """KV heads must split evenly over the model axis — a non-divisible
    count silently truncates head shards inside shard_map otherwise."""
    if model > 0 and num_kv_heads % model:
        raise ValueError(
            f"num_kv_heads={num_kv_heads} is not divisible by the model "
            f"axis size {model}; shrink the model axis to a divisor of "
            f"{num_kv_heads} (row-mode partitioning handles non-divisible "
            f"Q heads, but KV heads must tile the head-sharded cache)")


def check_placement(backend: str, devices) -> None:
    """Raise unless ``backend`` can run ranks placed on ``devices`` (one
    ``torch.device`` a rank, by rank): ``nccl`` needs a CUDA device a rank,
    no two ranks on one; ``gloo`` takes any placement."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    if backend != "nccl":
        return
    devs = [torch.device(d) for d in devices]
    if any(d.type != "cuda" for d in devs):
        raise ValueError(f"nccl runs only on CUDA devices, got "
                         f"{[str(d) for d in devs]}")
    seen: dict[torch.device, int] = {}
    for r, d in enumerate(devs):
        if d in seen:
            raise ValueError(
                f"nccl needs one card per rank, but ranks {seen[d]} and {r} "
                f"both sit on {d}; use gloo to share a card")
        seen[d] = r


@dataclasses.dataclass(frozen=True)
class RankEnv:
    """What :func:`spawn` hands a rank: its rank, the world size, the
    backend of the initialised process group, its device and every rank's
    device (by rank)."""

    rank: int
    world_size: int
    backend: str
    device: torch.device
    devices: tuple


class Mesh:
    """A ``data`` x ``model`` x ``seq`` mesh over the initialised process
    group: rank r sits at the row-major coordinate of r over the three
    axes (``seq`` fastest).  A tuple of axes is taken in mesh order; its
    index is row-major over them, as ``jax.lax.axis_index`` of a tuple.
    One process group is made for each axis and each combination of axes
    that spans more than one rank."""

    def __init__(self, env: RankEnv, *, data: int = 1, model: int = 1,
                 seq: int = 1):
        if not dist.is_initialized():
            raise RuntimeError("Mesh needs an initialised process group "
                               "(start the ranks with spawn)")
        if dist.get_backend() != env.backend:
            raise ValueError(f"the process group runs {dist.get_backend()}, "
                             f"the rank was started for {env.backend}")
        _check_factorization(env.world_size, {"data": data, "model": model,
                                              "seq": seq})
        check_placement(env.backend, env.devices)
        self.env = env
        self.backend = env.backend
        self.device = env.device
        self.shape = {"data": data, "model": model, "seq": seq}
        sizes = [data, model, seq]
        self.coords = dict(zip(AXES, _unravel(env.rank, sizes)))
        self._groups: dict[tuple, object] = {}
        # every rank makes the groups in one order (new_group is collective)
        for n in (1, 2, 3):
            for axes in itertools.combinations(AXES, n):
                if math.prod(self.shape[a] for a in axes) in (1, env.world_size):
                    continue
                for fixed in itertools.product(*(
                        range(self.shape[a]) for a in AXES if a not in axes)):
                    ranks = _members(axes, fixed, sizes)
                    group = dist.new_group(ranks=ranks)
                    if env.rank in ranks:
                        self._groups[axes] = group
        dist.barrier()                  # every rank has its groups

    @property
    def rank(self) -> int:
        return self.env.rank

    def _axes(self, axis) -> tuple:
        axes = (axis,) if isinstance(axis, str) else tuple(axis)
        if any(a not in AXES for a in axes) or list(axes) != sorted(
                axes, key=AXES.index) or len(set(axes)) != len(axes):
            raise ValueError(f"axes must be distinct names of {AXES} in "
                             f"mesh order, got {axis!r}")
        return axes

    def size(self, axis) -> int:
        """The number of ranks along ``axis`` (a name or a tuple)."""
        return math.prod(self.shape[a] for a in self._axes(axis))

    def axis_index(self, axis) -> int:
        """This rank's index along ``axis``: row-major over a tuple."""
        idx = 0
        for a in self._axes(axis):
            idx = idx * self.shape[a] + self.coords[a]
        return idx

    def _group(self, axes: tuple):
        return self._groups.get(axes)   # None: the default (world) group

    def all_gather(self, x: torch.Tensor, axis, dim: int = 0) -> torch.Tensor:
        """The blocks ``x`` of every rank along ``axis``, concatenated on
        ``dim`` in axis-index order (``jax.lax.all_gather(..., tiled=True)``).
        Moves raw bits, so any dtype gathers exactly."""
        axes = self._axes(axis)
        n = self.size(axes)
        if n == 1:
            return x
        x = x.contiguous()
        bits = x.view(_BITS[x.element_size()]) if x.dtype not in _GLOO_OK \
            else x
        staged = bits.cpu() if (self.backend == "gloo"
                                and bits.is_cuda) else bits
        parts = [torch.empty_like(staged) for _ in range(n)]
        dist.all_gather(parts, staged, group=self._group(axes))
        out = torch.cat(parts, dim=dim).to(x.device)
        return out if out.dtype == x.dtype else out.view(x.dtype)

    def _fold(self, x, axis, op):
        axes = self._axes(axis)
        n = self.size(axes)
        if n == 1:
            return x
        parts = self.all_gather(x.unsqueeze(0), axes, dim=0)
        acc = parts[0].to(torch.float32)
        for p in parts[1:]:             # in rank order, one rounding a term
            acc = op(acc, p.to(torch.float32))
        return acc.to(x.dtype)

    def psum(self, x: torch.Tensor, axis) -> torch.Tensor:
        """The sum of ``x`` over the ranks of ``axis``, taken in float32 in
        rank order and returned in ``x``'s dtype (``jax.lax.psum``)."""
        return self._fold(x, axis, torch.add)

    def all_reduce(self, x: torch.Tensor, axis) -> torch.Tensor:
        """The sum of ``x`` over the ranks of ``axis`` by the backend's
        all-reduce, in ``x``'s dtype and the backend's order (every rank
        gets the same bits): for the model's sums of row-sharded products,
        where the bytes moved matter more than the order."""
        axes = self._axes(axis)
        if self.size(axes) == 1:
            return x
        staged = (x.cpu() if self.backend == "gloo" and x.is_cuda
                  else x.clone()).contiguous()
        dist.all_reduce(staged, group=self._group(axes))
        return staged.to(x.device)

    def pmax(self, x: torch.Tensor, axis) -> torch.Tensor:
        """The elementwise maximum of ``x`` over the ranks of ``axis``
        (``jax.lax.pmax``)."""
        return self._fold(x, axis, torch.maximum)


# gloo gathers these dtypes as they are; others move as raw integer bits
_GLOO_OK = (torch.float32, torch.float64, torch.int32, torch.int64,
            torch.int8, torch.uint8, torch.float16)
_BITS = {1: torch.uint8, 2: torch.float16, 4: torch.int32, 8: torch.int64}


def _unravel(rank: int, sizes) -> list[int]:
    out = []
    for s in reversed(sizes):
        out.append(rank % s)
        rank //= s
    return out[::-1]


def _members(axes: tuple, fixed: tuple, sizes) -> list[int]:
    """The ranks whose coordinates off ``axes`` are ``fixed`` (in mesh
    order), sorted."""
    free = [AXES.index(a) for a in axes]
    other = [i for i in range(3) if i not in free]
    ranks = []
    for combo in itertools.product(*(range(sizes[i]) for i in free)):
        c = [0, 0, 0]
        for i, v in zip(free, combo):
            c[i] = v
        for i, v in zip(other, fixed):
            c[i] = v
        ranks.append((c[0] * sizes[1] + c[1]) * sizes[2] + c[2])
    return sorted(ranks)


def make_host_mesh(env: RankEnv, model: int | None = None,
                   data: int | None = None) -> Mesh:
    """A ``data`` x ``model`` mesh over the ranks (the reference's
    ``make_host_mesh``; ``seq`` has size 1)."""
    n = env.world_size
    if model is None and data is None:
        model = 1
        data = n
    elif model is None:
        if data < 1 or n % data:
            raise ValueError(
                f"data={data} does not divide the {n} visible device(s); "
                f"pick a divisor of {n}")
        model = n // data
    elif data is None:
        if model < 1 or n % model:
            raise ValueError(
                f"model={model} does not divide the {n} visible "
                f"device(s); pick a divisor of {n}")
        data = n // model
    _check_factorization(n, {"data": data, "model": model})
    return Mesh(env, data=data, model=model)


def make_host_mesh_2d(env: RankEnv, model: int = 1, seq: int = 1,
                      data: int | None = None,
                      num_kv_heads: int | None = None) -> Mesh:
    """The 2D head x sequence mesh (the reference's ``make_host_mesh_2d``):
    ``model`` shards kv heads, ``seq`` stripes the KV; ``data`` defaults to
    what is left over; ``num_kv_heads`` validates head divisibility."""
    n = env.world_size
    if model < 1 or seq < 1:
        raise ValueError(
            f"model and seq axis sizes must be >= 1, got model={model} "
            f"seq={seq}")
    if data is None:
        if n % (model * seq):
            _check_factorization(n, {"model": model, "seq": seq})
        data = n // (model * seq)
    _check_factorization(n, {"data": data, "model": model, "seq": seq})
    if num_kv_heads is not None:
        validate_heads_divide(num_kv_heads, model)
    return Mesh(env, data=data, model=model, seq=seq)


# -- starting ranks ----------------------------------------------------------

def rank_devices(device: str, world_size: int) -> list[torch.device]:
    """Each rank's device: ``"cpu"`` for all; ``"cuda"``: rank r on card r
    (the cards must suffice); ``"cuda:k"``: every rank on card k.  Raises
    if CUDA is asked for and absent: there is no CPU fallback."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return [dev] * world_size
    if dev.type != "cuda":
        raise ValueError(f"device must be cpu, cuda or cuda:k, got {device!r}")
    if not torch.cuda.is_available():
        raise RuntimeError(f"device={device!r} needs CUDA, which is not "
                           f"available; pass device='cpu' to run on the CPU")
    count = torch.cuda.device_count()
    if dev.index is not None:
        if dev.index >= count:
            raise ValueError(f"{device} asked for, {count} card(s) present")
        return [dev] * world_size
    if world_size > count:
        raise ValueError(f"device='cuda' puts rank r on card r: {world_size} "
                         f"ranks need {world_size} cards, {count} present "
                         f"(device='cuda:0' with gloo shares one card)")
    return [torch.device("cuda", r) for r in range(world_size)]


def _rank_main(rank, world_size, backend, devices, store, timeout_s, fn,
               args, results, done):
    """One rank: initialise the process group, run ``fn(env, *args)``,
    post ``(rank, ok, result or traceback)``, and stay alive until the
    parent has taken every result (shared tensors live in this process)."""
    try:
        torch.set_num_threads(1)
        device = devices[rank]
        if device.type == "cuda":
            torch.cuda.set_device(device)
        dist.init_process_group(
            backend, init_method=f"file://{store}", rank=rank,
            world_size=world_size,
            timeout=datetime.timedelta(seconds=timeout_s))
        env = RankEnv(rank, world_size, backend, device, tuple(devices))
        results.put((rank, True, fn(env, *args)))
    except BaseException:                   # reported to the parent, re-raised
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        done.wait(timeout_s)
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn, *, world_size: int, backend: str, device: str,
          timeout_s: float, args: tuple = ()) -> list:
    """Run ``fn(env, *args)`` on ``world_size`` new ranks and return their
    results by rank.

    ``fn`` must be importable (a module-level function of the package):
    ranks start from a fresh interpreter (the ``spawn`` start method; CUDA
    forbids ``fork``).  The process group meets through a file store in a
    new temporary directory, with ``timeout_s`` as its timeout.  Build the
    CUDA kernels (``kernels.build.build()``) before calling: ranks load the
    libraries and never race to compile them.

    Raises ``RuntimeError`` with the rank's traceback if a rank fails or
    dies, ``TimeoutError`` if not every rank has answered by the deadline
    (``timeout_s`` from the start); every rank is stopped either way, and
    no partial result is returned.
    """
    devices = rank_devices(device, world_size)
    check_placement(backend, devices)
    ctx = torch.multiprocessing.get_context("spawn")
    results, done = ctx.Queue(), ctx.Event()
    tmp = tempfile.mkdtemp(prefix="mesh-")
    store = os.path.join(tmp, "store")
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, world_size, backend, devices, store,
                               timeout_s, fn, args, results, done))
             for r in range(world_size)]
    deadline = time.monotonic() + timeout_s
    got: dict[int, object] = {}
    started = []
    try:
        for p in procs:
            p.start()
            started.append(p)
        while len(got) < world_size:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"{world_size - len(got)} of {world_size} ranks did not "
                    f"finish within {timeout_s} s (ranks done: "
                    f"{sorted(got)})")
            try:
                rank, ok, value = results.get(timeout=min(left, 0.5))
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in got and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(
                        f"rank {dead[0]} died with exit code "
                        f"{procs[dead[0]].exitcode} before it reported")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            got[rank] = value
        done.set()
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1.0))
        return [got[r] for r in range(world_size)]
    finally:
        done.set()
        for p in started:
            if p.is_alive():
                p.terminate()
        for p in started:
            p.join(5)
            if p.is_alive():
                p.kill()
                p.join(5)
        shutil.rmtree(tmp, ignore_errors=True)
