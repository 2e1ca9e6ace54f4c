"""Deterministic fault injection + the structured failure vocabulary the
self-healing serving engine speaks (DESIGN.md §2.13): a copy of the
reference package's ``serving/faults.py`` (pure Python).

Production serving state (a paged block pool with a host swap tier,
epoch-versioned plans, quantized scales) fails in ways a unit test never
exercises on its own: a host transfer times out, an fp8 scale goes NaN, an
allocator raises halfway through mapping a prompt.  This module makes
those failures INJECTABLE — deterministically, from a seeded plan — so the
recovery machinery (sentinels + quarantine, retry/backoff swaps, invariant
audits, epoch-swap rollback, checkpoint/restore) is testable end to end.

Design rules:

- **Named seams, not monkeypatching.**  The engine calls
  :meth:`FaultInjector.fire` at a handful of chokepoints (:data:`SEAMS`);
  what happens there is data (a :class:`FaultSpec`), not test code.
- **Disabled == absent.**  Every seam guards on ``injector is None or not
  injector.enabled`` before doing anything, so the hot path with no
  injector configured is bitwise-identical to a build without this module.
- **Deterministic.**  Specs trigger on per-seam *invocation counts*
  (``after`` / ``times``), never on wall clock or RNG at fire time;
  :meth:`FaultPlan.random` derives a schedule from a seed once, up front.

Failure vocabulary (raised by seams AND by the self-healing layer):

- :class:`TransferError` — a host<->device swap transfer failed (after
  the engine's bounded retries, when it reaches the scheduler).
- :class:`InjectedAllocError` — allocator exhaustion mid-admission; a
  ``MemoryError`` subclass so existing capacity handling catches it.
- :class:`EpochSwapError` — a plan-epoch swap failed; the engine rolls
  back to the old epoch and keeps serving.
- :class:`IntegrityError` — an invariant audit found corrupt accounting;
  carries the structured list of violated invariants.
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np

# the engine's injection chokepoints, in hot-path order
SEAMS = (
    "swap_out_transfer",   # device -> pinned-host block copy (preemption)
    "swap_in_transfer",    # pinned-host -> device block copy (resume)
    "admission_alloc",     # allocator block mapping during admit/swap-in
    "kv_corrupt",          # NaN/Inf into a resident KV block (or scale)
    "epoch_swap",          # plan-epoch swap application (replan)
    "poison_request",      # one request's prefill produces garbage logits
)


class FaultError(Exception):
    """Base of the structured failure vocabulary: every error names the
    seam (or subsystem) it came from and, when scoped, the victim rid."""

    def __init__(self, seam: str, detail: str = "", rid: int | None = None):
        self.seam = seam
        self.detail = detail
        self.rid = rid
        where = f"{seam}" + (f" rid={rid}" if rid is not None else "")
        super().__init__(f"[{where}] {detail}" if detail else f"[{where}]")


class TransferError(FaultError):
    """A host<->device swap transfer failed (retries exhausted)."""


class EpochSwapError(FaultError):
    """A plan-epoch swap failed before commit; the old plan keeps serving."""


class InjectedAllocError(MemoryError):
    """Injected allocator exhaustion mid-admission.  Subclasses
    ``MemoryError`` so the scheduler's capacity handling (and the
    allocator's partial-failure rollback) treat it like the real thing."""

    def __init__(self, detail: str, rid: int | None = None):
        self.seam = "admission_alloc"
        self.rid = rid
        super().__init__(detail)


class IntegrityError(Exception):
    """An invariant audit failed.  ``failures`` is the structured list of
    violated invariants (one human-readable string each) — callers log it
    whole instead of serving corrupt state."""

    def __init__(self, failures: list[str]):
        self.failures = list(failures)
        super().__init__(
            f"{len(self.failures)} invariant(s) violated: "
            + "; ".join(self.failures))


@dataclasses.dataclass
class FaultSpec:
    """One scheduled fault at one seam.

    ``after``: matching invocations of the seam to let pass first;
    ``times``: consecutive matching invocations to then hit (an engine
    retry re-fires the seam, so ``times < swap_retries`` heals and
    ``times > swap_retries`` exhausts the retry budget).
    ``rid``: scope — at transfer/admission seams a filter on the sequence
    being operated on; at ``kv_corrupt`` / ``poison_request`` the VICTIM
    designation (those seams fire per tick/prefill without a subject).
    ``mode``: seam-dependent — transfers: ``"fail"`` | ``"delay"``
    (``value`` seconds); ``kv_corrupt``: ``"nan"`` | ``"inf"``.
    """

    seam: str
    mode: str = "fail"
    after: int = 0
    times: int = 1
    rid: int | None = None
    value: float = 0.0

    def __post_init__(self):
        if self.seam not in SEAMS:
            raise ValueError(f"unknown seam {self.seam!r} (have {SEAMS})")
        self._seen = 0            # matching invocations observed so far

    def matches(self, rid: int | None) -> bool:
        # rid=None invocations (per-tick seams) match every spec; a
        # spec's rid then designates the victim instead of filtering
        return self.rid is None or rid is None or self.rid == rid

    @property
    def exhausted(self) -> bool:
        return self._seen >= self.after + self.times

    def to_dict(self) -> dict:
        return {k: v for k, v in dataclasses.asdict(self).items()
                if not k.startswith("_")}


@dataclasses.dataclass
class FaultPlan:
    """A deterministic fault schedule: an ordered tuple of specs, plus the
    seed it was derived from (provenance — replaying the same plan against
    the same workload reproduces the same failures)."""

    specs: tuple[FaultSpec, ...] = ()
    seed: int | None = None

    def to_json(self) -> str:
        return json.dumps({"seed": self.seed,
                           "specs": [s.to_dict() for s in self.specs]})

    @staticmethod
    def from_json(s: str) -> "FaultPlan":
        d = json.loads(s)
        return FaultPlan(
            specs=tuple(FaultSpec(**sp) for sp in d.get("specs", ())),
            seed=d.get("seed"))

    @staticmethod
    def load(path: str) -> "FaultPlan":
        with open(path) as f:
            return FaultPlan.from_json(f.read())

    @staticmethod
    def random(seed: int, rate: float, horizon: int = 100,
               seams: tuple[str, ...] = SEAMS,
               max_rid: int | None = None) -> "FaultPlan":
        """A seeded random schedule for chaos runs: per seam, each of the
        first ``horizon`` invocations independently faults with
        probability ``rate`` (so a 1% chaos run passes ``rate=0.01``).
        ``max_rid`` scopes ``kv_corrupt`` / ``poison_request`` victims to
        real rids.  Deterministic: same (seed, rate, horizon) -> same
        plan."""
        rng = np.random.default_rng(seed)
        specs: list[FaultSpec] = []
        for seam in seams:
            hits = np.nonzero(rng.random(horizon) < rate)[0]
            for at in hits:
                mode = "fail"
                rid = None
                if seam == "kv_corrupt":
                    mode = "nan" if rng.random() < 0.5 else "inf"
                if seam in ("kv_corrupt", "poison_request") \
                        and max_rid is not None:
                    rid = int(rng.integers(0, max_rid))
                specs.append(FaultSpec(seam=seam, mode=mode, after=int(at),
                                       times=1, rid=rid))
        return FaultPlan(specs=tuple(specs), seed=seed)


class FaultInjector:
    """Counts seam invocations and fires the plan's matching specs.

    One injector serves one engine run.  ``events`` records every fired
    fault (seam, invocation index, rid, mode) — the chaos benchmark and
    the tests read it back to assert exactly the scheduled faults (and no
    others) happened.
    """

    def __init__(self, plan: FaultPlan | None = None):
        self.plan = plan
        self._by_seam: dict[str, list[FaultSpec]] = {s: [] for s in SEAMS}
        for spec in (plan.specs if plan is not None else ()):
            self._by_seam[spec.seam].append(spec)
        self._count: dict[str, int] = {s: 0 for s in SEAMS}
        self.events: list[dict] = []

    @property
    def enabled(self) -> bool:
        """False when no spec can ever fire again — seams guard on this
        before doing ANY work, so a drained (or empty) injector costs one
        attribute read on the hot path."""
        return any(not s.exhausted for ss in self._by_seam.values()
                   for s in ss)

    def fired(self, seam: str) -> int:
        """How many faults this seam has fired so far."""
        return sum(1 for e in self.events if e["seam"] == seam)

    def fire(self, seam: str, rid: int | None = None) -> FaultSpec | None:
        """Count one invocation of ``seam``; return the spec that fires on
        it (first match wins), or None.  Each spec counts only MATCHING
        invocations, so rid-scoped specs trigger on the victim's Nth
        operation regardless of interleaved traffic."""
        n = self._count[seam]
        self._count[seam] = n + 1
        hit = None
        for spec in self._by_seam[seam]:
            if not spec.matches(rid):
                continue
            seen = spec._seen
            spec._seen = seen + 1
            if hit is None and spec.after <= seen < spec.after + spec.times:
                hit = spec
        if hit is not None:
            self.events.append({"seam": seam, "invocation": n, "rid": rid,
                                "mode": hit.mode,
                                "victim": hit.rid if rid is None else rid})
        return hit
