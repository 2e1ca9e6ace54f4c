"""Per-head sparsity profiles (paper §2.4): the offline profile type and
the synthetic generator, copied from the reference package's
``core/sparsity.py``.

A :class:`HeadSparsityProfile` holds, per (layer, head), the recovery ratio
of the top-``frac`` tokens on a normalized budget grid — the input of the
budget allocator.  :func:`synthetic_head_curves` draws structured per-head
power-law curves (the profile the serving engine plans from when no
calibration run exists).
"""
from __future__ import annotations

import dataclasses
import json
import numpy as np

# On-disk profile schema.  v1 files predate the field (load() treats a
# missing entry as v1); v2 adds the version itself plus epoch-snapshot
# metadata written by the online telemetry layer.  Readers must accept any
# version <= SCHEMA_VERSION and ignore unknown npz entries, so snapshots
# written by newer telemetry stay forward-readable.
SCHEMA_VERSION = 2

# Normalized budget grid on which recovery curves are tabulated.  Budgets are
# expressed as a fraction of the (causal) context available to each query, so
# a profile gathered at 4k transfers to 128k (paper Fig. 6: stability across
# context lengths).  Grid is log-spaced: sparse heads saturate at tiny
# fractions, so resolution matters most near zero.
DEFAULT_BUDGET_GRID: np.ndarray = np.unique(
    np.concatenate(
        [
            np.array([0.0]),
            np.logspace(-4, 0, 49),
        ]
    )
)



@dataclasses.dataclass
class HeadSparsityProfile:
    """Offline per-head sparsity profile for one model.

    Attributes
    ----------
    curves:
        ``[num_layers, num_heads, G]`` mean recovery ratio at each normalized
        budget in ``grid``.  Monotone non-decreasing along the last axis.
    grid:
        ``[G]`` normalized budget fractions.
    num_samples:
        how many calibration (query-block, input) samples were averaged.
    meta:
        free-form provenance (model name, calibration set, date).
    """

    curves: np.ndarray
    grid: np.ndarray
    num_samples: int = 0
    meta: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self) -> None:
        self.curves = np.asarray(self.curves, dtype=np.float64)
        self.grid = np.asarray(self.grid, dtype=np.float64)
        if self.curves.ndim == 2:  # single layer convenience
            self.curves = self.curves[None]
        assert self.curves.shape[-1] == self.grid.shape[0], (
            f"curve grid mismatch: {self.curves.shape} vs {self.grid.shape}"
        )
        # Enforce monotonicity (numerical noise from averaging).
        self.curves = np.maximum.accumulate(self.curves, axis=-1)

    # -- queries ----------------------------------------------------------
    @property
    def num_layers(self) -> int:
        return self.curves.shape[0]

    @property
    def num_heads(self) -> int:
        return self.curves.shape[1]

    def recovery_at(self, layer: int, head: int, frac: float | np.ndarray) -> np.ndarray:
        """Interpolated recovery ratio at normalized budget ``frac``."""
        return np.interp(frac, self.grid, self.curves[layer, head])

    def budget_for_recovery(self, layer: int, head: int, target: float) -> float:
        """Smallest normalized budget achieving recovery >= ``target``.

        Inverse of the recovery curve (paper Fig. 4: per-head budget at
        p = 0.9).  Returns 1.0 if the target is unreachable.
        """
        c = self.curves[layer, head]
        if target <= c[0]:
            return float(self.grid[0])
        if target > c[-1]:
            return 1.0
        # first grid point reaching target, then linear inverse interp
        idx = int(np.searchsorted(c, target, side="left"))
        lo, hi = idx - 1, idx
        c0, c1 = c[lo], c[hi]
        g0, g1 = self.grid[lo], self.grid[hi]
        if c1 <= c0:
            return float(g1)
        t = (target - c0) / (c1 - c0)
        return float(g0 + t * (g1 - g0))

    def budgets_for_recovery(self, target: float) -> np.ndarray:
        """``[L, H]`` normalized budgets reaching ``target`` recovery."""
        out = np.empty((self.num_layers, self.num_heads))
        for l in range(self.num_layers):
            for h in range(self.num_heads):
                out[l, h] = self.budget_for_recovery(l, h, target)
        return out

    def heterogeneity(self, layer: int, target: float = 0.9) -> float:
        """max/min ratio of per-head budgets at ``target`` (paper Fig. 4)."""
        b = np.array(
            [self.budget_for_recovery(layer, h, target) for h in range(self.num_heads)]
        )
        return float(b.max() / max(b.min(), 1e-9))

    # -- merging / stability ----------------------------------------------
    def merge(self, other: "HeadSparsityProfile") -> "HeadSparsityProfile":
        """Sample-weighted average of two profiles on the same grid."""
        assert self.curves.shape == other.curves.shape
        assert np.allclose(self.grid, other.grid)
        n0, n1 = max(self.num_samples, 1), max(other.num_samples, 1)
        curves = (self.curves * n0 + other.curves * n1) / (n0 + n1)
        return HeadSparsityProfile(curves, self.grid, n0 + n1, dict(self.meta))

    def stability_vs(self, other: "HeadSparsityProfile", target: float = 0.9) -> float:
        """Pearson correlation of per-head budgets between two profiles.

        The paper's stability claim (Fig. 6) == this correlation being high
        across calibration sets of different tasks / context lengths.
        """
        a = self.budgets_for_recovery(target).ravel()
        b = other.budgets_for_recovery(target).ravel()
        if a.std() < 1e-12 or b.std() < 1e-12:
            return 1.0
        return float(np.corrcoef(a, b)[0, 1])

    # -- (de)serialization --------------------------------------------------
    def save(self, path: str) -> None:
        np.savez_compressed(
            path,
            curves=self.curves,
            grid=self.grid,
            num_samples=np.int64(self.num_samples),
            meta=np.bytes_(json.dumps(self.meta).encode()),
            schema_version=np.int64(SCHEMA_VERSION),
        )

    @staticmethod
    def load(path: str) -> "HeadSparsityProfile":
        z = np.load(path, allow_pickle=False)
        meta = json.loads(bytes(z["meta"]).decode()) if "meta" in z else {}
        # v1 files predate the field; anything newer must still load (only
        # entries this reader knows about are touched)
        meta["schema_version"] = (int(z["schema_version"])
                                  if "schema_version" in z else 1)
        return HeadSparsityProfile(
            z["curves"], z["grid"], int(z["num_samples"]), meta
        )



# ---------------------------------------------------------------------------
# Synthetic sparsity generators (benchmarks / tests / dry-run planning).
# ---------------------------------------------------------------------------

def synthetic_head_curves(
    num_layers: int,
    num_heads: int,
    seed: int = 0,
    grid: np.ndarray | None = None,
    alpha_range: tuple[float, float] = (0.15, 40.0),
) -> HeadSparsityProfile:
    """Structured synthetic per-head recovery curves.

    Each head draws a sparsity exponent ``alpha`` and gets the recovery curve
    ``rec(f) = f^{1/(1+alpha)}`` over the normalized top-fraction ``f`` —
    the closed-form recovery of a ``rank^-(1+alpha)`` attention-mass law.
    Large ``alpha`` = very sparse ("retrieval"-like) heads that saturate
    almost immediately (alpha=40: top-1% recovers ~89%, matching the
    measurement quoted in paper §2.3), small ``alpha`` = diffuse heads that
    need a large fraction of the context.  The family reproduces the
    qualitative heterogeneity of paper Fig. 3.  Head identity is drawn from a
    *fixed* rng — mirroring the paper's cross-request stability — while
    ``seed`` models different calibration sets via small jitter (Fig. 6).
    """
    if grid is None:
        grid = DEFAULT_BUDGET_GRID
    rng = np.random.default_rng(12345)  # head identity: fixed across "datasets"
    jitter_rng = np.random.default_rng(seed)
    lo, hi = alpha_range
    # log-uniform alphas: a few extremely sparse heads, a tail of diffuse ones
    alphas = np.exp(rng.uniform(np.log(lo), np.log(hi), size=(num_layers, num_heads)))
    curves = np.empty((num_layers, num_heads, len(grid)))
    for l in range(num_layers):
        for h in range(num_heads):
            a = alphas[l, h] * (1.0 + 0.03 * jitter_rng.standard_normal())
            a = max(a, 1e-3)
            beta = 1.0 / (1.0 + a)  # rec(f) = f^beta; beta->0 sparse, ->1 dense
            rec = np.maximum(grid, 0.0) ** beta
            curves[l, h] = np.clip(rec, 0.0, 1.0)
    curves[..., 0] = 0.0
    curves[..., -1] = 1.0
    return HeadSparsityProfile(
        curves, grid, num_samples=1,
        meta={"synthetic": True, "seed": seed, "alpha_range": list(alpha_range)},
    )
