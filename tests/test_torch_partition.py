"""The port's 1D partitioner on inputs where the reference's move pass
raises.

``refine_partition`` in the reference keeps moving items of the busiest
device after an accepted move has made another device the busiest, and
``best_partition([1, 1, 3, 13, 21, 23, 27, 29], 2)`` then raises
``ValueError``.  The port stops the move pass there.  These tests hold the
port to a consistent assignment on such inputs and to the reference's
result wherever the reference returns.  Every input comes from a fixed
seed, so each run checks the same cases.
"""
import numpy as np
import pytest
import torch

from repro.core import partition as ref_part
from repro_torch.core import partition as part

torch.set_num_threads(1)

# (devices, seed) of the weight vectors below; 658 / 1655 (3 devices) and
# 1131 / 3680 (4 devices) are inputs on which the reference raises
CASES = [(2, s) for s in range(5)] + [
    (3, s) for s in (0, 1, 2, 658, 1655)] + [
    (4, s) for s in (0, 1, 2, 1131, 3680)]


def _weights(devices: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    n = int(rng.integers(2 * devices + 2, 4 * devices + 3))
    return rng.integers(1, 31, size=n)


def _check_consistent(w, devices: int, a) -> None:
    """device_of in range, loads the per-device sums, no worse than LPT."""
    w = np.asarray(w, np.int64)
    assert a.device_of.shape == w.shape
    assert ((a.device_of >= 0) & (a.device_of < devices)).all()
    sums = np.zeros(devices, np.int64)
    np.add.at(sums, a.device_of, w)
    assert np.array_equal(a.loads, sums)
    assert a.makespan <= part.lpt_partition(w, devices).makespan


def _reference(w, devices: int):
    """The reference's result, or None where it raises."""
    try:
        return ref_part.best_partition(w, devices)
    except ValueError:
        return None


def test_best_partition_regression_two_devices():
    w = [1, 1, 3, 13, 21, 23, 27, 29]
    a = part.best_partition(w, 2)
    _check_consistent(w, 2, a)
    want = _reference(w, 2)
    if want is not None:
        assert np.array_equal(a.device_of, want.device_of)


@pytest.mark.parametrize("devices,seed", CASES)
def test_best_partition_consistent_and_equal_where_reference_returns(
        devices, seed):
    w = _weights(devices, seed)
    a = part.best_partition(w, devices)
    _check_consistent(w, devices, a)
    want = _reference(w, devices)
    if want is not None:
        assert np.array_equal(a.device_of, want.device_of)
        assert np.array_equal(a.loads, want.loads)


@pytest.mark.parametrize("devices,seed", CASES)
@pytest.mark.parametrize("seed_fn", ["lpt", "kk"])
def test_refine_partition_keeps_loads_consistent(devices, seed, seed_fn):
    w = _weights(devices, seed)
    start = getattr(part, f"{seed_fn}_partition")(w, devices)
    a = part.refine_partition(w, start)
    _check_consistent(w, devices, a)
    assert a.makespan <= start.makespan
    try:
        want = ref_part.refine_partition(
            w, getattr(ref_part, f"{seed_fn}_partition")(w, devices))
    except ValueError:
        return
    assert np.array_equal(a.device_of, want.device_of)
