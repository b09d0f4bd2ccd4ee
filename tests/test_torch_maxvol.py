"""The port's pivot routines (tt_irt_tpu_torch/ops/maxvol.py) against the
JAX package's on the same numpy matrices: bit for bit."""

import numpy as np
import pytest

from tt_irt_tpu.ops import maxvol as jmv
from tt_irt_tpu_torch.ops import maxvol as tmv


def _mats():
    rng = np.random.default_rng(11)
    low = rng.standard_normal((40, 5)) @ rng.standard_normal((5, 30))
    decay = (rng.standard_normal((30, 10)) @ np.diag(2.0 ** -np.arange(10))
             @ rng.standard_normal((10, 25)))
    return {
        "tall": rng.standard_normal((60, 8)),
        "square": rng.standard_normal((9, 9)),
        "short": rng.standard_normal((5, 8)),
        "rank_deficient": low,
        "decay": decay,
        "complex": (rng.standard_normal((50, 6))
                    + 1j * rng.standard_normal((50, 6))),
        "zeros": np.zeros((7, 5)),
        "int": rng.integers(-5, 6, (20, 4)),
    }


MATS = _mats()


def _same(a, b):
    if isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", sorted(MATS))
def test_maxvol_functions_bit_for_bit(name):
    """maxvol, maxvol_rect, trunc_svd and localcross give the JAX
    package's outputs bit for bit (indices, factors, dtypes)."""
    a = MATS[name]
    if a.shape[0] >= a.shape[1] and name != "zeros":
        _same(jmv.maxvol(a), tmv.maxvol(a))
        _same(jmv.maxvol_rect(a, kmax=a.shape[1] + 4),
              tmv.maxvol_rect(a, kmax=a.shape[1] + 4))
    elif name == "short":
        _same(jmv.maxvol(a), tmv.maxvol(a))
    for tol, rmax in ((1e-12, None), (1e-2, None), (1e-8, 3), (0.0, None)):
        _same(jmv.trunc_svd(a, tol, rmax), tmv.trunc_svd(a, tol, rmax))
        _same(jmv.localcross(a, tol, rmax), tmv.localcross(a, tol, rmax))


def test_lu_row_pivots_and_fallback_bit_for_bit(monkeypatch):
    """The LU pivot order, through LAPACK and through the loop used
    without scipy, is the JAX package's."""
    a = MATS["tall"]
    _same(jmv._lu_row_pivots(a), tmv._lu_row_pivots(a))
    monkeypatch.setattr(jmv, "_lu_factor", None)
    monkeypatch.setattr(tmv, "_lu_factor", None)
    _same(jmv._lu_row_pivots(a), tmv._lu_row_pivots(a))
    _same(jmv.maxvol(a), tmv.maxvol(a))


def test_maxvol_properties():
    """The port's maxvol is quasi-dominant and localcross orthonormal,
    as the JAX tests require of theirs."""
    a = MATS["tall"]
    ind = tmv.maxvol(a)
    b = np.linalg.solve(a[ind].T, a.T).T
    assert len(set(ind.tolist())) == 8 and np.max(np.abs(b)) <= 1.1
    u, v = tmv.localcross(MATS["rank_deficient"], 1e-12)
    np.testing.assert_allclose(u @ v, MATS["rank_deficient"], atol=1e-9)
    np.testing.assert_allclose(u.T @ u, np.eye(u.shape[1]), atol=1e-10)
