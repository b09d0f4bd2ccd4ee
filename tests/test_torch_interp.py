"""The port's Lagrange interpolation (tt_irt_tpu_torch/ops/interp.py)
against the JAX package's on the same inputs, within 1e-12."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tt_irt_tpu_torch as tp
from tt_irt_tpu import TT as JTT
from tt_irt_tpu.ops import interp as jinterp


@pytest.mark.parametrize("n,kind", [(7, "cheb"), (12, "uniform"),
                                    (25, "uniform")])
def test_lagrange_matrix_matches_jax(n, kind):
    """At random points, at exact grid hits and outside the interval."""
    rng = np.random.default_rng(n)
    if kind == "cheb":
        x = np.cos(np.pi * np.arange(n) / (n - 1))[::-1].copy()
    else:
        x = np.linspace(-2.0, 3.0, n)
    y = np.concatenate([rng.uniform(x[0], x[-1], 40), x[[0, 3, n - 1]],
                        [x[0] - 0.1, x[-1] + 0.2]])
    ref = np.asarray(jinterp.lagrange_matrix(jnp.asarray(x), jnp.asarray(y)))
    got = tp.lagrange_matrix(torch.from_numpy(x), torch.from_numpy(y))
    assert got.dtype == torch.float64 and got.device.type == "cpu"
    # within 1e-12 of each entry (the extrapolated rows reach 1e6)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-12, atol=1e-12)
    # exact hits give unit rows; every row sums to one
    np.testing.assert_array_equal(got.numpy()[40:43].argmax(1), [0, 3, n - 1])
    np.testing.assert_allclose(got.numpy().sum(1), 1.0, atol=1e-10)


@pytest.mark.parametrize("rd", [1, 3])
def test_tt_sample_lagrange_matches_jax(rd):
    """A TT (right boundary rank 1, or a block of 3) at continuous
    points: values within 1e-12 of the JAX package's, and equal to the
    TT's own values at grid points."""
    rng = np.random.default_rng(5 + rd)
    d, n, r = 4, 9, 3
    ranks = [1, r, r, r, rd]
    cores = [rng.standard_normal((ranks[k], n, ranks[k + 1]))
             for k in range(d)]
    grids = [np.linspace(-1.0, 1.0 + 0.1 * k, n) for k in range(d)]
    pts = np.stack([rng.uniform(g[0], g[-1], 64) for g in grids], axis=1)
    ref = np.asarray(jinterp.tt_sample_lagrange(
        JTT([jnp.asarray(c) for c in cores]),
        [jnp.asarray(g) for g in grids], jnp.asarray(pts)))
    tt = tp.tt_from_numpy(cores, device="cpu")
    got = tp.tt_sample_lagrange(tt, [torch.from_numpy(g) for g in grids],
                                torch.from_numpy(pts))
    assert tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=1e-12 * max(1.0, np.abs(ref).max()))
    idx = rng.integers(0, n, (16, d))
    at_nodes = tp.tt_sample_lagrange(
        tt, grids, np.stack([grids[k][idx[:, k]] for k in range(d)], 1))
    exact = tp.tt_eval_indices(tt, torch.from_numpy(idx))
    np.testing.assert_allclose(at_nodes.numpy(), exact.numpy().reshape(
        at_nodes.shape), rtol=0, atol=1e-12)
