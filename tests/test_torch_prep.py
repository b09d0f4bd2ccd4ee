"""The port's backward preparation and epilogue
(tt_irt_tpu_torch/samplers/irt_scan.py) against the JAX package."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tt_irt_tpu.ops.tt import TT as JTT
from tt_irt_tpu.samplers import irt_scan as jscan
from tt_irt_tpu_torch.ops.tt import TT
from tt_irt_tpu_torch.samplers import irt_scan as tscan


def _cores(d, n, r, seed):
    """Random TT cores (boundary ranks 1), made with numpy."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(d):
        r1 = 1 if k == 0 else r
        r2 = 1 if k == d - 1 else r
        out.append(rng.standard_normal((r1, n, r2)))
    return out


def test_prepare_scan_factor_matches_jax():
    """A random TT (d=6, n=17, r=5) and a rank-1 TT padded to rank 5 —
    zero Gram lanes that need the Cholesky jitter — prepared together as
    one batch of levels.  The factors agree with JAX's per-level
    _prepare_scan_factor to 1e-12 relative: both are f64 with different
    summation orders (einsum contractions, LAPACK vs torch Cholesky)."""
    d, n, r = 6, 17, 5
    x = np.linspace(-3.0, 3.0, n)
    full = _cores(d, n, r, 1)
    rank1 = [np.abs(c) + 0.1 for c in _cores(d, n, 1, 2)]
    stacks = []
    for cores in (full, rank1):
        cs, xs = jscan.stack_padded(JTT([jnp.asarray(c) for c in cores]),
                                    [jnp.asarray(x)] * d)
        stacks.append(np.asarray(cs))
    pad1 = np.zeros((d, r, n, r))
    pad1[:, :1, :, :1] = stacks[1]
    stacks[1] = pad1
    xs = np.stack([x] * d)
    bt, ht = tscan._prepare_scan_factor(torch.from_numpy(np.stack(stacks)),
                                        torch.from_numpy(xs))
    for lvl, cs in enumerate(stacks):
        bj, hj = jscan._prepare_scan_factor(jnp.asarray(cs), jnp.asarray(xs))
        bj = np.asarray(bj)
        assert np.all(np.isfinite(bt[lvl].numpy()))
        err = np.max(np.abs(bt[lvl].numpy() - bj)) / np.max(np.abs(bj))
        assert err < 1e-12, (lvl, err)
        np.testing.assert_array_equal(ht.numpy(), np.asarray(hj))


def test_stack_padded_matches_jax():
    cores = _cores(5, 9, 4, 3)
    cores[2] = cores[2][:, :, :2]
    cores[3] = cores[3][:2]
    x = np.linspace(0.0, 1.0, 9)
    cj, xj = jscan.stack_padded(JTT([jnp.asarray(c) for c in cores]),
                                [jnp.asarray(x)] * 5)
    ct, xt = tscan.stack_padded(TT([torch.from_numpy(c) for c in cores]),
                                [torch.from_numpy(x)] * 5)
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    np.testing.assert_array_equal(xt.numpy(), np.asarray(xj))
    assert tscan.can_use_scan(TT([torch.from_numpy(c) for c in cores]),
                              [torch.from_numpy(x)] * 5, 5)


@pytest.mark.parametrize("mode", ["sqr", "rt"])
def test_serve_solve_matches_jax_epilogues(mode, monkeypatch):
    """The port's f64 epilogue equals the JAX f64 epilogue
    (TTIRT_SERVE_EPI=f64) to 1e-14 — the same f64 formulas — and the
    JAX default double-single epilogue to 1e-8 in samples: that one
    carries the grid nodes as f32 pairs and measured 5.5e-9 from its own
    f64 twin on these inputs.  Its log-density takes an f32 weight, so
    it is held to the transform-level 1e-5 bar by the sampler tests."""
    rng = np.random.default_rng(4)
    m = 2048
    x1 = rng.uniform(-1, 1, m)
    x2 = x1 + rng.uniform(0.05, 0.3, m)
    f1 = rng.uniform(0.01, 2, m).astype(np.float32)
    f2 = rng.uniform(0.01, 2, m).astype(np.float32)
    tot = rng.uniform(1, 2, m).astype(np.float32)
    c1 = (tot * rng.uniform(0, 0.5, m)).astype(np.float32)
    cr2 = (tot - c1 - 0.5 * (f1 + f2) * (x2 - x1)).astype(np.float32)
    x1h = x1.astype(np.float32)
    x2h = x2.astype(np.float32)
    out9 = np.stack([c1, cr2, f1, f2, x1h, (x1 - x1h).astype(np.float32),
                     x2h, (x2 - x2h).astype(np.float32), tot], axis=1)
    if mode == "rt":
        qp = x1 + rng.uniform(0, 1, m) * (x2 - x1)
    else:
        qp = rng.uniform(0, 1, m)
        qp[:2] = [0.5, 0.5 + 2.0 ** -26]
    ot, dt, _, _ = tscan._serve_solve(mode, torch.from_numpy(out9),
                                      torch.from_numpy(qp))
    ods, _, _, _ = jscan._serve_solve(mode, jnp.asarray(out9), None,
                                      jnp.asarray(qp))
    assert np.max(np.abs(ot.numpy() - np.asarray(ods))) < 1e-8
    monkeypatch.setattr(jscan, "_SERVE_EPI_ENV", "f64")
    o64, d64, _, _ = jscan._serve_solve(mode, jnp.asarray(out9), None,
                                        jnp.asarray(qp))
    assert np.max(np.abs(ot.numpy() - np.asarray(o64))) < 1e-14
    assert np.max(np.abs(dt.numpy() - np.asarray(d64))) < 1e-14
