"""The whole-transform path (tt_irt_tpu_torch/ops/fused_irt.py) against
the JAX package's pallas_irt_sqr (interpret mode on the CPU) on the two
TTs of tests/test_pallas.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tt_irt_tpu as ti
import tt_irt_tpu_torch as tp
from tt_irt_tpu.ops.pallas_irt import build_pallas_data, pallas_irt_sqr
from tt_irt_tpu_torch.ops.fused_irt import fused_irt_sqr_cuda


def _gauss_tt(n, d, lo, corr):
    """sqrt of a banded Gaussian on a tensor grid, compressed by the JAX
    package's tt_from_dense; returns numpy cores and grids."""
    grids = [np.linspace(-lo, lo, n) for _ in range(d)]
    prec = np.eye(d) + corr * (np.eye(d, k=1) + np.eye(d, k=-1))
    mesh = np.meshgrid(*grids, indexing="ij")
    pts = np.stack([m.ravel() for m in mesh], axis=1)
    dense = np.exp(-0.25 * np.einsum("mi,ij,mj->m", pts, prec, pts)).reshape(
        [n] * d)
    t = ti.tt_from_dense(jnp.asarray(dense), eps=1e-12)
    return [np.array(c) for c in t.cores], grids


def _both(cores, grids):
    jtt = ti.TT([jnp.asarray(c) for c in cores])
    ttt = tp.TT([torch.from_numpy(c) for c in cores])
    return jtt, ttt, [torch.from_numpy(g) for g in grids]


def test_build_fused_data_matches_jax():
    """p2, coreu and x equal build_pallas_data's f32 arrays to 1e-6 of
    each array's largest entry (an f64 Gram-carry prep on both sides,
    then a cast).  The spacings h take the place of the scum matrices:
    scum[k] is their trapezoid-cumsum matrix."""
    cores, grids = _gauss_tt(17, 4, 3.0, 0.3)
    jtt, ttt, tg = _both(cores, grids)
    dj = build_pallas_data(jtt, grids)
    dt = tp.build_fused_data(ttt, tg)
    assert (dt["d"], dt["n"], dt["r"]) == (dj["d"], dj["n"], dj["r"])
    for name in ("p2", "coreu", "x"):
        a, b = dt[name].numpy(), np.asarray(dj[name])
        assert a.dtype == np.float32 and a.shape == b.shape
        assert np.max(np.abs(a - b)) / np.max(np.abs(b)) < 1e-6, name
    h = dt["h"].numpy()
    scum = np.asarray(dj["scum"])
    # column n-1 of scum holds the composite trapezoid weights
    w = np.zeros_like(scum[:, :, -1])
    w[:, :-1] += 0.5 * h
    w[:, 1:] += 0.5 * h
    assert np.max(np.abs(w - scum[:, :, -1])) < 1e-6


def test_fused_irt_sqr_matches_jax_kernel_and_f64():
    """fused_irt_sqr (plain version, CPU) vs pallas_irt_sqr(interpret)
    on 300 seeds: 2e-4 in samples and log-density between the two f32
    implementations (the one-sided inversion amplifies the f32 CDF floor
    in the right tail, and the cumsum is a running sum here, a matmul
    there; measured 6.2e-5 / 1.3e-5, with the port 2.2e-5 and the JAX
    kernel 8.4e-5 from the f64 scan), and both inside the JAX bars
    against the f64 scan (5e-2 samples, 1e-3 log-density, 1e-3 means)."""
    cores, grids = _gauss_tt(17, 4, 3.0, 0.3)
    jtt, ttt, tg = _both(cores, grids)
    q = np.random.default_rng(1234).random((300, 4))
    x64, l64 = ti.tt_irt_sqr(grids, jtt, jnp.asarray(q))
    xj, lj = pallas_irt_sqr(grids, jtt, jnp.asarray(q), block=128,
                            interpret=True)
    xt, lt = tp.fused_irt_sqr(tg, ttt, torch.from_numpy(q), device="cpu")
    assert xt.dtype == torch.float32 and xt.shape == (300, 4)
    xt, lt = xt.numpy().astype(np.float64), lt.numpy().astype(np.float64)
    assert np.max(np.abs(xt - np.asarray(xj))) < 2e-4
    assert np.max(np.abs(lt - np.asarray(lj))) < 2e-4
    for xs, ls in ((xt, lt), (np.asarray(xj, np.float64),
                              np.asarray(lj, np.float64))):
        assert np.max(np.abs(xs - np.asarray(x64))) < 5e-2
        assert np.max(np.abs(ls - np.asarray(l64))) < 1e-3
        assert np.max(np.abs(xs.mean(0) - np.asarray(x64).mean(0))) < 1e-3


def test_fused_irt_sqr_padding_and_port_f64():
    """100 rows, not a multiple of the block of 64: the output is cut
    back to 100 rows, finite, equal to the JAX kernel to 2e-4, and
    within the same bars of the port's own f64 tt_irt_sqr."""
    cores, grids = _gauss_tt(9, 3, 2.0, 0.0)
    jtt, ttt, tg = _both(cores, grids)
    q = np.random.default_rng(5).random((100, 3))
    xj, lj = pallas_irt_sqr(grids, jtt, jnp.asarray(q), block=64,
                            interpret=True)
    xt, lt = tp.fused_irt_sqr(tg, ttt, torch.from_numpy(q), block=64,
                              device="cpu")
    assert xt.shape == (100, 3) and lt.shape == (100,)
    assert bool(torch.isfinite(xt).all()) and bool(torch.isfinite(lt).all())
    assert np.max(np.abs(xt.numpy() - np.asarray(xj))) < 2e-4
    assert np.max(np.abs(lt.numpy() - np.asarray(lj))) < 2e-4
    x64, l64 = tp.tt_irt_sqr(tg, ttt, torch.from_numpy(q), device="cpu")
    assert float((xt.double() - x64).abs().max()) < 5e-2
    assert float((lt.double() - l64).abs().max()) < 1e-3


def test_fused_irt_sqr_wide_matches_jax_kernel():
    """Past rank 64 (n = 9, r = 72, d = 2: the wide tier on the card) on
    64 seeds: the port's plain version, and the same transform with the
    card's arithmetic (the Gram stage and the dense-weighted update of
    csrc/fused_wide.cu as tests/test_torch_tf32_split.py models them),
    against pallas_irt_sqr(interpret) within 2e-4 (the bar of the narrow
    shapes above), and both within the JAX bars of the f64 scan."""
    import tt_irt_tpu_torch.ops.fused_irt as fused_mod
    from test_torch_tf32_split import dense_update_model, gram_wide_model

    n, d, r = 9, 2, 72
    rng = np.random.default_rng(72)
    cores = [rng.uniform(0.1, 1.0, (1, n, r)),
             rng.uniform(0.1, 1.0, (r, n, 1))]
    grids = [np.linspace(-1.0, 1.0, n)] * d
    jtt, ttt, tg = _both(cores, grids)
    q = rng.random((64, d))
    xj, lj = pallas_irt_sqr(grids, jtt, jnp.asarray(q), block=64,
                            interpret=True)
    x64, l64 = ti.tt_irt_sqr(grids, jtt, jnp.asarray(q))
    data = tp.build_fused_data(ttt, tg)
    assert data["r"] == r
    ops = (torch.from_numpy(q).float(), data["p2"], data["coreu"],
           data["x"], data["h"])
    runs = {"plain": fused_mod.fused_irt_sqr_ref(*ops)}
    saved = (fused_mod.gram_conditional_ref, fused_mod.condition_update_ref)
    fused_mod.gram_conditional_ref = gram_wide_model
    fused_mod.condition_update_ref = dense_update_model
    try:
        runs["card model"] = fused_mod.fused_irt_sqr_ref(*ops)
    finally:
        fused_mod.gram_conditional_ref, fused_mod.condition_update_ref = \
            saved
    for name, (xt, lt) in runs.items():
        xt = xt.numpy().astype(np.float64)
        lt = lt.numpy().astype(np.float64)
        assert np.max(np.abs(xt - np.asarray(xj))) < 2e-4, name
        assert np.max(np.abs(lt - np.asarray(lj))) < 2e-4, name
        assert np.max(np.abs(xt - np.asarray(x64))) < 5e-2, name
        assert np.max(np.abs(lt - np.asarray(l64))) < 1e-3, name


def test_fused_irt_degenerate_rows_and_edges():
    """A dimension whose conditional is identically zero takes the
    uniform fix (samples x0 + q (x_end - x0), log-density -log of the
    box width), and seeds exactly 0 and 1 land on the box corners."""
    n, d = 9, 3
    x = np.linspace(-1.0, 3.0, n)
    cores = [np.ones((1, n, 1)), np.zeros((1, n, 1)), np.ones((1, n, 1))]
    ttt = tp.TT([torch.from_numpy(c) for c in cores])
    q = np.array([[0.0, 0.25, 1.0], [1.0, 0.5, 0.0], [0.3, 1.0, 0.7]])
    xt, lt = tp.fused_irt_sqr([torch.from_numpy(x)] * d, ttt,
                              torch.from_numpy(q), device="cpu")
    np.testing.assert_allclose(xt.numpy(), -1.0 + 4.0 * q, atol=1e-6)
    np.testing.assert_allclose(lt.numpy(), -3 * np.log(4.0), atol=1e-6)


def test_fused_irt_cuda_wrapper_raises_on_cpu_tensors():
    cores, grids = _gauss_tt(9, 3, 2.0, 0.0)
    _, ttt, tg = _both(cores, grids)
    data = tp.build_fused_data(ttt, tg)
    q = torch.rand((8, 3), dtype=torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        fused_irt_sqr_cuda(q, data["p2"], data["coreu"], data["x"],
                           data["h"])
    assert fused_irt_sqr_cuda.launches == 0
