"""The plain versions of the three factor-family kernels of the port
(factor_conditional, cdf_bracket_factor, odim_step) against the JAX
package's Pallas kernels, run in interpret mode on the CPU, on the same
numpy-made f32 operands."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tt_irt_tpu.ops.pallas_odim import odim_step as jax_odim_step
from tt_irt_tpu.ops.pallas_step import (
    cdf_bracket_factor as jax_cdf_bracket_factor,
    factor_conditional as jax_factor_conditional)
from tt_irt_tpu_torch.ops import kernel_plan
from tt_irt_tpu_torch.ops.dim_step import dim_step_ref
from tt_irt_tpu_torch.ops.odim_step import odim_step_cuda, odim_step_ref
from tt_irt_tpu_torch.ops.step import (cdf_bracket_factor_cuda,
                                       cdf_bracket_factor_ref,
                                       factor_conditional_cuda,
                                       factor_conditional_ref)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _operands(m, n, r, seed, mode="irt"):
    """f32 operands of one dimension step, made with numpy: a sorted
    grid, a positive prefix, a random factor scaled so that fk is O(1),
    and seeds that include 1e-9, 1 - 1e-9, exact 0.5 and 0.5 + 2^-26
    (in 'rt' mode: points on the grid's range, three of them on
    nodes)."""
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(-2.0, 2.0, n))
    x[0], x[-1] = -2.0, 2.0
    phi = rng.uniform(0.05, 1.0, (m, r)).astype(np.float32)
    phi /= np.max(np.abs(phi), axis=1, keepdims=True)
    bmat = (rng.standard_normal((r, n * r)) / r).astype(np.float32)
    q = rng.uniform(size=m)
    q[:4] = [1e-9, 1.0 - 1e-9, 0.5 + 2.0 ** -26, 0.5]
    x32 = x.astype(np.float32)
    qp32 = q.astype(np.float32)
    if mode == "rt":
        qp32 = rng.uniform(-2.0, 2.0, m).astype(np.float32)
        qp32[:3] = [-2.0, 2.0, x32[5]]
    return dict(phi=phi, qp32=qp32, um32=(1.0 - q).astype(np.float32),
                bmat=bmat, hrow=np.diff(x).astype(np.float32),
                xg=np.stack([x32, (x - x32.astype(np.float64)).astype(
                    np.float32)]))


def _dmat(h, n):
    e0 = np.eye(n, n - 1, dtype=np.float32)
    e1 = np.eye(n, n - 1, k=-1, dtype=np.float32)
    return 0.5 * (e0 + e1) * h[None, :]


def test_factor_conditional_ref_matches_numpy_and_pallas():
    """fk at (256 rows, r=23, n=33) against numpy and the Pallas kernel
    in interpret mode: 1e-6 of the largest fk, the bar of
    tests/test_fused_step.py::test_kernels_match_numpy (f32 sums of r
    products, then of r squares)."""
    rng = np.random.default_rng(0)
    m, r, n = 256, 23, 33
    phi = rng.standard_normal((m, r)).astype(np.float32)
    bt = rng.standard_normal((n, r, r)).astype(np.float32)
    bmat = np.transpose(bt, (1, 0, 2)).reshape(r, n * r)
    fk = factor_conditional_ref(_t(phi), _t(bmat)).numpy()
    ref = np.sum(np.einsum("mi,xij->mxj", phi.astype(np.float64),
                           bt.astype(np.float64)) ** 2, axis=2)
    assert fk.shape == (m, n) and fk.dtype == np.float32
    assert np.max(np.abs(fk - ref)) / np.max(ref) < 1e-6
    fj = np.asarray(jax_factor_conditional(jnp.asarray(phi),
                                           jnp.asarray(bmat)))
    assert np.max(np.abs(fk - fj)) / np.max(ref) < 1e-6
    # f64 operands (the 'ds' carry) stay f64
    f64 = factor_conditional_ref(_t(phi).double(), _t(bmat).double())
    assert f64.dtype == torch.float64
    assert np.max(np.abs(f64.numpy() - ref)) / np.max(ref) < 1e-13


@pytest.mark.parametrize("mode", ["irt", "rt"])
def test_cdf_bracket_factor_ref_matches_pallas_interpret(mode):
    """(out9, i0) at (512 rows, n=17, r=5) against the Pallas kernel in
    interpret mode.  out9 agrees to 1e-6 of each column's scale on rows
    with equal brackets (two f32 pipelines whose cells and running sums
    associate differently: the Pallas kernel forms them as matrix
    products).  i0 must be equal except on rows whose f32 target sits
    within 4 ulp of the CDF value of a node next to the bracket, where
    that rounding may move the bracket by one cell."""
    ops = _operands(512, 17, 5, seed=3, mode=mode)
    n = ops["xg"].shape[1]
    oj, ij = jax_cdf_bracket_factor(
        jnp.asarray(ops["phi"]), jnp.asarray(ops["qp32"]),
        jnp.asarray(ops["bmat"]), jnp.asarray(_dmat(ops["hrow"], n)),
        jnp.asarray(ops["hrow"][None, :]), jnp.asarray(ops["xg"]), mode=mode)
    oj, ij = np.asarray(oj), np.asarray(ij)
    ot, it = cdf_bracket_factor_ref(_t(ops["phi"]), _t(ops["qp32"]),
                                    _t(ops["bmat"]), _t(ops["hrow"]),
                                    _t(ops["xg"]), mode=mode)
    assert it.dtype == torch.int32
    ot, it = ot.numpy(), it.numpy()
    same = it == ij
    if mode == "rt":
        assert same.all()
    else:
        fk = factor_conditional_ref(_t(ops["phi"]), _t(ops["bmat"])).numpy()
        dc = 0.5 * (fk[:, :-1] + fk[:, 1:]) * ops["hrow"]
        ck = np.concatenate([np.zeros((512, 1), np.float32),
                             np.cumsum(dc, axis=1)], axis=1)
        tot = ck[:, -1]
        qt = ops["qp32"] * tot
        near = np.min(np.abs(ck - qt[:, None]), axis=1) <= 4 * 1.2e-7 * tot
        assert np.all(same | near), np.flatnonzero(~(same | near))
        assert np.mean(same) > 0.99
    scale = np.max(np.abs(oj), axis=0) + 1e-30
    assert np.max((np.abs(ot - oj) / scale)[same]) < 1e-6


def test_cdf_bracket_factor_is_dim_step_without_um32():
    """The kernel's function keeps the TPU kernel's right-tail target
    (1 - qp32) * tot: where um32 == 1 - qp32 in f32 its out9 equals
    dim_step's bit for bit, and for a seed within 2^-25 of 1 the target
    is 0 and the bracket is the last cell."""
    ops = _operands(512, 17, 5, seed=4)
    t = {k: _t(v) for k, v in ops.items()}
    cmat = torch.rand((17, 25), generator=torch.Generator().manual_seed(0))
    o9, i0 = cdf_bracket_factor_ref(t["phi"], t["qp32"], t["bmat"],
                                    t["hrow"], t["xg"])
    _, d9 = dim_step_ref(t["phi"], t["qp32"], t["um32"], t["bmat"], cmat,
                         t["hrow"], t["xg"])
    eq = t["um32"] == 1.0 - t["qp32"]
    assert 0.3 < float(eq.float().mean()) < 1.0
    assert torch.equal(o9[eq], d9[eq])
    assert ops["qp32"][1] == 1.0 and int(i0[1]) == 15
    assert float(d9[1, 4]) <= float(o9[1, 4])


@pytest.mark.parametrize("mode", ["irt", "rt"])
def test_odim_step_ref_matches_pallas_interpret(mode):
    """(psi', out9) at (512 rows, r=5, n=17) against the Pallas kernel
    in interpret mode on the unpacked f32 qmat.  Brackets identical;
    out9 to 1e-6 of each column's scale; psi' to 2e-5 in 'irt' mode: it
    is la v[i0] + (1 - la) v[i0+1] with the f32 in-cell weight la, whose
    rounding the CDF amplifies by tot / (f1 h) in low-density cells
    (measured 8.5e-6; the same holds for dim_step's phi', held to 1e-5
    in tests/test_torch_dim_step.py).  In 'rt' mode la does not pass
    through the CDF and psi' agrees to 1e-6 (measured 3.6e-7)."""
    ops = _operands(512, 17, 5, seed=7, mode=mode)
    pj, oj = jax_odim_step(
        jnp.asarray(ops["phi"]), jnp.asarray(ops["qp32"]),
        jnp.asarray(ops["um32"]), jnp.asarray(ops["bmat"]),
        jnp.asarray(ops["hrow"][None, :]), jnp.asarray(ops["xg"]), mode=mode)
    pj, oj = np.asarray(pj), np.asarray(oj)
    pt, ot = odim_step_ref(_t(ops["phi"]), _t(ops["qp32"]), _t(ops["um32"]),
                           _t(ops["bmat"]), _t(ops["hrow"]), _t(ops["xg"]),
                           mode=mode)
    pt, ot = pt.numpy(), ot.numpy()
    np.testing.assert_array_equal(ot[:, 4], oj[:, 4])
    np.testing.assert_array_equal(ot[:, 6], oj[:, 6])
    scale = np.max(np.abs(oj), axis=0) + 1e-30
    assert np.max(np.abs(ot - oj) / scale) < 1e-6
    err = np.max(np.abs(pt - pj))
    print(f"odim_step {mode}: psi' port vs Pallas interpret {err:.3g}")
    assert err < (1e-6 if mode == "rt" else 2e-5)
    assert np.max(np.abs(pt)) == 1.0


def test_new_kernels_on_cpu_run_plain_versions():
    """On CPU tensors the kernel plan hands out the plain versions, bit
    for bit, and launches nothing; the CUDA launchers refuse CPU tensors
    rather than choosing a version; an f64 carry gets the plain pair
    from factor_step."""
    ops = {k: _t(v) for k, v in _operands(64, 17, 5, seed=9).items()}
    phi, qp, um = ops["phi"], ops["qp32"], ops["um32"]
    a = kernel_plan.odim_step(phi, qp, um, ops["bmat"], ops["hrow"],
                              ops["xg"])
    b = odim_step_ref(phi, qp, um, ops["bmat"], ops["hrow"], ops["xg"])
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    a = kernel_plan.cdf_bracket_factor(phi, qp, ops["bmat"], ops["hrow"],
                                       ops["xg"])
    b = cdf_bracket_factor_ref(phi, qp, ops["bmat"], ops["hrow"], ops["xg"])
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    assert torch.equal(kernel_plan.factor_conditional(phi, ops["bmat"]),
                       factor_conditional_ref(phi, ops["bmat"]))
    with pytest.raises(ValueError, match="CUDA"):
        odim_step_cuda(phi, qp, um, ops["bmat"], ops["hrow"], ops["xg"])
    with pytest.raises(ValueError, match="CUDA"):
        cdf_bracket_factor_cuda(phi, qp, ops["bmat"], ops["hrow"], ops["xg"])
    with pytest.raises(ValueError, match="CUDA"):
        factor_conditional_cuda(phi, ops["bmat"])
    assert (odim_step_cuda.launches, cdf_bracket_factor_cuda.launches,
            factor_conditional_cuda.launches) == (0, 0, 0)
    first, _ = kernel_plan.factor_step(torch.float64)
    assert first is factor_conditional_ref
    assert kernel_plan.factor_step(torch.float32)[0] \
        is kernel_plan.factor_conditional


def test_odim_step_degenerate_rows():
    """Rows with no conditional mass (psi = 0) take the uniform density
    on the grid box (fk = 1, tot = the box width) and a zero psi'."""
    ops = _operands(32, 17, 5, seed=11)
    ops["phi"][:8] = 0.0
    pt, ot = odim_step_ref(*(_t(ops[k]) for k in (
        "phi", "qp32", "um32", "bmat", "hrow", "xg")))
    np.testing.assert_array_equal(ot[:8, 2].numpy(), 1.0)
    np.testing.assert_allclose(ot[:8, 8].numpy(), 4.0, rtol=1e-6)
    assert bool(torch.isfinite(pt).all()) and float(pt[:8].abs().max()) == 0.0
