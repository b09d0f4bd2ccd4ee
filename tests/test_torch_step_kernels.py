"""The plain versions of the two Gram-step contractions
(tt_irt_tpu_torch/ops/step.py) against the JAX package's Pallas kernels
(ops/pallas_step.py, interpret mode on the CPU) on the same numpy-made
operands."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tt_irt_tpu.ops.pallas_step import condition_update, gram_conditional
from tt_irt_tpu_torch.ops import kernel_plan
from tt_irt_tpu_torch.ops.step import (condition_update_cuda,
                                       condition_update_ref,
                                       gram_conditional_cuda,
                                       gram_conditional_ref)


def _operands(m, r, n, seed, edge=False, free_lb=False):
    """phi, a general (non-symmetric) P, a core, brackets and weights as
    tests/test_fused_step.py::test_kernels_match_numpy makes them."""
    rng = np.random.default_rng(seed)
    phi = rng.standard_normal((m, r)).astype(np.float32)
    pmat = rng.standard_normal((r, r, n)).astype(np.float32).reshape(
        r * r, n)
    core = rng.standard_normal((r, n, r)).astype(np.float32)
    cmat = np.transpose(core, (1, 0, 2)).reshape(n, r * r).copy()
    i0 = rng.integers(0, n - 1, size=m).astype(np.int32)
    if edge:
        i0[: m // 2] = n - 2
    la = rng.uniform(size=m).astype(np.float32)
    lb = (rng.uniform(size=m).astype(np.float32) if free_lb
          else (1.0 - la).astype(np.float32))
    return phi, pmat, cmat, i0, la, lb


# (m, r, n, i0 pinned at n-2 on half the rows, lb drawn independently);
# the last past rank 64, the Gram family's wide tier on the card.
CASES = [(256, 23, 33, False, False), (64, 1, 9, False, False),
         (128, 5, 17, True, False), (128, 7, 17, False, True),
         (64, 72, 9, True, False)]


@pytest.mark.parametrize("m,r,n,edge,free_lb", CASES)
def test_gram_conditional_ref_matches_jax_kernel(m, r, n, edge, free_lb):
    """1e-5 of the largest |fk|, the JAX test's own bar: two f32 sums of
    r^2 terms in different orders."""
    phi, pmat, _, _, _, _ = _operands(m, r, n, 0, edge, free_lb)
    fj = np.asarray(gram_conditional(jnp.asarray(phi), jnp.asarray(pmat)))
    ft = gram_conditional_ref(torch.from_numpy(phi),
                              torch.from_numpy(pmat)).numpy()
    ref = np.einsum("mi,ijx,mj->mx", phi.astype(np.float64),
                    pmat.reshape(r, r, n).astype(np.float64),
                    phi.astype(np.float64))
    scale = np.max(np.abs(ref))
    assert np.max(np.abs(ft - fj)) / scale < 1e-5
    assert np.max(np.abs(ft - ref)) / scale < 1e-5


def test_gram_wide_model_matches_jax_kernel():
    """The card's arithmetic past rank 64 (the Gram stage of
    csrc/tc_gram.cuh, modelled on the CPU by
    tests/test_torch_tf32_split.py::gram_wide_model) against the JAX
    package's Pallas kernel (interpret mode) at (9, 72): 1e-5 of the
    largest |fk|, the JAX test's own bar."""
    from test_torch_tf32_split import gram_wide_model

    m, r, n = 64, 72, 9
    phi, pmat, _, _, _, _ = _operands(m, r, n, 3)
    fj = np.asarray(gram_conditional(jnp.asarray(phi), jnp.asarray(pmat)))
    fm = gram_wide_model(torch.from_numpy(phi),
                         torch.from_numpy(pmat)).numpy()
    ref = np.einsum("mi,ijx,mj->mx", phi.astype(np.float64),
                    pmat.reshape(r, r, n).astype(np.float64),
                    phi.astype(np.float64))
    scale = np.max(np.abs(ref))
    assert np.max(np.abs(fm - fj)) / scale < 1e-5
    assert np.max(np.abs(fm - ref)) / scale < 1e-5


@pytest.mark.parametrize("m,r,n,edge,free_lb", CASES)
def test_condition_update_ref_matches_jax_kernel(m, r, n, edge, free_lb):
    """1e-5 absolute on the max-normalised prefix, the JAX test's bar."""
    phi, _, cmat, i0, la, lb = _operands(m, r, n, 1, edge, free_lb)
    pj = np.asarray(condition_update(
        jnp.asarray(phi), jnp.asarray(i0), jnp.asarray(la), jnp.asarray(lb),
        jnp.asarray(cmat)))
    pt = condition_update_ref(*(torch.from_numpy(a) for a in
                                (phi, i0, la, lb, cmat))).numpy()
    c64 = cmat.astype(np.float64).reshape(n, r, r)
    g = (la[:, None, None] * c64[i0] + lb[:, None, None] * c64[i0 + 1])
    ref = np.einsum("mi,mij->mj", phi.astype(np.float64), g)
    ref = ref / np.maximum(np.max(np.abs(ref), axis=1, keepdims=True), 1e-30)
    assert np.max(np.abs(pt - pj)) < 1e-5
    assert np.max(np.abs(pt - ref)) < 1e-5
    assert np.max(np.abs(pt)) == pytest.approx(1.0, abs=1e-6)


def test_kernel_plan_routes_cpu_and_f64_to_plain():
    """On CPU tensors kernel_plan runs the plain versions, and for an
    f64 contraction gram_step hands out the plain pair itself: no launch
    is counted; the CUDA wrappers raise on CPU tensors instead of
    falling back."""
    phi, pmat, cmat, i0, la, lb = (
        torch.from_numpy(a) for a in _operands(32, 4, 9, 2))
    before = (gram_conditional_cuda.launches, condition_update_cuda.launches)
    fk = kernel_plan.gram_conditional(phi, pmat)
    pn = kernel_plan.condition_update(phi, i0, la, lb, cmat)
    assert torch.equal(fk, gram_conditional_ref(phi, pmat))
    assert torch.equal(pn, condition_update_ref(phi, i0, la, lb, cmat))
    f64 = kernel_plan.gram_conditional(phi.double(), pmat.double())
    assert f64.dtype == torch.float64
    assert kernel_plan.gram_step(torch.float64) == (
        gram_conditional_ref, condition_update_ref)
    assert kernel_plan.gram_step(torch.float32) == (
        kernel_plan.gram_conditional, kernel_plan.condition_update)
    assert (gram_conditional_cuda.launches,
            condition_update_cuda.launches) == before
    with pytest.raises(ValueError, match="CUDA"):
        gram_conditional_cuda(phi, pmat)
    with pytest.raises(ValueError, match="CUDA"):
        condition_update_cuda(phi, i0, la, lb, cmat)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_plan_routes_cpu_and_f64_cdf_to_plain(dtype):
    """kernel_plan.cdf_invert runs the plain version on CPU tensors of
    either dtype, writing its sample into ``out`` and adding its dlf into
    ``lf``; on a device other than the CPU (here ``meta``, which computes
    shapes only) an f64 fk goes to the plain version too, and an f32 one
    to the kernel, whose wrapper raises off the card.  No launch is
    counted."""
    from tt_irt_tpu_torch.ops.cdf import cdf_invert_cuda, cdf_invert_ref

    rng = np.random.default_rng(5)
    m, n = 64, 9
    fk = torch.tensor(rng.uniform(size=(m, n)), dtype=dtype)
    xp = torch.linspace(-1.0, 1.0, n, dtype=dtype)
    h = torch.cat([torch.zeros(1, dtype=dtype), xp[1:] - xp[:-1]])
    qp = torch.tensor(rng.uniform(size=m), dtype=dtype)
    before = cdf_invert_cuda.launches
    out = torch.empty((m,), dtype=dtype)
    lf = torch.full((m,), 0.25, dtype=dtype)
    la, lb, i0 = kernel_plan.cdf_invert("sqr", fk, xp, h, qp, out, lf)
    x, dlf, la0, lb0, i00 = cdf_invert_ref("sqr", fk, xp, h, qp)
    assert torch.equal(out, x) and torch.equal(lf, 0.25 + dlf)
    assert torch.equal(la, la0) and torch.equal(lb, lb0)
    assert torch.equal(i0, i00)
    meta = [t.to("meta") for t in (fk, xp, h, qp, out, lf)]
    if dtype == torch.float64:
        _, _, i0m = kernel_plan.cdf_invert("sqr", *meta)
        assert i0m.device.type == "meta" and i0m.dtype == torch.int64
    else:
        with pytest.raises(ValueError, match="CUDA"):
            kernel_plan.cdf_invert("sqr", *meta)
    with pytest.raises(ValueError, match="CUDA"):
        cdf_invert_cuda("sqr", fk.float(), xp.float(), h.float(),
                        qp.float(), out.float(), lf.float())
    assert cdf_invert_cuda.launches == before
