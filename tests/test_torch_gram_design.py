"""A CPU model of the summation order of the shipped gram_conditional
kernel (tt_irt_tpu_torch/csrc/step.cu: rows blocked in registers on the
FP32 cores), held to the rule the card holds the kernel to: its fk no
further from the f64 fk than twice the plain f32 version's error plus
1e-6 of the largest |fk|, per dimension and through a whole level, on
examples/data/lz20_ck's own Gram fields (path A's checkpoint).

The model, ``gram_chain_model``, follows the kernel row by row:
  - P_x regrouped by node, each row of P_x padded with zeros to a
    multiple of 4 (the float4 reads);
  - v_i = fmaf(phi_j, P_x[i, j], v_i) over j in order, from 0;
  - fk[x] = fmaf(phi_i, v_i, f) over the true rank i in order, from 0.
Each fmaf is an exact f64 product and sum rounded to f32 (through f64:
a double rounding, which differs from the card's single rounding only
on rare ties).  How many rows a thread takes does not enter a row's
sum, so the kernel's fk is that of the one-row-a-thread kernel it
replaced, whose inner loop ran to the rank tier instead: the padding
adds exact zeros.  Nothing here needs a card."""

import os

import numpy as np
import pytest
import torch

from tt_irt_tpu_torch.ops.cdf import cdf_invert_into_ref
from tt_irt_tpu_torch.ops.step import (condition_update_ref,
                                       gram_conditional_ref)

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "examples", "data")
ROWS = 1 << 10


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Many small ops: one intra-op thread a process, so that parallel
    test workers do not oversubscribe the cores (as in
    tests/test_torch_tf32_split.py).  The caller's setting comes back
    afterwards."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def rank_tier(r):
    return 8 if r <= 8 else 16 if r <= 16 else 24 if r <= 24 else \
        32 if r <= 32 else 64


def _fma32(a, b, c):
    """fmaf on f32 tensors: the exact product plus c, rounded to f32."""
    return (a.double() * b.double() + c.double()).float()


def gram_chain_model(phi, pmat, pad=None):
    """fk (M, n) in the kernel's order from f32 phi (M, r) and pmat
    (r*r, n); ``pad``: the padded width of a row of P_x (default r
    rounded up to 4, the kernel's; the rank tier, the replaced kernel's)."""
    m, r = phi.shape
    n = pmat.shape[1]
    rj = pad if pad is not None else -(-r // 4) * 4
    p3 = torch.zeros((n, r, rj), dtype=torch.float32)
    p3[:, :, :r] = pmat.reshape(r, r, n).permute(2, 0, 1)   # [x, i, j]
    pj = torch.zeros((m, rj), dtype=torch.float32)
    pj[:, :r] = phi
    v = torch.zeros((m, n, r), dtype=torch.float32)
    for j in range(rj):
        v = _fma32(pj[:, j, None, None], p3[None, :, :, j], v)
    f = torch.zeros((m, n), dtype=torch.float32)
    for i in range(r):
        f = _fma32(phi[:, i, None], v[:, :, i], f)
    return f


def _errors(phi, pmat):
    """(model, plain f32) max |fk - fk64| relative to the largest
    |fk64|."""
    f64 = gram_conditional_ref(phi.double(), pmat.double())
    scale = float(f64.abs().max())
    em = float((gram_chain_model(phi, pmat).double() - f64).abs().max())
    ep = float((gram_conditional_ref(phi, pmat).double() - f64).abs().max())
    return em / scale, ep / scale


@pytest.mark.parametrize("n,r", [(17, 13), (17, 19), (33, 23), (9, 8),
                                 (9, 16), (9, 40)])
def test_model_ignores_the_padding(n, r):
    """Padding each row of P_x to r rounded up to 4 (the kernel) or to
    the rank tier (the one-row kernel it replaced) gives the same fk bit
    for bit: the padded terms are exact zeros."""
    rng = np.random.default_rng(n * r)
    phi = rng.standard_normal((256, r)).astype(np.float32)
    phi /= np.max(np.abs(phi), axis=1, keepdims=True)
    pmat = torch.from_numpy(rng.standard_normal((r * r, n)).astype(
        np.float32))
    phi = torch.from_numpy(phi)
    assert torch.equal(gram_chain_model(phi, pmat),
                       gram_chain_model(phi, pmat, pad=rank_tier(r)))


@pytest.mark.parametrize("n,r", [(17, 13), (17, 19), (33, 23), (9, 64)])
def test_model_meets_the_card_rule_on_random_operands(n, r):
    """A general (non-symmetric) P, as the card tests make it: the
    modelled fk within 1e-5 of the largest |fk64| and at most twice as
    far from it as the plain f32 version plus 1e-6."""
    rng = np.random.default_rng(n + r)
    phi = rng.standard_normal((ROWS, r)).astype(np.float32)
    phi /= np.max(np.abs(phi), axis=1, keepdims=True)
    pmat = rng.standard_normal((r * r, n)).astype(np.float32)
    em, ep = _errors(torch.from_numpy(phi), torch.from_numpy(pmat))
    assert em < 1e-5
    assert em <= 2.0 * ep + 1e-6, (em, ep)


@pytest.fixture(scope="module")
def lz20():
    """The last level of lz20_ck as DirtSampler prepares it at 'f32' and
    at 'f64', and 2^10 rows of seeds."""
    import tt_irt_tpu_torch as tp
    from tt_irt_tpu_torch.samplers.dirt import _prepare_level_preps

    dirt = tp.load_dirt(os.path.join(DATA, "lz20_ck"), device="cpu")
    p32 = _prepare_level_preps(dirt, "f32")[-1]
    p64 = _prepare_level_preps(dirt, "f64")[-1]
    q = torch.from_numpy(np.random.default_rng(6).uniform(
        size=(ROWS, dirt.d)))
    return p32, p64, q


def test_model_meets_the_card_rule_per_dimension_on_lz20(lz20):
    """lz20_ck's own Gram field at every dimension of its last level, on
    the carry the plain f32 chain reaches there from 2^10 seeds: the
    modelled fk within 1e-5 of the largest |fk64| and at most twice as
    far from it as the plain f32 version plus 1e-6."""
    from tt_irt_tpu_torch.samplers.irt_scan import _cdf_invert

    p32, _, q = lz20
    d, rr, _ = p32.pmat.shape
    r = int(round(rr ** 0.5))
    qs = q.float().T.contiguous()
    phi = torch.zeros((q.shape[0], r), dtype=torch.float32)
    phi[:, 0] = 1.0
    for k in range(d):
        em, ep = _errors(phi, p32.pmat[k])
        assert em < 1e-5, (k, em)
        assert em <= 2.0 * ep + 1e-6, (k, em, ep)
        fk = gram_conditional_ref(phi, p32.pmat[k])
        _, _, la, lb, i0 = _cdf_invert("sqr", fk, p32.xs[k], p32.hs[k],
                                       qs[k])
        phi = condition_update_ref(phi, i0, la, lb, p32.cmat[k])


def test_model_level_meets_the_card_rule_on_lz20(lz20):
    """The whole last level on 2^10 seeds with the modelled conditional
    and the plain CDF and prefix update: samples and log-density, at the
    maximum and the 99th percentile over rows, at most twice as far from
    the f64 Gram path as the plain f32 path plus 1e-6 (the rule of
    chip_smoke.py's level checks at the 99th percentile, and tighter at
    the maximum)."""
    from tt_irt_tpu_torch.samplers.irt_scan import _fwd

    p32, p64, q = lz20
    runs = {
        "model": _fwd("sqr", p32, q,
                      step=(gram_chain_model, cdf_invert_into_ref,
                            condition_update_ref)),
        "plain": _fwd("sqr", p32, q,
                      step=(gram_conditional_ref, cdf_invert_into_ref,
                            condition_update_ref)),
        "f64": _fwd("sqr", p64, q)}
    for i, what in enumerate(("x", "lf")):
        ref = runs["f64"][i]
        errs = {}
        for name in ("model", "plain"):
            e = (runs[name][i].double() - ref).abs()
            e = e.amax(1) if e.ndim == 2 else e
            errs[name] = (float(e.max()), float(torch.quantile(e, 0.99)))
        for stat in (0, 1):
            assert errs["model"][stat] <= 2.0 * errs["plain"][stat] + 1e-6, \
                (what, errs)
