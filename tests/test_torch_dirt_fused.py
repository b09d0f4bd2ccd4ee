"""The fused whole-stack program of the port (samplers/dirt_scan.py,
``tt_dirt_sample(use_fused=True)``): the two fused tests of
tests/test_dirt.py with their bars, the port's program against the JAX
package's on the same stack, and ``can_fuse`` against the JAX
package's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tt_irt_tpu as ti
import tt_irt_tpu_torch as tp
from tt_irt_tpu.samplers.dirt_scan import can_fuse as jax_can_fuse
from tt_irt_tpu_torch.samplers.dirt_scan import can_fuse

D = 4
GRIDS = [np.linspace(-5, 5, 17) for _ in range(D)]
BETA = [0.1, 0.3, 1.0]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread a process: the module's tensors are small and
    its operations many, so parallel test workers of eight threads each
    would oversubscribe the cores.  The caller's setting comes back
    afterwards."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def logratio_np(x, b0, b1, corr=0.5):
    x = np.asarray(x)
    quad = np.sum(x * x, 1) + 2.0 * corr * np.sum(x[:, :-1] * x[:, 1:], 1)
    return (b1 - b0) * (-0.5 * quad)


def _carry(dj):
    def cores(t):
        return [np.asarray(c) for c in t.cores]

    return tp.dirt_from_numpy(
        cores(dj.f0), [cores(f) for f in dj.fs],
        [np.asarray(g) for g in dj.x0], [np.asarray(g) for g in dj.x],
        np.asarray(dj.beta), dj.lfshift, reference=dj.reference,
        interpolation=dj.interpolation, device="cpu")


@pytest.fixture(scope="module")
def stacks():
    """tests/test_dirt.py's trained_dirt (uniform reference) and the
    'n3' stack of its fused-precision test, built by the JAX package."""
    uni = ti.tt_dirt_approx(GRIDS, logratio_np, BETA, stoptol=0.1, nswp=3,
                            kickrank=2, testsamples=512, seed=3, vec="host")
    n3 = ti.tt_dirt_approx(GRIDS, logratio_np, BETA, stoptol=0.1, nswp=2,
                           kickrank=2, reference="n3", testsamples=256,
                           seed=5, vec="host")
    return {"uniform": (uni, _carry(uni)), "n3": (n3, _carry(n3))}


def _seeds(reference, seed, m=512):
    u = np.random.default_rng(seed).uniform(size=(m, D))
    return tp.randref(reference, torch.from_numpy(u))


def _max(a, b):
    return float(torch.max(torch.abs(a.to(torch.float64)
                                     - b.to(torch.float64))))


def test_dirt_fused_matches_loop(stacks):
    """tests/test_dirt.py::test_dirt_fused_matches_loop: the fused program
    within 1e-12 in samples and 1e-10 in log-density of the level loop."""
    _, td = stacks["uniform"]
    assert can_fuse(td, D)
    q = _seeds("uniform", 11)
    z1, lf1 = tp.tt_dirt_sample(td, q, use_fused=False, device="cpu")
    z2, lf2 = tp.tt_dirt_sample(td, q, use_fused=True, device="cpu")
    assert _max(z1, z2) < 1e-12 and _max(lf1, lf2) < 1e-10


def test_dirt_fused_normal_reference_and_precisions(stacks):
    """tests/test_dirt.py::test_dirt_fused_normal_reference_and_precisions:
    truncated-normal maps between levels; at 'f64' the fused program
    within 1e-12 of the loop, at each reduced precision within the JAX
    test's bar of the 'f64' loop."""
    _, td = stacks["n3"]
    q = _seeds("n3", 13)
    z1, _ = tp.tt_dirt_sample(td, q, use_fused=False, device="cpu")
    z2, _ = tp.tt_dirt_sample(td, q, use_fused=True, device="cpu")
    assert _max(z1, z2) < 1e-12
    for prec, tol in [("mixed", 5e-5), ("hi", 5e-5), ("f32", 5e-4)]:
        z3, _ = tp.tt_dirt_sample(td, q, precision=prec, use_fused=True,
                                  device="cpu")
        assert _max(z1, z3) < tol, prec


@pytest.mark.parametrize("name", ["uniform", "n3"])
def test_port_fused_matches_jax_fused(stacks, name):
    """The port's fused program against the JAX package's on the same
    stack and seeds, at 'f64': within 1e-10 in samples and
    log-density."""
    dj, td = stacks[name]
    q = _seeds(td.reference, 17)
    zj, lj = ti.tt_dirt_sample(dj, jnp.asarray(q.numpy()), use_fused=True)
    zt, lt = tp.tt_dirt_sample(td, q, use_fused=True, device="cpu")
    assert _max(zt, torch.from_numpy(np.array(zj))) < 1e-10
    assert _max(lt, torch.from_numpy(np.array(lj))) < 1e-10


def test_can_fuse_matches_jax(stacks):
    """Eligible spline stack: True in both; the same stack relabelled
    Chebyshev, a marginal (dsample < d) and a stack without levels:
    False in both."""
    dj, td = stacks["uniform"]
    assert can_fuse(td, D) is jax_can_fuse(dj, D) is True
    cheb_j = ti.DIRT(dj.f0, dj.fs, dj.x0, dj.x, dj.beta, dj.lfshift,
                     reference=dj.reference, interpolation="chebyshev")
    cheb_t = tp.DIRT(td.f0, td.fs, td.x0, td.x, td.beta, td.lfshift,
                     td.reference, "chebyshev")
    assert can_fuse(cheb_t, D) is jax_can_fuse(cheb_j, D) is False
    assert can_fuse(td, D - 1) is jax_can_fuse(dj, D - 1) is False
    bare_j = ti.DIRT(dj.f0, [], dj.x0, dj.x, dj.beta[:1], dj.lfshift)
    bare_t = tp.DIRT(td.f0, [], td.x0, td.x, td.beta[:1], td.lfshift)
    assert can_fuse(bare_t, D) is jax_can_fuse(bare_j, D) is False
    with pytest.raises(ValueError, match="can_fuse"):
        tp.tt_dirt_sample(td, _seeds("uniform", 1)[:, :D - 1],
                          use_fused=True, device="cpu")
