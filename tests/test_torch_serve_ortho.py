"""The orthonormal-core serve path as a whole: the port's
DirtSampler(precision="hi", hi_step="odim") on the shipped Lorenz-40
checkpoint against the JAX DirtSampler under TTIRT_HI_ORTHO=1 and
against the port's default step."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tt_irt_tpu as ti
import tt_irt_tpu_torch as tp
from tt_irt_tpu.utils.checkpoint import load_dirt as jax_load
from tt_irt_tpu_torch.samplers.irt_scan import OrthoPrep

from test_torch_hi_steps import jax_ortho

DATA = os.path.join(os.path.dirname(__file__), "..", "examples", "data")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread a process, so that parallel test workers do
    not oversubscribe the cores; the caller's setting comes back."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def served():
    """256 truncated-normal seeds through lz40n33_ck (d=40, n=33, r=23,
    13 tempered levels plus level 0): JAX 'hi' on the orthonormal
    basis, JAX 'f64', and the port at "odim" and "dim" on the CPU."""
    path = os.path.join(DATA, "lz40n33_ck")
    jd = jax_load(path)
    u = np.random.default_rng(0).uniform(size=(256, jd.d))
    q = np.array(ti.randref("n3", jnp.asarray(u)))
    with jax_ortho(True):
        zj, lj = ti.DirtSampler(jd, precision="hi")(jnp.asarray(q))
        zj, lj = np.array(zj), np.array(lj)
    z64, l64 = ti.DirtSampler(jd, precision="f64")(jnp.asarray(q))
    stack = tp.load_dirt(path, device="cpu")
    out = {"jax": (zj, lj), "f64": (np.array(z64), np.array(l64))}
    for hi_step in ("odim", "dim"):
        sampler = tp.DirtSampler(stack, precision="hi", device="cpu",
                                 hi_step=hi_step)
        out[hi_step] = tuple(a.numpy() for a in sampler(torch.from_numpy(q)))
        out[hi_step + "_sampler"] = sampler
    return out


def test_odim_serve_matches_jax_ortho_serve(served):
    """Samples 5e-5, lfapp 1e-4: the bars of tests/test_torch_serve.py
    for the raw-factor path on this checkpoint (two f32 'hi' pipelines
    drift apart along 40 dimensions and 14 transforms).  The port must
    also be no further from the JAX f64 serve than 1.5x the JAX ortho
    serve."""
    zt, lt = served["odim"]
    zj, lj = served["jax"]
    assert np.all(np.isfinite(zt)) and np.all(np.isfinite(lt))
    dz, dl = np.max(np.abs(zt - zj)), np.max(np.abs(lt - lj))
    z64, l64 = served["f64"]
    ez, el = np.max(np.abs(zt - z64)), np.max(np.abs(lt - l64))
    jz, jl = np.max(np.abs(zj - z64)), np.max(np.abs(lj - l64))
    print(f"odim serve: port vs JAX ortho {dz:.3g}/{dl:.3g}; vs JAX f64: "
          f"port {ez:.3g}/{el:.3g}, JAX ortho {jz:.3g}/{jl:.3g}")
    assert dz < 5e-5 and dl < 1e-4
    assert ez < 1.5 * jz and el < 1.5 * jl


def test_odim_serve_matches_default_step(served):
    """The same transport in the other carry basis: "odim" against the
    port's "dim" on the same seeds, 5e-5 / 1e-4; both as close to the
    JAX f64 serve (printed)."""
    zo, lo = served["odim"]
    zd, ld = served["dim"]
    z64, l64 = served["f64"]
    print("vs JAX f64: odim %.3g/%.3g, dim %.3g/%.3g" % (
        np.max(np.abs(zo - z64)), np.max(np.abs(lo - l64)),
        np.max(np.abs(zd - z64)), np.max(np.abs(ld - l64))))
    assert np.max(np.abs(zo - zd)) < 5e-5
    assert np.max(np.abs(lo - ld)) < 1e-4


def test_odim_sampler_prepares_every_level_on_the_ortho_basis(served):
    """Level 0 and all 13 rank-bucketed upper levels are OrthoPreps (no
    core operand), padded to their bucket's rank."""
    sampler = served["odim_sampler"]
    assert sampler.hi_step == "odim" and sampler.precision == "hi"
    preps = [sampler._prep0] + list(sampler._upper)
    assert len(preps) == 14
    assert all(isinstance(p, OrthoPrep) for p in preps)
    ranks = {p.qmat.shape[1] for p in sampler._upper}
    assert max(ranks) == 23 and all(r % 4 == 0 or r == 23 for r in ranks)
    assert not hasattr(sampler._prep0, "cmat")
