"""Witness of the 'f32' Gram path's tail floor on lz20_ck.

Served at 2^20 seeds on an NVIDIA H100, DirtSampler(precision='f32')
gave 0-2 rows a seed set whose log-density is not finite, and a few rows
whose log-density sits tens of units from the 'f64' serve of the same
seeds.  tests/data/lz20_f32_witness.npz (written by chip_smoke.py as
chiprun_out/a_witness.npz) holds those rows' seeds with what the card
returned.  Served again here on the CPU, the JAX package's 'f32' path
does the same on the same seeds: the Gram-form conditional rounds to
zero or below in a far tail.  A property of precision 'f32', which the
port reproduces, not a fault of its kernels."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tt_irt_tpu as ti
import tt_irt_tpu_torch as tp
from tt_irt_tpu.utils.checkpoint import load_dirt as jax_load

HERE = os.path.dirname(__file__)
CKPT = os.path.join(HERE, "..", "examples", "data", "lz20_ck")
WITNESS = os.path.join(HERE, "data", "lz20_f32_witness.npz")


@pytest.fixture(scope="module")
def samplers():
    jd = jax_load(CKPT)
    return (ti.DirtSampler(jd, precision="f32"),
            ti.DirtSampler(jd, precision="f64"),
            tp.DirtSampler(tp.load_dirt(CKPT, device="cpu"),
                           precision="f32", device="cpu"))


def test_nonfinite_rows_are_nonfinite_in_jax_f32_too(samplers):
    """The rows whose 'f32' log-density was not finite on the card: not
    finite through the port's CPU path and through JAX 'f32' either, and
    finite through JAX 'f64'."""
    j32, j64, p32 = samplers
    with np.load(WITNESS) as w:
        q = np.concatenate([w[k] for k in sorted(w.files)
                            if k.startswith("qbad")])
    assert q.shape[0] >= 1
    _, lj = j32(jnp.asarray(q))
    _, l64 = j64(jnp.asarray(q))
    _, lp = p32(torch.from_numpy(q))
    assert not np.any(np.isfinite(np.asarray(lj)))
    assert not bool(torch.isfinite(lp).any())
    assert np.all(np.isfinite(np.asarray(l64)))


def test_far_rows_are_as_far_in_jax_f32(samplers):
    """The 16 rows whose 'f32' log-weight was furthest from the 'f64'
    one on the card (up to 47.8).  On each, the port's CPU path and JAX
    'f32' land within 0.1 of the card's 'f32' log-density (measured
    <= 0.05: two f32 pipelines on a tail row), while the two worst sit
    more than 30 from 'f64' in all three; JAX 'f64' reproduces the
    card's 'f64' to 1e-8."""
    j32, j64, p32 = samplers
    with np.load(WITNESS) as w:
        q, lcard, l64card = w["qfar"], w["lffar"], w["lf64far"]
    _, lj = j32(jnp.asarray(q))
    _, l64 = j64(jnp.asarray(q))
    _, lp = p32(torch.from_numpy(q))
    lj, l64, lp = np.asarray(lj), np.asarray(l64), lp.numpy()
    assert np.max(np.abs(l64 - l64card)) < 1e-8
    assert np.max(np.abs(lj - lcard)) < 0.1
    assert np.max(np.abs(lp - lcard)) < 0.1
    for lf in (lj, lp, lcard):
        assert np.sum(np.abs(lf - l64) > 30.0) == 2
