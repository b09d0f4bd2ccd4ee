"""The port's binding of the native C++ IRT kernel
(tt_irt_tpu_torch/native) against the port's 'f64' transforms and the
JAX package's, at tests/test_native.py's tolerances (1e-10 in samples,
1e-8 in log-density).  The library is built from the JAX package's
source read in place, into build/native/, never beside the source."""

import os
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tt_irt_tpu as ti
import tt_irt_tpu_torch as tp
from tt_irt_tpu_torch import native

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread a process, so that parallel test workers do
    not oversubscribe the cores; the caller's setting comes back."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _gauss(grids, corr):
    d = len(grids)
    prec = np.eye(d) + corr * (np.eye(d, k=1) + np.eye(d, k=-1))
    mesh = np.meshgrid(*grids, indexing="ij")
    pts = np.stack([m.ravel() for m in mesh], axis=1)
    e = np.einsum("mi,ij,mj->m", pts, prec, pts)
    return np.exp(-0.5 * e).reshape([len(g) for g in grids])


@pytest.mark.parametrize("mode", ["lin", "sqr"])
def test_native_matches_f64(rng, mode):
    """tests/test_native.py's TTs (lin: d=3, n=13; sqr: d=4, n=15):
    the native kernel against the port's tt_irt_lin / tt_irt_sqr at 'f64'
    and the JAX package's on the same seeds."""
    if mode == "lin":
        grids = [np.linspace(-3, 3, 13) for _ in range(3)]
        dense, eps, d = _gauss(grids, 0.4), 1e-12, 3
    else:
        grids = [np.linspace(-3, 3, 15) for _ in range(4)]
        dense, eps, d = np.sqrt(_gauss(grids, -0.3)), 1e-13, 4
    tt = tp.tt_from_dense(torch.from_numpy(dense), eps=eps, device="cpu")
    q = rng.random((256, d))
    xn, ln = native.tt_irt_native(grids, tt, q, mode=mode)
    port = tp.tt_irt_lin if mode == "lin" else tp.tt_irt_sqr
    xt, lt = port([torch.from_numpy(g) for g in grids], tt,
                  torch.from_numpy(q), precision="f64", device="cpu")
    np.testing.assert_allclose(xn, xt.numpy(), atol=1e-10)
    np.testing.assert_allclose(ln, lt.numpy(), atol=1e-8)
    jfn = ti.tt_irt_lin if mode == "lin" else ti.tt_irt_sqr
    xj, lj = jfn(grids, ti.tt_from_dense(jnp.asarray(dense), eps=eps),
                 jnp.asarray(q))
    np.testing.assert_allclose(xn, np.asarray(xj), atol=1e-10)
    np.testing.assert_allclose(ln, np.asarray(lj), atol=1e-8)


def test_native_builds_under_build_and_refuses_device_tensors(monkeypatch):
    """The library is built from tt_irt_tpu/native/tt_irt_core.cpp into
    build/native/libttirt.so: the compile command reads the source in
    place and writes only under build/native/, and nothing under
    tt_irt_tpu/ changes (its files' sizes and times, the JAX package's
    own libttirt.so aside, which its tests build there).  A CUDA tensor
    raises: the kernel is a host engine."""
    jax_dir = os.path.join(ROOT, "tt_irt_tpu")

    def snapshot():
        out = {}
        for base, _, names in os.walk(jax_dir):
            for n in names:
                if n == "libttirt.so" or n.endswith(".pyc"):
                    continue
                p = os.path.join(base, n)
                st = os.stat(p)
                out[p] = (st.st_size, st.st_mtime_ns)
        return out

    before = snapshot()
    calls = []
    real_run = subprocess.run

    def run(cmd, *a, **kw):
        calls.append(list(cmd))
        return real_run(cmd, *a, **kw)

    monkeypatch.setattr(native.subprocess, "run", run)
    assert native.build_native(force=True)
    assert native.native_available()
    assert native.NATIVE_LIB == os.path.join(ROOT, "build", "native",
                                             "libttirt.so")
    assert os.path.exists(native.NATIVE_LIB)
    (cmd,) = calls
    src = os.path.join(jax_dir, "native", "tt_irt_core.cpp")
    assert src in cmd
    out = cmd[cmd.index("-o") + 1]
    assert os.path.dirname(out) == os.path.join(ROOT, "build", "native")
    assert snapshot() == before
    if torch.cuda.is_available():
        tt = tp.tt_from_dense(torch.ones((3, 3), dtype=torch.float64),
                              device="cuda")
        with pytest.raises(ValueError, match="host engine"):
            native.tt_irt_native([np.linspace(0, 1, 3)] * 2, tt,
                                 np.full((2, 2), 0.5))
