"""Second witness for the N/ESS tail of the lz40n33 serve.

``chip_smoke.py`` serves 2^20 seeds per seed set through the port on the
card and finds, in some sets, a single row that carries a large share of
the importance weight (N/ESS 28 for seed set 3).  This module serves
those heaviest rows again, on the CPU, through the port and through the
JAX package's 'hi' and f64 DirtSampler, and compares their log-weights
log pi(z) - lfapp, each under its own package's Lorenz posterior.

``tests/data/lz40n33_ess_top.npz`` is the ``chiprun_out/ess_top.npz``
that ``chip_smoke.py`` writes.  For each seed set s (seeds from
``torch.Generator(device="cuda").manual_seed(s)`` and ``randref``) it
holds the 16 rows of largest log-weight: their seeds ``q{s}``, the
card's samples ``z{s}``, lfapp ``lf{s}`` and exact log-posterior
``le{s}``, the set's median log-weight ``dfmed{s}`` over all 2^20 rows,
and its N/ESS ``n_over_ess{s}``.

    python tests/test_torch_ess_witness.py    # prints the table
"""

import os

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(HERE, "..", "examples", "data")
TOP = os.path.join(HERE, "data", "lz40n33_ess_top.npz")
SETS = (1, 2, 3, 4, 5, 6)
ROWS = 4                     # heaviest rows per set served here


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread a process, so that parallel test workers do
    not oversubscribe the cores; the caller's setting comes back."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def serve_top_rows(rows=ROWS):
    """{set: {"card", "port", "jax_hi", "jax_f64": log-weights (rows,),
    "median": the set's median log-weight, "n_over_ess": the set's
    N/ESS on the card}}."""
    import jax.numpy as jnp

    import tt_irt_tpu as ti
    import tt_irt_tpu_torch as tp
    from tt_irt_tpu.models import lorenz as jlz
    from tt_irt_tpu.utils.checkpoint import load_dirt as jax_load

    top = np.load(TOP)
    path = os.path.join(DATA, "lz40n33_ck")
    data = np.load(os.path.join(DATA, "lz40n33_data.npy"))
    x0base = np.load(os.path.join(DATA, "lz40n33_x0base.npy"))
    lpj = jlz.LorenzProblem(d=40, n=33, x0true=x0base,
                            data=data).log_posterior_fn()
    lpt = tp.LorenzProblem(d=40, x0true=x0base,
                           data=data).log_posterior_fn()
    jd = jax_load(path)
    jax_samplers = {p: ti.DirtSampler(jd, precision=p) for p in ("hi", "f64")}
    port = tp.DirtSampler(tp.load_dirt(path, device="cpu"), precision="hi",
                          device="cpu")
    q = np.concatenate([top[f"q{s}"][:rows] for s in SETS])
    zt, lt = port(torch.from_numpy(q))
    lw = {"port": (lpt(zt) - lt).numpy()}
    for p, sampler in jax_samplers.items():
        zj, lj = sampler(jnp.asarray(q))
        lw[f"jax_{p}"] = np.asarray(lpj(zj)) - np.asarray(lj)
    out = {}
    for i, s in enumerate(SETS):
        part = {k: v[i * rows:(i + 1) * rows] for k, v in lw.items()}
        part["card"] = (top[f"le{s}"] - top[f"lf{s}"])[:rows]
        part["median"] = float(top[f"dfmed{s}"])
        part["n_over_ess"] = float(top[f"n_over_ess{s}"])
        out[s] = part
    return out


@pytest.fixture(scope="module")
def served():
    return serve_top_rows()


@pytest.mark.parametrize("s", SETS)
def test_heaviest_rows_are_as_heavy_under_jax_f64(served, s):
    """The row that dominates a set's N/ESS on the card is as heavy under
    the JAX package's f64 serve: the port's log-weight for it (CPU) is
    at most 1e-3 above the f64 one, so the port does not inflate the
    weight that decides N/ESS, and under f64 the row still stands at
    least 5 nats above the set's median log-weight (a weight of over
    150 median rows)."""
    got = served[s]
    f64 = got["jax_f64"]
    assert got["port"][0] - f64[0] <= 1e-3, (got["port"][0], f64[0])
    assert f64[0] - got["median"] >= 5.0


def test_tail_rows_as_close_to_f64_as_jax_hi(served):
    """On these tail rows every f32 'hi' pipeline (the card, the port on
    the CPU, JAX 'hi') differs from JAX f64 by f32 noise that the
    40-dimension prefix chain amplifies: JAX 'hi' itself by up to 0.22
    in log-weight on one row (seed set 4).  The card and the port must
    be no further from f64 than JAX 'hi' is, within a factor 1.5 (the
    bar of test_dirt_sampler_matches_jax_lz40n33)."""
    err = {name: max(np.max(np.abs(got[name] - got["jax_f64"]))
                     for got in served.values())
           for name in ("card", "port", "jax_hi")}
    assert err["port"] <= 1.5 * err["jax_hi"], err
    assert err["card"] <= 1.5 * err["jax_hi"], err


if __name__ == "__main__":
    import sys

    import jax

    sys.path.insert(0, os.path.join(HERE, ".."))

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    for s, got in serve_top_rows().items():
        print(f"seed set {s}: N/ESS on the card {got['n_over_ess']:.4f}, "
              f"median log-weight {got['median']:.6f}")
        print("  row  card        port (CPU)  JAX 'hi'    JAX f64")
        for i in range(len(got["card"])):
            print(f"  {i}   " + "  ".join(
                f"{got[k][i]:+.6f}" for k in ("card", "port", "jax_hi",
                                              "jax_f64")))
