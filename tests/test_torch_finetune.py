"""The port's dirt_finetune (constructors/finetune.py) against the JAX
package's, on tests/test_finetune.py's banded Gaussian (d=4, CORR 0.55,
rank capped at 2) built by the JAX package and carried across as numpy.

One step's loss and gradient equal the JAX package's (1e-8 relative) on
the same seeds for both objectives and every ``trainable``; Adam's
update equals optax.adam's on the same gradients; the guards raise; and
a short run meets tests/test_finetune.py's 25% N/ESS bar.  The
minibatches come from a torch.Generator, so whole runs are compared by
that bar, not number for number."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import tt_irt_tpu as ti
import tt_irt_tpu_torch as tp
from tt_irt_tpu.constructors.finetune import _rebuild as jax_rebuild
from tt_irt_tpu_torch.constructors.finetune import _rebuild, finetune_loss

CORR = 0.55
D = 4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread a process, so that parallel test workers do
    not oversubscribe the cores; the caller's setting comes back."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def lp(x):
    return -0.5 * (jnp.sum(x * x, axis=1)
                   + 2.0 * CORR * jnp.sum(x[:, :-1] * x[:, 1:], axis=1))


def lp_torch(x):
    return -0.5 * (torch.sum(x * x, dim=1)
                   + 2.0 * CORR * torch.sum(x[:, :-1] * x[:, 1:], dim=1))


def _build(beta):
    grids = [np.linspace(-6, 6, 13) for _ in range(D)]
    dj = ti.tt_dirt_approx(grids, lambda x, b0, b1: (b1 - b0) * lp(x), beta,
                           stoptol=0.5, nswp=1, kickrank=0, y0=2, rmax=2,
                           testsamples=0, verb=0, seed=5)
    dt = tp.dirt_from_numpy(
        [np.asarray(c) for c in dj.f0.cores],
        [[np.asarray(c) for c in f.cores] for f in dj.fs],
        [np.asarray(g) for g in dj.x0], [np.asarray(g) for g in dj.x],
        np.asarray(dj.beta), dj.lfshift, reference=dj.reference,
        interpolation=dj.interpolation, device="cpu")
    return dj, dt


@pytest.fixture(scope="module")
def coarse_dirt():
    """tests/test_finetune.py's stack: one level, rank capped at 2."""
    return _build([1.0])


@pytest.fixture(scope="module")
def two_level():
    """The same settings over the ladder [0.5, 1.0], so that 'levels'
    has a ratio level to train."""
    return _build([0.5, 1.0])


def _jax_loss(objective):
    if objective == "reverse":
        def loss_fn(stack, q):
            z, lfapp = ti.tt_dirt_sample(stack, q)
            return jnp.mean(lfapp - lp(z))
    else:
        def loss_fn(stack, q):
            z, lfapp_s = ti.tt_dirt_sample(stack, q)
            z = jax.lax.stop_gradient(z)
            w = jax.nn.softmax(jax.lax.stop_gradient(lp(z) - lfapp_s))
            _, lfapp = ti.tt_dirt_inverse(stack, z)
            return -jnp.sum(w * lfapp)
    return loss_fn


@pytest.fixture(scope="module")
def jax_value_and_grad(two_level):
    """objective -> (loss, {"f0": grads, "fs": grads}) of the JAX
    package's objective on the seeds of the one-step test, differentiated
    in every core once; freezing a group only drops its gradient, so
    each ``trainable`` is compared against its part of these."""
    dj, _ = two_level
    q = jnp.asarray(_one_step_seeds())
    cache = {}

    def get(objective):
        if objective not in cache:
            jloss = _jax_loss(objective)
            params = {"f0": tuple(dj.f0.cores),
                      "fs": tuple(tuple(f.cores) for f in dj.fs)}
            cache[objective] = jax.jit(jax.value_and_grad(
                lambda p: jloss(jax_rebuild(dj, p["f0"], p["fs"]), q)))(
                    params)
        return cache[objective]

    return get


def _one_step_seeds():
    return np.random.default_rng(3).uniform(1e-3, 1 - 1e-3, (256, D))


@pytest.mark.parametrize("objective", ["reverse", "forward"])
@pytest.mark.parametrize("trainable", ["all", "levels", "f0"])
def test_one_step_loss_and_gradient_match_jax(two_level, jax_value_and_grad,
                                              objective, trainable):
    _, dt = two_level
    train_f0 = trainable in ("all", "f0")
    train_fs = trainable in ("all", "levels")
    f0 = [c.clone().requires_grad_(train_f0) for c in dt.f0.cores]
    fs = [[c.clone().requires_grad_(train_fs) for c in f.cores]
          for f in dt.fs]
    loss = finetune_loss(_rebuild(dt, f0, fs), lp_torch,
                         torch.from_numpy(_one_step_seeds()), objective)
    leaves = (f0 if train_f0 else []) + ([c for cs in fs for c in cs]
                                         if train_fs else [])
    grads = torch.autograd.grad(loss, leaves)
    val, g = jax_value_and_grad(objective)
    jg = (list(g["f0"]) if train_f0 else []) + (
        [c for cs in g["fs"] for c in cs] if train_fs else [])
    assert abs(float(loss.detach()) - float(val)) <= 1e-8 * max(
        abs(float(val)), 1.0)
    assert len(grads) == len(jg)
    for a, b in zip(grads, jg):
        b = np.asarray(b)
        assert np.isfinite(a.numpy()).all()
        err = float(np.max(np.abs(a.numpy() - b)))
        assert err <= 1e-8 * max(float(np.max(np.abs(b))), 1e-300), err


def test_adam_update_matches_optax():
    """torch.optim.Adam and optax.adam (b1 0.9, b2 0.999, eps 1e-8
    outside the square root) give the same parameters after five steps
    of the same gradients (1e-12)."""
    rng = np.random.default_rng(0)
    p0 = rng.standard_normal((3, 4))
    grads = [rng.standard_normal((3, 4)) for _ in range(5)]
    pt = torch.tensor(p0, requires_grad=True)
    opt = torch.optim.Adam([pt], lr=3e-3)
    for g in grads:
        pt.grad = torch.from_numpy(g)
        opt.step()
    tx = optax.adam(3e-3)
    pj = jnp.asarray(p0)
    state = tx.init(pj)
    for g in grads:
        upd, state = tx.update(jnp.asarray(g), state, pj)
        pj = optax.apply_updates(pj, upd)
    assert float(np.max(np.abs(pt.detach().numpy() - np.asarray(pj)))) < 1e-12


def test_guards(coarse_dirt):
    _, dt = coarse_dirt
    with pytest.raises(ValueError):
        tp.dirt_finetune(dt, lp_torch, steps=1, trainable="nope",
                         device="cpu")
    with pytest.raises(ValueError):
        tp.dirt_finetune(dt, lp_torch, steps=1, objective="sideways",
                         device="cpu")
    with pytest.raises(TypeError, match="not a sample mesh"):
        tp.dirt_finetune(dt, lp_torch, steps=1, mesh=object(), device="cpu")
    from tt_irt_tpu_torch.parallel import sample_mesh
    _, one = tp.dirt_finetune(dt, lp_torch, steps=1, nsamples=64,
                              device="cpu")
    _, sh = tp.dirt_finetune(dt, lp_torch, steps=1, nsamples=64,
                             mesh=sample_mesh(devices=["cpu"] * 3),
                             device="cpu")
    assert sh[0] == one[0]
    tuned, losses = tp.dirt_finetune(dt, lp_torch, steps=3, nsamples=64,
                                     lr=1e-3, seed=0, trainable="f0",
                                     device="cpu")
    assert len(losses) == 3 and np.all(np.isfinite(losses))
    assert tuned.f0.ranks == dt.f0.ranks
    assert not any(c.requires_grad for c in tuned.f0.cores)
    tuned, losses = tp.dirt_finetune(
        dt, lp_torch, steps=2, nsamples=64, device="cpu",
        optimizer=lambda ps: torch.optim.SGD(ps, lr=1e-3))
    assert len(losses) == 2 and np.all(np.isfinite(losses))


def test_finetune_improves_ess_at_fixed_rank(coarse_dirt):
    """tests/test_finetune.py's run (150 reverse steps of 512 seeds, lr
    3e-3): the loss descends by 0.2 and N/ESS improves by at least 25%
    (the JAX package measured 17.1 -> 9.2)."""
    _, dt = coarse_dirt
    q = torch.from_numpy(np.random.default_rng(7).uniform(
        1e-4, 1 - 1e-4, size=(4096, D)))
    z0, lf0 = tp.tt_dirt_sample(dt, q, device="cpu")
    e0 = float(tp.essinv(lp_torch(z0), lf0))
    tuned, losses = tp.dirt_finetune(dt, lp_torch, steps=150, nsamples=512,
                                     lr=3e-3, seed=1, device="cpu")
    assert np.all(np.isfinite(losses))
    assert losses[-10:].mean() < losses[:5].mean() - 0.2
    assert tuned.f0.ranks == dt.f0.ranks and tuned.nlevels == dt.nlevels
    z1, lf1 = tp.tt_dirt_sample(tuned, q, device="cpu")
    e1 = float(tp.essinv(lp_torch(z1), lf1))
    assert e1 < 0.75 * e0, (e0, e1)
