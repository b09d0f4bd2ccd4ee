"""The port's sample mesh (tt_irt_tpu_torch/parallel/mesh.py) on eight
CPU shards, mirroring tests/test_parallel.py's sharded cases and
__graft_entry__.py's dryrun_multichip.

Every sharded result equals the port's single-device result bit for bit
(the shards run the same row-wise arithmetic), except dirt_finetune's
tuned cores, whose gradient sums the shards' parts in another order
(held to tests/test_parallel.py's bars); and each is held to the JAX
package's within the bars the port's tests use for that function:
1e-10 for the f64 transforms (tests/test_torch_precisions.py), 1e-8 for
a DIRT stack served by both packages (tests/test_torch_dirt_build.py),
1e-8 relative for a fine-tuning step (tests/test_torch_finetune.py)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tt_irt_tpu as ti
import tt_irt_tpu_torch as tp
from tt_irt_tpu.constructors.greedy_cross import greedy_cross as j_greedy
from tt_irt_tpu.parallel.mesh import sample_mesh as j_sample_mesh
from tt_irt_tpu.parallel.mesh import sharded_call as j_sharded_call
from tt_irt_tpu_torch.parallel import (replicate, sample_mesh, shard_samples,
                                       sharded_batch_fn, sharded_call)

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
CPU8 = ["cpu"] * 8


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread a process, so that parallel test workers do
    not oversubscribe the cores; the caller's setting comes back."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _density(grids):
    d = len(grids)
    prec = np.eye(d) + 0.3 * (np.eye(d, k=1) + np.eye(d, k=-1))
    mesh = np.meshgrid(*grids, indexing="ij")
    pts = np.stack([m.ravel() for m in mesh], axis=1)
    e = np.einsum("mi,ij,mj->m", pts, prec, pts)
    return np.exp(-0.25 * e).reshape([len(g) for g in grids])


def _equal(a, b):
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
        return
    assert torch.equal(a, b)


def _to_jax(dt):
    """The port's stack as a JAX-package DIRT (numpy leaves)."""
    def tt(t):
        return ti.TT([jnp.asarray(c.numpy()) for c in t.cores])

    return ti.DIRT(tt(dt.f0), [tt(f) for f in dt.fs],
                   [jnp.asarray(g.numpy()) for g in dt.x0],
                   [jnp.asarray(g.numpy()) for g in dt.x],
                   jnp.asarray(dt.beta.numpy()), dt.lfshift,
                   reference=dt.reference, interpolation=dt.interpolation)


def test_mesh_layout():
    """A mesh is a tuple of devices; shards are contiguous and cover the
    rows; replicas are on every entry; sample_mesh() without a card
    raises, as every port entry point's default device does."""
    mesh = sample_mesh(devices=CPU8)
    assert mesh == tuple(torch.device("cpu") for _ in range(8))
    assert sample_mesh(3, devices=CPU8) == mesh[:3]
    x = torch.arange(21.0).reshape(21, 1)
    shards = shard_samples(mesh, x)
    assert [s.shape[0] for s in shards] == [3] * 5 + [2] * 3
    _equal(torch.cat(shards), x)
    assert len(replicate(mesh, {"a": x, "b": [x]})) == 8
    out = sharded_batch_fn(mesh, lambda t: t[:, 0] * 2.0)(x.numpy())
    assert isinstance(out, np.ndarray) and out.shape == (21,)
    with pytest.raises(TypeError, match="not a sample mesh"):
        sharded_call(object(), torch.sum, x)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="not available"):
            sample_mesh()


def test_sharded_irt_matches_single_device():
    grids = [np.linspace(-3, 3, 17) for _ in range(4)]
    dense = _density(grids)
    t = tp.tt_from_dense(torch.from_numpy(dense), eps=1e-12, device="cpu")
    tg = [torch.from_numpy(g) for g in grids]
    q = np.random.default_rng(0).random((8 * 64, 4))
    qt = torch.from_numpy(q)
    one = tp.tt_irt_sqr(tg, t, qt, device="cpu")
    sh = sharded_call(sample_mesh(devices=CPU8),
                      lambda qq, tt_: tp.tt_irt_sqr(tg, tt_, qq,
                                                    device=qq.device),
                      qt, t)
    _equal(sh, one)
    xj, lj = ti.tt_irt_sqr(grids, ti.tt_from_dense(jnp.asarray(dense),
                                                    eps=1e-12),
                           jnp.asarray(q))
    assert np.max(np.abs(sh[0].numpy() - np.asarray(xj))) < 1e-10
    assert np.max(np.abs(sh[1].numpy() - np.asarray(lj))) < 1e-10


def test_sharded_diagnostics_reduce():
    """A function that reduces over the samples (essinv) runs once on
    the whole arrays (rowwise=False): the unsharded value bit for bit,
    and the JAX package's sharded value to 1e-12."""
    rng = np.random.default_rng(1)
    lfex = rng.standard_normal(8 * 128)
    lfapp = lfex + 0.1 * rng.standard_normal(8 * 128)
    a, b = torch.from_numpy(lfex), torch.from_numpy(lfapp)
    tau = sharded_call(sample_mesh(devices=CPU8), tp.essinv, a, b,
                       sample_args=(0, 1), rowwise=False)
    assert torch.equal(tau, tp.essinv(a, b))
    tau_j = float(j_sharded_call(j_sample_mesh(8), ti.essinv,
                                 jnp.asarray(lfex), jnp.asarray(lfapp),
                                 sample_args=(0, 1)))
    np.testing.assert_allclose(float(tau), tau_j, rtol=1e-12)


def _logratio(x, b0, b1):
    return -0.5 * (b1 - b0) * torch.sum(x * x, dim=1)


def test_dirt_sample_sharded():
    grids = [np.linspace(-4, 4, 13) for _ in range(3)]
    dirt = tp.tt_dirt_approx(grids, _logratio, [0.3, 1.0], stoptol=0.2,
                             nswp=2, kickrank=2, testsamples=128, seed=0,
                             device="cpu")
    q = np.random.default_rng(2).random((8 * 32, 3))
    qt = torch.from_numpy(q)
    one = tp.tt_dirt_sample(dirt, qt, device="cpu")
    sh = sharded_call(sample_mesh(devices=CPU8),
                      lambda qq, dd: tp.tt_dirt_sample(dd, qq,
                                                       device=qq.device),
                      qt, dirt)
    _equal(sh, one)
    zj, lj = ti.tt_dirt_sample(_to_jax(dirt), jnp.asarray(q))
    assert np.max(np.abs(sh[0].numpy() - np.asarray(zj))) < 1e-8
    assert np.max(np.abs(sh[1].numpy() - np.asarray(lj))) < 1e-8


def test_sharded_construction_matches_single_device():
    """tests/test_parallel.py's build (d=4, two levels, reference n3) with
    its probe batches sharded over eight shards equals the single-device
    build bit for bit (every core, the evaluation counts), and the JAX
    package serves the stack as the port does (1e-8)."""
    d = 4
    grids = [np.linspace(-4, 4, 13) for _ in range(d)]

    def logratio(x, b0, b1):
        quad = torch.sum(x * x, dim=1) + \
            0.8 * torch.sum(x[:, :-1] * x[:, 1:], dim=1)
        return -0.5 * (b1 - b0) * quad

    kw = dict(stoptol=0.1, nswp=2, kickrank=2, testsamples=128, verb=0,
              seed=9, reference="n3", device="cpu")
    d1 = tp.tt_dirt_approx(grids, logratio, [0.1, 1.0], **kw)
    d8 = tp.tt_dirt_approx(grids, logratio, [0.1, 1.0],
                           mesh=sample_mesh(devices=CPU8), **kw)
    _equal(list(d8.f0.cores) + [c for f in d8.fs for c in f.cores],
           list(d1.f0.cores) + [c for f in d1.fs for c in f.cores])
    np.testing.assert_array_equal(np.asarray(d8.evalcnt),
                                  np.asarray(d1.evalcnt))
    qn = tp.randref("n3", torch.Generator().manual_seed(3), (256, d))
    z1, l1 = tp.tt_dirt_sample(d1, qn, device="cpu")
    z8, l8 = tp.tt_dirt_sample(d8, qn, device="cpu")
    _equal((z8, l8), (z1, l1))
    zj, lj = ti.tt_dirt_sample(_to_jax(d8), jnp.asarray(qn.numpy()))
    assert np.max(np.abs(z8.numpy() - np.asarray(zj))) < 1e-8
    assert np.max(np.abs(l8.numpy() - np.asarray(lj))) < 1e-8


def _cross_case(cross, fun_t, fun_j, n, d, kw):
    """(port mesh-8 result, port mesh-1 result, JAX mesh-8 result)."""
    r8 = cross([n] * d, fun_t, 1e-10 if cross is tp.amen_cross_s else 1e-8,
               mesh=sample_mesh(devices=CPU8), device="cpu", **kw)
    r1 = cross([n] * d, fun_t, 1e-10 if cross is tp.amen_cross_s else 1e-8,
               mesh=sample_mesh(devices=["cpu"]), device="cpu", **kw)
    jcross = ti.amen_cross_s if cross is tp.amen_cross_s else j_greedy
    rj = jcross([n] * d, fun_j,
                1e-10 if cross is tp.amen_cross_s else 1e-8,
                mesh=j_sample_mesh(8), **kw)
    return r8, r1, rj


def test_sharded_amen_cross_matches_single_device():
    """amen_cross_s with probe batches over eight shards equals the
    one-shard build bit for bit; it approximates the target within
    1e-6, as tests/test_parallel.py requires of the JAX package's
    sharded build, and stays within twice that of the JAX package's."""
    d, n = 4, 11
    gt = torch.linspace(-2.0, 2.0, n, dtype=torch.float64)
    gj = jnp.linspace(-2.0, 2.0, n)

    def fun_t(ind):
        s = torch.sum(gt[ind], dim=1)
        return torch.exp(-0.5 * s * s) + 0.2 * torch.cos(s)

    def fun_j(ind):
        s = jnp.sum(gj[ind], axis=1)
        return jnp.exp(-0.5 * s * s) + 0.2 * jnp.cos(s)

    r8, r1, rj = _cross_case(tp.amen_cross_s, fun_t, fun_j, n, d,
                             dict(tol_exit=1e-8, nswp=8, kickrank=3, seed=3))
    _equal(r8.tt.cores, r1.tt.cores)
    f8 = tp.tt_full(r8.tt).numpy()
    mesh_pts = np.meshgrid(*[np.linspace(-2, 2, n)] * d, indexing="ij")
    s = sum(mesh_pts)
    ref = np.exp(-0.5 * s * s) + 0.2 * np.cos(s)
    assert np.max(np.abs(f8 - ref)) < 1e-6
    assert np.max(np.abs(f8 - np.asarray(ti.tt_full(rj.tt)))) < 2e-6


def test_sharded_greedy_cross_matches_single_device():
    d, n = 4, 9
    gt = torch.linspace(-1.0, 1.0, n, dtype=torch.float64)
    gj = jnp.linspace(-1.0, 1.0, n)

    def fun_t(ind):
        s = torch.sum(gt[ind], dim=1)
        return torch.exp(-0.5 * s * s) + 0.3 * torch.sin(2 * s)

    def fun_j(ind):
        s = jnp.sum(gj[ind], axis=1)
        return jnp.exp(-0.5 * s * s) + 0.3 * jnp.sin(2 * s)

    r8, r1, rj = _cross_case(tp.greedy_cross, fun_t, fun_j, n, d,
                             dict(nswp=25, tol_exit=1e-7, seed=1))
    _equal(r8.tt.cores, r1.tt.cores)
    f8 = tp.tt_full(r8.tt).numpy()
    mesh_pts = np.meshgrid(*[np.linspace(-1, 1, n)] * d, indexing="ij")
    s = sum(mesh_pts)
    ref = np.exp(-0.5 * s * s) + 0.3 * np.sin(2 * s)
    assert np.max(np.abs(f8 - ref)) < 1e-6
    assert np.max(np.abs(f8 - np.asarray(ti.tt_full(rj.tt)))) < 2e-6


def test_sharded_deep_serve_real_checkpoint():
    """The shipped lz40n33_ck (d=40, n=33, rank 23), cut to level 0 and
    its first three levels as tests/test_parallel.py cuts it, served at
    'f64' over eight shards: the single-device serve bit for bit, and
    the JAX package's to 1e-10 (level 0 and one level there, where its
    compile stays short)."""
    dirt = tp.load_dirt(os.path.join(ROOT, "examples", "data", "lz40n33_ck"),
                        device="cpu")
    assert dirt.nlevels >= 13 and dirt.d == 40

    def cut(levels):
        return tp.DIRT(dirt.f0, dirt.fs[:levels], dirt.x0, dirt.x,
                       dirt.beta[:levels + 1], dirt.lfshift,
                       reference=dirt.reference,
                       interpolation=dirt.interpolation)

    q = tp.randref(dirt.reference, torch.Generator().manual_seed(11),
                   (8 * 32, 40))
    mesh = sample_mesh(devices=CPU8)

    def serve(dd, qq):
        return tp.tt_dirt_sample(dd, qq, precision="f64", device=qq.device)

    for levels in (3, 1):
        short = cut(levels)
        one = tp.tt_dirt_sample(short, q, precision="f64", device="cpu")
        sh = sharded_call(mesh, lambda qq, dd: serve(dd, qq), q, short)
        _equal(sh, one)
    zj, lj = ti.tt_dirt_sample(_to_jax(short), jnp.asarray(q.numpy()))
    assert np.max(np.abs(sh[0].numpy() - np.asarray(zj))) < 1e-10
    assert np.max(np.abs(sh[1].numpy() - np.asarray(lj))) < 1e-10


def test_finetune_mesh_matches_single_device():
    """dirt_finetune over eight shards: the first step's loss equals the
    single-device run's bit for bit (the forward passes are row-wise);
    the gradient sums the shards' parts in another order, so the losses
    of later steps and the tuned cores are held to
    tests/test_parallel.py's bars (1e-10 relative, 1e-12).  The sharded
    objective's gradient equals the JAX package's to 1e-8 relative."""
    from tt_irt_tpu_torch.constructors.finetune import finetune_loss

    def lp(x):
        return -0.5 * (torch.sum(x * x, dim=1)
                       + 1.1 * torch.sum(x[:, :-1] * x[:, 1:], dim=1))

    def lp_j(x):
        return -0.5 * (jnp.sum(x * x, axis=1)
                       + 1.1 * jnp.sum(x[:, :-1] * x[:, 1:], axis=1))

    grids = [np.linspace(-6, 6, 9) for _ in range(3)]
    dj = ti.tt_dirt_approx(grids, lambda x, b0, b1: (b1 - b0) * lp_j(x),
                           [1.0], stoptol=0.5, nswp=1, kickrank=0, y0=2,
                           rmax=2, testsamples=0, verb=0, seed=5)
    dt = tp.dirt_from_numpy(
        [np.asarray(c) for c in dj.f0.cores], [],
        [np.asarray(g) for g in dj.x0], [], np.asarray(dj.beta), dj.lfshift,
        reference=dj.reference, interpolation=dj.interpolation,
        device="cpu")
    mesh = sample_mesh(devices=CPU8)
    t_ref, l_ref = tp.dirt_finetune(dt, lp, steps=4, nsamples=64, lr=1e-3,
                                    seed=3, device="cpu")
    t_sh, l_sh = tp.dirt_finetune(dt, lp, steps=4, nsamples=64, lr=1e-3,
                                  seed=3, mesh=mesh, device="cpu")
    assert l_sh[0] == l_ref[0]
    np.testing.assert_allclose(l_sh, l_ref, rtol=1e-10)
    for a, b in zip(t_sh.f0.cores, t_ref.f0.cores):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-12)

    q = np.random.default_rng(3).uniform(1e-3, 1 - 1e-3, (64, 3))
    leaves = [c.clone().requires_grad_(True) for c in dt.f0.cores]
    stack = tp.DIRT(tp.TT(leaves), [], dt.x0, dt.x, dt.beta, dt.lfshift,
                    reference=dt.reference, interpolation=dt.interpolation)
    loss = finetune_loss(stack, lp, torch.from_numpy(q), mesh=mesh)
    grads = torch.autograd.grad(loss, leaves)

    def jloss(cores):
        st = ti.DIRT(ti.TT(list(cores)), [], dj.x0, dj.x, dj.beta,
                     dj.lfshift, reference=dj.reference,
                     interpolation=dj.interpolation)
        z, lfapp = ti.tt_dirt_sample(st, jnp.asarray(q))
        return jnp.mean(lfapp - lp_j(z))

    lj, gj = jax.value_and_grad(jloss)(tuple(dj.f0.cores))
    assert abs(float(loss.detach()) - float(lj)) <= 1e-8 * abs(float(lj))
    for a, b in zip(grads, gj):
        b = np.asarray(b)
        assert np.max(np.abs(a.numpy() - b)) <= 1e-8 * np.max(np.abs(b))


def test_dryrun_multichip_on_four_shards():
    """__graft_entry__.py's dryrun_multichip in the port, on four shards:
    a sharded tt_irt_sqr step with a global essinv and mean, the
    two-level DIRT build with sharded probe batches, a standalone sharded
    amen_cross_s, and the sharded use_fused=True serve against the level
    loop (1e-9); each sharded result equals its unsharded one bit for
    bit."""
    import chip_smoke

    mesh = sample_mesh(devices=["cpu"] * 4)
    m = 8 * 4
    tt = tp.tt_from_numpy(chip_smoke.build_tt(6, 9, 4, seed=2), "cpu")
    grids = [torch.linspace(-2.0, 2.0, 9, dtype=torch.float64)] * 6
    q = torch.from_numpy(np.random.default_rng(3).random((m, 6)))

    def step(qq, tt_):
        return tp.tt_irt_sqr(grids, tt_, qq, device=qq.device)

    xq, lf = sharded_call(mesh, step, q, tt)
    _equal((xq, lf), step(q, tt))
    lfex = -0.5 * torch.sum(xq * xq, dim=1)
    tau = sharded_call(mesh, tp.essinv, lfex, lf, sample_args=(0, 1),
                       rowwise=False)
    assert xq.shape == (m, 6) and bool(torch.isfinite(tau))
    assert bool(torch.isfinite(torch.mean(xq, dim=0)).all())

    def logratio(x, b0, b1):
        quad = torch.sum(x * x, dim=1) + \
            0.5 * torch.sum(x[:, :-1] * x[:, 1:], dim=1)
        return -0.5 * (b1 - b0) * quad

    dgrids = [np.linspace(-4.0, 4.0, 9) for _ in range(4)]
    kw = dict(nswp=1, kickrank=2, y0=4, stoptol=0.5, testsamples=m, seed=0,
              device="cpu")
    dirt = tp.tt_dirt_approx(dgrids, logratio, [0.1, 1.0], mesh=mesh, **kw)
    _equal(dirt.fs[0].cores, tp.tt_dirt_approx(dgrids, logratio, [0.1, 1.0],
                                               **kw).fs[0].cores)
    gvec = torch.linspace(-2.0, 2.0, 9, dtype=torch.float64)

    def cfun(ind):
        s = torch.sum(gvec[ind], dim=1)
        return torch.exp(-0.5 * s * s)

    cres = tp.amen_cross_s([9] * 4, cfun, 1e-8, nswp=4, kickrank=2, seed=0,
                           mesh=mesh, device="cpu")
    assert cres.tt.d == 4
    qd = torch.from_numpy(np.random.default_rng(5).random((m, 4)))
    zd, _ = tp.tt_dirt_sample(dirt, qd, device="cpu")
    zf, lff = sharded_call(mesh, lambda qq, dd: tp.tt_dirt_sample(
        dd, qq, use_fused=True, device=qq.device), qd, dirt)
    _equal((zf, lff), tp.tt_dirt_sample(dirt, qd, use_fused=True,
                                        device="cpu"))
    assert float((zf - zd).abs().max()) < 1e-9
