"""Tests of the port's CUDA kernels on the card.  They import neither
jax nor the JAX package, so they run on the GPU machine:

    python -m pytest tests/test_torch_cuda.py -m cuda

Without a CUDA device each test skips (the kernels have no CPU mode)."""

import numpy as np
import pytest
import torch

from test_torch_cdf import assert_as_accurate, cdf_rows
from test_torch_cdf import same as same_or_nan
from tt_irt_tpu_torch.ops.cdf import (cdf_invert_cuda, cdf_invert_into_ref,
                                      cdf_invert_ref)
from tt_irt_tpu_torch.ops.dim_step import dim_step_cuda, dim_step_ref
from tt_irt_tpu_torch.ops.fused_irt import (fused_irt_sqr_cuda,
                                            fused_irt_sqr_ref)
from tt_irt_tpu_torch.ops.odim_step import odim_step_cuda, odim_step_ref
from tt_irt_tpu_torch.ops.step import (cdf_bracket_factor_cuda,
                                       cdf_bracket_factor_ref,
                                       condition_update_cuda,
                                       condition_update_ref,
                                       factor_conditional_cuda,
                                       factor_conditional_ref,
                                       gram_conditional_cuda,
                                       gram_conditional_ref)

NO_CARD = "needs a CUDA device: the kernel has no CPU mode"
SHAPES = [(17, 5), (17, 13), (17, 19), (33, 23), (9, 40)]


def _operands(m, n, r, seed):
    """f32 operands of one dimension step, made with numpy: a sorted
    grid, a random factor, a positive core and prefix, and seeds that
    include exact 0.5 and a value within 2^-25 above it."""
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(-2.0, 2.0, n))
    x[0], x[-1] = -2.0, 2.0
    phi = rng.uniform(0.05, 1.0, (m, r)).astype(np.float32)
    phi /= np.max(np.abs(phi), axis=1, keepdims=True)
    q = rng.uniform(size=m)
    q[:2] = [0.5, 0.5 + 2.0 ** -26][:m]
    x32 = x.astype(np.float32)
    return dict(phi=phi, qp32=q.astype(np.float32),
                um32=(1.0 - q).astype(np.float32),
                bmat=rng.standard_normal((r, n * r)).astype(np.float32),
                cmat=rng.uniform(0.05, 1.0, (n, r * r)).astype(np.float32),
                hrow=np.diff(x).astype(np.float32),
                xg=np.stack([x32, (x - x32.astype(np.float64)).astype(
                    np.float32)]))


# The shapes of the tensor-core kernels (dim_step, odim_step,
# cdf_bracket_factor, factor_conditional): SHAPES, one at every rank tier
# (8, 16, 24, 32, 64), and two where the split factor does not fit and
# the mma.sync variant runs ((50, 24), (30, 32); (9, 40) and (9, 64) run
# it too, at tier 64).
# The even ranks the served stacks give dim_step (lz40_ck: (17, 16);
# dirt_round(lz40n33_ck): n=33 at 12, 16, 20), whose second pass stages its
# node slices at an odd stride since r^2 is even.
EVEN_SHAPES = [(17, 16), (17, 20), (33, 12), (33, 16), (33, 20)]
TC_SHAPES = SHAPES + [(9, 8), (9, 16), (9, 24), (9, 32), (9, 64), (50, 24),
                      (30, 32)] + EVEN_SHAPES


def _check_dim_step(t, mode):
    """dim_step_cuda on the operands t against its plain version: brackets
    identical on at least 99.9% of rows, out9 within 1e-5 of each
    column's scale where they agree, phin as close to the plain version
    run in f64 as the plain f32 version is (twice its error plus 1e-6)."""
    args = (t["phi"], t["qp32"], t["um32"], t["bmat"], t["cmat"],
            t["hrow"], t["xg"])
    before = dim_step_cuda.launches
    pk, ok_ = dim_step_cuda(*args, mode=mode)
    torch.cuda.synchronize()
    assert dim_step_cuda.launches == before + 1
    pr, orf = dim_step_ref(*args, mode=mode)
    p64, o64 = dim_step_ref(*(a.double() for a in args), mode=mode)
    same = ok_[:, 4] == orf[:, 4]
    assert float(same.double().mean()) >= 0.999
    scale = orf.abs().amax(0) + 1e-30
    assert float(((ok_ - orf).abs() / scale)[same].max()) < 1e-5
    all3 = same & (o64[:, 4].float() == orf[:, 4])
    err_k = float((pk.double() - p64)[all3].abs().max())
    err_p = float((pr.double() - p64)[all3].abs().max())
    assert err_k <= 2.0 * err_p + 1e-6, (err_k, err_p)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["irt", "rt"])
@pytest.mark.parametrize("n,r", TC_SHAPES)
def test_dim_step_kernel_matches_plain_on_card(mode, n, r):
    """The CUDA kernel against its plain version on the card, at every
    rank tier and in both variants of its tensor-core conditional.  phin
    depends on the f32 in-cell weight, whose rounding the CDF amplifies
    by tot / (f1 h) in low-density cells, so two f32 implementations
    differ there by more than 1e-5; the kernel's phin must instead be as
    accurate as the plain f32 version's (_check_dim_step)."""
    if not torch.cuda.is_available():
        pytest.skip(NO_CARD)
    _check_dim_step(_card_operands(4096 + 7, n, r, mode, n + r), mode)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 63, 64, 65, 4096 + 7])
@pytest.mark.parametrize("n,r", [(33, 23), (50, 24)])
def test_tensor_core_kernels_mask_the_last_tile_on_card(m, n, r):
    """Row counts that end inside a 64-row half or a 128-row tile, in the
    wgmma (33, 23) and mma.sync (50, 24) variants: on the first m rows of
    the operands of a longer launch, the outputs of all four tensor-core
    kernels (dim_step's phin and out9, odim_step's psin and out9 with the
    factor as Q, cdf_bracket_factor's out9 and i0, factor_conditional's
    fk) equal that launch's first m rows bit for bit (every row's
    arithmetic is its own, so a tail that is masked right changes
    nothing); odim_step's out9 equals dim_step's (the same first pass),
    cdf_bracket_factor's equals both wherever um32 == 1 - qp32, and every
    output is finite.  Accuracy against the plain versions at these
    shapes is the other card tests'."""
    if not torch.cuda.is_available():
        pytest.skip(NO_CARD)
    full = _card_operands(4096 + 7 + 200, n, r, "irt", n + r)
    rows = ("phi", "qp32", "um32")
    t = {k: (v[:m].contiguous() if k in rows else v) for k, v in full.items()}

    def all4(o):
        args = (o["phi"], o["qp32"], o["um32"], o["bmat"], o["cmat"],
                o["hrow"], o["xg"])
        return (*dim_step_cuda(*args),
                *odim_step_cuda(o["phi"], o["qp32"], o["um32"], o["bmat"],
                                o["hrow"], o["xg"]),
                *cdf_bracket_factor_cuda(o["phi"], o["qp32"], o["bmat"],
                                         o["hrow"], o["xg"]),
                factor_conditional_cuda(o["phi"], o["bmat"]))

    got, longer = all4(t), all4(full)
    torch.cuda.synchronize()
    for a, b in zip(got, longer):
        assert torch.equal(a, b[:m])
    pk, d9, ps, q9, o9, i0, fk = got
    assert torch.equal(q9, d9)
    eq = t["um32"] == 1.0 - t["qp32"]
    assert torch.equal(o9[eq], d9[eq])
    assert torch.equal(o9[:, 4], t["xg"][0][i0.long()])
    for out in (pk, d9, ps, o9, fk):
        assert bool(torch.isfinite(out).all())


@pytest.mark.cuda
def test_tensor_core_kernels_use_the_tensor_cores():
    """The compiled factor-family kernels (dim_step, odim_step,
    cdf_bracket_factor, factor_conditional) hold tensor-core
    instructions (cuobjdump -sass): HGMMA in every wgmma instance, HMMA
    in every mma.sync instance, at least one instance of each kernel at
    the rank tier 24 with HGMMA; HGMMA in each of the 21 instances of
    their wide tier (csrc/factor_wide.cuh, built from factor_wide.cu and
    factor_wide_cond.cu) and in each of the three instances of the Gram
    family's wide tiers (gram_wide.cu, fused_wide.cu).  dim_step's mode
    'irt' is one source, its mode 'rt' two (dim_step_rt.cu, tiers 8-32;
    dim_step_rt_t64.cu, 64).  The two Gram-family sources share
    one Gram stage: both include csrc/tc_gram.cuh and run its gram_nodes,
    which neither defines itself."""
    if not torch.cuda.is_available():
        pytest.skip(NO_CARD)
    import os
    import re

    from tt_irt_tpu_torch.ops._build import CSRC, sass_tensor_ops

    ops = {}
    for lib in ("dim_step", "dim_step_rt", "dim_step_rt_t64", "odim_step",
                "factor_step", "factor_conditional"):
        ops.update(sass_tensor_ops(lib))
    wide = {}
    for lib in ("factor_wide", "factor_wide_cond"):
        wide.update({k: v for k, v in sass_tensor_ops(lib).items()
                     if "_wide_kernel<" in k})
    assert len(wide) == 21, wide
    assert all(v["HGMMA"] > 0 for v in wide.values()), wide
    for lib, kern in (("gram_wide", "gram_wide_kernel<"),
                      ("fused_wide", "fused_wide_kernel<")):
        inst = {k: v for k, v in sass_tensor_ops(lib).items()
                if k.startswith(kern)}
        assert len(inst) == 3, (lib, inst)
        assert all(v["HGMMA"] > 0 for v in inst.values()), (lib, inst)
        with open(os.path.join(CSRC, lib + ".cu")) as fh:
            text = fh.read()
        assert '#include "tc_gram.cuh"' in text, lib
        assert re.search(r"\bgram_nodes<", text), lib
        assert not re.search(r"void gram_nodes\(", text), lib
    with open(os.path.join(CSRC, "tc_gram.cuh")) as fh:
        assert re.search(r"void gram_nodes\(", fh.read())
    # 4 wgmma tiers + 3 mma.sync tiers, in 'irt' and 'rt' where the
    # kernel has the two modes
    for kern, count in (("dim_step_kernel", 14), ("odim_step_kernel", 14),
                        ("cdf_bracket_factor_kernel", 14),
                        ("factor_conditional_kernel", 7)):
        inst = {k: v for k, v in ops.items() if k.startswith(kern + "<")}
        assert len(inst) == count, inst
        for k, v in inst.items():
            want = "HGMMA" if k.endswith("wgmma>") else "HMMA"
            assert v[want] > 0, (k, v)
        assert any(v["HGMMA"] > 0 for k, v in inst.items()
                   if k.startswith(kern + "<24,")), inst


@pytest.mark.cuda
def test_dim_step_kernel_rejects_bad_operands():
    """The wrapper raises on what the kernel does not take; nothing is
    launched."""
    if not torch.cuda.is_available():
        pytest.skip(NO_CARD)
    ops = {k: torch.from_numpy(np.ascontiguousarray(v)).cuda()
           for k, v in _operands(m=256, n=17, r=5, seed=1).items()}
    before = dim_step_cuda.launches
    with pytest.raises(ValueError):
        dim_step_cuda(ops["phi"].double(), ops["qp32"], ops["um32"], ops["bmat"],
                 ops["cmat"], ops["hrow"], ops["xg"])
    with pytest.raises(ValueError):
        dim_step_cuda(ops["phi"], ops["qp32"], ops["um32"], ops["bmat"].cpu(),
                 ops["cmat"], ops["hrow"], ops["xg"])
    # n=129: past the wide tier's caps
    big = _card_operands(128, 129, 4, "irt", 2)
    with pytest.raises(ValueError, match=r"caps n<=128, r<=128.*'f64'"):
        dim_step_cuda(big["phi"], big["qp32"], big["um32"], big["bmat"],
                      big["cmat"], big["hrow"], big["xg"])
    assert dim_step_cuda.launches == before


def _step_operands(m, n, r, seed):
    """phi, a general (non-symmetric) P, a core, brackets that include
    n-2, and weights with lb drawn independently of la."""
    rng = np.random.default_rng(seed)
    phi = rng.standard_normal((m, r)).astype(np.float32)
    phi /= np.max(np.abs(phi), axis=1, keepdims=True)
    pmat = rng.standard_normal((r * r, n)).astype(np.float32)
    cmat = rng.standard_normal((n, r * r)).astype(np.float32)
    i0 = rng.integers(0, n - 1, size=m).astype(np.int32)
    i0[:8] = n - 2
    la = rng.uniform(size=m).astype(np.float32)
    lb = rng.uniform(size=m).astype(np.float32)
    return [torch.from_numpy(a).cuda() for a in (phi, pmat, cmat, i0, la, lb)]


def _step_lib():
    from tt_irt_tpu_torch.ops.step import _lib
    return _lib()


# The step kernels' shapes: TC_SHAPES (every rank tier, the even ones
# included: an even r^2 is the node stride that condition_update pads to
# an odd one), and for condition_update one whose core does not fit
# shared memory beside its phi tiles (read from global memory).
UPDATE_SHAPES = TC_SHAPES + [(64, 32)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,r", TC_SHAPES)
def test_gram_conditional_kernel_matches_plain_on_card(n, r):
    """fk from the kernel against the plain version run in f64 on the
    same operands: 1e-5 of the largest |fk| (an f32 sum of r^2 terms),
    and no further from it than twice the plain f32 version plus 1e-6 of
    that scale.  The kernel takes 4 rows a thread at rank tiers 8-24, 2
    at tier 32 and 1 at tier 64."""
    if not torch.cuda.is_available():
        pytest.skip(NO_CARD)
    assert _step_lib().gram_conditional_rows(n, r) == (
        4 if r <= 24 else 2 if r <= 32 else 1)
    phi, pmat, _, _, _, _ = _step_operands(4096 + 7, n, r, n + r)
    before = gram_conditional_cuda.launches
    fk = gram_conditional_cuda(phi, pmat)
    torch.cuda.synchronize()
    assert gram_conditional_cuda.launches == before + 1
    f64 = gram_conditional_ref(phi.double(), pmat.double())
    scale = float(f64.abs().max())
    err_k = float((fk.double() - f64).abs().max()) / scale
    err_p = float((gram_conditional_ref(phi, pmat).double()
                   - f64).abs().max()) / scale
    assert err_k < 1e-5
    assert err_k <= 2.0 * err_p + 1e-6, (err_k, err_p)


@pytest.mark.cuda
@pytest.mark.parametrize("n,r", UPDATE_SHAPES)
def test_condition_update_kernel_matches_plain_on_card(n, r):
    """phi' from the kernel against the plain version in f64: 1e-5
    absolute on the max-normalised prefix.  The core is staged in shared
    memory at every shape but the last, (64, 32), whose 262 KB core is
    read from global memory."""
    if not torch.cuda.is_available():
        pytest.skip(NO_CARD)
    assert _step_lib().condition_update_staged(n, r) == int((n, r)
                                                            != (64, 32))
    phi, _, cmat, i0, la, lb = _step_operands(4096 + 7, n, r, n * r)
    before = condition_update_cuda.launches
    pk = condition_update_cuda(phi, i0, la, lb, cmat)
    torch.cuda.synchronize()
    assert condition_update_cuda.launches == before + 1
    p64 = condition_update_ref(phi.double(), i0, la.double(), lb.double(),
                               cmat.double())
    pr = condition_update_ref(phi, i0, la, lb, cmat)
    err_k = float((pk.double() - p64).abs().max())
    err_p = float((pr.double() - p64).abs().max())
    assert err_k < 1e-5
    assert err_k <= 2.0 * err_p + 1e-6, (err_k, err_p)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 127, 128, 129, 4096 + 7])
@pytest.mark.parametrize("n,r", [(17, 13), (17, 19), (33, 23), (9, 16),
                                 (64, 32), (9, 128), (96, 128)])
def test_step_kernels_mask_the_last_tile_on_card(m, n, r):
    """A ragged last tile (128 rows of condition_update, the 128 rows of
    a gram_conditional warp, or its 128-row tile at r > 24) leaves every
    row as the full run computes it and writes nothing past the last
    row: the outputs equal
    those of the same rows inside a larger run bit for bit, and the
    guard words after them stay as they were.  (64, 32) is
    condition_update's unstaged core and gram_conditional's wide tier (P
    alone takes 262 KB); (9, 128) and (96, 128) are both kernels' wide
    tier (128-row tiles of one cell; 128-row tiles of the Gram stage, two
    warpgroups of 64)."""
    if not torch.cuda.is_available():
        pytest.skip(NO_CARD)
    lib = _step_lib()
    phi, pmat, cmat, i0, la, lb = _step_operands(4096 + 7, n, r, m + n)
    stream = torch.cuda.current_stream().cuda_stream
    guard = torch.full((m + 300, max(n, r)), 7.0, device="cuda")
    runs = [(condition_update_cuda(phi, i0, la, lb, cmat), r,
             lambda out: lib.condition_update_launch(
                 phi.data_ptr(), i0.data_ptr(), la.data_ptr(), lb.data_ptr(),
                 cmat.data_ptr(), out.data_ptr(), m, n, r, phi.device.index,
                 stream)),
            (gram_conditional_cuda(phi, pmat), n,
             lambda out: lib.gram_conditional_launch(
                 phi.data_ptr(), pmat.data_ptr(), out.data_ptr(), m, n, r,
                 phi.device.index, stream))]
    for full, width, launch in runs:
        out = guard.clone()
        assert launch(out) == 0
        torch.cuda.synchronize()
        flat = out.view(-1)
        assert torch.equal(flat[:m * width], full[:m].reshape(-1))
        assert bool((flat[m * width:] == 7.0).all())


def _fused_operands(m, d, n, r, seed):
    """Operands of the whole transform from a smooth positive random TT
    (softplus of random Fourier features), made with numpy and prepared
    by the port on the card; rows 0 and 1 hold the seeds 0 and 1."""
    from tt_irt_tpu_torch.ops.fused_irt import build_fused_data
    from tt_irt_tpu_torch.ops.tt import TT

    rng = np.random.default_rng(seed)
    x = np.linspace(-1.0, 1.0, n)
    feats = np.stack([np.ones_like(x), np.sin(np.pi * x), np.cos(np.pi * x)])
    cores = []
    for k in range(d):
        r1 = 1 if k == 0 else r
        r2 = 1 if k == d - 1 else r
        w = rng.standard_normal((r1, 3, r2)) / np.sqrt(3 * r1)
        cores.append(np.log1p(np.exp(np.einsum("afb,fn->anb", w, feats))))
    tt = TT([torch.from_numpy(c).cuda() for c in cores])
    grid = torch.linspace(-2.0, 2.0, n, dtype=torch.float64).cuda()
    data = build_fused_data(tt, [grid] * d)
    q = rng.uniform(size=(m, d))
    q[0], q[1] = 0.0, 1.0
    return torch.from_numpy(q).float().cuda(), data


# The whole-transform kernel's shapes: SHAPES and rank tiers 8-32 at n=9.
FUSED_SHAPES = SHAPES + [(9, 8), (9, 16), (9, 24), (9, 32)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,r", FUSED_SHAPES)
def test_fused_irt_kernel_matches_plain_on_card(n, r):
    """The whole-transform kernel against its plain version in f64 on
    the same f32 operands (d=6): as accurate as the plain f32 version.
    The one-sided inversion in its cancelling form
    (-f1 + sqrt(f1^2 + 4 a t)) / 2a amplifies f32 rounding on flat cells
    and in the right tail, so two f32 implementations differ per row by
    more than 1e-5, and a bracket flips on rare rows at a CDF node.  The
    kernel's median and 99th-percentile errors must be at most twice the
    plain f32 version's plus 1e-6, and it may have at most twice as many
    outlier rows (error above 10x the plain version's 99th percentile
    plus 1e-5) as the plain version, plus 0.1% of the rows."""
    if not torch.cuda.is_available():
        pytest.skip(NO_CARD)
    q, data = _fused_operands(4096 + 7, 6, n, r, n + 2 * r)
    ops = (q, data["p2"], data["coreu"], data["x"], data["h"])
    before = fused_irt_sqr_cuda.launches
    xk, lk = fused_irt_sqr_cuda(*ops)
    torch.cuda.synchronize()
    assert fused_irt_sqr_cuda.launches == before + 1
    xr, lr = fused_irt_sqr_ref(*ops)
    x64, l64 = fused_irt_sqr_ref(*(t.double() for t in ops))
    assert bool(torch.isfinite(xk).all()) and bool(torch.isfinite(lk).all())
    rows = xk.shape[0]
    for k, r_, ref in ((xk, xr, x64), (lk, lr, l64)):
        ek = (k.double() - ref).abs().reshape(rows, -1).amax(1)
        er = (r_.double() - ref).abs().reshape(rows, -1).amax(1)
        st = {"k50": float(ek.median()), "r50": float(er.median()),
              "k99": float(torch.quantile(ek, 0.99)),
              "r99": float(torch.quantile(er, 0.99)),
              "kmax": float(ek.max()), "rmax": float(er.max())}
        cut = 10.0 * st["r99"] + 1e-5
        st["kout"] = int((ek > cut).sum())
        st["rout"] = int((er > cut).sum())
        assert st["k50"] <= 2.0 * st["r50"] + 1e-6, st
        assert st["k99"] <= 2.0 * st["r99"] + 1e-6, st
        assert st["kout"] <= 2 * st["rout"] + rows // 1000, st


def _parent_fused_smem(n, r):
    """Shared memory of a block of the one-row-a-thread whole-transform
    kernel this one replaced (its fused_irt_smem_bytes): P padded to the
    rank tier, the core, one fk and one phi column a thread, the grid and
    the spacings."""
    tier = 8 if r <= 8 else 16 if r <= 16 else 24 if r <= 24 else \
        32 if r <= 32 else 64
    return 4 * (n * r * tier + n * r * r + (n + r) * 128 + 2 * n)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 127, 128, 129, 4096 + 7])
@pytest.mark.parametrize("n,r", [(17, 13), (33, 23), (9, 40), (9, 32)])
def test_fused_irt_kernel_masks_the_last_tile_on_card(m, n, r):
    """A ragged last tile (512 rows at four rows a thread, 256 at two,
    128 at one), its warps wholly past the last row idle, leaves every
    row as the full run computes it and writes nothing past the last
    row: samples and log-densities equal those of
    the same rows inside a larger run bit for bit, and the guard words
    after them stay as they were.  (33, 23) runs single-buffered, (9, 40)
    one row a thread, (9, 32) two."""
    if not torch.cuda.is_available():
        pytest.skip(NO_CARD)
    from tt_irt_tpu_torch.ops.fused_irt import (_lib, fused_layout,
                                                pack_fused)

    q, data = _fused_operands(4096 + 7, 5, n, r, m + n)
    ops = (data["p2"], data["coreu"], data["x"], data["h"])
    xf, lf = fused_irt_sqr_cuda(q, *ops)
    d = q.shape[1]
    _, cstride, block = fused_layout(n, r)
    pack = pack_fused(*ops)
    xo = torch.full((m + 600, d), 7.0, device="cuda")
    lo = torch.full((m + 600,), 7.0, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    assert _lib().fused_irt_launch(
        q.data_ptr(), pack.data_ptr(), xo.data_ptr(), lo.data_ptr(), m, d,
        n, r, cstride, block, q.device.index, stream) == 0
    torch.cuda.synchronize()
    assert torch.equal(xo[:m], xf[:m]) and torch.equal(lo[:m], lf[:m])
    assert bool((xo[m:] == 7.0).all()) and bool((lo[m:] == 7.0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("n,r,rows,buffers", [
    (17, 13, 4, 2), (17, 19, 4, 1), (33, 23, 4, 1), (9, 40, 1, 1),
    (9, 24, 4, 1), (9, 32, 2, 1), (64, 16, 1, 1), (42, 24, 1, 1)])
def test_fused_irt_single_buffer_where_two_do_not_fit_on_card(
        n, r, rows, buffers):
    """The launch plan takes the rank tier's rows a thread where they fit,
    else one row, and of one or two staging buffers the instance with
    more resident blocks up to two an SM (two buffers on a tie): at
    (17, 19), (9, 24) and (9, 32) two buffers leave room for one block an
    SM, one buffer for two; at
    (33, 23) and (9, 40) two do not fit at all (at (33, 23) they alone
    take 286 KB).  Where it takes one buffer, the single-buffered
    instance runs and is as accurate as the plain version (the 99th
    percentile of its error against the f64 plain run at most twice the
    plain f32 version's plus 1e-6)."""
    if not torch.cuda.is_available():
        pytest.skip(NO_CARD)
    from tt_irt_tpu_torch.ops.fused_irt import fused_irt_plan, fused_layout

    got_rows, got_bufs, smem, _ = fused_irt_plan(n, r)
    assert (got_rows, got_bufs) == (rows, buffers)
    block = fused_layout(n, r)[2]
    slots = rows * max(n, r) * 128
    assert smem == 4 * (got_bufs * block + slots) <= 232448
    if (n, r) in ((33, 23), (9, 40)):
        assert 4 * (2 * block + slots) > 232448
    if got_bufs == 1:
        q, data = _fused_operands(1024 + 3, 4, n, r, 3 * n + r)
        ops = (q, data["p2"], data["coreu"], data["x"], data["h"])
        xk, lk = fused_irt_sqr_cuda(*ops)
        x64, l64 = fused_irt_sqr_ref(*(t.double() for t in ops))
        xr, lr = fused_irt_sqr_ref(*ops)
        for k, p_, ref in ((xk, xr, x64), (lk, lr, l64)):
            ek = torch.quantile((k.double() - ref).abs().reshape(
                k.shape[0], -1).amax(1), 0.99)
            ep = torch.quantile((p_.double() - ref).abs().reshape(
                k.shape[0], -1).amax(1), 0.99)
            assert float(ek) <= 2.0 * float(ep) + 1e-6, (ek, ep)


@pytest.mark.cuda
def test_fused_irt_kernel_takes_every_parent_shape_on_card():
    """Every (n, r) within the caps that the one-row-a-thread kernel took
    (its shared memory within 227 KB) has a launch plan within 227 KB."""
    if not torch.cuda.is_available():
        pytest.skip(NO_CARD)
    from tt_irt_tpu_torch.ops.fused_irt import fused_irt_plan

    missed = []
    for n in range(2, 65):
        for r in range(1, 65):
            if _parent_fused_smem(n, r) > 232448:
                continue
            rows, _, smem, grid = fused_irt_plan(n, r)
            if rows == 0 or smem > 232448 or grid != 1:
                missed.append((n, r))
    assert not missed, missed


@pytest.mark.cuda
def test_fused_irt_kernel_degenerate_rows_on_card():
    """A TT with an identically zero core has no mass anywhere: every
    dimension takes the uniform fix, samples are x0 + q (x_end - x0) and
    the log-density is -d log(box width); seeds 0 and 1 give the box
    corners."""
    if not torch.cuda.is_available():
        pytest.skip(NO_CARD)
    import tt_irt_tpu_torch as tp

    n, d = 9, 3
    x = torch.linspace(-1.0, 3.0, n, dtype=torch.float64)
    cores = [torch.ones((1, n, 1), dtype=torch.float64),
             torch.zeros((1, n, 1), dtype=torch.float64),
             torch.ones((1, n, 1), dtype=torch.float64)]
    q = torch.tensor([[0.0, 0.25, 1.0], [1.0, 0.5, 0.0], [0.3, 1.0, 0.7]],
                     dtype=torch.float64)
    xt, lt = tp.fused_irt_sqr([x] * d, tp.TT(cores), q)
    assert xt.is_cuda
    assert float((xt.double().cpu() - (-1.0 + 4.0 * q)).abs().max()) < 1e-6
    assert float((lt.double().cpu() + 3 * np.log(4.0)).abs().max()) < 1e-6


@pytest.mark.cuda
def test_new_kernels_reject_bad_operands():
    """Wrong dtype, device, contiguity or an int64 i0 raise, also
    through kernel_plan (an f64 tensor on the card is not sent to the
    plain version); nothing is launched."""
    if not torch.cuda.is_available():
        pytest.skip(NO_CARD)
    from tt_irt_tpu_torch.ops import kernel_plan

    phi, pmat, cmat, i0, la, lb = _step_operands(256, 17, 5, 1)
    q, data = _fused_operands(256, 3, 17, 5, 2)
    before = (gram_conditional_cuda.launches, condition_update_cuda.launches,
              fused_irt_sqr_cuda.launches)
    with pytest.raises(ValueError):
        gram_conditional_cuda(phi.double(), pmat)
    with pytest.raises(ValueError):
        kernel_plan.gram_conditional(phi.double(), pmat.double())
    with pytest.raises(ValueError):
        kernel_plan.condition_update(phi.double(), i0, la.double(),
                                     lb.double(), cmat.double())
    with pytest.raises(ValueError):
        gram_conditional_cuda(phi, pmat.cpu())
    with pytest.raises(ValueError):
        gram_conditional_cuda(phi, pmat.T.contiguous().T)
    with pytest.raises(ValueError):
        condition_update_cuda(phi, i0.long(), la, lb, cmat)
    with pytest.raises(ValueError):
        condition_update_cuda(phi, i0, la[:-1], lb, cmat)
    with pytest.raises(ValueError):
        fused_irt_sqr_cuda(q.double(), data["p2"], data["coreu"], data["x"],
                           data["h"])
    with pytest.raises(ValueError):
        fused_irt_sqr_cuda(q, data["p2"], data["coreu"], data["x"],
                           data["h"][:, :-1])
    assert (gram_conditional_cuda.launches, condition_update_cuda.launches,
            fused_irt_sqr_cuda.launches) == before


@pytest.mark.cuda
def test_kernel_plan_launches_on_the_card():
    """tt_irt_sqr at 'f32' on the card goes through both step kernels
    once per dimension and block, at 'f64' through neither."""
    if not torch.cuda.is_available():
        pytest.skip(NO_CARD)
    import tt_irt_tpu_torch as tp

    rng = np.random.default_rng(0)
    d, n, r = 5, 17, 4
    x = np.linspace(-2.0, 2.0, n)
    cores = [np.exp(-(x[None, :, None] - 0.3) ** 2
                    / rng.uniform(0.1, 0.5, (1 if k == 0 else r, 1,
                                             1 if k == d - 1 else r)))
             for k in range(d)]
    tt = tp.TT([torch.from_numpy(np.ascontiguousarray(c)) for c in cores])
    grids = [torch.from_numpy(x)] * d
    q = torch.from_numpy(rng.uniform(size=(3000, d)))
    g0, u0 = gram_conditional_cuda.launches, condition_update_cuda.launches
    x64, l64 = tp.tt_irt_sqr(grids, tt, q, precision="f64")
    assert (gram_conditional_cuda.launches, condition_update_cuda.launches) \
        == (g0, u0)
    x32, l32 = tp.tt_irt_sqr(grids, tt, q, precision="f32", block=1024)
    assert gram_conditional_cuda.launches == g0 + 3 * d
    assert condition_update_cuda.launches == u0 + 3 * d
    assert x32.is_cuda
    # as accurate as the same path through the plain versions on the CPU
    xc, lc = tp.tt_irt_sqr(grids, tt, q, precision="f32", block=1024,
                           device="cpu")
    for got, cpu, ref in ((x32, xc, x64), (l32, lc, l64)):
        e_card = float((got.double() - ref).abs().max())
        e_cpu = float((cpu.double() - ref.cpu()).abs().max())
        assert e_card <= 2.0 * e_cpu + 1e-6, (e_card, e_cpu)
    f0 = fused_irt_sqr_cuda.launches
    xf, lf = tp.fused_irt_sqr(grids, tt, q)
    assert fused_irt_sqr_cuda.launches == f0 + 1
    xfc, lfc = tp.fused_irt_sqr(grids, tt, q, device="cpu")
    for got, cpu, ref in ((xf, xfc, x64), (lf, lfc, l64)):
        e_card = torch.quantile((got.double() - ref).abs().reshape(
            3000, -1).amax(1), 0.99)
        e_cpu = torch.quantile((cpu.double() - ref.cpu()).abs().reshape(
            3000, -1).amax(1), 0.99)
        assert float(e_card) <= 2.0 * float(e_cpu) + 1e-6, (e_card, e_cpu)


def _card_operands(m, n, r, mode, seed):
    ops = _operands(m=m, n=n, r=r, seed=seed)
    if mode == "rt":
        ops["qp32"] = np.random.default_rng(r).uniform(
            -2.0, 2.0, ops["qp32"].shape).astype(np.float32)
    return {k: torch.from_numpy(np.ascontiguousarray(v)).cuda()
            for k, v in ops.items()}


def _bracket_nodes(o9, xg):
    """(rows, left node, live): dim_step's bracket from its out9 (x1 is
    the grid's f32 node there) and the rows that have mass (a row without
    it reads f1 = f2 = 1 in place of fk)."""
    i1 = torch.searchsorted(xg[0].contiguous(), o9[:, 4].contiguous())
    assert torch.equal(xg[0][i1], o9[:, 4])
    live = ~((o9[:, 2] == 1.0) & (o9[:, 3] == 1.0))
    return torch.arange(o9.shape[0], device=o9.device), i1, live


def _row_rel(fk, f64):
    """max |fk - f64| relative to each row's largest f64 fk."""
    return float(((fk.double() - f64).abs()
                  / f64.amax(1, keepdim=True).clamp_min(1e-300)).max())


@pytest.mark.cuda
@pytest.mark.parametrize("n,r", TC_SHAPES)
def test_factor_conditional_kernel_matches_plain_on_card(n, r):
    """fk from the kernel against the plain version run in f64 on the
    same operands, at every rank tier and in both variants of its
    tensor-core conditional: 1e-6 of the largest fk (a sum of r squares
    of r-term f32 sums), and no further from it than twice the plain f32
    version plus 1e-6, both relative to the largest fk and relative to
    each row's own largest fk (the small nodes are recomputed in f32).
    At dim_step's bracket nodes, on every row with mass, fk equals
    dim_step's f1 and f2 bit for bit: the same tensor-core stage and the
    same recompute rule."""
    if not torch.cuda.is_available():
        pytest.skip(NO_CARD)
    t = _card_operands(4096 + 7, n, r, "irt", n + r)
    before = factor_conditional_cuda.launches
    fk = factor_conditional_cuda(t["phi"], t["bmat"])
    torch.cuda.synchronize()
    assert factor_conditional_cuda.launches == before + 1
    f64 = factor_conditional_ref(t["phi"].double(), t["bmat"].double())
    fkp = factor_conditional_ref(t["phi"], t["bmat"])
    scale = float(f64.max())
    err_k = float((fk.double() - f64).abs().max()) / scale
    err_p = float((fkp.double() - f64).abs().max()) / scale
    assert err_k < 1e-6
    assert err_k <= 2.0 * err_p + 1e-6, (err_k, err_p)
    row_k, row_p = _row_rel(fk, f64), _row_rel(fkp, f64)
    assert row_k <= 2.0 * row_p + 1e-6, (row_k, row_p)
    _, o9 = dim_step_cuda(t["phi"], t["qp32"], t["um32"], t["bmat"],
                          t["cmat"], t["hrow"], t["xg"])
    rows, i1, live = _bracket_nodes(o9, t["xg"])
    assert float(live.double().mean()) > 0.99
    assert torch.equal(fk[rows, i1][live], o9[:, 2][live])
    assert torch.equal(fk[rows, i1 + 1][live], o9[:, 3][live])


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["irt", "rt"])
@pytest.mark.parametrize("n,r", TC_SHAPES)
def test_cdf_bracket_factor_kernel_matches_plain_on_card(mode, n, r):
    """(out9, i0) from the kernel against the plain version: brackets
    identical on at least 99.9% of rows, out9 within 1e-5 of each
    column's scale where they agree; and, wherever um32 == 1 - qp32 in
    f32 (every row in 'rt' mode, which reads no um32), out9 and the
    bracket equal dim_step's bit for bit: both kernels run the same
    device functions."""
    if not torch.cuda.is_available():
        pytest.skip(NO_CARD)
    t = _card_operands(4096 + 7, n, r, mode, n + r)
    before = cdf_bracket_factor_cuda.launches
    o9, i0 = cdf_bracket_factor_cuda(t["phi"], t["qp32"], t["bmat"],
                                     t["hrow"], t["xg"], mode=mode)
    torch.cuda.synchronize()
    assert cdf_bracket_factor_cuda.launches == before + 1
    assert i0.dtype == torch.int32
    orf, irf = cdf_bracket_factor_ref(t["phi"], t["qp32"], t["bmat"],
                                      t["hrow"], t["xg"], mode=mode)
    same = i0 == irf
    assert float(same.double().mean()) >= 0.999
    scale = orf.abs().amax(0) + 1e-30
    assert float(((o9 - orf).abs() / scale)[same].max()) < 1e-5
    assert torch.equal(o9[:, 4], t["xg"][0][i0.long()])
    _, d9 = dim_step_cuda(t["phi"], t["qp32"], t["um32"], t["bmat"],
                          t["cmat"], t["hrow"], t["xg"], mode=mode)
    eq = (t["um32"] == 1.0 - t["qp32"]) if mode == "irt" \
        else torch.ones_like(same)
    assert float(eq.double().mean()) > 0.3
    assert torch.equal(o9[eq], d9[eq])


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["irt", "rt"])
@pytest.mark.parametrize("n,r", TC_SHAPES)
def test_odim_step_kernel_matches_plain_on_card(mode, n, r):
    """The orthonormal-core kernel against its plain version, at every
    rank tier and in both variants of its tensor-core conditional:
    brackets identical on at least 99.9% of rows, out9 within 1e-5 of
    each column's scale where they agree, psi' as close to the plain
    version run in f64 as the plain f32 version is (twice its error plus
    1e-6; see the dim_step test for why not 1e-5 between the two).  Its
    first pass is dim_step's: on the same (psi, Q) operands its out9
    equals dim_step's bit for bit, and cdf_bracket_factor's wherever
    um32 == 1 - qp32 (every row in 'rt' mode)."""
    if not torch.cuda.is_available():
        pytest.skip(NO_CARD)
    t = _card_operands(4096 + 7, n, r, mode, n + r)
    args = (t["phi"], t["qp32"], t["um32"], t["bmat"], t["hrow"], t["xg"])
    before = odim_step_cuda.launches
    pk, ok_ = odim_step_cuda(*args, mode=mode)
    torch.cuda.synchronize()
    assert odim_step_cuda.launches == before + 1
    pr, orf = odim_step_ref(*args, mode=mode)
    p64, o64 = odim_step_ref(*(a.double() for a in args), mode=mode)
    same = ok_[:, 4] == orf[:, 4]
    assert float(same.double().mean()) >= 0.999
    scale = orf.abs().amax(0) + 1e-30
    assert float(((ok_ - orf).abs() / scale)[same].max()) < 1e-5
    all3 = same & (o64[:, 4].float() == orf[:, 4])
    err_k = float((pk.double() - p64)[all3].abs().max())
    err_p = float((pr.double() - p64)[all3].abs().max())
    assert err_k <= 2.0 * err_p + 1e-6, (err_k, err_p)
    assert float(pk.abs().amax(1).min()) == 1.0
    _, d9 = dim_step_cuda(t["phi"], t["qp32"], t["um32"], t["bmat"],
                          t["cmat"], t["hrow"], t["xg"], mode=mode)
    assert torch.equal(ok_, d9)
    o9, _ = cdf_bracket_factor_cuda(t["phi"], t["qp32"], t["bmat"],
                                    t["hrow"], t["xg"], mode=mode)
    eq = (t["um32"] == 1.0 - t["qp32"]) if mode == "irt" \
        else torch.ones_like(same)
    assert float(eq.double().mean()) > 0.3
    assert torch.equal(ok_[eq], o9[eq])


@pytest.mark.cuda
def test_factor_kernels_reject_bad_operands():
    """An f64 or CPU tensor reaching a wrapper raises, also through
    kernel_plan (an f64 tensor on the card is not sent to the plain
    version), and so does a shape past the wide tier's caps; nothing is
    launched."""
    if not torch.cuda.is_available():
        pytest.skip(NO_CARD)
    from tt_irt_tpu_torch.ops import kernel_plan

    t = _card_operands(256, 17, 5, "irt", 1)
    phi, qp, um, bm, h, xg = (t[k] for k in ("phi", "qp32", "um32", "bmat",
                                             "hrow", "xg"))
    fns = (odim_step_cuda, cdf_bracket_factor_cuda, factor_conditional_cuda)
    before = tuple(f.launches for f in fns)
    for bad_phi, bad_bm in ((phi.double(), bm), (phi, bm.cpu()),
                            (phi, bm.double())):
        with pytest.raises(ValueError):
            odim_step_cuda(bad_phi, qp, um, bad_bm, h, xg)
        with pytest.raises(ValueError):
            cdf_bracket_factor_cuda(bad_phi, qp, bad_bm, h, xg)
        with pytest.raises(ValueError):
            factor_conditional_cuda(bad_phi, bad_bm)
    with pytest.raises(ValueError):
        kernel_plan.odim_step(phi.double(), qp.double(), um.double(),
                              bm.double(), h.double(), xg.double())
    with pytest.raises(ValueError):
        kernel_plan.factor_conditional(phi.double(), bm.double())
    with pytest.raises(ValueError):
        kernel_plan.cdf_bracket_factor(phi.double(), qp.double(),
                                       bm.double(), h.double(), xg.double())
    with pytest.raises(ValueError):
        odim_step_cuda(phi, qp[:-1], um, bm, h, xg)
    # n=129: past the wide tier's caps
    big = _card_operands(128, 129, 4, "irt", 2)
    with pytest.raises(ValueError, match="caps n<=128"):
        odim_step_cuda(big["phi"], big["qp32"], big["um32"], big["bmat"],
                       big["hrow"], big["xg"])
    with pytest.raises(ValueError, match="caps n<=128"):
        cdf_bracket_factor_cuda(big["phi"], big["qp32"], big["bmat"],
                                big["hrow"], big["xg"])
    with pytest.raises(ValueError, match="caps n<=128"):
        factor_conditional_cuda(big["phi"], big["bmat"])
    assert tuple(f.launches for f in fns) == before


@pytest.mark.cuda
@pytest.mark.parametrize("precision,hi_step,counts", [
    ("hi", "odim", (0, 1, 0, 0, 0, 0)), ("hi", "bracket", (0, 0, 1, 0, 0, 1)),
    ("hi", "pair", (0, 0, 0, 1, 0, 1)), ("hid", "dim", (0, 0, 0, 1, 0, 1)),
    ("gs", "dim", (0, 0, 0, 0, 1, 1)), ("ds", "dim", (0, 0, 0, 0, 0, 0))])
def test_hi_steps_launch_their_kernels_on_the_card(precision, hi_step, counts):
    """tt_irt_sqr on the card goes through each variant's own kernels
    once per dimension and block (counts: dim_step, odim_step,
    cdf_bracket_factor, factor_conditional, gram_conditional,
    condition_update; 'ds' is plain f64 and launches none), and is as
    accurate against 'f64' as the same path through the plain versions
    on the CPU (twice its error plus 1e-6)."""
    if not torch.cuda.is_available():
        pytest.skip(NO_CARD)
    import tt_irt_tpu_torch as tp

    rng = np.random.default_rng(0)
    d, n, r = 5, 17, 4
    x = np.linspace(-2.0, 2.0, n)
    cores = [np.exp(-(x[None, :, None] - 0.3) ** 2
                    / rng.uniform(0.1, 0.5, (1 if k == 0 else r, 1,
                                             1 if k == d - 1 else r)))
             for k in range(d)]
    tt = tp.TT([torch.from_numpy(np.ascontiguousarray(c)) for c in cores])
    grids = [torch.from_numpy(x)] * d
    q = torch.from_numpy(rng.uniform(size=(3000, d)))
    fns = (dim_step_cuda, odim_step_cuda, cdf_bracket_factor_cuda,
           factor_conditional_cuda, gram_conditional_cuda,
           condition_update_cuda)
    x64, l64 = tp.tt_irt_sqr(grids, tt, q, precision="f64")
    before = tuple(f.launches for f in fns)
    xo, lo = tp.tt_irt_sqr(grids, tt, q, precision=precision, block=1024,
                           hi_step=hi_step)
    torch.cuda.synchronize()
    got = tuple(f.launches - b for f, b in zip(fns, before))
    assert got == tuple(3 * d * c for c in counts), got
    assert xo.is_cuda and xo.dtype == torch.float64
    xc, lc = tp.tt_irt_sqr(grids, tt, q, precision=precision, block=1024,
                           hi_step=hi_step, device="cpu")
    for card, cpu, ref in ((xo, xc, x64), (lo, lc, l64)):
        e_card = float((card - ref).abs().max())
        e_cpu = float((cpu - ref.cpu()).abs().max())
        assert e_card <= 2.0 * e_cpu + 1e-6, (e_card, e_cpu)


@pytest.mark.cuda
@pytest.mark.parametrize("precision,counts", [("f32", 1), ("hi", 1),
                                              ("f64", 0)])
def test_lin_launches_condition_update_on_the_card(precision, counts):
    """Mode 'lin' on the card: its prefix update goes through
    condition_update once per dimension and block at an f32 contraction
    (none at 'f64'), its conditional |phi P| is a plain product (no other
    kernel launches), and it is as accurate against 'f64' as the same
    path through the plain update on the CPU (twice its error plus
    1e-6)."""
    if not torch.cuda.is_available():
        pytest.skip(NO_CARD)
    import tt_irt_tpu_torch as tp

    rng = np.random.default_rng(1)
    d, n, r = 5, 17, 4
    x = np.linspace(-2.0, 2.0, n)
    cores = [np.exp(-(x[None, :, None] - 0.3) ** 2
                    / rng.uniform(0.1, 0.5, (1 if k == 0 else r, 1,
                                             1 if k == d - 1 else r)))
             for k in range(d)]
    tt = tp.TT([torch.from_numpy(np.ascontiguousarray(c)) for c in cores])
    grids = [torch.from_numpy(x)] * d
    q = torch.from_numpy(rng.uniform(size=(3000, d)))
    fns = (dim_step_cuda, odim_step_cuda, cdf_bracket_factor_cuda,
           factor_conditional_cuda, gram_conditional_cuda)
    x64, l64 = tp.tt_irt_lin(grids, tt, q, precision="f64")
    before = [f.launches for f in fns]
    u0 = condition_update_cuda.launches
    xo, lo = tp.tt_irt_lin(grids, tt, q, precision=precision, block=1024)
    torch.cuda.synchronize()
    assert condition_update_cuda.launches - u0 == 3 * d * counts
    assert [f.launches for f in fns] == before
    xc, lc = tp.tt_irt_lin(grids, tt, q, precision=precision, block=1024,
                           device="cpu")
    for card, cpu, ref in ((xo, xc, x64), (lo, lc, l64)):
        e_card = float((card.double() - ref).abs().max())
        e_cpu = float((cpu.double() - ref.cpu()).abs().max())
        assert e_card <= 2.0 * e_cpu + 1e-6, (e_card, e_cpu)


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["hi", "f32"])
def test_dirt_sample_equals_dirt_sampler_on_the_card(precision):
    """tt_dirt_sample and DirtSampler on the card: the same preparations
    and rank buckets, so the same outputs bit for bit, through the same
    kernels (lz10_ck, 4096 seeds)."""
    if not torch.cuda.is_available():
        pytest.skip(NO_CARD)
    import os

    import tt_irt_tpu_torch as tp

    path = os.path.join(os.path.dirname(__file__), "..", "examples", "data",
                        "lz10_ck")
    dirt = tp.load_dirt(path)
    q = tp.randref(dirt.reference, torch.Generator(device="cuda").manual_seed(
        4), (4096, dirt.d))
    zs, ls = tp.DirtSampler(dirt, precision=precision)(q)
    zt, lt = tp.tt_dirt_sample(dirt, q, precision=precision)
    assert torch.equal(zs, zt) and torch.equal(ls, lt)
    assert bool(torch.isfinite(zt).all())


@pytest.mark.cuda
def test_amen_cross_with_a_torch_function_on_the_card():
    """amen_cross_s hands a torch function its probe batches as int32
    tensors on the card; the result TT lies there and meets the JAX
    test's bar against the exact function (tests/test_cross.py,
    d=20, n=32: max relative error 1e-4 at 200 indices)."""
    if not torch.cuda.is_available():
        pytest.skip(NO_CARD)
    import tt_irt_tpu_torch as tp

    seen = set()

    def fun(ind):
        seen.add((ind.device.type, ind.dtype))
        return torch.sqrt(1.0 / torch.sum((ind.to(torch.float64) + 1.0) ** 2,
                                          dim=1))

    d, n = 20, 32
    res = tp.amen_cross_s([n] * d, fun, 1e-6, nswp=12, kickrank=4,
                          torch_fun=True)
    assert seen == {("cuda", torch.int32)}
    assert all(c.device.type == "cuda" for c in res.tt.cores)
    probe = torch.from_numpy(np.random.default_rng(0).integers(
        0, n, size=(200, d))).cuda()
    approx = tp.tt_eval_indices(res.tt, probe)
    exact = fun(probe)
    assert float(((approx - exact).abs() / exact).max()) < 1e-4


@pytest.mark.cuda
def test_dirt_build_at_hi_launches_dim_step_on_the_card():
    """A 2-level tt_dirt_approx(precision='hi') on the card pushes every
    probe batch through dim_step; built again with the plain 'hi' step on
    the card, its stack serves the same seeds as accurately: against the
    f64-push build's serve, the kernel build's 99th percentile is at most
    twice the plain build's plus 1e-6, in samples and log-densities
    (chip_smoke.py phase 13's rule)."""
    if not torch.cuda.is_available():
        pytest.skip(NO_CARD)
    import tt_irt_tpu_torch as tp
    from tt_irt_tpu_torch.ops import kernel_plan

    d = 4
    grids = [np.linspace(-5.0, 5.0, 17)] * d

    def logratio(x, b0, b1):
        quad = (x * x).sum(1) + (x[:, :-1] * x[:, 1:]).sum(1)
        return -0.5 * (b1 - b0) * quad

    kw = dict(nswp=1, kickrank=0, y0=5, stoptol=0.1, testsamples=0, seed=3)
    before = dim_step_cuda.launches
    built = tp.tt_dirt_approx(grids, logratio, [0.3, 1.0], precision="hi",
                              **kw)
    torch.cuda.synchronize()
    assert dim_step_cuda.launches - before > 0
    saved = kernel_plan.dim_step
    kernel_plan.dim_step = dim_step_ref
    try:
        plain = tp.tt_dirt_approx(grids, logratio, [0.3, 1.0],
                                  precision="hi", **kw)
    finally:
        kernel_plan.dim_step = saved
    ref = tp.tt_dirt_approx(grids, logratio, [0.3, 1.0], **kw)
    assert [f.ranks for f in built.fs] == [f.ranks for f in plain.fs]
    q = torch.rand((8192, d), generator=torch.Generator(
        device="cuda").manual_seed(5), dtype=torch.float64, device="cuda")
    zr, lr = tp.tt_dirt_sample(ref, q)
    for i, r in enumerate((zr, lr)):
        errs = []
        for stack in (built, plain):
            out = tp.tt_dirt_sample(stack, q)[i]
            e = (out - r).abs()
            e = e.amax(1) if e.ndim == 2 else e
            errs.append(float(torch.quantile(e, 0.99)))
        assert errs[0] <= 2.0 * errs[1] + 1e-6, errs


def _spectral_case(kind, d=4, r=5, seed=0):
    """A random positive TT (n=16 on the Fourier grid of (-4, 4], or
    n=17 on Lobatto nodes), its grids and 4096 seeds, made with numpy."""
    from tt_irt_tpu_torch.samplers.chebyshev import lobatto_nodes

    rng = np.random.default_rng(seed)
    n = 16 if kind == "fourier" else 17
    grid = ([np.arange(-7, 9) * 0.5] if kind == "fourier"
            else [lobatto_nodes(17, -4.0, 4.0)]) * d
    cores = [rng.uniform(0.1, 1.0, (1 if k == 0 else r, n,
                                    1 if k == d - 1 else r))
             for k in range(d)]
    return cores, grid, torch.from_numpy(rng.uniform(size=(4096, d)))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["fourier", "chebyshev"])
def test_spectral_samplers_on_card_match_cpu(kind):
    """tt_irt_fourier / tt_irt_cheb on the card against device='cpu':
    1e-10 on at least 99% of rows and 1e-6 on every row, in samples and
    log-density (tests/test_torch_spectral.py's bars)."""
    if not torch.cuda.is_available():
        pytest.skip(NO_CARD)
    import tt_irt_tpu_torch as tp

    fn = tp.tt_irt_fourier if kind == "fourier" else tp.tt_irt_cheb
    cores, grid, q = _spectral_case(kind)
    x, lf = fn(grid, tp.tt_from_numpy(cores, "cuda"), q, device="cuda")
    xc, lc = fn(grid, tp.tt_from_numpy(cores, "cpu"), q, device="cpu")
    dx = (x.cpu() - xc).abs().amax(1)
    dl = (lf.cpu() - lc).abs()
    assert int(((dx >= 1e-10) | (dl >= 1e-10)).sum()) <= 0.01 * q.shape[0]
    assert float(dx.max()) < 1e-6 and float(dl.max()) < 1e-6


@pytest.mark.cuda
def test_fused_program_matches_loop_at_f64_on_card():
    """tt_dirt_sample(use_fused=True) against the level loop at 'f64' on
    the card: within 1e-12 in samples and 1e-10 in log-density
    (tests/test_dirt.py's bars), on lz10_ck."""
    if not torch.cuda.is_available():
        pytest.skip(NO_CARD)
    import os

    import tt_irt_tpu_torch as tp

    dirt = tp.load_dirt(os.path.join(os.path.dirname(__file__), "..",
                                     "examples", "data", "lz10_ck"))
    q = tp.randref(dirt.reference, torch.Generator(
        device="cuda").manual_seed(3), (4096, dirt.d))
    z1, l1 = tp.tt_dirt_sample(dirt, q, precision="f64")
    z2, l2 = tp.tt_dirt_sample(dirt, q, precision="f64", use_fused=True)
    assert float((z1 - z2).abs().max()) < 1e-12
    assert float((l1 - l2).abs().max()) < 1e-10


@pytest.mark.cuda
def test_diffusion_likelihood_on_card_matches_cpu():
    """DiffusionProblem.likelihood_fn on the card against the CPU at
    meshlevel 0 (300 rows, blocks of 128): within 1e-12 relative per
    column."""
    if not torch.cuda.is_available():
        pytest.skip(NO_CARD)
    from tt_irt_tpu_torch.models.diffusion import DiffusionProblem

    pg = DiffusionProblem(meshlevel=0, tol_kle=3e-2, device="cuda")
    pc = DiffusionProblem(meshlevel=0, tol_kle=3e-2, device="cpu")
    rng = np.random.default_rng(2)
    y = torch.from_numpy(rng.uniform(-1.7, 1.7, (300, pc.kle_dim)))
    q_obs = rng.normal(0.5, 0.1, pc.m0 ** 2)
    og = pg.likelihood_fn(q_obs)(y).cpu()
    oc = pc.likelihood_fn(q_obs)(y)
    for c in range(3):
        ref = oc[:, c]
        err = float((og[:, c] - ref).abs().max())
        assert err <= 1e-12 * max(float(ref.abs().max()), 1e-300), (c, err)


def _random_tt_card(d, n, r, seed):
    """A random positive TT (numpy cores, uniform in [0.1, 1]) of rank r
    on the card, with d copies of linspace(-1, 1, n)."""
    import tt_irt_tpu_torch as tp

    rng = np.random.default_rng(seed)
    cores = [rng.uniform(0.1, 1.0, (1 if k == 0 else r, n,
                                    1 if k == d - 1 else r))
             for k in range(d)]
    grids = [torch.linspace(-1.0, 1.0, n, dtype=torch.float64,
                            device="cuda")] * d
    return tp.tt_from_numpy(cores, "cuda"), grids


@pytest.mark.cuda
@pytest.mark.parametrize("n,r", [(9, 128), (96, 32)])
def test_rank_128_at_f32_serves_through_the_wide_tier(n, r):
    """A TT of rank 128 (phase 23's posterior rank), and one at n = 96,
    served at 'f32' on the card through the wide tier of
    gram_conditional and condition_update (launch counts non-zero), as
    close to the 'f64' serve as the same transform through the plain f32
    steps: the 99th percentile and the maximum of |x - x64| and
    |lf - lf64| at most twice the plain path's plus 1e-6."""
    if not torch.cuda.is_available():
        pytest.skip(NO_CARD)
    import tt_irt_tpu_torch as tp
    from tt_irt_tpu_torch.samplers import irt_scan

    assert max(n, r) > 64            # past the narrow tiers' caps
    tt, grids = _random_tt_card(4, n, r, 4)
    q = torch.rand((4096, 4), dtype=torch.float64, device="cuda",
                   generator=torch.Generator(device="cuda").manual_seed(5))
    plain = (gram_conditional_ref, condition_update_ref)
    for fn, kern in ((tp.tt_irt_lin, ("condition_update",)),
                     (tp.tt_irt_sqr, ("gram_conditional",
                                      "condition_update"))):
        counts = {"gram_conditional": gram_conditional_cuda,
                  "condition_update": condition_update_cuda}
        before = {k: f.launches for k, f in counts.items()}
        x, lf = fn(grids, tt, q, precision="f32")
        torch.cuda.synchronize()
        for k in counts:
            launched = counts[k].launches - before[k]
            assert (launched > 0) == (k in kern), (fn.__name__, k, launched)
        x64, lf64 = fn(grids, tt, q, precision="f64")
        orig = (irt_scan.kernel_plan.gram_step,
                irt_scan.kernel_plan.cdf_invert)
        irt_scan.kernel_plan.gram_step = lambda dt: plain
        irt_scan.kernel_plan.cdf_invert = cdf_invert_into_ref
        try:
            xp, lfp = fn(grids, tt, q, precision="f32")
        finally:
            (irt_scan.kernel_plan.gram_step,
             irt_scan.kernel_plan.cdf_invert) = orig
        for a, b, ref in ((x, xp, x64), (lf, lfp, lf64)):
            ek = (a.double() - ref).abs().reshape(a.shape[0], -1).amax(1)
            ep = (b.double() - ref).abs().reshape(a.shape[0], -1).amax(1)
            assert bool(torch.isfinite(ek).all())
            for stat in (lambda e: float(torch.quantile(e, 0.99)),
                         lambda e: float(e.max())):
                assert stat(ek) <= 2.0 * stat(ep) + 1e-6, (
                    fn.__name__, stat(ek), stat(ep))


# The wide tier's shapes: rank 128 at a short grid, n = 96 at rank 32
# and both at 128; (64, 64) is within the narrow caps but its P needs
# 1 MB of shared memory, so gram_conditional takes the wide tier there;
# (9, 127) ends on a zero-padded k-step, (100, 70) on a unit of 3
# column groups; (33, 96) is the d = 40 serve's shape (three 32-column
# units a node).
WIDE_SHAPES = [(9, 128), (96, 32), (96, 128), (64, 64), (9, 127), (100, 70),
               (33, 96)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,r", WIDE_SHAPES)
def test_step_kernels_wide_tier_match_plain_on_card(n, r):
    """gram_conditional and condition_update in the wide tier against
    their plain versions run in f64 on the same operands: no further
    from them than twice the plain f32 versions plus 1e-6 (of the
    largest |fk| for fk), on a ragged last warp's rows too."""
    if not torch.cuda.is_available():
        pytest.skip(NO_CARD)
    # the narrow tiers take n, r <= 64, gram_conditional only while its
    # P (n r^2 floats, r padded to 4) fits the 227 KB opt-in
    assert max(n, r) > 64 or n * r * ((r + 3) // 4 * 4) * 4 > 227 * 1024
    phi, pmat, cmat, i0, la, lb = _step_operands(1024 + 7, n, r, n + r)
    before = (gram_conditional_cuda.launches, condition_update_cuda.launches)
    fk = gram_conditional_cuda(phi, pmat)
    pk = condition_update_cuda(phi, i0, la, lb, cmat)
    torch.cuda.synchronize()
    assert (gram_conditional_cuda.launches,
            condition_update_cuda.launches) == (before[0] + 1, before[1] + 1)
    f64 = gram_conditional_ref(phi.double(), pmat.double())
    scale = float(f64.abs().max())
    err_k = float((fk.double() - f64).abs().max()) / scale
    err_p = float((gram_conditional_ref(phi, pmat).double()
                   - f64).abs().max()) / scale
    assert err_k <= 2.0 * err_p + 1e-6, (err_k, err_p)
    p64 = condition_update_ref(phi.double(), i0, la.double(), lb.double(),
                               cmat.double())
    pr = condition_update_ref(phi, i0, la, lb, cmat)
    err_k = float((pk.double() - p64).abs().max())
    err_p = float((pr.double() - p64).abs().max())
    assert err_k <= 2.0 * err_p + 1e-6, (err_k, err_p)


@pytest.mark.cuda
def test_step_kernels_refuse_past_the_wide_caps():
    """n or r above 128 raises ValueError naming the caps and what serves
    such a shape ('f64'); nothing is launched.  dim_step refuses (9, 129)
    the same way."""
    if not torch.cuda.is_available():
        pytest.skip(NO_CARD)
    phi, pmat, cmat, i0, la, lb = _step_operands(64, 129, 4, 1)
    before = (gram_conditional_cuda.launches, condition_update_cuda.launches)
    with pytest.raises(ValueError, match=r"caps n<=128, r<=128.*'f64'"):
        gram_conditional_cuda(phi, pmat)
    with pytest.raises(ValueError, match=r"caps n<=128, r<=128.*'f64'"):
        condition_update_cuda(phi, i0, la, lb, cmat)
    assert (gram_conditional_cuda.launches,
            condition_update_cuda.launches) == before
    ops = _operands(64, 9, 129, 1)
    t = {k: torch.from_numpy(v).cuda() for k, v in ops.items()}
    with pytest.raises(ValueError, match=r"caps n<=128, r<=128.*'f64'"):
        dim_step_cuda(t["phi"], t["qp32"], t["um32"], t["bmat"], t["cmat"],
                      t["hrow"], t["xg"])


@pytest.mark.cuda
def test_conditional_at_hi_against_f64_on_card():
    """tt_irt_cond on a random positive TT (d=6, n=17, rank 5) with the
    first two coordinates fixed a seed, at 'hi' on the card: dim_step
    launched once a dimension, the conditioned columns equal xfix, and
    the samples and log conditional densities as close to the 'f64'
    conditional as the same call through dim_step's plain version (p99
    at most twice plus 1e-6)."""
    if not torch.cuda.is_available():
        pytest.skip(NO_CARD)
    import tt_irt_tpu_torch as tp
    from tt_irt_tpu_torch.ops import kernel_plan

    tt, grids = _random_tt_card(6, 17, 5, 6)
    gen = torch.Generator(device="cuda").manual_seed(6)
    z0, _ = tp.tt_irt_sqr(grids, tt, torch.rand(
        (2048, 6), generator=gen, dtype=torch.float64, device="cuda"),
        precision="f64")
    xfix = z0[:, :2]
    q_rest = torch.rand((2048, 4), generator=gen, dtype=torch.float64,
                        device="cuda")
    before = dim_step_cuda.launches
    z, lf = tp.tt_irt_cond(grids, tt, xfix, q_rest, precision="hi")
    torch.cuda.synchronize()
    assert dim_step_cuda.launches - before == 6
    assert torch.equal(z[:, :2], xfix)
    z64, lf64 = tp.tt_irt_cond(grids, tt, xfix, q_rest, precision="f64")
    saved = kernel_plan.dim_step
    kernel_plan.dim_step = dim_step_ref
    try:
        zp, lfp = tp.tt_irt_cond(grids, tt, xfix, q_rest, precision="hi")
    finally:
        kernel_plan.dim_step = saved
    for a, b, ref in ((z, zp, z64), (lf, lfp, lf64)):
        ek = (a - ref).abs().reshape(a.shape[0], -1).amax(1)
        ep = (b - ref).abs().reshape(a.shape[0], -1).amax(1)
        assert float(torch.quantile(ek, 0.99)) <= 2.0 * float(
            torch.quantile(ep, 0.99)) + 1e-6


@pytest.mark.cuda
def test_core_gradient_on_card_matches_finite_differences():
    """tests/test_autodiff.py's problem (d=4, n=9, ranks 1-3-2-3-1, so
    the scan path pads ranks) at 'f64' on the card: the core gradient is
    finite, within 1e-4 of central differences and within 1e-8 relative
    of the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip(NO_CARD)
    import tt_irt_tpu_torch as tp

    rng = np.random.default_rng(0)
    ranks = [1, 3, 2, 3, 1]
    cores = [rng.standard_normal((ranks[k], 9, ranks[k + 1]))
             for k in range(4)]
    q = rng.uniform(0.05, 0.95, size=(32, 4))

    def loss(cl, dev):
        grids = [torch.linspace(-1.0, 1.0, 9, dtype=torch.float64,
                                device=dev)] * 4
        z, lf = tp.tt_irt_sqr(grids, tp.TT(cl), torch.from_numpy(q).to(dev),
                              device=dev)
        return torch.sum(z ** 2) + 1e-3 * torch.sum(lf)

    grads = {}
    for dev in ("cuda", "cpu"):
        leaves = [torch.tensor(c, device=dev, requires_grad=True)
                  for c in cores]
        grads[dev] = [g.cpu().numpy() for g in
                      torch.autograd.grad(loss(leaves, dev), leaves)]
    assert all(np.isfinite(g).all() for g in grads["cuda"])
    for a, b in zip(grads["cuda"], grads["cpu"]):
        assert np.max(np.abs(a - b)) <= 1e-8 * np.max(np.abs(b))
    for ci, idx in [(0, (0, 2, 1)), (2, (1, 4, 1))]:
        cp = [torch.from_numpy(c.copy()).cuda() for c in cores]
        cm = [torch.from_numpy(c.copy()).cuda() for c in cores]
        cp[ci][idx] += 1e-6
        cm[ci][idx] -= 1e-6
        fd = float(loss(cp, "cuda") - loss(cm, "cuda")) / 2e-6
        assert abs(fd - grads["cuda"][ci][idx]) <= 1e-4 * max(abs(fd), 1.0)


# The factor family's wide tier (csrc/factor_wide.cu): n or r above 64,
# and narrow shapes whose staged factor passes shared memory ((33, 33),
# (65, 65) past the caps, (33, 96) the shape of the d = 40 serve below);
# the edges of its ring and k-step padding: (2, 65) one node of three
# 24-column units, (128, 128) the largest shared memory, (33, 127) a
# zero-padded last k-step.
WIDE_FACTOR_SHAPES = [(9, 128), (96, 32), (33, 33), (33, 96), (100, 70),
                      (9, 127), (65, 65), (2, 65), (128, 128), (33, 127)]


def _wide_tier(n, r):
    from tt_irt_tpu_torch.ops._build import load_library

    return load_library("factor_wide").factor_wide_tier(n, r) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("n,r", WIDE_FACTOR_SHAPES)
def test_factor_kernels_wide_tier_match_plain_on_card(n, r):
    """The four factor-family kernels in their wide tier against their
    plain versions, in both modes (_check_dim_step's bars and the narrow
    tests' for odim_step, cdf_bracket_factor and factor_conditional), and
    the ties of the tier: cdf_bracket_factor's out9 equals dim_step's bit
    for bit wherever um32 == 1 - qp32 (every row in 'rt' mode), odim_step's
    out9 dim_step's on the same (psi, Q), and factor_conditional's fk at
    dim_step's bracket nodes its f1 and f2."""
    if not torch.cuda.is_available():
        pytest.skip(NO_CARD)
    assert _wide_tier(n, r)
    for mode in ("irt", "rt"):
        t = _card_operands(4096 + 7, n, r, mode, n + r)
        _check_dim_step(t, mode)
        _, d9 = dim_step_cuda(t["phi"], t["qp32"], t["um32"], t["bmat"],
                              t["cmat"], t["hrow"], t["xg"], mode=mode)
        o9, i0 = cdf_bracket_factor_cuda(t["phi"], t["qp32"], t["bmat"],
                                         t["hrow"], t["xg"], mode=mode)
        orf, irf = cdf_bracket_factor_ref(t["phi"], t["qp32"], t["bmat"],
                                          t["hrow"], t["xg"], mode=mode)
        assert float((i0 == irf).double().mean()) >= 0.999
        eq = (t["um32"] == 1.0 - t["qp32"]) if mode == "irt" \
            else torch.ones_like(i0, dtype=torch.bool)
        assert float(eq.double().mean()) > 0.3
        assert torch.equal(o9[eq], d9[eq])
        args = (t["phi"], t["qp32"], t["um32"], t["bmat"], t["hrow"],
                t["xg"])
        pk, ok_ = odim_step_cuda(*args, mode=mode)
        pr, orf = odim_step_ref(*args, mode=mode)
        p64, o64 = odim_step_ref(*(a.double() for a in args), mode=mode)
        assert torch.equal(ok_, d9)
        same = (ok_[:, 4] == orf[:, 4]) & (o64[:, 4].float() == orf[:, 4])
        assert float(same.double().mean()) >= 0.999
        err_k = float((pk.double() - p64)[same].abs().max())
        err_p = float((pr.double() - p64)[same].abs().max())
        assert err_k <= 2.0 * err_p + 1e-6, (mode, err_k, err_p)
    t = _card_operands(4096 + 7, n, r, "irt", n + r)
    fk = factor_conditional_cuda(t["phi"], t["bmat"])
    f64 = factor_conditional_ref(t["phi"].double(), t["bmat"].double())
    fkp = factor_conditional_ref(t["phi"], t["bmat"])
    scale = float(f64.max())
    err_k = float((fk.double() - f64).abs().max()) / scale
    err_p = float((fkp.double() - f64).abs().max()) / scale
    assert err_k <= 2.0 * err_p + 1e-6, (err_k, err_p)
    row_k, row_p = _row_rel(fk, f64), _row_rel(fkp, f64)
    assert row_k <= 2.0 * row_p + 1e-6, (row_k, row_p)
    _, o9 = dim_step_cuda(t["phi"], t["qp32"], t["um32"], t["bmat"],
                          t["cmat"], t["hrow"], t["xg"])
    rows, i1, live = _bracket_nodes(o9, t["xg"])
    assert float(live.double().mean()) > 0.99
    assert torch.equal(fk[rows, i1][live], o9[:, 2][live])
    assert torch.equal(fk[rows, i1 + 1][live], o9[:, 3][live])


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 63, 64, 65, 127, 129, 4096 + 7])
@pytest.mark.parametrize("n,r", [(33, 96), (96, 32)])
def test_wide_tier_masks_the_last_tile_on_card(m, n, r):
    """Row counts that end inside a warpgroup's 64 rows or the 128-row
    tile, in the wide tier (three 32-column units a node at (33, 96), one
    at (96, 32)): on the first m rows of the operands of a longer launch,
    the outputs of all four wide kernels (dim_step's phin and out9,
    odim_step's psin and out9 with the factor as Q, cdf_bracket_factor's
    out9 and i0, factor_conditional's fk) equal that launch's first m rows
    bit for bit (every row's arithmetic is its own, whatever tile and
    warpgroup take it and wherever the ring stands), odim_step's out9
    equals dim_step's, cdf_bracket_factor's equals both wherever um32 ==
    1 - qp32, and every output is finite."""
    if not torch.cuda.is_available():
        pytest.skip(NO_CARD)
    assert _wide_tier(n, r)
    full = _card_operands(4096 + 7 + 200, n, r, "irt", n + r)
    rows = ("phi", "qp32", "um32")
    t = {k: (v[:m].contiguous() if k in rows else v) for k, v in full.items()}

    def all4(o):
        args = (o["phi"], o["qp32"], o["um32"], o["bmat"], o["cmat"],
                o["hrow"], o["xg"])
        return (*dim_step_cuda(*args),
                *odim_step_cuda(o["phi"], o["qp32"], o["um32"], o["bmat"],
                                o["hrow"], o["xg"]),
                *cdf_bracket_factor_cuda(o["phi"], o["qp32"], o["bmat"],
                                         o["hrow"], o["xg"]),
                factor_conditional_cuda(o["phi"], o["bmat"]))

    got, longer = all4(t), all4(full)
    torch.cuda.synchronize()
    for a, b in zip(got, longer):
        assert torch.equal(a, b[:m])
    pk, d9, ps, q9, o9, i0, fk = got
    assert torch.equal(q9, d9)
    eq = t["um32"] == 1.0 - t["qp32"]
    assert torch.equal(o9[eq], d9[eq])
    assert torch.equal(o9[:, 4], t["xg"][0][i0.long()])
    for out in (pk, d9, ps, o9, fk):
        assert bool(torch.isfinite(out).all())


@pytest.mark.cuda
def test_factor_kernels_refuse_past_the_wide_caps():
    """n or r above 128 raises ValueError in each factor-family wrapper
    and in fused_irt_sqr_cuda, naming the wide tier's caps and 'f64';
    nothing is launched."""
    if not torch.cuda.is_available():
        pytest.skip(NO_CARD)
    fns = (dim_step_cuda, odim_step_cuda, cdf_bracket_factor_cuda,
           factor_conditional_cuda, fused_irt_sqr_cuda)
    before = tuple(f.launches for f in fns)
    cap = r"caps n<=128, r<=128.*'f64'"
    for n, r in ((129, 4), (9, 129)):
        t = _card_operands(64, n, r, "irt", 3)
        with pytest.raises(ValueError, match=cap):
            dim_step_cuda(t["phi"], t["qp32"], t["um32"], t["bmat"],
                          t["cmat"], t["hrow"], t["xg"])
        with pytest.raises(ValueError, match=cap):
            odim_step_cuda(t["phi"], t["qp32"], t["um32"], t["bmat"],
                           t["hrow"], t["xg"])
        with pytest.raises(ValueError, match=cap):
            cdf_bracket_factor_cuda(t["phi"], t["qp32"], t["bmat"],
                                    t["hrow"], t["xg"])
        with pytest.raises(ValueError, match=cap):
            factor_conditional_cuda(t["phi"], t["bmat"])
        q = torch.rand((64, 2), device="cuda")
        with pytest.raises(ValueError, match=cap):
            fused_irt_sqr_cuda(
                q, torch.zeros((2, r * r, n), device="cuda"),
                torch.zeros((2, n, r * r), device="cuda"),
                torch.zeros((2, n), device="cuda"),
                torch.zeros((2, n - 1), device="cuda"))
    assert tuple(f.launches for f in fns) == before


@pytest.mark.cuda
@pytest.mark.parametrize("n,r", [(9, 128), (96, 32), (65, 65)])
def test_fused_irt_wide_tier_on_card(n, r):
    """The whole-transform kernel past its narrow caps (d=4) against its
    plain version in f64 on the same f32 operands: the 99th percentile
    of the error in samples and log-densities at most twice the plain
    f32 version's plus 1e-6 (the one-sided cancelling root is gated at
    the 99th percentile, as the narrow tier is)."""
    if not torch.cuda.is_available():
        pytest.skip(NO_CARD)
    q, data = _fused_operands(4096 + 7, 4, n, r, n + r)
    ops = (q, data["p2"], data["coreu"], data["x"], data["h"])
    before = fused_irt_sqr_cuda.launches
    xk, lk = fused_irt_sqr_cuda(*ops)
    torch.cuda.synchronize()
    assert fused_irt_sqr_cuda.launches == before + 1
    assert bool(torch.isfinite(xk).all()) and bool(torch.isfinite(lk).all())
    xr, lr = fused_irt_sqr_ref(*ops)
    x64, l64 = fused_irt_sqr_ref(*(t.double() for t in ops))
    for k, p_, ref in ((xk, xr, x64), (lk, lr, l64)):
        ek = torch.quantile((k.double() - ref).abs().reshape(
            k.shape[0], -1).amax(1), 0.99)
        ep = torch.quantile((p_.double() - ref).abs().reshape(
            k.shape[0], -1).amax(1), 0.99)
        assert float(ek) <= 2.0 * float(ep) + 1e-6, (float(ek), float(ep))


def _fused_p99(ops, xk, lk, rows=None):
    """The whole transform's bar: the 99th percentile of the kernel's
    row error in samples and log-densities against the plain version
    run in f64 on the same f32 operands at most twice the plain f32
    version's plus 1e-6 (on the given rows)."""
    sel = slice(None) if rows is None else rows
    xr, lr = fused_irt_sqr_ref(*ops)
    x64, l64 = fused_irt_sqr_ref(*(t.double() for t in ops))
    for k, p_, ref in ((xk, xr, x64), (lk, lr, l64)):
        k, p_, ref = k[sel], p_[sel], ref[sel]
        ek = torch.quantile((k.double() - ref).abs().reshape(
            k.shape[0], -1).amax(1), 0.99)
        ep = torch.quantile((p_.double() - ref).abs().reshape(
            k.shape[0], -1).amax(1), 0.99)
        assert float(ek) <= 2.0 * float(ep) + 1e-6, (float(ek), float(ep))


# Kernel 6's wide tier at a shape of each of its instances (fragments of
# 4, 8 and 16 k-steps: r <= 32, r <= 64, r <= 128): n = 96 at rank 32,
# n = 70 at rank 48 (6 k-steps, two units of 3 column groups), rank 72
# (9 k-steps) and 127 (a zero-padded last k-step) at n = 9.
FUSED_WIDE_BRANCHES = [(96, 32), (70, 48), (9, 72), (9, 127)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,r", FUSED_WIDE_BRANCHES)
def test_fused_irt_wide_branches_on_card(n, r):
    """The whole-transform kernel's wide tier at d = 4 against its plain
    version in f64 (the bar of test_fused_irt_wide_tier_on_card), one
    launch counted a call."""
    if not torch.cuda.is_available():
        pytest.skip(NO_CARD)
    q, data = _fused_operands(4096 + 7, 4, n, r, n * r)
    ops = (q, data["p2"], data["coreu"], data["x"], data["h"])
    before = fused_irt_sqr_cuda.launches
    xk, lk = fused_irt_sqr_cuda(*ops)
    torch.cuda.synchronize()
    assert fused_irt_sqr_cuda.launches == before + 1
    assert bool(torch.isfinite(xk).all()) and bool(torch.isfinite(lk).all())
    _fused_p99(ops, xk, lk)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 63, 64, 65, 127, 129, 4096 + 7])
@pytest.mark.parametrize("n,r", [(9, 128), (96, 32)])
def test_fused_irt_wide_rows_are_their_own_on_card(m, n, r):
    """Row counts that end inside a 64-row slab or the 128-row tile: the
    first m rows of a longer launch's seeds, and m rows 37 further on
    (other tile positions, other neighbours), give that launch's samples
    and log-densities of the same rows bit for bit (a row's Gram stage,
    CDF and dense-weighted update are its own: a zero weight adds an
    exact zero, whatever cells the tile's other rows touch)."""
    if not torch.cuda.is_available():
        pytest.skip(NO_CARD)
    q, data = _fused_operands(4096 + 7 + 200, 4, n, r, n + r)
    ops = (data["p2"], data["coreu"], data["x"], data["h"])
    xf, lf = fused_irt_sqr_cuda(q, *ops)
    for first in (0, 37):
        xm, lm = fused_irt_sqr_cuda(q[first:first + m].contiguous(), *ops)
        torch.cuda.synchronize()
        assert torch.equal(xm, xf[first:first + m]), first
        assert torch.equal(lm, lf[first:first + m]), first
        assert bool(torch.isfinite(xm).all() and torch.isfinite(lm).all())


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["one_cell", "first_cell", "last_cell",
                                  "ends"])
@pytest.mark.parametrize("n,r", [(9, 128), (96, 32)])
def test_fused_irt_wide_skewed_cells_on_card(kind, n, r):
    """Seeds that put every row of a tile in one cell (all rows one seed:
    the update streams the units of two nodes), in the first or the last
    cell (seeds within 1e-4 of 0 or 1), or half in each end cell: the
    rows in reverse order give the same rows' outputs bit for bit; one
    seed gives every row the outputs of that seed's row in a launch of
    uniform seeds; the end cells are held to the plain version in f64 at
    the 99th percentile."""
    if not torch.cuda.is_available():
        pytest.skip(NO_CARD)
    m, d = 4096 + 7, 4
    q, data = _fused_operands(m, d, n, r, n + r)
    ops = (data["p2"], data["coreu"], data["x"], data["h"])
    rng = np.random.default_rng(n * r + 3)
    lo = torch.from_numpy(rng.uniform(0.0, 1e-4, (m, d))).float().cuda()
    if kind == "one_cell":
        qs = q[7:8].expand(m, d).contiguous()
    elif kind == "first_cell":
        qs = lo
    elif kind == "last_cell":
        qs = 1.0 - lo
    else:
        qs = torch.where(torch.arange(m, device="cuda")[:, None] % 2 == 0,
                         lo, 1.0 - lo)
    xk, lk = fused_irt_sqr_cuda(qs, *ops)
    xr, lr = fused_irt_sqr_cuda(qs.flip(0).contiguous(), *ops)
    torch.cuda.synchronize()
    assert torch.equal(xr.flip(0), xk) and torch.equal(lr.flip(0), lk)
    assert bool(torch.isfinite(xk).all()) and bool(torch.isfinite(lk).all())
    if kind == "one_cell":
        xu, lu = fused_irt_sqr_cuda(q, *ops)
        assert torch.equal(xk, xu[7:8].expand(m, d))
        assert torch.equal(lk, lu[7:8].expand(m))
    else:
        _fused_p99((qs, *ops), xk, lk)


@pytest.mark.cuda
def test_hi_serves_d40_rank_96_on_card():
    """A random positive TT at d = 40, n = 33, r = 96, where every narrow
    tier refuses, served on the card at 'hi' with each hi_step and at
    'hid' (each variant's kernels once a dimension), and through
    DirtSampler(precision="auto") over a one-level stack of it, which
    picks 'hi' (dim_step once a dimension): samples and log-densities
    as close to the 'f64' serve as the same call through the plain
    steps (99th percentile at most twice plus 1e-6)."""
    if not torch.cuda.is_available():
        pytest.skip(NO_CARD)
    import tt_irt_tpu_torch as tp
    from tt_irt_tpu_torch.ops import kernel_plan
    from tt_irt_tpu_torch.utils.checkpoint import dirt_from_numpy

    d, n, r = 40, 33, 96
    assert _wide_tier(n, r)
    tt, grids = _random_tt_card(d, n, r, 40)
    q = torch.rand((2048, d), dtype=torch.float64, device="cuda",
                   generator=torch.Generator(device="cuda").manual_seed(40))
    x64, l64 = tp.tt_irt_sqr(grids, tt, q, precision="f64")
    plain = {"dim_step": dim_step_ref, "odim_step": odim_step_ref,
             "cdf_bracket_factor": cdf_bracket_factor_ref,
             "factor_conditional": factor_conditional_ref,
             "condition_update": condition_update_ref}
    fns = {"dim_step": dim_step_cuda, "odim_step": odim_step_cuda,
           "cdf_bracket_factor": cdf_bracket_factor_cuda,
           "factor_conditional": factor_conditional_cuda,
           "condition_update": condition_update_cuda}
    cases = (("hi", "dim", ("dim_step",)), ("hi", "odim", ("odim_step",)),
             ("hi", "bracket", ("cdf_bracket_factor", "condition_update")),
             ("hi", "pair", ("factor_conditional", "condition_update")),
             ("hid", None, ("factor_conditional", "condition_update")))
    for precision, hi_step, used in cases:
        kw = {} if hi_step is None else {"hi_step": hi_step}
        before = {k: f.launches for k, f in fns.items()}
        xk, lk = tp.tt_irt_sqr(grids, tt, q, precision=precision, **kw)
        torch.cuda.synchronize()
        got = {k: f.launches - before[k] for k, f in fns.items()}
        assert got == {k: (d if k in used else 0) for k in fns}, got
        saved = {k: getattr(kernel_plan, k) for k in plain}
        for k, f in plain.items():
            setattr(kernel_plan, k, f)
        try:
            xp, lp_ = tp.tt_irt_sqr(grids, tt, q, precision=precision, **kw)
        finally:
            for k, f in saved.items():
                setattr(kernel_plan, k, f)
        for k, p_, ref in ((xk, xp, x64), (lk, lp_, l64)):
            ek = torch.quantile((k - ref).abs().reshape(
                k.shape[0], -1).amax(1), 0.99)
            ep = torch.quantile((p_ - ref).abs().reshape(
                k.shape[0], -1).amax(1), 0.99)
            assert float(ek) <= 2.0 * float(ep) + 1e-6, (
                precision, hi_step, float(ek), float(ep))
    stack = dirt_from_numpy([c.cpu().numpy() for c in tt.cores], [],
                            [g.cpu().numpy() for g in grids], [], [1.0],
                            device="cuda")
    sampler = tp.DirtSampler(stack, precision="auto")
    assert sampler.precision == "hi"
    before = dim_step_cuda.launches
    z, lz = sampler(tp.randref(stack.reference, torch.Generator(
        device="cuda").manual_seed(41), (2048, d)))
    torch.cuda.synchronize()
    assert dim_step_cuda.launches - before == d
    assert bool(torch.isfinite(z).all()) and bool(torch.isfinite(lz).all())


@pytest.mark.cuda
def test_mesh_builds_equal_single_device_on_card():
    """Four shards on one card (sample_mesh(devices=["cuda:0"] * 4))
    against the single-device runs: amen_cross_s and greedy_cross (torch
    funs) and a two-level tt_dirt_approx equal bit for bit, a sharded
    'hi' serve equals the unsharded one bit for bit, and dirt_finetune's
    first loss is equal, its later losses within 1e-10 relative and its
    cores within 1e-12 (tests/test_parallel.py's bars: the shards'
    gradients are summed in another order)."""
    if not torch.cuda.is_available():
        pytest.skip(NO_CARD)
    import tt_irt_tpu_torch as tp
    from tt_irt_tpu_torch.parallel import sample_mesh, sharded_call

    mesh = sample_mesh(devices=["cuda:0"] * 4)
    gv = torch.linspace(-2.0, 2.0, 11, dtype=torch.float64, device="cuda")

    def fun(ind):
        s = torch.sum(gv[ind.to(gv.device)], dim=1)
        return torch.exp(-0.5 * s * s) + 0.2 * torch.cos(s)

    for cross, kw in ((tp.amen_cross_s, dict(nswp=6, kickrank=3, seed=3)),
                      (tp.greedy_cross, dict(nswp=20, seed=1))):
        one = cross([11] * 4, fun, 1e-9, torch_fun=True, **kw)
        sh = cross([11] * 4, fun, 1e-9, mesh=mesh, **kw)
        assert sh.evalcnt == one.evalcnt
        for a, b in zip(sh.tt.cores, one.tt.cores):
            assert torch.equal(a, b)

    def logratio(x, b0, b1):
        quad = torch.sum(x * x, dim=1) + \
            0.8 * torch.sum(x[:, :-1] * x[:, 1:], dim=1)
        return -0.5 * (b1 - b0) * quad

    grids = [np.linspace(-4, 4, 13) for _ in range(4)]
    kw = dict(stoptol=0.1, nswp=2, kickrank=2, testsamples=128, seed=9,
              reference="n3")
    d1 = tp.tt_dirt_approx(grids, logratio, [0.1, 1.0], **kw)
    d4 = tp.tt_dirt_approx(grids, logratio, [0.1, 1.0], mesh=mesh, **kw)
    for a, b in zip(list(d4.f0.cores) + list(d4.fs[0].cores),
                    list(d1.f0.cores) + list(d1.fs[0].cores)):
        assert torch.equal(a, b)
    tt, tg = _random_tt_card(6, 17, 5, 7)
    q = torch.rand((4096 + 3, 6), dtype=torch.float64, device="cuda",
                   generator=torch.Generator(device="cuda").manual_seed(8))
    one = tp.tt_irt_sqr(tg, tt, q, precision="hi")
    sh = sharded_call(mesh, lambda qq, t_: tp.tt_irt_sqr(
        tg, t_, qq, precision="hi", device=qq.device), q, tt)
    assert torch.equal(sh[0], one[0]) and torch.equal(sh[1], one[1])

    def lp(x):
        return -0.5 * (torch.sum(x * x, dim=1)
                       + 1.1 * torch.sum(x[:, :-1] * x[:, 1:], dim=1))

    # tests/test_parallel.py's fine-tuning problem and bars
    ft = tp.tt_dirt_approx([np.linspace(-6, 6, 9)] * 3,
                           lambda x, b0, b1: (b1 - b0) * lp(x), [1.0],
                           stoptol=0.5, nswp=1, kickrank=0, y0=2, rmax=2,
                           testsamples=0, seed=5)
    t1, l1 = tp.dirt_finetune(ft, lp, steps=4, nsamples=64, lr=1e-3, seed=3)
    t4, l4 = tp.dirt_finetune(ft, lp, steps=4, nsamples=64, lr=1e-3, seed=3,
                              mesh=mesh)
    assert l4[0] == l1[0]
    np.testing.assert_allclose(l4, l1, rtol=1e-10)
    for a, b in zip(t4.f0.cores, t1.f0.cores):
        assert float((a - b).abs().max()) <= 1e-12


@pytest.mark.cuda
def test_native_matches_f64_on_card():
    """The native C++ kernel on the host (its library built under
    build/native/) against tt_irt_sqr at 'f64' on the card on the same
    TT and seeds: 1e-10 in samples, 1e-8 in log-density
    (tests/test_native.py's tolerances)."""
    if not torch.cuda.is_available():
        pytest.skip(NO_CARD)
    import tt_irt_tpu_torch as tp
    from tt_irt_tpu_torch.native import tt_irt_native

    tt, grids = _random_tt_card(5, 15, 4, 9)
    q = np.random.default_rng(9).random((2048, 5))
    xc, lc = tp.tt_irt_sqr(grids, tt, torch.from_numpy(q).cuda(),
                           precision="f64")
    xn, ln = tt_irt_native([g.cpu() for g in grids], tt.to("cpu"), q)
    assert np.max(np.abs(xn - xc.cpu().numpy())) < 1e-10
    assert np.max(np.abs(ln - lc.cpu().numpy())) < 1e-8


# ---- the cell-grouped readout (csrc/cell_readout.cu): condition_update
#      past n or r of 64 and odim_step's readout in its wide tier ----

SKEWS = ["uniform", "one_cell", "last_cell", "ends", "63_64_65", "outside"]


def _skewed_i0(kind, m, n, rng):
    """Cells of m rows on n nodes: spread over every cell ("uniform");
    all in one middle cell, or in the last (n-2); only in cells 0 and
    n-2 ("ends": the rest empty); cells 0, 1, 2 of exactly 63, 64 and 65
    rows, the rest spread over cells 3.. ("63_64_65": the second
    warpgroup of a 128-row tile gets none, none, one row); i0 outside
    [0, n-2] on both sides ("outside": the kernel clips)."""
    if kind == "uniform":
        i0 = rng.integers(0, n - 1, m)
    elif kind == "one_cell":
        i0 = np.full(m, (n - 1) // 2)
    elif kind == "last_cell":
        i0 = np.full(m, n - 2)
    elif kind == "ends":
        i0 = np.where(rng.uniform(size=m) < 0.5, 0, n - 2)
    elif kind == "63_64_65":
        i0 = np.concatenate([np.full(63, 0), np.full(64, 1), np.full(65, 2),
                             rng.integers(3, n - 1, m - 192)])
        i0 = i0[rng.permutation(m)]
    else:
        i0 = rng.integers(-3 * n, 4 * n, m)
    return i0.astype(np.int32)


def _readout_ref(phi, slices, i0, la, lb):
    """The readout in plain PyTorch, the blend after the product
    (odim_step_ref's order): (la phi S[x] + lb phi S[x+1]) / max-abs, x =
    clip(i0, 0, n-2), slices (n, r, r)."""
    x = torch.clamp(i0.long(), 0, slices.shape[0] - 2)
    va = torch.bmm(phi[:, None, :], slices[x])[:, 0, :]
    vb = torch.bmm(phi[:, None, :], slices[x + 1])[:, 0, :]
    w = la[:, None] * va + lb[:, None] * vb
    return w / torch.clamp(w.abs().amax(1, keepdim=True), min=1e-30)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", SKEWS)
@pytest.mark.parametrize("n", [9, 33, 96])
def test_cell_plan_matches_plain_on_card(kind, n):
    """The readout's sort and tile plan on the card (cell_plan_cuda)
    against its plain version (cell_plan_ref): the same tiles (cell,
    first sorted position, rows) in the same order, every row once in
    the permutation, each in its (clipped) cell's range, on skewed cells
    and with empty cells; no tile passes 128 rows or its cell."""
    if not torch.cuda.is_available():
        pytest.skip(NO_CARD)
    from tt_irt_tpu_torch.ops.cell_readout import (cell_plan_cuda,
                                                   cell_plan_ref)

    m = 4096 + 7
    i0 = torch.from_numpy(_skewed_i0(kind, m, n, np.random.default_rng(n)))
    cell, perm_r, tiles_r = cell_plan_ref(i0, n)
    perm, tiles = cell_plan_cuda(i0.cuda(), n)
    torch.cuda.synchronize()
    assert torch.equal(tiles.cpu(), tiles_r)
    assert int(tiles_r[:, 2].max()) <= 128 and int(tiles_r[:, 2].min()) >= 1
    perm = perm.cpu()
    assert torch.equal(torch.sort(perm).values, torch.arange(m))
    assert torch.equal(cell[perm], cell[perm_r])
    key = cell * m
    assert torch.equal(torch.sort(key[perm] + perm).values,
                       key[perm_r] + perm_r)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", SKEWS)
@pytest.mark.parametrize("n,r", [(9, 128), (33, 96), (96, 32), (100, 70)])
def test_wide_condition_update_on_skewed_cells_on_card(kind, n, r):
    """condition_update in its wide tier (the cell-grouped readout) on
    skewed cells: one launch a call, as close to the plain version run
    in f64 (on the clipped cells) as the plain f32 version is (twice its
    error plus 1e-6); (100, 70) copies rows in 4 bytes at a time."""
    if not torch.cuda.is_available():
        pytest.skip(NO_CARD)
    m = 4096 + 7
    phi, _, cmat, _, la, lb = _step_operands(m, n, r, n + r)
    i0 = torch.from_numpy(_skewed_i0(kind, m, n, np.random.default_rng(r)))
    ic = torch.clamp(i0, 0, n - 2).cuda()
    before = condition_update_cuda.launches
    pk = condition_update_cuda(phi, i0.cuda(), la, lb, cmat)
    torch.cuda.synchronize()
    assert condition_update_cuda.launches == before + 1
    p64 = condition_update_ref(phi.double(), ic, la.double(), lb.double(),
                               cmat.double())
    pr = condition_update_ref(phi, ic, la, lb, cmat)
    err_k = float((pk.double() - p64).abs().max())
    err_p = float((pr.double() - p64).abs().max())
    assert err_k <= 2.0 * err_p + 1e-6, (kind, err_k, err_p)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", SKEWS)
@pytest.mark.parametrize("n,r", [(33, 96), (96, 32), (9, 127)])
def test_odim_readout_on_skewed_cells_on_card(kind, n, r):
    """odim_step's readout (cell_readout_launch with lb = 1 - la on the
    split of Q that factor_wide.cu's split leaves) on skewed cells,
    against the readout in plain PyTorch run in f64 on the same f32
    operands: as close as the plain f32 readout is (twice its error plus
    1e-6)."""
    if not torch.cuda.is_available():
        pytest.skip(NO_CARD)
    import ctypes

    from tt_irt_tpu_torch.ops._build import load_library
    from tt_irt_tpu_torch.ops.cell_readout import lib as readout_lib

    m = 4096 + 7
    t = _card_operands(m, n, r, "irt", n * r)
    rng = np.random.default_rng(n + r)
    i0 = torch.from_numpy(_skewed_i0(kind, m, n, rng)).cuda()
    la = torch.from_numpy(rng.uniform(size=m).astype(np.float32)).cuda()
    wide = load_library("factor_wide")
    p, i = ctypes.c_void_p, ctypes.c_int
    wide.factor_wide_split_launch.argtypes = [p, p, i, i, i, p]
    wide.factor_wide_scratch_floats.argtypes = [i, i]
    wide.factor_wide_scratch_floats.restype = ctypes.c_longlong
    cr = readout_lib()
    split = torch.empty((wide.factor_wide_scratch_floats(n, r),),
                        device="cuda")
    plan = torch.empty((cr.cell_readout_plan_words(m, n),),
                       dtype=torch.int32, device="cuda")
    psin = torch.empty((m, r), device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    assert wide.factor_wide_split_launch(t["bmat"].data_ptr(),
                                         split.data_ptr(), n, r, 0,
                                         stream) == 0
    assert cr.cell_readout_launch(
        t["phi"].data_ptr(), i0.data_ptr(), la.data_ptr(), None,
        split.data_ptr(), psin.data_ptr(), m, n, r, 0, stream,
        plan.data_ptr()) == 0
    torch.cuda.synchronize()
    q3 = t["bmat"].reshape(r, n, r).permute(1, 0, 2).contiguous()
    lb = 1.0 - la
    p64 = _readout_ref(t["phi"].double(), q3.double(), i0, la.double(),
                       lb.double())
    pr = _readout_ref(t["phi"], q3, i0, la, lb)
    err_k = float((psin.double() - p64).abs().max())
    err_p = float((pr.double() - p64).abs().max())
    assert err_k <= 2.0 * err_p + 1e-6, (kind, err_k, err_p)


@pytest.mark.cuda
@pytest.mark.parametrize("where", ["low", "high", "both"])
@pytest.mark.parametrize("n,r", [(33, 96), (96, 32)])
def test_odim_step_wide_on_skewed_seeds_on_card(where, n, r):
    """odim_step in its wide tier with seeds crowded at one end of the
    grid or both (most rows in a few cells, the rest empty): one launch a
    call, out9 equal to dim_step's bit for bit, psin as close to the
    plain version run in f64 as the plain f32 version (twice plus 1e-6),
    on the rows whose brackets agree."""
    if not torch.cuda.is_available():
        pytest.skip(NO_CARD)
    m = 4096 + 7
    t = _card_operands(m, n, r, "irt", n + 2 * r)
    u = np.random.default_rng(n).uniform(size=m) * 1e-3
    q = {"low": u, "high": 1.0 - u,
         "both": np.where(np.arange(m) % 2 == 0, u, 1.0 - u)}[where]
    t["qp32"] = torch.from_numpy(q.astype(np.float32)).cuda()
    t["um32"] = torch.from_numpy((1.0 - q).astype(np.float32)).cuda()
    args = (t["phi"], t["qp32"], t["um32"], t["bmat"], t["hrow"], t["xg"])
    before = odim_step_cuda.launches
    pk, ok_ = odim_step_cuda(*args)
    torch.cuda.synchronize()
    assert odim_step_cuda.launches == before + 1
    _, d9 = dim_step_cuda(t["phi"], t["qp32"], t["um32"], t["bmat"],
                          t["cmat"], t["hrow"], t["xg"])
    assert torch.equal(ok_, d9)
    pr, orf = odim_step_ref(*args)
    p64, o64 = odim_step_ref(*(a.double() for a in args))
    same = (ok_[:, 4] == orf[:, 4]) & (o64[:, 4].float() == orf[:, 4])
    assert float(same.double().mean()) >= 0.99
    err_k = float((pk.double() - p64)[same].abs().max())
    err_p = float((pr.double() - p64)[same].abs().max())
    assert err_k <= 2.0 * err_p + 1e-6, (where, err_k, err_p)


def _cdf_card(m, n, mode, exact, aligned=True):
    """(fk, xp, h, qp) of tests/test_torch_cdf.py::cdf_rows in f32 on the
    card; in mode 'rt' the seeds are points across the grid.  With
    ``aligned`` false fk starts 4 bytes into its storage, so that the
    kernel's tile staging takes its scalar path."""
    fk, xp, h, qp = cdf_rows(m, n, n + m, torch.float32, exact)
    if mode == "rt":
        qp = xp[0] + qp * (xp[-1] - xp[0])
    flat = torch.empty((m * n + 1,), dtype=torch.float32, device="cuda")
    fk_card = flat[int(not aligned):][:m * n].view(m, n)
    fk_card.copy_(fk)
    return fk_card, xp.cuda(), h.cuda(), qp.cuda()


def _near_node_rows(mode, fk, xp, h, qp, tol):
    """Rows whose target lies within ``tol`` of one of its running sums
    (the plain version's in f64): their f32 bracket may go either way.
    None in mode 'rt', whose bracket compares the grid itself."""
    if mode == "rt":
        return torch.zeros_like(qp, dtype=torch.bool)
    f, x, hh, q = (t.double() for t in (fk, xp, h, qp))
    dc = 0.5 * (f[:, :-1] + f[:, 1:]) * hh[1:]
    bad = dc.sum(1, keepdim=True) <= 0.0
    dc = torch.where(bad, (x[1:] - x[:-1]).expand_as(dc), dc)
    dc = dc / dc.sum(1, keepdim=True)
    zero = torch.zeros_like(dc[:, :1])
    ck = torch.cat([zero, dc.cumsum(1)], 1)
    cr = torch.cat([dc.flip(1).cumsum(1).flip(1), zero], 1)
    right = q > 0.5
    rows = torch.where(right[:, None], cr, ck)
    target = torch.where(right, 1.0 - q, q)
    return ((rows - target[:, None]).abs() < tol).any(1)


@pytest.mark.cuda
@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("mode", ["sqr", "rt"])
@pytest.mark.parametrize("n", [17, 33, 64, 128])
def test_cdf_invert_kernel_exact_rows_on_card(n, mode, aligned):
    """The CDF kernel on rows whose sums are exact in f32 (so that no
    order of summation rounds): every output equals the plain version's
    on the card bit for bit (NaN where it is NaN: a negative node can
    make the density at the sample negative), on a row count that ends
    inside a block, with rows without mass, rows whose running sums are
    not monotone and seeds at 0, 0.5, just above 0.5 and 1; one launch a
    call; lf is added to, not overwritten."""
    if not torch.cuda.is_available():
        pytest.skip(NO_CARD)
    m = 4096 + 7
    fk, xp, h, qp = _cdf_card(m, n, mode, exact=True, aligned=aligned)
    out = torch.empty((m,), dtype=torch.float32, device="cuda")
    lf = torch.full((m,), 0.5, dtype=torch.float32, device="cuda")
    before = cdf_invert_cuda.launches
    la, lb, i0 = cdf_invert_cuda(mode, fk, xp, h, qp, out, lf)
    torch.cuda.synchronize()
    assert cdf_invert_cuda.launches == before + 1
    assert i0.dtype == torch.int32
    x, dlf, la0, lb0, i00 = cdf_invert_ref(mode, fk, xp, h, qp)
    assert torch.equal(i0.long(), i00)
    for got, want in ((out, x), (lf, 0.5 + dlf), (la, la0), (lb, lb0)):
        assert same_or_nan(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["sqr", "rt"])
@pytest.mark.parametrize("n", [17, 33, 64, 128])
def test_cdf_invert_kernel_matches_plain_on_card(n, mode):
    """The CDF kernel on random rows (slightly negative nodes and rows
    without mass among them) against the plain version on the card.  The
    two differ only in how they sum a row's total (a compensated sum in
    order here, a tree in PyTorch), so: i0 equal on every row but those
    whose target lies within 4 n f32 ulps of 1 of a running sum (none in
    mode 'rt'); the sample, dlf, la and lb as accurate as the plain
    version's against its f64 run (tests/test_torch_cdf.py::
    assert_as_accurate: twice its 99th percentile of |error| plus 1e-6,
    three times its 99.9th)."""
    if not torch.cuda.is_available():
        pytest.skip(NO_CARD)
    m = 4096 + 7
    fk, xp, h, qp = _cdf_card(m, n, mode, exact=False)
    out = torch.empty((m,), dtype=torch.float32, device="cuda")
    lf = torch.zeros((m,), dtype=torch.float32, device="cuda")
    la, lb, i0 = cdf_invert_cuda(mode, fk, xp, h, qp, out, lf)
    got = (out, lf, la, lb)
    want = cdf_invert_ref(mode, fk, xp, h, qp)
    w64 = cdf_invert_ref(mode, *(t.double() for t in (fk, xp, h, qp)))
    near = _near_node_rows(mode, fk, xp, h, qp, 4 * n * 2.0 ** -24)
    assert torch.equal((i0.long() != want[4]) & ~near,
                       torch.zeros_like(near))
    assert_as_accurate(got + (i0.long(),), want, w64)


@pytest.mark.cuda
def test_cdf_invert_launches_once_a_dimension_on_card():
    """An 'f32' serve of lz20_ck (12 levels and level 0, d = 20) in one
    call of 2^20 seeds runs the CDF kernel once a dimension of every
    transform, 260 launches, beside kernels 5 and 3 as often."""
    if not torch.cuda.is_available():
        pytest.skip(NO_CARD)
    import os

    import tt_irt_tpu_torch as tp

    dirt = tp.load_dirt(os.path.join(os.path.dirname(__file__), "..",
                                     "examples", "data", "lz20_ck"))
    sampler = tp.DirtSampler(dirt, precision="f32", block=2 ** 20)
    q = tp.randref(dirt.reference, torch.Generator(
        device="cuda").manual_seed(20), (2 ** 20, dirt.d))
    before = (cdf_invert_cuda.launches, gram_conditional_cuda.launches,
              condition_update_cuda.launches)
    z, lf = sampler(q)
    torch.cuda.synchronize()
    after = (cdf_invert_cuda.launches, gram_conditional_cuda.launches,
             condition_update_cuda.launches)
    assert [a - b for a, b in zip(after, before)] == [260] * 3
    assert float(torch.isfinite(lf).double().mean()) > 0.999


@pytest.mark.cuda
def test_cdf_invert_refuses_past_its_caps_on_card():
    """Past n = 128, and on an f64 fk, the kernel's wrapper raises (the
    former naming 'f64', which serves any shape); kernel_plan hands an
    f64 fk on the card to the plain version, with no launch."""
    if not torch.cuda.is_available():
        pytest.skip(NO_CARD)
    from tt_irt_tpu_torch.ops import kernel_plan

    m = 64
    fk, xp, h, qp = _cdf_card(m, 129, "sqr", exact=False)
    out = torch.empty((m,), dtype=torch.float32, device="cuda")
    lf = torch.zeros((m,), dtype=torch.float32, device="cuda")
    with pytest.raises(ValueError, match="'f64'"):
        cdf_invert_cuda("sqr", fk, xp, h, qp, out, lf)
    fk, xp, h, qp = (t.double() for t in _cdf_card(m, 17, "sqr", False))
    out, lf = out.double(), lf.double()
    with pytest.raises(ValueError, match="float64"):
        cdf_invert_cuda("sqr", fk, xp, h, qp, out, lf)
    before = cdf_invert_cuda.launches
    la, lb, i0 = kernel_plan.cdf_invert("sqr", fk, xp, h, qp, out, lf)
    assert cdf_invert_cuda.launches == before
    x, dlf, la0, lb0, i00 = cdf_invert_ref("sqr", fk, xp, h, qp)
    assert torch.equal(out, x) and torch.equal(i0, i00)
    assert same_or_nan(lf, dlf) and torch.equal(la, la0)
