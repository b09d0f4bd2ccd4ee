"""A CPU model of the 3xTF32 arithmetic of the tensor-core factor
conditional (tt_irt_tpu_torch/csrc/tc_conditional.cuh), held to the
accuracy rule the card holds the kernels to: the model's fk no further
from the f64 fk than twice the plain f32 version's error plus 1e-6 of
the largest fk, and a whole level with the modelled conditional as
accurate as the plain f32 chain against the f64 chain.

The model, ``tc_conditional_model``, follows the kernel step by step:
  - each f32 operand split as hi = tf32(x) (round to nearest, ties to
    even, 10 explicit mantissa bits) and lo = x - hi, exact in f32,
    which the tensor core reads truncated to tf32;
  - the products of a k-step of 8 are exact in the tensor core; a step
    adds their sum to its accumulator and truncates the result toward
    zero to f32 (the tensor core does not round to nearest);
  - lo.hi and hi.lo over every k-step into one accumulator, hi.hi of
    each k-step into an accumulator of its own (starting from zero), and
    v = ((small + P_0) + P_1) ... in f32 with rounding to nearest;
  - fk = sum_j v_j^2 in the kernel's order: per lane fmaf over its two
    columns of each 8-column group, then two lane-shuffle sums.
That fk picks the bracket, sums the CDF cells and gives f1 and f2, except
where f1 or f2 is below 2^-8 of the row's largest fk: the kernel then
recomputes it in the f32 FMA chain of the CUDA cores (``chain_fk``;
``_model_step``).  factor_conditional, which has no bracket, recomputes
every node below 2^-8 of its row's largest fk the same way
(``factor_conditional_model``), so that its fk at the bracket nodes is
the bracket's f1 and f2.  The wide tier past rank 64
(tt_irt_tpu_torch/csrc/factor_wide.cu) groups the large products
instead: ``wide_conditional_model``; the prefix update past rank 64
(tt_irt_tpu_torch/csrc/cell_readout.cu) runs the same products on the
rows of one cell and interpolates after them: ``cell_readout_model``.
The Gram family's wide tiers (tt_irt_tpu_torch/csrc/tc_gram.cuh: the
stage with a Gram epilogue, which gram_wide.cu and fused_wide.cu run)
form v = phi P~ by the same products and fk = sum_j v_j phi_j in the
lanes' order: ``gram_wide_model``; the whole transform's wide tier
(fused_wide.cu) runs the same Gram stage and updates the prefix as a
dense-weighted product over the nodes its rows touch, hi.hi in one
part: ``dense_update_model``.
Nothing here needs a card."""

RECOMPUTE = 2.0 ** -8         # tc_conditional.cuh: kRecompute

import os

import numpy as np
import pytest
import torch

from tt_irt_tpu_torch.ops.cell_readout import cell_plan_ref
from tt_irt_tpu_torch.ops.dim_step import dim_step_ref
from tt_irt_tpu_torch.ops.rowmath import cdf_rows32, invert_quadratic
from tt_irt_tpu_torch.ops.step import (condition_update_ref,
                                       factor_conditional_ref,
                                       gram_conditional_ref)

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "examples", "data")


def tf32_round(x):
    """f32 -> the nearest tf32 value (ties to even), as an f32 tensor."""
    u = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    u = (u + 0xFFF + ((u >> 13) & 1)) & 0xFFFFE000
    u = torch.where(u >= 2 ** 31, u - 2 ** 32, u)
    return u.to(torch.int32).view(torch.float32)


def tf32_truncate(x):
    """f32 -> tf32 by dropping the 13 low mantissa bits (toward zero)."""
    return (x.contiguous().view(torch.int32) & -8192).view(torch.float32)


def split_tf32(x):
    """(hi, lo) with hi + lo = x exactly in f32."""
    hi = tf32_round(x)
    return hi, x - hi


def _toward_zero(s):
    """f64 -> the f32 value rounded toward zero, held in f64.  In f32's
    normal range, dropping the 29 mantissa bits f32 lacks is that
    rounding; below it (rare) the nearest f32 is stepped toward zero
    where it lies further out."""
    u = s.contiguous().view(torch.int64)
    t = (u & ~((1 << 29) - 1)).view(torch.float64)
    tiny = (t.abs() < 2.0 ** -126) & (t != 0)
    if bool(tiny.any()):
        st = s[tiny]
        yt = st.float()
        over = yt.double().abs() > st.abs()
        t[tiny] = torch.where(over, torch.nextafter(yt, torch.zeros_like(yt)),
                              yt).double()
    return t


def rank_tier(r):
    return 8 if r <= 8 else 16 if r <= 16 else 24 if r <= 24 else \
        32 if r <= 32 else 64


def tc_conditional_model(phi, bmat):
    """fk (M, n) as the tensor-core conditional computes it, from f32
    phi (M, r) and bmat (r, n*r).  The exact products of every k-step
    (8 terms each) are formed at once; what the kernel sums in order (a
    k-step's accumulator, v from its parts, a lane's squares) is summed
    here in that order."""
    m, r = phi.shape
    n = bmat.shape[1] // r
    kp = -(-r // 8) * 8
    ks = kp // 8
    a = torch.zeros((m, kp), dtype=torch.float32)
    a[:, :r] = phi
    b = torch.zeros((kp, n * r), dtype=torch.float32)
    b[:r] = bmat
    ah, al = split_tf32(a)
    bh, bl = split_tf32(b)
    al, bl = tf32_truncate(al), tf32_truncate(bl)   # as the tensor core reads

    def ksteps(x, y):
        """The exact products of every k-step, (ks, M, n*r) in f64."""
        return torch.bmm(x.double().reshape(m, ks, 8).transpose(0, 1),
                         y.double().reshape(ks, 8, n * r))

    small = None                          # f32 values, held in f64
    for x, y in ((al, bh), (ah, bl)):
        prods = ksteps(x, y)
        for s in range(ks):
            small = _toward_zero(prods[s] if small is None
                                 else small + prods[s])
    parts = _toward_zero(ksteps(ah, bh)).float()
    v = small.float()
    for s in range(ks):
        v = v + parts[s]
    # the kernel's per-node column blocks, padded to the rank tier; lane
    # t sums the squares of columns 8c + 2t + e over c, then e
    tier = rank_tier(r)
    vp = torch.zeros((m, n, tier), dtype=torch.float32)
    vp[:, :, :r] = v.reshape(m, n, r)
    vp = vp.reshape(m, n, tier // 8, 4, 2).double()
    acc = torch.zeros((m, n, 4), dtype=torch.float32)
    for c in range(tier // 8):
        for e in range(2):
            x = vp[:, :, c, :, e]
            acc = (x * x + acc.double()).float()
    return (acc[..., 0] + acc[..., 1]) + (acc[..., 2] + acc[..., 3])


def _wide_v(a, bh, bl, parts):
    """v = a B as the wide tiers' units compute it, from f32 a (mm, kp)
    zero-padded to whole k-steps and B's split (bh, bl (kp, cols), bl
    as the tensor core reads it): lo.hi, then hi.lo, over every k-step
    into one accumulator; hi.hi of each G = ceil(ks / parts) consecutive
    k-steps into an accumulator of its own (each a tensor-core
    accumulator, truncating as it adds a k-step); v = ((small + P0) +
    P1) ... in f32 rounded to nearest.  (mm, cols) f32."""
    mm, kp = a.shape
    ks, cols = kp // 8, bh.shape[1]
    g = -(-ks // parts)
    ah, al = split_tf32(a)
    al = tf32_truncate(al)

    def ksteps(x, y):
        return torch.bmm(x.double().reshape(mm, ks, 8).transpose(0, 1),
                         y.double().reshape(ks, 8, cols))

    def accumulate(prods, steps, acc=None):
        for s in steps:
            acc = _toward_zero(prods[s] if acc is None else acc + prods[s])
        return acc

    small = accumulate(ksteps(al, bh), range(ks))
    small = accumulate(ksteps(ah, bl), range(ks), small)
    big = ksteps(ah, bh)
    v = small.float()
    for first in range(0, ks, g):
        v = v + accumulate(big, range(first, min(ks, first + g))).float()
    return v


def _split_padded(b, kp):
    """B (r, cols) zero-padded to kp rows, split as the wide tiers' split
    kernel leaves it: (hi, lo as the tensor core reads it)."""
    bp = torch.zeros((kp, b.shape[1]), dtype=torch.float32)
    bp[:b.shape[0]] = b
    bh, bl = split_tf32(bp)
    return bh, tf32_truncate(bl)


def wide_conditional_model(phi, bmat, rows=128, parts=4):
    """fk (M, n) as the wide tier's tensor-core conditional computes it
    (csrc/factor_wide.cu::tile_conditional), from f32 phi (M, r) and bmat
    (r, n*r): ks = ceil(r / 8) k-steps, v by ``_wide_v`` (hi.hi in at
    most ``parts`` tensor-core accumulators), the squares in
    tc_conditional_model's lane order over the ks column groups (the
    units of a node in order, their zero padding adding nothing).
    ``rows`` rows at a time."""
    m, r = phi.shape
    n = bmat.shape[1] // r
    ks = -(-r // 8)
    kp = 8 * ks
    bh, bl = _split_padded(bmat, kp)
    out = []
    for lo_row in range(0, m, rows):
        mm = min(rows, m - lo_row)
        a = torch.zeros((mm, kp), dtype=torch.float32)
        a[:, :r] = phi[lo_row:lo_row + mm]
        v = _wide_v(a, bh, bl, parts)
        vp = torch.zeros((mm, n, kp), dtype=torch.float32)
        vp[:, :, :r] = v.reshape(mm, n, r)
        vp = vp.reshape(mm, n, ks, 4, 2).double()
        acc = torch.zeros((mm, n, 4), dtype=torch.float32)
        for c in range(ks):
            for e in range(2):
                x = vp[:, :, c, :, e]
                acc = (x * x + acc.double()).float()
        out.append((acc[..., 0] + acc[..., 1]) + (acc[..., 2] + acc[..., 3]))
    return torch.cat(out)


def cell_readout_model(phi, slices, i0, la, lb, parts=4):
    """phi' (M, r) as the cell-grouped readout computes it
    (csrc/cell_readout.cu), from f32 phi (M, r), slices S (n, r, r), i0
    (M,) and f32 la, lb (M,): the rows grouped by their clipped cell x
    (``cell_plan_ref``'s tiles), v_a = phi S[x] and v_b = phi S[x+1] by
    ``_wide_v`` on S split once, then la v_a + lb v_b in f32 (each
    product rounded, then the sum), each row divided by its largest
    absolute entry (floor 1e-30)."""
    m, r = phi.shape
    n = slices.shape[0]
    kp = 8 * -(-r // 8)
    split = [_split_padded(s_, kp) for s_ in slices]
    cell, perm, tiles = cell_plan_ref(i0, n)
    out = torch.empty_like(phi)
    for x, first, rows in tiles.tolist():
        idx = perm[first:first + rows]
        a = torch.zeros((rows, kp), dtype=torch.float32)
        a[:, :r] = phi[idx]
        va = _wide_v(a, *split[x], parts)
        vb = _wide_v(a, *split[x + 1], parts)
        w = la[idx, None] * va + lb[idx, None] * vb
        scale = torch.clamp(w.abs().amax(1, keepdim=True), min=1e-30)
        out[idx] = w / scale
    return out


def _lane_sums(vp, ap):
    """sum_j v_j a_j per (row, node) in the wide tiers' lane order, from
    v (mm, n, 8 ks) and a (mm, 1, 8 ks) zero-padded to whole k-steps:
    lane t takes columns 8c + 2t and 8c + 2t + 1 of each group c in
    order by fmaf, then the quad's four sums as (s0 + s1) + (s2 + s3)."""
    mm, n, kp = vp.shape
    ks = kp // 8
    vp = vp.reshape(mm, n, ks, 4, 2).double()
    ap = ap.reshape(ap.shape[0], ap.shape[1], ks, 4, 2).double()
    acc = torch.zeros((mm, n, 4), dtype=torch.float32)
    for c in range(ks):
        for e in range(2):
            acc = (vp[:, :, c, :, e] * ap[:, :, c, :, e]
                   + acc.double()).float()
    return (acc[..., 0] + acc[..., 1]) + (acc[..., 2] + acc[..., 3])


def gram_wide_model(phi, pmat, rows=128, parts=4):
    """fk (M, n) as the Gram family's wide tiers compute it
    (csrc/tc_gram.cuh::gram_nodes), from f32 phi (M, r) and pmat (r*r,
    n): P as the factor form P~[i, x*r + j] = P[i*r + j, x], split once;
    v = phi P~ by ``_wide_v`` (hi.hi in at most ``parts`` tensor-core
    accumulators); fk[x] = sum_j v[x, j] phi_j in the lanes' order
    (``_lane_sums``: the units of a node in order, their zero padding
    adding nothing).  ``rows`` rows at a time."""
    m, r = phi.shape
    n = pmat.shape[1]
    kp = 8 * -(-r // 8)
    pt = pmat.reshape(r, r, n).permute(0, 2, 1).reshape(r, n * r)
    bh, bl = _split_padded(pt, kp)
    out = []
    for lo_row in range(0, m, rows):
        mm = min(rows, m - lo_row)
        a = torch.zeros((mm, kp), dtype=torch.float32)
        a[:, :r] = phi[lo_row:lo_row + mm]
        v = _wide_v(a, bh, bl, parts)
        vp = torch.zeros((mm, n, kp), dtype=torch.float32)
        vp[:, :, :r] = v.reshape(mm, n, r)
        out.append(_lane_sums(vp, a[:, None, :]))
    return torch.cat(out)


def dense_update_model(phi, i0, la, lb, cmat, parts=1):
    """phi' (M, r) as the whole transform's wide tier updates the prefix
    (csrc/fused_wide.cu::update_units), from f32 phi (M, r), i0 (M,), f32
    la, lb (M,) and cmat (n, r*r) (condition_update_ref's operands): over
    every node c in order, v =
    phi C[c] by ``_wide_v`` (C[c] split once, hi.hi in ``parts``
    accumulators), acc = acc + w_c v in f32 (the product rounded, then
    the sum), w_c = la at c = i0, lb at c = i0 + 1, 0 elsewhere; each row
    divided by its largest absolute entry (floor 1e-30)."""
    m, r = phi.shape
    n = cmat.shape[0]
    kp = 8 * -(-r // 8)
    a = torch.zeros((m, kp), dtype=torch.float32)
    a[:, :r] = phi
    x = i0.long()
    acc = torch.zeros((m, r), dtype=torch.float32)
    for c in range(n):
        w = torch.where(x == c, la, torch.where(x + 1 == c, lb,
                                                torch.zeros_like(la)))
        v = _wide_v(a, *_split_padded(cmat[c].reshape(r, r), kp), parts)
        acc = acc + w[:, None] * v
    return acc / torch.clamp(acc.abs().amax(1, keepdim=True), min=1e-30)


def chain_fk(phi, bmat, at=None):
    """fk (M, n) in the CUDA cores' f32 FMA chain (TcStage::warp_node_fk):
    v_j = fma(phi_i, B_ij, v_j) over i in order, then f = fma(v_j, v_j, f)
    over j in order, each fma an exact f64 product and sum rounded once
    to f32.  With ``at`` (M, k) node indices, fk at those nodes of each
    row only, (M, k): the chain is elementwise over nodes, so these are
    the same values."""
    m, r = phi.shape
    n = bmat.shape[1] // r
    b3 = bmat.reshape(r, n, r).double()
    if at is not None:
        b3 = b3[:, at, :]                     # (r, M, k, r)
    p = phi.double()
    v = torch.zeros(b3.shape[1:] if at is not None else (m, n, r),
                    dtype=torch.float32)
    for i in range(r):
        v = (p[:, i, None, None] * b3[i] + v.double()).float()
    f = torch.zeros(v.shape[:-1], dtype=torch.float32)
    for j in range(r):
        x = v[..., j].double()
        f = (x * x + f.double()).float()
    return f


def factor_conditional_model(phi, bmat):
    """fk as the tensor-core factor_conditional gives it: the modelled
    tensor-core fk, and the f32 chain at every node whose tensor-core fk
    is below RECOMPUTE of its row's largest (TcStage::recompute_small)."""
    fk = tc_conditional_model(phi, bmat)
    tiny = RECOMPUTE * fk.amax(1, keepdim=True)
    return torch.where(fk < tiny, chain_fk(phi, bmat), fk)


def _errors(phi, bmat):
    """(model, plain f32) max |fk - fk64| relative to the largest fk64."""
    f64 = factor_conditional_ref(phi.double(), bmat.double())
    scale = float(f64.max())
    em = float((tc_conditional_model(phi, bmat).double() - f64).abs().max())
    ep = float((factor_conditional_ref(phi, bmat).double() - f64).abs().max())
    return em / scale, ep / scale


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The module's tensors are large and its ops many: one intra-op
    thread a process, so that parallel test workers do not oversubscribe
    the cores (six workers of eight threads each made this module 20x
    slower than alone).  The caller's setting comes back afterwards."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("bits", [0x3F800000, 0x3F801000, 0x3F803000,
                                  0x3F802FFF, 0xBF801001, 0x20001234])
def test_tf32_round_is_nearest_even_at_ten_bits(bits):
    """hi keeps 10 explicit mantissa bits, rounded to nearest with ties
    to even (0x3F801000 is a tie that rounds down to the even 1.0,
    0x3F803000 one that rounds up); hi + lo gives x back exactly, and the
    tensor core's view of them within 2^-21 of x."""
    x = torch.tensor([bits], dtype=torch.int64)
    x = torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(torch.int32).view(
        torch.float32)
    hi, lo = split_tf32(x)
    assert int(hi.view(torch.int32)) & 0x1FFF == 0
    half_ulp = 2.0 ** (np.floor(np.log2(abs(float(x)))) - 11)
    assert abs(float(x.double() - hi.double())) <= half_ulp
    assert float(hi.double() + lo.double()) == float(x)
    if bits == 0x3F801000:
        assert float(hi) == 1.0
    if bits == 0x3F803000:
        assert int(hi.view(torch.int32)) == 0x3F804000
    lo_t = tf32_truncate(lo)
    assert float((hi.double() + lo_t.double() - x.double()).abs()) \
        <= 2.0 ** -21 * abs(float(x))


@pytest.mark.parametrize("n,r", [(17, 5), (33, 23), (9, 40)])
def test_model_meets_the_card_rule_on_random_operands(n, r):
    """Random operands as the card tests make them: the modelled fk at
    most twice as far from the f64 fk as the plain f32 version plus 1e-6
    of the largest fk."""
    rng = np.random.default_rng(n + r)
    phi = rng.uniform(0.05, 1.0, (2048, r)).astype(np.float32)
    phi /= np.max(np.abs(phi), axis=1, keepdims=True)
    bmat = rng.standard_normal((r, n * r)).astype(np.float32)
    em, ep = _errors(torch.from_numpy(phi), torch.from_numpy(bmat))
    assert em <= 2.0 * ep + 1e-6, (em, ep)


# The wide tier's timed shapes (chip_smoke.py, WIDE_FACTOR_TIMED) and the
# edges of its k-step padding and unit widths (the card tests' new shapes).
WIDE_MODEL_SHAPES = [(33, 96), (96, 128), (9, 128), (96, 32), (2, 65),
                     (33, 127)]


@pytest.mark.parametrize("n,r", WIDE_MODEL_SHAPES)
def test_wide_model_meets_the_card_rule_on_random_operands(n, r):
    """The wide tier's grouping of k-steps (at most four tensor-core
    accumulators for hi.hi, summed in f32) on random operands as the card
    tests make them: its fk at most twice as far from the f64 fk as the
    plain f32 version plus 1e-6, relative to the largest fk and to each
    row's own largest (the card's fk_2x and fk_row_2x), and
    factor_conditional's recompute of the nodes below 2^-8 of their row's
    largest on top of it likewise."""
    rng = np.random.default_rng(n + r)
    phi = rng.uniform(0.05, 1.0, (512, r)).astype(np.float32)
    phi /= np.max(np.abs(phi), axis=1, keepdims=True)
    phi = torch.from_numpy(phi)
    bmat = torch.from_numpy(rng.standard_normal((r, n * r)).astype(
        np.float32))
    f64 = factor_conditional_ref(phi.double(), bmat.double())
    fkp = factor_conditional_ref(phi, bmat)
    tc = wide_conditional_model(phi, bmat)
    fk = tc.clone()
    for i, x in (tc < RECOMPUTE * tc.amax(1, keepdim=True)).nonzero().tolist():
        fk[i, x] = chain_fk(phi[i:i + 1], bmat, torch.tensor([[x]]))[0, 0]
    for model in (tc, fk):
        for scale in (f64.amax(1, keepdim=True), f64.max()):
            em = float(((model.double() - f64).abs() / scale).max())
            ep = float(((fkp.double() - f64).abs() / scale).max())
            assert em <= 2.0 * ep + 1e-6, (em, ep)


def test_wide_grouping_beats_fewer_accumulators():
    """Why four parts: at (96, 128) on random operands (16 k-steps) the
    wide model's fk is closer to the f64 fk with hi.hi in four
    tensor-core accumulators than in two, and in two than in one, whose
    truncation errors add up over more k-steps.  Two parts left the
    card's dim_step phin at 2.2x the plain version's error against f64
    at (128, 128), past the 2x + 1e-6 bar."""
    rng = np.random.default_rng(7)
    r, n = 128, 96
    phi = rng.uniform(0.05, 1.0, (256, r)).astype(np.float32)
    phi /= np.max(phi, axis=1, keepdims=True)
    phi = torch.from_numpy(phi)
    bmat = torch.from_numpy(rng.standard_normal((r, n * r)).astype(
        np.float32))
    f64 = factor_conditional_ref(phi.double(), bmat.double())
    err = [float((wide_conditional_model(phi, bmat, parts=p).double()
                  - f64).abs().max()) for p in (4, 2, 1)]
    assert err[0] < err[1] < err[2], err


def _readout_plain(phi, slices, i0, la, lb):
    """odim_step_ref's readout in plain PyTorch (the blend after the
    product) on slices S (n, r, r): (la phi S[x] + lb phi S[x+1]) /
    max-abs, x = clip(i0, 0, n-2)."""
    x = torch.clamp(i0.long(), 0, slices.shape[0] - 2)
    va = torch.bmm(phi[:, None, :], slices[x])[:, 0, :]
    vb = torch.bmm(phi[:, None, :], slices[x + 1])[:, 0, :]
    w = la[:, None] * va + lb[:, None] * vb
    return w / torch.clamp(w.abs().amax(1, keepdim=True), min=1e-30)


# Kernel 3's wide shapes (rank 128 at a short grid, cell U's (33, 96))
# and the largest.
READOUT_MODEL_SHAPES = [(9, 128), (33, 96), (128, 128)]


@pytest.mark.parametrize("kernel", ["condition_update", "odim_step"])
@pytest.mark.parametrize("n,r", READOUT_MODEL_SHAPES)
def test_cell_readout_model_meets_the_card_rule(kernel, n, r):
    """The cell-grouped readout's arithmetic (3xTF32 products of each
    cell's rows with S[x] and S[x+1], hi.hi in four parts, the blend
    after) on operands as the card tests make them: its phi' at most
    twice as far from the plain version run in f64 as the plain f32
    version plus 1e-6.  condition_update: a normal prefix and core,
    independent la and lb, against condition_update_ref (which
    interpolates the core first); odim_step's readout: a positive
    prefix, a normal factor Q, lb = 1 - la, against its plain readout."""
    rng = np.random.default_rng(n * r)
    m = 1024
    if kernel == "condition_update":
        phi = rng.standard_normal((m, r)).astype(np.float32)
        cmat = rng.standard_normal((n, r * r)).astype(np.float32)
        lb = rng.uniform(size=m).astype(np.float32)
    else:
        phi = rng.uniform(0.05, 1.0, (m, r)).astype(np.float32)
        q = rng.standard_normal((r, n * r)).astype(np.float32)
        cmat = q.reshape(r, n, r).transpose(1, 0, 2).reshape(n, r * r)
    phi /= np.max(np.abs(phi), axis=1, keepdims=True)
    i0 = rng.integers(0, n - 1, m).astype(np.int32)
    la = rng.uniform(size=m).astype(np.float32)
    if kernel == "odim_step":
        lb = (1.0 - la).astype(np.float32)
    phi, cmat, i0, la, lb = (torch.from_numpy(np.ascontiguousarray(a))
                             for a in (phi, cmat, i0, la, lb))
    slices = cmat.reshape(n, r, r)
    model = cell_readout_model(phi, slices, i0, la, lb)
    if kernel == "condition_update":
        p64 = condition_update_ref(phi.double(), i0, la.double(),
                                   lb.double(), cmat.double())
        pr = condition_update_ref(phi, i0, la, lb, cmat)
    else:
        p64 = _readout_plain(phi.double(), slices.double(), i0, la.double(),
                             lb.double())
        pr = _readout_plain(phi, slices, i0, la, lb)
    em = float((model.double() - p64).abs().max())
    ep = float((pr.double() - p64).abs().max())
    assert em <= 2.0 * ep + 1e-6, (em, ep)


def test_cell_readout_model_rows_are_their_own():
    """Every row's modelled phi' is its own: the first 100 rows alone
    give the same values bit for bit as inside 1024 rows, with every
    row in one cell or spread over all of them (the card tests'
    last-tile rule, which the grouping must keep)."""
    rng = np.random.default_rng(5)
    n, r, m = 9, 72, 1024
    phi = torch.from_numpy(rng.standard_normal((m, r)).astype(np.float32))
    slices = torch.from_numpy(rng.standard_normal((n, r, r)).astype(
        np.float32))
    la = torch.from_numpy(rng.uniform(size=m).astype(np.float32))
    lb = 1.0 - la
    for i0 in (torch.from_numpy(rng.integers(0, n - 1, m).astype(np.int32)),
               torch.full((m,), 3, dtype=torch.int32)):
        full = cell_readout_model(phi, slices, i0, la, lb)
        part = cell_readout_model(phi[:100], slices, i0[:100], la[:100],
                                  lb[:100])
        assert torch.equal(part, full[:100])


# The Gram family's wide shapes: WIDE_MODEL_SHAPES, a zero-padded last
# k-step at n = 9, (64, 64) (within the narrow caps, P past shared
# memory) and a unit of 3 column groups.
GRAM_MODEL_SHAPES = WIDE_MODEL_SHAPES + [(9, 127), (64, 64), (100, 70)]


def _gram_operands(n, r, m, seed):
    """phi and a general (non-symmetric) P as the card tests make them
    (tests/test_torch_cuda.py::_step_operands)."""
    rng = np.random.default_rng(seed)
    phi = rng.standard_normal((m, r)).astype(np.float32)
    phi /= np.max(np.abs(phi), axis=1, keepdims=True)
    pmat = rng.standard_normal((r * r, n)).astype(np.float32)
    return torch.from_numpy(phi), torch.from_numpy(pmat)


def _gram_ratios(phi, pmat, fk):
    """fk's error against the f64 fk over twice the plain f32 version's
    plus 1e-6, relative to the largest |fk64| and to each row's own
    (the card's bar is a ratio <= 1)."""
    f64 = gram_conditional_ref(phi.double(), pmat.double())
    fkp = gram_conditional_ref(phi, pmat)
    out = []
    for scale in (f64.abs().max(), f64.abs().amax(1, keepdim=True)):
        em = float(((fk.double() - f64).abs() / scale).max())
        ep = float(((fkp.double() - f64).abs() / scale).max())
        out.append(em / (2.0 * ep + 1e-6))
    return out


@pytest.mark.parametrize("n,r", GRAM_MODEL_SHAPES)
def test_gram_wide_model_meets_the_card_rule_on_random_operands(n, r):
    """The Gram stage's arithmetic (3xTF32 products of phi with P's node
    blocks, hi.hi in four parts, the Gram epilogue in the lanes' order)
    on random operands: its fk at most twice as far from the f64 fk as
    the plain f32 version plus 1e-6, relative to the largest |fk| and to
    each row's own largest."""
    phi, pmat = _gram_operands(n, r, 256, n + r)
    for ratio in _gram_ratios(phi, pmat, gram_wide_model(phi, pmat)):
        assert ratio <= 1.0, ratio


def test_gram_wide_parts_pin_the_accumulators():
    """How many hi.hi parts the Gram stage needs, at (96, 128) (16
    k-steps): four (the kernels', the factor stage's) are the closest to
    f64; two and one lose accuracy in that order (the tensor core
    truncates each sum of a k-step into its accumulator), though on these
    operands every count meets the bar (measured 0.16, 0.21, 0.37 of it
    against the largest |fk|)."""
    phi, pmat = _gram_operands(96, 128, 256, 224)
    f64 = gram_conditional_ref(phi.double(), pmat.double())
    err = [float((gram_wide_model(phi, pmat, parts=p).double()
                  - f64).abs().max()) for p in (4, 2, 1)]
    assert err[0] < err[1] < err[2], err
    assert max(_gram_ratios(phi, pmat, gram_wide_model(phi, pmat))) <= 1.0


def _update_operands(n, r, m, seed):
    """A normal prefix and core, cells in [0, n-2] and weights la, lb =
    1 - la, as the whole transform's CDF gives them."""
    rng = np.random.default_rng(seed)
    phi = rng.standard_normal((m, r)).astype(np.float32)
    phi /= np.max(np.abs(phi), axis=1, keepdims=True)
    cmat = rng.standard_normal((n, r * r)).astype(np.float32)
    i0 = rng.integers(0, n - 1, m).astype(np.int32)
    la = rng.uniform(size=m).astype(np.float32)
    lb = (1.0 - la).astype(np.float32)
    return tuple(torch.from_numpy(a) for a in (phi, cmat, i0, la, lb))


@pytest.mark.parametrize("n,r", GRAM_MODEL_SHAPES)
def test_dense_update_model_meets_the_card_rule(n, r):
    """The whole transform's dense-weighted prefix update (hi.hi in one
    part, the blend after the products) on random operands: phi' at most
    twice as far from condition_update_ref run in f64 as the plain f32
    version plus 1e-6 (phi' is max-normalised: each row's largest is 1),
    and with two parts too."""
    phi, cmat, i0, la, lb = _update_operands(n, r, 256, n * r + 1)
    model = dense_update_model(phi, i0, la, lb, cmat)
    p64 = condition_update_ref(phi.double(), i0, la.double(), lb.double(),
                               cmat.double())
    pr = condition_update_ref(phi, i0, la, lb, cmat)
    ek = (model.double() - p64).abs().amax(1)
    ep = (pr.double() - p64).abs().amax(1)
    assert float(ek.max()) <= 2.0 * float(ep.max()) + 1e-6
    for parts in (2, 1):
        m1 = dense_update_model(phi, i0, la, lb, cmat, parts=parts)
        assert float((m1.double() - p64).abs().max()) <= \
            2.0 * float(ep.max()) + 1e-6, parts


def test_dense_update_equals_the_cell_grouping():
    """A zero weight adds an exact zero: the dense-weighted update over
    every node equals the cell-grouped form (each row times its two
    slices only, kernel 3's wide tier's arithmetic at the same parts)
    bit for bit, so a row's phi' is its own whatever cells its tile's
    other rows touch; also with every row in one cell and in the two
    end cells."""
    n, r, m = 9, 72, 512
    phi, cmat, i0, la, lb = _update_operands(n, r, m, 11)
    slices = cmat.reshape(n, r, r)
    for cells in (i0, torch.full_like(i0, 3), torch.zeros_like(i0),
                  torch.full_like(i0, n - 2)):
        dense = dense_update_model(phi, cells, la, lb, cmat)
        assert torch.equal(dense, cell_readout_model(phi, slices, cells, la,
                                                     lb, parts=1))
        assert torch.equal(dense_update_model(phi[:100], cells[:100],
                                              la[:100], lb[:100], cmat),
                           dense[:100])


@pytest.fixture(scope="module")
def lz20():
    """The last level of lz20_ck as DirtSampler prepares it at 'f32', and
    2^10 rows of seeds (tests/test_torch_gram_design.py's fixture)."""
    import tt_irt_tpu_torch as tp
    from tt_irt_tpu_torch.samplers.dirt import _prepare_level_preps

    dirt = tp.load_dirt(os.path.join(DATA, "lz20_ck"), device="cpu")
    p32 = _prepare_level_preps(dirt, "f32")[-1]
    q = torch.from_numpy(np.random.default_rng(6).uniform(
        size=(1 << 10, dirt.d)))
    return p32, q


def test_gram_wide_models_meet_the_card_rule_on_lz20(lz20):
    """lz20_ck's own Gram fields and cores at every dimension of its last
    level, on the carry the plain f32 chain reaches there from 2^10
    seeds: the Gram stage's fk (largest |fk| and row by row) and the
    dense-weighted update's phi' (on the CDF's own cells and weights)
    each at most twice as far from their f64 versions as the plain f32
    versions plus 1e-6."""
    from tt_irt_tpu_torch.samplers.irt_scan import _cdf_invert

    p32, q = lz20
    d, rr, _ = p32.pmat.shape
    r = int(round(rr ** 0.5))
    qs = q.float().T.contiguous()
    phi = torch.zeros((q.shape[0], r), dtype=torch.float32)
    phi[:, 0] = 1.0
    for k in range(d):
        pmat, cmat = p32.pmat[k], p32.cmat[k]
        for ratio in _gram_ratios(phi, pmat, gram_wide_model(phi, pmat)):
            assert ratio <= 1.0, (k, ratio)
        fk = gram_conditional_ref(phi, pmat)
        _, _, la, lb, i0 = _cdf_invert("sqr", fk, p32.xs[k], p32.hs[k],
                                       qs[k])
        model = dense_update_model(phi, i0, la, lb, cmat)
        p64 = condition_update_ref(phi.double(), i0, la.double(),
                                   lb.double(), cmat.double())
        phi = condition_update_ref(phi, i0, la, lb, cmat)
        ek = float((model.double() - p64).abs().max())
        ep = float((phi.double() - p64).abs().max())
        assert ek <= 2.0 * ep + 1e-6, (k, ek, ep)


@pytest.fixture(scope="module")
def lz40():
    """The last level of lz40n33_ck as DirtSampler prepares it at 'hi',
    and 2^12 rows of seeds."""
    import tt_irt_tpu_torch as tp
    from tt_irt_tpu_torch.samplers.dirt import _prepare_level_preps

    dirt = tp.load_dirt(os.path.join(DATA, "lz40n33_ck"), device="cpu")
    prep = _prepare_level_preps(dirt, "hi")[-1]
    q = torch.from_numpy(np.random.default_rng(4).uniform(
        size=(1 << 12, dirt.d)))
    return prep, q


@pytest.mark.parametrize("k", [0, 20, 39])
def test_model_meets_the_card_rule_on_lz40n33(lz40, k):
    """lz40n33_ck's own factor at dimensions 0, 20 and 39 of its last
    level, on the carry the plain f32 chain reaches there from 2^12
    seeds."""
    prep, q = lz40
    r = prep.bmat.shape[1]
    qs = q.T.contiguous()
    phi = torch.zeros((q.shape[0], r), dtype=torch.float32)
    phi[:, 0] = 1.0
    for j in range(k):
        phi, _ = dim_step_ref(phi, qs[j].float(), (1.0 - qs[j]).float(),
                              prep.bmat[j], prep.cmat[j], prep.hrow[j],
                              prep.xg[j])
    em, ep = _errors(phi, prep.bmat[k])
    assert em <= 2.0 * ep + 1e-6, (em, ep)


def _model_step(phi, qp32, um32, bmat, cmat, hrow, xg, mode="irt"):
    """dim_step_ref with the modelled conditional, and f1 or f2 (and with
    them the cell weight) from the f32 chain where the kernel recomputes
    them."""
    m, r = phi.shape
    fk = tc_conditional_model(phi, bmat)
    out9, i0, _ = cdf_rows32(mode, fk, xg[0], xg[1], hrow, qp32, um32)
    flat = torch.sum(0.5 * (fk[:, :-1] + fk[:, 1:]) * hrow, dim=1) <= 0.0
    tiny = RECOMPUTE * fk.amax(1)
    # the chain at the bracket's two nodes, the only ones read
    fkp = chain_fk(phi, bmat, torch.stack([i0, i0 + 1], dim=1))
    for col in (2, 3):
        redo = ~flat & (out9[:, col] < tiny)
        out9[:, col] = torch.where(redo, fkp[:, col - 2], out9[:, col])
    c1, cr2, f1, f2, x1, _, x2, _, tot = out9.unbind(1)
    if mode == "rt":
        xk = qp32
    else:
        xl = invert_quadratic(f1, f2, c1, qp32 * tot, x1, x2)
        xr = -invert_quadratic(f2, f1, cr2, um32 * tot, -x2, -x1)
        xk = torch.where(qp32 > 0.5, xr, xl)
    la = torch.clamp((x2 - xk) / (x2 - x1), 0.0, 1.0)
    b = la[:, None] * cmat[i0] + (1.0 - la)[:, None] * cmat[i0 + 1]
    phin = torch.bmm(phi[:, None, :], b.reshape(m, r, r))[:, 0, :]
    scale = torch.amax(torch.abs(phin), dim=1, keepdim=True)
    return phin / torch.clamp(scale, min=1e-30), out9


def _plain64(phi, qp32, um32, bmat, cmat, hrow, xg, mode="irt"):
    return dim_step_ref(*(t.double() for t in (phi, qp32, um32, bmat, cmat,
                                               hrow, xg)), mode=mode)


def test_model_level_meets_the_card_rule_on_lz40n33(lz40):
    """The whole last level on 2^12 seeds with the modelled conditional
    and the plain CDF and prefix update: samples and log-density, at the
    maximum and the 99th percentile over rows, at most twice as far from
    the f64 plain chain as the plain f32 chain plus 1e-6 (the rule of
    chip_smoke.py's level checks)."""
    from tt_irt_tpu_torch.samplers.irt_scan import _fwd

    prep, q = lz40
    runs = {name: _fwd("sqr", prep, q, step=st) for name, st in (
        ("model", _model_step), ("plain", dim_step_ref), ("f64", _plain64))}
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


def _lz40_carry(lz40, k):
    """The plain f32 chain's carry at dimension k of the lz40 fixture's
    level, and the level."""
    prep, q = lz40
    qs = q.T.contiguous()
    phi = torch.zeros((q.shape[0], prep.bmat.shape[1]), dtype=torch.float32)
    phi[:, 0] = 1.0
    for j in range(k):
        phi, _ = dim_step_ref(phi, qs[j].float(), (1.0 - qs[j]).float(),
                              prep.bmat[j], prep.cmat[j], prep.hrow[j],
                              prep.xg[j])
    return phi, prep, qs


@pytest.mark.parametrize("k", [0, 20, 39])
def test_recompute_model_meets_the_row_rule_on_lz40n33(lz40, k):
    """factor_conditional's rule on lz40n33_ck's own factor (the last
    level, dimensions 0, 20, 39, on the plain chain's carry from 2^12
    seeds): its fk at most twice as far from the f64 fk as the plain
    f32 version plus 1e-6, relative to each row's own largest fk (the
    card's fk_row_2x) and to the largest fk of all (fk_2x).  5-9% of the
    nodes are below 2^-8 of their row's largest there."""
    phi, prep, _ = _lz40_carry(lz40, k)
    bmat = prep.bmat[k]
    f64 = factor_conditional_ref(phi.double(), bmat.double())
    fk = factor_conditional_model(phi, bmat)
    fkp = factor_conditional_ref(phi, bmat)
    tc = tc_conditional_model(phi, bmat)
    share = float((tc < RECOMPUTE * tc.amax(1, keepdim=True)).double()
                  .mean())
    assert 0.03 < share < 0.12, share
    for scale in (f64.amax(1, keepdim=True), f64.max()):
        em = float(((fk.double() - f64).abs() / scale).max())
        ep = float(((fkp.double() - f64).abs() / scale).max())
        assert em <= 2.0 * ep + 1e-6, (em, ep)


@pytest.mark.parametrize("mode", ["irt", "rt"])
def test_recompute_model_ties_to_the_bracket_on_lz40n33(lz40, mode):
    """At dimension 20 of lz40n33_ck's last level, factor_conditional's
    modelled fk at the bracket nodes of the modelled dim_step equals its
    f1 and f2 bit for bit on every row with mass: both recompute a node
    below 2^-8 of the row's largest tensor-core fk, in the same chain,
    and keep the tensor-core value elsewhere."""
    phi, prep, qs = _lz40_carry(lz40, 20)
    k = 20
    q = qs[k].float() if mode == "irt" else \
        prep.xg[k][0][torch.randint(0, prep.xg.shape[2], (qs.shape[1],),
                                    generator=torch.Generator().manual_seed(
                                        0))]
    _, out9 = _model_step(phi, q, (1.0 - qs[k]).float(), prep.bmat[k],
                          prep.cmat[k], prep.hrow[k], prep.xg[k], mode=mode)
    fk = factor_conditional_model(phi, prep.bmat[k])
    i0 = torch.searchsorted(prep.xg[k][0].contiguous(),
                            out9[:, 4].contiguous())
    assert torch.equal(prep.xg[k][0][i0], out9[:, 4])
    live = ~((out9[:, 2] == 1.0) & (out9[:, 3] == 1.0))
    assert float(live.double().mean()) > 0.99
    rows = torch.arange(phi.shape[0])
    recomputed = fk[rows, i0] != tc_conditional_model(phi, prep.bmat[k])[
        rows, i0]
    assert bool(recomputed.any())
    assert torch.equal(fk[rows, i0][live], out9[:, 2][live])
    assert torch.equal(fk[rows, i0 + 1][live], out9[:, 3][live])
