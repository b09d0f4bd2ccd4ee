"""The cell-grouped readout's plan and function on the CPU: the plain
PyTorch mirror of its counting sort and tile plan
(tt_irt_tpu_torch/ops/cell_readout.py::cell_plan_ref, the plan the card
tests hold the kernel's to), and condition_update's plain version at the
shapes of its wide tier (n or r past 64, where csrc/cell_readout.cu runs
it on the card) against the JAX package's Pallas kernel
(ops/pallas_step.py, interpret mode on the CPU) on the same numpy-made
operands."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tt_irt_tpu.ops.pallas_step import condition_update
from tt_irt_tpu_torch.ops.cell_readout import TILE_ROWS, cell_plan_ref
from tt_irt_tpu_torch.ops.step import condition_update_ref


def _cells(kind, m, n, rng):
    """i0 of m rows on n nodes: spread, all in one cell, only the two end
    cells, cells of exactly 63, 64 and 65 rows beside a spread rest, or
    outside [0, n-2] on both sides."""
    if kind == "uniform":
        return rng.integers(0, n - 1, m)
    if kind == "one_cell":
        return np.full(m, (n - 1) // 2)
    if kind == "ends":
        return np.where(rng.uniform(size=m) < 0.5, 0, n - 2)
    if kind == "63_64_65":
        rest = rng.integers(min(3, n - 2), n - 1, m - 192)
        return rng.permutation(np.concatenate(
            [np.full(63, 0), np.full(64, min(1, n - 2)),
             np.full(65, min(2, n - 2)), rest]))
    return rng.integers(-3 * n, 4 * n, m)


@pytest.mark.parametrize("kind,m", [
    (kind, m) for kind in ("uniform", "one_cell", "ends", "outside")
    for m in (1, 300, 4096 + 7)] + [("63_64_65", 300), ("63_64_65", 4103)])
@pytest.mark.parametrize("n", [2, 9, 33, 128])
def test_cell_plan_covers_every_row_once(kind, m, n):
    """Every row in exactly one tile, each tile rows of one (clipped)
    cell, 1..128 rows a tile, the cells' tiles in cell order and only the
    last of a cell ragged, empty cells without a tile, and at most
    ceil(m / 128) + n - 1 tiles (the kernel's scratch) whatever the
    skew."""
    rng = np.random.default_rng(m + n)
    i0 = torch.from_numpy(_cells(kind, m, n, rng).astype(np.int32))
    cell, perm, tiles = cell_plan_ref(i0, n)
    assert torch.equal(cell, torch.clamp(i0.long(), 0, n - 2))
    assert torch.equal(torch.sort(perm).values, torch.arange(m))
    counts = torch.bincount(cell, minlength=n - 1)
    assert tiles.shape[0] == int(((counts + TILE_ROWS - 1)
                                  // TILE_ROWS).sum())
    assert tiles.shape[0] <= -(-m // TILE_ROWS) + n - 1
    seen = torch.zeros(m, dtype=torch.long)
    pos = 0
    for x, first, rows in tiles.tolist():
        assert first == pos and 1 <= rows <= TILE_ROWS
        assert bool((cell[perm[first:first + rows]] == x).all())
        seen[perm[first:first + rows]] += 1
        pos += rows
    assert bool((seen == 1).all())
    assert sorted(set(tiles[:, 0].tolist())) == \
        torch.nonzero(counts)[:, 0].tolist()
    for x in torch.nonzero(counts)[:, 0].tolist():
        sizes = tiles[tiles[:, 0] == x, 2].tolist()
        assert sizes[:-1] == [TILE_ROWS] * (len(sizes) - 1)
        assert sum(sizes) == int(counts[x])


# Kernel 3's wide tier: r past 64 at a short grid, n past 64 at rank 33,
# both (rank 65 on 66 nodes), lb free or 1 - la.
WIDE_CASES = [(128, 72, 9, False), (96, 33, 96, True), (64, 65, 66, False)]


@pytest.mark.parametrize("m,r,n,free_lb", WIDE_CASES)
def test_condition_update_ref_matches_jax_kernel_wide(m, r, n, free_lb):
    """1e-5 absolute on the max-normalised prefix (the JAX test's bar),
    with half the rows at i0 = n - 2, at shapes the card serves through
    the cell-grouped readout."""
    rng = np.random.default_rng(m + r + n)
    phi = rng.standard_normal((m, r)).astype(np.float32)
    cmat = rng.standard_normal((n, r * r)).astype(np.float32)
    i0 = rng.integers(0, n - 1, size=m).astype(np.int32)
    i0[: m // 2] = n - 2
    la = rng.uniform(size=m).astype(np.float32)
    lb = (rng.uniform(size=m).astype(np.float32) if free_lb
          else (1.0 - la).astype(np.float32))
    pj = np.asarray(condition_update(
        jnp.asarray(phi), jnp.asarray(i0), jnp.asarray(la), jnp.asarray(lb),
        jnp.asarray(cmat)))
    pt = condition_update_ref(*(torch.from_numpy(a) for a in
                                (phi, i0, la, lb, cmat))).numpy()
    c64 = cmat.astype(np.float64).reshape(n, r, r)
    ref = np.einsum("mi,mij->mj", phi.astype(np.float64),
                    la[:, None, None] * c64[i0]
                    + lb[:, None, None] * c64[i0 + 1])
    ref = ref / np.maximum(np.max(np.abs(ref), axis=1, keepdims=True), 1e-30)
    assert np.max(np.abs(pt - pj)) < 1e-5
    assert np.max(np.abs(pt - ref)) < 1e-5
