"""The prefix update past n or r of 64, grouped by cell on the tensor
cores (``csrc/cell_readout.cu``): phi'[m] = (la[m] phi[m] S[x] + lb[m]
phi[m] S[x+1]) / max-abs, x = clip(i0[m], 0, n-2), for the slices S of
the core (``condition_update`` past its narrow tier, ``ops/step.py``) or
of the orthonormal factor Q (``odim_step``'s readout past its narrow
tier, ``ops/odim_step.py``, with lb = 1 - la).  Those modules' wrappers
launch it; this one types the library and mirrors the kernel's sort and
tile plan in plain PyTorch (``cell_plan_ref``), which the tests hold the
card's plan to (``cell_plan_cuda``).
"""

from __future__ import annotations

import ctypes

import torch

from ._build import load_library

__all__ = ["TILE_ROWS", "lib", "type_library", "cell_plan_ref",
           "cell_plan_cuda"]

# Rows of one cell a tile of the readout (two warpgroups of 64).
TILE_ROWS = 128
# Word offsets past the tile list in the plan: the cells' counts, their
# cursors, the tile count, the permutation (csrc/cell_readout.cu's Plan).
_CELL_SLOTS = 128


def type_library(out):
    """A ctypes library built from ``csrc/cell_readout.cu`` (this
    checkout's or another's), its entry points typed; returns it."""
    if not getattr(out, "_typed", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        for f in ("cell_readout_launch", "condition_update_wide_launch"):
            getattr(out, f).argtypes = [p] * 6 + [i] * 4 + [p, p]
            getattr(out, f).restype = i
        out.cell_readout_plan_launch.argtypes = [p, i, i, i, p, p]
        out.cell_readout_plan_launch.restype = i
        for f in ("cell_readout_plan_words", "cell_readout_max_tiles",
                  "cell_readout_smem_bytes"):
            getattr(out, f).argtypes = [i, i]
            getattr(out, f).restype = ll
        out.condition_update_wide_scratch_words.argtypes = [i, i, i]
        out.condition_update_wide_scratch_words.restype = ll
        out._typed = True
    return out


def lib():
    """The loaded ``csrc/cell_readout.cu`` library, typed."""
    return type_library(load_library("cell_readout"))


def cell_plan_ref(i0, n, tile_rows=TILE_ROWS):
    """Plain PyTorch version of the readout's counting sort and tile
    plan: (cell, perm, tiles) with cell (M,) the clipped cells
    clip(i0, 0, n-2), perm (M,) int64 the rows sorted by cell (stable;
    the kernel's order within a cell is whatever its atomics give), tiles
    (T, 3) int64 rows of (cell, first sorted position, rows): each
    nonempty cell's rows in tiles of ``tile_rows``, the last ragged, cells
    in order."""
    cell = torch.clamp(i0.long(), 0, n - 2)
    counts = torch.bincount(cell, minlength=n - 1)
    start = torch.cumsum(counts, 0) - counts
    ntile = (counts + tile_rows - 1) // tile_rows
    first = torch.cumsum(ntile, 0) - ntile
    tcell = torch.repeat_interleave(torch.arange(n - 1, device=cell.device),
                                    ntile)
    k = torch.arange(tcell.numel(), device=cell.device) - first[tcell]
    tiles = torch.stack([tcell, start[tcell] + k * tile_rows,
                         torch.clamp(counts[tcell] - k * tile_rows,
                                     max=tile_rows)], dim=1)
    return cell, torch.argsort(cell, stable=True), tiles


def cell_plan_cuda(i0, n):
    """The card's sort and tile plan of i0 (M,) int32 on a CUDA device
    (``cell_readout_plan_launch``, the readout's first four kernels
    alone): (perm, tiles) as ``cell_plan_ref`` gives them, perm in the
    kernel's order.  ``cell_plan_cuda.launches`` counts calls."""
    if i0.dtype != torch.int32 or i0.ndim != 1 or i0.device.type != "cuda":
        raise ValueError("cell_plan_cuda: i0 must be a CUDA int32 vector")
    i0 = i0.contiguous()
    m = i0.shape[0]
    cr = lib()
    cap = cr.cell_readout_max_tiles(m, n)
    words = torch.empty((cr.cell_readout_plan_words(m, n),),
                        dtype=torch.int32, device=i0.device)
    with torch.cuda.device(i0.device):
        stream = torch.cuda.current_stream(i0.device).cuda_stream
        err = cr.cell_readout_plan_launch(i0.data_ptr(), m, n,
                                          i0.device.index, stream,
                                          words.data_ptr())
    if err != 0:
        raise RuntimeError(f"cell_readout plan launch failed: cudaError {err}")
    cell_plan_cuda.launches += 1
    if m == 0:
        return (torch.empty((0,), dtype=torch.int64, device=i0.device),
                torch.empty((0, 3), dtype=torch.int64, device=i0.device))
    ntiles = int(words[4 * cap + 2 * _CELL_SLOTS])
    tiles = words[:4 * ntiles].view(ntiles, 4)[:, :3].long()
    base = 4 * cap + 2 * _CELL_SLOTS + 4
    return words[base:base + m].long(), tiles


cell_plan_cuda.launches = 0
