"""Eligibility of the whole-stack DIRT program (counterpart of
``tt_irt_tpu/samplers/dirt_scan.py``).

The JAX package pads every level TT to the stack's largest rank so that
one ``lax.scan`` over levels compiles the whole stack into one device
program (fewer dispatches through its remote TPU).  The port has no
tracing: ``tt_dirt_sample(use_fused=True)`` runs the level loop with
every level padded to the stack's largest rank (``ragged_step=0`` of
samplers/dirt.py ``_prepare_level_preps``), which is the same
computation on the same padded shapes.  This module keeps the JAX
package's eligibility test: spline interpolation, full-joint sampling,
uniform mode size, boundary ranks 1.
"""

from __future__ import annotations

from .irt import _canon_grid
from .irt_scan import can_use_scan

__all__ = ["can_fuse"]


def _canon_stack(dirt):
    """Boundary-extrapolated (tt_irt_sqr.m:56-62) grids and TTs of every
    level, as the per-level transforms see them."""
    levels = [_canon_grid(dirt.x, f) for f in dirt.fs]
    return levels, _canon_grid(dirt.x0, dirt.f0)


def can_fuse(dirt, dsample: int) -> bool:
    """True when the whole stack can run as one padded program."""
    if not str(dirt.interpolation).lower().startswith("s"):
        return False
    if dirt.nlevels < 1 or dsample != dirt.d:
        return False
    try:
        levels, (g0, f0) = _canon_stack(dirt)
    except ValueError:
        return False
    if not can_use_scan(f0, g0, dsample):
        return False
    return all(can_use_scan(f, g, dsample) for g, f in levels)
