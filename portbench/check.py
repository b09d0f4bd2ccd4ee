"""The comparison that decides ``correct``.

Inside the window the harness keeps, of every call, the outputs at a
sample of rows drawn from the seed before the window opened, and the
whole outputs of the last call.  Once the window has closed and the
program's state is freed, the float64 reference works the same seeds'
rows out again and each number below is held to its limit (the
configuration's ``limits``):

* ``z_p99``: the 99th percentile over the sampled rows of the largest
  absolute gap of a row's sample coordinates to the reference's;
* ``lfapp_p99``: the 99th percentile of the gap of the map's
  log-density;
* ``rows_over_pct``: the share of the sampled rows, in percent, whose
  sample gap is over ``z_p99``'s limit or whose log-density gap is over
  ``lfapp_p99``'s: the p99s leave 1% of the rows unheld, and this holds
  them, so that a fault confined to a few row tiles shows;
* ``logpost_max`` (weighted mixes): the largest gap of the program's
  log-posterior at its own samples to the reference's at those
  samples, over max(1, |reference|), the reference being the
  configuration's model's (``reference/<model>.py``);
* ``logw_max`` (weighted mixes): the largest gap, over every row of the
  last call, of the program's log-weight log(weighted / lp) to the
  reference's log(exp(lp - lfapp) / mean), both at the program's
  samples and map density.

A row that is not finite counts as an infinite gap.  The percentiles
leave room for the rare rows whose float32 chain lands far from float64
(the 'hi' and 'f32' precisions do so on a few rows in 10^4); a fault
that moves many rows, or every row a little, moves them, and one that
moves a few rows far moves ``rows_over_pct``.
"""

from __future__ import annotations

import os

import torch

from . import discover
from .loop import percentile
from .reference import dirt as ref_dirt
from .reference.weights import log_weights


def _gaps(a, b):
    gap = (a - b).abs()
    if gap.ndim == 2:
        gap = gap.amax(dim=1)
    return torch.nan_to_num(gap, nan=float("inf")).cpu().tolist()


def over_pct(z_gaps: list, lf_gaps: list, z_limit: float,
             lf_limit: float) -> float:
    """The percentage of rows whose sample gap is over ``z_limit`` or
    whose log-density gap is over ``lf_limit``."""
    over = sum(1 for a, b in zip(z_gaps, lf_gaps)
               if a > z_limit or b > lf_limit)
    return 100.0 * over / len(z_gaps)


def numbers(root: str, config: dict, sampled: dict, last: dict | None,
            device) -> dict:
    """The compared numbers.  ``sampled`` holds the seeds ("q") and the
    program's outputs at the sampled rows, ``last`` the whole outputs
    of the last call (weighted mixes only), all on ``device``."""
    stack = ref_dirt.load_stack(os.path.join(root, config["checkpoint"]))
    push = ref_dirt.Pushforward(stack, ref_dirt.F64, device)
    z_ref, lf_ref = push(sampled["q"])
    z_gaps, lf_gaps = _gaps(sampled["z"], z_ref), _gaps(sampled["lfapp"],
                                                        lf_ref)
    limits = config["limits"]
    out = {"z_p99": percentile(z_gaps, 99),
           "lfapp_p99": percentile(lf_gaps, 99),
           "rows_over_pct": over_pct(z_gaps, lf_gaps, limits["z_p99"],
                                     limits["lfapp_p99"])}
    if "lp" in sampled:
        logpost = discover.model_reference(config["problem"]["model"])(
            root, config, device)
        lp_ref = logpost(sampled["z"])
        rel = (sampled["lp"] - lp_ref).abs() / torch.clamp(lp_ref.abs(),
                                                           min=1.0)
        out["logpost_max"] = max(_gaps(rel, torch.zeros_like(rel)))
        logw_ref = log_weights(logpost(last["z"]), last["lfapp"])
        logw = torch.log(last["weighted"] / last["lp"])
        out["logw_max"] = max(_gaps(logw, logw_ref))
    return out


def verdict(values: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}): every number at or below
    its limit."""
    table = {k: {"value": v, "limit": limits[k]} for k, v in values.items()}
    return all(v <= limits[k] for k, v in values.items()), table
