"""DIRT checkpoints: the JAX package's ``.npz`` + ``.json`` format
(counterpart of ``tt_irt_tpu/utils/checkpoint.py``), and
``dirt_from_numpy`` / ``tt_from_numpy``, which carry a stack or a
single TT given as numpy arrays into the port's containers on a
device."""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..ops.tt import TT
from ..samplers.dirt import DIRT
from .device import resolve_device

__all__ = ["save_dirt", "load_dirt", "dirt_from_numpy", "tt_from_numpy"]


def tt_from_numpy(cores, device="cuda") -> TT:
    """A TT on ``device`` from numpy cores (r_{k-1}, n_k, r_k); arrays
    keep their dtype.  Tests hand the same arrays to the JAX package."""
    dev = resolve_device(device)
    return TT([torch.tensor(np.asarray(c), device=dev) for c in cores])


def dirt_from_numpy(f0_cores, level_cores, x0, x, beta, lfshift=0.0,
                    reference="uniform", interpolation="spline",
                    device="cuda", evalcnt=None, fprev_cores=None,
                    history=None) -> DIRT:
    """Build the port's DIRT from numpy leaves: level-0 cores, a list
    of per-level core lists, grids ``x0``/``x``, the beta ladder and the
    header fields.  Arrays keep their dtype (f64 cores stay f64)."""
    dev = resolve_device(device)

    def tt(cores):
        return tt_from_numpy(cores, dev)

    def vecs(gs):
        return [torch.tensor(np.asarray(g), device=dev) for g in gs]

    return DIRT(tt(f0_cores), [tt(cs) for cs in level_cores], vecs(x0),
                vecs(x), torch.tensor(np.asarray(beta), device=dev),
                float(np.asarray(lfshift)), reference=reference,
                interpolation=interpolation,
                evalcnt=(np.asarray(evalcnt, np.int64)
                         if evalcnt is not None else None),
                fprev=tt(fprev_cores) if fprev_cores else None,
                history=history)


def save_dirt(path: str, dirt: DIRT) -> None:
    """Serialize a DIRT stack to ``path`` (.npz + .json header)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)

    def host(t):
        return t.detach().cpu().numpy()

    arrays = {}
    for i, c in enumerate(dirt.f0.cores):
        arrays[f"f0_{i}"] = host(c)
    for lvl, f in enumerate(dirt.fs):
        for i, c in enumerate(f.cores):
            arrays[f"lvl{lvl}_{i}"] = host(c)
    for i, g in enumerate(dirt.x0):
        arrays[f"x0_{i}"] = host(g)
    for i, g in enumerate(dirt.x):
        arrays[f"x_{i}"] = host(g)
    arrays["beta"] = host(dirt.beta)
    arrays["evalcnt"] = np.asarray(dirt.evalcnt)
    fprev_dims = 0
    if dirt.fprev is not None:
        fprev_dims = dirt.fprev.d
        for i, c in enumerate(dirt.fprev.cores):
            arrays[f"fprev_{i}"] = host(c)
    header = {
        "d": dirt.d,
        "nlevels": dirt.nlevels,
        "level_dims": [f.d for f in dirt.fs],
        "lfshift": float(np.asarray(dirt.lfshift)),
        "reference": str(dirt.reference),
        "interpolation": str(dirt.interpolation),
        "n_x": len(dirt.x),
        "fprev_dims": fprev_dims,
    }
    if dirt.history:
        header["history"] = dirt.history
    np.savez_compressed(path + ".npz", **arrays)
    with open(path + ".json", "w") as fh:
        json.dump(header, fh)


def load_dirt(path: str, device="cuda") -> DIRT:
    """Restore a DIRT stack saved by either package's save_dirt onto
    ``device``."""
    with open(path + ".json") as fh:
        header = json.load(fh)
    with np.load(path + ".npz") as data:
        d = header["d"]
        fprev = [data[f"fprev_{i}"]
                 for i in range(header.get("fprev_dims", 0))]
        return dirt_from_numpy(
            [data[f"f0_{i}"] for i in range(d)],
            [[data[f"lvl{lvl}_{i}"] for i in range(dl)]
             for lvl, dl in enumerate(header["level_dims"])],
            [data[f"x0_{i}"] for i in range(d)],
            [data[f"x_{i}"] for i in range(header["n_x"])],
            data["beta"], header["lfshift"],
            reference=header["reference"],
            interpolation=header["interpolation"], device=device,
            evalcnt=data["evalcnt"], fprev_cores=fprev or None,
            history=header.get("history"))
