"""Data-parallel sample transport over several devices of one process.

Counterpart of ``tt_irt_tpu/parallel/mesh.py``.  The reference's only
concurrency is a single-node ``parfor`` over sample blocks
(tt_irt_fourier.m:144-158); the JAX package shards the sample axis over
a 1-D device mesh from one controlling process.  So does this module:

- a mesh is an ordered tuple of torch devices (``sample_mesh``); the
  same device may appear more than once, and its shards then run one
  after another on it (so a CPU test can mirror eight virtual devices,
  and one card can run four shards);
- the sample axis is cut into contiguous shards, one a mesh entry
  (``shard_samples``); TT cores and DIRT stacks are replicated by
  ``.to(device)`` (``replicate``), so that autograd carries gradients
  back from every shard to the caller's tensors;
- each shard runs on its own device and the results are concatenated on
  the mesh's first device (``sharded_call``, ``sharded_batch_fn``).

The host loops of the constructors (cross sweeps, the tempering ladder,
fine-tuning's optimizer) run once in the caller's process and only their
probe batches fan out, as in the JAX package.  Shards are run one after
another from the calling thread.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..utils.device import resolve_device

__all__ = ["sample_mesh", "shard_samples", "sharded_call", "replicate",
           "sharded_batch_fn", "sharded_rows", "canonical", "check_mesh"]


def sample_mesh(n_devices: int | None = None, devices=None) -> tuple:
    """1-D mesh over the given devices (names or ``torch.device``), or
    over every CUDA device; the first ``n_devices`` of them if given.
    Asking for CUDA without a card raises, as ``device="cuda"`` does
    everywhere in the port."""
    if devices is None:
        if not torch.cuda.is_available():
            resolve_device("cuda")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [canonical(resolve_device(d)) for d in devices]
    if n_devices is not None:
        devices = devices[:n_devices]
    if not devices:
        raise ValueError("sample_mesh: no devices")
    return tuple(devices)


def canonical(device) -> torch.device:
    """``device`` as a tensor on it reports it: a CUDA device without an
    index gets the current one."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def check_mesh(mesh) -> tuple:
    """``mesh`` itself if it is a sample mesh; raises TypeError if not."""
    if not (isinstance(mesh, tuple) and mesh
            and all(isinstance(d, torch.device) for d in mesh)):
        raise TypeError(f"not a sample mesh (a tuple of torch devices from "
                        f"sample_mesh): {type(mesh).__name__}")
    return mesh


def _to(tree, device):
    """A copy of ``tree`` on ``device``: tensors and objects with
    ``.to`` (TT, DIRT) moved, numpy arrays made tensors, lists, tuples
    and dicts walked; anything else as it is."""
    if torch.is_tensor(tree) or hasattr(tree, "to"):
        return tree.to(device)
    if isinstance(tree, np.ndarray):
        return torch.as_tensor(tree, device=device)
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(t, device) for t in tree)
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree


def shard_samples(mesh, x) -> list:
    """An (M, ...) array cut into contiguous shards along its leading
    (sample) axis, shard k on ``mesh[k]`` (torch.tensor_split's sizes:
    the first M % len(mesh) shards one row longer)."""
    mesh = check_mesh(mesh)
    x = torch.as_tensor(x)
    return [s.to(dev) for s, dev in zip(torch.tensor_split(x, len(mesh)),
                                        mesh)]


def replicate(mesh, tree) -> list:
    """One copy of ``tree`` (a tensor, a TT, a DIRT stack, or lists,
    tuples and dicts of them) on each mesh entry, by ``.to(device)``."""
    return [_to(tree, dev) for dev in check_mesh(mesh)]


def _concat(outs, device):
    """Per-shard outputs (tensors, or tuples / lists of them) joined
    along axis 0 on ``device``."""
    first = outs[0]
    if isinstance(first, (list, tuple)):
        return type(first)(_concat([o[i] for o in outs], device)
                           for i in range(len(first)))
    return torch.cat([torch.as_tensor(o).to(device) for o in outs], dim=0)


def sharded_call(mesh, fn: Callable, *args, sample_args=(0,),
                 rowwise: bool = True):
    """``fn(*args)`` with the positional args listed in ``sample_args``
    sharded along axis 0 and the rest replicated.

    ``rowwise=True`` (fn is elementwise over samples): each shard runs
    on its own device and the outputs (tensors, or tuples of them) are
    concatenated along axis 0 on the mesh's first device.
    ``rowwise=False`` (fn reduces over samples, e.g. ``essinv``): fn runs
    once, on the mesh's first device, with the whole arrays there, so its
    value is the unsharded one.  (The JAX package leaves this choice to
    its compiler's output shardings.)"""
    mesh = check_mesh(mesh)
    if not rowwise:
        return fn(*_to(list(args), mesh[0]))
    per_arg = [shard_samples(mesh, a) if i in sample_args
               else replicate(mesh, a) for i, a in enumerate(args)]
    outs = []
    for k in range(len(mesh)):
        shard = [p[k] for p in per_arg]
        if any(shard[i].shape[0] == 0 for i in sample_args):
            continue
        outs.append(fn(*shard))
    return _concat(outs, mesh[0])


def sharded_rows(mesh, fn: Callable, x):
    """fn over the rows of x (M, ...) shard by shard, x padded to a
    multiple of the mesh size by repeating its first row (the pad rows'
    results are dropped): the outputs joined on the mesh's first device
    as tensors, autograd graphs intact."""
    mesh = check_mesh(mesh)
    x = torch.as_tensor(x)
    m, k = x.shape[0], len(mesh)
    mpad = -(-m // k) * k
    if mpad != m:
        x = torch.cat([x, x[:1].expand((mpad - m,) + x.shape[1:])], dim=0)
    outs = [fn(s.to(dev)) for s, dev in zip(x.split(mpad // k), mesh)]
    out = _concat(outs, mesh[0])
    if isinstance(out, (list, tuple)):
        return type(out)(o[:m] for o in out)
    return out[:m]


def sharded_batch_fn(mesh, fn: Callable) -> Callable:
    """Wrap a batch function ``fn((M, ...)) -> (M,) or (M, k)`` on torch
    tensors so every call runs with its leading (sample) axis sharded
    over the mesh: the probe batches that the TT-cross feeds to the user
    density (amen_cross_s.m:704-760) and the DIRT ratio pushes
    (tt_dirt_approx.m:463-479) fan out over the devices.  Each shard is
    handed to ``fn`` as a tensor on its device; M is padded to a
    multiple of the mesh size by repeating the first row (sharded_rows),
    so any batch size works.  Returns host numpy, as the JAX package's
    does."""
    check_mesh(mesh)

    def wrapped(x):
        out = sharded_rows(mesh, fn, x)
        if isinstance(out, (list, tuple)):
            return type(out)(o.detach().cpu().numpy() for o in out)
        return out.detach().cpu().numpy()

    return wrapped
