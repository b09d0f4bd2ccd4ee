"""Gradient fine-tuning of a DIRT pushforward (counterpart of
``tt_irt_tpu/constructors/finetune.py``).

The transform is differentiable end to end in the TT cores at 'f64' (the
QR of the stable backward marginalisation keeps its 1e-14 I rows, which
keep its backward finite at padded ranks; samplers/irt_scan.py), so a
cross-built stack can be trained like a normalising flow at fixed ranks:

* 'reverse' minimises KL(T_# rho || pi) by the reparametrised surrogate
  mean(lfapp - lpfun(z)), z = T(q);
* 'forward' minimises KL(pi || T_# rho) by self-normalised importance
  weighting: z from the current map without gradient, weights
  softmax(lpfun(z) - lfapp), and the weighted pushforward log-likelihood
  through ``tt_dirt_inverse``.

Like the JAX package's, this runs the plain 'f64' path and no kernel:
the Pallas kernels have no backward there either.  ``torch.optim.Adam``
(b1 0.9, b2 0.999, eps 1e-8 outside the square root, as ``optax.adam``)
takes the place of optax, and a ``torch.Generator`` on the device that
of the JAX keys.  Debiasing stays exact whatever the tuning does.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.tt import TT
from ..parallel.mesh import check_mesh, sharded_rows
from ..samplers.dirt import DIRT, tt_dirt_inverse, tt_dirt_sample
from ..utils.device import resolve_device

__all__ = ["dirt_finetune"]


def _rebuild(dirt: DIRT, f0_cores, fs_cores) -> DIRT:
    return DIRT(TT(list(f0_cores)), [TT(list(c)) for c in fs_cores],
                dirt.x0, dirt.x, dirt.beta, dirt.lfshift,
                reference=dirt.reference, interpolation=dirt.interpolation,
                evalcnt=dirt.evalcnt, history=dirt.history)


def finetune_loss(stack: DIRT, lpfun, q, objective: str = "reverse",
                  mesh=None):
    """The fine-tuning objective of ``stack`` on the seeds q (M, d): a
    scalar tensor with the stack's cores in its graph.  With a ``mesh``
    the passes through the stack run a shard a mesh device, the stack
    replicated there by ``.to(device)`` (autograd carries the gradient
    back to its cores), and the loss is formed on the mesh's first
    device."""
    def run(fn, x):
        def on_rows(rows):
            return fn(stack.to(rows.device), rows, device=rows.device)

        return on_rows(x) if mesh is None else sharded_rows(mesh, on_rows, x)

    if objective == "reverse":
        z, lfapp = run(tt_dirt_sample, q)
        return torch.mean(lfapp - lpfun(z))
    with torch.no_grad():
        z, lfapp_s = run(tt_dirt_sample, q)
        w = torch.softmax(lpfun(z) - lfapp_s, dim=0)
    _, lfapp = run(tt_dirt_inverse, z)
    return -torch.sum(w * lfapp)


def dirt_finetune(dirt: DIRT, lpfun, *, steps: int = 100,
                  nsamples: int = 512, lr: float = 3e-3,
                  optimizer=None, trainable: str = "all",
                  objective: str = "reverse", mesh=None,
                  seed: int = 0, seed_margin: float = 1e-3,
                  verb: int = 0, device="cuda"):
    """Fine-tune the TT cores of ``dirt`` by stochastic KL descent.

    Args:
      dirt: a spline DIRT stack (e.g. from ``tt_dirt_approx``).
      lpfun: unnormalised log-target ``z (M, d) -> (M,)`` at beta = 1, on
        torch tensors and differentiable.
      steps: optimiser steps.
      nsamples: fresh seeds a step (the minibatch).
      lr: Adam's learning rate (ignored when ``optimizer`` is given).
      optimizer: a factory ``params -> torch.optim.Optimizer`` (params
        the list of trainable core tensors); default Adam(lr).
      trainable: 'all' (level 0 and every ratio level), 'levels' (level
        0 frozen) or 'f0' (level 0 alone).
      objective: 'reverse' (mode-seeking) or 'forward' (mass-covering,
        about twice the cost a step); module docstring.
      mesh: optional ``parallel.sample_mesh``: each step's minibatch
        runs sharded along its sample axis (finetune_loss), so the
        gradient is computed data-parallel; the losses and tuned cores
        equal the single-device run's up to the order in which the
        shards' gradients are summed.
      seed: seeds the ``torch.Generator`` of the minibatches.
      seed_margin: seeds lie in [m, 1 - m]: the CDF inversion is not
        differentiable at the box boundary.
      verb: print the loss about every steps/10 steps.
      device: where the stack is trained (default "cuda").

    Returns:
      (tuned_dirt, losses): the stack with the tuned cores (same ranks,
      grids, ladder and metadata) and the loss a step (numpy; one host
      read a step).
    """
    if dirt.interpolation not in ("spline",):
        raise NotImplementedError(
            "dirt_finetune supports spline interpolation only "
            f"(got {dirt.interpolation!r})")
    if trainable not in ("all", "levels", "f0"):
        raise ValueError(f"trainable={trainable!r}")
    if objective not in ("reverse", "forward"):
        raise ValueError(f"objective={objective!r}")
    if mesh is not None:
        check_mesh(mesh)
    dev = resolve_device(device)
    dirt = dirt.to(dev)

    def leaves(cores, train):
        return [c.detach().clone().requires_grad_(train) for c in cores]

    f0 = leaves(dirt.f0.cores, trainable in ("all", "f0"))
    fs = [leaves(f.cores, trainable in ("all", "levels")) for f in dirt.fs]
    params = [c for c in f0 + [c for cs in fs for c in cs] if c.requires_grad]
    opt = None
    if params:
        opt = (optimizer(params) if optimizer is not None
               else torch.optim.Adam(params, lr=lr))
    dtype = f0[0].dtype
    gen = torch.Generator(device=dev).manual_seed(seed)
    losses = np.empty(steps)
    for it in range(steps):
        q = seed_margin + (1.0 - 2.0 * seed_margin) * torch.rand(
            (nsamples, dirt.d), generator=gen, dtype=dtype, device=dev)
        loss = finetune_loss(_rebuild(dirt, f0, fs), lpfun, q, objective,
                             mesh)
        if opt is not None:
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
        losses[it] = float(loss.detach())
        if verb and (it % max(1, steps // 10) == 0 or it == steps - 1):
            print(f"=finetune= step {it:4d}  loss {losses[it]:+.6f}")
    tuned = _rebuild(dirt, [c.detach() for c in f0],
                     [[c.detach() for c in cs] for cs in fs])
    return tuned, losses
