"""The system under test, built from a configuration and a traffic mix:
the program (``tt_irt_tpu_torch``) as users call it, or, for the
control, the plain reference put in its place.

A system is ``call(q) -> outputs``: seeds q (rows, d) in, a dict of
tensors out ("z", "lfapp" and, where the traffic weighs the samples,
"lp" and "weighted").  The harness's spans name the calls into each
layer: "serve" (DirtSampler.sample), "logpost" (the exact
log-posterior) and "iw" (iw_prune).
"""

from __future__ import annotations

import os

import torch
from torch.profiler import record_function

from . import discover
from .reference import dirt as ref_dirt
from .reference.weights import log_weights


def program(root: str, config: dict, traffic: dict, device):
    """The port serving the configuration's checkpoint as the traffic
    asks: DirtSampler at the configuration's precision and the mix's
    block, then, for a weighted mix, the log-posterior of the
    configuration's model (``models/<model>.py``) and iw_prune."""
    import tt_irt_tpu_torch as tp

    serve = config["serve"]
    dirt = tp.load_dirt(os.path.join(root, config["checkpoint"]),
                        device=device)
    sampler = tp.DirtSampler(dirt, precision=serve["precision"],
                             hi_step=serve.get("hi_step", "dim"),
                             block=traffic.get("block"), device=device)
    logpost = None
    if traffic.get("weighted"):
        logpost = discover.model(config["problem"]["model"])(root, config,
                                                             device)

    def call(q):
        with record_function("serve"):
            z, lfapp = sampler(q)
        out = {"z": z, "lfapp": lfapp}
        if logpost is not None:
            with record_function("logpost"):
                lp = logpost(z)
            with record_function("iw"):
                res = tp.iw_prune(lp, lfapp)
            out.update(lp=lp, weighted=res.lfex)
        return out

    return call


def control(root: str, config: dict, traffic: dict, device):
    """The reference in the program's place at the configuration's
    control precision (the nearest below the one it states): the
    pushforward, and for a weighted mix the log-posterior and the
    weights, in the same form as the program's outputs."""
    spec = config["control"]
    prec = ref_dirt.precision_from(spec)
    push = ref_dirt.Pushforward(
        ref_dirt.load_stack(os.path.join(root, config["checkpoint"])),
        prec, device)
    logpost = None
    if traffic.get("weighted"):
        logpost = discover.model_reference(config["problem"]["model"])(
            root, config, device, getattr(torch, spec.get("logpost", "float64")))

    def call(q):
        with record_function("serve"):
            z, lfapp = push(q)
        out = {"z": z, "lfapp": lfapp}
        if logpost is not None:
            with record_function("logpost"):
                lp = logpost(z)
            with record_function("iw"):
                w = torch.exp(log_weights(lp, lfapp.to(lp.dtype)))
            out.update(lp=lp.to(torch.float64),
                       weighted=(lp * w).to(torch.float64))
        return out

    return call
