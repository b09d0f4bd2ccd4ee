"""The program's side of the Lorenz-96 initial-state posterior
(``problem.model`` "lorenz96"): the port's ``LorenzProblem`` on the
configuration's base state, data, noise and steps.  Its reference is
``reference/lorenz96.py``, found by the same name."""

from __future__ import annotations

from portbench.reference.lorenz96 import arrays


def log_posterior_fn(root: str, config: dict, device):
    """The program's log-posterior z -> lp."""
    import tt_irt_tpu_torch as tp

    prob = config["problem"]
    base, data = arrays(root, config)
    return tp.LorenzProblem(d=config["d"], x0true=base, data=data,
                            sigma_n=prob["sigma_n"],
                            steps=prob["steps"]).log_posterior_fn()
