"""Finds the benchmark's pieces by the names in ``BENCHMARK.json``:
``configs/<config>.json``, ``traffic/<mix>.json``,
``metrics/<metric>.py`` (a ``read(run)`` function),
``work/<kernel>.py`` (a ``work(rows, n, r)`` function), and for a
configuration's ``problem.model`` ``models/<model>.py`` (the program's
``log_posterior_fn(root, config, device)``) and
``reference/<model>.py`` (the reference's, with a ``dtype``).  A later
cell, mix, metric, kernel or model is a new file, found by its name."""

from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        return json.load(fh)


def _json(kind: str, name: str) -> dict:
    with open(os.path.join(HERE, kind, name + ".json")) as fh:
        return json.load(fh)


def config(name: str) -> dict:
    return _json("configs", name)


def traffic(name: str) -> dict:
    return _json("traffic", name)


def _function(kind: str, name: str, attr: str):
    path = os.path.join(HERE, kind, name + ".py")
    if not os.path.isfile(path):
        raise KeyError(f"no {kind}/{name}.py: {name!r} is unknown")
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return getattr(module, attr)


def reader(metric: str):
    return _function("metrics", metric, "read")


def work(kernel: str):
    return _function("work", kernel, "work")


def model(name: str):
    """The program's log-posterior factory of the model ``name``."""
    return _function("models", name, "log_posterior_fn")


def model_reference(name: str):
    """The reference's log-posterior factory of the model ``name``."""
    return _function("reference", name, "log_posterior_fn")


def cell(bench: dict, workload: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == workload:
            return w
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json")


def metrics_of(bench: dict, workload: str, kind: str) -> list:
    """The ``kind`` ("end_to_end" or "per_layer") metrics the cell
    reports: those that list it, and those that list no cells."""
    return [m for m in bench[kind]
            if workload in m.get("workloads", [workload])]
