"""The readings that a cell's limits are set from: the compared numbers
of the program over many seeds (the lower readings) and of the control,
the float64 reference put in the program's place at the configuration's
lower precision (the upper readings), in one process:

    python3 portbench/calibrate.py --workload lz40n33.serve \
        --seeds 11,12,13 --control-seeds 21,22,23 --seconds 3

Each seed is a short window at the cell's own load that compares as
many rows as a full run of ``run_seconds`` does (more rows a call).
The program is built once and served for every seed; the control is
built for each.  One JSON line a run, then a summary line with each
number's largest program reading and smallest control reading.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    sys.path[0] = ROOT  # the checkout, not this folder: no module shadows
    from portbench import run

    run._caches()
    from portbench import discover, harness
    from portbench import system as systems

    bench = discover.benchmark()
    mix = discover.traffic(discover.cell(bench, args.workload)["traffic"])
    keep = int(mix["check_rows_per_call"] * bench["run_seconds"]
               / args.seconds)
    built = {}

    def program(root, config, m, dev):
        if "call" not in built:
            built["call"] = systems.program(root, config, m, dev)
        return built["call"]

    lines = []
    compared = keep
    for side, seeds, factory in (
            ("program", args.seeds, program),
            ("control", args.control_seeds, systems.control)):
        for seed in [int(s) for s in seeds.split(",") if s]:
            res = harness.run_cell(
                args.workload, seed, args.seconds, False, T_START,
                make_system=factory, overrides={"check_rows_per_call": keep})
            line = {"side": side, "seed": seed, "correct": res["correct"],
                    "attempted": res["attempted"],
                    "numbers": {k: v["value"]
                                for k, v in res["checks"].items()}}
            print(json.dumps(line), flush=True)
            lines.append(line)
            compared = max(compared, res["attempted"] * keep)
        built.clear()
        # the control's calls are slower: as many rows in its first call
        # as the program compared in a whole short window
        keep = compared
    summary = {"workload": args.workload}
    for side, pick in (("program", max), ("control", min)):
        got = [ln["numbers"] for ln in lines if ln["side"] == side]
        if got:
            summary[side] = {k: pick(g[k] for g in got) for k in got[0]}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
