"""One traced run of a benchmark cell, with the program's ``ttirt.*``
spans read out of the harness's own capture:

    python3 tools/serve_spans.py --workload lz40n33.serve --seed 7 \
        --seconds 30

It runs ``portbench/run.py`` with ``--trace 1`` unchanged, except that
the capture's events are kept when the harness reads its stretch
(``portbench.trace.read_profile``).  Standard error gets the clock
check, device and idle seconds by program span, the longest idle gaps,
and the shares of ``portbench.program_spans.SHARES``; the harness's
result line is the last line of standard output, as ever.  The same
numbers go to ``chiprun_out/serve_spans/<workload>.<seed>.json``.  On a
tree whose program opens no spans every operation reads "-", and the
stretch's seconds a call are the capture's cost without them.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from portbench import program_spans, run  # noqa: E402
from portbench import trace as tracing  # noqa: E402


def _keeping(out: dict, read_profile=tracing.read_profile):
    """The harness's ``read_profile``, which also reads the program's
    spans from the capture it exports into ``out``."""

    def keeping(prof, calls):
        kept = {}

        class Export:
            def export_chrome_trace(self, path):
                prof.export_chrome_trace(path)
                with open(path) as fh:
                    kept["events"] = json.load(fh)["traceEvents"]

        stretch = read_profile(Export(), calls)
        if stretch is None:
            return None
        launched = program_spans.annotate(kept.pop("events"))
        lines = program_spans.tables(launched, stretch)
        found = program_spans.shares(launched, stretch)
        lines += [f"share {k} {v!r}" for k, v in found.items()]
        for line in lines:
            print(line, file=sys.stderr, flush=True)
        early, tied, lead = program_spans.clock_check(launched, stretch)
        out.update(
            calls=[calls.start, calls.stop], busy_s=stretch.busy_s,
            window_s=stretch.window_s, clock_early=early, clock_tied=tied,
            clock_lead_s=lead, shares=found, tables=lines)
        return stretch

    return keeping


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    out: dict = {}
    tracing.read_profile = _keeping(out)
    run.T_START = T_START
    rc = run.main(["--workload", args.workload, "--seed", str(args.seed),
                   "--seconds", str(args.seconds), "--trace", "1"])
    dest = os.path.join(ROOT, "chiprun_out", "serve_spans")
    os.makedirs(dest, exist_ok=True)
    with open(os.path.join(dest, f"{args.workload}.{args.seed}.json"),
              "w") as fh:
        json.dump(dict(out, rc=rc), fh, indent=1)
    return rc


if __name__ == "__main__":
    sys.exit(main())
