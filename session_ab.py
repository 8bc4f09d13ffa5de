#!/usr/bin/env python3
"""Time ``chip_smoke.py``'s phase 3 session, telemetry off, in two
checkouts of the port on one CUDA card, in turns A B B A.

    python3 session_ab.py PARENT_DIR CHANGE_DIR [--rounds 1] [--reps 4]

Each turn is a fresh process whose working directory is that checkout,
so it imports that checkout's ``chip_smoke`` and package.  It builds the
kernels, runs the session once to warm up, then ``--reps`` times, each
from ``chip_smoke.run_session`` (2,048 blobs of 1 MiB and 32 changes a
blob; the digests held against ``hashlib``), and prints each run's
seconds and GiB/s.  The telemetry gate starts off and nothing turns it
on, so the change pays only its gate-off cost.  The last line is a JSON
object: the card, per checkout every run and the medians, and the ratio
of the medians (change / parent).  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

_TURN = """
import json
import chip_smoke as cs
from dat_replication_protocol_tpu_torch.ops import _build
_build.build()
cs.run_session("cuda")
runs = [cs.run_session("cuda") for _ in range({reps})]
print(json.dumps([[r["seconds"], r["gib_per_s"]] for r in runs]))
"""


def turn(tree: str, reps: int) -> list:
    out = subprocess.run([sys.executable, "-c", _TURN.format(reps=reps)],
                         cwd=tree, capture_output=True, text=True,
                         timeout=900)
    if out.returncode != 0:
        sys.stderr.write(out.stdout[-4000:] + out.stderr[-4000:])
        raise SystemExit(f"session_ab: the turn in {tree} exited "
                         f"{out.returncode}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent")
    ap.add_argument("change")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--reps", type=int, default=4)
    args = ap.parse_args()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
        check=True).stdout.strip()
    print(card, flush=True)
    trees = {"parent": os.path.abspath(args.parent),
             "change": os.path.abspath(args.change)}
    runs: dict = {"parent": [], "change": []}
    for _ in range(args.rounds):
        for name in ("parent", "change", "change", "parent"):
            got = turn(trees[name], args.reps)
            runs[name] += got
            print(f"{name}: seconds {[r[0] for r in got]}, GiB/s "
                  f"{[r[1] for r in got]}", flush=True)
    med = {name: {"seconds": statistics.median(r[0] for r in rs),
                  "gib_per_s": statistics.median(r[1] for r in rs)}
           for name, rs in runs.items()}
    print(json.dumps({"card": card, "runs": runs, "median": med,
                      "ratio_seconds": med["change"]["seconds"]
                      / med["parent"]["seconds"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
