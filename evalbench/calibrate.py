"""Readings that the limits of ``correct`` are set from.

    python3 -m evalbench.calibrate --workloads robust04.rerank-sweep \\
        --seeds 11,12,13 --side control --out calibrate.jsonl

Each workload and seed is one ``harness.run`` with a short window, in
this process: on the ``program`` side as the benchmark runs it (the lower
reading), on the ``control`` side with the configuration kind's control
put in the program's place (the upper reading). Each run prints one JSON
line with the numbers compared. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m evalbench.calibrate")
    p.add_argument("--workloads", required=True, help="comma-separated")
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--side", choices=("program", "control"),
                   required=True)
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))

    from evalbench import found, harness

    sink = open(args.out, "a") if args.out else None
    for name in args.workloads.split(","):
        cell = harness.Cell(name, ROOT)
        alter = (found("kinds", cell.cfg["kind"]).control
                 if args.side == "control" else None)
        for seed in (int(s) for s in args.seeds.split(",")):
            line = harness.run(cell, seed, args.seconds, False, args.device,
                               time.perf_counter(), alter=alter)
            out = {"workload": name, "seed": seed, "side": args.side,
                   "correct": line["correct"], "calls": line["attempted"],
                   **{k: c["value"] for k, c in line["checks"].items()},
                   "device": line["device"]["kind"]}
            print(json.dumps(out), flush=True)
            if sink:
                sink.write(json.dumps(out) + "\n")
                sink.flush()
    if sink:
        sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
