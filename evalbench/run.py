"""Run one cell of the benchmark and print its result line.

    python3 -m evalbench.run --workload robust04.rerank-sweep --seed 7 \\
        --seconds 30 --trace 0

Run from the root of a checkout: the port is imported from the checkout's
``src``. The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1`` a
``breakdown``, and last the ``checks``: each number compared beside its
limit, which also end standard error). Without a CUDA device, or with
fewer than the cell asks for, the run prints no result and exits 3.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m evalbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from evalbench import check, harness

    cell = harness.Cell(args.workload, ROOT)
    import torch

    chips = int(cell.spec["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); this host "
              f"has {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import repro_torch  # noqa: F401
    except ImportError as exc:
        print(f"the port is not in this checkout: {exc}", file=sys.stderr)
        return 4
    line = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                       "cuda", STARTED)
    bad = harness.forbidden_modules()
    if bad:
        print(f"the run loaded forbidden modules: {bad}", file=sys.stderr)
        return 5
    check.print_checks(line["checks"])
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
