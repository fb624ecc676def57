"""The readings that `correct`'s limits are set from, for one cell: runs
of the cell as the benchmark makes them (a short window at the cell's own
load, then the judge over as many calls as a run judges), the program
judged on `--seeds` and the control (the plain reference put in the
program's place with its matmul operands in TF32, the precision below the
configuration's float32) on `--control-seeds`, all in one process.

    python3 portbench/control.py --workload <cell> --seeds 1 2 3 \\
        --control-seeds 1 2 3 [--seconds 2]

Prints one JSON line a seed and side: every number the judge reads, and
whether the run came out correct."""
import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from portbench.common.harness import run_cell

    runs = [("program", s) for s in args.seeds] + [
        ("control", s) for s in args.control_seeds]
    for side, seed in runs:
        res = run_cell(args.workload, seed, args.seconds, False,
                       device=args.device, control=side == "control",
                       log=lambda m: None)
        print(json.dumps({"side": side, "seed": seed,
                          "correct": res["correct"],
                          **{k: c["value"] for k, c in
                             res["checks"].items()},
                          **res["not_compared"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
