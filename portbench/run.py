"""The port's benchmark: one run of one cell on the card it is started on.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Prints, as the last line of standard output, one JSON object with
`correct`, `attempted`, `failed`, `metrics`, `device` (and with
`--trace 1` a `breakdown`), and last a `checks` object: every number
that `correct` compares beside its limit. The same numbers end standard
error. Exits nonzero, printing no result, without a CUDA card, with fewer
cards than the cell asks for, or when the JAX stack or the JAX package
was loaded into the process."""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    if args.seed < 0:
        p.error("--seed must be a non-negative integer")
    # the program's kernels build into build/pctpu_torch of this checkout;
    # a Triton cache, should one be used, stays beside them
    os.environ.setdefault("TRITON_CACHE_DIR",
                          str(ROOT / "build" / "triton_cache"))
    sys.path.insert(0, str(ROOT))

    import torch
    from portbench.common.harness import forbidden_modules, run_cell

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    chips = next(w["chips"] for w in bench["workloads"]
                 if w["name"] == args.workload)
    if not torch.cuda.is_available():
        print("portbench: no CUDA device; nothing was run", file=sys.stderr)
        return 3
    if torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 3
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), device="cuda", t0=T0)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the process loaded {bad}; no result",
              file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
        if c["value"] is not None and not math.isfinite(c["value"]):
            c["value"] = None       # strict JSON has no inf or nan
    sys.stderr.flush()
    print(json.dumps(result, allow_nan=False), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
