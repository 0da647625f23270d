"""Run one cell of the port's benchmark once.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is the result object: `correct`,
`attempted`, `failed`, `metrics`, `device` (and, traced, `breakdown`),
and last `checks`, each number compared beside its limit; the same
numbers close standard error. A run that cannot measure (no CUDA
device, fewer than the cell asks for, a failure of the program, or a
JAX module loaded by the time the window has closed) says why on
standard error, prints no result and exits 1.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python3 -m portbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    try:
        from portbench import harness

        result = harness.run_cell(args.workload, args.seed, args.seconds,
                                  bool(args.trace), t_start=T_START)
        found = harness.forbidden_modules()
    except Exception:
        traceback.print_exc()
        return 1
    if found:
        print("JAX modules loaded by the run: " + ", ".join(found),
              file=sys.stderr)
        return 1
    for k, c in result["checks"].items():
        print(f"check {k}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
