"""The control of the output check, on several seeds in one process.

    python3 bench/control.py --workload <cell> --seconds <s> --seeds <n>...

Each seed runs the cell with the program's own bfloat16 path switched on
(``PHConfig(dtype="bfloat16")``, the nearest precision below the
configurations' float32): its diagrams have to come out not correct.
Each seed prints the run's result line (a short window at the cell's own
load); the benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import sys
import time

import run as bench_run


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    for seed in args.seeds:
        rc = bench_run.main(["--workload", args.workload, "--seed",
                             str(seed), "--seconds", str(args.seconds)],
                            overrides={"dtype": "bfloat16"},
                            t_start=time.perf_counter())
        if rc:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
