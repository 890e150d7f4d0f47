"""Readings that a cell's limits are set from, on the chip at the cell's
size: the comparison's numbers for the program on each of --seeds and for
the control (the reference in a lower precision, in the program's place) on
each of --control-seeds, and for each of --faults (tools/faults.py, planted
in the reference in the program's place) on each of --fault-seeds, in one
process.

    python3 -m benchmark.tools.limits --workload <cell> --seeds 1,2,3 \\
        --control-seeds 1,2,3 --out build/limits-<cell>.json

Prints one JSON line per reading and writes them all to --out. Nothing
here runs in a benchmark run.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from benchmark import run as H


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--faults", default="", help="faults of tools/faults.py, comma-separated")
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--out", required=True)
    a = p.parse_args(argv)
    H.quiet_environment()
    spec = H.cell_spec(H.read_json(os.path.join(H.ROOT, "BENCHMARK.json")), a.workload)
    driver = H.load_file(os.path.join(H.HERE, "drivers", spec["traffic"]["driver"] + ".py"),
                         "benchmark_driver_" + spec["traffic"]["driver"])
    out = []
    sides = [("program", a.seeds), ("control", a.control_seeds)]
    sides += [(f, a.fault_seeds) for f in a.faults.split(",") if f]
    for side, seeds in sides:
        for seed in [int(s) for s in seeds.split(",") if s]:
            args = argparse.Namespace(seed=seed, seconds=0.0, trace=0, workload=a.workload)
            t0 = time.time()
            numbers = driver.readings(H.Context(args, spec, "cuda"), side)
            rec = {"workload": a.workload, "seed": seed, "side": side, "numbers": numbers,
                   "seconds": time.time() - t0}
            out.append(rec)
            print(json.dumps(rec), flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
    with open(a.out, "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
