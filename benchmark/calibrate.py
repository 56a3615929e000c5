"""Readings that the limits of ``correct`` are set from, for a training cell.

    python3 benchmark/calibrate.py --workload vo.map --seeds 1 2 3 ... \\
        --control 3 --fault half_batch 3 --fault unchanged 1

For each seed the program is driven through the cell's compared steps as a
run's set-up drives it, and the three numbers of ``yardstick/compare.py``
are read against the reference: the lower readings. For the first
``--control`` seeds the control (the reference in bfloat16 where the
configuration states float32) is read against the reference in float32,
and for the first seeds of each ``--fault`` the program with that fault
planted (``faults.py``): the upper readings. Prints one JSON line per
reading, then one with each number's largest lower and smallest upper
reading. The benchmark's own runs never run this.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from benchmark import faults, harness  # noqa: E402
from benchmark.yardstick import compare  # noqa: E402


def main(argv=None, out=sys.stdout):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", type=int, default=0)
    p.add_argument("--fault", nargs=2, action="append", default=[],
                   metavar=("NAME", "SEEDS"))
    a = p.parse_args(argv)
    cell = harness.Cell(a.workload)
    drv = cell.driver
    rows = []

    def emit(kind, seed, got, ref, t0):
        row = dict(kind=kind, seed=seed, seconds=time.perf_counter() - t0,
                   **compare.gaps(got, ref))
        rows.append(row)
        out.write(json.dumps(dict(row, leaves=compare.worst_leaves(
            got, ref))) + "\n")
        out.flush()

    for i, seed in enumerate(a.seeds):
        ctx = harness.context(cell, seed, "cuda:0")
        t0 = time.perf_counter()
        stage, prog, _ = drv.build(ctx)
        del stage
        harness.free_device_memory()
        ref = drv.reference_readings(ctx)
        emit("program", seed, prog, ref, t0)
        if i < a.control:
            t0 = time.perf_counter()
            emit("control", seed, drv.reference_readings(ctx, low=True),
                 ref, t0)
        for name, n in a.fault:
            if i < int(n):
                t0 = time.perf_counter()
                with faults.FAULTS[name]():
                    stage, got, _ = drv.build(ctx)
                del stage
                harness.free_device_memory()
                emit(name, seed, got, ref, t0)
    summary = {"kind": "summary"}
    for k in compare.NUMBERS:
        summary[f"{k}.lower"] = max(r[k] for r in rows
                                    if r["kind"] == "program")
        for kind in {r["kind"] for r in rows} - {"program"}:
            summary[f"{k}.{kind}"] = min(r[k] for r in rows
                                         if r["kind"] == kind)
    out.write(json.dumps(summary) + "\n")
    return rows


if __name__ == "__main__":
    main()
