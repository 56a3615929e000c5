"""Counts of the F <= 2 ``scatter_cols_accum`` design on recorded ids, on
the CPU: how many runs of equal ids its lane groups sum in registers, how
many row adds reach the table in global memory, and the most on one row.

    python3 scripts/model_scatter_runs.py IDS.npz [--blocks 132] [--slots 0]

``IDS.npz`` holds int32 id arrays (``scripts/exp_torch_table_kernels.py``
writes the (h1) scatters' ids as
``nerf_vo_tpu_torch/_build/table_kernels/h1_ids.npz``).
The model follows ``csrc/gather.cu``: ``--blocks`` blocks (one a streaming
multiprocessor: 512 threads at ~112 registers) of 64 lane groups (16 warps
x 4 groups at F = 2), each group a contiguous range of ``span``
descriptors, one row add a run. ``--slots N`` also models a second stage
that was tried and not kept: a per-block table of N rows in shared memory
that a run's id claims from its multiplicative hash on (4 probes, first
come keeps the slot; the groups' claims in group order, where the card
interleaves them), a miss adding to global memory, each block adding its
table's rows at the end.
"""

from __future__ import annotations

import argparse

import numpy as np


def model(idx, blocks, groups, slots, probes):
    M = idx.shape[0]
    span = -(-M // (blocks * groups))
    runs = direct = table_rows = 0
    adds = {}
    for b in range(blocks):
        table = [-1] * slots
        for g in range(groups):
            lo = (b * groups + g) * span
            s = idx[lo:min(lo + span, M)]
            if s.size == 0:
                continue
            run_ids = s[np.r_[0, np.nonzero(s[1:] != s[:-1])[0] + 1]]
            runs += run_ids.size
            for v in run_ids.tolist():
                h = (v * 2654435761) % 2**32 % slots if slots else 0
                for p in range(probes if slots else 0):
                    k = table[(h + p) % slots]
                    if k == -1:
                        table[(h + p) % slots] = v
                    if k in (-1, v):
                        break
                else:
                    direct += 1
                    adds[v] = adds.get(v, 0) + 1
        for v in table:
            if v >= 0:
                table_rows += 1
                adds[v] = adds.get(v, 0) + 1
    return dict(M=M, span=span, runs=runs, table_misses=direct,
                table_rows=table_rows, row_adds=direct + table_rows,
                most_on_one_row=max(adds.values()))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("ids")
    ap.add_argument("--blocks", type=int, default=132)
    ap.add_argument("--groups", type=int, default=64)
    ap.add_argument("--slots", type=int, default=0)
    ap.add_argument("--probes", type=int, default=4)
    args = ap.parse_args()
    data = np.load(args.ids)
    for key in data.files:
        idx = data[key].astype(np.int64)
        counts = np.unique(idx, return_counts=True)[1]
        r = model(idx, args.blocks, args.groups, args.slots, args.probes)
        table = (f", table misses {r['table_misses']}, table rows added "
                 f"{r['table_rows']}" if args.slots else "")
        print(f"{key}: M {r['M']}, span {r['span']}, runs summed in "
              f"registers {r['runs']}{table}; row adds into the "
              f"global table {r['row_adds']} (one a descriptor: {r['M']}), "
              f"the most on one row {r['most_on_one_row']} (one a "
              f"descriptor: {int(counts.max())})")


if __name__ == "__main__":
    main()
