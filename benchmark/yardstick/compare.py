"""The numbers that decide ``correct`` in a training cell.

Three readings of the program's first steps against the reference's, each
the worst over the steps or the leaves:

- ``loss_gap``: the largest ``|loss_p - loss_r| / |loss_r|`` over the
  compared steps;
- ``grad_gap``: of the first step's gradient, the largest gap between the
  program's norm of a leaf and the reference's, over the reference's norm
  of that leaf or of the median leaf, whichever is larger (some gradients
  are all but zero);
- ``change_gap``: the same of each leaf's change over the compared steps
  (the weights as the next step finds them), for the leaves whose
  reference gradient is at least a thousandth of the median leaf's (a
  leaf with a gradient nought to rounding moves under Adam by round-off
  alone).

A leaf that one side moves and the other leaves where it was reads 1.
"""

from __future__ import annotations

import statistics
from typing import Dict

NUMBERS = ("loss_gap", "grad_gap", "change_gap")
QUIET_LEAF = 1e-3  # of the median leaf's reference gradient norm


def worst_norm_gap(prog: Dict[str, float], ref: Dict[str, float]) -> float:
    """max over leaves of |prog - ref| / max(ref, median of ref)."""
    floor = statistics.median(ref.values())
    return max(abs(prog[k] - ref[k]) / max(ref[k], floor, 1e-30)
               for k in ref)


def gaps(prog: Dict, ref: Dict) -> Dict[str, float]:
    """The three numbers from each side's readings: ``losses`` [steps],
    ``grad`` {leaf: norm of the first gradient}, ``change`` {leaf: norm of
    the change over the steps}."""
    losses = [abs(p - r) / max(abs(r), 1e-30)
              for p, r in zip(prog["losses"], ref["losses"])]
    if len(prog["losses"]) != len(ref["losses"]):
        losses.append(1.0)
    floor = statistics.median(ref["grad"].values())
    kept = [k for k, v in ref["grad"].items() if v >= QUIET_LEAF * floor]
    return {"loss_gap": max(losses),
            "grad_gap": worst_norm_gap(prog["grad"], ref["grad"]),
            "change_gap": worst_norm_gap(
                {k: prog["change"][k] for k in kept},
                {k: ref["change"][k] for k in kept})}


def worst_leaves(prog: Dict, ref: Dict, k: int = 3) -> Dict[str, list]:
    """For a look at a reading: the ``k`` leaves with the largest gaps of
    the first gradient and of the change, with both sides' norms."""
    out = {}
    for key in ("grad", "change"):
        floor = statistics.median(ref[key].values())
        rows = sorted(((abs(prog[key][n] - r) / max(r, floor, 1e-30), n,
                        prog[key][n], r) for n, r in ref[key].items()),
                      reverse=True)[:k]
        out[key] = [[n, g, p, r] for g, n, p, r in rows]
    out["losses"] = [prog["losses"], ref["losses"]]
    return out
