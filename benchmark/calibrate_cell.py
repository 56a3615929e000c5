"""Readings that the limits of ``correct`` are set from, for a training cell
whose driver compares more than ``yardstick/compare.py``'s three numbers.

    python3 benchmark/calibrate_cell.py --workload slam.map --seeds 1 2 3 ... \\
        --control 3 --fault half_batch 3 --fault altered 3 \\
        --fault unchanged 3 --fault slab_shifted 3 --fault bin_mirrored 3

``calibrate.py`` itself, with each reading taken by the cell's driver's
``gaps`` over its ``NUMBERS`` (``drivers/ngp_map.py``: the three numbers
and ``occ_gap``) in place of ``compare.gaps``, and with two faults of the
occupancy grid beside ``faults.py``'s:

- ``slab_shifted``: a refresh merges its slab's densities into the next
  slab's cells;
- ``bin_mirrored``: the bins' occupancy is read at the cell with x and z
  swapped.

The benchmark's own runs never run this.
"""

import argparse
import contextlib
import os
import sys
import types

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from benchmark import calibrate, faults, harness  # noqa: E402
from benchmark.yardstick import compare  # noqa: E402


@contextlib.contextmanager
def slab_shifted():
    from nerf_vo_tpu_torch.ops import occupancy as O

    refresh = O.refresh

    def shifted(grid, density_slab, start, config):
        n = density_slab.shape[0]
        return refresh(grid, density_slab, (start + n) % grid.shape[0],
                       config)

    O.refresh = shifted
    try:
        yield
    finally:
        O.refresh = refresh


@contextlib.contextmanager
def bin_mirrored():
    from nerf_vo_tpu_torch.ops import occupancy as O

    bin_weights = O.bin_weights

    def mirrored(grid, unit_pos, config):
        return bin_weights(grid, unit_pos.flip(-1), config)

    O.bin_weights = mirrored
    try:
        yield
    finally:
        O.bin_weights = bin_weights


FAULTS = dict(faults.FAULTS, slab_shifted=slab_shifted,
              bin_mirrored=bin_mirrored)


def main(argv=None, out=sys.stdout):
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--workload", required=True)
    drv = harness.Cell(p.parse_known_args(argv)[0].workload).driver
    calibrate.compare = types.SimpleNamespace(
        gaps=drv.gaps, NUMBERS=drv.NUMBERS,
        worst_leaves=compare.worst_leaves)
    calibrate.faults = types.SimpleNamespace(FAULTS=FAULTS)
    try:
        return calibrate.main(argv, out)
    finally:
        calibrate.compare, calibrate.faults = compare, faults


if __name__ == "__main__":
    main()
