"""Readings that the limits of ``correct`` are set from, for the SDF
mapping cell.

    python3 benchmark/calibrate_sdf.py --workload sdf.map --seeds 1 2 3 ... \\
        --control 3 --fault half_batch 3 --fault sdf_input_bf16 3 \\
        --fault eps_coarse 3 --fault upsample_inv_s_halved 3

``calibrate_cell.py`` itself (each reading taken by ``drivers/sdf_map.py``'s
``gaps`` over its ``NUMBERS``: the three numbers and ``normal_gap``), with
three faults of the SDF mapper beside ``faults.py``'s:

- ``sdf_input_bf16``: the SDF MLP's input ``[x, features]`` rounded to
  bfloat16, as the port's other MLPs round theirs;
- ``eps_coarse``: the taps spaced for one level coarser than the finest
  active one (``eps = 1 / res[active - 2]``);
- ``upsample_inv_s_halved``: the first up-sampling round at half its
  sharpness (32 in place of 64).

The benchmark's own runs never run this.
"""

import contextlib
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from benchmark import calibrate_cell, faults  # noqa: E402


@contextlib.contextmanager
def sdf_input_bf16():
    from nerf_vo_tpu_torch.models import nerf_field

    head = nerf_field.SDFField.sdf_head

    def rounded(self, h):
        return head(self, h.to(nerf_field.torch.bfloat16).float())

    nerf_field.SDFField.sdf_head = rounded
    try:
        yield
    finally:
        nerf_field.SDFField.sdf_head = head


@contextlib.contextmanager
def eps_coarse():
    from nerf_vo_tpu_torch.models import nerfacto

    values = nerfacto.NerfactoModel.schedule_values

    def coarse(self, step):
        active, _, curv, anneal = values(self, step)
        res = self.field.grid.resolutions
        return active, 1.0 / res[max(int(active) - 2, 0)], curv, anneal

    nerfacto.NerfactoModel.schedule_values = coarse
    try:
        yield
    finally:
        nerfacto.NerfactoModel.schedule_values = values


@contextlib.contextmanager
def upsample_inv_s_halved():
    from nerf_vo_tpu_torch.ops import rendering

    upsample = rendering.neus_upsample

    def halved(o, d, z, sdf, n_new, inv_s):
        first = inv_s == 64.0
        return upsample(o, d, z, sdf, n_new, inv_s * 0.5 if first else inv_s)

    rendering.neus_upsample = halved
    try:
        yield
    finally:
        rendering.neus_upsample = upsample


FAULTS = dict(faults.FAULTS, sdf_input_bf16=sdf_input_bf16,
              eps_coarse=eps_coarse,
              upsample_inv_s_halved=upsample_inv_s_halved)


def main(argv=None, out=sys.stdout):
    cell_faults = calibrate_cell.FAULTS
    calibrate_cell.FAULTS = FAULTS
    try:
        return calibrate_cell.main(argv, out)
    finally:
        calibrate_cell.FAULTS = cell_faults


if __name__ == "__main__":
    main()
