"""Floating-point operations of one train step of the Instant-NGP mapper,
by precision, from the configuration's shapes alone (never read from the
program).

Counted as ``yardstick/flops.py`` counts them (``mlp``, ``interp``):

- the field at the final samples, ``rays x num_nerf_samples`` points:
  forward (interpolation, density and colour MLPs), then the backward:
  twice each MLP (input and weight gradients) and twice the interpolation
  (table gradient, and the position gradient the pose correction needs);
- the occupancy refresh's forward (interpolation and density MLP) over its
  slab of ``resolution^3 / slab_div`` cells, once every ``update_every``
  steps, spread over them.

The occupancy lookups, the resampling, compositing, losses and Adam are
elementwise and not counted, so the share of the peak this gives is a
lower bound of the work done.
"""

from __future__ import annotations

from typing import Dict

from benchmark.yardstick.flops import interp, mlp


def map_step(mc, rays: int) -> Dict[str, float]:
    """{"bfloat16": ..., "float32": ...} operations of one step of the
    mapper ``mc`` (``reference.ngp_mapper.NGPConfig``) at ``rays`` rays."""
    from benchmark.reference.ngp_mapper import _mlp_dims

    dims = _mlp_dims(mc)
    dens, col = mlp(dims["density_mlp"]), mlp(dims["color_mlp"])
    fi = interp(mc.num_grid_levels, mc.grid_features_per_level)
    points = rays * mc.num_nerf_samples
    slab = mc.slab / mc.update_every
    return {"bfloat16": 3 * points * (dens + col) + slab * dens,
            "float32": 3 * points * fi + slab * fi}
