"""Floating-point operations of one mapping train step, by precision, from
the configuration's shapes alone (never read from the program).

Counted: every matrix product of the MLPs (bf16: ``2 a b`` a point for an
``a -> b`` layer) and every trilinear interpolation of a table (f32: two
operations for each of the 8 corners and F features of a level), forward
and backward:

- each proposal field at its samples: forward (interpolation, MLP), then
  the backward, since the interlevel loss trains it and the pose gradient
  runs through its samples: twice the MLP (input and weight gradients)
  and twice the interpolation (table and position gradients);
- the field at the final samples: forward (interpolation, density,
  colour and normal MLPs), the normals' density pullback (the density
  MLP's input gradient, one interpolation), then the backward: twice each
  MLP and twice the interpolation.

Elementwise work (encodings, compositing, losses, Adam) and the interlevel
loss's histogram contractions are not counted, so the share of the peak
this gives is a lower bound of the work done.
"""

from __future__ import annotations

from typing import Dict, Sequence


def mlp(dims: Sequence[int]) -> int:
    return sum(2 * a * b for a, b in zip(dims[:-1], dims[1:]))


def interp(levels: int, features: int) -> int:
    return 2 * 8 * features * levels


def map_step(mc, rays: int) -> Dict[str, float]:
    """{"bfloat16": ..., "float32": ...} operations of one step of the
    mapper ``mc`` (``reference.mapper.ModelConfig``) at ``rays`` rays."""
    from benchmark.reference.mapper import _mlp_dims

    f32 = bf16 = 0.0
    for grid, n in zip(mc.proposal_grids, mc.num_proposal_samples):
        width = grid.n_levels * grid.features
        f32 += 3 * rays * n * interp(grid.n_levels, grid.features)
        bf16 += 3 * rays * n * mlp([width, mc.proposal_hidden, 1])
    dims = _mlp_dims(mc)
    dens, col, nrm = (mlp(dims[k]) for k in ("density_mlp", "color_mlp",
                                             "normal_mlp"))
    fi = interp(mc.num_grid_levels, mc.grid_features_per_level)
    S = mc.num_nerf_samples
    f32 += 4 * rays * S * fi
    bf16 += rays * S * (3 * (dens + col + nrm) + dens)
    return {"bfloat16": bf16, "float32": f32}
