"""Occupancy-grid ray sampling (the Instant-NGP mapper's empty-space skip).

Counterpart of ``nerf_vo_tpu/ops/occupancy.py``, which recasts pyngp's
occupancy-grid ray marching with a fixed sample budget:

  * the grid is a dense f32 density EMA over the field's unit-cube
    coordinates (flat [res^3], 8 MB at 128^3);
  * per ray, occupancy at the centres of M coarse bins becomes the weights
    of the PDF resampler (``ops.rendering.sample_pdf``), so the fixed
    per-ray budget lands in occupied bins;
  * a refresh decays the whole grid and max-merges the current field
    density over one contiguous slab of cells; the slab rotates with the
    refresh count, so every cell is revisited once per ``slab_div``
    refreshes.

Random numbers come in as arguments: :func:`slab_cell_centers` takes the
slab's jitter uniforms, where the JAX module draws them from a key. The
step a refresh is made at may be a Python int or a 0-dim integer tensor on
the grid's device: the slab's place is then computed there, so that a CUDA
graph of the refresh serves every slab.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class OccupancyConfig:
    resolution: int = 128
    decay: float = 0.95          # NGP's per-refresh density EMA decay
    update_every: int = 16       # train steps between refreshes (NGP: 16)
    slab_div: int = 8            # cells re-evaluated a refresh: res^3 / this
    occ_threshold: float = 1e-2  # density above which a cell is "occupied"
    base_weight: float = 1e-3    # sampling floor so unseen space stays visible


def slab_size(config: OccupancyConfig) -> int:
    """Cells re-evaluated per refresh."""
    return config.resolution ** 3 // config.slab_div


def create(config: OccupancyConfig, device) -> torch.Tensor:
    """Fresh grid on ``device``: everything occupied (optimistic init, like
    NGP)."""
    return torch.ones(config.resolution ** 3, device=device)


def lookup(grid: torch.Tensor, unit_pos: torch.Tensor,
           config: OccupancyConfig) -> torch.Tensor:
    """Occupancy density at unit-cube positions [..., 3] -> [...]."""
    r = config.resolution
    idx = (unit_pos * r).to(torch.int32).clamp(0, r - 1).long()
    flat = (idx[..., 0] * r + idx[..., 1]) * r + idx[..., 2]
    return grid[flat]


def bin_weights(grid: torch.Tensor, unit_pos: torch.Tensor,
                config: OccupancyConfig) -> torch.Tensor:
    """PDF-resampler weights for coarse bins at unit positions [..., M, 3]."""
    occ = lookup(grid, unit_pos, config)
    return (occ > config.occ_threshold).float() + config.base_weight


def slab_cell_centers(step, jitter: torch.Tensor, config: OccupancyConfig):
    """Unit-cube positions (jittered cell centres) of this refresh's slab
    and the slab's flat start (an int, or a 0-dim tensor where ``step`` is
    one). ``jitter``: [slab_size, 3] uniforms in [0, 1). The slab rotates
    with the refresh count."""
    r = config.resolution
    slab = slab_size(config)
    start = ((step // config.update_every) % config.slab_div) * slab
    cell = start + torch.arange(slab, device=jitter.device)
    xyz = torch.stack([cell // (r * r), (cell // r) % r, cell % r], -1)
    return (xyz.float() + jitter) / r, start


def refresh(grid: torch.Tensor, density_slab: torch.Tensor, start,
            config: OccupancyConfig) -> torch.Tensor:
    """One refresh: whole-grid decay, then max-merge of the slab's
    densities (evaluated at :func:`slab_cell_centers`) into the cells from
    ``start`` (an int or a 0-dim tensor). Returns a new grid."""
    grid = grid * config.decay
    cells = start + torch.arange(density_slab.shape[0], device=grid.device)
    return grid.index_copy_(0, cells, torch.maximum(
        grid.index_select(0, cells), density_slab.to(grid.dtype)))
