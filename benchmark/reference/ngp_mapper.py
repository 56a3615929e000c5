"""Plain PyTorch reference of one train step of NeRF-SLAM's Instant-NGP
mapper, as the port runs it (``mapping_module: instant-ngp``).

It imports torch and ``reference/mapper.py`` alone: nothing of the program.
It computes in float32 with TF32 off (a ``Mapper`` turns it off for the
process), the MLPs and the table reads in bfloat16 as configured.
It follows the port's plain paths (``models/nerfacto.py``'s occupancy
sampler, ``models/nerf_field.py``, ``ops/occupancy.py``,
``ops/rendering.py``, ``ops/losses.py``, ``mapping/keyframe_buffer.py`` with
its depth-variance channel, ``mapping/trainer.py``), frozen here for the
mapper the benchmark runs: Instant-NGP's NeRF at its published widths
(Mueller et al., SIGGRAPH 2022; instant-ngp ``configs/nerf/base.json``): a
hash grid of 16 levels x 2 features, 2^19 entries a level, from 16 to
``max_res``; a density MLP of one hidden layer of 64 with 16 outputs
(density and 15 geometry features); a colour MLP of two hidden layers of
64 on degree-4 spherical harmonics, the geometry features and the
appearance embedding; an occupancy grid of 128^3 kept as a density EMA
(decay 0.95, refreshed every 16 steps, threshold 0.01). The loss is
NeRF-SLAM's (Rosinol et al., IROS 2023): colour MSE and the depth L2
weighted by each pixel's depth variance, with the port's distortion term.
The hash grid, MLPs, SH, resampler, rays, pose exponential and Adam are
``reference/mapper.py``'s.

Departures from published Instant-NGP, each as the port has it:

- a fixed budget of samples a ray: occupancy at 128 bin centres a ray
  weights an inverse-CDF resampling to 64 samples, in place of NGP's
  variable-length march through occupied cells compacted to 2^18 samples
  a step (4096 rays x 64 = 2^18 samples, NGP's batch at its first 4096
  rays);
- one 128^3 grid over the scene's bounding box [-4, 4]^3, in place of
  NGP's cascade of grids at doubling scales; samples outside the box read
  its boundary cells;
- a refresh re-evaluates one rotating 1/8 slab of the grid at jittered
  cell centres (every cell once in 8 refreshes), where NGP samples cells
  at random across the whole grid; the EMA is the same (decay every cell,
  then the max with the new density);
- colour MSE in place of NGP's Huber loss, and the mipNeRF-360 distortion
  term (weight 0.002) on the final samples, which NGP lacks;
- a 32-wide appearance embedding a keyframe fed to the colour MLP (NGP's
  is optional and off in ``base.json``), and Adam on each keyframe's pose
  correction (eps 1e-8, learning rate decaying 1e-4 -> 1e-5);
- samples linear in distance between near 0.05 and far 20 m, where NGP
  steps by cone-tracing distance;
- the MLPs in bfloat16 (input, weights and each product rounded), not
  NGP's float16, and the hash table read as bfloat16 rows of a float32
  table; density ``trunc_exp(h - 1)`` (the port's bias);
- Adam at learning rate 1e-2, eps 1e-15 and betas 0.9 / 0.999, with no
  decay of the learning rate, no L2 on the MLPs and no average of the
  weights, where ``base.json`` has beta2 0.99, ``l2_reg`` 1e-6 and an EMA
  of the weights at decay 0.95.

``low`` puts the reference in the control's place: every float32 tensor
of the step (positions, bin lookups, resampling, interpolation,
rendering, losses and their gradients) is computed in bfloat16, the step
below the float32 the configuration states; the MLPs stay in bfloat16 and
the optimizers' state and the grid in float32.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Tuple

import torch

from benchmark.reference import mapper as base
from benchmark.reference.mapper import BF16, Grid

# Instant-NGP's published widths, as ``mapping_model_overrides`` sets them
# on the port's instant-ngp module; the only ones a benchmark cell runs
PUBLISHED = {"num_grid_levels": 16, "grid_features_per_level": 2,
             "log2_hashmap_size": 19, "max_res": 2048, "num_occ_bins": 128,
             "num_nerf_samples": 64, "predict_normals": False}
OCCUPANCY = ("resolution", "decay", "update_every", "slab_div",
             "occ_threshold", "base_weight")


@dataclasses.dataclass(frozen=True)
class NGPConfig:
    """The mapper the configuration runs: Instant-NGP's widths and the
    port's instant-ngp settings around them."""

    num_images: int
    near: float = 0.05
    far: float = 20.0
    aabb_min: float = -4.0
    aabb_max: float = 4.0
    num_occ_bins: int = 128
    num_nerf_samples: int = 64
    distortion_loss_mult: float = 0.002
    depth_loss_mult: float = 0.001
    max_res: int = 2048
    log2_hashmap_size: int = 19
    num_grid_levels: int = 16
    grid_features_per_level: int = 2
    hidden: int = 64
    geo_feat_dim: int = 15
    appearance_dim: int = 32
    sh_degree: int = 4
    # the occupancy grid (ops/occupancy.py OccupancyConfig)
    resolution: int = 128
    decay: float = 0.95
    update_every: int = 16
    slab_div: int = 8
    occ_threshold: float = 1e-2
    base_weight: float = 1e-3

    @property
    def field_grid(self) -> Grid:
        return Grid(self.num_grid_levels, self.grid_features_per_level,
                    self.log2_hashmap_size, 16, self.max_res)

    @property
    def slab(self) -> int:
        return self.resolution**3 // self.slab_div


def model_config(cfg: Dict) -> NGPConfig:
    """The mapper of a run configuration: ``mapping_module: instant-ngp``
    with ``predict_normals`` off and the widths ``mapping_model_overrides``
    sets (an ``occupancy`` entry, a dict or an object with the grid's
    fields, sets the grid); anything else raises."""
    if cfg.get("mapping_module") != "instant-ngp" or \
            "normal" in cfg.get("enhancement_module", "none"):
        raise NotImplementedError("the NGP reference runs the instant-ngp "
                                  "mapper with no normal channel")
    over = dict(cfg.get("mapping_model_overrides") or {})
    if over.pop("predict_normals", True):
        raise NotImplementedError("Instant-NGP has no normal head")
    occ = over.pop("occupancy", {})
    if not isinstance(occ, dict):
        occ = {k: getattr(occ, k) for k in OCCUPANCY}
    return NGPConfig(num_images=cfg["num_keyframes"],
                     depth_loss_mult=cfg.get("depth_supervision_lambda",
                                             0.001), **over, **occ)


def _mlp_dims(mc: NGPConfig) -> Dict[str, List[int]]:
    F = mc.grid_features_per_level * mc.num_grid_levels
    h, g = mc.hidden, mc.geo_feat_dim
    return {"density_mlp": [F, h, 1 + g],
            "color_mlp": [mc.sh_degree**2 + g + mc.appearance_dim, h, h, 3]}


@torch.no_grad()
def init_params(mc: NGPConfig, seed: int, device) -> Dict[str, torch.Tensor]:
    """The mapper's weights from ``seed``, made on ``device`` one call a
    tensor, named as the port's ``NerfactoModel`` state dict names them
    (``reference/mapper.py``'s initializers: tables U(-1e-4, 1e-4), LeCun
    normal kernels truncated at 2 std, zero biases, the embedding normal
    of variance 1 / num_images)."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1000003 + 5) & (2**63 - 1))
    out = {}
    for name, dims in _mlp_dims(mc).items():
        for j, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
            std = math.sqrt(1.0 / a) / 0.87962566103423978
            out[f"field.{name}.layers.{j}.weight"] = base._trunc_normal(
                (b, a), std, g, device)
            out[f"field.{name}.layers.{j}.bias"] = torch.zeros(
                b, device=device)
    out["field.embedding.weight"] = torch.randn(
        mc.num_images, mc.appearance_dim, generator=g, device=device
    ) / math.sqrt(mc.num_images)
    grid = mc.field_grid
    out["field.tables"] = (torch.rand(grid.n_levels * grid.bricks_per_level,
                                      32 * grid.features, generator=g,
                                      device=device) * 2e-4 - 1e-4)
    return out


# ---------------------------------------------------------------------------
# the occupancy grid
# ---------------------------------------------------------------------------

def bin_weights(grid, unit, mc: NGPConfig):
    """The resampler's weights of bins whose centres lie at unit-cube
    positions [..., 3]: 1 where the cell's density exceeds the threshold,
    plus a floor."""
    r = mc.resolution
    i = (unit * r).to(torch.int32).clamp(0, r - 1).long()
    occ = grid[(i[..., 0] * r + i[..., 1]) * r + i[..., 2]]
    return (occ > mc.occ_threshold).to(unit.dtype) + mc.base_weight


def slab_centres(step: int, jitter, mc: NGPConfig):
    """The refresh's slab at ``step``: (its first cell, the unit-cube
    positions of its jittered cell centres)."""
    r = mc.resolution
    start = ((step // mc.update_every) % mc.slab_div) * mc.slab
    cell = start + torch.arange(mc.slab, device=jitter.device)
    xyz = torch.stack([cell // (r * r), (cell // r) % r, cell % r], -1)
    return start, (xyz.float() + jitter) / r


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

class Mapper(base.Mapper):
    """The mapper's state (weights, keyframe buffer with depth variances,
    pose corrections, both optimizers, the occupancy grid) and its train
    step; ``reference/mapper.py``'s buffer, rays, field and update."""

    def __init__(self, cfg: Dict, params: Dict[str, torch.Tensor],
                 keyframes: Dict[str, torch.Tensor], device, low=False,
                 grid=None):
        # float32 products in float32 on the card, not in TF32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.mc = mc = model_config(cfg)
        self.low = low
        self.dt = BF16 if low else torch.float32
        self.rays = cfg.get("rays_per_batch", 4096)
        self.iterations = cfg["mapping_iterations"]
        self.cam_lr0 = cfg.get("extrinsic_learning_rate", 1e-4)
        self.p = {k: v.detach().clone().float().requires_grad_(True)
                  for k, v in params.items()}
        self.pose_deltas = torch.zeros(mc.num_images, 6, device=device,
                                       requires_grad=True)
        self.opt = base.Adam(list(self.p.values()), 1e-15)
        self.cam_opt = base.Adam([self.pose_deltas], 1e-8)
        self.step_count = 0
        pixel_dtype = cfg.get("assumed", {}).get("pixel_dtype", "bfloat16")
        self._insert(keyframes, pixel_dtype)
        # the buffer's variance channel, rounded as it stores it
        self.cov = keyframes["cov"].to(getattr(torch, pixel_dtype)).float()
        # the occupancy grid the steps start from (the port's: ones)
        self.grid = (torch.ones(mc.resolution**3, device=device)
                     if grid is None else grid.float().clone())

    def _batch(self, draws):
        b = super()._batch(draws)
        b["depth_cov"] = self.cov[draws["frame"], draws["py"], draws["px"]]
        return b

    def to_unit(self, pos):
        mc = self.mc
        return (pos - mc.aabb_min) / (mc.aabb_max - mc.aabb_min)

    def loss(self, b, uniforms):
        mc, dt = self.mc, self.dt
        o, d = b["origins"].to(dt), b["directions"].to(dt)
        u = [x.to(dt) for x in uniforms]

        def positions(t_mid):
            return o[..., None, :] + d[..., None, :] * t_mid[..., None]

        def t_of(s):
            t = mc.near + s * (mc.far - mc.near)
            return 0.5 * (t[..., 1:] + t[..., :-1]), t[..., 1:] - t[..., :-1]

        # occupancy at the coarse bins' centres weights the resampling
        s = base.uniform_bins(u[0], mc.num_occ_bins)
        t_mid, _ = t_of(s)
        w = bin_weights(self.grid, self.to_unit(positions(t_mid)), mc)
        s = base.sample_pdf(s, w, mc.num_nerf_samples, u[1])
        t_mid, deltas = t_of(s)
        pos = positions(t_mid)
        density, geo = self.density_unit_features(self.to_unit(pos))
        rgb_s = self.rgb(geo, d[..., None, :].expand(pos.shape),
                         b["camera_indices"])
        w = base.render_weights(density, deltas)
        acc = torch.sum(w, -1)
        rgb = torch.sum(w[..., None] * rgb_s, -2) + (1.0 - acc[..., None]) \
            * rgb_s[..., -1, :]
        loss = torch.mean((rgb - b["rgb"].to(dt)) ** 2)
        loss = loss + mc.distortion_loss_mult * base.distortion_loss(s, w)
        # expected distance, weight-normalized and held inside the samples
        depth = torch.sum(w * t_mid, -1) / acc.clamp(min=1e-10)
        depth = torch.minimum(torch.maximum(depth, t_mid[..., 0]),
                              t_mid[..., -1])
        target = b["depth"].to(dt)
        err = (depth - target) ** 2 / b["depth_cov"].to(dt).clamp(min=1e-6)
        valid = (target > 0).to(dt) * b["depth_mask"].to(dt)
        dl = torch.sum(err * valid) / torch.sum(valid).clamp(min=1.0)
        return loss + mc.depth_loss_mult * dl

    @torch.no_grad()
    def refresh(self, step: int, jitter) -> None:
        """The grid's refresh at ``step`` on the updated field: every cell
        decayed, then the slab's cells raised to the field's density at
        their jittered centres where it is higher."""
        mc = self.mc
        start, unit = slab_centres(step, jitter, mc)
        density, _ = self.density_unit_features(unit.to(self.dt))
        grid = self.grid * mc.decay
        end = start + mc.slab
        grid[start:end] = torch.maximum(grid[start:end], density.float())
        self.grid = grid

    def step(self, draws) -> Tuple[float, Dict[str, torch.Tensor]]:
        """One train step on ``draws`` (``occ_jitter`` on a refresh
        step): the loss, Adam on the weights and on the pose corrections,
        then on a refresh step the grid's refresh."""
        step = self.step_count
        out = super().step(draws)
        if step % self.mc.update_every == 0:
            self.refresh(step, draws["occ_jitter"])
        return out
