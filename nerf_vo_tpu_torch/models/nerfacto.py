"""Nerfacto-equivalent NeRF model: proposal sampling + hash field + losses.

Counterpart of ``nerf_vo_tpu/models/nerfacto.py``. Two dense proposal
density grids drive PDF resampling; a hash-grid field renders RGB, depth and
normals; the loss set is RGB MSE + distortion + DS-NeRF (or L2) depth +
monosdf normal + orientation / predicted-normal. Proposals train by
distillation: their grids carry no gradients, and
:meth:`NerfactoModel.refresh_proposals` rewrites a rotating brick slab from
the current field density.

The Instant-NGP mapper (``sampler="occupancy"``) has no proposal fields:
occupancy-grid weights at 128 uniform coarse bins drive the PDF resampler
(``ops/occupancy.py``), and :meth:`NerfactoModel.refresh_occupancy`
re-evaluates a rotating slab of the grid from the current field.

Ported paths: ``proposal_type="dense"`` with ``proposal_training="distill"``
and f32 proposal tables, ``sampler`` "proposal" or "occupancy",
``grad_normal_mode`` in {"surface", "none"}, single device. A configuration
that selects another path raises ``NotImplementedError``.

Random numbers come in as arguments: ``uniforms`` is the list of
stratification uniforms of one render (the bin jitter ``[R, S0+1]``, then one
``[R, n+1]`` per PDF resampling), where the JAX package splits a key.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from nerf_vo_tpu_torch.models import nerf_field
from nerf_vo_tpu_torch.models.nerf_field import (
    DenseProposalField,
    HashGridConfig,
    NerfactoField,
)
from nerf_vo_tpu_torch.ops import losses as L
from nerf_vo_tpu_torch.ops import occupancy as O
from nerf_vo_tpu_torch.ops import rendering as R


@dataclasses.dataclass(frozen=True)
class NerfactoConfig:
    """The JAX package's ``NerfactoConfig``, field for field (see its
    comments for the reasons behind each default)."""

    near: float = 0.05
    far: float = 50.0
    spacing: str = "disparity"
    num_proposal_samples: Tuple[int, ...] = (96, 48)
    num_nerf_samples: int = 48
    num_images: int = 512
    use_contraction: bool = True
    aabb_min: float = -1.0
    aabb_max: float = 1.0
    predict_normals: bool = True
    grad_normal_mode: str = "surface"
    background: str = "last_sample"  # or "black" / "white"
    interlevel_loss_mult: float = 1.0
    distortion_loss_mult: float = 0.002
    depth_loss_mult: float = 0.001
    depth_loss_type: str = "ds_nerf"  # "ds_nerf" | "l2"
    normal_loss_mult: float = 5e-6
    depth_sigma: float = 0.001
    orientation_loss_mult: float = 1e-4
    pred_normal_loss_mult: float = 1e-3
    is_euclidean_depth: bool = False
    max_res: int = 2048
    log2_hashmap_size: int = 19
    num_grid_levels: int = 3
    grid_features_per_level: int = 8
    proposal_type: str = "dense"
    proposal_resolutions: Tuple[int, ...] = (128, 160)
    proposal_mlp_freqs: Tuple[int, ...] = (4, 6)
    proposal_training: str = "distill"
    proposal_table_dtype: str = "float32"
    proposal_refresh_every: int = 16
    proposal_refresh_bricks: int = 8192
    proposal_distill_points: int = 4096
    proposal_distill_loss_mult: float = 1.0
    proposal_distill_clip: float = 10.0
    model_axis: Optional[str] = None
    model_axis_size: int = 1
    descriptor_sharding: bool = False
    table_grad_phase: bool = False
    sampler: str = "proposal"
    num_occ_bins: int = 128
    occupancy: O.OccupancyConfig = O.OccupancyConfig()


def check_ported(cfg: NerfactoConfig) -> None:
    """Raise NotImplementedError for a configuration this port does not
    run yet."""
    unported = {
        "proposal_type": (cfg.proposal_type, ("dense",)),
        "proposal_training": (cfg.proposal_training, ("distill",)),
        "proposal_table_dtype": (cfg.proposal_table_dtype, ("float32",)),
        "sampler": (cfg.sampler, ("proposal", "occupancy")),
        "grad_normal_mode": (cfg.grad_normal_mode, ("surface", "none")),
        "table_grad_phase": (cfg.table_grad_phase, (False,)),
        "model_axis": (cfg.model_axis, (None,)),
        "descriptor_sharding": (cfg.descriptor_sharding, (False,)),
    }
    for name, (value, ok) in unported.items():
        if value not in ok:
            raise NotImplementedError(
                f"NerfactoConfig.{name}={value!r} is not ported (ported: "
                f"{ok})")


class NerfactoModel(nn.Module):
    """Proposal fields + field; parameters are this module's. Build it under
    a torch seed for a reproducible random init, or load
    :func:`from_jax_params`'s state dict."""

    def __init__(self, config: NerfactoConfig = NerfactoConfig()):
        super().__init__()
        check_ported(config)
        self.config = config
        common = dict(use_contraction=config.use_contraction,
                      aabb_min=config.aabb_min, aabb_max=config.aabb_max)
        self.proposal_fields = nn.ModuleList(
            DenseProposalField(resolution=r, **common)
            for r in config.proposal_resolutions[
                :len(config.num_proposal_samples)]
            if config.sampler == "proposal")
        self.field = NerfactoField(
            grid=HashGridConfig(config.num_grid_levels,
                                config.grid_features_per_level,
                                config.log2_hashmap_size, 16, config.max_res),
            num_images=config.num_images,
            predict_normals=config.predict_normals,
            **common,
        )
        self._s_to_t = R.SPACINGS[config.spacing][0]

    def uniform_shapes(self, n_rays: int) -> Sequence[Tuple[int, int]]:
        """Shapes of the stratification uniforms of one training render."""
        cfg = self.config
        if cfg.sampler == "occupancy":
            counts = [cfg.num_occ_bins, cfg.num_nerf_samples]
        else:
            counts = list(cfg.num_proposal_samples) + [cfg.num_nerf_samples]
        return [(n_rays, n + 1) for n in counts]

    # -- rendering ---------------------------------------------------------

    def _positions(self, origins, directions, t_mid):
        return origins[..., None, :] + directions[..., None, :] * t_mid[..., None]

    def render(self, origins, directions, camera_indices=None, uniforms=None,
               compute_grad_normals: bool = False, occ_grid=None
               ) -> Dict[str, Any]:
        """Render a batch of rays.

        Args:
          origins/directions: [R, 3] world-frame rays (unit directions).
          camera_indices: [R] keyframe ids for the appearance embedding.
          uniforms: stratification uniforms (see :meth:`uniform_shapes`);
            None samples the deterministic bin centres (evaluation).
          occ_grid: the occupancy grid of ``sampler="occupancy"`` (None
            spreads the samples as if every bin were occupied).

        Returns a dict with rgb [R, 3], depth [R] (euclidean ray distance),
        accumulation [R], the per-level histograms, and the normals.
        """
        cfg = self.config
        n_rays = origins.shape[0]
        u = list(uniforms) if uniforms is not None else [None] * (
            len(cfg.num_proposal_samples) + 1)
        edges_list, weights_list = [], []

        if cfg.sampler == "occupancy":
            # empty-space skipping: occupancy at coarse bin centres weights
            # the PDF resampler
            s_edges = R.uniform_bins(n_rays, cfg.num_occ_bins, u[0],
                                     device=origins.device)
            t_edges = self._s_to_t(s_edges, cfg.near, cfg.far)
            t_mid = 0.5 * (t_edges[..., 1:] + t_edges[..., :-1])
            if occ_grid is not None:
                unit = self.field._to_unit(
                    self._positions(origins, directions, t_mid))
                w = O.bin_weights(occ_grid, unit, cfg.occupancy)
            else:
                w = torch.ones_like(t_mid)
            s_edges = R.sample_pdf(s_edges, w, cfg.num_nerf_samples, u[-1])
        else:
            s_edges = R.uniform_bins(n_rays, cfg.num_proposal_samples[0],
                                     u[0], device=origins.device)
        for i, pf in enumerate(self.proposal_fields):
            t_edges = self._s_to_t(s_edges, cfg.near, cfg.far)
            t_mid = 0.5 * (t_edges[..., 1:] + t_edges[..., :-1])
            deltas = t_edges[..., 1:] - t_edges[..., :-1]
            # distilled proposals carry no gradients
            with torch.no_grad():
                density = pf(self._positions(origins, directions, t_mid))
                weights, _ = R.render_weights(density, deltas)
            edges_list.append(s_edges)
            weights_list.append(weights)
            n_next = (cfg.num_proposal_samples[i + 1]
                      if i + 1 < len(cfg.num_proposal_samples)
                      else cfg.num_nerf_samples)
            s_edges = R.sample_pdf(s_edges, weights, n_next, u[i + 1])

        # final field
        t_edges = self._s_to_t(s_edges, cfg.near, cfg.far)
        t_mid = 0.5 * (t_edges[..., 1:] + t_edges[..., :-1])
        deltas = t_edges[..., 1:] - t_edges[..., :-1]
        pos = self._positions(origins, directions, t_mid)
        density, geo = self.field.density(pos)
        dirs_b = directions[..., None, :].expand(pos.shape)
        rgb_samples = self.field.rgb(geo, dirs_b, camera_indices)

        weights, _ = R.render_weights(density, deltas)
        edges_list.append(s_edges)
        weights_list.append(weights)

        if cfg.background == "last_sample":
            background = rgb_samples[..., -1, :]
        elif cfg.background == "white":
            background = torch.ones(3, device=origins.device)
        else:
            background = torch.zeros(3, device=origins.device)
        rgb = R.composite(weights, rgb_samples, background=background)
        depth = R.render_depth(weights, t_mid)
        acc = R.render_accumulation(weights)

        out = {
            "rgb": rgb,
            "depth": depth,
            "accumulation": acc,
            "s_edges_list": edges_list,
            "weights_list": weights_list,
            "t_mid": t_mid,
            "deltas": deltas,
            "sample_weights": weights,
        }
        if cfg.predict_normals:
            pred_n = self.field.normals(geo)
            out["normals"] = R.composite(weights, pred_n)
            out["sample_pred_normals"] = pred_n
        if compute_grad_normals and cfg.grad_normal_mode == "surface":
            # one density pullback per ray at the rendered expected depth:
            # a first-order gradient with respect to the surface point only,
            # used as a stop-gradient target; geo_s stays in the outer graph
            # (it trains the normal MLP)
            p_surf = (origins + directions * depth[..., None]).detach()
            p_surf = p_surf[..., None, :].requires_grad_(True)
            with torch.enable_grad():
                dens_s, geo_s = self.field.density(p_surf)
                (g,) = torch.autograd.grad(
                    dens_s, p_surf, grad_outputs=torch.ones_like(dens_s),
                    retain_graph=True)
            out["sample_grad_normals"] = -g / torch.linalg.norm(
                g, dim=-1, keepdim=True).clamp(min=1e-7)
            out["surface_pred_normals"] = self.field.normals(geo_s)
            out["surface_weights"] = acc[..., None]
        return out

    # -- losses ------------------------------------------------------------

    def loss(self, batch: Dict[str, Any], uniforms=None, occ_grid=None
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Full training loss on a ray batch.

        batch keys: origins, directions, rgb [R, 3]; optional: depth [R],
        normal [R, 3], depth_cov [R], camera_indices [R], depth_mask,
        normal_mask.
        """
        cfg = self.config
        out = self.render(
            batch["origins"], batch["directions"],
            batch.get("camera_indices"), uniforms=uniforms,
            compute_grad_normals=(cfg.predict_normals
                                  and cfg.grad_normal_mode != "none"),
            occ_grid=occ_grid,
        )
        metrics = {}
        loss = L.rgb_loss(out["rgb"], batch["rgb"])
        metrics["rgb_loss"] = loss

        final_edges = out["s_edges_list"][-1]
        final_w = out["weights_list"][-1]
        if cfg.distortion_loss_mult > 0:
            dist = R.distortion_loss(final_edges, final_w)
            metrics["distortion_loss"] = dist
            loss = loss + cfg.distortion_loss_mult * dist

        if "depth" in batch and cfg.depth_loss_mult > 0:
            if cfg.depth_loss_type == "l2":
                dloss = L.depth_l2_loss(out["depth"], batch["depth"],
                                        depth_cov=batch.get("depth_cov"),
                                        mask=batch.get("depth_mask"))
            else:
                dloss = L.ds_nerf_depth_loss(
                    out["sample_weights"], out["t_mid"], out["deltas"],
                    batch["depth"], cfg.depth_sigma,
                    mask=batch.get("depth_mask"))
            metrics["depth_loss"] = dloss
            loss = loss + cfg.depth_loss_mult * dloss

        if ("normal" in batch and cfg.predict_normals
                and cfg.normal_loss_mult > 0):
            nloss = L.monosdf_normal_loss(out["normals"], batch["normal"],
                                          mask=batch.get("normal_mask"))
            metrics["normal_loss"] = nloss
            loss = loss + cfg.normal_loss_mult * nloss

        if cfg.predict_normals and "sample_grad_normals" in out:
            n_w = out["surface_weights"]
            n_pred = out["surface_pred_normals"]
            oloss = L.orientation_loss(n_w, out["sample_grad_normals"],
                                       batch["directions"])
            ploss = L.pred_normal_loss(n_w, n_pred, out["sample_grad_normals"])
            metrics["orientation_loss"] = oloss
            metrics["pred_normal_loss"] = ploss
            loss = (loss + cfg.orientation_loss_mult * oloss
                    + cfg.pred_normal_loss_mult * ploss)

        metrics["loss"] = loss
        metrics["psnr"] = -10.0 * torch.log10(
            metrics["rgb_loss"].clamp(min=1e-10))
        return loss, {k: v.detach() for k, v in metrics.items()}

    # -- proposal distillation ----------------------------------------------

    @torch.no_grad()
    def refresh_proposals(self, step: int) -> None:
        """Rewrite one rotating brick slab of every proposal grid, in place,
        from the current field density."""
        for pf in self.proposal_fields:
            b0, rows = self._proposal_slab(pf, step)
            pf.tables[b0:b0 + rows.shape[0]] = rows

    @torch.no_grad()
    def _proposal_slab(self, pf, step: int):
        """(first brick, [S, 32] refreshed brick rows) of one proposal
        grid's rotating slab: density logits log(density) + 1 at the 27
        corners of each brick (the 5 pad entries are zero)."""
        cfg = self.config
        res = pf.grid.base_resolution
        bpa = ((res - 1) >> 1) + 1
        nb_real = bpa**3
        S = min(nb_real, cfg.proposal_refresh_bricks)
        n_slabs = max(nb_real // S, 1)
        b0 = ((step // cfg.proposal_refresh_every) % n_slabs) * S
        dev = pf.tables.device
        bids = b0 + torch.arange(S, device=dev)
        bx, by, bz = bids // (bpa * bpa), (bids // bpa) % bpa, bids % bpa
        e = torch.arange(27, device=dev)
        ex, ey, ez = e // 9, (e // 3) % 3, e % 3  # hash_encode's W order
        unit = torch.stack([2 * bx[None, :] + ex[:, None],
                            2 * by[None, :] + ey[:, None],
                            2 * bz[None, :] + ez[:, None]], -1).float() / res
        density = self.field.density_unit(unit)  # [27, S]
        logits = torch.log(density.clamp(1e-8, 1e8)) + 1.0
        rows = torch.cat([logits, logits.new_zeros(5, S)], 0).T
        return b0, rows.contiguous()


    # -- occupancy maintenance ----------------------------------------------

    @torch.no_grad()
    def refresh_occupancy(self, occ_grid, step: int, jitter):
        """One occupancy-grid refresh: this step's rotating cell slab
        re-evaluated against the current field and max-merged. ``jitter``:
        the slab's [res^3 / slab_div, 3] uniforms. Returns the new grid."""
        cfg = self.config.occupancy
        unit, start = O.slab_cell_centers(step, jitter, cfg)
        return O.refresh(occ_grid, self.field.density_unit(unit), start, cfg)


def from_jax_params(params_np) -> Dict[str, torch.Tensor]:
    """The JAX model's ``{"proposal_i": ..., "field": ...}`` parameter tree
    (nested numpy dicts) -> :class:`NerfactoModel`'s ``state_dict``."""
    out = {}
    for key, tree in params_np.items():
        if key == "field":
            prefix = "field."
        elif key.startswith("proposal_"):
            prefix = f"proposal_fields.{int(key.split('_')[1])}."
        else:
            raise KeyError(f"unexpected parameter group {key!r}")
        for name, t in nerf_field.from_jax_params(tree).items():
            out[prefix + name] = t
    return out
