"""Nerfacto-equivalent NeRF model: proposal sampling + hash field + losses.

Counterpart of ``nerf_vo_tpu/models/nerfacto.py``. Two proposal density
fields drive PDF resampling; a hash-grid field renders RGB, depth and
normals; the loss set is RGB MSE + interlevel + distortion + DS-NeRF (or L2)
depth + monosdf normal + orientation / predicted-normal (+ the MLP
proposals' distillation).

Proposal fields (``proposal_type``): "dense" grids (f32 or bf16 tables,
``proposal_table_dtype``), nerfstudio's "hash" grid + MLP, or a Fourier
"mlp". How they train (``proposal_training``): "distill" (default) keeps
their density out of the graph; dense grids are then rewritten slab by
slab from the field (:meth:`NerfactoModel.refresh_proposals`) and MLP
proposals regress the field's log-density in the loss. "interlevel"
(nerfacto's own) keeps their density in the graph, so the interlevel loss
trains them and the pose gradient runs through their samples too.
Density-gradient normals (``grad_normal_mode``) are taken at every final
sample ("samples", nerfacto's) or at one surface point a ray ("surface").

The Instant-NGP mapper (``sampler="occupancy"``) has no proposal fields:
occupancy-grid weights at 128 uniform coarse bins drive the PDF resampler
(``ops/occupancy.py``), and :meth:`NerfactoModel.refresh_occupancy`
re-evaluates a rotating slab of the grid from the current field.

Neuralangelo's SDF mapper (``sampler="sdf"``, :class:`nerf_field.SDFField`,
a port-only mapper with no JAX counterpart) renders a signed distance
field by NeuS: 64 stratified samples between the ray's entry and exit of
the scene's unit sphere, then ``upsample_rounds`` of NeuS's up-sampling
(16 samples each, merged by a sort) under the segment span
``map.sdf_upsample``; the SDF and its feature at every final sample and
at its four taps (one encode) under ``map.taps``, where the taps' finite
differences give the SDF's gradient and Laplacian; the colour MLP under
``map.field``; NeuS's alphas, the photometric L1, eikonal and curvature
terms under ``map.loss``. Its step-dependent state (active levels, tap
spacing, curvature weight, cosine anneal) comes in as the device tensor
``schedule`` (:meth:`NerfactoModel.schedule_values`, set by the trainer).

Every path of the JAX model is ported; a ``sampler`` other than "proposal",
"occupancy" or "sdf" raises ``NotImplementedError``. ``model_axis`` names
the axis of the mesh the model is given (``NerfactoModel(config, mesh=)``)
over which every table's rows are sharded: each rank holds ``1 /
model_axis_size`` of each table and every encode makes the model axis's
collectives (``ops/hash_grid.py``), so the ranks of a model group run the
same calls in lockstep; ``descriptor_sharding`` routes each rank's own
samples to the rows' owners.

Random numbers come in as arguments: ``uniforms`` is the list of
stratification uniforms of one render (the bin jitter ``[R, S0+1]``, then one
``[R, n+1]`` per PDF resampling), where the JAX package splits a key; and
``distill_points``, the MLP proposals' uniform unit-cube points.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from nerf_vo_tpu_torch.models import nerf_field
from nerf_vo_tpu_torch.models.nerf_field import (
    DenseProposalField,
    HashGridConfig,
    MLPProposalField,
    NerfactoField,
    ProposalDensityField,
    SDFConfig,
    SDFField,
)
from nerf_vo_tpu_torch.ops import losses as L
from nerf_vo_tpu_torch.ops import occupancy as O
from nerf_vo_tpu_torch.ops import rendering as R
from nerf_vo_tpu_torch.parallel import dist as pdist
from nerf_vo_tpu_torch.runtime.perf import span


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
    sdf: SDFConfig = SDFConfig()  # sampler="sdf" (port-only)


def check_ported(cfg: NerfactoConfig) -> None:
    """Raise NotImplementedError for a configuration this port does not
    run."""
    ok = ("proposal", "occupancy", "sdf")
    if cfg.sampler not in ok:
        raise NotImplementedError(
            f"NerfactoConfig.sampler={cfg.sampler!r} is not ported (ported: "
            f"{ok}: the nerfstudio, instant-ngp and neuralangelo mappers)")


def _model_axis(cfg: NerfactoConfig, mesh):
    """The model axis (``parallel.dist.Axis``; None without
    ``model_axis``)."""
    if cfg.model_axis is None:
        if cfg.descriptor_sharding:
            raise ValueError("NerfactoConfig.descriptor_sharding=True needs "
                             "model_axis (and the mesh)")
        return None
    if mesh is None:
        raise ValueError(f"NerfactoConfig.model_axis={cfg.model_axis!r} "
                         "needs the mesh: NerfactoModel(config, mesh=)")
    axis = pdist.mesh_axis(mesh, cfg.model_axis)
    if axis.size != cfg.model_axis_size:
        raise ValueError(f"NerfactoConfig.model_axis_size="
                         f"{cfg.model_axis_size} but the mesh's "
                         f"{cfg.model_axis!r} axis has {axis.size} ranks")
    return axis


class NerfactoModel(nn.Module):
    """Proposal fields + field; parameters are this module's. Build it under
    a torch seed for a reproducible random init, or load
    :func:`from_jax_params`'s state dict. ``mesh``: the device mesh whose
    ``config.model_axis`` shards the tables (see ``parallel/dist.py``);
    each table parameter is then this rank's row shard."""

    def __init__(self, config: NerfactoConfig = NerfactoConfig(), mesh=None):
        super().__init__()
        check_ported(config)
        self.config = config
        self.model_axis = _model_axis(config, mesh)
        common = dict(use_contraction=config.use_contraction,
                      aabb_min=config.aabb_min, aabb_max=config.aabb_max,
                      model_group=(None if self.model_axis is None
                                   else self.model_axis.group),
                      model_axis_size=config.model_axis_size,
                      descriptor_sharding=config.descriptor_sharding)
        n_prop = len(config.num_proposal_samples)
        if config.proposal_type == "dense":
            fields = [DenseProposalField(
                resolution=r, table_dtype=config.proposal_table_dtype,
                trainable=config.proposal_training != "distill", **common)
                for r in config.proposal_resolutions]
        elif config.proposal_type == "mlp":
            if config.proposal_training != "distill":
                raise ValueError(
                    "MLP proposals have no interlevel gradient path; they "
                    "train by density distillation "
                    "(proposal_training='distill')")
            fields = [MLPProposalField(n_freqs=f, **common)
                      for f in config.proposal_mlp_freqs]
        else:  # "hash": nerfstudio's two HashMLPDensityFields
            fields = [ProposalDensityField(grid=HashGridConfig(
                5, 2, 17, 16, res), hidden=16, **common) for res in (128, 256)]
        self.proposal_fields = nn.ModuleList(
            fields[:n_prop] if config.sampler == "proposal" else [])
        if config.sampler == "sdf":
            self.field = SDFField(
                HashGridConfig(config.num_grid_levels,
                               config.grid_features_per_level,
                               config.log2_hashmap_size,
                               nerf_field.SDF_MIN_RES, config.max_res),
                **{k: v for k, v in common.items()
                   if k != "use_contraction"})
        else:
            self.field = NerfactoField(
                grid=HashGridConfig(config.num_grid_levels,
                                    config.grid_features_per_level,
                                    config.log2_hashmap_size, 16,
                                    config.max_res),
                num_images=config.num_images,
                predict_normals=config.predict_normals,
                **common,
            )
        self._s_to_t = R.SPACINGS[config.spacing][0]

    def uniform_shapes(self, n_rays: int) -> Sequence[Tuple[int, int]]:
        """Shapes of the stratification uniforms of one training render."""
        cfg = self.config
        if cfg.sampler == "sdf":
            return [(n_rays, cfg.sdf.num_samples)]
        if cfg.sampler == "occupancy":
            counts = [cfg.num_occ_bins, cfg.num_nerf_samples]
        else:
            counts = list(cfg.num_proposal_samples) + [cfg.num_nerf_samples]
        return [(n_rays, n + 1) for n in counts]

    # -- rendering ---------------------------------------------------------

    def _positions(self, origins, directions, t_mid):
        return origins[..., None, :] + directions[..., None, :] * t_mid[..., None]

    def render(self, origins, directions, camera_indices=None, uniforms=None,
               compute_grad_normals: bool = False, occ_grid=None, step=None,
               schedule=None) -> Dict[str, Any]:
        """Render a batch of rays.

        Args:
          origins/directions: [R, 3] world-frame rays (unit directions).
          camera_indices: [R] keyframe ids for the appearance embedding.
          uniforms: stratification uniforms (see :meth:`uniform_shapes`);
            None samples the deterministic bin centres (evaluation).
          occ_grid: the occupancy grid of ``sampler="occupancy"`` (None
            spreads the samples as if every bin were occupied).
          step: the train step; with ``table_grad_phase`` it phases the
            field's table gradient (training renders only).
          schedule: under ``sampler="sdf"``, the [4] device tensor of
            :meth:`schedule_values` (None: the schedules' end).

        Returns a dict with rgb [R, 3], depth [R] (euclidean ray distance),
        accumulation [R], the per-level histograms, and the normals.
        """
        cfg = self.config
        if cfg.sampler == "sdf":
            return self._render_sdf(origins, directions, uniforms, schedule)
        n_rays = origins.shape[0]
        u = list(uniforms) if uniforms is not None else [None] * (
            len(cfg.num_proposal_samples) + 1)
        edges_list, weights_list = [], []

        if cfg.sampler == "occupancy":
            # empty-space skipping: occupancy at coarse bin centres weights
            # the PDF resampler
            with span("map.occupancy", segment=True):
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
                s_edges = R.sample_pdf(s_edges, w, cfg.num_nerf_samples,
                                       u[-1])
        else:
            s_edges = R.uniform_bins(n_rays, cfg.num_proposal_samples[0],
                                     u[0], device=origins.device)
        for i, pf in enumerate(self.proposal_fields):
            with span("map.proposal"):
                t_edges = self._s_to_t(s_edges, cfg.near, cfg.far)
                t_mid = 0.5 * (t_edges[..., 1:] + t_edges[..., :-1])
                deltas = t_edges[..., 1:] - t_edges[..., :-1]
                pos = self._positions(origins, directions, t_mid)
                if cfg.proposal_training == "distill":
                    # distilled proposals carry no gradients: neither into
                    # their parameters nor along the pose chain
                    with torch.no_grad():
                        density = pf(pos)
                else:  # the interlevel loss trains them
                    density = pf(pos)
                weights, _ = R.render_weights(density, deltas)
                edges_list.append(s_edges)
                weights_list.append(weights)
                n_next = (cfg.num_proposal_samples[i + 1]
                          if i + 1 < len(cfg.num_proposal_samples)
                          else cfg.num_nerf_samples)
                s_edges = R.sample_pdf(s_edges, weights, n_next, u[i + 1])

        with span("map.field"):  # the final field
            t_edges = self._s_to_t(s_edges, cfg.near, cfg.far)
            t_mid = 0.5 * (t_edges[..., 1:] + t_edges[..., :-1])
            deltas = t_edges[..., 1:] - t_edges[..., :-1]
            pos = self._positions(origins, directions, t_mid)
            # phased table gradient: only the main field pass gets the phase
            gp = (step if cfg.table_grad_phase and uniforms is not None
                  else None)
            grad_normals = None
            if compute_grad_normals and cfg.grad_normal_mode == "samples":
                # the density's position gradient at every final sample, a
                # stop-gradient target taken from the same encode
                density, geo, g = self.field.density_and_gradient(pos, gp)
                grad_normals = -g / torch.linalg.norm(
                    g, dim=-1, keepdim=True).clamp(min=1e-7)
            else:
                density, geo = self.field.density(pos, gp)
            dirs_b = directions[..., None, :].expand(pos.shape)
            rgb_samples = self.field.rgb(geo, dirs_b, camera_indices)
            pred_n = self.field.normals(geo) if cfg.predict_normals else None

        with span("map.loss"):  # compositing
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
            if (uniforms is not None and cfg.proposal_type == "mlp"
                    and cfg.proposal_training == "distill"):
                # the MLP proposals' free distillation targets (see loss())
                out["sample_positions"] = pos
                out["sample_density"] = density
            if pred_n is not None:
                out["normals"] = R.composite(weights, pred_n)
                out["sample_pred_normals"] = pred_n
            if grad_normals is not None:
                out["sample_grad_normals"] = grad_normals
        if compute_grad_normals and cfg.grad_normal_mode == "surface":
            # one density pullback per ray at the rendered expected depth:
            # a first-order gradient with respect to the surface point only,
            # used as a stop-gradient target; geo_s stays in the outer graph
            # (it trains the normal MLP)
            with span("map.field"):
                p_surf = (origins + directions * depth[..., None]).detach()
                _, geo_s, g = self.field.density_and_gradient(
                    p_surf[..., None, :])
                out["sample_grad_normals"] = -g / torch.linalg.norm(
                    g, dim=-1, keepdim=True).clamp(min=1e-7)
                out["surface_pred_normals"] = self.field.normals(geo_s)
                out["surface_weights"] = acc[..., None]
        return out

    # -- losses ------------------------------------------------------------

    def loss(self, batch: Dict[str, Any], uniforms=None, occ_grid=None,
             step=None, distill_points=None, schedule=None
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Full training loss on a ray batch.

        batch keys: origins, directions, rgb [R, 3]; optional: depth [R],
        normal [R, 3], depth_cov [R], camera_indices [R], depth_mask,
        normal_mask. ``step``: the train step (``table_grad_phase``);
        ``distill_points``: the MLP proposals' ``[proposal_distill_points,
        3]`` uniform unit-cube points; ``schedule``: under
        ``sampler="sdf"``, :meth:`render`'s.
        """
        cfg = self.config
        if cfg.sampler == "sdf":
            return self._loss_sdf(batch, uniforms, schedule)
        out = self.render(
            batch["origins"], batch["directions"],
            batch.get("camera_indices"), uniforms=uniforms,
            compute_grad_normals=(cfg.predict_normals
                                  and cfg.grad_normal_mode != "none"),
            occ_grid=occ_grid, step=step,
        )
        with span("map.loss"):
            metrics = {}
            loss = L.rgb_loss(out["rgb"], batch["rgb"])
            metrics["rgb_loss"] = loss

            final_edges = out["s_edges_list"][-1]
            final_w = out["weights_list"][-1]
            if (cfg.interlevel_loss_mult > 0
                    and cfg.proposal_training != "distill"):
                # each proposal histogram against the final one
                inter = 0.0
                for pe, pw in zip(out["s_edges_list"][:-1],
                                  out["weights_list"][:-1]):
                    inter = inter + R.interlevel_loss(pe, pw, final_edges,
                                                      final_w)
                metrics["interlevel_loss"] = inter
                loss = loss + cfg.interlevel_loss_mult * inter

            if (cfg.proposal_training == "distill"
                    and cfg.proposal_type == "mlp"
                    and len(self.proposal_fields)):
                # MLP-proposal distillation: each proposal's logit regressed
                # onto the field's log-density (stop-gradient) at this step's
                # final samples and at the uniform unit-cube points
                c = cfg.proposal_distill_clip
                pts = out["sample_positions"].detach()
                tgt = torch.log(out["sample_density"].detach().clamp(
                    min=1e-30)).clamp(-c, c)
                with torch.no_grad():
                    dens_u = self.field.density_unit(distill_points)
                tgt_u = torch.log(dens_u.clamp(min=1e-30)).clamp(-c, c)
                dloss = 0.0
                for pf in self.proposal_fields:
                    ls = pf.logit(pts) - 1.0
                    lu = pf.logit_unit(distill_points) - 1.0
                    dloss = (dloss + torch.mean(torch.square(ls - tgt))
                             + torch.mean(torch.square(lu - tgt_u)))
                metrics["proposal_distill_loss"] = dloss
                loss = loss + cfg.proposal_distill_loss_mult * dloss
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
                # surface mode: one accumulation-weighted point a ray; samples
                # mode: every final sample
                if cfg.grad_normal_mode == "surface":
                    n_w = out["surface_weights"]
                    n_pred = out["surface_pred_normals"]
                else:
                    n_w = out["sample_weights"]
                    n_pred = out["sample_pred_normals"]
                oloss = L.orientation_loss(n_w, out["sample_grad_normals"],
                                           batch["directions"])
                ploss = L.pred_normal_loss(n_w, n_pred,
                                           out["sample_grad_normals"])
                metrics["orientation_loss"] = oloss
                metrics["pred_normal_loss"] = ploss
                loss = (loss + cfg.orientation_loss_mult * oloss
                        + cfg.pred_normal_loss_mult * ploss)

            metrics["loss"] = loss
            metrics["psnr"] = -10.0 * torch.log10(
                metrics["rgb_loss"].clamp(min=1e-10))
        return loss, {k: v.detach() for k, v in metrics.items()}

    # -- the SDF mapper (sampler="sdf") --------------------------------------

    def schedule_values(self, step: int) -> Tuple[float, ...]:
        """Neuralangelo's step-dependent state at ``step``: (active levels,
        the taps' eps = 1 / res[active - 1], the curvature weight
        ``SDF_CURVATURE_MULT / growth**(active - c2f_init)``, the cosine
        anneal's ratio)."""
        sc, grid = self.config.sdf, self.field.grid
        L = grid.n_levels
        active = min(L, sc.c2f_init + step // sc.c2f_step)
        growth = (math.exp((math.log(grid.max_resolution)
                            - math.log(grid.base_resolution)) / (L - 1))
                  if L > 1 else 1.0)
        eps = 1.0 / grid.resolutions[active - 1]
        curv = (nerf_field.SDF_CURVATURE_MULT
                / growth ** (active - sc.c2f_init))
        anneal = min(step / sc.anneal_end, 1.0) if sc.anneal_end else 1.0
        return float(active), eps, curv, anneal

    def sdf_points(self, n_rays: int) -> Dict[str, int]:
        """The points the SDF field evaluates in one training render, by
        pass: the up-sampling's (no gradient), the final samples' and
        their taps'; and ``feature``, the points whose feature rows the
        SDF MLP runs (:meth:`SDFField.sdf_and_feature`: the final samples
        alone; every other point takes the SDF row alone)."""
        sc = self.config.sdf
        final = sc.num_samples + sc.upsample_rounds * sc.num_importance
        return {"upsample": n_rays * (sc.num_samples + (
                    sc.upsample_rounds - 1) * sc.num_importance),
                "final": n_rays * final,
                "taps": n_rays * final * len(nerf_field.SDF_TAPS),
                "feature": n_rays * final}

    def _render_sdf(self, origins, directions, uniforms, schedule):
        sc = self.config.sdf
        f = self.field
        R_ = origins.shape[0]
        dev = origins.device
        if schedule is None:
            schedule = torch.tensor(self.schedule_values(1 << 30),
                                    device=dev)
        active, eps, anneal = schedule[0], schedule[1], schedule[3]
        o = f.to_sphere(origins)
        d = directions
        with span("map.sdf_upsample", segment=True):
            near, far = R.sphere_bounds(o, d)
            u = (uniforms[0] if uniforms is not None else torch.full(
                (R_, sc.num_samples), 0.5, device=dev))
            with torch.no_grad():
                o_, d_ = o.detach(), d.detach()

                def points(z):
                    return o_[:, None, :] + d_[:, None, :] * z[..., None]

                z = R.stratified_depths(near.detach(), far.detach(), u)
                sdf = f.sdf_value(points(z), active)
                for h in range(sc.upsample_rounds):
                    new = R.neus_upsample(o_, d_, z, sdf, sc.num_importance,
                                          nerf_field.SDF_UPSAMPLE_INV_S
                                          * 2**h)
                    z, order = torch.sort(torch.cat([z, new], -1), dim=-1)
                    if h + 1 < sc.upsample_rounds:
                        sdf = torch.gather(torch.cat(
                            [sdf, f.sdf_value(points(new), active)], -1),
                            -1, order)
        with span("map.taps"):
            # the final samples and their four taps in one encode
            x = o[:, None, :] + d[:, None, :] * z[..., None]  # [R, S, 3]
            e = eps * (1.0 / math.sqrt(3.0))
            x5 = torch.cat([x[..., None, :],
                            x[..., None, :] + e * f.taps], dim=-2)
            s5, feature = f.sdf_and_feature(x5, active)  # [R, S, 5]
            sdf, s_taps = s5[..., 0], s5[..., 1:]
            grad = torch.sum(s_taps[..., None] * f.taps, dim=-2) / (4.0 * e)
            laplacian = (torch.sum(s_taps, -1) * 0.5 - 2.0 * sdf) / (e * e)
        with span("map.field"):
            normals = grad / torch.linalg.vector_norm(
                grad, dim=-1, keepdim=True).clamp(min=1e-12)
            rgb_s = f.rgb(x, d[:, None, :].expand(x.shape), normals,
                          feature)
        with span("map.loss"):
            alpha = R.neus_alphas(sdf, grad, d, z, far,
                                  torch.exp(f.s_var), anneal)
            w = R.alpha_weights(alpha)
            acc = R.render_accumulation(w)
            return {
                "rgb": R.composite(w, rgb_s),
                "depth": f.radius * torch.sum(w * z, -1) / acc.clamp(
                    min=1e-10),
                "accumulation": acc,
                "sample_weights": w,
                "sample_depths": z,
                "sample_gradients": grad,
                "sample_laplacian": laplacian,
            }

    def _loss_sdf(self, batch, uniforms, schedule):
        out = self._render_sdf(batch["origins"], batch["directions"],
                               uniforms, schedule)
        with span("map.loss"):
            rgb_loss = L.rgb_l1_loss(out["rgb"], batch["rgb"])
            eik = L.eikonal_loss(out["sample_gradients"])
            curv = L.curvature_loss(out["sample_laplacian"])
            curv_mult = (schedule[2] if schedule is not None
                         else self.schedule_values(1 << 30)[2])
            loss = (rgb_loss + nerf_field.SDF_EIKONAL_MULT * eik
                    + curv_mult * curv)
            mse = torch.mean((out["rgb"] - batch["rgb"]) ** 2)
            metrics = {"rgb_loss": rgb_loss, "eikonal_loss": eik,
                       "curvature_loss": curv, "loss": loss,
                       "psnr": -10.0 * torch.log10(mse.clamp(min=1e-10))}
        return loss, {k: v.detach() for k, v in metrics.items()}

    # -- proposal distillation ----------------------------------------------

    @torch.no_grad()
    def refresh_proposals(self, step: int) -> None:
        """Rewrite one rotating brick slab of every dense proposal grid, in
        place, from the current field density (rounded to nearest even in a
        bf16 table). With a model axis the slab is computed through the
        sharded field on every rank alike, and each rank writes the rows it
        holds (the JAX package's ``_tp_refresh_proposals``)."""
        if self.config.proposal_type != "dense":
            raise ValueError("refresh_proposals needs dense proposal grids")
        for pf in self.proposal_fields:
            b0, rows = self._proposal_slab(pf, step)
            if self.model_axis is None:
                pf.tables[b0:b0 + rows.shape[0]] = rows
                continue
            R = pf.tables.shape[0]
            base = self.model_axis.index * R
            lo, hi = max(b0, base), min(b0 + rows.shape[0], base + R)
            if lo < hi:
                pf.tables[lo - base:hi - base] = rows[lo - b0:hi - b0]

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
    def refresh_occupancy(self, occ_grid, step, jitter):
        """One occupancy-grid refresh: this step's rotating cell slab
        re-evaluated against the current field and max-merged. ``step``: an
        int or a 0-dim integer tensor on the grid's device (see
        ``ops/occupancy.py``); ``jitter``: the slab's [res^3 / slab_div, 3]
        uniforms. Returns the new grid."""
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
