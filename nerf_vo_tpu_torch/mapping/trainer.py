"""Online NeRF mapping trainer: sample -> render -> loss -> update.

Counterpart of ``nerf_vo_tpu/mapping/trainer.py``. One train step samples a
ray batch from the keyframe buffer, renders, computes the loss set, and
applies Adam to the field parameters (lr 1e-2, eps 1e-15) and to the
per-keyframe SE3 pose corrections (Adam, eps 1e-8, lr decaying
exponentially from 1e-4 to 1e-5 over ``max_iterations``; keyframe 0, the
gauge anchor, frozen). One Adam holds every trainable parameter (the
proposal fields' too, except distilled dense grids, which require no grad
and hold no moments); a bf16 parameter (a dense grid under
``proposal_table_dtype: bfloat16`` trained by the interlevel loss) gets its
gradient in bf16 and bf16 moments, as optax keeps a parameter's dtype.
Distilled dense proposal grids take no optimizer step; every
``proposal_refresh_every`` steps their rotating slab is rewritten from the
updated field. Under ``sampler="occupancy"`` the train state carries the
occupancy grid, refreshed from the updated field every
``occupancy.update_every`` steps.

Prefetch (``TrainerConfig.prefetch_batch``, by default on where
``NERF_VO_PREFETCH_BATCH=1``, as in the JAX package; the port reads the
variable when a config is made, the JAX package at import): step t trains
on the pixel batch (picks and pixel values) sampled during step t-1, and
samples step t+1's; the first call fills the buffer first. Rays are still
made from the current pose corrections.

Random draws: ``train_step(state, buffer, draws)`` takes the step's pixel
picks and stratification uniforms when given (``{"frame", "py", "px",
"uniforms"}``, plus ``"occ_jitter"`` on an occupancy refresh step,
``"distill_points"`` under MLP proposals and, in prefetch mode, ``"fill"``
picks for the first call; see :meth:`MappingTrainer.draws`), else draws
them from the trainer's own ``torch.Generator``. In prefetch mode the picks
are the next step's batch.

Spans (``runtime/perf.py``; open only under a profiler): a step's parts
are ``map.sample`` (the draws, and the ray batch), ``map.forward`` (the
loss, with the model's ``map.proposal`` / ``map.field`` / ``map.loss``
inside), ``map.backward`` (the gradient into each leaf's ``.grad``) and
``map.optimizer`` (:meth:`MappingTrainer.update`).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Tuple

import torch

from nerf_vo_tpu_torch.core import cameras, conventions, lie
from nerf_vo_tpu_torch.mapping import keyframe_buffer as kb
from nerf_vo_tpu_torch.models.nerfacto import NerfactoModel
from nerf_vo_tpu_torch.ops import occupancy as O
from nerf_vo_tpu_torch.runtime.perf import span


def _prefetch_default() -> bool:
    return os.environ.get("NERF_VO_PREFETCH_BATCH", "0") == "1"


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    rays_per_batch: int = 4096
    learning_rate: float = 1e-2  # fields and proposals (Adam)
    camera_learning_rate: float = 1e-4
    camera_lr_final: float = 1e-5
    max_iterations: int = 8192  # mapping_iterations
    optimize_extrinsics: bool = True
    eps: float = 1e-15
    prefetch_batch: bool = dataclasses.field(
        default_factory=_prefetch_default)


@dataclasses.dataclass
class TrainState:
    """The trained tensors and their optimizers. ``params`` are the
    model's trainable parameters by name (the tensors themselves: an
    optimizer step updates them in place)."""

    params: Dict[str, torch.Tensor]
    pose_deltas: torch.Tensor  # [K, 6]
    opt: torch.optim.Adam
    cam_opt: torch.optim.Adam
    step: int
    occ_grid: Optional[torch.Tensor] = None  # [res^3] under "occupancy"
    prefetch: Optional[Dict] = None  # next step's pixel batch (prefetch)


class MappingTrainer:
    def __init__(self, model: NerfactoModel, config: TrainerConfig,
                 num_keyframes: int, device="cuda", seed: int = 7):
        self.model = model.to(device)
        self.config = config
        self.num_keyframes = num_keyframes
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)

    def init(self) -> TrainState:
        """Optimizer state for the model's current parameters. Distilled
        dense proposal grids do not require grad, so Adam never holds
        moments for them."""
        params = {n: p for n, p in self.model.named_parameters()
                  if p.requires_grad}
        pose_deltas = torch.zeros(self.num_keyframes, 6, device=self.device,
                                  requires_grad=True)
        cfg = self.config
        return TrainState(
            params=params,
            pose_deltas=pose_deltas,
            opt=torch.optim.Adam(list(params.values()), lr=cfg.learning_rate,
                                 eps=cfg.eps),
            cam_opt=torch.optim.Adam([pose_deltas],
                                     lr=cfg.camera_learning_rate, eps=1e-8),
            step=0,
            occ_grid=(O.create(self.model.config.occupancy, self.device)
                      if self.model.config.sampler == "occupancy" else None),
        )

    def camera_lr(self, step: int) -> float:
        """Exponential decay from camera_learning_rate to camera_lr_final
        over max_iterations, at the step count before the update."""
        cfg = self.config
        rate = cfg.camera_lr_final / cfg.camera_learning_rate
        return cfg.camera_learning_rate * rate ** (
            step / max(cfg.max_iterations, 1))

    def _refreshes_occupancy(self, state: TrainState) -> bool:
        return (state.occ_grid is not None and state.step
                % self.model.config.occupancy.update_every == 0)

    def _distills_mlp(self) -> bool:
        mcfg = self.model.config
        return (mcfg.proposal_training == "distill"
                and mcfg.proposal_type == "mlp"
                and len(self.model.proposal_fields) > 0)

    def refreshes_proposals(self, state: TrainState) -> bool:
        """Whether this step ends with the proposal refresh: distilled
        DENSE grids only (MLP proposals distill in the loss, other
        proposals train by gradient), every ``proposal_refresh_every``
        steps."""
        mcfg = self.model.config
        return (mcfg.proposal_training == "distill"
                and mcfg.proposal_type == "dense"
                and len(self.model.proposal_fields) > 0
                and state.step % mcfg.proposal_refresh_every == 0)

    def draws(self, buffer: kb.KeyframeBuffer, state: TrainState,
              n_rays: Optional[int] = None, generators=None) -> Dict:
        """One step's random draws from the trainer's generator: pixel
        picks (in prefetch mode the next step's, plus the first call's
        ``fill``), stratification uniforms, on an occupancy refresh step
        the slab jitter ``occ_jitter``, and under MLP proposals the
        distillation's ``distill_points``.

        A parallel step's draws: ``n_rays``, its share of the batch (no
        prefetch), and ``generators`` = (rays, refresh): the pixel picks
        and uniforms from its rank's generator, the refresh draws from one
        that is alike on every rank."""
        R = n_rays or self.config.rays_per_batch
        g_rays, g_refresh = generators or (self.generator, self.generator)
        with span("map.sample"):
            d = kb.draw_pixels(buffer, R, g_rays)
            if (n_rays is None and self.config.prefetch_batch
                    and state.prefetch is None):
                d["fill"] = kb.draw_pixels(buffer, R, g_rays)
            d["uniforms"] = [
                torch.rand(shape, generator=g_rays, device=self.device)
                for shape in self.model.uniform_shapes(R)]
            if self._refreshes_occupancy(state):
                d["occ_jitter"] = torch.rand(
                    O.slab_size(self.model.config.occupancy), 3,
                    generator=g_refresh, device=self.device)
            if self._distills_mlp():
                d["distill_points"] = torch.rand(
                    self.model.config.proposal_distill_points, 3,
                    generator=g_refresh, device=self.device)
        return d

    def train_step(self, state: TrainState, buffer: kb.KeyframeBuffer,
                   draws: Optional[Dict] = None
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """One optimization step, in place on ``state``: :meth:`gradients`,
        then :meth:`update` (the two Adam updates, then on the updated
        field the dense proposal grids' refresh when ``step %
        proposal_refresh_every == 0`` (distilled dense grids only) or the
        occupancy refresh when ``step % occupancy.update_every == 0``,
        then step + 1)."""
        if draws is None:
            draws = self.draws(buffer, state)
        metrics = self.gradients(state, buffer, draws)
        self.update(state, draws)
        return state, metrics

    def leaves(self, state: TrainState) -> List[torch.Tensor]:
        """The tensors a step differentiates: the trainable parameters,
        then the pose corrections when they are optimized."""
        leaves = list(state.params.values())
        if self.config.optimize_extrinsics:
            leaves.append(state.pose_deltas)
        return leaves

    def gradients(self, state: TrainState, buffer: kb.KeyframeBuffer,
                  draws: Dict, n_rays: Optional[int] = None
                  ) -> Dict[str, torch.Tensor]:
        """The loss of one step's batch; its gradient goes into the
        ``.grad`` of every leaf (:meth:`leaves`; zero where the loss does
        not reach it), where a parallel step averages it before
        :meth:`update`. Returns the loss terms.

        ``n_rays``: a parallel step's share of the batch. The batch is then
        sampled without prefetch and the loss is taken without the train
        step (no phased table gradient), as the JAX package's parallel
        steps do."""
        cfg = self.config
        deltas = state.pose_deltas if cfg.optimize_extrinsics else None
        step = state.step
        with span("map.sample"):
            if n_rays is not None:
                batch = kb.sample_ray_batch(buffer, deltas, n_rays,
                                            picks=draws)
                step = None
            elif cfg.prefetch_batch:
                R = cfg.rays_per_batch
                if state.prefetch is None:  # the first call fills the buffer
                    state.prefetch = kb.sample_pixel_batch(
                        buffer, R, draws.get("fill"), self.generator)
                pixels = state.prefetch
                # the next step's batch, sampled before this step's update
                state.prefetch = kb.sample_pixel_batch(buffer, R, picks=draws)
                batch = kb.rays_from_pixel_batch(buffer, deltas, pixels)
            else:
                batch = kb.sample_ray_batch(buffer, deltas,
                                            cfg.rays_per_batch, picks=draws)
        with span("map.forward"):
            loss, metrics = self.model.loss(
                batch, draws["uniforms"], occ_grid=state.occ_grid,
                step=step, distill_points=draws.get("distill_points"))

        with span("map.backward"):
            leaves = self.leaves(state)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            for p, g in zip(leaves, grads):
                # a bf16 parameter steps in bf16, as optax keeps its dtype
                p.grad = torch.zeros_like(p) if g is None else g.to(p.dtype)
        return metrics

    def update(self, state: TrainState, draws: Dict) -> None:
        """Apply the leaves' ``.grad`` (Adam; keyframe 0's pose gradient
        zeroed first: the gauge anchor), clear them, run the step's
        refreshes, step + 1."""
        cfg = self.config
        with span("map.optimizer"):
            state.opt.step()
            if cfg.optimize_extrinsics:
                state.pose_deltas.grad[0] = 0.0  # keyframe 0: the gauge anchor
                for group in state.cam_opt.param_groups:
                    group["lr"] = self.camera_lr(state.step)
                state.cam_opt.step()
            for p in self.leaves(state):
                p.grad = None

            if self.refreshes_proposals(state):
                self.model.refresh_proposals(state.step)
            if self._refreshes_occupancy(state):
                state.occ_grid = self.model.refresh_occupancy(
                    state.occ_grid, state.step, draws["occ_jitter"])
            state.step += 1

    # ------------------------------------------------------------------

    @torch.no_grad()
    def optimized_c2w(self, state: TrainState, buffer: kb.KeyframeBuffer):
        """Per-keyframe poses with the learned SE3 corrections applied."""
        delta = lie.se3_matrix(lie.se3_exp(state.pose_deltas))
        return conventions.apply_transform(delta, buffer.c2w)

    @torch.no_grad()
    def render_image(self, state: TrainState, c2w, intrinsics, height: int,
                     width: int, chunk: int = 1 << 14, chunk_fn=None
                     ) -> Dict[str, torch.Tensor]:
        """Full-frame render in ray chunks with deterministic samples:
        rgb [H, W, 3], z-depth [H, W], accumulation [H, W].

        ``chunk_fn(origins, directions, occ_grid)`` replaces the
        single-device chunk renderer: ``parallel.sharding.
        make_dp_render_chunk`` shards each chunk's rays over a mesh."""
        dev = self.device
        c2w = torch.as_tensor(c2w, dtype=torch.float32, device=dev)
        intrinsics = torch.as_tensor(intrinsics, dtype=torch.float32,
                                     device=dev)
        ys, xs = torch.meshgrid(
            torch.arange(height, dtype=torch.float32, device=dev),
            torch.arange(width, dtype=torch.float32, device=dev),
            indexing="ij")
        xy = torch.stack([xs, ys], -1).reshape(-1, 2) + 0.5
        o, d, dn = cameras.generate_rays(c2w, intrinsics, xy, "opengl")
        outs = {"rgb": [], "depth": [], "accumulation": []}
        render = chunk_fn or (lambda o, d, occ: self.model.render(
            o, d, occ_grid=occ))
        for i in range(0, xy.shape[0], chunk):
            r = render(o[i:i + chunk], d[i:i + chunk], state.occ_grid)
            for k in outs:
                outs[k].append(r[k])
        cat = {k: torch.cat(v) for k, v in outs.items()}
        return {
            "rgb": cat["rgb"].reshape(height, width, 3),
            # euclidean ray distance -> z-depth
            "depth": (cat["depth"] / dn[:, 0]).reshape(height, width),
            "accumulation": cat["accumulation"].reshape(height, width),
        }
