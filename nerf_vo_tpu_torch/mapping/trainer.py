"""Online NeRF mapping trainer: sample -> render -> loss -> update.

Counterpart of ``nerf_vo_tpu/mapping/trainer.py``. One train step samples a
ray batch from the keyframe buffer, renders, computes the loss set, and
applies Adam to the field parameters (lr 1e-2, eps 1e-15) and to the
per-keyframe SE3 pose corrections (Adam, eps 1e-8, lr decaying
exponentially from 1e-4 to 1e-5 over ``max_iterations``; keyframe 0, the
gauge anchor, frozen). The distilled proposal grids take no optimizer
step; every ``proposal_refresh_every`` steps their rotating slab is
rewritten from the updated field. Under ``sampler="occupancy"`` the train
state carries the occupancy grid, refreshed from the updated field every
``occupancy.update_every`` steps.

Random draws: ``train_step(state, buffer, draws)`` takes the step's pixel
picks and stratification uniforms when given (``{"frame", "py", "px",
"uniforms"}``, plus ``"occ_jitter"`` on an occupancy refresh step; see
:meth:`MappingTrainer.draws`), else draws them from the trainer's own
``torch.Generator``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from nerf_vo_tpu_torch.core import cameras, conventions, lie
from nerf_vo_tpu_torch.mapping import keyframe_buffer as kb
from nerf_vo_tpu_torch.models.nerfacto import NerfactoModel
from nerf_vo_tpu_torch.ops import occupancy as O


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    rays_per_batch: int = 4096
    learning_rate: float = 1e-2  # fields (Adam)
    camera_learning_rate: float = 1e-4
    camera_lr_final: float = 1e-5
    max_iterations: int = 8192  # mapping_iterations
    optimize_extrinsics: bool = True
    eps: float = 1e-15


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
        proposal grids do not require grad, so Adam never holds moments for
        them."""
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

    def draws(self, buffer: kb.KeyframeBuffer, state: TrainState) -> Dict:
        """One step's random draws from the trainer's generator: pixel
        picks, stratification uniforms and, on an occupancy refresh step,
        the slab jitter ``occ_jitter``."""
        R = self.config.rays_per_batch
        d = kb.draw_pixels(buffer, R, self.generator)
        d["uniforms"] = [
            torch.rand(shape, generator=self.generator, device=self.device)
            for shape in self.model.uniform_shapes(R)]
        if self._refreshes_occupancy(state):
            d["occ_jitter"] = torch.rand(
                O.slab_size(self.model.config.occupancy), 3,
                generator=self.generator, device=self.device)
        return d

    def train_step(self, state: TrainState, buffer: kb.KeyframeBuffer,
                   draws: Optional[Dict] = None
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """One optimization step, in place on ``state``: grads, the two
        Adam updates, then on the updated field the proposal refresh when
        ``step % proposal_refresh_every == 0`` or the occupancy refresh when
        ``step % occupancy.update_every == 0``, then step + 1."""
        if draws is None:
            draws = self.draws(buffer, state)
        cfg = self.config
        deltas = state.pose_deltas if cfg.optimize_extrinsics else None
        batch = kb.sample_ray_batch(buffer, deltas, cfg.rays_per_batch,
                                    picks=draws)
        loss, metrics = self.model.loss(batch, draws["uniforms"],
                                        occ_grid=state.occ_grid)

        leaves: List[torch.Tensor] = list(state.params.values())
        if cfg.optimize_extrinsics:
            leaves.append(state.pose_deltas)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        for p, g in zip(leaves, grads):
            p.grad = torch.zeros_like(p) if g is None else g
        state.opt.step()
        if cfg.optimize_extrinsics:
            state.pose_deltas.grad[0] = 0.0  # keyframe 0: the gauge anchor
            for group in state.cam_opt.param_groups:
                group["lr"] = self.camera_lr(state.step)
            state.cam_opt.step()
        for p in leaves:
            p.grad = None

        mcfg = self.model.config
        if (self.model.proposal_fields
                and state.step % mcfg.proposal_refresh_every == 0):
            self.model.refresh_proposals(state.step)
        if self._refreshes_occupancy(state):
            state.occ_grid = self.model.refresh_occupancy(
                state.occ_grid, state.step, draws["occ_jitter"])
        state.step += 1
        return state, metrics

    # ------------------------------------------------------------------

    @torch.no_grad()
    def optimized_c2w(self, state: TrainState, buffer: kb.KeyframeBuffer):
        """Per-keyframe poses with the learned SE3 corrections applied."""
        delta = lie.se3_matrix(lie.se3_exp(state.pose_deltas))
        return conventions.apply_transform(delta, buffer.c2w)

    @torch.no_grad()
    def render_image(self, state: TrainState, c2w, intrinsics, height: int,
                     width: int, chunk: int = 1 << 14
                     ) -> Dict[str, torch.Tensor]:
        """Full-frame render in ray chunks with deterministic samples:
        rgb [H, W, 3], z-depth [H, W], accumulation [H, W]."""
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
        for i in range(0, xy.shape[0], chunk):
            r = self.model.render(o[i:i + chunk], d[i:i + chunk],
                                  occ_grid=state.occ_grid)
            for k in outs:
                outs[k].append(r[k])
        cat = {k: torch.cat(v) for k, v in outs.items()}
        return {
            "rgb": cat["rgb"].reshape(height, width, 3),
            # euclidean ray distance -> z-depth
            "depth": (cat["depth"] / dn[:, 0]).reshape(height, width),
            "accumulation": cat["accumulation"].reshape(height, width),
        }
