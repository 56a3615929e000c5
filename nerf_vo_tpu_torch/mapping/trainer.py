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
``occupancy.update_every`` steps. Under ``sampler="sdf"`` (Neuralangelo)
the field's leaves take AdamW (``nerf_field.SDF_LEARNING_RATE``, decoupled
weight decay, eps 1e-8) at a learning rate warmed up linearly over
``warm_up_end`` steps and divided by ``SDF_LR_GAMMA`` at each of
``SDF_LR_STEPS``; the state carries the step-dependent ``schedule`` ([4]
on the device: active levels, the taps' eps, the curvature weight, the
cosine anneal; ``NerfactoModel.schedule_values``), set before each step's
forward.

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

CUDA graphs (``mapping/step_graph.py``): on a CUDA device, from the
first step whose optimizers hold their state, :meth:`MappingTrainer.
train_step` captures the step once as CUDA graphs between the hand-written
table-kernel calls, which stay eager, and replays that list at later steps:
the same draws, forward, gradients, Adam updates and kernels, with no
Python forward, autograd or optimizer on the host. A step stays eager where
its own state or inputs say the graphs cannot hold it
(:meth:`MappingTrainer.eager_reason`): a parallel step's share of the batch,
draws other than ``frame`` / ``py`` / ``px`` / ``uniforms`` (the MLP
proposals' distillation points, prefetch's first fill; an occupancy
refresh's ``occ_jitter`` where the state has no grid), prefetch, phased
table gradients. The list is captured
again when a tensor it reads from outside its memory pool has another
address or shape (:meth:`MappingTrainer.graph_key`: the keyframe buffer,
the model's tensors, the optimizers' state, the occupancy grid, the SDF
schedule, the draws' shapes); the keyframe inserts, the dense proposal
refresh and the occupancy refresh write their tensors in place, so they
keep it. After a
graphed step the dense proposal refresh runs eagerly. The occupancy
refresh has graphs of its own on the card, whether its step was graphed
or eager (:meth:`MappingTrainer._occupancy_step`): captured at the first
refresh step, they read the step and the slab's jitter from their own
buffers, so one capture serves every slab, and are replayed at each later
refresh step; they are captured again where a tensor they read has
moved (:meth:`MappingTrainer.occupancy_key`). On the card both Adams are
``capturable`` (their step counts on the device); the camera learning
rate (and the SDF field's) is a device tensor set before each step's
Adam, and the SDF schedule before the step's graphs. Counters:
``captures``, ``replays``, ``eager_steps`` (train steps by how they ran),
``occ_refreshes`` (occupancy refreshes, eager or replayed) and
``sdf_points`` (the points the SDF field evaluated, by pass: ``upsample``,
``final``, ``taps``).

Spans (``runtime/perf.py``; open only under a profiler): a step's parts
are ``map.sample`` (the draws, and the ray batch), ``map.forward`` (the
loss, with the model's ``map.proposal`` / ``map.field`` / ``map.loss``
inside), ``map.backward`` (the gradient into each leaf's ``.grad``) and
``map.optimizer`` (:meth:`MappingTrainer.update`, with the occupancy
refresh's ``map.occ_refresh`` inside). A replayed step opens ``map.replay``
around each graph it replays, and around each table-kernel call, and each
graph of the occupancy sampler's ``map.occupancy`` and ``map.occ_refresh``,
the spans open at it when it was captured (its part, the model's span, the
hash grid's span).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Tuple

import torch

from nerf_vo_tpu_torch.core import cameras, conventions, lie
from nerf_vo_tpu_torch.mapping import keyframe_buffer as kb
from nerf_vo_tpu_torch.mapping import step_graph as sg
from nerf_vo_tpu_torch.models import nerf_field
from nerf_vo_tpu_torch.models.nerfacto import NerfactoModel
from nerf_vo_tpu_torch.ops import occupancy as O
from nerf_vo_tpu_torch.runtime.perf import span


def _prefetch_default() -> bool:
    return os.environ.get("NERF_VO_PREFETCH_BATCH", "0") == "1"


# the draws a replayed step takes (its static buffers hold these); a
# replayed occupancy refresh takes "occ_jitter" into buffers of its own
GRAPH_DRAWS = frozenset({"frame", "py", "px", "uniforms"})


def _addresses(ts) -> tuple:
    """Where tensors ``ts`` are, as a graph reads them."""
    return tuple((t.data_ptr(), tuple(t.shape), t.dtype, t.requires_grad)
                 for t in ts)


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
    schedule: Optional[torch.Tensor] = None  # [4] under "sdf"
    prefetch: Optional[Dict] = None  # next step's pixel batch (prefetch)


def _set_lr(opt: torch.optim.Optimizer, lr: float) -> None:
    for group in opt.param_groups:
        if torch.is_tensor(group["lr"]):
            group["lr"].fill_(lr)
        else:
            group["lr"] = lr


class MappingTrainer:
    def __init__(self, model: NerfactoModel, config: TrainerConfig,
                 num_keyframes: int, device="cuda", seed: int = 7):
        self.model = model.to(device)
        self.config = config
        self.num_keyframes = num_keyframes
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.captures = self.replays = self.eager_steps = 0
        self.occ_refreshes = 0
        self.sdf_points = {"upsample": 0, "final": 0, "taps": 0}
        self.graphs: Optional[sg.StepGraphs] = None
        self.occ_graphs: Optional[sg.StepGraphs] = None

    def init(self) -> TrainState:
        """Optimizer state for the model's current parameters. Distilled
        dense proposal grids do not require grad, so Adam never holds
        moments for them."""
        params = {n: p for n, p in self.model.named_parameters()
                  if p.requires_grad}
        pose_deltas = torch.zeros(self.num_keyframes, 6, device=self.device,
                                  requires_grad=True)
        cfg = self.config
        # on the card the step's graphs hold both Adams: their step counts
        # and the learning rates they set live on the device
        card = self.device.type == "cuda"

        def rate(lr):
            return torch.tensor(lr, device=self.device) if card else lr

        mcfg = self.model.config
        sdf = mcfg.sampler == "sdf"
        if sdf:
            opt = torch.optim.AdamW(list(params.values()),
                                    lr=rate(nerf_field.SDF_LEARNING_RATE),
                                    weight_decay=nerf_field.SDF_WEIGHT_DECAY,
                                    capturable=card)
        else:
            opt = torch.optim.Adam(list(params.values()),
                                   lr=cfg.learning_rate, eps=cfg.eps,
                                   capturable=card)
        cam_opt = torch.optim.Adam([pose_deltas],
                                   lr=rate(cfg.camera_learning_rate),
                                   eps=1e-8, capturable=card)
        for o in (opt, cam_opt):  # eager steps are meant: no warning
            o._warned_capturable_if_run_uncaptured = True
            if card:  # a loaded state's learning rate comes to the device
                o.register_load_state_dict_post_hook(self._lr_to_device)
        return TrainState(
            params=params,
            pose_deltas=pose_deltas,
            opt=opt,
            cam_opt=cam_opt,
            step=0,
            occ_grid=(O.create(mcfg.occupancy, self.device)
                      if mcfg.sampler == "occupancy" else None),
            schedule=(torch.zeros(4, device=self.device)
                      if sdf else None),
        )

    def _lr_to_device(self, opt: torch.optim.Optimizer) -> None:
        for group in opt.param_groups:
            if torch.is_tensor(group["lr"]):
                group["lr"] = group["lr"].to(self.device)

    def camera_lr(self, step: int) -> float:
        """Exponential decay from camera_learning_rate to camera_lr_final
        over max_iterations, at the step count before the update."""
        cfg = self.config
        rate = cfg.camera_lr_final / cfg.camera_learning_rate
        return cfg.camera_learning_rate * rate ** (
            step / max(cfg.max_iterations, 1))

    def field_lr(self, step: int) -> float:
        """The SDF field's AdamW learning rate at ``step``: linear warm-up
        to ``SDF_LEARNING_RATE`` over ``warm_up_end`` steps, then divided
        by ``SDF_LR_GAMMA`` past each of ``SDF_LR_STEPS`` (Neuralangelo's
        ``two_steps_with_warmup``)."""
        end = self.model.config.sdf.warm_up_end
        lr = nerf_field.SDF_LEARNING_RATE
        if step < end:
            return lr * step / end
        return lr / nerf_field.SDF_LR_GAMMA ** sum(
            step > s for s in nerf_field.SDF_LR_STEPS)

    def set_schedule(self, state: TrainState) -> None:
        """The SDF schedule of this step into ``state.schedule`` (in place:
        the step's graphs read it from the device); nothing for another
        sampler."""
        if state.schedule is None:
            return
        for i, v in enumerate(self.model.schedule_values(state.step)):
            state.schedule[i].fill_(v)

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
        then step + 1). Where :meth:`eager_reason` finds none, the step up
        to Adam is captured as CUDA graphs, or replays the graphs captured
        before (see the module docstring)."""
        if draws is None:
            draws = self.draws(buffer, state)
        if self.eager_reason(state, draws) is not None:
            self.eager_steps += 1
            metrics = self.gradients(state, buffer, draws)
            self.update(state, draws)
            return state, metrics
        key = self.graph_key(state, buffer, draws)
        if self.graphs is not None and self.graphs.key == key:
            metrics = self._replay(draws)
        else:
            metrics = self._capture(state, buffer, draws, key)
        with span("map.optimizer"):
            self._refresh(state, draws)
        return state, metrics

    def eager_reason(self, state: TrainState, draws: Dict,
                     n_rays: Optional[int] = None) -> Optional[str]:
        """Why a train step with these draws runs eagerly, or None where
        its graphs are captured or replayed: ``"n_rays"`` (a parallel
        step's share of the batch), ``"draws"`` (draws beyond
        :data:`GRAPH_DRAWS` and, where the state has an occupancy grid, the
        refresh's ``occ_jitter``), ``"prefetch"``, ``"grad_phase"`` (phased
        table gradients follow the step count), ``"first_step"`` (an
        optimizer holds no state yet: its first step makes it) or
        ``"device"`` (graphs need the card)."""
        if n_rays is not None:
            return "n_rays"
        held = GRAPH_DRAWS if state.occ_grid is None else GRAPH_DRAWS | {
            "occ_jitter"}
        if not held.issuperset(draws):
            return "draws"
        if self.config.prefetch_batch:
            return "prefetch"
        if self.model.config.table_grad_phase:
            return "grad_phase"
        held = [p for p in state.params.values() if p not in state.opt.state]
        if held or (self.config.optimize_extrinsics
                    and state.pose_deltas not in state.cam_opt.state):
            return "first_step"
        if self.device.type != "cuda":
            return "device"
        return None

    def graph_key(self, state: TrainState, buffer: kb.KeyframeBuffer,
                  draws: Dict) -> tuple:
        """What a captured step reads from outside its memory pool: the
        keyframe buffer's tensors and sizes, the model's parameters and
        buffers, the pose corrections, each optimizer's state and
        learning rates, the occupancy grid, the SDF schedule; and the
        draws' shapes. The graphs replay while it is unchanged."""
        ts = [buffer.intrinsics, buffer.c2w, buffer.pixels, state.pose_deltas]
        if state.schedule is not None:
            ts.append(state.schedule)
        for opt in (state.opt, state.cam_opt):
            for st in opt.state.values():
                ts += [v for v in st.values() if torch.is_tensor(v)]
            ts += [g["lr"] for g in opt.param_groups
                   if torch.is_tensor(g["lr"])]
        picks = [draws[k] for k in ("frame", "py", "px")] + list(
            draws["uniforms"])
        return (buffer.hw, buffer.channels,
                tuple((tuple(t.shape), t.dtype) for t in picks),
                _addresses(ts) + self.occupancy_key(state))

    def occupancy_key(self, state: TrainState) -> tuple:
        """What the occupancy refresh's graphs read from outside their
        memory pool: the model's parameters and buffers and the grid."""
        ts = list(self.model.parameters()) + list(self.model.buffers())
        if state.occ_grid is not None:
            ts.append(state.occ_grid)
        return _addresses(ts)

    def _capture(self, state: TrainState, buffer: kb.KeyframeBuffer,
                 draws: Dict, key: tuple) -> Dict[str, torch.Tensor]:
        """Capture this step (it trains as it is captured) and keep its
        graphs; the step's metrics."""
        if self.graphs is not None:
            self.graphs.release()
            self.graphs = None
        graphs = sg.StepGraphs(self.device, key, sg.draw_buffers(
            {k: draws[k] for k in GRAPH_DRAWS}))

        def run(g: sg.StepGraphs):
            d = g.draws
            if state.schedule is not None:
                g.eager("sample", lambda: self.set_schedule(state))
            with g.segment("sample"):
                batch = self._batch(state, buffer, d)
            with g.segment("forward"):
                loss, metrics = self._forward(state, batch, d, None)
            with g.segment("backward"):
                self._backward(state, loss)
            g.eager("optimizer", lambda: self._set_learning_rates(state))
            with g.segment("optimizer"):
                self._adam(state)
                packed = torch.stack(list(metrics.values()))
            return list(metrics), packed

        graphs.metrics = graphs.capture(run)
        self.graphs = graphs
        self.captures += 1
        return self._metrics()

    def _replay(self, draws: Dict) -> Dict[str, torch.Tensor]:
        """This step by the captured graphs: its draws into their buffers,
        then every graph and table-kernel call in order. The metrics are
        copied out of the graphs' memory (one copy)."""
        with span("map.sample"):
            sg.fill_draws(self.graphs.draws, draws)
        self._count_points(draws)
        self.graphs.replay()
        self.replays += 1
        with span("map.replay"):
            return self._metrics()

    def _occupancy_step(self, state: TrainState,
                        jitter: torch.Tensor) -> None:
        """This step's occupancy refresh. On the card by its graphs,
        captured (and so made) where none are held for
        :meth:`occupancy_key`, else replayed; they read the step and the
        slab's jitter from their own buffers, filled first. Eager on the
        CPU, and under a model axis (its encodes exchange rows between
        ranks, which a graph cannot hold)."""
        self.occ_refreshes += 1
        if self.device.type != "cuda" or self.model.model_axis is not None:
            self._refresh_occupancy(state, state.step, jitter)
            return
        key = self.occupancy_key(state)
        if self.occ_graphs is not None and self.occ_graphs.key == key:
            self.occ_graphs.draws["step"].fill_(state.step)
            self.occ_graphs.draws["occ_jitter"].copy_(jitter)
            self.occ_graphs.replay()
            return
        if self.occ_graphs is not None:
            self.occ_graphs.release()
        graphs = sg.StepGraphs(self.device, key, {
            "step": torch.tensor(state.step, device=self.device),
            "occ_jitter": jitter.clone()})

        def run(g: sg.StepGraphs):
            # its graphs and calls replay inside map.occ_refresh, which
            # the caller's map.optimizer holds
            with g.segment("occ_refresh"):
                self._refresh_occupancy(state, g.draws["step"],
                                        g.draws["occ_jitter"])

        graphs.capture(run)
        self.occ_graphs = graphs

    def _count_points(self, draws: Dict) -> None:
        """``sdf_points``: the SDF field's points of a step of these
        draws."""
        if self.model.config.sampler == "sdf":
            for k, n in self.model.sdf_points(
                    draws["frame"].shape[0]).items():
                self.sdf_points[k] += n

    def _metrics(self) -> Dict[str, torch.Tensor]:
        names, packed = self.graphs.metrics
        return dict(zip(names, packed.clone().unbind(0)))

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
        self.set_schedule(state)
        batch = self._batch(state, buffer, draws, n_rays)
        loss, metrics = self._forward(state, batch, draws,
                                      None if n_rays is not None
                                      else state.step)
        self._backward(state, loss)
        return metrics

    def _batch(self, state: TrainState, buffer: kb.KeyframeBuffer,
               draws: Dict, n_rays: Optional[int] = None) -> Dict:
        """The step's ray batch (see :meth:`gradients`)."""
        cfg = self.config
        deltas = state.pose_deltas if cfg.optimize_extrinsics else None
        with span("map.sample"):
            if n_rays is not None:
                batch = kb.sample_ray_batch(buffer, deltas, n_rays,
                                            picks=draws)
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
        return batch

    def _forward(self, state: TrainState, batch: Dict, draws: Dict, step
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The loss and its terms (``step``: the phased table gradient's,
        or None)."""
        self._count_points(draws)
        with span("map.forward"):
            return self.model.loss(
                batch, draws["uniforms"], occ_grid=state.occ_grid,
                step=step, distill_points=draws.get("distill_points"),
                schedule=state.schedule)

    def _backward(self, state: TrainState, loss: torch.Tensor) -> None:
        """The loss's gradient into every leaf's ``.grad``."""
        with span("map.backward"):
            leaves = self.leaves(state)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            for p, g in zip(leaves, grads):
                # a bf16 parameter steps in bf16, as optax keeps its dtype
                p.grad = torch.zeros_like(p) if g is None else g.to(p.dtype)

    def update(self, state: TrainState, draws: Dict) -> None:
        """Apply the leaves' ``.grad`` (Adam; keyframe 0's pose gradient
        zeroed first: the gauge anchor), clear them, run the step's
        refreshes, step + 1."""
        with span("map.optimizer"):
            self._set_learning_rates(state)
            self._adam(state)
            self._refresh(state, draws)

    def _set_learning_rates(self, state: TrainState) -> None:
        """The camera learning rate of this step, and the SDF field's (in
        place where it is a device tensor, which a capturable Adam
        reads)."""
        if self.config.optimize_extrinsics:
            _set_lr(state.cam_opt, self.camera_lr(state.step))
        if state.schedule is not None:
            _set_lr(state.opt, self.field_lr(state.step))

    def _adam(self, state: TrainState) -> None:
        """Both Adam updates from the leaves' ``.grad``, which are then
        cleared."""
        state.opt.step()
        if self.config.optimize_extrinsics:
            state.pose_deltas.grad[0] = 0.0  # keyframe 0: the gauge anchor
            state.cam_opt.step()
        for p in self.leaves(state):
            p.grad = None

    def _refresh(self, state: TrainState, draws: Dict) -> None:
        """The step's refreshes on the updated field, then step + 1."""
        if self.refreshes_proposals(state):
            self.model.refresh_proposals(state.step)
        if self._refreshes_occupancy(state):
            self._occupancy_step(state, draws["occ_jitter"])
        state.step += 1

    def _refresh_occupancy(self, state: TrainState, step,
                           jitter: torch.Tensor) -> None:
        """The occupancy grid refreshed in place (a replayed step reads it
        where it was captured) at ``step``, an int or a 0-dim device
        tensor."""
        with span("map.occ_refresh", segment=True):
            state.occ_grid.copy_(self.model.refresh_occupancy(
                state.occ_grid, step, jitter))

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
        if self.model.config.sampler == "sdf":
            # 128 samples and 4 taps a ray: 640 points a ray encoded
            chunk = min(chunk, 1 << 12)
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
