"""Multi-device mapping steps and eval renders over a device mesh.

Counterpart of ``nerf_vo_tpu/parallel/sharding.py``. Two axes help the
mapper:

* **data** (:func:`make_dp_train_step`): each rank trains on its share of
  the ray batch and the gradients are averaged before the (replicated)
  Adam update: the throughput axis.
* **model** (:func:`make_dp_tp_train_step`): every table's rows are
  sharded over the model axis (``NerfactoModel(config with model_axis,
  mesh=)``, loaded by :func:`shard_state_tp`); each encode makes the model
  axis's collectives (``ops/hash_grid.py``), table gradients and their Adam
  moments stay shard-local: the memory axis. With ``descriptor_sharding``
  each rank of a model group also trains on rays of its own.

Each rank is one process running the same program; a step is called on
every rank of the mesh with the same state and buffer. Gradients are
averaged with SUM all-reduces (gloo has no average) of one flat buffer per
group: the table leaves over ``data`` (times ``1 / n_model`` under
descriptor sharding, where a rank's table gradient is already the sum over
its model group), every other leaf and the pose corrections over both
axes. Keyframe 0's pose gradient is zeroed (the gauge). Proposal and
occupancy refreshes run on every rank alike.

Draws: a step's ``draws`` are this rank's (pass them to reproduce a run);
without them a rank draws its rays from a generator seeded by (``seed``,
its ray-group index) and the refresh draws from one seeded by ``seed``
alone, alike on every rank.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional

import torch
import torch.distributed as dist
from torch import nn

from nerf_vo_tpu_torch.mapping import keyframe_buffer as kb
from nerf_vo_tpu_torch.mapping.trainer import MappingTrainer, TrainState
from nerf_vo_tpu_torch.parallel import dist as pdist

_RENDER_KEYS = ("rgb", "depth", "accumulation")


def _is_table_path(name: str) -> bool:
    return name.split(".")[-1] == "tables"


def table_sharded_specs(params: Iterable[str], model_axis: str = "model"
                        ) -> Dict[str, Optional[str]]:
    """Per parameter name, the mesh axis its rows are sharded over: the hash
    tables over ``model_axis``, None (replicated) for everything else."""
    return {n: (model_axis if _is_table_path(n) else None) for n in params}


def _tensors(obj) -> List[torch.Tensor]:
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, nn.Module):
        return list(obj.parameters()) + list(obj.buffers())
    if isinstance(obj, torch.optim.Optimizer):
        return [v for st in obj.state.values() for v in st.values()
                if isinstance(v, torch.Tensor)]
    if isinstance(obj, dict):
        return [t for v in obj.values() for t in _tensors(v)]
    if isinstance(obj, (list, tuple)):
        return [t for v in obj for t in _tensors(v)]
    if dataclasses.is_dataclass(obj):
        return [t for f in dataclasses.fields(obj)
                for t in _tensors(getattr(obj, f.name))]
    return []


@torch.no_grad()
def replicate(tree, src: int = 0):
    """Make every tensor of ``tree`` (a tensor, module, optimizer, dict,
    list or dataclass such as a ``TrainState`` or keyframe buffer) equal to
    rank ``src``'s, in place, over every rank of the world (a mesh spans
    them all). Returns ``tree``."""
    if dist.get_world_size() > 1:
        for t in _tensors(tree):
            dist.broadcast(t.data, src=src)
    return tree


def _shard_rows(t: torch.Tensor, axis: pdist.Axis) -> torch.Tensor:
    R = t.shape[0] // axis.size
    return t[axis.index * R:(axis.index + 1) * R].clone()


@torch.no_grad()
def shard_state_tp(model: nn.Module, state: TrainState,
                   trainer: MappingTrainer) -> TrainState:
    """Load a whole (replicated) model and its ``TrainState`` into a
    table-sharded trainer: each table (and its Adam moments) as this rank's
    row shard over ``trainer.model``'s model axis, everything else whole.
    Returns the sharded trainer's ``TrainState``."""
    axis = trainer.model.model_axis
    if axis is None:
        raise ValueError("shard_state_tp: the trainer's model has no "
                         "model_axis (build it with NerfactoModel(config, "
                         "mesh=))")
    src = dict(model.named_parameters())
    for name, p in trainer.model.named_parameters():
        v = src[name].detach()
        p.copy_(_shard_rows(v, axis) if _is_table_path(name) else v)
    out = trainer.init()
    out.pose_deltas.copy_(state.pose_deltas.detach())
    out.step = state.step
    if state.occ_grid is not None:
        out.occ_grid = state.occ_grid.clone()
    for name, p in out.params.items():
        st = state.opt.state.get(state.params[name])
        if st:
            out.opt.state[p] = {
                k: (_shard_rows(v, axis) if _is_table_path(name)
                    and v.dim() == 2 else v.clone())
                for k, v in st.items()}
    st = state.cam_opt.state.get(state.pose_deltas)
    if st:
        out.cam_opt.state[out.pose_deltas] = {k: v.clone()
                                              for k, v in st.items()}
    return out


def _average(grads: List[torch.Tensor], axis: pdist.Axis, scale: float
             ) -> None:
    """Sum ``grads`` over ``axis`` with one all-reduce of a flat f32 buffer,
    times ``scale``, in place."""
    if not grads:
        return
    flat = torch.cat([g.float().reshape(-1) for g in grads])
    pdist.all_reduce_sum(flat, axis)
    flat = flat * scale
    off = 0
    for g in grads:
        g.copy_(flat[off:off + g.numel()].view_as(g))
        off += g.numel()


def _mean_metrics(metrics: Dict[str, torch.Tensor], axis: pdist.Axis
                  ) -> Dict[str, torch.Tensor]:
    names = sorted(metrics)
    flat = torch.stack([metrics[k].float().reshape(()) for k in names])
    pdist.all_reduce_sum(flat, axis)
    flat = flat / axis.size
    return {k: flat[i] for i, k in enumerate(names)}


class _Draws:
    """A rank's draws: rays from a generator seeded by (seed, its ray-group
    index), refresh draws from one seeded by seed alone."""

    def __init__(self, trainer: MappingTrainer, index: int, seed: int):
        self.trainer = trainer
        self.rays = torch.Generator(device=trainer.device)
        self.rays.manual_seed(seed * 1_000_003 + index + 1)
        self.refresh = torch.Generator(device=trainer.device)
        self.refresh.manual_seed(seed)

    def __call__(self, buffer, state, n_rays):
        return self.trainer.draws(buffer, state, n_rays,
                                  (self.rays, self.refresh))


def _per_rank(trainer: MappingTrainer, n_groups: int) -> int:
    R = trainer.config.rays_per_batch
    if R % n_groups:
        raise ValueError(f"rays_per_batch {R} is not divisible by "
                         f"{n_groups} ray groups")
    return R // n_groups


def make_dp_train_step(trainer: MappingTrainer, mesh, axis: str = "data",
                       seed: int = 0):
    """A data-parallel train step over ``mesh``: each rank trains on
    ``rays_per_batch / n`` rays, the gradients are averaged over ``axis``,
    and every rank applies the same Adam update (the JAX package's
    ``pmean`` + replicated ``optax`` update).

    Returns ``step(state, buffer, draws=None) -> (state, metrics)``, in
    place on ``state``, with the metrics averaged over the ranks."""
    ax = pdist.mesh_axis(mesh, axis)
    per = _per_rank(trainer, ax.size)
    draw = _Draws(trainer, ax.index, seed)

    def step(state: TrainState, buffer: kb.KeyframeBuffer,
             draws: Optional[Dict] = None):
        if draws is None:
            draws = draw(buffer, state, per)
        metrics = trainer.gradients(state, buffer, draws, n_rays=per)
        _average([p.grad for p in trainer.leaves(state)], ax, 1.0 / ax.size)
        metrics = _mean_metrics(metrics, ax)
        trainer.update(state, draws)
        return state, metrics

    return step


def make_dp_render_chunk(trainer: MappingTrainer, mesh, axis: str = "data"):
    """A data-parallel eval render chunk: each rank renders its slice of a
    chunk's rays (the parameters and occupancy grid replicated) and the
    slices are gathered in order. A chunk that does not split evenly is
    padded with copies of its last ray, which are dropped. Pass it as
    :meth:`MappingTrainer.render_image`'s ``chunk_fn``; every rank of the
    mesh renders the same image."""
    ax = pdist.mesh_axis(mesh, axis)

    def chunk(origins, directions, occ_grid):
        n = origins.shape[0]
        k = -(-n // ax.size)
        pad = k * ax.size - n
        if pad:
            origins = torch.cat([origins, origins[-1:].expand(pad, 3)])
            directions = torch.cat([directions,
                                    directions[-1:].expand(pad, 3)])
        sl = slice(ax.index * k, (ax.index + 1) * k)
        r = trainer.model.render(origins[sl], directions[sl],
                                 occ_grid=occ_grid)
        return {key: pdist.all_gather_cat(r[key].contiguous(), ax)[:n]
                for key in _RENDER_KEYS}

    return chunk


def make_dp_tp_train_step(trainer: MappingTrainer, mesh,
                          data_axis: str = "data", model_axis: str = "model",
                          descriptor_sharding: bool = False, seed: int = 0):
    """A 2D data x model parallel train step over ``mesh``.

    ``trainer.model`` is the table-sharded model (``NerfactoModel(config,
    mesh=)`` with ``config.model_axis == model_axis`` and the same
    ``descriptor_sharding``), loaded with :func:`shard_state_tp`. Rays are
    split over ``data_axis`` (the ranks of a model group train on the same
    rays), or over both axes under ``descriptor_sharding`` (each rank on
    its own; table lookups routed to the rows' owners). Table gradients are
    averaged over ``data_axis`` and, under descriptor sharding, divided by
    the model axis's size (each owner's gradient is the sum over its
    group); every other leaf and the pose corrections are averaged over
    both axes.

    Returns ``step(state, buffer, draws=None) -> (state, metrics)``."""
    mcfg = trainer.model.config
    if (mcfg.model_axis, mcfg.descriptor_sharding) != (
            model_axis, descriptor_sharding):
        raise ValueError(
            f"the trainer's model has model_axis={mcfg.model_axis!r}, "
            f"descriptor_sharding={mcfg.descriptor_sharding}; the step "
            f"asks for {model_axis!r}, {descriptor_sharding}")
    d_ax = pdist.mesh_axis(mesh, data_axis)
    m_ax = pdist.mesh_axis(mesh, model_axis)
    w_ax = pdist.world_axis()
    if descriptor_sharding:
        n_groups, group = d_ax.size * m_ax.size, \
            d_ax.index * m_ax.size + m_ax.index
        t_scale = 1.0 / (d_ax.size * m_ax.size)
    else:
        n_groups, group = d_ax.size, d_ax.index
        t_scale = 1.0 / d_ax.size
    per = _per_rank(trainer, n_groups)
    draw = _Draws(trainer, group, seed)

    def step(state: TrainState, buffer: kb.KeyframeBuffer,
             draws: Optional[Dict] = None):
        if draws is None:
            draws = draw(buffer, state, per)
        metrics = trainer.gradients(state, buffer, draws, n_rays=per)
        sharded = table_sharded_specs(state.params, model_axis)
        grads = [(sharded.get(n), p.grad) for n, p in zip(
            list(state.params) + ["pose_deltas"], trainer.leaves(state))]
        _average([g for ax, g in grads if ax], d_ax, t_scale)
        _average([g for ax, g in grads if not ax], w_ax, 1.0 / w_ax.size)
        metrics = _mean_metrics(metrics, w_ax)
        trainer.update(state, draws)
        return state, metrics

    return step
