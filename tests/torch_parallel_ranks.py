"""Rank functions of ``tests/test_torch_parallel.py``.

``parallel.dist.spawn`` starts each rank in a new process that imports this
module by name, so it imports torch and the port only, never JAX or the JAX
package: the test process makes the inputs (JAX keys' draws, a JAX init
carried across as numpy) and hands them over. Each function runs several
cases in one world, so a spawn is paid for a few times, not per test.
Results come back as numpy.
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import numpy as np
import torch

from nerf_vo_tpu_torch.evaluation.nerf_renderer import MapRenderer
from nerf_vo_tpu_torch.mapping import keyframe_buffer as tkb
from nerf_vo_tpu_torch.mapping.trainer import MappingTrainer, TrainerConfig
from nerf_vo_tpu_torch.models import nerfacto as tn
from nerf_vo_tpu_torch.ops import dense_ba as tba
from nerf_vo_tpu_torch.ops import hash_grid as thg
from nerf_vo_tpu_torch.ops import occupancy as O
from nerf_vo_tpu_torch.parallel import dist as pdist
from nerf_vo_tpu_torch.parallel import sharding

K, H, W = 4, 12, 16
RAYS = 64
# the grid of tests/test_parallel.py: level 0 (512 bricks) one-hot, the
# hashed levels' backward compacted to the owned descriptors
MODEL = dict(num_proposal_samples=(8,), num_nerf_samples=6, num_images=K,
             log2_hashmap_size=14, max_res=64, proposal_resolutions=(8,))
NGP = dict(num_proposal_samples=(), num_nerf_samples=8, num_images=K,
           log2_hashmap_size=8, max_res=32, proposal_resolutions=(),
           sampler="occupancy", num_occ_bins=16)
OCC = dict(resolution=8, update_every=2, slab_div=2)
TRAIN_STEPS = 2


def packet(seed: int = 0):
    """K keyframes of a smooth scene (cameras on a short arc looking down
    -z, smooth colors, depth 1.5-3.5, normals near +z), as numpy."""
    rng = np.random.default_rng(seed)
    c2w = np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))
    ang = rng.uniform(-0.2, 0.2, K)
    c2w[:, 0, 0], c2w[:, 0, 2] = np.cos(ang), np.sin(ang)
    c2w[:, 2, 0], c2w[:, 2, 2] = -np.sin(ang), np.cos(ang)
    c2w[:, :3, 3] = rng.normal(0, 0.3, (K, 3)) + [1.0, 0.5, 2.0]
    yy, xx = np.meshgrid(np.linspace(0, 1, H), np.linspace(0, 1, W),
                         indexing="ij")
    base = rng.uniform(0.1, 0.9, (K, 1, 1, 3))
    color = np.clip(base + 0.3 * np.sin(6 * xx + 4 * yy)[None, ..., None],
                    0, 1).astype(np.float32)
    depth = (2.5 + np.cos(3 * xx - yy)[None] * rng.uniform(0.5, 1, (K, 1, 1))
             ).astype(np.float32)
    nrm = rng.normal(size=(K, H, W, 3)) + [0, 0, 3.0]
    return {
        "intrinsics": np.tile(np.asarray([[10.0, 10.0, W / 2, H / 2]],
                                         np.float32), (K, 1)),
        "c2w": c2w, "color": color, "depth": depth,
        "normal": (nrm / np.linalg.norm(nrm, axis=-1, keepdims=True)
                   ).astype(np.float32),
    }


def buffer(pkt):
    b = tkb.create(K, H, W, device="cpu")
    tkb.insert(b, list(range(K)), {k: torch.tensor(v) for k, v in
                                   pkt.items()})
    return b


def _numpy(model):
    return {n: p.detach().float().numpy().copy()
            for n, p in model.named_parameters()}


# ---------------------------------------------------------------------------
# the cases
# ---------------------------------------------------------------------------

def encode(rank, world, mesh, grid_kw, tab, x, cot, ds):
    """One table-sharded encode over the mesh's "model" axis and its
    backward: (features, this rank's table gradient rows, position
    gradient). Under ``ds`` (descriptor sharding) each rank takes its own
    block of the points and cotangents."""
    cfg = thg.HashGridConfig(**grid_kw)
    ax = pdist.mesh_axis(mesh, "model")
    t = thg.tables_from_jax(tab)
    R = t.shape[0] // ax.size
    t = t[ax.index * R:(ax.index + 1) * R].clone().requires_grad_(True)
    x, cot = torch.tensor(x), torch.tensor(cot)
    if ds:
        n = x.shape[0] // ax.size
        x, cot = x[ax.index * n:(ax.index + 1) * n], \
            cot[ax.index * n:(ax.index + 1) * n]
    x = x.clone().requires_grad_(True)
    f = thg.hash_encode(t, x, cfg, group=ax.group, descriptor_sharding=ds)
    gt, gx = torch.autograd.grad(f, (t, x), cot)
    return f.detach().numpy(), gt.numpy(), gx.numpy()


def train(rank, mesh, model_kw, params0, draws, mode, occ=None):
    """Train ``len(draws[rank])`` steps from the JAX init ``params0`` with
    this rank's draws (``draws`` None: TRAIN_STEPS steps on the step's own
    draws): ``mode`` "dp" (make_dp_train_step over the mesh's "data" axis),
    "tp" or "ds" (make_dp_tp_train_step, without / with descriptor
    sharding). Returns every parameter (a table: this rank's rows), the
    pose corrections, the last metrics, the occupancy grid, and what the
    first step's update was given: the averaged gradient of every leaf
    and the draws."""
    torch.manual_seed(0)
    occ_cfg = O.OccupancyConfig(**occ) if occ else O.OccupancyConfig()
    cfg = tn.NerfactoConfig(**model_kw, occupancy=occ_cfg)
    full = tn.NerfactoModel(cfg)
    full.load_state_dict(tn.from_jax_params(params0))
    tcfg = TrainerConfig(rays_per_batch=RAYS, max_iterations=8)
    trainer = MappingTrainer(full, tcfg, K, device="cpu")
    state = trainer.init()
    model = full
    if mode == "dp":
        step = sharding.make_dp_train_step(trainer, mesh)
    else:
        ds = mode == "ds"
        m = pdist.mesh_axis(mesh, "model").size
        model = tn.NerfactoModel(dataclasses.replace(
            cfg, model_axis="model", model_axis_size=m,
            descriptor_sharding=ds), mesh=mesh)
        tp_trainer = MappingTrainer(model, tcfg, K, device="cpu")
        state = sharding.shard_state_tp(full, state, tp_trainer)
        trainer = tp_trainer
        step = sharding.make_dp_tp_train_step(trainer, mesh,
                                              descriptor_sharding=ds)
    seen = []
    update = trainer.update

    def recording_update(state, d):
        names = list(state.params) + ["pose_deltas"]
        seen.append(({n: p.grad.detach().float().numpy().copy() for n, p in
                      zip(names, trainer.leaves(state))},
                     {k: (v.numpy().copy() if isinstance(v, torch.Tensor)
                          else [u.numpy().copy() for u in v])
                      for k, v in d.items()}))
        update(state, d)

    trainer.update = recording_update
    buf = buffer(packet())
    sharding.replicate(buf)
    metrics = {}
    for d in (draws[rank] if draws is not None else [None] * TRAIN_STEPS):
        state, metrics = step(state, buf, d)
    return dict(params=_numpy(model),
                pose=state.pose_deltas.detach().numpy().copy(),
                metrics={k: float(v) for k, v in metrics.items()},
                occ=(state.occ_grid.numpy().copy()
                     if state.occ_grid is not None else None),
                step=state.step, grads=seen[0][0], draws=seen[0][1])


def render(rank, mesh, params0):
    """A 12x16 frame through ``MapRenderer(stage, mesh=)`` and through the
    one-device renderer, and ``make_dp_render_chunk`` on 61 rays (padded
    to split over the ranks) against the one-device chunk."""
    torch.manual_seed(0)
    model = tn.NerfactoModel(tn.NerfactoConfig(**MODEL))
    model.load_state_dict(tn.from_jax_params(params0))
    trainer = MappingTrainer(model, TrainerConfig(rays_per_batch=RAYS), K,
                             device="cpu")
    buf = buffer(packet())
    stage = SimpleNamespace(trainer=trainer, buffer=buf,
                            device=torch.device("cpu"), state=trainer.init(),
                            model=model)
    cam = dict(fx=10.0, fy=10.0, cx=W / 2, cy=H / 2, height=H, width=W)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = [0.2, -0.1, 0.3]
    one = MapRenderer(stage).render_frame(cam, pose)
    dp = MapRenderer(stage, mesh=mesh).render_frame(cam, pose)
    g = torch.Generator().manual_seed(3)
    o = torch.randn(61, 3, generator=g) * 0.1
    d = torch.nn.functional.normalize(torch.randn(61, 3, generator=g), dim=-1)
    with torch.no_grad():
        ref = model.render(o, d)
        got = sharding.make_dp_render_chunk(trainer, mesh)(o, d, None)
    return dict(frame_one=one, frame_dp=dp,
                chunk_one={k: ref[k].numpy() for k in got},
                chunk_dp={k: v.numpy() for k, v in got.items()})


def dense_ba(rank, mesh, problem, slots, eta, num_iters):
    """``make_sharded_dense_ba`` over the mesh's "data" axis (window 3)."""
    p = tba.DenseBAProblem(**{k: torch.tensor(v) for k, v in
                              problem.items()})
    step = tba.make_sharded_dense_ba(mesh, num_iters=num_iters, window=3)
    out = step(p, torch.tensor(slots),
               eta=None if eta is None else torch.tensor(eta))
    return [t.numpy() for t in out]


# ---------------------------------------------------------------------------
# the worlds
# ---------------------------------------------------------------------------

def world_two(rank, world, device, spec):
    """Two ranks: the 2-shard encodes, DP(2) train steps of both mappers
    (the references of DP2 x TP2: the same rays a data row), the
    data-parallel renders."""
    out = {}
    m_mesh = pdist.make_mesh(world, "model")
    out["encode"] = {name: encode(rank, world, m_mesh, *args, False)
                     for name, args in spec["encode"].items()}
    mesh = pdist.make_mesh(world)
    out["dp2"] = train(rank, mesh, MODEL, spec["params0"], spec["draws_dp2"],
                       "dp")
    out["ngp_dp2"] = train(rank, mesh, NGP, spec["ngp_params0"],
                           spec["draws_ngp"], "dp", occ=OCC)
    out["render"] = render(rank, mesh, spec["params0"])
    try:  # a model axis whose size the mesh contradicts
        tn.NerfactoModel(tn.NerfactoConfig(**MODEL, model_axis="model",
                                           model_axis_size=3), mesh=m_mesh)
        out["size_check"] = None
    except ValueError as e:
        out["size_check"] = str(e)
    return out


def world_four(rank, world, device, spec):
    """Four ranks: the descriptor-routed encodes (4 shards), DP(4), DP2 x
    TP2 and descriptor-sharded 2 x 2 train steps, the table-sharded
    occupancy mapper, the pixel-sharded dense BA (in f32, and in f64 at
    several seeds), the pod mesh."""
    out = {}
    m_mesh = pdist.make_mesh(world, "model")
    out["encode_ds"] = {name: encode(rank, world, m_mesh, *args, True)
                        for name, args in spec["encode_ds"].items()}
    mesh = pdist.make_mesh(world)
    out["dp4"] = train(rank, mesh, MODEL, spec["params0"], spec["draws_dp4"],
                       "dp")
    mesh2 = pdist.make_mesh_2d(2, 2)
    out["tp"] = train(rank, mesh2, MODEL, spec["params0"], spec["draws_tp"],
                      "tp")
    out["ds"] = train(rank, mesh2, MODEL, spec["params0"], spec["draws_dp4"],
                      "ds")
    out["ngp"] = train(rank, mesh2, NGP, spec["ngp_params0"],
                       spec["draws_ngp"], "tp", occ=OCC)
    # the steps' own draws: a rank's rays from its ray group's generator,
    # the occupancy refresh's jitter alike on every rank
    out["own_draws"] = {
        "tp": train(rank, mesh2, NGP, spec["ngp_params0"], None, "tp",
                    occ=OCC),
        "ds": train(rank, mesh2, MODEL, spec["params0"], None, "ds")}
    out["dense_ba"] = {n: dense_ba(rank, mesh, *spec["dense_ba"], n)
                       for n in (1, 2)}
    out["dense_ba_f64"] = [dense_ba(rank, mesh, *args, 2)
                           for args in spec["dense_ba_f64"]]
    pod = pdist.make_pod_mesh(n_model=2)
    out["pod"] = dict(names=pod.mesh_dim_names, ranks=pod.mesh.tolist(),
                      ranks_2d=mesh2.mesh.tolist(),
                      model_index=pdist.mesh_axis(pod, "model").index,
                      data_index=pdist.mesh_axis(pod, "data").index)
    return out


def fail_on_rank_one(rank, world, device):
    if rank == 1:
        raise ValueError("rank 1 fails on purpose")
    return rank
