"""Driver of the Instant-NGP mapping cell: ``MappingStage.train_step`` of
the ``instant-ngp`` mapper over a full keyframe buffer with depth
variances after the stream has ended, the loop of ``finish()``.

As ``drivers/map.py`` (its helpers are used here), with what this mapper
adds:

- ``setup``: the keyframes of the seed's room and, per pixel, a depth
  variance from the seed (:func:`depth_variance`), inserted as packets with
  ``frames_depth_cov``; the weights (``reference/ngp_mapper.py``); the
  occupancy grid as ``finish()`` finds it after the stream
  (:func:`start_grid`), on both sides; the compared steps' draws,
  ``occ_jitter`` on their refresh steps; then
  ``train_step()`` up to ``warm_to_step``, past the first graphed
  refresh, so that the step's graphs and the refresh's are both made.
- ``window``: ``drivers/map.py``'s.
- ``trace``: as ``drivers/map.py``'s, and the window's reduction by the
  step's parts (``parts``) and by the occupancy sampler's spans
  ``map.occupancy`` and ``map.occ_refresh`` (``occupancy``), and the
  trainer's counters: the untraced window's eager steps among its steps.
  Every counter is read with a default, so that a program without one
  runs the cell all the same.
- ``check``: the three numbers of ``yardstick/compare.py`` and
  ``occ_gap``: the worst relative error of the occupancy grid after the
  compared steps against the reference's. Step 0 refreshes it (on the card
  by the refresh's graphs, which read the slab's place from the device):
  slab 0's cells, behind the room's walls, take the field's densities
  where they exceed their decayed start and keep it elsewhere, and every
  other cell is its start decayed. The start's occupied walls and empty
  inside make the bins' weights vary along every ray.
"""

from __future__ import annotations

import types
from typing import Dict, List

import torch

from benchmark.drivers import map as base
from benchmark.drivers.map import _costs, _loop, _spans, program_readings
from benchmark.reference import ngp_mapper as ref
from benchmark.yardstick import compare, parts, room
from benchmark.yardstick.trace import Trace, breakdown

NUMBERS = compare.NUMBERS + ("occ_gap",)
COUNTERS = ("captures", "replays", "eager_steps", "occ_refreshes")


def depth_variance(depth: torch.Tensor, seed: int) -> torch.Tensor:
    """A DROID-like depth variance [K, H, W] of z-depths ``depth``:
    ``(0.02 d)^2 exp(n)``, n standard normal from the seed, with one pixel
    in ten (chosen by the seed) 100 times less certain."""
    g = base._generator(seed, 13, depth.device)
    kw = dict(generator=g, device=depth.device)
    n = torch.randn(depth.shape, **kw)
    loose = torch.rand(depth.shape, **kw) < 0.1
    var = (0.02 * depth) ** 2 * torch.exp(n)
    return torch.where(loose, 100.0 * var, var)


def start_grid(mc: ref.NGPConfig, seed: int, device) -> torch.Tensor:
    """The occupancy grid [resolution^3] that the compared steps start
    from, as ``finish()`` would find it after the stream's refreshes: the
    cells within a cell's width of the room's walls occupied (density 10),
    the room's empty inside at 0, and the cells behind its walls, which no
    keyframe sees, at densities drawn from the seed in [0, 1)."""
    r = mc.resolution
    cell = (mc.aabb_max - mc.aabb_min) / r
    c = mc.aabb_min + (torch.arange(r, dtype=torch.float64, device=device)
                       + 0.5) * cell
    p = torch.stack(torch.meshgrid(c, c, c, indexing="ij"), -1)
    f64 = dict(dtype=torch.float64, device=device)
    lo, hi = (torch.tensor(b, **f64) for b in (room.ROOM_LO, room.ROOM_HI))
    inside = ((p > lo) & (p < hi)).all(-1)
    d_in = torch.minimum(p - lo, hi - p).amin(-1)
    d_out = torch.linalg.vector_norm(
        torch.clamp(lo - p, min=0) + torch.clamp(p - hi, min=0), dim=-1)
    wall = torch.where(inside, d_in, d_out) < cell
    behind = torch.rand(p.shape[:-1], generator=base._generator(
        seed, 17, device), **f64)
    grid = torch.where(inside, torch.zeros_like(behind), behind)
    return torch.where(wall, torch.full_like(grid, 10.0), grid).flatten(
        ).float()


def draws(mc: ref.NGPConfig, traffic: Dict, cfg: Dict, seed: int,
          device) -> List[Dict]:
    """The compared steps' draws from the seed: pixel picks, the bins' and
    the resampling's uniforms, and on a refresh step the slab's jitter."""
    g = base._generator(seed, 11, device)
    R = cfg.get("rays_per_batch", 4096)
    K, H, W = traffic["keyframes"], cfg["frame_height"], cfg["frame_width"]
    kw = dict(generator=g, device=device)
    out = []
    for i in range(traffic["compared_steps"]):
        d = {"frame": torch.randint(0, K, (R,), **kw),
             "py": torch.randint(0, H, (R,), **kw),
             "px": torch.randint(0, W, (R,), **kw),
             "uniforms": [torch.rand(R, n + 1, **kw)
                          for n in (mc.num_occ_bins, mc.num_nerf_samples)]}
        if i % mc.update_every == 0:
            d["occ_jitter"] = torch.rand(mc.slab, 3, **kw)
        out.append(d)
    return out


def inputs(ctx):
    """The run's inputs, made on the device from the seed: keyframes with
    their depth variances, the mapper's weights, the grid the compared
    steps start from, the compared draws."""
    mc = ref.model_config(ctx.cfg)
    kf = room.keyframes(ctx.cfg, ctx.traffic, ctx.seed, ctx.device)
    kf["cov"] = depth_variance(kf["depth"], ctx.seed)
    params = ref.init_params(mc, ctx.seed, ctx.device)
    grid = start_grid(mc, ctx.seed, ctx.device)
    return mc, kf, params, grid, draws(mc, ctx.traffic, ctx.cfg, ctx.seed,
                                       ctx.device)


def build(ctx):
    """The program's mapping stage over the cell's keyframes, driven
    through the compared steps: (stage, its readings, the mapper)."""
    from nerf_vo_tpu_torch.runtime.stages import MappingStage

    mc, kf, params, grid, steps = inputs(ctx)
    args = types.SimpleNamespace(**ctx.cfg)
    stage = MappingStage(args, state_dict=params, device=ctx.device)
    chunk = ctx.traffic["insert_chunk"]
    for p, a in zip(base._packets(kf, chunk),
                    range(0, kf["c2w"].shape[0], chunk)):
        stage.update(dict(p, frames_depth_cov=kf["cov"][a:a + chunk]))
    del kf
    stage.stream_active = False  # the stream has ended, as in finish()
    stage.state.occ_grid.copy_(grid)
    readings = program_readings(stage, params, steps)
    readings["grid"] = stage.state.occ_grid.clone()
    return stage, readings, mc


def setup(ctx):
    stage, readings, mc = build(ctx)
    while stage.step_count < ctx.traffic["warm_to_step"]:
        stage.train_step()
    base._sync(ctx.device)
    return types.SimpleNamespace(stage=stage, readings=readings, mc=mc)


window = base.window


def counters(trainer) -> Dict:
    return {k: getattr(trainer, k, None) for k in COUNTERS}


def trace(ctx, state, seconds: float) -> Dict:
    from torch.profiler import ProfilerActivity, profile, record_function

    stage, dev = state.stage, ctx.device
    n = ctx.traffic["trace_steps"]
    calls = {k: [] for k in base.KERNEL_OPS}
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with _spans(stage, calls, ctx.traffic["bytes_steps"]):
            with record_function("bench.window"):
                for _ in range(n):
                    stage.train_step()
                base._sync(dev)
    before = counters(stage.trainer)
    steps, rays, dt = _loop(stage, seconds, dev)
    after = counters(stage.trainer)
    tr = Trace.from_profiler(prof, "bench.window")
    by_part = parts.Window.from_profiler(
        prof, "bench.window", parts=parts.PARTS + ("replay",)).reduce()
    occupancy = parts.Window.from_profiler(
        prof, "bench.window", parts=("occupancy", "occ_refresh")).reduce()
    del prof
    costs = _costs(tr, calls)
    del calls
    eager = (None if before["eager_steps"] is None
             else after["eager_steps"] - before["eager_steps"])
    return {"kind": "map", "trace": tr, "trace_steps": n,
            "trace_window_s": tr.window_s(), "busy_s": tr.busy_s(),
            "calls": costs, "model": state.mc,
            "rays_per_batch": stage.trainer.config.rays_per_batch,
            "step_s": dt / max(steps, 1), "attempted": n + steps,
            "failed": 0, "breakdown": breakdown(tr), "parts": by_part,
            "occupancy": occupancy, "eager_steps": eager,
            "window_steps": steps, "counters": after}


def reference_readings(ctx, low: bool = False) -> Dict:
    """The reference's readings of the compared steps, from the run's own
    inputs made again from the seed (``low``: the control)."""
    mc, kf, params, grid, steps = inputs(ctx)
    m = ref.Mapper(ctx.cfg, params, kf, ctx.device, low=low, grid=grid)
    del kf
    losses, grad = [], {}
    for i, d in enumerate(steps):
        loss, g = m.step(d)
        losses.append(loss)
        if i == 0:
            grad = {k: base._norm(v) for k, v in g.items()}
    st = m.state()
    change = {k: base._norm(st[k] - p) for k, p in params.items()}
    change["pose_deltas"] = base._norm(st["pose_deltas"])
    return {"losses": losses, "grad": grad, "change": change,
            "grid": m.grid}


def gaps(prog: Dict, ref_: Dict) -> Dict[str, float]:
    """``compare.gaps`` and ``occ_gap``: max |g_p - g_r| / max(|g_r|,
    1e-6) over the grid's cells (1 where the grids differ in shape)."""
    out = compare.gaps(prog, ref_)
    gp = prog["grid"].double()
    gr = ref_["grid"].to(gp.device).double()
    out["occ_gap"] = (float(((gp - gr).abs() / gr.abs().clamp(min=1e-6))
                            .max()) if gp.shape == gr.shape else 1.0)
    return out


def check(ctx, readings) -> Dict[str, float]:
    return gaps(readings, reference_readings(ctx))
