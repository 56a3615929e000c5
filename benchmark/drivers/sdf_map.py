"""Driver of the SDF mapping cell: ``MappingStage.train_step`` of the
``neuralangelo`` mapper (Neuralangelo's hash-grid SDF, ``sampler="sdf"``)
over a full keyframe buffer after the stream has ended, the loop of
``finish()``.

As ``drivers/map.py`` (its helpers are used here), with what this mapper
adds:

- ``setup``: the keyframes of the seed's room, the state the compared
  steps start from (``reference/sdf_mapper.py``'s ``init_params``: the
  published geometric init, inside out, with the feature columns of the
  SDF MLP's first layer and the tables from the seed) and the step
  counter at ``start_step``, past every scaled schedule (the cell asserts
  that every level is active); the final samples' numerical SDF gradients
  of the first compared step's render, then the compared steps (the first
  eager, the second captured, the third replayed); then ``train_step()``
  up to ``warm_to_step``.
- ``window``: ``drivers/map.py``'s.
- ``trace``: as ``drivers/ngp_map.py``'s, and the window's reduction by
  the up-sampler's span ``map.sdf_upsample`` (``sdf``). Every counter is
  read with a default, so that a program without one runs the cell all
  the same.
- ``check``: the three numbers of ``yardstick/compare.py`` and
  ``normal_gap``: the worst error of the final samples' numerical SDF
  gradients of the first compared step's render against the reference's,
  relative to the gradient or to 1 where it is shorter (1 where their
  shapes differ).
"""

from __future__ import annotations

import types
from typing import Dict, List

import torch

from benchmark.drivers import map as base
from benchmark.drivers.map import _costs, _loop, _spans, program_readings
from benchmark.reference import sdf_mapper as ref
from benchmark.yardstick import compare, parts, room
from benchmark.yardstick.trace import Trace, breakdown

NUMBERS = compare.NUMBERS + ("normal_gap",)
COUNTERS = ("captures", "replays", "eager_steps", "sdf_points")


def draws(mc: ref.SDFMapperConfig, traffic: Dict, cfg: Dict, seed: int,
          device) -> List[Dict]:
    """The compared steps' draws from the seed: pixel picks over the
    keyframes and the stratified samples' uniforms."""
    g = base._generator(seed, 11, device)
    R = cfg.get("rays_per_batch", 4096)
    K, H, W = traffic["keyframes"], cfg["frame_height"], cfg["frame_width"]
    kw = dict(generator=g, device=device)
    return [{"frame": torch.randint(0, K, (R,), **kw),
             "py": torch.randint(0, H, (R,), **kw),
             "px": torch.randint(0, W, (R,), **kw),
             "uniforms": [torch.rand(R, mc.num_samples, **kw)]}
            for _ in range(traffic["compared_steps"])]


def inputs(ctx):
    """The run's inputs, made on the device from the seed: keyframes, the
    state the compared steps start from, their draws."""
    mc = ref.model_config(ctx.cfg)
    kf = room.keyframes(ctx.cfg, ctx.traffic, ctx.seed, ctx.device)
    params = ref.init_params(mc, ctx.seed, ctx.device)
    return mc, kf, params, draws(mc, ctx.traffic, ctx.cfg, ctx.seed,
                                 ctx.device)


@torch.no_grad()
def program_normals(stage, d) -> torch.Tensor:
    """The program's final-sample SDF gradients [R, S, 3] of the render of
    draws ``d`` at the stage's state (its own render, batch and
    schedule)."""
    from nerf_vo_tpu_torch.mapping import keyframe_buffer as kb

    tr, st = stage.trainer, stage.state
    tr.set_schedule(st)
    b = kb.sample_ray_batch(stage.buffer, st.pose_deltas,
                            d["frame"].shape[0], picks=d)
    out = stage.model.render(b["origins"], b["directions"],
                             uniforms=d["uniforms"], schedule=st.schedule)
    return out["sample_gradients"].float().clone()


def build(ctx):
    """The program's mapping stage over the cell's keyframes at
    ``start_step``, driven through the compared steps: (stage, its
    readings, the mapper)."""
    from nerf_vo_tpu_torch.runtime.stages import MappingStage

    mc, kf, params, steps = inputs(ctx)
    args = types.SimpleNamespace(**ctx.cfg)
    stage = MappingStage(args, state_dict=params, device=ctx.device)
    for p in base._packets(kf, ctx.traffic["insert_chunk"]):
        stage.update(p)
    del kf
    stage.stream_active = False  # the stream has ended, as in finish()
    start = ctx.traffic["start_step"]
    stage.state.step = stage.step_count = start
    active = stage.model.schedule_values(start)[0]
    if active != mc.num_grid_levels:
        raise AssertionError(f"{active} of {mc.num_grid_levels} levels "
                             f"active at step {start}")
    normals = program_normals(stage, steps[0])
    readings = program_readings(stage, params, steps)
    readings["normals"] = normals
    return stage, readings, mc


def setup(ctx):
    stage, readings, mc = build(ctx)
    while stage.step_count < ctx.traffic["warm_to_step"]:
        stage.train_step()
    base._sync(ctx.device)
    return types.SimpleNamespace(stage=stage, readings=readings, mc=mc)


window = base.window


def counters(trainer) -> Dict:
    out = {k: getattr(trainer, k, None) for k in COUNTERS}
    if isinstance(out["sdf_points"], dict):
        out["sdf_points"] = dict(out["sdf_points"])
    return out


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
    sdf = parts.Window.from_profiler(
        prof, "bench.window", parts=("sdf_upsample", "taps")).reduce()
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
            "sdf": sdf, "eager_steps": eager, "window_steps": steps,
            "counters": after}


def reference_readings(ctx, low: bool = False) -> Dict:
    """The reference's readings of the compared steps, from the run's own
    inputs made again from the seed (``low``: the control)."""
    mc, kf, params, steps = inputs(ctx)
    m = ref.Mapper(ctx.cfg, params, kf, ctx.device, low=low,
                   start_step=ctx.traffic["start_step"])
    del kf
    normals = m.normals(steps[0])
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
            "normals": normals}


def gaps(prog: Dict, ref_: Dict) -> Dict[str, float]:
    """``compare.gaps`` and ``normal_gap``: max over the final samples of
    |g_p - g_r| / max(|g_r|, 1), the norms of the SDF gradients: relative
    to the gradient, or to the unit norm the eikonal term holds it to
    where it is smaller (the geometric init's smoothed apex at the
    sphere's centre, where keyframe 0's rays start, has a gradient near
    0)."""
    out = compare.gaps(prog, ref_)
    gp = prog["normals"].double()
    gr = ref_["normals"].to(gp.device).double()
    if gp.shape != gr.shape:
        out["normal_gap"] = 1.0
    else:
        err = torch.linalg.vector_norm(gp - gr, dim=-1)
        scale = torch.linalg.vector_norm(gr, dim=-1).clamp(min=1.0)
        out["normal_gap"] = float((err / scale).max())
    return out


def check(ctx, readings) -> Dict[str, float]:
    return gaps(readings, reference_readings(ctx))
