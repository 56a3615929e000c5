"""Driver of the mapping cells: ``MappingStage.train_step`` over a full
keyframe buffer after the stream has ended, the loop of ``finish()``.

- ``setup``: renders the cell's keyframes of the seed's room on the device
  (``yardstick/room.py``), makes the mapper's weights from the seed on the
  device (``reference/mapper.py``'s ``init_params``), builds
  ``MappingStage(args, state_dict=weights)``, inserts the keyframes through
  ``MappingStage.update`` as enhanced packets of ``insert_chunk``, ends the
  stream (``stream_active = False``, as ``finish()`` does) and drives the
  first ``compared_steps`` steps through ``MappingStage.train_step`` with
  draws made from the seed, keeping the program's readings of them (the
  losses, the first gradient from Adam's first moment, each leaf's change);
  then ``train_step()`` as the window calls it, up to step
  ``warm_to_step``, so that every shape the window meets has run.
- ``window``: ``train_step()`` in a closed loop for ``seconds``; every ray
  trained counts.
- ``trace``: the window's first ``trace_steps`` steps under
  ``torch.profiler``, with the benchmark's spans around the trainer's
  parts and around each call of the two table kernels whose roofline the
  cell reports; then an untraced window of ``seconds`` for the step time.
  Each call of the two kernels in the first ``bytes_steps`` traced steps
  gets its bytes and operations from its own inputs and its device time
  from the trace: the durations of the device operations it launched
  there (``KERNEL_OPS``).
- ``check``: the reference from the same inputs, the same draws, its
  readings and the three numbers of ``yardstick/compare.py``.
"""

from __future__ import annotations

import contextlib
import time
import types
from typing import Dict, List

import torch

from benchmark.reference import mapper as ref
from benchmark.yardstick import compare, room
from benchmark.yardstick import table_bytes as tb
from benchmark.yardstick.trace import Trace, breakdown

# The device operations each roofline kernel's call launches, by name in
# the trace (the program's kernels link cudart statically, so the trace
# ties them to no host range): one ``gather_interp_kernel`` a call; the
# output's zeroing, ``sort_ids_kernel`` and ``scatter_owned_kernel``, one
# after the other on the stream, for ``scatter_cols_outer``.
KERNEL_OPS = {"gather_interp": ("gather_interp_kernel<",),
              "scatter_cols_outer": ("sort_ids_kernel",
                                     "scatter_owned_kernel")}
ZEROING = ("fill", "memset")  # the op before the sort, in lower case


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _generator(seed: int, k: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1000003 + k) & (2**63 - 1))
    return g


def draws(mc: ref.ModelConfig, traffic: Dict, cfg: Dict, seed: int,
          device) -> List[Dict]:
    """The compared steps' random draws from the seed: pixel picks over
    the keyframes and the stratification uniforms of each sampling
    level."""
    g = _generator(seed, 11, device)
    R = cfg.get("rays_per_batch", 4096)
    K, H, W = traffic["keyframes"], cfg["frame_height"], cfg["frame_width"]
    counts = list(mc.num_proposal_samples) + [mc.num_nerf_samples]
    kw = dict(generator=g, device=device)
    return [{"frame": torch.randint(0, K, (R,), **kw),
             "py": torch.randint(0, H, (R,), **kw),
             "px": torch.randint(0, W, (R,), **kw),
             "uniforms": [torch.rand(R, n + 1, **kw) for n in counts]}
            for _ in range(traffic["compared_steps"])]


def inputs(ctx):
    """The benchmark's inputs of a run, made on the device from the seed:
    keyframes, the mapper's weights and the compared steps' draws."""
    mc = ref.model_config(ctx.cfg)
    kf = room.keyframes(ctx.cfg, ctx.traffic, ctx.seed, ctx.device)
    params = ref.init_params(mc, ctx.seed, ctx.device)
    return mc, kf, params, draws(mc, ctx.traffic, ctx.cfg, ctx.seed,
                                 ctx.device)


def _norm(t) -> float:
    return float(torch.linalg.vector_norm(t.detach().double()))


def _packets(kf, chunk: int):
    """The keyframes as the enhancement stage hands them to the mapper."""
    K = kf["c2w"].shape[0]
    for a in range(0, K, chunk):
        yield {"camera_extrinsics": kf["c2w"][a:a + chunk],
               "camera_intrinsics": kf["intrinsics"][a:a + chunk],
               "frames_color_float": kf["color"][a:a + chunk],
               "frames_depth": kf["depth"][a:a + chunk]}


def program_readings(stage, params, steps) -> Dict:
    """Drive ``stage`` through the compared steps and read them as
    ``compare.gaps`` wants them, for every weight the run was handed and
    the pose corrections. The first gradient is Adam's first moment after
    one step over (1 - beta1); a weight Adam does not hold reads 0."""
    st = stage.state
    losses, grad = [], {}
    for i, d in enumerate(steps):
        m = stage.train_step(d)
        losses.append(float(m["loss"]))
        if i == 0:
            named = [(k, st.opt, st.params.get(k)) for k in params]
            named.append(("pose_deltas", st.cam_opt, st.pose_deltas))
            for name, opt, p in named:
                m = opt.state.get(p, {}).get("exp_avg") if p is not None \
                    else None
                b1 = opt.param_groups[0]["betas"][0]
                grad[name] = 0.0 if m is None else _norm(m / (1 - b1))
    model = stage.model.state_dict()
    change = {k: _norm(model[k] - params[k]) for k in params}
    change["pose_deltas"] = _norm(st.pose_deltas)
    return {"losses": losses, "grad": grad, "change": change}


def build(ctx):
    """The program's mapping stage over the cell's keyframes, driven
    through the compared steps: (stage, its readings, the mapper)."""
    from nerf_vo_tpu_torch.runtime.stages import MappingStage

    mc, kf, params, steps = inputs(ctx)
    args = types.SimpleNamespace(**ctx.cfg)
    stage = MappingStage(args, state_dict=params, device=ctx.device)
    for p in _packets(kf, ctx.traffic["insert_chunk"]):
        stage.update(p)
    del kf
    stage.stream_active = False  # the stream has ended, as in finish()
    return stage, program_readings(stage, params, steps), mc


def setup(ctx):
    stage, readings, mc = build(ctx)
    while stage.step_count < ctx.traffic["warm_to_step"]:
        stage.train_step()
    _sync(ctx.device)
    return types.SimpleNamespace(stage=stage, readings=readings, mc=mc)


def _loop(stage, seconds: float, dev):
    """Steps in a closed loop until ``seconds`` have passed (or the
    configured iterations are done); the time runs until the device has
    finished the last step."""
    rays = stage.trainer.config.rays_per_batch
    steps = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        if stage.train_step() is None:
            break
        steps += 1
    _sync(dev)
    return steps, steps * rays, time.perf_counter() - t0


def window(ctx, state, seconds: float) -> Dict:
    steps, rays, dt = _loop(state.stage, seconds, ctx.device)
    return {"kind": "map", "steps": steps, "rays": rays, "window_s": dt,
            "attempted": steps, "failed": 0}


@contextlib.contextmanager
def _spans(stage, calls: Dict[str, List], record_steps: int):
    """The benchmark's spans, installed for the traced steps and removed
    after: the step, its gradient and update parts, and each call of the
    roofline kernels (``bench.<kernel>#<n>``), whose inputs are kept for
    the calls of the first ``record_steps`` steps."""
    from torch.profiler import record_function

    from nerf_vo_tpu_torch.ops import gather_cuda as gc

    done = [0]

    def span(name, fn):
        def wrapped(*a, **k):
            with record_function(f"bench.{name}"):
                return fn(*a, **k)
        return wrapped

    def kernel(name, fn):
        # the program counts a kernel's launches on the function its
        # module names: the wrapper while it is installed
        def wrapped(*a, **k):
            n = len(calls[name])
            if done[0] < record_steps:
                calls[name].append(a)
            with record_function(f"bench.{name}#{n}"):
                return fn(*a, **k)
        wrapped.launches = 0
        return wrapped

    step = stage.train_step

    def counted_step(*a, **k):
        with record_function("bench.train_step"):
            out = step(*a, **k)
        done[0] += 1
        return out

    tr = stage.trainer
    saved = {k: getattr(gc, k) for k in KERNEL_OPS}
    stage.train_step = counted_step
    tr.gradients = span("gradients", tr.gradients)
    tr.update = span("update", tr.update)
    for k, fn in saved.items():
        setattr(gc, k, kernel(k, fn))
    try:
        yield
    finally:
        for k, fn in saved.items():
            fn.launches += getattr(gc, k).launches
            setattr(gc, k, fn)
        for obj, names in ((stage, ["train_step"]),
                           (tr, ["gradients", "update"])):
            for n in names:
                obj.__dict__.pop(n, None)


def _call_cost(name, a):
    if name == "gather_interp":
        return tb.gather_interp(*a[:4])
    W, cot, idx, nb = a[:4]
    return tb.scatter_cols_outer(W, cot, idx, nb)


def _call_ops(tr: Trace, name: str, n: int):
    """The device operations of the first ``n`` calls of ``name`` in the
    traced window, a list a call; None where the trace holds fewer."""
    ops = [tr.ops_named(p) for p in KERNEL_OPS[name]]
    if any(len(o) < n for o in ops):
        return None
    calls = [[o[i] for o in ops] for i in range(n)]
    if name == "scatter_cols_outer":
        for c in calls:
            before = tr.op_before(c[0])
            if before and any(z in before[2].lower() for z in ZEROING):
                c.insert(0, before)
    return calls


def _costs(tr: Trace, calls: Dict[str, List]) -> Dict[str, List]:
    """(bytes, operations, device seconds) of each recorded call that
    launched a kernel (an empty one launches none)."""
    out = {}
    for name, recorded in calls.items():
        live = [a for a in recorded if a[2 if name == "scatter_cols_outer"
                                        else 1].shape[0]]
        ops = _call_ops(tr, name, len(live))
        out[name] = [] if ops is None else [
            (*_call_cost(name, a), sum(t1 - t0 for t0, t1, _ in o) * 1e-6)
            for a, o in zip(live, ops)]
    return out


def trace(ctx, state, seconds: float) -> Dict:
    from torch.profiler import ProfilerActivity, profile, record_function

    stage, dev = state.stage, ctx.device
    n = ctx.traffic["trace_steps"]
    calls = {k: [] for k in KERNEL_OPS}
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with _spans(stage, calls, ctx.traffic["bytes_steps"]):
            with record_function("bench.window"):
                for _ in range(n):
                    stage.train_step()
                _sync(dev)
    steps, rays, dt = _loop(stage, seconds, dev)
    tr = Trace.from_profiler(prof, "bench.window")
    del prof
    costs = _costs(tr, calls)
    del calls
    return {"kind": "map", "trace": tr, "trace_steps": n,
            "trace_window_s": tr.window_s(), "busy_s": tr.busy_s(),
            "calls": costs, "model": state.mc,
            "rays_per_batch": stage.trainer.config.rays_per_batch,
            "step_s": dt / max(steps, 1), "attempted": n + steps,
            "failed": 0, "breakdown": breakdown(tr)}


def reference_readings(ctx, low: bool = False) -> Dict:
    """The reference's readings of the compared steps, from the run's own
    inputs made again from the seed (``low``: the control)."""
    mc, kf, params, steps = inputs(ctx)
    m = ref.Mapper(ctx.cfg, params, kf, ctx.device, low=low)
    del kf
    losses, grad = [], {}
    for i, d in enumerate(steps):
        loss, g = m.step(d)
        losses.append(loss)
        if i == 0:
            grad = {k: _norm(v) for k, v in g.items()}
    st = m.state()
    change = {k: _norm(st[k] - p) for k, p in params.items()}
    change["pose_deltas"] = _norm(st["pose_deltas"])
    return {"losses": losses, "grad": grad, "change": change}


def check(ctx, readings) -> Dict[str, float]:
    return compare.gaps(readings, reference_readings(ctx))
