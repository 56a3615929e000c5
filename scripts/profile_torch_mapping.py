"""Where the PyTorch port's mapping train step spends its time, on one
NVIDIA GPU.

    python3 scripts/profile_torch_mapping.py [--keyframes 16] [--steps 40] [--window 16]

Builds ``MappingStage`` at the replica configuration (192 keyframe slots of
360x640, 4096 rays per step, field 3 x 8 at log2 table 19, dense proposal
grids 128 / 160 with 96 + 48 samples, 48 nerf samples; random weights from a
seed) and inserts ``--keyframes`` synthetic keyframes (the textured frames of
``chip_smoke.py`` with a smooth depth, cameras panning along x). It then runs
``--steps`` warm-up steps, times ``--window`` steps (synchronized), times
each part of a step over the same window, and profiles one more window with
``torch.profiler``. Prints the step time and rays/s, the time per part
(ray batch, forward with the surface-normal pullback, backward, the two Adam
steps, the proposal refresh; each synchronized), the device-busy share
(kernel time / wall), the table kernels' share, and the top kernels.
The window is a multiple of the refresh period (16), so it holds its share
of refresh steps.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import MAPPING, REPLICA, synthetic_frames  # noqa: E402

# the table kernels of csrc/gather.cu by name (their template instances:
# gather_cols_kernel<L, Sink> is row 2 and gather_cols_dot,
# scatter_cols_accum_kernel<F, Src> the scatters' slab design,
# scatter_runs_kernel<F, Src> their atomic runs design and
# scatter_owned_kernel<F, Src> scatter_cols_outer; sort_ids_kernel its sort)
TABLE_KERNELS = ("gather_cols_kernel", "gather_interp_kernel",
                 "gather_interp_mm_kernel", "scatter_cols_accum_kernel",
                 "scatter_runs_kernel", "gather_cols_dfrac_kernel",
                 "scatter_owned_kernel", "sort_ids_kernel")


def keyframe_packet(n, H, W, device):
    frames = synthetic_frames(n, H, W)
    c2w = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    c2w[:, 0, 3] = np.arange(n) * 0.02
    yy, xx = np.meshgrid(np.linspace(0, 1, H), np.linspace(0, 1, W),
                         indexing="ij")
    depth = (2.0 + 0.5 * np.cos(3 * xx) * np.sin(2 * yy)).astype(np.float32)
    intr = np.asarray([[320.0, 320.0, W / 2, H / 2]], np.float32)
    return {
        "camera_extrinsics": torch.tensor(c2w),
        "camera_intrinsics": torch.tensor(np.repeat(intr, n, 0)),
        "frames_color_float": torch.tensor(
            np.stack(frames).astype(np.float32) / 255.0, device=device),
        "frames_depth": torch.tensor(np.repeat(depth[None], n, 0),
                                     device=device),
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--keyframes", type=int, default=16)
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--window", type=int, default=16)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from nerf_vo_tpu_torch.mapping import trainer as trainer_mod
    from nerf_vo_tpu_torch.runtime.stages import MappingStage

    args = SimpleNamespace(**REPLICA, **MAPPING)
    stage = MappingStage(args, device="cuda")
    stage.update(keyframe_packet(a.keyframes, args.frame_height,
                                 args.frame_width, "cuda"))
    stage.stream_active = False
    model = stage.model

    parts = {"ray batch": 0.0, "forward": 0.0, "backward": 0.0,
             "adam": 0.0, "refresh": 0.0}
    timing = [False]
    active = []  # a part called inside another (the forward's surface
    # pullback calls autograd.grad) counts toward the outer one

    def timed(name, fn):
        def wrap(*x, **k):
            if not timing[0] or active:
                return fn(*x, **k)
            active.append(name)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*x, **k)
            torch.cuda.synchronize()
            parts[name] += time.perf_counter() - t0
            active.pop()
            return out
        return wrap

    kb = trainer_mod.kb
    kb.sample_ray_batch = timed("ray batch", kb.sample_ray_batch)
    model.loss = timed("forward", model.loss)
    torch.autograd.grad = timed("backward", torch.autograd.grad)
    model.refresh_proposals = timed("refresh", model.refresh_proposals)
    for opt in (stage.state.opt, stage.state.cam_opt):
        opt.step = timed("adam", opt.step)

    for _ in range(a.steps):
        stage.train_step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(a.window):
        stage.train_step()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / a.window
    print(f"{torch.cuda.get_device_name(0)}; steady step {wall * 1e3:.2f} ms "
          f"({args.rays_per_batch / wall:.0f} rays/s), {a.keyframes} "
          f"keyframes, step {stage.step_count}")

    timing[0] = True
    t0 = time.perf_counter()
    for _ in range(a.window):
        stage.train_step()
    torch.cuda.synchronize()
    synced = (time.perf_counter() - t0) / a.window
    timing[0] = False
    for k, v in parts.items():
        print(f"  {k}: {v / a.window * 1e3:.2f} ms/step (synchronized)")
    print(f"  step with the parts synchronized: {synced * 1e3:.2f} ms")

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof:
        for _ in range(a.window):
            stage.train_step()
        torch.cuda.synchronize()
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in kernels)
    n_launch = sum(e.count for e in kernels)
    table_us = sum(e.self_device_time_total for e in kernels
                   if any(n in e.key for n in TABLE_KERNELS))
    print(f"device busy {dev_us / a.window / 1e3:.2f} ms/step of "
          f"{wall * 1e3:.2f} ms wall ({dev_us / a.window / 1e3 / (wall * 1e3):.1%}"
          f" busy, profiler on); {n_launch / a.window:.0f} kernel launches "
          f"per step; the table kernels {table_us / a.window / 1e3:.3f} "
          f"ms/step ({table_us / max(dev_us, 1):.1%} of device time)")
    print(events.table(sort_by="self_device_time_total", row_limit=30,
                       max_name_column_width=60))


if __name__ == "__main__":
    main()
