"""Where the PyTorch port's tracking time goes, on one NVIDIA GPU.

    python3 scripts/profile_torch_tracking.py [--frames 40] [--window 8]

Runs ``TrackingStage`` at the replica configuration on the synthetic frames
of ``chip_smoke.py`` (random weights from a seed), then times ``--window``
steady-state frames and profiles the next ``--window`` with
``torch.profiler``. Prints the wall time per frame,
the device-busy share of that wall time (sum of kernel times / wall), the
correlation kernel's device time and launches per frame, the top device
kernels, and the time per tracker phase (encode, host half of the update,
device update), measured with ``torch.cuda.synchronize`` around each.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from types import SimpleNamespace

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import REPLICA, synthetic_frames  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--window", type=int, default=8)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from nerf_vo_tpu_torch.runtime.stages import TrackingStage

    args = SimpleNamespace(**REPLICA)
    H, W = args.frame_height, args.frame_width
    frames = synthetic_frames(a.frames + a.window, H, W)
    stage = TrackingStage(args, device="cuda")
    tr = stage.tracker
    intr = dict(fx=320.0, fy=320.0, cx=W / 2, cy=H / 2)

    # host time per phase, synchronized
    phases = {"encode": 0.0, "prepare_update": 0.0, "vo_update": 0.0}

    def timed(name, fn):
        def wrap(*x, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*x, **k)
            torch.cuda.synchronize()
            phases[name] += time.perf_counter() - t0
            return out
        return wrap

    tr._encode = timed("encode", tr._encode)
    tr._prepare_update = timed("prepare_update", tr._prepare_update)
    tr._vo_update = timed("vo_update", tr._vo_update)

    def step(i):
        stage.step(dict(frame_index=i, frame_color=frames[i],
                        camera_intrinsics=intr))

    n_warm = a.frames - a.window
    for i in range(n_warm):
        step(i)
    torch.cuda.synchronize()
    for k in phases:
        phases[k] = 0.0
    t0 = time.perf_counter()
    for i in range(n_warm, a.frames):
        step(i)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / a.window
    print(f"{torch.cuda.get_device_name(0)}; steady frame {wall * 1e3:.2f} ms"
          f" ({1 / wall:.2f} frames/s), live edges {int(tr.e_valid.sum())}")
    for k, v in phases.items():
        print(f"  {k}: {v / a.window * 1e3:.2f} ms/frame (synchronized)")

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof:
        for i in range(a.frames, a.frames + a.window):
            step(i)
        torch.cuda.synchronize()
    events = prof.key_averages()
    # kernel rows only: the aten rows repeat their kernels' device time
    dev_us = sum(e.self_device_time_total for e in events
                 if e.device_type == DeviceType.CUDA)
    print(f"device busy {dev_us / a.window / 1e3:.2f} ms/frame of "
          f"{wall * 1e3:.2f} ms wall ({dev_us / a.window / 1e3 / (wall * 1e3):.1%}"
          " busy, profiler on)")
    corr = [e for e in events if e.device_type == DeviceType.CUDA
            and "corr" in e.key]
    corr_us = sum(e.self_device_time_total for e in corr)
    print(f"corr kernel: {corr_us / a.window / 1e3:.4f} ms/frame device "
          f"time, {sum(e.count for e in corr) / a.window:.2f} launches/frame")
    print(events.table(sort_by="self_device_time_total", row_limit=25,
                       max_name_column_width=60))


if __name__ == "__main__":
    main()
