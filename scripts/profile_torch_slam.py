"""Where the nerf_slam path's time goes on one NVIDIA GPU.

    python3 scripts/profile_torch_slam.py [--frames N] [--no-phase-g]

Runs ``TrackingStage(droid-slam)`` at the nerf_slam replica width on
``chip_smoke.py``'s synthetic frames (its cuts: random weights, every frame a
keyframe candidate) with synchronized timers around each part of a frame:
the encoders and motion filter, the correlation pyramid, the lookup, the
update net (the ConvGRU and its heads, the agg head over the buffer's
frames), the dense BA, the host's edge bookkeeping (with its pair
distances), and the end-of-stream flush (GRU chunks, pyramids and global BA
of both backend passes). Then, unless ``--no-phase-g``, it runs
``chip_smoke.py``'s phase (g) as that script does. Every line carries the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import collections
import os
import subprocess
import sys
import time
from types import SimpleNamespace

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402


def timed(table, name, fn):
    """``fn`` with its synchronized wall time added to ``table[name]``."""
    def wrapper(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **k)
        torch.cuda.synchronize()
        table[name] += time.perf_counter() - t0
        return out
    return wrapper


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=cs.N_FRAMES)
    ap.add_argument("--no-phase-g", action="store_true")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_slam: no CUDA device")
    from nerf_vo_tpu_torch.ops import cuda_build, dense_ba
    from nerf_vo_tpu_torch.runtime.stages import TrackingStage
    from nerf_vo_tpu_torch.tracking import droid_slam

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    cuda_build.build_all(["gather"])
    dev = torch.device("cuda", 0)

    args = SimpleNamespace(**cs.SLAM, **cs.SLAM_TRACKING_CUTS)
    H, W = args.frame_height, args.frame_width
    frames = cs.synthetic_frames(opts.frames, H, W)
    stage = TrackingStage(args, device=dev)
    tr = stage.tracker
    parts = collections.defaultdict(float)
    tr._encode = timed(parts, "encode", tr._encode)
    tr._motion = timed(parts, "motion filter", tr._motion)
    tr._pyramid = timed(parts, "frontend pyramid", tr._pyramid)
    tr._rebuild_edges = timed(parts, "edge bookkeeping (host + distances)",
                              tr._rebuild_edges)
    for name, mod in (("ConvGRU", tr.net.update.gru),
                      ("agg head", tr.net.update.agg)):
        mod.forward = timed(parts, name, mod.forward)
    update = tr.net.update
    update.forward = timed(parts, "update net (all)", update.forward)
    patched = [(droid_slam, "corr_lookup", "corr lookup"),
               (droid_slam, "build_corr_pyramid",
                "pyramid (motion filter, backend chunks)"),
               (dense_ba, "dense_bundle_adjust", "frontend dense BA"),
               (dense_ba, "global_dense_ba", "global BA solve")]
    saved = [(mod, fn, getattr(mod, fn)) for mod, fn, _ in patched]
    for mod, fn, name in patched:
        setattr(mod, fn, timed(parts, name, getattr(mod, fn)))
    tr.backend = timed(parts, "flush: backend passes", tr.backend)

    intr = dict(fx=320.0, fy=320.0, cx=W / 2, cy=H / 2)
    t0 = time.perf_counter()
    for i, img in enumerate(frames):
        stage.step(dict(frame_index=i, frame_color=img,
                        camera_intrinsics=intr,
                        last_frame=i == len(frames) - 1))
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    print(f"DROID tracking breakdown, {smi}: {len(frames)} frames, "
          f"{len(tr.retired)} keyframes, {total:.2f} s synchronized "
          "(parts overlap where one calls another: the update net holds "
          "the GRU and the agg head; the flush holds its chunks' pyramids, "
          "lookups, GRUs and global BA)", flush=True)
    for name, sec in sorted(parts.items(), key=lambda kv: -kv[1]):
        print(f"  {name}: {sec:.3f} s ({sec / total * 100:.1f}%)",
              flush=True)
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
          " GiB", flush=True)
    for mod, fn, orig in saved:  # phase (g) runs untimed
        setattr(mod, fn, orig)
    del stage, tr
    torch.cuda.empty_cache()
    if not opts.no_phase_g:
        cs.phase_slam(dev, smi)


if __name__ == "__main__":
    main()
