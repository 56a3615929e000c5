"""Tracking inside the PyTorch port's pipeline against tracking alone, on
one NVIDIA GPU.

    python3 scripts/exp_torch_pipeline_modes.py [--rounds 2] [--iterations 64]

Tracks the 48 synthetic 360x640 frames of ``chip_smoke.py`` at the replica
configuration (random weights from a seed) four ways, in turns:
``TrackingStage`` alone with a ``torch.cuda.synchronize`` after each frame
(as ``chip_smoke.py`` phase (b) times it), the same without the
synchronize, and ``runtime.pipeline.execute`` in serial and in threaded
mode (``mapping_iterations`` cut to ``--iterations``). Each round runs
them in the order alone+sync, alone, serial, threaded, then backwards.
Prints the card's name and power limit, then per run the steady tracking
frames/s over the frames after ``tracking_init_frames`` (the last frame
left out); a pipeline run reads its tracking spans from the runtime CSV
that ``execute`` writes.
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys
import tempfile
import time
from types import SimpleNamespace

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import (  # noqa: E402
    MAPPING, N_FRAMES, PIPELINE, REPLICA, synthetic_frames)

INIT_FRAMES = 8  # the stages' default tracking_init_frames


def steady_fps(times):
    steady = times[INIT_FRAMES:-1]
    return len(steady) / sum(steady)


def alone(frames, intr, sync):
    from nerf_vo_tpu_torch.runtime.stages import TrackingStage

    stage = TrackingStage(SimpleNamespace(**REPLICA), device="cuda")
    times = []
    for i, img in enumerate(frames):
        t0 = time.perf_counter()
        stage.step(dict(frame_index=i, frame_color=img,
                        camera_intrinsics=intr,
                        last_frame=i == len(frames) - 1))
        if sync:
            torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return steady_fps(times)


def pipelined(frames, intr, threaded, iterations):
    from nerf_vo_tpu_torch.runtime.pipeline import execute

    tmp = tempfile.mkdtemp(prefix="exp_pipeline_")
    try:
        args = SimpleNamespace(**{
            **REPLICA, **MAPPING, **PIPELINE,
            "multithreading": threaded, "mapping_iterations": iterations,
            "mapping_snapshot_iterations": iterations,
            "dir_result": tmp})
        dataset = [dict(frame_index=i, camera_intrinsics=intr,
                        frame_color=img, last_frame=i == len(frames) - 1)
                   for i, img in enumerate(frames)]
        execute(args, device="cuda", dataset=dataset)
        torch.cuda.synchronize()
        with open(os.path.join(tmp, "runtime_tracking.csv")) as f:
            times = [float(line.split(",")[1])
                     for line in f.read().split()[1:]]
        return steady_fps(times)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--iterations", type=int, default=64)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    from nerf_vo_tpu_torch.ops import cuda_build

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0], flush=True)
    cuda_build.build_all(["corr", "gather"])
    H, W = REPLICA["frame_height"], REPLICA["frame_width"]
    frames = synthetic_frames(N_FRAMES, H, W)
    intr = dict(fx=320.0, fy=320.0, cx=W / 2, cy=H / 2)
    runs = {
        "alone, synchronized": lambda: alone(frames, intr, True),
        "alone": lambda: alone(frames, intr, False),
        "pipeline, serial": lambda: pipelined(frames, intr, False,
                                              a.iterations),
        "pipeline, threaded": lambda: pipelined(frames, intr, True,
                                                a.iterations),
    }
    order = list(runs) + list(reversed(runs))
    alone(frames, intr, True)  # warm-up: cuDNN choices, allocator
    for r in range(a.rounds):
        for name in order:
            print(f"round {r}, {name}: steady tracking "
                  f"{runs[name]():.2f} frames/s", flush=True)


if __name__ == "__main__":
    main()
