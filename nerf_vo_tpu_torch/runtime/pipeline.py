"""Pipeline orchestrator: data -> tracking -> enhancement -> mapping in one
process.

Counterpart of ``nerf_vo_tpu/runtime/pipeline.py``, which replaces the
reference's 4-process queue pipeline (nerf_vo/execute.py:25-124): the
stages run interleaved on one thread, which launches all device work, and
with ``multithreading: true`` one prefetch thread reads and decodes frames
on the host ahead of it. The frames are the same either way, so the serial
and the threaded mode give the same result; on the CPU both are bitwise
repeatable.

Mapping pacing preserves the reference rule: at most
``mapping_iterations / num_keyframes`` consecutive train-only steps while
the stream is active (mapping_module.py:36-47), then train to completion.
"""

from __future__ import annotations

import os
import queue
import threading

import torch

from nerf_vo_tpu_torch.runtime.perf import PerformanceTracker
from nerf_vo_tpu_torch.runtime.stages import (
    DataStage,
    EnhancementStage,
    MappingStage,
    TrackingStage,
)


def execute(args, device="cuda", dataset=None) -> MappingStage:
    """Run the full VO + mapping pipeline for one scene on ``device``.

    ``dataset``: a frame source for :class:`DataStage` (any object with
    ``__len__`` and ``__getitem__``); the dataset ``args`` names
    otherwise. Writes the prediction directory (``args.dir_prediction``)
    and the per-stage runtime CSVs (``args.dir_result``) where ``args``
    sets them, and returns the mapping stage (holding the trained model),
    as the reference's ``execute(args) -> mapping_model`` does
    (execute.py:126). On ``cuda`` without a card it raises.
    """
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("execute: no CUDA device; pass device='cpu' to "
                           "run the pipeline on the CPU")
    dir_prediction = getattr(args, "dir_prediction", None)
    dir_result = getattr(args, "dir_result", None)
    if dir_prediction:
        os.makedirs(os.path.join(dir_prediction, "snapshots"), exist_ok=True)
        os.makedirs(os.path.join(dir_prediction, "matrices"), exist_ok=True)

    perf = PerformanceTracker(getattr(args, "performance_tracking", True))
    data = DataStage(args, dataset)
    tracking = TrackingStage(args, device=device)
    enhancement = EnhancementStage(args, device=device)
    mapping = MappingStage(args, device=device)

    multithreading = getattr(args, "multithreading", False)
    frames = _threaded_frames(data) if multithreading else _serial_frames(data)

    # Online mapping rate: up to this many train steps per input frame (the
    # reference's per-packet budget of mapping_iterations/num_keyframes
    # still caps the total between packets: can_train enforces it).
    steps_per_frame = int(getattr(args, "mapping_steps_per_frame", 4))

    try:
        done = False
        while not done:
            with perf.track("data"):
                frame = next(frames, None)
            if frame is None:
                done = True

            with perf.track("tracking"):
                packet = tracking.step(frame)

            if packet is not None:
                with perf.track("enhancement"):
                    enhanced = enhancement.step(packet)
                with perf.track("mapping"):
                    mapping.update(enhanced)
                if enhanced is not None and enhanced.get("last_frame"):
                    done = True
            with perf.track("mapping"):
                for _ in range(steps_per_frame):
                    if mapping.train_step() is None:
                        break
    finally:
        frames.close()

    with perf.track("mapping"):
        mapping.finish()

    if dir_prediction:
        tracking.save_artifacts(dir_prediction)
        mapping.save_snapshot(dir_prediction)
    if dir_result:
        perf.write_csvs(dir_result)
    return mapping


def _serial_frames(data: DataStage):
    while True:
        frame = data.step()
        if frame is None:
            return
        yield frame
        if frame.get("last_frame"):
            return


def _threaded_frames(data: DataStage, depth: int = 8):
    """Prefetch frames on a thread that only reads and decodes them on the
    host; the caller's thread does all device work. An exception in the
    thread is raised in the caller; closing the generator stops the
    thread."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                pass
        return False

    def worker():
        try:
            while True:
                frame = data.step()
                if not put(frame) or frame is None or frame.get("last_frame"):
                    return
        except Exception as e:  # handed to the consuming thread
            put(e)

    t = threading.Thread(target=worker, name="frame-prefetch", daemon=True)
    t.start()
    try:
        while True:
            frame = q.get()
            if isinstance(frame, Exception):
                raise frame
            if frame is None:
                return
            yield frame
            if frame.get("last_frame"):
                return
    finally:
        stop.set()
        t.join(timeout=10.0)
