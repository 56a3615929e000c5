"""Per-stage runtime telemetry (counterpart of nerf_vo_tpu/runtime/perf.py).

Parity with the reference's PerformanceTracker + LoggingModule CSVs
(nerf_vo/multiprocessing/performance_tracker.py,
logging_module.py:21-25): every stage step is timed; totals/averages exclude
the first and last step (process_module.py:107-113); per-stage
``runtime_<stage>.csv`` files land in ``dir_result``.

:func:`span` names a range of the program's work for a profiler: the
parts of a mapping step (``map.*``) and the hash grid's encode and backward
(``hash.*``), which ``scripts/profile_torch_mapping.py`` reduces the
card's operations by. It costs two flag checks unless a profiler is on.
While :func:`tracking` is on (the capture of a mapping step's CUDA
graphs), each thread also keeps the names of its open spans
(:func:`open_spans`), so that a replay can open them again around the
work it makes outside its graphs, and the capture is told when a span
opened with ``segment=True`` opens or closes, so that its work is a graph
of its own (:func:`segment_spans`).
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

from torch.autograd import _profiler_enabled
from torch.profiler import record_function

PREFIX = "nerf_vo."

_tracking = False
_edge = None  # while tracked: called as a segment span opens and closes
_open = threading.local()  # .stack: this thread's open (span, segment)


def span(name: str, segment: bool = False):
    """The range ``nerf_vo.<name>``: under an active ``torch.profiler`` (or
    autograd profiler) a ``record_function``, on the clock of the launches
    and device operations the profiler records; otherwise a shared no-op
    context (``record_function`` costs microseconds even with no profiler
    on). ``segment``: a capture of CUDA graphs (``mapping/step_graph.py``)
    makes the span's work a graph of its own, replayed inside it."""
    if _tracking:
        return _Tracked(name, segment)
    if _profiler_enabled():
        return record_function(PREFIX + name)
    return _NULL


def profiling() -> bool:
    """Whether a profiler is on (so that :func:`span` records)."""
    return _profiler_enabled()


@contextlib.contextmanager
def tracking(edge=None):
    """Keep each thread's open span names (:func:`open_spans`) inside;
    ``edge()`` is called after each segment span opens and after it
    closes."""
    global _tracking, _edge
    _tracking, _edge = True, edge
    try:
        yield
    finally:
        _tracking, _edge = False, None


def open_spans() -> Tuple[str, ...]:
    """The names of this thread's open spans, outermost first (empty
    outside :func:`tracking`)."""
    return tuple(n for n, _ in getattr(_open, "stack", ()))


def segment_spans() -> Optional[Tuple[str, ...]]:
    """This thread's open spans up to its innermost open segment span,
    outermost first; None where none is open."""
    stack = getattr(_open, "stack", ())
    inner = [i for i, (_, seg) in enumerate(stack) if seg]
    return tuple(n for n, _ in stack[:inner[-1] + 1]) if inner else None


class _Tracked:
    """A span whose name this thread's stack holds while it is open."""

    def __init__(self, name: str, segment: bool):
        self.name, self.segment = name, segment
        self.inner = (record_function(PREFIX + name) if _profiler_enabled()
                      else _NULL)

    def __enter__(self):
        _open.__dict__.setdefault("stack", []).append(
            (self.name, self.segment))
        self.inner.__enter__()
        if self.segment and _edge is not None:
            _edge()
        return self

    def __exit__(self, *exc):
        self.inner.__exit__(*exc)
        _open.stack.pop()
        if self.segment and _edge is not None and exc[0] is None:
            _edge()
        return False


class PerformanceTracker:
    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.rows: Dict[str, List] = {}

    class _Span:
        def __init__(self, tracker, stage):
            self.tracker = tracker
            self.stage = stage

        def __enter__(self):
            self.t0 = time.perf_counter()
            return self

        def __exit__(self, *exc):
            dt = time.perf_counter() - self.t0
            rows = self.tracker.rows.setdefault(self.stage, [])
            rows.append((len(rows), dt))
            return False

    def track(self, stage: str):
        if not self.enabled:
            return _NullSpan()
        return self._Span(self, stage)

    def summary(self, stage: str) -> Dict[str, float]:
        rows = self.rows.get(stage, [])
        vals = [dt for _, dt in rows[1:-1]] or [dt for _, dt in rows]
        if not vals:
            return {"total": 0.0, "average": 0.0, "steps": 0}
        return {
            "total": sum(dt for _, dt in rows),
            "average": sum(vals) / len(vals),
            "steps": len(rows),
        }

    def write_csvs(self, dir_result: str) -> None:
        os.makedirs(dir_result, exist_ok=True)
        for stage, rows in self.rows.items():
            path = os.path.join(dir_result, f"runtime_{stage}.csv")
            with open(path, "w") as f:
                f.write("step,runtime\n")
                for step, dt in rows:
                    f.write(f"{step},{dt}\n")


class _NullSpan:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _NullSpan()
