"""Per-stage runtime telemetry (counterpart of nerf_vo_tpu/runtime/perf.py).

Parity with the reference's PerformanceTracker + LoggingModule CSVs
(nerf_vo/multiprocessing/performance_tracker.py,
logging_module.py:21-25): every stage step is timed; totals/averages exclude
the first and last step (process_module.py:107-113); per-stage
``runtime_<stage>.csv`` files land in ``dir_result``.

:func:`span` names a range of the program's work for a profiler: the
parts of a mapping step (``map.*``) and the hash grid's encode and backward
(``hash.*``), which ``scripts/profile_torch_mapping.py`` reduces the
card's operations by. It costs one flag check unless a profiler is on.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List

from torch.autograd import _profiler_enabled
from torch.profiler import record_function

PREFIX = "nerf_vo."


def span(name: str):
    """The range ``nerf_vo.<name>``: under an active ``torch.profiler`` (or
    autograd profiler) a ``record_function``, on the clock of the launches
    and device operations the profiler records; otherwise a shared no-op
    context (``record_function`` costs microseconds even with no profiler
    on)."""
    if _profiler_enabled():
        return record_function(PREFIX + name)
    return _NULL


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
