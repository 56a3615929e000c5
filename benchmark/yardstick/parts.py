"""Reduction of a profiled mapping window to the parts of the step, by the
program's own spans: ``nerf_vo.map.sample``, ``.forward``, ``.backward``
and ``.optimizer`` (``runtime/perf.py`` and ``mapping/trainer.py`` in the
port).

A device operation (kernel, copy or set) belongs to the part in which it
was launched. Its launch is the runtime (or driver) call that the profiler
records with the operation's own correlation id (``cudaLaunchKernel``,
``cudaLaunchCooperativeKernel``, ``cudaMemcpyAsync``, ...); the port's
kernels are recorded so because their libraries call the CUDA runtime
PyTorch loaded. The part is the part span open when the launch began, on
whatever thread: autograd's device thread launches the backward's work
while the training thread waits inside ``map.backward``. (The profiler's
``linked_correlation_id`` names the innermost ATen op or autograd node
open at the launch, never a ``record_function`` range, and none where no
op is open.) An operation whose launch the trace lacks is counted
(``unlinked``) and given to no part; ``outside`` counts every operation of
the window in no part, the unlinked ones among them.

For each part: ``launches``, the operations in the window launched inside
it; ``device_s``, the union of their intervals clipped to the window
(never a sum of durations); ``idle_s``, the window's idle stretches
(``trace.gaps``) inside the part's spans.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Tuple

from benchmark.yardstick.trace import NAME_CHARS, busy, gaps, union

PARTS = ("sample", "forward", "backward", "optimizer")
PREFIX = "nerf_vo."
SPAN = PREFIX + "map."
ANNOTATIONS = ("bench.", PREFIX)  # host ranges, not device work
LAUNCH = "cu"  # runtime and driver calls: cudaLaunchKernel, cuLaunchKernel
TOP = 5  # device operations named in each part's breakdown

# device: (start, end, name, correlation id); launches: correlation id ->
# (start, name); ranges: the program's spans (name, start, end); times in
# microseconds on the profiler's clock
Op = Tuple[float, float, str, int]


class Window:
    """What the reduction reads of one profiled window."""

    def __init__(self, device: List[Op], launches: Dict[int, tuple],
                 ranges: List[Tuple[str, float, float]],
                 window: Tuple[float, float], parts=PARTS, prefix=SPAN):
        """``parts``: the names (after ``prefix``) of spans that never
        overlap: the step's four parts; inside ``map.forward``,
        ``("proposal", "field", "loss")``; or the hash grid's
        ``("encode", "backward")`` under ``nerf_vo.hash.``."""
        self.device = sorted(device)
        self.launches = launches
        self.ranges = ranges
        self.parts = tuple(parts)
        self.spans = sorted(((n[len(prefix):], a, b) for n, a, b in ranges
                             if n.startswith(prefix)
                             and n[len(prefix):] in self.parts),
                            key=lambda s: s[1])
        self.starts = [s[1] for s in self.spans]
        self.window = window

    @classmethod
    def from_profiler(cls, prof, window_name: str, parts=PARTS,
                      prefix=SPAN) -> "Window":
        """From the profiler's raw events, on the clock of its
        ``FunctionEvent`` list (``trace.Trace``'s)."""
        from torch.autograd import DeviceType

        result = prof.profiler.kineto_results
        origin = result.trace_start_ns()
        device, launches, ranges, window = [], {}, [], None
        for k in result.events():
            name = k.name()
            t0 = (k.start_ns() - origin) / 1000
            t1 = (k.end_ns() - origin) / 1000
            if k.device_type() == DeviceType.CUDA:
                if not (getattr(k, "is_user_annotation", bool)()
                        or name.startswith(ANNOTATIONS)):
                    device.append((t0, t1, name, k.correlation_id()))
            elif name == window_name:
                window = (t0, t1)
            elif name.startswith(PREFIX):
                ranges.append((name, t0, t1))
            elif name.startswith(LAUNCH):
                launches[k.correlation_id()] = (t0, name)
        if window is None:
            raise RuntimeError(f"the trace has no {window_name!r} range")
        return cls(device, launches, ranges, window, parts, prefix)

    def in_window(self) -> List[Op]:
        lo, hi = self.window
        return [op for op in self.device if op[0] < hi and op[1] > lo]

    def launch(self, op: Op):
        """The (start, name) of the call that launched ``op``, or None."""
        return self.launches.get(op[3])

    def part_at(self, t: float):
        """The part whose span is open at ``t``, or None."""
        i = bisect.bisect_right(self.starts, t) - 1
        if i >= 0 and t < self.spans[i][2]:
            return self.spans[i][0]
        return None

    def reduce(self) -> Dict:
        lo, hi = self.window
        ops = self.in_window()
        mine: Dict[str, List[Op]] = {p: [] for p in self.parts}
        unlinked: Dict[str, int] = {}
        for op in ops:
            h = self.launch(op)
            if h is None:
                name = op[2][:NAME_CHARS]
                unlinked[name] = unlinked.get(name, 0) + 1
                continue
            part = self.part_at(h[0])
            if part is not None:
                mine[part].append(op)
        idle = gaps([(a, b) for a, b, _, _ in ops], lo, hi)
        parts = {}
        for p in self.parts:
            own = [(a, b) for q, a, b in self.spans if q == p]
            parts[p] = {
                "launches": len(mine[p]),
                "device_s": busy([(a, b) for a, b, _, _ in mine[p]],
                                 lo, hi) * 1e-6,
                "idle_s": _overlap(idle, own) * 1e-6,
                "top_ops": _top(mine[p], lo, hi),
            }
        return {"window_s": (hi - lo) * 1e-6, "count": len(ops),
                "parts": parts,
                "outside": len(ops) - sum(len(v) for v in mine.values()),
                "unlinked": sum(unlinked.values()),
                "unlinked_ops": unlinked}


def _overlap(a, b) -> float:
    """Length of the intersection of two sets of intervals."""
    a, b = union(a), union(b)
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0.0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def _top(ops: List[Op], lo: float, hi: float) -> List[list]:
    """The part's ``TOP`` operation names with the most time in the
    window, in seconds."""
    tot: Dict[str, float] = {}
    for a, b, n, _ in ops:
        tot[n] = tot.get(n, 0.0) + (min(b, hi) - max(a, lo))
    top = sorted(tot.items(), key=lambda x: -x[1])[:TOP]
    return [[n[:NAME_CHARS], v * 1e-6] for n, v in top]
