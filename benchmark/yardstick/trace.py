"""Reduction of a ``torch.profiler`` trace to what the readers need.

Device time is the union of the intervals in which a kernel, a memory copy
or a memory set ran on the card, never a sum of self times (the profiler's
projections of host annotations onto the card's timeline are left out).
The host side is the benchmark's own ``record_function`` ranges (named
``bench.<span>``) around its calls into the program, which name the idle
stretches.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple

PREFIX = "bench."
NAME_CHARS = 160  # of a kernel's name in the breakdown
Interval = Tuple[float, float]


def union(intervals: Iterable[Interval]) -> List[Interval]:
    """The sorted, disjoint union of [start, end) intervals."""
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def clip(intervals: Iterable[Interval], lo: float, hi: float
         ) -> List[Interval]:
    return [(max(a, lo), min(b, hi)) for a, b in intervals
            if min(b, hi) > max(a, lo)]


def busy(intervals: Iterable[Interval], lo: float, hi: float) -> float:
    """Length of the union of the intervals inside [lo, hi)."""
    return sum(b - a for a, b in union(clip(intervals, lo, hi)))


def gaps(intervals: Iterable[Interval], lo: float, hi: float
         ) -> List[Interval]:
    """The idle stretches of [lo, hi) between the intervals."""
    out, t = [], lo
    for a, b in union(clip(intervals, lo, hi)):
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if hi > t:
        out.append((t, hi))
    return out


class Trace:
    """A profiled window: ``device`` [(start, end, name)] on the card,
    ``ranges`` [(name, start, end, thread)] of the benchmark's spans,
    ``window`` (start, end); times in microseconds on the profiler's
    clock."""

    def __init__(self, device, ranges, window):
        self.device = sorted(device)
        self.ranges = list(ranges)
        self.window = window

    @classmethod
    def from_profiler(cls, prof, window_name: str) -> "Trace":
        from torch.autograd import DeviceType

        device, ranges = [], []
        window = None
        for e in prof.events():
            t0, t1 = e.time_range.start, e.time_range.end
            if e.device_type == DeviceType.CUDA:
                if not (getattr(e, "is_user_annotation", False)
                        or e.name.startswith(PREFIX)):
                    device.append((t0, t1, e.name))
            elif e.name == window_name:
                window = (t0, t1)
            elif e.name.startswith(PREFIX):
                ranges.append((e.name, t0, t1, e.thread))
        if window is None:
            raise RuntimeError(f"the trace has no {window_name!r} range")
        return cls(device, ranges, window)

    def intervals(self) -> List[Interval]:
        return [(a, b) for a, b, _ in self.device]

    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    def busy_s(self) -> float:
        return busy(self.intervals(), *self.window) * 1e-6

    def count(self) -> int:
        """Device operations (kernels, copies, sets) in the window."""
        lo, hi = self.window
        return sum(1 for a, b, _ in self.device if a < hi and b > lo)

    def ops_named(self, part: str) -> List[Tuple[float, float, str]]:
        """The device operations in the window whose name holds ``part``,
        in the order the card began them."""
        lo, hi = self.window
        return [op for op in self.device
                if part in op[2] and op[0] < hi and op[1] > lo]

    def op_before(self, op) -> Optional[Tuple[float, float, str]]:
        """The device operation the card began last before ``op``."""
        i = self.device.index(op)
        return self.device[i - 1] if i else None

    def span_at(self, t: float) -> str:
        """The innermost benchmark span open at ``t`` (on any thread)."""
        best: Optional[Tuple[float, str]] = None
        for n, a, b, _ in self.ranges:
            if a <= t < b and (best is None or b - a < best[0]):
                best = (b - a, n)
        return best[1][len(PREFIX):].split("#")[0] if best else "outside"

    def top_ops(self, k: int = 10) -> List[list]:
        """The ``k`` device operations with the most time, in seconds."""
        lo, hi = self.window
        tot: Dict[str, float] = {}
        for a, b, n in self.device:
            if a < hi and b > lo:
                tot[n] = tot.get(n, 0.0) + (min(b, hi) - max(a, lo))
        top = sorted(tot.items(), key=lambda x: -x[1])[:k]
        return [[n[:NAME_CHARS], v * 1e-6] for n, v in top]

    def top_gaps(self, k: int = 10) -> List[list]:
        """The ``k`` longest idle stretches, each named by the span the host
        was in when it began, in seconds."""
        g = sorted(gaps(self.intervals(), *self.window),
                   key=lambda x: x[0] - x[1])[:k]
        return [[self.span_at(a), (b - a) * 1e-6] for a, b in g]


def breakdown(tr: Trace) -> Dict[str, Sequence]:
    return {"device_ops": tr.top_ops(), "idle_gaps": tr.top_gaps()}
