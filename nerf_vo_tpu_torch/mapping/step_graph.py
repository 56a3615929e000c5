"""A mapping train step replayed as CUDA graphs between the table kernels.

The hand-written table kernels stay eager calls (their launch counters,
the hooks installed on ``ops/gather_cuda.py``'s functions and the spans
around them keep seeing every call); everything PyTorch launches between
them is captured once and replayed. :class:`StepGraphs` holds one step as
an ordered list of items:

- a graph: one segment of the step, replayed inside the span
  ``map.replay``, or, where it was captured inside a segment span
  (``span(name, segment=True)``, ``runtime/perf.py``), inside the spans
  open at its capture up to the innermost such span;
- a call: one table-kernel call, made again at replay through the
  module attribute ``gather_cuda.<name>`` with the inputs it had at
  capture and ``out=`` the buffer its result went to (which the next
  graph reads), inside the spans that were open at the call;
- an eager item: host-side work between segments (the camera learning
  rate, which a capturable Adam reads from the device), inside its part's
  span.

Capture (:meth:`StepGraphs.capture`) runs one step on a side stream with
the table kernels' module functions replaced by breakers: each ends the
open segment, replays it (so the kernel gets real inputs and the step
trains as an eager step would), makes the call and begins the next
segment. The caller opens a segment per part of the step
(:meth:`StepGraphs.segment`); a segment span that opens or closes inside
one ends it and begins the next too, so that the span's work is a graph
of its own. Autograd's device thread makes the
backward's calls, so a segment may begin on one thread and end on
another: the capture runs in CUDA's relaxed mode. Every segment allocates
from one shared memory pool and is replayed in the order it was captured,
so each tensor a graph or a call reads has, at replay, the address it had
at capture. A segment that launched nothing is not replayed.
"""

from __future__ import annotations

import contextlib
import warnings
from typing import Callable, List

import torch

from nerf_vo_tpu_torch.ops import gather_cuda as gc
from nerf_vo_tpu_torch.runtime import perf
from nerf_vo_tpu_torch.runtime.perf import span

# the gather_cuda functions the hash grid calls: a segment ends at each
TABLE_KERNELS = ("gather_interp_mm", "gather_interp", "gather_cols_dfrac",
                 "scatter_cols_outer")
_EMPTY = "The CUDA Graph is empty"  # PyTorch's warning at such a capture


class _Call:
    """One table-kernel call: its function's name, its inputs, the buffer
    its result is written to, and the spans open at it (the step's part
    first)."""

    def __init__(self, name, args, kwargs, out, part, spans):
        self.name, self.args, self.kwargs, self.out = name, args, kwargs, out
        # autograd's thread opens only its own spans, not the part's
        part_span = "map." + part
        self.spans = spans if spans[:1] == (part_span,) else (
            (part_span,) + spans)

    def __call__(self):
        got = getattr(gc, self.name)(*self.args, out=self.out, **self.kwargs)
        if got is not self.out:  # a hook that made its own result
            self.out.copy_(got)


class StepGraphs:
    """One train step's graphs and table-kernel calls (see the module
    docstring). ``key``: what the capture read from outside its pool
    (the caller's to compare); ``draws``: the static draw buffers the
    graphs read, which a replay fills first; ``metrics``: the caller's
    (names, tensor) of the step's loss terms, which the graphs write."""

    def __init__(self, device, key, draws):
        self.device = torch.device(device)
        self.key = key
        self.draws = draws
        self.metrics = None
        self.items: List[tuple] = []
        self.pool = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream(self.device)
        self._open = None  # (part, graph, spans) being captured
        self._empty: List[torch.cuda.CUDAGraph] = []  # captured, not replayed

    # -- capture -------------------------------------------------------------

    def capture(self, run: Callable):
        """``run(self)`` on the side stream with the table kernels'
        breakers installed; returns its result. ``run`` opens the step's
        segments with :meth:`segment` and adds eager items with
        :meth:`eager`."""
        cur = torch.cuda.current_stream(self.device)
        torch.cuda.synchronize(self.device)
        self.stream.wait_stream(cur)
        kernels = {k: getattr(gc, k) for k in TABLE_KERNELS}
        breakers = {k: self._breaker(k, fn) for k, fn in kernels.items()}
        for k, b in breakers.items():
            setattr(gc, k, b)
        try:
            with torch.cuda.stream(self.stream), \
                    perf.tracking(self._edge):
                try:
                    out = run(self)
                finally:
                    if self._open is not None:  # an error in a segment
                        g, self._open = self._open[1], None
                        with contextlib.suppress(Exception):
                            g.capture_end()
        finally:
            for k, fn in kernels.items():
                # the wrappers count launches on their module's function
                fn.launches += breakers[k].launches
                setattr(gc, k, fn)
        cur.wait_stream(self.stream)
        return out

    @contextlib.contextmanager
    def segment(self, part: str):
        """Capture the work inside as the step's ``part`` (one segment,
        or several where table kernels are called)."""
        self._begin(part)
        yield
        self._end()

    def eager(self, part: str, fn: Callable[[], None]) -> None:
        """Run ``fn`` now, outside any segment, and at every replay here."""
        fn()
        self.items.append(("eager", part, fn))

    def _begin(self, part: str) -> None:
        # inside a segment span the graph replays inside the spans open
        # now, up to the innermost one; elsewhere inside map.replay
        spans = perf.segment_spans()
        g = torch.cuda.CUDAGraph()
        g.capture_begin(pool=self.pool, capture_error_mode="relaxed")
        self._open = (part, g, spans)

    def _end(self) -> None:
        part, g, spans = self._open
        self._open = None
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            g.capture_end()
        empty = False
        for w in caught:
            if _EMPTY in str(w.message):
                empty = True
            else:
                warnings.warn(w.message, w.category)
        if empty:
            self._empty.append(g)  # its allocations stay the pool's
            return
        g.replay()
        self.items.append(("graph", part, (g, spans)))

    def _edge(self) -> None:
        """A segment span opened or closed: a new segment begins."""
        if self._open is not None and torch.cuda.is_current_stream_capturing():
            part = self._open[0]
            self._end()
            self._begin(part)

    def _breaker(self, name: str, fn: Callable):
        def call(*args, **kwargs):
            if self._open is None \
                    or not torch.cuda.is_current_stream_capturing():
                return fn(*args, **kwargs)  # not this step's capture
            part = self._open[0]
            self._end()
            out = fn(*args, **kwargs)
            self.items.append(("call", _Call(name, args, kwargs, out, part,
                                             perf.open_spans())))
            self._begin(part)
            return out
        call.launches = 0
        return call

    # -- replay --------------------------------------------------------------

    def replay(self) -> None:
        """Every item in order, on the current stream."""
        profiling = perf.profiling()
        for item in self.items:
            if item[0] == "graph":
                g, spans = item[2]
                if spans is None:
                    with span("map.replay"):
                        g.replay()
                elif not profiling:
                    g.replay()
                else:
                    with _spans(spans):
                        g.replay()
            elif item[0] == "eager":
                with span("map." + item[1]):
                    item[2]()
            elif not profiling:
                item[1]()
            else:
                with _spans(item[1].spans):
                    item[1]()

    def counts(self) -> dict:
        """Graphs, calls and eager items a replay makes."""
        out = {"graph": 0, "call": 0, "eager": 0}
        for item in self.items:
            out[item[0]] += 1
        return out

    def release(self) -> None:
        """Drop the graphs and buffers once the card is done with them."""
        torch.cuda.synchronize(self.device)
        self.items.clear()
        self._empty.clear()
        self.draws = self.metrics = None


@contextlib.contextmanager
def _spans(names):
    """The spans ``names``, outermost first, open inside."""
    with contextlib.ExitStack() as open_:
        for name in names:
            open_.enter_context(span(name))
        yield


def draw_buffers(draws) -> dict:
    """Static copies of a step's draws ({"frame", "py", "px", "uniforms"})."""
    return {k: ([u.clone() for u in v] if k == "uniforms" else v.clone())
            for k, v in draws.items()}


def fill_draws(static, draws) -> None:
    """Copy a step's draws into the static buffers (each draw the buffers
    hold)."""
    for k, buf in static.items():
        if k == "uniforms":
            for s, u in zip(buf, draws[k]):
                s.copy_(u)
        else:
            buf.copy_(draws[k])
