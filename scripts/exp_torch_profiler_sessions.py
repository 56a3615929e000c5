"""Does a profiler session over CUDA-graph replays leave a later session in
the same process without the card's kernels? On the card:

    python3 scripts/exp_torch_profiler_sessions.py [CASE ...]

Each case runs in a process of its own: it does its work (below), then
opens a probe session around one ``gather_interp`` call and one
``torch.add``, and prints one JSON line: the kernels the probe session
recorded (all, ``gather_interp``'s by any name and by its demangled name
``gather_interp_kernel<``, and the first characters of each name), the
runtime launches it recorded, and the span bookkeeping of
``runtime/perf.py`` after the work.

- ``none``: the probe alone; ``probe2``: two probes, one after the other;
- ``plain_graph`` / ``kernel_graph``: a ``torch.cuda.graph`` of a few
  ``torch`` ops / of a ``gather_interp`` call, replayed under a profiler;
- ``ngp``: ``tests/test_torch_ngp_step_graph.py``'s occupancy mapper,
  8 replayed steps under a profiler after its warm-up;
- ``ngp_unsegmented``: the same with every span's ``segment`` off (the
  occupancy work inside the step's graphs, replayed under ``map.replay``);
- ``ngp_unprofiled``: the same warm-up and replays, no profiler;
- ``ngp_eager``: the occupancy mapper's steps driven eagerly (no graph)
  under a profiler;
- ``vo``: ``tests/test_torch_step_graph.py``'s nerfacto mapper, its
  replays under a profiler;
- ``corr_lib``: the correlation kernel's library loaded (as
  ``tests/test_torch_gather_cuda.py``'s traced test loads it), no
  profiler; ``ngp_corr_lib``: ``ngp``, then the library loaded;
- ``graph_freed_inside`` / ``ngp_freed_inside``: ``kernel_graph``'s graph /
  ``ngp``'s trainer and its graphs kept, then freed (``gc.collect()``)
  inside the probe's session, before its calls; ``ngp_freed_before``: the
  trainer freed before the session;
- ``ngp_read``: ``ngp`` with every event of its session read
  (``kineto_results().events()``, as ``benchmark/yardstick`` reads them);
  ``ngp_window`` / ``ngp_window_read``: ``ngp`` / ``ngp_read`` with the
  replays inside a ``record_function`` range;
- ``ngp_test``: the profiled replays of
  ``tests/test_torch_ngp_step_graph.py``'s occupancy span test
  (``_occupancy_parts``, which the test runs in a process of its own).
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = ("none", "probe2", "plain_graph", "kernel_graph", "ngp",
         "ngp_unsegmented", "ngp_unprofiled", "ngp_eager", "vo", "corr_lib",
         "ngp_corr_lib", "graph_freed_inside", "ngp_freed_inside",
         "ngp_freed_before", "ngp_read", "ngp_window", "ngp_window_read",
         "ngp_test")


def _profile(fn):
    from torch.profiler import ProfilerActivity, profile
    import torch

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return prof


def probe(inside=None) -> dict:
    """The probe session (``inside()`` first in it, where given)."""
    import torch
    from torch.autograd import DeviceType

    from nerf_vo_tpu_torch.ops import gather_cuda as gc

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    tab = torch.randn(4096, 64, device=dev, generator=g)
    idx = torch.randint(0, 4096, (65536,), device=dev, generator=g,
                        dtype=torch.int32)
    w = torch.rand(65536, 32, device=dev, generator=g)
    a = torch.randn(1024, device=dev)
    gc.gather_interp(tab, idx, w, 2)  # warm

    def work():
        if inside is not None:
            inside()
        gc.gather_interp(tab, idx, w, 2)
        torch.add(a, 1.0)

    events = _profile(work).profiler.kineto_results.events()
    cuda = [e.name() for e in events if e.device_type() == DeviceType.CUDA]
    return {"kernels": len(cuda),
            "gather_interp": sum("gather_interp" in n for n in cuda),
            "demangled": sum("gather_interp_kernel<" in n for n in cuda),
            "names": [n[:60] for n in cuda],
            "launches": sum(e.device_type() == DeviceType.CPU
                            and e.name().startswith("cudaLaunch")
                            for e in events)}


def _ngp_replays(profiled: bool, read: bool = False, window: bool = False):
    """``tests/test_torch_ngp_step_graph.py``'s occupancy mapper warmed up,
    then 8 replayed steps (two refreshes), under a profiler or not."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import torch
    import test_torch_ngp_step_graph as t

    dev = torch.device("cuda")
    buf = t._buffer(dev)
    tr, st = t._trainer(dev)
    t._warm(tr, st, buf, dev)

    def steps():
        with (torch.profiler.record_function("bench.window") if window
              else contextlib.nullcontext()):
            for step in range(10, 18):
                tr.train_step(st, buf, t._draws(tr, step, dev))
            torch.cuda.synchronize()

    if profiled:
        prof = _profile(steps)
        if read:
            for k in prof.profiler.kineto_results.events():
                k.name(), k.start_ns(), k.correlation_id()
    else:
        steps()
    return tr


def _freed(held: list):
    """Drops what ``held`` holds and collects it, when called."""
    import gc

    def free():
        held.clear()
        gc.collect()
    return free


def work(case: str):
    """The case's work; returns what the probe runs inside its session."""
    import torch

    dev = torch.device("cuda")
    if case == "probe2":
        probe()
    elif case in ("plain_graph", "kernel_graph", "graph_freed_inside"):
        from nerf_vo_tpu_torch.ops import gather_cuda as gc

        x = torch.randn(4096, 64, device=dev)
        idx = torch.randint(0, 4096, (65536,), device=dev,
                            dtype=torch.int32)
        w = torch.rand(65536, 32, device=dev)
        gc.gather_interp(x, idx, w, 2)
        s = torch.cuda.Stream()
        s.wait_stream(torch.cuda.current_stream())
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(s), torch.cuda.graph(graph):
            y = (x * 2.0 + 1.0).sum()
            if case != "plain_graph":
                y = y + gc.gather_interp(x, idx, w, 2).sum()
        torch.cuda.current_stream().wait_stream(s)
        _profile(lambda: [graph.replay() for _ in range(4)])
        if case == "graph_freed_inside":
            held = [graph]
            del graph
            return _freed(held)
    elif case in ("ngp_freed_inside", "ngp_freed_before"):
        held = [_ngp_replays(True)]
        free = _freed(held)
        if case == "ngp_freed_before":
            free()
            return None
        return free
    elif case in ("ngp_read", "ngp_window", "ngp_window_read"):
        _ngp_replays(True, read=case != "ngp_window",
                     window=case != "ngp_read")
    elif case == "ngp_test":
        sys.path.insert(0, os.path.join(ROOT, "tests"))
        import test_torch_ngp_step_graph as t

        t._occupancy_parts()
    elif case in ("ngp", "ngp_corr_lib"):
        _ngp_replays(True)
        if case == "ngp_corr_lib":
            from nerf_vo_tpu_torch.ops import correlation_cuda

            correlation_cuda._lib()
    elif case == "corr_lib":
        from nerf_vo_tpu_torch.ops import correlation_cuda

        correlation_cuda._lib()
    elif case == "ngp_unsegmented":
        from nerf_vo_tpu_torch.mapping import trainer
        from nerf_vo_tpu_torch.models import nerfacto
        from nerf_vo_tpu_torch.runtime import perf

        def unsegmented(name, segment=False):
            return perf.span(name)

        trainer.span = nerfacto.span = unsegmented
        _ngp_replays(True)
    elif case == "ngp_unprofiled":
        _ngp_replays(False)
    elif case == "ngp_eager":
        sys.path.insert(0, os.path.join(ROOT, "tests"))
        import test_torch_ngp_step_graph as t

        buf = t._buffer(dev)
        tr, st = t._trainer(dev)
        t._eager_refresh(tr)

        def steps():
            for step in range(8):
                d = t._draws(tr, step, dev)
                tr.gradients(st, buf, d)
                tr.update(st, d)

        _profile(steps)
    elif case == "vo":
        sys.path.insert(0, os.path.join(ROOT, "tests"))
        import test_torch_step_graph as t

        buf = t._buffer(dev)
        tr, st = t._trainer(dev, 256)
        for step in range(4):
            tr.train_step(st, buf, t._draws(tr, step, 256, dev))
        _profile(lambda: [tr.train_step(st, buf, t._draws(tr, s, 256, dev))
                          for s in range(4, 12)])


def run_case(case: str) -> dict:
    from nerf_vo_tpu_torch.runtime import perf

    inside = work(case)
    return {"case": case, "probe": probe(inside),
            "tracking": perf._tracking, "edge": perf._edge is not None,
            "open": list(getattr(perf._open, "stack", []))}


def main(argv) -> None:
    if argv[:1] == ["--one"]:
        sys.path.insert(0, ROOT)
        print(json.dumps(run_case(argv[1])), flush=True)
        return
    for case in argv or CASES:
        out = subprocess.run([sys.executable, __file__, "--one", case],
                             capture_output=True, text=True, cwd=ROOT,
                             timeout=600)
        lines = out.stdout.strip().splitlines()
        print(lines[-1] if out.returncode == 0 and lines else json.dumps(
            {"case": case, "rc": out.returncode,
             "stderr": out.stderr[-1500:]}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
