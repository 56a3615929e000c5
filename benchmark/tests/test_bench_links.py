"""On the card: every device operation of the program's table kernels in a
profiled mapping step has its launch in the trace (the libraries link the
CUDA runtime dynamically), inside the benchmark's range of the wrapper call
that launched it (``bench.<wrapper>#<n>``) and the program's hash grid span
(``nerf_vo.hash.encode`` / ``.backward``; the normals' pullback in
``nerf_vo.map.field``), and the pairing by name and
launch order that the roofline readers use (``drivers/map.py``
``KERNEL_OPS``) gives each call the operations its launches made."""

import pytest
import torch

from benchmark import harness
from benchmark.tests import tiny
from benchmark.yardstick import parts
from benchmark.yardstick.trace import Trace

# each kernel of csrc/gather.cu on vo.map's path: the roofline wrapper whose
# call launches it (None: no roofline reads it) and the program's spans it
# is launched in (the normals' position pullback runs in the final field's
# forward, outside the hash grid's backward)
LINKED = {"gather_interp_kernel<": ("gather_interp", ("hash.encode",)),
          "sort_ids_kernel": ("scatter_cols_outer", ("hash.backward",)),
          "scatter_owned_kernel": ("scatter_cols_outer", ("hash.backward",)),
          "gather_cols_dfrac_kernel": (None, ("hash.backward", "map.field"))}
OWN = ("gather_cols_kernel", "gather_interp_kernel", "gather_interp_mm_kernel",
       "scatter_cols_accum_kernel", "scatter_runs_kernel",
       "scatter_owned_kernel", "sort_ids_kernel", "gather_cols_dfrac_kernel")


@pytest.fixture(scope="module")
def profiled():
    """Two vo.map steps (the mapper at its widths, a 4-keyframe buffer)
    profiled as the benchmark's traced run profiles its window."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    from torch.profiler import ProfilerActivity, profile, record_function

    cell = harness.Cell("vo.map")
    tiny.configure(cell)
    cell.config["rays_per_batch"] = 1024
    ctx = harness.context(cell, 3500000017, "cuda:0")
    drv = cell.driver
    state = drv.setup(ctx)
    calls = {k: [] for k in drv.KERNEL_OPS}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with drv._spans(state.stage, calls, 2):
            with record_function("bench.window"):
                for _ in range(2):
                    state.stage.train_step()
                torch.cuda.synchronize()
    return (drv, parts.Window.from_profiler(prof, "bench.window"),
            Trace.from_profiler(prof, "bench.window"))


def _calls(tr, wrapper):
    """The benchmark's range of each call of ``wrapper``, in call order."""
    return [(a, b) for _, a, b in sorted(
        (int(n.split("#")[1]), a, b) for n, a, b, _ in tr.ranges
        if n.startswith(f"bench.{wrapper}#"))]


def _inside(t, spans):
    return sum(a <= t < b for a, b in spans)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", sorted(LINKED))
def test_kernel_is_launched_inside_its_call(profiled, kernel):
    _, w, tr = profiled
    ops = [op for op in w.in_window() if kernel in op[2]]
    assert ops, f"no {kernel} in the window"
    launches = [w.launch(op) for op in ops]
    assert all(h is not None for h in launches), kernel
    wrapper, program = LINKED[kernel]
    ours = [(a, b) for n, a, b in w.ranges
            if n[len(parts.PREFIX):] in program]
    assert [_inside(h[0], ours) for h in launches] == [1] * len(ops)
    if wrapper is None:
        return
    calls = [s for s in _calls(tr, wrapper)
             if any(s[0] <= h[0] < s[1] for h in launches)]
    # each launch in one call of its wrapper, the k-th operation by the
    # card's order in the k-th call that launched
    assert [_inside(h[0], calls) for h in launches] == [1] * len(ops)
    assert [next(i for i, (a, b) in enumerate(calls) if a <= h[0] < b)
            for h in launches] == list(range(len(ops)))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["gather_interp", "scatter_cols_outer"])
def test_kernel_ops_pairing_is_the_link(profiled, name):
    drv, w, tr = profiled
    mine = [h[0] for op in w.in_window()
            if any(k in op[2] for k, v in LINKED.items() if v[0] == name)
            for h in [w.launch(op)] if h is not None]
    # the calls that launched (an empty call launches nothing)
    live = [(a, b) for a, b in _calls(tr, name)
            if any(a <= t < b for t in mine)]
    pairing = drv._call_ops(tr, name, len(live))
    assert pairing is not None and len(live) > 0
    ops = {(op[0], op[2]): op for op in w.device}  # the trace's clock
    for (a, b), call in zip(live, pairing):
        for t0, _, n in call:
            if any(key in n for key in LINKED):  # not the scatter's zeroing
                assert a <= w.launch(ops[(t0, n)])[0] < b


@pytest.mark.cuda
def test_parts_cover_the_window(profiled):
    _, w, tr = profiled
    r = w.reduce()
    launches = sum(v["launches"] for v in r["parts"].values())
    assert launches + r["outside"] == tr.count() == r["count"]
    assert not [n for n in r["unlinked_ops"] if any(k in n for k in OWN)]
    assert all(v["launches"] > 0 for v in r["parts"].values()), r
    print({p: v["launches"] for p, v in r["parts"].items()},
          "outside", r["outside"], "unlinked", r["unlinked_ops"])
