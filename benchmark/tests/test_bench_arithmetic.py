"""The metric arithmetic: the device's busy time as a union of intervals,
idle stretches and their labels, rates over the whole window, and the
table kernels' bytes and bounds against ``chip_smoke.py``'s formulas."""

import importlib.util
import json
import math

import pytest
import torch

from benchmark import harness
from benchmark.reference import mapper as ref
from benchmark.yardstick import flops, peaks, table_bytes, trace

ROOT = harness.ROOT


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_busy_is_a_union_not_a_sum():
    iv = [(0, 10), (5, 15), (20, 30), (25, 26), (40, 50)]
    assert trace.union(iv) == [(0, 15), (20, 30), (40, 50)]
    assert trace.busy(iv, 0, 100) == 35  # a sum of durations says 46
    assert trace.busy(iv, 8, 45) == 7 + 10 + 5
    assert trace.gaps(iv, 0, 60) == [(15, 20), (30, 40), (50, 60)]


def test_trace_readings():
    dev = [(0.0, 10.0, "a"), (5.0, 15.0, "b"), (40.0, 50.0, "a")]
    ranges = [("bench.train_step", -5.0, 100.0, 1),
              ("bench.update", 14.0, 45.0, 1)]
    tr = trace.Trace(dev, ranges, (0.0, 100.0))
    assert math.isclose(tr.busy_s(), 25e-6)
    assert tr.count() == 3
    name, t = tr.top_ops()[0]
    assert name == "a" and math.isclose(t, 20e-6)
    (n0, g0), (n1, g1) = tr.top_gaps()[:2]
    assert (n0, n1) == ("train_step", "update")
    assert math.isclose(g0, 50e-6) and math.isclose(g1, 25e-6)
    rec = {"kind": "map", "trace": tr, "trace_steps": 3}
    c = harness.Cell("vo.map")
    assert math.isclose(c.reader("idle_pct.map").read(rec), 75.0)
    assert c.reader("launches_per_step").read(rec) == 1.0


def test_rates_over_the_whole_window():
    c = harness.Cell("vo.map")
    rec = {"kind": "map", "rays": 4096 * 300, "window_s": 10.0}
    assert c.reader("rays_per_s").read(rec) == 4096 * 30
    assert c.reader("rays_per_s").read({"kind": "stream"}) is None
    assert c.reader("setup_s").read({"setup_s": 12.5}) == 12.5


def test_peaks_are_chip_smokes(smoke):
    assert peaks.HBM_BYTES_PER_S == smoke.HBM_BYTES_PER_S
    assert peaks.BF16_FLOP_PER_S == smoke.BF16_FLOP_PER_S
    assert peaks.F32_FLOP_PER_S == smoke.F32_FLOP_PER_S
    for nb, fl in ((1e6, 1e3), (1e3, 1e12)):
        assert math.isclose(peaks.bound_s(nb, fl) * 1e3,
                            smoke.bound(nb, fl)[0])


@pytest.mark.parametrize("F", [1, 2, 8])
def test_table_bytes_are_chip_smokes(smoke, F):
    g = torch.Generator().manual_seed(F)
    tab = torch.randn(64, 32 * F, generator=g)
    idx = torch.randint(-2, 70, (300,), generator=g, dtype=torch.int32)
    w = torch.rand(300, 32, generator=g)
    w[w < 0.6] = 0.0
    assert table_bytes.interp_table_bytes(tab, idx, w, F) \
        == smoke.interp_table_bytes(tab, idx, w, F)
    nb, ops = table_bytes.gather_interp(tab, idx, w, F)
    assert nb == smoke.interp_table_bytes(tab, idx, w, F) \
        + 300 * (4 + 32 * 4 + F * 4)
    assert ops == 2 * 300 * 32 * F
    cot = torch.randn(300, F, generator=g)
    nb, ops = table_bytes.scatter_cols_outer(w, cot, idx, 64)
    # chip_smoke.py adjoint_timing's count for scatter_cols_outer
    assert nb == 300 * (32 * 4 + 4 * F + 4) + 64 * 32 * F * 4
    assert ops == 2 * 300 * 32 * F


def test_roofline_reader():
    c = harness.Cell("vo.map")
    r = c.reader("scatter_cols_outer_roofline")
    calls = [(3.35e6, 0, 2e-6), (3.35e6, 0, 3e-6)]
    assert math.isclose(r.read({"calls": {"scatter_cols_outer": calls}}),
                        40.0)
    assert r.read({"calls": {"scatter_cols_outer": []}}) is None
    assert r.read({}) is None


def test_calls_take_their_own_device_ops():
    """Each recorded call gets the durations of the operations it launched
    in the trace, in launch order: a scatter's zeroing, sort and scatter;
    a gather_interp's one kernel; other operations between them are
    not its own."""
    drv = harness.Cell("vo.map").driver
    dev = [(0.0, 1.0, "void at::native::FillFunctor<float>"),
           (1.0, 3.0, "sort_ids_kernel"),
           (4.0, 8.0, "void scatter_owned_kernel<2, Outer<2>>"),
           (9.0, 10.0, "void gather_interp_kernel<float, 2, 15>"),
           (10.0, 30.0, "void gather_interp_mm_kernel<2>"),
           (31.0, 32.0, "void elementwise_kernel"),
           (32.0, 34.0, "sort_ids_kernel"),
           (35.0, 36.0, "void scatter_owned_kernel<2, Outer<2>>"),
           (40.0, 43.0, "void gather_interp_kernel<float, 2, 15>")]
    tr = trace.Trace(dev, [], (0.0, 50.0))
    W, cot, idx = torch.zeros(5, 32), torch.zeros(5, 2), torch.zeros(
        5, dtype=torch.int32)
    empty = torch.zeros(0, dtype=torch.int32)
    calls = {"scatter_cols_outer": [(W, cot, idx, 8), (W[:0], cot[:0],
                                                       empty, 8),
                                    (W, cot, idx, 8)],
             "gather_interp": [(torch.zeros(8, 64), idx, W, 2)] * 2}
    costs = drv._costs(tr, calls)
    assert [t for _, _, t in costs["scatter_cols_outer"]] == [7e-6, 3e-6]
    assert [t for _, _, t in costs["gather_interp"]] == [1e-6, 3e-6]
    assert costs["scatter_cols_outer"][0][:2] == \
        table_bytes.scatter_cols_outer(W, cot, idx, 8)
    calls["gather_interp"] *= 2  # more calls than the trace has kernels
    assert drv._costs(tr, calls)["gather_interp"] == []


def test_map_step_operations_by_hand():
    mc = ref.model_config(json.loads(
        (ROOT / "benchmark/configs/nerf_vo_replica.json").read_text()))
    got = flops.map_step(mc, 10)
    prop = 2 * (10 * 16 + 16 * 1)
    dens = 2 * (32 * 64 + 64 * 16)
    col = 2 * (63 * 64 + 64 * 64 + 64 * 3)
    nrm = 2 * (15 * 64 + 64 * 64 + 64 * 3)
    fi = 2 * 8 * 2 * 16
    assert math.isclose(got["bfloat16"], 3 * 10 * (256 + 96) * prop
                        + 10 * 48 * (3 * (dens + col + nrm) + dens))
    assert math.isclose(got["float32"], 3 * 10 * (256 + 96) * 2 * 8 * 2 * 5
                        + 4 * 10 * 48 * fi)
