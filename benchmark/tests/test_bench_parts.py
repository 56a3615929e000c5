"""``yardstick/parts.py`` on synthetic windows: operations go to the part
in which their launch began, on any thread; device time is a union;
idle stretches are cut at the parts' edges; unlinked operations are
counted and given to no part."""

import math

from benchmark.yardstick import parts
from benchmark.yardstick.trace import Trace

# one step: sample [0, 10), forward [10, 40), backward [40, 70), optimizer
# [70, 90); the window is [0, 100)
PARTS = [("sample", 0.0, 10.0), ("forward", 10.0, 40.0),
         ("backward", 40.0, 70.0), ("optimizer", 70.0, 90.0)]
RANGES = [(f"nerf_vo.map.{p}", a, b) for p, a, b in PARTS] + [
    ("nerf_vo.hash.encode", 19.0, 21.0),
    ("nerf_vo.hash.backward", 44.0, 65.0)]
# the launch of each operation, by its correlation id
LAUNCHES = {1: (2.0, "cudaLaunchKernel"), 2: (12.0, "cudaLaunchKernel"),
            3: (20.0, "cudaLaunchKernel"),
            4: (45.0, "cudaLaunchKernel"),  # autograd's thread
            5: (72.0, "cudaLaunchKernel"), 6: (95.0, "cudaMemcpyAsync"),
            7: (96.0, "cudaMemcpyAsync"), 8: (97.0, "cudaMemcpyAsync"),
            9: (145.0, "cudaLaunchKernel")}


def _window(device, ranges=RANGES, window=(0.0, 100.0)):
    return parts.Window(device, LAUNCHES, ranges, window)


def test_launch_from_another_thread_falls_in_the_part_by_time():
    w = _window([(50.0, 60.0, "mul", 4)])
    r = w.reduce()
    assert r["parts"]["backward"]["launches"] == 1
    assert r["outside"] == 0


def test_device_time_is_a_union_not_a_sum():
    # two overlapping copies and one clipped by the window's end
    w = _window([(14.0, 24.0, "cat", 2), (16.0, 20.0, "cat", 2),
                 (22.0, 30.0, "gather_interp_kernel", 3)])
    f = w.reduce()["parts"]["forward"]
    assert f["launches"] == 3
    assert math.isclose(f["device_s"], 16e-6)
    assert f["top_ops"][0] == ["cat", 14e-6]
    late = _window([(95.0, 120.0, "copy", 5)]).reduce()
    assert math.isclose(late["parts"]["optimizer"]["device_s"], 5e-6)


def test_idle_stretch_across_two_parts_is_split():
    # busy [0, 5) and [55, 100): idle [5, 55) covers sample's end, all of
    # forward and backward's start
    r = _window([(0.0, 5.0, "randint", 1), (55.0, 100.0, "mul", 4)]).reduce()
    idle = {p: v["idle_s"] for p, v in r["parts"].items()}
    assert math.isclose(idle["sample"], 5e-6)
    assert math.isclose(idle["forward"], 30e-6)
    assert math.isclose(idle["backward"], 15e-6)
    assert idle["optimizer"] == 0.0
    assert sum(idle.values()) <= 50e-6 + 1e-12


def test_unlinked_ops_are_counted_not_attributed():
    # a launch the trace lacks: none recorded, or another id
    r = _window([(21.0, 22.0, "ours", 0), (23.0, 24.0, "gone", 99),
                 (25.0, 26.0, "cat", 2)]).reduce()
    assert r["unlinked"] == 2
    assert r["unlinked_ops"] == {"ours": 1, "gone": 1}
    assert r["parts"]["forward"]["launches"] == 1
    assert r["outside"] == 2


def test_launches_and_outside_make_the_window_count():
    device = [(1.0, 3.0, "randint", 1), (12.0, 14.0, "cat", 2),
              (30.0, 35.0, "gather_interp_kernel", 3),
              (50.0, 52.0, "mul", 4), (74.0, 76.0, "adam", 5),
              (96.0, 98.0, "copy", 6),  # launched after the optimizer
              (99.0, 104.0, "copy", 7),  # ends after the window
              (104.0, 106.0, "copy", 8),  # after the window
              (40.0, 41.0, "ours", 0)]
    w = _window(device)
    r = w.reduce()
    tr = Trace([op[:3] for op in device], [], (0.0, 100.0))
    launches = [v["launches"] for v in r["parts"].values()]
    assert launches == [1, 2, 1, 1]
    assert sum(launches) + r["outside"] == tr.count() == r["count"] == 8
    assert r["outside"] == 3 and r["unlinked"] == 1
    assert math.isclose(r["window_s"], 100e-6)


def test_parts_with_several_spans_each():
    # two steps: each part's spans are unioned
    ranges = RANGES + [(n, a + 100.0, b + 100.0) for n, a, b in RANGES]
    w = _window([(50.0, 60.0, "mul", 4), (150.0, 155.0, "mul", 9)],
                ranges, (0.0, 200.0))
    r = w.reduce()
    assert r["parts"]["backward"]["launches"] == 2
    assert math.isclose(r["parts"]["backward"]["idle_s"], 45e-6)
    assert w.part_at(95.0) is None and w.part_at(110.0) == "forward"


def test_the_forward_by_its_own_parts():
    ranges = RANGES + [("nerf_vo.map.proposal", 11.0, 15.0),
                       ("nerf_vo.map.field", 15.0, 25.0),
                       ("nerf_vo.map.loss", 25.0, 30.0)]
    device = [(12.0, 14.0, "cat", 2), (30.0, 35.0, "gather", 3),
              (50.0, 52.0, "mul", 4)]
    r = parts.Window(device, LAUNCHES, ranges, (0.0, 100.0),
                     ("proposal", "field", "loss")).reduce()
    assert {p: v["launches"] for p, v in r["parts"].items()} == {
        "proposal": 1, "field": 1, "loss": 0}
    assert r["outside"] == 1  # the backward's


def test_the_hash_grids_spans_as_parts():
    device = [(12.0, 14.0, "cat", 2), (20.0, 22.0, "gather", 3),
              (50.0, 52.0, "mul", 4), (74.0, 76.0, "adam", 5)]
    r = parts.Window(device, LAUNCHES, RANGES, (0.0, 100.0),
                     ("encode", "backward"), "nerf_vo.hash.").reduce()
    assert {p: v["launches"] for p, v in r["parts"].items()} == {
        "encode": 1, "backward": 1}
    assert r["parts"]["encode"]["top_ops"] == [["gather", 2e-6]]
    assert r["outside"] == 2
