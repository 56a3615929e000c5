"""The ``slam.map`` cell (the Instant-NGP mapper, ``drivers/ngp_map.py``):
its files found by name, its new metrics read from made-up records, its
operation count by hand, and at a tiny size on the CPU the reference
against the program, the control, whole runs and each fault."""

import io
import json
import time
import types

import pytest

from benchmark import calibrate_cell, harness
from benchmark.reference import ngp_mapper
from benchmark.tests import tiny
from benchmark.yardstick import compare, ngp_flops

CELL = "slam.map"
NEW = ("occupancy_ms_per_step", "eager_step_pct", "ngp_map_step_mfu")
APPENDED = ("rays_per_s", "idle_pct.map", "launches_per_step",
            "gather_interp_roofline", "scatter_cols_outer_roofline")


def configure(cell):
    """``tiny.configure`` and a 16^3 occupancy grid refreshed every 2
    steps, so that the compared steps refresh it twice."""
    from nerf_vo_tpu_torch.ops.occupancy import OccupancyConfig

    tiny.configure(cell)
    over = cell.config["mapping_model_overrides"]
    cell.config["mapping_model_overrides"] = dict(
        over, occupancy=OccupancyConfig(resolution=16, update_every=2))


def _ctx(seed):
    cell = harness.Cell(CELL)
    configure(cell)
    return cell, harness.context(cell, seed, "cpu")


def test_files_found_by_name():
    c = harness.Cell(CELL)
    assert c.workload["driver"] == "ngp_map"
    assert c.entry["config"] == "nerf_slam_replica" and c.chips == 1
    assert c.config["mapping_model_overrides"] == ngp_mapper.PUBLISHED
    assert [m["name"] for m in c.metrics(False)] == ["rays_per_s", "setup_s"]
    traced = [m["name"] for m in c.metrics(True)]
    assert set(traced) == set(NEW) | set(APPENDED) - {"rays_per_s"}
    assert set(c.workload["limits"]) == set(c.driver.NUMBERS)
    for m in NEW:
        assert callable(c.reader(m).read)
    assert "map_step_mfu" not in traced  # its count is nerfacto's


def _model():
    return ngp_mapper.model_config(harness.Cell(CELL).config)


@pytest.mark.parametrize("metric, record, want", [
    ("occupancy_ms_per_step",
     {"trace_steps": 10, "occupancy": {"parts": {
         "occupancy": {"launches": 40, "device_s": 2e-3},
         "occ_refresh": {"launches": 9, "device_s": 1e-3}}}}, 0.3),
    ("occupancy_ms_per_step",  # a program without the spans
     {"trace_steps": 10, "occupancy": {"parts": {
         "occupancy": {"launches": 0, "device_s": 0.0},
         "occ_refresh": {"launches": 0, "device_s": 0.0}}}}, None),
    ("occupancy_ms_per_step", {"trace_steps": 10}, None),
    ("eager_step_pct", {"eager_steps": 3, "window_steps": 60}, 5.0),
    ("eager_step_pct", {"eager_steps": 0, "window_steps": 60}, 0.0),
    ("eager_step_pct", {"eager_steps": None, "window_steps": 60}, None),
    ("ngp_map_step_mfu", "ngp", 100 * 2.4354087e-5 / 8.6e-3),
    ("ngp_map_step_mfu", "nerfacto", None),
], ids=["occupancy", "occupancy_no_spans", "occupancy_no_record", "eager",
        "eager_none", "eager_no_counter", "mfu", "mfu_nerfacto"])
def test_new_metrics_read_a_made_up_record(metric, record, want):
    if isinstance(record, str):
        from benchmark.reference import mapper
        model = _model() if record == "ngp" else mapper.ModelConfig(192)
        record = {"kind": "map", "step_s": 8.6e-3, "rays_per_batch": 4096,
                  "model": model,
                  "trace": types.SimpleNamespace(device=[(0, 1, "k")])}
    got = harness.Cell(CELL).reader(metric).read(record)
    if want is None:
        assert got is None
    else:
        assert got == pytest.approx(want, rel=1e-6)


def test_ngp_step_operations_by_hand():
    """4096 rays x 64 samples; density MLP 32 -> 64 -> 16, colour MLP
    63 -> 64 -> 64 -> 3; 16 levels x 2 features; the 262,144-cell slab's
    forward spread over 16 steps."""
    ops = ngp_flops.map_step(_model(), 4096)
    points, slab = 4096 * 64, 128**3 // 8 / 16
    dens = 2 * (32 * 64 + 64 * 16)
    col = 2 * (63 * 64 + 64 * 64 + 64 * 3)
    interp = 2 * 8 * 2 * 16
    assert ops["bfloat16"] == 3 * points * (dens + col) + slab * dens
    assert ops["float32"] == 3 * points * interp + slab * interp


def test_reference_follows_the_program():
    cell, ctx = _ctx(2**31 + 41)
    _, prog, _ = cell.driver.build(ctx)
    ref = cell.driver.reference_readings(ctx)
    numbers = cell.driver.check(ctx, prog)
    assert set(numbers) == set(cell.driver.NUMBERS)
    for k, v in numbers.items():
        assert v < 1e-4, (k, v)
    assert ref["grid"].shape == prog["grid"].shape == (16**3,)


def test_control_fails():
    cell, ctx = _ctx(2**31 + 42)
    ref = cell.driver.reference_readings(ctx)
    low = cell.driver.reference_readings(ctx, low=True)
    numbers = cell.driver.gaps(low, ref)
    limits = cell.workload["limits"]
    assert any(numbers[k] > limits[k] for k in limits), numbers


def _run(trace=0):
    out, err = io.StringIO(), io.StringIO()
    rc = harness.run(["--workload", CELL, "--seed", str(2**31 + 43),
                      "--seconds", "0.5", "--trace", str(trace)],
                     t0=time.perf_counter(), device="cpu", check_chip=False,
                     out=out, err=err, configure=configure)
    assert rc == 0, err.getvalue()
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("trace", [0, 1])
def test_sound_run_is_correct(trace):
    res = _run(trace)
    assert res["correct"] is True
    assert set(res["checks"]) == set(compare.NUMBERS) | {"occ_gap"}
    if trace:  # on the CPU every step is eager and no device op is traced
        assert res["metrics"] == {"eager_step_pct": {"value": 100.0,
                                                     "unit": "%"}}
    else:
        assert set(res["metrics"]) == {"rays_per_s", "setup_s"}


@pytest.mark.parametrize("fault", sorted(calibrate_cell.FAULTS))
def test_fault_is_caught(fault):
    """``faults.py``'s and the occupancy grid's (``calibrate_cell.py``)."""
    with calibrate_cell.FAULTS[fault]():
        res = _run()
    assert res["correct"] is False, res["checks"]


def test_calibration_reads_every_number(monkeypatch):
    cell_type, context = harness.Cell, harness.context

    class Tiny(cell_type):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            configure(self)

    monkeypatch.setattr(harness, "Cell", Tiny)
    monkeypatch.setattr(harness, "context", lambda cell, seed, device:
                        context(cell, seed, "cpu"))
    out = io.StringIO()
    calibrate_cell.main(["--workload", CELL, "--seeds", "5", "--fault",
                         "unchanged", "1"], out)
    rows = [json.loads(x) for x in out.getvalue().splitlines()]
    assert [r["kind"] for r in rows] == ["program", "unchanged", "summary"]
    assert rows[0]["occ_gap"] == 0.0 and rows[1]["occ_gap"] > 0.05
    assert rows[-1]["occ_gap.lower"] == 0.0
