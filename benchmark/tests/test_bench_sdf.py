"""The ``sdf.map`` cell (Neuralangelo's SDF mapper, ``drivers/sdf_map.py``):
its configuration and files found by name, its two new metrics read from
made-up records, its operation count by hand, and at a tiny size on the
CPU the reference against the program, the control, whole runs and each
fault."""

import io
import json
import time
import types

import pytest

from benchmark import calibrate_sdf, harness
from benchmark.reference import mapper, sdf_mapper
from benchmark.tests import tiny
from benchmark.yardstick import compare, sdf_flops

CELL = "sdf.map"
NEW = ("sdf_upsample_ms_per_step", "sdf_map_step_mfu")
APPENDED = ("rays_per_s", "idle_pct.map", "launches_per_step",
            "gather_interp_roofline", "scatter_cols_outer_roofline",
            "eager_step_pct")


def configure(cell):
    """``tiny.configure``, a 2-level grid at log2 10 and 8 stratified
    samples with 2 up-sampling rounds of 4 (the MLPs at their widths)."""
    tiny.configure(cell)
    over = cell.config["mapping_model_overrides"]
    cell.config["mapping_model_overrides"] = dict(
        over, num_grid_levels=2, log2_hashmap_size=10, max_res=64,
        sdf=dict(num_samples=8, num_importance=4, upsample_rounds=2))


def _ctx(seed):
    cell = harness.Cell(CELL)
    configure(cell)
    return cell, harness.context(cell, seed, "cpu")


def test_files_found_by_name():
    c = harness.Cell(CELL)
    assert c.workload["driver"] == "sdf_map"
    assert c.entry["config"] == "neuralangelo_replica" and c.chips == 1
    assert c.config["mapping_module"] == "neuralangelo"
    assert c.config["mapping_model_overrides"] == sdf_mapper.PUBLISHED
    assert [m["name"] for m in c.metrics(False)] == ["rays_per_s", "setup_s"]
    traced = [m["name"] for m in c.metrics(True)]
    assert set(traced) == set(NEW) | set(APPENDED) - {"rays_per_s"}
    assert set(c.workload["limits"]) == set(c.driver.NUMBERS)
    for m in NEW:
        assert callable(c.reader(m).read)
    t = c.workload["traffic"]
    mc = sdf_mapper.model_config(c.config)
    assert mc.schedule(t["start_step"])[0] == 16
    assert t["start_step"] < t["warm_to_step"] < c.config[
        "mapping_iterations"]


def test_configuration_keeps_the_published_widths():
    """Nothing of a width is cut: the 16 x 8 grid at log2 22 from 32 to
    2048, the 131 -> 256 -> 257 SDF MLP, the 271 -> 4 x 256 -> 3 colour
    MLP, 64 + 4 x 16 samples; ``reduced`` names the iterations and the
    rays a step only."""
    cfg = harness.Cell(CELL).config
    mc = sdf_mapper.model_config(cfg)
    assert cfg["reduced"] == ["mapping_iterations", "rays_per_batch"]
    assert sdf_mapper._mlp_dims(mc) == {
        "sdf_mlp": [131, 256, 257], "color_mlp": [271] + [256] * 4 + [3]}
    assert (mc.num_samples, mc.num_importance, mc.upsample_rounds) == (
        64, 16, 4)
    grid = mc.field_grid
    assert grid.resolutions[0] == 32 and grid.resolutions[-1] == 2047
    # the 2 GiB table fits one card whole
    assert grid.n_levels * grid.bricks_per_level * 32 * 8 * 4 == 2**31
    spec = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    entry = [c for c in spec["configs"]
             if c["name"] == "neuralangelo_replica"][0]
    assert entry["reduced"] == cfg["reduced"]
    assert len(entry["source"]) <= 200 and len(cfg["source"]) <= 200


def _model():
    return sdf_mapper.model_config(harness.Cell(CELL).config)


@pytest.mark.parametrize("metric, record, want", [
    ("sdf_upsample_ms_per_step",
     {"trace_steps": 8, "sdf": {"parts": {
         "sdf_upsample": {"launches": 400, "device_s": 4e-3},
         "taps": {"launches": 90, "device_s": 9e-3}}}}, 0.5),
    ("sdf_upsample_ms_per_step",  # a program without the span
     {"trace_steps": 8, "sdf": {"parts": {
         "sdf_upsample": {"launches": 0, "device_s": 0.0},
         "taps": {"launches": 0, "device_s": 0.0}}}}, None),
    ("sdf_upsample_ms_per_step", {"trace_steps": 8}, None),
    ("sdf_map_step_mfu", "sdf", None),  # filled in below
    ("sdf_map_step_mfu", "nerfacto", None),
], ids=["upsample", "upsample_no_span", "upsample_no_record", "mfu",
        "mfu_nerfacto"])
def test_new_metrics_read_a_made_up_record(metric, record, want):
    if isinstance(record, str):
        model = _model() if record == "sdf" else mapper.ModelConfig(192)
        record = {"kind": "map", "step_s": 5.0e-2, "rays_per_batch": 4096,
                  "model": model,
                  "trace": types.SimpleNamespace(device=[(0, 1, "k")])}
        if model is not None and hasattr(model, "upsample_rounds"):
            ops = sdf_flops.map_step(model, 4096)
            want = 100 * (ops["float32"] / 67e12
                          + ops["bfloat16"] / 989e12) / 5.0e-2
    got = harness.Cell(CELL).reader(metric).read(record)
    if want is None:
        assert got is None
    else:
        assert got == pytest.approx(want, rel=1e-9)


def test_sdf_step_operations_by_hand():
    """4096 rays: the SDF MLP 131 -> 256 -> 257 and 16 x 8 interpolations
    at 112 points a ray without gradient and 640 a ray forward and
    backward; the colour MLP 271 -> 256 x 4 -> 3 at 128 a ray, forward and
    backward."""
    ops = sdf_flops.map_step(_model(), 4096)
    sdf = 2 * (131 * 256 + 256 * 257)
    col = 2 * (271 * 256 + 3 * 256 * 256 + 256 * 3)
    interp = 2 * 8 * 8 * 16
    assert ops["float32"] == 4096 * 112 * (sdf + interp) \
        + 3 * 4096 * 640 * (sdf + interp)
    assert ops["bfloat16"] == 3 * 4096 * 128 * col
    assert 1.5e12 < ops["float32"] < 1.8e12


def test_reference_follows_the_program():
    cell, ctx = _ctx(2**31 + 71)
    _, prog, _ = cell.driver.build(ctx)
    numbers = cell.driver.check(ctx, prog)
    assert set(numbers) == set(cell.driver.NUMBERS)
    for k, v in numbers.items():
        assert v < 1e-3, (k, v)
    assert prog["normals"].shape == (64, 16, 3)


def test_control_fails():
    cell, ctx = _ctx(2**31 + 72)
    ref = cell.driver.reference_readings(ctx)
    low = cell.driver.reference_readings(ctx, low=True)
    numbers = cell.driver.gaps(low, ref)
    limits = cell.workload["limits"]
    assert any(numbers[k] > limits[k] for k in limits), numbers


def _run(trace=0):
    out, err = io.StringIO(), io.StringIO()
    rc = harness.run(["--workload", CELL, "--seed", str(2**31 + 73),
                      "--seconds", "0.5", "--trace", str(trace)],
                     t0=time.perf_counter(), device="cpu", check_chip=False,
                     out=out, err=err, configure=configure)
    assert rc == 0, err.getvalue()
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("trace", [0, 1])
def test_sound_run_is_correct(trace):
    res = _run(trace)
    assert res["correct"] is True
    assert set(res["checks"]) == set(compare.NUMBERS) | {"normal_gap"}
    if trace:  # on the CPU every step is eager and no device op is traced
        assert res["metrics"] == {"eager_step_pct": {"value": 100.0,
                                                     "unit": "%"}}
    else:
        assert set(res["metrics"]) == {"rays_per_s", "setup_s"}


@pytest.mark.parametrize("fault", sorted(calibrate_sdf.FAULTS))
def test_fault_is_caught(fault):
    """``faults.py``'s and the SDF mapper's (``calibrate_sdf.py``)."""
    with calibrate_sdf.FAULTS[fault]():
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
    calibrate_sdf.main(["--workload", CELL, "--seeds", "5", "--control",
                        "1", "--fault", "eps_coarse", "1"], out)
    rows = [json.loads(x) for x in out.getvalue().splitlines()]
    assert [r["kind"] for r in rows] == ["program", "control", "eps_coarse",
                                         "summary"]
    assert rows[0]["normal_gap"] < 1e-3
    assert rows[1]["normal_gap"] > 0.01
    assert "normal_gap.lower" in rows[-1]
