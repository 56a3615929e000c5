"""``benchmark/reference/`` at a tiny size against the port's plain CPU
path (the same inputs, weights and draws to both), the control (the
reference in bfloat16) against the reference, and a whole run on the CPU
with each fault a training cell can have planted under the timed path,
which must come out not correct."""

import io
import json
import time

import pytest

from benchmark import faults, harness
from benchmark.tests import tiny

CELLS = ["vo.map"]


def _ctx(cell_name, seed):
    cell = harness.Cell(cell_name)
    tiny.configure(cell)
    return cell, harness.context(cell, seed, "cpu")


@pytest.mark.parametrize("name", CELLS)
def test_reference_follows_the_program(name):
    cell, ctx = _ctx(name, 2**31 + 11)
    _, prog, _ = cell.driver.build(ctx)
    ref = cell.driver.reference_readings(ctx)
    assert len(prog["losses"]) == len(ref["losses"]) == 3
    assert set(prog["grad"]) == set(ref["grad"])
    assert set(prog["change"]) == set(ref["change"])
    numbers = cell.driver.check(ctx, prog)
    for k, v in numbers.items():
        assert v < 1e-4, (k, v)


@pytest.mark.parametrize("name", CELLS)
def test_control_fails(name):
    cell, ctx = _ctx(name, 2**31 + 12)
    ref = cell.driver.reference_readings(ctx)
    low = cell.driver.reference_readings(ctx, low=True)
    from benchmark.yardstick import compare
    numbers = compare.gaps(low, ref)
    limits = cell.workload["limits"]
    assert any(numbers[k] > limits[k] for k in limits), numbers


def _run(name, trace=0):
    out, err = io.StringIO(), io.StringIO()
    rc = harness.run(["--workload", name, "--seed", str(2**31 + 13),
                      "--seconds", "0.5", "--trace", str(trace)],
                     t0=time.perf_counter(), device="cpu", check_chip=False,
                     out=out, err=err, configure=tiny.configure)
    assert rc == 0, err.getvalue()
    lines = err.getvalue().strip().splitlines()
    return json.loads(out.getvalue().strip().splitlines()[-1]), lines


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    res, lines = _run(name)
    assert res["correct"] is True
    assert set(res["metrics"]) == {"rays_per_s", "setup_s"}
    assert list(res)[-1] == "checks"
    assert set(res["checks"]) == set(harness.Cell(name).workload["limits"])
    assert all(" limit " in line for line in lines[-3:])


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_fault_is_caught(name, fault):
    with faults.FAULTS[fault]():
        res, _ = _run(name)
    assert res["correct"] is False, res["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", [w["name"] for w in harness.Cell(
    "vo.map").spec["workloads"]])
def test_cell_on_the_card(card, name):
    """A short run of the cell as the benchmark makes it, on the card."""
    import subprocess
    import sys

    out = subprocess.run(
        [sys.executable, str(harness.ROOT / "benchmark/run.py"),
         "--workload", name, "--seed", "77", "--seconds", "2", "--trace",
         "0"], capture_output=True, text=True, timeout=600,
        cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True and res["device"]["platform"] == "gpu"
