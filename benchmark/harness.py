"""The benchmark's harness: finds a cell's files by name, runs its driver,
reduces what the driver recorded to the cell's metrics and prints one
result line.

Everything that belongs to one configuration, traffic mix or metric is a
file of its own, found by the name ``BENCHMARK.json`` gives it:

- ``benchmark/configs/<config>.json``: the configuration as it is run;
- ``benchmark/workloads/<cell>.json``: the driver kind, the configuration,
  the traffic's parameters, the limits of the correctness check and why;
- ``benchmark/drivers/<kind>.py``: ``setup(ctx)`` (the program built and
  warmed, and the readings the check needs, ``.readings``),
  ``window(ctx, state, seconds)`` and ``trace(ctx, state, seconds)`` (the
  record the readers read), ``check(ctx, readings)`` (each number the
  workload's ``limits`` name); see ``drivers/map.py``;
- ``benchmark/metrics/<metric>.py``: ``read(record)``, the metric's value
  or None where the record holds nothing to read.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import sys
import time
import types
from pathlib import Path
from typing import Dict, List

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "nerf_vo_tpu")


def parse(argv: List[str]) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="benchmark/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def read_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path) -> types.ModuleType:
    """A benchmark file by path (its name may hold dots)."""
    name = "bench_" + path.stem.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One entry of ``workloads`` in ``root``'s ``BENCHMARK.json``, with
    its files."""

    def __init__(self, name: str, root: Path = ROOT):
        self.root = root
        self.spec = read_json(root / "BENCHMARK.json")
        entries = {w["name"]: w for w in self.spec["workloads"]}
        if name not in entries:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.name = name
        self.entry = entries[name]
        self.chips = int(self.entry["chips"])
        base = root / "benchmark"
        self.workload = read_json(base / "workloads" / f"{name}.json")
        self.config = read_json(base / "configs"
                                / f"{self.entry['config']}.json")
        self.driver = load_module(base / "drivers"
                                  / f"{self.workload['driver']}.py")

    def metrics(self, trace: bool) -> List[Dict]:
        """The metrics this cell reports: with ``trace`` the per-layer ones,
        else the end-to-end ones; each where its ``workloads`` name the cell
        or where it names none."""
        group = self.spec["per_layer" if trace else "end_to_end"]
        return [m for m in group
                if self.name in m.get("workloads", [self.name])]

    def reader(self, metric: str) -> types.ModuleType:
        return load_module(self.root / "benchmark" / "metrics"
                           / f"{metric}.py")


def forbidden_modules() -> List[str]:
    """Modules loaded in this process whose top-level name, compared whole,
    is one the benchmark may not load."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def context(cell: Cell, seed: int, device, err=None) -> types.SimpleNamespace:
    """What a driver is handed: the seed, the device, the cell and its
    configuration, traffic and limits."""
    import torch

    return types.SimpleNamespace(
        seed=seed, device=torch.device(device), cell=cell, cfg=cell.config,
        traffic=cell.workload["traffic"], limits=cell.workload["limits"],
        root=cell.root, err=err or sys.stderr)


def free_device_memory() -> None:
    import torch

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def run(argv: List[str], *, t0: float, device: str = "cuda:0",
        check_chip: bool = True, root: Path = ROOT, out=None, err=None,
        configure=None) -> int:
    """One run of one cell; prints the result line and returns the exit
    code. ``check_chip`` False skips the look for a card, so that a test
    can drive the rest of a run on the CPU; ``configure(cell)`` may then
    shrink the cell's configuration and traffic in place."""
    import torch

    out = out or sys.stdout
    err = err or sys.stderr
    a = parse(argv)
    cell = Cell(a.workload, root)
    if check_chip and (not torch.cuda.is_available()
                       or torch.cuda.device_count() < cell.chips):
        print(f"benchmark: the cell needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=err)
        return 2
    if configure is not None:
        configure(cell)
    ctx = context(cell, a.seed, device, err)
    if ctx.device.type == "cuda":
        torch.cuda.set_device(ctx.device)
        torch.cuda.reset_peak_memory_stats()

    state = cell.driver.setup(ctx)
    record: Dict = {"setup_s": time.perf_counter() - t0}
    if a.trace:
        record.update(cell.driver.trace(ctx, state, a.seconds))
    else:
        record.update(cell.driver.window(ctx, state, a.seconds))
    peak = (torch.cuda.max_memory_allocated(ctx.device)
            if ctx.device.type == "cuda" else 0)
    readings = state.readings
    del state
    free_device_memory()
    numbers = cell.driver.check(ctx, readings)

    limits = ctx.limits
    # each number compared has its limit in the workload's file; a NaN
    # fails, since it is not below its limit
    ok = all(numbers[k] <= limits[k] for k in limits)
    metrics = {}
    for m in cell.metrics(bool(a.trace)):
        value = cell.reader(m["name"]).read(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    if ctx.device.type == "cuda":
        dev = dict(platform="gpu", kind=torch.cuda.get_device_name(ctx.device),
                   count=cell.chips, memory_peak_bytes=int(peak))
    else:
        dev = dict(platform="cpu", kind="cpu", count=0, memory_peak_bytes=0)
    if a.trace and "busy_s" in record:
        dev.update(busy_s=record["busy_s"], window_s=record["trace_window_s"])
    found = forbidden_modules()
    if found:
        print("benchmark: these modules are loaded and may not be: "
              + ", ".join(found), file=err)
        return 3
    result = {"correct": ok, "attempted": record.get("attempted", 0),
              "failed": record.get("failed", 0), "metrics": metrics,
              "device": dev}
    if a.trace and "breakdown" in record:
        result["breakdown"] = record["breakdown"]
    result["checks"] = {k: {"value": numbers[k], "limit": limits[k]}
                        for k in limits}
    out.write(json.dumps(result) + "\n")
    out.flush()
    for k in limits:
        print(f"{k} {numbers[k]!r} limit {limits[k]!r}", file=err)
    err.flush()
    return 0
