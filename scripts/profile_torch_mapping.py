"""Where the port's mapping step spends its time, part by part, in a
mapping cell of the benchmark on one NVIDIA GPU.

    python3 scripts/profile_torch_mapping.py [--config nerf_vo_replica] [--seed 7] [--steps 16] [--seconds 20] [--out FILE]

``--config`` names the configuration whose mapping cell is profiled:
``nerf_vo_replica`` (``vo.map``: nerfacto), ``nerf_slam_replica``
(``slam.map``: the Instant-NGP mapper) or ``neuralangelo_replica``
(``sdf.map``: Neuralangelo's SDF mapper). Builds the cell as
``benchmark/run.py --workload <cell>`` does (its driver's ``setup``: the
room's 192 keyframes, the mapper at its published widths, weights from the
seed, the compared steps and the warm-up), times
``--seconds`` of untraced steps, then profiles ``--steps`` steps inside one
range, ``bench.window`` (``torch.profiler``; no other range is added), twice:
the steps as the window runs them (``train_step``, replayed as CUDA graphs
where the trainer can), then steps driven through ``gradients`` +
``update``, which are eager. Each window is reduced as the benchmark's
readers reduce it (``yardstick/trace.py``: launches a step, the idle share)
and by the program's own spans (``yardstick/parts.py``): each device
operation goes to the span in which its launch began. The replayed window
by the parts of the step with ``replay`` beside them (the graphs' work;
the table-kernel calls stay in their parts); the eager window three times
over: the parts of the step (sample, forward, backward, optimizer), the
forward's parts (the occupancy sampler's bins and resampling, the
proposal passes or the SDF sampler's up-sampling and taps, the final
field, compositing and the loss terms), and the
hash grid's encodes and backwards (``hash.encode``, ``hash.backward``),
each with its device time (a union) and the window's idle time inside it.
Both windows are also reduced by the occupancy sampler's spans
(``map.occupancy``, ``map.occ_refresh``; empty for nerfacto). The eager
window's ``hash.encode`` (launches and device ms a step) is printed apart,
beside ``gather_cuda.hash_descriptors.launches``, the descriptor kernel's
launches in each window, and ``rendering_cuda.interlevel_loss.launches``,
the interlevel-loss kernels' (a replayed step runs both inside its graphs,
so counts them only where it captures). The ``CatArrayBatchedCopy`` copies' device time is
given by span in each of the three. What the program's spans cost a
profiled step is their count a step times the time of one empty span
under the profiler (the mean of 20,000). Prints one JSON line (and writes
it to ``--out`` when given) with the card, its power limit, the trainer's
``captures`` / ``replays`` / ``eager_steps`` / ``occ_refreshes`` /
``sdf_points`` (each read where the trainer has it), and per
window and span:
launches a step, device ms a step, idle share of the window, its top
operations; the operations in no part and those whose launch the trace
lacks, by name.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from benchmark import harness  # noqa: E402
from benchmark.yardstick import parts  # noqa: E402
from benchmark.yardstick.trace import Trace, busy  # noqa: E402
from nerf_vo_tpu_torch.ops import gather_cuda as gc  # noqa: E402
from nerf_vo_tpu_torch.ops import rendering_cuda  # noqa: E402
from nerf_vo_tpu_torch.runtime import perf  # noqa: E402

WINDOW = "bench.window"
REPLAYED = parts.PARTS + ("replay",)
FORWARD = ("occupancy", "proposal", "sdf_upsample", "taps", "field",
           "loss")
OCCUPANCY = ("occupancy", "occ_refresh")
HASH = ("encode", "backward")
CAT = "CatArrayBatchedCopy"


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else ""


def _per_part(r, n, win):
    return {p: {"launches_per_step": v["launches"] / n,
                "device_ms_per_step": 1e3 * v["device_s"] / n,
                "idle_pct": 100.0 * v["idle_s"] / win,
                "top_ops_ms_per_step": [[k, 1e3 * s / n]
                                        for k, s in v["top_ops"]]}
            for p, v in r["parts"].items()}


def _ms_of(w, key: str, n: int):
    """Device ms a step of the window's operations named with ``key``, by
    the span of ``w`` their launch began in ("outside": none)."""
    lo, hi = w.window
    by = {}
    for op in w.in_window():
        if key in op[2]:
            h = w.launch(op)
            part = (w.part_at(h[0]) if h else None) or "outside"
            by.setdefault(part, []).append(op[:2])
    return {p: 1e3 * busy(v, lo, hi) * 1e-6 / n for p, v in by.items()}


def _profile(step, n: int):
    """``n`` calls of ``step()`` inside ``bench.window``, profiled: the
    benchmark's trace of them and their ``parts.Window``."""
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            for _ in range(n):
                step()
            torch.cuda.synchronize()
    return Trace.from_profiler(prof, WINDOW), parts.Window.from_profiler(
        prof, WINDOW, REPLAYED)


def _cell(config: str) -> str:
    """The benchmark's mapping cell of ``config``."""
    spec = json.loads(open(os.path.join(ROOT, "BENCHMARK.json")).read())
    cells = [w["name"] for w in spec["workloads"]
             if w["config"] == config and w["traffic"] == "map"]
    if not cells:
        raise SystemExit(f"no mapping cell of {config!r} in BENCHMARK.json")
    return cells[0]


def _window(tr, w, n):
    """The step-level numbers of one profiled window."""
    win = tr.window_s()
    r = w.reduce()
    by_part = _per_part(r, n, win)
    occ = parts.Window(w.device, w.launches, w.ranges, w.window, OCCUPANCY)
    return r, {
        "traced_step_ms": 1e3 * win / n,
        "launches_per_step": tr.count() / n,
        "device_ms_per_step": 1e3 * tr.busy_s() / n,
        "idle_pct.map": 100.0 * (1.0 - tr.busy_s() / win),
        "parts": by_part,
        "outside_per_step": r["outside"] / n,
        "unlinked": r["unlinked"], "unlinked_ops": r["unlinked_ops"],
        "sum_launches_per_step": sum(v["launches_per_step"]
                                     for v in by_part.values()),
        "sum_idle_pct": sum(v["idle_pct"] for v in by_part.values()),
        "spans_per_step": len(w.ranges) / n,
        "occupancy_parts": _per_part(occ.reduce(), n, win),
    }


def _span_s(n: int = 20000) -> float:
    """Seconds of one empty span under the profiler."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        t0 = time.perf_counter()
        for _ in range(n):
            with perf.span("cost"):
                pass
        dt = time.perf_counter() - t0
    return dt / n


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="nerf_vo_replica",
                    help="nerf_vo_replica (vo.map), nerf_slam_replica "
                    "(slam.map) or neuralangelo_replica (sdf.map)")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--out", help="also write the line to this file")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")

    cell = harness.Cell(_cell(a.config))
    ctx = harness.context(cell, a.seed, "cuda:0")
    drv = cell.driver
    state = drv.setup(ctx)
    stage = state.stage
    trainer = stage.trainer
    untraced = drv.window(ctx, state, a.seconds)
    n = a.steps
    # kernels captured inside the step's graphs: counted at eager steps
    # and captures only
    captured = {"hash_descriptors": gc.hash_descriptors,
                "interlevel_loss": rendering_cuda.interlevel_loss}
    counted = {k: {"setup_and_untraced": fn.launches}
               for k, fn in captured.items()}
    _, replayed = _window(*_profile(stage.train_step, n), n)
    for k, fn in captured.items():
        counted[k]["replayed"] = (fn.launches
                                  - counted[k]["setup_and_untraced"])
    counters = {k: getattr(trainer, k, None) for k in (
        "captures", "replays", "eager_steps", "occ_refreshes",
        "sdf_points")}

    def eager():
        d = trainer.draws(stage.buffer, stage.state)
        trainer.gradients(stage.state, stage.buffer, d)
        trainer.update(stage.state, d)

    before = {k: fn.launches for k, fn in captured.items()}
    tr, w = _profile(eager, n)
    for k, fn in captured.items():
        counted[k]["eager"] = fn.launches - before[k]
    r, line_eager = _window(tr, w, n)
    del line_eager["parts"]["replay"]
    fw = parts.Window(w.device, w.launches, w.ranges, w.window, FORWARD)
    hw = parts.Window(w.device, w.launches, w.ranges, w.window, HASH,
                      parts.PREFIX + "hash.")
    fwd, hsh = fw.reduce(), hw.reduce()
    win = tr.window_s()
    span_s = _span_s()
    hash_parts = _per_part(hsh, n, win)
    line_eager.update({
        "forward_parts": _per_part(fwd, n, win),
        # the forward's launches in none of its parts (the first bins)
        "forward_rest_per_step": (r["parts"]["forward"]["launches"]
                                  - sum(v["launches"] for v in
                                        fwd["parts"].values())) / n,
        "hash_parts": hash_parts,
        "hash_encode": {k: hash_parts.get("encode", {}).get(k)
                        for k in ("launches_per_step",
                                  "device_ms_per_step")},
        "cat_ms_per_step": {"step": _ms_of(w, CAT, n),
                            "forward": _ms_of(fw, CAT, n),
                            "hash": _ms_of(hw, CAT, n)},
    })
    line = {
        "card": _card(), "cell": cell.name, "seed": a.seed, "steps": n,
        "untraced_step_ms": 1e3 * untraced["window_s"]
        / max(untraced["steps"], 1),
        "counters": counters,
        **{f"{k}_launches": v for k, v in counted.items()},
        "graphs": (trainer.graphs.counts() if trainer.graphs else None),
        "replayed": replayed, "eager": line_eager,
        "span_us": 1e6 * span_s,
        "span_cost_ms_per_step": {
            k: 1e3 * v["spans_per_step"] * span_s
            for k, v in (("replayed", replayed), ("eager", line_eager))},
    }
    if a.out:
        with open(a.out, "w") as f:
            json.dump(line, f, indent=1)
    print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
