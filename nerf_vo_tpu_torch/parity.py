"""The PyTorch port's accuracy-parity harness: the counterpart of
``parity.py`` at the root of the repository, on the port's pipeline.

One command runs the full pipeline (data -> tracking -> enhancement ->
mapping -> render -> evaluate) of a config on the card, with the pretrained
checkpoints the env hooks name, and writes a report comparing every
reference-comparable metric (ATE RMSE, PSNR / MSSIM / LPIPS, depth abs-rel
/ RMSE, mesh F1) with the expected ranges of ``PARITY.md``:

    NERF_VO_DPVO_WEIGHTS=/ckpts/dpvo.pth \\
    NERF_VO_OMNIDATA_DEPTH_WEIGHTS=/ckpts/omnidata_dpt_depth_v2.ckpt \\
    NERF_VO_OMNIDATA_NORMAL_WEIGHTS=/ckpts/omnidata_dpt_normal_v2.ckpt \\
    NERF_VO_LPIPS_WEIGHTS=/ckpts/lpips_alex.pth \\
    python -m nerf_vo_tpu_torch.parity --config nerf_vo_replica --scenes room0

(``nerf_slam_*`` configs use ``NERF_VO_DROID_WEIGHTS`` instead of the DPVO
and Omnidata hooks.) A missing checkpoint aborts with exit code 2 and the
env vars to set; ``--allow-random-weights`` runs anyway as a plumbing dry
run, whose report is stamped ``DRY-RUN``. LPIPS is optional either way:
without its weights the report carries an explicit
``N/A (set NERF_VO_LPIPS_WEIGHTS)`` row.

Each scene runs :func:`nerf_vo_tpu_torch.run.run_scene` (``execute``, then
``render_and_evaluate``, with the port's per-scene overrides), after the
seed 42 and the run's directories of :func:`nerf_vo_tpu_torch.run.start_run`;
the report goes to
``<dir_prediction>/<config>_<stamp>_<experiment>/parity_report.{json,md}``.
:func:`report_rows` turns one scene's metrics into the report's rows.
Configs are read from ``configs/<name>.yaml`` in the working directory;
``yaml`` is imported only there.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import sys
from typing import Dict, List, Optional

import numpy as np

from nerf_vo_tpu_torch import run

# Expected ranges for a run WITH the real pretrained checkpoints, keyed by
# config (a ``None`` bound is not checked); PARITY.md has the table and
# its sources.
EXPECTED_RANGES: Dict[str, Dict[str, Dict[str, Optional[float]]]] = {
    "nerf_vo_replica": {
        "trajectory/keyframes_tracking/ate_rmse": {"max": 0.02},  # meters
        "2d/psnr": {"min": 26.0},
        "2d/mssim": {"min": 0.80},
        "2d/lpips": {"max": 0.35},
        "2d/depth_abs_rel": {"max": 0.08},
        "3d/mesh_f1": {"min": 0.60},
    },
    "nerf_vo_tum_rgbd": {
        "trajectory/keyframes_tracking/ate_rmse": {"max": 0.10},
        "2d/psnr": {"min": 18.0},
    },
    "nerf_vo_7_scenes": {
        "trajectory/keyframes_tracking/ate_rmse": {"max": 0.10},
        "2d/psnr": {"min": 18.0},
    },
    "nerf_vo_scannet": {
        "trajectory/keyframes_tracking/ate_rmse": {"max": 0.15},
        "2d/psnr": {"min": 18.0},
    },
    "nerf_slam_replica": {
        "trajectory/keyframes_tracking/ate_rmse": {"max": 0.05},
        "2d/psnr": {"min": 24.0},
    },
}

# The metrics every scene's report lists (an explicit N/A if absent).
REPORT_METRICS = [
    "trajectory/keyframes_tracking/ate_rmse",
    "trajectory/keyframes_mapping/ate_rmse",
    "2d/psnr",
    "2d/mssim",
    "2d/lpips",
    "2d/depth_abs_rel",
    "2d/depth_rmse",
    "3d/mesh_accuracy",
    "3d/mesh_completion",
    "3d/mesh_f1",
]


def weight_hooks_for(config: dict) -> Dict[str, dict]:
    """The checkpoint env hooks this config's pipeline reads, each with
    its ``env``, whether it is ``required``, its ``path`` and whether that
    file is ``present``."""
    hooks: Dict[str, dict] = {}
    tracking = config.get("tracking_module", "dpvo")
    if tracking == "dpvo":
        hooks["dpvo"] = {"env": "NERF_VO_DPVO_WEIGHTS", "required": True}
    else:
        hooks["droid"] = {"env": "NERF_VO_DROID_WEIGHTS", "required": True}
    enhancement = config.get("enhancement_module", "depth")
    if enhancement != "none":
        hooks["omnidata_depth"] = {
            "env": "NERF_VO_OMNIDATA_DEPTH_WEIGHTS", "required": True,
        }
        if "normal" in enhancement:
            hooks["omnidata_normal"] = {
                "env": "NERF_VO_OMNIDATA_NORMAL_WEIGHTS", "required": True,
            }
    # LPIPS is evaluation only: optional, but its absence shows as N/A
    hooks["lpips"] = {"env": "NERF_VO_LPIPS_WEIGHTS", "required": False}
    for h in hooks.values():
        path = os.environ.get(h["env"])
        h["path"] = path
        h["present"] = bool(path) and os.path.exists(path)
    return hooks


def is_dry_run(hooks: Dict[str, dict]) -> bool:
    """True when a required checkpoint is missing: random weights."""
    return any(h["required"] and not h["present"] for h in hooks.values())


def _flatten(metrics: Dict[str, Optional[dict]]) -> Dict[str, float]:
    flat = {}
    for group, vals in metrics.items():
        if not vals:
            continue
        for k, v in vals.items():
            flat[f"{group}/{k}"] = v
    return flat


def _check(value: Optional[float], bounds: Dict[str, Optional[float]]) -> str:
    if value is None or (isinstance(value, float) and np.isnan(value)):
        return "N/A"
    if bounds.get("max") is not None and value > bounds["max"]:
        return "FAIL"
    if bounds.get("min") is not None and value < bounds["min"]:
        return "FAIL"
    return "PASS"


def report_rows(config_name: str, metrics: Dict[str, Optional[dict]],
                dry_run: bool) -> List[dict]:
    """One scene's report rows (metric, value, expected, status, note), one
    for each of ``REPORT_METRICS``, from the metrics dict that
    ``render_and_evaluate`` returns. Under ``dry_run`` a checked metric is
    stamped ``DRY-RUN`` where it would PASS or FAIL."""
    ranges = EXPECTED_RANGES.get(config_name, {})
    flat = _flatten(metrics)
    rows = []
    for key in REPORT_METRICS:
        value = flat.get(key)
        if value is not None and isinstance(value, float) \
                and np.isnan(value):
            value = None
        bounds = ranges.get(key, {})
        status = _check(value, bounds) if bounds else (
            "N/A" if value is None else "INFO")
        note = ""
        if key == "2d/lpips" and value is None:
            note = "N/A (set NERF_VO_LPIPS_WEIGHTS)"
        elif value is None:
            note = "metric not produced"
        if dry_run and status in ("PASS", "FAIL"):
            status = "DRY-RUN"
        rows.append({
            "metric": key, "value": value,
            "expected": bounds or None, "status": status, "note": note,
        })
    return rows


def weight_provenance(hooks: Dict[str, dict]) -> Dict[str, dict]:
    """Where each component's weights came from, for the report."""
    return {
        name: {
            "env": h["env"],
            "path": h["path"],
            "weights": "pretrained" if h["present"] else (
                "n/a (eval metric skipped)" if not h["required"]
                else "RANDOM (dry run)"
            ),
        }
        for name, h in hooks.items()
    }


def verdict(scenes_report: Dict[str, List[dict]], dry_run: bool) -> str:
    statuses = [r["status"] for rows in scenes_report.values() for r in rows]
    if dry_run:
        return ("DRY-RUN: random weights — metrics are NOT comparable to "
                "the reference; plumbing verified only")
    if "FAIL" in statuses:
        return "FAIL"
    return "PARITY (within documented expected ranges — see PARITY.md)"


def load_config(config_name: str) -> dict:
    """``configs/<config_name>.yaml`` from the working directory."""
    import yaml

    with open(f"configs/{config_name}.yaml") as f:
        return yaml.safe_load(f)


def run_parity(config_name: str, scenes: Optional[List[str]] = None,
               allow_random_weights: bool = False,
               overrides: Optional[dict] = None,
               experiment: str = "parity", device="cuda") -> dict:
    """Run the harness on ``device``; returns (and writes) the report."""
    config = load_config(config_name)
    if overrides:
        config.update(overrides)

    hooks = weight_hooks_for(config)
    missing = [h["env"] for h in hooks.values()
               if h["required"] and not h["present"]]
    if missing and not allow_random_weights:
        sys.stderr.write(
            "parity: missing pretrained checkpoints — set these env vars to\n"
            "the reference checkpoint files and re-run:\n"
            + "".join(f"  export {env}=/path/to/checkpoint\n"
                      for env in missing)
            + "(or pass --allow-random-weights for a plumbing dry run whose\n"
            " metrics are NOT comparable to the reference).\n"
        )
        raise SystemExit(2)

    scene_names = scenes or config["scene_names"]
    dir_dataset = config["dir_dataset"]
    stamp = datetime.datetime.now().strftime("%Y_%m_%d_%H_%M_%S")
    dir_prediction, dir_result = run.start_run(
        config, f"{config_name}_{stamp}_{experiment}")

    dry_run = is_dry_run(hooks)
    scenes_report = {}
    for scene_name in scene_names:
        index = (config["scene_names"].index(scene_name)
                 if scene_name in config["scene_names"] else 0)
        metrics = run.run_scene(dict(config), scene_name, index, dir_dataset,
                                dir_prediction, dir_result, experiment,
                                device)
        scenes_report[scene_name] = report_rows(config_name, metrics,
                                                dry_run)

    report = {
        "config": config_name,
        "scenes": scenes_report,
        "weights": weight_provenance(hooks),
        "dry_run": dry_run,
        "verdict": verdict(scenes_report, dry_run),
        "dir_prediction": dir_prediction,
    }
    with open(dir_prediction + "/parity_report.json", "w") as f:
        json.dump(report, f, indent=2)
    _write_md(report, dir_prediction + "/parity_report.md")
    return report


def _write_md(report: dict, path: str) -> None:
    lines = [f"# Parity report — {report['config']}", ""]
    lines.append(f"**Verdict:** {report['verdict']}")
    lines += ["", "## Checkpoints", "",
              "| component | env hook | weights |", "|---|---|---|"]
    for name, p in report["weights"].items():
        lines.append(f"| {name} | `{p['env']}` | {p['weights']} |")
    for scene, rows in report["scenes"].items():
        lines += ["", f"## {scene}", "",
                  "| metric | value | expected | status | note |",
                  "|---|---|---|---|---|"]
        for r in rows:
            val = "—" if r["value"] is None else f"{r['value']:.4g}"
            exp = "—" if not r["expected"] else " ".join(
                f"{k}={v}" for k, v in r["expected"].items() if v is not None)
            lines.append(f"| {r['metric']} | {val} | {exp} | {r['status']} "
                         f"| {r['note']} |")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def main(argv: Optional[List[str]] = None, device="cuda") -> None:
    p = argparse.ArgumentParser(
        description="Accuracy-parity harness of the PyTorch port.")
    p.add_argument("--config", default="nerf_vo_replica")
    p.add_argument("--scenes", default=None,
                   help="comma-separated subset of the config's scene_names")
    p.add_argument("--allow-random-weights", action="store_true",
                   help="run without checkpoints (plumbing dry run)")
    p.add_argument("--experiment", default="parity")
    cli = p.parse_args(argv)
    scenes = cli.scenes.split(",") if cli.scenes else None
    report = run_parity(cli.config, scenes, cli.allow_random_weights,
                        experiment=cli.experiment, device=device)
    print(json.dumps({"verdict": report["verdict"],
                      "report": report["dir_prediction"]
                      + "/parity_report.json"}))


if __name__ == "__main__":
    main()
