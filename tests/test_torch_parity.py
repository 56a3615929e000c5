"""The port's accuracy-parity harness (``nerf_vo_tpu_torch/parity.py``)
against the JAX package's (``parity.py`` at the root).

Its tables and hook inventory equal the JAX harness's for every shipped
config; on the same metrics (each harness's pipeline replaced by one that
returns them) both write the same rows, verdict, checkpoint provenance,
per-scene ``args`` and Markdown report; a missing checkpoint aborts both
alike; and one dry run of the port on the CPU, on the synthetic 10-frame
48x64 scene of ``tests/test_torch_pipeline.py``, writes the report and the
artifact tree that ``tests/test_parity.py``'s dry run checks.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import parity as jparity  # noqa: E402
import run as jrun  # noqa: E402
from nerf_vo_tpu_torch import parity as tparity  # noqa: E402
from test_e2e import INTR  # noqa: E402
from test_torch_pipeline import CFG, _write_scene  # noqa: E402

HOOKS = ("NERF_VO_DPVO_WEIGHTS", "NERF_VO_DROID_WEIGHTS",
         "NERF_VO_OMNIDATA_DEPTH_WEIGHTS", "NERF_VO_OMNIDATA_NORMAL_WEIGHTS",
         "NERF_VO_LPIPS_WEIGHTS")
CONFIGS = sorted(p.stem for p in (REPO / "configs").glob("*.yaml"))
NAN = float("nan")
# what render_and_evaluate returns: values inside and outside the
# expected ranges, a NaN, a missing LPIPS, a group with no metrics
METRICS = {
    "room0": {
        "trajectory": {"keyframes_tracking/ate_rmse": 0.012,
                       "keyframes_mapping/ate_rmse": 0.5},
        "2d": {"psnr": 21.5, "mssim": 0.91, "lpips": None,
               "depth_abs_rel": NAN, "depth_rmse": 0.1},
        "3d": {"mesh_accuracy": 0.03, "mesh_completion": 0.04,
               "mesh_f1": 0.72},
    },
    "room1": {
        "trajectory": {"keyframes_tracking/ate_rmse": 0.3},
        "2d": {"psnr": 30.0, "mssim": 0.7, "lpips": 0.2,
               "depth_abs_rel": 0.05, "depth_rmse": 0.2},
        "3d": None,
    },
}


def _clear(mp):
    for env in HOOKS:
        mp.delenv(env, raising=False)


@pytest.mark.parametrize("state", ["unset", "present", "missing"])
def test_tables_and_hooks_equal_jax(tmp_path, state):
    assert tparity.EXPECTED_RANGES == jparity.EXPECTED_RANGES
    assert tparity.REPORT_METRICS == jparity.REPORT_METRICS
    import yaml

    ck = tmp_path / "ckpt"
    ck.write_bytes(b"x")
    with pytest.MonkeyPatch.context() as mp:
        _clear(mp)
        if state != "unset":
            for env in HOOKS:
                mp.setenv(env, str(ck if state == "present"
                                   else tmp_path / "missing"))
        for name in CONFIGS:
            config = yaml.safe_load((REPO / "configs" / f"{name}.yaml")
                                    .read_text())
            got = tparity.weight_hooks_for(config)
            assert got == jparity.weight_hooks_for(config), name
            assert tparity.is_dry_run(got) == (state != "present")


def test_abort_matches_jax(capsys):
    """Without checkpoints both harnesses exit with code 2, naming the env
    vars to set, before anything runs."""
    errs = []
    with pytest.MonkeyPatch.context() as mp:
        _clear(mp)
        mp.chdir(REPO)
        for harness in (jparity, tparity):
            with pytest.raises(SystemExit) as e:
                harness.run_parity("nerf_vo_replica", scenes=["room0"])
            assert e.value.code == 2
            errs.append(capsys.readouterr().err)
    assert errs[0] == errs[1]
    for env in ("NERF_VO_DPVO_WEIGHTS", "NERF_VO_OMNIDATA_DEPTH_WEIGHTS",
                "--allow-random-weights"):
        assert env in errs[1]


def _normalized(report, seen):
    run = report["dir_prediction"]
    text = json.dumps(dict(report, dir_prediction=None), sort_keys=True)
    md = Path(run, "parity_report.md").read_text()
    on_disk = json.loads(Path(run, "parity_report.json").read_text())
    assert on_disk == json.loads(json.dumps(report))
    args = [json.dumps(vars(a), sort_keys=True).replace(run, "<run>")
            for a in seen]
    return text, md, args


@pytest.mark.parametrize("config", ["nerf_vo_replica", "nerf_slam_replica",
                                    "nerf_vo_tum_rgbd"])
@pytest.mark.parametrize("weights", ["pretrained", "random"])
def test_reports_equal_jax_on_the_same_metrics(tmp_path, config, weights):
    ck = tmp_path / "ckpt"
    ck.write_bytes(b"x")
    overrides = dict(dir_prediction=str(tmp_path / "pred"),
                     scene_names=["room0", "room1"],
                     depth_supervision_lambdas=[0.1, 0.2])
    seen = {"jax": [], "port": []}

    def jax_run(args, cfg):
        seen["jax"].append(args)
        return METRICS[args.scene_name]

    def port_execute(args, device="cuda", dataset=None):
        assert device == "cpu"
        seen["port"].append(args)
        return "mapping"

    def port_evaluate(args, cfg, mapping):
        assert mapping == "mapping"
        return METRICS[args.scene_name]

    with pytest.MonkeyPatch.context() as mp:
        _clear(mp)
        if weights == "pretrained":
            for env in HOOKS[:-1]:
                mp.setenv(env, str(ck))
        mp.chdir(REPO)
        mp.setattr(jrun, "execute_render_and_evaluate", jax_run)
        mp.setattr(tparity.run, "execute", port_execute)
        mp.setattr(tparity.run, "render_and_evaluate", port_evaluate)
        want = jparity.run_parity(config, allow_random_weights=True,
                                  overrides=overrides, experiment="e")
        got = tparity.run_parity(config, allow_random_weights=True,
                                 overrides=overrides, experiment="e",
                                 device="cpu")
    assert _normalized(got, seen["port"]) == _normalized(want, seen["jax"])
    assert got["dry_run"] == (weights == "random")
    statuses = {r["status"] for rows in got["scenes"].values() for r in rows}
    assert statuses >= ({"DRY-RUN", "N/A", "INFO"} if weights == "random"
                        else {"PASS", "FAIL", "N/A", "INFO"})


def test_report_rows_of_one_scene():
    """``report_rows`` alone: one row a metric, LPIPS an explicit N/A."""
    rows = tparity.report_rows("nerf_vo_replica", METRICS["room0"], False)
    assert [r["metric"] for r in rows] == tparity.REPORT_METRICS
    by = {r["metric"]: r for r in rows}
    assert by["2d/lpips"]["note"] == "N/A (set NERF_VO_LPIPS_WEIGHTS)"
    assert by["2d/psnr"]["status"] == "FAIL"
    assert by["2d/depth_abs_rel"]["value"] is None
    assert by["trajectory/keyframes_tracking/ate_rmse"]["status"] == "PASS"
    dry = tparity.report_rows("nerf_vo_replica", METRICS["room0"], True)
    assert by["2d/mssim"]["status"] == "PASS"
    assert {r["metric"]: r["status"] for r in dry}["2d/mssim"] == "DRY-RUN"


def test_imports_without_yaml_or_jax():
    """The harness imports with yaml, cv2, JAX and the JAX package
    unimportable; only reading a config needs yaml."""
    code = """
import sys
for m in ("yaml", "cv2", "jax", "jaxlib", "flax", "optax", "nerf_vo_tpu"):
    sys.modules[m] = None
from nerf_vo_tpu_torch import parity
rows = parity.report_rows("nerf_vo_replica", {"2d": {"psnr": 30.0}}, False)
assert len(rows) == len(parity.REPORT_METRICS)
try:
    parity.run_parity("nerf_vo_replica")
except ImportError as e:
    assert "yaml" in str(e), e
else:
    raise AssertionError("read a config without yaml")
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.fixture(scope="module")
def dry_run(tmp_path_factory):
    """One port dry run on the CPU at one intra-op thread (as
    ``tests/test_torch_pipeline.py`` runs the port)."""
    root = tmp_path_factory.mktemp("Replica")
    (root / "camera_parameters.json").write_text(json.dumps({"replica": INTR}))
    _write_scene(root / "room0")
    overrides = dict(CFG, dir_dataset=str(root),
                     dir_prediction=str(tmp_path_factory.mktemp("pred")),
                     num_evaluation_frames=4)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with pytest.MonkeyPatch.context() as mp:
            _clear(mp)
            mp.chdir(REPO)
            return tparity.run_parity("nerf_vo_replica", scenes=["room0"],
                                      allow_random_weights=True,
                                      overrides=overrides, device="cpu")
    finally:
        torch.set_num_threads(n)


def test_port_dry_run_writes_the_report(dry_run):
    report = dry_run
    assert report["dry_run"]
    assert report["verdict"].startswith("DRY-RUN")
    assert report["weights"]["dpvo"]["weights"] == "RANDOM (dry run)"
    assert "n/a" in report["weights"]["lpips"]["weights"]
    rows = {r["metric"]: r for r in report["scenes"]["room0"]}
    assert set(rows) == set(tparity.REPORT_METRICS)
    assert rows["2d/lpips"]["status"] == "N/A"
    assert "NERF_VO_LPIPS_WEIGHTS" in rows["2d/lpips"]["note"]
    for key in ("trajectory/keyframes_tracking/ate_rmse", "2d/psnr",
                "2d/mssim", "2d/depth_abs_rel", "3d/mesh_f1"):
        assert rows[key]["value"] is not None and np.isfinite(
            rows[key]["value"]), key
    assert all(r["status"] in ("DRY-RUN", "N/A", "INFO")
               for r in rows.values())


def test_port_dry_run_writes_the_artifact_tree(dry_run):
    pred = dry_run["dir_prediction"]
    assert os.path.exists(pred + "/parity_report.json")
    assert os.path.exists(pred + "/parity_report.md")
    assert os.path.exists(pred + "/config.json")
    assert os.path.exists(pred + "/room0/snapshots")
    res = pred + "/results/room0"
    for artifact in ("metrics_trajectory.csv", "metrics_2d_frames.csv",
                     "metrics_2d.csv", "metrics_2d.json", "metrics_3d.csv"):
        assert os.path.exists(res + f"/{artifact}"), artifact
    with open(res + "/metrics_2d.json") as f:
        agg = json.load(f)
    assert "lpips" in agg and agg["lpips"] is None
    with open(res + "/metrics_2d_frames.csv") as f:
        header = f.readline()
    assert "lpips" in header
