"""The port's CLI (``nerf_vo_tpu_torch.run``) on a nerf_slam config, on
the CPU: ``execute`` with DROID tracking and the Instant-NGP mapper, then
``render_and_evaluate``, whose renders go through the occupancy grid. The
scene and the config's keys are those of
``tests/test_torch_slam_pipeline.py``."""

from __future__ import annotations

import contextlib
import io
import json

import numpy as np
import pytest

from nerf_vo_tpu_torch import run as trun
from nerf_vo_tpu_torch.runtime import stages as tstages
from test_torch_slam_pipeline import (  # noqa: F401 (fixtures)
    CFG,
    one_thread,
    replica_root,
)


def test_slam_cli_executes_and_evaluates(replica_root, tmp_path):
    """``nerf_vo_tpu_torch.run.main`` with the nerf_slam keys: ``execute``,
    then ``render_and_evaluate``, whose renders go through the occupancy
    grid; the metrics are written and finite."""
    import yaml

    config = dict(CFG, dir_dataset=str(replica_root),
                  dir_prediction=str(tmp_path / "predictions"),
                  scene_names=["room0"], num_evaluation_frames=4)
    (tmp_path / "configs").mkdir()
    (tmp_path / "configs" / "slam.yaml").write_text(yaml.safe_dump(config))
    stages = []
    init = tstages.MappingStage.__init__

    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, \
            contextlib.redirect_stdout(out):
        def spy(self, *a, **k):
            init(self, *a, **k)
            stages.append(self)

        mp.setattr(tstages.MappingStage, "__init__", spy)
        mp.chdir(tmp_path)
        trun.main(["--config", "slam", "--experiment", "t",
                   "--last_scene", "0"], device="cpu")
    (run_dir,) = (tmp_path / "predictions").iterdir()
    assert stages and stages[0].state.occ_grid is not None
    res = run_dir / "results" / "room0"
    for name in ("metrics_trajectory.csv", "metrics_2d.csv",
                 "metrics_3d.csv", "metrics_2d.json"):
        assert (res / name).is_file(), name
    m2d = json.loads((res / "metrics_2d.json").read_text())
    assert all(np.isfinite(v) for k, v in m2d.items() if k != "lpips")
