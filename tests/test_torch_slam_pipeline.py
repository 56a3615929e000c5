"""The port's nerf_slam pipeline (DROID tracking, DROID depth under
``enhancement_module: none``, the Instant-NGP mapper) through
``runtime.pipeline.execute``, against the JAX package's ``execute``, on the
CPU.

The synthetic Replica scene of ``tests/test_torch_pipeline.py`` (10 frames
of 48x64) goes through the JAX ``execute`` once and through the port's
serially and threaded with the same ``args``, the keys of
``configs/nerf_slam_replica.yaml`` cut to this size, with the tracker's
branches forced (``motion_threshold`` 0: every frame a candidate;
``keyframe_threshold`` 0: none removed; window 5 and 12 edges, so frames
retire during the stream and the flush runs both global BA passes). The
prediction trees match file for file (``.msgpack`` -> ``.pt``), the two
port runs are bitwise equal, and the snapshots hold the occupancy grid
(``tests/test_torch_slam_cli.py`` runs the CLI on the same scene).
Values of the trajectories are not compared across packages here:
random-weight tracking is chaotic (``tests/test_torch_droid.py`` holds the
tracker's pieces; ROADMAP, Queue 3).
"""

from __future__ import annotations

import argparse
import csv
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from nerf_vo_tpu.runtime import pipeline as jpipeline
from nerf_vo_tpu_torch.runtime import pipeline as tpipeline
from nerf_vo_tpu_torch.runtime import stages as tstages
from test_e2e import INTR
from test_torch_pipeline import (
    N_FRAMES,
    TRACK_JSON,
    TRAIN_JSON,
    _assert_equal_tree,
    _assert_rigid,
    _files,
    _json,
    _write_scene,
)

ITERS = 16
CFG = dict(
    dataset_name="replica", tracking_module="droid-slam",
    enhancement_module="none", mapping_module="instant-ngp",
    perform_global_bundle_adjustment=True, compute_covariances=True,
    multithreading=False, performance_tracking=True, cache_dataset=False,
    first_frame_index=0, last_frame_index=-1, frame_stride=1,
    num_keyframes=16, frame_height=48, frame_width=64, motion_threshold=0.0,
    keyframe_threshold=0.0, tracking_frontend_window=5, tracking_max_edges=12,
    mapping_iterations=ITERS, mapping_snapshot_iterations=ITERS,
    rays_per_batch=128,
    mapping_model_overrides=dict(log2_hashmap_size=14, max_res=64,
                                 num_nerf_samples=8, num_occ_bins=16),
)
SNAPS = (f"trainstate{ITERS:06d}", f"snapshot{ITERS:06d}")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread, as in ``tests/test_torch_pipeline.py``."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def replica_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("Replica")
    (root / "camera_parameters.json").write_text(json.dumps({"replica": INTR}))
    _write_scene(root / "room0")
    return root


def _args(root: Path, out: Path, **kw) -> argparse.Namespace:
    return argparse.Namespace(**dict(
        CFG, dir_dataset=str(root / "room0"), scene_name="room0",
        dir_prediction=str(out / "pred"), dir_result=str(out / "result"),
        **kw))


@pytest.fixture(scope="module")
def jax_run(replica_root, tmp_path_factory):
    args = _args(replica_root, tmp_path_factory.mktemp("jax"))
    return args, jpipeline.execute(args)


@pytest.fixture(scope="module")
def port_runs(replica_root, tmp_path_factory):
    runs = {}
    for name, threaded in (("serial", False), ("threaded", True)):
        args = _args(replica_root, tmp_path_factory.mktemp(name),
                     multithreading=threaded)
        runs[name] = (args, tpipeline.execute(args, device="cpu"))
    return runs


def test_slam_prediction_tree_matches_jax(jax_run, port_runs):
    jargs, jmap = jax_run
    targs, tmap = port_runs["serial"]
    jfiles = _files(jargs.dir_prediction, jargs.dir_result)
    assert jfiles == _files(targs.dir_prediction, targs.dir_result)
    for stem in SNAPS:
        assert f"pred/snapshots/{stem}.pt" in jfiles
    jnpz = np.load(os.path.join(jargs.dir_prediction, "dataset.npz"))
    tnpz = np.load(os.path.join(targs.dir_prediction, "dataset.npz"))
    assert sorted(jnpz.files) == sorted(tnpz.files)
    for k in jnpz.files:
        assert (jnpz[k].shape, jnpz[k].dtype) == (tnpz[k].shape,
                                                  tnpz[k].dtype), k
    kf2frame = _json(targs, "mapping_keyframe2frame.json")
    assert kf2frame == _json(jargs, "mapping_keyframe2frame.json")
    assert kf2frame == {str(i): i for i in range(N_FRAMES)}
    for name in (TRACK_JSON, TRAIN_JSON):
        jm, tm = _json(jargs, name), _json(targs, name)
        assert jm.keys() == tm.keys(), name
        _assert_rigid(tm)
        _assert_rigid(jm)
    assert (tmap.step_count, tmap.num_inserted) == (jmap.step_count,
                                                    jmap.num_inserted)
    assert tmap.step_count == ITERS and tmap.num_inserted == N_FRAMES
    for f in jfiles:
        if f.endswith(".csv"):
            with open(Path(jargs.dir_prediction).parent / f) as a, \
                    open(Path(targs.dir_prediction).parent / f) as b:
                assert next(csv.reader(a)) == next(csv.reader(b)), f


def test_slam_mapper_gets_droid_depth_and_covariance(jax_run, port_runs):
    """The NGP stage's buffer holds the depth from DROID's inverse depth
    and the upsampled covariance (not the default 1) in both packages."""
    for mapping in (jax_run[1], port_runs["serial"][1]):
        n = mapping.num_inserted
        cov = np.asarray(mapping.buffer.depth_cov[:n], np.float32)
        depth = np.asarray(mapping.buffer.depth[:n], np.float32)
        assert cov.shape == (n, 48, 64) and (cov > 0).all()
        assert not (cov == 1).all()
        assert np.isfinite(depth).all() and (depth > 0).all()
    model = port_runs["serial"][1].model
    assert model.config.sampler == "occupancy" and not model.proposal_fields


def test_slam_port_runs_repeat_bitwise(port_runs):
    """The threaded mode reads the same frames: bitwise the serial run."""
    a, b = port_runs["serial"][0], port_runs["threaded"][0]
    for name in ("mapping_keyframe2frame.json", TRACK_JSON, TRAIN_JSON):
        assert (Path(a.dir_prediction, name).read_bytes()
                == Path(b.dir_prediction, name).read_bytes()), name
    for stem in SNAPS:
        sa = torch.load(Path(a.dir_prediction, "snapshots", stem + ".pt"))
        sb = torch.load(Path(b.dir_prediction, "snapshots", stem + ".pt"))
        _assert_equal_tree(sa, sb, stem)


def test_slam_snapshot_restores_the_grid(port_runs):
    """Both snapshots hold the occupancy grid; the train-state snapshot
    restores it (and every other tensor) into a fresh NGP stage."""
    args, mapping = port_runs["serial"]
    grid = mapping.state.occ_grid
    assert grid is not None and (grid < 1).any()
    for stem in SNAPS:
        blob = torch.load(Path(args.dir_prediction, "snapshots",
                               stem + ".pt"))
        assert torch.equal(blob["occ_grid"], grid), stem
    fresh = tstages.MappingStage(args, device="cpu")
    assert (fresh.state.occ_grid == 1).all()
    fresh.restore_snapshot(str(Path(args.dir_prediction, "snapshots",
                                    SNAPS[0] + ".pt")))
    assert torch.equal(fresh.state.occ_grid, grid)
    assert fresh.step_count == ITERS
