"""The port's pipeline and CLI (``runtime.pipeline.execute``,
``nerf_vo_tpu_torch.run``) against the JAX package's ``execute``, on the
CPU.

One synthetic Replica scene (10 frames of 48x64, written with OpenCV as
``tests/test_e2e.py`` writes its scene) goes through the JAX ``execute``
once and through the port's several times with the same ``args``: the
prediction trees match file for file (``.msgpack`` -> ``.pt``), two serial
runs of the port and a threaded one are bitwise equal, the train-state
snapshot restores every tensor, and the CLI lays out the run directory,
applies the per-scene overrides and evaluates each scene. Values of the trajectories are not
compared across packages: random-weight tracking is chaotic (ROADMAP,
Queue 3).
"""

from __future__ import annotations

import argparse
import contextlib
import csv
import io
import json
import os
from pathlib import Path
from types import SimpleNamespace

import cv2
import numpy as np
import pytest
import torch

from nerf_vo_tpu.runtime import pipeline as jpipeline
from nerf_vo_tpu_torch import run as trun
from nerf_vo_tpu_torch.models import dpt as tdpt
from nerf_vo_tpu_torch.runtime import pipeline as tpipeline
from nerf_vo_tpu_torch.runtime import stages as tstages
from test_e2e import INTR, _scene_sdf_depth_color

N_FRAMES = 10
ITERS = 16
CFG = dict(
    dataset_name="replica", tracking_module="dpvo", enhancement_module="depth",
    mapping_module="nerfstudio", multithreading=False,
    performance_tracking=True, cache_dataset=False, first_frame_index=0,
    last_frame_index=-1, frame_stride=1, num_keyframes=16, frame_height=48,
    frame_width=64, patches_per_frame=8, removal_window=5,
    optimization_window=4, patch_lifetime=4, keyframe_threshold=0.0,
    mapping_iterations=ITERS, mapping_snapshot_iterations=ITERS,
    rays_per_batch=128, enhancement_image_size=64, enhancement_dpt_layers=2,
    tracking_init_frames=4, tracking_max_edges=512, tracking_ring_size=8,
    tracking_max_frames=64,
    mapping_model_overrides=dict(
        log2_hashmap_size=14, max_res=64, proposal_resolutions=[16, 24],
        num_proposal_samples=[16, 8], num_nerf_samples=8),
)
SNAP = f"trainstate{ITERS:06d}"


def _write_scene(scene: Path) -> None:
    """Frames, GT depth and GT poses (``traj.txt``); the pipeline reads
    only the frames, evaluation all three."""
    (scene / "results").mkdir(parents=True)
    traj = []
    for i in range(N_FRAMES):
        c2w = np.eye(4)
        c2w[0, 3] = 0.04 * i  # slow lateral motion
        ang = 0.01 * i
        c2w[:3, :3] = [[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                       [-np.sin(ang), 0, np.cos(ang)]]
        color, depth = _scene_sdf_depth_color(c2w)
        cv2.imwrite(str(scene / "results" / f"frame{i:06d}.jpg"),
                    cv2.cvtColor(color, cv2.COLOR_RGB2BGR))
        cv2.imwrite(str(scene / "results" / f"depth{i:06d}.png"),
                    (depth * INTR["depth_scale"]).astype(np.uint16))
        traj.append(" ".join(str(v) for v in c2w.flatten()))
    (scene / "traj.txt").write_text("\n".join(traj))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's CPU runs at one intra-op thread: at these sizes more
    threads gain little alone and, beside the other test workers, cost
    several times their time in contention."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def replica_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("Replica")
    (root / "camera_parameters.json").write_text(json.dumps({"replica": INTR}))
    _write_scene(root / "room0")
    (root / "room1").symlink_to(root / "room0")
    return root


def _args(root: Path, out: Path, **kw) -> argparse.Namespace:
    return argparse.Namespace(**dict(
        CFG, dir_dataset=str(root / "room0"), scene_name="room0",
        dir_prediction=str(out / "pred"), dir_result=str(out / "result"),
        **kw))


@pytest.fixture(scope="module")
def jax_run(replica_root, tmp_path_factory):
    """The JAX ``execute`` once. Its depth DPT comes from an
    Omnidata-layout file (the blocks past the two it runs share one
    storage), which spares the JAX estimator's eager random init."""
    tmp = tmp_path_factory.mktemp("jax")
    torch.manual_seed(7)
    sd = tdpt.DPTHybrid(num_channels=1, image_size=64, depth_layers=2,
                        dtype=torch.float32).state_dict()
    for k in [k for k in sd if ".blocks.1." in k]:
        for b in range(2, 12):
            sd[k.replace(".blocks.1.", f".blocks.{b}.")] = sd[k]
    torch.save(sd, tmp / "omnidata_depth.pt")
    args = _args(replica_root, tmp)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("NERF_VO_OMNIDATA_DEPTH_WEIGHTS",
                  str(tmp / "omnidata_depth.pt"))
        mapping = jpipeline.execute(args)
    return args, mapping


@pytest.fixture(scope="module")
def port_runs(replica_root, tmp_path_factory):
    """The port's ``execute`` on the CPU: serial twice, threaded once."""
    runs = {}
    for name, threaded in (("serial", False), ("serial_again", False),
                           ("threaded", True)):
        args = _args(replica_root, tmp_path_factory.mktemp(name),
                     multithreading=threaded)
        runs[name] = (args, tpipeline.execute(args, device="cpu"))
    return runs


def _files(*dirs):
    return sorted(str(Path(d, f).relative_to(Path(d).parent)).replace(
        ".msgpack", ".pt")
        for d in dirs for f in _rel(Path(d)))


def _rel(d: Path):
    return [str(p.relative_to(d)) for p in d.rglob("*") if p.is_file()]


def _json(args, name):
    with open(os.path.join(args.dir_prediction, name)) as f:
        return json.load(f)


TRACK_JSON = "matrices/matrices_origin2frame_keyframes_tracking.json"
TRAIN_JSON = "matrices/matrices_origin2frame_training.json"


def _assert_rigid(mats: dict) -> None:
    for k, m in mats.items():
        m = np.asarray(m, np.float64)
        assert m.shape == (4, 4) and np.isfinite(m).all(), k
        np.testing.assert_allclose(m[:3, :3] @ m[:3, :3].T, np.eye(3),
                                   atol=1e-4, err_msg=k)
        np.testing.assert_allclose(m[3], [0, 0, 0, 1], atol=1e-6, err_msg=k)


def _assert_same_run(a, b):
    """Bitwise equal prediction directories: JSON bytes, the training-set
    dump and every tensor of both snapshots."""
    for name in ("mapping_keyframe2frame.json", TRACK_JSON, TRAIN_JSON):
        assert (Path(a.dir_prediction, name).read_bytes()
                == Path(b.dir_prediction, name).read_bytes()), name
    na = np.load(os.path.join(a.dir_prediction, "dataset.npz"))
    nb = np.load(os.path.join(b.dir_prediction, "dataset.npz"))
    for k in na.files:
        np.testing.assert_array_equal(na[k], nb[k], err_msg=k)
    for stem in (SNAP, f"snapshot{ITERS:06d}"):
        sa = torch.load(Path(a.dir_prediction, "snapshots", stem + ".pt"))
        sb = torch.load(Path(b.dir_prediction, "snapshots", stem + ".pt"))
        _assert_equal_tree(sa, sb, stem)


def _assert_equal_tree(x, y, where=""):
    if isinstance(x, torch.Tensor):
        assert isinstance(y, torch.Tensor) and torch.equal(x, y), where
    elif isinstance(x, dict):
        assert x.keys() == y.keys(), where
        for k in x:
            _assert_equal_tree(x[k], y[k], f"{where}/{k}")
    elif isinstance(x, (list, tuple)):
        assert len(x) == len(y), where
        for i, (u, v) in enumerate(zip(x, y)):
            _assert_equal_tree(u, v, f"{where}/{i}")
    else:
        assert x == y, where


@pytest.mark.parametrize("other", ["serial_again", "threaded"])
def test_port_runs_repeat_bitwise(port_runs, other):
    """Serial mode repeats bitwise on the CPU, and the threaded mode (frames
    read on a prefetch thread) gives the serial result."""
    _assert_same_run(port_runs["serial"][0], port_runs[other][0])


def test_snapshot_restores_train_state(port_runs):
    """The port's counterpart of ``tests/test_resume.py``: every model
    tensor (the distilled proposal grids, which take no gradient, too), the
    pose deltas and both Adam states come back exactly, and training goes
    on from the restored step."""
    args, live = port_runs["serial"]
    fresh = tstages.MappingStage(args, device="cpu")
    grids = [k for k in live.model.state_dict() if "proposal" in k]
    assert grids
    assert any(not torch.equal(fresh.model.state_dict()[k],
                               live.model.state_dict()[k]) for k in grids)
    fresh.buffer, fresh.num_inserted = live.buffer, live.num_inserted
    fresh.restore_snapshot(os.path.join(args.dir_prediction, "snapshots",
                                        SNAP + ".pt"))
    assert fresh.step_count == fresh.state.step == ITERS
    assert isinstance(fresh.state.step, int)
    _assert_equal_tree(live.model.state_dict(), fresh.model.state_dict(),
                       "model")
    assert torch.equal(live.state.pose_deltas, fresh.state.pose_deltas)
    _assert_equal_tree(live.state.opt.state_dict(),
                       fresh.state.opt.state_dict(), "opt")
    _assert_equal_tree(live.state.cam_opt.state_dict(),
                       fresh.state.cam_opt.state_dict(), "cam_opt")
    # the optimizers step the stage's own tensors
    opt_params = fresh.state.opt.param_groups[0]["params"]
    assert all(p is q for p, q in zip(opt_params,
                                      fresh.state.params.values()))

    fresh.mapping_iterations += 1
    fresh.stream_active = False
    before = fresh.state.params["field.tables"].clone()
    m = fresh.train_step()
    assert m is not None and torch.isfinite(m["loss"])
    assert fresh.step_count == ITERS + 1
    assert not torch.equal(before, fresh.state.params["field.tables"])


def test_prediction_tree_matches_jax(jax_run, port_runs):
    jargs, jmap = jax_run
    targs, tmap = port_runs["serial"]
    jfiles = _files(jargs.dir_prediction, jargs.dir_result)
    assert jfiles == _files(targs.dir_prediction, targs.dir_result)
    assert f"pred/snapshots/{SNAP}.pt" in jfiles
    assert "result/runtime_enhancement.csv" in jfiles

    jnpz = np.load(os.path.join(jargs.dir_prediction, "dataset.npz"))
    tnpz = np.load(os.path.join(targs.dir_prediction, "dataset.npz"))
    assert sorted(jnpz.files) == sorted(tnpz.files)
    for k in jnpz.files:
        assert (jnpz[k].shape, jnpz[k].dtype) == (tnpz[k].shape,
                                                  tnpz[k].dtype), k
    assert int(tnpz["num_active"]) == tmap.num_inserted

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
    assert tmap.step_count == ITERS

    for f in jfiles:
        if f.endswith(".csv"):
            with open(Path(jargs.dir_prediction).parent / f) as a, \
                    open(Path(targs.dir_prediction).parent / f) as b:
                assert next(csv.reader(a)) == next(csv.reader(b)), f


def test_execute_on_cuda_without_a_card_raises(replica_root, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpipeline.execute(_args(replica_root, tmp_path))


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

LAMBDAS = [0.25, 0.5]


@pytest.fixture(scope="module")
def cli_run(replica_root, tmp_path_factory):
    """``nerf_vo_tpu_torch.run.main`` over two scenes of a config with the
    keys of ``configs/synthetic_demo.yaml`` (cut to this file's sizes),
    ``frame_stride: 2`` and per-scene depth lambdas, from a working
    directory that holds ``configs/<name>.yaml``."""
    import yaml

    work = tmp_path_factory.mktemp("cli")
    demo = yaml.safe_load(
        (Path(__file__).parents[1] / "configs" / "synthetic_demo.yaml")
        .read_text())
    config = dict(CFG, dir_dataset=str(replica_root),
                  dir_prediction=str(work / "predictions"),
                  scene_names=["room0", "room1"], num_evaluation_frames=4,
                  frame_stride=2, depth_supervision_lambdas=LAMBDAS)
    assert set(demo) <= set(config)
    (work / "configs").mkdir()
    (work / "configs" / "tiny.yaml").write_text(yaml.safe_dump(config))

    seen, tracked = [], {}

    def spy(args, device="cuda", dataset=None):
        seen.append(args.depth_supervision_lambda)
        mapping = tpipeline.execute(args, device, dataset)
        seen.append(mapping.model.config.depth_loss_mult)
        # as execute wrote it: evaluation rewrites it as a scaled list
        tracked[args.scene_name] = json.loads(
            Path(args.dir_prediction, TRACK_JSON).read_text())
        return mapping

    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, \
            contextlib.redirect_stdout(out):
        mp.setattr(trun, "execute", spy)
        mp.chdir(work)
        trun.main(["--config", "tiny", "--experiment", "t",
                   "--first_scene", "0", "--last_scene", "1"], device="cpu")
    (run_dir,) = (work / "predictions").iterdir()
    return SimpleNamespace(run_dir=run_dir, config=config, seen=seen,
                           out=out.getvalue(), tracked=tracked)


def test_cli_lays_out_the_run_and_applies_overrides(cli_run):
    run_dir, config, seen = cli_run.run_dir, cli_run.config, cli_run.seen
    assert run_dir.name.startswith("tiny_") and run_dir.name.endswith("_t")
    assert json.loads((run_dir / "config.json").read_text()) == config
    for scene in config["scene_names"]:
        assert (run_dir / scene / f"snapshots/{SNAP}.pt").is_file()
        assert (run_dir / "results" / scene / "runtime_tracking.csv").is_file()
    assert seen == [LAMBDAS[0], LAMBDAS[0], LAMBDAS[1], LAMBDAS[1]]


def test_cli_writes_the_evaluation_metrics(cli_run):
    """After each scene's ``execute`` the CLI renders and evaluates it:
    ``results/<scene>/`` holds the trajectory, 2D and 3D metrics, and the
    printed metrics are finite."""
    run_dir, config = cli_run.run_dir, cli_run.config
    assert "not ported" not in cli_run.out
    for scene in config["scene_names"]:
        res = run_dir / "results" / scene
        for name in ("metrics_trajectory.csv", "metrics_2d.csv",
                     "metrics_2d_frames.csv", "metrics_3d.csv",
                     "metrics_2d.json"):
            assert (res / name).is_file(), (scene, name)
        m2d = json.loads((res / "metrics_2d.json").read_text())
        assert m2d["lpips"] is None
        assert all(np.isfinite(v) for k, v in m2d.items() if k != "lpips")
        with open(res / "metrics_trajectory.csv") as f:
            head, row = list(csv.reader(f))
        assert "keyframes_mapping/ate_rmse" in head
        assert all(np.isfinite(float(v)) for v in row)
        pred = run_dir / scene
        assert (pred / "mesh" / "mesh_from_evaluation_frames.ply").is_file()
        # num_evaluation_frames 4 of 10 frames: every int(10 / 4) = 2nd
        assert len(list((pred / "evaluation_frames" / "color").iterdir())) \
            == 5


def test_frame_stride_doubles_frame_indices(cli_run):
    """``frame_stride: 2`` keeps every second file, and both JSON files
    count frames in files, as the JAX stage does: keyframe i is file 2i.
    Evaluation then rewrites the tracking JSON as a list in key order
    (positions scaled to GT), as the JAX renderer does."""
    n = N_FRAMES // 2
    for scene in ("room0", "room1"):
        pred = cli_run.run_dir / scene
        kf2frame = json.loads((pred / "mapping_keyframe2frame.json")
                              .read_text())
        assert kf2frame == {str(i): 2 * i for i in range(n)}
        mats = cli_run.tracked[scene]
        assert sorted(mats, key=int) == [str(2 * i) for i in range(n)]
        _assert_rigid(mats)
        scaled = json.loads((pred / TRACK_JSON).read_text())
        assert isinstance(scaled, list) and len(scaled) == n
        _assert_rigid(dict(enumerate(scaled)))
