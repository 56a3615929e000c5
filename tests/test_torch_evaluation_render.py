"""The port's evaluation layer over a trained map (``MapRenderer``,
``Renderer``, ``Evaluator``, ``render_and_evaluate``) against the JAX
package's, on the CPU.

One synthetic Replica scene (``tests/test_e2e.py``'s plane + sphere, 10
frames of 48x64 with their GT depth and poses) is written to disk twice,
once per package, so that each fuses and caches its own GT mesh. The map:
the JAX ``MappingStage`` takes one packet of 5 keyframes (every second
frame, poses at half the GT scale as a monocular tracker reports them,
depth priors at that scale) and trains 6 steps; its parameters and pose
deltas are carried to the port's stage, which takes the same packet. The
prediction directory holds the keyframe JSONs as ``execute`` writes them,
in two copies.

Tolerances (measured spread in brackets):
- optimized keyframe poses in the prediction frame: 1e-5 [3.7e-8];
- renders: depth relative 1e-3 [3.5e-4]; color: every channel within 2
  of 255 [1, at 1.2% of the values] (the bf16 MLPs round apart);
- the density grid: 2e-3 of its largest value [4.5e-4];
- ``render_and_evaluate``: the same files in both trees; trajectory
  metrics and the rescaled keyframe poses 1e-5, relative and absolute
  [6.0e-6 absolute, 2.5e-6 relative, in the ATE's scale, which carries
  the pred->GT depth-scale ratio of the two packages' renders; the poses
  3.4e-7]; PSNR / MSSIM / depth metrics relative 2e-3 [<= 2.3e-4, MSSIM:
  renders one level apart at a few pixels, through the JPEG]; mesh
  metrics absolute 1e-2 [<= 1.2e-3: two meshes fused from those renders,
  sampled alike].
"""

from __future__ import annotations

import argparse
import csv
import json
import shutil
from pathlib import Path
from types import SimpleNamespace

import cv2
import jax
import numpy as np
import pytest
import torch

from nerf_vo_tpu.evaluation import nerf_renderer as jnr
from nerf_vo_tpu.evaluation import runner as jrunner
from nerf_vo_tpu.runtime import stages as jstages
from nerf_vo_tpu_torch.core import conventions
from nerf_vo_tpu_torch.evaluation import nerf_renderer as tnr
from nerf_vo_tpu_torch.evaluation import runner as trunner
from nerf_vo_tpu_torch.models import nerfacto as tn
from nerf_vo_tpu_torch.runtime import stages as tstages
from test_e2e import INTR, _scene_sdf_depth_color
from torch_parity import to_numpy_tree

H, W = INTR["h"], INTR["w"]
N_FRAMES = 10
KEYFRAMES = list(range(0, N_FRAMES, 2))
TRACK_SCALE = 0.5  # the tracker's scale against GT
STEPS = 6
POSE_ATOL = 1e-5
DEPTH_RTOL = 1e-3
COLOR_ATOL = 2
DENSITY_RTOL = 2e-3
TRAJ_TOL = 1e-5
METRIC_2D_RTOL = 2e-3
METRIC_3D_ATOL = 1e-2


def _gt_pose(i):
    c2w = np.eye(4)
    c2w[0, 3] = 0.04 * i  # slow lateral motion
    ang = 0.01 * i
    c2w[:3, :3] = [[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                   [-np.sin(ang), 0, np.cos(ang)]]
    return c2w


def _write_replica(root: Path) -> Path:
    scene = root / "room0"
    (scene / "results").mkdir(parents=True)
    (root / "camera_parameters.json").write_text(json.dumps(
        {"replica": INTR}))
    traj = []
    for i in range(N_FRAMES):
        color, depth = _scene_sdf_depth_color(_gt_pose(i))
        cv2.imwrite(str(scene / "results" / f"frame{i:06d}.jpg"),
                    cv2.cvtColor(color, cv2.COLOR_RGB2BGR))
        cv2.imwrite(str(scene / "results" / f"depth{i:06d}.png"),
                    (depth * INTR["depth_scale"]).astype(np.uint16))
        traj.append(" ".join(str(v) for v in _gt_pose(i).flatten()))
    (scene / "traj.txt").write_text("\n".join(traj))
    return scene


def _tracker_pose(i):
    c2w = _gt_pose(i)
    c2w[:3, 3] *= TRACK_SCALE
    return c2w


def _packet():
    """The enhancement stage's packet of the keyframes: OpenGL poses in
    the tracker's world, colors in [0, 1], depth priors at its scale."""
    colors, depths = zip(*(_scene_sdf_depth_color(_gt_pose(i))
                           for i in KEYFRAMES))
    cv_poses = np.stack([_tracker_pose(i) for i in KEYFRAMES]).astype(
        np.float32)
    intr = np.asarray([INTR["fx"], INTR["fy"], INTR["cx"], INTR["cy"]],
                      np.float32)
    return {
        "camera_extrinsics": conventions.opencv_to_opengl(
            torch.tensor(cv_poses)).numpy(),
        "camera_intrinsics": np.tile(intr, (len(KEYFRAMES), 1)),
        "frames_color_float": np.stack(colors).astype(np.float32) / 255.0,
        "frames_depth": (np.stack(depths) * TRACK_SCALE).astype(np.float32),
        "keyframe_indices": np.arange(len(KEYFRAMES)),
    }


def _stage_args():
    return SimpleNamespace(
        num_keyframes=8, frame_height=H, frame_width=W,
        mapping_iterations=STEPS, rays_per_batch=256,
        enhancement_module="depth", mapping_module="nerfstudio",
        mapping_model_overrides=dict(
            log2_hashmap_size=14, max_res=64, proposal_resolutions=[16, 24],
            num_proposal_samples=[16, 8], num_nerf_samples=8))


def _write_prediction(pred: Path) -> None:
    """The keyframe JSONs as ``execute`` writes them."""
    (pred / "matrices").mkdir(parents=True)
    (pred / "mapping_keyframe2frame.json").write_text(json.dumps(
        {str(k): f for k, f in enumerate(KEYFRAMES)}))
    (pred / "matrices" / "matrices_origin2frame_keyframes_tracking.json") \
        .write_text(json.dumps({str(f): _tracker_pose(f).tolist()
                                for f in KEYFRAMES}))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's CPU runs at one intra-op thread, as in
    ``tests/test_torch_pipeline.py``: beside the other test workers more
    threads cost more in contention than they gain."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def stages():
    """The JAX stage trained ``STEPS`` steps on the packet, and the port's
    stage holding its parameters, pose deltas and the same packet."""
    args = _stage_args()
    pkt = _packet()
    jst = jstages.MappingStage(args)
    jst.update(pkt)
    jst.stream_active = False
    while jst.train_step() is not None:
        pass
    assert jst.step_count == STEPS
    tst = tstages.MappingStage(
        args, state_dict=tn.from_jax_params(to_numpy_tree(jst.state.params)),
        device="cpu")
    tst.update({k: torch.tensor(v) for k, v in pkt.items()})
    deltas = np.asarray(jst.state.pose_deltas)
    assert np.abs(deltas[1:]).max() > 0  # the camera optimizer moved them
    with torch.no_grad():
        tst.state.pose_deltas.copy_(torch.tensor(deltas))
    return jst, tst


@pytest.fixture(scope="module")
def renderers(stages):
    jst, tst = stages
    return jnr.MapRenderer(jst), tnr.MapRenderer(tst)


def test_camera_extrinsics_match_jax(renderers):
    jr, tr = renderers
    for k in range(len(KEYFRAMES)):
        want = jr.get_camera_extrinsics(k)
        got = tr.get_camera_extrinsics(k)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0, atol=POSE_ATOL)
    # keyframe 0 is the gauge anchor: the tracker's pose comes back
    np.testing.assert_allclose(tr.get_camera_extrinsics(0),
                               _tracker_pose(0), atol=POSE_ATOL)


def test_render_frame_matches_jax(renderers):
    """A render at a pred-frame pose between two keyframes, and the depth
    render at a training pose, as ``Renderer`` takes them."""
    jr, tr = renderers
    ci = dict(INTR, height=H, width=W)
    pose = _tracker_pose(3)
    jc, jd = jr.render_frame(ci, pose)
    tc, td = tr.render_frame(ci, pose)
    assert tc.shape == (H, W, 3) and tc.dtype == np.uint8
    assert td.shape == (H, W) and np.isfinite(td).all()
    assert np.abs(tc.astype(int) - jc.astype(int)).max() <= COLOR_ATOL
    np.testing.assert_allclose(td, jd, rtol=DEPTH_RTOL)
    for k in (0, 4):
        np.testing.assert_allclose(
            tr.render_frame_depth_from_training_frame(ci, k),
            jr.render_frame_depth_from_training_frame(ci, k),
            rtol=DEPTH_RTOL)


def test_density_grid_and_nerf_mesh_match_jax(renderers, tmp_path):
    """``render_mesh``'s density grid over a pred-frame box against the
    JAX field's density at the same lattice (the JAX ``render_mesh``
    builds it so, then jits the field), and both meshes written."""
    jr, tr = renderers
    res, lo, hi = (20, 16, 24), (-1.0, -0.8, 0.2), (1.0, 0.8, 2.0)
    got = tr.density_grid(res, lo, hi)
    xs = [np.linspace(np.float32(lo[d]), np.float32(hi[d]), res[d])
          for d in range(3)]
    grid = np.stack(np.meshgrid(*xs, indexing="ij"), -1).reshape(-1, 3)
    gridh = np.concatenate([grid, np.ones((len(grid), 1))], -1)
    pts = (jr._norm @ gridh.T).T[:, :3].astype(np.float32)
    model, params = jr.mapping.model, jr.state.params

    @jax.jit
    def density(p):
        return model.field.apply({"params": params["field"]}, p,
                                 method=model.field.density)[0]

    want = np.asarray(density(pts)).reshape(res)
    assert got.shape == res
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=DENSITY_RTOL * np.abs(want).max())
    # a threshold inside the grid's range, so both meshes have faces
    thr = float(np.median(want))
    for r, name in ((jr, "j.ply"), (tr, "t.ply")):
        r.render_mesh(str(tmp_path / name), res, lo, hi,
                      density_threshold=thr)
    from nerf_vo_tpu_torch.evaluation import meshio

    (vj, fj), (vt, ft) = (meshio.read_ply(str(tmp_path / n))
                          for n in ("j.ply", "t.ply"))
    assert len(ft) > 100
    assert abs(len(ft) - len(fj)) <= 0.05 * len(fj)
    assert (vt.min(0) >= np.asarray(lo) - 1e-5).all()
    assert (vt.max(0) <= np.asarray(hi) + 1e-5).all()


# ---------------------------------------------------------------------------
# render_and_evaluate, both packages
# ---------------------------------------------------------------------------

def _tree(d: Path):
    return sorted(str(p.relative_to(d)) for p in d.rglob("*") if p.is_file())


def _csv(path: Path):
    with open(path) as f:
        rows = list(csv.reader(f))
    return rows[0], rows[1:]


@pytest.fixture(scope="module")
def evaluated(stages, tmp_path_factory):
    jst, tst = stages
    out = {}
    for name, st, run in (("jax", jst, jrunner.render_and_evaluate),
                          ("port", tst, trunner.render_and_evaluate)):
        root = tmp_path_factory.mktemp(name)
        scene = _write_replica(root / "Replica")
        pred, result = root / "pred", root / "result"
        _write_prediction(pred)
        config = dict(dataset_name="replica", dir_dataset=str(scene),
                      num_evaluation_frames=4, dir_prediction=str(pred),
                      dir_result=str(result), render_poisson_mesh=True,
                      poisson_grid_resolution=64)
        metrics = run(argparse.Namespace(**config), config, st)
        out[name] = (root, metrics)
    return out


def test_render_and_evaluate_writes_the_same_tree(evaluated):
    (jroot, _), (troot, _) = evaluated["jax"], evaluated["port"]
    assert _tree(troot) == _tree(jroot)
    names = _tree(troot)
    for f in ("pred/mesh/mesh_from_evaluation_frames.ply",
              "pred/mesh/mesh_from_poisson.ply",
              "pred/evaluation_frames/color/000006.jpg",
              "pred/evaluation_frames/depth/000006.png",
              "pred/matrices/matrices_origin2frame_keyframes_mapping.json",
              "result/metrics_trajectory.csv", "result/metrics_2d.csv",
              "result/metrics_2d_frames.csv", "result/metrics_2d.json",
              "result/metrics_3d.csv", "Replica/room0_mesh_fused.ply"):
        assert f in names, f
    for f in names:
        if f.endswith(".csv"):
            jh, jrows = _csv(jroot / f)
            th, trows = _csv(troot / f)
            assert th == jh, f
            assert len(trows) == len(jrows), f
    jj = json.loads((jroot / "result/metrics_2d.json").read_text())
    tj = json.loads((troot / "result/metrics_2d.json").read_text())
    assert tj.keys() == jj.keys() and tj["lpips"] is jj["lpips"] is None
    # an empty lpips field, as pandas writes NaN
    head, rows = _csv(troot / "result/metrics_2d_frames.csv")
    assert [r[head.index("lpips")] for r in rows] == [""] * len(rows)
    assert [r[0] for r in rows] == ["0", "2", "4", "6", "8"][:len(rows)]


def test_render_and_evaluate_metrics_match_jax(evaluated):
    (jroot, jm), (troot, tm) = evaluated["jax"], evaluated["port"]
    assert tm["trajectory"].keys() == jm["trajectory"].keys()
    assert len(tm["trajectory"]) == 14
    for k, v in jm["trajectory"].items():
        np.testing.assert_allclose(tm["trajectory"][k], v, rtol=TRAJ_TOL,
                                   atol=TRAJ_TOL, err_msg=k)
    for name in ("keyframes_tracking", "keyframes_mapping"):
        f = f"pred/matrices/matrices_origin2frame_{name}.json"
        np.testing.assert_allclose(
            np.asarray(json.loads((troot / f).read_text())),
            np.asarray(json.loads((jroot / f).read_text())), rtol=TRAJ_TOL,
            atol=TRAJ_TOL)
    assert tm["2d"].keys() == jm["2d"].keys()
    for k, v in jm["2d"].items():
        if k == "lpips":
            assert np.isnan(v) and np.isnan(tm["2d"][k])
            continue
        assert np.isfinite(tm["2d"][k]), k
        np.testing.assert_allclose(tm["2d"][k], v, rtol=METRIC_2D_RTOL,
                                   err_msg=k)
    assert tm["3d"].keys() == jm["3d"].keys()
    for k, v in jm["3d"].items():
        np.testing.assert_allclose(tm["3d"][k], v, rtol=0,
                                   atol=METRIC_3D_ATOL, err_msg=k)
    assert tm["3d"]["mesh_f1"] > 0.1


def test_snapshot_renderer_restores_the_map(stages, tmp_path):
    """``load_snapshot_renderer`` reads the newest ``snapshot*.pt`` into a
    fresh stage (no optimizer state in it), which then renders what the
    live stage renders."""
    _, tst = stages
    snaps = tmp_path / "snapshots"
    snaps.mkdir()
    blob = {"model": tst.model.state_dict(),
            "pose_deltas": tst.state.pose_deltas.detach(), "step": STEPS}
    torch.save(blob, snaps / f"snapshot{STEPS:06d}.pt")
    torch.save({"model": {}, "pose_deltas": None, "step": 0},
               snaps / "snapshot000000.pt")
    shutil.copy(snaps / f"snapshot{STEPS:06d}.pt",
                snaps / f"trainstate{STEPS:06d}.pt")
    fresh = tstages.MappingStage(_stage_args(), device="cpu")
    fresh.buffer, fresh.num_inserted = tst.buffer, tst.num_inserted
    r = tnr.load_snapshot_renderer(str(tmp_path), fresh)
    assert fresh.step_count == STEPS
    ci = dict(INTR, height=H, width=W)
    live = tnr.MapRenderer(tst)
    for k in (0, 3):
        np.testing.assert_array_equal(r.get_camera_extrinsics(k),
                                      live.get_camera_extrinsics(k))
    np.testing.assert_array_equal(r.render_frame(ci, _tracker_pose(3))[1],
                                  live.render_frame(ci, _tracker_pose(3))[1])
