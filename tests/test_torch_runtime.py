"""The port's smaller runtime modules against the JAX package, on the CPU:
the dataset loaders and their utilities (``data/``), the mapping stage's
pacing rule, the live viewer, ``_pick_device``, imports without the
host-only packages, and ``chip_smoke.py``'s configurations against
``configs/nerf_vo_replica.yaml`` and ``configs/nerf_slam_replica.yaml``.
"""

from __future__ import annotations

import argparse
import ast
import importlib.util
import json
import os
import subprocess
import sys
import urllib.error
import urllib.request
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch
import yaml

from nerf_vo_tpu.data import datasets as jdatasets
from nerf_vo_tpu.data import utils as jutils
from nerf_vo_tpu_torch.data import datasets as tdatasets
from nerf_vo_tpu_torch.data import utils as tutils
from nerf_vo_tpu_torch.runtime import stages as tstages
from nerf_vo_tpu_torch.runtime.viewer import LiveViewer

REPO = Path(__file__).resolve().parents[1]


def _args(**kw):
    base = dict(dir_dataset="", dataset_name="replica", first_frame_index=0,
                last_frame_index=-1, frame_stride=1, frame_height=48,
                frame_width=64, cache_dataset=False)
    base.update(kw)
    return argparse.Namespace(**base)


def _img(rng, h=48, w=64):
    return rng.integers(0, 255, (h, w, 3), dtype=np.uint8)


def _replica(root: Path, rng):
    scene = root / "Replica" / "room0"
    (scene / "results").mkdir(parents=True)
    for i in range(6):
        cv2.imwrite(str(scene / "results" / f"frame{i:06d}.jpg"),
                    _img(rng, 60, 80))
    (root / "Replica" / "camera_parameters.json").write_text(json.dumps(
        {"replica": {"h": 60, "w": 80, "fx": 40.0, "fy": 40.0, "cx": 40.0,
                     "cy": 30.0, "depth_scale": 6553.5}}))
    return _args(dir_dataset=str(scene), first_frame_index=1,
                 last_frame_index=6, frame_stride=2, cache_dataset=True)


def _timestamped(seq: Path, rng, n, drop=()):
    """TUM-style rgb/depth/groundtruth files; frames in ``drop`` get no
    depth partner within 0.02 s."""
    (seq / "rgb").mkdir(parents=True)
    rgb, depth, gt = ["# rgb"], ["# depth"], ["# gt"]
    for i in range(n):
        t = 100.0 + 0.25 * i
        name = f"rgb/{t:.6f}.png"
        cv2.imwrite(str(seq / name), _img(rng))
        rgb.append(f"{t:.6f} {name}")
        if i not in drop:
            depth.append(f"{t + 0.004:.6f} depth/{t:.6f}.png")
        gt.append(f"{t - 0.003:.6f} 0 0 0 0 0 0 1")
    (seq / "rgb.txt").write_text("\n".join(rgb))
    (seq / "depth.txt").write_text("\n".join(depth))
    (seq / "groundtruth.txt").write_text("\n".join(gt))


def _tum(root: Path, rng):
    seq = root / "TUM" / "rgbd_dataset_freiburg1_desk"
    _timestamped(seq, rng, 5, drop=(3,))
    (root / "TUM" / "camera_parameters.json").write_text(json.dumps(
        {"fr1": {"h": 48, "w": 64, "fx": 50.0, "fy": 52.0, "cx": 31.0,
                 "cy": 24.5, "depth_scale": 5000.0, "k1": 0.2, "k2": -0.1,
                 "p1": 0.01, "p2": -0.005, "k3": 0.02}}))
    return _args(dir_dataset=str(seq), dataset_name="tum-rgbd",
                 frame_height=40, frame_width=60)


def _scannet(root: Path, rng):
    scene = root / "scene0000_00"
    (scene / "color").mkdir(parents=True)
    (scene / "intrinsics").mkdir()
    for i in (0, 1, 2, 10):  # numeric sort: 2 before 10
        cv2.imwrite(str(scene / "color" / f"{i}.jpg"), _img(rng))
    K = np.eye(4)
    K[0, 0], K[1, 1], K[0, 2], K[1, 2] = 50, 51, 32, 24
    (scene / "intrinsics" / "intrinsic_color.txt").write_text(
        " ".join(str(v) for v in K.flatten()))
    return _args(dir_dataset=str(scene), dataset_name="scannet",
                 frame_height=40, frame_width=60)


def _seven_scenes(root: Path, rng):
    scene = root / "7-Scenes" / "chess"
    (scene / "seq-01").mkdir(parents=True)
    for i in range(3):
        cv2.imwrite(str(scene / "seq-01" / f"frame-{i:06d}.color.png"),
                    _img(rng))
        cv2.imwrite(str(scene / "seq-01" / f"frame-{i:06d}.depth.png"),
                    rng.integers(0, 5000, (48, 64), dtype=np.uint16))
    (root / "7-Scenes" / "camera_parameters.json").write_text(json.dumps(
        {"7-scenes": {"h": 48, "w": 64, "fx": 58.5, "fy": 58.5, "cx": 32.0,
                      "cy": 24.0, "depth_scale": 1000.0}}))
    return _args(dir_dataset=str(scene), dataset_name="7-scenes",
                 frame_height=24, frame_width=32)


def _eth3d(root: Path, rng):
    seq = root / "ETH3D" / "sfm_lab_room_1"
    _timestamped(seq, rng, 4, drop=(2,))
    (seq / "calibration.txt").write_text("55.5 56.5 32.25 23.75")
    return _args(dir_dataset=str(seq), dataset_name="eth3d",
                 frame_height=24, frame_width=32)


FIXTURES = {"replica": _replica, "tum-rgbd": _tum, "scannet": _scannet,
            "7-scenes": _seven_scenes, "eth3d": _eth3d}


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_make_dataset_matches_jax(name, tmp_path, rng):
    """Every frame bitwise equal to the JAX loader's, with equal
    intrinsics, indices and last-frame flags."""
    args = FIXTURES[name](tmp_path, rng)
    want = jdatasets.make_dataset(name, args)
    got = tdatasets.make_dataset(name, args)
    assert len(got) == len(want) > 1
    assert got.files_color == want.files_color
    assert got.camera_intrinsics == want.camera_intrinsics
    np.testing.assert_array_equal(got.intrinsics_vector(),
                                  want.intrinsics_vector())
    for i in range(len(want)):
        f, g = want[i], got[i]
        assert f.keys() == g.keys()
        assert (g["frame_index"], g["last_frame"]) == (f["frame_index"],
                                                       f["last_frame"])
        assert g["frame_color"].dtype == np.uint8
        assert g["frame_color"].shape == (args.frame_height,
                                          args.frame_width, 3)
        np.testing.assert_array_equal(g["frame_color"], f["frame_color"])
        assert g["camera_intrinsics"] == f["camera_intrinsics"]


def test_dataset_utils_match_jax(tmp_path):
    cases = [([1.0, 2.0, 3.0], [1.015, 2.5, 3.001]),
             ([0.0, 0.01, 0.02, 5.0], [0.005, 0.011, 4.99, 5.001]),
             ([], [1.0]), ([2.0], [])]
    for src, tgt in cases:
        js, jt, ts, tt = list(src), list(tgt), list(src), list(tgt)
        assert (tutils.associate_timestamp_data(ts, tt)
                == jutils.associate_timestamp_data(js, jt))
        assert (ts, tt) == (js, jt)  # both consume their inputs alike
    for n in range(0, 2000, 7):
        assert tutils.even_padding(n) == jutils.even_padding(n)
        assert tutils.even_padding(n, 0.25) == jutils.even_padding(n, 0.25)
    ci = dict(height=60, width=80, fx=40.0, fy=41.0, cx=40.5, cy=30.5,
              depth_scale=1.0)
    assert (tutils.scale_camera_intrinsics(ci, 48, 64)
            == jutils.scale_camera_intrinsics(ci, 48, 64))
    seq = tmp_path / "seq"
    _timestamped(seq, np.random.default_rng(0), 3)
    (tmp_path / "camera_parameters.json").write_text(json.dumps(
        {"fr2": {"h": 48, "w": 64, "fx": 1.0, "fy": 2.0, "cx": 3.0,
                 "cy": 4.0, "depth_scale": 5.0, "k1": 0.1}}))
    for mode in ("color", "depth", "camera_extrinsics"):
        assert (tutils.read_timestamp_data(str(seq), mode)
                == jutils.read_timestamp_data(str(seq), mode))
    assert (tutils.load_camera_intrinsics(str(seq), "fr2")
            == jutils.load_camera_intrinsics(str(seq), "fr2"))


# ---------------------------------------------------------------------------
# pacing (the port of tests/test_pacing.py on the port's MappingStage)
# ---------------------------------------------------------------------------

def _paced_stage(mapping_iterations=64, num_keyframes=8):
    """A MappingStage with only the pacing state: no model, no buffer."""
    stage = tstages.MappingStage.__new__(tstages.MappingStage)
    stage.num_inserted = 0
    stage.step_count = 0
    stage.last_received = 0
    stage.stream_active = True
    stage.mapping_iterations = mapping_iterations
    stage.num_keyframes = num_keyframes
    return stage


def _budget_between_packets():
    stage = _paced_stage(64, 8)
    stage.num_inserted = 4
    allowed = 0
    while stage.can_train():  # budget = 64 / 8 = 8 consecutive steps
        stage.step_count += 1
        stage.last_received += 1
        allowed += 1
        assert allowed <= 8
    assert allowed == 8
    stage.last_received = 0  # what update() does on insert
    assert stage.can_train()


def _requires_keyframes():
    stage = _paced_stage()
    assert stage.num_inserted == 0 and not stage.can_train()


def _unlimited_after_stream():
    stage = _paced_stage(16, 8)
    stage.num_inserted = 8
    stage.last_received = 10_000  # far past the between-packet budget
    stage.stream_active = False
    n = 0
    while stage.can_train():
        stage.step_count += 1
        n += 1
    assert n == 16  # train to completion: the remaining budget exactly


def _stops_at_iteration_cap():
    stage = _paced_stage(4, 2)
    stage.num_inserted = 2
    stage.stream_active = False
    n = 0
    while stage.can_train():
        stage.step_count += 1
        n += 1
    assert n == 4 and not stage.can_train()


def _steps_per_frame_majority_online():
    """With the pacing rule and 4 steps a frame, most of the budget runs
    before the stream ends."""
    frames, num_keyframes, iterations, steps_per_frame = 100, 20, 400, 4
    stage = _paced_stage(iterations, num_keyframes)
    online = 0
    for f in range(frames):
        if (f % (frames // num_keyframes) == 0
                and stage.num_inserted < num_keyframes):
            stage.num_inserted += 1
            stage.last_received = 0
        for _ in range(steps_per_frame):
            if not stage.can_train():
                break
            stage.step_count += 1
            stage.last_received += 1
            online += 1
    assert online / iterations >= 0.7, f"{online}/{iterations} online"


PACING = {"budget_between_packets": _budget_between_packets,
          "requires_keyframes": _requires_keyframes,
          "unlimited_after_stream": _unlimited_after_stream,
          "stops_at_iteration_cap": _stops_at_iteration_cap,
          "steps_per_frame_majority_online":
              _steps_per_frame_majority_online}


@pytest.mark.parametrize("case", list(PACING))
def test_pacing(case):
    PACING[case]()


# ---------------------------------------------------------------------------
# the live viewer
# ---------------------------------------------------------------------------

def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=10) as r:
        return r.status, r.headers.get("Content-Type"), r.read()


def _post(port, path, body):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=json.dumps(body).encode(),
                                 method="POST")
    with urllib.request.urlopen(req, timeout=10) as r:
        return r.status


def test_viewer_endpoints():
    v = LiveViewer(port=0)  # an ephemeral port
    port = v.start()
    try:
        code, ctype, body = _get(port, "/")
        assert code == 200 and ctype == "text/html" and b"canvas" in body
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(port, "/render.jpg")  # nothing published yet
        assert e.value.code == 404

        poses = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
        poses[2, 0, 3] = 1.5
        v.publish(b"RGBJPEG", b"DEPTHJPEG", {"step": 7.0, "loss": 0.25},
                  poses)
        code, ctype, body = _get(port, "/render.jpg")
        assert code == 200 and ctype == "image/jpeg" and body == b"RGBJPEG"
        assert _get(port, "/depth.jpg")[2] == b"DEPTHJPEG"
        state = json.loads(_get(port, "/api/state")[2])
        assert state["step"] == 7.0 and state["loss"] == 0.25
        assert state["num_keyframes"] == 3
        assert len(state["poses"]) == 3 and len(state["poses"][0]) == 12
        assert state["poses"][2][3] == 1.5  # keyframe 2's x translation

        # camera mailbox: follow, then orbit after a POST, then follow
        assert v.requested_camera() is None
        c2w = [float(x) for x in np.eye(4)[:3].reshape(-1)]
        c2w[3] = 2.0
        assert _post(port, "/api/camera", {"c2w": c2w}) == 200
        cam = v.requested_camera()
        assert cam.shape == (4, 4) and cam[0, 3] == 2.0 and cam[3, 3] == 1.0
        assert _post(port, "/api/camera", {"follow": True}) == 200
        assert v.requested_camera() is None

        req = urllib.request.Request(f"http://127.0.0.1:{port}/api/camera",
                                     data=b"not json", method="POST")
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=10)
        assert e.value.code == 400
    finally:
        v.stop()


def _tiny_mapping_args(tmp_path, **kw):
    return argparse.Namespace(
        mapping_module="nerfstudio", enhancement_module="depth",
        num_keyframes=4, frame_height=12, frame_width=16,
        mapping_iterations=4, mapping_snapshot_iterations=4,
        rays_per_batch=32, dir_prediction=str(tmp_path),
        mapping_model_overrides=dict(
            log2_hashmap_size=10, max_res=64, proposal_resolutions=[8],
            num_proposal_samples=[8], num_nerf_samples=6,
            proposal_distill_points=64),
        **kw)


def test_mapping_stage_publishes_and_previews(tmp_path, rng):
    """A tiny MappingStage with ``viewer: true`` and preview renders
    publishes JPEGs, honours a requested camera and writes the previews."""
    H, W = 12, 16
    m = tstages.MappingStage(_tiny_mapping_args(
        tmp_path, viewer=True, viewer_port=0, viewer_render_every=2,
        viewer_width=8, preview_iterations=2), device="cpu")
    try:
        port = m.viewer.port
        m.update({
            "camera_intrinsics": torch.tensor([[8.0, 8.0, W / 2, H / 2]] * 2),
            "camera_extrinsics": torch.eye(4).expand(2, 4, 4),
            "frames_color_float": torch.from_numpy(
                rng.uniform(0, 1, (2, H, W, 3)).astype(np.float32)),
            "frames_depth": torch.full((2, H, W), 2.0),
            "frames_normal": torch.tensor([0.0, 0, 1]).expand(2, H, W, 3),
        })
        m.stream_active = False
        m.train_step()
        m.train_step()  # step 2: publish and preview
        code, _, body = _get(port, "/render.jpg")
        assert code == 200 and body[:2] == b"\xff\xd8"  # JPEG magic
        state = json.loads(_get(port, "/api/state")[2])
        assert state["step"] == 2.0 and state["num_keyframes"] == 2
        assert "loss" in state and "psnr" in state
        assert sorted(os.listdir(tmp_path / "previews")) == [
            "depth_000002.png", "rgb_000002.jpg"]
        rgb = cv2.imread(str(tmp_path / "previews" / "rgb_000002.jpg"))
        assert rgb.shape == (H, W, 3)

        c2w = [float(x) for x in np.eye(4)[:3].reshape(-1)]
        assert _post(port, "/api/camera", {"c2w": c2w}) == 200
        m.train_step()
        m.train_step()  # step 4: publish from the requested camera
        assert json.loads(_get(port, "/api/state")[2])["step"] == 4.0
    finally:
        m.viewer.stop()


# ---------------------------------------------------------------------------
# devices and imports
# ---------------------------------------------------------------------------

def test_pick_device():
    """``<stage>_device: N`` names a card; an index at or past the card
    count raises as the JAX stage does, before any model is built."""
    args = argparse.Namespace(mapping_device=64)
    with pytest.raises(ValueError, match="mapping_device=64 but only"):
        tstages._pick_device(args, "mapping", "cpu")
    with pytest.raises(ValueError, match="mapping_device=64 but only"):
        tstages.MappingStage(_tiny_mapping_args(".", mapping_device=64),
                             device="cpu")
    with pytest.raises(ValueError, match="enhancement_device=64 but only"):
        tstages.EnhancementStage(argparse.Namespace(enhancement_device=64),
                                 device="cpu")
    none = argparse.Namespace()
    assert tstages._pick_device(none, "mapping", "cpu") == torch.device("cpu")
    if torch.cuda.device_count() == 0:
        with pytest.raises(ValueError, match="only 0 devices"):
            tstages._pick_device(argparse.Namespace(mapping_device=0),
                                 "mapping", "cpu")


BLOCKED = ("cv2", "yaml", "pandas", "jax", "jaxlib", "flax", "optax",
           "nerf_vo_tpu")
EVALUATION = tuple(f"nerf_vo_tpu_torch.evaluation.{m}" for m in (
    "meshio", "metrics", "lpips", "tsdf", "poisson", "datasets",
    "nerf_renderer", "renderer", "evaluator", "runner"))


def test_runtime_imports_without_host_packages(tmp_path, rng):
    """With cv2, yaml, pandas, JAX and the JAX package unimportable, the
    runtime and evaluation modules import; a dataset loader (ingest or
    evaluation) that must decode, the viewer and the preview renders then
    raise an ImportError that names them."""
    args = _replica(tmp_path, rng)
    code = f"""
import argparse, importlib, sys
for m in {BLOCKED!r}:
    sys.modules[m] = None
for m in ("nerf_vo_tpu_torch.data.utils", "nerf_vo_tpu_torch.data.datasets",
          "nerf_vo_tpu_torch.runtime.viewer",
          "nerf_vo_tpu_torch.runtime.stages",
          "nerf_vo_tpu_torch.runtime.pipeline", "nerf_vo_tpu_torch.run"
          ) + {EVALUATION!r}:
    importlib.import_module(m)
from nerf_vo_tpu_torch.data.datasets import make_dataset
from nerf_vo_tpu_torch.evaluation.datasets import ReplicaDataset
from nerf_vo_tpu_torch.runtime.stages import MappingStage
args = argparse.Namespace(**{vars(args)!r})
try:
    make_dataset("replica", args)
except ImportError as e:
    assert "ReplicaDataset" in str(e), e
else:
    raise AssertionError("the Replica loader decoded without cv2")
try:
    ReplicaDataset(args.dir_dataset, 3, device="cpu")
except ImportError as e:
    assert "ReplicaDataset" in str(e), e
else:
    raise AssertionError("the Replica evaluation dataset decoded without cv2")
for key in ("viewer", "preview_iterations"):
    margs = argparse.Namespace(mapping_module="nerfstudio", **{{key: 1}})
    try:
        MappingStage(margs, device="cpu")
    except ImportError as e:
        assert key in str(e), e
    else:
        raise AssertionError(key + " started without cv2")
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


# ---------------------------------------------------------------------------
# chip_smoke.py runs the replica configuration at full width
# ---------------------------------------------------------------------------

def _jax_stage_defaults():
    """``getattr(args, key, default)`` defaults of the JAX stages, read
    from their source: the values a config that omits a key runs with."""
    tree = ast.parse((REPO / "nerf_vo_tpu/runtime/stages.py").read_text())
    out = {}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                and node.func.id == "getattr" and len(node.args) == 3
                and isinstance(node.args[1], ast.Constant)
                and isinstance(node.args[2], ast.Constant)):
            out.setdefault(node.args[1].value, node.args[2].value)
    return out


def test_chip_smoke_runs_the_replica_config():
    """Every key of phases (b)-(e) equals ``configs/nerf_vo_replica.yaml``
    or, where the file omits it, the JAX stages' default; phases (e) and
    (f) differ from the file only in their listed cuts, and (f) uses
    Replica's camera."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    config = yaml.safe_load((REPO / "configs/nerf_vo_replica.yaml")
                            .read_text())
    defaults = _jax_stage_defaults()
    phases = {**smoke.REPLICA, **smoke.MAPPING, **smoke.PIPELINE}
    for key, value in phases.items():
        want = config[key] if key in config else defaults[key]
        assert value == want, key
    assert set(smoke.PIPELINE_CUTS) == {"mapping_iterations",
                                        "mapping_snapshot_iterations"}
    for key, value in smoke.PIPELINE_CUTS.items():
        assert 0 < value <= 512 < config[key], key
    for key in config:
        assert (key in phases) != (key in smoke.SOURCE_KEYS), key
    assert set(smoke.SOURCE_KEYS) <= set(config)
    # phase (f) cuts only the evaluation frames, at Replica's camera
    assert set(smoke.EVALUATION_CUTS) == {"num_evaluation_frames"}
    assert set(smoke.EVALUATION_CUTS) <= set(smoke.SOURCE_KEYS)
    cut = smoke.EVALUATION_CUTS["num_evaluation_frames"]
    assert 0 < cut < config["num_evaluation_frames"]
    cam = json.loads((REPO / "datasets/replica.json").read_text())["replica"]
    assert smoke.replica_camera() == dict(
        height=cam["h"], width=cam["w"], fx=cam["fx"], fy=cam["fy"],
        cx=cam["cx"], cy=cam["cy"], depth_scale=cam["depth_scale"])
    assert (cam["w"], cam["h"]) == (1200, 680)


# ---------------------------------------------------------------------------
# the pipeline's frame sources
# ---------------------------------------------------------------------------

def _prefetch_threads():
    import threading

    return [t for t in threading.enumerate() if t.name == "frame-prefetch"]


class _Frames:
    """A frame source of ``n`` frames that raises at frame ``fail_at``."""

    def __init__(self, n, fail_at=None):
        self.n, self.fail_at = n, fail_at

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        if i == self.fail_at:
            raise OSError(f"cannot read frame {i}")
        return {"frame_index": i, "last_frame": i == self.n - 1}


def test_threaded_frames_keep_order_and_stop():
    """The prefetch thread hands over every frame in order under frequent
    thread switches, ends at the last frame, raises a read error in the
    consumer and stops when the consumer closes early."""
    from nerf_vo_tpu_torch.runtime import pipeline as tpipeline

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        data = tstages.DataStage(None, _Frames(300))
        got = [f["frame_index"]
               for f in tpipeline._threaded_frames(data, depth=2)]
        assert got == list(range(300))
        serial = tpipeline._serial_frames(tstages.DataStage(None,
                                                            _Frames(300)))
        assert [f["frame_index"] for f in serial] == got

        frames = tpipeline._threaded_frames(
            tstages.DataStage(None, _Frames(300, fail_at=7)), depth=2)
        with pytest.raises(OSError, match="frame 7"):
            for _ in frames:
                pass

        frames = tpipeline._threaded_frames(
            tstages.DataStage(None, _Frames(300)), depth=2)
        assert next(frames)["frame_index"] == 0
        assert _prefetch_threads()
        frames.close()
        assert not _prefetch_threads()
    finally:
        sys.setswitchinterval(interval)


def test_chip_smoke_runs_the_nerf_slam_replica_config():
    """Every key of phase (g) equals ``configs/nerf_slam_replica.yaml`` or,
    where the file omits it, the JAX stages' default; (g) differs from the
    file only in its listed cuts."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    config = yaml.safe_load((REPO / "configs/nerf_slam_replica.yaml")
                            .read_text())
    defaults = _jax_stage_defaults()
    for key, value in smoke.SLAM.items():
        want = config[key] if key in config else defaults[key]
        assert value == want, key
    for key in config:
        assert (key in smoke.SLAM) != (key in smoke.SOURCE_KEYS), key
    assert smoke.SLAM_TRACKING_CUTS == {"motion_threshold": 0.0}
    assert "motion_threshold" not in config
    assert defaults["motion_threshold"] > 0
