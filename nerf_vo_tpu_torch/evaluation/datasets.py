"""Evaluation datasets: ingest + GT depth + GT trajectories + GT mesh.

The port's counterpart of ``nerf_vo_tpu/evaluation/datasets.py``, a
behavior-parity rewrite of evaluation/datasets/* (reference): same file
discovery and GT formats — Replica ``traj.txt`` rows of flat 4x4, 7-Scenes
per-frame ``pose.txt`` + 65535-depth invalidation
(seven_scenes_dataset.py:50-56), ScanNet ``pose/*.txt`` with inf-pose SE3
interpolation (evaluation_utils.py:93-157), TUM/ETH3D timestamp association
with quaternion ground truth. GT meshes are TSDF-fused once, on the
dataset's ``device``, and cached as ``<scene>_mesh_fused.ply`` next to the
scene (base_dataset.py:101-111).

OpenCV is imported only where a frame is read or resized, so the module
imports on a machine without ``cv2``; a loader that needs it there raises
an ``ImportError`` naming the loader. A subclass may override the
``_load_*`` hooks to serve frames from memory.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np
import torch

from nerf_vo_tpu_torch.core import lie
from nerf_vo_tpu_torch.data import utils
from nerf_vo_tpu_torch.evaluation import meshio, tsdf


def _cv2(user: str):
    """The ``cv2`` module, for ``user``'s image decoding and encoding."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError(
            f"{user} reads or writes images with OpenCV, and cv2 is not "
            "installed") from e
    return cv2


def _quat_to_matrix(tx, ty, tz, qx, qy, qz, qw):
    g = torch.tensor([tx, ty, tz, qx, qy, qz, qw], dtype=torch.float32)
    return lie.se3_matrix(g).numpy()


class EvaluationDataset:
    def __init__(self, dir_dataset: str, dataset_name: str,
                 num_evaluation_frames: int, frame_height: int = 0,
                 frame_width: int = 0, device="cuda"):
        """``device``: where :meth:`mesh` fuses the GT mesh."""
        self.dir_dataset = dir_dataset
        self.dataset_name = dataset_name
        self.height = frame_height
        self.width = frame_width
        self.device = device
        self._load_dataset()
        step = max(int(self.num_frames / num_evaluation_frames), 1)
        self.evaluation_frames = list(range(0, self.num_frames, step))
        self.num_evaluation_frames = len(self.evaluation_frames)

    # -- hooks ----------------------------------------------------------

    def _load_dataset(self) -> None:
        self.files_color, self.files_depth = self._load_files()
        self.camera_intrinsics = utils.scale_camera_intrinsics(
            self._load_camera_intrinsics(), height=self.height,
            width=self.width,
        )
        self.camera_extrinsics = self._load_camera_extrinsics()
        self.num_frames = len(self.files_color)

    def _image_shape(self) -> Tuple[int, int, int]:
        """Shape of the first color frame as decoded."""
        return _cv2(type(self).__name__).imread(self.files_color[0]).shape

    def _load_camera_intrinsics(self) -> dict:
        if self.height == 0 or self.width == 0:
            self.height, self.width, _ = self._image_shape()
        return utils.load_camera_intrinsics(self.dir_dataset,
                                            self.dataset_name)

    def _load_camera_extrinsics(self) -> List[np.ndarray]:
        raise NotImplementedError

    def _load_files(self) -> Tuple[List[str], List[str]]:
        raise NotImplementedError

    # -- access ---------------------------------------------------------

    def _load_frame_color(self, i: int) -> np.ndarray:
        cv2 = _cv2(type(self).__name__)
        img = cv2.cvtColor(cv2.imread(self.files_color[i]), cv2.COLOR_BGR2RGB)
        return cv2.resize(
            img, (self.camera_intrinsics["width"],
                  self.camera_intrinsics["height"])
        )

    def _read_depth(self, i: int) -> np.ndarray:
        """Raw depth of frame ``i`` as float64, before scaling."""
        cv2 = _cv2(type(self).__name__)
        return cv2.imread(self.files_depth[i], cv2.IMREAD_ANYDEPTH).astype(
            np.float64)

    def _load_frame_depth(self, i: int) -> np.ndarray:
        cv2 = _cv2(type(self).__name__)
        d = self._read_depth(i) / self.camera_intrinsics["depth_scale"]
        return cv2.resize(
            d, (self.camera_intrinsics["width"],
                self.camera_intrinsics["height"]),
            interpolation=cv2.INTER_NEAREST,
        )

    def _indices(self, mode: str, keyframes=None):
        if mode == "evaluation_frames":
            return self.evaluation_frames
        if mode == "keyframes":
            return [int(k) for k in keyframes]
        if mode == "all":
            return range(self.num_frames)
        raise NotImplementedError(mode)

    def frames_color(self, mode="evaluation_frames", keyframes=None):
        return [self._load_frame_color(i)
                for i in self._indices(mode, keyframes)]

    def frames_depth(self, mode="evaluation_frames", keyframes=None):
        return [self._load_frame_depth(i)
                for i in self._indices(mode, keyframes)]

    def mesh(self) -> Tuple[Tuple[np.ndarray, Optional[np.ndarray]], str]:
        """GT mesh via cached TSDF fusion. Returns ((verts, faces), path)."""
        file_mesh = os.path.dirname(self.dir_dataset) + (
            f"/{os.path.basename(self.dir_dataset)}_mesh_fused.ply"
        )
        if not os.path.exists(file_mesh):
            stride = max(1, self.num_frames // 200)  # bound fusion cost
            idx = list(range(0, self.num_frames, stride))
            tsdf.integrate_mesh(
                file_mesh=file_mesh,
                camera_intrinsics=self.camera_intrinsics,
                camera_extrinsics=[self.camera_extrinsics[i] for i in idx],
                frames_color=[self._load_frame_color(i) for i in idx],
                frames_depth=[self._load_frame_depth(i) for i in idx],
                device=self.device,
            )
        return meshio.read_ply(file_mesh), file_mesh


class ReplicaDataset(EvaluationDataset):
    def __init__(self, dir_dataset, num_evaluation_frames,
                 frame_height: int = 0, frame_width: int = 0, device="cuda"):
        super().__init__(dir_dataset, "replica", num_evaluation_frames,
                         frame_height, frame_width, device)

    def _load_camera_extrinsics(self):
        with open(self.dir_dataset + "/traj.txt") as f:
            lines = f.readlines()
        return [np.array(list(map(float, l.split()))).reshape(4, 4)
                for l in lines]

    def _load_files(self):
        d = self.dir_dataset + "/results"
        fc = sorted(os.path.join(d, x) for x in os.listdir(d)
                    if x.endswith(".jpg"))
        fd = sorted(os.path.join(d, x) for x in os.listdir(d)
                    if x.endswith(".png"))
        return fc, fd


class SevenScenesDataset(EvaluationDataset):
    def __init__(self, dir_dataset, num_evaluation_frames,
                 frame_height: int = 0, frame_width: int = 0, device="cuda"):
        super().__init__(dir_dataset, "7-scenes", num_evaluation_frames,
                         frame_height, frame_width, device)

    def _load_camera_intrinsics(self):
        if self.height == 0 or self.width == 0:
            self.height, self.width, _ = self._image_shape()
        return utils.load_camera_intrinsics(self.dir_dataset, "7_scenes")

    def _load_camera_extrinsics(self):
        d = self.dir_dataset + "/seq-01"
        files = sorted(x for x in os.listdir(d) if x.endswith("pose.txt"))
        return [
            np.loadtxt(os.path.join(d, x)).reshape(4, 4) for x in files
        ]

    def _load_files(self):
        d = self.dir_dataset + "/seq-01"
        fc = sorted(os.path.join(d, x) for x in os.listdir(d)
                    if x.endswith("color.png"))
        fd = sorted(os.path.join(d, x) for x in os.listdir(d)
                    if x.endswith("depth.png"))
        return fc, fd

    def _read_depth(self, i):
        d = super()._read_depth(i)
        d[d == 65535] = 0  # invalid sentinel (reference :50-56)
        return d


class ScanNetDataset(EvaluationDataset):
    def __init__(self, dir_dataset, num_evaluation_frames,
                 frame_height: int = 0, frame_width: int = 0, device="cuda"):
        super().__init__(dir_dataset, "scannet", num_evaluation_frames,
                         frame_height, frame_width, device)

    def _load_camera_intrinsics(self):
        h, w, _ = self._image_shape()
        if self.height == 0 or self.width == 0:
            self.height, self.width = h, w
        with open(self.dir_dataset + "/intrinsics/intrinsic_color.txt") as f:
            K = np.array(list(map(float, f.read().split()))).reshape(4, 4)
        return {
            "height": h, "width": w, "fx": K[0, 0], "fy": K[1, 1],
            "cx": K[0, 2], "cy": K[1, 2], "depth_scale": 1000.0,
        }

    def _load_camera_extrinsics(self):
        d = self.dir_dataset + "/pose"
        files = sorted(os.listdir(d), key=lambda p: _num(p))
        mats = [np.loadtxt(os.path.join(d, x)).reshape(4, 4) for x in files]
        return _interpolate_invalid_poses(mats)

    def _load_files(self):
        dc = self.dir_dataset + "/color"
        dd = self.dir_dataset + "/depth"
        fc = sorted((os.path.join(dc, x) for x in os.listdir(dc)),
                    key=lambda p: _num(os.path.basename(p)))
        fd = sorted((os.path.join(dd, x) for x in os.listdir(dd)),
                    key=lambda p: _num(os.path.basename(p)))
        return fc, fd


class _TimestampEvalMixin:
    def _load_files_and_poses(self):
        color = utils.read_timestamp_data(self.dir_dataset, "color")
        depth = utils.read_timestamp_data(self.dir_dataset, "depth")
        extr = utils.read_timestamp_data(self.dir_dataset,
                                         "camera_extrinsics")
        cd = utils.associate_timestamp_data(list(color.keys()),
                                            list(depth.keys()))
        cd_map = dict(cd)
        ce = utils.associate_timestamp_data([t for t, _ in cd],
                                            list(extr.keys()))
        stamps = sorted(t for t, _ in ce)
        ce_map = dict(ce)
        fc, fd, poses = [], [], []
        for t in stamps:
            fc.append(os.path.join(self.dir_dataset, color[t][0]))
            fd.append(os.path.join(self.dir_dataset, depth[cd_map[t]][0]))
            vals = list(map(float, extr[ce_map[t]]))
            poses.append(_quat_to_matrix(*vals))
        self._poses = poses
        return fc, fd

    def _load_camera_extrinsics(self):
        return self._poses

    def _load_files(self):
        return self._load_files_and_poses()


class TUMRGBDDataset(_TimestampEvalMixin, EvaluationDataset):
    def __init__(self, dir_dataset, num_evaluation_frames,
                 frame_height: int = 0, frame_width: int = 0, device="cuda"):
        super().__init__(dir_dataset, "tum-rgbd", num_evaluation_frames,
                         frame_height, frame_width, device)

    def _load_camera_intrinsics(self):
        if self.height == 0 or self.width == 0:
            self.height, self.width, _ = self._image_shape()
        seq = os.path.basename(os.path.normpath(self.dir_dataset))
        for tag, short in (("freiburg1", "fr1"), ("freiburg2", "fr2"),
                           ("freiburg3", "fr3")):
            if tag in seq:
                return utils.load_camera_intrinsics(self.dir_dataset, short)
        raise NotImplementedError(seq)


class ETH3DDataset(_TimestampEvalMixin, EvaluationDataset):
    def __init__(self, dir_dataset, num_evaluation_frames,
                 frame_height: int = 0, frame_width: int = 0, device="cuda"):
        super().__init__(dir_dataset, "eth3d", num_evaluation_frames,
                         frame_height, frame_width, device)

    def _load_camera_intrinsics(self):
        h, w, _ = self._image_shape()
        if self.height == 0 or self.width == 0:
            self.height, self.width = h, w
        with open(self.dir_dataset + "/calibration.txt") as f:
            fx, fy, cx, cy = map(float, f.read().split())
        return {"height": h, "width": w, "fx": fx, "fy": fy, "cx": cx,
                "cy": cy, "depth_scale": 5000.0}


def _num(name: str):
    stem = os.path.splitext(name)[0]
    try:
        return (0, int(stem))
    except ValueError:
        return (1, stem)


def _interpolate_invalid_poses(mats: List[np.ndarray]) -> List[np.ndarray]:
    """SE3-interpolate inf/nan GT poses (ScanNet; reference
    evaluation_utils.py:93-157), in f32 as the JAX package does."""
    valid = [np.isfinite(m).all() for m in mats]
    if all(valid):
        return mats
    idx_valid = [i for i, v in enumerate(valid) if v]
    out = list(mats)
    for i, v in enumerate(valid):
        if v:
            continue
        before = max((j for j in idx_valid if j < i), default=None)
        after = min((j for j in idx_valid if j > i), default=None)
        if before is None and after is None:
            out[i] = np.eye(4)
        elif before is None:
            out[i] = mats[after]
        elif after is None:
            out[i] = mats[before]
        else:
            alpha = (i - before) / (after - before)
            g0 = lie.se3_from_matrix(
                torch.tensor(mats[before], dtype=torch.float32))
            g1 = lie.se3_from_matrix(
                torch.tensor(mats[after], dtype=torch.float32))
            g = lie.se3_interp(g0, g1, torch.tensor(alpha,
                                                    dtype=torch.float32))
            out[i] = lie.se3_matrix(g).numpy().astype(np.float64)
    return out


EVAL_DATASETS = {
    "replica": ReplicaDataset,
    "7-scenes": SevenScenesDataset,
    "scannet": ScanNetDataset,
    "tum-rgbd": TUMRGBDDataset,
    "eth3d": ETH3DDataset,
}


def make_dataset(config: dict, device="cuda") -> EvaluationDataset:
    """The evaluation dataset a run's ``config`` names."""
    cls = EVAL_DATASETS[config["dataset_name"]]
    return cls(
        dir_dataset=config["dir_dataset"],
        num_evaluation_frames=config["num_evaluation_frames"],
        frame_height=config.get("evaluation_frame_height", 0),
        frame_width=config.get("evaluation_frame_width", 0),
        device=device,
    )
