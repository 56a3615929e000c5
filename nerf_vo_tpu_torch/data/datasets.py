"""Ingest datasets: Replica, 7-Scenes, ScanNet, TUM-RGBD, ETH3D.

The port's own copy of ``nerf_vo_tpu/data/datasets.py``, a behavior-parity
rewrite of the reference ingest loaders
(nerf_vo/data/{base,replica,seven_scenes,scannet,tum_rgbd,eth3d}_dataset.py):
same file discovery, frame-range slicing, intrinsic scaling, the ScanNet/TUM
10%-pad-resize-crop trick, TUM undistortion and per-sequence fr1/fr2/fr3
intrinsics, and ETH3D timestamp association. Frames are plain host numpy;
the tracker uploads them.

OpenCV is imported only inside the functions that decode, resize or
undistort, so the module imports on a machine without ``cv2``; a loader
that needs it there raises an ``ImportError`` naming the loader.

Frame dict schema (SURVEY.md appendix):
  {frame_index: int, camera_intrinsics: dict, frame_color: np[H,W,3] u8 RGB,
   last_frame: bool}
"""

from __future__ import annotations

import os
from typing import List

import numpy as np

from nerf_vo_tpu_torch.data import utils


def _cv2(loader: str):
    """The ``cv2`` module, for ``loader``'s decoding, resizing and
    undistortion."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError(
            f"{loader} reads its frames with OpenCV, and cv2 is not "
            "installed: hand DataStage an in-memory frame source instead"
        ) from e
    return cv2


class BaseIngestDataset:
    """Sequential RGB frame source with optional full-RAM cache
    (reference nerf_vo/data/base_dataset.py:12-68)."""

    def __init__(self, args) -> None:
        self.args = args
        self.dir_dataset = args.dir_dataset
        self.first_frame_index = args.first_frame_index
        self.last_frame_index = args.last_frame_index
        self.stride = args.frame_stride
        self.height = args.frame_height
        self.width = args.frame_width
        self._load_dataset()
        self.cache = (
            [self._get_frame(i) for i in range(len(self))]
            if getattr(args, "cache_dataset", False)
            else None
        )

    # -- hooks ----------------------------------------------------------

    def _load_dataset(self) -> None:
        last = None if self.last_frame_index == -1 else self.last_frame_index
        self.files_color = self._load_files_color()[
            self.first_frame_index : last : self.stride
        ]
        self.camera_intrinsics = utils.scale_camera_intrinsics(
            self._load_camera_intrinsics(), height=self.height, width=self.width
        )

    def _load_files_color(self) -> List[str]:
        raise NotImplementedError

    def _load_camera_intrinsics(self) -> dict:
        return utils.load_camera_intrinsics(
            dir_dataset=self.dir_dataset, dataset_name=self.args.dataset_name
        )

    # -- access ---------------------------------------------------------

    def _cv2(self):
        return _cv2(type(self).__name__)

    def _read_color(self, path: str) -> np.ndarray:
        cv2 = self._cv2()
        img = cv2.imread(path)
        if img is None:
            raise FileNotFoundError(path)
        return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)

    def _image_shape(self, path: str):
        """(height, width, channels) of the image file at ``path``."""
        return self._cv2().imread(path).shape

    def _get_frame(self, frame_index: int) -> dict:
        frame_color = self._cv2().resize(
            self._read_color(self.files_color[frame_index]),
            (self.width, self.height),
        )
        return {
            "frame_index": frame_index,
            "camera_intrinsics": self.camera_intrinsics,
            "frame_color": frame_color,
            "last_frame": frame_index >= len(self) - 1,
        }

    def __len__(self) -> int:
        return len(self.files_color)

    def __getitem__(self, frame_index: int) -> dict:
        if self.cache is not None:
            return self.cache[frame_index]
        return self._get_frame(frame_index)

    def intrinsics_vector(self) -> np.ndarray:
        ci = self.camera_intrinsics
        return np.asarray([ci["fx"], ci["fy"], ci["cx"], ci["cy"]], np.float32)


class ReplicaDataset(BaseIngestDataset):
    """`<scene>/results/*.jpg` (reference replica_dataset.py)."""

    def _load_files_color(self) -> List[str]:
        d = os.path.join(self.dir_dataset, "results")
        return sorted(
            os.path.join(d, f) for f in os.listdir(d) if f.endswith(".jpg")
        )


class SevenScenesDataset(BaseIngestDataset):
    """`<scene>/seq-01/*.color.png` (reference seven_scenes_dataset.py)."""

    def _load_files_color(self) -> List[str]:
        d = os.path.join(self.dir_dataset, "seq-01")
        return sorted(
            os.path.join(d, f) for f in os.listdir(d) if f.endswith("color.png")
        )


class _PadCropMixin:
    """The reference's 10%-pad-resize-center-crop trick: resize to
    (W+padW, H+padH) then crop the border — slightly zooms in, discarding
    distorted image edges (scannet_dataset.py:55-72, tum_rgbd_dataset.py:98-116)."""

    def _setup_padding(self) -> None:
        self.horizontal_padding = utils.even_padding(self.width)
        self.vertical_padding = utils.even_padding(self.height)

    def _pad_crop_intrinsics(self, ci: dict) -> dict:
        sx = (self.width + self.horizontal_padding) / ci["width"]
        sy = (self.height + self.vertical_padding) / ci["height"]
        out = dict(ci)
        out["width"] = self.width
        out["height"] = self.height
        out["fx"] = ci["fx"] * sx
        out["fy"] = ci["fy"] * sy
        out["cx"] = ci["cx"] * sx - self.horizontal_padding / 2
        out["cy"] = ci["cy"] * sy - self.vertical_padding / 2
        return out

    def _pad_crop_image(self, img: np.ndarray) -> np.ndarray:
        img = self._cv2().resize(
            img,
            (self.width + self.horizontal_padding, self.height + self.vertical_padding),
        )
        vp, hp = self.vertical_padding // 2, self.horizontal_padding // 2
        return img[vp:-vp, hp:-hp]


class ScanNetDataset(_PadCropMixin, BaseIngestDataset):
    """`<scene>/color/*`, intrinsics from intrinsics/intrinsic_color.txt,
    depth_scale 1000 (reference scannet_dataset.py)."""

    def _load_dataset(self) -> None:
        last = None if self.last_frame_index == -1 else self.last_frame_index
        files = self._load_files_color()
        self.files_color = files[self.first_frame_index : last : self.stride]
        self.camera_intrinsics = self._load_camera_intrinsics()

    def _load_files_color(self) -> List[str]:
        d = os.path.join(self.dir_dataset, "color")
        return sorted(
            (os.path.join(d, f) for f in os.listdir(d)),
            key=lambda p: _numeric_key(os.path.basename(p)),
        )

    def _load_camera_intrinsics(self) -> dict:
        h, w, _ = self._image_shape(self.files_color[0])
        with open(
            os.path.join(self.dir_dataset, "intrinsics", "intrinsic_color.txt")
        ) as f:
            K = np.array(list(map(float, f.read().split()))).reshape(4, 4)[:3, :3]
        ci = {
            "height": h,
            "width": w,
            "fx": K[0, 0],
            "fy": K[1, 1],
            "cx": K[0, 2],
            "cy": K[1, 2],
            "depth_scale": 1000.0,
        }
        self._setup_padding()
        return self._pad_crop_intrinsics(ci)

    def _get_frame(self, frame_index: int) -> dict:
        img = self._pad_crop_image(self._read_color(self.files_color[frame_index]))
        return {
            "frame_index": frame_index,
            "camera_intrinsics": self.camera_intrinsics,
            "frame_color": img,
            "last_frame": frame_index >= len(self) - 1,
        }


class _TimestampMixin:
    """Color/depth/groundtruth triple association (TUM + ETH3D loaders,
    reference tum_rgbd_dataset.py:16-45 / eth3d_dataset.py:10-41)."""

    def _associated_color_files(self) -> List[str]:
        color = utils.read_timestamp_data(self.dir_dataset, "color")
        depth = utils.read_timestamp_data(self.dir_dataset, "depth")
        extr = utils.read_timestamp_data(self.dir_dataset, "camera_extrinsics")
        cd = utils.associate_timestamp_data(
            list(color.keys()), list(depth.keys())
        )
        ce = utils.associate_timestamp_data(
            [t for t, _ in cd], list(extr.keys())
        )
        stamps = sorted(t for t, _ in ce)
        return [os.path.join(self.dir_dataset, color[t][0]) for t in stamps]


class TUMRGBDDataset(_TimestampMixin, _PadCropMixin, BaseIngestDataset):
    """TUM-RGBD: timestamp association + undistortion + pad-crop; fr1/fr2/fr3
    intrinsics picked from the sequence directory name
    (reference tum_rgbd_dataset.py)."""

    def _load_dataset(self) -> None:
        last = None if self.last_frame_index == -1 else self.last_frame_index
        self.files_color = self._load_files_color()[
            self.first_frame_index : last : self.stride
        ]
        self.camera_intrinsics = self._load_camera_intrinsics()

    def _load_files_color(self) -> List[str]:
        return self._associated_color_files()

    def _load_camera_intrinsics(self) -> dict:
        seq = os.path.basename(os.path.normpath(self.dir_dataset))
        for tag, short in (
            ("freiburg1", "fr1"),
            ("freiburg2", "fr2"),
            ("freiburg3", "fr3"),
        ):
            if tag in seq:
                name = short
                break
        else:
            raise NotImplementedError(f"unknown TUM sequence family: {seq}")
        ci = utils.load_camera_intrinsics(self.dir_dataset, name)
        self.raw_camera_matrix = np.array(
            [[ci["fx"], 0, ci["cx"]], [0, ci["fy"], ci["cy"]], [0, 0, 1]]
        )
        self.raw_distortion = np.array(
            [ci["k1"], ci["k2"], ci["p1"], ci["p2"], ci["k3"]]
        )
        self._setup_padding()
        out = self._pad_crop_intrinsics(ci)
        return {
            k: v
            for k, v in out.items()
            if k not in ("k1", "k2", "k3", "p1", "p2")
        }

    def _get_frame(self, frame_index: int) -> dict:
        img = self._read_color(self.files_color[frame_index])
        img = self._cv2().undistort(
            img, self.raw_camera_matrix, self.raw_distortion
        )
        img = self._pad_crop_image(img)
        return {
            "frame_index": frame_index,
            "camera_intrinsics": self.camera_intrinsics,
            "frame_color": img,
            "last_frame": frame_index >= len(self) - 1,
        }


class ETH3DDataset(_TimestampMixin, BaseIngestDataset):
    """ETH3D: timestamp association, calibration.txt intrinsics,
    depth_scale 5000 (reference eth3d_dataset.py)."""

    def _load_files_color(self) -> List[str]:
        return self._associated_color_files()

    def _load_camera_intrinsics(self) -> dict:
        h, w, _ = self._image_shape(self.files_color[0])
        with open(os.path.join(self.dir_dataset, "calibration.txt")) as f:
            fx, fy, cx, cy = map(float, f.read().split())
        return {
            "height": h,
            "width": w,
            "fx": fx,
            "fy": fy,
            "cx": cx,
            "cy": cy,
            "depth_scale": 5000.0,
        }


def _numeric_key(name: str):
    stem = os.path.splitext(name)[0]
    try:
        return (0, int(stem))
    except ValueError:
        return (1, stem)


DATASETS = {
    "replica": ReplicaDataset,
    "7-scenes": SevenScenesDataset,
    "scannet": ScanNetDataset,
    "tum-rgbd": TUMRGBDDataset,
    "eth3d": ETH3DDataset,
}


def make_dataset(name: str, args) -> BaseIngestDataset:
    """Factory matching the reference's DataModule dispatch
    (nerf_vo/data/data_module.py:14-25)."""
    if name not in DATASETS:
        raise NotImplementedError(name)
    return DATASETS[name](args)
