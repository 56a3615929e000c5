"""Prediction renderer: pred->GT alignment, frame/mesh/trajectory artifacts.

The port's counterpart of ``nerf_vo_tpu/evaluation/renderer.py``, a
behavior-parity rewrite of evaluation/renderer.py (reference): computes the
pred->GT similarity (median per-keyframe depth-scale ratio + frame-0 pose
anchor, renderer.py:79-111), renders the evaluation frames at GT poses
mapped into the prediction frame (color jpg + uint16 depth png scaled by
depth_scale, renderer.py:239-263), fuses a mesh from rendered frames or
extracts one from the NeRF with GT-bbox-derived resolution
(renderer.py:126-210), and rescales the keyframe trajectory JSONs
(renderer.py:212-237). The same file names and directory layout.

Rendering is apart from encoding: :meth:`Renderer.render_frame_arrays`
returns the evaluation frames as arrays, :meth:`Renderer.render_frames`
writes them with OpenCV, and the mesh from frames fuses arrays it is
handed without reading files.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Tuple

import numpy as np

from nerf_vo_tpu_torch.evaluation import meshio, tsdf
from nerf_vo_tpu_torch.evaluation.datasets import (
    EvaluationDataset,
    _cv2,
    make_dataset,
)
from nerf_vo_tpu_torch.evaluation.nerf_renderer import MapRenderer

# evaluation frame index -> (color uint8 [H, W, 3] RGB, depth uint16 [H, W]
# in units of 1 / depth_scale metres, GT scale)
Frames = Dict[int, Tuple[np.ndarray, np.ndarray]]


class Renderer:
    def __init__(self, config: dict, dataset: Optional[EvaluationDataset],
                 nerf: MapRenderer):
        self.config = config
        self.dir_prediction = config["dir_prediction"]
        with open(self.dir_prediction + "/mapping_keyframe2frame.json") as f:
            self.keyframes = json.load(f)
        if dataset is None:
            dataset = make_dataset(config, nerf.device)
        self.dataset = dataset
        self.nerf = nerf
        self._calculate_pred2gt_transformation()

    # ------------------------------------------------------------------

    def _calculate_pred2gt_transformation(self) -> None:
        kf_frames = [self.keyframes[k] for k in sorted(
            self.keyframes, key=int)]
        scales = []
        gt_depths = self.dataset.frames_depth(mode="keyframes",
                                              keyframes=kf_frames)
        for index, frame_depth_gt in enumerate(gt_depths):
            frame_depth_pred = self.nerf.render_frame_depth_from_training_frame(
                camera_intrinsics=self.dataset.camera_intrinsics,
                frame_index=index,
            )
            mask = (
                (frame_depth_gt > 0) & (frame_depth_pred > 0)
                & (frame_depth_gt < 5) & (frame_depth_pred < 5)
            )
            if mask.sum() < 100:
                continue
            scales.append(
                frame_depth_gt[mask].mean() / frame_depth_pred[mask].mean()
            )
        scale = float(np.median(scales)) if scales else 1.0

        M_scale = np.diag([scale, scale, scale, 1.0])
        gt0 = self.dataset.camera_extrinsics[0]
        pred0 = self.nerf.get_camera_extrinsics(frame_index=0)
        matrix = gt0 @ np.linalg.inv(pred0)
        matrix_scaled = gt0 @ M_scale @ np.linalg.inv(pred0)
        self.pred2gt_transformation = {
            "scale_pred2gt": scale,
            "matrix_pred2gt": matrix,
            "matrix_pred2gt_scaled": matrix_scaled,
        }

    # ------------------------------------------------------------------

    @staticmethod
    def transform_camera_extrinsics_gt2pred(camera_extrinsics, t):
        out = np.tile(np.eye(4), (camera_extrinsics.shape[0], 1, 1))
        inv_scaled = np.linalg.inv(t["matrix_pred2gt_scaled"])
        inv = np.linalg.inv(t["matrix_pred2gt"])
        out[:, :3, 3] = (inv_scaled @ camera_extrinsics.transpose(1, 2, 0)
                         ).transpose(2, 0, 1)[:, :3, 3]
        out[:, :3, :3] = (inv @ camera_extrinsics.transpose(1, 2, 0)
                          ).transpose(2, 0, 1)[:, :3, :3]
        return out

    def render_frame_arrays(self) -> Frames:
        """The evaluation frames rendered at their GT poses: color and the
        z-depth at GT scale as the files hold them (uint16 of depth x
        scale_pred2gt x depth_scale, clipped)."""
        indices = self.dataset.evaluation_frames
        extr = np.stack([self.dataset.camera_extrinsics[i] for i in indices])
        extr_pred = self.transform_camera_extrinsics_gt2pred(
            extr, self.pred2gt_transformation
        )
        frames = {}
        for index, c2w in zip(indices, extr_pred):
            color, depth = self.nerf.render_frame(
                camera_intrinsics=self.dataset.camera_intrinsics,
                camera_extrinsics=c2w,
            )
            depth_u16 = np.clip(
                depth * self.pred2gt_transformation["scale_pred2gt"]
                * self.dataset.camera_intrinsics["depth_scale"],
                0, 65535,
            ).astype(np.uint16)
            frames[index] = (color, depth_u16)
        return frames

    def render_frames(self, mode: str = "evaluation_frames") -> None:
        """Render the evaluation frames and write them as
        ``<mode>/color/<index>.jpg`` and ``<mode>/depth/<index>.png``."""
        cv2 = _cv2("Renderer.render_frames")
        folder = "evaluation_frames" if mode == "evaluation_frames" else mode
        os.makedirs(self.dir_prediction + f"/{folder}/color", exist_ok=True)
        os.makedirs(self.dir_prediction + f"/{folder}/depth", exist_ok=True)
        for index, (color, depth_u16) in self.render_frame_arrays().items():
            cv2.imwrite(
                self.dir_prediction + f"/{folder}/color/{index:06d}.jpg",
                cv2.cvtColor(color, cv2.COLOR_RGB2BGR),
            )
            cv2.imwrite(
                self.dir_prediction + f"/{folder}/depth/{index:06d}.png",
                depth_u16,
            )

    def render_camera_extrinsics_keyframes(self) -> None:
        path = (self.dir_prediction
                + "/matrices/matrices_origin2frame_keyframes_tracking.json")
        with open(path) as f:
            data = json.load(f)
        if isinstance(data, dict):
            mats = np.stack(
                [np.asarray(data[k]) for k in sorted(data, key=int)]
            )
        else:
            mats = np.asarray(data)
        mats[:, :3, 3] *= self.pred2gt_transformation["scale_pred2gt"]
        with open(path, "w") as f:
            json.dump(mats.tolist(), f)

        mapping = np.stack(
            [self.nerf.get_camera_extrinsics(frame_index=i)
             for i in range(len(self.keyframes))]
        )
        mapping[:, :3, 3] *= self.pred2gt_transformation["scale_pred2gt"]
        with open(
            self.dir_prediction
            + "/matrices/matrices_origin2frame_keyframes_mapping.json", "w",
        ) as f:
            json.dump(mapping.tolist(), f)

    # ------------------------------------------------------------------

    def render_mesh(self, source: str = "frames",
                    mode: str = "evaluation_frames",
                    frames: Optional[Frames] = None) -> None:
        """``frames``: the evaluation frames as arrays, for the mesh from
        frames; read from the files otherwise."""
        os.makedirs(self.dir_prediction + "/mesh", exist_ok=True)
        if source == "frames":
            self._render_mesh_from_frames(mode, frames)
        elif source == "nerf":
            self._render_mesh_from_nerf()
        elif source == "poisson":
            self._render_mesh_from_poisson(mode)
        else:
            raise NotImplementedError(source)

    def _read_frames(self, mode: str) -> Frames:
        """The evaluation frames as written (the JPEG's loss included),
        rendered and written first where they are missing."""
        cv2 = _cv2("Renderer._read_frames")
        folder = "evaluation_frames"
        if not os.path.exists(self.dir_prediction + f"/{folder}/color"):
            self.render_frames(mode=mode)
        out = {}
        for i in self.dataset.evaluation_frames:
            color = cv2.cvtColor(
                cv2.imread(self.dir_prediction
                           + f"/{folder}/color/{i:06d}.jpg"),
                cv2.COLOR_BGR2RGB,
            )
            depth = cv2.imread(
                self.dir_prediction + f"/{folder}/depth/{i:06d}.png",
                cv2.IMREAD_ANYDEPTH)
            out[i] = (color, depth)
        return out

    def _render_mesh_from_frames(self, mode: str,
                                 frames: Optional[Frames] = None) -> None:
        if frames is None:
            frames = self._read_frames(mode)
        indices = self.dataset.evaluation_frames
        extr = np.stack([self.dataset.camera_extrinsics[i] for i in indices])
        scale = self.dataset.camera_intrinsics["depth_scale"]
        tsdf.integrate_mesh(
            file_mesh=self.dir_prediction + f"/mesh/mesh_from_{mode}.ply",
            camera_intrinsics=self.dataset.camera_intrinsics,
            camera_extrinsics=extr,
            frames_color=[frames[i][0] for i in indices],
            frames_depth=[frames[i][1] / scale for i in indices],
            device=self.nerf.device,
        )

    def _render_mesh_from_poisson(self, mode: str) -> None:
        """Poisson reconstruction from the rendered evaluation frames
        (reference nerf_renderer.py:170-209: generate_point_cloud +
        Open3D Poisson depth-9 + 10% density cull — here the FFT
        regular-grid solver, evaluation/poisson.py). Points/normals are
        backprojected from the rendered depths at GT poses, so the mesh
        lands directly in the GT frame like the TSDF path."""
        from nerf_vo_tpu_torch.evaluation import poisson as poisson_mod

        frames = self._read_frames(mode)
        pts_all, nrm_all = [], []
        for i in self.dataset.evaluation_frames:
            depth = frames[i][1].astype(np.float64) / (
                self.dataset.camera_intrinsics["depth_scale"])
            p, n = poisson_mod.depth_to_points_normals(
                depth, self.dataset.camera_intrinsics,
                self.dataset.camera_extrinsics[i], max_depth=5.0,
            )
            pts_all.append(p)
            nrm_all.append(n)
        pts = np.concatenate(pts_all)
        nrm = np.concatenate(nrm_all)
        if not len(pts):
            meshio.write_ply(
                self.dir_prediction + "/mesh/mesh_from_poisson.ply",
                np.zeros((0, 3), np.float32), None,
            )
            return
        # reference samples 200k points for its cloud (evaluator.py:148-174)
        n_max = 200_000
        if len(pts) > n_max:
            sel = np.random.default_rng(42).choice(len(pts), n_max,
                                                   replace=False)
            pts, nrm = pts[sel], nrm[sel]
        verts, faces = poisson_mod.poisson_mesh(
            pts, nrm,
            grid_resolution=int(
                self.config.get("poisson_grid_resolution", 256)
            ),
        )
        meshio.write_ply(
            self.dir_prediction + "/mesh/mesh_from_poisson.ply", verts, faces
        )

    def _render_mesh_from_nerf(self) -> None:
        VOXEL = 1.0 / 64.0
        (gt_verts, _), _ = self.dataset.mesh()
        lo = gt_verts.min(0)
        hi = gt_verts.max(0)
        corners = np.stack(np.meshgrid(*np.stack([lo, hi]).T), -1
                           ).reshape(8, 3)
        cornersh = np.concatenate([corners, np.ones((8, 1))], -1)
        inv = np.linalg.inv(
            self.pred2gt_transformation["matrix_pred2gt_scaled"]
        )
        pred_corners = (inv @ cornersh.T).T[:, :3]
        plo = pred_corners.min(0)
        phi = pred_corners.max(0)
        resolution = (
            (phi - plo) * self.pred2gt_transformation["scale_pred2gt"] / VOXEL
        ).astype(int)
        raw = self.dir_prediction + "/mesh/mesh_from_nerf_raw.ply"
        self.nerf.render_mesh(
            file_mesh=raw, resolution=resolution, lower_bound=plo,
            upper_bound=phi,
        )
        verts, faces = meshio.read_ply(raw)
        T = self.pred2gt_transformation["matrix_pred2gt_scaled"]
        verts = (verts @ T[:3, :3].T + T[:3, 3]).astype(np.float32)
        keep = ((verts >= lo - 1e-6) & (verts <= hi + 1e-6)).all(-1)
        verts, faces = _crop_mesh(verts, faces, keep)
        meshio.write_ply(self.dir_prediction + "/mesh/mesh_from_nerf.ply",
                         verts, faces)


def _crop_mesh(verts, faces, keep):
    remap = np.cumsum(keep) - 1
    if faces is not None and len(faces):
        fkeep = keep[faces].all(-1)
        faces = remap[faces[fkeep]].astype(np.int32)
    return verts[keep], faces
