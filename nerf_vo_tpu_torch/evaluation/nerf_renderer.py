"""NeRF render adapter for evaluation.

The port's counterpart of ``nerf_vo_tpu/evaluation/nerf_renderer.py``,
which replaces the reference's ``NeRFRenderer`` hierarchy
(evaluation/nerf_renderer.py:35-344): frame rendering at arbitrary poses,
optimized keyframe extrinsics, and density-field meshing, over either a
live MappingStage or a saved snapshot. Everything runs on the mapping
stage's device.

Frame conventions: all public methods speak the PREDICTION frame — OpenCV
cam2world in the tracker's world (the convention of
``matrices_origin2frame_keyframes_tracking.json``). Internally poses map
into the mapper's gauge-normalized OpenGL world via the keyframe buffer's
normalization matrix + the basis flip (core/conventions.py), composing the
camera-optimizer SE3 deltas like the reference does
(evaluation/nerf_renderer.py:109-123).
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch

from nerf_vo_tpu_torch.core import conventions


class MapRenderer:
    def __init__(self, mapping_stage):
        self.mapping = mapping_stage
        self.trainer = mapping_stage.trainer
        self.buffer = mapping_stage.buffer
        self.device = mapping_stage.device
        self._norm = self.buffer.normalization.cpu().numpy()
        self._norm_inv = np.linalg.inv(self._norm)

    # -- pose plumbing ---------------------------------------------------

    def _pred_cv_to_map_gl(self, c2w_cv: np.ndarray) -> np.ndarray:
        gl = conventions.opencv_to_opengl(
            torch.as_tensor(np.asarray(c2w_cv, np.float32))).numpy()
        return self._norm @ gl

    def _map_gl_to_pred_cv(self, c2w_gl: np.ndarray) -> np.ndarray:
        cv = self._norm_inv @ c2w_gl
        return conventions.opengl_to_opencv(
            torch.as_tensor(np.asarray(cv, np.float32))).numpy()

    def _optimized_c2w(self, frame_index: int) -> np.ndarray:
        return self.trainer.optimized_c2w(
            self.mapping.state, self.buffer)[frame_index].cpu().numpy()

    def get_camera_extrinsics(self, frame_index: int) -> np.ndarray:
        """Optimized keyframe pose in the prediction frame (OpenCV c2w)."""
        return self._map_gl_to_pred_cv(self._optimized_c2w(frame_index))

    # -- rendering -------------------------------------------------------

    def _render(self, camera_intrinsics: Dict, c2w_gl: np.ndarray):
        intr = np.asarray(
            [camera_intrinsics["fx"], camera_intrinsics["fy"],
             camera_intrinsics["cx"], camera_intrinsics["cy"]], np.float32,
        )
        return self.trainer.render_image(
            self.mapping.state, np.asarray(c2w_gl, np.float32), intr,
            camera_intrinsics["height"], camera_intrinsics["width"],
        )

    def render_frame(self, camera_intrinsics: Dict,
                     camera_extrinsics: np.ndarray):
        """(color uint8 [H, W, 3], z-depth f32 [H, W]) at a pred-frame pose."""
        gl = self._pred_cv_to_map_gl(camera_extrinsics)
        out = self._render(camera_intrinsics, gl)
        color = np.asarray(
            np.clip(out["rgb"].cpu().numpy() * 255.0, 0, 255), np.uint8
        )
        return color, out["depth"].cpu().numpy()

    def render_frame_depth_from_training_frame(self, camera_intrinsics: Dict,
                                               frame_index: int) -> np.ndarray:
        """Depth render at an optimized TRAINING pose (reference
        renderer.py:79-111 uses these for the pred->GT scale)."""
        out = self._render(camera_intrinsics, self._optimized_c2w(frame_index))
        return out["depth"].cpu().numpy()

    # -- meshing ---------------------------------------------------------

    @torch.no_grad()
    def density_grid(self, resolution, lower_bound, upper_bound,
                     chunk: int = 1 << 18) -> np.ndarray:
        """The field's density at a ``resolution`` lattice spanning a
        pred-frame AABB, evaluated on the stage's device ``chunk`` points
        at a time. Grid points map through the same pose plumbing."""
        res = np.clip(np.asarray(resolution, int), 8, 512)
        lo = np.asarray(lower_bound, np.float32)
        hi = np.asarray(upper_bound, np.float32)
        xs = [np.linspace(lo[d], hi[d], int(res[d])) for d in range(3)]
        grid = np.stack(np.meshgrid(*xs, indexing="ij"), -1).reshape(-1, 3)
        # pred(OpenCV world) -> map world: same world-frame transform as
        # poses; points transform by N directly (flip is camera-basis only)
        gridh = np.concatenate([grid, np.ones((len(grid), 1))], -1)
        grid_map = torch.as_tensor(
            (self._norm @ gridh.T).T[:, :3].astype(np.float32),
            device=self.device)
        field = self.mapping.model.field
        out = [field.density(grid_map[i:i + chunk])[0]
               for i in range(0, len(grid_map), chunk)]
        return torch.cat(out).cpu().numpy().reshape(tuple(int(r) for r in res))

    def render_mesh(self, file_mesh: str, resolution, lower_bound,
                    upper_bound, density_threshold: float = 15.0,
                    chunk: int = 1 << 18) -> None:
        """Isosurface of the density field over a pred-frame AABB
        (replaces marching-cubes mesh export, nerf_renderer.py:170-209).
        """
        from nerf_vo_tpu_torch.evaluation import meshio, tsdf

        res = np.clip(np.asarray(resolution, int), 8, 512)
        lo = np.asarray(lower_bound, np.float32)
        hi = np.asarray(upper_bound, np.float32)
        density = self.density_grid(res, lo, hi, chunk)
        sdf = density_threshold - density  # negative inside
        verts, faces, _ = tsdf.extract_mesh(
            np.clip(sdf / max(density_threshold, 1e-3), -1, 1), None,
            lo, 1.0, None,
        )
        if len(verts):
            # extraction assumed unit voxels at `lo`; rescale per-axis
            scale = (hi - lo) / np.maximum(res - 1, 1)
            verts = (verts - lo) * scale + lo
        meshio.write_ply(file_mesh, verts, faces)


def load_snapshot_renderer(dir_prediction: str, mapping_stage):
    """Rebuild a MapRenderer from the newest ``snapshots/snapshot*.pt``
    (reference eval_load_checkpoint path, nerf_renderer.py:211-218),
    restored into ``mapping_stage``."""
    snaps = sorted(
        os.path.join(dir_prediction, "snapshots", f)
        for f in os.listdir(os.path.join(dir_prediction, "snapshots"))
        if f.startswith("snapshot")
    )
    mapping_stage.restore_snapshot(snaps[-1])
    return MapRenderer(mapping_stage)
