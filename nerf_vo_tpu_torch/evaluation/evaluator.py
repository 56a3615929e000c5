"""Metric computation: trajectory / 2D / 3D CSVs and JSONs.

The port's counterpart of ``nerf_vo_tpu/evaluation/evaluator.py``, a
behavior-parity rewrite of evaluation/evaluator.py (reference): sim(3)
Umeyama-aligned ATE for the tracking and mapping keyframe trajectories
(evaluator.py:55-83 -> metrics_trajectory.csv), per-evaluation-frame depth
metrics + PSNR/MSSIM(/LPIPS gated) (evaluator.py:85-146 -> csv + json), and
point-sampled mesh accuracy/completion/precision/recall/F1 at 5 cm with
voxel downsampling + ICP refinement (evaluator.py:148-174).

The CSVs are written with the standard library's ``csv`` module, not
pandas: the same columns in the same order, floats as ``repr`` writes
them, NaN as an empty field (as ``DataFrame.to_csv`` writes it).
"""

from __future__ import annotations

import csv
import json
import math
import os
import warnings
from typing import Dict, List, Optional

import numpy as np

from nerf_vo_tpu_torch.evaluation import meshio, metrics
from nerf_vo_tpu_torch.evaluation.datasets import (
    EvaluationDataset,
    _cv2,
    make_dataset,
)
from nerf_vo_tpu_torch.evaluation.renderer import Frames


def _write_csv(path: str, rows: List[Dict]) -> None:
    """``rows`` under the first row's keys, NaN as an empty field."""
    def cell(v):
        return "" if isinstance(v, float) and math.isnan(v) else v

    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(list(rows[0]))
        for r in rows:
            w.writerow([cell(v) for v in r.values()])


def metrics_2d_row(index: int, pred_color: np.ndarray,
                   pred_depth: np.ndarray, gt_color: np.ndarray,
                   gt_depth: np.ndarray, device="cuda") -> Dict[str, float]:
    """One evaluation frame's 2D metrics. Colors float in [0, 1], depths
    in metres; LPIPS runs on ``device``."""
    row = {"frame": index}
    row["psnr"] = metrics.psnr(pred_color, gt_color)
    row["mssim"] = metrics.mssim(pred_color, gt_color)
    # Always emit the lpips column (reference CSV schema,
    # evaluation/evaluator.py:128-136): NaN when the pretrained AlexNet
    # weights are unavailable (NERF_VO_LPIPS_WEIGHTS unset) so the gap is
    # an explicit N/A, never a silently absent column.
    lp = metrics.lpips_distance(pred_color, gt_color, device=device)
    row["lpips"] = np.nan if lp is None else lp
    row.update(metrics.depth_metrics(pred_depth, gt_depth))
    return row


class Evaluator:
    def __init__(self, config: dict,
                 dataset: Optional[EvaluationDataset] = None, device="cuda"):
        """``device``: where LPIPS runs, and where the GT mesh is fused
        when ``dataset`` is None and the evaluator loads the one
        ``config`` names."""
        self.config = config
        self.device = device
        self.dir_prediction = config["dir_prediction"]
        self.dir_result = config.get("dir_result", self.dir_prediction)
        os.makedirs(self.dir_result, exist_ok=True)
        if dataset is None:
            dataset = make_dataset(config, device)
        self.dataset = dataset
        with open(self.dir_prediction + "/mapping_keyframe2frame.json") as f:
            self.keyframes = json.load(f)

    # -- trajectory ------------------------------------------------------

    def calculate_metrics_trajectory(self) -> Dict[str, float]:
        kf_frames = [self.keyframes[k] for k in sorted(self.keyframes,
                                                       key=int)]
        gt = np.stack(
            [self.dataset.camera_extrinsics[min(i, self.dataset.num_frames - 1)]
             for i in kf_frames]
        )[:, :3, 3]
        out = {}
        for name in ("keyframes_tracking", "keyframes_mapping"):
            path = (self.dir_prediction
                    + f"/matrices/matrices_origin2frame_{name}.json")
            if not os.path.exists(path):
                continue
            with open(path) as f:
                data = json.load(f)
            mats = (np.asarray(data) if isinstance(data, list)
                    else np.stack([np.asarray(data[k])
                                   for k in sorted(data, key=int)]))
            n = min(len(mats), len(gt))
            m = metrics.absolute_trajectory_error(gt[:n], mats[:n, :3, 3])
            out.update({f"{name}/{k}": v for k, v in m.items()})
        _write_csv(os.path.join(self.dir_result, "metrics_trajectory.csv"),
                   [out])
        return out

    # -- 2D --------------------------------------------------------------

    def _read_frames(self) -> Frames:
        cv2 = _cv2("Evaluator.calculate_metrics_2d")
        folder = self.dir_prediction + "/evaluation_frames"
        out = {}
        for index in self.dataset.evaluation_frames:
            fc = f"{folder}/color/{index:06d}.jpg"
            fd = f"{folder}/depth/{index:06d}.png"
            if not (os.path.exists(fc) and os.path.exists(fd)):
                continue
            out[index] = (cv2.cvtColor(cv2.imread(fc), cv2.COLOR_BGR2RGB),
                          cv2.imread(fd, cv2.IMREAD_ANYDEPTH))
        return out

    def calculate_metrics_2d(self, frames: Optional[Frames] = None
                             ) -> Dict[str, float]:
        """``frames``: the rendered evaluation frames as arrays (see
        ``Renderer.render_frame_arrays``); read from the files otherwise."""
        if frames is None:
            frames = self._read_frames()
        scale = self.dataset.camera_intrinsics["depth_scale"]
        rows = []
        for index in self.dataset.evaluation_frames:
            if index not in frames:
                continue
            color, depth = frames[index]
            rows.append(metrics_2d_row(
                index,
                color.astype(np.float64) / 255.0,
                depth.astype(np.float64) / scale,
                self.dataset._load_frame_color(index).astype(np.float64)
                / 255.0,
                self.dataset._load_frame_depth(index),
                device=self.device,
            ))
        if not rows:
            return {}
        _write_csv(os.path.join(self.dir_result, "metrics_2d_frames.csv"),
                   rows)
        with np.errstate(all="ignore"), warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)  # all-NaN mean
            agg = {}
            for k in rows[0]:
                if k == "frame":
                    continue
                col = np.asarray([r[k] for r in rows], np.float64)
                agg[k] = float(np.nanmean(
                    np.where(np.isinf(col), np.nan, col)))
        _write_csv(os.path.join(self.dir_result, "metrics_2d.csv"), [agg])
        # JSON: NaN is not valid JSON — emit null for unavailable metrics
        # (e.g. lpips without NERF_VO_LPIPS_WEIGHTS).
        agg_json = {k: (None if np.isnan(v) else v) for k, v in agg.items()}
        with open(os.path.join(self.dir_result, "metrics_2d.json"), "w") as f:
            json.dump(agg_json, f)
        return agg

    # -- 3D --------------------------------------------------------------

    def calculate_metrics_3d(self, n_points: int = 200_000,
                             threshold: float = 0.05
                             ) -> Optional[Dict[str, float]]:
        pred_path = None
        for cand in ("mesh_from_nerf.ply", "mesh_from_evaluation_frames.ply"):
            p = self.dir_prediction + f"/mesh/{cand}"
            if os.path.exists(p):
                pred_path = p
                break
        if pred_path is None:
            return None
        (gt_verts, gt_faces), _ = self.dataset.mesh()
        pv, pf = meshio.read_ply(pred_path)
        if len(pv) == 0:
            return None
        pred_pts = meshio.sample_mesh_points(pv, pf, n_points)
        gt_pts = meshio.sample_mesh_points(gt_verts, gt_faces, n_points)
        pred_pts = meshio.voxel_downsample(pred_pts, 1.0 / 64.0)
        gt_pts = meshio.voxel_downsample(gt_pts, 1.0 / 64.0)
        out = metrics.mesh_3d_metrics(pred_pts, gt_pts, threshold=threshold)
        _write_csv(os.path.join(self.dir_result, "metrics_3d.csv"), [out])
        return out
