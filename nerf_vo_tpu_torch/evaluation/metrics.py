"""Evaluation metrics: trajectory (ATE), 2D (PSNR/MSSIM/depth), 3D (mesh F1).

Behavior-parity rewrite of the reference's evaluation stack
(evaluation/evaluation_utils.py:230-512, evaluation/evaluator.py:55-174):
sim(3) Kabsch–Umeyama trajectory alignment, per-channel PSNR, a hand-rolled
gaussian MSSIM, masked scale-matched depth metrics, ICP point-cloud
alignment, and accuracy/completion/precision/recall/F1 mesh metrics at 5 cm.

Replacements for unavailable native deps:
  * open3d point-cloud ops -> numpy + scipy cKDTree (ICP, NN distances).
  * lpips(alex) -> gated: returns None unless AlexNet-LPIPS weights are
    provided (zero-egress environment; see lpips_distance docstring).

The port's own copy of ``nerf_vo_tpu/evaluation/metrics.py``. Nearest
neighbours go through ``cKDTree`` only: the JAX package's native C++ hash
grid is not copied (``tests/test_native.py`` holds the two equal there).
ICP bounds its neighbour search by the correspondence distance, which
changes no result and spares the search of points that have none.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
from scipy.spatial import cKDTree


# ---------------------------------------------------------------------------
# trajectory
# ---------------------------------------------------------------------------


def kabsch_umeyama(target: np.ndarray, source: np.ndarray,
                   with_scale: bool = True) -> Tuple[np.ndarray, float, np.ndarray]:
    """Similarity transform (R, c, t) minimizing ||target - (c R source + t)||.

    Reference: evaluation/evaluation_utils.py:230-252. Points are [N, 3].
    """
    assert target.shape == source.shape
    n = target.shape[0]
    mu_t = target.mean(axis=0)
    mu_s = source.mean(axis=0)
    var_s = np.mean(np.sum((source - mu_s) ** 2, axis=1))
    cov = (target - mu_t).T @ (source - mu_s) / n
    U, d, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    c = float(np.trace(np.diag(d) @ S) / var_s) if with_scale else 1.0
    t = mu_t - c * R @ mu_s
    return R, c, t


def absolute_trajectory_error(gt_positions: np.ndarray,
                              pred_positions: np.ndarray,
                              align_scale: bool = True) -> Dict[str, float]:
    """Sim(3)-aligned ATE statistics (reference evaluation_utils.py:255-286)."""
    R, c, t = kabsch_umeyama(gt_positions, pred_positions, with_scale=align_scale)
    aligned = (c * (R @ pred_positions.T)).T + t
    err = np.linalg.norm(gt_positions - aligned, axis=1)
    return {
        "ate_rmse": float(np.sqrt(np.mean(err**2))),
        "ate_mean": float(np.mean(err)),
        "ate_median": float(np.median(err)),
        "ate_std": float(np.std(err)),
        "ate_max": float(np.max(err)),
        "ate_min": float(np.min(err)),
        "scale": float(c),
    }


# ---------------------------------------------------------------------------
# 2D image metrics
# ---------------------------------------------------------------------------


def psnr(pred: np.ndarray, target: np.ndarray, max_value: float = 1.0) -> float:
    """Mean per-channel PSNR (reference evaluation_utils.py:289-318)."""
    pred = pred.astype(np.float64)
    target = target.astype(np.float64)
    vals = []
    for ch in range(pred.shape[-1]):
        mse = np.mean((pred[..., ch] - target[..., ch]) ** 2)
        vals.append(
            10.0 * np.log10(max_value**2 / mse) if mse > 0 else np.inf
        )
    return float(np.mean(vals))


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size) - size // 2
    g = np.exp(-(x**2) / (2 * sigma**2))
    k = np.outer(g, g)
    return k / k.sum()


def _filter2d(img: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """'valid' 2D correlation via FFT-free sliding windows."""
    from numpy.lib.stride_tricks import sliding_window_view

    win = sliding_window_view(img, kernel.shape, axis=(0, 1))
    return np.einsum("hwij,ij->hw", win, kernel)


def mssim(pred: np.ndarray, target: np.ndarray, max_value: float = 1.0) -> float:
    """Mean SSIM with an 11x11 gaussian window, averaged over channels
    (hand-rolled like the reference, evaluation_utils.py:322-377)."""
    k = _gaussian_kernel()
    c1 = (0.01 * max_value) ** 2
    c2 = (0.03 * max_value) ** 2
    pred = pred.astype(np.float64)
    target = target.astype(np.float64)
    if pred.ndim == 2:
        pred = pred[..., None]
        target = target[..., None]
    vals = []
    for ch in range(pred.shape[-1]):
        x, y = pred[..., ch], target[..., ch]
        mu_x = _filter2d(x, k)
        mu_y = _filter2d(y, k)
        sigma_x = _filter2d(x * x, k) - mu_x**2
        sigma_y = _filter2d(y * y, k) - mu_y**2
        sigma_xy = _filter2d(x * y, k) - mu_x * mu_y
        ssim_map = ((2 * mu_x * mu_y + c1) * (2 * sigma_xy + c2)) / (
            (mu_x**2 + mu_y**2 + c1) * (sigma_x + sigma_y + c2)
        )
        vals.append(np.mean(ssim_map))
    return float(np.mean(vals))


def depth_metrics(pred: np.ndarray, target: np.ndarray,
                  max_depth: float = 5.0,
                  scale_match: bool = True) -> Dict[str, float]:
    """Masked (0 < d < max_depth) depth metrics with optional mean-ratio scale
    correction (reference evaluation_utils.py:380-415)."""
    mask = (target > 0) & (target < max_depth)
    p = pred[mask].astype(np.float64)
    t = target[mask].astype(np.float64)
    if p.size == 0:
        return {k: float("nan") for k in (
            "depth_abs_rel", "depth_abs_diff", "depth_sq_rel", "depth_rmse",
            "depth_rmse_log", "depth_delta_1", "depth_delta_2", "depth_delta_3",
        )}
    if scale_match:
        p = p * np.mean(t) / max(np.mean(p), 1e-8)
    p = np.clip(p, 1e-6, None)
    thresh = np.maximum(t / p, p / t)
    return {
        "depth_abs_rel": float(np.mean(np.abs(p - t) / t)),
        "depth_abs_diff": float(np.mean(np.abs(p - t))),
        "depth_sq_rel": float(np.mean((p - t) ** 2 / t)),
        "depth_rmse": float(np.sqrt(np.mean((p - t) ** 2))),
        "depth_rmse_log": float(np.sqrt(np.mean((np.log(p) - np.log(t)) ** 2))),
        "depth_delta_1": float(np.mean(thresh < 1.25)),
        "depth_delta_2": float(np.mean(thresh < 1.25**2)),
        "depth_delta_3": float(np.mean(thresh < 1.25**3)),
    }


def lpips_distance(pred: np.ndarray, target: np.ndarray,
                   weights_path: Optional[str] = None,
                   device="cuda") -> Optional[float]:
    """LPIPS(alex) perceptual distance.

    The reference uses the ``lpips`` package with pretrained AlexNet
    (evaluation/evaluation_utils.py:418-444). The metric is fully
    implemented in PyTorch (evaluation/lpips.py: AlexNet trunk, scaling
    layer, unit-normalized features, learned 1x1 heads); only the pretrained
    weights are unavailable in this zero-egress environment. Pass
    ``weights_path`` (torch state dict — the lpips package's combined dump
    or torchvision alexnet + lin heads both convert) or set
    ``NERF_VO_LPIPS_WEIGHTS``; otherwise returns None and the evaluator
    reports the metric as missing rather than wrong. The network runs on
    ``device``.
    """
    import os

    weights_path = weights_path or os.environ.get("NERF_VO_LPIPS_WEIGHTS")
    if not weights_path or not os.path.exists(weights_path):
        return None
    from nerf_vo_tpu_torch.evaluation.lpips import lpips_from_file

    return lpips_from_file(pred, target, weights_path, device)


# ---------------------------------------------------------------------------
# 3D / point-cloud metrics
# ---------------------------------------------------------------------------


def icp_align(source: np.ndarray, target: np.ndarray,
              max_correspondence: float = 0.1, iterations: int = 20
              ) -> np.ndarray:
    """Point-to-point ICP returning a 4x4 transform source->target
    (replaces open3d ICP, reference evaluation_utils.py:447-463)."""
    T = np.eye(4)
    src = source.copy()
    tree = cKDTree(target)
    for _ in range(iterations):
        # bounded: a point with no neighbour within max_correspondence is
        # dropped either way, and the search prunes it ~50x faster
        dist, idx = tree.query(src, k=1,
                               distance_upper_bound=max_correspondence)
        keep = dist < max_correspondence
        if keep.sum() < 10:
            break
        R, _, t = kabsch_umeyama(target[idx[keep]], src[keep], with_scale=False)
        src = (R @ src.T).T + t
        delta = np.eye(4)
        delta[:3, :3] = R
        delta[:3, 3] = t
        T = delta @ T
        if np.linalg.norm(t) < 1e-7 and np.allclose(R, np.eye(3), atol=1e-7):
            break
    return T


def _nn_dist(ref: np.ndarray, query: np.ndarray) -> np.ndarray:
    """NN distances query->ref."""
    d, _ = cKDTree(ref).query(query, k=1)
    return d


def mesh_3d_metrics(pred_points: np.ndarray, gt_points: np.ndarray,
                    threshold: float = 0.05,
                    refine_icp: bool = True) -> Dict[str, float]:
    """Accuracy/completion/precision/recall/F1 on sampled point clouds
    (reference evaluation_utils.py:466-512; threshold 5 cm)."""
    if refine_icp:
        T = icp_align(pred_points, gt_points)
        pred_points = (T[:3, :3] @ pred_points.T).T + T[:3, 3]
    d_pred_to_gt = _nn_dist(gt_points, pred_points)
    d_gt_to_pred = _nn_dist(pred_points, gt_points)
    precision = float(np.mean(d_pred_to_gt < threshold))
    recall = float(np.mean(d_gt_to_pred < threshold))
    f1 = (
        2 * precision * recall / (precision + recall)
        if precision + recall > 0
        else 0.0
    )
    return {
        "mesh_accuracy": float(np.mean(d_pred_to_gt)),
        "mesh_completion": float(np.mean(d_gt_to_pred)),
        "mesh_precision": precision,
        "mesh_recall": recall,
        "mesh_f1": f1,
    }
