"""Supervision losses for the NeRF mapper.

Counterpart of ``nerf_vo_tpu/ops/losses.py``: RGB MSE, the DS-NeRF depth
log-likelihood, the monosdf normal loss, the NGP path's covariance-weighted
L2 depth loss, the orientation / predicted-normal regularizers, and the
SDF mapper's photometric L1, eikonal and curvature terms.
"""

from __future__ import annotations

import torch

EPS = 1e-7


def rgb_loss(pred, target):
    return torch.mean((pred - target) ** 2)


def ds_nerf_depth_loss(weights, t_mid, deltas, target_depth, sigma: float,
                       mask=None):
    """DS-NeRF depth loss: -log likelihood of termination at the target depth.

    L = -mean log( sum_i w_i * N(t_i; d, sigma^2) * delta_i ) over valid rays.

    Args:
      weights: [R, S] rendering weights.
      t_mid: [R, S] metric sample midpoints.
      deltas: [R, S] interval lengths.
      target_depth: [R] or [R, 1] euclidean ray distance.
      mask: optional [R] validity mask (combined with depth > 0).
    """
    d = target_depth.reshape(-1, 1)
    ll = torch.exp(-((t_mid - d) ** 2) / (2.0 * sigma**2)) * deltas
    loss = -torch.log(torch.sum(weights * ll, dim=-1) + EPS)
    valid = (d[:, 0] > 0).to(loss.dtype)
    if mask is not None:
        valid = mask.to(loss.dtype) * valid
    return torch.sum(loss * valid) / torch.sum(valid).clamp(min=1.0)


def depth_l2_loss(pred_depth, target_depth, depth_cov=None, mask=None):
    """L2 depth loss with optional covariance weighting (the NGP path)."""
    err = (pred_depth - target_depth) ** 2
    if depth_cov is not None:
        err = err / depth_cov.clamp(min=1e-6)
    valid = (target_depth > 0).to(err.dtype)
    if mask is not None:
        valid = mask.to(err.dtype) * valid
    return torch.sum(err * valid) / torch.sum(valid).clamp(min=1.0)


def monosdf_normal_loss(pred_normal, target_normal, mask=None):
    """L1 + angular consistency between rendered and prior normals."""
    pred = pred_normal / torch.linalg.norm(
        pred_normal, dim=-1, keepdim=True).clamp(min=EPS)
    tgt = target_normal / torch.linalg.norm(
        target_normal, dim=-1, keepdim=True).clamp(min=EPS)
    l1 = torch.sum(torch.abs(pred - tgt), dim=-1)
    cos = torch.abs(1.0 - torch.sum(pred * tgt, dim=-1))
    loss = l1 + cos
    if mask is not None:
        m = mask.to(loss.dtype)
        return torch.sum(loss * m) / torch.sum(m).clamp(min=1.0)
    return torch.mean(loss)


def orientation_loss(weights, sample_normals, view_dirs):
    """Ref-NeRF orientation loss: penalize normals facing away from the
    camera."""
    n_dot_v = torch.sum(sample_normals * view_dirs[..., None, :], dim=-1)
    return torch.mean(torch.sum(weights * n_dot_v.clamp(min=0.0) ** 2,
                                dim=-1))


def pred_normal_loss(weights, pred_normals, grad_normals):
    """Tie predicted normals to density-gradient normals (targets are
    stop-gradient)."""
    sim = 1.0 - torch.sum(pred_normals * grad_normals.detach(), dim=-1)
    return torch.mean(torch.sum(weights * sim, dim=-1))


def rgb_l1_loss(pred, target):
    return torch.mean(torch.abs(pred - target))


def eikonal_loss(gradients):
    """mean (|grad f| - 1)^2 over the samples."""
    return torch.mean((torch.linalg.vector_norm(gradients, dim=-1) - 1.0)
                      ** 2)


def curvature_loss(laplacian):
    """mean |sum of the hessian's diagonal| over the samples."""
    return torch.mean(torch.abs(laplacian))
