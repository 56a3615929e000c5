"""Poisson surface reconstruction from oriented points (regular-grid FFT).

Reference parity surface: the nerfstudio renderer's Poisson mesh export —
``generate_point_cloud`` + Open3D ``create_from_point_cloud_poisson``
(depth 9) with a 10% low-density vertex cull (reference
evaluation/nerf_renderer.py:170-209). This environment has no Open3D, and
an octree Poisson solver is a poor fit for array programming anyway; the
same capability is provided by the classic regular-grid formulation of
Kazhdan et al.'s method:

  1. splat the oriented point normals into a vector field V on a regular
     grid (trilinear, with a small Gaussian smoothing standing in for the
     B-spline kernel),
  2. solve the Poisson equation lap(chi) = div(V) for the indicator
     function chi with one 3D FFT (periodic; a boundary margin keeps the
     wrap-around away from the surface),
  3. extract the isosurface at the density-weighted mean of chi sampled
     at the input points (Kazhdan's iso-level rule) with the in-repo
     marching-tetrahedra extractor (evaluation/tsdf.py),
  4. cull vertices whose splat density falls below the 10% quantile —
     the analog of Open3D's ``remove_vertices_by_mask(densities <
     quantile(densities, 0.1))`` used by the reference.

Pure NumPy: this is eval-side host code. The port's own copy of
``nerf_vo_tpu/evaluation/poisson.py``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def depth_to_points_normals(
    depth: np.ndarray, camera_intrinsics: dict, c2w: np.ndarray,
    stride: int = 1, max_depth: float = 5.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Backproject a rendered z-depth map to world points with normals.

    Normals are estimated from the cross product of the backprojected
    image-space derivatives and oriented toward the camera (the rendered
    surface always faces the eye), matching what the reference gets from
    ``generate_point_cloud``'s rendered normals.
    """
    fx, fy = camera_intrinsics["fx"], camera_intrinsics["fy"]
    cx, cy = camera_intrinsics["cx"], camera_intrinsics["cy"]
    H, W = depth.shape
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float64)
    d = np.stack(
        [(xs - cx) / fx, (ys - cy) / fy, np.ones_like(xs)], -1
    )
    pts_c = d * depth[..., None]
    # world frame (OpenCV convention camera like the rest of eval)
    R, t = c2w[:3, :3], c2w[:3, 3]
    pts_w = pts_c @ R.T + t
    du = np.gradient(pts_w, axis=1)
    dv = np.gradient(pts_w, axis=0)
    nrm = np.cross(du, dv)
    ln = np.linalg.norm(nrm, axis=-1, keepdims=True)
    nrm = nrm / np.clip(ln, 1e-12, None)
    # orient toward the camera center
    view = (t - pts_w)
    flip = np.sum(nrm * view, -1, keepdims=True) < 0
    nrm = np.where(flip, -nrm, nrm)
    valid = (depth > 1e-6) & (depth < max_depth) & (ln[..., 0] > 1e-12)
    valid = valid & np.roll(valid, 1, 0) & np.roll(valid, -1, 0) \
        & np.roll(valid, 1, 1) & np.roll(valid, -1, 1)  # derivative support
    valid[0, :] = valid[-1, :] = False
    valid[:, 0] = valid[:, -1] = False
    sel = valid[::stride, ::stride]
    return (pts_w[::stride, ::stride][sel].astype(np.float32),
            nrm[::stride, ::stride][sel].astype(np.float32))


def _trilinear_splat(values: np.ndarray, coords: np.ndarray, shape) -> None:
    """values: [M, C] added in place into ``out[shape + (C,)]`` at
    fractional grid coords [M, 3] (in-place via np.add.at)."""
    lo = np.floor(coords).astype(np.int64)
    f = coords - lo
    R = np.asarray(shape)
    out = np.zeros(tuple(shape) + (values.shape[1],), np.float32)
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                w = (
                    (f[:, 0] if dx else 1 - f[:, 0])
                    * (f[:, 1] if dy else 1 - f[:, 1])
                    * (f[:, 2] if dz else 1 - f[:, 2])
                )
                ix = np.clip(lo[:, 0] + dx, 0, R[0] - 1)
                iy = np.clip(lo[:, 1] + dy, 0, R[1] - 1)
                iz = np.clip(lo[:, 2] + dz, 0, R[2] - 1)
                np.add.at(out, (ix, iy, iz),
                          values * w[:, None].astype(np.float32))
    return out


def _trilinear_sample(vol: np.ndarray, coords: np.ndarray) -> np.ndarray:
    lo = np.floor(coords).astype(np.int64)
    f = coords - lo
    R = vol.shape
    out = 0.0
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                w = (
                    (f[:, 0] if dx else 1 - f[:, 0])
                    * (f[:, 1] if dy else 1 - f[:, 1])
                    * (f[:, 2] if dz else 1 - f[:, 2])
                )
                ix = np.clip(lo[:, 0] + dx, 0, R[0] - 1)
                iy = np.clip(lo[:, 1] + dy, 0, R[1] - 1)
                iz = np.clip(lo[:, 2] + dz, 0, R[2] - 1)
                out = out + vol[ix, iy, iz] * w
    return out


def poisson_mesh(
    points: np.ndarray, normals: np.ndarray, grid_resolution: int = 256,
    margin: float = 0.10, smooth_sigma: float = 1.5,
    density_quantile: float = 0.10,
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Reconstruct a watertight-ish mesh from oriented points.

    Args:
      points: [M, 3] world-frame surface samples.
      normals: [M, 3] unit outward normals.
      grid_resolution: voxels along the longest AABB axis (the reference's
        Poisson depth-9 octree corresponds to 512; 256 is the practical
        default on this CPU eval path).
      margin: AABB padding fraction (keeps FFT wrap-around off-surface).
      smooth_sigma: Gaussian smoothing of the splatted normal field, in
        voxels (B-spline kernel stand-in).
      density_quantile: cull mesh vertices whose splat density is below
        this quantile of per-vertex densities (reference's 10% cull).

    Returns: (verts [V, 3] world frame, faces [F, 3] or None).
    """
    assert len(points), "empty point cloud"
    lo = points.min(0)
    hi = points.max(0)
    extent = float((hi - lo).max())
    extent = max(extent, 1e-6)
    pad = margin * extent
    lo = lo - pad
    span = extent + 2 * pad
    voxel = span / (grid_resolution - 1)
    Rx = Ry = Rz = int(grid_resolution)
    shape = (Rx, Ry, Rz)

    gc = (points - lo) / voxel
    # indicator gradient points INWARD (from chi=0 outside to chi=1
    # inside), i.e. against the outward normals
    V = _trilinear_splat(-normals, gc, shape)  # [R, R, R, 3]
    W = _trilinear_splat(np.ones((len(points), 1), np.float32), gc, shape)
    W = W[..., 0]

    # frequency-domain: Gaussian-smooth V, divergence, inverse Laplacian
    k = [np.fft.fftfreq(n).astype(np.float32) * 2 * np.pi for n in shape]
    kx = k[0][:, None, None]
    ky = k[1][None, :, None]
    kz = k[2][None, None, :]
    gauss = np.exp(
        -0.5 * smooth_sigma**2 * (kx**2 + ky**2 + kz**2)
    ).astype(np.float32)
    # central-difference operator i*sin(k); matching discrete Laplacian
    # eigenvalues 2cos(k)-2 per axis
    lap = (2 * np.cos(kx) - 2) + (2 * np.cos(ky) - 2) + (2 * np.cos(kz) - 2)
    lap[0, 0, 0] = 1.0
    div_hat = np.zeros(shape, np.complex64)
    for a, ka in enumerate((kx, ky, kz)):
        div_hat += (1j * np.sin(ka)).astype(np.complex64) * np.fft.fftn(
            V[..., a]
        ).astype(np.complex64)
    chi_hat = (div_hat * gauss) / lap
    chi_hat[0, 0, 0] = 0.0
    chi = np.real(np.fft.ifftn(chi_hat)).astype(np.float32)

    # iso level: density-weighted mean of chi at the samples
    iso = float(np.mean(_trilinear_sample(chi, gc)))

    from nerf_vo_tpu_torch.evaluation import tsdf

    # marching tets wants a TSDF-like field: negative inside
    field = np.clip(
        (iso - chi) / (np.abs(chi - iso).max() + 1e-12), -1.0, 1.0
    )
    verts, faces, _ = tsdf.extract_mesh(field, None, np.zeros(3), 1.0, None)
    if not len(verts):
        return verts.astype(np.float32), faces

    # density cull (reference nerf_renderer.py:199-204). The raw splat
    # density is exactly zero off the sample lattice, which makes the
    # quantile degenerate (ties at 0); smooth it with the same Gaussian so
    # it behaves like Open3D's (smooth, positive-near-surface) densities.
    if density_quantile > 0:
        W = np.real(
            np.fft.ifftn(np.fft.fftn(W).astype(np.complex64) * gauss)
        ).astype(np.float32)
        dens = _trilinear_sample(W, verts)
        keep = dens >= np.quantile(dens, density_quantile)
        remap = np.cumsum(keep) - 1
        if faces is not None and len(faces):
            fkeep = keep[faces].all(-1)
            faces = remap[faces[fkeep]].astype(np.int32)
        verts = verts[keep]

    verts = verts * voxel + lo
    return verts.astype(np.float32), faces
