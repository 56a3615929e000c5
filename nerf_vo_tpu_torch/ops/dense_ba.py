"""Dense (per-pixel inverse depth) bundle adjustment — DROID-SLAM style.

Counterpart of ``nerf_vo_tpu/ops/dense_ba.py``, which replaces the NeRF-SLAM
fork's CUDA/GTSAM BA stack (``droid_backends.reduced_camera_matrix``, GTSAM
``optimizeDensely``, ``droid_backends.solve_depth``) with damped
Gauss-Newton over the window poses plus per-pixel inverse depths:

  * per-pixel residual jacobians, analytic (``ops.ba._edge_jacobians``
    over the [E * hw] pixels; the JAX module takes them by ``vmap(jacfwd)``),
  * the reduced camera system assembled per edge as 12x12 blocks and
    scattered into the window's pose blocks with ``index_add_``, and the
    per-(frame, pixel) pose-depth coupling ``U`` [N, hw, P*6],
  * a Schur solve on the poses, then depth back-substitution,
  * the marginal depth covariance of the last linearization,
    C^-1 + C^-1 U S^-1 U^T C^-1 (the reference computes the same quantity
    by a dense Cholesky of the reduced camera matrix).

:func:`make_sharded_dense_ba` splits the pixels over a mesh axis (one
all-reduce of the reduced system an iteration). :func:`global_dense_ba` is
the terminate-time solver over every keyframe, with edges grouped by host
frame. Everything runs in full f32 (the port's
float policy keeps TF32 off).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from nerf_vo_tpu_torch.core import lie
from nerf_vo_tpu_torch.ops.ba import _edge_jacobians, project, unproject
from nerf_vo_tpu_torch.parallel import dist as pdist


def pixel_grid(h: int, w: int, device=None) -> torch.Tensor:
    """[h, w, 2] pixel coordinates (x, y)."""
    ys, xs = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=device),
        torch.arange(w, dtype=torch.float32, device=device), indexing="ij")
    return torch.stack([xs, ys], -1)


def dense_reproject(poses, disps, intrinsics, ii, jj):
    """Reproject every pixel of frames ii into frames jj.

    Args:
      poses: [N, 7] w2c SE3; disps: [N, h, w] inverse depth (1/8 res);
      intrinsics: [N, 4] at the same resolution; ii/jj: [E] frame ids.

    Returns (coords [E, h, w, 2], z [E, h, w]).
    """
    N, h, w = disps.shape
    grid = pixel_grid(h, w, disps.device)
    g_ji = lie.se3_mul(poses[jj], lie.se3_inv(poses[ii]))  # [E, 7]
    p_cam = unproject(grid[None], disps[ii], intrinsics[ii][:, None, None, :])
    p_j = lie.se3_act(g_ji[:, None, None, :], p_cam)
    return project(p_j, intrinsics[jj][:, None, None, :])


class DenseBAProblem(NamedTuple):
    poses: torch.Tensor  # [N, 7]
    disps: torch.Tensor  # [N, h, w]
    intrinsics: torch.Tensor  # [N, 4]
    ii: torch.Tensor  # [E]
    jj: torch.Tensor  # [E]
    targets: torch.Tensor  # [E, h, w, 2]
    weights: torch.Tensor  # [E, h, w, 2]
    valid: torch.Tensor  # [E] bool


def _pixel_jacobians(g_i, g_j, k_i, k_j, grid, d, tgt):
    """Residuals and jacobians of every pixel of a batch of edges.

    g_i/g_j [B, 7], k_i/k_j [B, 4], grid [hw, 2], d [B, hw], tgt [B, hw, 2]
    -> r [B, hw, 2], z [B, hw], J_i/J_j [B, hw, 2, 6], J_d [B, hw, 2].
    """
    B, hw = d.shape

    def rows(x):  # per-edge [B, k] -> per-pixel [B * hw, k]
        return x[:, None].expand(B, hw, x.shape[-1]).reshape(B * hw, -1)

    r, z, J_i, J_j, J_d = _edge_jacobians(
        rows(g_i), rows(g_j), rows(k_i), rows(k_j),
        grid[None].expand(B, hw, 2).reshape(B * hw, 2), d.reshape(B * hw),
        tgt.reshape(B * hw, 2))
    return (r.reshape(B, hw, 2), z.reshape(B, hw), J_i.reshape(B, hw, 2, 6),
            J_j.reshape(B, hw, 2, 6), J_d.reshape(B, hw, 2))


def _robust_weights(valid, r, z, wgt):
    """Weights of the pixels that count: a valid edge, in front of the
    target camera, a finite residual under 100 px."""
    ok = (valid[:, None] & (z > 0.1) & torch.isfinite(r).all(-1)
          & (torch.linalg.norm(r, dim=-1) < 100.0))
    return wgt * ok[..., None]


def dense_bundle_adjust(
    problem: DenseBAProblem,
    slot_map,
    *,
    num_iters: int = 2,
    window: int = 12,
    lm_lambda: float = 1e-4,
    ep: float = 0.1,
    eta=None,
    disp_clip: Tuple[float, float] = (1e-3, 10.0),
):
    """Damped Gauss-Newton over window poses + per-pixel inverse depths.

    Args:
      slot_map: [N] window-local pose slot or -1 (fixed).
      eta: optional [N, h, w] per-pixel depth damping (the update net's
        damping head).

    Returns (poses, disps, costs [num_iters], depth covariance [N, h, w];
    1e6 where no valid edge leaves a frame).
    """
    N, h, w = problem.disps.shape
    E = problem.ii.shape[0]
    hw = h * w
    poses, disps, costs, cov = _dense_ba_core(
        problem.poses, problem.disps.reshape(N, hw), problem.intrinsics,
        problem.ii, problem.jj, problem.targets.reshape(E, hw, 2),
        problem.weights.reshape(E, hw, 2), problem.valid,
        pixel_grid(h, w, problem.poses.device).reshape(hw, 2), slot_map,
        eta.reshape(N, hw) if eta is not None else None,
        num_iters=num_iters, window=window, lm_lambda=lm_lambda, ep=ep,
        disp_clip=disp_clip)
    return poses, disps.reshape(N, h, w), costs, cov.reshape(N, h, w)


def _dense_ba_core(poses, disps, intrinsics, ii, jj, tgt, wgt, valid, grid,
                   slot_map, eta, *, num_iters: int, window: int,
                   lm_lambda: float, ep: float,
                   disp_clip: Tuple[float, float], axis=None):
    """The GN iterations over one PIXEL BLOCK: disps [N, hwl], tgt / wgt
    [E, hwl, 2], grid [hwl, 2], eta [N, hwl] or None. With ``axis`` (a
    ``parallel.dist.Axis`` whose ranks each hold one block of the pixels),
    the reduced camera system and the cost are summed over it with one
    all-reduce an iteration; the jacobians, the depth back-substitution and
    the marginal covariance stay per block."""
    N, hwl = disps.shape
    P = window
    dev = poses.device
    kw = dict(device=dev, dtype=poses.dtype)  # buffers follow the inputs
    ii = ii.long()
    jj = jj.long()
    slot_map = slot_map.long()
    li = slot_map[ii]
    lj = slot_map[jj]
    li_s = torch.where(li >= 0, li.clamp(0, P - 1), P)  # trash slot P
    lj_s = torch.where(lj >= 0, lj.clamp(0, P - 1), P)
    edge_valid = valid & (ii != jj)
    k_i = intrinsics[ii]
    k_j = intrinsics[jj]
    touched = torch.zeros(N, **kw).index_add_(
        0, ii, edge_valid.to(poses.dtype)) > 0

    costs = []
    cov = None
    for _ in range(num_iters):
        r, z, J_i, J_j, J_d = _pixel_jacobians(
            poses[ii], poses[jj], k_i, k_j, grid, disps[ii], tgt)
        wm = _robust_weights(edge_valid, r, z, wgt)
        wJ_d = wm * J_d
        sw = torch.sqrt(wm.clamp(min=0.0))  # [E, hwl, 2]
        swJd = sw * J_d

        # per-edge 12x12 blocks, scattered into the window's pose blocks
        Jcat = torch.cat([sw[..., None] * J_i, sw[..., None] * J_j], -1)
        Hb = torch.einsum("ehck,ehcl->ekl", Jcat, Jcat)  # [E, 12, 12]
        vb = torch.einsum("ehck,ehc->ek", Jcat, sw * -r)  # [E, 12]
        Q = P + 1
        B4 = torch.zeros(Q * Q, 6, 6, **kw)
        B4.index_add_(0, li_s * Q + li_s, Hb[:, :6, :6])
        B4.index_add_(0, li_s * Q + lj_s, Hb[:, :6, 6:])
        B4.index_add_(0, lj_s * Q + li_s, Hb[:, 6:, :6])
        B4.index_add_(0, lj_s * Q + lj_s, Hb[:, 6:, 6:])
        B = B4.reshape(Q, Q, 6, 6)[:P, :P].permute(0, 2, 1, 3).reshape(
            P * 6, P * 6)
        v = torch.zeros(Q, 6, **kw)
        v.index_add_(0, li_s, vb[:, :6]).index_add_(0, lj_s, vb[:, 6:])
        v = v[:P].reshape(P * 6)

        # pose-depth coupling per (frame, pixel)
        u12 = torch.einsum("ehck,ehc->ehk", Jcat, swJd)  # [E, hwl, 12]
        U4 = torch.zeros(N * Q, hwl, 6, **kw)
        U4.index_add_(0, ii * Q + li_s, u12[..., :6])
        U4.index_add_(0, ii * Q + lj_s, u12[..., 6:])
        Uf = U4.reshape(N, Q, hwl, 6)[:, :P].permute(0, 2, 1, 3).reshape(
            N * hwl, P * 6)

        # depth terms
        C = torch.zeros(N, hwl, **kw).index_add_(
            0, ii, (wJ_d * J_d).sum(-1))
        w_d = torch.zeros(N, hwl, **kw).index_add_(
            0, ii, (wJ_d * -r).sum(-1))
        damp = lm_lambda * C + 1e-7
        if eta is not None:
            damp = damp + eta
        Cinv = 1.0 / (C + damp)

        # Schur complement + solve
        cf = Cinv.reshape(N * hwl)
        H = B - Uf.T @ (cf[:, None] * Uf)
        rhs = v - Uf.T @ (cf * w_d.reshape(-1))
        cost = torch.sum(wm * r * r)
        if axis is not None and axis.size > 1:
            # the reduced system sums over pixels: one all-reduce of
            # [H, rhs, cost] an iteration
            flat = pdist.all_reduce_sum(
                torch.cat([H.reshape(-1), rhs, cost[None]]), axis)
            H = flat[:H.numel()].reshape(H.shape)
            rhs = flat[H.numel():-1]
            cost = flat[-1]
        H = H + torch.diag(lm_lambda * torch.diagonal(H) + ep)
        dx = torch.linalg.solve_ex(H, rhs)[0].reshape(P, 6)
        dx = torch.where(torch.isfinite(dx), dx, 0.0)

        dz = Cinv * (w_d - (Uf @ dx.reshape(P * 6)).reshape(N, hwl))
        dz = torch.where(touched[:, None] & torch.isfinite(dz), dz, 0.0)

        # marginal depth covariance from this linearization
        Pcov = torch.linalg.inv_ex(H)[0]
        quad = ((Uf @ Pcov) * Uf).sum(-1).reshape(N, hwl)
        cov = torch.where(touched[:, None], Cinv + Cinv * quad * Cinv, 1e6)

        xi_full = torch.where((slot_map >= 0)[:, None],
                              dx[slot_map.clamp(0, P - 1)], 0.0)
        poses = lie.se3_retract(poses, xi_full)
        disps = (disps + dz).clamp(disp_clip[0], disp_clip[1])
        costs.append(cost)
    return poses, disps, torch.stack(costs), cov


def make_sharded_dense_ba(mesh, axis: str = "data", *, num_iters: int = 2,
                          window: int = 12, lm_lambda: float = 1e-4,
                          ep: float = 0.1,
                          disp_clip: Tuple[float, float] = (1e-3, 10.0)):
    """A pixel-sharded dense BA over mesh axis ``axis``.

    Each rank linearizes ``hw / D`` of the pixels (the [E, hw, 2, 6]
    jacobians, the solver's memory and work, shrink 1/D); the (P*6)^2
    reduced camera system and the cost are summed over the axis once per GN
    iteration, so every rank solves the same pose update; depth
    back-substitution and the marginal covariance stay per block, and the
    blocks are gathered at the end. Every rank of the axis calls it with
    the same problem.

    Returns ``step(problem, slot_map, eta=None) -> (poses, disps, costs,
    cov)`` with :func:`dense_bundle_adjust`'s semantics (equal up to f32
    summation order), the full ``disps`` and ``cov`` on every rank.
    """
    ax = pdist.mesh_axis(mesh, axis)

    def step(problem: DenseBAProblem, slot_map, eta=None):
        N, h, w = problem.disps.shape
        E = problem.ii.shape[0]
        hw = h * w
        if hw % ax.size:
            raise ValueError(f"{hw} pixels do not split over {ax.size} "
                             "ranks")
        k = hw // ax.size
        blk = slice(ax.index * k, (ax.index + 1) * k)
        grid = pixel_grid(h, w, problem.poses.device).reshape(hw, 2)
        poses, disps, costs, cov = _dense_ba_core(
            problem.poses, problem.disps.reshape(N, hw)[:, blk],
            problem.intrinsics, problem.ii, problem.jj,
            problem.targets.reshape(E, hw, 2)[:, blk],
            problem.weights.reshape(E, hw, 2)[:, blk], problem.valid,
            grid[blk], slot_map,
            eta.reshape(N, hw)[:, blk] if eta is not None else None,
            num_iters=num_iters, window=window, lm_lambda=lm_lambda, ep=ep,
            disp_clip=disp_clip, axis=ax)
        disps = pdist.all_gather_cat(disps, ax, dim=1)
        cov = pdist.all_gather_cat(cov, ax, dim=1)
        return poses, disps.reshape(N, h, w), costs, cov.reshape(N, h, w)

    return step


def frame_distance(poses, disps, intrinsics, ii, jj, beta: float = 0.3):
    """Mean flow magnitude between frame pairs, mixing full reprojection and
    rotation-only flow (replaces droid_backends.frame_distance)."""
    coords, z = dense_reproject(poses, disps, intrinsics, ii, jj)
    N, h, w = disps.shape
    grid = pixel_grid(h, w, disps.device)
    full = torch.linalg.norm(coords - grid[None], dim=-1)

    # rotation-only: the relative pose without its translation
    g_ji = lie.se3_mul(poses[jj], lie.se3_inv(poses[ii]))
    g_rot = torch.cat([torch.zeros_like(g_ji[..., :3]), g_ji[..., 3:]], -1)
    p_cam = unproject(grid[None], disps[ii], intrinsics[ii][:, None, None, :])
    coords_rot, _ = project(lie.se3_act(g_rot[:, None, None, :], p_cam),
                            intrinsics[jj][:, None, None, :])
    rot = torch.linalg.norm(coords_rot - grid[None], dim=-1)

    ok = (z > 0.1).float()
    count = ok.sum((1, 2)).clamp(min=1.0)
    return (beta * (full * ok).sum((1, 2)) / count
            + (1.0 - beta) * (rot * ok).sum((1, 2)) / count)


# ---------------------------------------------------------------------------
# global (terminate-time) bundle adjustment
# ---------------------------------------------------------------------------

# host rows linearized together: bounds the [rows, ME, hw, 2, 12] jacobians
_ROW_CHUNK = 4


def global_dense_ba(
    poses,
    disps,
    intrinsics,
    host,      # [N] buffer slot of each row's host frame
    jj_g,      # [N, ME] target slots per row (padding: any, masked)
    valid,     # [N, ME] bool
    targets,   # [N, ME, h, w, 2]
    weights,   # [N, ME, h, w, 2] (>= 0)
    slot_map,  # [B] window slot or -1 (fixed gauge poses)
    *,
    num_iters: int = 2,
    P: int,
    lm_lambda: float = 1e-5,
    ep: float = 1e-2,
    eta=None,  # [B, h, w] per-pixel depth damping
    disp_clip: Tuple[float, float] = (1e-3, 10.0),
):
    """Terminate-time global BA over all keyframes (reference backend /
    update_lowmem BA).

    Edges are grouped by host frame (each row holds one host frame's <= ME
    edges): pose blocks land in H [P+1, P+1, 6, 6] by per-edge 6x6 block
    scatters (slot P swallows fixed and padded poses), and the depth Schur
    complement uses each row's compact coupling U_i [hw, (ME+1)*6] (only the
    host and its targets couple to its depths), so the correction of a row
    is a small product scattered into H by its slot list. Rows go
    ``_ROW_CHUNK`` at a time. Returns (poses, disps, costs [num_iters]).
    """
    Bf, h, w = disps.shape
    N, ME = jj_g.shape
    hw = h * w
    dev = poses.device
    Q = P + 1
    grid = pixel_grid(h, w, dev).reshape(hw, 2)
    host = host.long()
    jj_g = jj_g.long()
    slot_map = slot_map.long()
    tgt = targets.reshape(N, ME, hw, 2)
    wgt = weights.reshape(N, ME, hw, 2)
    eta_rows = (eta[host].reshape(N, hw) if eta is not None
                else torch.zeros(N, hw, device=dev))
    sl_i = slot_map[host]
    a_all = torch.where(sl_i >= 0, sl_i, P)  # [N]
    sl_j = slot_map[jj_g]
    bm_all = torch.where((sl_j >= 0) & valid, sl_j, P)  # [N, ME]
    slots_all = torch.cat([a_all[:, None], bm_all], 1)  # [N, ME+1]
    touched = valid.any(1)

    costs = []
    for _ in range(num_iters):
        H = torch.zeros(Q * Q, 6, 6, device=dev)
        v = torch.zeros(Q, 6, device=dev)
        cost = torch.zeros((), device=dev)
        U_all, Cinv_all, wd_all = [], [], []
        for r0 in range(0, N, _ROW_CHUNK):
            rs = slice(r0, r0 + _ROW_CHUNK)
            hs, jjr, valr = host[rs], jj_g[rs], valid[rs]
            n = hs.shape[0]
            g_i = poses[hs][:, None].expand(n, ME, 7).reshape(n * ME, 7)
            k_i = intrinsics[hs][:, None].expand(n, ME, 4).reshape(n * ME, 4)
            d = disps[hs].reshape(n, 1, hw).expand(n, ME, hw)
            r, z, J_i, J_j, J_d = _pixel_jacobians(
                g_i, poses[jjr].reshape(n * ME, 7), k_i,
                intrinsics[jjr].reshape(n * ME, 4), grid,
                d.reshape(n * ME, hw), tgt[rs].reshape(n * ME, hw, 2))
            wm = _robust_weights(valr.reshape(-1), r, z,
                                 wgt[rs].reshape(n * ME, hw, 2))
            sw = torch.sqrt(wm.clamp(min=0.0))
            Gc = torch.cat([sw[..., None] * J_i, sw[..., None] * J_j], -1)
            Bblk = torch.einsum("ehca,ehcb->eab", Gc, Gc).reshape(
                n, ME, 12, 12)
            vblk = torch.einsum("ehca,ehc->ea", Gc, sw * -r).reshape(
                n, ME, 12)

            a = a_all[rs]
            bm = bm_all[rs]
            aa = a[:, None].expand(n, ME)
            H.index_add_(0, a * Q + a, Bblk[:, :, :6, :6].sum(1))
            H.index_add_(0, (aa * Q + bm).reshape(-1),
                         Bblk[:, :, :6, 6:].reshape(-1, 6, 6))
            H.index_add_(0, (bm * Q + aa).reshape(-1),
                         Bblk[:, :, 6:, :6].reshape(-1, 6, 6))
            H.index_add_(0, (bm * Q + bm).reshape(-1),
                         Bblk[:, :, 6:, 6:].reshape(-1, 6, 6))
            v.index_add_(0, a, vblk[:, :, :6].sum(1))
            v.index_add_(0, bm.reshape(-1), vblk[:, :, 6:].reshape(-1, 6))

            # depth terms (a row's edges share its host's depths)
            wJd = (wm * J_d).reshape(n, ME, hw, 2)
            J_dr = J_d.reshape(n, ME, hw, 2)
            C = (wJd * J_dr).sum((1, 3))  # [n, hw]
            w_d = (wJd * -r.reshape(n, ME, hw, 2)).sum((1, 3))
            swJd = (sw * J_d).reshape(n, ME, hw, 2)
            Gr = Gc.reshape(n, ME, hw, 2, 12)
            u_host = torch.einsum("nmhca,nmhc->nha", Gr[..., :6], swJd)
            u_tgt = torch.einsum("nmhca,nmhc->nmha", Gr[..., 6:], swJd)
            Ucomp = torch.cat([u_host[:, :, None], u_tgt.permute(0, 2, 1, 3)],
                              2).reshape(n, hw, (ME + 1) * 6)

            damp = lm_lambda * C + 1e-7 + eta_rows[rs]
            Cinv = 1.0 / (C + damp)
            S = torch.einsum("nha,nhb->nab", Ucomp, Cinv[..., None] * Ucomp)
            rhs_c = torch.einsum("nha,nh->na", Ucomp, Cinv * w_d)
            slots = slots_all[rs]
            Sblk = S.reshape(n, ME + 1, 6, ME + 1, 6).permute(0, 1, 3, 2, 4)
            H.index_add_(0, (slots[:, :, None] * Q
                             + slots[:, None, :]).reshape(-1),
                         -Sblk.reshape(-1, 6, 6))
            v.index_add_(0, slots.reshape(-1), -rhs_c.reshape(-1, 6))
            cost = cost + torch.sum(wm * r * r)
            U_all.append(Ucomp)
            Cinv_all.append(Cinv)
            wd_all.append(w_d)

        Hm = H.reshape(Q, Q, 6, 6)[:P, :P].permute(0, 2, 1, 3).reshape(
            P * 6, P * 6)
        vm = v[:P].reshape(P * 6)
        Hm = Hm + torch.diag(lm_lambda * torch.diagonal(Hm) + ep)
        dx = torch.linalg.solve_ex(Hm, vm)[0].reshape(P, 6)
        dx = torch.where(torch.isfinite(dx), dx, 0.0)

        # depth back-substitution per host row
        dx_pad = torch.cat([dx, dx.new_zeros(1, 6)])  # trash slot P
        dxr = dx_pad[slots_all].reshape(N, (ME + 1) * 6)
        dz = torch.cat(Cinv_all) * (
            torch.cat(wd_all)
            - torch.einsum("nha,na->nh", torch.cat(U_all), dxr))
        dz = torch.where(touched[:, None] & torch.isfinite(dz), dz, 0.0)
        disps = disps.index_add(0, host, dz.reshape(N, h, w)).clamp(
            disp_clip[0], disp_clip[1])

        xi_full = torch.where((slot_map >= 0)[:, None],
                              dx[slot_map.clamp(0, P - 1)], 0.0)
        poses = lie.se3_retract(poses, xi_full)
        costs.append(cost)
    return poses, disps, torch.stack(costs)
