"""DROID-SLAM-style dense tracking frontend (the "nerf_slam" pipeline).

Counterpart of ``nerf_vo_tpu/tracking/droid_slam.py``, itself the
replacement of the reference's DROIDSLAM class and its CUDA/GTSAM
underpinnings:

  * a motion filter keeping keyframes whose mean predicted flow exceeds a
    threshold (reference has_enough_motion),
  * a keyframe factor graph with neighbourhood + flow-proximity edges
    picked greedily with NMS (add_neighborhood / add_proximity_factors),
  * dense per-pixel correlation pyramids (``ops/dense_corr.py``), built once
    per graph version and reused by every update of that version,
  * ConvGRU update -> flow targets / weights / damping -> dense bundle
    adjustment (``ops/dense_ba.py``) over the frontend window, with the
    inactive-factor store as fixed constraints,
  * learned 8x convex upsampling of inverse depth for emitted keyframes and
    the per-pixel marginal depth covariance from the BA Schur system,
  * global bundle adjustment over all keyframes at the end of the stream
    (two backend passes).

Host bookkeeping (window, edges, keyframe decisions) is numpy, as in the
JAX tracker; the device half is eager PyTorch on ``cuda`` unless the caller
passes ``device="cpu"``. Feature maps are kept channels-last for the
correlation ([B, h, w, C] bf16), context and hidden state NCHW for the
update net.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from nerf_vo_tpu_torch.core import lie
from nerf_vo_tpu_torch.models.droid_net import (
    DroidNet,
    cvx_upsample,
    normalize_images,
)
from nerf_vo_tpu_torch.ops import dense_ba
from nerf_vo_tpu_torch.ops.dense_corr import build_corr_pyramid, corr_lookup


@dataclasses.dataclass(frozen=True)
class DroidConfig:
    """The JAX package's ``DroidConfig``, field for field."""

    buffer_size: int = 512
    motion_threshold: float = 2.4
    keyframe_threshold: float = 4.0
    frontend_window: int = 25
    frontend_radius: int = 2
    frontend_nms: int = 1
    frontend_threshold: float = 16.0
    max_factors: int = 48
    # iters1 updates run with every candidate keyframe; iters2 more only
    # when it is kept (the previous keyframe is removed otherwise)
    iters1: int = 4
    iters2: int = 2
    # inactive-factor store: evicted edges keep their last flow target and
    # weight as fixed BA constraints while both endpoints stay in the
    # window; 0 disables it
    inactive_factors: int = 48
    ba_iters: int = 2
    backend_radius: int = 2
    backend_nms: int = 3
    backend_threshold: float = 22.0
    backend_steps1: int = 7
    backend_steps2: int = 12
    perform_global_ba: bool = True
    compute_covariances: bool = True


def _motion_features(coords, grid, tgt_prev):
    """The update net's flow input: cat(coords - grid, previous target -
    coords) clamped to +-64, as [E, 4, h, w]."""
    flow = torch.cat([coords - grid, tgt_prev - coords], -1).clamp(-64.0, 64.0)
    return flow.permute(0, 3, 1, 2)


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


class DROIDSLAMTracker:
    def __init__(self, config: DroidConfig, net: DroidNet, height: int,
                 width: int, device="cuda", mesh=None):
        """``mesh``: a device mesh whose first axis shards the frontend
        dense BA's pixels (``ops.dense_ba.make_sharded_dense_ba``: one
        all-reduce of the reduced camera system an iteration). Every rank
        then runs the tracker in lockstep on the same frames."""
        if height % 8 or width % 8:
            raise ValueError(f"frame size {height}x{width} is not a multiple "
                             "of 8")
        self.cfg = config
        self.device = dev = torch.device(device)
        self._sharded_ba = None if mesh is None else \
            dense_ba.make_sharded_dense_ba(
                mesh, mesh.mesh_dim_names[0], num_iters=config.ba_iters,
                window=config.frontend_window)
        self.net = net.to(dev).eval().requires_grad_(False)  # inference
        self.H, self.W = height, width
        self.h, self.w = h, w = height // 8, width // 8
        B = config.buffer_size
        E = config.max_factors
        C, D = net.fdim, net.cdim
        bf16 = torch.bfloat16

        self.poses = lie.se3_identity((B,), device=dev)  # w2c
        self.disps = torch.ones(B, h, w, device=dev)
        self.intrinsics8 = torch.ones(B, 4, device=dev)
        self.fmaps = torch.zeros(B, h, w, C, dtype=bf16, device=dev)
        self.inps = torch.zeros(B, D, h, w, dtype=bf16, device=dev)
        self.hidden = torch.zeros(E, D, h, w, device=dev)
        self.e_target = torch.zeros(E, h, w, 2, device=dev)
        self.e_weight = torch.zeros(E, h, w, 2, device=dev)
        EI = max(config.inactive_factors, 1)
        self.i_target = torch.zeros(EI, h, w, 2, device=dev)
        self.i_weight = torch.zeros(EI, h, w, 2, device=dev)
        self.i_ii = np.full(EI, -1, np.int64)
        self.i_jj = np.full(EI, -1, np.int64)
        self.i_valid = np.zeros(EI, bool)
        self.i_ptr = 0
        self.eta = torch.zeros(B, h, w, device=dev)
        self.upmask = torch.zeros(B, 576, h, w, device=dev)
        self.depth_cov = torch.ones(B, h, w, device=dev)
        self.grid = dense_ba.pixel_grid(h, w, dev)[None]  # [1, h, w, 2]

        self.n_kf = 0  # buffer high-water mark (slots ever allocated)
        self.free_slots: List[int] = []  # slots freed by keyframe removal
        self.tstamps: Dict[int, float] = {}
        self.src_index: Dict[int, int] = {}
        self.colors: Dict[int, np.ndarray] = {}
        self.alive: List[int] = []  # keyframe slots in the frontend window
        self.retired: List[int] = []
        self.e_ii = np.full(E, -1, np.int64)
        self.e_jj = np.full(E, -1, np.int64)
        self.e_valid = np.zeros(E, bool)
        self.e_fresh = np.zeros(E, bool)
        # the frontend correlation pyramid depends only on the feature maps
        # and the live edge set, both fixed across the iters1 + iters2
        # updates of one frame: it is built once per graph version
        self._graph_version = 0
        self._pyr_cache = None
        self._pyr_version = -1

    def _ids(self, xs) -> torch.Tensor:
        return torch.as_tensor(np.asarray(xs, np.int64), device=self.device)

    # ------------------------------------------------------------------
    # device halves
    # ------------------------------------------------------------------

    def _encode(self, image):
        """image [H, W, 3] uint8 -> (fmap [h, w, C], inp [D, h, w]), bf16.
        The context net's hidden-state half is not kept: a fresh edge's
        hidden state starts at zero, as in the JAX tracker."""
        x = normalize_images(
            torch.as_tensor(image, device=self.device).float()
            .permute(2, 0, 1)[None])
        fmap = self.net.encode_features(x)[0]
        _, inp = self.net.encode_context(x)
        bf16 = torch.bfloat16
        return fmap.permute(1, 2, 0).to(bf16), inp[0].to(bf16)

    def _motion(self, fmap_new, fmap_last, inp_last) -> float:
        """Mean predicted flow of one identity-initialized edge (reference
        has_enough_motion)."""
        pyr = build_corr_pyramid(fmap_last[None], fmap_new[None], 4)
        coords = self.grid
        corr = corr_lookup(pyr, coords, radius=3)
        net = torch.zeros(1, self.net.cdim, self.h, self.w,
                          device=self.device)
        flow = torch.zeros(1, 4, self.h, self.w, device=self.device)
        _, delta, _, _, _ = self.net.update(
            net, inp_last[None].float(), _nchw(corr), flow)
        return float(torch.linalg.norm(_nhwc(delta), dim=-1).mean())

    def _pair_distance(self, ii, jj) -> np.ndarray:
        return dense_ba.frame_distance(
            self.poses, self.disps, self.intrinsics8, self._ids(ii),
            self._ids(jj)).cpu().numpy()

    def _pyramid(self, ii, jj):
        return build_corr_pyramid(self.fmaps[ii], self.fmaps[jj], 4)

    def _update(self, ii, jj, e_new, e_live, slot_map):
        """One frontend iteration over the edge slots: the GRU on every
        slot, the BA on the live edges plus the inactive store."""
        cfg = self.cfg
        coords, _ = dense_ba.dense_reproject(
            self.poses, self.disps, self.intrinsics8, ii, jj)
        corr = corr_lookup(self._pyr_cache, coords, radius=3)
        new4 = e_new[:, None, None, None]
        live4 = e_live[:, None, None, None]
        tgt_prev = torch.where(new4, coords, self.e_target)
        flow = _motion_features(coords, self.grid, tgt_prev)
        net = torch.where(new4, 0.0, self.hidden)
        inp = self.inps[ii].float()
        net, delta, weight, eta, upmask = self.net.update(
            net, inp, _nchw(corr), flow, ii, self.disps.shape[0])
        target = coords + _nhwc(delta)
        weight = _nhwc(weight) * live4
        self.e_weight = torch.where(live4, weight, self.e_weight)

        ba_ii, ba_jj, ba_t, ba_w, ba_v = ii, jj, target, weight, e_live
        if cfg.inactive_factors:
            i_valid = torch.as_tensor(self.i_valid.copy(), device=self.device)
            ba_ii = torch.cat([ii, self._ids(np.clip(self.i_ii, 0, None))])
            ba_jj = torch.cat([jj, self._ids(np.clip(self.i_jj, 0, None))])
            ba_t = torch.cat([target, self.i_target])
            ba_w = torch.cat([weight,
                              self.i_weight * i_valid[:, None, None, None]])
            ba_v = torch.cat([e_live, i_valid])
        problem = dense_ba.DenseBAProblem(
            poses=self.poses, disps=self.disps, intrinsics=self.intrinsics8,
            ii=ba_ii, jj=ba_jj, targets=ba_t, weights=ba_w, valid=ba_v)
        if self._sharded_ba is not None:
            self.poses, self.disps, _, depth_cov = self._sharded_ba(
                problem, slot_map, eta=eta)
        else:
            self.poses, self.disps, _, depth_cov = dense_ba.dense_bundle_adjust(
                problem, slot_map, num_iters=cfg.ba_iters,
                window=cfg.frontend_window, eta=eta)
        self.hidden = torch.where(live4, net, self.hidden)
        self.e_target = torch.where(live4, target, self.e_target)
        self.eta = eta
        self.upmask = upmask
        return depth_cov

    # ------------------------------------------------------------------

    @torch.no_grad()
    def track(self, tstamp: float, image: np.ndarray, intrinsics: np.ndarray,
              frame_index: Optional[int] = None) -> List[int]:
        """Returns retired keyframe ids (possibly empty)."""
        cfg = self.cfg
        fmap, inp = self._encode(image)

        if self.n_kf > 0:
            last = self.alive[-1]
            if self._motion(fmap, self.fmaps[last],
                            self.inps[last]) < cfg.motion_threshold:
                return []

        if self.free_slots:
            kf = self.free_slots.pop()
        else:
            kf = self.n_kf
            self.n_kf += 1
        if kf >= cfg.buffer_size:
            raise RuntimeError("keyframe buffer exhausted")
        self.fmaps[kf] = fmap
        self.inps[kf] = inp
        self.intrinsics8[kf] = torch.as_tensor(
            np.asarray(intrinsics, np.float32), device=self.device) / 8.0
        if len(self.alive) >= 2:
            g1 = self.poses[self.alive[-1]]
            g2 = self.poses[self.alive[-2]]
            motion_g = lie.se3_mul(g1, lie.se3_inv(g2))
            self.poses[kf] = lie.se3_mul(motion_g, g1)
            self.disps[kf] = self.disps[self.alive[-1]]
        elif self.alive:
            self.poses[kf] = self.poses[self.alive[-1]]

        self.tstamps[kf] = tstamp
        self.src_index[kf] = frame_index if frame_index is not None else kf
        self.colors[kf] = np.asarray(image, np.uint8)
        self.alive.append(kf)
        self._rebuild_edges()

        if len(self.alive) >= 4:
            for _ in range(cfg.iters1):
                self._run_update()
            # keyframe policy: test the flow distance between the two
            # keyframes before the candidate; if they became redundant
            # under the refined geometry, drop the previous one (the
            # candidate stays), else refine iters2 more times
            a, b = self.alive[-3], self.alive[-2]
            d = self._pair_distance([a, b], [b, a])
            if 0.5 * float(d[0] + d[1]) < cfg.keyframe_threshold:
                self.remove_keyframe(b)
            else:
                for _ in range(cfg.iters2):
                    self._run_update()

        return self._retire()

    def remove_keyframe(self, g: int) -> None:
        """Drop a redundant keyframe: its slot returns to the free pool, its
        edges and inactive factors are dropped, and it never reaches the
        mapping packet."""
        self.alive.remove(g)
        self.free_slots.append(g)
        self.colors.pop(g, None)
        self.tstamps.pop(g, None)
        self.src_index.pop(g, None)
        for k in range(self.cfg.inactive_factors):
            if self.i_valid[k] and g in (int(self.i_ii[k]),
                                         int(self.i_jj[k])):
                self.i_valid[k] = False
        self._rebuild_edges()

    # ------------------------------------------------------------------

    def _rebuild_edges(self) -> None:
        """Frontend graph: neighbourhood edges among the window keyframes +
        flow-proximity edges picked greedily by distance under the
        threshold, suppressing an index-space neighbourhood around each
        pick; the newest ``max_factors`` edges are kept."""
        cfg = self.cfg
        win = self.alive[-cfg.frontend_window:]
        W = len(win)
        pairs = []
        chosen = set()
        for a_idx, a in enumerate(win):
            for b_idx, b in enumerate(win):
                if a != b and abs(a_idx - b_idx) <= cfg.frontend_radius:
                    pairs.append((a, b))
                    chosen.add((a_idx, b_idx))

        budget = cfg.max_factors - len(pairs)
        if W >= 3 and budget > 0:
            cand = [(ai, bi) for ai in range(W) for bi in range(W)
                    if ai != bi and (ai, bi) not in chosen]
            if cand:
                d = self._pair_distance([win[ai] for ai, _ in cand],
                                        [win[bi] for _, bi in cand])
                suppressed = set()
                for k in np.argsort(d):
                    if budget <= 0 or d[k] > cfg.frontend_threshold:
                        break
                    ai, bi = cand[k]
                    if (ai, bi) in suppressed:
                        continue
                    pairs.append((win[ai], win[bi]))
                    budget -= 1
                    r = cfg.frontend_nms
                    for di in range(-r, r + 1):
                        for dj in range(-r, r + 1):
                            suppressed.add((ai + di, bi + dj))

        pairs = pairs[-cfg.max_factors:]
        old = {(int(self.e_ii[s]), int(self.e_jj[s])): s
               for s in range(cfg.max_factors) if self.e_valid[s]}
        if cfg.inactive_factors:
            self._store_inactive(old, pairs, set(win))
        self.e_valid[:] = False
        new_ii = np.full(cfg.max_factors, -1, np.int64)
        new_jj = np.full(cfg.max_factors, -1, np.int64)
        new_fresh = np.zeros(cfg.max_factors, bool)
        perm_src, perm_dst = [], []
        for s, (a, b) in enumerate(pairs):
            new_ii[s] = a
            new_jj[s] = b
            if (a, b) in old:
                if old[(a, b)] != s:
                    perm_src.append(old[(a, b)])
                    perm_dst.append(s)
                new_fresh[s] = self.e_fresh[old[(a, b)]]
            else:
                new_fresh[s] = True
        if perm_src:
            src, dst = self._ids(perm_src), self._ids(perm_dst)
            self.hidden[dst] = self.hidden[src]
            self.e_target[dst] = self.e_target[src]
        self.e_ii = new_ii
        self.e_jj = new_jj
        self.e_valid[:len(pairs)] = True
        self.e_fresh = new_fresh
        self._graph_version += 1  # invalidates the pyramid cache

    def _store_inactive(self, old: Dict, pairs: List, winset: set) -> None:
        """Move edges evicted from the live set into the inactive ring:
        their last flow target / weight persist as BA constraints. Entries
        whose endpoints left the window, were removed, or became live
        again are invalidated."""
        EI = self.cfg.inactive_factors
        pairset = set(pairs)
        for k in range(EI):
            if self.i_valid[k]:
                e = (int(self.i_ii[k]), int(self.i_jj[k]))
                if e in pairset or e[0] not in winset or e[1] not in winset:
                    self.i_valid[k] = False
        src, dst = [], []
        for (a, b), s in old.items():
            if ((a, b) in pairset or self.e_fresh[s]
                    or a not in winset or b not in winset):
                continue  # kept live, never updated, or out of the window
            d = self.i_ptr % EI
            self.i_ptr += 1
            self.i_ii[d], self.i_jj[d] = a, b
            self.i_valid[d] = True
            src.append(s)
            dst.append(d)
        if src:
            si, di = self._ids(src), self._ids(dst)
            self.i_target[di] = self.e_target[si]
            self.i_weight[di] = self.e_weight[si]

    def _slot_map(self, free: List[int]) -> np.ndarray:
        sm = np.full(self.cfg.buffer_size, -1, np.int64)
        for s, g in enumerate(free[:self.cfg.frontend_window]):
            sm[g] = s
        return sm

    def _run_update(self) -> None:
        if not self.e_valid.any():
            return
        win = self.alive[-self.cfg.frontend_window:]
        # the first two keyframes anchor gauge and scale
        slot_map = self._ids(self._slot_map([g for g in win if g > 1]))
        ii = self._ids(np.clip(self.e_ii, 0, None))
        jj = self._ids(np.clip(self.e_jj, 0, None))
        if self._pyr_version != self._graph_version:
            self._pyr_cache = self._pyramid(ii, jj)
            self._pyr_version = self._graph_version
        depth_cov = self._update(
            ii, jj, torch.as_tensor(self.e_fresh.copy(), device=self.device),
            torch.as_tensor(self.e_valid.copy(), device=self.device),
            slot_map)
        # merge fresh marginal covariances (frames outside the edge set
        # keep their last estimate)
        self.depth_cov = torch.where(depth_cov < 1e5, depth_cov,
                                     self.depth_cov)
        self.e_fresh[self.e_valid] = False

    def _retire(self) -> List[int]:
        retired = []
        while len(self.alive) > self.cfg.frontend_window:
            g = self.alive.pop(0)
            retired.append(g)
            self.retired.append(g)
        if retired:
            self._rebuild_edges()
        return retired

    @torch.no_grad()
    def flush(self) -> List[int]:
        if self.cfg.perform_global_ba and len(self.retired + self.alive) >= 8:
            # the reference's terminate schedule: two global BA passes
            self.backend(self.cfg.backend_steps1)
            self.backend(self.cfg.backend_steps2)
        out = list(self.alive)
        self.retired.extend(out)
        self.alive = []
        return out

    def _backend_edges(self):
        """Proximity edges over all keyframes: forced neighbours within
        ``backend_radius`` + greedy NMS picks of flow-close pairs, 16 edges
        per keyframe on average."""
        cfg = self.cfg
        order = self.retired + self.alive  # time order
        Nk = len(order)
        pairs = []
        chosen = set()
        for a in range(Nk):
            for b in range(Nk):
                if a != b and abs(a - b) <= cfg.backend_radius:
                    pairs.append((a, b))
                    chosen.add((a, b))
        cand = [(a, b) for a in range(Nk) for b in range(Nk)
                if a != b and (a, b) not in chosen]
        dists = np.full(len(cand), np.inf, np.float32)
        CH = 1024
        for start in range(0, len(cand), CH):
            cc = cand[start:start + CH]
            dists[start:start + len(cc)] = self._pair_distance(
                [order[a] for a, _ in cc], [order[b] for _, b in cc])
        budget = 16 * Nk - len(pairs)
        suppressed = set()
        for k in np.argsort(dists):
            if budget <= 0 or dists[k] > cfg.backend_threshold:
                break
            a, b = cand[k]
            if (a, b) in suppressed:
                continue
            pairs.append((a, b))
            budget -= 1
            r = cfg.backend_nms
            for di in range(-r, r + 1):
                for dj in range(-r, r + 1):
                    suppressed.add((a + di, b + dj))
        return order, pairs

    def _backend_flow(self, hidden, target_prev, ii, jj, ii_local, valid,
                      fresh: bool, n_frames: int):
        """Backend GRU flow pass over one host-frame-grouped edge chunk
        (reference update_lowmem). ``ii_local``: [CE] chunk-frame index in
        [0, n_frames) for the agg head (every edge of a host frame is in
        the chunk, so each frame's pooling is complete); ``fresh``: the
        first backend step zeroes hidden state and targets."""
        pyr = build_corr_pyramid(self.fmaps[ii], self.fmaps[jj], 4)
        coords, _ = dense_ba.dense_reproject(
            self.poses, self.disps, self.intrinsics8, ii, jj)
        corr = corr_lookup(pyr, coords, radius=3)
        del pyr
        tgt_prev = coords if fresh else target_prev
        flow = _motion_features(coords, self.grid, tgt_prev)
        net = (torch.zeros_like(hidden, dtype=torch.float32) if fresh
               else hidden.float())
        net, delta, weight, eta, upmask = self.net.update(
            net, self.inps[ii].float(), _nchw(corr), flow, ii_local,
            n_frames)
        return (net, coords + _nhwc(delta),
                _nhwc(weight) * valid[:, None, None, None], eta, upmask)

    @torch.no_grad()
    def backend(self, steps: int) -> None:
        """One global BA pass over all keyframes (reference backend +
        update_lowmem): fresh proximity edges, then ``steps`` iterations of
        [host-frame-chunked GRU flow updates -> one global dense BA over
        every edge]. Edge state (hidden, flow target, weight) persists
        across the pass."""
        cfg = self.cfg
        order, pairs = self._backend_edges()
        Nk = len(order)
        if Nk < 4 or not pairs:
            return
        h, w = self.h, self.w
        dev = self.device

        # edges grouped by host-frame position; ME bucketed to a power of 2
        per_host: Dict[int, List[int]] = {a: [] for a in range(Nk)}
        for a, b in pairs:
            per_host[a].append(b)
        me = max(len(v) for v in per_host.values())
        ME = 1
        while ME < me:
            ME *= 2
        jj_g = np.zeros((Nk, ME), np.int64)
        valid = np.zeros((Nk, ME), bool)
        for a, bs in per_host.items():
            for m, b in enumerate(bs):
                jj_g[a, m] = order[b]
                valid[a, m] = True
        host = np.asarray(order, np.int64)

        # per-edge state rows (the reference's gru_* buffers, fp16 there)
        hidden = torch.zeros(Nk, ME, self.net.cdim, h, w,
                             dtype=torch.bfloat16, device=dev)
        target = torch.zeros(Nk, ME, h, w, 2, device=dev)
        weight = torch.zeros(Nk, ME, h, w, 2, device=dev)

        # the first two keyframes are fixed: SE3 gauge + monocular scale
        slot_map = np.full(cfg.buffer_size, -1, np.int64)
        for p, g in enumerate(order[2:]):
            slot_map[g] = p
        P = max(Nk - 2, 1)
        jj_d, valid_d = self._ids(jj_g), torch.as_tensor(valid, device=dev)

        CF = min(4, Nk)  # host frames per GRU chunk
        for step in range(steps):
            for f0 in range(0, Nk, CF):
                # the last chunk may hold fewer rows: the agg head pools
                # each chunk frame over its own edges only, so a chunk's
                # rows do not depend on the others
                rows = list(range(f0, min(f0 + CF, Nk)))
                n = len(rows)
                r_idx = self._ids(rows)
                ii_c = self._ids(np.repeat(host[rows], ME))
                net_c, tgt_c, wgt_c, eta_c, up_c = self._backend_flow(
                    hidden[r_idx].reshape(n * ME, -1, h, w),
                    target[r_idx].reshape(n * ME, h, w, 2),
                    ii_c, jj_d[r_idx].reshape(-1),
                    self._ids(np.repeat(np.arange(n), ME)),
                    valid_d[r_idx].reshape(-1), step == 0, n)
                hidden[r_idx] = net_c.reshape(n, ME, -1, h, w).to(
                    torch.bfloat16)
                target[r_idx] = tgt_c.reshape(n, ME, h, w, 2)
                weight[r_idx] = wgt_c.reshape(n, ME, h, w, 2)
                hs = self._ids(host[rows])
                self.eta[hs] = eta_c
                self.upmask[hs] = up_c
            self.poses, self.disps, _ = dense_ba.global_dense_ba(
                self.poses, self.disps, self.intrinsics8, self._ids(host),
                jj_d, valid_d, target, weight, self._ids(slot_map),
                num_iters=cfg.ba_iters, P=P, eta=0.2 * self.eta + 1e-7)
        if self.alive:
            self._rebuild_edges()

    # ------------------------------------------------------------------

    @torch.no_grad()
    def keyframe_packet(self, kfs: List[int], last_frame: bool = False
                        ) -> Optional[Dict[str, Any]]:
        """tracking -> enhancement packet with the dense upsampled inverse
        depth (and covariance). Tensors stay on the device."""
        if not kfs:
            return None
        idx = self._ids(kfs)
        c2w = lie.se3_matrix(lie.se3_inv(self.poses[idx]))  # OpenCV frame
        masks = self.upmask[idx]
        colors = np.stack(
            [self.colors.pop(k, np.zeros((self.H, self.W, 3), np.uint8))
             for k in kfs])
        packet = {
            "keyframe_indices": np.asarray(kfs, np.int64),
            "camera_intrinsics": self.intrinsics8[idx] * 8.0,
            "camera_extrinsics": c2w.float(),
            "frames_color": np.moveaxis(colors, -1, 1),  # [K, 3, H, W]
            "droid_slam_inverse_depth": cvx_upsample(self.disps[idx], masks),
            "last_frame": last_frame,
        }
        if self.cfg.compute_covariances:
            # the BA's marginal covariance, upsampled with the same learned
            # convex masks as the disparities
            packet["droid_slam_depth_covariance"] = cvx_upsample(
                self.depth_cov[idx], masks)
        return packet

    @torch.no_grad()
    def trajectory(self) -> Dict[int, np.ndarray]:
        """keyframe slot -> cam2world 4x4 for all retired + alive
        keyframes."""
        kfs = self.retired + self.alive
        if not kfs:
            return {}
        mats = lie.se3_matrix(
            lie.se3_inv(self.poses[self._ids(kfs)])).cpu().numpy()
        return {k: mats[i] for i, k in enumerate(kfs)}
