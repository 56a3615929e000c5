"""Multiresolution brick hash-grid encoding.

Counterpart of ``nerf_vo_tpu/ops/hash_grid.py``. The unit of storage is a
BRICK: the 3x3x3 corner lattice of a 2x2x2-cell region, 27 entries padded to
32. All 8 trilinear corners of a cell live in its brick, so each (sample,
level) reads exactly one brick. Levels whose brick lattice fits the table are
dense; finer levels hash the brick coordinate with Instant-NGP's primes.

Layout: the port's table is BRICK-MAJOR ``[L * NB, 32F]``, f32 (bf16 for the
dense proposal grids' ``proposal_table_dtype: bfloat16``), one brick per
contiguous row, entry-major / feature-minor: the transpose of the JAX
package's feature-major ``[32F, L * NB]``; :func:`tables_from_jax` converts.

:func:`hash_encode` is a ``torch.autograd.Function`` with gradients for the
table and the positions. Its table operations are the kernels of
``ops/gather_cuda.py`` (their plain versions on CPU tensors):

- forward: ``gather_interp_mm`` on the dense prefix levels with at most 512
  bricks (the JAX package's one-hot matmul levels), ``gather_interp`` on the
  rest, all those levels stacked level-major into one launch (a bf16 table:
  ``gather_interp`` on every level, its bf16-table kernel);
- backward, table: ``scatter_cols_outer`` adds the per-descriptor rows
  ``W[t, e] * cot[t, f]``, formed in registers, into an f32 gradient of
  the table's shape (with ``grad_phase``, only the rows of the levels that
  count);
- on the card, ``gather_interp_mm`` keeps the one-hot levels' table rows
  (:func:`_hot_rows`; level 0's 512 bricks in the field) in shared memory;
- backward, positions: ``gather_cols_dot`` re-gathers the bf16 brick rows
  (they are not kept from the forward) and contracts them with the
  cotangent into ``dW`` [M, 32]; the ``dfrac * res`` contraction through
  the separable weights is plain torch (broadcast products, no [M, 32F]
  tensor). :func:`hash_encode_vjp` gives that position pullback on its
  own, as ``jax.vjp`` does for the density's normals: a custom backward
  cannot see that ``torch.autograd.grad(density, positions)`` will drop
  its table gradient, so it would make one.

Gathered table values are ``bf16(table)``, as the JAX package's bf16 shadow;
weights, sums and gradients are f32 (the JAX package accumulates the hashed
levels' table gradient in bf16, so the port is the more precise of the two).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

from nerf_vo_tpu_torch.ops import gather_cuda as gc
from nerf_vo_tpu_torch.parallel import dist as pdist

_PRIMES = (1, 2654435761, 805459861)  # Instant-NGP spatial hash primes
_BRICK = 27  # 3x3x3 corner lattice of a 2x2x2-cell region
_BRICK_PAD = 32  # padded brick height per feature
# dense prefix levels with at most this many bricks take the one-hot route
# (the JAX package's MXU matmul levels; here gather_interp_mm)
_ONEHOT_MAX_BRICKS = 512


@dataclasses.dataclass(frozen=True)
class HashGridConfig:
    n_levels: int = 16
    features_per_level: int = 2
    log2_table_size: int = 19  # per-level ENTRY capacity (bricks = T/32)
    base_resolution: int = 16
    max_resolution: int = 2048

    @property
    def table_size(self) -> int:
        return 1 << self.log2_table_size

    @property
    def bricks_per_level(self) -> int:
        return max(self.table_size // _BRICK_PAD, 1)

    @property
    def output_dim(self) -> int:
        return self.n_levels * self.features_per_level

    @property
    def resolutions(self) -> Sequence[int]:
        if self.n_levels == 1:
            return (self.base_resolution,)
        growth = math.exp(
            (math.log(self.max_resolution) - math.log(self.base_resolution))
            / (self.n_levels - 1)
        )
        return tuple(
            int(math.floor(self.base_resolution * growth**l))
            for l in range(self.n_levels)
        )


def init_tables(config: HashGridConfig, shard: int = 1):
    """Table init U(-1e-4, 1e-4) as in Instant-NGP, from torch's global
    generator: brick-major f32 ``[L * NB, 32F]``. ``shard`` > 1 makes one
    model-axis shard of it, ``[L * NB / shard, 32F]`` (rank r holds rows
    ``r * L * NB / shard`` on: the JAX package's column shard r)."""
    F = config.features_per_level
    rows = config.n_levels * config.bricks_per_level
    if rows % shard:
        raise ValueError(f"{rows} table rows do not split into {shard} "
                         "shards")
    return torch.rand(rows // shard, _BRICK_PAD * F) * 2e-4 - 1e-4


def tables_from_jax(tables_np):
    """JAX feature-major ``[32F, L * NB]`` -> brick-major ``[L * NB, 32F]``,
    in its dtype (f32, or bf16 from numpy's ml_dtypes ``bfloat16``)."""
    a = np.ascontiguousarray(np.asarray(tables_np).T)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _brick_ids(c_brick, res: int, n_bricks: int, level: int):
    """Brick index per sample for one level: dense when the brick lattice
    fits the table, the spatial hash otherwise. c_brick: [3, N] integer.

    The hash wraps at 32 bits like the JAX package's uint32 arithmetic: it
    is computed in int64 and masked to the low 32 bits, so the ids agree bit
    for bit. Returns int64 [N] global row ids (level offset included).
    """
    c = c_brick.long()
    bpa = ((res - 1) >> 1) + 1  # bricks per axis
    if bpa**3 <= n_bricks:
        bid = (c[0] * bpa + c[1]) * bpa + c[2]
    else:
        mask = 0xFFFFFFFF
        h = ((c[0] * _PRIMES[0]) & mask) ^ ((c[1] * _PRIMES[1]) & mask) \
            ^ ((c[2] * _PRIMES[2]) & mask)
        bid = h % n_bricks
    return bid + level * n_bricks


def _n_onehot(config: HashGridConfig) -> int:
    """Number of dense prefix levels on the one-hot route."""
    NB = config.bricks_per_level
    n = 0
    for l, res in enumerate(config.resolutions):
        bpa = ((res - 1) >> 1) + 1
        if bpa**3 <= min(NB, _ONEHOT_MAX_BRICKS):
            n = l + 1
        else:
            break
    return n


def _hot_rows(config: HashGridConfig) -> int:
    """Leading table rows read by the one-hot levels (level l's first
    ``bpa**3`` bricks at row ``l * NB``): what ``gather_interp_mm`` stages
    on chip. 0 without such a level."""
    n = _n_onehot(config)
    if n == 0:
        return 0
    bpa = ((config.resolutions[n - 1] - 1) >> 1) + 1
    return (n - 1) * config.bricks_per_level + bpa**3


def _axis_weights(lo, f):
    """[M, 3] weights of the 3 lattice points on one axis:
    (i == lo) (1 - f) + (i == lo + 1) f."""
    i3 = torch.arange(3, device=lo.device)
    lo = lo[:, None]
    f = f[:, None]
    return (i3 == lo) * (1.0 - f) + (i3 == lo + 1) * f


def _axis_dweights(lo):
    """[M, 3] d(axis weights)/df: -(i == lo) + (i == lo + 1)."""
    i3 = torch.arange(3, device=lo.device)
    lo = lo[:, None]
    return (i3 == lo + 1).float() - (i3 == lo).float()


def _trilinear(w0, w1, w2):
    """[M, 3] x 3 -> [M, 27]: W[(i*3+j)*3+k] = w0[i] w1[j] w2[k]."""
    M = w0.shape[0]
    return (w0[:, :, None, None] * w1[:, None, :, None]
            * w2[:, None, None, :]).reshape(M, _BRICK)


def _descriptors(x, config: HashGridConfig):
    """Per (level, sample), level-major: brick ids [L*N] int32, in-brick
    base corners [L*N, 3] int64, fractional offsets [L*N, 3] f32, and the
    trilinear weights [L*N, 32] f32 (rows 27..31 zero). Also the [N, 3]
    mask of coordinates inside [0, 1] (the clamp passes gradient there)."""
    xt = x.reshape(-1, 3).float()
    inside = (xt >= 0.0) & (xt <= 1.0)
    xt = xt.clamp(0.0, 1.0)
    NB = config.bricks_per_level
    ids, fr, loc = [], [], []
    for l, res in enumerate(config.resolutions):
        xs = xt * float(res)
        fl = torch.floor(xs)
        c = fl.long().clamp(0, res - 1)
        fr.append(xs - fl)
        loc.append(c & 1)
        ids.append(_brick_ids((c >> 1).T, res, NB, l))
    idx = torch.cat(ids).to(torch.int32)
    frac = torch.cat(fr)
    local = torch.cat(loc)
    W = _trilinear(*(_axis_weights(local[:, a], frac[:, a]) for a in range(3)))
    W = torch.cat([W, W.new_zeros(W.shape[0], _BRICK_PAD - _BRICK)], 1)
    return idx, local, frac, W, inside


def _brick_dW(tables, idx, cot):
    """d<features, cot>/dW [M, 32] of M descriptors: ``gather_cols_dot``
    re-gathers their bf16 brick rows and contracts them with cot [M, F]
    f32."""
    if tables.dtype != torch.float32:
        tables = tables.float()  # exact: the gather rounds to bf16 again
    return gc.gather_cols_dot(tables, idx, cot)


def _dfrac(dW, local, frac):
    """[M, 3] d<features, cot>/dfrac from dW [M, 32] through the separable
    trilinear weights: sum_ijk dW[ijk] w0'[i] w1[j] w2[k] and its two
    siblings, as broadcast products summed one axis at a time (an
    ``einsum`` over M runs as a batched matrix-vector product)."""
    M = dW.shape[0]
    dW = dW[:, :_BRICK].reshape(M, 3, 3, 3)
    w = [_axis_weights(local[:, a], frac[:, a]) for a in range(3)]
    dw = [_axis_dweights(local[:, a]) for a in range(3)]
    ij = torch.sum(dW * w[2][:, None, None, :], dim=3)  # [M, i, j]
    k = torch.sum(dW * (w[0][:, :, None, None] * w[1][:, None, :, None]),
                  dim=(1, 2))  # [M, k]
    return torch.stack([
        torch.sum(torch.sum(ij * w[1][:, None, :], dim=2) * dw[0], dim=1),
        torch.sum(torch.sum(ij * w[0][:, :, None], dim=1) * dw[1], dim=1),
        torch.sum(k * dw[2], dim=1),
    ], dim=-1)


def _position_grad(tables, desc, cot, config: HashGridConfig, x_shape,
                   x_dtype):
    """d<features, cot>/dx from one encode's descriptors: ``dW`` from
    ``gather_cols_dot``, then the ``dfrac * res`` contraction. cot: [L*n,
    F] level-major f32."""
    idx, local, frac, _, inside = desc
    L = config.n_levels
    n = idx.shape[0] // L
    dfrac = _dfrac(_brick_dW(tables, idx, cot), local, frac).reshape(L, n, 3)
    res = torch.tensor([float(r) for r in config.resolutions],
                       device=dfrac.device)
    grad_x = torch.sum(dfrac * res[:, None, None], dim=0) * inside
    return grad_x.reshape(x_shape).to(x_dtype)


def _level_major(cot, config: HashGridConfig):
    """[..., L*F] feature cotangent -> [L*n, F] f32, level-major like the
    descriptors."""
    L = config.n_levels
    F = config.features_per_level
    n = cot.numel() // (L * F)
    return cot.reshape(n, L, F).permute(1, 0, 2).reshape(L * n, F).float()


def _grad_rows(config: HashGridConfig, n: int, grad_phase):
    """The descriptor rows whose table gradient a backward accumulates:
    every row, or under ``grad_phase`` (with more than one scattered
    level) the one-hot prefix's and scattered level
    ``grad_phase % n_scattered``'s. Returns None for every row, else a
    list of (start, stop) ranges."""
    n_oh = _n_onehot(config)
    n_scat = config.n_levels - n_oh
    if grad_phase is None or n_scat <= 1:
        return None
    s = n_oh + int(grad_phase) % n_scat
    return [(0, n_oh * n), (s * n, (s + 1) * n)]


class _HashEncode(torch.autograd.Function):

    @staticmethod
    def forward(ctx, tables, x, config, grad_phase, desc):
        L = config.n_levels
        F = config.features_per_level
        n = x.numel() // 3
        idx, _, _, W, _ = desc
        # gather_interp_mm's route is for f32 tables; a bf16 table reads
        # every level through gather_interp (the same function)
        split = _n_onehot(config) * n if tables.dtype == torch.float32 else 0
        parts = []
        if split:
            parts.append(gc.gather_interp_mm(tables, idx[:split], W[:split],
                                             F, hot_rows=_hot_rows(config)))
        if split < L * n:
            parts.append(gc.gather_interp(tables, idx[split:], W[split:], F))
        feats = parts[0] if len(parts) == 1 else torch.cat(parts)  # [L*n, F]
        ctx.config = config
        ctx.grad_phase = grad_phase
        ctx.x_shape = x.shape
        ctx.x_dtype = x.dtype
        ctx.desc = desc
        ctx.save_for_backward(tables)
        out = feats.reshape(L, n, F).permute(1, 0, 2)
        return out.reshape(x.shape[:-1] + (L * F,))

    @staticmethod
    def backward(ctx, cot):
        (tables,) = ctx.saved_tensors
        config = ctx.config
        idx, _, _, W, _ = ctx.desc
        cot = _level_major(cot, config)
        grad_tables = grad_x = None
        if ctx.needs_input_grad[0]:
            n = idx.shape[0] // config.n_levels
            spans = _grad_rows(config, n, ctx.grad_phase)
            if spans is not None:  # one launch over the rows that count
                keep = lambda t: torch.cat([t[a:b] for a, b in spans])
                idx_g, W_g, cot_g = keep(idx), keep(W), keep(cot)
            else:
                idx_g, W_g, cot_g = idx, W, cot
            grad_tables = gc.scatter_cols_outer(W_g, cot_g, idx_g,
                                                tables.shape[0])
        if ctx.needs_input_grad[1]:
            grad_x = _position_grad(tables, ctx.desc, cot, config,
                                    ctx.x_shape, ctx.x_dtype)
        return grad_tables, grad_x, None, None, None


# ---------------------------------------------------------------------------
# model-axis (tensor-parallel) tables
# ---------------------------------------------------------------------------

def _model_axis(group) -> pdist.Axis:
    return pdist.Axis(group, dist.get_world_size(group), dist.get_rank(group))


class _TPRoute:
    """One encode's table lookups when the table is row-sharded over a
    model axis (rank r holds global rows ``[r * R, (r + 1) * R)`` of the
    brick-major table; the JAX package's column shard r). Counterpart of
    ``_tp_onehot_slab``, ``_tp_gather_cols`` and ``tp_gather_cols_a2a``.

    The one-hot prefix levels read a replicated slab of their bricks, made
    by one SUM all-reduce of each rank's owned rows (``gather_interp_mm``
    on it; its table gradient comes back through ``scatter_cols_outer`` on
    the slab, and each rank keeps its own rows). The other levels:

    - replicated samples (every rank of the axis encodes the same points):
      ``gather_interp`` on the local rows with the weights of descriptors
      owned elsewhere zeroed and their ids clamped, then one SUM
      all-reduce of the [M, F] features (only the owner's term is
      non-zero, so the sum is the owner's value); the table gradient is
      the owned descriptors' ``scatter_cols_outer`` on the local rows, with
      no collective (the cotangent is the same on every rank); the
      position gradient sums the owned descriptors' terms and all-reduces
      [n, 3];
    - ``descriptor_sharding`` (each rank encodes its own points): each
      descriptor's local id and weight row go to its owner in one
      ``all_to_all`` (split sizes exchanged first), the owner interpolates
      and returns the [R, F] features; the backward routes the [M, F]
      cotangents the same way, the owner scatters them into its rows (so
      its table gradient is the SUM over the axis) and returns each
      descriptor's [32] weight gradient for the requester's position
      gradient. The exact splits need no capacity and no overflow path.
    """

    def __init__(self, tables, desc, config: HashGridConfig, axis,
                 descriptor_sharding: bool):
        idx, _, _, W, _ = desc
        L, NB = config.n_levels, config.bricks_per_level
        self.config, self.axis, self.desc = config, axis, desc
        self.ds = descriptor_sharding
        self.rows = R = tables.shape[0]
        if R * axis.size != L * NB or R >= 1 << 24:
            raise ValueError(f"a table shard of {R} rows over {axis.size} "
                             f"ranks for a {L * NB}-row table")
        self.base = base = axis.index * R
        self.n = n = idx.shape[0] // L
        n_oh = _n_onehot(config) if tables.dtype == torch.float32 else 0
        self.split = split = n_oh * n
        # one-hot slab: the leading bpa**3 bricks of each one-hot level
        self.spans, off, sid = [], 0, []
        for l in range(n_oh):
            bpa = ((config.resolutions[l] - 1) >> 1) + 1
            self.spans.append((l * NB, bpa**3, off))
            sid.append(idx[l * n:(l + 1) * n] - l * NB + off)
            off += bpa**3
        self.slab_rows = off
        self.sid = torch.cat(sid) if sid else None
        self.slab = None
        if split == L * n:
            return
        idx_s = idx[split:].long()
        W_s = W[split:]
        if not self.ds:
            li = idx_s - base
            own = (li >= 0) & (li < R)
            self.w_masked = W_s * own[:, None]
            self.li_clamped = li.clamp(0, R - 1).to(torch.int32)
            self.own_rows = own.nonzero()[:, 0]
            self.own_li = li[self.own_rows].to(torch.int32)
            return
        owner = torch.div(idx_s, R, rounding_mode="floor")
        self.order = torch.argsort(owner, stable=True)
        send = torch.bincount(owner, minlength=axis.size)
        recv = pdist.exchange_counts(send, axis)
        self.send, self.recv = send.tolist(), recv.tolist()
        # a local id travels as an f32 column beside its weights: exact
        # below 2**24 rows
        li = (idx_s - owner * R)[self.order].to(torch.float32)
        packet = torch.cat([W_s[self.order], li[:, None]], 1)
        got = pdist.all_to_all_rows(packet, self.send, self.recv, axis)
        self.recv_w = got[:, :_BRICK_PAD].contiguous()
        self.recv_li = got[:, _BRICK_PAD].to(torch.int32)

    # -- forward -----------------------------------------------------------

    def _owned_span(self, g0, B):
        """Global rows [lo, hi) of [g0, g0 + B) held by this rank."""
        return max(g0, self.base), min(g0 + B, self.base + self.rows)

    def features(self, tables):
        F = self.config.features_per_level
        idx, _, _, W, _ = self.desc
        parts = []
        if self.split:
            slab = tables.new_zeros(self.slab_rows, tables.shape[1])
            for g0, B, off in self.spans:
                lo, hi = self._owned_span(g0, B)
                if lo < hi:
                    slab[off + lo - g0:off + hi - g0] = \
                        tables[lo - self.base:hi - self.base]
            self.slab = pdist.all_reduce_sum(slab, self.axis)
            parts.append(gc.gather_interp_mm(
                self.slab, self.sid, W[:self.split], F,
                hot_rows=self.slab_rows))
        if self.split < idx.shape[0]:
            if not self.ds:
                part = gc.gather_interp(tables, self.li_clamped,
                                        self.w_masked, F)
                parts.append(pdist.all_reduce_sum(part, self.axis))
            else:
                got = gc.gather_interp(tables, self.recv_li, self.recv_w, F)
                back = pdist.all_to_all_rows(got, self.recv, self.send,
                                             self.axis)
                part = torch.empty_like(back)
                part[self.order] = back
                parts.append(part)
        return parts[0] if len(parts) == 1 else torch.cat(parts)

    # -- backward ----------------------------------------------------------

    def routed_cot(self, cot):
        """Under descriptor sharding, the [L*n, F] cotangent's rows of the
        descriptors this rank owns, in the order they arrived (one
        all-to-all); else None. Every backward routes its own cotangent."""
        if not self.ds or self.split == cot.shape[0]:
            return None
        return pdist.all_to_all_rows(cot[self.split:][self.order], self.send,
                                     self.recv, self.axis)

    def table_grad(self, shape, cot, routed):
        """[R, 32F] f32 gradient of this rank's rows. cot: [L*n, F];
        routed: :meth:`routed_cot`'s."""
        idx, _, _, W, _ = self.desc
        grad = None
        if self.split < idx.shape[0]:
            if not self.ds:
                sel = self.own_rows
                w_g, c_g, li = W[self.split:][sel], cot[self.split:][sel], \
                    self.own_li
            else:
                w_g, c_g, li = self.recv_w, routed, self.recv_li
            grad = gc.scatter_cols_outer(w_g, c_g, li, shape[0])
        if grad is None:
            grad = torch.zeros(shape, dtype=torch.float32, device=cot.device)
        if self.split:
            g_slab = gc.scatter_cols_outer(W[:self.split], cot[:self.split],
                                           self.sid, self.slab_rows)
            if self.ds:  # each rank's samples differ
                pdist.all_reduce_sum(g_slab, self.axis)
            for g0, B, off in self.spans:
                lo, hi = self._owned_span(g0, B)
                if lo < hi:
                    grad[lo - self.base:hi - self.base] += \
                        g_slab[off + lo - g0:off + hi - g0]
        return grad

    def position_grad(self, tables, cot, routed, x_shape, x_dtype):
        """d<features, cot>/dx of this rank's points (routed:
        :meth:`routed_cot`'s). The slab's terms are replicated already and
        never all-reduced."""
        idx, local, frac, _, inside = self.desc
        n = self.n
        res = torch.tensor([float(r) for r in self.config.resolutions],
                           device=cot.device)
        row_res = res.repeat_interleave(n)
        sample = torch.arange(n, device=cot.device).repeat(
            self.config.n_levels)
        grad = torch.zeros(n, 3, device=cot.device)
        if self.split < idx.shape[0]:
            s = self.split
            cot_s = cot[s:]
            if not self.ds:
                sel = self.own_rows
                dW = _brick_dW(tables, self.own_li, cot_s[sel])
                rows = sel + s
            else:
                dW_own = _brick_dW(tables, self.recv_li, routed)
                back = pdist.all_to_all_rows(dW_own, self.recv, self.send,
                                             self.axis)
                dW = torch.empty_like(back)
                dW[self.order] = back
                rows = torch.arange(s, idx.shape[0], device=cot.device)
            d = _dfrac(dW, local[rows], frac[rows]) * row_res[rows, None]
            grad.index_add_(0, sample[rows], d)
            if not self.ds:
                pdist.all_reduce_sum(grad, self.axis)
        if self.split:
            s = self.split
            d = _dfrac(_brick_dW(self.slab, self.sid, cot[:s]), local[:s],
                       frac[:s]) * row_res[:s, None]
            grad.index_add_(0, sample[:s], d)
        return (grad * inside).reshape(x_shape).to(x_dtype)


class _TPHashEncode(torch.autograd.Function):

    @staticmethod
    def forward(ctx, tables, x, route):
        config = route.config
        L, F = config.n_levels, config.features_per_level
        feats = route.features(tables)  # [L*n, F] level-major
        ctx.route = route
        ctx.x_shape, ctx.x_dtype = x.shape, x.dtype
        ctx.save_for_backward(tables)
        out = feats.reshape(L, route.n, F).permute(1, 0, 2)
        return out.reshape(x.shape[:-1] + (L * F,))

    @staticmethod
    def backward(ctx, cot):
        (tables,) = ctx.saved_tensors
        route = ctx.route
        cot = _level_major(cot, route.config)
        routed = route.routed_cot(cot)
        grad_tables = grad_x = None
        if ctx.needs_input_grad[0]:
            grad_tables = route.table_grad(tables.shape, cot, routed)
        if ctx.needs_input_grad[1]:
            grad_x = route.position_grad(tables, cot, routed, ctx.x_shape,
                                         ctx.x_dtype)
        return grad_tables, grad_x, None


def _encode(tables, x, config, grad_phase, group, descriptor_sharding):
    """(features, descriptors, route or None) of one encode."""
    desc = _descriptors(x.detach(), config)
    if group is None:
        return _HashEncode.apply(tables, x, config, grad_phase, desc), desc, \
            None
    route = _TPRoute(tables.detach(), desc, config, _model_axis(group),
                     descriptor_sharding)
    return _TPHashEncode.apply(tables, x, route), desc, route


def hash_encode(tables, x, config: HashGridConfig, grad_phase=None,
                group=None, descriptor_sharding: bool = False):
    """Encode points with the multiresolution brick grid.

    Args:
      tables: brick-major ``[L * NB, 32F]`` f32 or bf16 table (see
        :func:`init_tables`); a bf16 table gets a bf16 gradient. With
        ``group``, this rank's row shard of it (``init_tables(shard=)``).
      x: [..., 3] positions in the unit cube [0, 1]^3 (values outside are
        clamped; callers apply scene contraction first).
      grad_phase: the train step, or None. When set and the grid has more
        than one scattered (non one-hot) level, the backward accumulates
        the table gradient of the one-hot prefix and of scattered level
        ``grad_phase % n_scattered`` only: every other scattered level's
        gradient is exactly 0 that step. Single-device only (the JAX
        package phases only there too).
      group: the model axis's process group when the table is row-sharded
        over it (the JAX package's ``model_axis``; see :class:`_TPRoute`).
        Every rank of the group must make the same encodes in the same
        order, forward and backward.
      descriptor_sharding: with ``group``, each rank passes its own points
        and lookups are routed to the rows' owners; the table gradient a
        rank gets is then the SUM over the group.

    Returns:
      [..., L*F] encoded features (f32), feature-within-level minor
      (level l, feature f at output column l*F + f).
    """
    return _encode(tables, x, config, grad_phase, group,
                   descriptor_sharding)[0]


def hash_encode_vjp(tables, x, config: HashGridConfig, grad_phase=None,
                    group=None, descriptor_sharding: bool = False):
    """:func:`hash_encode`'s features, and the pullback of the positions
    alone: ``pullback(cot)`` gives d<features, cot>/dx (detached) from this
    encode's descriptors, with no second encode and no table gradient (no
    ``scatter_cols_outer``); the features stay differentiable in the
    caller's graph as :func:`hash_encode`'s are. With ``group`` the
    pullback makes the route's collectives, so every rank calls it."""
    out, desc, route = _encode(tables, x, config, grad_phase, group,
                               descriptor_sharding)

    def pullback(cot):
        with torch.no_grad():
            cot = _level_major(cot, config)
            if route is not None:
                return route.position_grad(tables.detach(), cot,
                                           route.routed_cot(cot), x.shape,
                                           x.dtype)
            return _position_grad(tables.detach(), desc, cot, config,
                                  x.shape, x.dtype)
    return out, pullback


def contract(x, order: float = math.inf):
    """MipNeRF-360 scene contraction: maps R^3 into the ball of radius 2."""
    if order == math.inf:
        norm = torch.amax(torch.abs(x), dim=-1, keepdim=True)
    else:
        norm = torch.linalg.norm(x, ord=order, dim=-1, keepdim=True)
    norm = norm.clamp(min=1e-7)
    return torch.where(norm <= 1.0, x, (2.0 - 1.0 / norm) * x / norm)


def contract_to_unit_cube(x, order: float = math.inf):
    """Contraction composed with the affine map of [-2, 2]^3 onto [0, 1]^3."""
    return (contract(x, order) + 2.0) * 0.25


def normalize_to_unit_cube(x, aabb_min, aabb_max):
    """Affine map of an axis-aligned bounding box onto [0, 1]^3."""
    return (x - aabb_min) / (aabb_max - aabb_min)
