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
- backward, table: the per-descriptor rows ``W[t, e] * cot[t, f]`` go
  through ``scatter_cols_accum`` into an f32 gradient of the table's shape
  (with ``grad_phase``, only the rows of the levels that count);
- on the card, ``gather_interp_mm`` and ``scatter_cols_accum`` keep the
  one-hot levels' table rows (:func:`_hot_rows`; level 0's 512 bricks in
  the field) in shared memory;
- backward, positions: ``gather_cols`` re-gathers the bf16 brick rows (they
  are not kept from the forward) and the ``dW / dfrac * res`` contraction is
  plain torch. :func:`hash_encode_vjp` gives that position pullback on its
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

from nerf_vo_tpu_torch.ops import gather_cuda as gc

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


def init_tables(config: HashGridConfig):
    """Table init U(-1e-4, 1e-4) as in Instant-NGP, from torch's global
    generator: brick-major f32 ``[L * NB, 32F]``."""
    F = config.features_per_level
    rows = config.n_levels * config.bricks_per_level
    return torch.rand(rows, _BRICK_PAD * F) * 2e-4 - 1e-4


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
    and ``scatter_cols_accum`` accumulates on chip. 0 without such a
    level."""
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


def _position_grad(tables, desc, cot, config: HashGridConfig, x_shape,
                   x_dtype):
    """d<features, cot>/dx from one encode's descriptors: ``gather_cols``
    re-gathers the bf16 brick rows, then the ``dW / dfrac * res``
    contraction. cot: [L*n, F] level-major f32."""
    idx, local, frac, _, inside = desc
    L = config.n_levels
    F = config.features_per_level
    n = idx.shape[0] // L
    M = L * n
    if tables.dtype != torch.float32:
        tables = tables.float()  # exact: gather_cols rounds to bf16 again
    g = gc.gather_cols(tables, idx).float().reshape(M, _BRICK_PAD, F)
    dW = torch.sum(g * cot[:, None, :], dim=-1)[:, :_BRICK]
    dW = dW.reshape(M, 3, 3, 3)
    w = [_axis_weights(local[:, a], frac[:, a]) for a in range(3)]
    dw = [_axis_dweights(local[:, a]) for a in range(3)]
    dfrac = torch.stack([
        torch.einsum("mijk,mi,mj,mk->m", dW, dw[0], w[1], w[2]),
        torch.einsum("mijk,mi,mj,mk->m", dW, w[0], dw[1], w[2]),
        torch.einsum("mijk,mi,mj,mk->m", dW, w[0], w[1], dw[2]),
    ], dim=-1).reshape(L, n, 3)
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
            rows = (W_g[:, :, None] * cot_g[:, None, :]).reshape(
                idx_g.shape[0], tables.shape[1])
            grad_tables = gc.scatter_cols_accum(rows, idx_g, tables.shape[0],
                                                hot_rows=_hot_rows(config))
        if ctx.needs_input_grad[1]:
            grad_x = _position_grad(tables, ctx.desc, cot, config,
                                    ctx.x_shape, ctx.x_dtype)
        return grad_tables, grad_x, None, None, None


def hash_encode(tables, x, config: HashGridConfig, grad_phase=None):
    """Encode points with the multiresolution brick grid.

    Args:
      tables: brick-major ``[L * NB, 32F]`` f32 or bf16 table (see
        :func:`init_tables`); a bf16 table gets a bf16 gradient.
      x: [..., 3] positions in the unit cube [0, 1]^3 (values outside are
        clamped; callers apply scene contraction first).
      grad_phase: the train step, or None. When set and the grid has more
        than one scattered (non one-hot) level, the backward accumulates
        the table gradient of the one-hot prefix and of scattered level
        ``grad_phase % n_scattered`` only: every other scattered level's
        gradient is exactly 0 that step.

    Returns:
      [..., L*F] encoded features (f32), feature-within-level minor
      (level l, feature f at output column l*F + f).
    """
    return _HashEncode.apply(tables, x, config, grad_phase,
                             _descriptors(x.detach(), config))


def hash_encode_vjp(tables, x, config: HashGridConfig, grad_phase=None):
    """:func:`hash_encode`'s features, and the pullback of the positions
    alone: ``pullback(cot)`` gives d<features, cot>/dx (detached) from this
    encode's descriptors, with no second encode and no table gradient (no
    ``scatter_cols_accum``); the features stay differentiable in the
    caller's graph as :func:`hash_encode`'s are."""
    desc = _descriptors(x.detach(), config)
    out = _HashEncode.apply(tables, x, config, grad_phase, desc)

    def pullback(cot):
        with torch.no_grad():
            return _position_grad(tables.detach(), desc,
                                  _level_major(cot, config), config, x.shape,
                                  x.dtype)
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
