"""Multiresolution brick hash-grid encoding.

Counterpart of ``nerf_vo_tpu/ops/hash_grid.py``. The unit of storage is a
BRICK: the 3x3x3 corner lattice of a 2x2x2-cell region, 27 entries padded to
32. All 8 trilinear corners of a cell live in its brick, so each (sample,
level) reads exactly one brick. Levels whose brick lattice fits the table are
dense; finer levels hash the brick coordinate with Instant-NGP's primes.

Layout: the port's table is BRICK-MAJOR f32 ``[L * NB, 32F]`` (one brick per
contiguous row, entry-major / feature-minor), the transpose of the JAX
package's feature-major ``[32F, L * NB]``; :func:`tables_from_jax` converts.

:func:`hash_encode` is a ``torch.autograd.Function`` with gradients for the
table and the positions. Its table operations are the kernels of
``ops/gather_cuda.py`` (their plain versions on CPU tensors):

- forward: ``gather_interp_mm`` on the dense prefix levels with at most 512
  bricks (the JAX package's one-hot matmul levels), ``gather_interp`` on the
  rest, all those levels stacked level-major into one launch;
- backward, table: the per-descriptor rows ``W[t, e] * cot[t, f]`` go
  through ``scatter_cols_accum`` into an f32 gradient of the table's shape;
- on the card, ``gather_interp_mm`` and ``scatter_cols_accum`` keep the
  one-hot levels' table rows (:func:`_hot_rows`; level 0's 512 bricks in
  the field) in shared memory;
- backward, positions: ``gather_cols`` re-gathers the bf16 brick rows (they
  are not kept from the forward) and the ``dW / dfrac * res`` contraction is
  plain torch.

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
    """JAX feature-major ``[32F, L * NB]`` -> brick-major ``[L * NB, 32F]``."""
    return torch.from_numpy(np.ascontiguousarray(np.asarray(tables_np).T))


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


class _HashEncode(torch.autograd.Function):

    @staticmethod
    def forward(ctx, tables, x, config):
        L = config.n_levels
        F = config.features_per_level
        n = x.numel() // 3
        idx, local, frac, W, inside = _descriptors(x, config)
        split = _n_onehot(config) * n
        parts = []
        if split:
            parts.append(gc.gather_interp_mm(tables, idx[:split], W[:split],
                                             F, hot_rows=_hot_rows(config)))
        if split < L * n:
            parts.append(gc.gather_interp(tables, idx[split:], W[split:], F))
        feats = parts[0] if len(parts) == 1 else torch.cat(parts)  # [L*n, F]
        ctx.config = config
        ctx.x_shape = x.shape
        ctx.x_dtype = x.dtype
        ctx.save_for_backward(tables, idx, local, frac, W, inside)
        out = feats.reshape(L, n, F).permute(1, 0, 2)
        return out.reshape(x.shape[:-1] + (L * F,))

    @staticmethod
    def backward(ctx, cot):
        tables, idx, local, frac, W, inside = ctx.saved_tensors
        config = ctx.config
        L = config.n_levels
        F = config.features_per_level
        n = idx.shape[0] // L
        M = L * n
        # [n, L*F] -> [L*n, F], level-major like the descriptors
        cot = cot.reshape(n, L, F).permute(1, 0, 2).reshape(M, F).float()
        grad_tables = grad_x = None
        if ctx.needs_input_grad[0]:
            rows = (W[:, :, None] * cot[:, None, :]).reshape(M, _BRICK_PAD * F)
            grad_tables = gc.scatter_cols_accum(rows, idx, tables.shape[0],
                                                hot_rows=_hot_rows(config))
        if ctx.needs_input_grad[1]:
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
            grad_x = grad_x.reshape(ctx.x_shape).to(ctx.x_dtype)
        return grad_tables, grad_x, None


def hash_encode(tables, x, config: HashGridConfig):
    """Encode points with the multiresolution brick grid.

    Args:
      tables: brick-major ``[L * NB, 32F]`` f32 table (see
        :func:`init_tables`).
      x: [..., 3] positions in the unit cube [0, 1]^3 (values outside are
        clamped; callers apply scene contraction first).

    Returns:
      [..., L*F] encoded features (f32), feature-within-level minor
      (level l, feature f at output column l*F + f).
    """
    return _HashEncode.apply(tables, x, config)


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
