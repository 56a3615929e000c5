"""Hash-grid NeRF fields (nerfacto family).

Counterpart of ``nerf_vo_tpu/models/nerf_field.py`` for the fields the
nerfacto mapper runs by default: :class:`DenseProposalField` (one dense
level of density-logit bricks, F = 1) and :class:`NerfactoField` (hash grid
-> density + geometry feature; SH view directions + appearance embedding ->
rgb; geometry feature -> predicted normals).

The MLPs compute in bf16 as the JAX package's Flax ``MLP`` does: input,
weight and bias cast to bf16, the product and the bias add each rounded to
bf16, the output cast to f32. Parameters are f32. Initialization follows
Flax's defaults (truncated-normal LeCun kernels, zero biases) from a torch
seed; :func:`from_jax_params` carries a JAX parameter tree across instead.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
from torch import nn

from nerf_vo_tpu_torch.ops import hash_grid
from nerf_vo_tpu_torch.ops.hash_grid import HashGridConfig
from nerf_vo_tpu_torch.ops.sh import sh_encode


class _TruncExp(torch.autograd.Function):
    """exp with a clamped-input gradient (Instant-NGP's density
    activation)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.exp(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * torch.exp(x.clamp(-15.0, 15.0))


def trunc_exp(x):
    return _TruncExp.apply(x)


def _lecun_linear(in_dim: int, out_dim: int) -> nn.Linear:
    """nn.Linear with Flax Dense's default init: truncated-normal LeCun
    kernel (std 1/sqrt(fan_in) after truncation at 2 sigma), zero bias."""
    layer = nn.Linear(in_dim, out_dim)
    std = math.sqrt(1.0 / in_dim) / 0.87962566103423978
    nn.init.trunc_normal_(layer.weight, std=std, a=-2 * std, b=2 * std)
    nn.init.zeros_(layer.bias)
    return layer


class MLP(nn.Module):
    """``depth`` hidden ReLU layers of width ``hidden``, then a linear head;
    bf16 compute, f32 output."""

    def __init__(self, in_dim: int, hidden: int, depth: int, out_dim: int):
        super().__init__()
        dims = [in_dim] + [hidden] * depth + [out_dim]
        self.layers = nn.ModuleList(
            _lecun_linear(a, b) for a, b in zip(dims[:-1], dims[1:]))

    def forward(self, x):
        x = x.to(torch.bfloat16)
        last = len(self.layers) - 1
        for i, layer in enumerate(self.layers):
            x = torch.matmul(x, layer.weight.to(torch.bfloat16).t())
            x = x + layer.bias.to(torch.bfloat16)
            if i < last:
                x = torch.relu(x)
        return x.float()


class _UnitCube(nn.Module):
    def __init__(self, use_contraction: bool, aabb_min: float,
                 aabb_max: float):
        super().__init__()
        self.use_contraction = use_contraction
        self.aabb_min = aabb_min
        self.aabb_max = aabb_max

    def _to_unit(self, positions):
        if self.use_contraction:
            return hash_grid.contract_to_unit_cube(positions)
        return hash_grid.normalize_to_unit_cube(positions, self.aabb_min,
                                                self.aabb_max)


def dense_grid(resolution: int) -> HashGridConfig:
    """One dense level of F = 1 bricks at ``resolution``: the table holds
    the whole brick lattice (no hashing)."""
    bricks_per_axis = ((resolution - 1) >> 1) + 1
    needed = bricks_per_axis**3 * 32  # brick-padded entries
    return HashGridConfig(
        n_levels=1,
        features_per_level=1,
        log2_table_size=max(needed - 1, 1).bit_length(),
        base_resolution=resolution,
        max_resolution=resolution,
    )


class DenseProposalField(_UnitCube):
    """Dense voxel density grid -> density: the 1-level / 1-feature case of
    the brick grid at the proposal's resolution, storing density logits
    directly (no MLP). Its table is refreshed data, not a trained weight
    (distilled proposals): ``tables`` does not require grad."""

    def __init__(self, resolution: int = 128, use_contraction: bool = True,
                 aabb_min: float = -1.0, aabb_max: float = 1.0):
        super().__init__(use_contraction, aabb_min, aabb_max)
        self.resolution = resolution
        self.tables = nn.Parameter(hash_grid.init_tables(self.grid),
                                   requires_grad=False)

    @property
    def grid(self) -> HashGridConfig:
        return dense_grid(self.resolution)

    def forward(self, positions):
        """positions [..., 3] world-frame -> density [...]."""
        feat = hash_grid.hash_encode(self.tables, self._to_unit(positions),
                                     self.grid)
        return trunc_exp(feat[..., 0] - 1.0)


class NerfactoField(_UnitCube):
    """Hash-grid field with SH-encoded view directions and an appearance
    embedding: density(positions) -> (density, geo_feat);
    rgb(geo_feat, dirs, cam_idx); normals(geo_feat)."""

    def __init__(self, grid: HashGridConfig = HashGridConfig(),
                 geo_feat_dim: int = 15, hidden: int = 64,
                 appearance_dim: int = 32, num_images: int = 512,
                 sh_degree: int = 4, use_contraction: bool = True,
                 aabb_min: float = -1.0, aabb_max: float = 1.0,
                 predict_normals: bool = True):
        super().__init__(use_contraction, aabb_min, aabb_max)
        self.grid = grid
        self.geo_feat_dim = geo_feat_dim
        self.appearance_dim = appearance_dim
        self.sh_degree = sh_degree
        self.predict_normals = predict_normals
        self.density_mlp = MLP(grid.output_dim, hidden, 1, 1 + geo_feat_dim)
        self.color_mlp = MLP(sh_degree**2 + geo_feat_dim + appearance_dim,
                             hidden, 2, 3)
        self.embedding = nn.Embedding(num_images, appearance_dim)
        # Flax nn.Embed's default: normal with variance 1/num_embeddings
        nn.init.normal_(self.embedding.weight, std=1.0 / math.sqrt(num_images))
        if predict_normals:
            self.normal_mlp = MLP(geo_feat_dim, hidden, 2, 3)
        self.tables = nn.Parameter(hash_grid.init_tables(grid))

    def density(self, positions):
        return self.density_unit_features(self._to_unit(positions))

    def density_unit_features(self, unit_positions):
        feat = hash_grid.hash_encode(self.tables, unit_positions, self.grid)
        h = self.density_mlp(feat)
        return trunc_exp(h[..., 0] - 1.0), h[..., 1:]

    def density_unit(self, unit_positions):
        """Density at coordinates already in the unit cube."""
        return self.density_unit_features(unit_positions)[0]

    def rgb(self, geo_feat, directions, camera_indices=None):
        d = sh_encode(directions, self.sh_degree)
        shape = geo_feat.shape[:-1] + (self.appearance_dim,)
        if camera_indices is None:
            emb = geo_feat.new_zeros(shape)
        else:
            emb = self.embedding(camera_indices.long())
            if emb.dim() < geo_feat.dim():
                emb = emb[..., None, :]
            emb = emb.expand(shape)
        h = torch.cat([d, geo_feat, emb], dim=-1)
        return torch.sigmoid(self.color_mlp(h))

    def normals(self, geo_feat):
        n = self.normal_mlp(geo_feat)
        return n / torch.linalg.norm(n, dim=-1, keepdim=True).clamp(min=1e-7)


def _mlp_from_jax(prefix: str, tree) -> Dict[str, torch.Tensor]:
    out = {}
    for i in range(len(tree)):
        dense = tree[f"Dense_{i}"]
        out[f"{prefix}.layers.{i}.weight"] = torch.from_numpy(
            np.ascontiguousarray(np.asarray(dense["kernel"], np.float32).T))
        out[f"{prefix}.layers.{i}.bias"] = torch.from_numpy(
            np.asarray(dense["bias"], np.float32).copy())
    return out


def from_jax_params(params_np) -> Dict[str, torch.Tensor]:
    """One field's JAX parameter tree (nested numpy dicts) -> this module's
    ``state_dict``: feature-major tables transposed to brick-major, each
    Dense kernel ``[in, out]`` to a Linear weight ``[out, in]``, ``Embed``
    to ``Embedding``."""
    out = {"tables": hash_grid.tables_from_jax(params_np["tables"])}
    for name in ("density_mlp", "color_mlp", "normal_mlp"):
        if name in params_np:
            out.update(_mlp_from_jax(name, params_np[name]))
    if "embedding" in params_np:
        out["embedding.weight"] = torch.from_numpy(np.asarray(
            params_np["embedding"]["embedding"], np.float32).copy())
    return out
