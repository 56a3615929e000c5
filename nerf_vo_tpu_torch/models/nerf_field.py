"""Hash-grid NeRF fields (nerfacto family).

Counterpart of ``nerf_vo_tpu/models/nerf_field.py``: the three proposal
fields, :class:`DenseProposalField` (one dense level of density-logit
bricks, F = 1, in an f32 or bf16 table), :class:`ProposalDensityField`
(nerfstudio's ``HashMLPDensityField``: a 5-level F = 2 hash grid and a
16-wide MLP) and :class:`MLPProposalField` (a Fourier-feature MLP, no
table), and :class:`NerfactoField` (hash grid -> density + geometry
feature; SH view directions + appearance embedding -> rgb; geometry
feature -> predicted normals), and :class:`SDFField` (Neuralangelo's signed
distance field on the same hash grid: ``[x, features]`` -> an f32
weight-normed softplus MLP -> SDF and a 256-wide feature; ``[x, SH view,
normal, feature]`` -> a weight-normed bf16 colour MLP -> rgb).

The MLPs compute in bf16 as the JAX package's Flax ``MLP`` does: input,
weight and bias cast to bf16, the product and the bias add each rounded to
bf16, the output cast to f32. Parameters are f32. Initialization follows
Flax's defaults (truncated-normal LeCun kernels, zero biases) from a torch
seed; :func:`from_jax_params` carries a JAX parameter tree across instead.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F_
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
    """Positions -> the unit cube; and, for a field with a table, the
    model axis its table rows are sharded over (``model_group``, the JAX
    package's ``model_axis``; ``model_axis_size`` shards; None: the whole
    table) and ``descriptor_sharding`` (see ``hash_grid.hash_encode``)."""

    def __init__(self, use_contraction: bool, aabb_min: float,
                 aabb_max: float, model_group=None,
                 model_axis_size: int = 1, descriptor_sharding: bool = False):
        super().__init__()
        self.use_contraction = use_contraction
        self.aabb_min = aabb_min
        self.aabb_max = aabb_max
        self.model_group = model_group
        self.model_axis_size = model_axis_size
        self.descriptor_sharding = descriptor_sharding

    def _tp(self):
        return dict(group=self.model_group,
                    descriptor_sharding=self.descriptor_sharding)

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


class ProposalDensityField(_UnitCube):
    """Small hash grid -> density (nerfstudio's ``HashMLPDensityField``):
    the grid's features through a ``hidden``-wide 1-layer MLP, then
    ``trunc_exp(h - 1)``. Its table and MLP are trained weights."""

    def __init__(self, grid: HashGridConfig = HashGridConfig(5, 2, 17, 16,
                                                             256),
                 hidden: int = 16, use_contraction: bool = True,
                 aabb_min: float = -1.0, aabb_max: float = 1.0, **tp):
        super().__init__(use_contraction, aabb_min, aabb_max, **tp)
        self.grid = grid
        self.mlp = MLP(grid.output_dim, hidden, 1, 1)
        self.tables = nn.Parameter(hash_grid.init_tables(
            grid, shard=self.model_axis_size))

    def forward(self, positions):
        """positions [..., 3] world-frame -> density [...]."""
        feat = hash_grid.hash_encode(self.tables, self._to_unit(positions),
                                     self.grid, **self._tp())
        return trunc_exp(self.mlp(feat)[..., 0] - 1.0)


class MLPProposalField(_UnitCube):
    """Fourier-feature MLP -> density: no table, so no table kernel. It
    trains by distillation from the field (``NerfactoModel.loss``)."""

    def __init__(self, n_freqs: int = 6, hidden: int = 64, depth: int = 2,
                 use_contraction: bool = True, aabb_min: float = -1.0,
                 aabb_max: float = 1.0, **tp):
        # no table: its weights replicate over a model axis
        super().__init__(use_contraction, aabb_min, aabb_max)
        self.n_freqs = n_freqs
        self.mlp = MLP(3 + 6 * n_freqs, hidden, depth, 1)

    def _encode(self, unit):
        # NeRF positional encoding on [-1, 1]^3: [x, sin/cos(2^k pi x)]
        x = unit * 2.0 - 1.0
        k = 2.0 ** torch.arange(self.n_freqs, dtype=torch.float32,
                                device=x.device) * math.pi
        ang = x[..., None] * k  # [..., 3, n_freqs]
        enc = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).reshape(
            x.shape[:-1] + (6 * self.n_freqs,))
        return torch.cat([x, enc], dim=-1)

    def logit_unit(self, unit_positions):
        """Density logit at unit-cube coordinates (before the ``- 1``
        shift): the distillation's prediction space."""
        return self.mlp(self._encode(unit_positions))[..., 0]

    def logit(self, positions):
        """Density logit at world coordinates."""
        return self.logit_unit(self._to_unit(positions))

    def forward(self, positions):
        """positions [..., 3] world-frame -> density [...]."""
        return trunc_exp(self.logit(positions) - 1.0)


class DenseProposalField(_UnitCube):
    """Dense voxel density grid -> density: the 1-level / 1-feature case of
    the brick grid at the proposal's resolution, storing density logits
    directly (no MLP). Distilled proposals refresh the table as data
    (``trainable=False``: it does not require grad); under the interlevel
    loss it is a trained weight. ``table_dtype`` "bfloat16" stores the
    table in bf16 (the encode reads it as bf16 either way)."""

    def __init__(self, resolution: int = 128, use_contraction: bool = True,
                 aabb_min: float = -1.0, aabb_max: float = 1.0,
                 table_dtype: str = "float32", trainable: bool = False,
                 **tp):
        super().__init__(use_contraction, aabb_min, aabb_max, **tp)
        self.resolution = resolution
        if table_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"table_dtype {table_dtype!r}: 'float32' or "
                             "'bfloat16'")
        self.tables = nn.Parameter(
            hash_grid.init_tables(self.grid, shard=self.model_axis_size).to(
                getattr(torch, table_dtype)),
            requires_grad=trainable)

    @property
    def grid(self) -> HashGridConfig:
        return dense_grid(self.resolution)

    def forward(self, positions):
        """positions [..., 3] world-frame -> density [...]."""
        feat = hash_grid.hash_encode(self.tables, self._to_unit(positions),
                                     self.grid, **self._tp())
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
                 predict_normals: bool = True, **tp):
        super().__init__(use_contraction, aabb_min, aabb_max, **tp)
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
        self.tables = nn.Parameter(hash_grid.init_tables(
            grid, shard=self.model_axis_size))

    def density(self, positions, grad_phase=None):
        """(density, geo_feat) at world positions. ``grad_phase``: the
        train step, where the table gradient is phased (see
        ``hash_grid.hash_encode``)."""
        return self.density_unit_features(self._to_unit(positions),
                                          grad_phase)

    def density_unit_features(self, unit_positions, grad_phase=None):
        feat = hash_grid.hash_encode(self.tables, unit_positions, self.grid,
                                     grad_phase, **self._tp())
        h = self.density_mlp(feat)
        return trunc_exp(h[..., 0] - 1.0), h[..., 1:]

    def density_and_gradient(self, positions, grad_phase=None):
        """(density, geo_feat, g): the density and geometry feature as
        :meth:`density` gives them, in the caller's graph, and
        g = d(density)/d(positions), detached (a normal target). g comes
        from the same encode: the MLP's input gradient, then the hash
        grid's position pullback (``hash_encode_vjp``: no table gradient is
        made for it), then the contraction's."""
        p = positions.detach().requires_grad_(True)
        with torch.enable_grad():
            unit_p = self._to_unit(p)
        unit = self._to_unit(positions)
        feat, pullback = hash_grid.hash_encode_vjp(
            self.tables, unit, self.grid, grad_phase, **self._tp())
        with torch.enable_grad():
            if not feat.requires_grad:
                feat.requires_grad_(True)
            h = self.density_mlp(feat)
            density = trunc_exp(h[..., 0] - 1.0)
            (g_feat,) = torch.autograd.grad(
                density, feat, torch.ones_like(density), retain_graph=True)
            (g,) = torch.autograd.grad(unit_p, p, pullback(g_feat))
        return density, h[..., 1:], g

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


# Neuralangelo's field, losses and optimizer (Li et al., CVPR 2023;
# ``projects/neuralangelo/configs/base.yaml``); the hash grid's levels,
# features and table size are :class:`NerfactoConfig`'s
SDF_MIN_RES = 32  # the grid's coarsest resolution
SDF_HIDDEN = 256  # the SDF MLP's hidden width and feature width
SDF_BETA = 100.0  # softplus
SDF_COLOR_HIDDEN = 256
SDF_COLOR_DEPTH = 4
SDF_SH_DEGREE = 3  # 9 view coefficients
SDF_OUT_BIAS = 0.5  # the geometric init's sphere radius
SDF_INIT_S = 3.0  # s_var; inv_s = exp(s_var)
SDF_UPSAMPLE_INV_S = 64.0  # up-sampling round h: SDF_UPSAMPLE_INV_S * 2**h
SDF_EIKONAL_MULT = 0.1
SDF_CURVATURE_MULT = 5e-4  # divided by growth**(active - c2f_init)
SDF_LEARNING_RATE = 1e-3  # AdamW
SDF_WEIGHT_DECAY = 1e-2
SDF_LR_STEPS = (4915, 6554)  # each divides the learning rate by SDF_LR_GAMMA
SDF_LR_GAMMA = 10.0


@dataclasses.dataclass(frozen=True)
class SDFConfig:
    """Neuralangelo's sample counts and schedules, the step counts scaled
    from its 500k iterations to a mapper's 8192."""

    num_samples: int = 64  # stratified
    num_importance: int = 16  # each up-sampling round's samples
    upsample_rounds: int = 4
    c2f_init: int = 4  # active levels at step 0
    c2f_step: int = 82  # one more level every c2f_step steps
    anneal_end: int = 819  # the NeuS cosine anneal's last step
    warm_up_end: int = 82  # linear warm-up of the learning rate


# Neuralangelo's four-tap tetrahedron: sum k = 0, sum k k^T = 4 I
SDF_TAPS = ((1.0, -1.0, -1.0), (-1.0, -1.0, 1.0), (-1.0, 1.0, -1.0),
            (1.0, 1.0, 1.0))


class _WNLinear(nn.Module):
    """A linear layer under weight normalization (``torch.nn.utils.
    weight_norm`` at dim 0): ``weight = weight_v * (weight_g /
    ||weight_v||)``, row by row."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.weight_v = nn.Parameter(torch.empty(out_dim, in_dim))
        self.weight_g = nn.Parameter(torch.empty(out_dim, 1))
        self.bias = nn.Parameter(torch.zeros(out_dim))

    def weight(self):
        return self.weight_v * (self.weight_g / torch.linalg.vector_norm(
            self.weight_v, dim=1, keepdim=True))

    @torch.no_grad()
    def reset_g(self) -> None:
        """g = ||v||, so that the layer starts at weight v."""
        self.weight_g.copy_(torch.linalg.vector_norm(
            self.weight_v, dim=1, keepdim=True))


class SDFField(_UnitCube):
    """Neuralangelo's signed distance field on the brick hash grid.

    Positions are world coordinates; :meth:`to_sphere` maps the scene's
    bounding sphere (centre and radius from the AABB) to the unit sphere,
    and the grid covers [-1, 1]^3 of it. The SDF MLP takes ``[x,
    features]`` (levels at or above ``active`` multiplied by 0), has one
    softplus hidden layer and gives the SDF and a ``SDF_HIDDEN``-wide
    feature, all in float32: its four-tap differences at ~1/3547 would be noise
    after a bf16 rounding of its input. The colour MLP ("idr" mode) takes
    ``[x, SH view, normal, feature]`` and computes in bf16 as :class:`MLP`
    does. Both are weight-normed. ``s_var`` is NeuS's learnable sharpness.
    Initialization: Neuralangelo's geometric init of the SDF MLP (inside
    out: positive inside the sphere of radius ``SDF_OUT_BIAS``),
    the colour MLP as :func:`_lecun_linear`, tables as Instant-NGP."""

    def __init__(self, grid: HashGridConfig, aabb_min: float = -1.0,
                 aabb_max: float = 1.0, **tp):
        super().__init__(False, aabb_min, aabb_max, **tp)
        self.grid = grid
        h = SDF_HIDDEN
        n_in = 3 + grid.output_dim
        self.sdf_mlp = nn.ModuleList([_WNLinear(n_in, h),
                                      _WNLinear(h, 1 + h)])
        dims = ([3 + SDF_SH_DEGREE**2 + 3 + h]
                + [SDF_COLOR_HIDDEN] * SDF_COLOR_DEPTH + [3])
        self.color_mlp = nn.ModuleList(
            _WNLinear(a, b) for a, b in zip(dims[:-1], dims[1:]))
        self.s_var = nn.Parameter(torch.tensor(SDF_INIT_S))
        self.tables = nn.Parameter(hash_grid.init_tables(
            grid, shard=self.model_axis_size))
        F = grid.features_per_level
        self.register_buffer("level_of_col", torch.div(
            torch.arange(grid.output_dim), F, rounding_mode="floor").float(),
            persistent=False)
        self.register_buffer("taps", torch.tensor(SDF_TAPS),
                             persistent=False)
        self._init_mlps()

    @torch.no_grad()
    def _init_mlps(self) -> None:
        first, last = self.sdf_mlp
        k0 = first.weight_v.shape[0]
        nn.init.normal_(first.weight_v, 0.0, math.sqrt(2) / math.sqrt(k0))
        first.weight_v[:, 3:] = 0.0  # the features start out of the SDF
        nn.init.zeros_(first.bias)
        k1 = last.weight_v.shape[1]
        # inside out: the indoor room's free space is inside the sphere
        nn.init.normal_(last.weight_v, -math.sqrt(math.pi / k1), 1e-4)
        nn.init.constant_(last.bias, SDF_OUT_BIAS)
        for layer in self.color_mlp:
            a = layer.weight_v.shape[1]
            std = math.sqrt(1.0 / a) / 0.87962566103423978
            nn.init.trunc_normal_(layer.weight_v, std=std, a=-2 * std,
                                  b=2 * std)
            nn.init.zeros_(layer.bias)
        for layer in list(self.sdf_mlp) + list(self.color_mlp):
            layer.reset_g()

    @property
    def radius(self) -> float:
        return 0.5 * (self.aabb_max - self.aabb_min)

    def to_sphere(self, positions):
        """World positions -> the unit sphere's frame."""
        centre = 0.5 * (self.aabb_min + self.aabb_max)
        return (positions - centre) / self.radius

    def level_mask(self, active):
        """[L*F] 1 for the features of levels below ``active`` (a 0-dim
        tensor or a number), else 0."""
        return (self.level_of_col < active).float()

    def sdf_head(self, h):
        """The SDF MLP in float32: [..., 3 + L*F] -> [..., 1 + hidden]."""
        first, last = self.sdf_mlp
        h = F_.softplus(F_.linear(h, first.weight(), first.bias),
                        beta=SDF_BETA)
        return F_.linear(h, last.weight(), last.bias)

    def sdf_out(self, xs, active):
        """[..., 3] positions in the sphere's frame -> [..., 1 + hidden]:
        the SDF, then the feature. One encode of every point."""
        feat = hash_grid.hash_encode(self.tables, (xs + 1.0) * 0.5,
                                     self.grid, **self._tp())
        feat = feat * self.level_mask(active)
        return self.sdf_head(torch.cat([xs, feat], dim=-1))

    def sdf_value(self, xs, active):
        return self.sdf_out(xs, active)[..., 0]

    def rgb(self, xs, directions, normals, feature):
        """The colour MLP on ``[x, SH(directions), normals, feature]``:
        bf16 compute (each product and bias add rounded), sigmoid."""
        h = torch.cat([xs, sh_encode(directions, SDF_SH_DEGREE),
                       normals, feature], dim=-1).to(torch.bfloat16)
        last = len(self.color_mlp) - 1
        for i, layer in enumerate(self.color_mlp):
            h = torch.matmul(h, layer.weight().to(torch.bfloat16).t())
            h = h + layer.bias.to(torch.bfloat16)
            if i < last:
                h = torch.relu(h)
        return torch.sigmoid(h.float())


def _mlp_from_jax(prefix: str, tree) -> Dict[str, torch.Tensor]:
    out = {}
    for i in range(len(tree)):
        dense = tree[f"Dense_{i}"]
        out[f"{prefix}.layers.{i}.weight"] = torch.from_numpy(
            np.array(np.asarray(dense["kernel"], np.float32).T))
        out[f"{prefix}.layers.{i}.bias"] = torch.from_numpy(
            np.asarray(dense["bias"], np.float32).copy())
    return out


def from_jax_params(params_np) -> Dict[str, torch.Tensor]:
    """One field's JAX parameter tree (nested numpy dicts) -> this module's
    ``state_dict``: feature-major tables transposed to brick-major (in
    their dtype), each Dense kernel ``[in, out]`` to a Linear weight
    ``[out, in]`` (a proposal field's ``MLP_0`` is its ``mlp``), ``Embed``
    to ``Embedding``."""
    out = {}
    if "tables" in params_np:
        out["tables"] = hash_grid.tables_from_jax(params_np["tables"])
    for name, port in (("density_mlp", "density_mlp"),
                       ("color_mlp", "color_mlp"),
                       ("normal_mlp", "normal_mlp"), ("MLP_0", "mlp")):
        if name in params_np:
            out.update(_mlp_from_jax(port, params_np[name]))
    if "embedding" in params_np:
        out["embedding.weight"] = torch.from_numpy(np.asarray(
            params_np["embedding"]["embedding"], np.float32).copy())
    return out
