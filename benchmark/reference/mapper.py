"""Plain PyTorch reference of one NeRF mapping train step.

It imports torch alone: nothing of the program. It follows the port's
plain paths (``models/nerfacto.py``, ``models/nerf_field.py``,
``ops/hash_grid.py`` and the plain versions in ``ops/gather_cuda.py``,
``ops/rendering.py``, ``ops/losses.py``,
``mapping/keyframe_buffer.py``, ``mapping/trainer.py``,
``core/{lie,cameras,conventions}.py``, ``ops/sh.py``), frozen here for the
mapper the benchmark runs: nerfacto at its published widths (a 16 x 2
hash field, two 5 x 2 hash proposal fields at 128 and 256 trained by the
interlevel loss, 256 + 96 proposal and 48 field samples, density-gradient
normals at every final sample) with the DS-NeRF depth loss. Where the port
has a kernel, the reference has the function the kernel computes, in plain
operations: the hash grid's table read is an indexing of ``bf16(table)``
rows, its interpolation a weighted sum, and both its gradients (table and
positions) come from autograd.

``low`` puts the reference in the control's place: every float32 tensor
of the step (positions, trilinear weights, interpolation, rendering,
losses and their gradients) is computed in bfloat16, the step below the
float32 the configuration states; the MLPs stay in bfloat16 and the
optimizers' state in float32.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Sequence, Tuple

import torch

BF16 = torch.bfloat16
_PRIMES = (1, 2654435761, 805459861)  # Instant-NGP spatial hash primes
_BRICK, _BRICK_PAD = 27, 32


# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Grid:
    n_levels: int
    features: int
    log2_table_size: int
    base: int
    max_res: int

    @property
    def bricks_per_level(self) -> int:
        return max((1 << self.log2_table_size) // _BRICK_PAD, 1)

    @property
    def resolutions(self) -> Sequence[int]:
        if self.n_levels == 1:
            return (self.base,)
        growth = math.exp((math.log(self.max_res) - math.log(self.base))
                          / (self.n_levels - 1))
        return tuple(int(math.floor(self.base * growth**l))
                     for l in range(self.n_levels))


# nerfacto's published mapper, as ``mapping_model_overrides`` sets it on the
# port's nerfstudio module; the only one the reference runs
PUBLISHED = {"num_grid_levels": 16, "grid_features_per_level": 2,
             "log2_hashmap_size": 19, "max_res": 2048,
             "proposal_type": "hash", "proposal_training": "interlevel",
             "num_proposal_samples": [256, 96], "num_nerf_samples": 48,
             "grad_normal_mode": "samples"}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """The mapper the configuration runs: nerfacto's published widths and
    the port's nerfstudio settings around them."""

    num_images: int
    near: float = 0.05
    far: float = 20.0
    num_proposal_samples: Tuple[int, ...] = (256, 96)
    num_nerf_samples: int = 48
    interlevel_loss_mult: float = 1.0
    distortion_loss_mult: float = 0.002
    depth_loss_mult: float = 0.001
    depth_sigma: float = 0.001
    orientation_loss_mult: float = 1e-4
    pred_normal_loss_mult: float = 1e-3
    max_res: int = 2048
    log2_hashmap_size: int = 19
    num_grid_levels: int = 16
    grid_features_per_level: int = 2
    proposal_resolutions: Tuple[int, ...] = (128, 256)
    proposal_hidden: int = 16
    hidden: int = 64
    geo_feat_dim: int = 15
    appearance_dim: int = 32
    sh_degree: int = 4

    @property
    def field_grid(self) -> Grid:
        return Grid(self.num_grid_levels, self.grid_features_per_level,
                    self.log2_hashmap_size, 16, self.max_res)

    @property
    def proposal_grids(self) -> List[Grid]:
        """nerfstudio's HashMLPDensityField grids: 5 levels of 2 features,
        2^17 entries a level, from 16 to each proposal's resolution."""
        n = len(self.num_proposal_samples)
        return [Grid(5, 2, 17, 16, r) for r in self.proposal_resolutions[:n]]


def model_config(cfg: Dict) -> ModelConfig:
    """The mapper of a run configuration: ``mapping_module: nerfstudio``
    with ``mapping_model_overrides`` setting nerfacto's published widths
    (``PUBLISHED``); any other mapper raises."""
    if "normal" in cfg.get("enhancement_module", "depth"):
        raise NotImplementedError("the reference has no normal channel")
    if cfg.get("mapping_module", "nerfstudio") != "nerfstudio" or \
            cfg.get("mapping_model_overrides") != PUBLISHED:
        raise NotImplementedError("the reference runs nerfacto at its "
                                  "published widths only")
    return ModelConfig(
        num_images=cfg["num_keyframes"],
        depth_loss_mult=cfg.get("depth_supervision_lambda", 0.001))


def _mlp_dims(mc: ModelConfig) -> Dict[str, List[int]]:
    F = mc.grid_features_per_level * mc.num_grid_levels
    h, g = mc.hidden, mc.geo_feat_dim
    return {"density_mlp": [F, h, 1 + g],
            "color_mlp": [mc.sh_degree**2 + g + mc.appearance_dim, h, h, 3],
            "normal_mlp": [g, h, h, 3]}


def _trunc_normal(shape, std, g, device):
    """Normal of ``std`` truncated at 2 std, by the inverse CDF (one call)."""
    lo = 0.5 * (1 + math.erf(-2 / math.sqrt(2)))
    u = torch.rand(shape, generator=g, device=device) * (1 - 2 * lo) + lo
    return torch.erfinv(2 * u - 1) * math.sqrt(2) * std


@torch.no_grad()
def init_params(mc: ModelConfig, seed: int, device) -> Dict[str, torch.Tensor]:
    """The mapper's weights from ``seed``, made on ``device`` one call a
    tensor, named as the port's ``NerfactoModel`` state dict names them:
    tables U(-1e-4, 1e-4) (Instant-NGP), Dense kernels LeCun normal
    truncated at 2 std, zero biases, the appearance embedding normal with
    variance 1 / num_images (Flax's defaults)."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1000003 + 5) & (2**63 - 1))
    out = {}

    def table(grid):
        return (torch.rand(grid.n_levels * grid.bricks_per_level,
                           32 * grid.features, generator=g, device=device)
                * 2e-4 - 1e-4)

    def dense(prefix, dims):
        for j, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
            std = math.sqrt(1.0 / a) / 0.87962566103423978
            out[f"{prefix}.layers.{j}.weight"] = _trunc_normal(
                (b, a), std, g, device)
            out[f"{prefix}.layers.{j}.bias"] = torch.zeros(b, device=device)

    for i, grid in enumerate(mc.proposal_grids):
        out[f"proposal_fields.{i}.tables"] = table(grid)
        dense(f"proposal_fields.{i}.mlp",
              [grid.n_levels * grid.features, mc.proposal_hidden, 1])
    for name, dims in _mlp_dims(mc).items():
        dense(f"field.{name}", dims)
    out["field.embedding.weight"] = torch.randn(
        mc.num_images, mc.appearance_dim, generator=g, device=device
    ) / math.sqrt(mc.num_images)
    out["field.tables"] = table(mc.field_grid)
    return out


# ---------------------------------------------------------------------------
# hash grid (plain: rows of bf16(table), a weighted sum, autograd)
# ---------------------------------------------------------------------------

def _brick_ids(c, res: int, n_bricks: int, level: int):
    bpa = ((res - 1) >> 1) + 1
    if bpa**3 <= n_bricks:
        bid = (c[0] * bpa + c[1]) * bpa + c[2]
    else:
        mask = 0xFFFFFFFF
        h = (((c[0] * _PRIMES[0]) & mask) ^ ((c[1] * _PRIMES[1]) & mask)
             ^ ((c[2] * _PRIMES[2]) & mask))
        bid = h % n_bricks
    return bid + level * n_bricks


def _axis_weights(lo, f):
    i3 = torch.arange(3, device=lo.device)
    return (i3 == lo[:, None]) * (1.0 - f[:, None]) + (
        i3 == lo[:, None] + 1) * f[:, None]


def encode(tables, x, grid: Grid, low: bool = False):
    """[..., 3] unit-cube points -> [..., L*F] features, differentiable in
    the table and the points. Each (level, point) reads the brick of its
    cell; the 8 corners' values are bf16(table) entries weighted
    trilinearly (the 19 other entries of the brick and the padding weigh
    0)."""
    dt = BF16 if low else torch.float32
    L, F, NB = grid.n_levels, grid.features, grid.bricks_per_level
    xt = x.reshape(-1, 3).to(dt).clamp(0.0, 1.0)
    n = xt.shape[0]
    # the bf16 shadow of the table, with an exact f32 gradient
    if low:
        vals = tables.to(BF16)
    else:
        vals = tables + (tables.to(BF16).float() - tables).detach()
    feats = []
    for l, res in enumerate(grid.resolutions):
        xs = xt * float(res)
        fl = torch.floor(xs).detach()
        c = fl.long().clamp(0, res - 1)
        frac = xs - fl
        local = c & 1
        ids = _brick_ids((c >> 1).T, res, NB, l)
        w = [_axis_weights(local[:, a], frac[:, a]) for a in range(3)]
        W = (w[0][:, :, None, None] * w[1][:, None, :, None]
             * w[2][:, None, None, :]).reshape(n, _BRICK)
        rows = vals[ids].reshape(n, 32, F)[:, :_BRICK]
        feats.append(torch.sum(W[:, :, None] * rows, dim=1))
    return torch.cat(feats, -1).reshape(x.shape[:-1] + (L * F,))


def contract_to_unit_cube(x):
    norm = torch.amax(torch.abs(x), dim=-1, keepdim=True).clamp(min=1e-7)
    c = torch.where(norm <= 1.0, x, (2.0 - 1.0 / norm) * x / norm)
    return (c + 2.0) * 0.25


class _TruncExp(torch.autograd.Function):
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


def mlp(p: Dict[str, torch.Tensor], prefix: str, n: int, x, out_dt):
    """ReLU MLP in bf16: input, weight and bias cast to bf16, each product
    and bias add rounded to bf16."""
    x = x.to(BF16)
    for i in range(n):
        x = torch.matmul(x, p[f"{prefix}.layers.{i}.weight"].to(BF16).t())
        x = x + p[f"{prefix}.layers.{i}.bias"].to(BF16)
        if i < n - 1:
            x = torch.relu(x)
    return x.to(out_dt)


def sh_encode(d):
    """Real SH basis of degree 4 at unit directions [..., 3] -> [..., 16]."""
    x, y, z = d.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, yz, xz = x * y, y * z, x * z
    return torch.stack([
        torch.full_like(x, 0.28209479177387814),
        -0.48860251190291987 * y, 0.48860251190291987 * z,
        -0.48860251190291987 * x,
        1.0925484305920792 * xy, -1.0925484305920792 * yz,
        0.94617469575755997 * zz - 0.31539156525251999,
        -1.0925484305920792 * xz, 0.54627421529603959 * (xx - yy),
        0.59004358992664352 * y * (-3.0 * xx + yy),
        2.8906114426405538 * xy * z,
        0.45704579946446572 * y * (1.0 - 5.0 * zz),
        0.3731763325901154 * z * (5.0 * zz - 3.0),
        0.45704579946446572 * x * (1.0 - 5.0 * zz),
        1.4453057213202769 * z * (xx - yy),
        0.59004358992664352 * x * (-xx + 3.0 * yy)], -1)


# ---------------------------------------------------------------------------
# rendering and losses
# ---------------------------------------------------------------------------

def s_to_t(s, mc: ModelConfig):
    """Disparity spacing: s in [0, 1] -> t in [near, far]."""
    return 1.0 / ((1.0 - s) / mc.near + s / mc.far)


def uniform_bins(u, n: int):
    edges = torch.arange(n + 1, dtype=torch.float32,
                         device=u.device).to(u.dtype) / n
    noise = u - 0.5
    noise[:, 0] = 0.0
    noise[:, -1] = 0.0
    return edges + noise * (1.0 / n)


def sample_pdf(s_edges, weights, n: int, u, padding: float = 0.01):
    B = weights.shape[1]
    weights = weights + padding
    pdf = weights / torch.sum(weights, dim=-1, keepdim=True)
    cdf = torch.cat([torch.zeros_like(pdf[:, :1]), torch.cumsum(pdf, -1)], -1)
    cdf = cdf.clamp(max=1.0)
    cdf[:, -1] = 1.0
    q = torch.arange(n + 1, dtype=cdf.dtype, device=cdf.device)
    u = ((q + u) / (n + 1)).contiguous()
    k = torch.searchsorted(cdf.contiguous(), u, right=True)
    below = (k - 1).clamp(min=0)
    above = k.clamp(max=B)
    cb, ca = torch.gather(cdf, 1, below), torch.gather(cdf, 1, above)
    sb, sa = torch.gather(s_edges, 1, below), torch.gather(s_edges, 1, above)
    frac = ((u - cb) / (ca - cb).clamp(min=1e-8)).clamp(0.0, 1.0)
    new = sb + frac * (torch.maximum(sa, sb) - sb)
    return torch.cummax(new, dim=-1).values.detach()


def render_weights(density, deltas):
    a = density * deltas
    trans = torch.exp(-torch.cat([torch.zeros_like(a[:, :1]),
                                  torch.cumsum(a[:, :-1], -1)], -1))
    return (1.0 - torch.exp(-a)) * trans


def distortion_loss(s_edges, w):
    s_mid = 0.5 * (s_edges[..., 1:] + s_edges[..., :-1])
    ds = s_edges[..., 1:] - s_edges[..., :-1]
    cw = torch.cumsum(w, -1)
    cwm = torch.cumsum(w * s_mid, -1)
    cw_prev = torch.cat([torch.zeros_like(cw[..., :1]), cw[..., :-1]], -1)
    cwm_prev = torch.cat([torch.zeros_like(cwm[..., :1]), cwm[..., :-1]], -1)
    inter = 2.0 * torch.sum(w * (s_mid * cw_prev - cwm_prev), -1)
    intra = torch.sum(w**2 * ds, -1) / 3.0
    return torch.mean(inter + intra)


def ds_nerf_depth_loss(w, t_mid, deltas, d, sigma, mask):
    d = d.reshape(-1, 1)
    ll = torch.exp(-((t_mid - d) ** 2) / (2.0 * sigma**2)) * deltas
    loss = -torch.log(torch.sum(w * ll, -1) + 1e-7)
    valid = (d[:, 0] > 0).to(loss.dtype) * mask.to(loss.dtype)
    return torch.sum(loss * valid) / torch.sum(valid).clamp(min=1.0)


def interlevel_loss(p_edges, p_w, f_edges, f_w):
    """A proposal histogram against the final one (stop-gradient): the
    mass the proposal puts over each final bin, by two indicator
    contractions, below the final weight, squared over it."""
    f_w, f_edges = f_w.detach(), f_edges.detach()
    lo, hi = f_edges[..., :-1], f_edges[..., 1:]
    left = (p_edges[..., 1:, None] <= lo[..., None, :]).to(p_w.dtype)
    right = (p_edges[..., :-1, None] < hi[..., None, :]).to(p_w.dtype)
    bound = torch.einsum("rb,rbk->rk", p_w, right) \
        - torch.einsum("rb,rbk->rk", p_w, left)
    clipped = (f_w - bound).clamp(min=0.0)
    return torch.mean(clipped**2 / f_w.clamp(min=1e-7))


# ---------------------------------------------------------------------------
# poses and rays
# ---------------------------------------------------------------------------

def se3_exp_matrix(xi):
    """[K, 6] tangent [rho, phi] -> [K, 4, 4] (quaternion route, as the
    port's ``lie.se3_exp`` then ``se3_matrix``)."""
    rho, phi = xi[..., :3], xi[..., 3:6]
    eps = 1e-8
    th2 = torch.sum(phi * phi, -1, keepdim=True)
    th = torch.sqrt(th2.clamp(min=eps))
    small = th2 < 1e-8
    k = torch.where(small, 0.5 - th2 / 48.0, torch.sin(0.5 * th) / th)
    qw = torch.where(small, 1.0 - th2 / 8.0, torch.cos(0.5 * th))
    qx, qy, qz = (phi * k).unbind(-1)
    qw = qw[..., 0]
    # left Jacobian
    x, y, z = phi.unbind(-1)
    zero = torch.zeros_like(x)
    P = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero],
                    -1).reshape(phi.shape[:-1] + (3, 3))
    t2 = th2[..., 0]
    t1 = torch.sqrt(t2.clamp(min=eps))
    sm = t2 < 1e-8
    a = torch.where(sm, 0.5 - t2 / 24.0,
                    (1 - torch.cos(t1)) / t2.clamp(min=eps))
    b = torch.where(sm, 1.0 / 6.0 - t2 / 120.0,
                    (t1 - torch.sin(t1)) / (t2 * t1).clamp(min=eps))
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device).expand(P.shape)
    J = eye + a[..., None, None] * P + b[..., None, None] * (P @ P)
    t = (J @ rho[..., None])[..., 0]
    xx, yy, zz = qx * qx, qy * qy, qz * qz
    xy, xz, yz = qx * qy, qx * qz, qy * qz
    wx, wy, wz = qw * qx, qw * qy, qw * qz
    R = torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
                     2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
                     2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)],
                    -1).reshape(phi.shape[:-1] + (3, 3))
    top = torch.cat([R, t[..., None]], -1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=xi.dtype,
                          device=xi.device).expand(xi.shape[:-1] + (1, 4))
    return torch.cat([top, bottom], -2)


def generate_rays(c2w, intr, xy):
    """OpenGL pinhole rays: (origins, unit directions, norm of the
    unit-(-z) direction)."""
    fx, fy, cx, cy = intr.unbind(-1)
    u, v = xy.unbind(-1)
    x, y = (u - cx) / fx, (v - cy) / fy
    d_cam = torch.stack([x, -y, -torch.ones_like(x)], -1)
    d = torch.einsum("...ij,...j->...i", c2w[..., :3, :3], d_cam)
    norm = torch.linalg.norm(d, dim=-1, keepdim=True)
    return c2w[..., :3, 3].expand(d.shape), d / norm.clamp(min=1e-8), norm


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

class Adam:
    """torch.optim.Adam's update (betas 0.9 / 0.999), on f32 tensors."""

    def __init__(self, params: List[torch.Tensor], eps: float):
        self.params, self.eps, self.t = params, eps, 0
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]

    @torch.no_grad()
    def step(self, grads, lr: float):
        self.t += 1
        b1, b2 = 0.9, 0.999
        c1, c2 = 1 - b1**self.t, 1 - b2**self.t
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            m.lerp_(g, 1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = (v.sqrt() / math.sqrt(c2)).add_(self.eps)
            p.addcdiv_(m, denom, value=-lr / c1)


class Mapper:
    """The mapper's state (weights, keyframe buffer, pose corrections,
    both optimizers) and its train step, from the benchmark's inputs."""

    def __init__(self, cfg: Dict, params: Dict[str, torch.Tensor],
                 keyframes: Dict[str, torch.Tensor], device, low=False):
        self.mc = mc = model_config(cfg)
        self.low = low
        self.dt = BF16 if low else torch.float32
        self.rays = cfg.get("rays_per_batch", 4096)
        self.iterations = cfg["mapping_iterations"]
        self.cam_lr0 = cfg.get("extrinsic_learning_rate", 1e-4)
        self.p = {k: v.detach().clone().float().requires_grad_(True)
                  for k, v in params.items()}
        K = mc.num_images
        self.pose_deltas = torch.zeros(K, 6, device=device,
                                       requires_grad=True)
        self.opt = Adam(list(self.p.values()), 1e-15)
        self.cam_opt = Adam([self.pose_deltas], 1e-8)
        self.step_count = 0
        self._insert(keyframes, cfg.get("assumed", {}).get(
            "pixel_dtype", "bfloat16"))

    # -- keyframe buffer ---------------------------------------------------

    def _insert(self, kf, pixel_dtype: str):
        """Pin keyframe 0 to the identity (the gauge) and store the targets
        as the buffer stores them (colour and z-depth rounded to
        ``pixel_dtype``)."""
        c2w = kf["c2w"].float()
        norm = torch.linalg.inv(c2w[0])
        self.c2w = torch.matmul(norm, c2w)
        self.intr = kf["intrinsics"].float()
        q = getattr(torch, pixel_dtype)
        self.color = kf["color"].to(q).float()
        self.depth = kf["depth"].to(q).float()

    def _batch(self, draws):
        f, py, px = draws["frame"], draws["py"], draws["px"]
        c2w_all = torch.matmul(se3_exp_matrix(self.pose_deltas), self.c2w)
        c2w, intr = c2w_all[f], self.intr[f]
        xy = torch.stack([px, py], -1).float() + 0.5
        o, d, dn = generate_rays(c2w, intr, xy)
        dz = self.depth[f, py, px]
        return {"origins": o, "directions": d, "rgb": self.color[f, py, px],
                "camera_indices": f, "depth": dz * dn[..., 0],
                "depth_mask": dz > 0}

    # -- the field -----------------------------------------------------------

    def to_unit(self, pos):
        return contract_to_unit_cube(pos)

    def density_unit_features(self, unit):
        feat = encode(self.p["field.tables"], unit, self.mc.field_grid,
                      self.low)
        h = mlp(self.p, "field.density_mlp", 2, feat, self.dt)
        return trunc_exp(h[..., 0] - 1.0), h[..., 1:]

    def rgb(self, geo, dirs, cam):
        emb = self.p["field.embedding.weight"][cam.long()].to(self.dt)
        emb = emb[..., None, :].expand(geo.shape[:-1] + (emb.shape[-1],))
        h = torch.cat([sh_encode(dirs), geo, emb], -1)
        return torch.sigmoid(mlp(self.p, "field.color_mlp", 3, h, self.dt))

    def normals(self, geo):
        n = mlp(self.p, "field.normal_mlp", 3, geo, self.dt)
        return n / torch.linalg.norm(n, dim=-1, keepdim=True).clamp(min=1e-7)

    def proposal_density(self, i, pos):
        grid = self.mc.proposal_grids[i]
        feat = encode(self.p[f"proposal_fields.{i}.tables"],
                      self.to_unit(pos), grid, self.low)
        h = mlp(self.p, f"proposal_fields.{i}.mlp", 2, feat, self.dt)
        return trunc_exp(h[..., 0] - 1.0)

    # -- the loss ------------------------------------------------------------

    def loss(self, b, uniforms):
        mc, dt = self.mc, self.dt
        o, d = b["origins"].to(dt), b["directions"].to(dt)
        u = [x.to(dt) for x in uniforms]

        def positions(t_mid):
            return o[..., None, :] + d[..., None, :] * t_mid[..., None]

        def t_of(s):
            t = s_to_t(s, mc)
            return 0.5 * (t[..., 1:] + t[..., :-1]), t[..., 1:] - t[..., :-1]

        # the proposals stay in the graph: the interlevel loss trains them
        # and the pose gradient runs through their samples too
        s = uniform_bins(u[0], mc.num_proposal_samples[0])
        hist = []
        for i in range(len(mc.proposal_grids)):
            t_mid, deltas = t_of(s)
            w = render_weights(self.proposal_density(i, positions(t_mid)),
                               deltas)
            hist.append((s, w))
            n_next = (mc.num_proposal_samples[i + 1]
                      if i + 1 < len(mc.num_proposal_samples)
                      else mc.num_nerf_samples)
            s = sample_pdf(s, w, n_next, u[i + 1])
        t_mid, deltas = t_of(s)
        pos = positions(t_mid)
        density, geo = self.density_unit_features(self.to_unit(pos))
        # normals at every final sample: the density's position gradient,
        # a stop-gradient target
        (g,) = torch.autograd.grad(density, pos, torch.ones_like(density),
                                   retain_graph=True)
        grad_n = -g / torch.linalg.norm(g, dim=-1, keepdim=True).clamp(
            min=1e-7)
        rgb_s = self.rgb(geo, d[..., None, :].expand(pos.shape),
                         b["camera_indices"])
        w = render_weights(density, deltas)
        acc = torch.sum(w, -1)
        rgb = torch.sum(w[..., None] * rgb_s, -2) + (1.0 - acc[..., None]) \
            * rgb_s[..., -1, :]
        loss = torch.mean((rgb - b["rgb"].to(dt)) ** 2)
        for ps, pw in hist:
            loss = loss + mc.interlevel_loss_mult * interlevel_loss(
                ps, pw, s, w)
        loss = loss + mc.distortion_loss_mult * distortion_loss(s, w)
        dl = ds_nerf_depth_loss(w, t_mid, deltas, b["depth"].to(dt),
                                mc.depth_sigma, b["depth_mask"])
        loss = loss + mc.depth_loss_mult * dl
        n_pred = self.normals(geo)
        n_dot_v = torch.sum(grad_n * d[..., None, :], -1)
        oloss = torch.mean(torch.sum(w * n_dot_v.clamp(min=0.0) ** 2, -1))
        sim = 1.0 - torch.sum(n_pred * grad_n.detach(), -1)
        ploss = torch.mean(torch.sum(w * sim, -1))
        loss = (loss + mc.orientation_loss_mult * oloss
                + mc.pred_normal_loss_mult * ploss)
        return loss

    # -- one step ------------------------------------------------------------

    def leaves(self) -> Dict[str, torch.Tensor]:
        return dict(self.p, pose_deltas=self.pose_deltas)

    def step(self, draws) -> Tuple[float, Dict[str, torch.Tensor]]:
        """One train step on ``draws``: the loss, then Adam on the weights
        and on the pose corrections (keyframe 0's held). Returns the loss
        and each leaf's gradient."""
        leaves = self.leaves()
        loss = self.loss(self._batch(draws), draws["uniforms"])
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True)
        grads = {k: (torch.zeros_like(v) if g is None else g.float())
                 for (k, v), g in zip(leaves.items(), grads)}
        grads["pose_deltas"][0] = 0.0
        self.opt.step([grads[k] for k in self.p], 1e-2)
        cam_lr = self.cam_lr0 * (1e-5 / self.cam_lr0) ** (
            self.step_count / max(self.iterations, 1))
        self.cam_opt.step([grads["pose_deltas"]], cam_lr)
        self.step_count += 1
        return float(loss.detach().float()), grads

    def state(self) -> Dict[str, torch.Tensor]:
        """The trained tensors, by name."""
        return {k: v.detach() for k, v in self.leaves().items()}
