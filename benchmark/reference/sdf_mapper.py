"""Plain PyTorch reference of one train step of Neuralangelo's SDF mapper,
as the port runs it (``mapping_module: neuralangelo``).

It imports torch and ``reference/mapper.py`` alone: nothing of the program
and no kernel of it. It computes in float32 with TF32 off (a ``Mapper``
turns it off for the process), the colour MLP and the table reads in
bfloat16 as configured. It follows the port's plain paths
(``models/nerfacto.py``'s SDF sampler, ``models/nerf_field.py``'s
``SDFField``, ``ops/rendering.py``, ``ops/losses.py``,
``mapping/trainer.py``), frozen here for the mapper the benchmark runs:
Neuralangelo (Li et al., CVPR 2023; ``projects/neuralangelo/configs/
base.yaml``) at its published widths:

- a hash grid of 16 levels x 8 features, 2^22 entries a level, from 32 to
  2048, over [-1, 1]^3 of the scene's unit sphere; the features of levels
  at or above ``active`` multiplied by 0;
- an SDF MLP on ``[x, features]`` (131 inputs): one softplus (beta 100)
  hidden layer of 256, 257 outputs (the SDF and a 256-wide feature), in
  float32, weight-normed;
- a colour MLP on ``[x, SH(view) of degree 3, normal, feature]`` (271
  inputs): 4 ReLU hidden layers of 256, 3 sigmoid outputs, weight-normed;
- the SDF's gradient and Laplacian by four taps at ``e = eps / sqrt(3)``,
  ``eps = 1 / res[active - 1]``;
- NeuS's renderer (``inv_s = exp(s_var)``, the annealed cosine) over 64
  stratified samples and 4 rounds of NeuS's up-sampling of 16 samples at
  ``inv_s = 64 * 2^h``, between the ray's entry and exit of the unit
  sphere;
- the photometric L1, the eikonal term (weight 0.1) and the curvature term
  (5e-4 over ``growth^(active - 4)``); AdamW (learning rate 1e-3 after a
  linear warm-up, weight decay 1e-2) on the field.

The hash grid, rays, pose exponential, keyframe buffer and the camera's
Adam are ``reference/mapper.py``'s; so is its inverse-CDF resampler, which
the up-sampling calls at NeuS's mid-quantiles.

Departures from published Neuralangelo, each as the port has it:

- step counts scaled from 500k iterations to the mapper's 8192: the
  coarse-to-fine step 82 (from 5000), the warm-up 82 (from 5000), the
  cosine anneal's end 819 (0.1 of the run), the learning rate's two
  divisions by 10 at 4915 and 6554 (from 300k and 400k);
- 4096 rays a step, NeRF-VO's mapper batch, over a keyframe buffer of 192
  frames, with each keyframe's pose correction refined by Adam (eps 1e-8,
  learning rate 1e-4 -> 1e-5), which Neuralangelo does not do;
- the room in a sphere of radius 4.5 m about the first keyframe, no
  background NeRF, no appearance embedding, rays' colours composited on
  black (every ray of a room ends on a wall inside the sphere);
- the up-sampling is NeuS's (``up_sample``: mid-point SDF, the neighbours'
  cosine, the smaller of two, clipped to [-1e3, 0] inside the sphere), and
  its inverse CDF is the port's resampler (edges pinned monotone, a gap
  under 1e-8 read as 1e-8) in place of NeuS's ``sample_pdf`` (a gap under
  1e-5 read as 1);
- the colour MLP in bfloat16 (input, weights and each product rounded),
  the table read as bfloat16 rows of a float32 table; the colour MLP's
  normal is the normalized numerical gradient;
- the eikonal and curvature terms are means over every final sample (all
  lie inside the sphere);
- AdamW's eps 1e-8 (torch's default).

``low`` puts the reference in the control's place: every float32 tensor
of the step (positions, samples, the SDF MLP, the taps, rendering, losses
and their gradients) is computed in bfloat16, the step below the float32
the configuration states; the optimizers' state stays in float32.

The step is computed in blocks of ``block`` rays (its loss terms are means
over all rays, so each block adds its share and its gradients), so that
the plain hash grid's rows fit the card at 4096 rays x 640 points.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Tuple

import torch

from benchmark.reference import mapper as base
from benchmark.reference.mapper import BF16, Grid

# Neuralangelo's published widths, as ``mapping_model_overrides`` sets them
# on the port's neuralangelo module; the only ones a benchmark cell runs
PUBLISHED = {"num_grid_levels": 16, "grid_features_per_level": 8,
             "log2_hashmap_size": 22, "max_res": 2048}
TAPS = ((1.0, -1.0, -1.0), (-1.0, -1.0, 1.0), (-1.0, 1.0, -1.0),
        (1.0, 1.0, 1.0))
# the compared steps' start: the first layer's feature columns, which the
# geometric init zeroes, drawn at this standard deviation
FEATURE_STD = 0.05


@dataclasses.dataclass(frozen=True)
class SDFMapperConfig:
    """The mapper the configuration runs."""

    num_images: int
    num_grid_levels: int = 16
    grid_features_per_level: int = 8
    log2_hashmap_size: int = 22
    max_res: int = 2048
    min_res: int = 32
    radius: float = 4.5  # the scene's sphere about the first keyframe
    hidden: int = 256
    beta: float = 100.0
    color_hidden: int = 256
    color_depth: int = 4
    sh_degree: int = 3
    out_bias: float = 0.5
    inside_out: bool = True
    init_s: float = 3.0
    num_samples: int = 64
    num_importance: int = 16
    upsample_rounds: int = 4
    upsample_inv_s: float = 64.0
    c2f_init: int = 4
    c2f_step: int = 82
    anneal_end: int = 819
    eikonal_mult: float = 0.1
    curvature_mult: float = 5e-4
    learning_rate: float = 1e-3
    weight_decay: float = 1e-2
    warm_up_end: int = 82
    lr_steps: Tuple[int, ...] = (4915, 6554)
    lr_gamma: float = 10.0

    @property
    def field_grid(self) -> Grid:
        return Grid(self.num_grid_levels, self.grid_features_per_level,
                    self.log2_hashmap_size, self.min_res, self.max_res)

    @property
    def growth(self) -> float:
        L = self.num_grid_levels
        return (math.exp((math.log(self.max_res) - math.log(self.min_res))
                         / (L - 1)) if L > 1 else 1.0)

    def schedule(self, step: int) -> Tuple[int, float, float, float]:
        """(active levels, eps, curvature weight, cosine anneal) at
        ``step``."""
        L = self.num_grid_levels
        active = min(L, self.c2f_init + step // self.c2f_step)
        eps = 1.0 / self.field_grid.resolutions[active - 1]
        curv = self.curvature_mult / self.growth ** (active - self.c2f_init)
        anneal = (min(step / self.anneal_end, 1.0) if self.anneal_end
                  else 1.0)
        return active, eps, curv, anneal

    def learning_rate_at(self, step: int) -> float:
        if step < self.warm_up_end:
            return self.learning_rate * step / self.warm_up_end
        return self.learning_rate / self.lr_gamma ** sum(
            step > s for s in self.lr_steps)


def model_config(cfg: Dict) -> SDFMapperConfig:
    """The mapper of a run configuration: ``mapping_module: neuralangelo``
    with the widths ``mapping_model_overrides`` sets (an ``sdf`` entry, a
    dict or an object with the fields, sets the SDF mapper's own);
    anything else raises."""
    if cfg.get("mapping_module") != "neuralangelo":
        raise NotImplementedError("the SDF reference runs the neuralangelo "
                                  "mapper")
    over = dict(cfg.get("mapping_model_overrides") or {})
    sdf = over.pop("sdf", {})
    fields = {f.name for f in dataclasses.fields(SDFMapperConfig)}
    if not isinstance(sdf, dict):
        sdf = {k: getattr(sdf, k) for k in fields if hasattr(sdf, k)}
    unknown = set(over) - fields
    if unknown:
        raise NotImplementedError(f"the SDF reference has no {unknown}")
    sdf = {k: tuple(v) if isinstance(v, list) else v for k, v in sdf.items()
           if k in fields}
    return SDFMapperConfig(num_images=cfg["num_keyframes"], **over, **sdf)


def _mlp_dims(mc: SDFMapperConfig) -> Dict[str, List[int]]:
    F = mc.grid_features_per_level * mc.num_grid_levels
    h = mc.hidden
    return {"sdf_mlp": [3 + F, h, 1 + h],
            "color_mlp": [3 + mc.sh_degree**2 + 3 + h]
            + [mc.color_hidden] * mc.color_depth + [3]}


@torch.no_grad()
def init_params(mc: SDFMapperConfig, seed: int, device
                ) -> Dict[str, torch.Tensor]:
    """The state the compared steps start from, from ``seed``, made on
    ``device`` one call a tensor, named as the port's ``NerfactoModel``
    state dict names them: Neuralangelo's geometric init of the SDF MLP
    (inside out: positive inside the sphere of radius ``out_bias``) with
    the first layer's feature columns, which it zeroes, drawn N(0,
    ``FEATURE_STD``) so that the table trains; the colour MLP's
    directions LeCun normal truncated at 2 std; every weight norm g =
    ||v||; zero biases but the SDF's; tables U(-1e-4, 1e-4); s_var
    ``init_s``."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1000003 + 5) & (2**63 - 1))
    out = {}
    dims = _mlp_dims(mc)

    def put(prefix, j, v, b):
        out[f"{prefix}.{j}.weight_v"] = v
        out[f"{prefix}.{j}.weight_g"] = torch.linalg.vector_norm(
            v, dim=1, keepdim=True)
        out[f"{prefix}.{j}.bias"] = b

    n_in, h, n_out = dims["sdf_mlp"]
    v0 = torch.randn(h, n_in, generator=g, device=device) * (
        math.sqrt(2) / math.sqrt(h))
    v0[:, 3:] *= FEATURE_STD / (math.sqrt(2) / math.sqrt(h))
    put("field.sdf_mlp", 0, v0, torch.zeros(h, device=device))
    sign = -1.0 if mc.inside_out else 1.0
    v1 = sign * math.sqrt(math.pi / h) + 1e-4 * torch.randn(
        n_out, h, generator=g, device=device)
    put("field.sdf_mlp", 1, v1, torch.full((n_out,), -sign * mc.out_bias,
                                           device=device))
    cd = dims["color_mlp"]
    for j, (a, b) in enumerate(zip(cd[:-1], cd[1:])):
        std = math.sqrt(1.0 / a) / 0.87962566103423978
        put("field.color_mlp", j, base._trunc_normal((b, a), std, g, device),
            torch.zeros(b, device=device))
    out["field.s_var"] = torch.tensor(float(mc.init_s), device=device)
    grid = mc.field_grid
    out["field.tables"] = (torch.rand(grid.n_levels * grid.bricks_per_level,
                                      32 * grid.features, generator=g,
                                      device=device) * 2e-4 - 1e-4)
    return out


# ---------------------------------------------------------------------------
# sampling and rendering
# ---------------------------------------------------------------------------

def sphere_bounds(o, d):
    b = torch.sum(o * d, -1)
    c = torch.sum(o * o, -1) - 1.0
    root = torch.sqrt((b * b - c).clamp(min=0.0))
    return torch.relu(-b - root), -b + root


def up_sample(o, d, z, sdf, n: int, inv_s: float):
    """NeuS's ``up_sample`` at the mid-quantiles of ``n`` samples."""
    R = z.shape[0]
    radius = torch.linalg.vector_norm(o[:, None] + d[:, None] * z[..., None],
                                      dim=-1)
    inside = ((radius[:, :-1] < 1.0) | (radius[:, 1:] < 1.0)).to(z.dtype)
    dz = z[:, 1:] - z[:, :-1]
    mid = 0.5 * (sdf[:, :-1] + sdf[:, 1:])
    cos = (sdf[:, 1:] - sdf[:, :-1]) / (dz + 1e-5)
    prev = torch.cat([torch.zeros_like(cos[:, :1]), cos[:, :-1]], -1)
    cos = torch.minimum(prev, cos).clamp(-1e3, 0.0) * inside
    pc = torch.sigmoid((mid - cos * dz * 0.5) * inv_s)
    nc = torch.sigmoid((mid + cos * dz * 0.5) * inv_s)
    alpha = (pc - nc + 1e-5) / (pc + 1e-5)
    vis = torch.cumprod(torch.cat([torch.ones_like(alpha[:, :1]),
                                   1.0 - alpha + 1e-7], -1), -1)[:, :-1]
    half = torch.full((R, n), 0.5, dtype=z.dtype, device=z.device)
    return base.sample_pdf(z, alpha * vis, n - 1, half, padding=1e-5)


class Mapper(base.Mapper):
    """The mapper's state (weights, keyframe buffer, pose corrections,
    AdamW on the field, Adam on the poses) and its train step;
    ``reference/mapper.py``'s buffer and rays."""

    def __init__(self, cfg: Dict, params: Dict[str, torch.Tensor],
                 keyframes: Dict[str, torch.Tensor], device, low=False,
                 start_step: int = 0, block: int = 256):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.mc = mc = model_config(cfg)
        self.low = low
        self.dt = BF16 if low else torch.float32
        self.rays = cfg.get("rays_per_batch", 4096)
        self.iterations = cfg["mapping_iterations"]
        self.cam_lr0 = cfg.get("extrinsic_learning_rate", 1e-4)
        self.block = block
        self.p = {k: v.detach().clone().float().requires_grad_(True)
                  for k, v in params.items()}
        self.pose_deltas = torch.zeros(mc.num_images, 6, device=device,
                                       requires_grad=True)
        self.opt = base.Adam(list(self.p.values()), 1e-8)
        self.cam_opt = base.Adam([self.pose_deltas], 1e-8)
        self.step_count = start_step
        self.taps = torch.tensor(TAPS, device=device)
        self._insert(keyframes, cfg.get("assumed", {}).get(
            "pixel_dtype", "bfloat16"))

    # -- the field -----------------------------------------------------------

    def _weight(self, prefix: str, j: int):
        v = self.p[f"{prefix}.{j}.weight_v"]
        g = self.p[f"{prefix}.{j}.weight_g"]
        return v * (g / torch.linalg.vector_norm(v, dim=1, keepdim=True))

    def sdf_out(self, xs, active: int):
        """[..., 3] sphere-frame points -> [..., 1 + hidden]."""
        mc, dt = self.mc, self.dt
        grid = mc.field_grid
        feat = base.encode(self.p["field.tables"], (xs + 1.0) * 0.5, grid,
                           self.low).to(dt)
        keep = (torch.arange(grid.n_levels * grid.features,
                             device=xs.device)
                // grid.features < active).to(dt)
        h = torch.cat([xs.to(dt), feat * keep], -1)
        b0 = self.p["field.sdf_mlp.0.bias"].to(dt)
        h = torch.nn.functional.softplus(
            h @ self._weight("field.sdf_mlp", 0).to(dt).t() + b0,
            beta=mc.beta)
        return h @ self._weight("field.sdf_mlp", 1).to(dt).t() \
            + self.p["field.sdf_mlp.1.bias"].to(dt)

    def colour(self, xs, d, n, feat):
        h = torch.cat([xs, base.sh_encode(d)[..., :self.mc.sh_degree**2],
                       n, feat], -1).to(BF16)
        last = self.mc.color_depth
        for j in range(last + 1):
            h = torch.matmul(h, self._weight("field.color_mlp", j).to(
                BF16).t()) + self.p[f"field.color_mlp.{j}.bias"].to(BF16)
            if j < last:
                h = torch.relu(h)
        return torch.sigmoid(h.to(self.dt))

    # -- one render -----------------------------------------------------------

    def render(self, o_w, d_w, u, schedule):
        """The rays' colours and, per final sample, the SDF gradient,
        Laplacian and depth: ``(rgb, grad, laplacian, z)``."""
        mc, dt = self.mc, self.dt
        active, eps, _, anneal = schedule
        o = (o_w / mc.radius).to(dt)
        d = d_w.to(dt)
        near, far = sphere_bounds(o, d)
        with torch.no_grad():
            o_, d_ = o.detach(), d.detach()
            n = u.shape[-1]
            z = near.detach()[:, None] + (torch.arange(
                n, device=u.device).to(dt) + u.to(dt)) / n * (
                far - near).detach()[:, None]

            def sdf_at(z):
                return self.sdf_out(o_[:, None] + d_[:, None] * z[..., None],
                                    active)[..., 0]

            sdf = sdf_at(z)
            for h in range(mc.upsample_rounds):
                new = up_sample(o_, d_, z, sdf, mc.num_importance,
                                mc.upsample_inv_s * 2**h)
                z, order = torch.sort(torch.cat([z, new], -1), dim=-1)
                if h + 1 < mc.upsample_rounds:
                    sdf = torch.gather(torch.cat([sdf, sdf_at(new)], -1), -1,
                                       order)
        x = o[:, None] + d[:, None] * z[..., None]
        # eps in float32, then the factor, as the program's schedule holds it
        e = (torch.tensor(eps, device=x.device) * (1.0 / math.sqrt(3.0))
             ).to(dt)
        taps = self.taps.to(dt)
        out = self.sdf_out(torch.cat([x[..., None, :],
                                      x[..., None, :] + e * taps], -2),
                           active)
        sdf, feat, st = out[..., 0, 0], out[..., 0, 1:], out[..., 1:, 0]
        grad = torch.sum(st[..., None] * taps, -2) / (4.0 * e)
        lap = (torch.sum(st, -1) * 0.5 - 2.0 * sdf) / (e * e)
        normals = grad / torch.linalg.vector_norm(
            grad, dim=-1, keepdim=True).clamp(min=1e-12)
        rgb_s = self.colour(x, d[:, None].expand(x.shape), normals, feat)
        true_cos = torch.sum(d[:, None] * grad, -1)
        cos = -(torch.relu(-true_cos * 0.5 + 0.5) * (1.0 - anneal)
                + torch.relu(-true_cos) * anneal)
        ends = torch.cat([z, far[:, None]], -1)
        half = (ends[:, 1:] - ends[:, :-1]) * 0.5
        inv_s = torch.exp(self.p["field.s_var"]).to(dt)
        pc = torch.sigmoid((sdf - cos * half) * inv_s)
        nc = torch.sigmoid((sdf + cos * half) * inv_s)
        alpha = ((pc - nc) / (pc + 1e-5)).clamp(0.0, 1.0)
        front = torch.cat([torch.zeros_like(alpha[:, :1]), alpha[:, :-1]],
                          -1)
        w = alpha * torch.cumprod(1.0 - front, -1)
        rgb = torch.sum(w[..., None] * rgb_s, -2)
        return rgb, grad, lap, z

    # -- one step ------------------------------------------------------------

    def _blocks(self, draws):
        R = draws["frame"].shape[0]
        for a in range(0, R, self.block):
            yield a, {"frame": draws["frame"][a:a + self.block],
                      "py": draws["py"][a:a + self.block],
                      "px": draws["px"][a:a + self.block],
                      "u": draws["uniforms"][0][a:a + self.block]}

    @torch.no_grad()
    def normals(self, draws) -> torch.Tensor:
        """The final samples' numerical SDF gradients [R, S, 3] of the
        render of ``draws`` at the current state."""
        sched = self.mc.schedule(self.step_count)
        out = []
        for _, blk in self._blocks(draws):
            b = self._batch(blk)
            out.append(self.render(b["origins"], b["directions"], blk["u"],
                                   sched)[1].float())
        return torch.cat(out)

    def step(self, draws) -> Tuple[float, Dict[str, torch.Tensor]]:
        """One train step on ``draws``: the loss (photometric L1, eikonal,
        curvature), then AdamW on the field and Adam on the pose
        corrections (keyframe 0's held). Returns the loss and each leaf's
        gradient."""
        mc = self.mc
        sched = mc.schedule(self.step_count)
        leaves = self.leaves()
        R = draws["frame"].shape[0]
        S = mc.num_samples + mc.upsample_rounds * mc.num_importance
        grads = {k: torch.zeros_like(v) for k, v in leaves.items()}
        total = 0.0
        for _, blk in self._blocks(draws):
            b = self._batch(blk)
            rgb, grad, lap, _ = self.render(b["origins"], b["directions"],
                                            blk["u"], sched)
            l1 = torch.sum(torch.abs(rgb - b["rgb"].to(self.dt))) / (R * 3)
            eik = torch.sum((torch.linalg.vector_norm(grad, dim=-1) - 1.0)
                            ** 2) / (R * S)
            curv = torch.sum(torch.abs(lap)) / (R * S)
            loss = l1 + mc.eikonal_mult * eik + sched[2] * curv
            gs = torch.autograd.grad(loss, list(leaves.values()),
                                     allow_unused=True)
            for k, g in zip(leaves, gs):
                if g is not None:
                    grads[k] += g.float()
            total += float(loss.detach().float())
        grads["pose_deltas"][0] = 0.0
        lr = mc.learning_rate_at(self.step_count)
        with torch.no_grad():  # AdamW's decoupled decay, then Adam
            for p in self.p.values():
                p.mul_(1.0 - lr * mc.weight_decay)
        self.opt.step([grads[k] for k in self.p], lr)
        cam_lr = self.cam_lr0 * (1e-5 / self.cam_lr0) ** (
            self.step_count / max(self.iterations, 1))
        self.cam_opt.step([grads["pose_deltas"]], cam_lr)
        self.step_count += 1
        return total, grads
