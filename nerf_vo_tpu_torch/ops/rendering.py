"""Volume rendering primitives: spacing, resampling, compositing, reg losses.

Counterpart of ``nerf_vo_tpu/ops/rendering.py``. Sample positions live in a
normalized s-space in [0, 1], related to metric ray distance t by an
invertible spacing function; proposal histograms are resampled by inverse
CDF in s-space. Every shape is static: a fixed number of samples per ray.

The samplers take their random numbers as arguments (uniforms in [0, 1)),
where the JAX package takes a PRNG key, so that a test can hand both the
same draws.
"""

from __future__ import annotations

import torch

from nerf_vo_tpu_torch.ops import rendering_cuda

# ---------------------------------------------------------------------------
# spacing functions: s in [0,1] <-> metric distance t
# ---------------------------------------------------------------------------


def s_to_t_disparity(s, near, far):
    """Linear-in-disparity spacing (nerfacto default for contracted scenes)."""
    return 1.0 / ((1.0 - s) / near + s / far)


def t_to_s_disparity(t, near, far):
    inv_t = 1.0 / t.clamp(min=1e-8)
    return (1.0 / near - inv_t) / (1.0 / near - 1.0 / far)


def s_to_t_linear(s, near, far):
    return near + s * (far - near)


def t_to_s_linear(t, near, far):
    return (t - near) / (far - near)


SPACINGS = {
    "disparity": (s_to_t_disparity, t_to_s_disparity),
    "linear": (s_to_t_linear, t_to_s_linear),
}


# ---------------------------------------------------------------------------
# samplers
# ---------------------------------------------------------------------------


def _linspace01(n: int, device):
    """[n+1] points i/n, each rounded once."""
    return torch.arange(n + 1, dtype=torch.float32, device=device) / n


def uniform_bins(n_rays: int, n_samples: int, u=None, device=None):
    """[R, S+1] bin edges in s-space.

    ``u``: [R, S+1] uniforms in [0, 1) that jitter every interior edge
    within half a bin each way (stratified sampling); None gives the
    deterministic edges.
    """
    if u is not None:
        device = u.device
    edges = _linspace01(n_samples, device).expand(n_rays, n_samples + 1)
    if u is not None:
        noise = u - 0.5
        noise[:, 0] = 0.0
        noise[:, -1] = 0.0
        edges = edges + noise * (1.0 / n_samples)
    return edges


def sample_pdf(s_edges, weights, n_samples: int, u=None,
               histogram_padding: float = 0.01):
    """Inverse-CDF resampling of a weight histogram.

    Args:
      s_edges: [R, B+1] existing bin edges in s-space.
      weights: [R, B] rendering weights of those bins.
      n_samples: number of new bins -> returns [R, n_samples+1] edges.
      u: [R, n_samples+1] uniforms in [0, 1) for stratified draws; None
        draws the deterministic quantiles.

    The edge below each quantile is the last edge whose CDF is <= it, the
    edge above the first whose CDF is greater (the last edge past the end);
    the JAX package finds both with a one-hot contraction, this port with
    ``searchsorted``. The result is stop-gradient.
    """
    R = weights.shape[0]
    B = weights.shape[1]
    weights = weights + histogram_padding
    pdf = weights / torch.sum(weights, dim=-1, keepdim=True)
    cdf = torch.cat([torch.zeros_like(pdf[:, :1]),
                     torch.cumsum(pdf, dim=-1)], dim=-1)
    cdf = cdf.clamp(max=1.0)
    cdf[:, -1] = 1.0  # exact upper edge

    if u is not None:
        q = torch.arange(n_samples + 1, dtype=cdf.dtype, device=cdf.device)
        u = (q + u) / (n_samples + 1)
    else:
        u = _linspace01(n_samples, cdf.device).expand(R, n_samples + 1)
    u = u.contiguous()

    k = torch.searchsorted(cdf.contiguous(), u, right=True)  # >= 1
    below = (k - 1).clamp(min=0)
    above = k.clamp(max=B)
    cdf_below = torch.gather(cdf, 1, below)
    cdf_above = torch.gather(cdf, 1, above)
    s_below = torch.gather(s_edges, 1, below)
    s_above = torch.gather(s_edges, 1, above)

    denom = (cdf_above - cdf_below).clamp(min=1e-8)
    frac = ((u - cdf_below) / denom).clamp(0.0, 1.0)
    new_edges = s_below + frac * (torch.maximum(s_above, s_below) - s_below)
    # exact math gives monotone edges; pin them against rounding slop, since
    # negative bin deltas downstream would overflow exp() in the compositor
    new_edges = torch.cummax(new_edges, dim=-1).values
    return new_edges.detach()


# ---------------------------------------------------------------------------
# SDF rendering (NeuS, as Neuralangelo runs it)
# ---------------------------------------------------------------------------


def sphere_bounds(origins, directions):
    """(near, far) [R] where unit-direction rays from ``origins`` (in the
    unit sphere's frame) meet the unit sphere; near held at 0 for a ray
    that starts inside it (Neuralangelo's ``get_dist_bounds``)."""
    b = torch.sum(origins * directions, dim=-1)
    c = torch.sum(origins * origins, dim=-1) - 1.0
    root = torch.sqrt((b * b - c).clamp(min=0.0))
    return torch.relu(-b - root), -b + root


def stratified_depths(near, far, u):
    """[R, N] depths, one uniform draw ``u`` [R, N] in each of N equal
    intervals of [near, far]."""
    n = u.shape[-1]
    i = torch.arange(n, dtype=u.dtype, device=u.device)
    return near[:, None] + (i + u) / n * (far - near)[:, None]


def neus_upsample(origins, directions, z, sdf, n_new: int, inv_s: float):
    """NeuS's up-sampling (``up_sample``): [R, n_new] new depths from the
    depths ``z`` [R, N] (sorted) and their SDF values. Each interval's SDF
    at its ends is estimated from its mid-point SDF and a cosine taken
    from the neighbouring samples (the smaller of this interval's and the
    previous one's, clipped to [-1e3, 0] and zeroed where neither end is
    inside the unit sphere); the alphas at sharpness ``inv_s`` are
    composited into weights, which :func:`sample_pdf` inverts at the
    ``n_new`` mid-quantiles (histogram padding 1e-5, NeuS's)."""
    R = z.shape[0]
    radius = torch.linalg.vector_norm(
        origins[:, None, :] + directions[:, None, :] * z[..., None], dim=-1)
    inside = ((radius[:, :-1] < 1.0) | (radius[:, 1:] < 1.0)).to(z.dtype)
    prev_sdf, next_sdf = sdf[:, :-1], sdf[:, 1:]
    dz = z[:, 1:] - z[:, :-1]
    mid = 0.5 * (prev_sdf + next_sdf)
    cos = (next_sdf - prev_sdf) / (dz + 1e-5)
    prev_cos = torch.cat([torch.zeros_like(cos[:, :1]), cos[:, :-1]], -1)
    cos = torch.minimum(prev_cos, cos).clamp(-1e3, 0.0) * inside
    prev_cdf = torch.sigmoid((mid - cos * dz * 0.5) * inv_s)
    next_cdf = torch.sigmoid((mid + cos * dz * 0.5) * inv_s)
    alpha = (prev_cdf - next_cdf + 1e-5) / (prev_cdf + 1e-5)
    trans = torch.cumprod(torch.cat([torch.ones_like(alpha[:, :1]),
                                     1.0 - alpha + 1e-7], -1), -1)
    weights = alpha * trans[:, :-1]
    half = torch.full((R, n_new), 0.5, dtype=z.dtype, device=z.device)
    return sample_pdf(z, weights, n_new - 1, half, histogram_padding=1e-5)


def neus_alphas(sdf, gradients, directions, z, far, inv_s, anneal=1.0,
                eps: float = 1e-5):
    """NeuS's discrete opacities [R, S] of the samples at depths ``z``
    with SDF ``sdf`` and SDF gradients [R, S, 3]: each interval reaches
    the next sample (the last one ``far``); its ends' SDF is estimated
    from the sample's and the annealed cosine (``anneal`` 1:
    ``-relu(-cos)``), then ``(Phi(prev) - Phi(next)) / (Phi(prev) +
    eps)`` clipped to [0, 1], Phi the sigmoid of ``inv_s`` times it."""
    true_cos = torch.sum(directions[:, None, :] * gradients, dim=-1)
    cos = -(torch.relu(-true_cos * 0.5 + 0.5) * (1.0 - anneal)
            + torch.relu(-true_cos) * anneal)
    ends = torch.cat([z, far[:, None]], -1)
    half = (ends[:, 1:] - ends[:, :-1]) * 0.5
    prev_cdf = torch.sigmoid((sdf - cos * half) * inv_s)
    next_cdf = torch.sigmoid((sdf + cos * half) * inv_s)
    return ((prev_cdf - next_cdf) / (prev_cdf + eps)).clamp(0.0, 1.0)


class _CumprodPositive(torch.autograd.Function):
    """``torch.cumprod`` along the last dim of a tensor with no zero entry.
    Its backward is torch's own for such input (the reversed cumulative
    sum of output x grad, over the input) without torch's look on the
    host for a zero entry, a sync that a CUDA graph's capture refuses."""

    @staticmethod
    def forward(ctx, x):
        out = torch.cumprod(x, dim=-1)
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x, out = ctx.saved_tensors
        w = torch.flip(out * g, (-1,))
        return torch.flip(torch.cumsum(w, dim=-1), (-1,)) / x


def alpha_weights(alpha):
    """Compositing weights [R, S] of opacities below 1: alpha_i
    prod_{j<i} (1 - alpha_j). NeuS's alphas are at most prev / (prev +
    1e-5), so no factor is 0."""
    front = torch.cat([torch.zeros_like(alpha[:, :1]), alpha[:, :-1]], -1)
    return alpha * _CumprodPositive.apply(1.0 - front)


# ---------------------------------------------------------------------------
# compositing
# ---------------------------------------------------------------------------


def render_weights(densities, deltas):
    """Rendering weights from volume densities.

    Args:
      densities: [R, S] non-negative densities at sample midpoints.
      deltas: [R, S] metric lengths of each sample interval.

    Returns:
      (weights[R, S], transmittance[R, S]) with
      w_i = T_i * (1 - exp(-sigma_i * delta_i)).
    """
    alpha_exp = densities * deltas
    trans = torch.exp(-torch.cat(
        [torch.zeros_like(alpha_exp[:, :1]),
         torch.cumsum(alpha_exp[:, :-1], dim=-1)], dim=-1))
    alpha = 1.0 - torch.exp(-alpha_exp)
    return alpha * trans, trans


def composite(weights, values, background=None):
    """Weighted sum along samples: [R, S] x [R, S, C] -> [R, C]."""
    out = torch.sum(weights[..., None] * values, dim=-2)
    if background is not None:
        acc = torch.sum(weights, dim=-1, keepdim=True)
        out = out + (1.0 - acc) * background
    return out


def render_depth(weights, t_mid, eps: float = 1e-10):
    """Expected (weight-normalized) ray distance."""
    acc = torch.sum(weights, dim=-1)
    d = torch.sum(weights * t_mid, dim=-1) / acc.clamp(min=eps)
    return torch.minimum(torch.maximum(d, t_mid[..., 0]), t_mid[..., -1])


def render_accumulation(weights):
    return torch.sum(weights, dim=-1)


# ---------------------------------------------------------------------------
# regularization losses (mipnerf-360 family, as used by nerfacto)
# ---------------------------------------------------------------------------


def _outer_bounds(t0, t1, y1):
    """For each target bin of ``t0``, the mass of histogram (t1, y1) that
    overlaps it, as two indicator contractions (monotone edges):
    sum_b y1[b] 1[t1[b] < t_hi] - sum_b y1[b] 1[t1[b+1] <= t_lo]."""
    t0lo = t0[..., :-1]  # [R, K]
    t0hi = t0[..., 1:]
    left = (t1[..., 1:, None] <= t0lo[..., None, :]).to(torch.float32)
    right = (t1[..., :-1, None] < t0hi[..., None, :]).to(torch.float32)
    lo = torch.einsum("rb,rbk->rk", y1, left)
    hi = torch.einsum("rb,rbk->rk", y1, right)
    return hi - lo


def interlevel_loss(proposal_edges, proposal_weights, final_edges,
                    final_weights):
    """Histogram consistency loss: penalizes proposal histograms that put
    less mass than the final one over the same span.

    CUDA tensors go to ``rendering_cuda.interlevel_loss`` (the indicators
    formed in registers, never materialized); CPU tensors to
    :func:`interlevel_loss_plain`."""
    if proposal_weights.device.type == "cuda":
        return rendering_cuda.interlevel_loss(
            proposal_edges, proposal_weights, final_edges, final_weights)
    return interlevel_loss_plain(proposal_edges, proposal_weights,
                                 final_edges, final_weights)


def interlevel_loss_plain(proposal_edges, proposal_weights, final_edges,
                          final_weights):
    """:func:`interlevel_loss` as the [R, B, K] indicator contraction of
    :func:`_outer_bounds`, on any device."""
    fw = final_weights.detach()
    fe = final_edges.detach()
    bound = _outer_bounds(fe, proposal_edges, proposal_weights)
    clipped = (fw - bound).clamp(min=0.0)
    return torch.mean(clipped**2 / fw.clamp(min=1e-7))


def distortion_loss(s_edges, weights):
    """Mipnerf-360 distortion loss in s-space, by the O(S) cumulative
    form of sum_ij w_i w_j |s_i - s_j|."""
    s_mid = 0.5 * (s_edges[..., 1:] + s_edges[..., :-1])
    ds = s_edges[..., 1:] - s_edges[..., :-1]
    w = weights
    wm = w * s_mid
    cw = torch.cumsum(w, dim=-1)
    cwm = torch.cumsum(wm, dim=-1)
    cw_prev = torch.cat([torch.zeros_like(cw[..., :1]), cw[..., :-1]], -1)
    cwm_prev = torch.cat([torch.zeros_like(cwm[..., :1]), cwm[..., :-1]], -1)
    loss_inter = 2.0 * torch.sum(w * (s_mid * cw_prev - cwm_prev), dim=-1)
    loss_intra = torch.sum(w**2 * ds, dim=-1) / 3.0
    return torch.mean(loss_inter + loss_intra)
