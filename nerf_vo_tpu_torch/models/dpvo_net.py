"""DPVO networks in PyTorch: feature/context encoders + patch update net.

Counterpart of ``nerf_vo_tpu/models/dpvo_net.py``. The modules carry
upstream DPVO's torch key layout (``patchify.fnet``, ``patchify.inet``,
``update.*``), so a ``dpvo.pth`` loads through :func:`load_torch_weights`
(as the JAX package's loader reads it), and :func:`from_jax_params` maps the
JAX package's Flax params onto it.

  * ``patchify.fnet``: BasicEncoder4 (1/4 res, instance norm, matching
    features) and ``patchify.inet`` (no norm, context), both scaled by 1/4,
    on images normalized ``2*(x/255) - 0.5``.
  * ``update``: per-edge operator over the patch graph — corr MLP, additive
    context, LayerNorm, temporal neighbour mixing ``c1``/``c2`` (a missing
    neighbour feeds zeros, so the MLP bias still flows: upstream's
    behaviour), softmax aggregation over patches (``agg_kk``) and over
    (host, target) frame pairs (``agg_ij``), two LayerNorm + GatedResidual
    blocks, and the ``d``/``w`` heads.

Public tensors keep the JAX package's channels-last layout: the encoder takes
[B, H, W, 3] and returns [B, H/4, W/4, C].
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from nerf_vo_tpu_torch.ops.correlation import bilinear_gather


class ResidualBlock(nn.Module):
    def __init__(self, in_planes, planes, norm_fn="instance", stride=1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_planes, planes, 3, padding=1, stride=stride)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1)
        mk = ((lambda: nn.InstanceNorm2d(planes)) if norm_fn == "instance"
              else (lambda: nn.Sequential()))
        self.norm1, self.norm2, self.norm3 = mk(), mk(), mk()
        self.downsample = None
        if stride != 1:
            self.downsample = nn.Sequential(
                nn.Conv2d(in_planes, planes, 1, stride=stride), self.norm3
            )

    def forward(self, x):
        y = F.relu(self.norm1(self.conv1(x)))
        y = F.relu(self.norm2(self.conv2(y)))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(x + y)


class BasicEncoder4(nn.Module):
    """RAFT-style encoder to 1/4 resolution: conv7x7/2 -> 2 blocks @32 ->
    2 blocks @64 (first strided) -> 1x1."""

    def __init__(self, output_dim=128, norm_fn="instance"):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 32, 7, stride=2, padding=3)
        self.norm1 = (nn.InstanceNorm2d(32) if norm_fn == "instance"
                      else nn.Sequential())
        self.layer1 = nn.Sequential(
            ResidualBlock(32, 32, norm_fn, 1),
            ResidualBlock(32, 32, norm_fn, 1),
        )
        self.layer2 = nn.Sequential(
            ResidualBlock(32, 64, norm_fn, 2),
            ResidualBlock(64, 64, norm_fn, 1),
        )
        self.conv2 = nn.Conv2d(64, output_dim, 1)

    def forward(self, x):
        """x: [B, 3, H, W] normalized -> [B, D, H/4, W/4]."""
        x = F.relu(self.norm1(self.conv1(x)))
        return self.conv2(self.layer2(self.layer1(x)))


class Patchify(nn.Module):
    def __init__(self, fdim, cdim):
        super().__init__()
        self.fnet = BasicEncoder4(fdim, "instance")
        self.inet = BasicEncoder4(cdim, "none")


def extract_patches(fmap, coords, radius: int = 1):
    """(2r+1)^2 patch grids from one feature map by bilinear sampling.

    Args:
      fmap: [H, W, C] single-frame features.
      coords: [P, 2] (x, y) patch centres in fmap pixels.

    Returns: [P, 2r+1, 2r+1, C].
    """
    d = torch.arange(-radius, radius + 1, dtype=coords.dtype,
                     device=coords.device)
    gy, gx = torch.meshgrid(d, d, indexing="ij")
    offs = torch.stack([gx, gy], dim=-1)  # [d, d, (x, y)]
    c = coords[:, None, None, :] + offs[None]
    frame = torch.zeros(c.shape[:-1], dtype=torch.long, device=c.device)
    return bilinear_gather(fmap[None], frame, c)


def mlp2(dim):
    """Linear -> ReLU -> Linear (upstream's c1/c2 and GatedResidual.res)."""
    return nn.Sequential(nn.Linear(dim, dim), nn.ReLU(), nn.Linear(dim, dim))


class GatedResidual(nn.Module):
    """x + sigmoid(gate(x)) * res(x)."""

    def __init__(self, dim):
        super().__init__()
        self.gate = nn.Sequential(nn.Linear(dim, dim), nn.Sigmoid())
        self.res = mlp2(dim)

    def forward(self, x):
        return x + self.gate(x) * self.res(x)


class SoftAgg(nn.Module):
    """Channel-wise softmax-weighted aggregation over a grouping index
    (upstream SoftAgg: w = scatter_softmax(g(x)); y = scatter_sum(f(x) * w);
    out = h(y) expanded back to the edges). Segment scatters throughout:
    the JAX package's default ("scatter") route."""

    def __init__(self, dim):
        super().__init__()
        self.f = nn.Linear(dim, dim)
        self.g = nn.Linear(dim, dim)
        self.h = nn.Linear(dim, dim)

    def forward(self, x, groups, num_groups: int):
        """x: [E, D]; groups: [E] int in [0, num_groups); dead edges use the
        trash group ``num_groups - 1``."""
        gx = self.g(x)
        fx = self.f(x)
        D = gx.shape[1]
        idx = groups[:, None].expand(-1, D)
        gmax = torch.full((num_groups, D), -torch.inf, device=x.device,
                          dtype=gx.dtype)
        gmax = gmax.scatter_reduce(0, idx, gx, reduce="amax")
        ex = torch.exp(gx - gmax[groups])
        gsum = torch.zeros(num_groups, D, device=x.device,
                           dtype=ex.dtype).index_add_(0, groups, ex)
        w = ex / gsum[groups].clamp(min=1e-12)
        y = torch.zeros(num_groups, D, device=x.device,
                        dtype=ex.dtype).index_add_(0, groups, fx * w)
        return self.h(y)[groups]


class UpdateNet(nn.Module):
    """Recurrent patch-graph update operator (upstream DPVO Update)."""

    def __init__(self, dim=384, corr_dim=882):
        super().__init__()
        self.c1 = mlp2(dim)
        self.c2 = mlp2(dim)
        self.norm = nn.LayerNorm(dim, eps=1e-3)
        self.agg_kk = SoftAgg(dim)
        self.agg_ij = SoftAgg(dim)
        self.gru = nn.Sequential(
            nn.LayerNorm(dim, eps=1e-3), GatedResidual(dim),
            nn.LayerNorm(dim, eps=1e-3), GatedResidual(dim),
        )
        self.corr = nn.Sequential(
            nn.Linear(corr_dim, dim), nn.ReLU(),
            nn.Linear(dim, dim), nn.LayerNorm(dim, eps=1e-3),
            nn.ReLU(), nn.Linear(dim, dim),
        )
        self.d = nn.Sequential(nn.ReLU(), nn.Linear(dim, 2))
        self.w = nn.Sequential(nn.ReLU(), nn.Linear(dim, 2), nn.Sigmoid())
        # learned BA damping in upstream checkpoints; unused, as upstream's
        # own loader ignores it
        self.lmbda = nn.Parameter(torch.zeros(1))

    def forward(self, net, inp, corr, kk, pair, ix, jx, num_patches: int,
                num_pairs: int):
        """
        Args:
          net: [E, D] hidden state per edge.
          inp: [E, D] host-patch context per edge.
          corr: [E, corr_dim] correlation features.
          kk: [E] patch group in [0, num_patches]; dead edges use the trash
            group ``num_patches``.
          pair: [E] (host, target) frame-pair group in [0, num_pairs]; trash
            group ``num_pairs`` for dead edges.
          ix, jx: [E] edge slot of the same patch's edge to the previous /
            next target frame, or -1 when absent.

        Returns: (net', delta [E, 2], weight [E, 2]).
        """
        net = self.norm(net + inp + self.corr(corr))
        # temporal neighbours; c2 reads the c1-updated hidden state
        net = net + self.c1((ix >= 0)[:, None] * net[ix.clamp(min=0)])
        net = net + self.c2((jx >= 0)[:, None] * net[jx.clamp(min=0)])
        net = net + self.agg_kk(net, kk, num_patches + 1)
        net = net + self.agg_ij(net, pair, num_pairs + 1)
        net = self.gru(net)
        return net, self.d(net), self.w(net)


class DPVONet(nn.Module):
    """The three sub-networks under upstream's key layout."""

    def __init__(self, fdim: int = 128, cdim: int = 384, corr_radius: int = 3):
        super().__init__()
        self.fdim, self.cdim = fdim, cdim
        self.patchify = Patchify(fdim, cdim)
        self.update = UpdateNet(cdim, 2 * 9 * (2 * corr_radius + 1) ** 2)

    def encode(self, images):
        """images [B, H, W, 3] uint8-range floats -> (fmap1, fmap2, imap),
        channels-last: [B, H/4, W/4, fdim], [B, H/8, W/8, fdim],
        [B, H/4, W/4, cdim]. Correlation then uses raw dot products of the
        pre-scaled features."""
        x = (2.0 * (images / 255.0) - 0.5).permute(0, 3, 1, 2)
        fmap1 = self.patchify.fnet(x) * 0.25
        imap = self.patchify.inet(x) * 0.25
        fmap2 = F.avg_pool2d(fmap1, 2, 2)
        nhwc = lambda t: t.permute(0, 2, 3, 1)  # noqa: E731
        return nhwc(fmap1), nhwc(fmap2), nhwc(imap)

    def update_step(self, net, inp, corr, kk, pair, ix, jx, num_patches,
                    num_pairs):
        return self.update(net, inp, corr, kk, pair, ix, jx, num_patches,
                           num_pairs)


# --------------------------------------------------------------------------
# Flax params -> state_dict (the inverse of the JAX convert_torch_checkpoint)
# --------------------------------------------------------------------------

def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


def _lin(sd, prefix, p):
    sd[prefix + ".weight"] = _t(np.asarray(p["kernel"]).T)
    sd[prefix + ".bias"] = _t(p["bias"])


def _conv(sd, prefix, p):
    sd[prefix + ".weight"] = _t(np.transpose(np.asarray(p["kernel"]),
                                             (3, 2, 0, 1)))
    if "bias" in p:
        sd[prefix + ".bias"] = _t(p["bias"])


def _ln(sd, prefix, p):
    sd[prefix + ".weight"] = _t(p["scale"])
    sd[prefix + ".bias"] = _t(p["bias"])


def _encoder4(sd, prefix, p):
    _conv(sd, prefix + ".conv1", p["conv1"])
    _conv(sd, prefix + ".conv2", p["conv2"])
    for layer in ("layer1", "layer2"):
        for i in (0, 1):
            blk = p[f"{layer}_{i}"]
            pre = f"{prefix}.{layer}.{i}"
            _conv(sd, pre + ".conv1", blk["conv1"])
            _conv(sd, pre + ".conv2", blk["conv2"])
            if "downsample" in blk:
                _conv(sd, pre + ".downsample.0", blk["downsample"])


def _mlp2(sd, prefix, p):
    _lin(sd, prefix + ".0", p["lin0"])
    _lin(sd, prefix + ".2", p["lin2"])


def from_jax_params(params_np: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Map the JAX ``DPVONet`` Flax params (nested dicts of numpy arrays,
    with or without the outer ``"params"`` key) onto this module's
    state_dict: conv kernels HWIO -> OIHW, dense kernels [in, out] ->
    [out, in], LayerNorm scale -> weight. ``update.lmbda``, which the JAX
    model does not carry, is zero."""
    p = params_np.get("params", params_np)
    sd: Dict[str, torch.Tensor] = {}
    _encoder4(sd, "patchify.fnet", p["fnet"])
    _encoder4(sd, "patchify.inet", p["inet"])
    u = p["update"]
    for i in (0, 2, 5):
        _lin(sd, f"update.corr.{i}", u[f"corr{i}"])
    _ln(sd, "update.corr.3", u["corr3"])
    _ln(sd, "update.norm", u["norm"])
    _mlp2(sd, "update.c1", u["c1"])
    _mlp2(sd, "update.c2", u["c2"])
    for agg in ("agg_kk", "agg_ij"):
        for k in ("f", "g", "h"):
            _lin(sd, f"update.{agg}.{k}", u[agg][k])
    for i in (0, 2):
        _ln(sd, f"update.gru.{i}", u[f"gru{i}"])
    for i in (1, 3):
        _lin(sd, f"update.gru.{i}.gate.0", u[f"gru{i}"]["gate0"])
        _mlp2(sd, f"update.gru.{i}.res", u[f"gru{i}"]["res"])
    _lin(sd, "update.d.1", u["d1"])
    _lin(sd, "update.w.1", u["w1"])
    sd["update.lmbda"] = torch.zeros(1)
    return sd


# --------------------------------------------------------------------------
# dpvo.pth -> state_dict (the JAX package's convert_torch_checkpoint)
# --------------------------------------------------------------------------

def convert_checkpoint(state_dict: Dict[str, Any],
                       corr_perm=None) -> Dict[str, torch.Tensor]:
    """An upstream ``dpvo.pth`` state dict -> :class:`DPVONet`'s, read as
    the JAX ``convert_torch_checkpoint`` reads it: ``module.`` prefixes
    stripped, ``update.lmbda`` dropped (the net's stays zero: no tracker
    reads it), keys the net does not have ignored.

    Args:
      corr_perm: optional [882] permutation of the input columns of
        ``update.corr.0.weight``: the JAX converter permutes the rows of
        its [in, out] kernel, this net's weight is [out, in].

    Raises ``KeyError`` naming a key the net needs that the file lacks.
    """
    sd = {}
    for k, v in state_dict.items():
        k = k.replace("module.", "")
        if "update.lmbda" not in k:
            sd[k] = torch.as_tensor(v)
    with torch.device("meta"):
        names = list(DPVONet().state_dict())
    out = {}
    for k in names:
        if k == "update.lmbda":
            out[k] = torch.zeros(1)
        elif k in sd:
            out[k] = sd[k]
        else:
            raise KeyError(f"dpvo checkpoint has no {k!r}")
    if corr_perm is not None:
        perm = torch.as_tensor(np.asarray(corr_perm), dtype=torch.long)
        out["update.corr.0.weight"] = out["update.corr.0.weight"][:, perm]
    return out


def load_torch_weights(path: str, corr_perm=None) -> Dict[str, torch.Tensor]:
    """Load a ``dpvo.pth`` from disk as :class:`DPVONet`'s state dict
    (``NERF_VO_DPVO_WEIGHTS`` names it for the tracking stage); see
    :func:`convert_checkpoint`."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return convert_checkpoint(sd, corr_perm)
