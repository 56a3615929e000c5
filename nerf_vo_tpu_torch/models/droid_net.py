"""DROID-SLAM networks in PyTorch: 1/8-res encoders + ConvGRU update.

Counterpart of ``nerf_vo_tpu/models/droid_net.py``. The modules are NCHW
and carry upstream DROID-SLAM's torch key layout (``fnet.*``, ``cnet.*``,
``update.*``), so a ``droid.pth`` state dict loads with
:func:`load_torch_weights`, and :func:`from_jax_params` maps the JAX
package's Flax params onto it:

  * ``BasicEncoder8`` — RAFT-style residual encoder to 1/8 resolution
    (conv7x7/2 + 3 residual stages 64/96/128 + 1x1 head); ``fnet`` with
    instance norm, ``cnet`` with none.
  * ``UpdateModule`` — corr encoder (196->128 1x1, 128->128 3x3), flow
    encoder (4->128 7x7, 128->64 3x3), a ConvGRU over the 320-channel input
    with the global-context path, the delta / weight heads at 2 channels
    (the trained checkpoint's third channel is dropped at load, as the
    reference does), and the frame-level ``agg`` head (conv -> mean over
    each host frame's edges -> conv -> 0.01 * softplus damping + the
    576-channel upsample mask).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from nerf_vo_tpu_torch.models.dpvo_net import ResidualBlock

# ImageNet statistics: the reference normalizes frames with these before
# the encoders
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize_images(images_u8):
    """[B, 3, H, W] uint8-range floats -> ImageNet-normalized floats."""
    mean = torch.tensor(IMAGENET_MEAN, device=images_u8.device)
    std = torch.tensor(IMAGENET_STD, device=images_u8.device)
    return (images_u8 / 255.0 - mean[:, None, None]) / std[:, None, None]


class BasicEncoder8(nn.Module):
    """DROID BasicEncoder: 1/8 resolution, stages 64/96/128."""

    def __init__(self, output_dim=128, norm_fn="instance"):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3)
        self.norm1 = (nn.InstanceNorm2d(64) if norm_fn == "instance"
                      else nn.Sequential())
        self.layer1 = nn.Sequential(ResidualBlock(64, 64, norm_fn, 1),
                                    ResidualBlock(64, 64, norm_fn, 1))
        self.layer2 = nn.Sequential(ResidualBlock(64, 96, norm_fn, 2),
                                    ResidualBlock(96, 96, norm_fn, 1))
        self.layer3 = nn.Sequential(ResidualBlock(96, 128, norm_fn, 2),
                                    ResidualBlock(128, 128, norm_fn, 1))
        self.conv2 = nn.Conv2d(128, output_dim, 1)

    def forward(self, x):
        """x: [B, 3, H, W] normalized -> [B, D, H/8, W/8]."""
        x = F.relu(self.norm1(self.conv1(x)))
        return self.conv2(self.layer3(self.layer2(self.layer1(x))))


class ConvGRU(nn.Module):
    """DROID ConvGRU with the global-context path: a sigmoid-gated spatial
    mean of the hidden state feeds each gate through a 1x1 conv."""

    def __init__(self, h_planes=128, i_planes=320):
        super().__init__()
        self.convz = nn.Conv2d(h_planes + i_planes, h_planes, 3, padding=1)
        self.convr = nn.Conv2d(h_planes + i_planes, h_planes, 3, padding=1)
        self.convq = nn.Conv2d(h_planes + i_planes, h_planes, 3, padding=1)
        self.w = nn.Conv2d(h_planes, h_planes, 1)
        self.convz_glo = nn.Conv2d(h_planes, h_planes, 1)
        self.convr_glo = nn.Conv2d(h_planes, h_planes, 1)
        self.convq_glo = nn.Conv2d(h_planes, h_planes, 1)

    def forward(self, net, *inputs):
        inp = torch.cat(inputs, dim=1)
        net_inp = torch.cat([net, inp], dim=1)
        glo = (torch.sigmoid(self.w(net)) * net).mean((2, 3), keepdim=True)
        z = torch.sigmoid(self.convz(net_inp) + self.convz_glo(glo))
        r = torch.sigmoid(self.convr(net_inp) + self.convr_glo(glo))
        q = torch.tanh(self.convq(torch.cat([r * net, inp], dim=1))
                       + self.convq_glo(glo))
        return (1 - z) * net + z * q


class GraphAgg(nn.Module):
    """Frame-level head: conv before the mean over each host frame's edges
    (the upstream order), conv after, then damping and upsample mask."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(128, 128, 3, padding=1)
        self.conv2 = nn.Conv2d(128, 128, 3, padding=1)
        # index 1 is upstream's GradientClip, a no-op in the forward pass
        self.eta = nn.Sequential(nn.Conv2d(128, 1, 3, padding=1),
                                 nn.Identity(), nn.Softplus())
        self.upmask = nn.Sequential(nn.Conv2d(128, 8 * 8 * 9, 1))

    def forward(self, net, ii, num_frames: int):
        """net [E, 128, h, w], ii [E] host frame in [0, num_frames) ->
        eta [num_frames, h, w], upmask [num_frames, 576, h, w]."""
        a = F.relu(self.conv1(net))
        count = torch.zeros(num_frames, device=net.device).index_add_(
            0, ii, torch.ones(ii.shape[0], device=net.device))
        pooled = torch.zeros((num_frames,) + a.shape[1:],
                             device=net.device).index_add_(0, ii, a)
        pooled = pooled / count.clamp(min=1.0)[:, None, None, None]
        h2 = F.relu(self.conv2(pooled))
        return 0.01 * self.eta(h2)[:, 0], self.upmask(h2)


class UpdateModule(nn.Module):
    """Per-edge ConvGRU update: correlation + flow -> (delta, weight), and
    per host frame (damping, upsample mask) through the agg head."""

    def __init__(self, hidden=128, corr_dim=4 * 49):
        super().__init__()
        self.corr_encoder = nn.Sequential(
            nn.Conv2d(corr_dim, 128, 1), nn.ReLU(),
            nn.Conv2d(128, 128, 3, padding=1), nn.ReLU())
        self.flow_encoder = nn.Sequential(
            nn.Conv2d(4, 128, 7, padding=3), nn.ReLU(),
            nn.Conv2d(128, 64, 3, padding=1), nn.ReLU())
        # index 3 is upstream's GradientClip, a no-op in the forward pass
        self.weight = nn.Sequential(
            nn.Conv2d(128, 128, 3, padding=1), nn.ReLU(),
            nn.Conv2d(128, 2, 3, padding=1), nn.Identity(), nn.Sigmoid())
        self.delta = nn.Sequential(
            nn.Conv2d(128, 128, 3, padding=1), nn.ReLU(),
            nn.Conv2d(128, 2, 3, padding=1))
        self.gru = ConvGRU(hidden, 128 + 128 + 64)
        self.agg = GraphAgg()

    def forward(self, net, inp, corr, flow, ii=None, num_frames: int = 0):
        """
        Args:
          net: [E, 128, h, w] hidden per edge; inp: [E, 128, h, w] context
          of the host frame; corr: [E, 196, h, w]; flow: [E, 4, h, w]
          (flow + residual); ii: [E] host frame per edge.
          num_frames: frames of the agg head's output; 0 skips the head.
        Returns (net', delta [E, 2, h, w], weight [E, 2, h, w],
        eta [num_frames, h, w], upmask [num_frames, 576, h, w]), the last
        two None when the head is skipped.
        """
        c = self.corr_encoder(corr)
        f = self.flow_encoder(flow)
        net = self.gru(net, inp, c, f)
        delta = self.delta(net)
        weight = self.weight(net)
        eta = upmask = None
        if num_frames:
            eta, upmask = self.agg(net, ii, num_frames)
        return net, delta, weight, eta, upmask


def cvx_upsample(data, mask):
    """Learned convex 8x upsampling.

    Args:
      data: [N, h, w] field to upsample (e.g. inverse depth).
      mask: [N, 576, h, w] logits, channels (9, 8, 8) = (neighbour k,
        subpixel row, subpixel column), upstream's view order.

    Returns [N, 8h, 8w].
    """
    N, h, w = data.shape
    m = torch.softmax(mask.reshape(N, 9, 8, 8, h, w), dim=1)
    # 3x3 zero-padded neighbourhoods, k = (dy+1)*3 + (dx+1)
    neigh = F.unfold(data[:, None], 3, padding=1).reshape(N, 9, 1, 1, h, w)
    up = (m * neigh).sum(1)  # [N, 8, 8, h, w]
    return up.permute(0, 3, 1, 4, 2).reshape(N, 8 * h, 8 * w)


class DroidNet(nn.Module):
    def __init__(self, fdim: int = 128, cdim: int = 128):
        super().__init__()
        self.fdim, self.cdim = fdim, cdim
        self.fnet = BasicEncoder8(fdim, "instance")
        self.cnet = BasicEncoder8(2 * cdim, "none")
        self.update = UpdateModule(hidden=cdim)

    def encode_features(self, images):
        """ImageNet-normalized [B, 3, H, W] -> fmap [B, 128, H/8, W/8]."""
        return self.fnet(images)

    def encode_context(self, images):
        """-> (tanh hidden init, relu context), each [B, cdim, H/8, W/8]."""
        net, inp = self.cnet(images).split(self.cdim, dim=1)
        return torch.tanh(net), F.relu(inp)


# --------------------------------------------------------------------------
# weights
# --------------------------------------------------------------------------

def _conv(tree) -> Dict[str, torch.Tensor]:
    """Flax HWIO kernel + bias -> torch OIHW weight + bias."""
    k = np.asarray(tree["kernel"], np.float32)
    return {"weight": torch.tensor(k.transpose(3, 2, 0, 1)),
            "bias": torch.tensor(np.asarray(tree["bias"], np.float32))}


def _encoder(tree, prefix: str) -> Dict[str, torch.Tensor]:
    out = {}

    def put(name, sub):
        for k, v in _conv(sub).items():
            out[f"{prefix}.{name}.{k}"] = v

    put("conv1", tree["conv1"])
    put("conv2", tree["conv2"])
    for stage in (1, 2, 3):
        for blk in (0, 1):
            res = tree[f"layer{stage}_{blk}"]
            base = f"layer{stage}.{blk}"
            put(f"{base}.conv1", res["conv1"])
            put(f"{base}.conv2", res["conv2"])
            if "downsample" in res:
                put(f"{base}.downsample.0", res["downsample"])
    return out


def from_jax_params(params_np) -> Dict[str, torch.Tensor]:
    """The JAX ``DroidNet`` params (nested numpy dicts ``{"fnet", "cnet",
    "update"}``) -> :class:`DroidNet`'s ``state_dict`` in upstream's
    ``droid.pth`` layout. The inverse of the JAX package's
    ``convert_torch_checkpoint``."""
    out = {}
    out.update(_encoder(params_np["fnet"], "fnet"))
    out.update(_encoder(params_np["cnet"], "cnet"))
    u = params_np["update"]
    names = {
        "corr_encoder.0": u["corr_enc0"], "corr_encoder.2": u["corr_enc2"],
        "flow_encoder.0": u["flow_enc0"], "flow_encoder.2": u["flow_enc2"],
        "delta.0": u["delta0"], "delta.2": u["delta2"],
        "weight.0": u["weight0"], "weight.2": u["weight2"],
        "agg.conv1": u["agg_conv1"], "agg.conv2": u["agg_conv2"],
        "agg.eta.0": u["agg_eta"], "agg.upmask.0": u["agg_upmask"],
    }
    for g in ("convz", "convr", "convq", "w", "convz_glo", "convr_glo",
              "convq_glo"):
        names[f"gru.{g}"] = u["gru"][g]
    for name, sub in names.items():
        for k, v in _conv(sub).items():
            out[f"update.{name}.{k}"] = v
    return out


def convert_checkpoint(state_dict: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """An upstream ``droid.pth`` state dict -> :class:`DroidNet`'s: the
    ``module.`` prefixes stripped, the 3-channel delta / weight heads
    sliced to their first two channels (the reference's surgery at load)."""
    out = {}
    for k, v in state_dict.items():
        k = k.replace("module.", "")
        if k.startswith(("update.delta.2.", "update.weight.2.")):
            v = v[:2]
        out[k] = torch.as_tensor(v)
    return out


def load_torch_weights(path: str) -> Dict[str, torch.Tensor]:
    """Load a ``droid.pth`` from disk as :class:`DroidNet`'s state dict
    (``NERF_VO_DROID_WEIGHTS`` names it for the tracking stage)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return convert_checkpoint(sd)
