"""LPIPS(alex) perceptual metric in PyTorch.

The port's counterpart of ``nerf_vo_tpu/evaluation/lpips.py``, itself the
replacement for the ``lpips`` package the reference evaluator uses
(reference evaluation/evaluation_utils.py:418-444, SURVEY.md N9): the
AlexNet feature trunk, LPIPS input scaling, per-layer unit normalization,
and the learned non-negative 1x1 linear heads. The pretrained weights are
not in the repository, so :func:`load_torch_weights` reads a torch state
dict (either the ``lpips`` package's combined dump or torchvision
``alexnet`` features + ``lins``) when a file is available, and callers gate
on that.

Structure (Zhang et al., "The Unreasonable Effectiveness of Deep Features
as a Perceptual Metric", CVPR 2018):
  d(x, y) = sum_l mean_hw || w_l * (norm(f_l(x)) - norm(f_l(y))) ||^2
with f_l the 5 post-ReLU AlexNet feature stages.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# LPIPS input normalization (the package's ScalingLayer constants)
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)

# AlexNet feature geometry: (out_ch, kernel, stride, pad, maxpool_before)
_ALEX = (
    (64, 11, 4, 2, False),
    (192, 5, 1, 2, True),
    (384, 3, 1, 1, True),
    (256, 3, 1, 1, False),
    (256, 3, 1, 1, False),
)
_CHANNELS = tuple(c for c, *_ in _ALEX)
# torchvision AlexNet feature indices of the conv layers
_TV_IDX = (0, 3, 6, 8, 10)
# lpips-package slices: net.slice{n}.{local_idx}
_SLICE_IDX = ((1, 0), (2, 3), (3, 6), (4, 8), (5, 10))


class LPIPSAlex(nn.Module):
    """AlexNet trunk + LPIPS heads. ``forward(pred, target)`` takes
    [B, H, W, 3] RGB in [0, 1] and returns [B] distances."""

    def __init__(self):
        super().__init__()
        convs, cin = [], 3
        for cout, k, stride, pad, _ in _ALEX:
            convs.append(nn.Conv2d(cin, cout, k, stride, pad))
            cin = cout
        self.convs = nn.ModuleList(convs)
        self.lins = nn.ParameterList(
            [nn.Parameter(torch.zeros(c)) for c in _CHANNELS])
        self.register_buffer("shift", torch.tensor(_SHIFT).view(1, 3, 1, 1),
                             persistent=False)
        self.register_buffer("scale", torch.tensor(_SCALE).view(1, 3, 1, 1),
                             persistent=False)

    def features(self, x):
        """x: [B, 3, H, W] in [-1, 1] (LPIPS convention) -> 5 taps."""
        x = (x - self.shift) / self.scale
        taps = []
        for conv, (_, _, _, _, pool_before) in zip(self.convs, _ALEX):
            if pool_before:
                x = F.max_pool2d(x, 3, 2)
            x = F.relu(conv(x))
            taps.append(x)
        return taps

    def forward(self, pred, target):
        a = self.features(pred.permute(0, 3, 1, 2) * 2.0 - 1.0)
        b = self.features(target.permute(0, 3, 1, 2) * 2.0 - 1.0)
        total = 0.0
        for fa, fb, lin in zip(a, b, self.lins):
            na = fa / torch.linalg.norm(fa, dim=1, keepdim=True).clamp(
                min=1e-10)
            nb = fb / torch.linalg.norm(fb, dim=1, keepdim=True).clamp(
                min=1e-10)
            d = (na - nb) ** 2 * lin[:, None, None]
            total = total + d.sum(1).mean((1, 2))
        return total


def from_jax_params(params_np) -> Dict[str, torch.Tensor]:
    """The JAX parameter tree (``conv{i}_w`` HWIO, ``conv{i}_b``,
    ``lin{i}``; numpy) -> :class:`LPIPSAlex`'s ``state_dict``."""
    out = {}
    for i in range(len(_ALEX)):
        w = np.asarray(params_np[f"conv{i}_w"], np.float32)
        out[f"convs.{i}.weight"] = torch.from_numpy(
            np.ascontiguousarray(w.transpose(3, 2, 0, 1)))
        out[f"convs.{i}.bias"] = torch.from_numpy(
            np.asarray(params_np[f"conv{i}_b"], np.float32).copy())
        out[f"lins.{i}"] = torch.from_numpy(
            np.asarray(params_np[f"lin{i}"], np.float32).reshape(-1).copy())
    return out


def load_torch_weights(path: str) -> Dict[str, torch.Tensor]:
    """A torch LPIPS-Alex checkpoint -> :class:`LPIPSAlex`'s
    ``state_dict``.

    Accepts either (a) a combined ``lpips.LPIPS(net='alex')`` state dict
    (keys ``net.slice*.*.weight`` + ``lin*.model.1.weight``) or (b) a dict
    with torchvision ``features.*`` AlexNet keys + ``lin*`` heads. Conv
    kernels stay OIHW; the 1x1 head weights flatten to [C].
    """
    # weights_only=True: never execute pickled code from the checkpoint
    # path (it is user-supplied via NERF_VO_LPIPS_WEIGHTS). Full-module
    # pickles are intentionally unsupported — export a state dict instead.
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()

    def find(*cands):
        for c in cands:
            if c in sd:
                return sd[c].float()
        raise KeyError(f"none of {cands} in checkpoint ({len(sd)} keys)")

    out = {}
    for i in range(len(_ALEX)):
        s, li = _SLICE_IDX[i]
        t = _TV_IDX[i]
        out[f"convs.{i}.weight"] = find(
            f"features.{t}.weight", f"net.features.{t}.weight",
            f"net.slice{s}.{li}.weight")
        out[f"convs.{i}.bias"] = find(
            f"features.{t}.bias", f"net.features.{t}.bias",
            f"net.slice{s}.{li}.bias")
        lin = find(f"lin{i}.model.1.weight", f"lins.{i}.model.1.weight",
                   f"lin{i}.weight").reshape(-1)
        if lin.shape[0] != _CHANNELS[i]:
            raise ValueError(f"lin{i} has {lin.shape[0]} weights, not "
                             f"{_CHANNELS[i]}")
        out[f"lins.{i}"] = lin
    return out


_cached: Dict[Tuple[str, str], LPIPSAlex] = {}


@torch.no_grad()
def lpips_from_file(pred: np.ndarray, target: np.ndarray,
                    weights_path: str, device="cuda") -> Optional[float]:
    """Single-pair convenience wrapper, the network run on ``device`` and
    cached there by weights file."""
    device = torch.device(device)
    key = (weights_path, str(device))
    if key not in _cached:
        net = LPIPSAlex()
        net.load_state_dict(load_torch_weights(weights_path))
        _cached[key] = net.eval().to(device)
    d = _cached[key](
        torch.as_tensor(np.asarray(pred, np.float32), device=device)[None],
        torch.as_tensor(np.asarray(target, np.float32), device=device)[None],
    )
    return float(d[0])
