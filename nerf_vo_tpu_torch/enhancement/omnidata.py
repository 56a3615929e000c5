"""Dense depth/normal prior inference (Omnidata DPT models).

Counterpart of ``nerf_vo_tpu/enhancement/omnidata.py``: two DPT ViT-hybrid
networks — depth (1 channel, input Normalize(0.5, 0.5)) and normals
(3 channels, raw [0, 1] input) — run at a fixed square size on all K
keyframes of a packet at once; outputs are clamped to [0, 1] and resized
back to the frame size.

The resizes reproduce ``jax.image.resize(..., "cubic")`` exactly: Keys cubic
kernel (a = -0.5), half-pixel centres, and a widened (antialiasing) kernel
when a dimension shrinks. They are applied as one small resampling matrix per
axis.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import torch

from nerf_vo_tpu_torch.models import dpt
from nerf_vo_tpu_torch.models.dpt import DPTHybrid


def _keys_cubic(x):
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _cubic_weights(n_in: int, n_out: int, device):
    """[n_in, n_out] resampling matrix of jax.image's scale_and_translate
    for the cubic kernel, antialiased."""
    inv_scale = n_in / n_out
    kernel_scale = max(inv_scale, 1.0)
    sample_f = (torch.arange(n_out, dtype=torch.float32, device=device)
                + 0.5) * inv_scale - 0.5
    src = torch.arange(n_in, dtype=torch.float32, device=device)
    w = _keys_cubic((sample_f[None, :] - src[:, None]).abs() / kernel_scale)
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * torch.finfo(torch.float32).eps,
                    w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return torch.where(inside[None, :], w, 0.0)


def resize_cubic(x, out_h: int, out_w: int):
    """[K, H, W, C] -> [K, out_h, out_w, C], as jax.image.resize 'cubic'."""
    K, H, W, C = x.shape
    if H != out_h:
        x = torch.einsum("khwc,hH->kHwc", x, _cubic_weights(H, out_h,
                                                             x.device))
    if W != out_w:
        x = torch.einsum("khwc,wW->khWc", x, _cubic_weights(W, out_w,
                                                            x.device))
    return x


class OmnidataEstimator:
    def __init__(self, depth_state_dict: Optional[Dict] = None,
                 normal_state_dict: Optional[Dict] = None,
                 use_normals: bool = True, image_size: int = 384,
                 seed: int = 0, depth_layers: int = 12, device="cuda"):
        """Each model's weights: the state dict given; else the checkpoint
        that ``NERF_VO_OMNIDATA_DEPTH_WEIGHTS`` (depth) or
        ``NERF_VO_OMNIDATA_NORMAL_WEIGHTS`` (normals, read only with
        ``use_normals``) names, which must load; else random from ``seed``.
        The DPT computes in bf16 on cuda, as the JAX model does, and in f32
        on the CPU."""
        self.device = torch.device(device)
        self.image_size = image_size
        self.use_normals = use_normals
        self.hooks = (
            (8, 11) if depth_layers == 12
            else (max(depth_layers - 2, 0), depth_layers - 1)
        )
        self.depth_layers = depth_layers
        self.dtype = (torch.bfloat16 if self.device.type == "cuda"
                      else torch.float32)
        if depth_state_dict is None and os.environ.get(
                "NERF_VO_OMNIDATA_DEPTH_WEIGHTS"):
            depth_state_dict = dpt.load_torch_weights(
                os.environ["NERF_VO_OMNIDATA_DEPTH_WEIGHTS"], 1,
                depth_layers)
        if normal_state_dict is None and use_normals and os.environ.get(
                "NERF_VO_OMNIDATA_NORMAL_WEIGHTS"):
            normal_state_dict = dpt.load_torch_weights(
                os.environ["NERF_VO_OMNIDATA_NORMAL_WEIGHTS"], 3,
                depth_layers)
        self.depth_model = self._build(1, depth_state_dict, seed)
        self.normal_model = (
            self._build(3, normal_state_dict, seed + 1) if use_normals
            else None
        )

    def _build(self, num_channels, state_dict, seed):
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            model = DPTHybrid(num_channels=num_channels,
                              image_size=self.image_size,
                              depth_layers=self.depth_layers,
                              hooks=self.hooks, dtype=self.dtype)
        if state_dict is not None:
            model.load_state_dict(state_dict)
        return model.to(self.device).eval()

    @torch.no_grad()
    def __call__(self, frames) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """frames: [K, H, W, 3] f32 in [0, 1] on the estimator's device.
        Returns (depth [K, H, W], normals [K, H, W, 3] or None), in [0, 1]."""
        K, H, W, _ = frames.shape
        s = self.image_size
        x = resize_cubic(frames, s, s)
        depth = self.depth_model((x - 0.5) / 0.5)
        depth = resize_cubic(depth, H, W)[..., 0].clamp(0.0, 1.0)
        normal = None
        if self.normal_model is not None:
            normal = resize_cubic(self.normal_model(x), H, W).clamp(0.0, 1.0)
        return depth, normal
