"""Dense all-pairs correlation volumes + pyramid lookup (DROID-SLAM style).

Counterpart of ``nerf_vo_tpu/ops/dense_corr.py``: for each factor-graph edge
(i, j), the full correlation volume between frame i's and frame j's 1/8-res
feature maps is one f32 batched matmul, pooled into a 4-level pyramid and
stored in ``NERF_VO_CORR_PYRAMID_DTYPE`` (``bfloat16``, the default, or
``float32``; read at import, any other value raises, as in the JAX module;
half-precision volumes are the upstream DROID-SLAM behaviour: its
CorrBlock runs under fp16 autocast); each update then looks up (2r+1)^2
bilinear neighbourhoods around per-pixel correspondences, reading the
volumes in f32.

Layout: features and coordinates are channels-last, as the tracker keeps
them ([E, h, w, C], [E, h, w, 2]); volumes are ``[E, h*w, hl, wl]`` per
level (source pixel, then the target grid).
"""

from __future__ import annotations

import os
from typing import List, Sequence

import torch

_PYRAMID_DTYPE_NAME = os.environ.get("NERF_VO_CORR_PYRAMID_DTYPE",
                                     "bfloat16")
if _PYRAMID_DTYPE_NAME not in ("float32", "bfloat16"):
    raise ValueError(
        "NERF_VO_CORR_PYRAMID_DTYPE must be 'float32' or 'bfloat16', got "
        f"{_PYRAMID_DTYPE_NAME!r}")
PYRAMID_DTYPE = getattr(torch, _PYRAMID_DTYPE_NAME)

# edges per pyramid build: bounds the f32 all-pairs temporaries (the full
# replica frame holds 3600 pixels, 52 MB of f32 volume per edge)
_EDGE_CHUNK = 16


def build_corr_pyramid(fmap_i, fmap_j, num_levels: int = 4
                       ) -> List[torch.Tensor]:
    """All-pairs correlation pyramid for a batch of edges.

    Args:
      fmap_i: [E, h, w, C] source features.
      fmap_j: [E, h, w, C] target features.

    Returns: list of [E, h*w, h/2^l, w/2^l] volumes in ``PYRAMID_DTYPE``,
    l = 0..L-1. A
    level with fewer than 2 rows (columns) is not pooled along that axis.
    The product and the pooling run in f32; only the stored volumes are
    cast.
    """
    E, h, w, C = fmap_i.shape
    shapes = [(h, w)]
    for _ in range(num_levels - 1):
        hl, wl = shapes[-1]
        shapes.append((hl // 2 if hl >= 2 else hl, wl // 2 if wl >= 2 else wl))
    pyramid = [torch.empty(E, h * w, hl, wl, dtype=PYRAMID_DTYPE,
                           device=fmap_i.device) for hl, wl in shapes]
    sqrt_c = torch.sqrt(torch.tensor(float(C), device=fmap_i.device))
    for e0 in range(0, E, _EDGE_CHUNK):
        fi = fmap_i[e0:e0 + _EDGE_CHUNK].reshape(-1, h * w, C).float()
        fj = fmap_j[e0:e0 + _EDGE_CHUNK].reshape(-1, h * w, C).float()
        c = (torch.bmm(fi, fj.transpose(1, 2)) / sqrt_c).reshape(
            -1, h * w, h, w)
        pyramid[0][e0:e0 + _EDGE_CHUNK] = c
        for lvl in range(1, num_levels):
            ch, cw = c.shape[-2:]
            ph = 2 if ch >= 2 else 1
            pw = 2 if cw >= 2 else 1
            hl, wl = ch // ph, cw // pw
            c = c[..., :hl * ph, :wl * pw].reshape(
                -1, h * w, hl, ph, wl, pw).mean(dim=(3, 5))
            pyramid[lvl][e0:e0 + _EDGE_CHUNK] = c
    return pyramid


def _window(vol, coords, radius: int):
    """All (2r+1)^2 bilinear window taps around per-row centres.

    Every integer offset shares one fractional part per centre, so the taps
    lie on a (2r+2)^2 integer grid: one gather of that grid (zero outside
    the volume), then a blend of four shifted copies.

    vol [E, P, H, W]; coords [E, P, 2] (x, y) at this level.
    Returns [E, P, (2r+1)^2] f32, rows y-major.
    """
    E, P, H, W = vol.shape
    D = 2 * radius + 1
    G = D + 1
    x0f = torch.floor(coords[..., 0])
    y0f = torch.floor(coords[..., 1])
    fx = (coords[..., 0] - x0f)[..., None, None]
    fy = (coords[..., 1] - y0f)[..., None, None]
    off = torch.arange(G, device=vol.device)
    rows = y0f.long()[..., None] - radius + off  # [E, P, G]
    cols = x0f.long()[..., None] - radius + off
    inb = (((rows >= 0) & (rows < H))[..., :, None]
           & ((cols >= 0) & (cols < W))[..., None, :])  # [E, P, G, G]
    ep = torch.arange(E * P, device=vol.device).reshape(E, P, 1, 1)
    flat = ((ep * H + rows.clamp(0, H - 1)[..., :, None]) * W
            + cols.clamp(0, W - 1)[..., None, :])
    b = vol.reshape(-1)[flat].float()
    b = torch.where(inb, b, torch.zeros((), dtype=b.dtype, device=b.device))
    b00 = b[:, :, :D, :D]
    b01 = b[:, :, :D, 1:]
    b10 = b[:, :, 1:, :D]
    b11 = b[:, :, 1:, 1:]
    out = ((1 - fy) * (1 - fx) * b00 + (1 - fy) * fx * b01
           + fy * (1 - fx) * b10 + fy * fx * b11)
    return out.reshape(E, P, D * D)


def corr_lookup(pyramid: Sequence[torch.Tensor], coords, radius: int = 3):
    """Pyramid neighbourhood lookup at per-pixel correspondences.

    Args:
      pyramid: list of [E, h*w, hl, wl] volumes.
      coords: [E, h, w, 2] (x, y) correspondence estimates at level 0.

    Returns: [E, h, w, L * (2r+1)^2] f32 correlation features.
    """
    E, h, w, _ = coords.shape
    c0 = coords.reshape(E, h * w, 2)
    out = [_window(vol, c0 / (2.0 ** lvl), radius)
           for lvl, vol in enumerate(pyramid)]
    return torch.cat(out, dim=-1).reshape(E, h, w, -1)
