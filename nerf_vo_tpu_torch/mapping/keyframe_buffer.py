"""Device-resident keyframe training buffer + ray-batch sampling.

Counterpart of ``nerf_vo_tpu/mapping/keyframe_buffer.py``: preallocated
``[K, ...]`` tensors hold the keyframe stream (color, aligned depth,
normals, poses, intrinsics); the mapping stage inserts keyframes in place
(this port updates the tensors in place where the JAX package returns a new
buffer); the trainer samples random pixels over the active prefix each step.

All per-pixel channels live interleaved in one flat ``pixels`` tensor
``[K, H*W*C]`` of ``PIXEL_DTYPE``, so one gather fetches a ray's every
target. ``NERF_VO_PIXEL_DTYPE``, read at import as the JAX module reads it,
picks it: ``bfloat16`` (the default) or ``float32`` (exact targets); any
other value raises. Channel layout within a pixel's C-element block:

  0:3  color rgb
  3    z-depth (0 = invalid)
  4:7  camera-frame unit normal      (present iff use_normals)
  last depth variance (1 = unweighted; present iff use_depth_cov)

The first insert fixes the gauge: keyframe 0 is pinned to the identity pose
and every pose is stored pre-multiplied by that normalization.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional

import torch

from nerf_vo_tpu_torch.core import cameras, conventions, lie

_PIXEL_DTYPE_NAME = os.environ.get("NERF_VO_PIXEL_DTYPE", "bfloat16")
if _PIXEL_DTYPE_NAME not in ("float32", "bfloat16"):
    raise ValueError(
        "NERF_VO_PIXEL_DTYPE must be 'float32' or 'bfloat16', got "
        f"{_PIXEL_DTYPE_NAME!r}")
PIXEL_DTYPE = getattr(torch, _PIXEL_DTYPE_NAME)


@dataclasses.dataclass
class KeyframeBuffer:
    """Preallocated keyframe tensors. K = max keyframes."""

    intrinsics: torch.Tensor  # [K, 4] fx fy cx cy
    c2w: torch.Tensor  # [K, 4, 4] OpenGL-convention camera-to-world
    pixels: torch.Tensor  # [K, H*W*C] packed per-pixel channels
    num_active: int  # keyframes inserted so far (the active prefix)
    normalization: torch.Tensor  # [4, 4] gauge-fixing world transform
    height: int
    width: int
    use_normals: bool = True
    use_depth_cov: bool = False

    @property
    def capacity(self) -> int:
        return self.pixels.shape[0]

    @property
    def hw(self):
        return self.height, self.width

    @property
    def channels(self) -> int:
        return 4 + (3 if self.use_normals else 0) + (
            1 if self.use_depth_cov else 0)

    def _frames(self):
        return self.pixels.reshape(self.capacity, self.height, self.width,
                                   self.channels).float()

    @property
    def color(self) -> torch.Tensor:  # [K, H, W, 3]
        return self._frames()[..., 0:3]

    @property
    def depth(self) -> torch.Tensor:  # [K, H, W]
        return self._frames()[..., 3]

    @property
    def normal(self) -> torch.Tensor:  # [K, H, W, 3] (or [K, 1, 1, 3] stub)
        if not self.use_normals:
            return torch.zeros(self.capacity, 1, 1, 3,
                               device=self.pixels.device)
        return self._frames()[..., 4:7]

    @property
    def depth_cov(self) -> torch.Tensor:  # [K, H, W] (or [K, 1, 1] stub)
        if not self.use_depth_cov:
            return torch.ones(self.capacity, 1, 1, device=self.pixels.device)
        return self._frames()[..., self.channels - 1]


def create(num_keyframes: int, height: int, width: int,
           use_normals: bool = True, use_depth_cov: bool = False,
           device="cuda") -> KeyframeBuffer:
    K, H, W = num_keyframes, height, width
    C = 4 + (3 if use_normals else 0) + (1 if use_depth_cov else 0)
    pixels = torch.zeros(K, H * W * C, dtype=PIXEL_DTYPE, device=device)
    if use_depth_cov:  # cov channel defaults to 1 (unweighted)
        pixels.view(K, H * W, C)[:, :, C - 1] = 1.0
    return KeyframeBuffer(
        intrinsics=torch.ones(K, 4, device=device),
        c2w=torch.eye(4, device=device).expand(K, 4, 4).clone(),
        pixels=pixels,
        num_active=0,
        normalization=torch.eye(4, device=device),
        height=H,
        width=W,
        use_normals=use_normals,
        use_depth_cov=use_depth_cov,
    )


def insert(buffer: KeyframeBuffer, indices, packet: Dict[str, torch.Tensor]
           ) -> KeyframeBuffer:
    """Insert / update keyframes at ``indices``, in place.

    packet keys (leading dim = len(indices)): intrinsics [N, 4], c2w
    [N, 4, 4] (OpenGL cam2world, tracker world frame), color [N, H, W, 3],
    optional depth [N, H, W], normal [N, H, W, 3], depth_cov [N, H, W].
    Channels absent from the packet keep their previous contents.
    """
    dev = buffer.pixels.device
    indices = torch.as_tensor(indices, dtype=torch.long, device=dev)
    c2w_in = packet["c2w"].to(dev, torch.float32)
    if buffer.num_active == 0:
        buffer.normalization = conventions.gauge_normalization_matrix(
            c2w_in[0])
    c2w = conventions.apply_transform(buffer.normalization, c2w_in)

    H, W, C = buffer.height, buffer.width, buffer.channels
    N = indices.shape[0]
    old = buffer.pixels[indices].reshape(N, H, W, C).float()

    def chan(key, fallback):
        return packet[key].to(dev, torch.float32) if key in packet \
            else fallback

    parts = [packet["color"].to(dev, torch.float32),
             chan("depth", old[..., 3])[..., None]]
    if buffer.use_normals:
        parts.append(chan("normal", old[..., 4:7]))
    if buffer.use_depth_cov:
        parts.append(chan("depth_cov", old[..., C - 1])[..., None])
    rows = torch.cat(parts, dim=-1).reshape(N, H * W * C)

    buffer.intrinsics[indices] = packet["intrinsics"].to(dev, torch.float32)
    buffer.c2w[indices] = c2w
    buffer.pixels[indices] = rows.to(PIXEL_DTYPE)
    buffer.num_active = max(buffer.num_active, int(indices.max()) + 1)
    return buffer


def draw_pixels(buffer: KeyframeBuffer, num_rays: int, generator=None):
    """Random pixel picks over the active keyframes: {"frame", "py", "px"},
    int64 [R] each, from ``generator``."""
    H, W = buffer.hw
    dev = buffer.pixels.device
    n_active = max(buffer.num_active, 1)
    kw = dict(generator=generator, device=dev)
    return {
        "frame": torch.randint(0, n_active, (num_rays,), **kw),
        "py": torch.randint(0, H, (num_rays,), **kw),
        "px": torch.randint(0, W, (num_rays,), **kw),
    }


def sample_pixel_batch(buffer: KeyframeBuffer, num_rays: int,
                       picks: Optional[Dict[str, torch.Tensor]] = None,
                       generator=None) -> Dict[str, torch.Tensor]:
    """The pose-free half of ray-batch sampling: pixel picks (``picks``
    {"frame", "py", "px"} when given, else drawn from ``generator``) and one
    flat gather of every per-pixel channel.

    Returns {"frame", "py", "px", "px_data"}: px_data [R, C] f32.
    """
    if picks is None:
        picks = draw_pixels(buffer, num_rays, generator)
    dev = buffer.pixels.device
    frame, py, px = (picks[k].to(dev, torch.long) for k in ("frame", "py",
                                                             "px"))
    H, W = buffer.hw
    C = buffer.channels
    base = ((frame * H + py) * W + px) * C
    flat = buffer.pixels.reshape(-1)
    px_data = flat[base[:, None] + torch.arange(C, device=dev)[None, :]]
    return {"frame": frame, "py": py, "px": px, "px_data": px_data.float()}


def rays_from_pixel_batch(buffer: KeyframeBuffer, pose_deltas,
                          pixel_batch: Dict[str, torch.Tensor],
                          convention: str = "opengl"
                          ) -> Dict[str, torch.Tensor]:
    """The pose-dependent half of ray-batch sampling: compose the
    camera-optimizer SE3 deltas per keyframe, take each ray's pose and
    intrinsics, generate rays, unpack the channels. Differentiable with
    respect to ``pose_deltas`` ([K, 6] or None)."""
    K = buffer.capacity
    C = buffer.channels
    frame = pixel_batch["frame"]
    num_rays = frame.shape[0]
    if pose_deltas is not None:
        delta = lie.se3_matrix(lie.se3_exp(pose_deltas))  # [K, 4, 4]
        c2w_all = conventions.apply_transform(delta, buffer.c2w)
    else:
        c2w_all = buffer.c2w
    fr = torch.cat([c2w_all.reshape(K, 16), buffer.intrinsics], dim=1)[frame]
    c2w = fr[:, :16].reshape(num_rays, 4, 4)
    intr = fr[:, 16:20]
    xy = torch.stack([pixel_batch["px"], pixel_batch["py"]],
                     dim=-1).float() + 0.5
    origins, dirs, dirs_norm = cameras.generate_rays(c2w, intr, xy,
                                                     convention)

    px_data = pixel_batch["px_data"]
    depth_z = px_data[:, 3]
    batch = {
        "origins": origins,
        "directions": dirs,
        "directions_norm": dirs_norm[..., 0],
        "rgb": px_data[:, 0:3],
        "camera_indices": frame,
        "depth": depth_z * dirs_norm[..., 0],  # euclidean ray distance
        "depth_mask": depth_z > 0,
    }
    if buffer.use_normals:
        n_cam = px_data[:, 4:7]
        # camera-frame normals rotated to world
        batch["normal"] = torch.einsum("rij,rj->ri", c2w[:, :3, :3], n_cam)
        batch["normal_mask"] = torch.sum(n_cam * n_cam, dim=-1) > 1e-6
    if buffer.use_depth_cov:
        batch["depth_cov"] = px_data[:, C - 1]
    return batch


def sample_ray_batch(buffer: KeyframeBuffer, pose_deltas, num_rays: int,
                     picks=None, generator=None, convention: str = "opengl"
                     ) -> Dict[str, torch.Tensor]:
    """A training ray batch over the active keyframes: the composition of
    :func:`sample_pixel_batch` and :func:`rays_from_pixel_batch`."""
    pb = sample_pixel_batch(buffer, num_rays, picks, generator)
    return rays_from_pixel_batch(buffer, pose_deltas, pb, convention)
