"""The benchmark's scenes: an analytic box room ray-cast on the device.

A frozen copy of ``chip_smoke.py``'s room (``ROOM_LO`` / ``ROOM_HI``,
``room_pose`` and ``room_frame``, chip_smoke.py:1633-1691), kept here so that
a later edit of that script cannot move the yardstick. What the copy adds:
the seed picks the walls' base colours, the checker's phase and where the
camera path starts, and the camera runs a closed loop (a yaw turn every
``frames_per_turn`` frames on a small circle with a slow bob) so that a
stream of any length stays inside the room.

Every frame is cast in float64 on the device in one batched call; colours
are uint8 as a JPEG decoder gives them and depths are quantized to the
camera's depth scale as a depth PNG holds them.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

import torch

# a box the size of a Replica room, in metres (chip_smoke.py ROOM_LO/HI)
ROOM_LO = (-2.5, -1.25, -1.5)
ROOM_HI = (2.5, 1.25, 3.0)
CHECKER_M = 0.25


def camera(cfg: Dict) -> Dict[str, float]:
    """The configuration's camera at its frame size: the source camera of
    ``cfg["assumed"]["camera"]`` scaled as the port's loaders scale it
    (``fx * width / source width`` and so on)."""
    src = cfg["assumed"]["camera"]
    H, W = cfg["frame_height"], cfg["frame_width"]
    sx, sy = W / src["width"], H / src["height"]
    return dict(height=H, width=W, fx=src["fx"] * sx, fy=src["fy"] * sy,
                cx=src["cx"] * sx, cy=src["cy"] * sy,
                depth_scale=src["depth_scale"])


def scene(seed: int, device) -> Dict[str, torch.Tensor]:
    """The seed's room: six wall colours, the checker's phase on each wall
    and the phase of the camera loop."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) & (2**63 - 1))
    f64 = dict(dtype=torch.float64, device=device)
    return dict(base=0.15 + 0.75 * torch.rand(6, 3, generator=g, **f64),
                checker=torch.rand(6, 2, generator=g, **f64) * CHECKER_M,
                phase=torch.rand(1, generator=g, **f64) * 2 * math.pi)


def poses(sc: Dict[str, torch.Tensor], indices: Sequence[int],
          frames_per_turn: int) -> torch.Tensor:
    """OpenCV camera-to-world [N, 4, 4] f64 of frames ``indices`` of the
    loop: yaw turns once every ``frames_per_turn`` frames (0.5 degrees a
    frame at 720), the camera circles 0.5 m around the room's centre twice
    a turn and bobs 10 cm, so every frame sees three to four walls."""
    dev = sc["phase"].device
    i = torch.as_tensor(list(indices), dtype=torch.float64, device=dev)
    a = 2 * math.pi * i / frames_per_turn + sc["phase"]
    c, s = torch.cos(a), torch.sin(a)
    n = i.shape[0]
    c2w = torch.eye(4, dtype=torch.float64, device=dev).repeat(n, 1, 1)
    c2w[:, 0, 0], c2w[:, 0, 2] = c, s
    c2w[:, 2, 0], c2w[:, 2, 2] = -s, c
    centre = [0.5 * (lo + hi) for lo, hi in zip(ROOM_LO, ROOM_HI)]
    c2w[:, 0, 3] = centre[0] + 0.5 * torch.cos(2 * a)
    c2w[:, 1, 3] = centre[1] + 0.1 * torch.sin(3 * a)
    c2w[:, 2, 3] = centre[2] + 0.5 * torch.sin(2 * a)
    return c2w


@torch.no_grad()
def frames(sc: Dict[str, torch.Tensor], c2w: torch.Tensor,
           cam: Dict[str, float]):
    """Ray-cast the room from inside (chip_smoke.py ``room_frame``, batched
    over frames): colour uint8 [N, H, W, 3] (a checker of 25 cm on each
    wall, one base colour a wall, the seed's phase) and z-depth f32
    [N, H, W] quantized to the camera's depth scale."""
    H, W = cam["height"], cam["width"]
    dev = c2w.device
    f64 = dict(dtype=torch.float64, device=dev)
    ys, xs = torch.meshgrid(torch.arange(H, **f64), torch.arange(W, **f64),
                            indexing="ij")
    d = torch.stack([(xs - cam["cx"]) / cam["fx"],
                     (ys - cam["cy"]) / cam["fy"], torch.ones_like(xs)], -1)
    dw = torch.einsum("hwj,nij->nhwi", d, c2w[:, :3, :3])
    o = c2w[:, None, None, :3, 3]
    lo, hi = torch.tensor(ROOM_LO, **f64), torch.tensor(ROOM_HI, **f64)
    bound = torch.where(dw > 0, hi, lo)
    t_axis = torch.where(dw.abs() > 1e-12, (bound - o) / dw,
                         torch.full_like(dw, float("inf")))
    t, axis = t_axis.min(-1)  # the wall the ray leaves through
    p = o + dw * t[..., None]
    wall = axis * 2 + (dw.gather(-1, axis[..., None])[..., 0] > 0).long()
    u = p.gather(-1, ((axis + 1) % 3)[..., None])[..., 0]
    v = p.gather(-1, ((axis + 2) % 3)[..., None])[..., 0]
    u = u + sc["checker"][wall, 0]
    v = v + sc["checker"][wall, 1]
    check = (torch.floor(u / CHECKER_M) + torch.floor(v / CHECKER_M)) % 2
    color = sc["base"][wall] * (0.55 + 0.45 * check[..., None])
    color = (color * 255).round().clamp(0, 255).to(torch.uint8)
    scale = cam["depth_scale"]
    depth = (torch.round(t * scale).clamp(0, 65535) / scale).float()
    return color, depth


def opencv_to_opengl(c2w: torch.Tensor) -> torch.Tensor:
    """Camera axes flipped from OpenCV (+y down, +z forward) to OpenGL (+y
    up, -z forward), as the enhancement stage hands poses to the mapper."""
    flip = torch.tensor([1.0, -1.0, -1.0, 1.0], dtype=c2w.dtype,
                        device=c2w.device)
    return c2w * flip


def keyframes(cfg: Dict, traffic: Dict, seed: int, device
              ) -> Dict[str, torch.Tensor]:
    """The mapping cells' keyframe set: ``traffic["keyframes"]`` frames of
    the seed's loop, ``traffic["keyframe_stride"]`` frames apart, as an
    enhanced packet holds them: OpenGL c2w [K, 4, 4] f32, intrinsics
    [K, 4], colour f32 in [0, 1] [K, H, W, 3] and z-depth [K, H, W]."""
    cam = camera(cfg)
    sc = scene(seed, device)
    K = traffic["keyframes"]
    idx = [k * traffic["keyframe_stride"] for k in range(K)]
    c2w = poses(sc, idx, traffic["frames_per_turn"])
    color, depth = frames(sc, c2w, cam)
    intr = torch.tensor([cam["fx"], cam["fy"], cam["cx"], cam["cy"]],
                        dtype=torch.float32, device=device).repeat(K, 1)
    return dict(c2w=opencv_to_opengl(c2w).float(), intrinsics=intr,
                color=color.float() / 255.0, depth=depth)
