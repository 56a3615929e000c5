"""Patch correlation through the hand-written CUDA kernel ``csrc/corr.cu``.

Counterpart of ``nerf_vo_tpu/ops/correlation_pallas.py``
(``patch_correlation_pallas`` around the Pallas kernel ``corr_window_dot``).
It follows the Pallas route's rule at the frame border: a centre outside
``[0, W-1] x [0, H-1]`` gets an all-zero window, where the plain route of
``ops/correlation.py`` keeps the partial window.

- :func:`corr_level_plain` is the plain PyTorch version of one level; the
  CPU tests use it and the chip smoke holds the kernel against it.
- :func:`corr_level` (one level) and :func:`corr_two_level` (both levels
  of an update in one launch, the edges walked in target-slot order) are
  the wrappers: on a CPU tensor they take the plain version; on a CUDA
  tensor they launch the kernel or raise.
  ``<wrapper>.launches`` counts the launches.
- :func:`patch_correlation_kernel` is the two-level function the CUDA
  tracker calls: one launch per update.

What bounds the kernel, and its design, are noted at the top of
``csrc/corr.cu``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from nerf_vo_tpu_torch.ops import cuda_build
from nerf_vo_tpu_torch.ops.correlation import level_correlation

MAX_CHANNELS = 128  # the kernel pads C to 16, 32, 64 or 128 on chip
SORT_BLOCKS = 1024  # blocks the in-launch slot sort keeps counts for


def corr_level_plain(fmap, pf, ring, center, radius: int = 3,
                     chunk: int = 4096):
    """Plain PyTorch version of one level (the kernel's yardstick).

    Args:
      fmap: [R, H, W, C] feature ring (bf16 on the tracker's path).
      pf: [E, 9, C] patch features.
      ring: [E] int target ring slot.
      center: [E, 2] f32 centres in this level's pixels.

    Returns: [E, 9 * (2r+1)^2] f32 in (p, dy, dx) order; all zero for an
    edge whose centre is outside the frame or whose slot is out of range.
    """
    R, H, W, C = fmap.shape
    E = pf.shape[0]
    D = 2 * radius + 1
    out = torch.empty(E, 9 * D * D, dtype=torch.float32, device=fmap.device)
    for s in range(0, E, chunk):
        sl = slice(s, s + chunk)
        ce, rg = center[sl].float(), ring[sl].long()
        cx, cy = ce[:, 0], ce[:, 1]
        usable = ((cx >= 0) & (cx <= W - 1) & (cy >= 0) & (cy <= H - 1)
                  & (rg >= 0) & (rg < R))
        cc = torch.where(usable[:, None], ce, torch.zeros_like(ce))
        c = level_correlation(fmap, rg.clamp(0, R - 1), pf[sl], cc, radius)
        out[sl] = torch.where(usable[:, None], c.reshape(c.shape[0], -1), 0.0)
    return out


@functools.lru_cache(maxsize=None)
def _lib():
    lib = cuda_build.load("corr")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.corr_level.argtypes = [p] * 5 + [i] * 7 + [p]
    lib.corr_two_level.argtypes = [p] * 7 + [i] * 9 + [p]
    for fn in (lib.corr_level, lib.corr_two_level):
        fn.restype = ctypes.c_int
    return lib


def _check(t, name, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")


def _check_inputs(fn, fmaps, pf, ring, center, radius):
    """Device, dtype, shape, contiguity and alignment of a launch's inputs;
    returns (E, R, C)."""
    R, _, _, C = fmaps[0].shape
    E = pf.shape[0]
    dev = fmaps[0].device
    for k, fmap in enumerate(fmaps):
        _check(fmap, f"fmap{k}", torch.bfloat16, (R,) + fmap.shape[1:3] + (C,),
               dev)
    _check(pf, "pf", torch.bfloat16, (E, 9, C), dev)
    _check(ring, "ring", torch.int32, (E,), dev)
    _check(center, "center", torch.float32, (E, 2), dev)
    if C % 8 or C > MAX_CHANNELS:
        raise ValueError(f"{fn}: C={C}; the kernel takes C % 8 == 0, "
                         f"C <= {MAX_CHANNELS}")
    if radius < 0:
        raise ValueError(f"{fn}: negative radius {radius}")
    for name, t, align in [(f"fmap{k}", f, 16) for k, f in enumerate(fmaps)] \
            + [("pf", pf, 16), ("ring", ring, 4), ("center", center, 8)]:
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {name} is not contiguous")
        if t.data_ptr() % align:
            raise ValueError(f"{fn}: {name} is not {align}-byte aligned")
    return E, R, C


def _out(out, E, cols, dev, fn):
    if out is None:
        out = torch.empty(E, cols, dtype=torch.float32, device=dev)
    _check(out, "out", torch.float32, (E, cols), dev)
    if out.stride(1) != 1:
        raise ValueError(f"{fn}: out rows must be contiguous")
    return out


def _launched(fn, rc):
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} kernel launch failed: "
                           f"cudaError {rc}")
    fn.launches += 1


def corr_level(fmap, pf, ring, center, radius: int = 3, out=None):
    """One pyramid level of the Pallas-rule correlation.

    CPU tensors take :func:`corr_level_plain`. CUDA tensors launch the
    kernel: fmap [R, H, W, C] bf16, pf [E, 9, C] bf16, ring [E] int32,
    center [E, 2] f32 in this level's pixels, all contiguous, C a multiple
    of 8 up to 128. ``out`` may be an [E, 9*(2r+1)^2] f32 view whose rows
    are contiguous (a column block of a wider buffer); it is allocated when
    not given.
    """
    if fmap.device.type == "cpu":
        res = corr_level_plain(fmap, pf, ring, center, radius)
        if out is None:
            return res
        out.copy_(res)
        return out
    if fmap.device.type != "cuda":
        raise ValueError(f"corr_level: unsupported device {fmap.device}")
    E, R, C = _check_inputs("corr_level", (fmap,), pf, ring, center, radius)
    _, H, W, _ = fmap.shape
    out = _out(out, E, 9 * (2 * radius + 1) ** 2, fmap.device, "corr_level")
    if E:
        _launched(corr_level, _lib().corr_level(
            fmap.data_ptr(), pf.data_ptr(), ring.data_ptr(),
            center.data_ptr(), out.data_ptr(), E, R, H, W, C, radius,
            out.stride(0), torch.cuda.current_stream(fmap.device).cuda_stream,
        ))
    return out


def corr_two_level(pf, fmap1, fmap2, ring, center, radius: int = 3):
    """Both pyramid levels of the Pallas-rule correlation in one launch.

    Args:
      pf: [E, 9, C] bf16 patch features.
      fmap1/fmap2: [R, H, W, C] / [R, H2, W2, C] bf16 feature rings
        (level 1 at half resolution).
      ring: [E] int32 target ring slot.
      center: [E, 2] f32 centres in level-0 pixels (level 1 uses half).

    Returns: [E, 2 * 9 * (2r+1)^2] f32 in (level, p, dy, dx) order. CPU
    tensors take the plain version (per level :func:`corr_level_plain`).
    On the card the launch first sorts the edges by target slot and walks
    them in that order, so one frame's windows are read while they sit in
    L2; each edge's row lands at its own index, so the result does not
    depend on the order.
    """
    n = 9 * (2 * radius + 1) ** 2
    if pf.device.type == "cpu":
        return torch.cat([
            corr_level_plain(fmap1, pf, ring, center, radius),
            corr_level_plain(fmap2, pf, ring, center * 0.5, radius),
        ], dim=1)
    if pf.device.type != "cuda":
        raise ValueError(f"corr_two_level: unsupported device {pf.device}")
    E, R, C = _check_inputs("corr_two_level", (fmap1, fmap2), pf, ring,
                            center, radius)
    dev = pf.device
    out = _out(None, E, 2 * n, dev, "corr_two_level")
    if E:
        scratch = torch.empty(SORT_BLOCKS * (R + 1) + E, dtype=torch.int32,
                              device=dev)
        _, H0, W0, _ = fmap1.shape
        _, H1, W1, _ = fmap2.shape
        _launched(corr_two_level, _lib().corr_two_level(
            fmap1.data_ptr(), fmap2.data_ptr(), pf.data_ptr(),
            ring.data_ptr(), center.data_ptr(), scratch.data_ptr(),
            out.data_ptr(), E, R, H0, W0, H1, W1, C, radius, out.stride(0),
            torch.cuda.current_stream(dev).cuda_stream,
        ))
    return out


corr_level.launches = 0
corr_two_level.launches = 0


def patch_correlation_kernel(patch_feats, fmap1, fmap2, ring, center,
                             radius: int = 3):
    """Two-level Pallas-rule correlation, one launch per update
    (:func:`corr_two_level`).

    Args:
      patch_feats: [E, 3, 3, C] bf16 per-edge patch features.
      fmap1/fmap2: [R, H, W, C] / [R, H/2, W/2, C] bf16 feature rings.
      ring: [E] int32 target ring slot.
      center: [E, 2] f32 reprojected centres in level-0 pixels.

    Returns: [E, 2 * 9 * (2r+1)^2] f32 in (level, p, dy, dx) order, the
    layout of ``patch_correlation_pallas``.
    """
    E, _, _, C = patch_feats.shape
    pf = patch_feats.reshape(E, 9, C)
    center = center.float().contiguous()
    return corr_two_level(pf, fmap1, fmap2, ring, center, radius)
