"""The interlevel loss through ``csrc/rendering.cu``.

:func:`interlevel_loss` is ``ops/rendering.py``'s ``interlevel_loss`` on
CUDA tensors: one autograd Function over two kernels that form the
indicators ``[pe[b] < fe[k+1]]`` and ``[pe[b+1] <= fe[k]]`` in registers,
so nothing of size [R, B, K] reaches memory (the plain version's compares,
casts and GEMMs moved ~1.9 GB a step at vo.map's shapes). The forward
writes each ray's sum of loss terms and the clamped gaps ``max(fw - bound,
0)`` [R, K], the backward's only saved state; the loss is their sum over
``R K``, taken by ``torch.sum``. The backward returns the proposal weights'
gradient only: the edges and the final weights are stop-gradient. Every sum
is in a fixed order, so the same inputs give the same bits.

The kernels launch on the current stream, allocate through torch and read
nothing back to the host, so a CUDA graph captures them with the work
around them (the mapping step's graphs do). ``interlevel_loss.launches``
counts both kernels' launches, at eager calls and captures. What bounds
the kernels, and their design, are noted at the top of
``csrc/rendering.cu``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from nerf_vo_tpu_torch.ops import cuda_build

MAX_BINS = 1024  # the B and K a launch takes (csrc/rendering.cu kMaxBins)


@functools.lru_cache(maxsize=None)
def _lib():
    lib = cuda_build.load("rendering")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.interlevel_fwd.argtypes = [p, p, p, p, p, p, i, i, i, p]
    lib.interlevel_bwd.argtypes = [p, p, p, p, p, p, i, i, i, p]
    for fn in (lib.interlevel_fwd, lib.interlevel_bwd):
        fn.restype = ctypes.c_int
    return lib


def _launch(rc, name):
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")
    interlevel_loss.launches += 1


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _forward(pe, pw, fe, fw):
    """One forward launch on checked contiguous inputs: (part [R], the sum
    of each ray's loss terms; clipped [R, K], ``max(fw - bound, 0)``)."""
    R, B = pw.shape
    K = fw.shape[1]
    part = torch.empty(R, dtype=torch.float32, device=pw.device)
    clipped = torch.empty(R, K, dtype=torch.float32, device=pw.device)
    if R:
        _launch(_lib().interlevel_fwd(
            pe.data_ptr(), pw.data_ptr(), fe.data_ptr(), fw.data_ptr(),
            part.data_ptr(), clipped.data_ptr(), R, B, K,
            _stream(pw.device)), "interlevel_fwd")
    return part, clipped


def _backward(pe, fe, fw, clipped, gpart):
    """One backward launch: dpw [R, B] from the forward's ``clipped`` and
    the gradient ``gpart`` [R] of its ``part``."""
    R, K = clipped.shape
    B = pe.shape[1] - 1
    gpart = gpart.float().contiguous()
    dpw = torch.empty(R, B, dtype=torch.float32, device=pe.device)
    if R and B:
        _launch(_lib().interlevel_bwd(
            pe.data_ptr(), fe.data_ptr(), fw.data_ptr(), clipped.data_ptr(),
            gpart.data_ptr(), dpw.data_ptr(), R, B, K, _stream(pe.device)),
            "interlevel_bwd")
    return dpw


class _Interlevel(torch.autograd.Function):
    """(pe, pw, fe, fw) -> the per-ray sums of loss terms [R]; the gradient
    of ``pw`` only."""

    @staticmethod
    def forward(ctx, pe, pw, fe, fw):
        part, clipped = _forward(pe, pw, fe, fw)
        ctx.save_for_backward(pe, fe, fw, clipped)
        return part

    @staticmethod
    def backward(ctx, gpart):
        if not ctx.needs_input_grad[1]:
            return None, None, None, None
        return None, _backward(*ctx.saved_tensors, gpart), None, None


def interlevel_loss(proposal_edges, proposal_weights, final_edges,
                    final_weights):
    """The interlevel loss of CUDA tensors: proposal_edges [R, B+1],
    proposal_weights [R, B], final_edges [R, K+1], final_weights [R, K],
    all f32 on one card, B and K at most :data:`MAX_BINS` -> the scalar
    mean over [R, K] of ``max(fw - bound, 0)^2 / max(fw, 1e-7)``, ``bound``
    the proposal mass over each final bin as ``rendering._outer_bounds``
    counts it. Differentiable in the proposal weights only."""
    pw = proposal_weights
    if pw.device.type != "cuda":
        raise ValueError(f"interlevel_loss: unsupported device {pw.device}")
    named = (("proposal_edges", proposal_edges), ("proposal_weights", pw),
             ("final_edges", final_edges), ("final_weights", final_weights))
    for name, t in named:
        if t.device != pw.device:
            raise ValueError(f"interlevel_loss: {name} is on {t.device}, "
                             f"expected {pw.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"interlevel_loss: {name} has dtype {t.dtype}, "
                            "expected torch.float32")
        if t.dim() != 2:
            raise ValueError(f"interlevel_loss: {name} has shape "
                             f"{tuple(t.shape)}, expected 2 dims")
    R, B = pw.shape
    K = final_weights.shape[1]
    if (tuple(proposal_edges.shape) != (R, B + 1)
            or tuple(final_edges.shape) != (R, K + 1)
            or final_weights.shape[0] != R):
        raise ValueError(
            "interlevel_loss: shapes "
            f"{[tuple(t.shape) for _, t in named]} are not [R, B+1], "
            "[R, B], [R, K+1], [R, K]")
    if B > MAX_BINS or K > MAX_BINS:
        raise ValueError(f"interlevel_loss: {B} proposal and {K} final bins; "
                         f"the kernels take at most {MAX_BINS} of each")
    part = _Interlevel.apply(
        proposal_edges.detach().contiguous(), pw.contiguous(),
        final_edges.detach().contiguous(), final_weights.detach().contiguous())
    return torch.sum(part) / (R * K)


interlevel_loss.launches = 0
