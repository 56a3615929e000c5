"""Brick-row gather / interpolate / scatter through ``csrc/gather.cu``.

Counterparts of the four TPU kernels of ``nerf_vo_tpu/ops/gather_pallas.py``,
the table operations of the hash grid (``ops/hash_grid.py``). A table is
brick-major f32 ``[n_bricks, 32F]``: one brick (27 corner entries padded to
32, entry-major, feature-minor) per contiguous row; ``gather_interp`` also
takes a bf16 table (the dense proposal grids' ``proposal_table_dtype:
bfloat16``), through its own kernel, :func:`gather_interp_bf16`.

=====================  ===================================================
wrapper                function
=====================  ===================================================
:func:`gather_cols`    ``out[t, :] = bf16(tab[idx[t], :])``, [M, 32F] bf16
:func:`gather_interp`  ``out[t, f] = sum_e w[t, e] bf16(tab[idx[t], eF+f])``
:func:`gather_interp_bf16`  the same function on a bf16 table
:func:`gather_interp_mm`  the same function, for small dense tables
:func:`scatter_cols_accum`  ``out[b, :] = sum_{t: idx[t] = b} g[t, :]``, f32
=====================  ===================================================

Each wrapper takes its plain PyTorch version (``*_plain``) for a CPU tensor
and launches its kernel for a CUDA tensor, or raises; it counts its kernel
launches in ``<wrapper>.launches``. ``bf16`` rounds to nearest even (the
JAX package's bf16 shadow of the table); weights, sums and outputs are f32.
``gather_interp_mm`` and ``scatter_cols_accum`` take ``hot_rows``, the
number of leading table rows the kernel keeps on chip (staged, or
accumulated, in shared memory); the hash grid passes the rows of its
one-hot levels. It changes where rows are read or added, never the result.
What bounds each kernel, and its design, are noted at the top of
``csrc/gather.cu``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from nerf_vo_tpu_torch.ops import cuda_build

FEATURES = (1, 2, 4, 8)  # the F the kernels are built for


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def gather_cols_plain(tab, idx):
    return tab[idx.long()].to(torch.bfloat16)


def gather_interp_plain(tab, idx, w, features: int):
    g = tab[idx.long()].to(torch.bfloat16).float()
    return torch.sum(g.reshape(-1, 32, features) * w[:, :, None], dim=1)


def _one_hot_mats(features: int, device):
    """E [32, 32F] = [r // F == e] and S [32F, F] = [r % F == f]."""
    r = torch.arange(32 * features, device=device)
    E = (r[None, :] // features
         == torch.arange(32, device=device)[:, None]).float()
    S = (r[:, None] % features
         == torch.arange(features, device=device)[None, :]).float()
    return E, S


def gather_interp_mm_plain(tab, idx, w, features: int):
    E, S = _one_hot_mats(features, tab.device)
    g = tab[idx.long()].to(torch.bfloat16).float()
    return ((w @ E) * g) @ S


def scatter_cols_accum_plain(g, idx, n_bricks: int):
    out = torch.zeros(n_bricks, g.shape[1], dtype=torch.float32,
                      device=g.device)
    return out.index_add_(0, idx.long(), g.float())


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _lib():
    lib = cuda_build.load("gather")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.gather_cols.argtypes = [p, p, p, i, i, i, p]
    lib.gather_interp.argtypes = [p, p, p, p, i, i, i, p]
    lib.gather_interp_bf16.argtypes = [p, p, p, p, i, i, i, p]
    lib.gather_interp_mm.argtypes = [p, p, p, p, i, i, i, i, p]
    lib.scatter_cols_accum.argtypes = [p, p, p, i, i, i, i, p]
    for fn in (lib.gather_cols, lib.gather_interp, lib.gather_interp_bf16,
               lib.gather_interp_mm, lib.scatter_cols_accum):
        fn.restype = ctypes.c_int
    return lib


def _check(name, t, dtype, ndim, device, align=4):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{ndim} dims")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")
    if t.data_ptr() % align:
        raise ValueError(f"{name} is not {align}-byte aligned")


def _cuda_device(t, fn):
    if t.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {t.device}")
    return t.device


def _launched(fn, rc):
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} kernel launch failed: "
                           f"cudaError {rc}")
    fn.launches += 1


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def gather_cols(tab, idx):
    """Brick rows ``tab[idx]`` rounded to bf16: tab [n_bricks, R] f32,
    idx [M] int32 -> [M, R] bf16 (R a multiple of 4)."""
    if tab.device.type == "cpu":
        return gather_cols_plain(tab, idx)
    dev = _cuda_device(tab, "gather_cols")
    _check("tab", tab, torch.float32, 2, dev, align=16)
    _check("idx", idx, torch.int32, 1, dev)
    n_bricks, R = tab.shape
    if R % 4:
        raise ValueError(f"gather_cols: row width {R} is not a multiple of 4")
    M = idx.shape[0]
    out = torch.empty(M, R, dtype=torch.bfloat16, device=dev)
    if M:
        _launched(gather_cols, _lib().gather_cols(
            tab.data_ptr(), idx.data_ptr(), out.data_ptr(), M, R, n_bricks,
            _stream(dev)))
    return out


def _interp(fn, name, tab, idx, w, features, *extra,
            tab_dtype=torch.float32):
    dev = _cuda_device(tab, name)
    _check("tab", tab, tab_dtype, 2, dev, align=16)
    _check("idx", idx, torch.int32, 1, dev)
    _check("w", w, torch.float32, 2, dev, align=16)
    n_bricks, R = tab.shape
    if features not in FEATURES or R != 32 * features:
        raise ValueError(f"{name}: rows of {R} floats with F={features}; "
                         f"the kernel takes R = 32F, F in {FEATURES}")
    M = idx.shape[0]
    if tuple(w.shape) != (M, 32):
        raise ValueError(f"{name}: w has shape {tuple(w.shape)}, expected "
                         f"{(M, 32)}")
    out = torch.empty(M, features, dtype=torch.float32, device=dev)
    if M:
        _launched(fn, getattr(_lib(), name)(
            tab.data_ptr(), idx.data_ptr(), w.data_ptr(), out.data_ptr(), M,
            features, n_bricks, *extra, _stream(dev)))
    return out


def gather_interp(tab, idx, w, features: int):
    """Fused gather + trilinear reduce: tab [n_bricks, 32F] f32, idx [M]
    int32, w [M, 32] f32 -> [M, F] f32.

    On the card a table entry is read only where its weight is non-zero
    (the 8 corners of a point's cell for the hash grid's descriptors; at
    F = 1 four entries are one load, read where any of their weights is
    non-zero). A skipped entry would add ``0 * bf16(value)``, which is 0
    for a finite value, so the result is the plain version's for any finite
    table; an Inf or NaN entry under a zero weight gives NaN in the plain
    version and is skipped here. A bf16 table goes to
    :func:`gather_interp_bf16`."""
    if tab.device.type == "cpu":
        return gather_interp_plain(tab, idx, w, features)
    if tab.dtype == torch.bfloat16:
        return gather_interp_bf16(tab, idx, w, features)
    return _interp(gather_interp, "gather_interp", tab, idx, w, features)


def gather_interp_bf16(tab, idx, w, features: int):
    """:func:`gather_interp` on a bf16 table [n_bricks, 32F]: the kernel
    reads the stored bf16 entries (half the f32 table's bytes), with the
    same live entries (at F = 1, groups of 4 entries read where any weight
    is non-zero) and the same f32 sums in the same order, so its result is
    bitwise ``gather_interp(tab.float(), idx, w, features)``, the skipped
    zero-weight entries included."""
    if tab.device.type == "cpu":
        return gather_interp_plain(tab, idx, w, features)
    return _interp(gather_interp_bf16, "gather_interp_bf16", tab, idx, w,
                   features, tab_dtype=torch.bfloat16)


def gather_interp_mm(tab, idx, w, features: int, hot_rows: int = 0):
    """:func:`gather_interp`'s function for the dense small-table levels.

    On the card the table's first ``hot_rows`` rows (at most what 227 KB of
    shared memory holds as 27 bf16 entries a brick: 538 rows at F = 8,
    4304 at F = 1) are staged once per block, and a descriptor whose id lies
    there reads them on chip; any other id reads its row from global memory.
    Padding entries 27..31 are read (from global memory) only where their
    weight is non-zero, so the result is the plain version's for any
    finite table."""
    if tab.device.type == "cpu":
        return gather_interp_mm_plain(tab, idx, w, features)
    return _interp(gather_interp_mm, "gather_interp_mm", tab, idx, w,
                   features, int(hot_rows))


def scatter_cols_accum(g, idx, n_bricks: int, hot_rows: int = 0):
    """Accumulate rows: g [M, 32F] f32, idx [M] int32 -> [n_bricks, 32F]
    f32 with ``out[b] = sum of g[t] over idx[t] == b`` (F in 1, 2, 4, 8).

    On the card the first ``hot_rows`` rows (at most 768) accumulate in
    shared memory and are added to the table once per block; every other
    row is added with 16-byte float4 atomics. Sums are f32 in an order that
    changes from run to run."""
    if g.device.type == "cpu":
        return scatter_cols_accum_plain(g, idx, n_bricks)
    dev = _cuda_device(g, "scatter_cols_accum")
    _check("g", g, torch.float32, 2, dev, align=16)
    _check("idx", idx, torch.int32, 1, dev)
    M, R = g.shape
    if idx.shape[0] != M:
        raise ValueError(f"scatter_cols_accum: {idx.shape[0]} ids for {M} "
                         "rows")
    if R % 32 or R // 32 not in FEATURES:
        raise ValueError(f"scatter_cols_accum: rows of {R} floats; the "
                         f"kernel takes R = 32F, F in {FEATURES}")
    out = torch.zeros(n_bricks, R, dtype=torch.float32, device=dev)
    if M:
        _launched(scatter_cols_accum, _lib().scatter_cols_accum(
            g.data_ptr(), idx.data_ptr(), out.data_ptr(), M, R // 32,
            n_bricks, int(hot_rows), _stream(dev)))
    return out


KERNELS = (gather_cols, gather_interp, gather_interp_bf16, gather_interp_mm,
           scatter_cols_accum)
for _fn in KERNELS:
    _fn.launches = 0
