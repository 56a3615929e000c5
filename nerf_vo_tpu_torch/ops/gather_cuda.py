"""Brick-row gather / interpolate / scatter through ``csrc/gather.cu``.

Counterparts of the four TPU kernels of ``nerf_vo_tpu/ops/gather_pallas.py``,
the table operations of the hash grid (``ops/hash_grid.py``), and the two
adjoints of ``gather_interp`` that the hash grid's backward takes: the
kernels of rows 2 and 5 with the product that feeds them, or the
contraction that consumes them, done in registers. A table is
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
:func:`scatter_cols_outer`  ``out[b, eF+f] = sum_{t: idx[t] = b} W[t, e]
                       cot[t, f]``, f32
:func:`gather_cols_dfrac`  ``res * d<gather_interp(tab, idx, W, F)[t],
                       cot[t]> / dfrac[t]``, [M, 3] f32, W the trilinear
                       weights of (local, frac)
:func:`sort_ids`       the ids sorted stably, and their positions (int32)
:func:`hash_descriptors`  the inputs of the others: a grid's brick ids,
                       base corners, offsets and trilinear weights of
                       points x, every level in one launch
=====================  ===================================================

Each wrapper takes its plain PyTorch version (``*_plain``) for a CPU tensor
and launches its kernel for a CUDA tensor, or raises; it counts its kernel
launches in ``<wrapper>.launches``. The four that the hash grid calls
(``gather_interp``, ``gather_interp_mm``, ``scatter_cols_outer``,
``gather_cols_dfrac``; and ``gather_interp_bf16``) take ``out=``, a
contiguous f32 tensor of the result's shape on the inputs' device that
receives the result in place of a new one (a replayed mapping step passes
the buffers its CUDA graphs read). ``bf16`` rounds to nearest even (the
JAX package's bf16 shadow of the table); weights, sums and outputs are f32.
Both scatters launch :func:`sort_ids` and then one kernel that sums each
id's rows in sorted order with no atomics, so each gives the same bits on
every call. ``gather_interp_mm`` takes ``hot_rows``, the number of leading
table rows the kernel stages in shared memory; the hash grid passes the
rows of its one-hot levels. It changes where rows are read, never the
result.
What bounds each kernel, and its design, are noted at the top of
``csrc/gather.cu``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from nerf_vo_tpu_torch.ops import cuda_build

FEATURES = (1, 2, 4, 8)  # the F the kernels are built for
MAX_LEVELS = 32  # the grid levels a launch takes (gather_cols_dfrac's too)
PRIMES = (1, 2654435761, 805459861)  # Instant-NGP spatial hash primes


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


def gather_cols_dot_plain(tab, idx, cot):
    """dW [M, 32] f32, ``dW[t, e] = sum_f bf16(tab[idx[t], eF+f])
    cot[t, f]``: the W adjoint of :func:`gather_interp_plain`, the dW that
    :func:`gather_cols_dfrac_plain` contracts through the weights'
    derivatives."""
    M, F = cot.shape
    g = gather_cols_plain(tab, idx).float().reshape(M, 32, F)
    return torch.sum(g * cot[:, None, :], dim=-1)


def scatter_cols_outer_plain(W, cot, idx, n_bricks: int):
    M, F = cot.shape
    rows = (W[:, :, None] * cot[:, None, :]).reshape(M, 32 * F)
    return scatter_cols_accum_plain(rows, idx, n_bricks)


def axis_weights(lo, f):
    """[M, 3] trilinear weights of the 3 lattice points of a brick on one
    axis: (i == lo) (1 - f) + (i == lo + 1) f."""
    i3 = torch.arange(3, device=lo.device)
    lo = lo[:, None]
    f = f[:, None]
    return (i3 == lo) * (1.0 - f) + (i3 == lo + 1) * f


def axis_dweights(lo):
    """[M, 3] d(axis weights)/df: -(i == lo) + (i == lo + 1)."""
    i3 = torch.arange(3, device=lo.device)
    lo = lo[:, None]
    return (i3 == lo + 1).float() - (i3 == lo).float()


def dfrac(dW, local, frac):
    """[M, 3] d<features, cot>/dfrac from dW [M, 32] = d<features,
    cot>/dW through the separable trilinear weights of (local [M, 3], frac
    [M, 3]): sum_ijk dW[ijk] w0'[i] w1[j] w2[k] and its two siblings, as
    broadcast products summed one axis at a time (an ``einsum`` over M runs
    as a batched matrix-vector product)."""
    M = dW.shape[0]
    dW = dW[:, :27].reshape(M, 3, 3, 3)
    w = [axis_weights(local[:, a], frac[:, a]) for a in range(3)]
    dw = [axis_dweights(local[:, a]) for a in range(3)]
    ij = torch.sum(dW * w[2][:, None, None, :], dim=3)  # [M, i, j]
    k = torch.sum(dW * (w[0][:, :, None, None] * w[1][:, None, :, None]),
                  dim=(1, 2))  # [M, k]
    return torch.stack([
        torch.sum(torch.sum(ij * w[1][:, None, :], dim=2) * dw[0], dim=1),
        torch.sum(torch.sum(ij * w[0][:, :, None], dim=1) * dw[1], dim=1),
        torch.sum(k * dw[2], dim=1),
    ], dim=-1)


def id_levels(idx, level_first):
    """The level of each id: the last level whose first id (ascending) is
    at most it (level 0 below the first)."""
    first = torch.tensor(level_first, dtype=torch.int64, device=idx.device)
    return (torch.searchsorted(first, idx.long(), right=True) - 1).clamp_min(0)


def gather_cols_dfrac_plain(tab, idx, cot, local, frac, level_first, res):
    scale = torch.tensor(res, dtype=torch.float32, device=idx.device)
    return (dfrac(gather_cols_dot_plain(tab, idx, cot), local, frac)
            * scale[id_levels(idx, level_first)][:, None])


def sort_ids_plain(idx, n_bricks: int):
    key = torch.where((idx >= 0) & (idx < n_bricks), idx, n_bricks)
    keys, perm = torch.sort(key, stable=True)
    return keys, perm.to(torch.int32)


def brick_lattice(res: int, n_bricks: int):
    """(bricks per axis, dense) of a level at resolution ``res`` with
    ``n_bricks`` table rows: dense when its whole brick lattice fits the
    rows, hashed otherwise."""
    bpa = ((res - 1) >> 1) + 1
    return bpa, bpa**3 <= n_bricks


def brick_ids(c_brick, res: int, n_bricks: int, level: int):
    """Brick index per sample for one level: dense when the brick lattice
    fits the table, the spatial hash otherwise. c_brick: [3, N] integer.

    The hash wraps at 32 bits like the JAX package's uint32 arithmetic: it
    is computed in int64 and masked to the low 32 bits, so the ids agree bit
    for bit. Returns int64 [N] global row ids (level offset included).
    """
    c = c_brick.long()
    bpa, dense = brick_lattice(res, n_bricks)
    if dense:
        bid = (c[0] * bpa + c[1]) * bpa + c[2]
    else:
        mask = 0xFFFFFFFF
        h = ((c[0] * PRIMES[0]) & mask) ^ ((c[1] * PRIMES[1]) & mask) \
            ^ ((c[2] * PRIMES[2]) & mask)
        bid = h % n_bricks
    return bid + level * n_bricks


def trilinear(w0, w1, w2):
    """[M, 3] x 3 -> [M, 27]: W[(i*3+j)*3+k] = w0[i] w1[j] w2[k]."""
    M = w0.shape[0]
    return (w0[:, :, None, None] * w1[:, None, :, None]
            * w2[:, None, None, :]).reshape(M, 27)


def hash_descriptors_plain(x, resolutions, n_bricks: int):
    inside = (x >= 0.0) & (x <= 1.0)
    xt = x.clamp(0.0, 1.0)
    ids, fr, loc = [], [], []
    for l, res in enumerate(resolutions):
        xs = xt * float(res)
        fl = torch.floor(xs)
        c = fl.long().clamp(0, res - 1)
        fr.append(xs - fl)
        loc.append(c & 1)
        ids.append(brick_ids((c >> 1).T, res, n_bricks, l))
    idx = torch.cat(ids).to(torch.int32)
    frac = torch.cat(fr)
    local = torch.cat(loc)
    W = trilinear(*(axis_weights(local[:, a], frac[:, a]) for a in range(3)))
    W = torch.cat([W, W.new_zeros(W.shape[0], 32 - 27)], 1)
    return idx, local, frac, W, inside


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
    lib.scatter_cols_accum.argtypes = [p, p, p, p, p, p, i, i, i, p]
    lib.scatter_cols_outer.argtypes = [p, p, p, p, p, p, p, i, i, i, p]
    lib.scatter_slots.argtypes = [i, i, i]
    lib.scatter_slots.restype = ctypes.c_longlong
    lib.gather_cols_dfrac.argtypes = [p, p, p, p, p, p, i, i, i, i, p, p, p]
    lib.sort_ids.argtypes = [p, p, p, p, i, i, p]
    lib.hash_descriptors.argtypes = [p, p, p, p, p, p, i, i, p, p, p, i, p]
    lib.sort_ids_scratch.argtypes = [i]
    lib.sort_ids_scratch.restype = ctypes.c_longlong
    for fn in (lib.gather_cols, lib.gather_interp, lib.gather_interp_bf16,
               lib.gather_interp_mm, lib.scatter_cols_accum,
               lib.scatter_cols_outer,
               lib.gather_cols_dfrac, lib.sort_ids, lib.hash_descriptors):
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


def _result(name, out, shape, dev):
    """The result tensor of a call: ``out`` checked as a [shape] f32 tensor
    on ``dev`` (contiguous, 16-byte aligned), or a new one."""
    if out is None:
        return torch.empty(shape, dtype=torch.float32, device=dev)
    _check("out", out, torch.float32, len(shape), dev, align=16)
    if tuple(out.shape) != tuple(shape):
        raise ValueError(f"{name}: out has shape {tuple(out.shape)}, "
                         f"expected {tuple(shape)}")
    return out


def _plain(name, out, result):
    """A plain version's ``result``, written into ``out`` where given."""
    if out is None:
        return result
    return _result(name, out, result.shape, result.device).copy_(result)


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
            tab_dtype=torch.float32, out=None):
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
    out = _result(name, out, (M, features), dev)
    if M:
        _launched(fn, getattr(_lib(), name)(
            tab.data_ptr(), idx.data_ptr(), w.data_ptr(), out.data_ptr(), M,
            features, n_bricks, *extra, _stream(dev)))
    return out


def gather_interp(tab, idx, w, features: int, out=None):
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
        return _plain("gather_interp", out,
                      gather_interp_plain(tab, idx, w, features))
    if tab.dtype == torch.bfloat16:
        return gather_interp_bf16(tab, idx, w, features, out=out)
    return _interp(gather_interp, "gather_interp", tab, idx, w, features,
                   out=out)


def gather_interp_bf16(tab, idx, w, features: int, out=None):
    """:func:`gather_interp` on a bf16 table [n_bricks, 32F]: the kernel
    reads the stored bf16 entries (half the f32 table's bytes), with the
    same live entries (at F = 1, groups of 4 entries read where any weight
    is non-zero) and the same f32 sums in the same order, so its result is
    bitwise ``gather_interp(tab.float(), idx, w, features)``, the skipped
    zero-weight entries included."""
    if tab.device.type == "cpu":
        return _plain("gather_interp_bf16", out,
                      gather_interp_plain(tab, idx, w, features))
    return _interp(gather_interp_bf16, "gather_interp_bf16", tab, idx, w,
                   features, tab_dtype=torch.bfloat16, out=out)


def gather_interp_mm(tab, idx, w, features: int, hot_rows: int = 0,
                     out=None):
    """:func:`gather_interp`'s function for the dense small-table levels.

    On the card the table's first ``hot_rows`` rows (at most what 227 KB of
    shared memory holds as 27 bf16 entries a brick: 538 rows at F = 8,
    4304 at F = 1) are staged once per block, and a descriptor whose id lies
    there reads them on chip; any other id reads its row from global memory.
    Padding entries 27..31 are read (from global memory) only where their
    weight is non-zero, so the result is the plain version's for any
    finite table."""
    if tab.device.type == "cpu":
        return _plain("gather_interp_mm", out,
                      gather_interp_mm_plain(tab, idx, w, features))
    return _interp(gather_interp_mm, "gather_interp_mm", tab, idx, w,
                   features, int(hot_rows), out=out)


def scatter_cols_accum(g, idx, n_bricks: int):
    """Accumulate rows: g [M, 32F] f32, idx [M] int32 -> [n_bricks, 32F]
    f32 with ``out[b] = sum of g[t] over idx[t] == b`` (F in 1, 2, 4, 8).

    On the card the ids are sorted first (:func:`sort_ids`), and each id's
    rows are summed in registers in sorted order with no atomics (the
    design noted at the top of ``csrc/gather.cu``): the result is the same
    on every call. An id out of range is dropped."""
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
    return _scatter_sorted(scatter_cols_accum, "scatter_cols_accum", idx,
                           n_bricks, out, g)


def _features(name, cot, M, dev):
    """F of a [M, F] f32 cotangent, checked (aligned to 4F bytes, 16 at
    F = 8: the scatter's row source loads cot[t] as F / 4 16-byte pieces or
    one 4F-byte piece)."""
    if cot.dim() != 2 or cot.shape[1] not in FEATURES:
        raise ValueError(f"{name}: cot has shape {tuple(cot.shape)}, "
                         f"expected [M, F] with F in {FEATURES}")
    F = cot.shape[1]
    _check("cot", cot, torch.float32, 2, dev, align=min(4 * F, 16))
    if cot.shape[0] != M:
        raise ValueError(f"{name}: {cot.shape[0]} cotangent rows for {M} "
                         "descriptors")
    return F


def sort_ids(idx, n_bricks: int):
    """Sort brick ids stably: idx [M] int32 -> (keys [M] int32, perm [M]
    int32), ``keys[i] = key(idx[perm[i]])`` ascending, equal keys in the
    order of their positions; ``key(b) = b`` for b in [0, n_bricks), else
    n_bricks (an id out of range sorts last). The order
    ``torch.sort(key, stable=True)`` gives.

    On the card it is an LSD radix sort with 8-bit digits, as many passes
    as the bits of n_bricks need (two for a table under 65,536 rows), in
    one cooperative launch of one block an SM; it sorts integers, so every
    call gives the same order."""
    if idx.device.type == "cpu":
        return sort_ids_plain(idx, n_bricks)
    dev = _cuda_device(idx, "sort_ids")
    _check("idx", idx, torch.int32, 1, dev)
    if not 0 <= n_bricks < 2**31 - 1:
        raise ValueError(f"sort_ids: {n_bricks} bricks")
    M = idx.shape[0]
    keys = torch.empty(M, dtype=torch.int32, device=dev)
    perm = torch.empty(M, dtype=torch.int32, device=dev)
    if M:
        size = int(_lib().sort_ids_scratch(M))
        if size <= 0:
            raise RuntimeError("sort_ids: the kernel's grid could not be "
                               "sized")
        scratch = torch.empty(size, dtype=torch.int32, device=dev)
        _launched(sort_ids, _lib().sort_ids(
            idx.data_ptr(), keys.data_ptr(), perm.data_ptr(),
            scratch.data_ptr(), M, n_bricks, _stream(dev)))
    return keys, perm


def scatter_cols_outer(W, cot, idx, n_bricks: int, out=None):
    """The table adjoint of :func:`gather_interp`: W [M, 32] f32, cot [M, F]
    f32, idx [M] int32 -> [n_bricks, 32F] f32 with ``out[b, eF+f] = sum of
    W[t, e] cot[t, f] over idx[t] == b`` (F in 1, 2, 4, 8).

    On the card it is :func:`scatter_cols_accum` with its producer fused:
    each product ``W[t, e] * cot[t, f]`` is one f32 multiply in registers,
    the value the materialized row ``W (x) cot`` held, so no [M, 32F] row
    is written or read. The ids are sorted first (:func:`sort_ids`), and
    each id's terms are summed in registers in sorted order with no
    atomics (the design noted at the top of ``csrc/gather.cu``): the
    result is the same on every call. An id out of range is dropped.
    ``out`` is zeroed first, as a new result is."""
    if W.device.type == "cpu":
        return _plain("scatter_cols_outer", out,
                      scatter_cols_outer_plain(W, cot, idx, n_bricks))
    dev = _cuda_device(W, "scatter_cols_outer")
    _check("W", W, torch.float32, 2, dev, align=16)
    _check("idx", idx, torch.int32, 1, dev)
    M = idx.shape[0]
    if tuple(W.shape) != (M, 32):
        raise ValueError(f"scatter_cols_outer: W has shape "
                         f"{tuple(W.shape)}, expected {(M, 32)}")
    F = _features("scatter_cols_outer", cot, M, dev)
    out = _result("scatter_cols_outer", out, (n_bricks, 32 * F),
                  dev).zero_()
    return _scatter_sorted(scatter_cols_outer, "scatter_cols_outer", idx,
                           n_bricks, out, W, cot)


def _scatter_sorted(fn, name, idx, n_bricks, out, *src):
    """The scatter ``name`` into the zeroed ``out`` [n_bricks, 32F], its
    launch counted on ``fn``: :func:`sort_ids` on ``idx``, then one
    cooperative launch of the kernel with its row source ``src`` (``g``, or
    ``W`` and ``cot``), the sorted keys and positions, and scratch sized for
    that source."""
    M = idx.shape[0]
    if not M:
        return out
    F = out.shape[1] // 32
    keys, perm = sort_ids(idx, n_bricks)
    outer = int(name == "scatter_cols_outer")
    slots = int(_lib().scatter_slots(M, F, outer))
    if slots <= 0:
        raise RuntimeError(f"{name}: the kernel's grid could not be sized")
    part = torch.empty(slots, 32 * F, dtype=torch.float32, device=out.device)
    part_id = torch.empty(slots, dtype=torch.int32, device=out.device)
    _launched(fn, getattr(_lib(), name)(
        *(t.data_ptr() for t in src), keys.data_ptr(), perm.data_ptr(),
        out.data_ptr(), part.data_ptr(), part_id.data_ptr(), M, F, n_bricks,
        _stream(out.device)))
    return out


def gather_cols_dfrac(tab, idx, cot, local, frac, level_first, res,
                      out=None):
    """The position pullback of :func:`gather_interp` on trilinear weights:
    tab [n_bricks, 32F] f32, idx [M] int32, cot [M, F] f32, local [M, 3]
    int64 (a point's base corner in its brick, 0 or 1 an axis), frac [M, 3]
    f32 (its offsets in its cell) -> [M, 3] f32, ``res[l] *
    d<gather_interp(tab, idx, W, F)[t], cot[t]> / dfrac[t]`` with W the
    trilinear weights of (local, frac) and l the level of idx[t]: the last
    of the levels whose first ids ``level_first`` (ascending, at most 32)
    is at most idx[t]. Its plain version is :func:`dfrac` of
    :func:`gather_cols_dot_plain`'s ``dW``, times ``res``.

    On the card one thread serves a descriptor: it reads the F features of
    the 8 corners of its cell (the only entries with a non-zero weight or
    weight derivative; one 32-byte sector each at F = 8), rounds them to
    bf16 and contracts them with ``cot`` and the separable weights in
    registers, in a fixed order: no ``dW`` is written, and a descriptor gets
    the same bits wherever it lies in the call. An id out of range gives
    zeros (for a finite ``cot``)."""
    if tab.device.type == "cpu":
        return _plain("gather_cols_dfrac", out, gather_cols_dfrac_plain(
            tab, idx, cot, local, frac, level_first, res))
    dev = _cuda_device(tab, "gather_cols_dfrac")
    _check("tab", tab, torch.float32, 2, dev, align=16)
    _check("idx", idx, torch.int32, 1, dev)
    M = idx.shape[0]
    F = _features("gather_cols_dfrac", cot, M, dev)
    n_bricks, R = tab.shape
    if R != 32 * F:
        raise ValueError(f"gather_cols_dfrac: rows of {R} floats with "
                         f"F={F}; the kernel takes R = 32F")
    _check("local", local, torch.int64, 2, dev, align=8)
    _check("frac", frac, torch.float32, 2, dev)
    if tuple(local.shape) != (M, 3) or tuple(frac.shape) != (M, 3):
        raise ValueError(f"gather_cols_dfrac: local {tuple(local.shape)} and "
                         f"frac {tuple(frac.shape)}, expected {(M, 3)}")
    L = len(level_first)
    if not 1 <= L <= MAX_LEVELS or len(res) != L or any(
            a > b for a, b in zip(level_first, level_first[1:])):
        raise ValueError(f"gather_cols_dfrac: levels {list(level_first)} "
                         f"with resolutions {list(res)}")
    out = _result("gather_cols_dfrac", out, (M, 3), dev)
    if M:
        first = (ctypes.c_int * L)(*[int(v) for v in level_first])
        scale = (ctypes.c_float * L)(*[float(v) for v in res])
        _launched(gather_cols_dfrac, _lib().gather_cols_dfrac(
            tab.data_ptr(), idx.data_ptr(), cot.data_ptr(), local.data_ptr(),
            frac.data_ptr(), out.data_ptr(), M, F, n_bricks, L, first, scale,
            _stream(dev)))
    return out


def hash_descriptors(x, resolutions, n_bricks: int):
    """The descriptors of points on every level of a brick grid: x [N, 3]
    f32 (contiguous), ``resolutions`` each level's (at most 32), n_bricks
    table rows a level (level l's rows from ``l * n_bricks``) ->

    - idx [L*N] int32: each (level, point)'s brick row, level-major;
    - local [L*N, 3] int64: its cell's base corner in the brick (0 or 1);
    - frac [L*N, 3] f32: its offsets in the cell;
    - W [L*N, 32] f32: the trilinear weights of its brick's 27 corners
      (entries 27..31 zero);
    - inside [N, 3] bool: x in [0, 1], where the clamp passes a gradient.

    Points are clamped to [0, 1]; level l's cell is ``floor(x res)``
    clamped to ``[0, res - 1]`` (x = 1 takes the last cell at offset 0), its
    brick the cell halved, dense or hashed by :func:`brick_ids`. The plain
    version is the chain of elementwise operations per level and
    concatenations the hash grid ran (about 20 launches a level on the
    card).

    On the card one kernel writes all five, bitwise the plain version's
    on the same card (each multiply, subtraction and sum rounded on its
    own, as the chain's elementwise kernels round them; the hash in 32-bit
    arithmetic). It reads nothing from the host, so a CUDA graph captures
    it with the work around it."""
    if not torch.is_tensor(x) or x.dtype != torch.float32:
        raise TypeError(f"hash_descriptors: x must be a float32 tensor, "
                        f"not {getattr(x, 'dtype', type(x))}")
    if x.dim() != 2 or x.shape[1] != 3:
        raise ValueError(f"hash_descriptors: x has shape {tuple(x.shape)}, "
                         "expected [N, 3]")
    res = [int(r) for r in resolutions]
    L = len(res)
    if not 1 <= L <= MAX_LEVELS or not all(1 <= r <= 1 << 24 for r in res):
        raise ValueError(f"hash_descriptors: {L} levels at resolutions "
                         f"{res}; the kernel takes 1 to {MAX_LEVELS} levels "
                         "at 1 to 2^24")
    if n_bricks < 1 or L * n_bricks >= 2**31:
        raise ValueError(f"hash_descriptors: {L} levels of {n_bricks} "
                         "bricks; the ids are int32")
    if x.device.type == "cpu":
        return hash_descriptors_plain(x, res, n_bricks)
    dev = _cuda_device(x, "hash_descriptors")
    _check("x", x, torch.float32, 2, dev)
    N = x.shape[0]
    if N >= 2**31:
        raise ValueError(f"hash_descriptors: {N} points")
    M = L * N
    idx = torch.empty(M, dtype=torch.int32, device=dev)
    local = torch.empty(M, 3, dtype=torch.int64, device=dev)
    frac = torch.empty(M, 3, dtype=torch.float32, device=dev)
    W = torch.empty(M, 32, dtype=torch.float32, device=dev)
    inside = torch.empty(N, 3, dtype=torch.bool, device=dev)
    if N:
        bpa, dense = zip(*(brick_lattice(r, n_bricks) for r in res))
        ints = lambda v: (ctypes.c_int * L)(*[int(a) for a in v])
        _launched(hash_descriptors, _lib().hash_descriptors(
            x.data_ptr(), idx.data_ptr(), local.data_ptr(), frac.data_ptr(),
            W.data_ptr(), inside.data_ptr(), N, L, ints(res), ints(bpa),
            ints(dense), n_bricks, _stream(dev)))
    return idx, local, frac, W, inside


# the kernels a replayed mapping step launches as calls of their own (or
# no path does): a replayed step counts their launches as an eager one.
# hash_descriptors is captured inside the step's graphs, so its counter
# advances at eager steps and captures only.
KERNELS = (gather_cols, gather_interp, gather_interp_bf16, gather_interp_mm,
           scatter_cols_accum, scatter_cols_outer, gather_cols_dfrac,
           sort_ids)
for _fn in KERNELS + (hash_descriptors,):
    _fn.launches = 0
