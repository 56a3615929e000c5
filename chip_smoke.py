"""Drive the PyTorch port's nerf_vo and nerf_slam main paths on one NVIDIA
GPU and check them.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card, ``nvcc``
(``/usr/local/cuda``) and PyTorch built for CUDA. It builds every kernel of
the path from ``nerf_vo_tpu_torch/csrc/`` (into ``nerf_vo_tpu_torch/_build/``,
one ``nvcc`` per source, all started together), then runs seven phases;
any failure ends the run with a non-zero exit:

  (a) kernels: each kernel against its plain PyTorch version on the card at
      the replica configuration's shapes, with its time, the plain
      version's time, the least time the card could take and, where one
      PyTorch call computes the same function, that call's time;
  (b) tracking: ``TrackingStage`` at the full replica configuration
      (DPVO fdim 128 / cdim 384, 96 patches, 32768 edge slots, 32-frame
      ring) on synthetic 360x640 frames, random weights from a seed;
  (c) enhancement: ``EnhancementStage`` with the full 12-block Omnidata
      DPT-hybrid at 384 on the packets of (b);
  (d) mapping: ``MappingStage`` at the replica configuration (192
      keyframes of 360x640, 4096 rays per step, full field and proposal
      grids, random weights from a seed) fed the enhanced packets of (c)
      with train steps interleaved as the serial pipeline does, 64 steps in
      all, then one full-frame render;
  (e) the pipeline: ``runtime.pipeline.execute`` at the replica
      configuration's full width and its own threaded mode, fed the
      synthetic frames through ``DataStage`` (the card has no OpenCV to
      decode Replica's JPEGs) with ``mapping_iterations`` cut to 512; it
      checks the prediction directory, counts every kernel's launches on
      that path, and restores the train-state snapshot into a fresh mapping
      stage, which must hold the same tensors and render the same image;
  (f) evaluation: the steps of ``evaluation.runner.render_and_evaluate``
      on (e)'s mapping stage and prediction directory, against an analytic
      box room seen through Replica's 1200x680 camera (frames ray-cast on
      the card and handed over as arrays): the pred->GT scale from a depth
      render per keyframe, the rescaled trajectories, the evaluation
      frames, TSDF meshes from them and from the GT frames (fused on the
      card, held once against the CPU), the NeRF's density-grid mesh, and
      every metric, which must be finite; only the two forward table
      kernels may launch;
  (g) the nerf_slam pipeline at ``configs/nerf_slam_replica.yaml``'s full
      width (360x640, 192 keyframes, 48 factors, frontend window 25, global
      BA and covariances on): (g1) ``TrackingStage(droid-slam)`` alone on
      the synthetic frames, which must run both global BA passes with
      finite covariances; (g2) ``execute`` threaded with the same cuts as
      (e), which must launch each table kernel and never the correlation
      kernel, and fill the keyframe buffer's covariance channel; (g3)
      renders of (g2)'s map through ``MapRenderer`` and the occupancy grid.

Output: progress on stderr; on stdout the card's name and power limit, the
per-phase results, one JSON line with every kernel's numbers (its
launches on the (e), (f) and (g2) paths among them), and as the last line
``{"ok": true, "device": {...}}``. Without a CUDA device it exits
non-zero before printing any result.
"""

from __future__ import annotations

import gc
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from types import SimpleNamespace

import numpy as np
import torch

# published dense peaks of one H100 SXM at its full 700 W limit
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12

REPLICA = dict(  # configs/nerf_vo_replica.yaml, tracking + enhancement
    frame_height=360, frame_width=640, patches_per_frame=96,
    removal_window=28, optimization_window=13, patch_lifetime=15,
    keyframe_threshold=8.0, tracking_module="dpvo",
    enhancement_module="depth", enhancement_image_size=384,
    enhancement_dpt_layers=12,
)
MAPPING = dict(  # configs/nerf_vo_replica.yaml, mapping
    num_keyframes=192, mapping_iterations=8192, rays_per_batch=4096,
    mapping_module="nerfstudio",
)
PIPELINE = dict(  # configs/nerf_vo_replica.yaml, the pipeline's own keys
    frame_stride=2, multithreading=True, performance_tracking=True,
    mapping_snapshot_iterations=8192,
)
# phase (e)'s cut of the config: the pacing budget is mapping_iterations /
# num_keyframes train steps between keyframe packets
PIPELINE_CUTS = dict(mapping_iterations=512, mapping_snapshot_iterations=512)
# keys of the config that name the dataset on disk, the output directory
# and evaluation: phase (e) hands the pipeline its frames in memory and
# writes into a temporary directory
SOURCE_KEYS = ("dir_dataset", "dataset_name", "scene_names", "cache_dataset",
               "first_frame_index", "last_frame_index", "dir_prediction",
               "num_evaluation_frames")
N_FRAMES = 48
RADIUS = 3
MAP_STEPS = 64
STEPS_PER_FRAME = 4  # the serial pipeline's mapping_steps_per_frame
RAYS = MAPPING["rays_per_batch"]
FIELD_SAMPLES, PROPOSAL_SAMPLES = 48, (96, 48)
F32_FLOP_PER_S = 67e12  # f32 outside the tensor cores
SLEEP_CYCLES = 100_000_000  # ~50 ms of device clock
L2_FLUSH_BYTES = 128 << 20  # written before each cold call: > the 50 MB L2
# table-kernel launches of one train step without a proposal refresh: the
# forward (one per route), the surface-normal pullback and the outer backward
ORDINARY_STEP_LAUNCHES = dict(gather_cols=3, gather_interp=4,
                              gather_interp_mm=2, scatter_cols_accum=3)


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def cuda_ms(fn, reps, queued=False):
    """Mean device time of one call, by CUDA events around ``reps`` calls
    after one warm-up call. The kernels line carries this reading. With
    ``queued`` the timed calls wait behind a device-side sleep (~50 ms), so
    the host's time to enqueue a call cannot show: that is the device time
    of a kernel shorter than the enqueue time, printed beside it."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def cuda_ms_cold(fn, reps):
    """Mean device time of one call with a cold L2: each call is queued
    behind a device-side sleep after a 128 MB buffer is written, and timed
    by CUDA events around it alone. Repeated calls on the same inputs find
    them in the 50 MB L2 otherwise, and a bound that counts bytes from
    memory is then no floor."""
    flush = torch.empty(L2_FLUSH_BYTES // 4, device="cuda")
    fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda._sleep(SLEEP_CYCLES)
    for start, end in ev:
        flush.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(start.elapsed_time(end) for start, end in ev) / reps


# ---------------------------------------------------------------------------
# (a) kernels
# ---------------------------------------------------------------------------

def corr_inputs(gen, dev):
    """Replica shapes: R=32 ring slots, 90x160 / 45x80 levels, C=128, about
    30k live edges (96 * sum_{a<15} (14 + a) = 30,240). Centres: mostly
    interior, some in the band up to r+1 px outside, some far off-screen."""
    R, H4, W4, C, E = 32, 90, 160, 128, 30240
    f1 = (torch.randn(R, H4, W4, C, generator=gen, device=dev) * 0.5)
    f2 = torch.nn.functional.avg_pool2d(
        f1.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
    pf = torch.randn(E, 3, 3, C, generator=gen, device=dev) * 0.5
    ring = torch.randint(0, R, (E,), generator=gen, device=dev,
                         dtype=torch.int32)
    u = torch.rand(E, 2, generator=gen, device=dev)
    ctr = u * torch.tensor([W4 - 1.0, H4 - 1.0], device=dev)
    kind = torch.rand(E, generator=gen, device=dev)
    band = kind < 0.10
    off = (torch.rand(E, generator=gen, device=dev) * (RADIUS + 1) + 0.01)
    ctr[band, 0] = torch.where(ctr[band, 0] < W4 / 2, -off[band],
                               W4 - 1 + off[band])
    far = (kind >= 0.10) & (kind < 0.13)
    ctr[far, 0] = -30.0
    bf16 = torch.bfloat16
    return (pf.to(bf16).contiguous(), f1.to(bf16).contiguous(),
            f2.to(bf16).contiguous(), ring, ctr.contiguous())


def corr_bound(pf, f1, f2, ring, ctr):
    """Least time for one update's correlation (both levels): each input
    byte read once (only the feature pixels some usable window covers),
    each output byte written once, and the dot / blend operations of the
    usable edges at the bf16 peak. Returns (ms, 'bytes' | 'operations')."""
    E, _, _, C = pf.shape
    D, WIN = 2 * RADIUS + 1, 2 * RADIUS + 4
    nbytes = pf.numel() * 2 + ring.numel() * 4 + ctr.numel() * 4
    nbytes += E * 2 * 9 * D * D * 4
    flops = 0
    off = torch.arange(WIN, device=pf.device)
    for fmap, c in ((f1, ctr), (f2, ctr * 0.5)):
        R, H, W, _ = fmap.shape
        ok = ((c[:, 0] >= 0) & (c[:, 0] <= W - 1) & (c[:, 1] >= 0)
              & (c[:, 1] <= H - 1))
        cu, rg = c[ok], ring[ok].long()
        ix = torch.floor(cu[:, 0]).long() - (RADIUS + 1)
        iy = torch.floor(cu[:, 1]).long() - (RADIUS + 1)
        gy = iy[:, None, None] + off[None, :, None]
        gx = ix[:, None, None] + off[None, None, :]
        inb = (gy >= 0) & (gy < H) & (gx >= 0) & (gx < W)
        flat = ((rg[:, None, None] * H + gy.clamp(0, H - 1)) * W
                + gx.clamp(0, W - 1))
        touched = torch.zeros(R * H * W, dtype=torch.bool, device=pf.device)
        touched[flat[inb]] = True
        nbytes += int(touched.sum()) * C * 2
        n_ok = int(ok.sum())
        flops += n_ok * (9 * WIN * WIN * C * 2 + 9 * D * D * 7)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def phase_corr(dev):
    """Row 1 at the replica shapes: the two-level kernel (one launch per
    update, the edges sorted by target slot inside the launch, as the
    tracker's wrapper calls it) against the plain version of both levels;
    timed as the tracker calls it and, for comparison, as two one-level
    launches (``scripts/exp_torch_corr_phases.py`` times other edge
    orders)."""
    from nerf_vo_tpu_torch.ops import correlation_cuda as cc

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    pf, f1, f2, ring, ctr = corr_inputs(gen, dev)
    E = pf.shape[0]
    n = 9 * (2 * RADIUS + 1) ** 2
    pf9 = pf.reshape(E, 9, -1)

    def plain():
        return torch.cat([
            cc.corr_level_plain(f1, pf9, ring, ctr, RADIUS),
            cc.corr_level_plain(f2, pf9, ring, ctr * 0.5, RADIUS),
        ], dim=1)

    def kernel():
        return cc.patch_correlation_kernel(pf, f1, f2, ring, ctr, RADIUS)

    half = (ctr * 0.5).contiguous()

    def one_level():  # the same update as two launches of one level each
        return torch.cat([cc.corr_level(f1, pf9, ring, ctr, RADIUS),
                          cc.corr_level(f2, pf9, ring, half, RADIUS)], dim=1)
    want = plain()
    scale = want.abs().max().item()
    tol = 1e-3 * scale  # both accumulate in f32, in another order
    zero_rows = (want == 0).all(1)
    err = 0.0
    for name, fn in (("as the tracker calls it", kernel),
                     ("two one-level launches", one_level)):
        got = fn()
        torch.cuda.synchronize()
        e = (got - want).abs().max().item()
        print(f"(a) corr_two_level ({name}): E={E} edges, max|ref| "
              f"{scale:.4f}, max abs err {e:.3e} (tol {tol:.3e}), rel "
              f"{e / scale:.3e}; {int(zero_rows.sum())} all-zero rows "
              f"(off-frame centres)", flush=True)
        if not np.isfinite(e) or e > tol:
            fail(f"corr kernel ({name}) disagrees with its plain version: "
                 f"{e} > {tol}")
        if not torch.equal(got[zero_rows], want[zero_rows]):
            fail(f"corr kernel ({name}) wrote non-zero values for off-frame "
                 "centres")
        if got[:, :n].abs().sum() == 0 or got[:, n:].abs().sum() == 0:
            fail(f"corr kernel ({name}) output is all zero at a level")
        err = max(err, e)

    before = cc.corr_two_level.launches
    kernel()
    if cc.corr_two_level.launches != before + 1:
        fail("patch_correlation_kernel did not make exactly one launch")
    ms = cuda_ms(kernel, 50)
    queued_ms = cuda_ms(kernel, 50, queued=True)
    cold_ms = cuda_ms_cold(kernel, 50)
    plain_ms = cuda_ms(plain, 5)
    bound_ms, bound_by = corr_bound(pf, f1, f2, ring, ctr)
    print(f"(a) corr_two_level per update (1 launch, slot sort inside): kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"({bound_by}), kernel at {bound_ms / ms:.1%} of the bound; queued "
          f"behind a device sleep {queued_ms:.4f} ms "
          f"({bound_ms / queued_ms:.1%} of the bound); cold L2 "
          f"{cold_ms:.4f} ms ({bound_ms / cold_ms:.1%})", flush=True)
    print(f"(a) corr_level x 2 (two one-level launches): "
          f"{cuda_ms(one_level, 50):.4f} ms, queued "
          f"{cuda_ms(one_level, 50, queued=True):.4f} ms", flush=True)
    return [{
        "name": "corr_two_level", "route": "cuda",
        "source": "nerf_vo_tpu_torch/csrc/corr.cu",
        "replaces": "nerf_vo_tpu/ops/correlation_pallas.py:65",
        "launches": None, "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None,
    }]


def gather_inputs(dev):
    """The field's table ops at the replica configuration: 4096 rays x 48
    samples = 196,608 points, uniform in the unit cube, through the field
    grid (3 levels x 8 features, 16,384 bricks a level; level 0's 512
    bricks on the one-hot route). Returns the table, the level-major ids and
    trilinear weights of all levels, the number of level-0 descriptors, a
    cotangent of the encoded features, and the number of leading table rows
    the hash grid keeps on chip (level 0's 512 bricks)."""
    from nerf_vo_tpu_torch.ops import hash_grid as hg

    cfg = hg.HashGridConfig(3, 8, 19, 16, 2048)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    tab = torch.randn(3 * cfg.bricks_per_level, 256, generator=gen,
                      device=dev) * 0.5
    n = RAYS * FIELD_SAMPLES
    x = torch.rand(n, 3, generator=gen, device=dev)
    idx, _, _, W, _ = hg._descriptors(x, cfg)
    cot = torch.randn(3 * n, 8, generator=gen, device=dev)
    return tab, idx, W, n, cot, hg._hot_rows(cfg)


def proposal_inputs(dev):
    """The proposal grids' gather_interp inputs at the replica
    configuration: dense F = 1 grids at resolution 128 and 160, 4096 rays x
    96 / 48 samples uniform in the unit cube. Yields (res, table, ids,
    trilinear weights)."""
    from nerf_vo_tpu_torch.models.nerf_field import dense_grid
    from nerf_vo_tpu_torch.ops import hash_grid as hg

    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    for res, samples in zip((128, 160), PROPOSAL_SAMPLES):
        cfg = dense_grid(res)
        ptab = torch.randn(cfg.bricks_per_level, 32, generator=gen,
                           device=dev)
        x = torch.rand(RAYS * samples, 3, generator=gen, device=dev)
        pidx, _, _, pw, _ = hg._descriptors(x, cfg)
        yield res, ptab, pidx, pw


def table_bytes(tab, idx):
    """Bytes of the table rows a descriptor list touches, each read once."""
    return int(torch.unique(idx).numel()) * tab.shape[1] * 4


def bound(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def time_kernel(name, fn, plain, library, nbytes, flops, err, reps=20,
                tag="(a)"):
    ms = cuda_ms(fn, reps)
    queued_ms = cuda_ms(fn, reps, queued=True)
    cold_ms = cuda_ms_cold(fn, reps)
    plain_ms = cuda_ms(plain, 3)
    library_ms = cuda_ms(library, reps) if library is not None else None
    bound_ms, bound_by = bound(nbytes, flops)
    lib = "none" if library_ms is None else f"{library_ms:.4f} ms"
    print(f"{tag} {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"library {lib}, bound {bound_ms:.4f} ms ({bound_by}), kernel at "
          f"{bound_ms / ms:.1%} of the bound; max abs err {err:.3e}; "
          f"queued behind a device sleep {queued_ms:.4f} ms "
          f"({bound_ms / queued_ms:.1%} of the bound); cold L2 "
          f"{cold_ms:.4f} ms ({bound_ms / cold_ms:.1%})", flush=True)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms, max_abs_err=err)


def kernel_launches():
    """Every counted kernel wrapper by name; each carries its launches in
    ``.launches``."""
    from nerf_vo_tpu_torch.ops import correlation_cuda, gather_cuda

    return {"corr_level": correlation_cuda.corr_level,
            "corr_two_level": correlation_cuda.corr_two_level,
            **{k.__name__: k for k in gather_cuda.KERNELS}}


def check_close(name, got, want, rel):
    err = (got.float() - want.float()).abs().max().item()
    tol = rel * max(want.abs().max().item(), 1.0)
    if not np.isfinite(err) or err > tol:
        fail(f"{name} disagrees with its plain version: {err} > {tol}")
    return err


def stress_checks(tab, hot):
    """gather_interp_mm and scatter_cols_accum against their plain versions
    on adversarial ids: every id on one brick (inside and beyond the hot
    rows), ids out of range (the plain reference drops them), ids on both
    sides of the hot-row boundary; non-zero padding weights (entries
    27..31) throughout. Same tolerances as the main checks."""
    from nerf_vo_tpu_torch.ops import gather_cuda as gc

    dev = tab.device
    n_bricks, R = tab.shape
    F = R // 32
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    m = 4096

    def ids(lo, hi):
        return torch.randint(lo, hi, (m,), generator=gen, device=dev,
                             dtype=torch.int32)

    cases = {
        "one hot brick": torch.full((m,), 7, dtype=torch.int32, device=dev),
        "one brick beyond the hot rows": torch.full(
            (m,), hot + 5, dtype=torch.int32, device=dev),
        "ids out of range": ids(-n_bricks, 2 * n_bricks),
        "ids across the hot-row boundary": ids(max(hot - 64, 0), hot + 64),
    }
    w = torch.rand(m, 32, generator=gen, device=dev)
    # positive rows: a one-brick sum grows like m, its rounding like
    # m**1.5 * eps, so the 1e-5 relative tolerance holds with margin
    rows = torch.rand(m, R, generator=gen, device=dev)
    for name, i in cases.items():
        ok = (i >= 0) & (i < n_bricks)
        safe = torch.where(ok, i, torch.zeros_like(i))
        want = gc.gather_interp_mm_plain(tab, safe, w, F) * ok[:, None]
        got = gc.gather_interp_mm(tab, i, w, F, hot_rows=hot)
        want_s = gc.scatter_cols_accum_plain(rows[ok], i[ok], n_bricks)
        got_s = gc.scatter_cols_accum(rows, i, n_bricks, hot_rows=hot)
        torch.cuda.synchronize()
        e1 = check_close(f"gather_interp_mm ({name})", got, want, 1e-5)
        e2 = check_close(f"scatter_cols_accum ({name})", got_s, want_s, 1e-5)
        print(f"(a) stress, {name}: gather_interp_mm err {e1:.3e}, "
              f"scatter_cols_accum err {e2:.3e}", flush=True)


def live_groups(t, i, w, F, group_bytes):
    """[m, 32F*4 / group_bytes] bool: the groups of ``group_bytes`` bytes of
    each descriptor's table row that hold an entry with a non-zero weight
    (none for an id out of range)."""
    per = group_bytes // (4 * F)  # entries in a group
    ok = ((i >= 0) & (i < t.shape[0]))[:, None]
    return ((w != 0) & ok).reshape(i.shape[0], 32 // per, per).any(-1)


def interp_table_bytes(t, i, w, F):
    """Bytes of the table that gather_interp's function needs for these
    descriptors: of each touched brick, once, the 32-byte sectors (at F = 1
    the 16-byte groups of 4 entries) that hold an entry with a non-zero
    weight in some descriptor. Zero-weight entries, the padding entries
    27..31 among them, are not needed."""
    group = 16 if F == 1 else 32
    live = live_groups(t, i, w, F, group)
    G = live.shape[1]
    flat = (i.long().clamp(0, t.shape[0] - 1)[:, None] * G
            + torch.arange(G, device=i.device)[None, :])
    touched = torch.zeros(t.shape[0] * G, dtype=torch.bool, device=i.device)
    touched[flat[live]] = True
    return int(touched.sum()) * group


def interp_requests(t, i, w, F):
    """Bytes gather_interp requests from L2 for these descriptors: the ids,
    the weight rows, the outputs and, of each table row, the 32-byte
    sectors that hold an entry with a non-zero weight (ids out of range
    read nothing); and the bytes of the same descriptors with whole rows,
    as one warp per descriptor read them before."""
    m = i.shape[0]
    ok = (i >= 0) & (i < t.shape[0])
    fixed = m * (4 + 32 * 4 + F * 4)
    return (fixed + int(live_groups(t, i, w, F, 32).sum()) * 32,
            fixed + int(ok.sum()) * 32 * F * 4)


def interp_stress(tab):
    """gather_interp against its plain version on weights the hash grid
    never makes: all 32 entries non-zero, and only the padding entries
    27..31 non-zero; ids out of range read zeros. Tolerance 1e-5 of
    max(|ref|, 1)."""
    from nerf_vo_tpu_torch.ops import gather_cuda as gc

    dev = tab.device
    n_bricks, R = tab.shape
    F = R // 32
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    m = 65536
    i = torch.randint(-1000, n_bricks + 1000, (m,), generator=gen,
                      device=dev, dtype=torch.int32)
    ok = (i >= 0) & (i < n_bricks)
    safe = torch.where(ok, i, torch.zeros_like(i))
    dense = torch.rand(m, 32, generator=gen, device=dev) + 0.1
    pad = dense.clone()
    pad[:, :27] = 0.0
    for name, w in (("dense weights", dense),
                    ("only padding entries 27..31", pad)):
        want = gc.gather_interp_plain(tab, safe, w, F) * ok[:, None]
        got = gc.gather_interp(tab, i, w, F)
        torch.cuda.synchronize()
        e = check_close(f"gather_interp ({name})", got, want, 1e-5)
        print(f"(a) stress, gather_interp F={F}, {name}, ids out of range: "
              f"err {e:.3e}", flush=True)


def phase_gather(dev):
    """Kernels 2-5 at the field's shapes; gather_interp also at the two
    proposal grids' (F = 1). Tolerances against the plain versions:
    gather_cols bitwise (the same bf16 rounding); the others 1e-5 of
    max(|plain|, 1) (f32 sums in another order, atomics in an order that
    changes from run to run). gather_interp_mm and scatter_cols_accum are
    timed with the hash grid's hot rows (level 0 kept on chip) and, for
    comparison, with none; the scatter also on level 0's descriptors alone
    and on the hashed levels' alone."""
    import torch.nn.functional as Fn

    from nerf_vo_tpu_torch.ops import gather_cuda as gc

    tab, idx, W, n, cot, hot = gather_inputs(dev)
    M, R = idx.shape[0], tab.shape[1]
    src = "nerf_vo_tpu_torch/csrc/gather.cu"
    pallas = "nerf_vo_tpu/ops/gather_pallas.py"
    out = []

    # 2: gather_cols, every level (the position backward's re-gather)
    got = gc.gather_cols(tab, idx)
    torch.cuda.synchronize()
    if not torch.equal(got, gc.gather_cols_plain(tab, idx)):
        fail("gather_cols differs from its plain version")
    idx_l = idx.long()
    nbytes = table_bytes(tab, idx) + M * 4 + M * R * 2
    out.append(dict(name="gather_cols", route="cuda", source=src,
                    replaces=f"{pallas}:79", launches=None, **time_kernel(
                        f"gather_cols M={M} R={R}",
                        lambda: gc.gather_cols(tab, idx),
                        lambda: gc.gather_cols_plain(tab, idx),
                        lambda: torch.index_select(tab, 0, idx_l),
                        nbytes, 0, 0.0)))

    def interp_entry(name, line, fn, plain, t, i, w, F, label=None):
        m = i.shape[0]
        got = fn(t, i, w, F)
        torch.cuda.synchronize()
        err = check_close(name, got, plain(t, i, w, F), 1e-5)
        flat = (i.long()[:, None] * 32
                + torch.arange(32, device=dev)[None, :])
        view = t.view(-1, F)
        nbytes = interp_table_bytes(t, i, w, F) + m * (4 + 32 * 4 + F * 4)
        return dict(name=name, route="cuda", source=src,
                    replaces=f"{pallas}:{line}", launches=None,
                    **time_kernel(
                        f"{label or name} M={m} F={F} over {t.shape[0]} "
                        "bricks",
                        lambda: fn(t, i, w, F), lambda: plain(t, i, w, F),
                        lambda: Fn.embedding_bag(flat, view,
                                                 per_sample_weights=w,
                                                 mode="sum"),
                        nbytes, 2 * m * 32 * F, err))

    # 3: gather_interp, the hashed levels 1-2 of the field
    out.append(interp_entry("gather_interp", 133, gc.gather_interp,
                            gc.gather_interp_plain, tab, idx[n:], W[n:], 8))
    req, whole = interp_requests(tab, idx[n:], W[n:], 8)
    print(f"(a) gather_interp F=8 requests {req / 1e6:.1f} MB (live entries "
          f"only; whole rows would be {whole / 1e6:.1f} MB); its bound moves "
          f"{out[-1]['bound_ms'] * HBM_BYTES_PER_S / 1e9:.1f} MB", flush=True)
    interp_stress(tab)
    # 4: gather_interp_mm, the field's one-hot level 0, hot rows staged
    def mm_hot(t, i, w, F):
        return gc.gather_interp_mm(t, i, w, F, hot_rows=hot)

    e4 = interp_entry("gather_interp_mm", 219, mm_hot,
                      gc.gather_interp_mm_plain, tab, idx[:n], W[:n], 8,
                      label=f"gather_interp_mm (hot rows {hot} staged)")
    agree = (mm_hot(tab, idx[:n], W[:n], 8)
             - gc.gather_interp(tab, idx[:n], W[:n], 8)).abs().max().item()
    print(f"(a) gather_interp_mm vs gather_interp on level 0: max abs diff "
          f"{agree:.3e}", flush=True)
    if agree > 1e-5 * max(tab.abs().max().item(), 1.0):
        fail("gather_interp_mm and gather_interp disagree")
    out.append(e4)
    # the other design (every row through L1/L2), and gather_interp, on the
    # same level-0 descriptors
    interp_entry("gather_interp_mm", 219, gc.gather_interp_mm,
                 gc.gather_interp_mm_plain, tab, idx[:n], W[:n], 8,
                 label="gather_interp_mm (no rows staged, L1/L2)")
    interp_entry("gather_interp", 133, gc.gather_interp,
                 gc.gather_interp_plain, tab, idx[:n], W[:n], 8,
                 label="gather_interp on level 0")
    # the staging's share: one round of 128 descriptors per block (one
    # block per SM) is mostly the staging of the hot rows
    m1 = torch.cuda.get_device_properties(dev).multi_processor_count * 128
    i1, w1 = idx[:m1], W[:m1]
    for queued in (False, True):
        staged_ms = cuda_ms(lambda: mm_hot(tab, i1, w1, 8), 20, queued)
        none_ms = cuda_ms(lambda: gc.gather_interp_mm(tab, i1, w1, 8), 20,
                          queued)
        how = "queued behind a device sleep" if queued else "back to back"
        print(f"(a) gather_interp_mm, {m1} descriptors (one round per "
              f"block), {how}: hot rows {hot} staged {staged_ms:.4f} ms, "
              f"none staged {none_ms:.4f} ms", flush=True)

    # 5: scatter_cols_accum, the table gradient of every level
    rows = (W[:, :, None] * cot[:, None, :]).reshape(M, R)
    nb = tab.shape[0]
    got = gc.scatter_cols_accum(rows, idx, nb, hot_rows=hot)
    torch.cuda.synchronize()
    err = check_close("scatter_cols_accum", got,
                      gc.scatter_cols_accum_plain(rows, idx, nb), 1e-5)
    got0 = gc.scatter_cols_accum(rows, idx, nb)
    torch.cuda.synchronize()
    err = max(err, check_close("scatter_cols_accum (no hot rows)", got0,
                               gc.scatter_cols_accum_plain(rows, idx, nb),
                               1e-5))
    acc = torch.zeros_like(tab)

    def scatter_entry(label, r, i, h):
        m = i.shape[0]
        il = i.long()
        return time_kernel(
            f"scatter_cols_accum {label} M={m} R={R} into {nb} bricks",
            lambda: gc.scatter_cols_accum(r, i, nb, hot_rows=h),
            lambda: gc.scatter_cols_accum_plain(r, i, nb),
            lambda: acc.index_add_(0, il, r),
            m * R * 4 + m * 4 + tab.numel() * 4, m * R, err)

    out.append(dict(name="scatter_cols_accum", route="cuda", source=src,
                    replaces=f"{pallas}:297", launches=None,
                    **scatter_entry(f"(hot rows {hot} on chip)", rows, idx,
                                    hot)))
    scatter_entry("(no hot rows)", rows, idx, 0)
    scatter_entry(f"level 0 alone (hot rows {hot})", rows[:n], idx[:n], hot)
    scatter_entry("level 0 alone (no hot rows)", rows[:n], idx[:n], 0)
    scatter_entry("hashed levels alone", rows[n:], idx[n:], hot)

    stress_checks(tab, hot)

    # gather_interp at the proposal grids' shapes (F = 1, dense)
    for res, ptab, pidx, pw in proposal_inputs(dev):
        e1 = interp_entry(f"gather_interp (proposal res {res})", 133,
                          gc.gather_interp, gc.gather_interp_plain, ptab,
                          pidx, pw, 1)
        req, whole = interp_requests(ptab, pidx, pw, 1)
        print(f"(a) gather_interp F=1 res {res} requests {req / 1e6:.1f} MB "
              f"(whole rows {whole / 1e6:.1f} MB; bound "
              f"{e1['bound_ms'] * HBM_BYTES_PER_S / 1e9:.1f} MB)", flush=True)
    return out


# ---------------------------------------------------------------------------
# (b) tracking, (c) enhancement, (d) mapping
# ---------------------------------------------------------------------------

def synthetic_frames(n, H, W, seed=0):
    """A smooth random texture (bilinear x8 upsampling of noise) seen by a
    camera panning 2 px per frame, as [H, W, 3] uint8 frames."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(0, 255, (H // 8 + 2, (W + 2 * n) // 8 + 2, 3))
    ys = (np.arange(H) + 0.5) / 8
    xs = (np.arange(W + 2 * n) + 0.5) / 8
    y0, x0 = ys.astype(int), xs.astype(int)
    fy = (ys - y0)[:, None, None]
    fx = (xs - x0)[None, :, None]
    big = (base[y0][:, x0] * (1 - fy) * (1 - fx)
           + base[y0 + 1][:, x0] * fy * (1 - fx)
           + base[y0][:, x0 + 1] * (1 - fy) * fx
           + base[y0 + 1][:, x0 + 1] * fy * fx).astype(np.uint8)
    return [np.ascontiguousarray(big[:, 2 * i:2 * i + W]) for i in range(n)]


def phase_tracking(dev):
    from nerf_vo_tpu_torch.runtime.stages import TrackingStage

    args = SimpleNamespace(**REPLICA)
    H, W = args.frame_height, args.frame_width
    frames = synthetic_frames(N_FRAMES, H, W)
    stage = TrackingStage(args, device=dev)
    intr = dict(fx=320.0, fy=320.0, cx=W / 2, cy=H / 2)
    packets, frame_of, times = [], [], []
    updates = [0]
    vo_update = stage.tracker._vo_update

    def counted(*a, **k):  # one update of the patch graph
        updates[0] += 1
        return vo_update(*a, **k)

    stage.tracker._vo_update = counted
    for i, img in enumerate(frames):
        t0 = time.perf_counter()
        pkt = stage.step(dict(frame_index=i, frame_color=img,
                              camera_intrinsics=intr,
                              last_frame=i == N_FRAMES - 1))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if pkt is not None:
            packets.append(pkt)
            frame_of.append(i)
    tr = stage.tracker
    steady = times[tr.cfg.init_frames:-1]
    fps = len(steady) / sum(steady)
    n_kf = sum(len(p["keyframe_indices"]) for p in packets)
    print(f"(b) tracking: {N_FRAMES} frames at {H}x{W}, steady "
          f"{fps:.2f} frames/s ({1e3 / fps:.2f} ms/frame), init frame "
          f"{times[tr.cfg.init_frames - 1] * 1e3:.1f} ms, {len(packets)} "
          f"packets, {n_kf} keyframes, {int(tr.e_valid.sum())} live edge "
          f"slots at the end", flush=True)
    mats = np.stack(list(tr.trajectory().values()))  # kept frames
    if not np.isfinite(mats).all():
        fail("tracking produced non-finite poses")
    if n_kf == 0:
        fail("tracking retired no keyframes")
    for p in packets:
        ext = p["camera_extrinsics"].cpu().numpy()
        rot = ext[:, :3, :3]
        eye = np.broadcast_to(np.eye(3), rot.shape)
        if not np.allclose(rot @ np.transpose(rot, (0, 2, 1)), eye,
                           atol=1e-4):
            fail("camera_extrinsics are not rigid")
        if not np.isfinite(p["dpvo_patches"].cpu().numpy()).all():
            fail("non-finite patches in a packet")
    return packets, frame_of, fps, updates[0]


def phase_enhancement(dev, packets):
    from nerf_vo_tpu_torch.enhancement.alignment import MAX_DEPTH
    from nerf_vo_tpu_torch.runtime.stages import EnhancementStage

    stage = EnhancementStage(SimpleNamespace(**REPLICA), device=dev)
    stage.step(packets[0])  # warm-up (cuDNN algorithm choice)
    torch.cuda.synchronize()
    total, n_kf, enhanced = 0.0, 0, []
    for p in packets:
        t0 = time.perf_counter()
        out = stage.step(p)
        torch.cuda.synchronize()
        total += time.perf_counter() - t0
        enhanced.append(out)
        k = len(p["keyframe_indices"])
        n_kf += k
        depth = out["frames_depth"]
        if tuple(depth.shape) != (k, REPLICA["frame_height"],
                                  REPLICA["frame_width"]):
            fail(f"frames_depth has shape {tuple(depth.shape)}")
        if not torch.isfinite(depth).all():
            fail("non-finite aligned depth")
        if depth.min() < 0 or depth.max() > MAX_DEPTH:
            fail("aligned depth outside [0, MAX_DEPTH]")
    ms = total / n_kf * 1e3
    print(f"(c) enhancement: DPT-hybrid "
          f"{REPLICA['enhancement_dpt_layers']} blocks at "
          f"{REPLICA['enhancement_image_size']}, {len(packets)} "
          f"packets, {n_kf} keyframes, {ms:.2f} ms per keyframe", flush=True)
    return enhanced


def phase_mapping(dev, enhanced, frame_of):
    """The serial pipeline's order: a packet is inserted at the frame that
    produced it, then up to STEPS_PER_FRAME paced train steps follow each
    frame; after the last frame the stream ends (as ``finish`` does) and
    training runs on to MAP_STEPS steps."""
    from nerf_vo_tpu_torch.ops import gather_cuda
    from nerf_vo_tpu_torch.runtime.stages import MappingStage

    args = SimpleNamespace(**REPLICA, **MAPPING)
    stage = MappingStage(args, device=dev)
    at = dict(zip(frame_of, enhanced))
    history, times = [], []
    per_step = {k.__name__: 0 for k in gather_cuda.KERNELS}
    every = stage.model.config.proposal_refresh_every

    def step():
        refresh = stage.state.step % every == 0
        before = {k.__name__: k.launches for k in gather_cuda.KERNELS}
        t0 = time.perf_counter()
        m = stage.train_step()
        torch.cuda.synchronize()
        if m is None:
            return False
        times.append(time.perf_counter() - t0)
        if not refresh:
            for k in gather_cuda.KERNELS:
                per_step[k.__name__] = max(per_step[k.__name__],
                                           k.launches - before[k.__name__])
        vals = {k: float(v) for k, v in m.items()}
        if not all(np.isfinite(v) for v in vals.values()):
            fail(f"non-finite mapping metrics at step {len(history)}: {vals}")
        history.append(vals)
        return True

    for i in range(N_FRAMES):
        if i in at:
            stage.update(at[i])
        for _ in range(STEPS_PER_FRAME):
            if len(history) >= MAP_STEPS or not step():
                break
    stage.stream_active = False  # end of stream, as finish() does
    while len(history) < MAP_STEPS:
        if not step():
            fail("the mapping stage stopped training before its last step")
    torch.cuda.synchronize()

    t0 = time.perf_counter()
    c2w = stage.trainer.optimized_c2w(stage.state, stage.buffer)[0]
    img = stage.trainer.render_image(stage.state, c2w,
                                     stage.buffer.intrinsics[0],
                                     args.frame_height, args.frame_width)
    torch.cuda.synchronize()
    render_s = time.perf_counter() - t0
    rgb, depth = img["rgb"], img["depth"]
    if tuple(rgb.shape) != (args.frame_height, args.frame_width, 3):
        fail(f"rendered rgb has shape {tuple(rgb.shape)}")
    if not torch.isfinite(rgb).all() or rgb.min() < 0 or rgb.max() > 1:
        fail("rendered rgb is not finite in [0, 1]")
    if not torch.isfinite(depth).all():
        fail("rendered depth is not finite")

    steady = times[8:]
    ms = sum(steady) / len(steady) * 1e3
    first = np.mean([h["rgb_loss"] for h in history[:8]])
    last = np.mean([h["rgb_loss"] for h in history[-8:]])
    print(f"(d) mapping: {stage.num_inserted} keyframes inserted, "
          f"{len(history)} steps, steady {ms:.2f} ms/step "
          f"({args.rays_per_batch / ms * 1e3:.0f} rays/s) over steps "
          f"8..{len(history) - 1}, first step {times[0] * 1e3:.1f} ms; "
          f"rgb_loss first 8 {first:.5f} -> last 8 {last:.5f}; psnr "
          f"{history[-1]['psnr']:.2f}; full-frame render "
          f"{args.frame_height}x{args.frame_width} {render_s * 1e3:.1f} ms, "
          f"depth {depth.min().item():.3f}..{depth.max().item():.3f}",
          flush=True)
    print(f"(d) table-kernel launches per ordinary train step (most seen): "
          f"{per_step}", flush=True)
    for name, most in ORDINARY_STEP_LAUNCHES.items():
        if per_step[name] > most:
            fail(f"{name} launched {per_step[name]} times in one ordinary "
                 f"train step (at most {most})")
    if not last < first:
        fail(f"rgb_loss did not fall: {first} -> {last}")
    return ms


# ---------------------------------------------------------------------------
# (e) the pipeline
# ---------------------------------------------------------------------------

PREDICTION_FILES = {
    "dataset.npz", "mapping_keyframe2frame.json",
    "matrices/matrices_origin2frame_keyframes_tracking.json",
    "matrices/matrices_origin2frame_training.json",
}


def files_under(d):
    return {os.path.relpath(os.path.join(root, f), d)
            for root, _, names in os.walk(d) for f in names}


def check_rigid(name, mats):
    for k, m in mats.items():
        m = np.asarray(m, np.float64)
        if m.shape != (4, 4) or not np.isfinite(m).all():
            fail(f"{name}[{k}] is not a finite 4x4 matrix")
        if (not np.allclose(m[:3, :3] @ m[:3, :3].T, np.eye(3), atol=1e-4)
                or not np.allclose(m[3], [0, 0, 0, 1])):
            fail(f"{name}[{k}] is not rigid")


def equal_tree(x, y):
    """Bitwise equality of nested dicts / lists of tensors and scalars."""
    if isinstance(x, torch.Tensor):
        return (isinstance(y, torch.Tensor) and x.device == y.device
                and torch.equal(x, y))
    if isinstance(x, dict):
        return x.keys() == y.keys() and all(equal_tree(x[k], y[k])
                                            for k in x)
    if isinstance(x, (list, tuple)):
        return len(x) == len(y) and all(map(equal_tree, x, y))
    return x == y


def stage_summary(dir_result, stage):
    """``PerformanceTracker.summary`` of one stage, from the runtime CSV
    the pipeline wrote, and the per-step times."""
    from nerf_vo_tpu_torch.runtime.perf import PerformanceTracker

    with open(os.path.join(dir_result, f"runtime_{stage}.csv")) as f:
        rows = [(int(a), float(b)) for a, b in
                (line.split(",") for line in f.read().split()[1:])]
    perf = PerformanceTracker()
    perf.rows[stage] = rows
    return perf.summary(stage), [dt for _, dt in rows]


def phase_pipeline(dev, smi, tracking_fps, tmp):
    """``execute`` as a user calls it, on the card, writing into ``tmp``,
    then the snapshot's round trip. Returns the kernels' launches on the
    pipeline's path, the mapping stage and the run's ``args``."""
    from nerf_vo_tpu_torch.ops import correlation_cuda, gather_cuda
    from nerf_vo_tpu_torch.runtime import pipeline, stages

    cfg = {**REPLICA, **MAPPING, **PIPELINE, **PIPELINE_CUTS}
    H, W, K = cfg["frame_height"], cfg["frame_width"], cfg["num_keyframes"]
    iters = cfg["mapping_iterations"]
    intr = dict(fx=320.0, fy=320.0, cx=W / 2, cy=H / 2)
    dataset = [dict(frame_index=i, camera_intrinsics=intr, frame_color=img,
                    last_frame=i == N_FRAMES - 1)
               for i, img in enumerate(synthetic_frames(N_FRAMES, H, W))]
    print(f"(e) cuts: random weights from a seed; {N_FRAMES} synthetic "
          f"{H}x{W} frames handed to DataStage in memory, in place of "
          f"{', '.join(SOURCE_KEYS[:2])} (the card has no cv2 to decode the "
          f"Replica JPEGs); mapping_iterations and "
          f"mapping_snapshot_iterations {iters} in place of "
          f"{MAPPING['mapping_iterations']}, so the pacing budget is "
          f"{iters}/{K} = {iters / K:.2f} train steps per keyframe packet "
          f"(not {MAPPING['mapping_iterations'] / K:.2f}); dir_prediction "
          "and dir_result in a temporary directory", flush=True)

    args = SimpleNamespace(**cfg, dir_prediction=f"{tmp}/prediction",
                           dir_result=f"{tmp}/result")
    marks = {}
    finish = stages.MappingStage.finish

    def timed_finish(self):  # observes finish(), changes nothing
        torch.cuda.synchronize()
        marks["start"] = (time.perf_counter(), self.step_count)
        finish(self)
        torch.cuda.synchronize()
        marks["end"] = (time.perf_counter(), self.step_count)

    stages.MappingStage.finish = timed_finish
    correlation_cuda.corr_level.launches = 0
    correlation_cuda.corr_two_level.launches = 0
    for k in gather_cuda.KERNELS:
        k.launches = 0
    t0 = time.perf_counter()
    try:
        mapping = pipeline.execute(args, device=dev, dataset=dataset)
        torch.cuda.synchronize()
    finally:
        stages.MappingStage.finish = finish
    wall = time.perf_counter() - t0
    counts = {"corr_two_level": correlation_cuda.corr_two_level.launches,
              **{k.__name__: k.launches for k in gather_cuda.KERNELS}}
    print(f"(e) launches on the pipeline's path: {counts}; one-level "
          f"corr_level: {correlation_cuda.corr_level.launches}",
          flush=True)
    for name, n in counts.items():
        if n == 0:
            fail(f"the pipeline never launched {name}")
    if correlation_cuda.corr_level.launches:
        fail("the pipeline launched the one-level corr kernel")

    pred = args.dir_prediction
    want = PREDICTION_FILES | {f"snapshots/{s}{iters:06d}.pt"
                               for s in ("trainstate", "snapshot")}
    if files_under(pred) != want:
        fail(f"prediction directory holds {sorted(files_under(pred))}, "
             f"not {sorted(want)}")
    runtimes = {f"runtime_{s}.csv" for s in ("data", "tracking",
                                             "enhancement", "mapping")}
    if files_under(args.dir_result) != runtimes:
        fail(f"result directory holds {files_under(args.dir_result)}")
    with open(f"{pred}/mapping_keyframe2frame.json") as f:
        kf2frame = json.load(f)
    if len(kf2frame) != mapping.num_inserted:
        fail(f"{len(kf2frame)} keyframes in mapping_keyframe2frame.json,"
             f" {mapping.num_inserted} inserted")
    for name in sorted(want):
        if name.endswith(".json") and name.startswith("matrices/"):
            with open(f"{pred}/{name}") as f:
                check_rigid(name, json.load(f))
    if mapping.step_count != iters:
        fail(f"the mapper took {mapping.step_count} steps, not {iters}")

    summaries = {s: stage_summary(args.dir_result, s)
                 for s in ("data", "tracking", "enhancement", "mapping")}
    init = getattr(args, "tracking_init_frames", 8)
    steady = summaries["tracking"][1][init:-1]
    fps = len(steady) / sum(steady)
    (t_start, s_start), (t_end, s_end) = marks["start"], marks["end"]
    ms_step = (t_end - t_start) / max(s_end - s_start, 1) * 1e3
    print(f"(e) pipeline, {smi}: {N_FRAMES} frames, "
          f"{mapping.num_inserted} keyframes, {mapping.step_count} "
          f"mapping steps ({s_start} while the stream ran); wall "
          f"{wall:.2f} s, to the end of finish() "
          f"{t_end - t0:.2f} s", flush=True)
    for s, (summ, _) in summaries.items():
        print(f"(e) stage {s}: {summ['steps']} spans, total "
              f"{summ['total']:.3f} s, average "
              f"{summ['average'] * 1e3:.2f} ms without the first and "
              "last", flush=True)
    print(f"(e) tracking inside the pipeline: steady {fps:.2f} frames/s "
          f"(frames {init}..{len(summaries['tracking'][1]) - 2}), "
          f"against {tracking_fps:.2f} alone in phase (b); mapping "
          f"inside the pipeline: {ms_step:.2f} ms/step over the "
          f"{s_end - s_start} steps of finish()", flush=True)

    # the train-state snapshot, restored into a fresh stage on the card
    fresh = stages.MappingStage(args, device=dev)
    fresh.buffer, fresh.num_inserted = mapping.buffer, mapping.num_inserted
    fresh.restore_snapshot(f"{pred}/snapshots/trainstate{iters:06d}.pt")
    live, back = mapping.state, fresh.state
    grids = [k for k in mapping.model.state_dict() if "proposal" in k]
    same = {
        "model (proposal grids too)": equal_tree(
            mapping.model.state_dict(), fresh.model.state_dict()),
        "pose_deltas": torch.equal(live.pose_deltas, back.pose_deltas),
        "field Adam": equal_tree(live.opt.state_dict(),
                                 back.opt.state_dict()),
        "camera Adam": equal_tree(live.cam_opt.state_dict(),
                                  back.cam_opt.state_dict()),
        "step": fresh.step_count == live.step == iters,
    }
    c2w = mapping.trainer.optimized_c2w(live, mapping.buffer)[0]
    intr0 = mapping.buffer.intrinsics[0]
    img = mapping.trainer.render_image(live, c2w, intr0, H, W)
    img2 = fresh.trainer.render_image(back, c2w, intr0, H, W)
    torch.cuda.synchronize()
    diff = max((img[k] - img2[k]).abs().max().item() for k in img)
    same["render"] = all(torch.equal(img[k], img2[k]) for k in img)
    print(f"(e) snapshot round trip on the card ({len(grids)} proposal "
          f"grid tensors among {len(mapping.model.state_dict())}): "
          f"{same}; {H}x{W} render max abs diff {diff:.3e}", flush=True)
    for what, ok in same.items():
        if not ok:
            fail(f"the restored snapshot differs from the live stage: "
                 f"{what}")
    if not all(torch.isfinite(v).all() for v in img.values()):
        fail("the pipeline's render is not finite")
    return counts, mapping, args


# ---------------------------------------------------------------------------
# (f) evaluation
# ---------------------------------------------------------------------------

# phase (f)'s cut of the config: evaluation frames; the frame size is
# Replica's own (datasets/replica.json)
EVALUATION_CUTS = dict(num_evaluation_frames=8)
# the analytic room phase (f) evaluates against, in metres: a box the size
# of a Replica room, seen from inside
ROOM_LO, ROOM_HI = (-2.5, -1.25, -1.5), (2.5, 1.25, 3.0)


def replica_camera():
    """Replica's camera (``datasets/replica.json``) as an evaluation
    dataset's intrinsics."""
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "datasets", "replica.json")) as f:
        c = json.load(f)["replica"]
    return dict(height=c["h"], width=c["w"], fx=c["fx"], fy=c["fy"],
                cx=c["cx"], cy=c["cy"], depth_scale=c["depth_scale"])


def room_pose(i):
    """A slow pan from inside the room: 0.5 degrees of yaw and 1 cm of
    dolly a frame (OpenCV camera-to-world)."""
    ang = np.radians(0.5) * i - 0.2
    c2w = np.eye(4)
    c2w[:3, :3] = [[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                   [-np.sin(ang), 0, np.cos(ang)]]
    c2w[:3, 3] = [0.01 * i - 0.4, 0.1, 0.0]
    return c2w


@torch.no_grad()
def room_frame(c2w, cam, dev):
    """Ray-cast the box room from inside: color uint8 [H, W, 3] (a
    checker of 25 cm on each wall, one base color a wall) and the z-depth
    [H, W] quantized to the dataset's depth scale, as a depth PNG holds
    it."""
    H, W = cam["height"], cam["width"]
    f64 = dict(dtype=torch.float64, device=dev)
    ys, xs = torch.meshgrid(torch.arange(H, **f64), torch.arange(W, **f64),
                            indexing="ij")
    d = torch.stack([(xs - cam["cx"]) / cam["fx"],
                     (ys - cam["cy"]) / cam["fy"], torch.ones_like(xs)], -1)
    c2w = torch.as_tensor(c2w, **f64)
    dw = d @ c2w[:3, :3].T
    o = c2w[:3, 3]
    lo, hi = torch.tensor(ROOM_LO, **f64), torch.tensor(ROOM_HI, **f64)
    bound = torch.where(dw > 0, hi, lo)
    t_axis = torch.where(dw.abs() > 1e-12, (bound - o) / dw,
                         torch.full_like(dw, float("inf")))
    t, axis = t_axis.min(-1)  # the wall the ray leaves through
    p = o + dw * t[..., None]
    wall = axis * 2 + (dw.gather(-1, axis[..., None])[..., 0] > 0).long()
    u = p.gather(-1, ((axis + 1) % 3)[..., None])[..., 0]
    v = p.gather(-1, ((axis + 2) % 3)[..., None])[..., 0]
    check = (torch.floor(u * 4) + torch.floor(v * 4)) % 2
    base = torch.tensor([[0.8, 0.3, 0.2], [0.2, 0.6, 0.8], [0.7, 0.7, 0.3],
                         [0.3, 0.7, 0.4], [0.6, 0.4, 0.7], [0.9, 0.8, 0.6]],
                        **f64)[wall]
    color = base * (0.55 + 0.45 * check[..., None])
    color = (color * 255).clamp(0, 255).to(torch.uint8).cpu().numpy()
    scale = cam["depth_scale"]
    depth = torch.round(t * scale).clamp(0, 65535).cpu().numpy() / scale
    return color, depth


def room_dataset(cam, num_frames, dir_dataset, dev):
    """The port's Replica evaluation dataset over the box room, its frames
    ray-cast on ``dev`` when they are read (the card has no cv2 to decode
    files); the GT mesh is fused on ``dev`` into ``dir_dataset``'s
    parent."""
    from nerf_vo_tpu_torch.evaluation.datasets import EvaluationDataset

    class RoomDataset(EvaluationDataset):
        def _load_files(self):
            return [None] * num_frames, [None] * num_frames

        def _load_camera_intrinsics(self):
            return dict(cam)

        def _load_camera_extrinsics(self):
            return [room_pose(i) for i in range(num_frames)]

        def _load_frame_color(self, i):
            return room_frame(self.camera_extrinsics[i], cam, dev)[0]

        def _load_frame_depth(self, i):
            return room_frame(self.camera_extrinsics[i], cam, dev)[1]

    return RoomDataset(dir_dataset, "replica",
                       EVALUATION_CUTS["num_evaluation_frames"],
                       cam["height"], cam["width"], device=dev)


def record_interp_calls(fn):
    """Runs ``fn()`` with rows 3 and 4 observed: each call's inputs are
    kept (tensors cloned, so that later in-place updates of a table do not
    reach them) and the call goes on to the kernel, whose launch is counted
    on the kernel's own wrapper as usual. Returns fn's result and the
    calls."""
    from nerf_vo_tpu_torch.ops import gather_cuda as gc

    kernel = {name: getattr(gc, name)
              for name in ("gather_interp", "gather_interp_mm")}
    calls = []

    def recorder(name):
        def record(*a, **kw):
            calls.append((name, tuple(x.detach().clone()
                                      if torch.is_tensor(x) else x
                                      for x in a), dict(kw)))
            out = kernel[name](*a, **kw)
            # the wrapper counts on the module's function, which this
            # stands in for while it records: hand the count back
            kernel[name].launches += record.launches
            record.launches = 0
            return out
        record.launches = 0
        return record

    for name in kernel:
        setattr(gc, name, recorder(name))
    try:
        out = fn()
    finally:
        for name, k in kernel.items():
            setattr(gc, name, k)
    return out, calls


def hold_interp_calls(calls, label, tag):
    """Each recorded row-3 / row-4 call, launched again on its own inputs,
    held against its plain version and timed as phase (a) times it."""
    import torch.nn.functional as Fn

    from nerf_vo_tpu_torch.ops import gather_cuda as gc

    plain = {"gather_interp": gc.gather_interp_plain,
             "gather_interp_mm": gc.gather_interp_mm_plain}
    torch.cuda.synchronize()
    for name, a, kw in calls:
        kernel = getattr(gc, name)
        t, i, w, F = a[:4]
        m = i.shape[0]
        got = kernel(*a, **kw)
        torch.cuda.synchronize()
        err = check_close(f"{name} at {label}", got,
                          plain[name](t, i, w, F), 1e-5)
        flat = i.long()[:, None] * 32 + torch.arange(32, device=i.device)
        view = t.view(-1, F)
        nbytes = interp_table_bytes(t, i, w, F) + m * (4 + 32 * 4 + F * 4)
        time_kernel(
            f"{name} at {label}: M={m} F={F} over {t.shape[0]} bricks"
            f"{', hot rows ' if kw else ''}{kw.get('hot_rows', '')}",
            lambda: kernel(*a, **kw), lambda: plain[name](t, i, w, F),
            lambda: Fn.embedding_bag(flat, view, per_sample_weights=w,
                                     mode="sum"),
            nbytes, 2 * m * 32 * F, err, tag=tag)


def chunk_shape_timings(mapping):
    """Rows 3 and 4 at an evaluation render's shapes: the inputs of every
    table-kernel launch of one 16,384-ray render chunk of the map (one
    128x128 render), each launch then held against its plain version and
    timed as phase (a) times it."""
    st = mapping.trainer
    c2w = st.optimized_c2w(mapping.state, mapping.buffer)[0]
    intr = mapping.buffer.intrinsics[0] * 0.2
    _, calls = record_interp_calls(
        lambda: st.render_image(mapping.state, c2w, intr, 128, 128))
    hold_interp_calls(calls, "a 16,384-ray render chunk", "(f)")
    return len(calls)


def phase_evaluation(dev, smi, mapping, args, tmp):
    """The evaluation layer on (e)'s mapping stage and prediction
    directory, against the box room at Replica's frame size: the steps of
    ``render_and_evaluate``, with the evaluation frames handed over as
    arrays. Returns every kernel's launches in this phase and the
    metrics."""
    from nerf_vo_tpu_torch.evaluation import meshio, tsdf
    from nerf_vo_tpu_torch.evaluation.evaluator import Evaluator
    from nerf_vo_tpu_torch.evaluation.nerf_renderer import MapRenderer
    from nerf_vo_tpu_torch.evaluation.renderer import Renderer

    cam = replica_camera()
    H, W = cam["height"], cam["width"]
    pred = args.dir_prediction
    with open(f"{pred}/mapping_keyframe2frame.json") as f:
        kf2frame = json.load(f)
    n_kf, n_frames = len(kf2frame), max(kf2frame.values()) + 1
    os.makedirs(f"{tmp}/dataset", exist_ok=True)
    dataset = room_dataset(cam, n_frames, f"{tmp}/dataset/room0", dev)
    n_eval = len(dataset.evaluation_frames)
    print(f"(f) cuts: num_evaluation_frames "
          f"{EVALUATION_CUTS['num_evaluation_frames']} in place of 125 "
          f"({n_eval} of {n_frames} frames); frames at Replica's full "
          f"{W}x{H} (datasets/replica.json), ray-cast from an analytic "
          f"{np.subtract(ROOM_HI, ROOM_LO).tolist()} m box room on a slow "
          "pan and handed over as arrays: the card has no cv2, so the 2D "
          "metrics and the mesh from frames skip the JPEG / PNG round trip "
          "that render_and_evaluate makes; the map is phase (e)'s, trained "
          "on other frames", flush=True)

    kernels = kernel_launches()
    for k in kernels.values():
        k.launches = 0

    def launches():
        return {name: k.launches for name, k in kernels.items()}

    # observers: they time and count, and change nothing
    fused, meshed, grids = [], [], []
    fuse, extract = tsdf.fuse_tsdf, tsdf.extract_mesh
    nerf = MapRenderer(mapping)
    density_grid = nerf.density_grid

    def timed_fuse(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        vol = fuse(*a, **kw)
        torch.cuda.synchronize()
        fused.append((len(a[0]), vol["tsdf"].shape, vol["voxel_size"],
                      time.perf_counter() - t0))
        return vol

    def timed_extract(*a, **kw):
        t0 = time.perf_counter()
        out = extract(*a, **kw)
        meshed.append((a[0].shape, len(out[1]), time.perf_counter() - t0))
        return out

    def timed_density_grid(res, lo, hi, chunk=1 << 18):
        torch.cuda.synchronize()
        before = launches()
        t0 = time.perf_counter()
        out = density_grid(res, lo, hi, chunk)
        torch.cuda.synchronize()
        n = int(np.prod(out.shape))
        grids.append((out.shape, time.perf_counter() - t0, -(-n // chunk),
                      {k: v - before[k] for k, v in launches().items()}))
        return out

    steps = []

    def step(name, fn, renders=0):
        torch.cuda.synchronize()
        before = launches()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        steps.append((name, sec, renders,
                      {k: v - before[k] for k, v in launches().items()}))
        print(f"(f) step {len(steps)}, {name}: {sec:.2f} s", flush=True)
        return out

    tsdf.fuse_tsdf, tsdf.extract_mesh = timed_fuse, timed_extract
    nerf.density_grid = timed_density_grid
    try:
        config = dict(dir_prediction=pred, dir_result=args.dir_result,
                      dataset_name="replica",
                      dir_dataset=dataset.dir_dataset)
        renderer = step("pred->GT scale, one depth render a keyframe",
                        lambda: Renderer(config, dataset, nerf), n_kf)
        step("keyframe trajectories rescaled",
             renderer.render_camera_extrinsics_keyframes)
        frames = step("evaluation frames rendered to arrays",
                      renderer.render_frame_arrays, n_eval)
        step("mesh from the evaluation frames (TSDF on the card)",
             lambda: renderer.render_mesh("frames", frames=frames))
        (_, _), gt_path = step("GT mesh, dataset.mesh() (TSDF on the card)",
                               dataset.mesh)
        evaluator = Evaluator(config, dataset, device=dev)
        if os.path.exists(f"{pred}/mesh/mesh_from_nerf.ply"):
            fail("a NeRF mesh exists before the metrics: the 3D metrics "
                 "would not score the mesh from the evaluation frames")
        metrics = step("metrics: trajectory, 2D from the arrays, 3D of the "
                       "mesh from the evaluation frames",
                       lambda: {
                           "trajectory":
                               evaluator.calculate_metrics_trajectory(),
                           "2d": evaluator.calculate_metrics_2d(frames),
                           "3d": evaluator.calculate_metrics_3d()})
        # the evaluation path's launches and steps end here
        counts = launches()
        path_steps, path_meshed = list(steps), len(meshed)
        # the NeRF's own mesh: render_and_evaluate does not make it, so it
        # runs after the metrics, apart from their launches and seconds
        step("mesh from the NeRF (density grid on the card), not on "
             "render_and_evaluate's path", lambda: renderer.render_mesh("nerf"))
    finally:
        tsdf.fuse_tsdf, tsdf.extract_mesh = fuse, extract
    nerf_counts = steps[-1][3]

    renders = sum(r for _, _, r, _ in path_steps)
    t_render = sum(sec for _, sec, r, _ in path_steps if r)
    per = {k: sum(c[k] for _, _, r, c in path_steps if r) / renders
           for k in ("gather_interp", "gather_interp_mm")}
    print(f"(f) {renders} renders of {H}x{W} ({n_kf} keyframes, {n_eval} "
          f"evaluation frames): {t_render / renders * 1e3:.1f} ms a render "
          f"with its copy to the host, {renders * H * W / t_render:.0f} "
          f"rays/s; launches a render: {per}", flush=True)
    for shape, sec, chunks, grid_counts in grids:
        print(f"(f) density grid {shape} ({int(np.prod(shape))} points, "
              f"{chunks} chunks): {sec:.2f} s; launches a chunk: "
              f"gather_interp {grid_counts['gather_interp'] / chunks:.1f}, "
              f"gather_interp_mm "
              f"{grid_counts['gather_interp_mm'] / chunks:.1f}", flush=True)
    for n, dims, vox, sec in fused:
        print(f"(f) TSDF fusion of {n} frames: grid {dims} "
              f"({int(np.prod(dims))} voxels) at {vox * 100:.3f} cm, "
              f"{sec:.2f} s with the volume's copy to the host, "
              f"{sec / n * 1e3:.1f} ms a frame", flush=True)
    for dims, n_faces, sec in meshed:
        print(f"(f) host meshing of a {dims} grid: {n_faces} faces, "
              f"{sec:.2f} s", flush=True)
    print(f"(f) host meshing on render_and_evaluate's path "
          f"{sum(m[2] for m in meshed[:path_meshed]):.2f} s; metrics "
          f"{path_steps[-1][1]:.2f} s; render_and_evaluate's steps in all "
          f"{sum(sec for _, sec, _, _ in path_steps):.2f} s, {smi}",
          flush=True)
    print(f"(f) the NeRF mesh, apart: {steps[-1][1]:.2f} s, launches "
          f"{nerf_counts}", flush=True)
    for name in ("gather_cols", "scatter_cols_accum", "corr_two_level",
                 "corr_level"):
        if nerf_counts[name]:
            fail(f"the density grid launched {name} {nerf_counts[name]} "
                 "times: a gradient or tracking")
    for name in ("gather_interp", "gather_interp_mm"):
        if not nerf_counts[name]:
            fail(f"the density grid never launched {name}")

    for name, path in (
            ("the evaluation frames",
             f"{pred}/mesh/mesh_from_evaluation_frames.ply"),
            ("the NeRF", f"{pred}/mesh/mesh_from_nerf.ply"),
            ("the GT frames", gt_path)):
        v, fcs = meshio.read_ply(path)
        print(f"(f) mesh from {name}: {len(v)} vertices, "
              f"{0 if fcs is None else len(fcs)} faces", flush=True)
        if fcs is None or not len(fcs):
            fail(f"the mesh from {name} is empty")

    n_calls = chunk_shape_timings(mapping)
    print(f"(f) {n_calls} table-kernel launches in one render chunk",
          flush=True)

    # the card's fusion against the CPU's, on a small volume
    idx = dataset.evaluation_frames[:4]
    small = [np.stack([dataset._load_frame_depth(i) for i in idx]),
             np.stack([dataset._load_frame_color(i) for i in idx]
                      ).astype(np.float32) / 255.0,
             np.asarray([cam["fx"], cam["fy"], cam["cx"], cam["cy"]],
                        np.float32),
             np.stack([dataset.camera_extrinsics[i] for i in idx])]
    on_card = tsdf.fuse_tsdf(*small, voxel_size=1 / 16, device=dev)
    on_cpu = tsdf.fuse_tsdf(*small, voxel_size=1 / 16, device="cpu")
    err = max(float(np.abs(on_card[k] - on_cpu[k]).max())
              for k in ("tsdf", "weight", "color"))
    print(f"(f) fuse_tsdf on the card against the CPU, {len(idx)} GT frames "
          f"on a {on_cpu['tsdf'].shape} grid: max abs diff {err:.3e} "
          "(tolerance 1e-5)", flush=True)
    if not err <= 1e-5:
        fail(f"fuse_tsdf on the card differs from the CPU by {err}")

    print(f"(f) metrics: {json.dumps(metrics)}", flush=True)
    for group, vals in metrics.items():
        if not vals:
            fail(f"no {group} metrics")
        for k, v in vals.items():
            if k != "lpips" and not np.isfinite(v):
                fail(f"{group} metric {k} is {v}")
    return counts, metrics


# ---------------------------------------------------------------------------
# (g) the nerf_slam pipeline
# ---------------------------------------------------------------------------

SLAM = dict(  # configs/nerf_slam_replica.yaml, the keys the stages read
    frame_height=360, frame_width=640, num_keyframes=192,
    keyframe_threshold=8.0, tracking_module="droid-slam",
    enhancement_module="none", mapping_module="instant-ngp",
    perform_global_bundle_adjustment=True, compute_covariances=True,
    frame_stride=2, multithreading=True, performance_tracking=True,
    mapping_iterations=8192, mapping_snapshot_iterations=8192,
)
# phase (g)'s cut of the tracker: with random weights the motion filter's
# mean predicted flow says nothing of the synthetic pan, so every frame is
# a keyframe candidate; the keyframe policy and both global BA passes then
# run as on a real stream
SLAM_TRACKING_CUTS = dict(motion_threshold=0.0)
SLAM_RENDERS = 2


def phase_slam_tracking(dev, smi):
    """(g1) ``TrackingStage(droid-slam)`` alone on the synthetic frames at
    the nerf_slam replica width: frames/s, keyframes kept and removed,
    frontend and backend edges, the time of each global BA pass, and the
    last packet's depth-covariance range."""
    from nerf_vo_tpu_torch.runtime.stages import TrackingStage
    from nerf_vo_tpu_torch.tracking.droid_slam import DroidConfig

    args = SimpleNamespace(**SLAM, **SLAM_TRACKING_CUTS)
    H, W = args.frame_height, args.frame_width
    frames = synthetic_frames(N_FRAMES, H, W)
    stage = TrackingStage(args, device=dev)
    tr = stage.tracker
    cfg = tr.cfg
    print(f"(g1) cuts: random weights from a seed; {N_FRAMES} synthetic "
          f"{H}x{W} frames; motion_threshold "
          f"{SLAM_TRACKING_CUTS['motion_threshold']} in place of "
          f"{DroidConfig.motion_threshold} (the tracker's default): every "
          "frame is a keyframe "
          f"candidate. Full width: buffer {cfg.buffer_size}, "
          f"{cfg.max_factors} factors, frontend window "
          f"{cfg.frontend_window}, global BA "
          f"{cfg.perform_global_ba}, covariances "
          f"{cfg.compute_covariances}", flush=True)
    removed, passes, edges = [], [], []
    remove, backend, backend_edges = (tr.remove_keyframe, tr.backend,
                                      tr._backend_edges)

    def counted_remove(g):  # observers: they count and time, change nothing
        removed.append(g)
        remove(g)

    def timed_backend(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        backend(steps)
        torch.cuda.synchronize()
        passes.append((steps, time.perf_counter() - t0))

    def counted_edges():
        order, pairs = backend_edges()
        edges.append((len(order), len(pairs)))
        return order, pairs

    tr.remove_keyframe, tr.backend = counted_remove, timed_backend
    tr._backend_edges = counted_edges
    intr = dict(fx=320.0, fy=320.0, cx=W / 2, cy=H / 2)
    torch.cuda.reset_peak_memory_stats()
    times, packets, live = [], [], []
    for i, img in enumerate(frames):
        t0 = time.perf_counter()
        pkt = stage.step(dict(frame_index=i, frame_color=img,
                              camera_intrinsics=intr,
                              last_frame=i == N_FRAMES - 1))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        live.append(int(tr.e_valid.sum()))
        if pkt is not None:
            packets.append(pkt)
    steady = times[4:-1]  # updates run from the 4th keyframe on
    fps = len(steady) / sum(steady)
    kept = len(tr.retired)
    print(f"(g1) DROID tracking, {smi}: {N_FRAMES} frames, steady "
          f"{fps:.2f} frames/s ({1e3 / fps:.1f} ms/frame, frames "
          f"4..{N_FRAMES - 2}); last frame with the flush "
          f"{times[-1]:.2f} s; keyframes kept {kept}, removed "
          f"{len(removed)}; frontend edges at most {max(live)} of "
          f"{cfg.max_factors}", flush=True)
    for (steps, sec), (nk, ne) in zip(passes, edges):
        print(f"(g1) global BA pass backend({steps}): {nk} keyframes, "
              f"{ne} edges, {sec:.2f} s", flush=True)
    last = packets[-1]
    cov = last["droid_slam_depth_covariance"]
    inv = last["droid_slam_inverse_depth"]
    print(f"(g1) last packet: {len(last['keyframe_indices'])} keyframes, "
          f"inverse depth {inv.min().item():.4g}..{inv.max().item():.4g}, "
          f"depth covariance {cov.min().item():.4g}..{cov.max().item():.4g};"
          f" peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    if len(passes) != 2:
        fail(f"the flush ran {len(passes)} global BA passes, not 2")
    if not all(ne for _, ne in edges):
        fail("a global BA pass had no edges")
    for p in packets:
        for k in ("droid_slam_depth_covariance", "droid_slam_inverse_depth",
                  "camera_extrinsics"):
            if not torch.isfinite(p[k]).all():
                fail(f"non-finite {k} in a DROID packet")
    mats = np.stack(list(tr.trajectory().values()))
    if not np.isfinite(mats).all():
        fail("DROID tracking produced non-finite poses")
    return fps


def phase_slam_pipeline(dev, smi, tmp):
    """(g2) ``execute`` threaded with the nerf_slam replica keys, the cuts
    of (e) and (g1): DROID tracking, DROID depth, the Instant-NGP mapper.
    Returns the kernels' launches on this path and the mapping stage."""
    from nerf_vo_tpu_torch.models import nerfacto
    from nerf_vo_tpu_torch.ops import occupancy
    from nerf_vo_tpu_torch.runtime import pipeline, stages

    cfg = {**SLAM, **SLAM_TRACKING_CUTS, **PIPELINE_CUTS}
    H, W, K = cfg["frame_height"], cfg["frame_width"], cfg["num_keyframes"]
    iters = cfg["mapping_iterations"]
    intr = dict(fx=320.0, fy=320.0, cx=W / 2, cy=H / 2)
    dataset = [dict(frame_index=i, camera_intrinsics=intr, frame_color=img,
                    last_frame=i == N_FRAMES - 1)
               for i, img in enumerate(synthetic_frames(N_FRAMES, H, W))]
    print(f"(g2) cuts: as (e), {N_FRAMES} synthetic {H}x{W} frames in "
          f"memory and mapping_iterations {iters} in place of "
          f"{SLAM['mapping_iterations']} (pacing budget {iters / K:.2f} "
          f"steps a packet); as (g1), motion_threshold "
          f"{SLAM_TRACKING_CUTS['motion_threshold']}", flush=True)
    args = SimpleNamespace(**cfg, dir_prediction=f"{tmp}/slam_prediction",
                           dir_result=f"{tmp}/slam_result")
    marks, refreshes, refresh_calls = {}, [], []
    every = stages.mapping_model_config(
        SimpleNamespace(**cfg)).occupancy.update_every
    finish = stages.MappingStage.finish
    refresh = nerfacto.NerfactoModel.refresh_occupancy

    def timed_finish(self):  # observers: they count and time
        torch.cuda.synchronize()
        marks["start"] = (time.perf_counter(), self.step_count)
        finish(self)
        torch.cuda.synchronize()
        marks["end"] = (time.perf_counter(), self.step_count)

    def counted_refresh(self, occ_grid, step, jitter):
        refreshes.append(step)
        if step + every < iters:
            return refresh(self, occ_grid, step, jitter)
        # the last refresh: its rows 3 and 4 inputs are kept for (g2)'s
        # check of those launches against their plain versions
        grid, calls = record_interp_calls(
            lambda: refresh(self, occ_grid, step, jitter))
        refresh_calls[:] = calls
        return grid

    stages.MappingStage.finish = timed_finish
    nerfacto.NerfactoModel.refresh_occupancy = counted_refresh
    kernels = kernel_launches()
    for k in kernels.values():
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        mapping = pipeline.execute(args, device=dev, dataset=dataset)
        torch.cuda.synchronize()
    finally:
        stages.MappingStage.finish = finish
        nerfacto.NerfactoModel.refresh_occupancy = refresh
    wall = time.perf_counter() - t0
    counts = {name: k.launches for name, k in kernels.items()}
    (t_start, s_start), (t_end, s_end) = marks["start"], marks["end"]
    ms_step = (t_end - t_start) / max(s_end - s_start, 1) * 1e3
    grid = mapping.state.occ_grid
    occ = mapping.model.config.occupancy
    occupied = (grid > occ.occ_threshold).float().mean().item()
    n = mapping.num_inserted
    cov = mapping.buffer.depth_cov[:n]
    summ = {s: stage_summary(args.dir_result, s)[0]["total"]
            for s in ("data", "tracking", "enhancement", "mapping")}
    print(f"(g2) nerf_slam pipeline, {smi}: {N_FRAMES} frames, {n} "
          f"keyframes, {mapping.step_count} mapping steps "
          f"({s_start} while the stream ran); wall {wall:.2f} s, to the "
          f"end of finish() {t_end - t0:.2f} s; mapping "
          f"{ms_step:.2f} ms/step over the {s_end - s_start} steps of "
          f"finish(); stage totals (s) "
          f"{json.dumps({k: round(v, 3) for k, v in summ.items()})}",
          flush=True)
    print(f"(g2) occupancy: {len(refreshes)} refreshes, "
          f"{occupied * 100:.2f}% of {grid.numel()} cells above "
          f"{occ.occ_threshold}; buffer depth covariance "
          f"{cov.min().item():.4g}..{cov.max().item():.4g}; launches "
          f"{counts}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    for name in ("gather_cols", "gather_interp", "gather_interp_mm",
                 "scatter_cols_accum"):
        if not counts[name]:
            fail(f"the nerf_slam pipeline never launched {name}")
    for name in ("corr_two_level", "corr_level"):
        if counts[name]:
            fail(f"the nerf_slam pipeline launched {name}: the DPVO kernel")
    if mapping.step_count != iters or not refreshes:
        fail(f"the NGP mapper took {mapping.step_count} steps and "
             f"{len(refreshes)} refreshes")
    if not n or bool((cov == 1).all()):
        fail("the keyframe buffer's covariance channel is all 1")
    if not torch.isfinite(cov).all() or not torch.isfinite(grid).all():
        fail("non-finite covariance or occupancy grid")
    if not refresh_calls:
        fail("the last occupancy refresh launched no field kernel")
    print(f"(g2) the last occupancy refresh (step {refreshes[-1]}): "
          f"{len(refresh_calls)} table-kernel launches on its "
          f"{occupancy.slab_size(occ)}-cell slab, held against their plain "
          "versions on the same inputs:", flush=True)
    hold_interp_calls(refresh_calls, "an occupancy refresh's slab", "(g2)")
    pred = args.dir_prediction
    want = PREDICTION_FILES | {f"snapshots/{s}{iters:06d}.pt"
                               for s in ("trainstate", "snapshot")}
    if files_under(pred) != want:
        fail(f"prediction directory holds {sorted(files_under(pred))}")
    for name in sorted(want):
        if name.endswith(".json") and name.startswith("matrices/"):
            with open(f"{pred}/{name}") as f:
                check_rigid(name, json.load(f))
    return counts, mapping


def phase_slam_render(dev, smi, mapping):
    """(g3) ``MapRenderer`` on (g2)'s map at the first keyframe poses,
    through the occupancy grid; ms and launches per render."""
    from nerf_vo_tpu_torch.evaluation.nerf_renderer import MapRenderer
    from nerf_vo_tpu_torch.ops import occupancy

    renderer = MapRenderer(mapping)
    H, W = SLAM["frame_height"], SLAM["frame_width"]
    fx, fy, cx, cy = mapping.buffer.intrinsics[0].tolist()
    cam = dict(fx=fx, fy=fy, cx=cx, cy=cy, height=H, width=W)
    kernels = kernel_launches()
    lookups = []
    bin_weights = occupancy.bin_weights

    def counted(*a, **k):  # observer: counts the occupancy route
        lookups.append(1)
        return bin_weights(*a, **k)

    occupancy.bin_weights = counted
    torch.cuda.reset_peak_memory_stats()
    times = []
    try:
        renderer.render_frame(cam, renderer.get_camera_extrinsics(0))
        torch.cuda.synchronize()  # warm-up
        lookups.clear()
        for k in kernels.values():
            k.launches = 0
        for i in range(SLAM_RENDERS):
            t0 = time.perf_counter()
            color, depth = renderer.render_frame(
                cam, renderer.get_camera_extrinsics(i % mapping.num_inserted))
            times.append(time.perf_counter() - t0)
    finally:
        occupancy.bin_weights = bin_weights
    counts = {name: k.launches / SLAM_RENDERS for name, k in kernels.items()}
    ms = sum(times) / len(times) * 1e3
    print(f"(g3) MapRenderer through the occupancy grid, {smi}: "
          f"{SLAM_RENDERS} renders of {H}x{W}, {ms:.1f} ms a render with "
          f"its copy to the host ({H * W / ms * 1e3:.0f} rays/s), "
          f"{len(lookups) / SLAM_RENDERS:.0f} occupancy lookups and "
          f"launches {counts} a render; depth "
          f"{depth.min():.3f}..{depth.max():.3f}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    if not lookups:
        fail("the renders did not go through the occupancy grid")
    if not counts["gather_interp"] or not counts["gather_interp_mm"]:
        fail("the renders launched no field kernel")
    if counts["gather_cols"] or counts["scatter_cols_accum"]:
        fail("a render launched a gradient kernel")
    if color.shape != (H, W, 3) or not np.isfinite(depth).all():
        fail("the render is not a finite full frame")


def phase_slam(dev, smi):
    """Phase (g): (g1) DROID tracking alone, (g2) the nerf_slam pipeline,
    (g3) renders of its map. Returns (g2)'s launches."""
    phase_slam_tracking(dev, smi)
    gc.collect()
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_slam_")
    try:
        counts, mapping = phase_slam_pipeline(dev, smi, tmp)
        phase_slam_render(dev, smi, mapping)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return counts


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs only "
                         "on an NVIDIA GPU")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from nerf_vo_tpu_torch.ops import correlation_cuda, cuda_build, gather_cuda

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    reports = cuda_build.build_all(["corr", "gather"])
    log(f"kernels built in {time.perf_counter() - t0:.1f} s")
    for name, rep in reports.items():
        log(f"--- nvcc {name}:\n{rep}")

    kernels = phase_corr(dev) + phase_gather(dev)
    correlation_cuda.corr_level.launches = 0
    correlation_cuda.corr_two_level.launches = 0
    packets, frame_of, fps, updates = phase_tracking(dev)
    launches = correlation_cuda.corr_two_level.launches
    print(f"(b) corr_two_level launches on the main path: {launches} in "
          f"{updates} updates ({launches / max(updates, 1):.3f} per update); "
          f"one-level corr_level launches: "
          f"{correlation_cuda.corr_level.launches}", flush=True)
    if launches == 0:
        fail("the tracking path never launched the corr kernel")
    if launches > updates or correlation_cuda.corr_level.launches:
        fail("the tracking path made more than one corr launch per update")
    enhanced = phase_enhancement(dev, packets)
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
          " GiB", flush=True)

    torch.cuda.reset_peak_memory_stats()
    for k in gather_cuda.KERNELS:
        k.launches = 0
    phase_mapping(dev, enhanced, frame_of)
    counts = {k.__name__: k.launches for k in gather_cuda.KERNELS}
    print(f"(d) launches on the mapping path: {counts}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    for name, n in counts.items():
        if n == 0:
            fail(f"the mapping path never launched {name}")

    del packets, enhanced  # phases (b)-(d) hold nothing on the card now
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        counts, mapping, args = phase_pipeline(dev, smi, fps, tmp)
        print(f"(e) peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
              flush=True)
        torch.cuda.reset_peak_memory_stats()
        eval_counts, _ = phase_evaluation(dev, smi, mapping, args, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"(f) launches on the evaluation path: {eval_counts}; peak device "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
          flush=True)
    for name in ("gather_interp", "gather_interp_mm"):
        if not eval_counts[name]:
            fail(f"the evaluation path never launched {name}")
    for name in ("gather_cols", "scatter_cols_accum", "corr_two_level",
                 "corr_level"):
        if eval_counts[name]:
            fail(f"the evaluation path launched {name} "
                 f"{eval_counts[name]} times: a gradient or tracking")
    del mapping, args
    gc.collect()
    torch.cuda.empty_cache()
    slam_counts = phase_slam(dev, smi)
    for entry in kernels:  # the launches of the user's entry points
        entry["launches"] = counts[entry["name"]]
        entry["evaluation_launches"] = eval_counts[entry["name"]]
        entry["slam_launches"] = slam_counts[entry["name"]]

    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
