"""Drive the PyTorch port's nerf_vo and nerf_slam main paths on one NVIDIA
GPU and check them.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card, ``nvcc``
(``/usr/local/cuda``) and PyTorch built for CUDA. It builds every kernel of
the path from ``nerf_vo_tpu_torch/csrc/`` (into ``nerf_vo_tpu_torch/_build/``,
one ``nvcc`` per source, all started together), then runs ten phases
(in the order a-d, h, e-g, i, j); any failure ends the run with a non-zero
exit:

  (a) kernels: each kernel against its plain PyTorch version on the card at
      the replica configuration's shapes, with its time, the plain
      version's time, the least time the card could take and, where one
      PyTorch call computes the same function, that call's time; rows 2
      and 5 (``gather_cols``, ``scatter_cols_accum``) as the TPU had them,
      and as the paths run them, fused with their consumer and producer:
      the position pullback ``gather_cols_dfrac`` (row 2's gather with the
      contraction through the trilinear weights' derivatives, 8 corners a
      descriptor) and ``scatter_cols_outer`` (row 5 with the outer
      product, on the ids sorted by ``sort_ids``), each timed beside the
      chain it replaced (row 2, then the contraction and ``dfrac``; the
      materialized rows then row 5), the sort beside ``torch.sort``; and
      ``hash_descriptors``, every encode's descriptors in one launch,
      bitwise its plain chain and timed beside it, at the benchmark's four
      encodes (vo.map's field and two hash proposals, slam.map's field);
      and the interlevel loss's forward and backward kernels
      (``csrc/rendering.cu``) at vo.map's two proposal shapes, within the
      f32 summation bound of their terms, timed beside the plain [R, B, K]
      indicator contraction (launched on (h1)'s path only: the replica
      mapper's proposals distill); and the F = 8 table kernels at the
      sdf.map cell's grid (16 levels x 8 features, 2^22 entries a level,
      32 to 2048) and its three encodes (:func:`phase_sdf_kernels`; alone:
      ``python3 chip_smoke.py sdf-kernels``);
  (b) tracking: ``TrackingStage`` at the full replica configuration
      (DPVO fdim 128 / cdim 384, 96 patches, 32768 edge slots, 32-frame
      ring) on synthetic 360x640 frames, random weights from a seed;
  (c) enhancement: ``EnhancementStage`` with the full 12-block Omnidata
      DPT-hybrid at 384 on the packets of (b);
  (d) mapping: ``MappingStage`` at the replica configuration (192
      keyframes of 360x640, 4096 rays per step, full field and proposal
      grids, random weights from a seed) fed the enhanced packets of (c)
      with train steps interleaved as the serial pipeline does, 64 steps in
      all, then one full-frame render; the last step's calls of the fused
      adjoints held and timed, the field scatter's id runs per level
      printed; rows 2 and 5 with their plain row sink and source launch
      on no path (here or in any later phase);
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
      kernels and ``hash_descriptors`` may launch;
  (g) the nerf_slam pipeline at ``configs/nerf_slam_replica.yaml``'s full
      width (360x640, 192 keyframes, 48 factors, frontend window 25, global
      BA and covariances on): (g1) ``TrackingStage(droid-slam)`` alone on
      the synthetic frames, which must run both global BA passes with
      finite covariances; (g2) ``execute`` threaded with the same cuts as
      (e), which must launch each table kernel and never the correlation
      kernel, and fill the keyframe buffer's covariance channel; (g3)
      renders of (g2)'s map through ``MapRenderer`` and the occupancy grid;
  (h) the mapper's other configurations, each a ``MappingStage`` at the
      replica config with ``mapping_model_overrides`` (as ``run.py`` builds
      it) fed (c)'s packets as (d) feeds them, 64 steps: (h1) nerfstudio's
      mapper (hash proposals trained by the interlevel loss, per-sample
      normals), whose normal pullback must launch no table scatter, with
      rows 2-5 held and timed at the last step's F = 2 inputs of both
      proposals, and per level of each proposal's scatter its ids' runs,
      distinct ids and most descriptors on one id printed;
      (h2) bf16 dense proposal tables with phased table gradients under
      ``NERF_VO_PREFETCH_BATCH=1`` (the bf16-table ``gather_interp`` held
      and timed at both grids' inputs, bitwise against the f32 kernel; the
      phased backward's rows), then MLP proposals; (h3) a DROID frontend
      correlation pyramid under ``NERF_VO_CORR_PYRAMID_DTYPE=float32`` and
      under the bf16 default, one lookup on each;
  (i) the multi-device paths (``nerf_vo_tpu_torch/parallel/``), with ranks
      started by ``parallel.dist.spawn`` from the kernels built above:
      (i1) one NCCL rank, where ``make_dp_train_step`` and
      ``make_dp_tp_train_step`` (1 x 1) must equal the plain train step;
      (i2) four gloo ranks sharing ``cuda:0`` (NCCL refuses two ranks on
      one card), at the replica mapping width: DP(4), DP(2) over the
      2 x 2 mesh's data axis, DP2 x TP2 and descriptor-sharded 2 x 2 train
      steps on one batch, each held against the DP of the same rays a rank
      and each rank's launches of rows 2-5 counted; one table-sharded call
      of each of rows 2-5 from rank 0's real inputs held against its plain
      version and timed; a 360x640 ``MapRenderer(mesh=)`` render; the NGP
      mapper under DP2 x TP2 through a refresh; ``make_sharded_dense_ba``
      at DROID's frontend size and ``DROIDSLAMTracker(mesh=)``, each
      against one rank's. Times of ranks that share a card are no scaling
      figure;
  (j) the rest of the JAX package's behaviour: (j1) the upstream-checkpoint
      hooks: ``dpvo.pth`` and Omnidata depth / normal checkpoints written
      in the upstream layouts from seeded port nets, loaded by
      ``TrackingStage`` and ``EnhancementStage`` (12-block DPT-hybrid at
      384, depth and normals) through ``NERF_VO_DPVO_WEIGHTS`` /
      ``NERF_VO_OMNIDATA_{DEPTH,NORMAL}_WEIGHTS``: every parameter the
      file's tensor, then (b)'s first 16 frames and one packet's
      enhancement bit for bit as by stages given the same state dicts
      (deterministic algorithms on), and a 1-channel normal head refused;
      (j2) ``NERF_VO_PIXEL_DTYPE=float32`` in a child process
      (``chip_smoke.py pixel-f32 <dir>``; the knob is read at import):
      (d)'s 64 steps on (c)'s packets with an f32 buffer that holds the
      inserted rows exactly, rows 2-5 launched, held and timed, its ms a
      step beside (d)'s; an invalid value must fail the import; (j3) the
      port's parity harness (``nerf_vo_tpu_torch/parity.py``): (f)'s
      metrics as report rows with the hooks present, the ``DRY-RUN``
      stamp without them, and ``run_parity``'s exit code 2.

Output: progress on stderr; on stdout the card's name and power limit, the
per-phase results, one JSON line with every kernel's numbers (its
launches on the (e), (f), (g2), (h), (i) and (j) paths among them; the
bf16-table ``gather_interp``'s ``launches`` are (h2)'s, the only path with a
bf16 table), the whole run's seconds, and as the last line
``{"ok": true, "device": {...}}``. Without a CUDA device it exits
non-zero before printing any result.
"""

from __future__ import annotations

import contextlib
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
# forward (one per route, the surface pass's too), the surface-normal
# pullback (position only: one gather_cols_dfrac, no scatter) and the
# outer backward (the field's position gradient; both passes' table
# gradients, each with its sort)
ORDINARY_STEP_LAUNCHES = dict(gather_cols_dfrac=2, gather_interp=4,
                              gather_interp_mm=2, scatter_cols_outer=2,
                              sort_ids=2)
# rows 2-5 as the paths run them: rows 2 and 5 (gather_cols,
# scatter_cols_accum) through their fused instantiations, the position
# pullback and the table adjoint of row 3
TABLE_ROWS = ("gather_cols_dfrac", "gather_interp", "gather_interp_mm",
              "scatter_cols_outer")
# the table adjoint's sort: launched by scatter_cols_outer, once a call
SORT = "sort_ids"
# rows 2 and 5 with their plain row source and sink: held in phase (a),
# launched on no path
UNFUSED = ("gather_cols", "scatter_cols_accum")
# every encode's descriptors: captured inside a replayed step's graphs, so
# counted at eager steps and captures only
DESCRIPTORS = "hash_descriptors"
# the interlevel loss's kernel pair (csrc/rendering.cu): captured inside a
# replayed step's graphs, so counted at eager steps and captures only; on
# the paths whose proposals train by the interlevel loss ((h1))
INTERLEVEL = "interlevel_loss"
# (a)'s interlevel shapes: vo.map's rays, hash proposals 0 and 1's bins,
# its final bins
INTERLEVEL_SHAPES = ((RAYS, 256, FIELD_SAMPLES), (RAYS, 96, FIELD_SAMPLES))
# the encodes (a) makes descriptors for: vo.map's field and hash proposals
# 0 and 1, slam.map's field (grid, samples a ray; benchmark/configs)
DESCRIPTOR_ENCODES = (
    ("vo.map field", (16, 2, 19, 16, 2048), 48),
    ("vo.map proposal 0", (5, 2, 17, 16, 128), 256),
    ("vo.map proposal 1", (5, 2, 17, 16, 256), 96),
    ("slam.map field", (16, 2, 19, 16, 2048), 64),
)


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
    cotangent of the encoded features, the number of leading table rows
    the hash grid keeps on chip (level 0's 512 bricks), and the
    descriptors' base corners and offsets."""
    from nerf_vo_tpu_torch.ops import hash_grid as hg

    cfg = hg.HashGridConfig(3, 8, 19, 16, 2048)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    tab = torch.randn(3 * cfg.bricks_per_level, 256, generator=gen,
                      device=dev) * 0.5
    n = RAYS * FIELD_SAMPLES
    x = torch.rand(n, 3, generator=gen, device=dev)
    idx, local, frac, W, _ = hg._descriptors(x, cfg)
    cot = torch.randn(3 * n, 8, generator=gen, device=dev)
    return tab, idx, W, n, cot, hg._hot_rows(cfg), local, frac


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
                bound_by=bound_by, library_ms=library_ms, max_abs_err=err,
                queued_ms=queued_ms, cold_ms=cold_ms)


def kernel_launches():
    """Every counted kernel wrapper by name; each carries its launches in
    ``.launches``."""
    from nerf_vo_tpu_torch.ops import (correlation_cuda, gather_cuda,
                                       rendering_cuda)

    return {"corr_level": correlation_cuda.corr_level,
            "corr_two_level": correlation_cuda.corr_two_level,
            **{k.__name__: k for k in gather_cuda.KERNELS},
            DESCRIPTORS: gather_cuda.hash_descriptors,
            INTERLEVEL: rendering_cuda.interlevel_loss}


def reset_launches():
    """Set every counted kernel's launches to 0."""
    for k in kernel_launches().values():
        k.launches = 0


def read_launches():
    """Every counted kernel's launches by name."""
    return {name: k.launches for name, k in kernel_launches().items()}


# the correlation kernels: a path that runs no tracking launches neither
CORR_KERNELS = ("corr_level", "corr_two_level")


def check_close(name, got, want, rel):
    err = (got.float() - want.float()).abs().max().item()
    tol = rel * max(want.abs().max().item(), 1.0)
    if not np.isfinite(err) or err > tol:
        fail(f"{name} disagrees with its plain version: {err} > {tol}")
    return err


def check_sums(name, got, want, abs_sum, terms, tag):
    """Elementwise, a kernel's sums against the plain version's: |got -
    want| <= 2 gamma_(k+1) * sum |term|, the bound on the difference of two
    f32 sums of k products in any order (k = ``terms``, per element or
    one number; ``abs_sum`` = the plain function of the terms' absolute
    values). A kernel that drops, repeats or misplaces a term fails
    wherever the term exceeds that bound, whatever the values' scale.
    Prints the largest difference and its largest share of the bound."""
    eps = 2.0 ** -24
    k = torch.as_tensor(terms, dtype=torch.float32,
                        device=got.device) + 1
    bound = 2 * k * eps / (1 - k * eps) * abs_sum.float()
    diff = (got.float() - want.float()).abs()
    err = diff.max().item()
    share = (diff / bound.clamp_min(torch.finfo(torch.float32).tiny)).max()
    if not np.isfinite(err) or bool((diff > bound).any()):
        fail(f"{name} disagrees with its plain version: max abs err {err}, "
             f"{share.item():.3g} x its f32 summation bound")
    print(f"{tag} {name}: max |plain| {want.abs().max().item():.4g}, max "
          f"abs err {err:.3e}, {share.item():.3g} of the f32 summation "
          "bound at most", flush=True)
    return err


def check_unfused(counts, where):
    """Rows 2 and 5 with their plain row sink and source launch on no
    path: the hash grid's backward takes ``gather_cols_dfrac`` and
    ``scatter_cols_outer``; and the scatter sorts with ``sort_ids``, once a
    call."""
    for name in UNFUSED:
        if counts.get(name):
            fail(f"{where} launched {name} {counts[name]} times; the hash "
                 "grid's backward takes gather_cols_dfrac / "
                 "scatter_cols_outer")
    if counts.get(SORT, 0) != counts.get("scatter_cols_outer", 0):
        fail(f"{where} launched sort_ids {counts.get(SORT)} times for "
             f"{counts.get('scatter_cols_outer')} scatters")


def call_shape(name, a):
    """(M, F) of a recorded table-kernel call."""
    if name == "scatter_cols_outer":
        return a[0].shape[0], a[1].shape[1]
    if name == "gather_cols_dfrac":
        return a[1].shape[0], a[2].shape[1]
    if name in UNFUSED:
        return a[1].shape[0], a[0].shape[1] // 32
    return a[1].shape[0], a[3]


def corner_table_bytes(t, i, local, F):
    """Bytes of the table that the position pullback needs for these
    descriptors: of each touched brick, once, the 32-byte sectors that hold
    one of a descriptor's 8 cell corners (the entries with a non-zero
    weight or weight derivative)."""
    from nerf_vo_tpu_torch.ops import gather_cuda as gc

    i3 = torch.arange(3, device=local.device)
    ax = [((i3 == lo[:, None]) | (i3 == lo[:, None] + 1)).float()
          for lo in local.T]
    corners = torch.cat([gc.trilinear(*ax),
                         ax[0].new_zeros(local.shape[0], 5)], 1)
    live = live_groups(t, i, corners, F, 32)
    G = live.shape[1]
    flat = (i.long().clamp(0, t.shape[0] - 1)[:, None] * G
            + torch.arange(G, device=i.device)[None, :])
    touched = torch.zeros(t.shape[0] * G, dtype=torch.bool, device=i.device)
    touched[flat[live]] = True
    return int(touched.sum()) * 32


def dfrac_abs_sum(t, i, c, local, frac, first, res):
    """The position pullback of the terms' absolute values: |bf16(v)| |c|
    w w |w'| res summed as the function sums its terms (the scale of
    check_sums' bound)."""
    from nerf_vo_tpu_torch.ops import gather_cuda as gc

    d = gc.gather_cols_dot_plain(t.abs(), i, c.abs())[:, :27].reshape(
        -1, 3, 3, 3)
    w = [gc.axis_weights(local[:, a], frac[:, a]) for a in range(3)]
    dw = [gc.axis_dweights(local[:, a]).abs() for a in range(3)]
    scale = torch.tensor(res, dtype=torch.float32, device=t.device)[
        gc.id_levels(i, first)]
    return torch.stack([
        torch.einsum("mijk,mi,mj,mk->m", d, dw[0], w[1], w[2]),
        torch.einsum("mijk,mi,mj,mk->m", d, w[0], dw[1], w[2]),
        torch.einsum("mijk,mi,mj,mk->m", d, w[0], w[1], dw[2]),
    ], dim=-1) * scale[:, None]


def sort_timing(i, nb, label, tag):
    """``sort_ids`` on a scatter's ids: exactly its plain version (keys and
    positions), timed as phase (a) times a kernel, beside ``torch.sort``
    of the same ids (its library call; the plain version maps ids out of
    range first). Bound: the ids read, the keys and positions written."""
    from nerf_vo_tpu_torch.ops import gather_cuda as gc

    m = i.shape[0]
    keys, perm = gc.sort_ids(i, nb)
    want_k, want_p = gc.sort_ids_plain(i, nb)
    torch.cuda.synchronize()
    if not (torch.equal(keys, want_k) and torch.equal(perm, want_p)):
        fail(f"sort_ids at {label} differs from its plain version")
    return time_kernel(
        f"sort_ids at {label}: M={m} ids of {nb} bricks",
        lambda: gc.sort_ids(i, nb), lambda: gc.sort_ids_plain(i, nb),
        lambda: torch.sort(i, stable=True), 12 * m, 0, 0.0, tag=tag)


def adjoint_timing(name, a, label, tag):
    """One fused adjoint on its inputs: held elementwise within the f32
    summation bound of its terms against its plain version, timed as phase
    (a) times a kernel, and the chain it replaced on the same inputs timed
    in the same call: for ``gather_cols_dfrac`` row 2, then the cast,
    product and sum into dW, ``dfrac`` and the resolution's product; for
    ``scatter_cols_outer`` the materialized W (x) cot rows then row 5 (its
    sort included), and its ids' sort (:func:`sort_timing`, under
    ``sort``). Returns the timing."""
    from nerf_vo_tpu_torch.ops import gather_cuda as gc

    kernel = getattr(gc, name)
    got = kernel(*a)
    torch.cuda.synchronize()
    extra = {}
    if name == "gather_cols_dfrac":
        t, i, c, local, frac, first, res = a
        m, F = c.shape
        again = kernel(*a)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            fail(f"{name} at {label} gave other bits on a second call")
        err = check_sums(f"{name} at {label}", got,
                         gc.gather_cols_dfrac_plain(*a),
                         dfrac_abs_sum(*a), F + 12, tag)
        scale = torch.tensor(res, dtype=torch.float32, device=t.device)[
            gc.id_levels(i, first)][:, None]

        def chain():
            g = gc.gather_cols(t, i).float().reshape(m, 32, F)
            dW = torch.sum(g * c[:, None, :], dim=-1)
            return gc.dfrac(dW, local, frac) * scale

        nbytes = corner_table_bytes(t, i, local, F) + m * (4 + 4 * F + 24
                                                           + 12 + 12)
        flops = m * (8 * 2 * F + 40)
        what = f"M={m} F={F} over {t.shape[0]} bricks"
    else:
        W, c, i, nb = a[:4]
        m, F = c.shape
        il = i.long()
        live = (il >= 0) & (il < nb)
        terms = torch.zeros(nb, device=W.device).index_add_(
            0, il[live], torch.ones(int(live.sum()), device=W.device))
        again = kernel(*a)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            fail(f"{name} at {label} gave other bits on a second call")
        err = check_sums(f"{name} at {label}", got,
                         gc.scatter_cols_outer_plain(W, c, i, nb),
                         gc.scatter_cols_outer_plain(W.abs(), c.abs(), i,
                                                     nb),
                         terms[:, None], tag)

        def chain():
            rows = (W[:, :, None] * c[:, None, :]).reshape(m, 32 * F)
            return gc.scatter_cols_accum(rows, i, nb)

        nbytes = m * (32 * 4 + 4 * F + 4) + nb * 32 * F * 4
        flops = 2 * m * 32 * F
        what = f"M={m} F={F} into {nb} bricks"
        extra["sort"] = sort_timing(i, nb, label, tag)
    timing = time_kernel(f"{name} at {label}: {what}",
                         lambda: kernel(*a), lambda: getattr(
                             gc, f"{name}_plain")(*a), None, nbytes, flops,
                         err, tag=tag)
    chain_ms = cuda_ms(chain, 20)
    chain_queued = cuda_ms(chain, 20, queued=True)
    print(f"{tag} the chain {name} replaces, same inputs: {chain_ms:.4f} "
          f"ms, queued {chain_queued:.4f} ms; the kernel "
          f"{timing['ms']:.4f} ms ({timing['ms'] / chain_ms:.1%} of the "
          "chain's time)", flush=True)
    return dict(timing, chain_ms=chain_ms, chain_queued_ms=chain_queued,
                **extra)


def stress_checks(tab, hot):
    """gather_interp_mm and scatter_cols_accum against their plain versions
    on adversarial ids: every id on one brick (inside and beyond
    gather_interp_mm's hot rows), ids out of range (the plain reference
    drops them), ids on both sides of the hot-row boundary; non-zero
    padding weights (entries 27..31) throughout. Same tolerances as the
    main checks."""
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
        got_s = gc.scatter_cols_accum(rows, i, n_bricks)
        torch.cuda.synchronize()
        e1 = check_close(f"gather_interp_mm ({name})", got, want, 1e-5)
        e2 = check_close(f"scatter_cols_accum ({name})", got_s, want_s, 1e-5)
        print(f"(a) stress, {name}: gather_interp_mm err {e1:.3e}, "
              f"scatter_cols_accum err {e2:.3e}", flush=True)


def live_groups(t, i, w, F, group_bytes):
    """[m, 32F*size / group_bytes] bool: the groups of ``group_bytes`` bytes
    of each descriptor's table row that hold an entry with a non-zero
    weight (none for an id out of range)."""
    per = group_bytes // (t.element_size() * F)  # entries in a group
    ok = ((i >= 0) & (i < t.shape[0]))[:, None]
    return ((w != 0) & ok).reshape(i.shape[0], 32 // per, per).any(-1)


def interp_table_bytes(t, i, w, F):
    """Bytes of the table that gather_interp's function needs for these
    descriptors: of each touched brick, once, the 32-byte sectors (at F = 1
    the groups of 4 entries, 16 bytes in f32 and 8 in bf16) that hold an
    entry with a non-zero weight in some descriptor. Zero-weight entries,
    the padding entries 27..31 among them, are not needed."""
    group = 4 * t.element_size() if F == 1 else 32
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
    max(|plain|, 1) (f32 sums in another order). gather_interp_mm is timed
    with the hash grid's hot rows (level 0 kept on chip) and, for
    comparison, with none."""
    import torch.nn.functional as Fn

    from nerf_vo_tpu_torch.ops import gather_cuda as gc
    from nerf_vo_tpu_torch.ops import hash_grid as hg

    tab, idx, W, n, cot, hot, local, frac = gather_inputs(dev)
    M, R = idx.shape[0], tab.shape[1]
    src = "nerf_vo_tpu_torch/csrc/gather.cu"
    pallas = "nerf_vo_tpu/ops/gather_pallas.py"
    out = []

    # 2: gather_cols, every level (held here: the paths take its
    # gather_cols_dfrac instantiation)
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

    # 5: scatter_cols_accum, the table gradient of every level (held
    # here: the paths take its scatter_cols_outer instantiation), sorted,
    # the same bits every call
    rows = (W[:, :, None] * cot[:, None, :]).reshape(M, R)
    nb = tab.shape[0]
    got = gc.scatter_cols_accum(rows, idx, nb)
    again = gc.scatter_cols_accum(rows, idx, nb)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        fail("scatter_cols_accum gave other bits on a second call")
    err = check_close("scatter_cols_accum", got,
                      gc.scatter_cols_accum_plain(rows, idx, nb), 1e-5)
    acc = torch.zeros_like(tab)
    out.append(dict(name="scatter_cols_accum", route="cuda", source=src,
                    replaces=f"{pallas}:297", launches=None,
                    **time_kernel(
                        f"scatter_cols_accum M={M} R={R} into {nb} bricks",
                        lambda: gc.scatter_cols_accum(rows, idx, nb),
                        lambda: gc.scatter_cols_accum_plain(rows, idx, nb),
                        lambda: acc.index_add_(0, idx_l, rows),
                        M * R * 4 + M * 4 + tab.numel() * 4, M * R, err)))

    # rows 2 and 5 as the paths run them: the position pullback and the
    # table adjoint of row 3 over every level of the field, the contraction
    # or the product in registers, each beside the chain it replaced, and
    # the scatter's sort
    cfg = hg.HashGridConfig(3, 8, 19, 16, 2048)
    levels = ([l * cfg.bricks_per_level for l in range(3)],
              cfg.resolutions)
    out.append(dict(name="gather_cols_dfrac", route="cuda", source=src,
                    replaces=f"{pallas}:79", launches=None,
                    **adjoint_timing("gather_cols_dfrac",
                                     (tab, idx, cot, local, frac, *levels),
                                     "the field shape", "(a)")))
    outer = adjoint_timing("scatter_cols_outer", (W, cot, idx, nb),
                           "the field shape", "(a)")
    out.append(dict(name="scatter_cols_outer", route="cuda", source=src,
                    replaces=f"{pallas}:297", launches=None,
                    **{k: v for k, v in outer.items() if k != "sort"}))
    out.append(dict(name=SORT, route="cuda", source=src,
                    replaces=f"{pallas}:297", launches=None,
                    **outer["sort"]))

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


def phase_descriptors(dev):
    """``hash_descriptors`` at the benchmark's encodes (4096 rays, points
    uniform in the cube): its five tensors bitwise the plain chain's on the
    same card, the kernel timed as the other rows are, its bound the bytes
    it must move (x read once; 168 bytes written a descriptor, 3 a point),
    and the plain chain timed back to back, queued and cold."""
    from nerf_vo_tpu_torch.ops import gather_cuda as gc
    from nerf_vo_tpu_torch.ops import hash_grid as hg

    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    out = []
    for label, grid, samples in DESCRIPTOR_ENCODES:
        cfg = hg.HashGridConfig(*grid)
        n, L = RAYS * samples, cfg.n_levels
        x = torch.rand(n, 3, generator=gen, device=dev)
        args = (x, cfg.resolutions, cfg.bricks_per_level)
        got = gc.hash_descriptors(*args)
        want = gc.hash_descriptors_plain(*args)
        for name, a, b in zip(("idx", "local", "frac", "W", "inside"), got,
                              want):
            if a.dtype == torch.float32:
                a, b = a.view(torch.int32), b.view(torch.int32)
            if a.dtype != b.dtype or not torch.equal(a, b):
                fail(f"hash_descriptors ({label}): {name} differs from the "
                     "plain chain's")
        del got, want
        nbytes = n * 12 + L * n * (4 + 24 + 12 + 128) + n * 3
        timing = time_kernel(
            f"hash_descriptors {label} N={n} L={L} (M={L * n})",
            lambda: gc.hash_descriptors(*args),
            lambda: gc.hash_descriptors_plain(*args), None, nbytes, 0, 0.0)
        plain_queued = cuda_ms(lambda: gc.hash_descriptors_plain(*args), 3,
                               queued=True)
        plain_cold = cuda_ms_cold(lambda: gc.hash_descriptors_plain(*args), 3)
        print(f"(a) hash_descriptors {label}: bitwise the plain chain; "
              f"plain chain queued {plain_queued:.4f} ms, cold "
              f"{plain_cold:.4f} ms; {nbytes / 1e6:.1f} MB moved", flush=True)
        out.append(dict(name=DESCRIPTORS, route="cuda",
                        source="nerf_vo_tpu_torch/csrc/gather.cu",
                        replaces="nerf_vo_tpu_torch/ops/hash_grid.py "
                        "_descriptors' plain chain", launches=None,
                        shape=label, M=L * n, plain_queued_ms=plain_queued,
                        plain_cold_ms=plain_cold, **timing))
        del x, args
        torch.cuda.empty_cache()
    return out


# (a)'s sdf.map shapes: Neuralangelo's grid and the cell's encodes (points
# a ray: the final samples and their four taps, the stratified samples, an
# up-sampling round's new samples; benchmark/configs/neuralangelo_replica)
SDF_GRID = (16, 8, 22, 32, 2048)
SDF_ENCODES = (("sdf.map final + taps", 128 * 5), ("sdf.map stratified", 64),
               ("sdf.map round", 16))
SDF_HELD = 500_000  # descriptors of a large call held against plain
SDF_BLOCK = 1 << 22  # descriptors of a block of 5o's plain version


def sdf_timed(name, fn, nbytes, flops, err):
    """:func:`time_kernel`'s readings of one call, without a plain
    version's time (the plain versions of (a)'s sdf.map calls are held on
    slices, not timed)."""
    ms = cuda_ms(fn, 20)
    queued_ms = cuda_ms(fn, 20, queued=True)
    cold_ms = cuda_ms_cold(fn, 20)
    bound_ms, bound_by = bound(nbytes, flops)
    print(f"(a) {name}: kernel {ms:.4f} ms, queued {queued_ms:.4f} ms, cold "
          f"{cold_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}): "
          f"{bound_ms / queued_ms:.1%} of it queued, "
          f"{bound_ms / cold_ms:.1%} cold", flush=True)
    return dict(ms=ms, queued_ms=queued_ms, cold_ms=cold_ms,
                bound_ms=bound_ms, bound_by=bound_by, max_abs_err=err)


def phase_sdf_kernels(dev):
    """Rows D, 3, 2d and 5o at the sdf.map cell's F = 8 grid (no level of
    it is on the one-hot route, so row 4 does not run there) and its three
    encodes of 4096 rays (points uniform in the cube), timed as the other
    rows are. Held: the descriptors bitwise the plain chain on the first
    and the last ``SDF_HELD`` points; rows 3 and 2d within the f32
    summation bound on the first and the last ``SDF_HELD`` descriptors
    (each descriptor's output is its own; the final encode's last ones
    pass 2^31 elements of their rows); row 5o within its bound over every
    descriptor, against its plain version summed over blocks of
    ``SDF_BLOCK`` descriptors (its [M, 256] rows do not fit at once at the
    final encode's M = 42M), and bitwise the same over two calls. Returns
    the timings."""
    from nerf_vo_tpu_torch.ops import gather_cuda as gc
    from nerf_vo_tpu_torch.ops import hash_grid as hg

    cfg = hg.HashGridConfig(*SDF_GRID)
    L, NB, F = cfg.n_levels, cfg.bricks_per_level, cfg.features_per_level
    res, first = cfg.resolutions, [l * NB for l in range(L)]
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    tab = torch.randn(L * NB, 32 * F, generator=gen, device=dev) * 1e-2
    out = []
    for label, per_ray in SDF_ENCODES:
        n = RAYS * per_ray
        x = torch.rand(n, 3, generator=gen, device=dev)
        desc = gc.hash_descriptors(x, res, NB)
        idx, local, frac, W, _ = desc
        M = idx.shape[0]
        k = min(SDF_HELD, n)
        for s_ in (slice(0, k), slice(n - k, n)):
            part = gc.hash_descriptors_plain(x[s_], res, NB)
            for name, a, b in zip(("idx", "local", "frac", "W"), desc, part):
                a = a.reshape(L, n, *a.shape[1:])[:, s_].reshape(b.shape)
                if a.dtype == torch.float32:
                    a, b = a.view(torch.int32), b.view(torch.int32)
                if a.dtype != b.dtype or not torch.equal(a, b):
                    fail(f"hash_descriptors ({label}) [{s_.start}:"
                         f"{s_.stop}]: {name} differs from the plain chain's")
            del part
        row = dict(shape=label, M=M, N=n)
        nbytes = n * 12 + M * (4 + 24 + 12 + 128) + n * 3
        row["D"] = sdf_timed(
            f"hash_descriptors {label} N={n} L={L} (M={M})",
            lambda: gc.hash_descriptors(x, res, NB),
            nbytes, 0, 0.0)
        cot = torch.randn(M, F, generator=gen, device=dev)
        ends = [slice(0, min(SDF_HELD, M)), slice(max(M - SDF_HELD, 0), M)]
        got = gc.gather_interp(tab, idx, W, F)
        for s_ in ends:
            check_sums(f"gather_interp {label} [{s_.start}:{s_.stop}]",
                       got[s_], gc.gather_interp_plain(tab, idx[s_], W[s_],
                                                       F),
                       gc.gather_interp_plain(tab.abs(), idx[s_],
                                              W[s_].abs(), F), 32, "(a)")
        del got
        row["3"] = sdf_timed(
            f"gather_interp {label}: M={M} F={F} over {L * NB} bricks",
            lambda: gc.gather_interp(tab, idx, W, F),
            interp_table_bytes(tab, idx, W, F) + M * (4 + 128 + 4 * F),
            2 * M * 32 * F, 0.0)
        a = (tab, idx, cot, local, frac, first, res)
        got = gc.gather_cols_dfrac(*a)
        if not torch.equal(got, gc.gather_cols_dfrac(*a)):
            fail(f"gather_cols_dfrac ({label}) gave other bits on a second "
                 "call")
        for s_ in ends:
            sub = (tab, idx[s_], cot[s_], local[s_], frac[s_], first, res)
            check_sums(f"gather_cols_dfrac {label} [{s_.start}:{s_.stop}]",
                       got[s_], gc.gather_cols_dfrac_plain(*sub),
                       dfrac_abs_sum(*sub), F + 12, "(a)")
        del got
        row["2d"] = sdf_timed(
            f"gather_cols_dfrac {label}: M={M} F={F}",
            lambda: gc.gather_cols_dfrac(*a),
            corner_table_bytes(tab, idx, local, F)
            + M * (4 + 4 * F + 24 + 12 + 12), M * (8 * 2 * F + 40), 0.0)
        nb = L * NB
        got = gc.scatter_cols_outer(W, cot, idx, nb)
        if not torch.equal(got, gc.scatter_cols_outer(W, cot, idx, nb)):
            fail(f"scatter_cols_outer ({label}) gave other bits on a second "
                 "call")
        want, abs_sum = torch.zeros_like(got), torch.zeros_like(got)
        for b0 in range(0, M, SDF_BLOCK):
            s_ = slice(b0, b0 + SDF_BLOCK)
            want += gc.scatter_cols_outer_plain(W[s_], cot[s_], idx[s_], nb)
            abs_sum += gc.scatter_cols_outer_plain(W[s_].abs(),
                                                   cot[s_].abs(), idx[s_], nb)
        terms = torch.zeros(nb, device=dev).index_add_(
            0, idx.long(), torch.ones(M, device=dev))
        check_sums(f"scatter_cols_outer {label}", got, want, abs_sum,
                   terms[:, None], "(a)")
        del got, want, abs_sum, terms
        row["5o"] = sdf_timed(
            f"scatter_cols_outer {label}: M={M} F={F} into {nb} bricks",
            lambda: gc.scatter_cols_outer(W, cot, idx, nb),
            M * (32 * 4 + 4 * F + 4) + nb * 32 * F * 4,
            2 * M * 32 * F, 0.0)
        row["5s"] = cuda_ms(lambda: gc.sort_ids(idx, nb), 20, queued=True)
        print(f"(a) sort_ids {label}: M={M} queued {row['5s']:.4f} ms",
              flush=True)
        out.append(row)
        del x, desc, idx, local, frac, W, cot, a
        torch.cuda.empty_cache()
    print(json.dumps({"sdf_kernels": out}), flush=True)
    return out


def interlevel_inputs(dev, R, B, K, gen):
    """A proposal histogram on jittered uniform bins and a final one
    resampled from it (monotone through cummax), as the mapper makes them."""
    from nerf_vo_tpu_torch.ops import rendering as rd

    pe = rd.uniform_bins(R, B, torch.rand(R, B + 1, generator=gen,
                                          device=dev))
    pw = torch.rand(R, B, generator=gen, device=dev) ** 4
    pw = pw / pw.sum(-1, keepdim=True)
    fe = rd.sample_pdf(pe, pw, K, torch.rand(R, K + 1, generator=gen,
                                             device=dev))
    fw = torch.rand(R, K, generator=gen, device=dev) ** 4
    fw = 0.9 * fw / fw.sum(-1, keepdim=True)
    return pe.contiguous(), pw.contiguous(), fe.contiguous(), fw.contiguous()


def phase_interlevel(dev):
    """The interlevel loss's kernels at vo.map's two proposal shapes (4096
    rays; 256 and 96 proposal bins; 48 final bins): the forward's clamped
    gaps against the plain contraction's and its loss, and the backward's
    ``d pw`` against the plain contractions of the same per-bin
    derivatives, each within the f32 summation bound of its terms; each
    kernel timed as the other rows are, beside the plain chain (the
    [R, B, K] compares, casts and GEMMs; with autograd's backward for the
    whole loss). Bounds: the forward reads pe, pw, fe, fw once and writes
    the [R] partial; the backward reads pe, fe, fw, the clamped gaps and
    the partial's gradient and writes d pw; each makes 2 B K
    compare-and-adds a ray, counted as 4 B K operations."""
    from nerf_vo_tpu_torch.ops import rendering as rd
    from nerf_vo_tpu_torch.ops import rendering_cuda as rc

    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    out = []
    for R, B, K in INTERLEVEL_SHAPES:
        label = f"R={R} B={B} K={K}"
        pe, pw, fe, fw = interlevel_inputs(dev, R, B, K, gen)
        part, clipped = rc._forward(pe, pw, fe, fw)
        left = (pe[:, 1:, None] <= fe[:, None, :-1]).float()
        right = (pe[:, :-1, None] < fe[:, None, 1:]).float()
        fwc = fw.clamp(min=1e-7)
        want = (fw - rd._outer_bounds(fe, pe, pw)).clamp(min=0.0)
        err = check_sums(f"interlevel clamped gaps {label}", clipped, want,
                         fw.abs() + torch.einsum("rb,rbk->rk", pw.abs(),
                                                 left + right), B + 2, "(a)")
        terms = clipped ** 2 / fwc
        check_sums(f"interlevel loss {label}", torch.sum(part) / (R * K),
                   torch.mean(terms), terms.sum() / (R * K), R * K, "(a)")
        gpart = torch.full((R,), 1.0 / (R * K), device=dev)
        dpw = rc._backward(pe, fe, fw, clipped, gpart)
        g = -((gpart[:, None] / fwc) * (2.0 * clipped))
        err = max(err, check_sums(
            f"interlevel d pw {label}", dpw,
            torch.einsum("rk,rbk->rb", g, right)
            - torch.einsum("rk,rbk->rb", g, left),
            torch.einsum("rk,rbk->rb", g.abs(), left + right), K + 1, "(a)"))
        del left, right, want, terms, g
        in_bytes = 4 * (pe.numel() + pw.numel() + fe.numel() + fw.numel())
        fwd = time_kernel(
            f"interlevel_fwd {label}", lambda: rc._forward(pe, pw, fe, fw),
            lambda: rd.interlevel_loss_plain(pe, pw, fe, fw), None,
            in_bytes + 4 * R, 4 * R * B * K, err)
        w0 = pw.clone().requires_grad_(True)
        plain_loss = rd.interlevel_loss_plain(pe, w0, fe, fw)
        bwd = time_kernel(
            f"interlevel_bwd {label}",
            lambda: rc._backward(pe, fe, fw, clipped, gpart),
            lambda: torch.autograd.grad(plain_loss, w0, retain_graph=True),
            None,
            4 * (pe.numel() + fe.numel() + fw.numel() + clipped.numel()
                 + R + pw.numel()), 4 * R * B * K, err)
        w = pw.clone().requires_grad_(True)

        def whole(fn):
            return lambda: torch.autograd.grad(fn(pe, w, fe, fw), w)
        both = time_kernel(
            f"interlevel loss and d pw {label}", whole(rc.interlevel_loss),
            whole(rd.interlevel_loss_plain), None,
            in_bytes + 4 * R + 4 * pw.numel(), 8 * R * B * K, err)
        print(f"(a) interlevel {label}: kernels forward {fwd['ms']:.4f} + "
              f"backward {bwd['ms']:.4f} ms (queued {fwd['queued_ms']:.4f} "
              f"+ {bwd['queued_ms']:.4f}, cold {fwd['cold_ms']:.4f} + "
              f"{bwd['cold_ms']:.4f}); the loss and its gradient "
              f"{both['ms']:.4f} ms against the plain chain's "
              f"{both['plain_ms']:.4f} ms", flush=True)
        out.append(dict(name=INTERLEVEL, route="cuda",
                        source="nerf_vo_tpu_torch/csrc/rendering.cu",
                        replaces="nerf_vo_tpu_torch/ops/rendering.py "
                        "_outer_bounds' [R, B, K] indicator contraction",
                        launches=None, shape=label, backward=bwd,
                        whole=both, **fwd))
        del pe, pw, fe, fw, part, clipped, dpw, w, w0, plain_loss
        torch.cuda.empty_cache()
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


def drive_mapping(stage, enhanced, frame_of, record=()):
    """The serial pipeline's order: a packet is inserted at the frame that
    produced it, then up to STEPS_PER_FRAME paced train steps follow each
    frame; after the last frame the stream ends (as ``finish`` does) and
    training runs on to MAP_STEPS steps. ``record``: the ``gather_cuda``
    wrappers whose calls in the last step are recorded (``record_calls``).
    Returns the steps' metrics and times, the most table-kernel launches
    seen in one ordinary step (no proposal refresh), and the calls."""
    from nerf_vo_tpu_torch.ops import gather_cuda

    at = dict(zip(frame_of, enhanced))
    history, times, calls = [], [], []
    per_step = {k.__name__: 0 for k in gather_cuda.KERNELS}
    def step():
        refresh = stage.trainer.refreshes_proposals(stage.state)
        before = {k.__name__: k.launches for k in gather_cuda.KERNELS}
        t0 = time.perf_counter()
        if record and len(history) == MAP_STEPS - 1:
            m, rec = record_calls(stage.train_step, record)
            calls.extend(rec)
        else:
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
    return history, times, per_step, calls


# the field grid's levels (configs/nerf_vo_replica.yaml: 3 x 8, log2 19,
# 16 -> 2048)
FIELD_LEVELS = 3
ADJOINTS = ("gather_cols_dfrac", "scatter_cols_outer")


def phase_mapping(dev, enhanced, frame_of):
    """``MappingStage`` at the replica config, driven by
    :func:`drive_mapping`, then one full-frame render. The last step's
    calls of the two fused adjoints are recorded; after the render the id
    runs of each field scatter are printed per level and every recorded
    call is held against its plain version and timed beside the chain it
    replaced. Returns the steady ms a step and the held calls."""
    from nerf_vo_tpu_torch.runtime.stages import MappingStage

    args = SimpleNamespace(**REPLICA, **MAPPING)
    stage = MappingStage(args, device=dev)
    history, times, per_step, calls = drive_mapping(stage, enhanced,
                                                    frame_of, ADJOINTS)
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
    del stage
    for name, a, _ in calls:
        if name == "scatter_cols_outer" and a[1].shape[1] == 8:
            print_id_runs(a[2], FIELD_LEVELS, f"(d) the field scatter at "
                          f"M={a[2].shape[0]}")
    print(f"(d) the last step's {len(calls)} launches of the fused "
          "adjoints, held against their plain versions on the same "
          "inputs:", flush=True)
    return ms, hold_calls(calls, "the mapping step's last step", "(d)")


# ---------------------------------------------------------------------------
# (h) the mapper's other configurations, on (c)'s packets
# ---------------------------------------------------------------------------

# (h1): nerfstudio's mapper, the reference's own: hash proposals trained by
# the interlevel loss, density-gradient normals at every sample
NERFSTUDIO = dict(proposal_type="hash", proposal_training="interlevel",
                  grad_normal_mode="samples")
# (h2): bf16 dense proposal tables and phased field table gradients, run
# with NERF_VO_PREFETCH_BATCH=1; then MLP proposals
BF16_PHASED = dict(proposal_table_dtype="bfloat16", table_grad_phase=True)
MLP_PROPOSALS = dict(proposal_type="mlp")
# table-kernel launches of one (h1) step: the forward (the field and each
# hash proposal: level 0 on the one-hot route, the rest gathered), the
# per-sample normal pullback (one gather_cols_dfrac, no scatter: it takes
# the position gradient only) and the backward (the field and both
# proposals: one scatter_cols_outer with its sort and one gather_cols_dfrac
# each)
H1_STEP_LAUNCHES = dict(gather_cols_dfrac=4, gather_interp=3,
                        gather_interp_mm=3, scatter_cols_outer=3,
                        sort_ids=3)
# the kernel only a bf16 proposal table launches: no other phase's path has
# one
BF16_KERNELS = ("gather_interp_bf16",)


def run_variant(dev, smi, tag, overrides, enhanced, frame_of, record=(),
                env=None):
    """``MappingStage`` at the replica config plus ``overrides`` as
    ``mapping_model_overrides`` (the route ``run.py`` takes), built with
    ``env`` set, and driven by :func:`drive_mapping` with the launch counts
    and the peak memory set to 0 just before. Returns the stage, the steps'
    metrics, the launches in all and per ordinary step, and the last
    step's recorded calls."""
    from nerf_vo_tpu_torch.runtime.stages import MappingStage

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    args = SimpleNamespace(**REPLICA, **MAPPING,
                           mapping_model_overrides=dict(overrides))
    saved = {k: os.environ.get(k) for k in env or {}}
    os.environ.update(env or {})
    try:
        stage = MappingStage(args, device=dev)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v
    reset_launches()
    history, times, per_step, calls = drive_mapping(stage, enhanced,
                                                    frame_of, record)
    counts = read_launches()
    for name in CORR_KERNELS:
        if counts[name]:
            fail(f"({tag}) the mapping path launched {name}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    steady = times[8:]
    ms = sum(steady) / len(steady) * 1e3
    last = {k: round(v, 6) for k, v in history[-1].items()}
    print(f"({tag}) mapping_model_overrides {overrides}"
          f"{' with ' + str(env) if env else ''}: {len(history)} steps of "
          f"{RAYS} rays, steady {ms:.2f} ms/step ({RAYS / ms * 1e3:.0f} "
          f"rays/s) over steps 8..{len(history) - 1}, first step "
          f"{times[0] * 1e3:.1f} ms; launches {counts}, per ordinary step "
          f"(most seen) {per_step}; last step's losses {last}; peak device "
          f"memory {peak:.2f} GiB; {smi}", flush=True)
    return stage, history, counts, per_step, calls


def phase_variants(dev, smi, enhanced, frame_of):
    """(h1) nerfstudio's mapper and (h2) the other mapping options, on
    (c)'s packets as (d) feeds them, 64 steps each; rows 2-5 held at (h1)'s
    F = 2 proposal inputs and the bf16 ``gather_interp`` at (h2)'s, against
    their plain versions, and timed. Returns each kernel's (h1) / (h2)
    launches and (h)'s timings by kernel name."""
    # (h1)
    stage, history, counts, per_step, calls = run_variant(
        dev, smi, "h1", NERFSTUDIO, enhanced, frame_of, record=TABLE_ROWS)
    if any(not np.isfinite(v) for h in history for v in h.values()):
        fail("(h1) non-finite losses")
    if "interlevel_loss" not in history[-1]:
        fail("(h1) the loss has no interlevel term")
    if not counts[INTERLEVEL]:
        fail("(h1) the interlevel loss never launched its kernels")
    for name in TABLE_ROWS + (DESCRIPTORS,):
        if not counts[name]:
            fail(f"(h1) nerfstudio's mapper never launched {name}")
    for name, most in H1_STEP_LAUNCHES.items():
        if per_step[name] > most:
            fail(f"(h1) {name} launched {per_step[name]} times in one step "
                 f"(at most {most}: the normal pullback makes no table "
                 "gradient)")
    if counts["gather_interp_bf16"]:
        fail("(h1) f32 tables launched the bf16-table kernel")
    check_unfused(counts, "(h1)")
    f2 = [c for c in calls if call_shape(c[0], c[1])[1] == 2]
    for name, a, _ in f2:
        if name == "scatter_cols_outer":
            print_id_runs(a[2], PROPOSAL_LEVELS,
                          f"(h1) the scatter at M={a[2].shape[0]}")
    print(f"(h1) the last step's {len(f2)} table-kernel launches at the "
          "hash proposals' F = 2 (of its "
          f"{len(calls)}), held against their plain versions on the same "
          "inputs:", flush=True)
    held = {"h1": hold_calls(f2, "the hash proposals' last step", "(h1)")}
    launches = {"h1": counts}
    del stage, calls, f2

    # (h2) bf16 proposal tables, phased table gradients, prefetch
    stage, history, counts, per_step, calls = run_variant(
        dev, smi, "h2", BF16_PHASED, enhanced, frame_of,
        record=BF16_KERNELS + ("scatter_cols_outer",),
        env={"NERF_VO_PREFETCH_BATCH": "1"})
    if not stage.trainer.config.prefetch_batch or stage.state.prefetch is None:
        fail("(h2) NERF_VO_PREFETCH_BATCH=1 did not prefetch")
    if any(pf.tables.dtype != torch.bfloat16
           for pf in stage.model.proposal_fields):
        fail("(h2) the proposal tables are not bf16")
    if not counts["gather_interp_bf16"]:
        fail("(h2) the bf16 proposal tables never launched "
             "gather_interp_bf16")
    n = RAYS * FIELD_SAMPLES
    check_unfused(counts, "(h2)")
    field_m = [c[1][0].shape[0] for c in calls
               if c[0] == "scatter_cols_outer" and c[1][1].shape[1] == 8]
    print(f"(h2) the field's table-gradient scatters in the last step "
          f"(step {stage.state.step - 1}, phase "
          f"{(stage.state.step - 1) % 2}): M = {field_m} rows, against "
          f"{3 * n} for every level of the main pass ({n} a level; the "
          f"surface pass's {3 * RAYS} rows are not phased)", flush=True)
    if 2 * n not in field_m or 3 * n in field_m:
        fail(f"(h2) the phased backward scattered {field_m} rows, not the "
             f"one-hot level and one scattered level ({2 * n})")
    bf16 = [c for c in calls if c[0] == "gather_interp_bf16"]
    print(f"(h2) the last step's {len(bf16)} gather_interp_bf16 launches at "
          "the bf16 proposal grids, held against their plain versions and "
          "bitwise against the f32 kernel on the same values:", flush=True)
    held["h2"] = hold_calls(bf16, "the bf16 proposal grids' last step",
                            "(h2)")
    launches["h2"] = counts
    del stage, calls, bf16

    stage, history, counts, _, _ = run_variant(
        dev, smi, "h2", MLP_PROPOSALS, enhanced, frame_of)
    check_unfused(counts, "(h2) MLP proposals")
    if "proposal_distill_loss" not in history[-1]:
        fail("(h2) MLP proposals without their distillation loss")
    if any(not np.isfinite(v) for h in history for v in h.values()):
        fail("(h2) non-finite losses under MLP proposals")
    launches["h2_mlp"] = counts
    del stage
    gc.collect()
    torch.cuda.empty_cache()
    return launches, held


def phase_pyramid(dev, smi):
    """(h3) one DROID frontend correlation pyramid at the nerf_slam replica
    width (48 edges of 45x80 feature maps, 128 channels, 4 levels) built
    under NERF_VO_CORR_PYRAMID_DTYPE=float32 and under the bf16 default,
    and one lookup (radius 3) on each: times, bytes, and how far the bf16
    lookup lies from the f32 one."""
    import importlib

    from nerf_vo_tpu_torch.ops import dense_corr
    from nerf_vo_tpu_torch.tracking.droid_slam import DroidConfig

    E = DroidConfig().max_factors
    h, w, C = SLAM["frame_height"] // 8, SLAM["frame_width"] // 8, 128
    gen = torch.Generator(device=dev)
    gen.manual_seed(8)
    fi = torch.randn(E, h, w, C, generator=gen, device=dev).to(
        torch.bfloat16)
    fj = torch.randn(E, h, w, C, generator=gen, device=dev).to(
        torch.bfloat16)
    ys, xs = torch.meshgrid(torch.arange(h, device=dev),
                            torch.arange(w, device=dev), indexing="ij")
    coords = (torch.stack([xs, ys], -1).float()[None]
              + torch.rand(E, h, w, 2, generator=gen, device=dev) * 4 - 2)
    saved = os.environ.get("NERF_VO_CORR_PYRAMID_DTYPE")
    lookups = {}
    try:
        for name in ("float32", "bfloat16"):
            os.environ["NERF_VO_CORR_PYRAMID_DTYPE"] = name
            importlib.reload(dense_corr)
            pyr = dense_corr.build_corr_pyramid(fi, fj, 4)
            if any(v.dtype != getattr(torch, name) for v in pyr):
                fail(f"(h3) the {name} pyramid stores {pyr[0].dtype}")
            build_ms = cuda_ms(lambda: dense_corr.build_corr_pyramid(
                fi, fj, 4), 3)
            look_ms = cuda_ms(lambda: dense_corr.corr_lookup(pyr, coords, 3),
                              3)
            lookups[name] = dense_corr.corr_lookup(pyr, coords, 3)
            nbytes = sum(v.numel() * v.element_size() for v in pyr)
            print(f"(h3) {name} pyramid: {E} edges of {h}x{w}x{C}, levels "
                  f"{[tuple(v.shape[2:]) for v in pyr]}, {nbytes / 1e9:.3f} "
                  f"GB stored; build {build_ms:.3f} ms, one lookup "
                  f"{look_ms:.3f} ms; {smi}", flush=True)
            del pyr
            torch.cuda.empty_cache()
    finally:
        if saved is None:
            os.environ.pop("NERF_VO_CORR_PYRAMID_DTYPE", None)
        else:
            os.environ["NERF_VO_CORR_PYRAMID_DTYPE"] = saved
        importlib.reload(dense_corr)
    a, b = lookups["float32"], lookups["bfloat16"]
    if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
        fail("(h3) non-finite correlation lookups")
    diff = (a - b).abs().max().item()
    print(f"(h3) the bf16 lookup against the f32 one: max abs diff "
          f"{diff:.4g} (|f32| up to {a.abs().max().item():.4g})", flush=True)
    if diff > 1e-2 * a.abs().max().item():
        fail("(h3) the bf16 and f32 pyramids' lookups differ by more than "
             "bf16 rounding")


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
    reset_launches()
    t0 = time.perf_counter()
    try:
        mapping = pipeline.execute(args, device=dev, dataset=dataset)
        torch.cuda.synchronize()
    finally:
        stages.MappingStage.finish = finish
    wall = time.perf_counter() - t0
    counts = {"corr_two_level": correlation_cuda.corr_two_level.launches,
              **{k.__name__: k.launches for k in gather_cuda.KERNELS
                 + (gather_cuda.hash_descriptors,)}}
    print(f"(e) launches on the pipeline's path: {counts}; one-level "
          f"corr_level: {correlation_cuda.corr_level.launches}",
          flush=True)
    for name, n in counts.items():
        if n == 0 and name not in BF16_KERNELS + UNFUSED:
            fail(f"the pipeline never launched {name}")
    check_unfused(counts, "the pipeline")
    # the replica mapper's proposals distill, so no interlevel loss here
    counts[INTERLEVEL] = read_launches()[INTERLEVEL]
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


def record_calls(fn, names):
    """Runs ``fn()`` with the named ``gather_cuda`` wrappers observed: each
    call's inputs are kept (tensors cloned, so that later in-place updates
    of a table do not reach them) and the call goes on to the kernel, whose
    launch is counted on the kernel's own wrapper as usual. Returns fn's
    result and the calls."""
    from nerf_vo_tpu_torch.ops import gather_cuda as gc

    kernel = {name: getattr(gc, name) for name in names}
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


# levels of both hash proposal grids (models/nerfacto.py: HashGridConfig(5,
# 2, 17, 16, 128 / 256))
PROPOSAL_LEVELS = 5


def id_runs(idx, levels):
    """Per level of level-major ids: descriptors, id runs
    (``(idx[1:] != idx[:-1]).sum() + 1``), distinct ids and the most
    descriptors on one id. The scatters' runs design adds once a run; the
    most on one id is what one table row takes with one add a
    descriptor."""
    n = idx.shape[0] // levels
    rows = []
    for lv in range(levels):
        s = idx[lv * n:(lv + 1) * n].long()
        counts = torch.unique(s, return_counts=True)[1]
        rows.append(dict(level=lv, n=n, lo=int(s.min()), hi=int(s.max()),
                         runs=int((s[1:] != s[:-1]).sum()) + 1,
                         distinct=int(counts.numel()),
                         most=int(counts.max())))
    return rows


def print_id_runs(idx, levels, label):
    for r in id_runs(idx, levels):
        print(f"{label} level {r['level']}: {r['n']} descriptors, ids "
              f"{r['lo']}..{r['hi']}, {r['runs']} runs (mean length "
              f"{r['n'] / r['runs']:.2f}), {r['distinct']} distinct ids, "
              f"most on one id {r['most']}", flush=True)


def hold_calls(calls, label, tag):
    """Each recorded call, launched again on its own inputs, held against
    its plain version and timed as phase (a) times it: ``gather_cols``
    bitwise; rows 3-4 elementwise within the f32 summation bound of their
    terms (``check_sums``: scaled to the terms' own size, which for a
    gradient lies far below 1); a bf16-table ``gather_interp_bf16`` also
    bitwise against the f32 kernel on the table's values in f32 (its
    library call, ``embedding_bag``, runs on that f32 copy: it takes no
    bf16 table with f32 weights); the fused adjoints ``gather_cols_dfrac``
    and ``scatter_cols_outer`` within the f32 summation bound, with the
    chain each replaced timed beside them and the scatter's sort timed
    (:func:`adjoint_timing`). The launches made here are not counted:
    every kernel's count is as it was before the call. Returns (name,
    timing with the call's M) for each call."""
    import torch.nn.functional as Fn

    from nerf_vo_tpu_torch.ops import gather_cuda as gc

    interp_plain = {"gather_interp": gc.gather_interp_plain,
                    "gather_interp_bf16": gc.gather_interp_plain,
                    "gather_interp_mm": gc.gather_interp_mm_plain}
    torch.cuda.synchronize()
    counted = read_launches()
    held = []
    for name, a, kw in calls:
        if name in ADJOINTS:
            timing = adjoint_timing(name, a, label, tag)
            held.append((name, dict(timing, M=call_shape(name, a)[0])))
            continue
        kernel = getattr(gc, name)
        got = kernel(*a, **kw)
        torch.cuda.synchronize()
        hot = f", hot rows {kw['hot_rows']}" if kw.get("hot_rows") else ""
        if name == "gather_cols":
            t, i = a
            m, R = i.shape[0], t.shape[1]
            if not torch.equal(got, gc.gather_cols_plain(t, i)):
                fail(f"gather_cols at {label} differs from its plain version")
            il = i.long()
            timing = time_kernel(
                f"{name} at {label}: M={m} R={R} over {t.shape[0]} bricks",
                lambda: kernel(t, i), lambda: gc.gather_cols_plain(t, i),
                lambda: torch.index_select(t, 0, il),
                table_bytes(t, i) + m * 4 + m * R * 2, 0, 0.0, tag=tag)
        else:
            t, i, w, F = a[:4]
            m = i.shape[0]
            err = check_sums(f"{name} at {label}", got,
                             interp_plain[name](t, i, w, F),
                             interp_plain[name](t.abs(), i, w.abs(), F),
                             32, tag)
            t32 = t.float()
            if name == "gather_interp_bf16":
                if not torch.equal(got, gc.gather_interp(t32, i, w, F)):
                    fail(f"{name} at {label} is not bitwise the f32 "
                         "kernel's result on the same values")
                f32_ms = cuda_ms(lambda: gc.gather_interp(t32, i, w, F), 20)
                f32_queued = cuda_ms(lambda: gc.gather_interp(t32, i, w, F),
                                     20, queued=True)
                f32_bound, _ = bound(interp_table_bytes(t32, i, w, F)
                                     + m * (4 + 32 * 4 + F * 4), 0)
                print(f"{tag} the f32 kernel on the same values: "
                      f"{f32_ms:.4f} ms, queued {f32_queued:.4f} ms, bound "
                      f"{f32_bound:.4f} ms", flush=True)
            flat = i.long()[:, None] * 32 + torch.arange(32, device=i.device)
            view = t32.view(-1, F)
            nbytes = interp_table_bytes(t, i, w, F) + m * (4 + 32 * 4 + F * 4)
            timing = time_kernel(
                f"{name} at {label}: M={m} F={F} over {t.shape[0]} "
                f"{str(t.dtype)[6:]} bricks{hot}",
                lambda: kernel(*a, **kw),
                lambda: interp_plain[name](t, i, w, F),
                lambda: Fn.embedding_bag(flat, view, per_sample_weights=w,
                                         mode="sum"),
                nbytes, 2 * m * 32 * F, err, tag=tag)
        held.append((name, dict(timing, M=int(a[1].shape[0]))))
    for name, k in kernel_launches().items():
        k.launches = counted[name]
    return held


def chunk_shape_timings(mapping):
    """Rows 3 and 4 at an evaluation render's shapes: the inputs of every
    table-kernel launch of one 16,384-ray render chunk of the map (one
    128x128 render), each launch then held against its plain version and
    timed as phase (a) times it."""
    st = mapping.trainer
    c2w = st.optimized_c2w(mapping.state, mapping.buffer)[0]
    intr = mapping.buffer.intrinsics[0] * 0.2
    _, calls = record_calls(
        lambda: st.render_image(mapping.state, c2w, intr, 128, 128),
        ("gather_interp", "gather_interp_mm"))
    hold_calls(calls, "a 16,384-ray render chunk", "(f)")
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
    for name in UNFUSED + ADJOINTS + (SORT,) + CORR_KERNELS:
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
    from nerf_vo_tpu_torch.mapping import trainer
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
    # every refresh, eager or replayed as CUDA graphs, passes here
    refresh = trainer.MappingTrainer._occupancy_step

    def timed_finish(self):  # observers: they count and time
        torch.cuda.synchronize()
        marks["start"] = (time.perf_counter(), self.step_count)
        finish(self)
        torch.cuda.synchronize()
        marks["end"] = (time.perf_counter(), self.step_count)

    def counted_refresh(self, state, jitter):
        step = state.step
        refreshes.append(step)
        if step + every < iters:
            return refresh(self, state, jitter)
        # the last refresh: its rows 3 and 4 inputs are kept for (g2)'s
        # check of those launches against their plain versions (a
        # replayed call's output buffer left out)
        _, calls = record_calls(
            lambda: refresh(self, state, jitter),
            ("gather_interp", "gather_interp_mm"))
        refresh_calls[:] = [(n, a, {k: v for k, v in kw.items()
                                    if k != "out"}) for n, a, kw in calls]
        return None

    stages.MappingStage.finish = timed_finish
    trainer.MappingTrainer._occupancy_step = counted_refresh
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
        trainer.MappingTrainer._occupancy_step = refresh
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
    for name in TABLE_ROWS + (DESCRIPTORS,):
        if not counts[name]:
            fail(f"the nerf_slam pipeline never launched {name}")
    check_unfused(counts, "the nerf_slam pipeline")
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
    hold_calls(refresh_calls, "an occupancy refresh's slab", "(g2)")
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
    if any(counts[name] for name in UNFUSED + ADJOINTS + (SORT,)):
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



# ---------------------------------------------------------------------------
# (i) the multi-device paths
# ---------------------------------------------------------------------------

# (i)'s cuts: 16 active keyframes of the buffer's 192, 8 train steps a mode
# (2 in (i1), NGP 2: one occupancy refresh), 12 DROID frames
PARALLEL = dict(keyframes=16, steps=8, i1_steps=2, ngp_steps=2,
                droid_frames=12, render=(360, 640), ba_frames=192,
                ba_edges=48, ba_hw=(45, 80), ba_window=25)
TP_ROWS = TABLE_ROWS
LR, CAM_LR = 1e-2, 1e-4


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def mapping_packet(dev, K, H, W, seed, cov=False):
    """K synthetic keyframes on the device from a seed: cameras on an arc
    looking down -z (OpenGL), smooth colors, positive depth everywhere (so
    that every loss is a mean over rays and data-parallel groupings of one
    batch agree)."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    ang = (torch.rand(K, generator=g, device=dev) - 0.5) * 0.4
    c2w = torch.eye(4, device=dev).repeat(K, 1, 1)
    c2w[:, 0, 0], c2w[:, 0, 2] = torch.cos(ang), torch.sin(ang)
    c2w[:, 2, 0], c2w[:, 2, 2] = -torch.sin(ang), torch.cos(ang)
    c2w[:, :3, 3] = torch.randn(K, 3, generator=g, device=dev) * 0.3
    yy, xx = torch.meshgrid(torch.linspace(0, 1, H, device=dev),
                            torch.linspace(0, 1, W, device=dev),
                            indexing="ij")
    base = torch.rand(K, 1, 1, 3, generator=g, device=dev) * 0.8 + 0.1
    color = (base + 0.3 * torch.sin(6 * xx + 4 * yy)[None, ..., None]).clamp(
        0, 1)
    depth = 2.5 + torch.cos(3 * xx - yy)[None] * (
        torch.rand(K, 1, 1, generator=g, device=dev) * 0.5 + 0.5)
    f = 0.8 * W
    pkt = dict(intrinsics=torch.tensor([f, f, W / 2, H / 2],
                                       device=dev).repeat(K, 1),
               c2w=c2w, color=color, depth=depth)
    if cov:
        pkt["depth_cov"] = 0.01 + 0.1 * torch.rand(K, H, W, generator=g,
                                                   device=dev)
    return pkt


def slice_draws(d, lo, hi):
    """Rays lo..hi of a step's draws (refresh draws whole)."""
    out = {k: v for k, v in d.items()}
    for k in ("frame", "py", "px"):
        out[k] = d[k][lo:hi]
    out["uniforms"] = [u[lo:hi] for u in d["uniforms"]]
    return out


def mapper(args, dev, mesh=None, mode="plain"):
    """(model, trainer) of the replica mapper for ``args`` from torch seed
    42 (``MappingStage``'s init); ``mode`` "tp" / "ds" make the table-
    sharded model over ``mesh``."""
    import dataclasses

    from nerf_vo_tpu_torch.mapping.trainer import MappingTrainer, TrainerConfig
    from nerf_vo_tpu_torch.models.nerfacto import NerfactoModel
    from nerf_vo_tpu_torch.runtime.stages import mapping_model_config

    cfg = mapping_model_config(args)
    if mode in ("tp", "ds"):
        cfg = dataclasses.replace(
            cfg, model_axis="model", model_axis_size=mesh.size(1),
            descriptor_sharding=mode == "ds")
    torch.manual_seed(42)
    model = NerfactoModel(cfg, mesh=mesh if mode in ("tp", "ds") else None)
    trainer = MappingTrainer(model, TrainerConfig(
        rays_per_batch=getattr(args, "rays_per_batch", 4096),
        max_iterations=args.mapping_iterations), args.num_keyframes,
        device=dev)
    return model, trainer


def train_mode(args, dev, mode, buf, steps, mesh=None, record=False):
    """``steps`` train steps of the replica mapper in ``mode``: "plain"
    (``train_step``), "dp" (``make_dp_train_step`` over ``mesh``'s "data"
    axis), "tp" / "ds" (``make_dp_tp_train_step`` over its 2D layout). Every
    rank makes each step's whole 4096-ray draws from one seed and takes its
    share: rank r of DP(n) rays r/n..(r+1)/n, a data row i of DP x TP half
    i, a rank of the descriptor-sharded layout its own quarter, so every
    mode trains on the same rays. Returns the model, trainer, state, the
    parameters after the first step (copies), per-step losses and ms, each
    table kernel's launches and the last step's recorded table-kernel
    calls (with ``record``)."""
    from nerf_vo_tpu_torch.ops import gather_cuda as gc
    from nerf_vo_tpu_torch.parallel import dist as pdist
    from nerf_vo_tpu_torch.parallel import sharding

    full, trainer = mapper(args, dev)
    state = trainer.init()
    model = full
    R = trainer.config.rays_per_batch
    lo, hi = 0, R
    if mode == "dp":
        ax = pdist.mesh_axis(mesh, "data")
        step = sharding.make_dp_train_step(trainer, mesh)
        lo, hi = ax.index * R // ax.size, (ax.index + 1) * R // ax.size
    elif mode in ("tp", "ds"):
        model, tp_trainer = mapper(args, dev, mesh, mode)
        state = sharding.shard_state_tp(full, state, tp_trainer)
        del full
        trainer = tp_trainer
        step = sharding.make_dp_tp_train_step(
            trainer, mesh, descriptor_sharding=mode == "ds")
        d, m = (pdist.mesh_axis(mesh, a) for a in ("data", "model"))
        n, i = ((d.size * m.size, d.index * m.size + m.index)
                if mode == "ds" else (d.size, d.index))
        lo, hi = i * R // n, (i + 1) * R // n
    else:
        step = trainer.train_step
    for k in gc.KERNELS:
        k.launches = 0
    g = torch.Generator(device=dev)
    losses, times, calls, first = [], [], [], None
    for s in range(steps):
        g.manual_seed(1000 + s)
        draws = slice_draws(trainer.draws(buf, state, R, (g, g)), lo, hi)
        sync(dev)
        t0 = time.perf_counter()
        if record and s == steps - 1:
            (state, m), calls = record_calls(
                lambda: step(state, buf, draws), TP_ROWS)
        else:
            state, m = step(state, buf, draws)
        sync(dev)
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
        if not np.isfinite(losses[-1]):
            fail(f"(i) {mode}: non-finite loss at step {s}")
        if s == 0:
            first = {n: v.clone() for n, v in params_of(model, state).items()}
    launches = {k.__name__: k.launches for k in gc.KERNELS}
    return model, trainer, state, first, losses, times, launches, calls


def params_of(model, state):
    out = {n: p.detach() for n, p in model.named_parameters()}
    out["pose_deltas"] = state.pose_deltas.detach()
    return out


def leaf_names(state):
    """The names of the leaves a step trains (``MappingTrainer.leaves``:
    the parameters that take a gradient, then the pose corrections). The
    distilled dense proposal grids take none: they change at a refresh
    only, and stay out of the comparisons."""
    return list(state.params) + ["pose_deltas"]


def compare_tight(got, want, names):
    """After one step, for each trained leaf: the elements outside the CPU
    test's ``atol 2e-6 + rtol 2e-4`` (``tests/test_torch_parallel.py``)
    and the largest difference. Adam's first step moves an element by
    lr times the sign of its gradient, so an element outside means a
    gradient of the other sign (or zero) there."""
    out = {}
    for n in names:
        w = want[n].float()
        d = (got[n].float() - w).abs()
        out[n] = dict(outside=int((d > 2e-6 + 2e-4 * w.abs()).sum()),
                      worst=float(d.max()))
    return out


def compare_params(got, want, names):
    """The numbers of the mapping parity rule (``tests/test_torch_mapping.
    py``), for each trained leaf: the share of its elements within lr / 10
    and within 2.5 lr; the pose corrections' largest difference in cam_lr;
    the largest parameter difference."""
    close, wide = {}, {}
    worst, pose = 0.0, 0.0
    for n in names:
        d = (got[n].float() - want[n].float()).abs()
        if n == "pose_deltas":
            pose = float(d.max()) / CAM_LR
            continue
        close[n] = float((d <= LR / 10).float().mean())
        wide[n] = float((d <= 2.5 * LR).float().mean())
        worst = max(worst, float(d.max()))
    return dict(close=close, wide=wide, pose_in_lr=pose, worst=worst)


# (i)'s limits for a parallel step against its reference on the same rays
# a rank, each trained leaf alone, set from the readings of an H100 run
# that PERF.md lists (in brackets). On the card the scatters' atomics sum
# in a varying order, so even DP(1) differs from the plain step where a
# gradient nearly cancels. After step 1: at most STEP1_OUTSIDE elements of
# the trained leaves (12.6M at the replica width) outside the CPU test's
# tolerance [1-5], and none by lr / 10 or more [largest 9.3e-5]: a gradient
# of the other sign moves an element by 2 lr. After the last step: the
# share within lr / 10 of the tables >= TABLE_CLOSE [0.9729-0.9913] and of
# every other leaf >= LEAF_CLOSE [0.7240: the normal MLPs, whose bf16
# roundings the varying sums steer step after step]; of each leaf within
# 2.5 lr >= LEAF_WIDE [0.999862]; the pose corrections within 2.5 cam_lr
# [0.948].
STEP1_OUTSIDE, TABLE_CLOSE, LEAF_CLOSE, LEAF_WIDE = 64, 0.95, 0.5, 0.999


def params_agree(c, c1):
    return (sum(v["outside"] for v in c1.values()) <= STEP1_OUTSIDE
            and max(v["worst"] for v in c1.values()) < LR / 10
            and all(v >= (TABLE_CLOSE if n.endswith("tables")
                          else LEAF_CLOSE) for n, v in c["close"].items())
            and min(c["wide"].values()) >= LEAF_WIDE
            and c["pose_in_lr"] <= 2.5)


def describe_agreement(c, c1, n_steps):
    """One line of the numbers ``params_agree`` judges."""
    out = sum(v["outside"] for v in c1.values())
    w1 = max(v["worst"] for v in c1.values())
    lo = min(c["close"], key=c["close"].get)
    close = ", ".join(f"{n} {v:.6f}" for n, v in c["close"].items())
    wide = min(c["wide"], key=c["wide"].get)
    return (f"after step 1 {out} elements of the trained leaves outside "
            f"2e-6 + 2e-4 relative (largest difference {w1:.3g}); after "
            f"step {n_steps} the least leaf within lr/10 {lo} "
            f"{c['close'][lo]:.6f} (each leaf: {close}), the least within "
            f"2.5 lr {wide} {c['wide'][wide]:.6f}, largest difference "
            f"{c['worst']:.3g}, pose {c['pose_in_lr']:.3g} cam_lr")


def nccl_probe(dev):
    """The collectives the port uses, called on the default group itself
    (the port's helpers move nothing over a size-1 axis): all_reduce,
    all_gather, all_to_all_single and broadcast on tensors of the card,
    each result checked. Returns the backend and whether all were right."""
    import torch.distributed as dist

    n = 1 << 20
    t = torch.arange(n, device=dev, dtype=torch.float32)
    dist.all_reduce(t)
    ok = torch.equal(t, torch.arange(n, device=dev, dtype=torch.float32))
    parts = [torch.empty(3, device=dev)]
    dist.all_gather(parts, torch.full((3,), 5.0, device=dev))
    ok &= torch.equal(parts[0], torch.full((3,), 5.0, device=dev))
    rows = torch.arange(10.0, device=dev).view(5, 2)
    got = torch.empty_like(rows)
    dist.all_to_all_single(got, rows, [5], [5])
    ok &= torch.equal(got, rows)
    b = torch.full((7,), 2.0, device=dev)
    dist.broadcast(b, src=0)
    torch.cuda.synchronize(dev)
    ok &= torch.equal(b, torch.full((7,), 2.0, device=dev))
    return dict(backend=dist.get_backend(), ok=bool(ok))


def rank_i1(rank, world, dev, spec):
    """(i1) one NCCL rank: the collectives called on the NCCL group
    (``nccl_probe``), then ``make_dp_train_step`` (DP(1)) and
    ``make_dp_tp_train_step`` (1 x 1) against the plain ``train_step`` on
    the same draws, from one init. The steps' collectives move nothing over
    a size-1 axis: the steps run the one-rank route of the parallel code."""
    from nerf_vo_tpu_torch.mapping import keyframe_buffer as kb
    from nerf_vo_tpu_torch.parallel import dist as pdist

    probe = nccl_probe(dev)

    args = SimpleNamespace(**spec["args"])
    K = spec["keyframes"]
    buf = kb.create(args.num_keyframes, args.frame_height, args.frame_width,
                    use_normals=False, device=dev)
    kb.insert(buf, list(range(K)), mapping_packet(
        dev, K, args.frame_height, args.frame_width, 7))
    out = {}
    ref = None
    for mode, mesh in (("plain", None), ("dp", pdist.make_mesh(1)),
                       ("tp", pdist.make_mesh_2d(1, 1))):
        model, _, state, first, losses, times, launches, _ = train_mode(
            args, dev, mode, buf, spec["steps"], mesh)
        p = params_of(model, state)
        names = leaf_names(state)
        if ref is None:
            ref = ({n: v.clone() for n, v in p.items()}, first)
        out[mode] = dict(losses=losses, ms=times, launches=launches,
                         vs_ref=compare_params(p, ref[0], names),
                         vs_ref_step1=compare_tight(first, ref[1], names))
        del model, state
    return out, probe


def rank_i2(rank, world, dev, spec):
    """(i2) four ranks on one card, at the replica width: DP(4), DP2 x TP2
    and descriptor-sharded 2 x 2 train steps on the same rays from one
    init (each held against DP(4)), a 360x640 ``MapRenderer(mesh=)``
    render of the DP(4) map against one rank's, the NGP mapper under DP2 x
    TP2 through one occupancy refresh, ``make_sharded_dense_ba`` at the
    nerf_slam frontend's size against one rank's solver, and
    ``DROIDSLAMTracker(mesh=)`` on the synthetic frames. Rank 0 then holds
    one table-sharded call of each of rows 2-5 from its last DP2 x TP2 step
    against its plain version and times it."""
    from nerf_vo_tpu_torch.evaluation.nerf_renderer import MapRenderer
    from nerf_vo_tpu_torch.mapping import keyframe_buffer as kb
    from nerf_vo_tpu_torch.ops import dense_ba
    from nerf_vo_tpu_torch.parallel import dist as pdist

    args = SimpleNamespace(**spec["args"])
    K = spec["keyframes"]
    H, W = args.frame_height, args.frame_width
    mesh = pdist.make_mesh()
    mesh22 = pdist.make_mesh_2d(2, 2)
    world_ax = pdist.world_axis()
    buf = kb.create(args.num_keyframes, H, W, use_normals=False, device=dev)
    kb.insert(buf, list(range(K)), mapping_packet(dev, K, H, W, 7))
    out, calls = {}, []

    def peak():
        return (torch.cuda.max_memory_allocated(dev) / 2**30
                if dev.type == "cuda" else 0.0)

    def whole(p):
        """A table-sharded model's parameters with each table gathered over
        the model axis (and checked alike on both data rows)."""
        m_ax = pdist.mesh_axis(mesh22, "model")
        d_ax = pdist.mesh_axis(mesh22, "data")
        same = True
        for n in list(p):
            if n.endswith("tables"):
                local = p[n].float().contiguous()
                rows = pdist.all_gather_cat(local[None], d_ax)
                same &= torch.equal(rows[0], rows[-1])
                p[n] = pdist.all_gather_cat(local, m_ax)
        return p, same

    # DP(4) on the ranks' quarters; DP(2) over the 2 x 2 mesh's data axis
    # on the rows' halves (a model column's two ranks alike): the
    # references of descriptor sharding and of DP2 x TP2, on the same rays
    # a rank
    refs = {}
    for mode, msh, kind, ref_of in (("dp", mesh, "dp", None),
                                    ("rows", mesh22, "dp", None),
                                    ("tp", mesh22, "tp", "rows"),
                                    ("ds", mesh22, "ds", "dp")):
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        (model, trainer, state, first, losses, times, launches,
         calls_m) = train_mode(args, dev, kind, buf, spec["steps"], msh,
                               record=mode == "tp" and rank == 0)
        calls = calls_m or calls
        p = params_of(model, state)
        names = leaf_names(state)
        rec = dict(losses=losses, ms=times, launches=launches,
                   peak_gib=peak())
        if ref_of is not None:
            p, rec["rows_equal"] = whole(p)
            first, same = whole(first)
            rec["rows_equal"] &= same
            rec["vs_ref"] = compare_params(p, refs[ref_of][0], names)
            rec["vs_ref_step1"] = compare_tight(first, refs[ref_of][1],
                                                names)
            if mode == "tp":  # against DP(4): other groupings of the rays
                rec["vs_dp4"] = compare_params(p, refs["dp"][0], names)
        else:
            refs[mode] = ({n: v.clone() for n, v in p.items()}, first)
        # replicated leaves (and pose corrections) alike on every rank of
        # the mode's group (a model column of "rows", else every rank)
        flat = torch.cat([v.float().reshape(-1) for n, v in p.items()
                          if not n.endswith("tables")])
        ax = pdist.mesh_axis(mesh22, "data") if mode == "rows" else world_ax
        allr = pdist.all_gather_cat(flat[None], ax)
        rec["replicated_equal"] = all(torch.equal(allr[0], allr[r])
                                      for r in range(ax.size))
        out[mode] = rec
        if mode == "dp":  # the render of the DP(4) map
            stage = SimpleNamespace(trainer=trainer, buffer=buf, device=dev,
                                    state=state, model=model)
            rh, rw = spec["render"]
            cam = dict(fx=0.8 * rw, fy=0.8 * rw, cx=rw / 2, cy=rh / 2,
                       height=rh, width=rw)
            pose = np.eye(4, dtype=np.float32)
            pose[:3, 3] = [0.1, 0.0, -0.2]
            sync(dev)
            t0 = time.perf_counter()
            col, dep = MapRenderer(stage, mesh=mesh).render_frame(cam, pose)
            sync(dev)
            t_dp = (time.perf_counter() - t0) * 1e3
            rec["render"] = dict(ms=t_dp)
            if rank == 0:
                t0 = time.perf_counter()
                col1, dep1 = MapRenderer(stage).render_frame(cam, pose)
                sync(dev)
                rec["render"].update(
                    one_ms=(time.perf_counter() - t0) * 1e3,
                    rgb_max_diff=int(np.abs(col.astype(int)
                                            - col1.astype(int)).max()),
                    depth_max_rel=float(np.max(np.abs(dep - dep1)
                                               / np.maximum(np.abs(dep1),
                                                            1e-6))))
        del model, trainer, state, p, first
    del refs

    # the NGP mapper, DP2 x TP2, through one occupancy refresh
    ngp_args = SimpleNamespace(**spec["ngp_args"])
    ngp_buf = kb.create(ngp_args.num_keyframes, H, W, use_normals=False,
                        use_depth_cov=True, device=dev)
    kb.insert(ngp_buf, list(range(K)), mapping_packet(dev, K, H, W, 8,
                                                      cov=True))
    _, _, nstate, _, nloss, ntimes, nlaunch, _ = train_mode(
        ngp_args, dev, "tp", ngp_buf, spec["ngp_steps"], mesh22)
    grid = nstate.occ_grid
    grids = pdist.all_gather_cat(grid[None], world_ax)
    out["ngp"] = dict(
        losses=nloss, ms=ntimes, launches=nlaunch,
        grid_equal=all(torch.equal(grids[0], grids[r])
                       for r in range(world)),
        grid_finite=bool(torch.isfinite(grid).all()),
        grid_max=float(grid.max()),
        occupied=float((grid > 0.01).float().mean()))
    del nstate, ngp_buf

    # the pixel-sharded dense BA at the frontend's size
    problem, slots, eta = dense_ba_problem(dev, spec)
    res = {}
    for n_it in (1, 2):
        step = dense_ba.make_sharded_dense_ba(
            mesh, num_iters=n_it, window=spec["ba_window"])
        sync(dev)
        t0 = time.perf_counter()
        got = step(problem, slots, eta=eta)
        sync(dev)
        ms = (time.perf_counter() - t0) * 1e3
        res[n_it] = dict(ms=ms)
        if rank == 0:
            t0 = time.perf_counter()
            want = dense_ba.dense_bundle_adjust(
                problem, slots, num_iters=n_it, window=spec["ba_window"],
                eta=eta)
            sync(dev)
            res[n_it].update(one_ms=(time.perf_counter() - t0) * 1e3,
                             **ba_errors(got, want))
    out["dense_ba"] = res
    del problem, eta

    # DROID tracking with the pixel-sharded frontend BA
    sargs = SimpleNamespace(**spec["slam_args"])
    tr = droid_tracker(sargs, dev, mesh)
    sec = run_droid(tr, spec["droid_frames"], sargs)
    out["droid"] = dict(s=sec, **droid_state(tr))
    del tr

    # rank 0 holds the recorded table-sharded calls while the others wait
    pdist.all_reduce_sum(torch.zeros(1, device=dev), world_ax)
    if rank == 0 and dev.type == "cuda":
        out["held"] = hold_calls(pick_tp_calls(calls), "a DP2 x TP2 step's "
                                 "table-sharded route (rank 0)", "(i)")
    pdist.all_reduce_sum(torch.zeros(1, device=dev), world_ax)
    out["peak_gib"] = peak()
    return out


def pick_tp_calls(calls):
    """Of a step's recorded calls, the field's (F = 8) table-sharded
    ones: the largest masked ``gather_interp`` (local rows, zero weights on
    the descriptors owned elsewhere), the slab's ``gather_interp_mm``, the
    largest compacted ``scatter_cols_outer`` into the local rows (not the
    slab's) and the largest ``gather_cols_dfrac`` of owned descriptors."""
    best = {}
    local = max(a[0].shape[0] for name, a, kw in calls
                if name != "scatter_cols_outer" and a[0].shape[1] == 256)
    for name, a, kw in calls:
        m, F = call_shape(name, a)
        if F != 8:
            continue
        if name == "scatter_cols_outer" and a[3] != local:
            continue  # the slab's
        if name == "gather_cols_dfrac" and a[0].shape[0] != local:
            continue  # the slab's
        if name not in best or m > call_shape(name, best[name][1])[0]:
            best[name] = (name, a, kw)
    missing = [n for n in TP_ROWS if n not in best]
    if missing:
        fail(f"(i) no table-sharded call of {missing} was recorded")
    return [best[n] for n in TP_ROWS]


def dense_ba_problem(dev, spec):
    """A frontend-sized dense BA problem from a seed on the device:
    ``ba_frames`` frames (poses near identity, inverse depth 0.3-1.5) at
    45x80, ``ba_edges`` edges among the window's first frames, noisy
    reprojection targets, weights 0.2-1, depth damping up to 0.01."""
    from nerf_vo_tpu_torch.core import lie
    from nerf_vo_tpu_torch.ops import dense_ba

    g = torch.Generator(device=dev)
    g.manual_seed(11)
    N, E, P = spec["ba_frames"], spec["ba_edges"], spec["ba_window"]
    h, w = spec["ba_hw"]
    poses = lie.se3_retract(
        lie.se3_identity((N,), device=dev),
        torch.randn(N, 6, generator=g, device=dev) * 0.02)
    disps = 0.3 + 1.2 * torch.rand(N, h, w, generator=g, device=dev)
    intr = torch.tensor([w * 0.8, w * 0.8, w / 2, h / 2],
                        device=dev).repeat(N, 1)
    ii = torch.randint(0, P + 1, (E,), generator=g, device=dev)
    jj = (ii + torch.randint(1, 4, (E,), generator=g, device=dev)) % (P + 1)
    coords, _ = dense_ba.dense_reproject(poses, disps, intr, ii, jj)
    tgt = coords + torch.randn(coords.shape, generator=g, device=dev) * 0.3
    wgt = 0.2 + 0.8 * torch.rand(coords.shape, generator=g, device=dev)
    slots = torch.full((N,), -1, dtype=torch.long, device=dev)
    slots[1:P + 1] = torch.arange(P, device=dev)
    eta = torch.rand(N, h, w, generator=g, device=dev) * 0.01
    prob = dense_ba.DenseBAProblem(
        poses=poses, disps=disps, intrinsics=intr, ii=ii, jj=jj,
        targets=tgt, weights=wgt,
        valid=torch.ones(E, dtype=torch.bool, device=dev))
    return prob, slots, eta


def ba_errors(got, want):
    p1, d1, c1, cov1 = got
    p0, d0, c0, cov0 = want
    return dict(
        pose_max=float((p1 - p0).abs().max()),
        cost_rel=float(((c1 - c0).abs() / c0.abs()).max()),
        disp_mean_rel=float(((d1 - d0).abs() / d0.abs()).mean()),
        disp_max_rel=float(((d1 - d0).abs() / d0.abs()).max()),
        cov_max_rel=float(((cov1 - cov0).abs() / cov0.abs()).max()))


def droid_tracker(sargs, dev, mesh=None):
    """The DROID tracker of ``TrackingStage(droid-slam)`` (its config keys,
    random weights from torch seed 42), with the frontend BA sharded over
    ``mesh``'s first axis when given."""
    from nerf_vo_tpu_torch.models import droid_net
    from nerf_vo_tpu_torch.tracking.droid_slam import (DroidConfig,
                                                       DROIDSLAMTracker)

    cfg = DroidConfig(
        buffer_size=sargs.num_keyframes,
        motion_threshold=sargs.motion_threshold,
        keyframe_threshold=sargs.keyframe_threshold,
        perform_global_ba=sargs.perform_global_bundle_adjustment,
        compute_covariances=sargs.compute_covariances)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(42)
        net = droid_net.DroidNet()
    H = sargs.frame_height - sargs.frame_height % 8
    W = sargs.frame_width - sargs.frame_width % 8
    return DROIDSLAMTracker(cfg, net, H, W, device=dev, mesh=mesh)


def run_droid(tr, n, sargs):
    """``n`` synthetic frames through ``tr.track`` as the stage feeds them;
    returns the seconds, synchronized."""
    frames = synthetic_frames(n, sargs.frame_height, sargs.frame_width)
    intr = np.asarray([320.0, 320.0, sargs.frame_width / 2,
                       sargs.frame_height / 2], np.float32)
    sync(tr.device)
    t0 = time.perf_counter()
    for i, img in enumerate(frames):
        tr.track(float(i), img[:tr.H, :tr.W], intr, frame_index=i)
    sync(tr.device)
    return time.perf_counter() - t0


def droid_state(tr):
    n = tr.n_kf
    return dict(keyframes=n, poses=tr.poses[:n].detach().cpu().numpy(),
                disps=tr.disps[:n].detach().cpu().numpy())


def parallel_spec():
    """The inputs of (i)'s ranks: the replica mapping args, the nerf_slam
    NGP mapper's, the tracker's and (i)'s cuts."""
    return dict(PARALLEL, args=dict(REPLICA, **MAPPING), ngp_args=dict(SLAM),
                slam_args=dict(SLAM, **SLAM_TRACKING_CUTS))


def phase_parallel(dev, smi):
    """(i) the multi-device paths on the card: (i1) one NCCL rank, (i2)
    four gloo ranks sharing the card. Prints every case, then fails if any
    check failed. Returns each table kernel's launches by case and rank,
    and rank 0's held table-sharded calls."""
    from nerf_vo_tpu_torch.parallel import dist as pdist

    spec = parallel_spec()
    bad = []

    def check(ok, what):
        if not ok:
            bad.append(what)

    print(f"(i) cuts: {PARALLEL['keyframes']} active synthetic keyframes of "
          f"the buffer's {MAPPING['num_keyframes']}; {PARALLEL['steps']} "
          f"train steps a mode in (i2), {PARALLEL['i1_steps']} in (i1), "
          f"{PARALLEL['ngp_steps']} NGP steps (one occupancy refresh); "
          f"{PARALLEL['droid_frames']} DROID frames. Full width otherwise. "
          "Ranks that share one card run at that card's pace: their times "
          f"are no scaling figure. {smi}", flush=True)
    t0 = time.perf_counter()
    r1, probe = pdist.spawn(rank_i1, 1, "cuda", args=(
        dict(spec, steps=PARALLEL["i1_steps"]),), timeout=900)[0]
    print(f"(i1) all_reduce, all_gather, all_to_all_single and broadcast "
          f"called on the one-rank group: backend {probe['backend']}, "
          f"results right {probe['ok']}. The steps' own collectives move "
          "nothing over a size-1 axis: below, DP(1) and DP1 x TP1 run the "
          "one-rank route of the parallel code", flush=True)
    check(probe["ok"] and probe["backend"] == "nccl",
          "(i1) the NCCL collectives")
    for mode, rec in r1.items():
        c, c1 = rec["vs_ref"], rec["vs_ref_step1"]
        print(f"(i1) {mode}: losses {rec['losses']}, ms a step "
              f"{[round(t, 2) for t in rec['ms']]}; launches "
              f"{rec['launches']}; against the plain step: "
              f"{describe_agreement(c, c1, PARALLEL['i1_steps'])}",
              flush=True)
        check(np.allclose(rec["losses"], r1["plain"]["losses"], rtol=1e-4,
                          atol=0), f"(i1) {mode} losses")
        check(params_agree(c, c1), f"(i1) {mode} parameters")
    print(f"(i1) {time.perf_counter() - t0:.1f} s with the spawn", flush=True)

    # the one-rank DROID tracker, before the ranks share the card
    sargs = SimpleNamespace(**spec["slam_args"])
    tr = droid_tracker(sargs, dev)
    sec = run_droid(tr, PARALLEL["droid_frames"], sargs)
    one = dict(s=sec, **droid_state(tr))
    del tr
    gc.collect()
    torch.cuda.empty_cache()

    t1 = time.perf_counter()
    res = pdist.spawn(rank_i2, 4, "cuda", args=(spec,), timeout=1200)
    print(f"(i2) {time.perf_counter() - t1:.1f} s with the spawn", flush=True)
    refs = dict(tp="DP(2) over the data axis", ds="DP(4)")
    for mode in ("dp", "rows", "tp", "ds"):
        recs = [r[mode] for r in res]
        ms = [float(np.median(r["ms"][1:])) for r in recs]
        vs = ""
        if mode in refs:
            c, c1 = recs[0]["vs_ref"], recs[0]["vs_ref_step1"]
            vs = (f"; against {refs[mode]} on the same rays a rank: "
                  f"{describe_agreement(c, c1, PARALLEL['steps'])}; data "
                  f"rows' tables equal {all(r['rows_equal'] for r in recs)}")
            if mode == "tp":
                c4 = recs[0]["vs_dp4"]
                vs += (f"; against DP(4) (quarters, not halves, of the rays: "
                       f"other bf16 roundings of the MLP gradients) the "
                       f"least leaf {min(c4['close'].values()):.6f} within "
                       f"lr/10, largest difference {c4['worst']:.3g}")
            check(params_agree(c, c1), f"(i2) {mode} against {refs[mode]}")
            check(all(r["rows_equal"] for r in recs),
                  f"(i2) {mode} tables of the data rows")
            ref_losses = res[0]["rows" if mode == "tp" else "dp"]["losses"]
            check(np.allclose(recs[0]["losses"], ref_losses, rtol=1e-2,
                              atol=0), f"(i2) {mode} losses")
        print(f"(i2) {mode}: losses {[round(v, 5) for v in recs[0]['losses']]}"
              f"; median ms a step by rank {[round(m, 2) for m in ms]} (4 "
              f"ranks on one card); peak GiB by rank "
              f"{[round(r['peak_gib'], 2) for r in recs]}; launches by rank "
              f"{[r['launches'] for r in recs]}; replicated leaves equal on "
              f"every rank {all(r['replicated_equal'] for r in recs)}{vs}",
              flush=True)
        # DP(2) over the data axis runs one group a model column: its
        # leaves and metrics are alike within a column (ranks j, j + 2)
        group = (lambda r: r % 2) if mode == "rows" else (lambda r: 0)
        check(all(r["replicated_equal"] for r in recs),
              f"(i2) {mode} replicated leaves")
        check(all(r["losses"] == recs[group(i)]["losses"]
                  for i, r in enumerate(recs)),
              f"(i2) {mode} metrics alike on the ranks of a group")
        for r in recs:
            check(all(r["launches"][n] for n in TP_ROWS),
                  f"(i2) {mode}: a rank launched no {TP_ROWS} kernel")
            check(not any(r["launches"][n] for n in UNFUSED),
                  f"(i2) {mode}: a rank launched {UNFUSED}")
            check(r["launches"][SORT] == r["launches"]["scatter_cols_outer"],
                  f"(i2) {mode}: a rank's scatters and sorts differ")
    rr = res[0]["dp"]["render"]
    print(f"(i2) MapRenderer(mesh=) {PARALLEL['render'][0]}x"
          f"{PARALLEL['render'][1]} of the DP(4) map: {rr['ms']:.1f} ms over "
          f"4 ranks, one rank {rr['one_ms']:.1f} ms; rgb max diff "
          f"{rr['rgb_max_diff']} (uint8), depth max rel diff "
          f"{rr['depth_max_rel']:.3g}", flush=True)
    check(rr["rgb_max_diff"] <= 1 and rr["depth_max_rel"] <= 1e-3,
          "(i2) the data-parallel render against one rank's")
    ngp = res[0]["ngp"]
    print(f"(i2) NGP DP2 x TP2: losses {ngp['losses']}, ms a step "
          f"{[round(t, 2) for t in ngp['ms']]}, occupied share "
          f"{ngp['occupied']:.4f}, grid max {ngp['grid_max']:.4g}, alike on "
          f"every rank {all(r['ngp']['grid_equal'] for r in res)}; launches "
          f"by rank {[r['ngp']['launches'] for r in res]}", flush=True)
    check(all(r["ngp"]["grid_equal"] for r in res) and ngp["grid_finite"]
          and ngp["grid_max"] > 0, "(i2) NGP occupancy grid")
    for n_it, e in res[0]["dense_ba"].items():
        print(f"(i2) make_sharded_dense_ba, {PARALLEL['ba_frames']} frames "
              f"at {PARALLEL['ba_hw'][0]}x{PARALLEL['ba_hw'][1]}, "
              f"{PARALLEL['ba_edges']} edges, window "
              f"{PARALLEL['ba_window']}, {n_it} iteration(s): "
              f"{e['ms']:.1f} ms over 4 ranks, one rank {e['one_ms']:.1f} "
              f"ms; against one rank: poses {e['pose_max']:.3g}, costs rel "
              f"{e['cost_rel']:.3g}, inverse depth mean rel "
              f"{e['disp_mean_rel']:.3g} (max {e['disp_max_rel']:.3g}), "
              f"covariance max rel {e['cov_max_rel']:.3g}", flush=True)
    e1, e2 = res[0]["dense_ba"][1], res[0]["dense_ba"][2]
    check(e1["pose_max"] <= 1e-4 and e1["disp_mean_rel"] <= 2e-4
          and e1["cov_max_rel"] <= 1e-2 and e2["cost_rel"] <= 1e-4
          and e2["disp_mean_rel"] <= 1e-3,
          "(i2) the sharded dense BA against one rank's")
    d4 = res[0]["droid"]
    dpose = float(np.abs(d4["poses"] - one["poses"]).max())
    ddisp = float(np.mean(np.abs(d4["disps"] - one["disps"])
                          / np.abs(one["disps"])))
    alike = all(np.array_equal(r["droid"]["poses"], d4["poses"])
                and np.array_equal(r["droid"]["disps"], d4["disps"])
                for r in res)
    print(f"(i2) DROIDSLAMTracker(mesh=): {PARALLEL['droid_frames']} frames "
          f"in {d4['s']:.1f} s on each of 4 ranks (one rank alone "
          f"{one['s']:.1f} s), {d4['keyframes']} keyframes, alike on every "
          f"rank {alike}; against one rank: poses max diff {dpose:.3g}, "
          f"inverse depth mean rel {ddisp:.3g}", flush=True)
    check(alike and d4["keyframes"] == one["keyframes"] and dpose <= 1e-2
          and ddisp <= 1e-2, "(i2) the sharded-BA tracker against one rank's")
    print(f"(i) {time.perf_counter() - t0:.1f} s in all; peak GiB by rank "
          f"{[round(r['peak_gib'], 2) for r in res]}", flush=True)
    if bad:
        fail(f"(i) checks failed: {bad}")
    launches = {name: {"i1": {m: r1[m]["launches"][name] for m in r1},
                       **{m: [r[m]["launches"][name] for r in res]
                          for m in ("dp", "rows", "tp", "ds", "ngp")}}
                for name in TP_ROWS + (SORT,)}
    return launches, res[0]["held"]


# ---------------------------------------------------------------------------
# (j) the checkpoint hooks, NERF_VO_PIXEL_DTYPE, the parity harness
# ---------------------------------------------------------------------------

HOOK_ENV = {"dpvo": "NERF_VO_DPVO_WEIGHTS",
            "depth": "NERF_VO_OMNIDATA_DEPTH_WEIGHTS",
            "normal": "NERF_VO_OMNIDATA_NORMAL_WEIGHTS"}
# (j1): the replica front end with normals, fed phase (b)'s first frames
HOOKED = dict(REPLICA, enhancement_module="depth_normal")
HOOK_FRAMES = 16
# keys of a real Omnidata file that no loader reads
OMNIDATA_EXTRA = ("pretrained.act_postprocess1.0.project.0.weight",
                  "pretrained.act_postprocess2.3.weight",
                  "pretrained.model.norm.weight",
                  "pretrained.model.head.weight")
# what (j2) keeps of each of (c)'s packets: the keys MappingStage.update reads
PACKET_KEYS = ("camera_intrinsics", "camera_extrinsics", "frames_color_float",
               "frames_depth", "frames_normal", "frames_depth_cov")


@contextlib.contextmanager
def hook_env(**values):
    """Sets (or with ``None`` unsets) env vars for a block, then puts them
    back as they were."""
    def put(env):
        for k, v in env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    saved = {k: os.environ.get(k) for k in values}
    put(values)
    try:
        yield
    finally:
        put(saved)


def write_checkpoints(tmp):
    """(j1)'s three files in the upstream layouts, from seeded port nets
    at the replica width: ``dpvo.pth`` with ``module.`` prefixes and a
    non-zero ``update.lmbda``; the Omnidata depth and normal models as
    ``{"state_dict": {"model." + k: v}}`` with keys the port's module
    lacks. Returns the paths and the state dicts the stages must load."""
    from nerf_vo_tpu_torch.models.dpt import DPTHybrid
    from nerf_vo_tpu_torch.models.dpvo_net import DPVONet

    paths = {name: os.path.join(tmp, f) for name, f in (
        ("dpvo", "dpvo.pth"), ("depth", "omnidata_depth.ckpt"),
        ("normal", "omnidata_normal.ckpt"))}
    torch.manual_seed(1)
    vo = DPVONet(corr_radius=RADIUS).state_dict()
    torch.save(dict({"module." + k: v for k, v in vo.items()},
                    **{"module.update.lmbda": torch.tensor([0.37])}),
               paths["dpvo"])
    sds = {"dpvo": vo}
    for name, ch, seed in (("depth", 1, 2), ("normal", 3, 3)):
        torch.manual_seed(seed)
        sd = DPTHybrid(ch, image_size=REPLICA["enhancement_image_size"],
                       depth_layers=12, dtype=torch.float32).state_dict()
        blob = {"model." + k: v for k, v in sd.items()}
        for i, k in enumerate(OMNIDATA_EXTRA):
            blob["model." + k] = torch.full((8,), float(i))
        torch.save({"state_dict": blob, "epoch": 1}, paths[name])
        sds[name] = sd
    return paths, sds


def same_params(name, module, sd):
    """Every tensor of ``module`` equals ``sd``'s, key for key."""
    got = module.state_dict()
    if sorted(got) != sorted(sd):
        fail(f"(j1) {name} has other keys than its checkpoint")
    for k, v in sd.items():
        if not torch.equal(got[k].cpu(), v):
            fail(f"(j1) {name}'s {k} is not the checkpoint's tensor")


def bitwise(x, y, where):
    """Packets, tensors and arrays equal bit for bit."""
    if isinstance(x, dict):
        if sorted(x) != sorted(y):
            fail(f"(j1) {where}: other keys")
        for k in x:
            bitwise(x[k], y[k], f"{where}/{k}")
    elif torch.is_tensor(x):
        if not (torch.is_tensor(y) and x.dtype == y.dtype
                and torch.equal(x, y)):
            fail(f"(j1) {where} differs")
    elif isinstance(x, np.ndarray):
        if not np.array_equal(x, y):
            fail(f"(j1) {where} differs")
    elif x != y:
        fail(f"(j1) {where} differs: {x} != {y}")


def hooked_front_end(stage, enh, frames):
    """Tracks ``frames`` (the last flushes the stream) and enhances the
    first packet; returns the packets and the enhanced packet."""
    W, H = REPLICA["frame_width"], REPLICA["frame_height"]
    intr = dict(fx=320.0, fy=320.0, cx=W / 2, cy=H / 2)
    packets = []
    for i, img in enumerate(frames):
        pkt = stage.step(dict(frame_index=i, frame_color=img,
                              camera_intrinsics=intr,
                              last_frame=i == len(frames) - 1))
        if pkt is not None:
            packets.append(pkt)
    if not packets:
        fail("(j1) tracking retired no keyframe")
    out = enh.step(packets[0])
    torch.cuda.synchronize()
    return packets, out


def phase_hooks(dev, smi, tmp):
    """(j1) the DPVO and Omnidata checkpoint hooks at the replica width:
    the stages built with no weights and the three env vars set load the
    files (every parameter the file's tensor, ``lmbda`` zero) and track
    and enhance bit for bit as stages given the same state dicts do (both
    runs deterministic). Returns the hooks' paths and every kernel's
    launches in the hooked run."""
    from nerf_vo_tpu_torch.runtime.stages import (
        EnhancementStage,
        TrackingStage,
    )

    t0 = time.perf_counter()
    paths, sds = write_checkpoints(tmp)
    mb = sum(os.path.getsize(p) for p in paths.values()) / 2**20
    write_s = time.perf_counter() - t0
    args = SimpleNamespace(**HOOKED)
    t0 = time.perf_counter()
    with hook_env(**{HOOK_ENV[k]: p for k, p in paths.items()}):
        track = TrackingStage(args, device=dev)
        enh = EnhancementStage(args, device=dev)
    load_s = time.perf_counter() - t0
    same_params("the tracker's net",
                track.tracker.net, dict(sds["dpvo"], **{
                    "update.lmbda": torch.zeros(1)}))
    same_params("the depth DPT", enh.estimator.depth_model, sds["depth"])
    same_params("the normal DPT", enh.estimator.normal_model, sds["normal"])
    print(f"(j1) hooks: 3 checkpoints ({mb:.0f} MiB) written in "
          f"{write_s:.2f} s, loaded into TrackingStage + EnhancementStage "
          f"(12-block DPT-hybrid at 384, depth and normals) in {load_s:.2f} "
          f"s; every parameter is its file's tensor, update.lmbda 0 (the "
          f"file's 0.37 dropped), {len(OMNIDATA_EXTRA)} extra keys a file "
          "dropped", flush=True)

    frames = synthetic_frames(N_FRAMES, REPLICA["frame_height"],
                              REPLICA["frame_width"])[:HOOK_FRAMES]
    with hook_env(**{v: None for v in HOOK_ENV.values()}):
        direct = TrackingStage(args, state_dict=sds["dpvo"], device=dev)
        direct_enh = EnhancementStage(args, depth_state_dict=sds["depth"],
                                      normal_state_dict=sds["normal"],
                                      device=dev)
    # the index_add_ sums of the update net and BA run deterministically,
    # so two runs can be held bit for bit
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        reset_launches()
        t0 = time.perf_counter()
        got, got_enh = hooked_front_end(track, enh, frames)
        run_s = time.perf_counter() - t0
        counts = read_launches()
        want, want_enh = hooked_front_end(direct, direct_enh, frames)
    finally:
        torch.use_deterministic_algorithms(False)
    if len(got) != len(want):
        fail("(j1) the hooked stage retired other packets")
    for i, (g, w) in enumerate(zip(got, want)):
        bitwise(g, w, f"packet {i}")
    bitwise(got_enh, want_enh, "the enhanced packet")
    traj = np.stack(list(track.tracker.trajectory().values()))
    if not np.isfinite(traj).all():
        fail("(j1) non-finite poses")
    if not counts["corr_two_level"]:
        fail("(j1) the hooked tracker never launched corr_two_level")
    if counts["corr_level"]:
        fail("(j1) the hooked tracker made one-level corr_level launches")
    print(f"(j1) {HOOK_FRAMES} frames tracked ({run_s:.2f} s with the "
          f"enhancement of one packet, deterministic algorithms on): "
          f"{len(got)} packets, "
          f"{sum(len(p['keyframe_indices']) for p in got)} keyframes, "
          f"bitwise equal to the stages given the same state dicts; "
          f"frames_depth / frames_normal of the first packet bitwise "
          f"equal; launches {counts}; {smi}", flush=True)
    del direct, direct_enh, track, enh, sds
    gc.collect()
    torch.cuda.empty_cache()

    with hook_env(NERF_VO_OMNIDATA_NORMAL_WEIGHTS=paths["depth"]):
        try:
            EnhancementStage(args, device=dev)
        except ValueError as e:
            if str(e) != "checkpoint head has 1 channels, model expects 3":
                fail(f"(j1) a 1-channel normal head raised {e!r}")
            print(f"(j1) a normal checkpoint with a 1-channel head raises: "
                  f"ValueError({str(e)!r})", flush=True)
        else:
            fail("(j1) a normal checkpoint with a 1-channel head loaded")
    return paths, counts


def save_packets(enhanced, frame_of, tmp):
    """(c)'s enhanced packets, the keys the mapping stage reads, to a file
    for (j2)'s child process."""
    path = os.path.join(tmp, "packets.pt")
    torch.save({"frame_of": list(frame_of),
                "packets": [{k: torch.as_tensor(p[k]).cpu()
                             for k in PACKET_KEYS if k in p}
                            for p in enhanced]}, path)
    return path


def pixel_f32_child(tmp):
    """(j2), in a process started with ``NERF_VO_PIXEL_DTYPE=float32``:
    ``MappingStage`` at the replica config fed (c)'s packets as (d) feeds
    them, 64 steps. The buffer must hold the inserted f32 rows exactly;
    rows 2-5 must launch, and the last step's largest call of each is held
    against its plain version and timed. Writes its results to
    ``<tmp>/j2.json``."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from nerf_vo_tpu_torch.mapping import keyframe_buffer as kb
    from nerf_vo_tpu_torch.ops import cuda_build
    from nerf_vo_tpu_torch.runtime.stages import MappingStage

    dev = torch.device("cuda", 0)
    cuda_build.build_all(["gather"])  # built by the parent: loads it
    if kb.PIXEL_DTYPE != torch.float32:
        fail(f"(j2) NERF_VO_PIXEL_DTYPE=float32 gave {kb.PIXEL_DTYPE}")
    blob = torch.load(os.path.join(tmp, "packets.pt"), weights_only=True)
    enhanced = [{k: v.to(dev) for k, v in p.items()}
                for p in blob["packets"]]
    stage = MappingStage(SimpleNamespace(**REPLICA, **MAPPING), device=dev)
    if stage.buffer.pixels.dtype != torch.float32:
        fail(f"(j2) the buffer holds {stage.buffer.pixels.dtype} pixels")
    reset_launches()
    history, times, per_step, calls = drive_mapping(
        stage, enhanced, blob["frame_of"], record=TABLE_ROWS)
    counts = read_launches()
    n = stage.num_inserted
    rows = torch.cat([torch.cat([p["frames_color_float"],
                                 p["frames_depth"][..., None]], -1)
                      for p in enhanced])[:n]
    if not torch.equal(stage.buffer.pixels[:n], rows.reshape(n, -1)):
        fail("(j2) the f32 buffer does not hold the inserted rows exactly")
    for name in TABLE_ROWS:
        if not counts[name]:
            fail(f"(j2) the f32-target mapping path never launched {name}")
    check_unfused(counts, "(j2) the f32-target mapping path")
    for name in CORR_KERNELS:
        if counts[name]:
            fail(f"(j2) the mapping path launched {name}")
    largest = {}  # each row's call with the most descriptors
    for c in calls:
        if c[0] not in largest or (call_shape(*c[:2])[0]
                                   > call_shape(*largest[c[0]][:2])[0]):
            largest[c[0]] = c
    held = hold_calls(list(largest.values()), "the f32-target step", "(j2)")
    steady = times[8:]
    out = dict(ms=sum(steady) / len(steady) * 1e3, launches=counts,
               per_step=per_step, keyframes=n, steps=len(history),
               first_loss=float(np.mean([h["rgb_loss"]
                                         for h in history[:8]])),
               last_loss=float(np.mean([h["rgb_loss"]
                                        for h in history[-8:]])),
               held=held)
    with open(os.path.join(tmp, "j2.json"), "w") as f:
        json.dump(out, f)


def phase_pixel_f32(smi, tmp, bf16_ms):
    """(j2) in a child process (the knob is read at import), then an
    invalid value, which must make the import fail. Returns the child's
    launches and its held calls."""
    env = dict(os.environ, NERF_VO_PIXEL_DTYPE="float32")
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, os.path.abspath(__file__),
                          "pixel-f32", tmp], env=env, capture_output=True,
                         text=True, timeout=600)
    child_s = time.perf_counter() - t0
    print(out.stdout, end="", flush=True)
    log(out.stderr[-4000:])
    if out.returncode:
        fail(f"(j2) the NERF_VO_PIXEL_DTYPE=float32 child exited "
             f"{out.returncode}")
    with open(os.path.join(tmp, "j2.json")) as f:
        res = json.load(f)
    print(f"(j2) NERF_VO_PIXEL_DTYPE=float32: {res['keyframes']} keyframes, "
          f"{res['steps']} steps, f32 buffer equal to the inserted rows; "
          f"steady {res['ms']:.2f} ms/step against (d)'s {bf16_ms:.2f} "
          f"ms/step at bf16 targets (another process, same card); rgb_loss "
          f"first 8 {res['first_loss']:.5f} -> last 8 "
          f"{res['last_loss']:.5f}; launches {res['launches']}, per "
          f"ordinary step (most seen) {res['per_step']}; child "
          f"{child_s:.1f} s; {smi}", flush=True)
    if not res["last_loss"] < res["first_loss"]:
        fail("(j2) rgb_loss did not fall at f32 targets")

    env["NERF_VO_PIXEL_DTYPE"] = "float16"
    bad = subprocess.run(
        [sys.executable, "-c", "import nerf_vo_tpu_torch.mapping."
         "keyframe_buffer"], env=env, capture_output=True, text=True,
        timeout=120, cwd=os.path.dirname(os.path.abspath(__file__)))
    want = ("ValueError: NERF_VO_PIXEL_DTYPE must be 'float32' or "
            "'bfloat16', got 'float16'")
    if bad.returncode == 0 or want not in bad.stderr:
        fail(f"(j2) NERF_VO_PIXEL_DTYPE=float16 did not raise: exit "
             f"{bad.returncode}, {bad.stderr[-500:]}")
    print(f"(j2) NERF_VO_PIXEL_DTYPE=float16: the import exits "
          f"{bad.returncode} with {want}", flush=True)
    return res["launches"], res["held"]


def phase_harness(metrics, paths):
    """(j3) the port's parity harness: (f)'s metrics as report rows with
    the hooks present, a dry run's stamp with them unset, and the abort
    of ``run_parity`` without them (before ``execute``: no dataset).
    ``configs/*.yaml`` needs yaml, which the card lacks: ``load_config``
    gets this script's copy of the replica config."""
    import io

    from nerf_vo_tpu_torch import parity

    config = dict(REPLICA, **MAPPING, **PIPELINE)
    lpips = bool(os.environ.get("NERF_VO_LPIPS_WEIGHTS"))
    with hook_env(**{HOOK_ENV[k]: p for k, p in paths.items()}):
        hooks = parity.weight_hooks_for(config)
        if parity.is_dry_run(hooks):
            fail(f"(j3) the hooks' files are not seen: {hooks}")
        rows = parity.report_rows("nerf_vo_replica", metrics, False)
    if [r["metric"] for r in rows] != parity.REPORT_METRICS:
        fail(f"(j3) the rows are not REPORT_METRICS: {rows}")
    by = {r["metric"]: r for r in rows}
    if not lpips and (by["2d/lpips"]["status"] != "N/A" or by["2d/lpips"][
            "note"] != "N/A (set NERF_VO_LPIPS_WEIGHTS)"):
        fail(f"(j3) the LPIPS row without its weights: {by['2d/lpips']}")
    if any(r["status"] == "DRY-RUN" for r in rows):
        fail("(j3) a row is stamped DRY-RUN with the checkpoints present")
    report = {"rows": [(r["metric"], r["value"], r["status"]) for r in rows],
              "verdict": parity.verdict({"room": rows}, False)}
    print(f"(j3) report rows of (f)'s metrics with the hooks present: "
          f"{json.dumps(report)}", flush=True)

    with hook_env(**{v: None for v in HOOK_ENV.values()}):
        hooks = parity.weight_hooks_for(config)
        dry = parity.is_dry_run(hooks)
        rows = parity.report_rows("nerf_vo_replica", metrics, dry)
        stamp = parity.verdict({"room": rows}, dry)
        weights = parity.weight_provenance(hooks)
        if not (dry and stamp.startswith("DRY-RUN")
                and weights["dpvo"]["weights"] == "RANDOM (dry run)"
                and all(r["status"] in ("DRY-RUN", "N/A", "INFO")
                        for r in rows)):
            fail(f"(j3) the dry run is not stamped: {stamp}, {rows}")
        err = io.StringIO()
        load = parity.load_config
        parity.load_config = lambda name: dict(config)
        try:
            with contextlib.redirect_stderr(err):
                parity.run_parity("nerf_vo_replica", device="cuda")
        except SystemExit as e:
            code = e.code
        else:
            code = 0
        finally:
            parity.load_config = load
    named = all(v in err.getvalue() for v in (
        "NERF_VO_DPVO_WEIGHTS", "NERF_VO_OMNIDATA_DEPTH_WEIGHTS"))
    if code != 2 or not named:
        fail(f"(j3) run_parity without checkpoints: exit {code}, "
             f"{err.getvalue()!r}")
    required = [h["env"] for h in hooks.values() if h["required"]]
    print(f"(j3) hooks unset: verdict {stamp!r}; run_parity exits 2 "
          f"naming {', '.join(required)}", flush=True)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs only "
                         "on an NVIDIA GPU")
    jtmp = tempfile.mkdtemp(prefix="chip_smoke_j_")
    try:
        run_phases(jtmp)
    finally:
        shutil.rmtree(jtmp, ignore_errors=True)


def run_phases(jtmp):
    """Phases (a)-(j); ``jtmp`` holds (j)'s checkpoints and (c)'s packets."""
    t_start = time.perf_counter()
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
    reports = cuda_build.build_all(["corr", "gather", "rendering"])
    log(f"kernels built in {time.perf_counter() - t0:.1f} s")
    for name, rep in reports.items():
        log(f"--- nvcc {name}:\n{rep}")

    kernels = (phase_corr(dev) + phase_gather(dev) + phase_descriptors(dev)
               + phase_interlevel(dev))
    phase_sdf_kernels(dev)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"(a) peak device memory {peak:.2f} GiB (the sdf.map rows' "
          "buffers at M = 42M)", flush=True)
    torch.cuda.reset_peak_memory_stats()  # (b)-(c)'s peak below is theirs
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
    reset_launches()
    map_ms, held_d = phase_mapping(dev, enhanced, frame_of)
    d_interlevel = read_launches()[INTERLEVEL]
    counts = {k.__name__: k.launches
              for k in gather_cuda.KERNELS + (gather_cuda.hash_descriptors,)}
    print(f"(d) launches on the mapping path: {counts}, {INTERLEVEL} "
          f"{d_interlevel} (its proposals distill); peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    for name, n in counts.items():
        if n == 0 and name not in BF16_KERNELS + UNFUSED:
            fail(f"the mapping path never launched {name}")
    check_unfused(counts, "the mapping path")

    variant_launches, held = phase_variants(dev, smi, enhanced, frame_of)
    phase_pyramid(dev, smi)
    save_packets(enhanced, frame_of, jtmp)  # for (j2)

    del packets, enhanced  # phases (b)-(d), (h) hold nothing on the card now
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
        eval_counts, eval_metrics = phase_evaluation(dev, smi, mapping,
                                                     args, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"(f) launches on the evaluation path: {eval_counts}; peak device "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
          flush=True)
    for name in ("gather_interp", "gather_interp_mm"):
        if not eval_counts[name]:
            fail(f"the evaluation path never launched {name}")
    for name in UNFUSED + ADJOINTS + (SORT, INTERLEVEL) + CORR_KERNELS:
        if eval_counts[name]:
            fail(f"the evaluation path launched {name} "
                 f"{eval_counts[name]} times: a gradient or tracking")
    del mapping, args
    gc.collect()
    torch.cuda.empty_cache()
    slam_counts = phase_slam(dev, smi)
    gc.collect()
    torch.cuda.empty_cache()
    parallel_launches, parallel_held = phase_parallel(dev, smi)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    paths, j1_launches = phase_hooks(dev, smi, jtmp)
    j2_launches, j2_held = phase_pixel_f32(smi, jtmp, map_ms)
    phase_harness(eval_metrics, paths)
    print(f"(j) {time.perf_counter() - t0:.1f} s; {smi}", flush=True)
    bf16_entry = dict(held["h2"][0][1], name="gather_interp_bf16",
                      route="cuda", source="nerf_vo_tpu_torch/csrc/gather.cu",
                      replaces="nerf_vo_tpu/ops/gather_pallas.py:133",
                      shapes=[t for _, t in held["h2"]])
    for entry in kernels + [bf16_entry]:  # launches of the entry points
        name = entry["name"]
        entry["launches"] = counts[name]
        entry["evaluation_launches"] = eval_counts[name]
        entry["slam_launches"] = slam_counts[name]
        for tag, c in variant_launches.items():
            entry[f"{tag}_launches"] = c[name]
        if name in TABLE_ROWS:
            entry["h1_proposal_f2"] = [t for n, t in held["h1"] if n == name]
        if name in ADJOINTS:
            entry["d_last_step"] = [t for n, t in held_d if n == name]
        if name in parallel_launches:  # (i): by case, per rank
            entry["i_launches"] = parallel_launches[name]
            entry["i_tp_route"] = [t for n, t in parallel_held if n == name]
        if name == INTERLEVEL:
            entry["d_launches"] = d_interlevel
        entry["j1_launches"] = j1_launches[name]
        entry["j2_launches"] = j2_launches[name]
        if name in TABLE_ROWS:
            entry["j2_f32_targets"] = [t for n, t in j2_held if n == name]
        if name == SORT:  # timed on each held scatter's ids
            entry.update({k: [t["sort"] for n, t in h
                              if n == "scatter_cols_outer"]
                          for k, h in (("h1_proposal_f2", held["h1"]),
                                       ("d_last_step", held_d),
                                       ("i_tp_route", parallel_held),
                                       ("j2_f32_targets", j2_held))})
    # the bf16 kernel's path is (h2)'s: no other path has a bf16 table
    bf16_entry["launches"] = variant_launches["h2"]["gather_interp_bf16"]
    kernels.append(bf16_entry)

    print(f"chip_smoke: phases (a)-(j) in "
          f"{time.perf_counter() - t_start:.1f} s; {smi}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def sdf_kernels_only():
    """Phase (a)'s sdf.map rows alone (``python3 chip_smoke.py
    sdf-kernels``): the kernels built, then :func:`phase_sdf_kernels`."""
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from nerf_vo_tpu_torch.ops import cuda_build

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    cuda_build.build_all(["gather"])
    phase_sdf_kernels(torch.device("cuda", 0))
    print(json.dumps({"ok": True}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["pixel-f32"]:  # (j2)'s child process
        pixel_f32_child(sys.argv[2])
    elif sys.argv[1:2] == ["sdf-kernels"]:
        sdf_kernels_only()
    else:
        main()
