"""Drive the PyTorch port's nerf_vo main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card, ``nvcc``
(``/usr/local/cuda``) and PyTorch built for CUDA. It builds every kernel of
the path from ``nerf_vo_tpu_torch/csrc/`` (into ``nerf_vo_tpu_torch/_build/``,
one ``nvcc`` per source, all started together), then runs four phases; any
failure ends the run with a non-zero exit:

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
      all, then one full-frame render.

Output: progress on stderr; on stdout the card's name and power limit, the
per-phase results, one JSON line with every kernel's numbers, and as the
last line ``{"ok": true, "device": {...}}``. Without a CUDA device it exits
non-zero before printing any result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
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
N_FRAMES = 48
RADIUS = 3
MAP_STEPS = 64
STEPS_PER_FRAME = 4  # the serial pipeline's mapping_steps_per_frame
RAYS = MAPPING["rays_per_batch"]
FIELD_SAMPLES, PROPOSAL_SAMPLES = 48, (96, 48)
F32_FLOP_PER_S = 67e12  # f32 outside the tensor cores
SLEEP_CYCLES = 100_000_000  # ~50 ms of device clock
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
    from nerf_vo_tpu_torch.ops import correlation_cuda as cc

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    pf, f1, f2, ring, ctr = corr_inputs(gen, dev)
    E = pf.shape[0]
    n = 9 * (2 * RADIUS + 1) ** 2

    def plain():
        pf9 = pf.reshape(E, 9, -1)
        return torch.cat([
            cc.corr_level_plain(f1, pf9, ring, ctr, RADIUS),
            cc.corr_level_plain(f2, pf9, ring, ctr * 0.5, RADIUS),
        ], dim=1)

    got = cc.patch_correlation_kernel(pf, f1, f2, ring, ctr, RADIUS)
    torch.cuda.synchronize()
    want = plain()
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    tol = 1e-3 * scale  # both accumulate in f32, in another order
    zero_rows = (want == 0).all(1)
    print(f"(a) corr_level: E={E} edges, max|ref| {scale:.4f}, max abs err "
          f"{err:.3e} (tol {tol:.3e}), rel {err / scale:.3e}; "
          f"{int(zero_rows.sum())} all-zero rows (off-frame centres)",
          flush=True)
    if not np.isfinite(err) or err > tol:
        fail(f"corr kernel disagrees with its plain version: {err} > {tol}")
    if not torch.equal(got[zero_rows], want[zero_rows]):
        fail("corr kernel wrote non-zero values for off-frame centres")
    if got[:, :n].abs().sum() == 0:
        fail("corr kernel output is all zero")

    ms = cuda_ms(lambda: cc.patch_correlation_kernel(pf, f1, f2, ring, ctr,
                                                     RADIUS), 50)
    plain_ms = cuda_ms(plain, 5)
    bound_ms, bound_by = corr_bound(pf, f1, f2, ring, ctr)
    print(f"(a) corr_level per update (2 launches): kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"({bound_by}), kernel at {bound_ms / ms:.1%} of the bound",
          flush=True)
    return [{
        "name": "corr_level", "route": "cuda",
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


def table_bytes(tab, idx):
    """Bytes of the table rows a descriptor list touches, each read once."""
    return int(torch.unique(idx).numel()) * tab.shape[1] * 4


def bound(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def time_kernel(name, fn, plain, library, nbytes, flops, err, reps=20):
    ms = cuda_ms(fn, reps)
    queued_ms = cuda_ms(fn, reps, queued=True)
    plain_ms = cuda_ms(plain, 3)
    library_ms = cuda_ms(library, reps) if library is not None else None
    bound_ms, bound_by = bound(nbytes, flops)
    lib = "none" if library_ms is None else f"{library_ms:.4f} ms"
    print(f"(a) {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"library {lib}, bound {bound_ms:.4f} ms ({bound_by}), kernel at "
          f"{bound_ms / ms:.1%} of the bound; max abs err {err:.3e}; "
          f"queued behind a device sleep {queued_ms:.4f} ms "
          f"({bound_ms / queued_ms:.1%} of the bound)", flush=True)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms, max_abs_err=err)


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

    from nerf_vo_tpu_torch.models.nerf_field import dense_grid
    from nerf_vo_tpu_torch.ops import gather_cuda as gc
    from nerf_vo_tpu_torch.ops import hash_grid as hg

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
        nbytes = table_bytes(t, i) + m * 4 + m * 32 * 4 + m * F * 4
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
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    for res, samples in zip((128, 160), PROPOSAL_SAMPLES):
        cfg = dense_grid(res)
        ptab = torch.randn(cfg.bricks_per_level, 32, generator=gen,
                           device=dev)
        x = torch.rand(RAYS * samples, 3, generator=gen, device=dev)
        pidx, _, _, pw, _ = hg._descriptors(x, cfg)
        interp_entry(f"gather_interp (proposal res {res})", 133,
                     gc.gather_interp, gc.gather_interp_plain, ptab, pidx,
                     pw, 1)
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
    return packets, frame_of, fps


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
    packets, frame_of, fps = phase_tracking(dev)
    launches = correlation_cuda.corr_level.launches
    kernels[0]["launches"] = launches
    print(f"(b) corr_level launches on the main path: {launches}",
          flush=True)
    if launches == 0:
        fail("the tracking path never launched the corr kernel")
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
    for entry in kernels[1:]:
        entry["launches"] = counts[entry["name"]]
        if entry["launches"] == 0:
            fail(f"the mapping path never launched {entry['name']}")

    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
