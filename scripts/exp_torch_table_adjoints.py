"""The hash grid's two backward kernels, ``gather_cols_dfrac`` (the
position pullback) and ``scatter_cols_outer`` (the table gradient, on the
ids sorted by ``sort_ids``), against the chains they replaced and the
scatter against its other designs, on one NVIDIA GPU.

    python3 scripts/exp_torch_table_adjoints.py [--skip-h1]

Builds ``nerf_vo_tpu_torch/csrc/gather.cu`` (the kernels the port runs),
``scripts/exp_torch_table_adjoints_variants.cu`` (the port's design with
each weight formed from the descriptor's offsets and base corner in place
of read from W) and ``scripts/exp_torch_table_adjoints_prior.cu`` (the
scatter as it was before ``sort_ids``: ``torch.sort``, then the runs
kernel and a separate combine launch) into
``nerf_vo_tpu_torch/_build/adjoints/`` (git-ignored). Then, on the card:

- at ``chip_smoke.py`` phase (a)'s field shape (uniform random points):
  the scatter's designs held within the f32 summation bound, each called
  twice to see whether it repeats bitwise, and timed in turns port,
  other, other, port, whole and per level: the earlier design
  (``torch.sort``, runs, combine), the same kernels on ``sort_ids``'s
  order (the combine not folded in), W from (frac, local);
  ``sort_ids`` against ``torch.sort`` in turns; each kernel beside the
  chain it replaced (``chip_smoke.adjoint_timing``);
- ``chip_smoke.py``'s phases (b) and (c) for their packets, (d)'s 64 steps
  of the replica mapper recording the last step's calls of both kernels:
  per level of each field scatter, descriptors, id runs, distinct ids and
  the most descriptors on one id (``chip_smoke.print_id_runs``); then the
  same comparisons on those calls, and on the (i2)-shaped call cut from
  the field scatter: the level-1 descriptors of the first half of the rays
  whose bricks rank 0 of a 2-way table shard holds, as local ids into its
  24,576 rows (what one DP2 x TP2 rank scatters);
- unless ``--skip-h1``, (h1)'s 64 steps of nerfstudio's mapper: its
  F = 2 calls, as above.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
import time
from types import SimpleNamespace

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from nerf_vo_tpu_torch.ops import cuda_build  # noqa: E402
from nerf_vo_tpu_torch.ops import gather_cuda as gc  # noqa: E402
from nerf_vo_tpu_torch.ops import hash_grid as hg  # noqa: E402

SCRIPTS = os.path.join(ROOT, "scripts")
OUT = cuda_build.BUILD / "adjoints"
LIBS = {"variants": "exp_torch_table_adjoints_variants.cu",
        "prior": "exp_torch_table_adjoints_prior.cu"}


def build_variants():
    """The scatter's other designs, built into _build/adjoints/ (both
    sources at once) and loaded: (variants, prior)."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in LIBS.items():
        cmd = [cuda_build._nvcc(), "-gencode", cuda_build.ARCH,
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-I",
               ROOT, "-o", str(OUT / f"lib{name}.so"),
               os.path.join(SCRIPTS, src)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
    return load_variants(), load_prior()


def load_variants():
    """The variants library :func:`build_variants` built, loaded."""
    dll = ctypes.CDLL(str(OUT / "libvariants.so"))
    p, i = ctypes.c_void_p, ctypes.c_int
    dll.scatter_cols_outer_tri.argtypes = [p] * 8 + [i, i, i, p]
    dll.scatter_cols_outer_tri.restype = ctypes.c_int
    dll.scatter_cols_outer_tri_slots.argtypes = [i, i]
    dll.scatter_cols_outer_tri_slots.restype = ctypes.c_longlong
    return dll


def load_prior():
    dll = ctypes.CDLL(str(OUT / "libprior.so"))
    p, i = ctypes.c_void_p, ctypes.c_int
    for fn in (dll.scatter_cols_outer_prior,
               dll.scatter_cols_outer_prior_perm32):
        fn.argtypes = [p] * 7 + [i, i, i, p]
        fn.restype = ctypes.c_int
    dll.scatter_cols_outer_prior_slots.argtypes = [i, i, i]
    dll.scatter_cols_outer_prior_slots.restype = ctypes.c_longlong
    return dll


def _stream():
    return torch.cuda.current_stream().cuda_stream


def _check(rc, what):
    if rc:
        raise SystemExit(f"{what} launch failed: cudaError {rc}")


def prior_scatter(lib, W, cot, idx, nb, own_sort):
    """The earlier design: ``torch.sort`` (int64 positions) then runs and
    the separate combine; with ``own_sort`` the same kernels on
    ``sort_ids``' keys and int32 positions."""
    M, F = cot.shape
    out = torch.zeros(nb, 32 * F, device=W.device)
    if own_sort:
        sidx, perm = gc.sort_ids(idx, nb)
        fn = lib.scatter_cols_outer_prior_perm32
    else:
        sidx, perm = torch.sort(idx, stable=True)
        fn = lib.scatter_cols_outer_prior
    slots = int(lib.scatter_cols_outer_prior_slots(M, F,
                                                   perm.element_size()))
    part = torch.empty(slots, 32 * F, device=W.device)
    meta = torch.empty(2 * slots + 1, dtype=torch.int32, device=W.device)
    _check(fn(W.data_ptr(), cot.data_ptr(), sidx.data_ptr(), perm.data_ptr(),
              out.data_ptr(), part.data_ptr(), meta.data_ptr(), M, F, nb,
              _stream()), "prior")
    return out


def tri_scatter(lib, local, frac, cot, idx, nb):
    """The port's design with W formed from (frac, local)."""
    M, F = cot.shape
    out = torch.zeros(nb, 32 * F, device=cot.device)
    sidx, perm = gc.sort_ids(idx, nb)
    slots = int(lib.scatter_cols_outer_tri_slots(M, F))
    part = torch.empty(slots, 32 * F, device=cot.device)
    part_id = torch.empty(slots, dtype=torch.int32, device=cot.device)
    _check(lib.scatter_cols_outer_tri(
        frac.data_ptr(), local.data_ptr(), cot.data_ptr(), sidx.data_ptr(),
        perm.data_ptr(), out.data_ptr(), part.data_ptr(), part_id.data_ptr(),
        M, F, nb, _stream()), "tri")
    return out


def turns(label, a, b, names, nbytes):
    """a, b, b, a by cs.cuda_ms (20 calls after one warm-up), back to back
    and queued behind a device sleep."""
    bound, _ = cs.bound(nbytes, 0)
    for queued in (False, True):
        t = [cs.cuda_ms(f, 20, queued) for f in (a, b, b, a)]
        how = "queued" if queued else "back to back"
        print(f"{label} ({how}): {names[0]} {t[0]:.4f} / {t[3]:.4f} ms, "
              f"{names[1]} {t[1]:.4f} / {t[2]:.4f} ms; bound {bound:.4f} "
              f"ms", flush=True)


def compare(libs, label, W, cot, idx, nb, cells=None, dfrac=None,
            levels=0):
    """The scatter on one call's inputs, held and timed beside its chain
    and its sort (chip_smoke.adjoint_timing), then against its other
    designs: each held, called twice to see whether it repeats bitwise,
    and timed in turns with the port's, whole and per level; ``cells``
    (local, frac) of the same descriptors for the W-from-offsets design;
    ``dfrac``: the position pullback's recorded arguments, held and timed
    beside its chain."""
    variants, prior = libs
    cs.adjoint_timing("scatter_cols_outer", (W, cot, idx, nb), label, "(x)")
    if dfrac is not None:
        cs.adjoint_timing("gather_cols_dfrac", dfrac, label, "(x)")
    F = cot.shape[1]
    il = idx.long()
    live = (il >= 0) & (il < nb)
    terms = torch.zeros(nb, device=W.device).index_add_(
        0, il[live], torch.ones(int(live.sum()), device=W.device))
    port = lambda w, c, i, cl: gc.scatter_cols_outer(w, c, i, nb)  # noqa
    designs = [("earlier: torch.sort, runs, combine",
                lambda w, c, i, cl: prior_scatter(prior, w, c, i, nb, False)),
               ("sort_ids, runs, separate combine",
                lambda w, c, i, cl: prior_scatter(prior, w, c, i, nb, True))]
    if cells is not None:
        designs.append(("W from (frac, local)",
                        lambda w, c, i, cl: tri_scatter(variants, *cl, c, i,
                                                        nb)))
    want = port(W, cot, idx, cells)
    for name, fn in designs:
        a, b = fn(W, cot, idx, cells), fn(W, cot, idx, cells)
        torch.cuda.synchronize()
        cs.check_sums(f"scatter_cols_outer, {name}, at {label}", a,
                      gc.scatter_cols_outer_plain(W, cot, idx, nb),
                      gc.scatter_cols_outer_plain(W.abs(), cot.abs(), idx,
                                                  nb),
                      terms[:, None], "(x)")
        print(f"(x) {label}: {name} repeats bitwise over two calls: "
              f"{torch.equal(a, b)}; bitwise the port's: "
              f"{torch.equal(a, want)}", flush=True)
    turns(f"(x) {label} sort_ids M={idx.shape[0]}",
          lambda: gc.sort_ids(idx, nb),
          lambda: torch.sort(idx, stable=True), ("sort_ids", "torch.sort"),
          12 * idx.shape[0])
    n = W.shape[0] // levels if levels else W.shape[0]
    parts = [("whole call", slice(0, W.shape[0]))]
    parts += [(f"level {lv} alone", slice(lv * n, (lv + 1) * n))
              for lv in range(levels)]
    for part, sl in parts:
        w_, c_, i_ = W[sl], cot[sl], idx[sl]
        cl = None if cells is None else tuple(x[sl] for x in cells)
        m = w_.shape[0]
        for name, fn in designs:
            turns(f"(x) {label} scatter_cols_outer {part} M={m} F={F}",
                  lambda: port(w_, c_, i_, cl),
                  lambda: fn(w_, c_, i_, cl), ("port", name),
                  m * (32 * 4 + 4 * F + 4) + nb * 32 * F * 4)


def dfrac_of(calls, idx):
    """The recorded position-pullback call over the same descriptors as a
    scatter's ids, or None."""
    for name, a, _ in calls:
        if (name == "gather_cols_dfrac" and a[1].shape == idx.shape
                and torch.equal(a[1], idx)):
            return a
    return None


def i2_shaped(a, d):
    """From the field scatter ``a`` (and its pullback's ``d``): the level-1
    descriptors of the first half of the rays whose bricks lie in rank 0's
    half of a 2-way table shard, as local ids into its rows."""
    W, c, i, nb = a[:4]
    n = i.shape[0] // cs.FIELD_LEVELS
    sel = torch.arange(n, n + n // 2, device=i.device)
    half = nb // 2
    sel = sel[i[sel] < half]
    take = lambda t: t[sel].contiguous()  # noqa: E731
    return (take(W), take(c), take(i), half), (take(d[3]), take(d[4]))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--skip-h1", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    t0 = time.perf_counter()
    reports = cuda_build.build_all(["gather", "corr"])
    for name, rep in reports.items():
        print(f"--- nvcc {name}:\n{rep}", flush=True)
    libs = build_variants()
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)

    tab, idx, W, n, cot, hot, local, frac = cs.gather_inputs(dev)
    cfg = hg.HashGridConfig(3, 8, 19, 16, 2048)
    first = [lv * cfg.bricks_per_level for lv in range(3)]
    compare(libs, "(a) the field shape", W, cot, idx, tab.shape[0],
            (local, frac), (tab, idx, cot, local, frac, first,
                            cfg.resolutions), levels=cs.FIELD_LEVELS)
    del tab, idx, W, cot, local, frac

    packets, frame_of, _, _ = cs.phase_tracking(dev)
    enhanced = cs.phase_enhancement(dev, packets)
    del packets
    from nerf_vo_tpu_torch.runtime.stages import MappingStage
    stage = MappingStage(SimpleNamespace(**cs.REPLICA, **cs.MAPPING),
                         device=dev)
    _, times, per_step, calls = cs.drive_mapping(stage, enhanced, frame_of,
                                                 cs.ADJOINTS)
    steady = times[8:]
    print(f"(d) {sum(steady) / len(steady) * 1e3:.2f} ms a step; launches "
          f"per ordinary step {per_step}", flush=True)
    del stage
    for name, a, _ in calls:
        if name != "scatter_cols_outer" or a[1].shape[1] != 8:
            continue
        d = dfrac_of(calls, a[2])
        label = f"(d) the field, M={a[2].shape[0]}"
        cs.print_id_runs(a[2], cs.FIELD_LEVELS, label)
        compare(libs, label, *a[:4], None if d is None else (d[3], d[4]), d,
                levels=cs.FIELD_LEVELS)
        if d is not None and a[2].shape[0] == cs.FIELD_LEVELS * n:
            ia, cells = i2_shaped(a, d)
            compare(libs, f"(i2)-shaped, M={ia[2].shape[0]}", *ia, cells)
    cs.hold_calls([c for c in calls if cs.call_shape(c[0], c[1])[1] != 8],
                  "the mapping step's proposal grids", "(d)")
    del calls

    if not args.skip_h1:
        stage, _, _, _, calls = cs.run_variant(
            dev, smi, "h1", cs.NERFSTUDIO, enhanced, frame_of,
            record=cs.ADJOINTS)
        del stage
        held = [c for c in calls if cs.call_shape(c[0], c[1])[1] == 2]
        for name, a, _ in held:
            if name == "scatter_cols_outer":
                d = dfrac_of(held, a[2])
                label = f"(h1) M={a[2].shape[0]}"
                cs.print_id_runs(a[2], cs.PROPOSAL_LEVELS, label)
                compare(libs, label, *a[:4],
                        None if d is None else (d[3], d[4]), d,
                        levels=cs.PROPOSAL_LEVELS)
    print(f"done in {time.perf_counter() - t0:.1f} s; {smi}", flush=True)


if __name__ == "__main__":
    main()
