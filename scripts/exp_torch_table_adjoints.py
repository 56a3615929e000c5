"""The hash grid's two fused table adjoints, ``gather_cols_dot`` and
``scatter_cols_outer``, against the chains they replaced and the scatter
against its other designs, on one NVIDIA GPU.

    python3 scripts/exp_torch_table_adjoints.py [--skip-h1]

Builds ``nerf_vo_tpu_torch/csrc/gather.cu`` (the kernels the port runs;
``scatter_cols_outer`` sorts the ids and sums each id's terms in order,
with no atomics) and ``scripts/exp_torch_table_adjoints_variants.cu`` (the
same function by runs of the ids in the order given, added with atomics,
at every F; and by 32-column slabs with level 0's rows on chip at F = 8;
on no path) into ``nerf_vo_tpu_torch/_build/adjoints/`` (git-ignored).
Then, on the card:

- at ``chip_smoke.py`` phase (a)'s field shape (uniform random points, no
  runs): the three scatter designs held within the f32 summation bound,
  each called twice to see whether it repeats bitwise, and timed in turns
  port, variant, variant, port; each kernel beside the chain it replaced
  (row 2, the cast, product and sum; the materialized ``W (x) cot`` rows,
  then row 5); ``hash_grid._dfrac`` beside the three ``einsum`` calls it
  replaced;
- ``chip_smoke.py``'s phases (b) and (c) for their packets, (d)'s 64 steps
  of the replica mapper recording the last step's calls of both kernels:
  per level of each field scatter, descriptors, id runs, distinct ids and
  the most descriptors on one id (``chip_smoke.print_id_runs``); then the
  same comparisons on those calls, the scatter also per level alone;
- unless ``--skip-h1``, (h1)'s 64 steps of nerfstudio's mapper: its
  F = 2 calls held, and each scatter's ids and designs as above.
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

VARIANTS = os.path.join(ROOT, "scripts",
                        "exp_torch_table_adjoints_variants.cu")


def build_variants():
    """The scatter's other two designs, built into _build/adjoints/ and
    loaded."""
    out_dir = cuda_build.BUILD / "adjoints"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / "libscatter_outer_variants.so"
    cmd = [cuda_build._nvcc(), "-gencode", cuda_build.ARCH, "-std=c++17",
           "-O3", "-shared", "-Xcompiler", "-fPIC", "-I", ROOT, "-o",
           str(lib), VARIANTS]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    if proc.returncode:
        raise SystemExit(f"nvcc failed for the variants:\n{proc.stdout}")
    return load_variants()


def load_variants():
    """The library :func:`build_variants` built, loaded."""
    lib = cuda_build.BUILD / "adjoints" / "libscatter_outer_variants.so"
    dll = ctypes.CDLL(str(lib))
    p, i = ctypes.c_void_p, ctypes.c_int
    dll.scatter_cols_outer_slabs.argtypes = [p, p, p, p, i, i, i, p]
    dll.scatter_cols_outer_atomic_runs.argtypes = [p, p, p, p, i, i, i, p]
    for fn in (dll.scatter_cols_outer_slabs,
               dll.scatter_cols_outer_atomic_runs):
        fn.restype = ctypes.c_int
    return dll


def slab_scatter(lib, W, cot, idx, nb, hot):
    out = torch.zeros(nb, 32 * cot.shape[1], device=W.device)
    rc = lib.scatter_cols_outer_slabs(
        W.data_ptr(), cot.data_ptr(), idx.data_ptr(), out.data_ptr(),
        W.shape[0], nb, hot, torch.cuda.current_stream().cuda_stream)
    if rc:
        raise SystemExit(f"slab launch failed: cudaError {rc}")
    return out


def atomic_scatter(lib, W, cot, idx, nb):
    out = torch.zeros(nb, 32 * cot.shape[1], device=W.device)
    rc = lib.scatter_cols_outer_atomic_runs(
        W.data_ptr(), cot.data_ptr(), idx.data_ptr(), out.data_ptr(),
        W.shape[0], cot.shape[1], nb, torch.cuda.current_stream().cuda_stream)
    if rc:
        raise SystemExit(f"atomic runs launch failed: cudaError {rc}")
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


def compare(lib, label, W, cot, idx, nb, hot, tab, levels=0):
    """Both adjoints on one call's inputs: held, timed beside their chains,
    and the scatter against its other designs: each held, called twice to
    see whether it repeats bitwise, and timed in turns (also per level);
    ``hot`` is the slab design's rows on chip."""
    cs.adjoint_timing("scatter_cols_outer", (W, cot, idx, nb), label, "(x)")
    F = cot.shape[1]
    il = idx.long()
    live = (il >= 0) & (il < nb)
    terms = torch.zeros(nb, device=W.device).index_add_(
        0, il[live], torch.ones(int(live.sum()), device=W.device))
    designs = [("sorted, no atomics (the port)",
                lambda w, c, i: gc.scatter_cols_outer(w, c, i, nb)),
               ("atomic runs",
                lambda w, c, i: atomic_scatter(lib, w, c, i, nb))]
    if F == 8:
        designs.append(("slabs",
                        lambda w, c, i: slab_scatter(lib, w, c, i, nb, hot)))
    for name, fn in designs:
        a, b = fn(W, cot, idx), fn(W, cot, idx)
        torch.cuda.synchronize()
        cs.check_sums(f"scatter_cols_outer, {name}, at {label}", a,
                      gc.scatter_cols_outer_plain(W, cot, idx, nb),
                      gc.scatter_cols_outer_plain(W.abs(), cot.abs(), idx,
                                                  nb),
                      terms[:, None], "(x)")
        print(f"(x) {label}: {name} repeats bitwise over two calls: "
              f"{torch.equal(a, b)}", flush=True)
    sort_ms = [cs.cuda_ms(lambda: torch.sort(idx, stable=True), 20, q)
               for q in (False, True)]
    print(f"(x) {label}: the port's torch.sort of the ids alone "
          f"{sort_ms[0]:.4f} ms, queued {sort_ms[1]:.4f} ms", flush=True)
    n = W.shape[0] // levels if levels else W.shape[0]
    parts = [("whole call", slice(0, W.shape[0]))]
    parts += [(f"level {lv} alone", slice(lv * n, (lv + 1) * n))
              for lv in range(levels)]
    for part, sl in parts:
        w_, c_, i_ = W[sl], cot[sl], idx[sl]
        m = w_.shape[0]
        for name, fn in designs[1:]:
            turns(f"(x) {label} scatter_cols_outer {part} M={m} F={F}",
                  lambda: designs[0][1](w_, c_, i_),
                  lambda: fn(w_, c_, i_), ("port", name),
                  m * (32 * 4 + 4 * F + 4) + nb * 32 * F * 4)
    if tab is not None:
        cs.adjoint_timing("gather_cols_dot", (tab, idx, cot), label, "(x)")


def dfrac_pair(dev):
    """hash_grid._dfrac against the three einsum calls it replaced, at the
    field's (a) descriptors (589,824)."""
    cfg = hg.HashGridConfig(3, 8, 19, 16, 2048)
    g = torch.Generator(device=dev)
    g.manual_seed(1)
    x = torch.rand(cs.RAYS * cs.FIELD_SAMPLES, 3, generator=g, device=dev)
    _, local, frac, _, _ = hg._descriptors(x, cfg)
    dW = torch.randn(local.shape[0], 32, generator=g, device=dev)

    def einsum_form():
        M = dW.shape[0]
        d = dW[:, :27].reshape(M, 3, 3, 3)
        w = [hg._axis_weights(local[:, a], frac[:, a]) for a in range(3)]
        dw = [hg._axis_dweights(local[:, a]) for a in range(3)]
        return torch.stack([
            torch.einsum("mijk,mi,mj,mk->m", d, dw[0], w[1], w[2]),
            torch.einsum("mijk,mi,mj,mk->m", d, w[0], dw[1], w[2]),
            torch.einsum("mijk,mi,mj,mk->m", d, w[0], w[1], dw[2]),
        ], dim=-1)

    new = lambda: hg._dfrac(dW, local, frac)  # noqa: E731
    err = (new() - einsum_form()).abs().max().item()
    print(f"(x) _dfrac at M={dW.shape[0]}: max abs diff to the einsum form "
          f"{err:.3e}", flush=True)
    turns(f"(x) _dfrac M={dW.shape[0]}", einsum_form, new,
          ("einsum", "broadcast"), 0)


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
    lib = build_variants()
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)

    tab, idx, W, n, cot, hot = cs.gather_inputs(dev)
    compare(lib, "(a) the field shape", W, cot, idx, tab.shape[0], hot, tab,
            levels=cs.FIELD_LEVELS)
    del tab, idx, W, cot
    dfrac_pair(dev)

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
    tabs = [a[0] for name, a, _ in calls if name == "gather_cols_dot"]
    for name, a, _ in calls:
        if name != "scatter_cols_outer" or a[1].shape[1] != 8:
            continue
        Wc, c, i, nb = a[:4]
        label = f"(d) the field, M={i.shape[0]}"
        cs.print_id_runs(i, cs.FIELD_LEVELS, label)
        tab = next((t for t in tabs if t.shape[0] == nb), None)
        compare(lib, label, Wc, c, i, nb, hot, tab, levels=cs.FIELD_LEVELS)
    cs.hold_calls([c for c in calls if cs.call_shape(c[0], c[1])[1] != 8],
                  "the mapping step's proposal grids", "(d)")
    del calls, tabs

    if not args.skip_h1:
        stage, _, _, _, calls = cs.run_variant(
            dev, smi, "h1", cs.NERFSTUDIO, enhanced, frame_of,
            record=cs.ADJOINTS)
        del stage
        held = [c for c in calls if cs.call_shape(c[0], c[1])[1] == 2]
        for name, a, _ in held:
            if name == "scatter_cols_outer":
                label = f"(h1) M={a[2].shape[0]}"
                cs.print_id_runs(a[2], cs.PROPOSAL_LEVELS, label)
                compare(lib, label, *a[:4], 0, None,
                        levels=cs.PROPOSAL_LEVELS)
        cs.hold_calls(held, "the hash proposals' last step", "(h1)")
    print(f"done in {time.perf_counter() - t0:.1f} s; {smi}", flush=True)


if __name__ == "__main__":
    main()
