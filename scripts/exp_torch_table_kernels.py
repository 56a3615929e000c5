"""``scatter_cols_accum`` and ``gather_cols`` at the hash proposals' F = 2
shapes, against the design they replaced, on one NVIDIA GPU.

    python3 scripts/exp_torch_table_kernels.py [--out DIR]

Builds ``nerf_vo_tpu_torch/csrc/gather.cu`` (the kernels the port runs) and
``scripts/exp_torch_table_kernels_prior.cu`` (the earlier design of the
same source, on no path: a block's strided share of the descriptors with
one float4 atomic per 16 bytes for the scatter, one warp a descriptor for
the gather) into ``nerf_vo_tpu_torch/_build/`` (git-ignored). Then it runs
``chip_smoke.py``'s phases (b) and (c) for their packets and (h1)'s 64
steps of nerfstudio's mapper (hash proposals, interlevel, per-sample
normals), recording the last step's calls of both kernels, and for each
F = 2 call (proposal 0: 5 levels x 4096 rays x 96 samples; proposal 1: x
48):

- per level of the scatter's ids: descriptors, id runs, distinct ids and
  the most descriptors on one id (``chip_smoke.print_id_runs``);
- both designs held against the plain version (the scatter within the f32
  summation bound of its terms, the gather bitwise) and timed by
  ``chip_smoke.py``'s timer in turns earlier, current, current, earlier,
  on the whole call and (the scatter) on each level's slice alone;
- the same pair at ``chip_smoke.py`` phase (a)'s F = 8 shapes (rows 2 and
  5: uniform random points through the field grid), and the gather at
  49,237 of those ids over the table's first half (about (i2)'s
  table-sharded call).

Writes the scatters' ids (int32, ``np.savez_compressed``) to
``--out``/h1_ids.npz (default ``nerf_vo_tpu_torch/_build/table_kernels``,
git-ignored), which ``scripts/model_scatter_runs.py`` reads.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from nerf_vo_tpu_torch.ops import cuda_build  # noqa: E402
from nerf_vo_tpu_torch.ops import gather_cuda as gc  # noqa: E402

PRIOR = os.path.join(ROOT, "scripts", "exp_torch_table_kernels_prior.cu")


def build_prior():
    """Builds the earlier design into _build/prior/ and loads it."""
    out_dir = cuda_build.BUILD / "prior"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / "libgather_prior.so"
    cmd = [cuda_build._nvcc(), "-gencode", cuda_build.ARCH, "-std=c++17",
           "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", str(lib), PRIOR]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    if proc.returncode:
        raise SystemExit(f"nvcc failed for the earlier design:\n"
                         f"{proc.stdout}")
    dll = ctypes.CDLL(str(lib))
    p, i = ctypes.c_void_p, ctypes.c_int
    dll.gather_cols.argtypes = [p, p, p, i, i, i, p]
    dll.scatter_cols_accum.argtypes = [p, p, p, i, i, i, i, p]
    dll.gather_cols.restype = ctypes.c_int
    dll.scatter_cols_accum.restype = ctypes.c_int
    return dll


def prior_scatter(lib, g, idx, nb, hot):
    out = torch.zeros(nb, g.shape[1], device=g.device)
    rc = lib.scatter_cols_accum(g.data_ptr(), idx.data_ptr(), out.data_ptr(),
                                g.shape[0], g.shape[1] // 32, nb, hot,
                                torch.cuda.current_stream().cuda_stream)
    if rc:
        raise SystemExit(f"scatter launch failed: cudaError {rc}")
    return out


def prior_gather(lib, tab, idx):
    out = torch.empty(idx.shape[0], tab.shape[1], dtype=torch.bfloat16,
                      device=tab.device)
    rc = lib.gather_cols(tab.data_ptr(), idx.data_ptr(), out.data_ptr(),
                         idx.shape[0], tab.shape[1], tab.shape[0],
                         torch.cuda.current_stream().cuda_stream)
    if rc:
        raise SystemExit(f"gather launch failed: cudaError {rc}")
    return out


def hold_scatter(name, got, g, i, nb):
    il = i.long()
    live = (il >= 0) & (il < nb)
    terms = torch.zeros(nb, device=g.device).index_add_(
        0, il[live], torch.ones(int(live.sum()), device=g.device))
    return cs.check_sums(name, got, gc.scatter_cols_accum_plain(g, i, nb),
                         gc.scatter_cols_accum_plain(g.abs(), i, nb),
                         terms[:, None], "(x)")


def pair(label, prior_fn, new_fn, nbytes):
    """earlier, current, current, earlier by cs.cuda_ms (20 calls after one
    warm-up), back to back and queued behind a device sleep."""
    b, _ = cs.bound(nbytes, 0)
    for queued in (False, True):
        t = [cs.cuda_ms(f, 20, queued)
             for f in (prior_fn, new_fn, new_fn, prior_fn)]
        how = "queued" if queued else "back to back"
        print(f"{label} ({how}): earlier {t[0]:.4f} / {t[3]:.4f} ms, current "
              f"{t[1]:.4f} / {t[2]:.4f} ms; bound {b:.4f} ms; current at "
              f"{b / min(t[1], t[2]):.1%} of the bound", flush=True)


def compare_scatter(lib, label, g, i, nb, hot, levels=0):
    got = gc.scatter_cols_accum(g, i, nb, hot_rows=hot)
    got_p = prior_scatter(lib, g, i, nb, hot)
    torch.cuda.synchronize()
    hold_scatter(f"scatter current {label}", got, g, i, nb)
    hold_scatter(f"scatter earlier {label}", got_p, g, i, nb)
    n = g.shape[0] // levels if levels else g.shape[0]
    parts = [(f"{label} scatter M={g.shape[0]} R={g.shape[1]} into {nb} "
              f"bricks, hot {hot}", g, i)]
    parts += [(f"{label} scatter, level {lv} alone", g[lv * n:(lv + 1) * n],
               i[lv * n:(lv + 1) * n]) for lv in range(levels)]
    for name, gs, js in parts:
        pair(name, lambda: prior_scatter(lib, gs, js, nb, hot),
             lambda: gc.scatter_cols_accum(gs, js, nb, hot_rows=hot),
             gs.numel() * 4 + gs.shape[0] * 4 + nb * gs.shape[1] * 4)


def compare_gather(lib, label, tab, i):
    want = gc.gather_cols_plain(tab, i)
    got, got_p = gc.gather_cols(tab, i), prior_gather(lib, tab, i)
    torch.cuda.synchronize()
    if not (torch.equal(got, want) and torch.equal(got_p, want)):
        raise SystemExit(f"{label}: gather_cols differs from plain")
    pair(f"{label} gather_cols M={i.shape[0]} R={tab.shape[1]} over "
         f"{tab.shape[0]} bricks (both bitwise)",
         lambda: prior_gather(lib, tab, i), lambda: gc.gather_cols(tab, i),
         cs.table_bytes(tab, i) + i.shape[0] * (4 + tab.shape[1] * 2))


def h1_calls(dev, smi):
    packets, frame_of, _, _ = cs.phase_tracking(dev)
    enhanced = cs.phase_enhancement(dev, packets)
    del packets
    stage, _, _, _, calls = cs.run_variant(
        dev, smi, "h1", cs.NERFSTUDIO, enhanced, frame_of,
        record=("gather_cols", "scatter_cols_accum"))
    del stage, enhanced
    return [c for c in calls if c[1][0].shape[1] == 64]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=str(cuda_build.BUILD / "table_kernels"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    os.makedirs(args.out, exist_ok=True)
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    t0 = time.perf_counter()
    cuda_build.build_all(["gather", "corr"])
    lib = build_prior()
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)

    # (a)'s F = 8 shapes: rows 2 and 5
    tab, idx, W, n, cot, hot, _, _ = cs.gather_inputs(dev)
    compare_gather(lib, "(a) F=8", tab, idx)
    rows = (W[:, :, None] * cot[:, None, :]).reshape(idx.shape[0], 256)
    compare_scatter(lib, "(a) F=8", rows, idx, tab.shape[0], hot)
    # (i2)'s table-sharded gather_cols, approximately: owned ids of the
    # first half of the table
    own = idx[idx < tab.shape[0] // 2][:49237].contiguous()
    compare_gather(lib, "(a) F=8 half table", tab[:tab.shape[0] // 2], own)
    del tab, idx, W, cot, rows

    ids = {}
    for name, a, kw in h1_calls(dev, smi):
        label = f"(h1) proposal M={a[1].shape[0]}"
        if name == "scatter_cols_accum":
            g, i, nb = a[:3]
            cs.print_id_runs(i, cs.PROPOSAL_LEVELS, label)
            compare_scatter(lib, label, g, i, nb, kw.get("hot_rows", 0),
                            levels=cs.PROPOSAL_LEVELS)
            ids[f"scatter_{g.shape[0]}"] = i.cpu().numpy()
        else:
            compare_gather(lib, label, *a[:2])
    np.savez_compressed(os.path.join(args.out, "h1_ids.npz"), **ids)
    print(f"done in {time.perf_counter() - t0:.1f} s; {smi}", flush=True)


if __name__ == "__main__":
    main()
