"""Whether ``chip_smoke.py`` (i2)'s descriptor-sharded train step agrees
with DP(4) on every run, and whether DP(4) repeats itself, on one NVIDIA
GPU (four gloo ranks share the card, as in (i2)).

    python3 scripts/exp_torch_ds_repeats.py [REPS] [--scatter port|atomic]

Each repetition trains DP(4) and the descriptor-sharded 2 x 2 step for
(i2)'s 8 steps from the same init on the same rays a rank, holds the
descriptor-sharded parameters against DP(4) by (i2)'s own rule
(``chip_smoke.params_agree``), and DP(4) against the first repetition's
DP(4). ``--scatter`` picks the table gradient's scatter on every rank:
``port`` (``gather_cuda.scatter_cols_outer``: ids sorted, no atomics) or
``atomic`` (the same function by runs added with float4 atomics, built
from ``scripts/exp_torch_table_adjoints_variants.cu``).
Prints one line a repetition and the count of failed checks.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time
from types import SimpleNamespace

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import chip_smoke as cs  # noqa: E402
from nerf_vo_tpu_torch.ops import cuda_build  # noqa: E402


def rank_fn(rank, world, dev, spec, reps, scatter):
    from nerf_vo_tpu_torch.mapping import keyframe_buffer as kb
    from nerf_vo_tpu_torch.ops import gather_cuda as gc
    from nerf_vo_tpu_torch.parallel import dist as pdist

    if scatter == "atomic":
        import exp_torch_table_adjoints as adj

        lib = adj.load_variants()
        gc.scatter_cols_outer = (
            lambda W, cot, idx, nb: adj.atomic_scatter(lib, W, cot, idx, nb))
    args = SimpleNamespace(**spec["args"])
    K = spec["keyframes"]
    H, W = args.frame_height, args.frame_width
    mesh, mesh22 = pdist.make_mesh(), pdist.make_mesh_2d(2, 2)
    buf = kb.create(args.num_keyframes, H, W, use_normals=False, device=dev)
    kb.insert(buf, list(range(K)), cs.mapping_packet(dev, K, H, W, 7))

    def whole(p):
        m_ax = pdist.mesh_axis(mesh22, "model")
        for n in list(p):
            if n.endswith("tables"):
                p[n] = pdist.all_gather_cat(p[n].float().contiguous(), m_ax)
        return p

    rows, dp0 = [], None
    for r in range(reps):
        got = {}
        for mode, msh in (("dp", mesh), ("ds", mesh22)):
            model, _, state, first, *_ = cs.train_mode(
                args, dev, mode, buf, spec["steps"], msh)
            p = cs.params_of(model, state)
            names = cs.leaf_names(state)
            if mode == "ds":
                p, first = whole(p), whole(first)
            got[mode] = ({n: v.clone() for n, v in p.items()}, first)
        c = cs.compare_params(got["ds"][0], got["dp"][0], names)
        c1 = cs.compare_tight(got["ds"][1], got["dp"][1], names)
        least = min(c["wide"], key=c["wide"].get)
        row = dict(ok=cs.params_agree(c, c1), least_within_2_5_lr=least,
                   share=c["wide"][least], largest=c["worst"])
        if dp0 is None:
            dp0 = got["dp"][0]
        else:
            row["dp_equals_first_dp"] = all(
                torch.equal(got["dp"][0][n], dp0[n]) for n in names)
        rows.append(row)
        if rank == 0:
            print(f"repetition {r}: {row}", flush=True)
    return rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("reps", nargs="?", type=int, default=6)
    ap.add_argument("--scatter", choices=("port", "atomic"),
                    default="port")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    from nerf_vo_tpu_torch.parallel import dist as pdist

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    cuda_build.build_all(["corr", "gather"])
    if a.scatter == "atomic":
        import exp_torch_table_adjoints as adj

        adj.build_variants()
    t0 = time.perf_counter()
    res = pdist.spawn(rank_fn, 4, "cuda", args=(cs.parallel_spec(), a.reps,
                                                a.scatter), timeout=1200)
    fails = sum(not r["ok"] for r in res[0])
    print(f"scatter {a.scatter}: the ds check failed {fails} of {a.reps}; "
          f"{time.perf_counter() - t0:.1f} s; {smi}", flush=True)


if __name__ == "__main__":
    main()
