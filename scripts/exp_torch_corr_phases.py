"""Where the correlation kernel's time goes, on one NVIDIA GPU.

    python3 scripts/exp_torch_corr_phases.py

Builds variants of ``nerf_vo_tpu_torch/csrc/corr.cu`` into
``nerf_vo_tpu_torch/_build/phases/`` (git-ignored): the kernel as it is,
without the dots, without the bilinear blend, and without both (the
variants write wrong outputs; only their times are read), each once as
shipped (the launch sorts the edges by target slot) and once walking an
order the caller gives in place of the sort. Each variant also counts, per
warp, the SM clock cycles spent in each phase of its edge loop (waiting
for a level's window, the level's dots and blend, issuing the next edge's
copies). Runs them on ``chip_smoke.py``'s phase (a) inputs (30,240 edges,
replica shapes): in slot order sorted inside the launch, and in the
caller's order (the identity order given); the whole kernel also in a slot
order that ``torch.argsort`` makes outside the timed calls and inside
each. Prints for each the time of one call queued behind a device sleep
and the mean cycles per edge by phase. The variants are made by editing
the source text at fixed anchors; a changed source fails loudly.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from nerf_vo_tpu_torch.ops import correlation_cuda as cc  # noqa: E402
from nerf_vo_tpu_torch.ops import cuda_build  # noqa: E402

PHASES = ["wait level 0", "level 0 dots + blend", "issue next level 0 + A",
          "wait level 1", "level 1 dots + blend", "issue next level 1"]
PHASE_VARIANTS = {"kernel": [], "no dots": ["-DNO_DOTS"],
                  "no blend": ["-DNO_BLEND"],
                  "no dots, no blend": ["-DNO_DOTS", "-DNO_BLEND"]}
# (variant, given order): with GIVEN_ORDER the launch walks the order that
# its scratch argument holds instead of sorting
VARIANTS = {(name, given): flags + (["-DGIVEN_ORDER"] if given else [])
            for name, flags in PHASE_VARIANTS.items()
            for given in (False, True)}
MAX_WARPS = 8192


def instrumented_source() -> str:
    s = (cuda_build.CSRC / "corr.cu").read_text()

    def rep(anchor, new):
        nonlocal s
        if anchor not in s:
            raise SystemExit(f"corr.cu changed: anchor not found:\n{anchor}")
        s = s.replace(anchor, new, 1)

    rep("namespace {\n\nconstexpr int kMaxWarps",
        f"__device__ long long g_prof[{MAX_WARPS} * 8];\n\n"
        "namespace {\n\nconstexpr int kMaxWarps")
    rep("  if (sort) {\n    slot_sort(reinterpret_cast<int*>(smem), ring, "
        "scratch, E, R);\n    order = scratch + kMaxBlocks * (R + 1);\n"
        "  }\n",
        "#ifdef GIVEN_ORDER\n  order = scratch;\n#else\n"
        "  if (sort) {\n    slot_sort(reinterpret_cast<int*>(smem), ring, "
        "scratch, E, R);\n    order = scratch + kMaxBlocks * (R + 1);\n"
        "  }\n#endif\n")
    rep("  for (; t + 4 <= nt; t += 4)\n",
        "#ifndef NO_DOTS\n  for (; t + 4 <= nt; t += 4)\n")
    rep("  for (; t < nt; ++t) dot_tiles<KS, 1>(win, a, t, cw, NW, box_bytes,"
        " lane);\n",
        "  for (; t < nt; ++t) dot_tiles<KS, 1>(win, a, t, cw, NW, box_bytes,"
        " lane);\n#endif\n#ifdef NO_BLEND\n  __syncwarp();\n"
        "  if (lane == 0) __stcs(o, cw[0]);\n  return;\n#endif\n")
    rep("  for (; i < E; i += G) {\n",
        "  long long T[8] = {0, 0, 0, 0, 0, 0, 0, 0};\n"
        "  long long t0 = clock64(), t1;\n"
        "#define TICK(k) t1 = clock64(); T[k] += t1 - t0; t0 = t1;\n"
        "  for (; i < E; i += G) {\n    TICK(7)\n")
    rep("      ph0 ^= 1;\n    }\n", "      ph0 ^= 1;\n    }\n    TICK(0)\n")
    rep("    __syncwarp();\n\n    // the next edge's level 0",
        "    __syncwarp();\n    TICK(1)\n\n    // the next edge's level 0")
    rep("    if (levels > 1) {\n", "    TICK(2)\n    if (levels > 1) {\n")
    rep("        ph1 ^= 1;\n      }\n", "        ph1 ^= 1;\n      }\n"
        "      TICK(3)\n")
    rep("      __syncwarp();\n    }\n", "      __syncwarp();\n      TICK(4)\n"
        "    }\n")
    rep("    g1 = n1;\n  }\n}\n",
        "    g1 = n1;\n    TICK(5)\n  }\n  if (lane == 0) {\n"
        "    const long long gw = static_cast<long long>(blockIdx.x) * wpb"
        " + warp;\n    for (int k = 0; k < 8; ++k) g_prof[gw * 8 + k] = T[k];"
        "\n  }\n}\n")
    s += ("\nextern \"C\" int get_prof(void* dst) {\n  return (int)"
          "cudaMemcpyFromSymbol(dst, g_prof, sizeof(long long) * "
          f"{MAX_WARPS} * 8);\n}}\n")
    return s


def build():
    out_dir = cuda_build.BUILD / "phases"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / "corr_phases.cu"
    src.write_text(instrumented_source())
    procs = {}
    for (name, given), flags in VARIANTS.items():
        stem = name.replace(" ", "_").replace(",", "")
        lib = out_dir / f"lib{stem}{'_given' if given else ''}.so"
        cmd = [cuda_build._nvcc(), "-gencode", cuda_build.ARCH, "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", *flags, "-o",
               str(lib), str(src)]
        procs[name, given] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        dll = ctypes.CDLL(str(lib))
        p, i = ctypes.c_void_p, ctypes.c_int
        dll.corr_two_level.argtypes = [p] * 7 + [i] * 9 + [p]
        dll.get_prof.argtypes = [p]
        libs[name] = dll
    return libs


def main():
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    libs = build()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    pf, f1, f2, ring, ctr = cs.corr_inputs(gen, dev)
    E, R = pf.shape[0], f1.shape[0]
    pf9 = pf.reshape(E, 9, -1)
    out = torch.empty(E, 2 * 9 * (2 * cs.RADIUS + 1) ** 2, device=dev)
    scratch = torch.empty(cc.SORT_BLOCKS * (R + 1) + E, dtype=torch.int32,
                          device=dev)
    identity = torch.arange(E, dtype=torch.int32, device=dev)
    argsorted = torch.argsort(ring, stable=True).to(torch.int32)
    want = cc.corr_two_level(pf9, f1, f2, ring, ctr, cs.RADIUS)

    def call(lib, walk):
        order = walk()  # held until the launch is queued
        rc = lib.corr_two_level(
            f1.data_ptr(), f2.data_ptr(), pf9.data_ptr(), ring.data_ptr(),
            ctr.data_ptr(), order.data_ptr(), out.data_ptr(), E, R,
            f1.shape[1], f1.shape[2], f2.shape[1], f2.shape[2], f1.shape[3],
            cs.RADIUS, out.stride(0), torch.cuda.current_stream().cuda_stream)
        if rc:
            raise SystemExit(f"launch failed: cudaError {rc}")

    runs = []
    for name in PHASE_VARIANTS:
        runs.append((name, False, "slot order sorted in the launch",
                     lambda: scratch))
        runs.append((name, True, "caller's order", lambda: identity))
    runs.append(("kernel", True, "argsort slot order made outside the "
                 "timed calls", lambda: argsorted))
    runs.append(("kernel", True, "argsort slot order made in each call",
                 lambda: torch.argsort(ring, stable=True).to(torch.int32)))
    for name, given, order, walk in runs:
        lib = libs[name, given]
        call(lib, walk)
        torch.cuda.synchronize()
        if name == "kernel":
            err = (out - want).abs().max().item()
            if err > 1e-3 * want.abs().max().item():
                raise SystemExit(f"instrumented kernel ({order}) is wrong: "
                                 f"{err}")
        prof = np.zeros(MAX_WARPS * 8, np.int64)
        lib.get_prof(prof.ctypes.data)
        per_edge = prof.reshape(MAX_WARPS, 8).sum(0) / E
        ms = cs.cuda_ms(lambda: call(lib, walk), 30, queued=True)
        phases = ", ".join(f"{p} {c:.0f}" for p, c in zip(PHASES, per_edge))
        print(f"{name}, {order}: {ms:.4f} ms queued; warp cycles per edge: "
              f"{phases}", flush=True)


if __name__ == "__main__":
    main()
