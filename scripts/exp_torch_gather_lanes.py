"""Lanes per descriptor for ``gather_interp`` at F = 1, on one NVIDIA GPU.

    python3 scripts/exp_torch_gather_lanes.py

Builds ``nerf_vo_tpu_torch/csrc/gather.cu`` three times into
``nerf_vo_tpu_torch/_build/lanes/`` (git-ignored), with 2, 4 and 8 lanes
serving one descriptor at F = 1 (``-DGI_LANES_F1``; the source's default is
the layout this comparison chose). Runs each on ``chip_smoke.py``'s
proposal-grid inputs (dense F = 1 grids at resolution 128 and 160, 4096
rays x 96 / 48 samples), checks it against the plain version (1e-5 of
max(|plain|, 1)) and prints the time of one call by ``chip_smoke.py``'s
timer, back to back and queued behind a device sleep.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from nerf_vo_tpu_torch.ops import cuda_build  # noqa: E402
from nerf_vo_tpu_torch.ops import gather_cuda as gc  # noqa: E402

LANES = (2, 4, 8)


def build():
    out_dir = cuda_build.BUILD / "lanes"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for lanes in LANES:
        lib = out_dir / f"libgather_lanes{lanes}.so"
        cmd = [cuda_build._nvcc(), "-gencode", cuda_build.ARCH, "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC",
               f"-DGI_LANES_F1={lanes}", "-o", str(lib),
               str(cuda_build.CSRC / "gather.cu")]
        procs[lanes] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT, text=True),
                        lib)
    libs = {}
    for lanes, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {lanes} lanes:\n{log}")
        dll = ctypes.CDLL(str(lib))
        p, i = ctypes.c_void_p, ctypes.c_int
        dll.gather_interp.argtypes = [p, p, p, p, i, i, i, p]
        dll.gather_interp.restype = ctypes.c_int
        libs[lanes] = dll
    return libs


def main():
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    libs = build()
    for res, tab, idx, w in cs.proposal_inputs(dev):
        out = torch.empty(idx.shape[0], 1, device=dev)
        want = gc.gather_interp_plain(tab, idx, w, 1)

        def call(lib):
            rc = lib.gather_interp(
                tab.data_ptr(), idx.data_ptr(), w.data_ptr(), out.data_ptr(),
                idx.shape[0], 1, tab.shape[0],
                torch.cuda.current_stream().cuda_stream)
            if rc:
                raise SystemExit(f"launch failed: cudaError {rc}")

        for lanes, lib in libs.items():
            call(lib)
            torch.cuda.synchronize()
            err = cs.check_close(f"gather_interp with {lanes} lanes", out,
                                 want, 1e-5)
            print(f"res {res}, M={idx.shape[0]}, {lanes} lanes per "
                  f"descriptor: {cs.cuda_ms(lambda: call(lib), 20):.4f} ms, "
                  f"queued {cs.cuda_ms(lambda: call(lib), 20, True):.4f} ms; "
                  f"max abs err {err:.3e}", flush=True)


if __name__ == "__main__":
    main()
