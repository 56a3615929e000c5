"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface. It is compiled with
``nvcc`` for ``sm_90a`` into ``_build/lib<name>-<hash>.so`` inside the package
(the hash is of the source and the compiler's flags, so an edited source or
a changed flag is rebuilt) and loaded with ``ctypes``. Nothing is built at
import: the first launch builds, or a caller builds every kernel up front
with :func:`build_all`, one ``nvcc`` process per source, all started
together.

The libraries link the CUDA runtime dynamically (``-cudart shared``), so
they call the ``libcudart.so.12`` that PyTorch has loaded: the profiler then
records each launch (the runtime call, under its kernel's correlation id),
and so the span it was made in (a statically linked runtime's launches are
invisible to it). So a source may call only runtime entry points that
PyTorch's runtime (``torch.version.cuda``) has, even where ``nvcc`` is
newer: a build warns when it is (:func:`runtime_warning`), and a library
calling an entry point that runtime lacks fails when ``ctypes`` loads it.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import warnings
from pathlib import Path
from typing import Dict, Iterable, Optional

PKG = Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
BUILD = PKG / "_build"
ARCH = "arch=compute_90a,code=sm_90a"
FLAGS = ("-gencode", ARCH, "-std=c++17", "-O3", "-shared", "-cudart",
         "shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA toolkit is required "
                           "to build the port's kernels")
    return path


def _release(text: str):
    """(major, minor) of a CUDA version in ``text``, or None."""
    m = re.search(r"(\d+)\.(\d+)", text or "")
    return (int(m.group(1)), int(m.group(2))) if m else None


def runtime_warning(nvcc_version: str, torch_cuda: Optional[str]):
    """The warning a build gives where PyTorch's CUDA runtime, which the
    libraries call, is older than the toolkit that builds them (
    ``nvcc_version`` is ``nvcc --version``'s output), else None."""
    m = re.search(r"release (\d+\.\d+)", nvcc_version)
    toolkit = _release(m.group(1)) if m else None
    runtime = _release(torch_cuda)
    if toolkit is None or runtime is None or runtime >= toolkit:
        return None
    return (f"the port's kernels are built by nvcc {m.group(1)} and call "
            f"PyTorch's CUDA runtime {torch_cuda}: a source may call only "
            f"runtime entry points that CUDA {torch_cuda} has")


@functools.lru_cache(maxsize=None)
def _check_runtime(nvcc: str) -> None:
    import torch

    out = subprocess.run([nvcc, "--version"], capture_output=True,
                         text=True).stdout
    message = runtime_warning(out, torch.version.cuda)
    if message:
        warnings.warn(message, RuntimeWarning, stacklevel=3)


def library_path(name: str) -> Path:
    """The library of ``csrc/<name>.cu``, named by a hash of the source and
    of :data:`FLAGS`."""
    digest = hashlib.sha1((CSRC / f"{name}.cu").read_bytes())
    digest.update("\0".join(FLAGS).encode())
    return BUILD / f"lib{name}-{digest.hexdigest()[:12]}.so"


def _command(name: str, out: Path):
    return [_nvcc(), *FLAGS, "-o", str(out), str(CSRC / f"{name}.cu")]


def build_all(names: Iterable[str]) -> Dict[str, str]:
    """Compile every named kernel that is not built yet, in parallel.

    Returns each name's compiler output (``-Xptxas -v`` register and
    shared-memory report); raises if any build fails.
    """
    BUILD.mkdir(exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        _check_runtime(_nvcc())
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(
            _command(name, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True,
        ), tmp, out)
    reports, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        reports[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return reports


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu``, building it if needed."""
    build_all([name])
    return ctypes.CDLL(str(library_path(name)))
