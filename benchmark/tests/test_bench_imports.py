"""Nothing the benchmark runs imports JAX or the JAX package (top-level
names compared whole, so ``nerf_vo_tpu_torch`` passes), and the references
import nothing of the program."""

import ast
import os
import subprocess
import sys

from benchmark import harness

ROOT = harness.ROOT
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "nerf_vo_tpu"}


def _imports(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_sources_import_no_jax():
    files = sorted((ROOT / "benchmark").rglob("*.py"))
    assert len(files) > 10
    for f in files:
        bad = set(_imports(f)) & FORBIDDEN
        if "reference" in f.relative_to(ROOT).parts:
            bad |= set(_imports(f)) & {"nerf_vo_tpu_torch"}
        assert not bad, (f, bad)


def test_a_run_loads_no_jax():
    code = (
        "import sys; sys.path.insert(0, sys.argv[1])\n"
        "from benchmark import harness\n"
        "cell = harness.Cell('vo.map')\n"
        "import nerf_vo_tpu_torch.runtime.stages\n"
        "from nerf_vo_tpu_torch.ops import gather_cuda\n"
        "for m in cell.metrics(True) + cell.metrics(False):\n"
        "    cell.reader(m['name'])\n"
        "print(harness.forbidden_modules())\n")
    env = dict(os.environ, USE_FLAX="0")
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)], env=env,
                         capture_output=True, text=True, timeout=300,
                         cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_run_refuses_without_the_card_and_outside_a_checkout(tmp_path):
    run = [sys.executable, str(ROOT / "benchmark/run.py"), "--workload",
           "vo.map", "--seed", "5", "--seconds", "1", "--trace", "0"]
    out = subprocess.run(run, capture_output=True, text=True, timeout=300,
                         cwd=ROOT, env=dict(os.environ,
                                            CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0 and out.stdout == ""
    # a directory with BENCHMARK.json and the benchmark's files only
    import shutil
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark")
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    run[1] = str(tmp_path / "benchmark/run.py")
    out = subprocess.run(run, capture_output=True, text=True, timeout=300,
                         cwd=tmp_path)
    assert out.returncode != 0 and out.stdout == ""
