"""The port's core (Lie algebra, cameras, conventions) against the JAX
package, and the port's import boundary.

Inputs come from numpy with a fixed seed and go to both packages. Tolerance:
f32 on both sides, atol 1e-5 (the same formulas; only the rounding of
individual float32 operations may differ).
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_vo_tpu.core import cameras as jcam
from nerf_vo_tpu.core import conventions as jconv
from nerf_vo_tpu.core import lie as jlie
from nerf_vo_tpu_torch.core import cameras as tcam
from nerf_vo_tpu_torch.core import conventions as tconv
from nerf_vo_tpu_torch.core import lie as tlie

ATOL = 1e-5
REPO = Path(__file__).resolve().parents[1]


def _close(j, t, atol=ATOL):
    if isinstance(j, (tuple, list)):
        for a, b in zip(j, t):
            _close(a, b, atol)
        return
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=atol)


def _inputs(rng, n=16):
    xi = np.concatenate([rng.normal(size=(n, 3)),
                         rng.normal(size=(n, 3)) * 0.7], -1)
    xi[0, 3:] = 1e-6  # small-angle branch
    xi[1, 3:] = 0.0
    xi = xi.astype(np.float32)
    g1 = np.asarray(jlie.se3_exp(jnp.asarray(xi)))
    g2 = np.asarray(jlie.se3_exp(jnp.asarray(xi[::-1].copy())))
    p = rng.normal(size=(n, 3)).astype(np.float32)
    alpha = rng.uniform(size=n).astype(np.float32)
    return dict(xi=xi, g1=g1, g2=g2, p=p, alpha=alpha,
                q1=g1[:, 3:], q2=g2[:, 3:], phi=xi[:, 3:],
                m=np.asarray(jlie.quat_to_matrix(jnp.asarray(g1[:, 3:]))))


LIE_CASES = {
    "quat_mul": ("q1", "q2"),
    "quat_conj": ("q1",),
    "quat_normalize": ("q1",),
    "quat_rotate": ("q1", "p"),
    "quat_to_matrix": ("q1",),
    "matrix_to_quat": ("m",),
    "so3_hat": ("phi",),
    "so3_exp_quat": ("phi",),
    "so3_log": ("q1",),
    "so3_left_jacobian": ("phi",),
    "se3_inv": ("g1",),
    "se3_mul": ("g1", "g2"),
    "se3_act": ("g1", "p"),
    "se3_matrix": ("g1",),
    "se3_exp": ("xi",),
    "se3_log": ("g1",),
    "se3_retract": ("g1", "xi"),
    "se3_normalize": ("g1",),
    "se3_interp": ("g1", "g2", "alpha"),
    "se3_adjoint": ("g1",),
}


@pytest.mark.parametrize("name", sorted(LIE_CASES))
def test_lie_matches_jax(name):
    data = _inputs(np.random.default_rng(0))
    args = [data[k] for k in LIE_CASES[name]]
    want = getattr(jlie, name)(*[jnp.asarray(a) for a in args])
    got = getattr(tlie, name)(*[torch.tensor(a) for a in args])
    # log maps divide by a small sine near identity: allow 1e-4 there
    _close(want, got, 1e-4 if name.endswith("log") else ATOL)


def test_lie_identities_and_round_trips():
    data = _inputs(np.random.default_rng(1))
    g = torch.tensor(data["g1"])
    ident = tlie.se3_mul(g, tlie.se3_inv(g))
    np.testing.assert_allclose(ident.numpy(), tlie.se3_identity(
        (g.shape[0],)).numpy(), atol=ATOL)
    m = tlie.se3_matrix(g)
    back = tlie.se3_from_matrix(m)
    # q and -q are the same rotation: compare matrices
    np.testing.assert_allclose(tlie.se3_matrix(back).numpy(), m.numpy(),
                               atol=ATOL)


def _cam_inputs(rng, n=12):
    return dict(
        intr=np.asarray([100.0, 90.0, 64.0, 48.0], np.float32),
        xy=rng.uniform([0, 0], [128, 96], size=(n, 2)).astype(np.float32),
        depth=rng.uniform(0.5, 5.0, size=n).astype(np.float32),
        pts=np.concatenate([rng.normal(size=(n, 2)),
                            rng.uniform(0.5, 4, size=(n, 1))],
                           -1).astype(np.float32),
        c2w=np.asarray(jlie.se3_matrix(jlie.se3_exp(jnp.asarray(
            rng.normal(size=(n, 6)).astype(np.float32) * 0.5)))),
        pose=np.asarray(jlie.se3_exp(jnp.asarray(
            rng.normal(size=(n, 6)).astype(np.float32) * 0.5))),
        dist=np.asarray([0.1, -0.05, 0.002, -0.001], np.float32),
        xyn=rng.uniform(-0.5, 0.5, size=(n, 2)).astype(np.float32),
    )


CAM_CASES = {
    "intrinsics_matrix": (("intr",), {}),
    "project": (("pts", "intr"), {}),
    "project_gl": (("pts", "intr"), {"convention": "opengl"}),
    "unproject": (("xy", "depth", "intr"), {}),
    "unproject_gl": (("xy", "depth", "intr"), {"convention": "opengl"}),
    "pixel_directions": (("xy", "intr"), {}),
    "pixel_directions_gl": (("xy", "intr"), {"convention": "opengl"}),
    "generate_rays": (("c2w", "intr", "xy"), {}),
    "generate_rays_se3": (("pose", "intr", "xy"), {}),
    "distort_radtan": (("xyn", "dist"), {}),
    "undistort_radtan": (("xyn", "dist"), {}),
}


@pytest.mark.parametrize("case", sorted(CAM_CASES))
def test_cameras_match_jax(case):
    data = _cam_inputs(np.random.default_rng(2))
    keys, kw = CAM_CASES[case]
    name = case.removesuffix("_gl")
    args = [data[k] for k in keys]
    want = getattr(jcam, name)(*[jnp.asarray(a) for a in args], **kw)
    got = getattr(tcam, name)(*[torch.tensor(a) for a in args], **kw)
    _close(want, got)


def test_scale_intrinsics_matches_jax():
    intr = np.asarray([100.0, 90.0, 64.0, 48.0], np.float32)
    want = jcam.scale_intrinsics(intr, (96, 128), (360, 640))
    got = tcam.scale_intrinsics(torch.tensor(intr), (96, 128),
                                (360, 640))
    _close(want, got)


CONV_CASES = ["opencv_to_opengl", "opengl_to_opencv", "nerf_to_ngp",
              "ngp_to_nerf", "gauge_normalization_matrix",
              "apply_transform"]


@pytest.mark.parametrize("name", CONV_CASES)
def test_conventions_match_jax(name):
    data = _cam_inputs(np.random.default_rng(3))
    c2w = data["c2w"]
    args = {
        "gauge_normalization_matrix": (c2w[0],),
        "apply_transform": (c2w[1], c2w),
    }.get(name, (c2w,))
    kw = {"scale": 0.3} if "ngp" in name else {}
    want = getattr(jconv, name)(*[jnp.asarray(a) for a in args], **kw)
    got = getattr(tconv, name)(*[torch.tensor(a) for a in args], **kw)
    _close(want, got)


PORT_MODULES = [
    "nerf_vo_tpu_torch",
    "nerf_vo_tpu_torch.core.lie",
    "nerf_vo_tpu_torch.core.cameras",
    "nerf_vo_tpu_torch.core.conventions",
    "nerf_vo_tpu_torch.ops.correlation",
    "nerf_vo_tpu_torch.ops.correlation_cuda",
    "nerf_vo_tpu_torch.ops.cuda_build",
    "nerf_vo_tpu_torch.ops.ba",
    "nerf_vo_tpu_torch.ops.sh",
    "nerf_vo_tpu_torch.ops.rendering",
    "nerf_vo_tpu_torch.ops.losses",
    "nerf_vo_tpu_torch.ops.hash_grid",
    "nerf_vo_tpu_torch.ops.gather_cuda",
    "nerf_vo_tpu_torch.ops.dense_corr",
    "nerf_vo_tpu_torch.ops.dense_ba",
    "nerf_vo_tpu_torch.ops.occupancy",
    "nerf_vo_tpu_torch.models.droid_net",
    "nerf_vo_tpu_torch.tracking.droid_slam",
    "nerf_vo_tpu_torch.models.dpvo_net",
    "nerf_vo_tpu_torch.models.dpt",
    "nerf_vo_tpu_torch.models.nerf_field",
    "nerf_vo_tpu_torch.models.nerfacto",
    "nerf_vo_tpu_torch.mapping.keyframe_buffer",
    "nerf_vo_tpu_torch.mapping.trainer",
    "nerf_vo_tpu_torch.tracking.dpvo",
    "nerf_vo_tpu_torch.enhancement.omnidata",
    "nerf_vo_tpu_torch.enhancement.alignment",
    "nerf_vo_tpu_torch.runtime.stages",
    "nerf_vo_tpu_torch.runtime.perf",
    "nerf_vo_tpu_torch.runtime.viewer",
    "nerf_vo_tpu_torch.runtime.pipeline",
    "nerf_vo_tpu_torch.data.utils",
    "nerf_vo_tpu_torch.data.datasets",
    "nerf_vo_tpu_torch.run",
    "nerf_vo_tpu_torch.parity",
    "nerf_vo_tpu_torch.utils.torch_setup",
    "nerf_vo_tpu_torch.parallel",
    "nerf_vo_tpu_torch.parallel.dist",
    "nerf_vo_tpu_torch.parallel.sharding",
] + [f"nerf_vo_tpu_torch.evaluation.{m}" for m in (
    "meshio", "metrics", "lpips", "tsdf", "poisson", "datasets",
    "nerf_renderer", "renderer", "evaluator", "runner")]


def test_port_imports_no_jax_in_subprocess():
    """Importing the port (every module of the slice) loads neither JAX nor
    the JAX package."""
    code = (
        "import importlib, sys\n"
        f"for m in {PORT_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'nerf_vo_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def _imported_roots(path: Path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_port_sources_import_nothing_of_jax():
    """No file of the port, nor chip_smoke.py, nor the rank functions the
    parallel tests start in new processes, imports JAX, Flax, optax, the
    JAX package, the tests or the examples — not even lazily inside a
    function."""
    files = sorted((REPO / "nerf_vo_tpu_torch").rglob("*.py"))
    files += [REPO / "chip_smoke.py", REPO / "tests" /
              "torch_parallel_ranks.py"]
    banned = {"jax", "jaxlib", "flax", "optax", "nerf_vo_tpu", "tests",
              "examples"}
    for f in files:
        assert not _imported_roots(f) & banned, f
