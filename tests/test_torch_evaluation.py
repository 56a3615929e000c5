"""The port's evaluation building blocks (``nerf_vo_tpu_torch/evaluation/``:
meshio, metrics, poisson, tsdf, lpips, datasets) against the JAX
package's, on the CPU, with the same seeded numpy inputs.

Tolerances (measured spread in brackets):
- the numpy copies (PLY IO, sampling, ATE, PSNR, MSSIM, depth metrics,
  ICP, Poisson): exact [bitwise], except the mesh metrics, whose nearest
  neighbours the JAX package may take from its native C++ hash grid in
  f32 while the port uses ``cKDTree``: relative 1e-6;
- TSDF fusion: grid dims, origin and voxel size exact; tsdf, weight and
  color within 1e-5 [tsdf <= 1.6e-6: the JAX scan's dot and the port's
  ordered products round apart in the last bits; weight and color exact];
- the extractors on one volume: identical vertices and faces;
- LPIPS from one parameter tree: relative 1e-5 [3.4e-7];
- evaluation datasets: intrinsics, frames and evaluation frames exact;
  extrinsics within 1e-6 (the quaternion and SE3 interpolation run in f32
  in both packages) [<= 7.5e-9, ScanNet's interpolated poses; the
  others bitwise].
"""

from __future__ import annotations

import json
import os
from pathlib import Path

import cv2
import jax
import numpy as np
import pytest
import torch

from nerf_vo_tpu.evaluation import datasets as jdatasets
from nerf_vo_tpu.evaluation import lpips as jlpips
from nerf_vo_tpu.evaluation import meshio as jmeshio
from nerf_vo_tpu.evaluation import metrics as jmetrics
from nerf_vo_tpu.evaluation import poisson as jpoisson
from nerf_vo_tpu.evaluation import tsdf as jtsdf
from nerf_vo_tpu_torch.evaluation import datasets as tdatasets
from nerf_vo_tpu_torch.evaluation import lpips as tlpips
from nerf_vo_tpu_torch.evaluation import meshio as tmeshio
from nerf_vo_tpu_torch.evaluation import metrics as tmetrics
from nerf_vo_tpu_torch.evaluation import poisson as tpoisson
from nerf_vo_tpu_torch.evaluation import tsdf as ttsdf
from test_tsdf import _render_sphere_depth

TSDF_ATOL = 1e-5
LPIPS_RTOL = 1e-5
EXTR_ATOL = 1e-6
MESH_METRIC_RTOL = 1e-6


def _mesh(rng, n=60, m=80):
    v = rng.normal(size=(n, 3)).astype(np.float32)
    f = rng.integers(0, n, size=(m, 3)).astype(np.int32)
    return v, f


# ---------------------------------------------------------------------------
# meshio, metrics, poisson: the numpy copies
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("colors", [False, True])
def test_ply_roundtrip_across_packages(tmp_path, rng, colors):
    """A PLY written by either package reads back the same in both."""
    v, f = _mesh(rng)
    c = rng.uniform(0, 1, size=(len(v), 3)).astype(np.float32) if colors \
        else None
    for writer, name in ((jmeshio.write_ply, "j.ply"),
                         (tmeshio.write_ply, "t.ply")):
        writer(str(tmp_path / name), v, f, c)
    assert (tmp_path / "j.ply").read_bytes() == (tmp_path / "t.ply") \
        .read_bytes()
    for reader in (jmeshio.read_ply, tmeshio.read_ply):
        v2, f2 = reader(str(tmp_path / "t.ply"))
        np.testing.assert_array_equal(v2, v)
        np.testing.assert_array_equal(f2, f)


def test_sampling_and_downsampling_match_jax(rng):
    v, f = _mesh(rng)
    for faces in (f, None):
        a = jmeshio.sample_mesh_points(v, faces, 5000, seed=3)
        b = tmeshio.sample_mesh_points(v, faces, 5000, seed=3)
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(jmeshio.voxel_downsample(a, 0.1),
                                      tmeshio.voxel_downsample(b, 0.1))


def test_trajectory_metrics_match_jax(rng):
    gt = rng.normal(size=(40, 3))
    R, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    pred = 0.4 * gt @ R.T + rng.normal(size=3) + 0.01 * rng.normal(
        size=gt.shape)
    for scale in (True, False):
        a = jmetrics.absolute_trajectory_error(gt, pred, align_scale=scale)
        b = tmetrics.absolute_trajectory_error(gt, pred, align_scale=scale)
        assert a == b


def test_image_metrics_match_jax(rng):
    gt = rng.uniform(0, 1, (40, 56, 3))
    pred = np.clip(gt + 0.05 * rng.normal(size=gt.shape), 0, 1)
    assert jmetrics.psnr(pred, gt) == tmetrics.psnr(pred, gt)
    assert jmetrics.psnr(gt, gt) == tmetrics.psnr(gt, gt) == np.inf
    assert jmetrics.mssim(pred, gt) == tmetrics.mssim(pred, gt)
    assert jmetrics.mssim(pred[..., 0], gt[..., 0]) == tmetrics.mssim(
        pred[..., 0], gt[..., 0])
    d_gt = rng.uniform(0.2, 6.0, (40, 56))
    d_gt[:4] = 0.0  # invalid
    d_pred = 0.7 * d_gt + 0.05 * rng.normal(size=d_gt.shape)
    for sm in (True, False):
        assert (jmetrics.depth_metrics(d_pred, d_gt, scale_match=sm)
                == tmetrics.depth_metrics(d_pred, d_gt, scale_match=sm))
    empty = tmetrics.depth_metrics(d_pred, np.zeros_like(d_gt))
    assert set(empty) == set(jmetrics.depth_metrics(d_pred, d_gt))
    assert all(np.isnan(x) for x in empty.values())


def test_icp_and_mesh_metrics_match_jax(rng):
    gt = rng.uniform(-1, 1, (3000, 3))
    ang = 0.03
    R = np.array([[np.cos(ang), -np.sin(ang), 0],
                  [np.sin(ang), np.cos(ang), 0], [0, 0, 1]])
    pred = gt[:2500] @ R.T + [0.02, -0.01, 0.015] + 0.005 * rng.normal(
        size=(2500, 3))
    # outliers, most beyond ICP's 0.1 correspondence distance
    pred = np.concatenate([pred, rng.uniform(-3, 3, (300, 3))])
    np.testing.assert_array_equal(jmetrics.icp_align(pred, gt),
                                  tmetrics.icp_align(pred, gt))
    for icp in (True, False):
        a = jmetrics.mesh_3d_metrics(pred, gt, refine_icp=icp)
        b = tmetrics.mesh_3d_metrics(pred, gt, refine_icp=icp)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_allclose(b[k], a[k], rtol=MESH_METRIC_RTOL,
                                       err_msg=k)


def test_poisson_matches_jax():
    g = np.random.default_rng(0)
    v = g.standard_normal((8000, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    pts, nrm = v.astype(np.float32), v.astype(np.float32)
    for q in (0.0, 0.1):
        va, fa = jpoisson.poisson_mesh(pts, nrm, grid_resolution=40,
                                       density_quantile=q)
        vb, fb = tpoisson.poisson_mesh(pts, nrm, grid_resolution=40,
                                       density_quantile=q)
        assert len(va) > 100
        np.testing.assert_array_equal(va, vb)
        np.testing.assert_array_equal(fa, fb)
    intr = dict(fx=50.0, fy=52.0, cx=31.5, cy=23.0)
    depth = 2.0 + 0.3 * np.sin(np.mgrid[0:48, 0:64][1] / 7.0)
    c2w = np.eye(4)
    c2w[:3, 3] = [0.1, -0.2, 0.3]
    for a, b in zip(jpoisson.depth_to_points_normals(depth, intr, c2w,
                                                     stride=2),
                    tpoisson.depth_to_points_normals(depth, intr, c2w,
                                                     stride=2)):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# TSDF fusion and meshing
# ---------------------------------------------------------------------------

def _sphere_frames(n=12, H=60, W=80, seed=0):
    """``tests/test_tsdf.py``'s analytic scene: a sphere seen from a ring
    of cameras, with a seeded color per frame."""
    intr = np.asarray([60.0, 60.0, 40.0, 30.0])
    center, radius = np.zeros(3), 0.5
    rng = np.random.default_rng(seed)
    c2ws, depths, colors = [], [], []
    for ang in np.linspace(0, 2 * np.pi, n, endpoint=False):
        pos = np.asarray([2.0 * np.sin(ang), 0.0, -2.0 * np.cos(ang)])
        z = (center - pos) / np.linalg.norm(center - pos)
        x = np.cross([0, 1, 0], z)
        x /= np.linalg.norm(x)
        c2w = np.eye(4)
        c2w[:3, :3] = np.stack([x, np.cross(z, x), z], -1)
        c2w[:3, 3] = pos
        c2ws.append(c2w)
        depths.append(_render_sphere_depth(c2w, intr, H, W, center, radius))
        colors.append(rng.uniform(0, 1, (H, W, 3)).astype(np.float32))
    return np.stack(depths), np.stack(colors), intr, np.stack(c2ws)


@pytest.mark.parametrize("color,voxel,max_res", [
    (False, 1 / 32, 448), (True, 1 / 64, 448), (True, 1 / 64, 40)])
def test_fuse_tsdf_matches_jax(color, voxel, max_res):
    """The port's fusion on the CPU against the JAX scan (native library
    off): the same grid, and the same volumes to 1e-5. ``max_res`` 40
    makes the grid grow its voxel."""
    depths, colors, intr, c2ws = _sphere_frames()
    colors = colors if color else None
    a = jtsdf.fuse_tsdf(depths, colors, intr, c2ws, voxel_size=voxel,
                        max_resolution=max_res, use_native=False)
    b = ttsdf.fuse_tsdf(depths, colors, intr, c2ws, voxel_size=voxel,
                        max_resolution=max_res, device="cpu")
    assert a["tsdf"].shape == b["tsdf"].shape
    assert b["voxel_size"] == a["voxel_size"]
    assert (max_res == 40) == (b["voxel_size"] > voxel)
    np.testing.assert_array_equal(b["origin"], a["origin"])
    assert b["origin"].dtype == np.float32
    assert (b["weight"] > 0).mean() > 0.1
    for k in ("tsdf", "weight") + (("color",) if color else ()):
        np.testing.assert_allclose(b[k], a[k], rtol=0, atol=TSDF_ATOL,
                                   err_msg=k)
    if not color:
        assert b["color"] is None


def test_fuse_tsdf_small_chunks_change_nothing(monkeypatch):
    """The voxel chunking is invisible: a chunk of 1000 voxels (the last
    one partial) gives the one-chunk volume bitwise."""
    depths, colors, intr, c2ws = _sphere_frames(n=4)
    whole = ttsdf.fuse_tsdf(depths, colors, intr, c2ws, voxel_size=1 / 32,
                            device="cpu")
    monkeypatch.setattr(ttsdf, "FUSE_CHUNK", 1000)
    parts = ttsdf.fuse_tsdf(depths, colors, intr, c2ws, voxel_size=1 / 32,
                            device="cpu")
    assert whole["tsdf"].size % 1000
    for k in ("tsdf", "weight", "color"):
        np.testing.assert_array_equal(parts[k], whole[k], err_msg=k)


@pytest.mark.parametrize("method", ["marching_tetrahedra", "surface_nets"])
def test_extractors_match_jax(method):
    """Both extractors on one volume give identical meshes in both
    packages, vertex colors included."""
    depths, colors, intr, c2ws = _sphere_frames()
    vol = jtsdf.fuse_tsdf(depths, colors, intr, c2ws, voxel_size=1 / 32,
                          use_native=False)
    args = (vol["tsdf"], vol["weight"], vol["origin"], vol["voxel_size"],
            vol["color"])
    va, fa, ca = jtsdf.extract_mesh(*args, method=method)
    vb, fb, cb = ttsdf.extract_mesh(*args, method=method)
    assert len(fa) > 500
    np.testing.assert_array_equal(va, vb)
    np.testing.assert_array_equal(fa, fb)
    np.testing.assert_array_equal(ca, cb)
    # a volume with no sign change gives an empty mesh in both
    flat = np.ones_like(vol["tsdf"])
    assert len(ttsdf.extract_mesh(flat, None, vol["origin"], 1.0,
                                  method=method)[0]) == 0


def test_integrate_mesh_writes_a_sphere(tmp_path):
    """The port's ``integrate_mesh`` on the CPU: a closed mesh on the
    sphere of radius 0.5, with vertex colors."""
    depths, colors, intr, c2ws = _sphere_frames()
    ci = dict(fx=intr[0], fy=intr[1], cx=intr[2], cy=intr[3])
    path = str(tmp_path / "m.ply")
    ttsdf.integrate_mesh(path, ci, list(c2ws),
                         list((colors * 255).astype(np.uint8)), list(depths),
                         voxel_size=1 / 32, device="cpu")
    verts, faces = tmeshio.read_ply(path)
    assert len(faces) > 500
    r = np.linalg.norm(verts, axis=1)
    assert abs(np.median(r) - 0.5) < 1 / 32
    assert b"property uchar red" in Path(path).read_bytes()[:400]


# ---------------------------------------------------------------------------
# LPIPS
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def lpips_params():
    return jlpips.init_params(jax.random.PRNGKey(0))


def test_lpips_matches_jax(lpips_params, rng):
    net = tlpips.LPIPSAlex()
    net.load_state_dict(tlpips.from_jax_params(
        jax.tree_util.tree_map(np.asarray, lpips_params)))
    x = rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    y = np.clip(x + 0.1 * rng.normal(size=x.shape), 0, 1).astype(np.float32)
    want = np.asarray(jlpips.lpips_alex(lpips_params, x, y))
    with torch.no_grad():
        got = net(torch.tensor(x), torch.tensor(y)).numpy()
        same = net(torch.tensor(x), torch.tensor(x)).numpy()
    assert (want > 0).all()
    np.testing.assert_allclose(got, want, rtol=LPIPS_RTOL)
    np.testing.assert_allclose(same, 0.0, atol=1e-6)


def _lpips_state_dicts(seed=0):
    """One random LPIPS(alex) checkpoint in both layouts that the
    converters accept: torchvision ``features.*`` + ``lin*`` heads, and the
    ``lpips`` package's combined dump."""
    g = torch.Generator().manual_seed(seed)
    tv_idx = (0, 3, 6, 8, 10)
    cin = 3
    sd_tv, sd_lpips = {}, {}
    for i, (cout, k, _, _, _) in enumerate(tlpips._ALEX):
        w = torch.randn(cout, cin, k, k, generator=g) * 0.05
        b = torch.randn(cout, generator=g) * 0.01
        lin = torch.rand(1, cout, 1, 1, generator=g)
        sd_tv[f"features.{tv_idx[i]}.weight"] = w
        sd_tv[f"features.{tv_idx[i]}.bias"] = b
        sd_tv[f"lin{i}.model.1.weight"] = lin
        s, li = ((1, 0), (2, 3), (3, 6), (4, 8), (5, 10))[i]
        sd_lpips[f"net.slice{s}.{li}.weight"] = w
        sd_lpips[f"net.slice{s}.{li}.bias"] = b
        sd_lpips[f"lins.{i}.model.1.weight"] = lin
        cin = cout
    return sd_tv, sd_lpips


def test_lpips_weight_layouts_and_gate(tmp_path, rng, monkeypatch):
    """Both checkpoint layouts load to one state dict; ``lpips_distance``
    is None without ``NERF_VO_LPIPS_WEIGHTS`` and, with it, equals the JAX
    package's metric on the same file."""
    sd_tv, sd_lpips = _lpips_state_dicts()
    torch.save(sd_tv, tmp_path / "tv.pth")
    torch.save(sd_lpips, tmp_path / "lp.pth")
    a = tlpips.load_torch_weights(str(tmp_path / "tv.pth"))
    b = tlpips.load_torch_weights(str(tmp_path / "lp.pth"))
    assert a.keys() == b.keys() == tlpips.LPIPSAlex().state_dict().keys()
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
    assert a["lins.2"].shape == (384,)

    x = rng.uniform(0, 1, (32, 40, 3))
    y = rng.uniform(0, 1, (32, 40, 3))
    monkeypatch.delenv("NERF_VO_LPIPS_WEIGHTS", raising=False)
    assert tmetrics.lpips_distance(x, y, device="cpu") is None
    assert tmetrics.lpips_distance(x, y, str(tmp_path / "none.pth"),
                                   device="cpu") is None
    monkeypatch.setenv("NERF_VO_LPIPS_WEIGHTS", str(tmp_path / "lp.pth"))
    got = tmetrics.lpips_distance(x, y, device="cpu")
    want = jmetrics.lpips_distance(x, y)
    assert got > 0
    np.testing.assert_allclose(got, want, rtol=LPIPS_RTOL)


def test_lpips_runs_on_the_device_it_is_given(tmp_path, rng, monkeypatch):
    """The 2D row's LPIPS runs its network on the device the row is given
    (the evaluator passes its own, the card by default) and equals the JAX
    metric there; a device that is not present raises rather than falling
    back to the host."""
    from nerf_vo_tpu_torch.evaluation.evaluator import metrics_2d_row

    torch.save(_lpips_state_dicts(seed=1)[1], tmp_path / "lp.pth")
    monkeypatch.setenv("NERF_VO_LPIPS_WEIGHTS", str(tmp_path / "lp.pth"))
    x = rng.uniform(0, 1, (32, 40, 3))
    y = rng.uniform(0, 1, (32, 40, 3))
    depth = rng.uniform(0.5, 4.0, (32, 40))
    row = metrics_2d_row(3, x, depth, y, depth * 1.01, device="cpu")
    np.testing.assert_allclose(row["lpips"], jmetrics.lpips_distance(x, y),
                               rtol=LPIPS_RTOL)
    net = tlpips._cached[(str(tmp_path / "lp.pth"), "cpu")]
    assert {p.device.type for p in net.parameters()} == {"cpu"}
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            metrics_2d_row(3, x, depth, y, depth * 1.01)


# ---------------------------------------------------------------------------
# evaluation datasets
# ---------------------------------------------------------------------------

def _pose(i):
    c2w = np.eye(4)
    ang = 0.05 * i
    c2w[:3, :3] = [[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                   [-np.sin(ang), 0, np.cos(ang)]]
    c2w[:3, 3] = [0.03 * i, -0.01 * i, 0.02 * i]
    return c2w


def _img(rng, h=48, w=64):
    return rng.integers(0, 255, (h, w, 3), dtype=np.uint8)


def _depth(rng, h=48, w=64):
    return rng.integers(0, 20000, (h, w), dtype=np.uint16)


def _eval_replica(root: Path, rng):
    scene = root / "Replica" / "room0"
    (scene / "results").mkdir(parents=True)
    traj = []
    for i in range(7):
        cv2.imwrite(str(scene / "results" / f"frame{i:06d}.jpg"),
                    _img(rng, 60, 80))
        cv2.imwrite(str(scene / "results" / f"depth{i:06d}.png"),
                    _depth(rng, 60, 80))
        traj.append(" ".join(str(v) for v in _pose(i).flatten()))
    (scene / "traj.txt").write_text("\n".join(traj))
    (root / "Replica" / "camera_parameters.json").write_text(json.dumps(
        {"replica": {"h": 60, "w": 80, "fx": 40.0, "fy": 40.0, "cx": 40.0,
                     "cy": 30.0, "depth_scale": 6553.5}}))
    return dict(dir_dataset=str(scene), num_evaluation_frames=3)


def _eval_timestamped(seq: Path, rng, n, drop=()):
    """TUM-style rgb / depth / groundtruth files with unit quaternions;
    frames in ``drop`` get no depth partner within 0.02 s."""
    (seq / "rgb").mkdir(parents=True)
    (seq / "depth").mkdir()
    rgb, depth, gt = ["# rgb"], ["# depth"], ["# gt"]
    for i in range(n):
        t = 100.0 + 0.25 * i
        cv2.imwrite(str(seq / f"rgb/{t:.6f}.png"), _img(rng))
        rgb.append(f"{t:.6f} rgb/{t:.6f}.png")
        if i not in drop:
            cv2.imwrite(str(seq / f"depth/{t:.6f}.png"), _depth(rng))
            depth.append(f"{t + 0.004:.6f} depth/{t:.6f}.png")
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        tx, ty, tz = rng.normal(size=3)
        gt.append(f"{t - 0.003:.6f} {tx} {ty} {tz} {q[0]} {q[1]} {q[2]} "
                  f"{q[3]}")
    (seq / "rgb.txt").write_text("\n".join(rgb))
    (seq / "depth.txt").write_text("\n".join(depth))
    (seq / "groundtruth.txt").write_text("\n".join(gt))


def _eval_tum(root: Path, rng):
    seq = root / "TUM" / "rgbd_dataset_freiburg1_desk"
    _eval_timestamped(seq, rng, 6, drop=(3,))
    (root / "TUM" / "camera_parameters.json").write_text(json.dumps(
        {"fr1": {"h": 48, "w": 64, "fx": 50.0, "fy": 52.0, "cx": 31.0,
                 "cy": 24.5, "depth_scale": 5000.0}}))
    return dict(dir_dataset=str(seq), num_evaluation_frames=2,
                frame_height=40, frame_width=60)


def _eval_eth3d(root: Path, rng):
    seq = root / "ETH3D" / "sfm_lab_room_1"
    _eval_timestamped(seq, rng, 5, drop=(2,))
    (seq / "calibration.txt").write_text("55.5 56.5 32.25 23.75")
    return dict(dir_dataset=str(seq), num_evaluation_frames=4)


def _eval_scannet(root: Path, rng):
    """Frames 1, 2 and 6 have inf poses: 1-2 are interpolated between 0
    and 3, 6 (the last) takes 5's."""
    scene = root / "scene0000_00"
    for d in ("color", "depth", "pose", "intrinsics"):
        (scene / d).mkdir(parents=True)
    for i in range(7):
        cv2.imwrite(str(scene / "color" / f"{i}.jpg"), _img(rng))
        cv2.imwrite(str(scene / "depth" / f"{i}.png"), _depth(rng))
        m = np.full((4, 4), np.inf) if i in (1, 2, 6) else _pose(i)
        np.savetxt(scene / "pose" / f"{i}.txt", m)
    K = np.eye(4)
    K[0, 0], K[1, 1], K[0, 2], K[1, 2] = 50, 51, 32, 24
    (scene / "intrinsics" / "intrinsic_color.txt").write_text(
        " ".join(str(v) for v in K.flatten()))
    return dict(dir_dataset=str(scene), num_evaluation_frames=3,
                frame_height=24, frame_width=32)


def _eval_seven_scenes(root: Path, rng):
    scene = root / "7-Scenes" / "chess"
    (scene / "seq-01").mkdir(parents=True)
    for i in range(4):
        cv2.imwrite(str(scene / "seq-01" / f"frame-{i:06d}.color.png"),
                    _img(rng))
        d = _depth(rng)
        d[:3] = 65535  # the invalid sentinel
        cv2.imwrite(str(scene / "seq-01" / f"frame-{i:06d}.depth.png"), d)
        np.savetxt(scene / "seq-01" / f"frame-{i:06d}.pose.txt", _pose(i))
    (root / "7-Scenes" / "camera_parameters.json").write_text(json.dumps(
        {"7_scenes": {"h": 48, "w": 64, "fx": 58.5, "fy": 58.5, "cx": 32.0,
                      "cy": 24.0, "depth_scale": 1000.0}}))
    return dict(dir_dataset=str(scene), num_evaluation_frames=4,
                frame_height=24, frame_width=32)


EVAL_FIXTURES = {"replica": _eval_replica, "tum-rgbd": _eval_tum,
                 "scannet": _eval_scannet, "7-scenes": _eval_seven_scenes,
                 "eth3d": _eval_eth3d}


@pytest.mark.parametrize("name", sorted(EVAL_FIXTURES))
def test_evaluation_datasets_match_jax(name, tmp_path, rng):
    """Each evaluation dataset reads the same files to the same
    intrinsics, extrinsics (ScanNet's inf poses interpolated, TUM / ETH3D
    quaternions), evaluation frames and frames as the JAX one."""
    kw = EVAL_FIXTURES[name](tmp_path, rng)
    a = jdatasets.EVAL_DATASETS[name](**kw)
    b = tdatasets.EVAL_DATASETS[name](**kw, device="cpu")
    assert b.camera_intrinsics == a.camera_intrinsics
    assert b.evaluation_frames == a.evaluation_frames
    assert b.num_frames == a.num_frames >= 4
    assert len(b.camera_extrinsics) == len(a.camera_extrinsics)
    for ea, eb in zip(a.camera_extrinsics, b.camera_extrinsics):
        assert np.isfinite(eb).all() and eb.dtype == ea.dtype
        np.testing.assert_allclose(eb, ea, rtol=0, atol=EXTR_ATOL)
    for mode in ("evaluation_frames", "all"):
        for fa, fb in zip(a.frames_color(mode), b.frames_color(mode)):
            np.testing.assert_array_equal(fb, fa)
        for fa, fb in zip(a.frames_depth(mode), b.frames_depth(mode)):
            np.testing.assert_array_equal(fb, fa)
    kf = [1, 0]
    for fa, fb in zip(a.frames_depth("keyframes", kf),
                      b.frames_depth("keyframes", kf)):
        np.testing.assert_array_equal(fb, fa)
    with pytest.raises(NotImplementedError):
        b.frames_color("bogus")


def test_replica_gt_mesh_is_fused_once(tmp_path):
    """``mesh()`` fuses the GT mesh on the dataset's device into
    ``<scene>_mesh_fused.ply`` beside the scene, and reads the cache
    after that."""
    from test_e2e import INTR, _scene_sdf_depth_color

    scene = tmp_path / "Replica" / "room0"
    (scene / "results").mkdir(parents=True)
    (tmp_path / "Replica" / "camera_parameters.json").write_text(
        json.dumps({"replica": INTR}))
    traj = []
    for i in range(6):
        c2w = np.eye(4)
        c2w[0, 3] = 0.1 * i
        color, depth = _scene_sdf_depth_color(c2w)
        cv2.imwrite(str(scene / "results" / f"frame{i:06d}.jpg"),
                    cv2.cvtColor(color, cv2.COLOR_RGB2BGR))
        cv2.imwrite(str(scene / "results" / f"depth{i:06d}.png"),
                    (depth * INTR["depth_scale"]).astype(np.uint16))
        traj.append(" ".join(str(v) for v in c2w.flatten()))
    (scene / "traj.txt").write_text("\n".join(traj))
    ds = tdatasets.ReplicaDataset(str(scene), 3, device="cpu")
    (verts, faces), path = ds.mesh()
    assert path == str(tmp_path / "Replica" / "room0_mesh_fused.ply")
    assert len(faces) > 1000
    # the sphere's front (z = 1.5) and the plane (z = 3) are in the mesh
    assert verts[:, 2].min() < 1.55 and verts[:, 2].max() > 2.95
    stamp = os.stat(path).st_mtime_ns
    (v2, f2), _ = ds.mesh()
    assert os.stat(path).st_mtime_ns == stamp
    np.testing.assert_array_equal(v2, verts)
