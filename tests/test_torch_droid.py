"""The port's DROID tracking half (``ops/dense_corr.py``, ``ops/dense_ba.py``,
``models/droid_net.py``, ``tracking/droid_slam.py``) against the JAX
package's, on the CPU.

Sizes as ``tests/test_droid.py``: 48x64 frames (6x8 at 1/8), the JAX
package's random init carried across with ``droid_net.from_jax_params``;
every other input is made from a numpy seed. The JAX side is jitted.

Tolerances (measured spread in brackets):
- correlation pyramid: stored as bf16 after an f32 product whose sum order
  differs, so an entry may round to the neighbouring bf16 value: every
  entry within one bf16 step, >= 99% equal [100%];
- lookup on the same volumes: atol 1e-5 [2.4e-7];
- one dense BA (2 GN iterations): poses atol 2e-5 [5.3e-6], inverse depths
  atol 1e-4 [1.1e-5], costs rtol 1e-4 [1.2e-6], the covariance rtol 5e-3
  [6.3e-4: an inverse of the damped Schur matrix];
- global BA: poses 2e-5 [1.8e-6], inverse depths 1e-4 [1.1e-5], costs rtol
  1e-4 [1.4e-7]; frame distances atol 1e-5 [1.8e-7];
- network heads: 1e-4 of each output's largest value [<= 3.5e-6]; the
  motion filter's mean flow rtol 1e-3 [8.6e-6];
- the tracker from the JAX tracker's state (one update; the end-of-stream
  flush with both global BA passes; the packet): poses 5e-4 [8.6e-5 after
  an update, 1.6e-5 after the flush], inverse depths 1e-3 of their range
  [6.7e-5], covariances rtol 1e-2 [1.4e-3], hidden state 1e-4 [3.0e-6];
- the tracker run free over the frames: bookkeeping (window, edges,
  inactive store, retirements, free slots) equal; poses 2e-2 [JAX vs port
  2.7e-3; the port's own spread between 1 and 4 threads 4.0e-4]: the
  encoders agree to ~2e-6, which flips bf16 roundings of the stored
  features, and random-weight tracking amplifies every such step
  (ROADMAP, Queue 3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_vo_tpu.core import lie as jlie
from nerf_vo_tpu.models import droid_net as jdn
from nerf_vo_tpu.ops import dense_ba as jba
from nerf_vo_tpu.ops import dense_corr as jdc
from nerf_vo_tpu.runtime import stages as jstages
from nerf_vo_tpu.tracking import droid_slam as jds
from nerf_vo_tpu_torch.models import droid_net as tdn
from nerf_vo_tpu_torch.ops import dense_ba as tba
from nerf_vo_tpu_torch.ops import dense_corr as tdc
from nerf_vo_tpu_torch.runtime import stages as tstages
from nerf_vo_tpu_torch.tracking import droid_slam as tds

H, W = 48, 64
h, w = H // 8, W // 8
INTR = np.asarray([40.0, 40.0, W / 2, H / 2], np.float32)
TINY = dict(buffer_size=32, motion_threshold=0.0, frontend_window=5,
            frontend_radius=2, max_factors=12, iters1=1, iters2=1,
            ba_iters=1, backend_steps1=1, backend_steps2=1,
            perform_global_ba=True, compute_covariances=True)
N_FRAMES = 8  # a multiple of the backend's 4-frame chunks (Queue 3)


def _t(x):
    x = np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x)
    return torch.tensor(x)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread, as in ``tests/test_torch_pipeline.py``: beside
    the other test workers more threads cost more in contention than they
    gain at these sizes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def droid():
    net, params = jdn.init_droid_params(jax.random.PRNGKey(0), H, W)
    pn = jax.tree_util.tree_map(np.asarray, params)
    tnet = tdn.DroidNet()
    tnet.load_state_dict(tdn.from_jax_params(pn))
    return net, params, tnet


def _frames(n, seed=0):
    """A smooth random texture panned 2 px a frame, [H, W, 3] uint8."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(0, 255, (H // 8 + 2, (W + 2 * n) // 8 + 2, 3))
    ys = (np.arange(H) + 0.5) / 8
    xs = (np.arange(W + 2 * n) + 0.5) / 8
    y0, x0 = ys.astype(int), xs.astype(int)
    fy = (ys - y0)[:, None, None]
    fx = (xs - x0)[None, :, None]
    big = (base[y0][:, x0] * (1 - fy) * (1 - fx)
           + base[y0 + 1][:, x0] * fy * (1 - fx)
           + base[y0][:, x0 + 1] * (1 - fy) * fx
           + base[y0 + 1][:, x0 + 1] * fy * fx).astype(np.uint8)
    return [np.ascontiguousarray(big[:, 2 * i:2 * i + W]) for i in range(n)]


# ---------------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hw", [(6, 8), (5, 7)])
def test_corr_pyramid_matches_jax(hw):
    """(6, 8) pools to 3x4, then 1x2 (one row left: not pooled along it)
    and 1x1; (5, 7) crops odd edges on the way."""
    hh, ww = hw
    rng = np.random.default_rng(0)
    fi = rng.normal(size=(3, hh, ww, 128)).astype(np.float32)
    fj = rng.normal(size=(3, hh, ww, 128)).astype(np.float32)
    want = jax.jit(jdc.build_corr_pyramid, static_argnums=2)(fi, fj, 4)
    got = tdc.build_corr_pyramid(torch.tensor(fi), torch.tensor(fj), 4)
    for a, b in zip(want, got):
        assert b.dtype == torch.bfloat16 and tuple(b.shape) == a.shape
        a = np.asarray(a.astype(jnp.float32))
        b = b.float().numpy()
        assert (np.abs(a - b) <= 2.0 ** -7 * np.abs(a) + 1e-30).all()
        assert np.mean(a == b) >= 0.99


def test_corr_lookup_matches_jax():
    """Coordinates in the frame, across its border and far outside."""
    rng = np.random.default_rng(1)
    f = rng.normal(size=(4, h, w, 32)).astype(np.float32)
    pyr = jdc.build_corr_pyramid(f, f[::-1].copy(), 4)
    coords = rng.uniform(-6, w + 6, (4, h, w, 2)).astype(np.float32)
    coords[0, 0, :, 0] = 1e4
    coords[1, 1, :, 1] = -1e4
    want = np.asarray(jdc.corr_lookup(pyr, jnp.asarray(coords), radius=3))
    got = tdc.corr_lookup([_t(v).bfloat16() for v in pyr],
                          torch.tensor(coords), 3).numpy()
    assert got.shape == want.shape == (4, h, w, 196)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert not got[0, 0].any() and not got[1, 1].any()


def _scene(n=4):
    """Poses on a short track, a smooth depth field, all |i - j| <= 2
    edges; noisy flow targets, random weights, one invalid edge."""
    rng = np.random.default_rng(2)
    xi = np.concatenate([np.stack([-0.2 * np.arange(n), 0.01 * np.arange(n),
                                   0.02 * np.arange(n)], -1),
                         rng.normal(size=(n, 3)) * 0.01], -1)
    poses = np.asarray(jlie.se3_exp(jnp.asarray(xi, jnp.float32)))
    intr = np.tile(np.asarray([12.0, 12.0, 8.0, 6.0], np.float32), (n, 1))
    ys, xs = np.mgrid[0:12, 0:16]
    depth = 3.0 + 0.5 * np.sin(xs / 3.0) * np.cos(ys / 2.0)
    disps = np.tile(1.0 / depth, (n, 1, 1)).astype(np.float32)
    ii, jj = map(np.asarray, zip(*[(a, b) for a in range(n)
                                   for b in range(n)
                                   if a != b and abs(a - b) <= 2]))
    tgt, _ = jba.dense_reproject(poses, disps, intr, ii, jj)
    tgt = (np.asarray(tgt)
           + rng.normal(size=tgt.shape) * 0.5).astype(np.float32)
    wgt = rng.uniform(0, 1, tgt.shape).astype(np.float32)
    d0 = (disps * (1 + 0.05 * rng.normal(size=disps.shape))).astype(
        np.float32)
    eta = rng.uniform(0, 0.01, disps.shape).astype(np.float32)
    valid = np.ones(len(ii), bool)
    valid[1] = False
    return dict(poses=poses, disps=d0, intr=intr, ii=ii.astype(np.int32),
                jj=jj.astype(np.int32), tgt=tgt, wgt=wgt, valid=valid,
                eta=eta, slot_map=np.asarray([-1, -1, 0, 1], np.int32))


def test_dense_bundle_adjust_matches_jax():
    s = _scene()
    keys = ("poses", "disps", "intr", "ii", "jj", "tgt", "wgt", "valid")
    want = jba.dense_bundle_adjust(
        jba.DenseBAProblem(*[jnp.asarray(s[k]) for k in keys]),
        jnp.asarray(s["slot_map"]), num_iters=2, window=3,
        eta=jnp.asarray(s["eta"]))
    got = tba.dense_bundle_adjust(
        tba.DenseBAProblem(*[torch.tensor(s[k]) for k in keys]),
        torch.tensor(s["slot_map"]), num_iters=2, window=3,
        eta=torch.tensor(s["eta"]))
    (jp, jd, jc, jcov), (tp, td, tc, tcov) = [
        [np.asarray(x) for x in r] for r in (want, got)]
    np.testing.assert_allclose(tp, jp, rtol=0, atol=2e-5)
    np.testing.assert_allclose(td, jd, rtol=0, atol=1e-4)
    np.testing.assert_allclose(tc, jc, rtol=1e-4)
    np.testing.assert_allclose(tcov, jcov, rtol=5e-3)
    np.testing.assert_allclose(tp[:2], s["poses"][:2], atol=1e-6)  # fixed
    assert tc[-1] < tc[0]


def test_frame_distance_matches_jax():
    s = _scene()
    want = jba.frame_distance(s["poses"], s["disps"], s["intr"], s["ii"],
                              s["jj"])
    got = tba.frame_distance(*[torch.tensor(s[k]) for k in (
        "poses", "disps", "intr")], torch.tensor(s["ii"]).long(),
        torch.tensor(s["jj"]).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_global_dense_ba_matches_jax():
    """Edges grouped by host frame into rows of ME = 4 (padding masked)."""
    s = _scene()
    n, ME = 4, 4
    jj_g = np.zeros((n, ME), np.int32)
    valid = np.zeros((n, ME), bool)
    tgt = np.zeros((n, ME, 12, 16, 2), np.float32)
    wgt = np.zeros_like(tgt)
    count = np.zeros(n, int)
    for e, (a, b) in enumerate(zip(s["ii"], s["jj"])):
        m = count[a]
        jj_g[a, m], valid[a, m] = b, s["valid"][e]
        tgt[a, m], wgt[a, m] = s["tgt"][e], s["wgt"][e]
        count[a] += 1
    args = (s["poses"], s["disps"], s["intr"], np.arange(n, dtype=np.int32),
            jj_g, valid, tgt, wgt, s["slot_map"])
    want = jba.global_dense_ba(*map(jnp.asarray, args), num_iters=2, P=2,
                               eta=jnp.asarray(s["eta"]))
    got = tba.global_dense_ba(*map(torch.tensor, args), num_iters=2, P=2,
                              eta=torch.tensor(s["eta"]))
    (jp, jd, jc), (tp, td, tc) = [[np.asarray(x) for x in r]
                                  for r in (want, got)]
    np.testing.assert_allclose(tp, jp, rtol=0, atol=2e-5)
    np.testing.assert_allclose(td, jd, rtol=0, atol=1e-4)
    np.testing.assert_allclose(tc, jc, rtol=1e-4)
    assert tc[-1] < tc[0]


# ---------------------------------------------------------------------------
# networks
# ---------------------------------------------------------------------------

def _close(got, want, rtol=1e-4):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * max(np.abs(want).max(), 1e-6))


def test_droid_net_heads_match_jax(droid):
    """Both encoders on two frames; one update over four edges into four
    frames, of which frame 3 has no edge (its agg head sees a zero mean)."""
    net, params, tnet = droid
    v = {"params": params}
    rng = np.random.default_rng(3)
    img = rng.uniform(0, 255, (2, H, W, 3)).astype(np.float32)
    x = jdn.normalize_images(jnp.asarray(img))
    tx = tdn.normalize_images(torch.tensor(img).permute(0, 3, 1, 2))
    _close(tx.permute(0, 2, 3, 1), x, 1e-6)
    with torch.no_grad():
        _close(tnet.encode_features(tx).permute(0, 2, 3, 1),
               jax.jit(lambda p, x: net.apply(
                   p, x, method=net.encode_features))(v, x))
        jc = jax.jit(lambda p, x: net.apply(
            p, x, method=net.encode_context))(v, x)
        for a, b in zip(tnet.encode_context(tx), jc):
            _close(a.permute(0, 2, 3, 1), b)

    E = 4
    hid = np.tanh(rng.normal(size=(E, h, w, 128))).astype(np.float32)
    inp = np.maximum(rng.normal(size=(E, h, w, 128)), 0).astype(np.float32)
    corr = rng.normal(size=(E, h, w, 196)).astype(np.float32)
    flow = rng.normal(size=(E, h, w, 4)).astype(np.float32) * 4
    ii = np.asarray([0, 2, 2, 1], np.int32)
    want = jax.jit(lambda p, *a: net.apply(
        p, *a, 4, method=net.update_step))(v, hid, inp, corr, flow, ii)
    nchw = [torch.tensor(a).permute(0, 3, 1, 2)
            for a in (hid, inp, corr, flow)]
    with torch.no_grad():
        got = tnet.update(*nchw, torch.tensor(ii).long(), 4)
    for name, a, b in zip(("net", "delta", "weight"), got[:3], want[:3]):
        _close(a.permute(0, 2, 3, 1), b)
    _close(got[3], want[3])  # eta [4, h, w]
    _close(got[4].permute(0, 2, 3, 1), want[4])  # upmask
    assert got[3].shape == (4, h, w) and (got[3] > 0).all()

    data = rng.uniform(0.1, 1, (3, h, w)).astype(np.float32)
    mask = rng.normal(size=(3, h, w, 576)).astype(np.float32)
    up = tdn.cvx_upsample(torch.tensor(data),
                          torch.tensor(mask).permute(0, 3, 1, 2))
    _close(up, jax.jit(jdn.cvx_upsample)(data, mask), 1e-6)
    assert up.shape == (3, H, W)


def test_from_jax_params_is_the_upstream_layout(droid):
    """The state dict keys are droid.pth's; the JAX converter takes it
    back to the same Flax tree, and an upstream checkpoint's 3-channel
    heads load through ``convert_checkpoint``."""
    _, params, tnet = droid
    sd = {k: v.numpy() for k, v in tnet.state_dict().items()}
    assert {k.split(".")[0] for k in sd} == {"fnet", "cnet", "update"}
    assert sd["update.delta.2.weight"].shape == (2, 128, 3, 3)
    back = jdn.convert_torch_checkpoint(
        {k: (np.concatenate([v, v[:1]]) if k.startswith(
            ("update.delta.2.", "update.weight.2.")) else v)
         for k, v in sd.items()})["params"]
    flat_a = jax.tree_util.tree_leaves_with_path(back)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(params))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(leaf, np.asarray(flat_b[path]))
    upstream = {"module." + k: (torch.cat([v, v[:1]]) if k.startswith(
        ("update.delta.2.", "update.weight.2.")) else v)
        for k, v in tnet.state_dict().items()}
    fresh = tdn.DroidNet()
    fresh.load_state_dict(tdn.convert_checkpoint(upstream))
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, tnet.state_dict()[k]), k


# ---------------------------------------------------------------------------
# the tracker
# ---------------------------------------------------------------------------

def _trackers(droid, **kw):
    net, params, tnet = droid
    cfg = dict(TINY, **kw)
    return (jds.DROIDSLAMTracker(jds.DroidConfig(**cfg), net, params, H, W),
            tds.DROIDSLAMTracker(tds.DroidConfig(**cfg), tnet, H, W,
                                 device="cpu"))


def _sync(jt, tt):
    """The JAX tracker's whole state into the port's."""
    tt.poses, tt.disps = _t(jt.poses), _t(jt.disps)
    tt.intrinsics8, tt.fmaps = _t(jt.intrinsics8), _t(jt.fmaps).bfloat16()
    tt.inps = _t(jt.inps).permute(0, 3, 1, 2).bfloat16().contiguous()
    tt.hidden = _t(jt.hidden).permute(0, 3, 1, 2).contiguous()
    tt.upmask = _t(jt.upmask).permute(0, 3, 1, 2).contiguous()
    for k in ("e_target", "e_weight", "i_target", "i_weight", "eta",
              "depth_cov"):
        setattr(tt, k, _t(getattr(jt, k)))
    for k in ("i_ii", "i_jj", "i_valid", "e_ii", "e_jj", "e_valid",
              "e_fresh"):
        setattr(tt, k, getattr(jt, k).copy())
    tt.alive, tt.retired = list(jt.alive), list(jt.retired)
    tt.free_slots, tt.n_kf, tt.i_ptr = list(jt.free_slots), jt.n_kf, jt.i_ptr
    tt.src_index, tt.tstamps = dict(jt.src_index), dict(jt.tstamps)
    tt.colors = dict(jt.colors)
    tt._pyr_version = -1


def _same_books(jt, tt):
    assert tt.alive == jt.alive and tt.retired == jt.retired
    assert tt.free_slots == jt.free_slots and tt.n_kf == jt.n_kf
    for k in ("e_ii", "e_jj", "e_valid", "e_fresh", "i_ii", "i_jj",
              "i_valid"):
        np.testing.assert_array_equal(getattr(tt, k), getattr(jt, k),
                                      err_msg=k)
    assert tt.src_index == jt.src_index


def _disp_close(tt, jt, rel):
    want = np.asarray(jt.disps)
    np.testing.assert_allclose(tt.disps.numpy(), want, rtol=0,
                               atol=rel * (want.max() - want.min()))


@pytest.fixture(scope="module")
def run_keep_all(droid):
    """keyframe_threshold 0: every frame stays a keyframe; window 5, so
    three retire during the stream; max_factors 12 < the 14 neighbourhood
    pairs of a full window, so live edges are evicted into the inactive
    store."""
    jt, tt = _trackers(droid, keyframe_threshold=0.0)
    out = []
    for i, f in enumerate(_frames(N_FRAMES)):
        out.append((jt.track(i * 0.1, f, INTR, frame_index=i),
                    tt.track(i * 0.1, f, INTR, frame_index=i)))
    return jt, tt, out


def test_tracker_runs_free_with_the_same_books(run_keep_all):
    jt, tt, out = run_keep_all
    for jr, tr in out:
        assert jr == tr
    assert sum(len(jr) for jr, _ in out) == N_FRAMES - TINY[
        "frontend_window"]
    _same_books(jt, tt)
    assert jt.i_valid.any()  # the inactive store holds evicted edges
    jtr, ttr = jt.trajectory(), tt.trajectory()
    assert jtr.keys() == ttr.keys()
    for k in jtr:
        np.testing.assert_allclose(ttr[k], jtr[k], rtol=0, atol=2e-2)


def test_tracker_update_from_the_same_state(run_keep_all, droid):
    """One frontend update (pyramid, lookup, GRU, BA with the inactive
    store, the covariance merge) from the JAX tracker's state."""
    jt, _, _ = run_keep_all
    _, tt = _trackers(droid, keyframe_threshold=0.0)
    _sync(jt, tt)
    before = np.asarray(jt.poses)
    jt._run_update()
    tt._run_update()
    assert np.abs(np.asarray(jt.poses) - before).max() > 1e-4  # it moved
    np.testing.assert_allclose(tt.poses.numpy(), np.asarray(jt.poses),
                               rtol=0, atol=5e-4)
    _disp_close(tt, jt, 1e-3)
    np.testing.assert_allclose(tt.depth_cov.numpy(),
                               np.asarray(jt.depth_cov), rtol=1e-2)
    np.testing.assert_allclose(
        tt.hidden.permute(0, 2, 3, 1).numpy(), np.asarray(jt.hidden),
        rtol=0, atol=1e-4)
    _same_books(jt, tt)


def test_tracker_flush_and_packet_from_the_same_state(run_keep_all, droid):
    """The end of the stream from the JAX tracker's state: both global BA
    passes over all 8 keyframes, the edges rebuilt, then the packet of
    every keyframe (upsampled inverse depth and covariance)."""
    jt, _, _ = run_keep_all
    _, tt = _trackers(droid, keyframe_threshold=0.0)
    _sync(jt, tt)
    before = np.asarray(jt.poses)
    assert jt.flush() == tt.flush()
    assert np.abs(np.asarray(jt.poses) - before).max() > 1e-4
    _same_books(jt, tt)
    jtr, ttr = jt.trajectory(), tt.trajectory()
    for k in jtr:
        np.testing.assert_allclose(ttr[k], jtr[k], rtol=0, atol=5e-4)
    _disp_close(tt, jt, 1e-3)
    np.testing.assert_allclose(tt.eta.numpy(), np.asarray(jt.eta),
                               rtol=0, atol=1e-5)

    kfs = list(jt.retired)
    jp, tp = jt.keyframe_packet(kfs, True), tt.keyframe_packet(kfs, True)
    assert sorted(jp) == sorted(tp)
    np.testing.assert_array_equal(tp["keyframe_indices"],
                                  jp["keyframe_indices"])
    np.testing.assert_array_equal(tp["frames_color"], jp["frames_color"])
    np.testing.assert_allclose(tp["camera_intrinsics"].numpy(),
                               jp["camera_intrinsics"], rtol=1e-6)
    np.testing.assert_allclose(tp["camera_extrinsics"].numpy(),
                               jp["camera_extrinsics"], atol=5e-4)
    inv = jp["droid_slam_inverse_depth"]
    assert tp["droid_slam_inverse_depth"].shape == (len(kfs), H, W)
    np.testing.assert_allclose(tp["droid_slam_inverse_depth"].numpy(), inv,
                               rtol=0, atol=1e-3 * (inv.max() - inv.min()))
    cov = tp["droid_slam_depth_covariance"].numpy()
    assert np.isfinite(cov).all() and (cov > 0).all()
    np.testing.assert_allclose(cov, jp["droid_slam_depth_covariance"],
                               rtol=1e-2)


def test_tracker_removes_keyframes_as_jax(droid):
    """keyframe_threshold 1e9: every candidate drops the keyframe before
    it, so slots return to the free pool and are reused."""
    jt, tt = _trackers(droid, keyframe_threshold=1e9)
    for i, f in enumerate(_frames(7)):
        assert (jt.track(i * 0.1, f, INTR, frame_index=i)
                == tt.track(i * 0.1, f, INTR, frame_index=i))
        _same_books(jt, tt)
    assert len(jt.alive) == 3 and jt.n_kf < 7  # slots reused
    np.testing.assert_allclose(tt.poses.numpy(), np.asarray(jt.poses),
                               rtol=0, atol=2e-2)


def test_motion_filter_matches_jax(droid):
    """The motion filter's value, the mean predicted flow of the identity
    edge between the last keyframe and a new frame: relative 1e-3."""
    jt, tt = _trackers(droid, motion_threshold=0.0)
    f0, f1 = _frames(2)
    jt.track(0.0, f0, INTR)
    tt.track(0.0, f0, INTR)
    fm, _, _ = jt._encode(jt.params, jnp.asarray(f1, jnp.float32))
    want = float(jt._motion(jt.params, fm, jt.fmaps[0], jt.inps[0]))
    tf, _ = tt._encode(f1)
    got = tt._motion(tf, tt.fmaps[0], tt.inps[0])
    assert want > 0
    np.testing.assert_allclose(got, want, rtol=1e-3)


def test_backend_updates_every_row():
    """Keyframe counts that are no multiple of the backend's 4-frame GRU
    chunks: the port writes every row's edge state back (the JAX backend
    pads the last chunk with copies of its last row and scatters them
    after it, which loses that row's update; ROADMAP, Queue 3)."""
    torch.manual_seed(0)
    tt = tds.DROIDSLAMTracker(tds.DroidConfig(**dict(
        TINY, keyframe_threshold=0.0)), tdn.DroidNet(), H, W, device="cpu")
    for i, f in enumerate(_frames(9)):
        tt.track(i * 0.1, f, INTR, frame_index=i)
    seen = {}
    flow = tt._backend_flow

    def spy(hidden, target_prev, ii, jj, ii_local, valid, fresh, n_frames):
        out = flow(hidden, target_prev, ii, jj, ii_local, valid, fresh,
                   n_frames)
        for g in ii.tolist():
            seen[g] = seen.get(g, 0) + 1
        return out

    tt._backend_flow = spy
    order = tt.retired + tt.alive
    eta0 = tt.eta.clone()
    tt.backend(1)
    assert sorted(seen) == sorted(order)  # every host row ran
    assert len(order) % 4 == 1
    last = order[-1]
    assert not torch.equal(tt.eta[last], eta0[last])


def test_retired_keyframes_carry_the_zero_input_mask():
    """The frontend keeps the newest ``max_factors`` edges, so a keyframe
    leaving the window hosts no live edge in the last update before it
    retires: the agg head pooled zeros for it, and its packet is upsampled
    with the mask of a zero input, as in the JAX tracker, whose agg head
    also runs over every buffer frame (ROADMAP, Queue 3)."""
    torch.manual_seed(0)
    tt = tds.DROIDSLAMTracker(tds.DroidConfig(**dict(
        TINY, keyframe_threshold=0.0)), tdn.DroidNet(), H, W, device="cpu")
    retired = []
    for i, f in enumerate(_frames(7)):
        retired += tt.track(i * 0.1, f, INTR, frame_index=i)
    assert retired == [0, 1]
    agg = tt.net.update.agg
    with torch.no_grad():
        zero = agg.upmask(torch.relu(agg.conv2(torch.zeros(1, 128, h, w))))
    for g in retired:
        torch.testing.assert_close(tt.upmask[g], zero[0], rtol=1e-5,
                                   atol=1e-6)


# ---------------------------------------------------------------------------
# the stages
# ---------------------------------------------------------------------------

def _stage_args(**kw):
    from types import SimpleNamespace

    return SimpleNamespace(**dict(
        tracking_module="droid-slam", enhancement_module="none",
        mapping_module="instant-ngp", frame_height=H + 2, frame_width=W + 3,
        num_keyframes=32, motion_threshold=0.0, keyframe_threshold=0.0,
        tracking_frontend_window=5, tracking_max_edges=12,
        perform_global_bundle_adjustment=False, frame_stride=2), **kw)


def test_tracking_stage_droid_matches_jax(droid, tmp_path):
    """``TrackingStage(droid-slam)`` crops the frame to a multiple of 8 and
    runs the tracker with the config's keys (the tracker's own iteration
    counts: 4 + 2 updates of 2 GN iterations a frame); the packets'
    keyframes and colours and the artifacts' keys match the JAX stage's.
    Values are not compared: with these counts random-weight tracking
    parts from JAX's by 0.18 in pose within two frames of its first
    update, though one update from the same state agrees to 2.7e-4 (the
    tests above hold the tracker's values)."""
    import json

    _, params, tnet = droid
    args = _stage_args()
    jst = jstages.TrackingStage(args, params=params)
    tst = tstages.TrackingStage(args, state_dict=tnet.state_dict(),
                                device="cpu")
    assert (tst.tracker.H, tst.tracker.W) == (H, W)
    assert tst.tracker.cfg.buffer_size == 32
    frames = [np.pad(f, ((0, 2), (0, 3), (0, 0))) for f in _frames(7)]
    ci = dict(fx=40.0, fy=40.0, cx=W / 2, cy=H / 2)
    for i, f in enumerate(frames):
        frame = dict(frame_index=i, frame_color=f, camera_intrinsics=ci,
                     last_frame=i == len(frames) - 1)
        jp, tp = jst.step(frame), tst.step(frame)
        assert (jp is None) == (tp is None)
        if jp is None:
            continue
        np.testing.assert_array_equal(tp["keyframe_indices"],
                                      jp["keyframe_indices"])
        np.testing.assert_array_equal(tp["frames_color"], jp["frames_color"])
        assert tp["frames_color"].shape[-2:] == (H, W)
        assert tp["last_frame"] == jp["last_frame"]
        ext = tp["camera_extrinsics"].numpy()
        assert ext.shape == jp["camera_extrinsics"].shape
        assert np.isfinite(ext).all()
    assert jp["last_frame"]
    for st, d in ((jst, tmp_path / "jax"), (tst, tmp_path / "port")):
        st.save_artifacts(str(d))
    for name in ("mapping_keyframe2frame.json",
                 "matrices/matrices_origin2frame_keyframes_tracking.json"):
        a = json.loads((tmp_path / "jax" / name).read_text())
        b = json.loads((tmp_path / "port" / name).read_text())
        assert a.keys() == b.keys(), name
    assert json.loads((tmp_path / "port" / "mapping_keyframe2frame.json")
                      .read_text()) == {str(i): 2 * i for i in range(7)}


def test_enhancement_stage_droid_branch_matches_jax():
    """Under ``enhancement_module: none`` a DROID packet's depth is
    clip(1 / clip(inverse depth, 1e-6), 0, MAX_DEPTH) and its covariance
    passes through; the poses flip to OpenGL. Exact."""
    rng = np.random.default_rng(6)
    inv = rng.uniform(-0.1, 2.0, (3, H, W)).astype(np.float32)
    inv[0, 0, :4] = [0.0, 1e-9, 1e-3, 1e3]
    packet = {
        "keyframe_indices": np.arange(3),
        "camera_intrinsics": np.tile(INTR, (3, 1)),
        "camera_extrinsics": np.tile(np.eye(4, dtype=np.float32), (3, 1, 1)),
        "frames_color": rng.integers(0, 255, (3, 3, H, W), dtype=np.uint8),
        "droid_slam_inverse_depth": inv,
        "droid_slam_depth_covariance": rng.uniform(
            1e-3, 10, (3, H, W)).astype(np.float32),
        "last_frame": False,
    }
    args = _stage_args()
    want = jstages.EnhancementStage(args).step(packet)
    got = tstages.EnhancementStage(args, device="cpu").step(
        {k: torch.tensor(v) if k in ("camera_extrinsics",
                                     "droid_slam_inverse_depth",
                                     "droid_slam_depth_covariance") else v
         for k, v in packet.items()})
    for k in ("frames_depth", "frames_depth_cov", "camera_extrinsics",
              "frames_color_float"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
