"""The port's Instant-NGP mapping path (``ops/occupancy.py``, the
``sampler="occupancy"`` branch of ``models/nerfacto.py``, the trainer's
occupancy grid, ``MappingStage`` under ``mapping_module: instant-ngp``)
against the JAX package's, on the CPU.

The model is the NGP mapper's geometry cut to size, as
``tests/test_accuracy_ngp.py`` cuts it: linear spacing in a bounded AABB
(no contraction), covariance-weighted L2 depth, a 32^3 occupancy grid
refreshed over a quarter of its cells, 64 coarse bins and 16 nerf samples;
the field 3 levels x 8 features at log2 table 14. Keyframes of 32x40, 128
rays per step. Parameters are one JAX init (tables redrawn wider) carried
across with ``nerfacto.from_jax_params``; each step's draws are the ones
the JAX step's key gives (``tests/torch_parity.py``).

Tolerances (measured spread in brackets):
- occupancy ops: exact (the same f32 arithmetic and integer indexing);
- renders: 1e-2 of each output's largest value, as
  ``tests/test_torch_nerfacto.py`` (the bf16 MLPs) [2.6e-3];
- a refresh: the decayed grid exact outside the slab; inside it the max
  with the field's density, relative 1e-2 [9.8e-4];
- loss terms at each of 3 train steps: relative 2e-2 [<= 3.2e-4; the
  normal regularizers <= 2.9e-3];
- parameters after 3 Adam steps: as ``tests/test_torch_mapping.py``, by the
  share of elements within lr / 10 of JAX's: >= 99% of all [99.7%];
- the stage's 14 steps: the keyframe buffer (with its covariance channel)
  exact, the losses relative 2e-2 [<= 3.5e-3], the two normal
  regularizers, which compare the normal MLP with the bf16 density MLP's
  position gradient and drift most as the parameters part, relative 0.3
  [<= 0.15], the grid after its refresh >= 99.9% within 1e-2 of its
  largest value [100%].
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_vo_tpu.mapping import keyframe_buffer as jkb
from nerf_vo_tpu.mapping.trainer import MappingTrainer as JTrainer
from nerf_vo_tpu.mapping.trainer import TrainerConfig as JTrainerConfig
from nerf_vo_tpu.models import nerfacto as jn
from nerf_vo_tpu.ops import occupancy as jocc
from nerf_vo_tpu.runtime import stages as jstages
from nerf_vo_tpu_torch.mapping import keyframe_buffer as tkb
from nerf_vo_tpu_torch.mapping.trainer import MappingTrainer as TTrainer
from nerf_vo_tpu_torch.mapping.trainer import TrainerConfig as TTrainerConfig
from nerf_vo_tpu_torch.models import nerfacto as tn
from nerf_vo_tpu_torch.ops import occupancy as tocc
from nerf_vo_tpu_torch.runtime import stages as tstages
from torch_parity import (
    occupancy_render_uniforms,
    occupancy_step_draws,
    to_numpy_tree,
)

K, H, W, RAYS = 6, 32, 40, 128
FX = 30.0
OCC = dict(resolution=32, slab_div=4, decay=0.5)
MODEL = dict(sampler="occupancy", spacing="linear", near=0.05, far=6.0,
             use_contraction=False, aabb_min=-1.0, aabb_max=4.0,
             depth_loss_type="l2", depth_loss_mult=0.05, num_nerf_samples=16,
             num_occ_bins=64, log2_hashmap_size=14, max_res=128,
             num_images=K)
RTOL = 2e-2
NORMAL_TERMS = ("orientation_loss", "pred_normal_loss")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread, as in ``tests/test_torch_pipeline.py``: beside
    the other test workers more threads cost more in contention than they
    gain at these sizes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(**kw):
    return (jn.NerfactoConfig(**MODEL, occupancy=jocc.OccupancyConfig(**OCC),
                              **kw),
            tn.NerfactoConfig(**MODEL, occupancy=tocc.OccupancyConfig(**OCC),
                              **kw))


def _params(jcfg):
    params = to_numpy_tree(jax.jit(jn.NerfactoModel(jcfg).init)(
        jax.random.PRNGKey(0)))
    assert sorted(params) == ["field"]  # no proposal fields
    t = params["field"]["tables"]
    params["field"]["tables"] = np.random.default_rng(0).normal(
        0, 0.3, t.shape).astype(t.dtype)
    return params


def _grid(seed=0):
    """An occupancy grid with empty, faint and dense cells."""
    rng = np.random.default_rng(seed)
    g = rng.uniform(0, 2, OCC["resolution"] ** 3).astype(np.float32)
    g[rng.uniform(size=g.shape) < 0.6] = 0.0
    g[rng.uniform(size=g.shape) < 0.05] = 0.005
    return g


def test_occupancy_ops_match_jax():
    jc, tc = jocc.OccupancyConfig(**OCC), tocc.OccupancyConfig(**OCC)
    np.testing.assert_array_equal(tocc.create(tc, "cpu").numpy(),
                                  np.asarray(jocc.create(jc)))
    g = _grid()
    pos = np.random.default_rng(1).uniform(-0.2, 1.2, (50, 7, 3)).astype(
        np.float32)
    for fn in ("lookup", "bin_weights"):
        want = np.asarray(getattr(jocc, fn)(jnp.asarray(g), jnp.asarray(pos),
                                            jc))
        got = getattr(tocc, fn)(torch.tensor(g), torch.tensor(pos), tc)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=fn)
    slab = tocc.slab_size(tc)
    for step in (0, 16, 48, 80):
        key = jax.random.PRNGKey(step)
        u, start = jocc.slab_cell_centers(step, key, jc)
        jitter = torch.tensor(np.asarray(jax.random.uniform(key, (slab, 3))))
        tu, tstart = tocc.slab_cell_centers(step, jitter, tc)
        assert tstart == int(start)
        np.testing.assert_array_equal(tu.numpy(), np.asarray(u))
        dens = np.random.default_rng(step).uniform(0, 3, slab).astype(
            np.float32)
        want = jocc.refresh(jnp.asarray(g), jnp.asarray(dens), start, jc)
        got = tocc.refresh(torch.tensor(g), torch.tensor(dens), tstart, tc)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert {int(jocc.slab_cell_centers(s, key, jc)[1])
            for s in range(0, 64, 16)} == {0, slab, 2 * slab, 3 * slab}


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = _cfgs()
    params = _params(jcfg)
    tmodel = tn.NerfactoModel(tcfg)
    tmodel.load_state_dict(tn.from_jax_params(params))
    assert len(tmodel.proposal_fields) == 0
    return jn.NerfactoModel(jcfg), tmodel, params


def _rays(n=RAYS, seed=2):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3)) + [0, 0, 2.0]
    return (rng.uniform(-0.2, 0.2, (n, 3)).astype(np.float32),
            (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(
                np.float32),
            rng.integers(0, K, n).astype(np.int32))


def test_occupancy_render_matches_jax(setup):
    """Through a grid with empty cells, without a grid (every bin alike),
    deterministic and stratified."""
    jmodel, tmodel, params = setup
    o, d, cam = _rays()
    g = _grid()
    for grid in (g, None):
        for key in (None, jax.random.PRNGKey(3)):
            want = jax.jit(jmodel.render, static_argnames="train")(
                params, jnp.asarray(o), jnp.asarray(d), jnp.asarray(cam),
                key=key, train=key is not None,
                occ_grid=None if grid is None else jnp.asarray(grid))
            u = None if key is None else occupancy_render_uniforms(
                key, RAYS, jmodel.config.num_proposal_samples,
                MODEL["num_occ_bins"], MODEL["num_nerf_samples"])
            with torch.no_grad():
                got = tmodel.render(
                    torch.tensor(o), torch.tensor(d), torch.tensor(cam), u,
                    occ_grid=None if grid is None else torch.tensor(grid))
            for k in ("rgb", "depth", "accumulation", "normals", "t_mid"):
                w = np.asarray(want[k])
                np.testing.assert_allclose(
                    got[k].numpy(), w, rtol=0, atol=1e-2 * np.abs(w).max(),
                    err_msg=k)
    # the grid moves the samples: empty cells get (almost) none
    with torch.no_grad():
        a = tmodel.render(torch.tensor(o), torch.tensor(d),
                          occ_grid=torch.tensor(g))["t_mid"]
        b = tmodel.render(torch.tensor(o), torch.tensor(d))["t_mid"]
    assert (a - b).abs().max() > 0.1


@pytest.mark.parametrize("step", [0, 16])
def test_refresh_occupancy_matches_jax(setup, step):
    jmodel, tmodel, params = setup
    g = _grid(1)
    key = jax.random.PRNGKey(11)
    want = np.asarray(jax.jit(jmodel.refresh_occupancy, static_argnums=2)(
        params, jnp.asarray(g), step, key))
    jitter = torch.tensor(np.asarray(jax.random.uniform(
        key, (tocc.slab_size(tmodel.config.occupancy), 3))))
    got = tmodel.refresh_occupancy(torch.tensor(g), step, jitter).numpy()
    slab = tocc.slab_size(tmodel.config.occupancy)
    start = (step // 16) % OCC["slab_div"] * slab
    out = np.ones(g.shape, bool)
    out[start:start + slab] = False
    np.testing.assert_array_equal(got[out], want[out])
    np.testing.assert_allclose(got[~out], want[~out], rtol=1e-2, atol=1e-6)
    assert (got[~out] > g[~out] * OCC["decay"]).any()  # the field raised


def _buffers():
    """Six GT-posed keyframes of a textured plane at z = 2.5 (as
    tests/test_accuracy_ngp.py makes them), with a varying covariance and
    no normal channel (the NGP stage under ``enhancement_module: none``)."""
    rng = np.random.default_rng(7)
    ys, xs = np.mgrid[0:H, 0:W]
    c2w = np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))
    c2w[:, 0, 3] = np.linspace(-0.15, 0.15, K)
    c2w[:, 1, 3] = rng.uniform(-0.05, 0.05, K)
    colors = np.zeros((K, H, W, 3), np.float32)
    depths = np.zeros((K, H, W), np.float32)
    for k in range(K):
        dirs = np.stack([(xs - W / 2) / FX, (ys - H / 2) / FX,
                         np.ones_like(xs)], -1) @ c2w[k, :3, :3].T
        t = (2.5 - c2w[k, 2, 3]) / dirs[..., 2]
        p = c2w[k, :3, 3] + t[..., None] * dirs
        colors[k] = np.stack([0.5 + 0.45 * np.sin(4 * p[..., 0]),
                              0.5 + 0.45 * np.cos(5 * p[..., 1]),
                              0.5 + 0.3 * np.sin(3 * (p[..., 0] - p[..., 1]))],
                             -1)
        depths[k] = t
    pkt = {"intrinsics": np.tile(np.asarray([[FX, FX, W / 2, H / 2]],
                                            np.float32), (K, 1)),
           "c2w": c2w, "color": colors, "depth": depths,
           "depth_cov": np.tile((0.01 + 0.05 * ((xs - W / 2) / W) ** 2
                                 ).astype(np.float32), (K, 1, 1))}
    jb = jkb.insert(jkb.create(K, H, W, use_normals=False,
                               use_depth_cov=True),
                    jnp.arange(K), {k: jnp.asarray(v) for k, v in pkt.items()})
    tb = tkb.create(K, H, W, use_normals=False, use_depth_cov=True,
                    device="cpu")
    tkb.insert(tb, torch.arange(K), {k: torch.tensor(v)
                                     for k, v in pkt.items()})
    return jb, tb


@pytest.fixture(scope="module")
def trained(setup):
    """Three train steps of both trainers (step 0 refreshes the grid)."""
    jmodel, _, params = setup
    jb, tb = _buffers()
    np.testing.assert_array_equal(tb.pixels.float().numpy(),
                                  np.asarray(jb.pixels, np.float32))
    jtr = JTrainer(jmodel, JTrainerConfig(rays_per_batch=RAYS), K)
    jstate = jtr.init(jax.random.PRNGKey(0))
    jstate = jstate.replace(params=jax.tree_util.tree_map(jnp.asarray,
                                                          params))
    jstate = jstate.replace(opt_state=jtr.tx.init(jstate.params))
    _, tcfg = _cfgs()
    tmodel = tn.NerfactoModel(tcfg)
    tmodel.load_state_dict(tn.from_jax_params(params))
    ttr = TTrainer(tmodel, TTrainerConfig(rays_per_batch=RAYS), K,
                   device="cpu")
    tstate = ttr.init()
    np.testing.assert_array_equal(tstate.occ_grid.numpy(),
                                  np.asarray(jstate.occ_grid))
    slab = tocc.slab_size(tcfg.occupancy)
    jm, tm, grids = [], [], []
    for i in range(3):
        key = jax.random.PRNGKey(100 + i)
        d = occupancy_step_draws(key, K, H, W, RAYS,
                                 jmodel.config.num_proposal_samples,
                                 MODEL["num_occ_bins"],
                                 MODEL["num_nerf_samples"], slab)
        jstate, m = jtr.train_step(jstate, jb, key)
        jm.append({k: float(v) for k, v in m.items()})
        tstate, m = ttr.train_step(tstate, tb, d)
        tm.append({k: float(v) for k, v in m.items()})
        grids.append((np.asarray(jstate.occ_grid),
                      tstate.occ_grid.numpy().copy()))
    return dict(jstate=jstate, tstate=tstate, jm=jm, tm=tm, grids=grids,
                ttr=ttr, jtr=jtr)


def test_ngp_train_steps_match_jax(trained):
    for jm, tm in zip(trained["jm"], trained["tm"]):
        assert sorted(jm) == sorted(tm)
        assert "depth_loss" in tm
        for k in jm:
            np.testing.assert_allclose(tm[k], jm[k], rtol=RTOL, err_msg=k)
    jstate, tstate = trained["jstate"], trained["tstate"]
    want = tn.from_jax_params(to_numpy_tree(jstate.params))
    close = total = 0
    for name, p in tstate.params.items():
        diff = np.abs(p.detach().numpy() - want[name].numpy())
        close += int(np.sum(diff <= 1e-3))
        total += diff.size
    assert close / total >= 0.99
    assert tstate.step == int(jstate.step) == 3


def test_ngp_occupancy_refresh_in_training(trained):
    """Step 0 refreshes a quarter of the grid (decay 0.5 everywhere, the
    slab max-merged with the field); steps 1 and 2 leave it alone."""
    (j0, t0), _, (j2, t2) = trained["grids"]
    slab = OCC["resolution"] ** 3 // OCC["slab_div"]
    np.testing.assert_array_equal(t0[slab:], j0[slab:])
    assert (t0[slab:] == 0.5).all()
    np.testing.assert_allclose(t0[:slab], j0[:slab], rtol=1e-2, atol=1e-6)
    np.testing.assert_array_equal(t2, t0)
    np.testing.assert_array_equal(j2, j0)


def test_ngp_render_image_uses_the_grid(trained):
    """The trainer's chunked render passes its grid: the image matches the
    JAX trainer's, and another grid changes it."""
    ttr, tstate = trained["ttr"], trained["tstate"]
    c2w = np.eye(4, dtype=np.float32)
    intr = np.asarray([FX, FX, W / 2, H / 2], np.float32)
    a = ttr.render_image(tstate, c2w, intr, 8, 10)
    jtr, jstate = trained["jtr"], trained["jstate"]
    want = jtr.render_image(jstate, jnp.asarray(c2w), jnp.asarray(intr), 8,
                            10, chunk=80)
    for k in ("rgb", "depth", "accumulation"):
        w = np.asarray(want[k])
        np.testing.assert_allclose(a[k].numpy(), w, rtol=0,
                                   atol=5e-2 * np.abs(w).max(), err_msg=k)
    saved = tstate.occ_grid
    tstate.occ_grid = torch.tensor(_grid())
    b = ttr.render_image(tstate, c2w, intr, 8, 10)
    tstate.occ_grid = saved
    assert (a["depth"] - b["depth"]).abs().max() > 1e-3


def _stage_args(**kw):
    return SimpleNamespace(
        num_keyframes=K, frame_height=H, frame_width=W, mapping_iterations=14,
        rays_per_batch=RAYS, enhancement_module="none",
        mapping_module="instant-ngp", mapping_model_overrides=dict(
            log2_hashmap_size=14, max_res=64, num_nerf_samples=8,
            num_occ_bins=16), **kw)


def test_mapping_stage_instant_ngp_matches_jax():
    """One DROID packet (depth and covariance) into both NGP stages: the
    buffer with its covariance channel, the pacing rule, the end of the
    stream, every step's losses (a refresh at step 0), then the snapshot
    holds the grid."""
    args = _stage_args()
    jst = jstages.MappingStage(args)
    tst = tstages.MappingStage(
        args, state_dict=tn.from_jax_params(to_numpy_tree(jst.state.params)),
        device="cpu")
    mc = tst.model.config
    assert (mc.sampler, mc.spacing, mc.depth_loss_type, mc.use_contraction,
            mc.occupancy.resolution) == ("occupancy", "linear", "l2", False,
                                         128)
    assert tst.buffer.use_depth_cov and not tst.model.proposal_fields
    _, tb = _buffers()
    pkt = {"camera_extrinsics": tb.c2w[:3].numpy(),
           "camera_intrinsics": tb.intrinsics[:3].numpy(),
           "frames_color_float": tb.color[:3].float().numpy(),
           "frames_depth": tb.depth[:3].float().numpy(),
           "frames_depth_cov": np.random.default_rng(4).uniform(
               0.01, 2.0, (3, H, W)).astype(np.float32),
           "keyframe_indices": np.arange(3)}
    jst.update(pkt)
    tst.update({k: torch.tensor(v) for k, v in pkt.items()})
    np.testing.assert_array_equal(tst.buffer.pixels.float().numpy(),
                                  np.asarray(jst.buffer.pixels, np.float32))
    np.testing.assert_array_equal(tst.buffer.depth_cov[:3].numpy(),
                                  np.asarray(jst.buffer.depth_cov[:3]))
    slab = tocc.slab_size(mc.occupancy)
    key = jax.random.PRNGKey(7)  # the JAX stage's step key stream
    jst.stream_active = tst.stream_active = False
    steps = 0
    while jst.can_train():
        key, sub = jax.random.split(key)
        d = occupancy_step_draws(sub, jst.num_inserted, H, W, RAYS,
                                 mc.num_proposal_samples, mc.num_occ_bins,
                                 mc.num_nerf_samples, slab)
        mj, mt = jst.train_step(), tst.train_step(d)
        for k in mj:
            np.testing.assert_allclose(
                float(mt[k]), float(mj[k]), err_msg=k,
                rtol=0.3 if k in NORMAL_TERMS else RTOL)
        steps += 1
    assert not tst.can_train() and steps == args.mapping_iterations
    jg, tg = np.asarray(jst.state.occ_grid), tst.state.occ_grid.numpy()
    assert (tg < 1).any()
    assert np.mean(np.abs(tg - jg) <= 1e-2 * np.abs(jg).max()) >= 0.999
    full = tst._train_state()
    assert torch.equal(full["occ_grid"], tst.state.occ_grid)

