"""The port's mapping half (``nerf_vo_tpu_torch/mapping/``, the
``MappingStage`` of ``runtime/stages.py``) against the JAX package's, and
the port's whole nerf_vo main path on the CPU.

The model is the mapper's geometry cut to size, as in
``tests/test_torch_nerfacto.py``: field 3 levels x 8 features at log2 table
14, proposals at resolutions 16 / 24 with (16, 8) samples, 8 nerf samples;
keyframes of 16x24 pixels, 64 rays per step. Parameters are one JAX init
carried across with ``nerfacto.from_jax_params``; each step's draws are the
ones the JAX step's key gives (``tests/torch_parity.py``).

Tolerances (measured spread in brackets):
- buffer contents: exact (the same bf16 rounding of the same f32 values);
  gauge-normalized poses and ray batches 1e-5;
- loss terms at every step: relative 1e-2 (the bf16 MLPs; <= 1e-3). Over
  the stage's 14 steps the parameters drift apart as below, and the two
  normal regularizers, which compare the normal MLP's output with the
  bf16 density MLP's position gradient, drift most: relative 0.2 for
  them [<= 9.4e-2 orientation, 2.6e-2 predicted-normal; the other terms
  <= 8e-4];
- per-leaf gradients of step 0: relative L2 < 5e-2 (<= 2.5e-2 for biases);
- after 3 Adam steps: Adam with eps 1e-15 moves every parameter element by
  about +-lr whatever its gradient's size, so an element whose small
  gradient changes sign or size through bf16 rounding lands up to 2 lr
  away. Parameters are compared by the share of elements within lr / 10 of
  JAX's: >= 99% of all elements [99.8%], >= 80% of each leaf [>= 86%, the
  normal MLP's head, trained only by the 1e-3 predicted-normal loss], and
  >= 99% of each leaf within 2.5 lr [>= 99.8%]; pose deltas (Adam eps 1e-8,
  camera lr 1e-4): >= 90% within lr / 10 [97%], all within 2.5 lr;
- the distilled proposal tables after the step-0 refresh, evaluated at the
  updated parameters (which differ as above): >= 99% of entries within
  1e-3 of JAX's [99.8%; the logits span 0.03].
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
from nerf_vo_tpu.runtime import stages as jstages
from nerf_vo_tpu_torch.mapping import keyframe_buffer as tkb
from nerf_vo_tpu_torch.mapping.trainer import MappingTrainer as TTrainer
from nerf_vo_tpu_torch.mapping.trainer import TrainerConfig as TTrainerConfig
from nerf_vo_tpu_torch.models import nerfacto as tn
from nerf_vo_tpu_torch.runtime import stages as tstages
from torch_parity import rel_l2, step_draws, to_numpy_tree

H, W, K, RAYS = 16, 24, 6, 64
MODEL = dict(log2_hashmap_size=14, max_res=64, proposal_resolutions=(16, 24),
             num_proposal_samples=(16, 8), num_nerf_samples=8)
CFG = dict(MODEL, near=0.05, far=20.0, num_images=K, aabb_min=-4.0,
           aabb_max=4.0)
RTOL = 1e-2
# the normal regularizers over many steps (see the module docstring)
NORMAL_TERMS = ("orientation_loss", "pred_normal_loss")
NORMAL_RTOL = 0.2


def _packet(n, seed, use_normals=True):
    """n keyframes of a smooth scene: cameras along a short arc looking
    down -z (OpenGL), colors smooth in the image, depth 1.5-3.5 m."""
    rng = np.random.default_rng(seed)
    c2w = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    ang = rng.uniform(-0.2, 0.2, n)
    c2w[:, 0, 0], c2w[:, 0, 2] = np.cos(ang), np.sin(ang)
    c2w[:, 2, 0], c2w[:, 2, 2] = -np.sin(ang), np.cos(ang)
    c2w[:, :3, 3] = rng.normal(0, 0.3, (n, 3)) + [1.0, 0.5, 2.0]
    yy, xx = np.meshgrid(np.linspace(0, 1, H), np.linspace(0, 1, W),
                         indexing="ij")
    base = rng.uniform(0.1, 0.9, (n, 1, 1, 3))
    color = np.clip(base + 0.3 * np.sin(6 * xx + 4 * yy)[None, ..., None],
                    0, 1).astype(np.float32)
    depth = (2.5 + np.cos(3 * xx - yy)[None] * rng.uniform(0.5, 1, (n, 1, 1))
             ).astype(np.float32)
    depth[:, 0, :3] = 0.0  # invalid pixels
    pkt = {
        "intrinsics": np.tile(np.asarray([[20.0, 20.0, W / 2, H / 2]],
                                         np.float32), (n, 1)),
        "c2w": c2w, "color": color, "depth": depth,
    }
    if use_normals:
        nrm = rng.normal(size=(n, H, W, 3)) + [0, 0, 3.0]
        pkt["normal"] = (nrm / np.linalg.norm(nrm, axis=-1, keepdims=True)
                         ).astype(np.float32)
    return pkt


def _buffers(use_normals=True):
    jb = jkb.create(K, H, W, use_normals=use_normals)
    tb = tkb.create(K, H, W, use_normals=use_normals, device="cpu")
    for idx, seed in (([0, 1, 2], 0), ([3], 1), ([1], 2)):
        pkt = _packet(len(idx), seed, use_normals)
        if seed == 2:  # an update without depth keeps the old depth
            del pkt["depth"]
        jb = jkb.insert(jb, jnp.asarray(idx), {k: jnp.asarray(v)
                                               for k, v in pkt.items()})
        tkb.insert(tb, idx, {k: torch.tensor(v) for k, v in pkt.items()})
    return jb, tb


@pytest.mark.parametrize("use_normals", [True, False])
def test_buffer_insert_gauge_and_packing(use_normals):
    jb, tb = _buffers(use_normals)
    assert tb.num_active == int(jb.num_active) == 4
    assert tb.pixels.dtype == torch.bfloat16 == getattr(
        torch, str(jb.pixels.dtype))
    np.testing.assert_array_equal(tb.pixels.float().numpy(),
                                  np.asarray(jb.pixels, np.float32))
    np.testing.assert_allclose(tb.c2w[0].numpy(), np.eye(4), atol=1e-5)
    for name in ("c2w", "normalization", "intrinsics"):
        np.testing.assert_allclose(getattr(tb, name).numpy(),
                                   np.asarray(getattr(jb, name)), atol=1e-5)
    for name in ("color", "depth", "normal", "depth_cov"):
        np.testing.assert_array_equal(getattr(tb, name).numpy(),
                                      np.asarray(getattr(jb, name)))


def test_ray_batch_with_pose_deltas_matches_jax():
    jb, tb = _buffers()
    key = jax.random.PRNGKey(5)
    d = step_draws(key, 4, H, W, RAYS, (16, 8), 8)
    deltas = np.random.default_rng(3).normal(0, 0.05, (K, 6)).astype(
        np.float32)
    k_sample, _ = jax.random.split(key)
    want = jax.jit(jkb.sample_ray_batch, static_argnums=3)(
        jb, jnp.asarray(deltas), k_sample, RAYS)
    t_deltas = torch.tensor(deltas, requires_grad=True)
    got = tkb.sample_ray_batch(tb, t_deltas, RAYS, picks=d)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].detach().numpy(),
                                   np.asarray(want[k]), rtol=0, atol=1e-5,
                                   err_msg=k)
    # differentiable in the pose deltas, through the ray origins/directions
    def objective(p):
        b = jkb.sample_ray_batch(jb, p, k_sample, RAYS)
        return jnp.sum(b["directions"] ** 2 * jnp.arange(3.0) + b["origins"])

    g_want = jax.jit(jax.grad(objective))(jnp.asarray(deltas))
    (g_got,) = torch.autograd.grad(
        torch.sum(got["directions"] ** 2 * torch.arange(3.0)
                  + got["origins"]), t_deltas)
    np.testing.assert_allclose(g_got.numpy(), np.asarray(g_want), atol=1e-5)


@pytest.fixture(scope="module")
def trained():
    """Three train steps of both trainers from one init on one buffer."""
    jb, tb = _buffers()
    jmodel = jn.NerfactoModel(jn.NerfactoConfig(**CFG))
    jtr = JTrainer(jmodel, JTrainerConfig(rays_per_batch=RAYS), K)
    jstate = jtr.init(jax.random.PRNGKey(0))
    params0 = to_numpy_tree(jstate.params)
    tmodel = tn.NerfactoModel(tn.NerfactoConfig(**CFG))
    tmodel.load_state_dict(tn.from_jax_params(params0))
    ttr = TTrainer(tmodel, TTrainerConfig(rays_per_batch=RAYS), K,
                   device="cpu")
    tstate = ttr.init()

    keys = [jax.random.PRNGKey(100 + i) for i in range(3)]
    draws = [step_draws(k, 4, H, W, RAYS, MODEL["num_proposal_samples"],
                        MODEL["num_nerf_samples"]) for k in keys]
    # step-0 gradients, before any update
    jgrads = jax.jit(jax.grad(
        lambda p, d: jtr._loss_fn(p, d, jb, keys[0], step=0)[0],
        argnums=(0, 1)))(jstate.params, jstate.pose_deltas)
    batch = tkb.sample_ray_batch(tb, tstate.pose_deltas, RAYS, draws[0])
    loss, _ = tmodel.loss(batch, draws[0]["uniforms"])
    tgrads = torch.autograd.grad(
        loss, list(tstate.params.values()) + [tstate.pose_deltas])

    jm, tm, jprops, tprops = [], [], [], []
    for key, d in zip(keys, draws):
        jstate, m = jtr.train_step(jstate, jb, key)
        jm.append({k: float(v) for k, v in m.items()})
        jprops.append([np.asarray(jstate.params[f"proposal_{i}"]["tables"])
                       for i in range(2)])
        tstate, m = ttr.train_step(tstate, tb, d)
        tm.append({k: float(v) for k, v in m.items()})
        tprops.append([pf.tables.detach().numpy().copy()
                       for pf in tmodel.proposal_fields])
    return dict(jgrads=jgrads, tgrads=tgrads, tstate=tstate, jstate=jstate,
                jm=jm, tm=tm, jprops=jprops, tprops=tprops, params0=params0)


def test_train_steps_losses_match_jax(trained):
    for jm, tm in zip(trained["jm"], trained["tm"]):
        assert sorted(jm) == sorted(tm)
        for k in jm:
            np.testing.assert_allclose(tm[k], jm[k], rtol=RTOL, err_msg=k)


def test_step0_gradients_match_jax(trained):
    gp, gpose = trained["jgrads"]
    want = tn.from_jax_params(to_numpy_tree(gp))
    names = list(trained["tstate"].params)
    for name, g in zip(names, trained["tgrads"][:-1]):
        assert rel_l2(g.numpy(), want[name].numpy()) < 5e-2, name
    g_pose = trained["tgrads"][-1].numpy()
    assert np.abs(g_pose).max() > 0
    assert rel_l2(g_pose, gpose) < 5e-2


def test_params_and_pose_deltas_after_three_steps(trained):
    jstate, tstate = trained["jstate"], trained["tstate"]
    want = tn.from_jax_params(to_numpy_tree(jstate.params))
    lr = 1e-2
    close = total = 0
    for name, p in tstate.params.items():
        diff = np.abs(p.detach().numpy() - want[name].numpy())
        assert np.mean(diff <= lr / 10) >= 0.8, name
        assert np.mean(diff <= 2.5 * lr) >= 0.99, name
        close += int(np.sum(diff <= lr / 10))
        total += diff.size
    assert close / total >= 0.99
    moved = tstate.params["field.tables"].detach().numpy() - \
        tn.from_jax_params(trained["params0"])["field.tables"].numpy()
    assert np.abs(moved).max() > lr  # three steps moved the tables
    pd_t = tstate.pose_deltas.detach().numpy()
    pd_j = np.asarray(jstate.pose_deltas)
    assert not pd_t[0].any() and np.abs(pd_t).max() > 0  # kf 0 frozen
    cam_lr = 1e-4
    assert np.mean(np.abs(pd_t - pd_j) <= cam_lr / 10) >= 0.9
    assert np.abs(pd_t - pd_j).max() <= 2.5 * cam_lr
    assert tstate.step == int(jstate.step) == 3


def test_proposal_refresh_at_step0_matches_jax(trained):
    """Step 0 refreshes the distilled proposal grids from the updated field
    (steps 1 and 2 leave them alone)."""
    for i in range(2):
        got = trained["tprops"][0][i]
        want = trained["jprops"][0][i].T
        assert np.mean(np.abs(got - want) <= 1e-3) >= 0.99
        np.testing.assert_array_equal(trained["tprops"][2][i], got)


def _stage_args(**kw):
    return SimpleNamespace(
        num_keyframes=K, frame_height=H, frame_width=W, mapping_iterations=14,
        rays_per_batch=RAYS, enhancement_module="depth",
        mapping_module="nerfstudio", mapping_model_overrides=dict(
            log2_hashmap_size=14, max_res=64, proposal_resolutions=[16, 24],
            num_proposal_samples=[16, 8], num_nerf_samples=8), **kw)


def _enhanced(n, seed):
    """An enhanced packet as the enhancement stage hands it on."""
    p = _packet(n, seed, use_normals=False)
    return {"camera_extrinsics": p["c2w"], "camera_intrinsics":
            p["intrinsics"], "frames_color_float": p["color"],
            "frames_depth": p["depth"],
            "keyframe_indices": np.arange(n)}


def test_mapping_stage_matches_jax():
    """The same enhanced packets into both stages: buffer contents, the
    pacing rule (mapping_iterations / num_keyframes = 2.33 steps between
    packets), the stream's end, and every step's losses."""
    args = _stage_args()
    jst = jstages.MappingStage(args)
    tst = tstages.MappingStage(
        args, state_dict=tn.from_jax_params(to_numpy_tree(jst.state.params)),
        device="cpu")
    key = jax.random.PRNGKey(7)  # the JAX stage's step key stream

    def step_both():
        nonlocal key
        assert tst.can_train() == jst.can_train()
        if not jst.can_train():
            assert tst.train_step() is None
            return None
        key, sub = jax.random.split(key)
        d = step_draws(sub, jst.num_inserted, H, W, RAYS,
                       MODEL["num_proposal_samples"],
                       MODEL["num_nerf_samples"])
        mj = jst.train_step()
        mt = tst.train_step(d)
        for k in mj:
            np.testing.assert_allclose(
                float(mt[k]), float(mj[k]), err_msg=k,
                rtol=NORMAL_RTOL if k in NORMAL_TERMS else RTOL)
        return mt

    steps = []
    for n, seed in ((2, 0), (3, 1), (3, 2)):  # the last overflows K = 6
        pkt = _enhanced(n, seed)
        jst.update(pkt)
        tst.update({k: torch.tensor(v) for k, v in pkt.items()})
        assert tst.num_inserted == jst.num_inserted
        count = 0
        while step_both() is not None:
            count += 1
        steps.append(count)
    assert steps == [3, 3, 3] and tst.num_inserted == K
    np.testing.assert_array_equal(tst.buffer.pixels.float().numpy(),
                                  np.asarray(jst.buffer.pixels, np.float32))
    np.testing.assert_allclose(tst.buffer.c2w.numpy(),
                               np.asarray(jst.buffer.c2w), atol=1e-5)
    # end of stream: train on to mapping_iterations
    jst.stream_active = tst.stream_active = False
    while step_both() is not None:
        pass
    assert tst.step_count == jst.step_count == args.mapping_iterations


def _frames(n, h, w):
    rng = np.random.default_rng(0)
    base = rng.uniform(0, 255, (h // 4 + 2, (w + 2 * n) // 4 + 2, 3))
    big = np.kron(base, np.ones((4, 4, 1)))
    return [np.ascontiguousarray(big[:h, 2 * i:2 * i + w].astype(np.uint8))
            for i in range(n)]


def test_port_main_path_on_cpu():
    """Tracking -> enhancement -> mapping, port only, tiny size, in the
    serial loop's order; then the end of the stream and a full-frame
    render. Every metric is finite."""
    h, w = 48, 64
    args = SimpleNamespace(
        frame_height=h, frame_width=w, patches_per_frame=8, removal_window=6,
        optimization_window=4, patch_lifetime=4, tracking_init_frames=4,
        tracking_max_edges=512, tracking_ring_size=8, tracking_max_frames=64,
        keyframe_threshold=0.0, enhancement_module="depth",
        enhancement_image_size=64, enhancement_dpt_layers=2,
        mapping_module="nerfstudio", num_keyframes=16, mapping_iterations=24,
        rays_per_batch=RAYS, mapping_model_overrides=dict(
            log2_hashmap_size=14, max_res=64, proposal_resolutions=[16, 24],
            num_proposal_samples=[16, 8], num_nerf_samples=8))
    tracking = tstages.TrackingStage(args, device="cpu")
    enhancement = tstages.EnhancementStage(args, device="cpu")
    mapping = tstages.MappingStage(args, device="cpu")
    intr = dict(fx=40.0, fy=40.0, cx=w / 2, cy=h / 2)
    frames = _frames(10, h, w)
    metrics = []
    for i, img in enumerate(frames):
        pkt = tracking.step(dict(frame_index=i, frame_color=img,
                                 camera_intrinsics=intr,
                                 last_frame=i == len(frames) - 1))
        if pkt is not None:
            mapping.update(enhancement.step(pkt))
        for _ in range(2):
            m = mapping.train_step()
            if m is None:
                break
            metrics.append(m)
    mapping.finish()
    assert mapping.num_inserted == 10
    assert mapping.step_count == args.mapping_iterations
    assert metrics and all(torch.isfinite(v).all() for m in metrics
                           for v in m.values())
    st = mapping.trainer
    out = st.render_image(mapping.state,
                          st.optimized_c2w(mapping.state, mapping.buffer)[0],
                          mapping.buffer.intrinsics[0], 12, 16)
    assert out["rgb"].shape == (12, 16, 3)
    assert all(torch.isfinite(v).all() for v in out.values())
    assert 0 <= out["rgb"].min() and out["rgb"].max() <= 1
