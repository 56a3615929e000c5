"""The mapper's other configurations in the port against the JAX package:
nerfstudio's hash proposals trained by the interlevel loss with per-sample
normals, MLP proposals, dense grids trained by the interlevel loss, bf16
proposal tables, phased table gradients, the prefetched pixel batch, and the
f32 DROID correlation pyramid.

The model is the mapper's geometry cut to size, as in
``tests/test_torch_mapping.py``: field 3 levels x 8 features at log2 table
14 (level 0 on the one-hot route, levels 1-2 scattered), dense proposals at
resolutions 16 / 24, (16, 8) proposal samples, 8 nerf samples; hash
proposals at their own fixed geometry (5 levels x 2 features, log2 17, to
resolution 128 / 256); MLP proposals with 4 / 6 frequencies and 64
distillation points; keyframes of 16x24 pixels, 64 rays a step.
Parameters: one JAX init, the field's and proposals' tables redrawn wider
than the +-1e-4 init (so that the proposals place samples unevenly and the
interlevel loss is not 0), carried across with ``nerfacto.from_jax_params``.
Draws: the ones the JAX step's key gives (``tests/torch_parity.py``). The
JAX side is jitted.

Tolerances (measured spread in brackets, over the five configurations;
from the bf16 MLPs on both sides, amplified by Adam):
- loss terms of step 0: relative 1e-3 [<= 1.7e-4];
- loss terms of steps 1 and 2, after one or two Adam steps (every element
  moves about +-lr, so parameters whose small gradients differ in sign
  part, see ``tests/test_torch_mapping.py``): relative 1e-2 [<= 7.8e-3];
  the interlevel loss, a ratio of small histogram differences, 5e-2
  [<= 3.3e-2]; the three normal terms (the normal MLP, trained only by the
  1e-3 predicted-normal loss, drifts most) 0.25 [<= 0.19, the orientation
  loss];
- per-leaf gradients of step 0: relative L2 < 5e-2 [<= 2.7e-2, the biases;
  the proposal tables and MLPs under the interlevel or distillation loss
  <= 1.5e-2]; pose deltas 1e-2 [<= 5.8e-3];
- after three Adam steps: >= 97% of all elements within lr / 10 of JAX's
  [>= 98.3%], >= 99% of each leaf within 2.5 lr [>= 99.7%], and within
  lr / 10 >= 80% of each leaf [>= 87%] except the normal MLP's and the
  density MLP's first layer, which the normal targets drive: >= 40% [>=
  47%]. A bf16 table (dense + interlevel + bf16) is held at its own
  resolution: within lr / 10 plus one bf16 ulp of the value;
- the bf16 dense grid's forward against the f32 grid on the rounded
  table: bitwise; against JAX's bf16 grid: relative 1e-6;
- the f32 pyramid and its lookup: 1e-5 (f32 products in another order).
"""

import importlib
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_vo_tpu.mapping.trainer import MappingTrainer as JTrainer
from nerf_vo_tpu.mapping.trainer import TrainerConfig as JTrainerConfig
from nerf_vo_tpu.models import nerf_field as jf
from nerf_vo_tpu.models import nerfacto as jn
from nerf_vo_tpu.runtime import stages as jstages
from nerf_vo_tpu_torch.mapping import keyframe_buffer as tkb
from nerf_vo_tpu_torch.mapping.trainer import MappingTrainer as TTrainer
from nerf_vo_tpu_torch.mapping.trainer import TrainerConfig as TTrainerConfig
from nerf_vo_tpu_torch.models import nerf_field as tf
from nerf_vo_tpu_torch.models import nerfacto as tn
from nerf_vo_tpu_torch.runtime import stages as tstages
from test_torch_mapping import H, K, RAYS, W, _buffers, _enhanced
from torch_parity import (pixel_picks, rel_l2, render_uniforms, step_draws,
                          to_numpy_tree)

MODEL = dict(log2_hashmap_size=14, max_res=64, proposal_resolutions=(16, 24),
             num_proposal_samples=(16, 8), num_nerf_samples=8,
             proposal_distill_points=64)
CFG = dict(MODEL, near=0.05, far=20.0, num_images=K, aabb_min=-4.0,
           aabb_max=4.0)
RTOL = 1e-2
STEP0_RTOL = 1e-3
NORMAL_TERMS = ("orientation_loss", "pred_normal_loss", "normal_loss")
NORMAL_RTOL = 0.25
INTERLEVEL_RTOL = 5e-2
GRAD_RTOL = 5e-2
LR = 1e-2
# leaves driven by the normal targets (see the module docstring)
NORMAL_LEAVES = ("field.normal_mlp.", "field.density_mlp.layers.0.")

VARIANTS = {
    "hash_interlevel_samples": dict(proposal_type="hash",
                                    proposal_training="interlevel",
                                    grad_normal_mode="samples"),
    "mlp_distill": dict(proposal_type="mlp"),
    "dense_interlevel": dict(proposal_training="interlevel"),
    "phased": dict(table_grad_phase=True),
    "dense_interlevel_bf16": dict(proposal_training="interlevel",
                                  proposal_table_dtype="bfloat16"),
}


def _widen(params, seed=0):
    """The JAX params with wider tables (see the module docstring)."""
    rng = np.random.default_rng(seed)
    for k, tree in params.items():
        if "tables" not in tree:
            continue
        t = tree["tables"]
        if k == "field":
            v = rng.normal(0, 0.3, t.shape)
        elif t.shape[0] == 32:  # a dense grid's density logits
            v = rng.normal(0, 1.0, t.shape) + 1.0
        else:  # a hash proposal's features
            v = rng.normal(0, 1.0, t.shape)
        tree["tables"] = v.astype(t.dtype)
    return params


def _draws(key, n_active, cfg, prefetch=False, first=False):
    """The draws of one JAX train step from its key (see torch_parity): the
    MLP proposals' distillation points come from fold_in(render key, 7);
    in prefetch mode the picks are the next batch's (fold_in(key, 2)) and
    the first call's fill fold_in(key, 3)."""
    d = step_draws(key, n_active, H, W, RAYS, cfg.num_proposal_samples,
                   cfg.num_nerf_samples)
    k_render = jax.random.split(key)[1]
    if cfg.proposal_type == "mlp":
        d["distill_points"] = torch.tensor(np.asarray(jax.random.uniform(
            jax.random.fold_in(k_render, 7),
            (cfg.proposal_distill_points, 3))))
    if prefetch:
        d.update(pixel_picks(jax.random.fold_in(key, 2), n_active, H, W,
                             RAYS))
        if first:
            d["fill"] = pixel_picks(jax.random.fold_in(key, 3), n_active, H,
                                    W, RAYS)
    return d


def _train_both(over, steps=3, prefetch=False, grads=True):
    """``steps`` train steps of both trainers from one (widened) init on
    one buffer; with ``grads`` also both step-0 gradients."""
    jb, tb = _buffers()
    jcfg = jn.NerfactoConfig(**CFG, **over)
    tcfg = tn.NerfactoConfig(**CFG, **over)
    jmodel = jn.NerfactoModel(jcfg)
    jtr = JTrainer(jmodel, JTrainerConfig(rays_per_batch=RAYS,
                                          prefetch_batch=prefetch), K)
    jstate = jtr.init(jax.random.PRNGKey(0))
    params0 = _widen(to_numpy_tree(jstate.params))
    jstate = jstate.replace(params=jax.tree_util.tree_map(jnp.asarray,
                                                          params0))
    tmodel = tn.NerfactoModel(tcfg)
    tmodel.load_state_dict(tn.from_jax_params(params0))
    ttr = TTrainer(tmodel, TTrainerConfig(rays_per_batch=RAYS,
                                          prefetch_batch=prefetch), K,
                   device="cpu")
    tstate = ttr.init()
    keys = [jax.random.PRNGKey(100 + i) for i in range(steps)]
    draws = [_draws(k, 4, tcfg, prefetch, i == 0) for i, k in enumerate(keys)]
    out = dict(tmodel=tmodel, params0=params0, draws=draws)
    if grads:
        out["jgrads"] = jax.jit(jax.grad(
            lambda p, d: jtr._loss_fn(p, d, jb, keys[0],
                                   step=jnp.asarray(0, jnp.int32))[0],
            argnums=(0, 1)))(jstate.params, jstate.pose_deltas)
        batch = tkb.sample_ray_batch(tb, tstate.pose_deltas, RAYS, draws[0])
        loss, _ = tmodel.loss(batch, draws[0]["uniforms"], step=0,
                              distill_points=draws[0].get("distill_points"))
        out["tgrads"] = dict(zip(
            list(tstate.params) + ["pose_deltas"], torch.autograd.grad(
                loss, list(tstate.params.values()) + [tstate.pose_deltas],
                allow_unused=True)))
    jm, tm = [], []
    for key, d in zip(keys, draws):
        jstate, m = jtr.train_step(jstate, jb, key)
        jm.append({k: float(v) for k, v in m.items()})
        tstate, m = ttr.train_step(tstate, tb, d)
        tm.append({k: float(v) for k, v in m.items()})
    out.update(jstate=jstate, tstate=tstate, jm=jm, tm=tm)
    return out


@pytest.fixture(scope="module", params=list(VARIANTS))
def trained(request):
    return request.param, _train_both(VARIANTS[request.param])


def _check_losses(jms, tms):
    for step, (jm, tm) in enumerate(zip(jms, tms)):
        assert sorted(jm) == sorted(tm)
        for k in jm:
            if step == 0:
                rtol = STEP0_RTOL
            elif k in NORMAL_TERMS:
                rtol = NORMAL_RTOL
            elif k == "interlevel_loss":
                rtol = INTERLEVEL_RTOL
            else:
                rtol = RTOL
            np.testing.assert_allclose(tm[k], jm[k], rtol=rtol,
                                       err_msg=f"step {step} {k}")


def test_losses_of_three_steps_match_jax(trained):
    name, t = trained
    _check_losses(t["jm"], t["tm"])
    if "interlevel" in name:
        assert all(m["interlevel_loss"] > 0 for m in t["tm"])
    if name == "mlp_distill":
        assert all(m["proposal_distill_loss"] > 0 for m in t["tm"])


def test_step0_gradients_match_jax(trained):
    name, t = trained
    gp, gpose = t["jgrads"]
    want = tn.from_jax_params(to_numpy_tree(gp))
    tg = t["tgrads"]
    for leaf, g in tg.items():
        if leaf == "pose_deltas":
            continue
        w = want[leaf].float().numpy()
        if g is None:  # no path to the loss: JAX's gradient is 0 too
            assert not w.any(), leaf
            continue
        assert rel_l2(g.float().numpy(), w) < GRAD_RTOL, leaf
    if "interlevel" in name:  # the interlevel loss trains the proposals
        assert any(k.startswith("proposal_fields") and tg[k] is not None
                   and tg[k].abs().max() > 0 for k in tg), name
    assert rel_l2(tg["pose_deltas"].numpy(), gpose) < 1e-2


@pytest.mark.parametrize("phase", [0, 1, 2])
def test_phased_table_gradient(phase):
    """``hash_encode(..., grad_phase)`` on the field's grid (level 0
    one-hot, levels 1-2 scattered): the one-hot level and scattered level
    1 + phase % 2 get their gradient, bitwise the unphased one's rows;
    the other scattered level's is exactly 0, as in JAX (whose scattered
    rows accumulate in bf16: relative L2 1e-2 [<= 2.0e-3])."""
    from nerf_vo_tpu.ops import hash_grid as jhg
    from nerf_vo_tpu_torch.ops import hash_grid as thg

    cfg = thg.HashGridConfig(3, 8, 14, 16, 64)
    NB = cfg.bricks_per_level
    rng = np.random.default_rng(6)
    tab = rng.normal(0, 0.3, (3 * NB, 256)).astype(np.float32)
    x = rng.uniform(0, 1, (500, 3)).astype(np.float32)
    cot = rng.normal(size=(500, 24)).astype(np.float32)

    def port(gp):
        t = torch.tensor(tab, requires_grad=True)
        out = thg.hash_encode(t, torch.tensor(x), cfg, grad_phase=gp)
        (g,) = torch.autograd.grad(out, t, torch.tensor(cot))
        return g.numpy()

    got, full = port(phase), port(None)
    _, pull = jax.vjp(lambda t: jhg.hash_encode(
        t, jnp.asarray(x), jhg.HashGridConfig(3, 8, 14, 16, 64),
        grad_phase=jnp.asarray(phase, jnp.int32)), jnp.asarray(tab.T))
    want = np.asarray(pull(jnp.asarray(cot))[0]).T
    on = 1 + phase % 2
    off = 3 - on
    for lvl in (0, on):
        rows = slice(lvl * NB, (lvl + 1) * NB)
        np.testing.assert_array_equal(got[rows], full[rows])
        assert np.abs(got[rows]).max() > 0
        assert rel_l2(got[rows], want[rows]) < 1e-2
    rows = slice(off * NB, (off + 1) * NB)
    assert not got[rows].any() and not want[rows].any()


def test_params_after_three_steps_match_jax(trained):
    name, t = trained
    want = tn.from_jax_params(to_numpy_tree(t["jstate"].params))
    close = total = 0
    for leaf, p in t["tstate"].params.items():
        got = p.detach().float().numpy()
        w = want[leaf].float().numpy()
        tol = LR / 10
        if p.dtype == torch.bfloat16:  # plus one ulp at the value
            tol = tol + np.abs(w) * 2.0**-7
        diff = np.abs(got - w)
        share = 0.4 if leaf.startswith(NORMAL_LEAVES) else 0.8
        assert np.mean(diff <= tol) >= share, leaf
        assert np.mean(diff <= 2.5 * LR + tol) >= 0.99, leaf
        close += int(np.sum(diff <= tol))
        total += diff.size
    assert close / total >= 0.97
    assert t["tstate"].step == int(t["jstate"].step) == 3
    moved = [leaf for leaf in t["tstate"].params
             if leaf.startswith("proposal_fields") and not torch.equal(
                 t["tstate"].params[leaf].detach(),
                 tn.from_jax_params(t["params0"])[leaf])]
    # trained proposals (interlevel, or the MLP's distillation) move
    assert bool(moved) == (name != "phased"), name


def test_proposal_fields_from_jax_match_jax():
    """``from_jax_params`` for both new proposal fields: the hash
    proposal's density, the MLP proposal's density, logit and unit-cube
    logit, at world positions inside and beyond the contraction's unit
    ball."""
    rng = np.random.default_rng(3)
    pos = rng.normal(0, 1.5, (64, 5, 3)).astype(np.float32)
    unit = rng.uniform(0, 1, (64, 3)).astype(np.float32)
    grid = jf.HashGridConfig(5, 2, 17, 16, 128)
    jp = jf.ProposalDensityField(grid=grid, hidden=16)
    params = to_numpy_tree(jp.init(jax.random.PRNGKey(1), jnp.asarray(pos)))
    params["params"]["tables"] = rng.normal(
        0, 1.0, params["params"]["tables"].shape).astype(np.float32)
    tp = tf.ProposalDensityField(grid=tn.HashGridConfig(5, 2, 17, 16, 128),
                                 hidden=16)
    tp.load_state_dict(tf.from_jax_params(params["params"]))
    want = jax.jit(jp.apply)(params, jnp.asarray(pos))
    with torch.no_grad():
        got = tp(torch.tensor(pos))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL)
    assert np.std(np.asarray(want)) > 0.05 * np.mean(np.asarray(want))

    jm = jf.MLPProposalField(n_freqs=4)
    mp = to_numpy_tree(jm.init(jax.random.PRNGKey(2), jnp.asarray(pos)))
    tm = tf.MLPProposalField(n_freqs=4)
    tm.load_state_dict(tf.from_jax_params(mp["params"]))
    with torch.no_grad():
        for method, x in ((None, pos), ("logit", pos), ("logit_unit", unit)):
            want = jax.jit(lambda p, v: jm.apply(p, v, method=method))(
                mp, jnp.asarray(x))
            got = (tm if method is None else getattr(tm, method))(
                torch.tensor(x))
            np.testing.assert_allclose(got.numpy(), want, rtol=RTOL,
                                       atol=RTOL * np.abs(want).max(),
                                       err_msg=str(method))


def test_bf16_dense_grid_forward():
    """A bf16 dense grid reads exactly what the f32 grid reads on the
    rounded table (bitwise), and agrees with JAX's bf16 grid."""
    rng = np.random.default_rng(4)
    pos = rng.normal(0, 1.5, (64, 7, 3)).astype(np.float32)
    t32 = tf.DenseProposalField(resolution=24)
    t16 = tf.DenseProposalField(resolution=24, table_dtype="bfloat16")
    assert t16.tables.dtype == torch.bfloat16
    with torch.no_grad():
        t16.tables.copy_(torch.tensor(rng.normal(
            1, 1, tuple(t16.tables.shape)), dtype=torch.float32))
        t32.tables.copy_(t16.tables.float())
        got16, got32 = t16(torch.tensor(pos)), t32(torch.tensor(pos))
    assert torch.equal(got16, got32)
    jd = jf.DenseProposalField(resolution=24, table_dtype="bfloat16")
    jt = jnp.asarray(t16.tables.float().numpy().T).astype(jnp.bfloat16)
    want = jax.jit(jd.apply)({"params": {"tables": jt}}, jnp.asarray(pos))
    np.testing.assert_allclose(got16.numpy(), want, rtol=1e-6)


def test_bf16_refresh_rounds_to_nearest_even():
    """The slab refresh writes a bf16 grid's rows as the f32 rows rounded
    to nearest even."""
    cfg = tn.NerfactoConfig(**CFG, proposal_table_dtype="bfloat16",
                            proposal_refresh_bricks=256)
    torch.manual_seed(0)
    model = tn.NerfactoModel(cfg)
    b0, rows = model._proposal_slab(model.proposal_fields[0], 0)
    model.refresh_proposals(0)
    got = model.proposal_fields[0].tables[b0:b0 + rows.shape[0]]
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, rows.to(torch.bfloat16))


def test_bf16_interlevel_adam_keeps_bf16():
    """Dense + interlevel + bf16: the tables get bf16 gradients and bf16
    Adam moments (optax keeps a parameter's dtype), and move."""
    t = _train_both(VARIANTS["dense_interlevel_bf16"], steps=1, grads=False)
    st = t["tstate"]
    for i in range(2):
        p = st.params[f"proposal_fields.{i}.tables"]
        assert p.dtype == torch.bfloat16
        moments = st.opt.state[p]
        assert moments["exp_avg"].dtype == moments["exp_avg_sq"].dtype \
            == torch.bfloat16
        assert not torch.equal(
            p.detach(), tn.from_jax_params(t["params0"])[
                f"proposal_fields.{i}.tables"])


def test_prefetch_trains_on_the_previous_steps_picks(monkeypatch):
    """Under prefetch, step t trains on the picks drawn at step t-1 (the
    first call's on its fill picks), and three steps match the JAX
    trainer's prefetch mode."""
    seen = []
    loss = tn.NerfactoModel.loss

    def spy(self, batch, *a, **kw):
        seen.append(batch["camera_indices"].clone())
        return loss(self, batch, *a, **kw)

    monkeypatch.setattr(tn.NerfactoModel, "loss", spy)
    t = _train_both({}, prefetch=True, grads=False)
    d = t["draws"]
    assert torch.equal(seen[0], d[0]["fill"]["frame"])
    for s in (1, 2):
        assert torch.equal(seen[s], d[s - 1]["frame"])
    assert torch.equal(t["tstate"].prefetch["frame"], d[2]["frame"])
    _check_losses(t["jm"], t["tm"])


def _stage_args(**over):
    return SimpleNamespace(
        num_keyframes=K, frame_height=H, frame_width=W, mapping_iterations=6,
        rays_per_batch=RAYS, enhancement_module="depth",
        mapping_module="nerfstudio", mapping_model_overrides=dict(
            log2_hashmap_size=14, max_res=64, proposal_resolutions=[16, 24],
            num_proposal_samples=[16, 8], num_nerf_samples=8, **over))


HASH = VARIANTS["hash_interlevel_samples"]


def test_mapping_stage_with_overrides_matches_jax():
    """``MappingStage`` built from ``mapping_model_overrides`` selecting
    nerfstudio's mapper: the same packets into both stages, every step's
    losses (the normal regularizers drift as in
    ``tests/test_torch_mapping.py``: relative 0.2; from the stage's own
    +-1e-4 init the interlevel loss is ~1e-7 and is held to 1e-6
    absolute)."""
    args = _stage_args(**HASH)
    jst = jstages.MappingStage(args)
    tst = tstages.MappingStage(
        args, state_dict=tn.from_jax_params(to_numpy_tree(jst.state.params)),
        device="cpu")
    assert tst.model.config.proposal_type == "hash"
    key = jax.random.PRNGKey(7)
    for n, seed in ((2, 0), (3, 1)):
        pkt = _enhanced(n, seed)
        jst.update(pkt)
        tst.update({k: torch.tensor(v) for k, v in pkt.items()})
    jst.stream_active = tst.stream_active = False
    while jst.can_train():
        key, sub = jax.random.split(key)
        d = step_draws(sub, jst.num_inserted, H, W, RAYS, (16, 8), 8)
        mj, mt = jst.train_step(), tst.train_step(d)
        assert sorted(mj) == sorted(mt) and "interlevel_loss" in mt
        for k in mj:
            np.testing.assert_allclose(
                float(mt[k]), float(mj[k]), err_msg=k,
                rtol=0.2 if k in NORMAL_TERMS else RTOL,
                atol=1e-6 if k == "interlevel_loss" else 0)
    assert not tst.can_train()
    assert tst.step_count == jst.step_count == args.mapping_iterations


def test_snapshot_round_trip_with_hash_proposals(tmp_path):
    """A train-state snapshot of a stage with hash proposals restores every
    model tensor (the proposals' tables and MLPs) and their Adam state into
    a fresh stage, which then takes the same next step."""
    args = _stage_args(**HASH)
    a = tstages.MappingStage(args, device="cpu")
    a.update({k: torch.tensor(v) for k, v in _enhanced(3, 0).items()})
    a.stream_active = False
    draws = [a.trainer.draws(a.buffer, a.state) for _ in range(3)]
    for d in draws[:2]:
        a.train_step(d)
    a.save_snapshot(str(tmp_path))
    b = tstages.MappingStage(args, device="cpu")
    b.update({k: torch.tensor(v) for k, v in _enhanced(3, 0).items()})
    b.stream_active = False
    b.restore_snapshot(str(tmp_path / "snapshots" / "trainstate000002.pt"))
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert any(k.startswith("proposal_fields.1.mlp") for k in sa)
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    pa = a.state.params["proposal_fields.0.tables"]
    pb = b.state.params["proposal_fields.0.tables"]
    assert torch.equal(a.state.opt.state[pa]["exp_avg"],
                       b.state.opt.state[pb]["exp_avg"])
    ma, mb = a.train_step(draws[2]), b.train_step(draws[2])
    for k in ma:
        assert torch.equal(ma[k], mb[k]), k


@pytest.fixture
def f32_pyramid(monkeypatch):
    """Both dense_corr modules re-read NERF_VO_CORR_PYRAMID_DTYPE=float32;
    afterwards they are read again without it."""
    from nerf_vo_tpu.ops import dense_corr as jdc
    from nerf_vo_tpu_torch.ops import dense_corr as tdc

    monkeypatch.setenv("NERF_VO_CORR_PYRAMID_DTYPE", "float32")
    yield importlib.reload(jdc), importlib.reload(tdc)
    monkeypatch.delenv("NERF_VO_CORR_PYRAMID_DTYPE")
    importlib.reload(jdc)
    importlib.reload(tdc)


def test_f32_pyramid_lookup_matches_jax(f32_pyramid):
    jdc, tdc = f32_pyramid
    rng = np.random.default_rng(5)
    E, h, w, C = 3, 12, 16, 32
    fi = rng.normal(size=(E, h, w, C)).astype(np.float32)
    fj = rng.normal(size=(E, h, w, C)).astype(np.float32)
    coords = (rng.uniform(-2, 1, (E, h, w, 2))
              + np.stack(np.meshgrid(np.arange(w), np.arange(h)), -1)
              ).astype(np.float32)
    jp = jax.jit(jdc.build_corr_pyramid)(jnp.asarray(fi), jnp.asarray(fj))
    tp = tdc.build_corr_pyramid(torch.tensor(fi), torch.tensor(fj))
    for a, b in zip(tp, jp):
        assert a.dtype == torch.float32 and b.dtype == jnp.float32
        np.testing.assert_allclose(a.numpy(), b, atol=1e-5)
    want = jax.jit(jdc.corr_lookup)(jp, jnp.asarray(coords))
    got = tdc.corr_lookup(tp, torch.tensor(coords))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_pyramid_dtype_rejects_other_values(monkeypatch):
    from nerf_vo_tpu_torch.ops import dense_corr as tdc

    monkeypatch.setenv("NERF_VO_CORR_PYRAMID_DTYPE", "float16")
    with pytest.raises(ValueError, match="NERF_VO_CORR_PYRAMID_DTYPE"):
        importlib.reload(tdc)
    monkeypatch.delenv("NERF_VO_CORR_PYRAMID_DTYPE")
    assert importlib.reload(tdc).PYRAMID_DTYPE == torch.bfloat16


def test_mlp_proposals_need_distill():
    """As the JAX model asserts: MLP proposals have no interlevel path."""
    cfg = tn.NerfactoConfig(**CFG, proposal_type="mlp",
                            proposal_training="interlevel")
    with pytest.raises(ValueError, match="distill"):
        tn.NerfactoModel(cfg)
    with pytest.raises(AssertionError):
        jn.NerfactoModel(jn.NerfactoConfig(**CFG, proposal_type="mlp",
                                           proposal_training="interlevel"))
