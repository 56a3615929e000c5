"""The port's nerfacto fields and model (``nerf_vo_tpu_torch/models/``)
against ``nerf_vo_tpu/models/{nerf_field,nerfacto}.py``.

Parameters: one JAX init, its tables redrawn wider than the ±1e-4 init (so
that the features, the proposal densities and the samples they place are
not all alike), carried to the port by ``nerfacto.from_jax_params``. Draws:
the uniforms JAX's render key gives (``tests/torch_parity.py``).

The geometry is the mapper's, cut to size: field grid 3 levels x 8 features
at log2 table 14 (level 0, 512 bricks, on the one-hot route; levels 1-2
hashed), proposals at resolutions 16 (one-hot route, F=1) and 24 (gathered,
F=1) with (16, 8) samples, 8 nerf samples, 64 rays.

Tolerances, from the measured spread: the MLPs run in bf16 on both sides
(JAX jitted on XLA:CPU, the port through torch's CPU kernels), which round
some products and sums differently, one bf16 ulp (2^-8 relative) at a time:
- render outputs, fields and loss terms: relative 1e-2 (loss terms
  measured <= 1.6e-4);
- per-leaf gradients: relative L2 < 5e-2 (measured <= 2.3e-3 for weights
  and tables, <= 2.3e-2 for biases, whose gradient sums the bf16-rounded
  cotangents of every sample; JAX also accumulates the table gradient in
  bf16);
- the position gradient (rays' origins and directions): relative L2 < 1e-2
  (measured 1.8e-4).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_vo_tpu.models import nerfacto as jn
from nerf_vo_tpu_torch.models import nerfacto as tn
from torch_parity import render_uniforms, rel_l2, to_numpy_tree

CFG = dict(near=0.05, far=20.0, num_images=8, log2_hashmap_size=14,
           max_res=64, proposal_resolutions=(16, 24),
           num_proposal_samples=(16, 8), num_nerf_samples=8,
           aabb_min=-4.0, aabb_max=4.0, proposal_refresh_bricks=256)
R = 64
RTOL = 1e-2
GRAD_RTOL = 5e-2


def _params():
    params = to_numpy_tree(jax.jit(
        jn.NerfactoModel(jn.NerfactoConfig(**CFG)).init)(
        jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    t = params["field"]["tables"]
    params["field"]["tables"] = rng.normal(0, 0.3, t.shape).astype(t.dtype)
    for k in ("proposal_0", "proposal_1"):
        t = params[k]["tables"]
        params[k]["tables"] = (rng.normal(0, 1.0, t.shape) + 1.0).astype(
            t.dtype)
    return params


def _batch():
    rng = np.random.default_rng(1)
    d = rng.normal(size=(R, 3)) + [0, 0, -2.0]
    n = rng.normal(size=(R, 3))
    return {
        "origins": rng.normal(0, 0.2, (R, 3)).astype(np.float32),
        "directions": (d / np.linalg.norm(d, axis=-1, keepdims=True)
                       ).astype(np.float32),
        "rgb": rng.uniform(0, 1, (R, 3)).astype(np.float32),
        "camera_indices": rng.integers(0, 8, R).astype(np.int32),
        "depth": rng.uniform(0.5, 4, R).astype(np.float32),
        "depth_mask": rng.uniform(size=R) < 0.9,
        "normal": (n / np.linalg.norm(n, axis=-1, keepdims=True)
                   ).astype(np.float32),
        "normal_mask": rng.uniform(size=R) < 0.9,
    }


@pytest.fixture(scope="module")
def setup():
    jcfg = jn.NerfactoConfig(**CFG, normal_loss_mult=5e-6)
    tcfg = tn.NerfactoConfig(**CFG, normal_loss_mult=5e-6)
    jmodel = jn.NerfactoModel(jcfg)
    params = _params()
    tmodel = tn.NerfactoModel(tcfg)
    tmodel.load_state_dict(tn.from_jax_params(params))
    return dict(jmodel=jmodel, tmodel=tmodel, params=params)


def _tb(batch, grad=False):
    out = {k: torch.tensor(v) for k, v in batch.items()}
    if grad:
        out["origins"].requires_grad_(True)
        out["directions"].requires_grad_(True)
    return out


def test_fields_match_jax(setup):
    jmodel, tmodel, params = setup["jmodel"], setup["tmodel"], setup["params"]
    rng = np.random.default_rng(2)
    pos = rng.normal(0, 1.5, (R, 5, 3)).astype(np.float32)
    dirs = rng.normal(size=(R, 5, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    cam = rng.integers(0, 8, R).astype(np.int32)
    fp = {"params": params["field"]}
    f = jmodel.field
    dj, gj = f.apply(fp, jnp.asarray(pos), method=f.density)
    dt, gt = tmodel.field.density(torch.tensor(pos))
    np.testing.assert_allclose(dt.detach().numpy(), dj, rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(gt.detach().numpy(), gj, rtol=0,
                               atol=RTOL * np.abs(gj).max())
    rgb_j = f.apply(fp, gj, jnp.asarray(dirs), jnp.asarray(cam),
                    method=f.rgb)
    rgb_t = tmodel.field.rgb(torch.tensor(np.asarray(gj)),
                             torch.tensor(dirs), torch.tensor(cam))
    np.testing.assert_allclose(rgb_t.detach().numpy(), rgb_j, atol=RTOL)
    n_j = f.apply(fp, gj, method=f.normals)
    n_t = tmodel.field.normals(torch.tensor(np.asarray(gj)))
    np.testing.assert_allclose(n_t.detach().numpy(), n_j, atol=RTOL)
    for i, pf in enumerate(jmodel.proposal_fields):
        pj = pf.apply({"params": params[f"proposal_{i}"]}, jnp.asarray(pos))
        pt = tmodel.proposal_fields[i](torch.tensor(pos))
        # no MLP: only the bf16 table shadow, the same on both sides
        np.testing.assert_allclose(pt.numpy(), pj, rtol=1e-5)


def test_render_matches_jax(setup):
    jmodel, tmodel, params = setup["jmodel"], setup["tmodel"], setup["params"]
    b = _batch()
    for key in (None, jax.random.PRNGKey(3)):
        want = jax.jit(jmodel.render, static_argnames="train")(
            params, jnp.asarray(b["origins"]), jnp.asarray(b["directions"]),
            jnp.asarray(b["camera_indices"]), key=key, train=key is not None)
        u = None if key is None else render_uniforms(
            key, R, CFG["num_proposal_samples"], CFG["num_nerf_samples"])
        with torch.no_grad():
            got = tmodel.render(torch.tensor(b["origins"]),
                                torch.tensor(b["directions"]),
                                torch.tensor(b["camera_indices"]), u)
        for k in ("s_edges_list", "weights_list"):
            for g, w in zip(got[k], want[k]):
                np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                           atol=RTOL * np.abs(w).max())
        for k in ("rgb", "depth", "accumulation", "normals"):
            np.testing.assert_allclose(got[k].numpy(), want[k], rtol=RTOL,
                                       atol=RTOL * np.abs(want[k]).max())


def test_loss_and_grads_match_jax(setup):
    jmodel, tmodel, params = setup["jmodel"], setup["tmodel"], setup["params"]
    b = _batch()
    key = jax.random.PRNGKey(4)

    def loss_fn(p, o, d):
        batch = {k: jnp.asarray(v) for k, v in b.items()}
        batch["origins"], batch["directions"] = o, d
        return jmodel.loss(p, batch, key)

    (lj, mj), (gp, go, gd) = jax.jit(jax.value_and_grad(
        loss_fn, argnums=(0, 1, 2), has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, params),
        jnp.asarray(b["origins"]), jnp.asarray(b["directions"]))

    tb = _tb(b, grad=True)
    u = render_uniforms(key, R, CFG["num_proposal_samples"],
                        CFG["num_nerf_samples"])
    lt, mt = tmodel.loss(tb, u)
    named = dict(tmodel.named_parameters())
    train = {k: p for k, p in named.items() if p.requires_grad}
    assert not any(k.startswith("proposal_fields") for k in train)
    grads = torch.autograd.grad(lt, list(train.values())
                                + [tb["origins"], tb["directions"]])

    assert sorted(mt) == sorted(mj)
    for k in mj:
        np.testing.assert_allclose(float(mt[k]), float(mj[k]), rtol=RTOL,
                                   err_msg=k)
    want = tn.from_jax_params(to_numpy_tree(gp))
    for (k, _), g in zip(train.items(), grads):
        assert rel_l2(g.numpy(), want[k].numpy()) < GRAD_RTOL, k
    assert rel_l2(grads[-2].numpy(), go) < RTOL
    assert rel_l2(grads[-1].numpy(), gd) < RTOL


@pytest.mark.parametrize("step", [0, 16])
def test_refresh_proposals_matches_jax(setup, step):
    """One rotating slab per proposal grid (resolution 16: 512 bricks in
    slabs of 256, so step 16 rewrites the second slab)."""
    jmodel, params = setup["jmodel"], setup["params"]
    tmodel = tn.NerfactoModel(tn.NerfactoConfig(**CFG))
    tmodel.load_state_dict(tn.from_jax_params(params))
    fp = {"params": jax.tree_util.tree_map(jnp.asarray, params["field"])}
    want_p = to_numpy_tree(jmodel.refresh_proposals(
        jax.tree_util.tree_map(jnp.asarray, params), step))
    tmodel.refresh_proposals(step)
    for i, pf in enumerate(jmodel.proposal_fields):
        b0, col = jmodel._proposal_slab(fp, pf, step)
        tb0, rows = tmodel._proposal_slab(tmodel.proposal_fields[i], step)
        assert int(b0) == tb0
        col = np.asarray(col)
        np.testing.assert_allclose(rows.numpy().T, col, rtol=0,
                                   atol=RTOL * np.abs(col).max())
        got = tmodel.proposal_fields[i].tables.numpy()
        want = want_p[f"proposal_{i}"]["tables"].T
        assert b0 > 0 or step == 0 or i == 1
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=RTOL * np.abs(want).max())


def test_unported_paths_raise():
    """An unknown sampler is not ported; the model-axis tables need the
    mesh they are sharded over (``NerfactoModel(config, mesh=)``), and
    descriptor sharding needs a model axis."""
    cfg = dataclasses.replace(tn.NerfactoConfig(**CFG), sampler="uniform")
    with pytest.raises(NotImplementedError, match="sampler"):
        tn.NerfactoModel(cfg)
    for field, value in [("model_axis", "m"), ("descriptor_sharding", True)]:
        cfg = dataclasses.replace(tn.NerfactoConfig(**CFG), **{field: value})
        with pytest.raises(ValueError, match=field):
            tn.NerfactoModel(cfg)
