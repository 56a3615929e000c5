"""The port's multi-device paths (``nerf_vo_tpu_torch/parallel/``, the
model-axis routes of ``ops/hash_grid.py``, ``make_sharded_dense_ba``,
``MapRenderer(mesh=)``) against the JAX package's ``shard_map`` versions
and against the port's own one-device and data-parallel paths.

Ranks are CPU processes over gloo, started twice (a world of two, then of
four; ``tests/torch_parallel_ranks.py`` holds their functions, which import
no JAX) while this process computes the JAX side on conftest's 8-device
CPU mesh. Sizes are those of ``tests/test_parallel.py``: 4 keyframes of
12x16, 64 rays a step, the field 3 x 8 at log2 14 (level 0 one-hot, 512
bricks), one proposal grid at resolution 8; two train steps.

Tolerances (measured spread in brackets):
- table-sharded encodes against JAX's: as ``tests/test_torch_hash_grid.py``
  (features 1e-6 of max |out|, table gradient relative L2 < 1e-2 per shard
  (JAX accumulates the hashed levels in bf16), position gradient relative
  L2 < 1e-5) [8e-8, <= 2.5e-3, <= 1e-7];
- train steps against JAX's: as ``tests/test_torch_mapping.py`` (bf16 MLPs
  round differently in the two frameworks, and Adam with eps 1e-15 moves
  an element ~lr whatever its gradient's size): losses relative 1e-2
  (0.2 for the two normal regularizers) [<= 2.6e-2 for them], the
  share of parameter elements within lr / 10 >= 99% overall and >= 80% a
  leaf, >= 99% a leaf within 2.5 lr; pose corrections >= 90% within
  cam_lr / 10, all within 2.5 cam_lr; the NGP mapper: losses 2e-2
  (``tests/test_torch_ngp.py``'s rule) [1.05e-2], the occupancy grid 1e-2
  relative (its refresh rule), >= 95% of all elements within lr / 10
  [96.4%: at this size (the narrow init, 32 rays a data row) the two
  packages' NGP DP(2) steps differ by as much, while each package's DP2 x
  TP2 equals its own DP(2)];
- the port's table-sharded steps against its own data-parallel steps on
  the same rays a rank: JAX's own ``rtol=2e-4, atol=2e-6``
  (``tests/test_parallel.py``): the features are the same sums, only the
  order of the position gradient's and the all-reduces' sums differs;
- the pixel-sharded dense BA against the one-rank solver and against JAX's
  sharded solver: ``tests/test_parallel.py``'s (one iteration: poses rtol
  1e-4 / atol 1e-6, depths 2e-4 / 1e-5, covariances 1e-3 / 1e-5; two: the
  costs 1e-5, poses 1e-3 / 1e-4, mean relative depth error < 1e-3), and
  against JAX's ``tests/test_torch_droid.py``'s for one iteration (poses
  2e-5, depths 1e-4, costs 1e-4 relative, covariances 5e-3 relative) and
  the two-iteration rule above for two (the one-device solvers of the two
  packages differ by as much there: depths 3.1e-3, mean 3.3e-4);
- data-parallel renders against one rank: rtol / atol 2e-5, JAX's
  (``test_dp_render_chunk_matches_single_device``) [bitwise here].
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from nerf_vo_tpu.core import lie as jlie
from nerf_vo_tpu.mapping import keyframe_buffer as jkb
from nerf_vo_tpu.mapping.trainer import MappingTrainer as JTrainer
from nerf_vo_tpu.mapping.trainer import TrainerConfig as JTrainerConfig
from nerf_vo_tpu.models import nerfacto as jn
from nerf_vo_tpu.ops import dense_ba as jba
from nerf_vo_tpu.ops import hash_grid as jhg
from nerf_vo_tpu.ops.occupancy import OccupancyConfig as JOccupancyConfig
from nerf_vo_tpu.parallel import sharding as jsh
from nerf_vo_tpu_torch.models import nerfacto as tn
from nerf_vo_tpu_torch.ops import dense_ba as tba
from nerf_vo_tpu_torch.parallel import dist as pdist
from torch_parity import (occupancy_step_draws, rel_l2, step_draws,
                          to_numpy_tree)

import torch_parallel_ranks as ranks

K, H, W, RAYS = ranks.K, ranks.H, ranks.W, ranks.RAYS
LR, CAM_LR = 1e-2, 1e-4
# the normal regularizers compare the normal MLP's output with the bf16
# density MLP's position gradient: tests/test_torch_mapping.py's rule
NORMAL_TERMS = ("orientation_loss", "pred_normal_loss")
NORMAL_RTOL = 0.2
GRIDS = {  # (JAX grid config, points): level 0 one-hot / every level hashed
    "onehot": dict(n_levels=3, features_per_level=8, log2_table_size=14,
                   base_resolution=16, max_resolution=64),
    "hashed": dict(n_levels=3, features_per_level=8, log2_table_size=8,
                   base_resolution=16, max_resolution=32),
}


def _encode_inputs(grid_kw, seed, n):
    cfg = jhg.HashGridConfig(**grid_kw)
    L, F = cfg.n_levels, cfg.features_per_level
    rng = np.random.default_rng(seed)
    tab = rng.normal(0, 0.5, (32 * F, L * cfg.bricks_per_level)).astype(
        np.float32)
    x = rng.uniform(-0.02, 1.02, (n, 3)).astype(np.float32)
    if seed % 2:  # points crowded into one corner: uneven owner counts
        x[: n // 2] *= 0.2
    cot = rng.normal(size=(n, L * F)).astype(np.float32)
    return cfg, tab, x, cot


def _jax_encode(cfg, tab, x, cot, n_dev, ds):
    """JAX ``hash_encode(model_axis=)`` and its VJP in a shard_map over
    ``n_dev`` devices: the table column-sharded, the points replicated (or
    sharded under descriptor sharding)."""
    mesh = Mesh(np.asarray(jax.devices()[:n_dev]), ("model",))
    pts = P("model") if ds else P()

    def f(t, p, c):
        out, vjp = jax.vjp(lambda a, b: jhg.hash_encode(
            a, b, cfg, model_axis="model", descriptor_sharding=ds), t, p)
        gt, gp = vjp(c)
        return out, gt, gp

    run = jax.jit(jax.shard_map(
        f, mesh=mesh, in_specs=(P(None, "model"), pts, pts),
        out_specs=(pts, P(None, "model"), pts), check_vma=False))
    return [np.asarray(a) for a in run(jnp.asarray(tab), jnp.asarray(x),
                                       jnp.asarray(cot))]


def _jax_buffer():
    pkt = ranks.packet()
    buf = jkb.create(K, H, W)
    return jkb.insert(buf, jnp.arange(K), {k: jnp.asarray(v)
                                           for k, v in pkt.items()})


def _jax_trainer(model_kw, occ=None):
    kw = dict(model_kw)
    if occ:
        kw["occupancy"] = JOccupancyConfig(**occ)
    model = jn.NerfactoModel(jn.NerfactoConfig(**kw))
    return JTrainer(model, JTrainerConfig(rays_per_batch=RAYS,
                                          max_iterations=8), K)


def _dense_ba_problem(seed=42):
    """tests/test_parallel.py's problem (conftest's ``rng``, seed 42): 4
    frames of 8x16, 6 edges; the same recipe at other seeds."""
    rng = np.random.default_rng(seed)
    N, h, w = 4, 8, 16
    poses = jnp.tile(jnp.asarray([0., 0, 0, 0, 0, 0, 1.]), (N, 1))
    poses = jlie.se3_retract(
        poses, jnp.asarray(rng.normal(0, 0.02, (N, 6)), jnp.float32))
    disps = jnp.asarray(rng.uniform(0.3, 1.5, (N, h, w)), jnp.float32)
    intr = jnp.tile(jnp.asarray([12.0, 12.0, w / 2, h / 2]), (N, 1))
    ii = jnp.asarray([0, 1, 2, 3, 1, 2], jnp.int32)
    jj = jnp.asarray([1, 2, 3, 0, 0, 1], jnp.int32)
    coords, _ = jba.dense_reproject(poses, disps, intr, ii, jj)
    tgt = coords + jnp.asarray(rng.normal(0, 0.3, (6, h, w, 2)), jnp.float32)
    wgt = jnp.asarray(rng.uniform(0.2, 1.0, (6, h, w, 2)), jnp.float32)
    problem = dict(poses=poses, disps=disps, intrinsics=intr, ii=ii, jj=jj,
                   targets=tgt, weights=wgt, valid=jnp.ones((6,), bool))
    slots = np.asarray([-1, 0, 1, 2], np.int32)
    eta = rng.uniform(0.0, 0.01, (N, h, w)).astype(np.float32)
    return {k: np.asarray(v) for k, v in problem.items()}, slots, eta


# seeds of the f64 check of the pixel-sharded dense BA
F64_SEEDS = (42, 0, 1, 2, 3, 7, 11, 123)


def _f64(problem, slots, eta):
    """A dense BA problem in float64 (its float arrays cast)."""
    def cast(v):
        return v.astype(np.float64) if v.dtype == np.float32 else v
    return {k: cast(v) for k, v in problem.items()}, slots, cast(eta)


def _dense_ba_one(problem, slots, eta, num_iters):
    """The one-rank dense BA (window 3) in this process."""
    p = tba.DenseBAProblem(**{k: torch.tensor(v) for k, v in
                              problem.items()})
    return [t.numpy() for t in tba.dense_bundle_adjust(
        p, torch.tensor(slots), num_iters=num_iters, window=3,
        eta=torch.tensor(eta))]


def _gather_tables(results, names, model_group):
    """The parameters of the table-sharded ranks ``model_group`` (one data
    row), tables concatenated along their rows."""
    return {n: (np.concatenate([results[r]["params"][n] for r in model_group])
                if n.endswith("tables") else results[model_group[0]]
                ["params"][n]) for n in names}


@pytest.fixture(scope="module")
def run():
    """Start both worlds, compute the JAX side meanwhile, then collect."""
    keys = [jax.random.PRNGKey(100 + i) for i in range(ranks.TRAIN_STEPS)]
    jtr = _jax_trainer(ranks.MODEL)
    jstate0 = jtr.init(jax.random.PRNGKey(0))
    params0 = to_numpy_tree(jstate0.params)
    ngp_tr = _jax_trainer(ranks.NGP, ranks.OCC)
    ngp0 = to_numpy_tree(ngp_tr.init(jax.random.PRNGKey(0)).params)

    def draws(n_ranks, n_rays):
        return [[step_draws(jax.random.fold_in(k, r), K, H, W, n_rays,
                            ranks.MODEL["num_proposal_samples"],
                            ranks.MODEL["num_nerf_samples"]) for k in keys]
                for r in range(n_ranks)]

    slab = ranks.OCC["resolution"] ** 3 // ranks.OCC["slab_div"]

    def ngp_draws(k, row):
        d = occupancy_step_draws(jax.random.fold_in(k, row), K, H, W,
                                 RAYS // 2, (), ranks.NGP["num_occ_bins"],
                                 ranks.NGP["num_nerf_samples"], slab)
        # the refresh key is the step's, alike on every device
        d["occ_jitter"] = torch.tensor(np.asarray(jax.random.uniform(
            jax.random.fold_in(k, 1), (slab, 3))))
        return d

    enc2 = {n: _encode_inputs(kw, 0, 48) for n, kw in GRIDS.items()}
    enc4 = {n: _encode_inputs(kw, 1, 4 * 40) for n, kw in GRIDS.items()}
    dp2 = draws(2, RAYS // 2)
    problem, slots, eta = _dense_ba_problem()
    f64 = [_f64(*_dense_ba_problem(seed)) for seed in F64_SEEDS]
    ngp = [[ngp_draws(k, row) for k in keys] for row in range(2)]
    spec2 = dict(encode={n: (GRIDS[n], t, x, c) for n, (_, t, x, c)
                         in enc2.items()},
                 params0=params0, draws_dp2=dp2, ngp_params0=ngp0,
                 draws_ngp=ngp)
    spec4 = dict(encode_ds={n: (GRIDS[n], t, x, c) for n, (_, t, x, c)
                            in enc4.items()},
                 params0=params0, draws_dp4=draws(4, RAYS // 4),
                 draws_tp=[dp2[r // 2] for r in range(4)],
                 ngp_params0=ngp0,
                 draws_ngp=[ngp[r // 2] for r in range(4)],
                 dense_ba=(problem, slots, eta), dense_ba_f64=f64)
    two = pdist.spawn(ranks.world_two, 2, "cpu", args=(spec2,), wait=False,
                      quiet=True)
    four = pdist.spawn(ranks.world_four, 4, "cpu", args=(spec4,),
                       wait=False, quiet=True)

    j = {"encode": {n: _jax_encode(c, t, x, g, 2, False)
                    for n, (c, t, x, g) in enc2.items()},
         "encode_ds": {n: _jax_encode(c, t, x, g, 4, True)
                       for n, (c, t, x, g) in enc4.items()}}
    buf = _jax_buffer()
    mesh4 = jsh.make_mesh(4)
    mesh22 = jsh.make_mesh_2d(2, 2)

    def steps(step, state, mesh):
        b = jsh.replicate(buf, mesh)
        for k in keys:
            state, m = step(state, b, k)
        return dict(params=tn.from_jax_params(to_numpy_tree(state.params)),
                    pose=np.asarray(state.pose_deltas),
                    metrics={k: float(v) for k, v in m.items()},
                    occ=(np.asarray(state.occ_grid)
                         if state.occ_grid is not None else None))

    j["dp4"] = steps(jsh.make_dp_train_step(jtr, mesh4),
                     jsh.replicate(jtr.init(jax.random.PRNGKey(0)), mesh4),
                     mesh4)
    for mode, ds in (("tp", False), ("ds", True)):
        j[mode] = steps(
            jsh.make_dp_tp_train_step(jtr, mesh22, descriptor_sharding=ds),
            jsh.shard_state_tp(jtr.init(jax.random.PRNGKey(0)), mesh22),
            mesh22)
    j["ngp"] = steps(
        jsh.make_dp_tp_train_step(ngp_tr, mesh22),
        jsh.shard_state_tp(ngp_tr.init(jax.random.PRNGKey(0)), mesh22),
        mesh22)
    m2 = jsh.make_mesh(2)
    j["ngp_dp2"] = steps(
        jsh.make_dp_train_step(ngp_tr, m2),
        jsh.replicate(ngp_tr.init(jax.random.PRNGKey(0)), m2), m2)
    j["ngp_grid0"] = np.asarray(ngp_tr.init(jax.random.PRNGKey(0)).occ_grid)
    jp = jba.DenseBAProblem(**{k: jnp.asarray(v) for k, v in
                               problem.items()})
    j["dense_ba"] = {n: [np.asarray(a) for a in jba.make_sharded_dense_ba(
        mesh4, num_iters=n, window=3)(jp, jnp.asarray(slots),
                                      eta=jnp.asarray(eta))] for n in (1, 2)}
    one = {n: _dense_ba_one(problem, slots, eta, n) for n in (1, 2)}
    one_f64 = [_dense_ba_one(*args, 2) for args in f64]
    return dict(two=two.join(), four=four.join(), jax=j, dense_ba_one=one,
                dense_ba_one_f64=one_f64, enc2=enc2, enc4=enc4)


# ---------------------------------------------------------------------------
# table-sharded encodes
# ---------------------------------------------------------------------------

def _check_encode(cfg, got_f, got_gt, got_gx, want):
    wf, wgt, wgx = want
    np.testing.assert_allclose(got_f, wf, rtol=0,
                               atol=1e-6 * np.abs(wf).max())
    wgt = wgt.T  # brick-major
    rows = wgt.shape[0] // len(got_gt)
    for r, g in enumerate(got_gt):
        assert rel_l2(g, wgt[r * rows:(r + 1) * rows]) < 1e-2, r
    assert rel_l2(got_gx, wgx) < 1e-5


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_table_sharded_encode_matches_jax(run, grid):
    """2 shards, every rank the same points: masked local gather + one
    all-reduce of the features; the one-hot slab (``onehot``)."""
    res = run["two"]
    for r in res:  # every rank holds the whole features and point grads
        np.testing.assert_array_equal(r["encode"][grid][0],
                                      res[0]["encode"][grid][0])
        np.testing.assert_array_equal(r["encode"][grid][2],
                                      res[0]["encode"][grid][2])
    cfg = run["enc2"][grid][0]
    _check_encode(cfg, res[0]["encode"][grid][0],
                  [r["encode"][grid][1] for r in res],
                  res[0]["encode"][grid][2], run["jax"]["encode"][grid])


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_descriptor_routed_encode_matches_jax(run, grid):
    """4 shards, each rank its own points (half of them crowded into a
    corner): lookups routed to the owners with exact splits; with the
    one-hot level, shard 0 holds only slab rows and is sent nothing."""
    res = run["four"]
    cfg = run["enc4"][grid][0]
    cat = lambda i: np.concatenate([r["encode_ds"][grid][i] for r in res])
    _check_encode(cfg, cat(0), [r["encode_ds"][grid][1] for r in res],
                  cat(2), run["jax"]["encode_ds"][grid])


# ---------------------------------------------------------------------------
# train steps
# ---------------------------------------------------------------------------

def _check_against_jax(got, want, ngp=False):
    """tests/test_torch_mapping.py's rule; ``ngp``: tests/test_torch_ngp.py's
    (losses 2e-2, the share of all elements within lr / 10 only)."""
    for k in want["metrics"]:
        np.testing.assert_allclose(
            got["metrics"][k], want["metrics"][k],
            rtol=NORMAL_RTOL if k in NORMAL_TERMS else 2e-2 if ngp else 1e-2,
            err_msg=k)
    close = total = 0
    for name, w in want["params"].items():
        diff = np.abs(got["params"][name] - w.numpy())
        if not ngp:
            assert np.mean(diff <= LR / 10) >= 0.8, name
            assert np.mean(diff <= 2.5 * LR) >= 0.99, name
        close += int(np.sum(diff <= LR / 10))
        total += diff.size
    assert close / total >= (0.95 if ngp else 0.99)
    if ngp:
        return
    dp = np.abs(got["pose"] - want["pose"])
    assert np.mean(dp <= CAM_LR / 10) >= 0.9
    assert dp.max() <= 2.5 * CAM_LR


GRAD_ATOL = 2e-6  # of the leaf's max |gradient|


def _check_tight(got, want):
    for name, w in want["params"].items():
        np.testing.assert_allclose(got["params"][name], w, rtol=2e-4,
                                   atol=2e-6, err_msg=name)
    np.testing.assert_allclose(got["pose"], want["pose"], rtol=2e-4,
                               atol=2e-6)


def _tp_rows(run, mode):
    """Data row 0's parameters of a 2 x 2 run, tables gathered."""
    res = [r[mode] for r in run["four"]]
    return dict(res[0], params=_gather_tables(res, res[0]["params"], (0, 1)))


def test_dp_train_step_matches_jax(run):
    """DP(4): each rank 16 rays from fold_in(key, rank), as JAX's."""
    res = [r["dp4"] for r in run["four"]]
    for r in res[1:]:  # replicated: every rank holds the same state
        for n, v in r["params"].items():
            np.testing.assert_array_equal(v, res[0]["params"][n])
    assert res[0]["step"] == ranks.TRAIN_STEPS
    assert not res[0]["pose"][0].any() and np.abs(res[0]["pose"]).max() > 0
    _check_against_jax(res[0], run["jax"]["dp4"])


@pytest.mark.parametrize("mode", ["tp", "ds"])
def test_table_sharded_step_matches_jax(run, mode):
    """DP2 x TP2 (a data row's two ranks on the same 32 rays) and
    descriptor-sharded 2 x 2 (each rank 16 rays of its own), from one
    init with JAX's draws a device."""
    _check_against_jax(_tp_rows(run, mode), run["jax"][mode])


@pytest.mark.parametrize("mode", ["tp", "ds"])
def test_table_sharded_step_matches_port_dp(run, mode):
    """The same rays a rank as the port's DP(2) (``tp``) or DP(4) (``ds``):
    the same computation, the tables sharded."""
    want = run["two"][0]["dp2"] if mode == "tp" else run["four"][0]["dp4"]
    got = _tp_rows(run, mode)
    _check_tight(got, want)
    # both data rows hold the same replicated leaves and tables
    row1 = _gather_tables([r[mode] for r in run["four"]],
                          got["params"], (2, 3))
    for n, v in row1.items():
        np.testing.assert_array_equal(v, got["params"][n], err_msg=n)


@pytest.mark.parametrize("mode", ["tp", "ds", "ngp"])
def test_table_sharded_step_averages_gradients_as_dp(run, mode):
    """The first step's gradients as the update is given them (tables
    averaged over the data axis, times 1 / n_model under descriptor
    sharding; every other leaf over both axes), tables gathered, equal the
    port's DP gradients on the same rays in both data rows. The parameters
    cannot show a wrong factor: Adam (eps 1e-15) moves an element by ~lr
    whatever its gradient's scale."""
    dp = {"tp": run["two"][0]["dp2"], "ds": run["four"][0]["dp4"],
          "ngp": run["two"][0]["ngp_dp2"]}[mode]["grads"]
    res = [r[mode] for r in run["four"]]
    for row in ((0, 1), (2, 3)):
        got = {n: (np.concatenate([res[r]["grads"][n] for r in row])
                   if n.endswith("tables") else res[row[0]]["grads"][n])
               for n in dp}
        for n, w in dp.items():
            assert np.abs(w).max() > 0, n
            np.testing.assert_allclose(
                got[n], w, rtol=2e-4, atol=GRAD_ATOL * np.abs(w).max(),
                err_msg=f"{mode} {n}")


def test_steps_draw_by_ray_group(run):
    """A step given no draws: a rank's rays come from its ray group's
    generator (a model group draws alike under DP2 x TP2, every rank its
    own under descriptor sharding), the occupancy refresh's jitter is alike
    on every rank, and the ranks stay in lockstep."""
    tp = [r["own_draws"]["tp"] for r in run["four"]]
    ds = [r["own_draws"]["ds"] for r in run["four"]]

    def same(a, b):
        return all(np.array_equal(a["draws"][k], b["draws"][k])
                   for k in ("frame", "py", "px")) and all(
            np.array_equal(u, v) for u, v in zip(a["draws"]["uniforms"],
                                                 b["draws"]["uniforms"]))

    assert same(tp[0], tp[1]) and same(tp[2], tp[3])
    assert not same(tp[0], tp[2])
    assert not any(same(ds[a], ds[b]) for a in range(4) for b in range(a))
    assert tp[0]["draws"]["occ_jitter"].shape[0] > 0
    for r in tp[1:]:
        np.testing.assert_array_equal(r["draws"]["occ_jitter"],
                                      tp[0]["draws"]["occ_jitter"])
        np.testing.assert_array_equal(r["occ"], tp[0]["occ"])
    for res in (tp, ds):
        assert res[0]["step"] == ranks.TRAIN_STEPS
        for r in res[1:]:
            for n, v in r["params"].items():
                if not n.endswith("tables"):
                    np.testing.assert_array_equal(v, res[0]["params"][n])
            np.testing.assert_array_equal(r["pose"], res[0]["pose"])


def test_replicated_leaves_equal_on_every_rank(run):
    for mode in ("tp", "ds", "ngp"):
        res = [r[mode] for r in run["four"]]
        for r in res[1:]:
            for n, v in r["params"].items():
                if not n.endswith("tables"):
                    np.testing.assert_array_equal(
                        v, res[0]["params"][n], err_msg=f"{mode} {n}")
            np.testing.assert_array_equal(r["pose"], res[0]["pose"])


def test_table_sharded_occupancy_refresh(run):
    """The Instant-NGP mapper under DP2 x TP2: the occupancy grid refreshes
    through the sharded field at step 0 (update_every 2), alike on every
    rank, as JAX's does; the steps equal the port's NGP DP(2) on the same
    rays."""
    res = [r["ngp"] for r in run["four"]]
    want = run["jax"]["ngp"]
    for r in res[1:]:
        np.testing.assert_array_equal(r["occ"], res[0]["occ"])
    assert not np.allclose(res[0]["occ"], run["jax"]["ngp_grid0"])
    np.testing.assert_allclose(res[0]["occ"], want["occ"], rtol=1e-2,
                               atol=1e-6)
    got = dict(res[0], params=_gather_tables(res, res[0]["params"], (0, 1)))
    _check_tight(got, run["two"][0]["ngp_dp2"])
    np.testing.assert_array_equal(got["occ"], run["two"][0]["ngp_dp2"]["occ"])
    _check_against_jax(got, want, ngp=True)


# ---------------------------------------------------------------------------
# dense BA, renders, meshes, the launcher
# ---------------------------------------------------------------------------

def test_sharded_dense_ba_matches_one_rank_and_jax(run):
    for r in run["four"][1:]:  # every rank returns the whole solution
        for a, b in zip(r["dense_ba"][2], run["four"][0]["dense_ba"][2]):
            np.testing.assert_array_equal(a, b)
    p1, d1, c1, cov1 = run["four"][0]["dense_ba"][1]
    p0, d0, c0, cov0 = run["dense_ba_one"][1]
    np.testing.assert_allclose(p1, p0, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(d1, d0, rtol=2e-4, atol=1e-5)
    np.testing.assert_allclose(cov1, cov0, rtol=1e-3, atol=1e-5)
    p2, d2, c2, _ = run["four"][0]["dense_ba"][2]
    p3, d3, c3, _ = run["dense_ba_one"][2]
    np.testing.assert_allclose(c2, c3, rtol=1e-5)
    np.testing.assert_allclose(p2, p3, rtol=1e-3, atol=1e-4)
    assert np.mean(np.abs(d2 - d3) / np.abs(d3)) < 1e-3
    # against JAX's sharded solver: one iteration as tests/test_torch_droid.py
    # holds the one-device solvers, two by the global rule above (the
    # cutoffs flip for other pixels in the two frameworks, as they do
    # between their one-device solvers)
    jp, jd, jc, jcov = run["jax"]["dense_ba"][1]
    np.testing.assert_allclose(p1, jp, rtol=0, atol=2e-5)
    np.testing.assert_allclose(d1, jd, rtol=0, atol=1e-4)
    np.testing.assert_allclose(c1, jc, rtol=1e-4)
    np.testing.assert_allclose(cov1, jcov, rtol=5e-3)
    jp, jd, jc, _ = run["jax"]["dense_ba"][2]
    np.testing.assert_allclose(c2, jc, rtol=1e-5)
    np.testing.assert_allclose(p2, jp, rtol=1e-3, atol=1e-4)
    assert np.mean(np.abs(d2 - jd) / np.abs(jd)) < 1e-3


@pytest.mark.parametrize("i", range(len(F64_SEEDS)),
                         ids=[f"seed{s}" for s in F64_SEEDS])
def test_sharded_dense_ba_f64_matches_one_rank(run, i):
    """In float64 the pixel-sharded solve (4 ranks, 2 iterations) equals
    the one-rank solve to 1e-9 at every seed: the route sums the same
    terms, and the f32 spread of the check above is rounding that the
    second Gauss-Newton solve amplifies."""
    got = run["four"][0]["dense_ba_f64"][i]
    want = run["dense_ba_one_f64"][i]
    for r in run["four"][1:]:
        for a, b in zip(r["dense_ba_f64"][i], got):
            np.testing.assert_array_equal(a, b)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float64
    (p, d, c, cov), (p0, d0, c0, cov0) = got, want
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-9, atol=1e-9)
    assert np.mean(np.abs(d - d0) / np.abs(d0)) < 1e-9


def test_dp_render_matches_one_rank(run):
    for r in run["two"]:
        rr = r["render"]
        np.testing.assert_array_equal(rr["frame_dp"][0], rr["frame_one"][0])
        np.testing.assert_allclose(rr["frame_dp"][1], rr["frame_one"][1],
                                   rtol=2e-5, atol=2e-5)
        for k, v in rr["chunk_one"].items():
            assert rr["chunk_dp"][k].shape == v.shape
            np.testing.assert_allclose(rr["chunk_dp"][k], v, rtol=2e-5,
                                       atol=2e-5, err_msg=k)


def test_pod_mesh_on_one_host_is_the_2d_mesh(run):
    for rank, r in enumerate(run["four"]):
        pod = r["pod"]
        assert tuple(pod["names"]) == ("data", "model")
        assert pod["ranks"] == pod["ranks_2d"] == [[0, 1], [2, 3]]
        assert (pod["data_index"], pod["model_index"]) == divmod(rank, 2)


def test_pick_backend():
    assert pdist.pick_backend(4, "cpu") == ("gloo", ["cpu"] * 4)
    with pytest.raises(ValueError, match="gloo"):
        pdist.pick_backend(2, "cpu", "nccl")


def test_spawn_reports_a_failing_rank():
    with pytest.raises(RuntimeError, match="rank 1 fails"):
        pdist.spawn(ranks.fail_on_rank_one, 2, "cpu", quiet=True,
                    timeout=120)


def test_model_axis_size_must_match_the_mesh(run):
    for r in run["two"]:
        assert "model_axis_size=3" in r["size_check"]


def test_initialize_distributed_without_torchrun_is_a_noop(monkeypatch):
    for var in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    assert not pdist.initialize_distributed()
    assert not torch.distributed.is_initialized()
