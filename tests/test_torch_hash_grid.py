"""The port's brick hash grid (``nerf_vo_tpu_torch/ops/hash_grid.py``)
against ``nerf_vo_tpu/ops/hash_grid.py``.

Inputs are numpy draws from a fixed seed; tables go to the port transposed
to its brick-major layout. On the CPU the port's ``hash_encode`` runs the
plain versions of its kernels: the one-hot route (``gather_interp_mm``) on
the dense prefix levels with at most 512 bricks, ``gather_interp`` on the
rest, ``scatter_cols_outer`` for the table gradient and ``gather_cols_dot``
for the position gradient.

Tolerances, from the measured spread:
- brick ids: bit-exact (int64 masked to 32 bits against uint32);
- forward: both sides sum the same bf16 table values with the same f32
  weights, in another order: 1e-6 of max |out| (measured 8e-8);
- table gradient: JAX rounds the cotangent rows to bf16 and accumulates the
  hashed levels in bf16 (SCATTER_BF16) and the one-hot level's sums to bf16;
  the port is f32 throughout: relative L2 error < 1e-2 per level (measured
  1.8e-3 to 2.0e-3, the bf16 rounding of the cotangent);
- position gradient: f32 on both sides: relative L2 < 1e-5 (measured 8e-8).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_vo_tpu.models import nerf_field as jfield
from nerf_vo_tpu.ops import hash_grid as jhg
from nerf_vo_tpu_torch.models import nerf_field as tfield
from nerf_vo_tpu_torch.ops import hash_grid as thg

FIELD = dict(n_levels=3, features_per_level=8, log2_table_size=14,
             base_resolution=16, max_resolution=64)


def _rel(got, want):
    want = np.asarray(want, np.float64)
    return np.linalg.norm(np.asarray(got, np.float64) - want) / max(
        np.linalg.norm(want), 1e-30)


@pytest.mark.parametrize("res,n_bricks", [(64, 512), (2048, 16384),
                                          (1 << 22, 16384)])
def test_brick_ids_bit_exact(res, n_bricks):
    """Dense and hashed levels; the last has brick coordinates up to 2^21,
    so the prime products wrap 32 bits."""
    rng = np.random.default_rng(0)
    bpa = ((res - 1) >> 1) + 1
    c = rng.integers(0, bpa, size=(3, 4096)).astype(np.int32)
    c[:, 0] = bpa - 1
    want = np.asarray(jhg._brick_ids(jnp.asarray(c), res, n_bricks, 2))
    got = thg._brick_ids(torch.tensor(c), res, n_bricks, 2)
    np.testing.assert_array_equal(got.numpy(), want)


def _grid_cases():
    return {
        # level 0 (512 bricks) on the one-hot route, levels 1-2 hashed
        "field": jhg.HashGridConfig(**FIELD),
        # dense proposal geometry: res 16 one-hot, res 24 gathered
        "proposal16": jfield.DenseProposalField(resolution=16).grid,
        "proposal24": jfield.DenseProposalField(resolution=24).grid,
    }


@pytest.mark.parametrize("case", ["field", "proposal16", "proposal24"])
def test_hash_encode_matches_jax(case):
    jcfg = _grid_cases()[case]
    tcfg = thg.HashGridConfig(**vars(jcfg))
    if case != "field":
        assert tcfg == tfield.DenseProposalField(
            resolution=jcfg.base_resolution).grid
    L, F = jcfg.n_levels, jcfg.features_per_level
    rng = np.random.default_rng(1)
    tab = rng.normal(0, 0.5, (32 * F, L * jcfg.bricks_per_level)).astype(
        np.float32)
    x = rng.uniform(-0.02, 1.02, (40, 16, 3)).astype(np.float32)
    cot = rng.normal(size=(40, 16, L * F)).astype(np.float32)

    out_j, vjp = jax.vjp(lambda t, p: jhg.hash_encode(t, p, jcfg),
                         jnp.asarray(tab), jnp.asarray(x))
    gt_j, gx_j = vjp(jnp.asarray(cot))

    t_tab = thg.tables_from_jax(tab).requires_grad_(True)
    t_x = torch.tensor(x, requires_grad=True)
    out_t = thg.hash_encode(t_tab, t_x, tcfg)
    gt_t, gx_t = torch.autograd.grad(out_t, (t_tab, t_x), torch.tensor(cot))

    out_j = np.asarray(out_j)
    assert out_t.shape == out_j.shape
    np.testing.assert_allclose(out_t.detach().numpy(), out_j, rtol=0,
                               atol=1e-6 * np.abs(out_j).max())
    NB = jcfg.bricks_per_level
    gt_j = np.asarray(gt_j).T  # brick-major
    for l in range(L):
        lvl = slice(l * NB, (l + 1) * NB)
        assert _rel(gt_t[lvl].numpy(), gt_j[lvl]) < 1e-2, l
    assert not gt_t.reshape(-1, 32, F)[:, 27:].any()  # pad rows
    assert _rel(gx_t.numpy(), gx_j) < 1e-5
    # outside the unit cube the clamp passes no gradient
    outside = (x < 0) | (x > 1)
    assert outside.any() and not gx_t.numpy()[outside].any()


def _jax_onehot_rows(jcfg):
    """Leading table rows of the JAX one-hot levels, by the rule of
    ``nerf_vo_tpu/ops/hash_grid.py`` (dense prefix levels whose brick
    lattice fits ``min(NB, _ONEHOT_MAX_BRICKS)``; level l's bricks start at
    column l * NB)."""
    NB = jcfg.bricks_per_level
    n_oh = 0
    for l, res in enumerate(jcfg.resolutions):
        bpa = ((res - 1) >> 1) + 1
        if bpa**3 <= min(NB, jhg._ONEHOT_MAX_BRICKS):
            n_oh = l + 1
        else:
            break
    if n_oh == 0:
        return 0
    bpa = ((jcfg.resolutions[n_oh - 1] - 1) >> 1) + 1
    return (n_oh - 1) * NB + bpa**3


@pytest.mark.parametrize("case", ["field", "replica_field", "proposal128",
                                  "proposal160", "proposal16",
                                  "proposal24"])
def test_hot_rows_follow_the_jax_onehot_rule(case, monkeypatch):
    """The leading rows ``hash_encode`` asks ``gather_interp_mm`` to keep
    on chip are the rows of the JAX package's one-hot levels: the test field, the replica field (3 x 8, log2
    19, 16 -> 2048) and the replica's two dense proposal grids (128, 160),
    and the small proposal grids of the parity test."""
    grids = dict(_grid_cases(),
                 replica_field=jhg.HashGridConfig(3, 8, 19, 16, 2048),
                 proposal128=jfield.DenseProposalField(resolution=128).grid,
                 proposal160=jfield.DenseProposalField(resolution=160).grid)
    jcfg = grids[case]
    tcfg = thg.HashGridConfig(**vars(jcfg))
    want = _jax_onehot_rows(jcfg)
    assert thg._hot_rows(tcfg) == want
    assert want == {"field": 512, "replica_field": 512, "proposal16": 512
                    }.get(case, 0)

    seen = {}

    def spy(name):
        real = getattr(thg.gc, name)

        def call(*args, hot_rows=0):
            seen.setdefault(name, []).append(hot_rows)
            return real(*args, hot_rows=hot_rows)
        return call

    monkeypatch.setattr(thg.gc, "gather_interp_mm", spy("gather_interp_mm"))
    L, F = tcfg.n_levels, tcfg.features_per_level
    rng = np.random.default_rng(3)
    tab = torch.tensor(rng.normal(size=(L * tcfg.bricks_per_level, 32 * F)),
                       dtype=torch.float32, requires_grad=True)
    x = torch.tensor(rng.uniform(0, 1, (64, 3)), dtype=torch.float32)
    thg.hash_encode(tab, x, tcfg).sum().backward()
    assert seen.get("gather_interp_mm", []) == ([want] if want else [])


def test_dfrac_matches_the_einsum_form():
    """``_dfrac`` (broadcast products summed one axis at a time) against
    the contraction it replaced, one ``einsum("mijk,mi,mj,mk->m")`` per
    axis, on the descriptors of points in and around the unit cube and a
    dW ~ N(0, 1): f32 sums of 27 terms in another order, 1e-6 relative."""
    cfg = thg.HashGridConfig(**FIELD)
    rng = np.random.default_rng(4)
    x = torch.tensor(rng.uniform(-0.02, 1.02, (2000, 3)).astype(np.float32))
    _, local, frac, _, _ = thg._descriptors(x, cfg)
    dW = torch.tensor(rng.normal(size=(local.shape[0], 32)).astype(
        np.float32))
    d = dW[:, :27].reshape(-1, 3, 3, 3)
    w = [thg._axis_weights(local[:, a], frac[:, a]) for a in range(3)]
    dw = [thg._axis_dweights(local[:, a]) for a in range(3)]
    want = torch.stack([
        torch.einsum("mijk,mi,mj,mk->m", d, dw[0], w[1], w[2]),
        torch.einsum("mijk,mi,mj,mk->m", d, w[0], dw[1], w[2]),
        torch.einsum("mijk,mi,mj,mk->m", d, w[0], w[1], dw[2]),
    ], dim=-1).numpy()
    got = thg._dfrac(dW, local, frac).numpy()
    assert got.shape == (local.shape[0], 3)
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=1e-6 * np.abs(want).max())


def test_contractions_match_jax():
    rng = np.random.default_rng(2)
    x = (rng.normal(size=(256, 3)) * 3).astype(np.float32)
    for name in ("contract", "contract_to_unit_cube"):
        for order in (np.inf, 2.0):
            want = getattr(jhg, name)(jnp.asarray(x), order)
            got = getattr(thg, name)(torch.tensor(x), order)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=0, atol=1e-6)
    want = jhg.normalize_to_unit_cube(jnp.asarray(x), -4.0, 4.0)
    got = thg.normalize_to_unit_cube(torch.tensor(x), -4.0, 4.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-7)


def test_from_jax_params_round_trip():
    """Tables go brick-major and back; every Flax leaf lands in the torch
    field with its transpose."""
    jcfg = jhg.HashGridConfig(**FIELD)
    module = jfield.NerfactoField(grid=jcfg, num_images=8)
    params = module.init(jax.random.PRNGKey(0), jnp.zeros((4, 3)),
                         jnp.ones((4, 3)) / np.sqrt(3.0),
                         jnp.zeros((4,), jnp.int32))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    tab = params["tables"]
    np.testing.assert_array_equal(thg.tables_from_jax(tab).numpy().T, tab)
    sd = tfield.from_jax_params(params)
    field = tfield.NerfactoField(grid=thg.HashGridConfig(**FIELD),
                                 num_images=8)
    missing = field.load_state_dict(sd, strict=True)
    assert not missing.missing_keys and not missing.unexpected_keys
    np.testing.assert_array_equal(field.tables.detach().numpy(), tab.T)
    np.testing.assert_array_equal(
        field.color_mlp.layers[1].weight.detach().numpy(),
        params["color_mlp"]["Dense_1"]["kernel"].T)
    np.testing.assert_array_equal(
        field.embedding.weight.detach().numpy(),
        params["embedding"]["embedding"])
