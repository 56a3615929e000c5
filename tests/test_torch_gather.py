"""The plain versions of the port's table kernels
(``nerf_vo_tpu_torch/ops/gather_cuda.py``) against the Pallas kernels of
``nerf_vo_tpu/ops/gather_pallas.py`` in interpret mode, and against the
XLA chain of ``hash_encode`` that computes the same functions. The two
adjoints of ``gather_interp`` (``gather_cols_dot_plain``, the dW inside
``gather_cols_dfrac_plain``, and ``scatter_cols_outer``) are held against
the Pallas ``gather_cols`` / ``scatter_cols_accum`` followed by the
contraction / the outer product in ``jnp``.

Pallas runs as ``tests/test_gather_pallas.py`` runs it: interpret mode,
tile 128, a 64-brick table of 256-wide rows, M = 256 descriptors. Inputs are
numpy draws from a fixed seed. The Pallas contract is bf16 (table, w, out,
accumulator); the port gathers bf16-rounded table values and keeps w, the
sums and the output in f32. Tolerances:

- ``gather_cols``: exact (the same round-to-nearest-even bf16 values);
- ``gather_interp`` / ``gather_interp_mm``: abs < 0.05 with w rounded to
  bf16 on both sides (the Pallas output's bf16 rounding over |out| <~ 10);
- ``scatter_cols_accum`` / ``scatter_cols_outer``: abs < 0.2, the bound of
  the Pallas tests (Pallas accumulates its ~4 N(0, 0.1) rows per brick in
  bf16, the port in f32), and 1e-5 against numpy's f32 ``add.at``;
- ``gather_cols_dot_plain``: 1e-5 against the Pallas gather's bf16 rows
  contracted in f32 in ``jnp``, and against numpy (F-term f32 sums);
- against the XLA chain (all f32 but the bf16 table): 1e-5, the order of
  a 32-term f32 sum.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_vo_tpu.ops import gather_pallas as gp
from nerf_vo_tpu_torch.ops import gather_cuda as gc

TILE = 128
B, M = 64, 2 * TILE


def _bf16(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    return dict(
        tab8=rng.normal(size=(B, 256)).astype(np.float32),
        tab1=rng.normal(size=(B, 32)).astype(np.float32),
        idx=rng.integers(0, B, M).astype(np.int32),
        w=_bf16(rng.uniform(0, 1, (M, 32))),
        g=_bf16(rng.normal(0, 0.1, (M, 256))),
    )


def test_gather_cols_matches_pallas_exactly(data):
    tab, idx = data["tab8"], data["idx"]
    want = gp.gather_cols(jnp.asarray(tab, jnp.bfloat16), jnp.asarray(idx),
                          interpret=True, tile=TILE)
    got = gc.gather_cols(torch.tensor(tab), torch.tensor(idx))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


@pytest.mark.parametrize("mm", [False, True], ids=["interp", "interp_mm"])
def test_gather_interp_matches_pallas(data, mm):
    tab, idx, w = data["tab8"], data["idx"], data["w"]
    pallas = gp.gather_interp_mm if mm else gp.gather_interp
    port = gc.gather_interp_mm if mm else gc.gather_interp
    want = pallas(jnp.asarray(tab, jnp.bfloat16), jnp.asarray(idx),
                  jnp.asarray(w, jnp.bfloat16), features=8, interpret=True,
                  tile=TILE)
    got = port(torch.tensor(tab), torch.tensor(idx), torch.tensor(w), 8)
    assert got.shape == (M, 8) and got.dtype == torch.float32
    err = np.abs(got.numpy() - np.asarray(want, np.float32)).max()
    assert err < 0.05, err


@pytest.mark.parametrize("F", [8, 1])
def test_gather_interp_on_trilinear_descriptors_matches_pallas(F):
    """The hash grid's own descriptors, hashed (res 24 over 64 bricks):
    their weights are non-zero on at most the 8 corners of the point's
    cell and never on the padding entries 27..31, the entries the CUDA
    kernel reads alone. On them the plain version matches the Pallas
    kernel, and a sum over the live entries alone equals the full sum."""
    from nerf_vo_tpu_torch.ops import hash_grid as hg

    cfg = hg.HashGridConfig(1, F, 11, 24, 24)
    rng = np.random.default_rng(6)
    tab = rng.normal(size=(cfg.bricks_per_level, 32 * F)).astype(np.float32)
    x = torch.tensor(rng.uniform(0, 1, (M, 3)).astype(np.float32))
    idx, _, _, w, _ = hg._descriptors(x, cfg)
    live = w != 0
    assert int(live.sum(1).max()) <= 8 and int(live.sum(1).min()) >= 1
    assert not live[:, 27:].any()
    w = torch.tensor(_bf16(w.numpy()))
    got = gc.gather_interp(torch.tensor(tab), idx, w, F)
    want = gp.gather_interp(jnp.asarray(tab, jnp.bfloat16),
                            jnp.asarray(idx.numpy()),
                            jnp.asarray(w.numpy(), jnp.bfloat16), features=F,
                            interpret=True, tile=TILE)
    err = np.abs(got.numpy() - np.asarray(want, np.float32)).max()
    assert err < 0.05, err
    rows = torch.tensor(_bf16(tab))[idx.long()].reshape(M, 32, F)
    sparse = (rows * w[:, :, None] * live[:, :, None]).sum(1)
    np.testing.assert_allclose(got.numpy(), sparse.numpy(), rtol=0,
                               atol=1e-5)


def test_scatter_cols_accum_matches_pallas(data):
    g, idx = data["g"], data["idx"]
    want = gp.scatter_cols_accum(jnp.asarray(g, jnp.bfloat16),
                                 jnp.asarray(idx), n_bricks=B,
                                 interpret=True, tile=TILE)
    got = gc.scatter_cols_accum(torch.tensor(g), torch.tensor(idx), B)
    assert got.shape == (B, 256) and got.dtype == torch.float32
    err = np.abs(got.numpy() - np.asarray(want, np.float32)).max()
    assert err < 0.2, err
    ref = np.zeros((B, 256), np.float32)
    np.add.at(ref, idx, g)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)

    # F = 2 rows with ids in runs, as the hash proposals hand them over
    # (level-major, a ray's samples adjacent): the shapes the card's F <= 2
    # design targets
    rng = np.random.default_rng(2)
    runs = np.repeat(rng.integers(0, B, 64), rng.integers(1, 24, 64))[:M]
    assert runs.shape == (M,) and (runs[1:] == runs[:-1]).mean() > 0.5
    runs = runs.astype(np.int32)
    g2 = _bf16(rng.normal(0, 0.1, (M, 64)))
    want2 = gp.scatter_cols_accum(jnp.asarray(g2, jnp.bfloat16),
                                  jnp.asarray(runs), n_bricks=B,
                                  interpret=True, tile=TILE)
    got2 = gc.scatter_cols_accum(torch.tensor(g2), torch.tensor(runs), B)
    assert got2.shape == (B, 64) and got2.dtype == torch.float32
    err2 = np.abs(got2.numpy() - np.asarray(want2, np.float32)).max()
    assert err2 < 0.2, err2
    ref2 = np.zeros((B, 64), np.float32)
    np.add.at(ref2, runs, g2)
    np.testing.assert_allclose(got2.numpy(), ref2, rtol=0, atol=1e-5)


ADJOINT_CASES = [(8, "random"), (2, "random"), (2, "runs")]


def _adjoint_case(F, ids):
    """A [B, 32F] table, M ids (uniform, or in runs as the hash proposals
    hand them over: level-major, a ray's samples adjacent), bf16-exact
    trilinear-like weights [M, 32] (entries 27..31 zero) and a cotangent
    [M, F] ~ N(0, 0.1)."""
    rng = np.random.default_rng(20 + F)
    tab = rng.normal(size=(B, 32 * F)).astype(np.float32)
    if ids == "runs":
        idx = np.repeat(rng.integers(0, B, 64), rng.integers(1, 24, 64))[:M]
        assert idx.shape == (M,) and (idx[1:] == idx[:-1]).mean() > 0.5
    else:
        idx = rng.integers(0, B, M)
    W = _bf16(rng.uniform(0, 1, (M, 32)))
    W[:, 27:] = 0.0
    cot = rng.normal(0, 0.1, (M, F)).astype(np.float32)
    return tab, idx.astype(np.int32), W, cot


@pytest.mark.parametrize("F,ids", ADJOINT_CASES)
def test_gather_cols_dot_matches_pallas(F, ids):
    """dW[t, e] = sum_f bf16(tab[idx[t], eF+f]) cot[t, f]: the Pallas
    gather's bf16 rows contracted with cot in jnp, and numpy's f32 sum."""
    tab, idx, _, cot = _adjoint_case(F, ids)
    rows = gp.gather_cols(jnp.asarray(tab, jnp.bfloat16), jnp.asarray(idx),
                          interpret=True, tile=TILE)
    want = jnp.sum(rows.astype(jnp.float32).reshape(M, 32, F)
                   * jnp.asarray(cot)[:, None, :], axis=-1)
    got = gc.gather_cols_dot_plain(torch.tensor(tab), torch.tensor(idx),
                                   torch.tensor(cot))
    assert got.shape == (M, 32) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    ref = (_bf16(tab)[idx].reshape(M, 32, F) * cot[:, None, :]).sum(-1)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)


def _bf16_sum_bound(idx, terms, n_bricks):
    """Elementwise bound on |bf16 scatter - exact sum| for a scatter of
    ``terms`` rounded to bf16 and added in a bf16 accumulator in any
    order: gamma_(n+1) * sum |terms| over the n terms of each brick, unit
    roundoff u = 2^-8 (one rounding of each term, one of each add)."""
    u = 2.0 ** -8
    n = np.bincount(idx, minlength=n_bricks)[:, None]
    assert (n + 1).max() * u < 1
    abs_sum = np.zeros((n_bricks, terms.shape[1]))
    np.add.at(abs_sum, idx, np.abs(terms.astype(np.float64)))
    return (n + 1) * u / (1 - (n + 1) * u) * abs_sum


@pytest.mark.parametrize("F,ids", ADJOINT_CASES)
def test_scatter_cols_outer_matches_pallas(F, ids):
    """out[b, eF+f] = sum_{idx[t] = b} W[t, e] cot[t, f]: the outer
    product in jnp through the Pallas scatter (bf16 rows and accumulator),
    within the bf16 summation bound of each brick's terms, and numpy's f32
    add.at of the f32 rows."""
    _, idx, W, cot = _adjoint_case(F, ids)
    rows = (jnp.asarray(W)[:, :, None] * jnp.asarray(cot)[:, None, :]
            ).reshape(M, 32 * F)
    want = gp.scatter_cols_accum(rows.astype(jnp.bfloat16), jnp.asarray(idx),
                                 n_bricks=B, interpret=True, tile=TILE)
    got = gc.scatter_cols_outer(torch.tensor(W), torch.tensor(cot),
                                torch.tensor(idx), B)
    assert got.shape == (B, 32 * F) and got.dtype == torch.float32
    terms = (W[:, :, None] * cot[:, None, :]).reshape(M, -1)
    diff = np.abs(got.numpy() - np.asarray(want, np.float32))
    bound = _bf16_sum_bound(idx, terms, B) + 1e-5
    assert (diff <= bound).all(), (diff - bound).max()
    ref = np.zeros((B, 32 * F), np.float32)
    np.add.at(ref, idx, terms)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("F", [8, 1])
def test_plain_versions_compose_to_the_hash_encode_chain(data, F):
    """The XLA chain of hash_encode (feature-major table, bf16 take, f32
    weighted 32-row reduce; f32 scatter-add of the table cotangent over the
    27F real rows) equals the plain versions on the brick-major table."""
    tab = data["tab8"] if F == 8 else data["tab1"]
    idx = data["idx"]
    W = data["w"].copy()
    W[:, 27:] = 0.0  # pad rows carry zero weight
    tab_fm = jnp.asarray(tab.T)  # [32F, B]
    g = jnp.take(tab_fm.astype(jnp.bfloat16), jnp.asarray(idx),
                 axis=1).reshape(32, F, M).astype(jnp.float32)
    want = jnp.sum(g * jnp.asarray(W.T)[:, None, :], axis=0).T  # [M, F]
    t_tab, t_idx, t_w = torch.tensor(tab), torch.tensor(idx), torch.tensor(W)
    for fn in (gc.gather_interp, gc.gather_interp_mm):
        got = fn(t_tab, t_idx, t_w, F)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-5)

    cot = np.random.default_rng(1).normal(size=(M, F)).astype(np.float32)
    rows = (W[:, :, None] * cot[:, None, :]).reshape(M, 32 * F)
    want_g = jnp.zeros((27 * F, B)).at[:, jnp.asarray(idx)].add(
        jnp.asarray(rows.T[:27 * F]))
    got_g = gc.scatter_cols_accum(torch.tensor(rows), t_idx, B)
    np.testing.assert_allclose(got_g.numpy()[:, :27 * F],
                               np.asarray(want_g).T, rtol=0, atol=1e-5)
    assert not got_g[:, 27 * F:].any()


SORT_CASES = ["random", "out_of_range", "all_equal", "empty", "one"]


@pytest.mark.parametrize("case", SORT_CASES)
def test_sort_ids_plain_matches_numpy_stable_argsort(case):
    """``sort_ids``' plain version against numpy's stable argsort of the
    keys (an id in [0, n_bricks), else n_bricks): the same keys and the same
    int32 positions, equal keys in the order of their positions."""
    n_bricks = 300
    rng = np.random.default_rng(30)
    idx = {"random": rng.integers(0, 7, 5000) * 41,
           "out_of_range": rng.integers(-20, n_bricks + 20, 5000),
           "all_equal": np.full(4099, 17),
           "empty": np.zeros(0),
           "one": np.asarray([299])}[case].astype(np.int32)
    keys, perm = gc.sort_ids(torch.tensor(idx), n_bricks)
    key = np.where((idx >= 0) & (idx < n_bricks), idx, n_bricks)
    want = np.argsort(key, kind="stable")
    assert keys.dtype == torch.int32 and perm.dtype == torch.int32
    np.testing.assert_array_equal(perm.numpy(), want)
    np.testing.assert_array_equal(keys.numpy(), key[want])


def test_wrappers_take_the_plain_version_only_on_the_cpu(data):
    """A tensor on another device never falls back to the plain version."""
    tab = torch.tensor(data["tab8"], device="meta")
    idx = torch.tensor(data["idx"], device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        gc.gather_cols(tab, idx)
    with pytest.raises(ValueError, match="unsupported device"):
        gc.gather_interp(tab, idx, torch.empty(M, 32, device="meta"), 8)
    with pytest.raises(ValueError, match="unsupported device"):
        gc.scatter_cols_accum(torch.empty(M, 256, device="meta"), idx, B)
    cot = torch.empty(M, 8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        gc.scatter_cols_outer(torch.empty(M, 32, device="meta"), cot, idx, B)
    with pytest.raises(ValueError, match="unsupported device"):
        gc.gather_cols_dfrac(tab, idx, cot,
                             torch.empty(M, 3, dtype=torch.int64,
                                         device="meta"),
                             torch.empty(M, 3, device="meta"), [0], [16.0])
    with pytest.raises(ValueError, match="unsupported device"):
        gc.sort_ids(idx, B)
    assert all(k.launches == 0 for k in gc.KERNELS)
