"""The order in which the hash proposals and the NeRF field hand their
table gradient to ``scatter_cols_outer``, which the atomic runs design of
``scatter_cols_accum`` relies on: it sums runs of equal ids in registers
before adding them to the table (``nerf_vo_tpu_torch/csrc/gather.cu``;
``scatter_cols_outer`` sorts the ids first and does not depend on it).

A ``ProposalDensityField`` or ``NerfactoField`` encodes ``positions
[rays, samples, 3]``; its backward scatters one row per (level, sample) in
level-major order, and within a level in ray-major order, a ray's samples
adjacent. Consecutive samples of a ray lie close together, so at the
coarse levels they fall in the same brick: the ids come in runs longer
than 1. CPU only (the plain scatter), at small proposal grids and the
replica field's grid.
"""

import numpy as np
import pytest
import torch

from nerf_vo_tpu_torch.models.nerf_field import (NerfactoField,
                                                 ProposalDensityField)
from nerf_vo_tpu_torch.ops import gather_cuda as gc
from nerf_vo_tpu_torch.ops import hash_grid as hg

RAYS, SAMPLES = 16, 96


def _ray_positions(seed):
    """[RAYS, SAMPLES, 3] world points along rays from near the origin,
    spaced evenly in disparity as nerfacto's first proposal samples."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-0.2, 0.2, (RAYS, 1, 3))
    d = rng.normal(size=(RAYS, 1, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    near, far = 0.05, 6.0
    s = np.linspace(0.0, 1.0, SAMPLES)
    t = 1.0 / (1.0 / near * (1 - s) + 1.0 / far * s)
    return torch.tensor((o + t[None, :, None] * d).astype(np.float32))


def _scattered_ids(density, pos, monkeypatch):
    seen = []
    scatter = gc.scatter_cols_outer

    def record(W, cot, idx, n_bricks):
        seen.append(idx.clone())
        return scatter(W, cot, idx, n_bricks)

    monkeypatch.setattr(gc, "scatter_cols_outer", record)
    density(pos).sum().backward()
    assert len(seen) == 1
    return seen[0]


def _level_runs(field, density, cfg, pos, monkeypatch):
    """The ids that ``density(pos)``'s backward scatters checked to be
    level-major, then ray-major with a ray's samples adjacent, each level
    in its own rows; returns the number of id runs in each level."""
    idx = _scattered_ids(density, pos, monkeypatch)
    L, NB, n = cfg.n_levels, cfg.bricks_per_level, RAYS * SAMPLES
    assert idx.shape == (L * n,) and idx.dtype == torch.int32
    per_level = idx.reshape(L, RAYS, SAMPLES).long()
    for r in range(RAYS):
        alone, *_ = hg._descriptors(field._to_unit(pos[r]), cfg)
        assert torch.equal(per_level[:, r], alone.reshape(L, SAMPLES).long())
    for lv in range(L):
        assert per_level[lv].min() >= lv * NB
        assert per_level[lv].max() < (lv + 1) * NB
    return [int((s[1:] != s[:-1]).sum()) + 1
            for s in per_level.reshape(L, n)]


@pytest.mark.parametrize("max_res", [128, 256], ids=["proposal0",
                                                     "proposal1"])
def test_proposal_scatter_ids_are_level_then_ray_major(max_res,
                                                       monkeypatch):
    """The scattered ids equal, level by level and ray by ray, the ids of
    each ray's samples encoded alone; each level's ids lie in its own
    rows; the coarse levels' ids come in runs longer than 1."""
    cfg = hg.HashGridConfig(5, 2, 13, 16, max_res)
    torch.manual_seed(0)
    field = ProposalDensityField(grid=cfg)
    runs = _level_runs(field, field, cfg, _ray_positions(1), monkeypatch)
    n = RAYS * SAMPLES
    # level 0 (8 bricks an axis) and level 1: several samples a brick
    assert runs[0] * 4 <= n and runs[1] * 2 <= n, runs
    # finer levels split rays into more bricks
    assert runs[0] <= runs[1] <= runs[-1], runs


def test_field_scatter_ids_are_level_then_ray_major(monkeypatch):
    """The same order for the NeRF field at the replica configuration's
    grid (3 x 8, log2 19, 16 -> 2048), the shape of the F = 8 measurements
    of the scatter designs: level 0's ids come in runs longer than 1, and
    the finer levels in more runs."""
    cfg = hg.HashGridConfig(3, 8, 19, 16, 2048)
    torch.manual_seed(0)
    field = NerfactoField(grid=cfg, predict_normals=False)
    runs = _level_runs(field, lambda p: field.density(p)[0], cfg,
                       _ray_positions(2), monkeypatch)
    n = RAYS * SAMPLES
    # level 0 (8 bricks an axis): several samples a brick
    assert runs[0] * 4 <= n, runs
    assert runs[0] <= runs[1] <= runs[-1], runs


@pytest.mark.parametrize("F", [1, 2, 4, 8])
def test_scatter_on_runs_matches_numpy(F):
    """The wrapper on CPU tensors (its plain version) on run-structured ids
    at every F the kernels take, against numpy's unbuffered add."""
    rng = np.random.default_rng(F)
    n_bricks = 40
    ids = np.repeat(rng.integers(0, n_bricks, 60), rng.integers(1, 12, 60))
    rows = rng.normal(size=(ids.shape[0], 32 * F)).astype(np.float32)
    got = gc.scatter_cols_accum(torch.tensor(rows),
                                torch.tensor(ids.astype(np.int32)), n_bricks,
                                hot_rows=8)
    want = np.zeros((n_bricks, 32 * F), np.float32)
    np.add.at(want, ids, rows)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
