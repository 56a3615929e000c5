"""Neuralangelo's SDF mapper on the card: its step as CUDA graphs
(``mapping/step_graph.py``) against the eager step, and the table kernels
at the ``sdf.map`` cell's grid and final encode, past 2^31 elements of the
descriptors' rows.

Skipped without a card; the file imports nothing of JAX, so it runs where
JAX is not installed: ``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_sdf_cuda.py``.
"""

import numpy as np
import pytest
import torch

from nerf_vo_tpu_torch.mapping import keyframe_buffer as kb
from nerf_vo_tpu_torch.mapping.trainer import MappingTrainer, TrainerConfig
from nerf_vo_tpu_torch.models.nerf_field import SDFConfig
from nerf_vo_tpu_torch.models.nerfacto import NerfactoConfig, NerfactoModel
from nerf_vo_tpu_torch.ops import gather_cuda as gc
from nerf_vo_tpu_torch.ops import hash_grid as hg

H, W, K = 24, 32, 6
RAYS = 256
SDF = dict(sampler="sdf", use_contraction=False, aabb_min=-2.0,
           aabb_max=2.0, num_images=K, num_grid_levels=4,
           grid_features_per_level=8, log2_hashmap_size=12, max_res=256,
           predict_normals=False,
           sdf=SDFConfig(num_samples=16, num_importance=8,
                         upsample_rounds=2, c2f_init=2, c2f_step=3,
                         warm_up_end=2, anneal_end=6))
KERNELS = ("gather_interp", "gather_cols_dfrac", "scatter_cols_outer")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs and the table kernels "
                    "have no CPU mode")
    return torch.device("cuda")


def _buffer(dev):
    """K keyframes along a short arc inside the unit sphere's room."""
    rng = np.random.default_rng(0)
    c2w = np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))
    c2w[:, :3, 3] = rng.normal(0, 0.2, (K, 3))
    yy, xx = np.meshgrid(np.linspace(0, 1, H), np.linspace(0, 1, W),
                         indexing="ij")
    color = np.clip(rng.uniform(0.1, 0.9, (K, 1, 1, 3))
                    + 0.3 * np.sin(6 * xx + 4 * yy)[None, ..., None], 0, 1)
    buf = kb.create(K, H, W, use_normals=False, device=dev)
    kb.insert(buf, list(range(K)), {
        "intrinsics": torch.tensor([[20.0, 20.0, W / 2, H / 2]]).repeat(K, 1),
        "c2w": torch.tensor(c2w),
        "color": torch.tensor(color, dtype=torch.float32),
        "depth": torch.full((K, H, W), 1.0)})
    return buf


def _trainer(dev):
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(3)
        model = NerfactoModel(NerfactoConfig(**SDF))
        with torch.no_grad():  # the features in the SDF: tables train
            model.field.sdf_mlp[0].weight_v[:, 3:].normal_(0, 0.05)
            model.field.tables.uniform_(-1e-2, 1e-2)
    cfg = TrainerConfig(rays_per_batch=RAYS, max_iterations=64,
                        prefetch_batch=False)
    tr = MappingTrainer(model, cfg, num_keyframes=K, device=dev)
    return tr, tr.init()


def _draws(tr, step, dev):
    g = torch.Generator(device=dev)
    g.manual_seed(1000 + step)
    kw = dict(generator=g, device=dev)
    return {"frame": torch.randint(0, K, (RAYS,), **kw),
            "py": torch.randint(0, H, (RAYS,), **kw),
            "px": torch.randint(0, W, (RAYS,), **kw),
            "uniforms": [torch.rand(s, **kw)
                         for s in tr.model.uniform_shapes(RAYS)]}


def _launches():
    return {k: getattr(gc, k).launches for k in KERNELS}


@pytest.mark.cuda
def test_replayed_sdf_steps_are_the_eager_steps(card):
    """Steps 0-11 from the start of the schedules (levels 2 -> 4, the
    warm-up, the cosine anneal): the graphed trainer's metrics and every
    leaf bitwise the eager trainer's, each step, with the same table-kernel
    calls a step; step 0 eager (no AdamW state), step 1 captured, the rest
    replayed, the schedule read from the device."""
    buf = _buffer(card)
    eager, est = _trainer(card)
    graphed, gst = _trainer(card)
    for step in range(12):
        d = _draws(eager, step, card)
        before = _launches()
        m_e = eager.gradients(est, buf, d)
        eager.update(est, d)
        torch.cuda.synchronize()
        mid = _launches()
        _, m_g = graphed.train_step(gst, buf, d)
        torch.cuda.synchronize()
        after = _launches()
        for k in KERNELS:
            assert after[k] - mid[k] == mid[k] - before[k] > 0, (step, k)
        for k in m_e:
            assert torch.equal(m_g[k], m_e[k]), (step, k)
        for a, b in zip(eager.leaves(est), graphed.leaves(gst)):
            assert torch.equal(a, b), step
        assert torch.equal(est.schedule, gst.schedule), step
    assert (graphed.eager_steps, graphed.captures, graphed.replays) == (
        1, 1, 10)
    assert gst.schedule[0].item() == 4.0
    assert graphed.sdf_points == eager.sdf_points == {
        "upsample": 12 * RAYS * 24, "final": 12 * RAYS * 32,
        "taps": 12 * RAYS * 128}


def _cell_grid():
    return hg.HashGridConfig(16, 8, 22, 32, 2048)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["hash_descriptors", "gather_interp",
                                    "gather_cols_dfrac",
                                    "scatter_cols_outer"])
def test_table_kernels_at_the_cells_m(card, kernel):
    """At the cell's grid (16 levels x 8 features, 2^22 entries a level,
    2M brick rows of 256) and its final encode (4096 rays x 128 samples x
    5 points: M = 41,943,040 descriptors, M x 32F = 1.07e10 past 2^31):
    the descriptors bitwise their plain chain on the first and the last
    300,000 points; the interpolation and the position pullback within
    1e-5 of the largest |output| of their plain versions on the first and
    the last 500,000 descriptors (each descriptor's output is its own);
    the table adjoint within 1e-5 of the largest |entry| of its plain
    version summed over blocks of 2^22 descriptors (its [M, 256] rows do
    not fit at once)."""
    grid = _cell_grid()
    NB = grid.bricks_per_level
    g = torch.Generator(device=card)
    g.manual_seed(7)
    n = 4096 * 128 * 5
    x = torch.rand(n, 3, generator=g, device=card)
    desc = gc.hash_descriptors(x, grid.resolutions, NB)
    idx, local, frac, Wt, _ = desc
    M = idx.shape[0]
    assert M == 41_943_040 and M * 32 * 8 > 2**31
    if kernel == "hash_descriptors":
        for s in (slice(0, 300_000), slice(n - 300_000, n)):
            want = gc.hash_descriptors_plain(x[s], grid.resolutions, NB)
            for a, b in zip(desc[:4], want[:4]):
                a = a.reshape(grid.n_levels, n, *a.shape[1:])[:, s]
                assert torch.equal(a.reshape(b.shape), b)
        return
    tab = torch.randn(grid.n_levels * NB, 256, generator=g, device=card)
    ends = (slice(0, 500_000), slice(M - 500_000, M))
    if kernel == "gather_interp":
        got = gc.gather_interp(tab, idx, Wt, 8)
        for s in ends:
            want = gc.gather_interp_plain(tab, idx[s], Wt[s], 8)
            scale = want.abs().max()
            assert (got[s] - want).abs().max() <= 1e-5 * scale
        return
    cot = torch.randn(M, 8, generator=g, device=card)
    if kernel == "gather_cols_dfrac":
        first = [l * NB for l in range(grid.n_levels)]
        got = gc.gather_cols_dfrac(tab, idx, cot, local, frac, first,
                                   grid.resolutions)
        for s in ends:
            want = gc.gather_cols_dfrac_plain(tab, idx[s], cot[s], local[s],
                                              frac[s], first,
                                              grid.resolutions)
            scale = want.abs().max()
            assert (got[s] - want).abs().max() <= 1e-5 * scale
        return
    nb = tab.shape[0]
    del tab, local, frac
    got = gc.scatter_cols_outer(Wt, cot, idx, nb)
    want = torch.zeros_like(got)
    for a in range(0, M, 1 << 22):
        s = slice(a, a + (1 << 22))
        want += gc.scatter_cols_outer_plain(Wt[s], cot[s], idx[s], nb)
    scale = want.abs().max()
    assert (got - want).abs().max() <= 1e-5 * scale
