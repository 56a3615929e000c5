"""The Instant-NGP mapper's step and occupancy refresh as CUDA graphs
(``mapping/step_graph.py``, ``MappingTrainer.train_step``), on the card.

Skipped without one; the file imports nothing of JAX, so it runs where JAX
is not installed: ``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_ngp_step_graph.py``. A small occupancy mapper (a 4 x 2
hash grid, 32 bins resampled to 16 samples, a 32^3 grid refreshed every 4
steps, its density MLP's bias raised so that refreshed cells take the
field's densities) over a keyframe buffer with depth variances. Step 0 is
eager (its Adams hold no state) and captures the refresh's graphs, step 1
captures the step's; every later step replays, refresh steps too.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.yardstick import parts
from nerf_vo_tpu_torch.mapping import keyframe_buffer as kb
from nerf_vo_tpu_torch.mapping.trainer import MappingTrainer, TrainerConfig
from nerf_vo_tpu_torch.models.nerfacto import NerfactoConfig, NerfactoModel
from nerf_vo_tpu_torch.ops import occupancy as O

H, W, K = 24, 32, 6
OCC = O.OccupancyConfig(resolution=32, update_every=4)
NGP = dict(sampler="occupancy", spacing="linear", use_contraction=False,
           aabb_min=-4.0, aabb_max=4.0, near=0.05, far=20.0, num_images=K,
           num_grid_levels=4, grid_features_per_level=2,
           log2_hashmap_size=12, max_res=128, num_occ_bins=32,
           num_nerf_samples=16, predict_normals=False, depth_loss_type="l2",
           occupancy=OCC)
RAYS = 256


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs and the table kernels "
                    "have no CPU mode")
    return torch.device("cuda")


def _buffer(dev):
    """K keyframes along a short arc, depth 1.5-3.5 m, variances of
    (0.02 d)^2 with a spread."""
    rng = np.random.default_rng(0)
    c2w = np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))
    c2w[:, :3, 3] = rng.normal(0, 0.3, (K, 3))
    yy, xx = np.meshgrid(np.linspace(0, 1, H), np.linspace(0, 1, W),
                         indexing="ij")
    color = np.clip(rng.uniform(0.1, 0.9, (K, 1, 1, 3))
                    + 0.3 * np.sin(6 * xx + 4 * yy)[None, ..., None], 0, 1)
    depth = 2.5 + np.cos(3 * xx - yy)[None] * rng.uniform(0.5, 1, (K, 1, 1))
    cov = (0.02 * depth) ** 2 * np.exp(rng.normal(size=depth.shape))
    buf = kb.create(K, H, W, use_normals=False, use_depth_cov=True,
                    device=dev)
    kb.insert(buf, list(range(K)), {
        "intrinsics": torch.tensor([[20.0, 20.0, W / 2, H / 2]]).repeat(K, 1),
        "c2w": torch.tensor(c2w),
        "color": torch.tensor(color, dtype=torch.float32),
        "depth": torch.tensor(depth, dtype=torch.float32),
        "depth_cov": torch.tensor(cov, dtype=torch.float32)})
    return buf


def _trainer(dev):
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(3)
        model = NerfactoModel(NerfactoConfig(**NGP))
    with torch.no_grad():
        model.field.density_mlp.layers[-1].bias[0] += 1.5
    cfg = TrainerConfig(rays_per_batch=RAYS, max_iterations=64,
                        prefetch_batch=False)
    tr = MappingTrainer(model, cfg, num_keyframes=K, device=dev)
    return tr, tr.init()


def _draws(tr, step, dev):
    """A step's draws from their own seed (the same for any trainer), the
    slab's jitter on a refresh step."""
    g = torch.Generator(device=dev)
    g.manual_seed(1000 + step)
    kw = dict(generator=g, device=dev)
    d = {"frame": torch.randint(0, K, (RAYS,), **kw),
         "py": torch.randint(0, H, (RAYS,), **kw),
         "px": torch.randint(0, W, (RAYS,), **kw),
         "uniforms": [torch.rand(s, **kw)
                      for s in tr.model.uniform_shapes(RAYS)]}
    if step % OCC.update_every == 0:
        d["occ_jitter"] = torch.rand(O.slab_size(OCC), 3, **kw)
    return d


def _eager_refresh(tr):
    """The trainer's occupancy refreshes made eagerly, never by graphs."""
    def refresh(state, jitter):
        tr.occ_refreshes += 1
        tr._refresh_occupancy(state, state.step, jitter)

    tr._occupancy_step = refresh


@pytest.mark.cuda
def test_replayed_refresh_steps_are_the_eager_steps(card):
    buf = _buffer(card)
    eager, est = _trainer(card)
    _eager_refresh(eager)
    graphed, gst = _trainer(card)
    for step in range(21):
        d = _draws(eager, step, card)
        m_e = eager.gradients(est, buf, d)
        eager.update(est, d)
        _, m_g = graphed.train_step(gst, buf, d)
        torch.cuda.synchronize()
        for k in m_e:
            assert torch.equal(m_g[k], m_e[k]), (step, k)
        for a, b in zip(eager.leaves(est), graphed.leaves(gst)):
            assert torch.equal(a, b), step
        assert torch.equal(est.occ_grid, gst.occ_grid), step
        if step == 0:  # the refresh's graphs, captured at the eager step
            refresh = graphed.occ_graphs
    assert (graphed.eager_steps, graphed.captures, graphed.replays) == (
        1, 1, 19)
    assert eager.occ_refreshes == graphed.occ_refreshes == 6
    assert eager.occ_graphs is None
    assert refresh is not None and graphed.occ_graphs is refresh
    # the refreshes reached the grid: cells above the decayed value
    assert (gst.occ_grid > 1.01 * OCC.decay**6).any()


def _warm(tr, st, buf, dev, steps=10):
    for step in range(steps):
        tr.train_step(st, buf, _draws(tr, step, dev))


@pytest.mark.cuda
def test_no_step_is_eager_after_the_warm_up(card):
    buf = _buffer(card)
    tr, st = _trainer(card)
    _warm(tr, st, buf, card)
    eager, refreshes = tr.eager_steps, tr.occ_refreshes
    for _ in range(24):  # the trainer's own draws, 6 refreshes among them
        tr.train_step(st, buf)
    assert tr.eager_steps == eager == 1 and tr.captures == 1
    assert tr.occ_refreshes == refreshes + 6


def _occupancy_parts():
    """8 replayed steps (refreshes at 12 and 16) after the warm-up,
    profiled: the replays and eager steps they made, and the window
    reduced by the occupancy sampler's spans."""
    from torch.profiler import ProfilerActivity, profile, record_function

    dev = torch.device("cuda")
    buf = _buffer(dev)
    tr, st = _trainer(dev)
    _warm(tr, st, buf, dev)
    replays = tr.replays
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("bench.window"):
            for step in range(10, 18):
                tr.train_step(st, buf, _draws(tr, step, dev))
            torch.cuda.synchronize()
    got = parts.Window.from_profiler(
        prof, "bench.window", parts=("occupancy", "occ_refresh")).reduce()
    return {"replays": tr.replays - replays, "eager_steps": tr.eager_steps,
            "parts": got["parts"]}


@pytest.mark.cuda
def test_occupancy_spans_hold_device_time_on_replayed_steps(card):
    """Profiled in a process of its own: on the H100 (torch 2.11), after
    this profiler session, ``tests/test_torch_gather_cuda.py``'s traced
    test run in the same process may find its first kernel's device record
    missing from its own session (its launch is recorded). No state of
    ``runtime/perf.py`` is left behind; the cases that narrow it down:
    ``scripts/exp_torch_profiler_sessions.py``."""
    code = ("import json, sys; sys.path.insert(0, sys.argv[1]); "
            "import test_torch_ngp_step_graph as t; "
            "print(json.dumps(t._occupancy_parts()))")
    here = Path(__file__).resolve().parent
    out = subprocess.run([sys.executable, "-c", code, str(here)],
                         capture_output=True, text=True, timeout=600,
                         cwd=here.parent)
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["replays"] == 8 and got["eager_steps"] == 1
    for name in ("occupancy", "occ_refresh"):
        assert got["parts"][name]["launches"] > 0, name
        assert got["parts"][name]["device_s"] > 0, name
