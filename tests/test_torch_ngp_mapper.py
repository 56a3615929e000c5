"""The Instant-NGP mapper (``mapping_module: instant-ngp``) against the
benchmark's plain reference (``benchmark/reference/ngp_mapper.py``), on
the CPU at a small size, and the refresh that reads its slab's place from
the device.

The program is the benchmark's ``slam.map`` cell as ``drivers/ngp_map.py``
builds it (``MappingStage`` over a keyframe buffer with depth variances,
the compared steps' draws from the seed), cut to 4 keyframes of 24 x 32,
64 rays a step, a 4 x 2 hash grid at log2 12, 16 occupancy bins resampled
to 8 samples and a 16^3 grid refreshed every 2 steps, so that the 3
compared steps refresh it twice, from ``ngp_map.start_grid`` (the room's
walls occupied, its inside empty, the cells behind its walls drawn from
the seed).
"""

import contextlib
import json
import types
from pathlib import Path

import pytest
import torch
import yaml

from benchmark import calibrate_cell
from benchmark.drivers import ngp_map as drv
from benchmark.reference import ngp_mapper as ref
from nerf_vo_tpu_torch.mapping import trainer as trainer_mod
from nerf_vo_tpu_torch.models import nerfacto
from nerf_vo_tpu_torch.ops import occupancy as O

ROOT = Path(__file__).resolve().parents[1]
CONFIG = ROOT / "benchmark/configs/nerf_slam_replica.json"
LIMITS = json.loads((ROOT / "benchmark/workloads/slam.map.json")
                    .read_text())["limits"]
SOURCE_KEYS = ("dir_dataset", "dataset_name", "scene_names", "cache_dataset",
               "first_frame_index", "last_frame_index", "dir_prediction",
               "num_evaluation_frames")
OCC = O.OccupancyConfig(resolution=16, update_every=2)
SMALL = dict(num_grid_levels=4, grid_features_per_level=2,
             log2_hashmap_size=12, max_res=128, num_occ_bins=16,
             num_nerf_samples=8, predict_normals=False, occupancy=OCC)
TRAFFIC = dict(keyframes=4, keyframe_stride=8, frames_per_turn=720,
               insert_chunk=2, compared_steps=3)


def _ctx(seed=2**31 + 29):
    cfg = json.loads(CONFIG.read_text())
    cfg.update(num_keyframes=4, frame_height=24, frame_width=32,
               rays_per_batch=64, mapping_model_overrides=SMALL)
    return types.SimpleNamespace(seed=seed, device=torch.device("cpu"),
                                 cfg=cfg, traffic=TRAFFIC)


def test_config_is_the_yaml():
    cfg = json.loads(CONFIG.read_text())
    src = yaml.safe_load((ROOT / "configs/nerf_slam_replica.yaml")
                         .read_text())
    for k, v in src.items():
        if k not in SOURCE_KEYS:
            assert cfg[k] == v, k
    changed = [k for k in cfg if k not in src
               and k not in ("source", "reduced", "assumed",
                             "mapping_model_overrides")]
    assert sorted(changed) == sorted(cfg["reduced"]) == []
    assert cfg["source"] and len(cfg["source"]) <= 200
    assert cfg["mapping_model_overrides"] == ref.PUBLISHED
    mc = ref.model_config(cfg)
    assert (mc.num_grid_levels, mc.grid_features_per_level,
            mc.log2_hashmap_size, mc.resolution, mc.update_every) == (
                16, 2, 19, 128, 16)
    assert 4096 * mc.num_nerf_samples == 2**18


def test_program_follows_the_reference():
    """Tolerances: the losses to 1e-5 of the reference's, each leaf's first
    gradient and change over the steps to 1e-4 of its norm (or the median
    leaf's): the two sides sum the hash grid's interpolation and its
    gradients in other float32 orders (the port's plain kernels against
    autograd's indexing), which moves a sum by some 1e-7, and Adam over
    3 steps amplifies it little; a step in bfloat16 in place of float32
    moves them by 1e-3 and more (``benchmark/tests``' control). The grid
    to 1e-2 of each cell: where two such features differ in their last
    bit, one bfloat16 rounding of the density MLP may fall the other way,
    2^-8 of the density. The refreshed slabs (0 and 1) hold both branches
    of the max-merge: cells that took the field's density and cells that
    kept their decayed start."""
    ctx = _ctx()
    _, prog, _ = drv.build(ctx)
    want = drv.reference_readings(ctx)
    assert len(prog["losses"]) == len(want["losses"]) == 3
    for p, r in zip(prog["losses"], want["losses"]):
        assert abs(p - r) <= 1e-5 * abs(r), (p, r)
    assert set(prog["grad"]) == set(want["grad"]) == set(want["change"])
    assert "pose_deltas" in want["grad"] and len(want["grad"]) == 13
    for key in ("grad", "change"):
        floor = sorted(want[key].values())[len(want[key]) // 2]
        for leaf, r in want[key].items():
            assert abs(prog[key][leaf] - r) <= 1e-4 * max(r, floor), (
                key, leaf, prog[key][leaf], r)
    g, gr = prog["grid"], want["grid"]
    torch.testing.assert_close(g, gr, rtol=1e-2, atol=0)
    start = drv.start_grid(ref.model_config(ctx.cfg), ctx.seed, "cpu")
    took = ~torch.isclose(gr, start * OCC.decay**2, rtol=1e-5, atol=0)
    n = O.slab_size(OCC)
    assert not took[2 * n:].any()
    assert 0.25 * n < took.sum() < 1.75 * n
    assert all(v <= LIMITS[k] for k, v in drv.gaps(prog, want).items())


def _ignore_covariance(monkeypatch):
    l2 = nerfacto.L.depth_l2_loss

    def unweighted(pred, target, depth_cov=None, mask=None):
        return l2(pred, target, None, mask)

    monkeypatch.setattr(nerfacto.L, "depth_l2_loss", unweighted)


def _skip_refresh(monkeypatch):
    monkeypatch.setattr(trainer_mod.MappingTrainer, "_refresh_occupancy",
                        lambda self, state, step, jitter: None)


@pytest.mark.parametrize("fault, gap", [
    (_ignore_covariance, "loss_gap"), (_skip_refresh, "occ_gap"),
    ("slab_shifted", "occ_gap"), ("bin_mirrored", "loss_gap")],
    ids=["covariance_ignored", "refresh_skipped", "slab_shifted",
         "bin_mirrored"])
def test_a_fault_fails_a_gap(monkeypatch, fault, gap):
    """Named faults: ``benchmark/calibrate_cell.py``'s, a refresh into the
    next slab's cells and bin lookups at mirrored cells."""
    ctx = _ctx(2**31 + 31)
    want = drv.reference_readings(ctx)
    with contextlib.ExitStack() as planted:
        if isinstance(fault, str):
            planted.enter_context(calibrate_cell.FAULTS[fault]())
        else:
            fault(monkeypatch)
        _, prog, _ = drv.build(ctx)
    numbers = drv.gaps(prog, want)
    assert numbers[gap] > LIMITS[gap], numbers


@pytest.mark.parametrize("slab", range(O.OccupancyConfig().slab_div))
def test_the_refresh_reads_its_slab_from_the_device(slab):
    """The refresh at a step given as a 0-dim tensor, as the graphs hold
    it, is the refresh at the step as an int, and both are the decay and
    the max-merge over that slab's cells."""
    occ = O.OccupancyConfig(resolution=16, update_every=3)
    cfg = nerfacto.NerfactoConfig(
        **{k: v for k, v in SMALL.items() if k != "occupancy"},
        sampler="occupancy", spacing="linear", use_contraction=False,
        aabb_min=-4.0, aabb_max=4.0, num_images=4, occupancy=occ)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(slab)
        model = nerfacto.NerfactoModel(cfg)
        grid = torch.rand(occ.resolution**3) * 3.0
        jitter = torch.rand(O.slab_size(occ), 3)
    step = slab * occ.update_every + 1
    host = model.refresh_occupancy(grid, step, jitter)
    dev = model.refresh_occupancy(grid, torch.tensor(step), jitter)
    assert torch.equal(host, dev)
    n = O.slab_size(occ)
    unit, start = O.slab_cell_centers(torch.tensor(step), jitter, occ)
    assert int(start) == slab * n
    want = grid * occ.decay
    with torch.no_grad():
        dens = model.field.density_unit(unit)
    want[slab * n:(slab + 1) * n] = torch.maximum(
        want[slab * n:(slab + 1) * n], dens)
    assert torch.equal(dev, want)
