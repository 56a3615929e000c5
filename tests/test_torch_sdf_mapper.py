"""Neuralangelo's SDF mapper (``mapping_module: neuralangelo``,
``sampler="sdf"``) against the benchmark's plain reference
(``benchmark/reference/sdf_mapper.py``), on the CPU at a small size.

The program is the benchmark's ``sdf.map`` cell as ``drivers/sdf_map.py``
builds it (``MappingStage`` over the room's keyframes, the compared steps'
draws from the seed, the step counter at 1024), cut to 4 keyframes of
24 x 32, 8 rays a step, a 2 x 8 hash grid at log2 10 (32 and 64) and 8
stratified samples with 2 up-sampling rounds of 4; the MLPs keep their
published widths.
"""

import contextlib
import json
import types
from pathlib import Path

import pytest
import torch
import yaml

from benchmark import calibrate_sdf
from benchmark.drivers import sdf_map as drv
from benchmark.reference import sdf_mapper as ref
from nerf_vo_tpu_torch.models import nerf_field
from nerf_vo_tpu_torch.models.nerf_field import SDFConfig
from nerf_vo_tpu_torch.runtime import stages

ROOT = Path(__file__).resolve().parents[1]
CONFIG = ROOT / "benchmark/configs/neuralangelo_replica.json"
LIMITS = json.loads((ROOT / "benchmark/workloads/sdf.map.json")
                    .read_text())["limits"]
SOURCE_KEYS = ("dir_dataset", "dataset_name", "scene_names", "cache_dataset",
               "first_frame_index", "last_frame_index", "dir_prediction",
               "num_evaluation_frames")
SMALL_SDF = dict(num_samples=8, num_importance=4, upsample_rounds=2)
SMALL = dict(num_grid_levels=2, grid_features_per_level=8,
             log2_hashmap_size=10, max_res=64, sdf=SMALL_SDF)
# the SDF mapper's settings that are module constants of the program
CONSTANTS = ("min_res", "hidden", "beta", "color_hidden", "color_depth",
             "sh_degree", "out_bias", "init_s", "upsample_inv_s",
             "eikonal_mult", "curvature_mult", "learning_rate",
             "weight_decay", "lr_steps", "lr_gamma")
TRAFFIC = dict(keyframes=4, keyframe_stride=8, frames_per_turn=720,
               insert_chunk=2, start_step=1024, compared_steps=3)


def _ctx(seed=2**31 + 61, start=1024):
    cfg = json.loads(CONFIG.read_text())
    cfg.update(num_keyframes=4, frame_height=24, frame_width=32,
               rays_per_batch=8, mapping_model_overrides=SMALL)
    return types.SimpleNamespace(seed=seed, device=torch.device("cpu"),
                                 cfg=cfg, traffic=dict(TRAFFIC,
                                                       start_step=start))


def test_config_is_the_yaml():
    cfg = json.loads(CONFIG.read_text())
    src = yaml.safe_load((ROOT / "configs/neuralangelo_replica.yaml")
                         .read_text())
    for k, v in src.items():
        if k not in SOURCE_KEYS:
            assert cfg[k] == v, k
    added = [k for k in cfg if k not in src
             and k not in ("source", "reduced", "assumed",
                           "mapping_model_overrides")]
    assert added == ["rays_per_batch"] and cfg["rays_per_batch"] == 4096
    assert cfg["reduced"] == ["mapping_iterations", "rays_per_batch"]
    assert cfg["source"] and len(cfg["source"]) <= 200
    assert cfg["mapping_model_overrides"] == ref.PUBLISHED
    mc = ref.model_config(cfg)
    assert (mc.num_grid_levels, mc.grid_features_per_level,
            mc.log2_hashmap_size, mc.min_res, mc.max_res) == (16, 8, 22, 32,
                                                             2048)
    # the reference's settings are the program's defaults
    port = stages.mapping_model_config(types.SimpleNamespace(**cfg))
    assert port.sampler == "sdf" and port.aabb_max == mc.radius
    for f in SDFConfig.__dataclass_fields__:
        assert getattr(port.sdf, f) == getattr(mc, f), f
    for f in CONSTANTS:
        assert getattr(nerf_field, "SDF_" + f.upper()) == getattr(mc, f), f
    assert mc.inside_out
    assert mc.schedule(1024)[0] == 16 and mc.schedule(983)[0] == 15


def test_program_follows_the_reference():
    """Tolerances: the losses to 1e-5 of the reference's, each leaf's first
    gradient to 1e-4 and its change over the steps to 1e-3 of its norm (or
    the median leaf's): the two sides sum the hash grid's interpolation and
    its gradients in other float32 orders (the port's plain kernels against
    autograd's indexing), which moves a sum by some 1e-7; AdamW's eps 1e-8
    lets a table entry with a gradient near 1e-8 move by a share of its
    step on either side. The final samples' numerical gradients to 1e-4.
    The schedule the program's graphs read holds the reference's values
    at the last step, and AdamW's learning rate its."""
    ctx = _ctx()
    stage, prog, mc = drv.build(ctx)
    want = drv.reference_readings(ctx)
    assert len(prog["losses"]) == len(want["losses"]) == 3
    for p, r in zip(prog["losses"], want["losses"]):
        assert abs(p - r) <= 1e-5 * abs(r), (p, r)
    assert set(prog["grad"]) == set(want["grad"]) == set(want["change"])
    assert "pose_deltas" in want["grad"] and len(want["grad"]) == 24
    for key, tol in (("grad", 1e-4), ("change", 1e-3)):
        floor = sorted(want[key].values())[len(want[key]) // 2]
        for leaf, r in want[key].items():
            assert abs(prog[key][leaf] - r) <= tol * max(r, floor), (
                key, leaf, prog[key][leaf], r)
    assert want["grad"]["field.tables"] > 0
    torch.testing.assert_close(prog["normals"], want["normals"], rtol=1e-4,
                               atol=1e-4)
    st = stage.state
    assert st.step == 1027
    torch.testing.assert_close(st.schedule, torch.tensor(
        mc.schedule(1026), dtype=torch.float32), rtol=0, atol=0)
    assert st.opt.param_groups[0]["lr"] == mc.learning_rate_at(1026)
    assert all(v <= LIMITS[k] for k, v in drv.gaps(prog, want).items())


def test_the_schedules_move_from_the_start():
    """From step 0: the learning rate's warm-up, the levels' coarse-to-fine
    and the cosine anneal, each step's as the reference has it."""
    ctx = _ctx(start=0)
    ctx.cfg["mapping_model_overrides"] = dict(
        SMALL, num_grid_levels=6, max_res=96, sdf=dict(
            SMALL_SDF, c2f_init=1, c2f_step=1, warm_up_end=2, anneal_end=4))
    mc, kf, params, steps = drv.inputs(ctx)
    stage = stages.MappingStage(types.SimpleNamespace(**ctx.cfg),
                                state_dict=params, device="cpu")
    for p in drv.base._packets(kf, 2):
        stage.update(p)
    stage.stream_active = False
    seen = []
    for d in steps:
        stage.train_step(d)
        st = stage.state
        seen.append((tuple(st.schedule.tolist()),
                     st.opt.param_groups[0]["lr"]))
    want = [(tuple(torch.tensor(mc.schedule(s)).tolist()),
             mc.learning_rate_at(s)) for s in range(3)]
    assert seen == want
    assert [s[0][0] for s in seen] == [1.0, 2.0, 3.0]
    assert seen[0][1] == 0.0 and seen[2][1] == mc.learning_rate


@pytest.mark.parametrize("fault", ["sdf_input_bf16", "eps_coarse",
                                   "upsample_inv_s_halved", "half_batch"])
def test_a_fault_fails_a_gap(fault):
    """``benchmark/calibrate_sdf.py``'s faults: the SDF MLP's input in
    bf16, the taps one level coarse, round 0's sharpness halved; and
    ``faults.py``'s half batch."""
    ctx = _ctx(2**31 + 63)
    want = drv.reference_readings(ctx)
    with contextlib.ExitStack() as planted:
        planted.enter_context(calibrate_sdf.FAULTS[fault]())
        _, prog, _ = drv.build(ctx)
    numbers = drv.gaps(prog, want)
    assert any(numbers[k] > LIMITS[k] for k in LIMITS), numbers


def test_a_bf16_sdf_mlp_fails_the_normals():
    """The SDF MLP's input rounded to bf16, as the port's other MLPs round
    theirs: the taps 1/(64 sqrt 3) apart collapse onto bf16's grid, and
    the numerical gradients fail ``normal_gap``."""
    ctx = _ctx(2**31 + 65)
    want = drv.reference_readings(ctx)
    with calibrate_sdf.FAULTS["sdf_input_bf16"]():
        _, prog, _ = drv.build(ctx)
    assert drv.gaps(prog, want)["normal_gap"] > LIMITS["normal_gap"]
