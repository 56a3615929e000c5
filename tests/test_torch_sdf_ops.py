"""The SDF mapper's parts on the CPU: the four-tap gradient and Laplacian
against an analytic sphere's, NeuS's up-sampling, the coarse-to-fine level
mask and tap spacing, and the ``neuralangelo`` module's route from
``run.py`` to the mapper."""

import dataclasses
import math
import shutil
import types
from pathlib import Path

import pytest
import torch
import yaml

from nerf_vo_tpu_torch import run as run_mod
from nerf_vo_tpu_torch.models import nerfacto
from nerf_vo_tpu_torch.models import nerf_field
from nerf_vo_tpu_torch.models.nerf_field import SDFConfig
from nerf_vo_tpu_torch.ops import rendering as R
from nerf_vo_tpu_torch.runtime import stages

ROOT = Path(__file__).resolve().parents[1]


def _model(levels=2, max_res=64, **sdf):
    """An SDF mapper with a small table (log2 10) and the published
    MLPs."""
    cfg = nerfacto.NerfactoConfig(
        sampler="sdf", use_contraction=False, aabb_min=-2.0, aabb_max=2.0,
        num_grid_levels=levels, grid_features_per_level=8,
        log2_hashmap_size=10, max_res=max_res,
        sdf=dataclasses.replace(SDFConfig(), **sdf))
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        return nerfacto.NerfactoModel(cfg)


def _sphere(model, radius, sign=1.0):
    """The field's SDF replaced by ``sign * (|x| - radius)`` in the sphere's
    frame, with a zero feature."""
    hidden = nerf_field.SDF_HIDDEN

    def out(xs, active):
        f = sign * (torch.linalg.vector_norm(xs, dim=-1, keepdim=True)
                    - radius)
        return torch.cat([f, torch.zeros(xs.shape[:-1] + (hidden,))], -1)

    model.field.sdf_out = out


def _rays(n, seed=0):
    g = torch.Generator().manual_seed(seed)
    o = (torch.rand(n, 3, generator=g) - 0.5) * 0.6  # world, inside
    d = torch.randn(n, 3, generator=g)
    return o, d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)


@pytest.mark.parametrize("eps", [1 / 32, 1 / 128, 1 / 512])
def test_four_taps_give_the_sphere_gradient_and_laplacian(eps):
    """|x| - r: gradient x / |x|, Laplacian 2 / |x|. The tetrahedron's
    gradient is exact to O(e) (its third moment, sum k_x k_y k_z = 4,
    leaves e / 2 times the Hessian's off-diagonal, at most 1 / |x|) and
    its Laplacian to O(e) (the third derivatives); float32 rounds the SDF
    by ~3e-8, which the differences divide by 4e and e^2."""
    model = _model()
    _sphere(model, 0.5)
    o, d = _rays(32)
    sched = torch.tensor([2.0, eps, 0.0, 1.0])
    with torch.no_grad():
        out = model.render(o, d, schedule=sched)
    x = (model.field.to_sphere(o)[:, None, :]
         + d[:, None, :] * out["sample_depths"][..., None])
    r = torch.linalg.vector_norm(x, dim=-1)
    far = r > 0.2  # away from the cone's apex at the centre
    assert far.sum() > 1000
    e = eps / math.sqrt(3)
    g_err = (out["sample_gradients"] - x / r[..., None]).abs().amax(-1)
    l_err = (out["sample_laplacian"] - 2.0 / r).abs()
    assert g_err[far].max() <= e / 0.2 + 3e-7 / e, (g_err, e)
    assert l_err[far].max() <= 4 * e / 0.2**3 + 3e-7 / e**2, (l_err, e)


@pytest.mark.parametrize("seed", range(3))
def test_upsampled_depths_are_sorted_inside_the_sphere(seed):
    """The merged depths of 64 stratified samples and 4 rounds of 16, over
    an inside-out sphere of radius 0.5 that every ray crosses: sorted,
    within [near, far], and each round's samples near the crossing."""
    model = _model()
    _sphere(model, 0.5, sign=-1.0)
    o, d = _rays(16, seed)
    g = torch.Generator().manual_seed(seed)
    u = [torch.rand(16, 64, generator=g)]
    with torch.no_grad():
        out = model.render(o, d, uniforms=u, schedule=torch.tensor(
            [2.0, 1 / 64, 0.0, 1.0]))
    z = out["sample_depths"]
    assert z.shape == (16, 128)
    assert (z[:, 1:] >= z[:, :-1]).all()
    near, far = R.sphere_bounds(model.field.to_sphere(o), d)
    assert (z >= near[:, None]).all() and (z <= far[:, None]).all()
    # the crossing of |o + t d| = 0.5
    os_ = model.field.to_sphere(o)
    b = (os_ * d).sum(-1)
    t0 = -b + torch.sqrt(b * b - (os_ * os_).sum(-1) + 0.25)
    close = ((z - t0[:, None]).abs() < 0.05).sum(-1)
    assert (close >= 64).all(), close


@pytest.mark.parametrize("active", [4, 10, 16])
def test_level_mask_and_eps(active):
    """At the step where ``active`` levels are on: the features of the
    levels below it kept, the rest zeroed, and the taps spaced for the
    finest active level (Neuralangelo's grid, 32 to 2048 over 16
    levels)."""
    model = _model(levels=16, max_res=2048)
    sc = model.config.sdf
    step = (active - sc.c2f_init) * sc.c2f_step
    got = model.schedule_values(step)
    # the port's grid: floor(32 growth^l), growth = exp(ln(64) / 15), so
    # the finest level rounds down to 2047
    growth = math.exp((math.log(2048) - math.log(32)) / 15)
    res = [int(math.floor(32 * growth**l)) for l in range(16)]
    assert got[0] == active and got[1] == 1.0 / res[active - 1]
    assert got[2] == pytest.approx(5e-4 / growth ** (active - 4), rel=1e-12)
    assert model.schedule_values(max(step - 1, 0))[0] == active - (active > 4)
    mask = model.field.level_mask(torch.tensor(float(active)))
    assert mask.tolist() == [1.0] * (8 * active) + [0.0] * (8 * (16 - active))
    assert res[0] == 32 and res[-1] == 2047


def test_masked_levels_get_no_table_gradient():
    """A level at or above ``active`` takes no part in the SDF: its
    table rows get a zero gradient, the active level's do not."""
    model = _model()
    x = torch.rand(64, 3) * 0.8 - 0.4
    f = model.field
    with torch.no_grad():
        f.sdf_mlp[0].weight_v[:, 3:].normal_(0, 0.05)
    f.sdf_value(x, torch.tensor(1.0)).sum().backward()
    NB = f.grid.bricks_per_level
    g = f.tables.grad
    assert g[:NB].abs().sum() > 0 and g[NB:].abs().sum() == 0


def test_unported_modules_name_the_ported_ones():
    with pytest.raises(NotImplementedError) as e:
        stages.MappingStage(types.SimpleNamespace(
            mapping_module="monosdf", num_keyframes=2, frame_height=4,
            frame_width=4, mapping_iterations=8), device="cpu")
    for name in ("nerfstudio", "instant-ngp", "neuralangelo"):
        assert name in str(e.value)
    with pytest.raises(NotImplementedError) as e:
        nerfacto.check_ported(nerfacto.NerfactoConfig(sampler="volsdf"))
    for name in ("nerfstudio", "instant-ngp", "neuralangelo", "'sdf'"):
        assert name in str(e.value)


def test_run_reaches_the_sdf_mapper(tmp_path, monkeypatch):
    """``run.py --config neuralangelo_replica`` hands the scene's args to
    ``execute``, whose ``MappingStage`` is Neuralangelo's mapper at the
    published widths; here the stage is built with the grid cut to 2
    levels at log2 10 (a full table is 2 GiB) and trains a step."""
    (tmp_path / "configs").mkdir()
    shutil.copy(ROOT / "configs/neuralangelo_replica.yaml",
                tmp_path / "configs/neuralangelo_replica.yaml")
    monkeypatch.chdir(tmp_path)
    seen = {}

    def execute(args, device="cuda"):
        cfg = stages.mapping_model_config(args)
        seen["cfg"] = cfg
        small = argparse_like(args, mapping_model_overrides=dict(
            num_grid_levels=2, log2_hashmap_size=10, max_res=64,
            sdf=dict(num_samples=8, num_importance=4, upsample_rounds=2)),
            num_keyframes=2, frame_height=8, frame_width=8,
            rays_per_batch=16)
        stage = stages.MappingStage(small, device=device)
        K = 2
        c2w = torch.eye(4).repeat(K, 1, 1)
        c2w[1, 0, 3] = 0.3
        stage.update({"camera_extrinsics": c2w,
                      "camera_intrinsics": torch.tensor(
                          [[8.0, 8.0, 4.0, 4.0]]).repeat(K, 1),
                      "frames_color_float": torch.rand(K, 8, 8, 3),
                      "frames_depth": torch.rand(K, 8, 8) + 1.0})
        stage.stream_active = False
        seen["metrics"] = stage.train_step()
        seen["stage"] = stage
        return stage

    monkeypatch.setattr(run_mod, "execute", execute)
    monkeypatch.setattr(run_mod, "render_and_evaluate",
                        lambda args, config, mapping: {})
    run_mod.main(["--config", "neuralangelo_replica", "--last_scene", "0"],
                 device="cpu")
    cfg = seen["cfg"]
    assert cfg.sampler == "sdf" and (
        cfg.num_grid_levels, cfg.grid_features_per_level,
        cfg.log2_hashmap_size, cfg.max_res) == (16, 8, 22, 2048)
    assert seen["stage"].model.config.sampler == "sdf"
    assert seen["stage"].model.field.grid.base_resolution == 32
    assert torch.isfinite(seen["metrics"]["loss"])
    src = yaml.safe_load((ROOT / "configs/neuralangelo_replica.yaml")
                         .read_text())
    assert src["mapping_module"] == "neuralangelo"


def argparse_like(args, **kw):
    return types.SimpleNamespace(**dict(vars(args), **kw))
