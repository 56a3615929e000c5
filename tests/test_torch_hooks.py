"""The upstream-checkpoint env hooks of the port's nerf_vo stages
(``NERF_VO_DPVO_WEIGHTS``, ``NERF_VO_OMNIDATA_DEPTH_WEIGHTS``,
``NERF_VO_OMNIDATA_NORMAL_WEIGHTS``) against the JAX package's.

The files are written in the upstream layouts by the upstream-layout torch
stacks of ``tests/test_convert_dpvo.py`` (``TVONet``) and
``tests/test_convert_dpt.py`` (``TDPT``, 12 blocks at 96x96): ``dpvo.pth``
with ``module.`` prefixes and a non-zero ``update.lmbda``; the Omnidata
files as ``{"state_dict": {"model." + k: v}}`` with keys neither converter
reads (``pretrained.act_postprocess{1,2}``, the timm ViT's ``norm`` and
``head``). The JAX stages and the port's stages load the same files through
the hooks; the port's state dicts must equal ``from_jax_params`` of the JAX
params exactly, and the nets' outputs must agree within the tolerances of
``tests/test_torch_dpvo_net.py`` (atol 1e-4: f32 convolutions and dense
layers summed in another order, outputs O(1)) and
``tests/test_torch_dpt.py`` (atol 1e-5, outputs O(0.1)), with the DPT at
the 2 blocks that ``enhancement_dpt_layers: 2`` cuts it to, in f32 on both
sides.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_vo_tpu.models import dpt as jdpt
from nerf_vo_tpu.models import dpvo_net as jdpvo
from nerf_vo_tpu.runtime import stages as jstages
from nerf_vo_tpu_torch.models import dpt as tdpt
from nerf_vo_tpu_torch.models import dpvo_net as tdpvo
from nerf_vo_tpu_torch.runtime import stages as tstages
from test_convert_dpt import TDPT
from test_convert_dpvo import TVONet

H, W, S = 48, 64, 96
ARGS = dict(
    frame_height=H, frame_width=W, patches_per_frame=8, removal_window=6,
    optimization_window=4, patch_lifetime=4, tracking_init_frames=4,
    tracking_max_edges=512, tracking_ring_size=8, tracking_max_frames=64,
    keyframe_threshold=0.0, enhancement_module="depth_normal",
    enhancement_image_size=S, enhancement_dpt_layers=2,
)
HOOKS = ("NERF_VO_DPVO_WEIGHTS", "NERF_VO_OMNIDATA_DEPTH_WEIGHTS",
         "NERF_VO_OMNIDATA_NORMAL_WEIGHTS")
DPVO_ATOL = 1e-4
DPT_ATOL = 1e-5
# keys of a real Omnidata file that neither converter reads
EXTRA = ("pretrained.act_postprocess1.0.project.0.weight",
         "pretrained.act_postprocess2.3.weight",
         "pretrained.model.norm.weight", "pretrained.model.head.weight")


def _omnidata_file(path, sd):
    blob = {"model." + k: v for k, v in sd.items()}
    for i, k in enumerate(EXTRA):
        blob["model." + k] = torch.full((4,), float(i))
    torch.save({"state_dict": blob, "epoch": 3}, path)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ckpt")
    torch.manual_seed(11)
    vo = TVONet().state_dict()
    vo["update.lmbda"] = torch.tensor([0.37])
    torch.save({"module." + k: v for k, v in vo.items()}, tmp / "dpvo.pth")
    out = {"dpvo": vo, "dir": tmp}
    for name, ch, seed in (("depth", 1, 3), ("normal", 3, 4)):
        torch.manual_seed(seed)
        sd = TDPT(S // 16, num_channels=ch).state_dict()
        _omnidata_file(tmp / f"omnidata_{name}.ckpt", sd)
        out[name] = sd
    return out


def _env(mp, files, **paths):
    names = dict(zip(HOOKS, ("dpvo.pth", "omnidata_depth.ckpt",
                             "omnidata_normal.ckpt")))
    for env in HOOKS:
        mp.setenv(env, str(files["dir"] / paths.get(env, names[env])))


@pytest.fixture(scope="module")
def stages(files):
    """Both packages' tracking and enhancement stages, built with no
    weights passed and the three hooks set."""
    args = SimpleNamespace(**ARGS)
    with pytest.MonkeyPatch.context() as mp:
        _env(mp, files)
        jtrack = jstages.TrackingStage(args)
        jenh = jstages.EnhancementStage(args)
        ttrack = tstages.TrackingStage(args, device="cpu")
        tenh = tstages.EnhancementStage(args, device="cpu")
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return dict(
        jtrack=jtrack, ttrack=ttrack, jenh=jenh, tenh=tenh,
        jdpvo=np_tree(jtrack.tracker.params["params"]),
        jdepth=np_tree(jenh.estimator.depth_params["params"]),
        jnormal=np_tree(jenh.estimator.normal_params["params"]))


def _first_blocks(params, n):
    return {k: v for k, v in params.items()
            if not (k.startswith("block_") and int(k[6:]) >= n)}


def _assert_state_dicts_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0,
                                   msg=k)


def test_dpvo_hook_loads_the_file_as_jax_does(stages, files):
    got = stages["ttrack"].tracker.net.state_dict()
    _assert_state_dicts_equal(got, tdpvo.from_jax_params(stages["jdpvo"]))
    for k, v in files["dpvo"].items():  # every tensor is the file's ...
        if k != "update.lmbda":
            torch.testing.assert_close(got[k], v, rtol=0, atol=0, msg=k)
    # ... but the BA damping, which no tracker reads
    assert files["dpvo"]["update.lmbda"].item() != 0
    assert not got["update.lmbda"].any()


def test_dpvo_hook_nets_match_jax(stages):
    jnet = stages["jtrack"].tracker.net
    params = stages["jtrack"].tracker.params
    tnet = stages["ttrack"].tracker.net
    img = np.random.default_rng(0).uniform(0, 255, (1, H, W, 3))
    img = img.astype(np.float32)
    want = jnet.apply(params, jnp.asarray(img), method=jnet.encode)
    with torch.no_grad():
        got = tnet.encode(torch.tensor(img))
    for w, g in zip(want, got):
        assert g.shape == w.shape and np.abs(np.asarray(w)).max() > 1e-2
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=DPVO_ATOL)

    rng = np.random.default_rng(1)
    E, D = 12, 384
    net = rng.standard_normal((E, D)).astype(np.float32) * 0.5
    inp = rng.standard_normal((E, D)).astype(np.float32) * 0.5
    corr = rng.standard_normal((E, 882)).astype(np.float32)
    kk = np.repeat(np.arange(4), 3).astype(np.int32)
    jj = np.tile(np.arange(3), 4).astype(np.int32)
    pair = jj.copy()
    ix = np.where(jj > 0, np.arange(E) - 1, -1).astype(np.int32)
    jx = np.where(jj < 2, np.arange(E) + 1, -1).astype(np.int32)
    want = jnet.apply(
        params, *map(jnp.asarray, (net, inp, corr, kk, pair, ix, jx)),
        jnp.ones((E,), bool), 4, 3, method=jnet.update_step)
    with torch.no_grad():
        got = tnet.update_step(*[torch.tensor(a) for a in
                                 (net, inp, corr)],
                               *[torch.tensor(a).long() for a in
                                 (kk, pair, ix, jx)], 4, 3)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=DPVO_ATOL)


def test_dpvo_corr_perm_matches_jax(files):
    perm = np.random.default_rng(2).permutation(882)
    path = files["dir"] / "dpvo.pth"
    want = jdpvo.convert_torch_checkpoint(
        torch.load(path, weights_only=True), corr_perm=perm)
    got = tdpvo.load_torch_weights(str(path), corr_perm=perm)
    _assert_state_dicts_equal(got, tdpvo.from_jax_params(
        jax.tree_util.tree_map(np.asarray, want)))
    np.testing.assert_array_equal(
        got["update.corr.0.weight"].numpy(),
        files["dpvo"]["update.corr.0.weight"].numpy()[:, perm])


@pytest.mark.parametrize("depth_layers", [2, 12])
def test_omnidata_hooks_load_the_files_as_jax_does(stages, files,
                                                   depth_layers):
    """A 12-block file loads into a model of ``depth_layers`` blocks as
    into JAX's: the JAX params hold the file's 12 blocks and the model
    reads the first ``depth_layers``; the port keeps those, with every
    key JAX reads (``refinenet4``'s ``resConfUnit1`` too) and none of the
    file's extras."""
    if depth_layers == 2:
        est = stages["tenh"].estimator
    else:
        with pytest.MonkeyPatch.context() as mp:
            _env(mp, files)
            est = tstages.EnhancementStage(
                SimpleNamespace(**dict(ARGS, enhancement_dpt_layers=12)),
                device="cpu").estimator
    for model, ch, jparams in ((est.depth_model, 1, stages["jdepth"]),
                               (est.normal_model, 3, stages["jnormal"])):
        assert len(model.pretrained.model.blocks) == depth_layers
        got = model.state_dict()
        _assert_state_dicts_equal(got, tdpt.from_jax_params(
            _first_blocks(jparams, depth_layers), ch))
        file_sd = files["depth" if ch == 1 else "normal"]
        for k, v in got.items():
            torch.testing.assert_close(v, file_sd[k], rtol=0, atol=0, msg=k)
        assert got["scratch.refinenet4.resConfUnit1.conv1.weight"].any()
        assert not any(k in got for k in EXTRA)


def test_omnidata_hook_nets_match_jax(stages):
    est = stages["tenh"].estimator
    x = np.random.default_rng(3).uniform(-1, 1, (2, S, S, 3))
    x = x.astype(np.float32)
    for model, ch, params in ((est.depth_model, 1, stages["jdepth"]),
                              (est.normal_model, 3, stages["jnormal"])):
        assert model.hooks == (0, 1) and model.dtype == torch.float32
        jmodel = jdpt.DPTHybrid(num_channels=ch, image_size=S,
                                depth_layers=2, hooks=(0, 1),
                                dtype=jnp.float32)
        want = np.asarray(jax.jit(jmodel.apply)({"params": params},
                                                jnp.asarray(x)))
        with torch.no_grad():
            got = model(torch.tensor(x)).numpy()
        assert got.shape == want.shape == (2, S, S, ch)
        assert np.abs(want).max() > 1e-2
        np.testing.assert_allclose(got, want, rtol=0, atol=DPT_ATOL)


def test_passed_state_dicts_beat_the_hooks(files):
    """Weights passed in are used as they are: the hooks, here naming
    files that do not exist, are not read."""
    torch.manual_seed(5)
    vo = tdpvo.DPVONet().state_dict()
    dsd = tdpt.DPTHybrid(1, image_size=S, depth_layers=2, hooks=(0, 1),
                         dtype=torch.float32).state_dict()
    nsd = tdpt.DPTHybrid(3, image_size=S, depth_layers=2, hooks=(0, 1),
                         dtype=torch.float32).state_dict()
    args = SimpleNamespace(**ARGS)
    with pytest.MonkeyPatch.context() as mp:
        _env(mp, files, **{env: "missing" for env in HOOKS})
        track = tstages.TrackingStage(args, state_dict=vo, device="cpu")
        est = tstages.EnhancementStage(args, depth_state_dict=dsd,
                                       normal_state_dict=nsd,
                                       device="cpu").estimator
    _assert_state_dicts_equal(track.tracker.net.state_dict(), vo)
    _assert_state_dicts_equal(est.depth_model.state_dict(), dsd)
    _assert_state_dicts_equal(est.normal_model.state_dict(), nsd)


def test_normal_hook_is_read_only_with_normals(files):
    args = SimpleNamespace(**dict(ARGS, enhancement_module="depth"))
    with pytest.MonkeyPatch.context() as mp:
        _env(mp, files, NERF_VO_OMNIDATA_NORMAL_WEIGHTS="missing")
        est = tstages.EnhancementStage(args, device="cpu").estimator
    assert est.normal_model is None
    torch.testing.assert_close(
        est.depth_model.state_dict()["scratch.output_conv.4.weight"],
        files["depth"]["scratch.output_conv.4.weight"], rtol=0, atol=0)


def test_wrong_head_raises_as_in_jax(files):
    """The depth file (a 1-channel head) named as the normal checkpoint."""
    args = SimpleNamespace(**ARGS)
    with pytest.MonkeyPatch.context() as mp:
        _env(mp, files, NERF_VO_OMNIDATA_NORMAL_WEIGHTS="omnidata_depth.ckpt")
        with pytest.raises(AssertionError) as want:
            jstages.EnhancementStage(args)
        with pytest.raises(ValueError) as got:
            tstages.EnhancementStage(args, device="cpu")
    assert str(got.value) == str(want.value) == (
        "checkpoint head has 1 channels, model expects 3")


@pytest.mark.parametrize("env", HOOKS)
def test_missing_file_raises_as_in_jax(files, env):
    """A hook naming no file raises in both packages: no random weights."""
    args = SimpleNamespace(**ARGS)
    stage = ("TrackingStage" if env == "NERF_VO_DPVO_WEIGHTS"
             else "EnhancementStage")
    with pytest.MonkeyPatch.context() as mp:
        _env(mp, files, **{env: "missing"})
        with pytest.raises(FileNotFoundError):
            getattr(jstages, stage)(args)
        with pytest.raises(FileNotFoundError):
            getattr(tstages, stage)(args, device="cpu")


def test_missing_keys_raise_as_in_jax(files, tmp_path):
    """A file without a key the converter reads raises ``KeyError`` naming
    it in both packages: a DPVO update layer, and ``refinenet4``'s
    ``resConfUnit1``, which the forward never calls but JAX's converter
    reads."""
    vo = {"module." + k: v for k, v in files["dpvo"].items()
          if not k.startswith("update.gru.1.")}
    torch.save(vo, tmp_path / "dpvo.pth")
    with pytest.raises(KeyError, match="update.gru.1.gate.0") as want:
        jdpvo.load_torch_weights(str(tmp_path / "dpvo.pth"))
    with pytest.raises(KeyError, match="update.gru.1.gate.0"):
        tdpvo.load_torch_weights(str(tmp_path / "dpvo.pth"))
    assert "update.gru.1.gate.0.weight" in str(want.value)

    gone = "scratch.refinenet4.resConfUnit1.conv2.bias"
    _omnidata_file(tmp_path / "depth.ckpt",
                   {k: v for k, v in files["depth"].items() if k != gone})
    for load in (jdpt.load_torch_weights, tdpt.load_torch_weights):
        with pytest.raises(KeyError, match=gone):
            load(str(tmp_path / "depth.ckpt"), 1)
