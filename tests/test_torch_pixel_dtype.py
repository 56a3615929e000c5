"""``NERF_VO_PIXEL_DTYPE``: both packages read it when their
``mapping/keyframe_buffer.py`` is imported, so each case runs in a child
process with the variable set.

At ``float32`` the port's buffer stores the inserted targets exactly and
equals the JAX buffer bitwise (``tests/test_torch_mapping.py``'s inserts),
and one train step of each trainer on those buffers, from one JAX init
with the JAX step's draws, agrees within ``tests/test_torch_mapping.py``'s
tolerances (measured spread in brackets): losses relative 1e-2 [3.1e-5],
step-0 gradients relative L2 < 5e-2 [1.2e-2], parameters after the step
>= 99% of all elements within lr / 10 [99.99%], >= 80% of each leaf
[>= 99.79%], >= 99% of each leaf within 2.5 lr [100%]. Any value but
``float32`` or ``bfloat16`` raises the same ``ValueError`` in both
packages.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

TESTS = Path(__file__).resolve().parent
REPO = TESTS.parent

CHILD = """
import json
import conftest  # the suite's JAX setup: CPU devices, highest matmul precision
import jax
import numpy as np
import torch
import test_torch_mapping as tm
from nerf_vo_tpu_torch.mapping import keyframe_buffer as tkb
from nerf_vo_tpu_torch.models import nerfacto as tn
from nerf_vo_tpu.mapping.trainer import MappingTrainer as JTrainer
from nerf_vo_tpu.mapping.trainer import TrainerConfig as JTrainerConfig
from nerf_vo_tpu.models import nerfacto as jn
from nerf_vo_tpu_torch.mapping.trainer import MappingTrainer as TTrainer
from nerf_vo_tpu_torch.mapping.trainer import TrainerConfig as TTrainerConfig
from torch_parity import rel_l2, step_draws, to_numpy_tree

out = {}
jb, tb = tm._buffers()
out["dtypes"] = [str(tb.pixels.dtype), str(jb.pixels.dtype),
                 str(tkb.PIXEL_DTYPE)]
out["bitwise"] = bool(np.array_equal(tb.pixels.numpy(),
                                     np.asarray(jb.pixels)))
# the last insert of each keyframe, as tm._buffers makes them: [0, 1, 2]
# from seed 0, [3] from seed 1, then [1] from seed 2 without depth
p0, p1, p2 = tm._packet(3, 0), tm._packet(1, 1), tm._packet(1, 2)
want = {"color": np.stack([p0["color"][0], p2["color"][0], p0["color"][2],
                           p1["color"][0]]),
        "depth": np.stack([p0["depth"][0], p0["depth"][1], p0["depth"][2],
                           p1["depth"][0]]),
        "normal": np.stack([p0["normal"][0], p2["normal"][0],
                            p0["normal"][2], p1["normal"][0]])}
out["exact"] = {k: bool(np.array_equal(getattr(tb, k)[:4].numpy(), v))
                for k, v in want.items()}

jmodel = jn.NerfactoModel(jn.NerfactoConfig(**tm.CFG))
jtr = JTrainer(jmodel, JTrainerConfig(rays_per_batch=tm.RAYS), tm.K)
jstate = jtr.init(jax.random.PRNGKey(0))
params0 = to_numpy_tree(jstate.params)
tmodel = tn.NerfactoModel(tn.NerfactoConfig(**tm.CFG))
tmodel.load_state_dict(tn.from_jax_params(params0))
ttr = TTrainer(tmodel, TTrainerConfig(rays_per_batch=tm.RAYS), tm.K,
               device="cpu")
tstate = ttr.init()
key = jax.random.PRNGKey(100)
d = step_draws(key, 4, tm.H, tm.W, tm.RAYS, tm.MODEL["num_proposal_samples"],
               tm.MODEL["num_nerf_samples"])
gp, gpose = jax.jit(jax.grad(
    lambda p, q: jtr._loss_fn(p, q, jb, key, step=0)[0],
    argnums=(0, 1)))(jstate.params, jstate.pose_deltas)
batch = tkb.sample_ray_batch(tb, tstate.pose_deltas, tm.RAYS, d)
loss, _ = tmodel.loss(batch, d["uniforms"])
tgrads = torch.autograd.grad(
    loss, list(tstate.params.values()) + [tstate.pose_deltas])
gwant = tn.from_jax_params(to_numpy_tree(gp))
out["grad_rel_l2"] = {n: float(rel_l2(g.numpy(), gwant[n].numpy()))
                      for n, g in zip(tstate.params, tgrads[:-1])}
out["grad_rel_l2"]["pose_deltas"] = float(rel_l2(tgrads[-1].numpy(), gpose))

jstate, jm = jtr.train_step(jstate, jb, key)
tstate, tm_ = ttr.train_step(tstate, tb, d)
out["loss_rel"] = {k: abs(float(tm_[k]) - float(jm[k]))
                   / max(abs(float(jm[k])), 1e-30) for k in jm}
out["loss_keys"] = [sorted(jm), sorted(tm_)]
pwant = tn.from_jax_params(to_numpy_tree(jstate.params))
lr = 1e-2
out["close"], out["wide"] = {}, {}
for name, p in tstate.params.items():
    diff = np.abs(p.detach().numpy() - pwant[name].numpy())
    out["close"][name] = [int(np.sum(diff <= lr / 10)), int(diff.size)]
    out["wide"][name] = float(np.mean(diff <= 2.5 * lr))
print("RESULT " + json.dumps(out))
"""


def _child(code, value, timeout):
    env = dict(os.environ, NERF_VO_PIXEL_DTYPE=value,
               PYTHONPATH=os.pathsep.join([str(TESTS), str(REPO)]))
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=timeout)


@pytest.fixture(scope="module")
def f32():
    out = _child(CHILD, "float32", 600)
    assert out.returncode == 0, out.stderr[-4000:]
    line = [s for s in out.stdout.splitlines() if s.startswith("RESULT ")]
    return json.loads(line[-1][len("RESULT "):])


def test_f32_buffer_is_exact_and_equals_jax_bitwise(f32):
    assert f32["dtypes"] == ["torch.float32", "float32", "torch.float32"]
    assert f32["bitwise"]
    assert f32["exact"] == {"color": True, "depth": True, "normal": True}


def test_f32_train_step_matches_jax(f32):
    keys = f32["loss_keys"]
    assert keys[0] == keys[1]
    for k, rel in f32["loss_rel"].items():
        assert rel <= 1e-2, (k, rel)
    for name, rel in f32["grad_rel_l2"].items():
        assert rel < 5e-2, (name, rel)
    close = total = 0
    for name, (c, n) in f32["close"].items():
        assert c / n >= 0.8, name
        assert f32["wide"][name] >= 0.99, name
        close += c
        total += n
    assert close / total >= 0.99


@pytest.mark.parametrize("value", ["float16", "f32"])
@pytest.mark.parametrize("package", ["nerf_vo_tpu", "nerf_vo_tpu_torch"])
def test_invalid_pixel_dtype_raises(package, value):
    out = _child(f"import {package}.mapping.keyframe_buffer", value, 120)
    assert out.returncode != 0
    assert ("ValueError: NERF_VO_PIXEL_DTYPE must be 'float32' or "
            f"'bfloat16', got {value!r}") in out.stderr
