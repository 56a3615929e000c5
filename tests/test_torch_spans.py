"""The port's spans (``runtime/perf.py``): named ranges of the program's
work that open only under a profiler.

With no profiler a mapping step makes no ``record_function`` and its
results are bitwise a profiled step's; under ``torch.profiler`` a step is
its parts in order (sample, forward with the model's proposal / field /
loss passes and the hash grid's encodes, backward with the hash grid's
backward, optimizer). The kernels' libraries link the CUDA runtime
dynamically, under a name that changes with the compiler's flags, and a
build warns where PyTorch's runtime is older than the compiler. Imports
no JAX.
"""

from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from nerf_vo_tpu_torch.ops import cuda_build
from nerf_vo_tpu_torch.runtime import perf
from nerf_vo_tpu_torch.runtime import stages as tstages

K, H, W, RAYS = 4, 16, 24, 64
MAPPER = dict(  # nerfacto's layout (vo.map's) at a tiny size
    num_grid_levels=4, grid_features_per_level=2, log2_hashmap_size=12,
    max_res=64, proposal_type="hash", proposal_training="interlevel",
    num_proposal_samples=[16, 8], num_nerf_samples=8,
    grad_normal_mode="samples")


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stage():
    """A mapping stage over K random keyframes, the stream ended."""
    args = SimpleNamespace(
        num_keyframes=K, frame_height=H, frame_width=W,
        mapping_iterations=16, rays_per_batch=RAYS,
        enhancement_module="depth", mapping_module="nerfstudio",
        mapping_model_overrides=MAPPER)
    stage = tstages.MappingStage(args, device="cpu")
    g = torch.Generator().manual_seed(0)
    c2w = torch.eye(4).repeat(K, 1, 1)
    c2w[:, 0, 3] = torch.arange(K) * 0.05
    stage.update({
        "camera_extrinsics": c2w,
        "camera_intrinsics": torch.tensor([[20.0, 20.0, W / 2, H / 2]]
                                          ).repeat(K, 1),
        "frames_color_float": torch.rand(K, H, W, 3, generator=g),
        "frames_depth": 1.0 + torch.rand(K, H, W, generator=g)})
    stage.stream_active = False
    return stage


def _spans(prof):
    """The program's spans: (name without the prefix, start, end,
    thread), in the order they began."""
    out = [(e.name[len(perf.PREFIX):], e.time_range.start,
            e.time_range.end, e.thread) for e in prof.events()
           if e.name.startswith(perf.PREFIX)]
    return sorted(out, key=lambda s: (s[1], -s[2]))


def _children(spans, parent):
    """The names of the spans directly inside ``parent``, in order."""
    _, a, b, th = parent
    inside = [s for s in spans if s is not parent and s[3] == th
              and a <= s[1] and s[2] <= b]
    return [s[0] for s in inside
            if not any(o is not s and o[1] <= s[1] and s[2] <= o[2]
                       and (o[1], -o[2]) < (s[1], -s[2]) for o in inside)]


def test_no_profiler_makes_no_record_function(monkeypatch):
    calls = []

    def counted(name):
        calls.append(name)
        return torch.profiler.record_function(name)

    monkeypatch.setattr(perf, "record_function", counted)
    stage = _stage()
    for _ in range(2):
        stage.train_step()
    assert calls == []
    with profile(activities=[ProfilerActivity.CPU]):
        stage.train_step()
    assert "nerf_vo.map.sample" in calls and "nerf_vo.map.backward" in calls


def test_a_step_is_one_tree_of_spans():
    stage = _stage()
    stage.train_step()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        stage.train_step()
        stage.train_step()
    assert stage.state.step == 3
    spans = _spans(prof)
    main = spans[0][3]
    top = [s for s in spans if s[3] == main
           and not any(o is not s and o[3] == main and o[1] <= s[1]
                       and s[2] <= o[2] and (o[1], -o[2]) < (s[1], -s[2])
                       for o in spans)]
    # each step: the draws, then the ray batch, the loss, its gradient and
    # the update
    parts = ["map.sample", "map.sample", "map.forward", "map.backward",
             "map.optimizer"]
    assert [s[0] for s in top] == parts * 2
    for step in (top[:5], top[5:]):
        fwd, back = step[2], step[3]
        # compositing in the render, then the loss terms
        assert _children(spans, fwd) == [
            "map.proposal", "map.proposal", "map.field", "map.loss",
            "map.loss"]
        # autograd's thread runs the hash grid's backward while the
        # training thread waits in map.backward
        inside = [s for s in spans if s[0] == "hash.backward"
                  and back[1] <= s[1] and s[2] <= back[2]]
        assert inside and all(_children(spans, s) == [] for s in inside)
        for p in [s for s in spans if s[0] == "map.proposal"
                  and fwd[1] <= s[1] and s[2] <= fwd[2]]:
            assert _children(spans, p) == ["hash.encode"]
        field = _children(spans, next(
            s for s in spans if s[0] == "map.field"
            and fwd[1] <= s[1] and s[2] <= fwd[2]))
        assert field and set(field) == {"hash.encode"}


def _run_steps(stage, n):
    """n steps through the trainer's parts: each step's loss terms, the
    gradients they left in the leaves, then the parameters."""
    tr, st = stage.trainer, stage.state
    out = []
    for _ in range(n):
        draws = tr.draws(stage.buffer, st)
        metrics = tr.gradients(st, stage.buffer, draws)
        grads = [p.grad.clone() for p in tr.leaves(st)]
        tr.update(st, draws)
        out.append((metrics, grads))
    return out, [p.detach().clone() for p in tr.leaves(st)]


def test_profiled_steps_are_bitwise_the_unprofiled():
    plain = _run_steps(_stage(), 2)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        profiled = _run_steps(_stage(), 2)
    assert any(s[0] == "map.forward" for s in _spans(prof))
    for (m0, g0), (m1, g1) in zip(plain[0], profiled[0]):
        assert m0.keys() == m1.keys()
        assert all(torch.equal(m0[k], m1[k]) for k in m0)
        assert all(torch.equal(a, b) for a, b in zip(g0, g1))
    assert all(torch.equal(a, b) for a, b in zip(plain[1], profiled[1]))


def test_kernels_link_the_shared_cuda_runtime(monkeypatch):
    monkeypatch.setattr(cuda_build, "_nvcc", lambda: "nvcc")
    cmd = cuda_build._command("gather", cuda_build.library_path("gather"))
    i = cmd.index("-cudart")
    assert cmd[i + 1] == "shared"
    assert cmd[cmd.index("-o") + 1] == str(cuda_build.library_path("gather"))
    before = cuda_build.library_path("gather")
    monkeypatch.setattr(cuda_build, "FLAGS",
                        tuple(f for f in cuda_build.FLAGS
                              if f not in ("-cudart", "shared")))
    after = cuda_build.library_path("gather")
    assert after != before and after.parent == before.parent
    assert after.name.startswith("libgather-")


NVCC = ("nvcc: NVIDIA (R) Cuda compiler driver\n"
        "Cuda compilation tools, release 12.9, V12.9.86\n")


@pytest.mark.parametrize("runtime, warns", [
    ("12.8", True), ("12.9", False), ("13.0", False), (None, False)])
def test_a_build_warns_when_the_runtime_is_older(runtime, warns):
    message = cuda_build.runtime_warning(NVCC, runtime)
    assert (message is not None) == warns
    if warns:
        assert "nvcc 12.9" in message and "runtime 12.8" in message
