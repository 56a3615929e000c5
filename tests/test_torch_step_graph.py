"""The mapping step as CUDA graphs between the table kernels
(``mapping/step_graph.py``, ``MappingTrainer.train_step``).

On the CPU: the table wrappers' ``out=`` (the plain versions' values in the
given tensor; a wrong shape or dtype refused), the rule that decides when a
step is graphed (``MappingTrainer.eager_reason``: never on the CPU; a
parallel share of the batch, draws beyond the picks, uniforms and an
occupancy refresh's jitter, prefetch, phased table gradients and a first
step stay eager), the
occupancy refresh in place, and the span names a capture keeps per thread.

On the card (skipped elsewhere; the file imports nothing of JAX, so it
also runs where JAX is not installed:
``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_step_graph.py``): two trainers from one seed and one
keyframe buffer, one stepped through ``gradients`` + ``update`` (eager),
the other through ``train_step`` (eager at step 0, captured at step 1,
replayed after), given the same draws for 16 steps. A whole mapping step
repeats bitwise on the card (the table kernels sum in a fixed order and
add no atomics), and a replay launches the same kernels on the same
inputs, so every loss term, leaf and pose correction must be bitwise the
eager trainer's. Each table kernel's launch counter advances as much in a
replayed step as in an eager one; a wrapper installed on
``gather_cuda.gather_interp`` / ``scatter_cols_outer`` after the capture
sees each replayed call with its inputs' shapes; a new keyframe buffer
makes the trainer capture again.
"""

import threading

import numpy as np
import pytest
import torch

from nerf_vo_tpu_torch.mapping import keyframe_buffer as kb
from nerf_vo_tpu_torch.mapping.trainer import MappingTrainer, TrainerConfig
from nerf_vo_tpu_torch.models.nerfacto import NerfactoConfig, NerfactoModel
from nerf_vo_tpu_torch.ops import gather_cuda as gc
from nerf_vo_tpu_torch.ops import occupancy as O
from nerf_vo_tpu_torch.runtime import perf

H, W, K = 24, 32, 6
# vo.map's mapper (hash proposals trained by the interlevel loss, normals
# at every final sample) cut to a few samples a ray and small tables
NERFSTUDIO = dict(num_grid_levels=4, grid_features_per_level=2,
                  log2_hashmap_size=12, max_res=128, proposal_type="hash",
                  proposal_training="interlevel", grad_normal_mode="samples",
                  num_proposal_samples=(16, 8), num_nerf_samples=8,
                  near=0.05, far=20.0, num_images=K, aabb_min=-4.0,
                  aabb_max=4.0)


def _packet(n, seed):
    """n keyframes along a short arc, smooth colours, depth 1.5-3.5 m."""
    rng = np.random.default_rng(seed)
    c2w = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    ang = rng.uniform(-0.2, 0.2, n)
    c2w[:, 0, 0], c2w[:, 0, 2] = np.cos(ang), np.sin(ang)
    c2w[:, 2, 0], c2w[:, 2, 2] = -np.sin(ang), np.cos(ang)
    c2w[:, :3, 3] = rng.normal(0, 0.3, (n, 3))
    yy, xx = np.meshgrid(np.linspace(0, 1, H), np.linspace(0, 1, W),
                         indexing="ij")
    color = np.clip(rng.uniform(0.1, 0.9, (n, 1, 1, 3))
                    + 0.3 * np.sin(6 * xx + 4 * yy)[None, ..., None], 0, 1)
    depth = 2.5 + np.cos(3 * xx - yy)[None] * rng.uniform(0.5, 1, (n, 1, 1))
    nrm = rng.normal(size=(n, H, W, 3)) + [0, 0, 3.0]
    return {"intrinsics": torch.tensor([[20.0, 20.0, W / 2, H / 2]]).repeat(
                n, 1),
            "c2w": torch.tensor(c2w),
            "color": torch.tensor(color, dtype=torch.float32),
            "depth": torch.tensor(depth, dtype=torch.float32),
            "normal": torch.tensor(nrm / np.linalg.norm(nrm, axis=-1,
                                                        keepdims=True),
                                   dtype=torch.float32)}


def _buffer(dev):
    buf = kb.create(K, H, W, device=dev)
    kb.insert(buf, list(range(K)), _packet(K, 0))
    return buf


def _trainer(dev, rays=64, **overrides):
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(3)
        model = NerfactoModel(NerfactoConfig(**{**NERFSTUDIO, **overrides}))
    cfg = TrainerConfig(rays_per_batch=rays, max_iterations=64,
                        prefetch_batch=False)
    tr = MappingTrainer(model, cfg, num_keyframes=K, device=dev)
    return tr, tr.init()


def _draws(tr, step, rays, dev):
    """A step's draws from their own seed (the same for any trainer)."""
    g = torch.Generator(device=dev)
    g.manual_seed(1000 + step)
    kw = dict(generator=g, device=dev)
    return {"frame": torch.randint(0, K, (rays,), **kw),
            "py": torch.randint(0, H, (rays,), **kw),
            "px": torch.randint(0, W, (rays,), **kw),
            "uniforms": [torch.rand(s, **kw)
                         for s in tr.model.uniform_shapes(rays)]}


# ---------------------------------------------------------------------------
# the CPU
# ---------------------------------------------------------------------------

def _wrapper_calls(F=2, M=37, n_bricks=11):
    g = torch.Generator().manual_seed(F)
    tab = torch.randn(n_bricks, 32 * F, generator=g)
    idx = torch.randint(0, n_bricks, (M,), generator=g, dtype=torch.int32)
    w = torch.rand(M, 32, generator=g)
    cot = torch.randn(M, F, generator=g)
    local = torch.randint(0, 2, (M, 3), generator=g)
    frac = torch.rand(M, 3, generator=g)
    return {
        "gather_interp": ((tab, idx, w, F), {}, (M, F)),
        "gather_interp_bf16": ((tab.bfloat16(), idx, w, F), {}, (M, F)),
        "gather_interp_mm": ((tab, idx, w, F), {"hot_rows": 4}, (M, F)),
        "scatter_cols_outer": ((w, cot, idx, n_bricks), {},
                               (n_bricks, 32 * F)),
        "gather_cols_dfrac": ((tab, idx, cot, local, frac, [0, 5], (16, 32)),
                              {}, (M, 3)),
    }


@pytest.mark.parametrize("name", sorted(_wrapper_calls()))
def test_out_takes_the_plain_result(name):
    args, kw, shape = _wrapper_calls()[name]
    fn = getattr(gc, name)
    want = fn(*args, **kw)
    out = torch.full(shape, float("nan"))
    got = fn(*args, out=out, **kw)
    assert got is out
    assert torch.equal(out, want)
    with pytest.raises(ValueError, match="shape"):
        fn(*args, out=torch.empty(shape[0] + 1, shape[1]), **kw)
    with pytest.raises(TypeError, match="dtype"):
        fn(*args, out=torch.empty(shape, dtype=torch.float64), **kw)


def test_cpu_steps_are_eager():
    dev = torch.device("cpu")
    buf = _buffer(dev)
    tr, st = _trainer(dev)
    for _ in range(3):
        tr.train_step(st, buf)
    assert (tr.captures, tr.replays, tr.eager_steps) == (0, 0, 3)
    assert tr.eager_reason(st, _draws(tr, 3, 64, dev)) == "device"


@pytest.mark.parametrize("case, reason", [
    ("n_rays", "n_rays"), ("occ_jitter", "draws"),
    ("distill_points", "draws"), ("prefetch", "prefetch"),
    ("grad_phase", "grad_phase"), ("first_step", "first_step"),
    ("occupancy", "device")])
def test_when_a_step_stays_eager(case, reason):
    """``occupancy``: a refresh's jitter where the state has an occupancy
    grid is graphed (with no grid, ``occ_jitter``, it is not)."""
    dev = torch.device("cpu")
    buf = _buffer(dev)
    over = {"table_grad_phase": True} if case == "grad_phase" else {}
    if case == "occupancy":
        over = dict(sampler="occupancy", spacing="linear",
                    use_contraction=False, proposal_training="distill",
                    occupancy=O.OccupancyConfig(resolution=16, slab_div=4))
    tr, st = _trainer(dev, **over)
    if case == "prefetch":
        tr.config = TrainerConfig(rays_per_batch=64, max_iterations=64,
                                  prefetch_batch=True)
    d = _draws(tr, 0, 64, dev)
    if case == "occupancy":  # step 0 refreshes the grid
        d["occ_jitter"] = torch.rand(O.slab_size(tr.model.config.occupancy),
                                     3)
    if case != "first_step":
        tr.gradients(st, buf, d)
        tr.update(st, d)
    if case in ("occ_jitter", "distill_points", "occupancy"):
        d["occ_jitter" if case == "occupancy" else case] = torch.rand(8, 3)
    n_rays = 32 if case == "n_rays" else None
    assert tr.eager_reason(st, d, n_rays=n_rays) == reason


def test_occupancy_refresh_writes_the_grid_in_place():
    dev = torch.device("cpu")
    occ = O.OccupancyConfig(resolution=16, update_every=1, slab_div=4)
    tr, st = _trainer(dev, sampler="occupancy", spacing="linear",
                      use_contraction=False, proposal_training="distill",
                      occupancy=occ)
    buf = _buffer(dev)
    grid = st.occ_grid
    before = grid.clone()
    tr.train_step(st, buf)
    assert st.occ_grid is grid and not torch.equal(grid, before)


def test_tracked_spans_are_per_thread():
    seen = {}

    def inner():
        with perf.span("hash.backward"):
            seen["autograd"] = perf.open_spans()

    with perf.tracking():
        with perf.span("map.forward"), perf.span("hash.encode"):
            seen["main"] = perf.open_spans()
            t = threading.Thread(target=inner)
            t.start()
            t.join()
    assert seen == {"main": ("map.forward", "hash.encode"),
                    "autograd": ("hash.backward",)}
    assert perf.open_spans() == ()
    with perf.span("map.forward"):
        assert perf.open_spans() == ()  # kept only while tracking


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs and the table kernels "
                    "have no CPU mode")
    return torch.device("cuda")


def _launches():
    return {k.__name__: k.launches for k in gc.KERNELS}


def _leaves(tr, st):
    return [p.detach().clone() for p in tr.leaves(st)]


@pytest.mark.cuda
def test_replayed_steps_are_the_eager_steps(card):
    rays = 256
    buf = _buffer(card)
    eager, est = _trainer(card, rays)
    graphed, gst = _trainer(card, rays)
    per_step = []
    for step in range(16):
        d = _draws(eager, step, rays, card)
        before = _launches()
        m_e = eager.gradients(est, buf, d)
        eager.update(est, d)
        mid = _launches()
        _, m_g = graphed.train_step(gst, buf, d)
        torch.cuda.synchronize()
        after = _launches()
        per_step.append(({k: mid[k] - before[k] for k in mid},
                         {k: after[k] - mid[k] for k in mid}))
        assert list(m_g) == list(m_e)
        for k in m_e:
            assert torch.equal(m_g[k], m_e[k]), (step, k)
        for a, b in zip(_leaves(eager, est), _leaves(graphed, gst)):
            assert torch.equal(a, b), step
        assert est.step == gst.step == step + 1
    assert (graphed.eager_steps, graphed.captures, graphed.replays) == (
        1, 1, 14)
    assert eager.captures == eager.replays == 0
    for e, g in per_step:
        assert e == g and e["scatter_cols_outer"] == 3


@pytest.mark.cuda
def test_hooks_after_the_capture_see_every_replayed_call(card):
    rays = 256
    buf = _buffer(card)
    tr, st = _trainer(card, rays)
    for step in range(2):  # eager, then captured
        tr.train_step(st, buf, _draws(tr, step, rays, card))
    assert tr.captures == 1

    def record(step):
        calls = []
        saved = {k: getattr(gc, k) for k in ("gather_interp",
                                             "scatter_cols_outer")}

        def hook(name, fn):
            def wrapped(*a, **kw):
                calls.append((name, [tuple(x.shape) for x in a
                                     if torch.is_tensor(x)]))
                return fn(*a, **kw)
            wrapped.launches = 0
            return wrapped
        for k, fn in saved.items():
            setattr(gc, k, hook(k, fn))
        try:
            step()
        finally:
            for k, fn in saved.items():
                fn.launches += getattr(gc, k).launches
                setattr(gc, k, fn)
        return calls

    d = _draws(tr, 2, rays, card)
    replayed = record(lambda: tr.train_step(st, buf, d))
    assert tr.replays == 1
    eager = record(lambda: (tr.gradients(st, buf, d), tr.update(st, d)))
    assert replayed == eager
    assert [n for n, _ in eager].count("scatter_cols_outer") == 3


@pytest.mark.cuda
def test_a_new_keyframe_buffer_is_captured_again(card):
    rays = 256
    buf = _buffer(card)
    tr, st = _trainer(card, rays)
    for step in range(3):
        tr.train_step(st, buf, _draws(tr, step, rays, card))
    kb.insert(buf, [2], _packet(1, 5))  # in place: the graphs hold
    tr.train_step(st, buf)
    assert (tr.captures, tr.replays) == (1, 2)
    fresh = _buffer(card)
    tr.train_step(st, fresh)
    tr.train_step(st, fresh)
    assert (tr.captures, tr.replays, tr.eager_steps) == (2, 3, 1)
