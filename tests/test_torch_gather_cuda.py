"""The four CUDA table kernels (``csrc/gather.cu``) against their plain
versions, on the card.

These tests need an NVIDIA GPU and ``nvcc`` and skip elsewhere. The file
imports nothing of JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gather_cuda.py

Tolerances: ``gather_cols`` bitwise (the same bf16 rounding);
``gather_interp`` / ``gather_interp_mm`` 1e-5 of the largest |output| (f32
sums of 32 products in another order); ``scatter_cols_accum`` 1e-5 of the
largest |output| (f32 atomics in arbitrary order against a sequential
index_add_).
"""

import pytest
import torch

from nerf_vo_tpu_torch.ops import gather_cuda as gc
from nerf_vo_tpu_torch.ops import hash_grid as hg


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(dev, F, n_bricks=300, M=1001, seed=0):
    """M not a multiple of any block or tile; ids drawn from a few bricks
    so that most repeat."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    tab = torch.randn(n_bricks, 32 * F, generator=g, device=dev)
    idx = torch.randint(0, n_bricks, (M,), generator=g, device=dev,
                        dtype=torch.int32)
    idx[: M // 2] = idx[: M // 2] % 7  # heavy duplicates
    w = torch.rand(M, 32, generator=g, device=dev)
    w[:, 27:] = 0.0
    return tab, idx, w


def _close(got, want):
    err = (got - want).abs().max().item()
    assert err <= 1e-5 * max(want.abs().max().item(), 1.0), err


@pytest.mark.cuda
@pytest.mark.parametrize("F", [1, 2, 4, 8])
def test_gather_cols_bitwise(dev, F):
    tab, idx, _ = _inputs(dev, F)
    before = gc.gather_cols.launches
    got = gc.gather_cols(tab, idx)
    torch.cuda.synchronize()
    assert gc.gather_cols.launches == before + 1
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, gc.gather_cols_plain(tab, idx))


@pytest.mark.cuda
@pytest.mark.parametrize("mm", [False, True], ids=["interp", "interp_mm"])
@pytest.mark.parametrize("F", [1, 2, 4, 8])
def test_gather_interp_matches_plain(dev, F, mm):
    tab, idx, w = _inputs(dev, F)
    fn = gc.gather_interp_mm if mm else gc.gather_interp
    before = fn.launches
    got = fn(tab, idx, w, F)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    _close(got, gc.gather_interp_plain(tab, idx, w, F))
    # the two routes compute one function
    _close(got, (gc.gather_interp if mm else gc.gather_interp_mm)(
        tab, idx, w, F))


@pytest.mark.cuda
@pytest.mark.parametrize("F", [1, 8])
def test_scatter_cols_accum_matches_plain(dev, F):
    tab, idx, w = _inputs(dev, F)
    rows = torch.randn(idx.shape[0], 32 * F, device=dev)
    before = gc.scatter_cols_accum.launches
    got = gc.scatter_cols_accum(rows, idx, tab.shape[0])
    torch.cuda.synchronize()
    assert gc.scatter_cols_accum.launches == before + 1
    _close(got, gc.scatter_cols_accum_plain(rows, idx, tab.shape[0]))


@pytest.mark.cuda
def test_hash_encode_on_the_card_matches_the_cpu_route(dev):
    """Forward, table gradient and position gradient of the port's
    hash_encode through the kernels against the plain versions on the CPU
    (field geometry: level 0 one-hot route, levels 1-2 hashed)."""
    cfg = hg.HashGridConfig(3, 8, 14, 16, 64)
    g = torch.Generator().manual_seed(1)
    tab = torch.randn(3 * cfg.bricks_per_level, 256, generator=g) * 0.5
    x = torch.rand(500, 7, 3, generator=g)
    cot = torch.randn(500, 7, 24, generator=g)
    outs = []
    for d in ("cpu", dev):
        t = tab.to(d).requires_grad_(True)
        p = x.to(d).requires_grad_(True)
        out = hg.hash_encode(t, p, cfg)
        gt, gp = torch.autograd.grad(out, (t, p), cot.to(d))
        outs.append([v.detach().cpu() for v in (out, gt, gp)])
    for a, b in zip(*outs):
        _close(b, a)


@pytest.mark.cuda
def test_wrappers_reject_bad_inputs(dev):
    tab, idx, w = _inputs(dev, 8)
    with pytest.raises(TypeError):
        gc.gather_cols(tab.double(), idx)
    with pytest.raises(TypeError):
        gc.gather_interp(tab, idx.long(), w, 8)
    with pytest.raises(ValueError):
        gc.gather_interp(tab, idx, w, 4)  # R != 32F
    with pytest.raises(ValueError):
        gc.gather_interp(tab, idx, w[:, :16], 8)
    with pytest.raises(ValueError):
        gc.gather_interp(tab[:, ::2], idx, w, 4)  # not contiguous
    with pytest.raises(ValueError):
        gc.scatter_cols_accum(tab[:5], idx, 300)  # row count mismatch
    with pytest.raises(ValueError):
        gc.gather_cols(tab, idx.cpu())
    empty = gc.gather_interp(tab, idx[:0], w[:0], 8)
    assert empty.shape == (0, 8)
