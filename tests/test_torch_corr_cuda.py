"""The CUDA correlation kernel against its plain version, on the card.

These tests need an NVIDIA GPU and ``nvcc`` and skip elsewhere. The file
imports nothing of JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_corr_cuda.py

Tolerance: kernel and plain version both accumulate in f32, in another
order: max abs error <= 1e-3 of max |plain|. Rows the plain version zeroes
(unusable centres and slots) must be exactly zero.
"""

import pytest
import torch

from nerf_vo_tpu_torch.ops import correlation_cuda as cc


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(dev, R=4, H=24, W=40, C=128, E=300, seed=0):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    fmap = torch.randn(R, H, W, C, generator=g, device=dev).bfloat16()
    pf = torch.randn(E, 9, C, generator=g, device=dev).bfloat16()
    ring = torch.randint(0, R, (E,), generator=g, device=dev,
                         dtype=torch.int32)
    span = torch.tensor([W + 10.0, H + 10.0], device=dev)
    ctr = torch.rand(E, 2, generator=g, device=dev) * span - 5.0
    ctr[0] = float("nan")  # a NaN centre is unusable: zeros
    if E > 1:
        ring[1] = R  # an out-of-range slot: zeros
    return fmap, pf, ring, ctr


def _check(got, want):
    err = (got - want).abs().max().item()
    assert err <= 1e-3 * want.abs().max().item(), err
    zero = (want == 0).all(1)
    assert (got[zero] == 0).all()


def _half(fmap):
    f2 = torch.nn.functional.avg_pool2d(
        fmap.float().permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
    return f2.bfloat16().contiguous()


def _plain_two_level(pf, f1, f2, ring, ctr, radius):
    return torch.cat([cc.corr_level_plain(f1, pf, ring, ctr, radius),
                      cc.corr_level_plain(f2, pf, ring, ctr * 0.5, radius)],
                     1)


@pytest.mark.cuda
@pytest.mark.parametrize("radius,C", [(3, 128), (2, 128), (3, 64), (0, 8),
                                     (4, 128)])
def test_corr_level_matches_plain(dev, radius, C):
    fmap, pf, ring, ctr = _inputs(dev, C=C)
    before = cc.corr_level.launches
    got = cc.corr_level(fmap, pf, ring, ctr, radius)
    torch.cuda.synchronize()
    assert cc.corr_level.launches == before + 1
    want = cc.corr_level_plain(fmap, pf, ring, ctr, radius)
    _check(got, want)
    assert (got[:2] == 0).all()


@pytest.mark.cuda
def test_two_level_writes_column_blocks(dev):
    fmap, pf, ring, ctr = _inputs(dev, H=32, W=48)
    f2 = torch.nn.functional.avg_pool2d(
        fmap.float().permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
    f2 = f2.bfloat16().contiguous()
    before = cc.corr_two_level.launches
    got = cc.patch_correlation_kernel(pf.reshape(-1, 3, 3, 128), fmap, f2,
                                      ring, ctr, 3)
    torch.cuda.synchronize()
    assert cc.corr_two_level.launches == before + 1  # one launch an update
    want = torch.cat([cc.corr_level_plain(fmap, pf, ring, ctr, 3),
                      cc.corr_level_plain(f2, pf, ring, ctr * 0.5, 3)], 1)
    _check(got, want)


@pytest.mark.cuda
def test_wrapper_rejects_bad_inputs(dev):
    fmap, pf, ring, ctr = _inputs(dev)
    with pytest.raises(TypeError):
        cc.corr_level(fmap.float(), pf, ring, ctr)
    with pytest.raises(TypeError):
        cc.corr_level(fmap, pf, ring.long(), ctr)
    with pytest.raises(ValueError):
        cc.corr_level(fmap, pf[:, :, ::2], ring, ctr)
    with pytest.raises(ValueError):
        cc.corr_level(fmap, pf, ring, ctr.cpu())
    empty = cc.corr_level(fmap, pf[:0], ring[:0], ctr[:0])
    assert empty.shape == (0, 441)


@pytest.mark.cuda
@pytest.mark.parametrize("radius,C", [(3, 128), (2, 128), (3, 64), (0, 8),
                                     (4, 128)])
@pytest.mark.parametrize("E", [1, 301])
def test_two_level_matches_plain(dev, radius, C, E):
    """Both levels in one launch (the edges walked in target-slot order,
    sorted inside the launch) against the plain version of each; E = 1 and
    an E that is no multiple of the warps of a block or grid; every row
    must land at its caller's index."""
    fmap, pf, ring, ctr = _inputs(dev, H=32, W=48, C=C, E=E)
    if E == 1:  # a usable centre
        ctr[0] = torch.tensor([20.3, 11.7], device=dev)
    f2 = _half(fmap)
    before = cc.corr_two_level.launches
    got = cc.corr_two_level(pf, fmap, f2, ring, ctr, radius)
    torch.cuda.synchronize()
    assert cc.corr_two_level.launches == before + 1
    want = _plain_two_level(pf, fmap, f2, ring, ctr, radius)
    assert got.shape == want.shape
    _check(got, want)
    if E > 1:  # the NaN centre and the out-of-range slot
        assert (got[:2] == 0).all()
    else:
        n = got.shape[1] // 2
        assert got[0, :n].abs().max() > 0 and got[0, n:].abs().max() > 0


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["one_slot", "sorted", "reversed",
                                  "random_order"])
def test_two_level_edge_orders(dev, case):
    """All edges on one ring slot; slots sorted; slots in reverse; slots in
    random order: the launch sorts each by slot. The walk never changes a
    row: each edge's result is bitwise the one it gets when the caller
    hands the same edges over in another order (a random permutation)."""
    fmap, pf, ring, ctr = _inputs(dev, R=6, H=40, W=64, E=2000, seed=3)
    f2 = _half(fmap)
    if case == "one_slot":
        ring = torch.full_like(ring, 4)
    elif case == "sorted":
        ring = torch.sort(ring).values
    elif case == "reversed":
        ring = torch.sort(ring, descending=True).values
    g = torch.Generator(device=dev)
    g.manual_seed(9)
    perm = torch.randperm(2000, generator=g, device=dev)
    got = cc.corr_two_level(pf, fmap, f2, ring, ctr, 3)
    permuted = cc.corr_two_level(pf[perm].contiguous(), fmap, f2,
                                 ring[perm].contiguous(),
                                 ctr[perm].contiguous(), 3)
    torch.cuda.synchronize()
    _check(got, _plain_two_level(pf, fmap, f2, ring, ctr, 3))
    assert torch.equal(got[perm], permuted)


@pytest.mark.cuda
def test_two_level_rejects_bad_inputs(dev):
    fmap, pf, ring, ctr = _inputs(dev, H=32, W=48)
    f2 = _half(fmap)
    with pytest.raises(ValueError):  # C above what the kernel pads to
        wide = torch.zeros(4, 32, 48, 136, dtype=torch.bfloat16, device=dev)
        cc.corr_two_level(torch.zeros(300, 9, 136, dtype=torch.bfloat16,
                                      device=dev), wide, _half(wide), ring,
                          ctr)
    with pytest.raises(ValueError):  # level 1 with another channel count
        cc.corr_two_level(pf, fmap, f2[..., :64].contiguous(), ring, ctr)
    with pytest.raises(TypeError):
        cc.corr_two_level(pf, fmap, f2, ring.long(), ctr)
    empty = cc.corr_two_level(pf[:0], fmap, f2, ring[:0], ctr[:0])
    assert empty.shape == (0, 882)
