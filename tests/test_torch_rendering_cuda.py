"""The interlevel-loss kernels (``csrc/rendering.cu``) against the plain
indicator contraction (``rendering.interlevel_loss_plain``), on the card.

These tests need an NVIDIA GPU and ``nvcc`` and skip elsewhere. The file
imports nothing of JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_rendering_cuda.py

Each quantity is held elementwise within the f32 summation bound of its
own terms, ``2 gamma_(k+1) sum |term|`` (the bound on the difference of two
f32 sums of k terms in any order):

- ``clipped = max(fw - bound, 0)`` against the plain version's, its terms
  ``fw`` and the ``pw[b]`` of both prefix sets (B + 2 terms; the clamp is
  1-Lipschitz);
- the loss against the mean of ``clipped^2 / max(fw, 1e-7)`` over the
  kernel's own ``clipped`` (the terms are then the same bits, so only the
  sum's order differs);
- ``d pw`` against the two plain contractions of the per-bin derivative
  autograd forms from the kernel's ``clipped`` (K + 1 terms).

At vo.map's shapes (4096 rays; 256 and 96 proposal bins; 48 final bins)
and at odd ones, on histograms as the mapper makes them and with ties
(final edges equal to proposal edges, zero-width final bins, equal
adjacent proposal edges), a swapped pair of proposal edges, and final
weights at 0 and at and below the 1e-7 clamp. Repeated calls and a CUDA
graph's replay are bitwise the eager run; more bins than the kernels take
are refused.
"""

import pytest
import torch

from nerf_vo_tpu_torch.ops import rendering as tR
from nerf_vo_tpu_torch.ops import rendering_cuda as rc

EPS = 2.0 ** -24
VARIANTS = ("mapper", "ties", "swapped", "fw_clamp")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _histograms(dev, R, B, K, variant, seed=0):
    """A proposal histogram on jittered uniform bins and a final one
    resampled from it (monotone edges through cummax), as the mapper makes
    them, then ``variant``'s edits."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    pe = tR.uniform_bins(R, B, torch.rand(R, B + 1, generator=g, device=dev))
    pw = torch.rand(R, B, generator=g, device=dev) ** 4
    pw = pw / pw.sum(-1, keepdim=True).clamp_min(1e-12)
    fe = tR.sample_pdf(pe, pw, K, torch.rand(R, K + 1, generator=g,
                                             device=dev))
    fw = torch.rand(R, K, generator=g, device=dev) ** 4
    fw = 0.9 * fw / fw.sum(-1, keepdim=True).clamp_min(1e-12)
    pe, fe = pe.clone(), fe.clone()
    if variant == "ties":
        # final edges on proposal edges (both sides' ties), zero-width
        # final bins, equal adjacent proposal edges
        for k in range(1, K, 3):
            fe[:, k] = pe[:, min(k * B // K + 1, B)]
        fe[:, 2::5] = fe[:, 1:-1:5][:, :fe[:, 2::5].shape[1]]
        pe[:, 1::4] = pe[:, 0:-1:4][:, :pe[:, 1::4].shape[1]]
    elif variant == "swapped":
        b = B // 2
        pe[:, [b, b + 1]] = pe[:, [b + 1, b]]
        if B > 1:
            pe[::2, [1, 2]] = pe[::2, [2, 1]]
    elif variant == "fw_clamp":
        fw[:, 0::4] = 0.0
        fw[:, 1::4] = 1e-7
        fw[:, 2::8] = 3e-9
    return pe.contiguous(), pw.contiguous(), fe.contiguous(), fw.contiguous()


def _indicators(pe, fe):
    """The plain version's two [R, B, K] indicator sets, f32."""
    left = (pe[:, 1:, None] <= fe[:, None, :-1]).float()
    right = (pe[:, :-1, None] < fe[:, None, 1:]).float()
    return left, right


def _bound(abs_sum, terms):
    """2 gamma_(terms+1) abs_sum: how far two f32 sums of ``terms`` terms
    whose absolute values sum to ``abs_sum`` may differ."""
    k = torch.as_tensor(terms, dtype=torch.float32) + 1
    return 2 * k * EPS / (1 - k * EPS) * abs_sum


def _within(name, got, want, bound):
    diff = (got - want).abs()
    assert torch.isfinite(got).all(), name
    bad = diff > bound
    assert not bad.any(), (
        f"{name}: {int(bad.sum())} elements past their bound, max abs err "
        f"{diff.max().item():.3e}")


def _check(pe, pw, fe, fw):
    R, B = pw.shape
    K = fw.shape[1]
    before = rc.interlevel_loss.launches
    part, clipped = rc._forward(pe, pw, fe, fw)
    left, right = _indicators(pe, fe)
    fwc = fw.clamp(min=1e-7)
    # clipped against the plain version's max(fw - bound, 0)
    want = (fw - tR._outer_bounds(fe, pe, pw)).clamp(min=0.0)
    abs_sum = fw.abs() + torch.einsum("rb,rbk->rk", pw.abs(), left + right)
    _within("clipped", clipped, want, _bound(abs_sum, B + 2))
    # the loss: the same terms, summed in another order
    terms = clipped ** 2 / fwc
    loss = torch.sum(part) / (R * K)
    _within("loss", loss, torch.mean(terms),
            _bound(terms.abs().sum() / (R * K), R * K))
    # d pw: the per-bin derivative autograd forms, contracted plainly
    gpart = torch.full((R,), 1.0 / (R * K), device=pw.device)
    dpw = rc._backward(pe, fe, fw, clipped, gpart)
    g = -((gpart[:, None] / fwc) * (2.0 * clipped))
    want = (torch.einsum("rk,rbk->rb", g, right)
            - torch.einsum("rk,rbk->rb", g, left))
    _within("d pw", dpw, want, _bound(
        torch.einsum("rk,rbk->rb", g.abs(), left + right), K + 1))
    assert rc.interlevel_loss.launches == before + 2


SHAPES = [(4096, 256, 48), (4096, 96, 48), (37, 1, 1), (33, 1024, 1024),
          (5, 70, 130)]


@pytest.mark.cuda
@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("shape", SHAPES,
                         ids=["vo.map-p0", "vo.map-p1", "one-bin", "most",
                              "odd"])
def test_interlevel_matches_plain(dev, shape, variant):
    _check(*_histograms(dev, *shape, variant))


@pytest.mark.cuda
@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("B", [256, 96])
def test_interlevel_loss_and_grad_through_rendering(dev, B, variant):
    """``rendering.interlevel_loss`` on CUDA tensors launches the kernels
    (forward and backward) and gives the plain version's loss and gradient
    at vo.map's shapes, within the plain version's rounding carried
    through: each ``bound`` within the summation bound of its terms, so
    ``clipped`` within ``dc``, each loss term within ``(2 c + dc) dc /
    max(fw, 1e-7)`` and each bin's derivative within ``2 dc / max(fw,
    1e-7) / (R K)`` (a cancelling ``hi - lo`` over a final weight near the
    clamp moves it most), plus the final sums' bounds."""
    pe, pw, fe, fw = _histograms(dev, 4096, B, 48, variant, seed=1)
    R, K = fw.shape
    n = R * K
    w = pw.clone().requires_grad_(True)
    before = rc.interlevel_loss.launches
    loss = tR.interlevel_loss(pe, w, fe, fw)
    (grad,) = torch.autograd.grad(loss, w)
    assert rc.interlevel_loss.launches == before + 2
    w0 = pw.clone().requires_grad_(True)
    want = tR.interlevel_loss_plain(pe, w0, fe, fw)
    (want_grad,) = torch.autograd.grad(want, w0)

    left, right = _indicators(pe, fe)
    both = left + right
    fwc = fw.clamp(min=1e-7)
    c = (fw - tR._outer_bounds(fe, pe, pw)).clamp(min=0.0)
    dc = _bound(fw.abs() + torch.einsum("rb,rbk->rk", pw.abs(), both),
                B + 2)
    terms = c ** 2 / fwc
    dterm = (2 * c + dc) * dc / fwc + 4 * EPS * terms
    _within("loss", loss, want,
            dterm.sum() / n + _bound(terms.sum() / n, n + 2))
    g = 2 * c / fwc / n
    dg = 2 * dc / fwc / n + 4 * EPS * g
    _within("d pw", grad, want_grad,
            torch.einsum("rk,rbk->rb", dg, both)
            + _bound(torch.einsum("rk,rbk->rb", g, both), K + 2))


@pytest.mark.cuda
def test_interlevel_repeats_bitwise(dev):
    pe, pw, fe, fw = _histograms(dev, 4096, 256, 48, "ties", seed=2)
    w = pw.clone().requires_grad_(True)
    runs = []
    for _ in range(3):
        loss = rc.interlevel_loss(pe, w, fe, fw)
        (grad,) = torch.autograd.grad(loss, w)
        runs.append((loss, grad))
    for loss, grad in runs[1:]:
        assert torch.equal(loss, runs[0][0])
        assert torch.equal(grad, runs[0][1])


@pytest.mark.cuda
def test_interlevel_graph_replay_bitwise(dev):
    """Forward and backward captured in one CUDA graph (as the mapping
    step's graphs capture them): the capture counts both launches, a
    replay none, and the replay's loss and gradient are the eager run's
    bits, on the captured inputs and on new values copied into them."""
    pe, pw, fe, fw = _histograms(dev, 4096, 96, 48, "mapper", seed=3)
    w = pw.clone().requires_grad_(True)

    def run():
        loss = rc.interlevel_loss(pe, w, fe, fw)
        (grad,) = torch.autograd.grad(loss, w)
        return loss, grad

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        eager = run()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = rc.interlevel_loss.launches
    with torch.cuda.graph(graph):
        static = run()
    assert rc.interlevel_loss.launches == before + 2
    graph.replay()
    torch.cuda.synchronize()
    assert rc.interlevel_loss.launches == before + 2
    assert torch.equal(static[0], eager[0])
    assert torch.equal(static[1], eager[1])
    new = _histograms(dev, 4096, 96, 48, "ties", seed=4)
    for t, v in zip((pe, w, fe, fw), new):
        with torch.no_grad():
            t.copy_(v)
    graph.replay()
    want = run()
    torch.cuda.synchronize()
    assert torch.equal(static[0], want[0])
    assert torch.equal(static[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("B,K", [(rc.MAX_BINS + 1, 48),
                                 (96, rc.MAX_BINS + 1)])
def test_interlevel_refuses_too_many_bins(dev, B, K):
    pe, pw, fe, fw = _histograms(dev, 4, B, K, "mapper")
    with pytest.raises(ValueError, match="at most"):
        rc.interlevel_loss(pe, pw, fe, fw)
    with pytest.raises(ValueError, match="at most"):
        tR.interlevel_loss(pe, pw, fe, fw)
