"""The port's SH encoding, samplers, compositing, regularizers and losses
(``nerf_vo_tpu_torch/ops/{sh,rendering,losses}.py``) against the JAX
package's.

Inputs are numpy draws from a fixed seed. The samplers get the random
uniforms JAX draws from its key: ``jax.random.uniform(key, shape)`` gives
the same bits for any [min, max), so the port's ``u - 0.5`` jitter equals
JAX's ``uniform(key, minval=-0.5, maxval=0.5)`` bit for bit.

Tolerance: f32 on both sides, 2e-6 absolute on O(1) values (the same
formulas; sums in another order). Bin edges: 1.2e-7, one ulp at 1.0 (the
port rounds i/n once; XLA:CPU evaluates jnp.linspace as i * (1/n)).
``sample_pdf``: the port looks the CDF up with ``searchsorted`` where JAX
telescopes one-hot sums; their ~1e-7 rounding is divided by the CDF step
of the bin (down to ~4e-4 where the padding alone fills it): 1e-5
(measured 2.6e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_vo_tpu.ops import losses as jL
from nerf_vo_tpu.ops import rendering as jR
from nerf_vo_tpu.ops.sh import sh_encode as j_sh
from nerf_vo_tpu_torch.ops import losses as tL
from nerf_vo_tpu_torch.ops import rendering as tR
from nerf_vo_tpu_torch.ops import rendering_cuda
from nerf_vo_tpu_torch.ops.sh import sh_encode as t_sh

ATOL = 2e-6
R, S = 64, 24


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=0,
                               atol=atol)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    d = rng.normal(size=(R, S, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    edges = np.sort(rng.uniform(0, 1, (R, S + 1)), axis=-1)
    edges[:, 0], edges[:, -1] = 0.0, 1.0
    w = rng.exponential(0.05, (R, S)).astype(np.float32)
    w[:4] = 0.0  # empty histograms: the padding carries the CDF
    t_mid = np.sort(rng.uniform(0.1, 6, (R, S)), axis=-1).astype(np.float32)
    return dict(
        dirs=d, edges=edges.astype(np.float32), w=w, t_mid=t_mid,
        dens=rng.exponential(2.0, (R, S)).astype(np.float32),
        deltas=rng.uniform(0.01, 0.3, (R, S)).astype(np.float32),
        vals=rng.uniform(0, 1, (R, S, 3)).astype(np.float32),
        bg=rng.uniform(0, 1, (R, 3)).astype(np.float32),
        rgb=rng.uniform(0, 1, (R, 3)).astype(np.float32),
        depth=np.where(rng.uniform(size=R) < 0.2, 0.0,
                       rng.uniform(0.5, 5, R)).astype(np.float32),
        n1=rng.normal(size=(R, 3)).astype(np.float32),
        n2=rng.normal(size=(R, 3)).astype(np.float32),
        mask=rng.uniform(size=R) < 0.7,
        cov=rng.uniform(0.1, 2, R).astype(np.float32),
        view=d[:, 0],
    )


@pytest.mark.parametrize("degree", [1, 2, 3, 4])
def test_sh_encode(data, degree):
    _close(t_sh(torch.tensor(data["dirs"]), degree),
           j_sh(jnp.asarray(data["dirs"]), degree))


@pytest.mark.parametrize("name", ["disparity", "linear"])
def test_spacings(data, name):
    s = data["edges"]
    t = np.asarray(jR.SPACINGS[name][0](jnp.asarray(s), 0.05, 20.0))
    _close(tR.SPACINGS[name][0](torch.tensor(s), 0.05, 20.0), t, 1e-4)
    _close(tR.SPACINGS[name][1](torch.tensor(t), 0.05, 20.0),
           jR.SPACINGS[name][1](jnp.asarray(t), 0.05, 20.0))


@pytest.mark.parametrize("stratified", [True, False])
def test_uniform_bins(stratified):
    key = jax.random.PRNGKey(3)
    want = jR.uniform_bins(key if stratified else None, R, S, stratified)
    u = (torch.tensor(np.asarray(jax.random.uniform(key, (R, S + 1))))
         if stratified else None)
    _close(tR.uniform_bins(R, S, u), want, 1.2e-7)


@pytest.mark.parametrize("stratified", [True, False])
@pytest.mark.parametrize("n", [8, 47])
def test_sample_pdf(data, stratified, n):
    key = jax.random.PRNGKey(4)
    want = jR.sample_pdf(key if stratified else None,
                         jnp.asarray(data["edges"]), jnp.asarray(data["w"]),
                         n, stratified)
    u = (torch.tensor(np.asarray(jax.random.uniform(key, (R, n + 1))))
         if stratified else None)
    w = torch.tensor(data["w"], requires_grad=True)
    got = tR.sample_pdf(torch.tensor(data["edges"]), w, n, u)
    assert not got.requires_grad  # stop-gradient
    assert (got[:, 1:] >= got[:, :-1]).all()  # monotone
    _close(got, want, 1e-5)


def test_compositing(data):
    dens, deltas = data["dens"], data["deltas"]
    wj, tj = jR.render_weights(jnp.asarray(dens), jnp.asarray(deltas))
    wt, tt = tR.render_weights(torch.tensor(dens), torch.tensor(deltas))
    _close(wt, wj)
    _close(tt, tj)
    for bg in (None, data["bg"]):
        _close(tR.composite(wt, torch.tensor(data["vals"]),
                            None if bg is None else torch.tensor(bg)),
               jR.composite(wj, jnp.asarray(data["vals"]),
                            None if bg is None else jnp.asarray(bg)))
    _close(tR.render_depth(wt, torch.tensor(data["t_mid"])),
           jR.render_depth(wj, jnp.asarray(data["t_mid"])), 1e-5)
    _close(tR.render_accumulation(wt), jR.render_accumulation(wj))


def test_regularizers(data):
    e, w = data["edges"], data["w"]
    _close(tR.distortion_loss(torch.tensor(e), torch.tensor(w)),
           jR.distortion_loss(jnp.asarray(e), jnp.asarray(w)))
    # proposal histogram on other edges than the final one
    pe = np.sort(np.random.default_rng(5).uniform(0, 1, (R, 17)), -1)
    pe[:, 0], pe[:, -1] = 0.0, 1.0
    pe = pe.astype(np.float32)
    pw = np.random.default_rng(6).exponential(0.1, (R, 16)).astype(
        np.float32)
    _close(tR._outer_bounds(torch.tensor(e), torch.tensor(pe),
                            torch.tensor(pw)),
           jR._outer_bounds(jnp.asarray(e), jnp.asarray(pe), jnp.asarray(pw)))
    _close(tR.interlevel_loss(torch.tensor(pe), torch.tensor(pw),
                              torch.tensor(e), torch.tensor(w)),
           jR.interlevel_loss(jnp.asarray(pe), jnp.asarray(pw),
                              jnp.asarray(e), jnp.asarray(w)), 1e-5)


def _interlevel_case(data, variant):
    """A proposal histogram (16 bins) against the final one (the fixture's
    24), with ``variant``'s ties: proposal edges equal to final edges
    (``<=`` and ``<`` both decide), zero-width final bins (as cummax
    leaves them), equal adjacent proposal edges, a swapped pair."""
    rng = np.random.default_rng(7)
    e = data["edges"].copy()
    pe = np.sort(rng.uniform(0, 1, (R, 17)), -1).astype(np.float32)
    pe[:, 0], pe[:, -1] = 0.0, 1.0
    pw = rng.exponential(0.1, (R, 16)).astype(np.float32)
    fw = data["w"] + np.float32(0.01)
    if variant in ("ties", "all"):
        pe[:, 3:15:3] = e[:, 5:23:5][:, :4]
        e[:, 9] = pe[:, 8]
    if variant in ("zero_width", "all"):
        e[:, 12] = e[:, 11]
        e[:, 18:20] = e[:, 17:18]
        pe[:, 6] = pe[:, 5]
    if variant in ("swapped", "all"):
        pe[:, [7, 8]] = pe[:, [8, 7]]
    return pe, pw, e, fw


INTERLEVEL_CASES = ["random", "ties", "zero_width", "swapped", "all"]


@pytest.mark.parametrize("variant", INTERLEVEL_CASES[1:])
def test_interlevel_ties(data, variant):
    """The indicator contraction keeps JAX's two prefix sets, their ties
    and no monotonicity of the edges."""
    pe, pw, e, fw = _interlevel_case(data, variant)
    _close(tR._outer_bounds(torch.tensor(e), torch.tensor(pe),
                            torch.tensor(pw)),
           jR._outer_bounds(jnp.asarray(e), jnp.asarray(pe), jnp.asarray(pw)))
    _close(tR.interlevel_loss(torch.tensor(pe), torch.tensor(pw),
                              torch.tensor(e), torch.tensor(fw)),
           jR.interlevel_loss(jnp.asarray(pe), jnp.asarray(pw),
                              jnp.asarray(e), jnp.asarray(fw)), 1e-5)


@pytest.mark.parametrize("variant", INTERLEVEL_CASES)
def test_interlevel_grad_matches_jax(data, variant):
    """d loss / d proposal weights, which the card's backward kernel
    computes, against JAX's gradient (the edges and final weights take
    none)."""
    pe, pw, e, fw = _interlevel_case(data, variant)
    want = jax.grad(lambda w: jR.interlevel_loss(
        jnp.asarray(pe), w, jnp.asarray(e), jnp.asarray(fw)))(
        jnp.asarray(pw))
    w = torch.tensor(pw, requires_grad=True)
    edges = torch.tensor(e, requires_grad=True)
    final = torch.tensor(fw, requires_grad=True)
    tR.interlevel_loss(torch.tensor(pe), w, edges, final).backward()
    assert edges.grad is None and final.grad is None
    scale = float(np.abs(np.asarray(want)).max())
    assert scale > 0
    _close(w.grad, want, 1e-5 * scale)


def _interlevel_before(pe, pw, fe, fw):
    """The interlevel loss as the port computed it on every device before
    the card got its kernels: the [R, B, K] indicator contraction."""
    fw = fw.detach()
    fe = fe.detach()
    left = (pe[..., 1:, None] <= fe[..., :-1][..., None, :]).to(torch.float32)
    right = (pe[..., :-1, None] < fe[..., 1:][..., None, :]).to(torch.float32)
    bound = (torch.einsum("rb,rbk->rk", pw, right)
             - torch.einsum("rb,rbk->rk", pw, left))
    clipped = (fw - bound).clamp(min=0.0)
    return torch.mean(clipped**2 / fw.clamp(min=1e-7))


@pytest.mark.parametrize("variant", INTERLEVEL_CASES)
def test_interlevel_cpu_bits_unchanged(data, variant, monkeypatch):
    """On CPU tensors ``interlevel_loss`` is the plain contraction: the
    same bits as before, loss and gradient, and no kernel is called or
    launched."""
    def refuse(*args):
        raise AssertionError("the CPU route called the CUDA wrapper")

    launches = rendering_cuda.interlevel_loss.launches
    monkeypatch.setattr(rendering_cuda, "interlevel_loss", refuse)
    pe, pw, e, fw = (torch.tensor(a) for a in _interlevel_case(data,
                                                               variant))
    w0 = pw.clone().requires_grad_(True)
    w1 = pw.clone().requires_grad_(True)
    got = tR.interlevel_loss(pe, w0, e, fw)
    want = _interlevel_before(pe, w1, e, fw)
    got.backward()
    want.backward()
    assert torch.equal(got, want)
    assert torch.equal(w0.grad, w1.grad)
    assert torch.equal(got, tR.interlevel_loss_plain(pe, pw, e, fw))
    monkeypatch.undo()
    assert rendering_cuda.interlevel_loss.launches == launches


def test_losses(data):
    T = {k: torch.tensor(v) for k, v in data.items()}
    J = {k: jnp.asarray(v) for k, v in data.items()}
    wt, _ = tR.render_weights(T["dens"], T["deltas"])
    wj, _ = jR.render_weights(J["dens"], J["deltas"])
    cases = [
        (tL.rgb_loss(T["bg"], T["rgb"]), jL.rgb_loss(J["bg"], J["rgb"])),
        (tL.depth_l2_loss(T["cov"], T["depth"]),
         jL.depth_l2_loss(J["cov"], J["depth"])),
        (tL.depth_l2_loss(T["cov"], T["depth"], T["cov"], T["mask"]),
         jL.depth_l2_loss(J["cov"], J["depth"], J["cov"], J["mask"])),
        (tL.monosdf_normal_loss(T["n1"], T["n2"]),
         jL.monosdf_normal_loss(J["n1"], J["n2"])),
        (tL.monosdf_normal_loss(T["n1"], T["n2"], T["mask"]),
         jL.monosdf_normal_loss(J["n1"], J["n2"], J["mask"])),
        (tL.orientation_loss(wt, T["dirs"], T["view"]),
         jL.orientation_loss(wj, J["dirs"], J["view"])),
        (tL.pred_normal_loss(wt, T["dirs"], T["dirs"].flip(1)),
         jL.pred_normal_loss(wj, J["dirs"], J["dirs"][:, ::-1])),
    ]
    for mask in (None, "mask"):
        m_t = None if mask is None else T[mask]
        m_j = None if mask is None else J[mask]
        # sigma wide enough that the likelihood is not all underflow
        cases.append((
            tL.ds_nerf_depth_loss(wt, T["t_mid"], T["deltas"], T["depth"],
                                  0.5, m_t),
            jL.ds_nerf_depth_loss(wj, J["t_mid"], J["deltas"], J["depth"],
                                  0.5, m_j)))
    for got, want in cases:
        _close(got, want, 1e-5 * max(1.0, abs(float(want))))
