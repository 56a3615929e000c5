"""The CUDA table kernels (``csrc/gather.cu``) against their plain
versions, on the card.

These tests need an NVIDIA GPU and ``nvcc`` and skip elsewhere. The file
imports nothing of JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gather_cuda.py

Tolerances: ``gather_cols`` bitwise (the same bf16 rounding);
``gather_interp`` / ``gather_interp_mm`` 1e-5 of the largest |output| (f32
sums of 32 products in another order); ``gather_interp`` on a bf16 table
bitwise the f32 kernel's result on the same values in f32; ``scatter_cols_accum`` 1e-5 of the
largest |output| (f32 atomics in arbitrary order against a sequential
index_add_). ``gather_interp_mm`` and ``scatter_cols_accum`` run both with
leading rows kept on chip (``hot_rows``) and without; ids out of
``[0, n_bricks)`` are held against a reference that reads zeros for them
(gather) or drops them (scatter). The scatter's id patterns (runs of equal
ids, which the F <= 2 kernel sums in registers) are held elementwise
within the f32 summation bound of each brick's terms. The fused adjoints
of ``gather_interp``: ``gather_cols_dot`` elementwise within the f32
summation bound of its F terms, ``scatter_cols_outer`` within that of
each brick's terms (its rows ``W (x) cot`` formed in registers) and
bitwise the same over two calls (it adds no atomics).
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


def _interp_ref(tab, idx, w, F):
    """The plain version, with zeros for ids outside [0, n_bricks)."""
    ok = (idx >= 0) & (idx < tab.shape[0])
    safe = torch.where(ok, idx, torch.zeros_like(idx))
    return gc.gather_interp_plain(tab, safe, w, F) * ok[:, None]


def _scatter_ref(rows, idx, n_bricks):
    """The plain version, dropping ids outside [0, n_bricks)."""
    ok = (idx >= 0) & (idx < n_bricks)
    return gc.scatter_cols_accum_plain(rows[ok], idx[ok], n_bricks)


def _mm_staged(tab, idx, w, F):
    return gc.gather_interp_mm(tab, idx, w, F, hot_rows=64)


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
@pytest.mark.parametrize("mm", [False, True, "staged"],
                         ids=["interp", "interp_mm", "interp_mm_staged"])
@pytest.mark.parametrize("F", [1, 2, 4, 8])
def test_gather_interp_matches_plain(dev, F, mm):
    """interp_mm_staged keeps the first 64 of the 300 rows on chip, so the
    ids fall on both sides of the staged rows."""
    tab, idx, w = _inputs(dev, F)
    fn = {False: gc.gather_interp, True: gc.gather_interp_mm,
          "staged": _mm_staged}[mm]
    counter = gc.gather_interp if mm is False else gc.gather_interp_mm
    before = counter.launches
    got = fn(tab, idx, w, F)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    _close(got, gc.gather_interp_plain(tab, idx, w, F))
    # the two routes compute one function
    _close(got, (gc.gather_interp_mm if mm is False else gc.gather_interp)(
        tab, idx, w, F))


@pytest.mark.cuda
@pytest.mark.parametrize("F", [1, 2, 4, 8])
def test_gather_interp_on_trilinear_descriptors(dev, F):
    """The hash grid's own descriptors (at most 8 live entries a row: the
    corners of the point's cell), which the kernel reads alone."""
    cfg = hg.HashGridConfig(2, F, 14, 16, 64)
    g = torch.Generator(device=dev)
    g.manual_seed(8)
    tab = torch.randn(2 * cfg.bricks_per_level, 32 * F, generator=g,
                      device=dev)
    x = torch.rand(5001, 3, generator=g, device=dev)
    idx, _, _, w, _ = hg._descriptors(x, cfg)
    assert int((w != 0).sum(1).max()) <= 8
    want = gc.gather_interp_plain(tab, idx, w, F)
    _close(gc.gather_interp(tab, idx, w, F), want)


@pytest.mark.cuda
@pytest.mark.parametrize("weights", ["dense", "padding_only"])
@pytest.mark.parametrize("F", [1, 2, 4, 8])
def test_gather_interp_weight_patterns(dev, F, weights):
    """All 32 weights non-zero, and only the padding entries 27..31
    non-zero: the live-entry skip depends on the data alone. Ids out of
    range read zeros."""
    tab, idx, w = _inputs(dev, F)
    g = torch.Generator(device=dev)
    g.manual_seed(10)
    idx = torch.randint(-50, 350, idx.shape, generator=g, device=dev,
                        dtype=torch.int32)
    w = torch.rand(w.shape, generator=g, device=dev) + 0.25
    if weights == "padding_only":
        w[:, :27] = 0.0
    got = gc.gather_interp(tab, idx, w, F)
    torch.cuda.synchronize()
    want = _interp_ref(tab, idx, w, F)
    _close(got, want)
    ok = (idx >= 0) & (idx < tab.shape[0])
    assert not got[~ok].any()
    assert got[ok].abs().max() > 0


@pytest.mark.cuda
@pytest.mark.parametrize("F", [1, 2, 4, 8])
def test_scatter_cols_accum_matches_plain(dev, F):
    """With no rows on chip, and with the first 64 of 300 accumulated in
    shared memory."""
    tab, idx, w = _inputs(dev, F)
    rows = torch.randn(idx.shape[0], 32 * F, device=dev)
    want = gc.scatter_cols_accum_plain(rows, idx, tab.shape[0])
    for hot in (0, 64):
        before = gc.scatter_cols_accum.launches
        got = gc.scatter_cols_accum(rows, idx, tab.shape[0], hot_rows=hot)
        torch.cuda.synchronize()
        assert gc.scatter_cols_accum.launches == before + 1
        _close(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("hot", [0, 512])
def test_scatter_cols_accum_level0_contention(dev, hot):
    """The field's level 0: 512 bricks, 196,608 descriptors (~384 a
    brick), F = 8."""
    g = torch.Generator(device=dev)
    g.manual_seed(4)
    idx = torch.randint(0, 512, (196608,), generator=g, device=dev,
                        dtype=torch.int32)
    rows = torch.randn(196608, 256, generator=g, device=dev)
    got = gc.scatter_cols_accum(rows, idx, 512, hot_rows=hot)
    torch.cuda.synchronize()
    _close(got, gc.scatter_cols_accum_plain(rows, idx, 512))


@pytest.mark.cuda
@pytest.mark.parametrize("brick", [5, 700], ids=["hot", "beyond_hot"])
def test_every_id_on_one_brick(dev, brick):
    """4096 descriptors on one brick of a 1024-row table whose first 512
    rows are kept on chip."""
    g = torch.Generator(device=dev)
    g.manual_seed(5)
    tab = torch.randn(1024, 256, generator=g, device=dev)
    idx = torch.full((4096,), brick, dtype=torch.int32, device=dev)
    w = torch.rand(4096, 32, generator=g, device=dev)
    # positive rows: the f32 rounding of a 4096-term sum in another order
    # stays well inside 1e-5 of the sum
    rows = torch.rand(4096, 256, generator=g, device=dev)
    got = gc.gather_interp_mm(tab, idx, w, 8, hot_rows=512)
    got_s = gc.scatter_cols_accum(rows, idx, 1024, hot_rows=512)
    torch.cuda.synchronize()
    _close(got, gc.gather_interp_plain(tab, idx, w, 8))
    _close(got_s, gc.scatter_cols_accum_plain(rows, idx, 1024))
    assert got_s[:brick].abs().sum() == 0
    assert got_s[brick + 1:].abs().sum() == 0


@pytest.mark.cuda
@pytest.mark.parametrize("hot", [0, 64])
def test_ids_out_of_range(dev, hot):
    """Negative ids and ids >= n_bricks read zeros and are dropped."""
    tab, idx, w = _inputs(dev, 8)
    g = torch.Generator(device=dev)
    g.manual_seed(6)
    idx = torch.randint(-400, 700, idx.shape, generator=g, device=dev,
                        dtype=torch.int32)
    idx[:3] = torch.tensor([-1, 300, 2**31 - 1], device=dev)
    rows = torch.randn(idx.shape[0], 256, generator=g, device=dev)
    got = gc.gather_interp_mm(tab, idx, w, 8, hot_rows=hot)
    got_s = gc.scatter_cols_accum(rows, idx, 300, hot_rows=hot)
    torch.cuda.synchronize()
    _close(got, _interp_ref(tab, idx, w, 8))
    assert not got[:3].any()
    _close(got_s, _scatter_ref(rows, idx, 300))


@pytest.mark.cuda
@pytest.mark.parametrize("F", [1, 8])
def test_one_descriptor(dev, F):
    """M = 1, staged and not."""
    tab, idx, w = _inputs(dev, F)
    idx, w = idx[:1].contiguous(), w[:1].contiguous()
    rows = torch.randn(1, 32 * F, device=dev)
    for hot in (0, 300):
        got = gc.gather_interp_mm(tab, idx, w, F, hot_rows=hot)
        got_s = gc.scatter_cols_accum(rows, idx, 300, hot_rows=hot)
        torch.cuda.synchronize()
        assert got.shape == (1, F)
        _close(got, gc.gather_interp_plain(tab, idx, w, F))
        _close(got_s, gc.scatter_cols_accum_plain(rows, idx, 300))


@pytest.mark.cuda
@pytest.mark.parametrize("F", [1, 2, 4, 8])
def test_gather_interp_mm_beyond_the_staged_rows(dev, F):
    """A 1024-row table with its first 512 rows staged, ids on both sides
    of the boundary; and more hot rows asked than shared memory holds
    (staging stops at its capacity, the rest reads from global memory)."""
    g = torch.Generator(device=dev)
    g.manual_seed(7)
    tab = torch.randn(6000, 32 * F, generator=g, device=dev)
    w = torch.rand(20000, 32, generator=g, device=dev)
    w[:, 27:] = 0.0
    for lo, hi, hot in ((448, 576, 512), (0, 6000, 6000)):
        idx = torch.randint(lo, hi, (20000,), generator=g, device=dev,
                            dtype=torch.int32)
        got = gc.gather_interp_mm(tab, idx, w, F, hot_rows=hot)
        torch.cuda.synchronize()
        _close(got, gc.gather_interp_plain(tab, idx, w, F))


@pytest.mark.cuda
@pytest.mark.parametrize("hot", [0, 300])
def test_gather_interp_mm_nonzero_padding_weights(dev, hot):
    """Padding entries 27..31 with non-zero weights (the hash grid gives
    them none) are read from global memory and counted."""
    tab, idx, w = _inputs(dev, 8)
    w = torch.rand_like(w) + 0.5
    got = gc.gather_interp_mm(tab, idx, w, 8, hot_rows=hot)
    torch.cuda.synchronize()
    _close(got, gc.gather_interp_plain(tab, idx, w, 8))


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
@pytest.mark.parametrize("M", [4096, 262144])
def test_ngp_field_encode_on_the_card_matches_the_cpu_route(dev, M):
    """The Instant-NGP mapper's route into the field: positions of a
    bounded AABB normalized to the unit cube (no contraction), some outside
    it, on the mapper's table (3 levels of 8 features, 2^19 entries a
    level, resolutions 16..2048), at a small batch and at an occupancy
    refresh's slab of 262,144 cells; forward, table and position gradients
    against the plain versions on the CPU.

    The AABB normalization is made once, on the CPU, and both devices
    encode the same unit positions: torch's CUDA division by a scalar
    multiplies by its reciprocal, which can land one ulp from the CPU's
    quotient, and at 2048 cells an axis about one point in 262,144 then
    falls into the next cell."""
    cfg = hg.HashGridConfig(3, 8, 19, 16, 2048)
    g = torch.Generator().manual_seed(2)
    tab = torch.randn(3 * cfg.bricks_per_level, 256, generator=g) * 0.5
    world = torch.rand(M, 3, generator=g) * 6.0 - 1.5  # aabb [-1, 4]
    unit = hg.normalize_to_unit_cube(world, -1.0, 4.0)
    cot = torch.randn(M, 24, generator=g)
    outs = []
    for d in ("cpu", dev):
        t = tab.to(d).requires_grad_(True)
        p = unit.to(d).requires_grad_(True)
        out = hg.hash_encode(t, p, cfg)
        gt, gp = torch.autograd.grad(out, (t, p), cot.to(d))
        outs.append([v.detach().cpu() for v in (out, gt, gp)])
    for a, b in zip(*outs):
        _close(b, a)


@pytest.mark.cuda
def test_gather_interp_skips_an_inf_under_a_zero_weight(dev):
    """The one result where the card route and the plain version differ:
    an Inf table entry under a zero weight. The plain version sums
    0 * Inf = NaN; the kernel reads only entries with a non-zero weight
    and gives the finite sum of the rest. A table holding an Inf is a
    diverged run in both packages."""
    tab, idx, w = _inputs(dev, 8, M=64)
    w[:, 8:] = 0.0
    tab[idx[0].item(), 20 * 8] = float("inf")  # entry 20, weight 0
    got = gc.gather_interp(tab, idx, w, 8)
    want = gc.gather_interp_plain(tab, idx, w, 8)
    bad = (idx == idx[0]).nonzero()[:, 0]
    assert torch.isnan(want[bad]).any()
    assert torch.isfinite(got).all()
    ok = torch.ones(64, dtype=torch.bool, device=dev)
    ok[bad] = False
    _close(got[ok], want[ok])
    tab[idx[0].item(), 20 * 8] = 0.0
    _close(got, gc.gather_interp_plain(tab, idx, w, 8))


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
        gc.scatter_cols_accum(tab[:, :48].contiguous(), idx, 300)  # R 48
    with pytest.raises(ValueError):
        gc.gather_cols(tab, idx.cpu())
    with pytest.raises(TypeError):
        gc.gather_interp_bf16(tab, idx, w, 8)  # an f32 table
    with pytest.raises(ValueError):
        gc.gather_interp_bf16(tab.to(torch.bfloat16), idx, w, 4)  # R != 32F
    empty = gc.gather_interp(tab, idx[:0], w[:0], 8)
    assert empty.shape == (0, 8)


def _bf16_case(dev, F, weights, seed=5):
    """A bf16 table, ids with out-of-range ones among them, and weights of
    one pattern: trilinear (8 live corners), dense, or padding-only."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    tab = (torch.randn(300, 32 * F, generator=g, device=dev) * 3.0).to(
        torch.bfloat16)
    M = 1001
    idx = torch.randint(-20, 320, (M,), generator=g, device=dev,
                        dtype=torch.int32)
    if weights == "trilinear":
        cfg = hg.HashGridConfig(1, F, 14, 16, 16)
        x = torch.rand(M, 3, generator=g, device=dev)
        _, _, _, w, _ = hg._descriptors(x, cfg)
    else:
        w = torch.rand(M, 32, generator=g, device=dev) + 0.1
        if weights == "padding_only":
            w[:, :27] = 0.0
    return tab, idx, w.contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("weights", ["trilinear", "dense", "padding_only"])
@pytest.mark.parametrize("F", [1, 2, 4, 8])
def test_gather_interp_bf16_table_bitwise(dev, F, weights):
    """The bf16-table kernel gives bitwise the f32 kernel's result on the
    table's values in f32 (bf16 rounding is exact on them), and, for ids in
    range, the plain version's within 1e-5; gather_interp routes a bf16
    table to it and counts the launch there."""
    tab, idx, w = _bf16_case(dev, F, weights)
    before = (gc.gather_interp_bf16.launches, gc.gather_interp.launches)
    got = gc.gather_interp(tab, idx, w, F)
    torch.cuda.synchronize()
    assert (gc.gather_interp_bf16.launches, gc.gather_interp.launches) == (
        before[0] + 1, before[1])
    want = gc.gather_interp(tab.float(), idx, w, F)
    assert torch.equal(got, want)
    assert torch.equal(gc.gather_interp_bf16(tab, idx, w, F), want)
    _close(got, _interp_ref(tab, idx, w, F))


@pytest.mark.cuda
@pytest.mark.parametrize("F", [1, 8])
def test_gather_interp_bf16_skips_an_inf_under_a_zero_weight(dev, F):
    """The bf16-table kernel reads the entries the f32 kernel reads: an Inf
    under a zero weight is skipped alike (where its group of 4 entries at
    F = 1 has no live weight), and the two agree bitwise; the plain
    version gives NaN there."""
    tab, idx, w = _inputs(dev, F, M=64)
    w[:, 8:] = 0.0
    tab16 = tab.to(torch.bfloat16)
    tab16[idx[0].item(), 20 * F] = float("inf")  # entry 20, weight 0
    got = gc.gather_interp(tab16, idx, w, F)
    assert torch.equal(got, gc.gather_interp(tab16.float(), idx, w, F))
    assert torch.isfinite(got).all()
    bad = idx == idx[0]
    assert torch.isnan(gc.gather_interp_plain(tab16, idx, w, F)[bad]).any()
    # under a live weight the Inf is read by both kernels
    w[:, 20] = 0.5
    got = gc.gather_interp(tab16, idx, w, F)
    assert torch.equal(got, gc.gather_interp(tab16.float(), idx, w, F))
    assert torch.isinf(got[bad][:, 0]).all()


@pytest.mark.cuda
def test_hash_proposal_grid_at_f2_with_512_hot_rows(dev):
    """Rows 2-5 at F = 2 over the hash proposal's grid (5 levels x 2
    features, log2 17, resolution 16 -> 128: level 0's 512 bricks on the
    one-hot route and kept on chip, 512 hot rows): hash_encode's forward,
    table gradient and position gradient on the card against the plain
    versions on the CPU (rows 2 and 5 as the fused adjoints, one launch
    each, the unfused kernels none); then gather_interp_mm and
    scatter_cols_accum alone at F = 2 with the 512 hot rows, against
    plain."""
    cfg = hg.HashGridConfig(5, 2, 17, 16, 128)
    assert hg._hot_rows(cfg) == 512
    g = torch.Generator().manual_seed(7)
    tab = torch.randn(5 * cfg.bricks_per_level, 64, generator=g)
    x = torch.rand(2000, 3, generator=g)
    cot = torch.randn(2000, 10, generator=g)
    outs = []
    counts = {k.__name__: k.launches for k in gc.KERNELS}
    for d in ("cpu", dev):
        t = tab.to(d).requires_grad_(True)
        p = x.to(d).requires_grad_(True)
        out = hg.hash_encode(t, p, cfg)
        gt, gp = torch.autograd.grad(out, (t, p), cot.to(d))
        outs.append([v.detach().cpu() for v in (out, gt, gp)])
    for a, b in zip(*outs):
        _close(b, a)
    for name in ("gather_cols_dot", "gather_interp", "gather_interp_mm",
                 "scatter_cols_outer"):
        assert getattr(gc, name).launches == counts[name] + 1, name
    for name in ("gather_cols", "scatter_cols_accum"):
        assert getattr(gc, name).launches == counts[name], name
    tab_d = tab.to(dev)
    n = 2000
    idx, _, _, W, _ = hg._descriptors(x.to(dev), cfg)
    _close(gc.gather_interp_mm(tab_d, idx[:n], W[:n], 2, hot_rows=512),
           gc.gather_interp_mm_plain(tab_d, idx[:n], W[:n], 2))
    rows = torch.randn(idx.shape[0], 64, device=dev)
    _close(gc.scatter_cols_accum(rows, idx, tab_d.shape[0], hot_rows=512),
           gc.scatter_cols_accum_plain(rows, idx, tab_d.shape[0]))


# ---------------------------------------------------------------------------
# the F <= 2 scatter (runs of equal ids summed in registers) and the
# lane-group gather_cols, on the id patterns their designs meet
# ---------------------------------------------------------------------------

def _within_sum_bound(got, rows, idx, n_bricks):
    """Elementwise |got - plain| <= 2 gamma_(k+1) * sum |term| for the k
    rows added into each brick (ids outside [0, n_bricks) dropped): the
    bound on the difference of two f32 sums of the same terms in any
    order. A dropped, repeated or misplaced term fails it."""
    ok = (idx >= 0) & (idx < n_bricks)
    want = gc.scatter_cols_accum_plain(rows[ok], idx[ok], n_bricks)
    abs_sum = gc.scatter_cols_accum_plain(rows[ok].abs(), idx[ok], n_bricks)
    k = torch.zeros(n_bricks, device=rows.device).index_add_(
        0, idx[ok].long(), torch.ones(int(ok.sum()), device=rows.device))
    k = k[:, None] + 1
    eps = 2.0 ** -24
    bound = 2 * k * eps / (1 - k * eps) * abs_sum
    diff = (got - want).abs()
    assert bool((diff <= bound).all()), diff.max().item()


def _runs(dev, lengths, ids):
    """ids[i] repeated lengths[i] times, as int32 on the card."""
    return torch.repeat_interleave(
        torch.tensor(ids, dtype=torch.int32),
        torch.tensor(lengths)).to(dev)


def _scatter_case(dev, case, n_bricks=4096, hot=64):
    g = torch.Generator().manual_seed(11)
    if case == "run_longer_than_a_range":
        # runs of 5000 and 20000 (far longer than one lane group's range
        # at this M), then short ones
        lengths = [5000, 20000, 3, 1, 7, 40000]
        idx = _runs(dev, lengths, [900, 901, 900, 2, 3000, 17])
    elif case == "one_id_everywhere":
        idx = torch.full((150001,), 1234, dtype=torch.int32, device=dev)
    elif case == "alternating":
        idx = torch.tensor([500, 501], dtype=torch.int32).repeat(40000)
        idx = idx.to(dev)
    elif case == "runs_across_hot_boundary":
        ids = torch.randint(hot - 3, hot + 3, (20000,), generator=g)
        lengths = torch.randint(1, 40, (20000,), generator=g)
        idx = _runs(dev, lengths.tolist(), ids.tolist())
    elif case == "out_of_range_inside_runs":
        ids = torch.randint(0, n_bricks, (30000,), generator=g)
        lengths = torch.randint(1, 30, (30000,), generator=g)
        idx = _runs(dev, lengths.tolist(), ids.tolist())
        bad = torch.rand(idx.shape[0], generator=g) < 0.05
        junk = torch.randint(-3, 3, (idx.shape[0],), generator=g)
        junk = torch.where(junk < 0, junk, junk + n_bricks).to(torch.int32)
        idx = torch.where(bad.to(dev), junk.to(dev), idx)
        idx[:2] = torch.tensor([-1, 2**31 - 1], dtype=torch.int32)
    elif case == "many_distinct_ids":
        # every block meets far more distinct ids than any on-chip table
        # holds: ray-like runs over the whole table
        ids = torch.randint(0, n_bricks, (120000,), generator=g)
        lengths = torch.randint(1, 6, (120000,), generator=g)
        idx = _runs(dev, lengths.tolist(), ids.tolist())
    elif case == "one_descriptor":
        idx = torch.tensor([hot + 1], dtype=torch.int32, device=dev)
    elif case == "odd_m":
        # M not a multiple of the tile (8) nor of a block's lane groups
        ids = torch.randint(0, n_bricks, (1500,), generator=g)
        lengths = torch.randint(1, 9, (1500,), generator=g)
        idx = _runs(dev, lengths.tolist(), ids.tolist())[:4099]
    return idx.contiguous(), n_bricks, hot


SCATTER_CASES = ["run_longer_than_a_range", "one_id_everywhere",
                 "alternating", "runs_across_hot_boundary",
                 "out_of_range_inside_runs", "many_distinct_ids",
                 "one_descriptor", "odd_m"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", SCATTER_CASES)
@pytest.mark.parametrize("F", [1, 2, 4, 8])
def test_scatter_cols_accum_id_patterns(dev, F, case):
    """Each case with no rows on chip and with the first 64 accumulated in
    shared memory, held within the f32 summation bound of its terms."""
    idx, n_bricks, hot = _scatter_case(dev, case)
    g = torch.Generator(device=dev)
    g.manual_seed(12)
    rows = torch.randn(idx.shape[0], 32 * F, generator=g, device=dev)
    for h in (0, hot):
        before = gc.scatter_cols_accum.launches
        got = gc.scatter_cols_accum(rows, idx, n_bricks, hot_rows=h)
        torch.cuda.synchronize()
        assert gc.scatter_cols_accum.launches == before + 1
        _within_sum_bound(got, rows, idx, n_bricks)


@pytest.mark.cuda
@pytest.mark.parametrize("F", [1, 2, 4, 8])
def test_scatter_cols_accum_on_proposal_rays(dev, F):
    """Level-major descriptors of rays (each ray's samples adjacent), the
    order the hash grid hands the scatter, through a 5-level grid with
    level 0's bricks on chip."""
    cfg = hg.HashGridConfig(5, F, 17, 16, 128)
    g = torch.Generator(device=dev)
    g.manual_seed(13)
    rays, samples = 1024, 96
    o = torch.rand(rays, 1, 3, generator=g, device=dev) * 0.2 + 0.4
    d = torch.randn(rays, 1, 3, generator=g, device=dev)
    d = d / d.norm(dim=-1, keepdim=True)
    t = torch.linspace(0.0, 0.5, samples, device=dev)[None, :, None]
    x = (o + t * d).clamp(0.0, 1.0)
    idx, _, _, W, _ = hg._descriptors(x, cfg)
    cot = torch.randn(idx.shape[0], F, generator=g, device=dev)
    rows = (W[:, :, None] * cot[:, None, :]).reshape(idx.shape[0], 32 * F)
    nb = 5 * cfg.bricks_per_level
    got = gc.scatter_cols_accum(rows, idx, nb, hot_rows=hg._hot_rows(cfg))
    torch.cuda.synchronize()
    _within_sum_bound(got, rows, idx, nb)


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 31, 4099, 100003])
@pytest.mark.parametrize("R", [32, 64, 128, 256, 36])
def test_gather_cols_bitwise_widths(dev, R, M):
    """The lane-group kernel at R = 32F (R / 8 lanes a descriptor), and
    another multiple of 4 (one warp a descriptor), at odd M; runs of ids
    and ids out of range (zeros) included."""
    g = torch.Generator(device=dev)
    g.manual_seed(14)
    n_bricks = 3000
    tab = torch.randn(n_bricks, R, generator=g, device=dev) * 3.0
    idx = torch.randint(-20, n_bricks + 20, (M,), generator=g, device=dev,
                        dtype=torch.int32)
    idx[M // 2:] = idx[M // 2:] // 7 * 7  # runs of repeats
    got = gc.gather_cols(tab, idx)
    torch.cuda.synchronize()
    ok = (idx >= 0) & (idx < n_bricks)
    safe = torch.where(ok, idx, torch.zeros_like(idx))
    want = gc.gather_cols_plain(tab, safe) * ok[:, None]
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# the fused adjoints of gather_interp: gather_cols_dot (row 2 with the
# contraction that consumed its rows) and scatter_cols_outer (row 5 with
# the outer product that fed it)
# ---------------------------------------------------------------------------

ADJOINT_IDS = ["random", "runs", "out_of_range"]


def _adjoint_inputs(dev, F, ids, M=4099, n_bricks=700):
    """A table, M ids (uniform; in runs of 1-29, as the hash grid hands
    them over; or uniform with ids out of range among them), trilinear
    weights of random points (8 live corners, entries 27..31 zero) and a
    cotangent [M, F]."""
    g = torch.Generator(device=dev)
    g.manual_seed(21 + F)
    tab = torch.randn(n_bricks, 32 * F, generator=g, device=dev)
    if ids == "runs":
        c = torch.Generator().manual_seed(22)
        starts = torch.randint(0, n_bricks, (M,), generator=c)
        lengths = torch.randint(1, 30, (M,), generator=c)
        idx = _runs(dev, lengths.tolist(), starts.tolist())[:M].contiguous()
    else:
        lo, hi = (-50, n_bricks + 50) if ids == "out_of_range" else (
            0, n_bricks)
        idx = torch.randint(lo, hi, (M,), generator=g, device=dev,
                            dtype=torch.int32)
        if ids == "out_of_range":
            idx[:2] = torch.tensor([-1, 2**31 - 1], dtype=torch.int32)
    x = torch.rand(M, 3, generator=g, device=dev)
    _, _, _, w, _ = hg._descriptors(x, hg.HashGridConfig(1, F, 14, 16, 16))
    cot = torch.randn(M, F, generator=g, device=dev)
    return tab, idx, w.contiguous(), cot


def _within_dot_bound(got, tab, idx, cot):
    """Elementwise |got - plain| <= 2 gamma_(F+1) * sum_f |bf16(v) c|, the
    bound on two f32 sums of the same F products in any order; ids outside
    [0, n_bricks) give rows of zeros."""
    F = cot.shape[1]
    ok = (idx >= 0) & (idx < tab.shape[0])
    safe = torch.where(ok, idx, torch.zeros_like(idx))
    want = gc.gather_cols_dot_plain(tab, safe, cot) * ok[:, None]
    abs_sum = gc.gather_cols_dot_plain(tab.abs(), safe, cot.abs())
    eps = 2.0 ** -24
    bound = 2 * (F + 1) * eps / (1 - (F + 1) * eps) * abs_sum
    diff = (got - want).abs()
    assert bool((diff <= bound).all()), diff.max().item()
    assert not got[~ok].any()


def _outer_rows(W, cot):
    M, F = cot.shape
    return (W[:, :, None] * cot[:, None, :]).reshape(M, 32 * F)


@pytest.mark.cuda
@pytest.mark.parametrize("ids", ADJOINT_IDS)
@pytest.mark.parametrize("F", [1, 2, 4, 8])
def test_gather_cols_dot_matches_plain(dev, F, ids):
    tab, idx, _, cot = _adjoint_inputs(dev, F, ids)
    before = (gc.gather_cols_dot.launches, gc.gather_cols.launches)
    got = gc.gather_cols_dot(tab, idx, cot)
    torch.cuda.synchronize()
    assert (gc.gather_cols_dot.launches, gc.gather_cols.launches) == (
        before[0] + 1, before[1])
    assert got.shape == (idx.shape[0], 32) and got.dtype == torch.float32
    _within_dot_bound(got, tab, idx, cot)


@pytest.mark.cuda
@pytest.mark.parametrize("ids", ADJOINT_IDS)
@pytest.mark.parametrize("F", [1, 2, 4, 8])
def test_scatter_cols_outer_matches_plain(dev, F, ids):
    """One launch of the fused kernel and none of row 5; ids out of range
    are dropped."""
    _, idx, W, cot = _adjoint_inputs(dev, F, ids)
    before = (gc.scatter_cols_outer.launches, gc.scatter_cols_accum.launches)
    got = gc.scatter_cols_outer(W, cot, idx, 700)
    torch.cuda.synchronize()
    assert (gc.scatter_cols_outer.launches,
            gc.scatter_cols_accum.launches) == (before[0] + 1, before[1])
    assert got.shape == (700, 32 * F)
    _within_sum_bound(got, _outer_rows(W, cot), idx, 700)
    assert not got.reshape(700, 32, F)[:, 27:].any()  # zero weights


@pytest.mark.cuda
@pytest.mark.parametrize("case", SCATTER_CASES)
@pytest.mark.parametrize("F", [1, 2, 4, 8])
def test_scatter_cols_outer_id_patterns(dev, F, case):
    """The scatter's id patterns with rows formed from dense random
    weights (every entry live) and a cotangent."""
    idx, n_bricks, _ = _scatter_case(dev, case)
    g = torch.Generator(device=dev)
    g.manual_seed(23)
    W = torch.rand(idx.shape[0], 32, generator=g, device=dev)
    cot = torch.randn(idx.shape[0], F, generator=g, device=dev)
    got = gc.scatter_cols_outer(W, cot, idx, n_bricks)
    torch.cuda.synchronize()
    _within_sum_bound(got, _outer_rows(W, cot), idx, n_bricks)


@pytest.mark.cuda
@pytest.mark.parametrize("case", SCATTER_CASES)
@pytest.mark.parametrize("F", [1, 2, 4, 8])
def test_scatter_cols_outer_repeats_bitwise(dev, F, case):
    """The sorted design adds no atomics: two calls on the same inputs
    give the same bits, ids spanning many lane groups' ranges included."""
    idx, n_bricks, _ = _scatter_case(dev, case)
    g = torch.Generator(device=dev)
    g.manual_seed(25)
    W = torch.rand(idx.shape[0], 32, generator=g, device=dev)
    cot = torch.randn(idx.shape[0], F, generator=g, device=dev)
    first = gc.scatter_cols_outer(W, cot, idx, n_bricks)
    again = gc.scatter_cols_outer(W, cot, idx, n_bricks)
    torch.cuda.synchronize()
    assert torch.equal(first, again)


@pytest.mark.cuda
@pytest.mark.parametrize("F", [1, 2, 4, 8])
def test_adjoints_on_proposal_rays(dev, F):
    """Level-major descriptors of rays (each ray's samples adjacent) through
    a 5-level grid: both adjoints as the hash grid's backward calls
    them."""
    cfg = hg.HashGridConfig(5, F, 17, 16, 128)
    g = torch.Generator(device=dev)
    g.manual_seed(24)
    rays, samples = 1024, 96
    o = torch.rand(rays, 1, 3, generator=g, device=dev) * 0.2 + 0.4
    d = torch.randn(rays, 1, 3, generator=g, device=dev)
    d = d / d.norm(dim=-1, keepdim=True)
    t = torch.linspace(0.0, 0.5, samples, device=dev)[None, :, None]
    idx, _, _, W, _ = hg._descriptors((o + t * d).clamp(0.0, 1.0), cfg)
    cot = torch.randn(idx.shape[0], F, generator=g, device=dev)
    nb = 5 * cfg.bricks_per_level
    tab = torch.randn(nb, 32 * F, generator=g, device=dev)
    got = gc.scatter_cols_outer(W, cot, idx, nb)
    dW = gc.gather_cols_dot(tab, idx, cot)
    torch.cuda.synchronize()
    _within_sum_bound(got, _outer_rows(W, cot), idx, nb)
    _within_dot_bound(dW, tab, idx, cot)


@pytest.mark.cuda
@pytest.mark.parametrize("F", [1, 2, 4, 8])
def test_adjoints_with_no_descriptors(dev, F):
    """M = 0: an empty dW and a zero gradient, no launch."""
    tab, idx, W, cot = _adjoint_inputs(dev, F, "random", M=16)
    before = (gc.gather_cols_dot.launches, gc.scatter_cols_outer.launches)
    dW = gc.gather_cols_dot(tab, idx[:0], cot[:0])
    grad = gc.scatter_cols_outer(W[:0], cot[:0], idx[:0], 700)
    torch.cuda.synchronize()
    assert dW.shape == (0, 32)
    assert grad.shape == (700, 32 * F) and not grad.any()
    assert (gc.gather_cols_dot.launches,
            gc.scatter_cols_outer.launches) == before


@pytest.mark.cuda
def test_adjoints_reject_bad_inputs(dev):
    tab, idx, W, cot = _adjoint_inputs(dev, 8, "random", M=64)
    with pytest.raises(ValueError):
        gc.gather_cols_dot(tab, idx, cot[:, :4].contiguous())  # R != 32F
    with pytest.raises(ValueError):
        gc.gather_cols_dot(tab, idx, cot[:10])  # row count mismatch
    with pytest.raises(TypeError):
        gc.gather_cols_dot(tab, idx, cot.double())
    with pytest.raises(ValueError):
        gc.gather_cols_dot(tab, idx, cot.cpu())
    with pytest.raises(ValueError):
        gc.gather_cols_dot(tab, idx, cot[:, :3].contiguous())  # F 3
    with pytest.raises(ValueError):
        gc.scatter_cols_outer(W[:, :16].contiguous(), cot, idx, 700)
    with pytest.raises(ValueError):
        gc.scatter_cols_outer(W, cot[:10], idx, 700)
    with pytest.raises(TypeError):
        gc.scatter_cols_outer(W, cot, idx.long(), 700)
    with pytest.raises(ValueError):
        gc.scatter_cols_outer(W, cot.t(), idx, 700)  # not contiguous
