"""The CUDA table kernels (``csrc/gather.cu``) against their plain
versions, on the card.

These tests need an NVIDIA GPU and ``nvcc`` and skip elsewhere. The file
imports nothing of JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gather_cuda.py

Tolerances: ``gather_cols`` bitwise (the same bf16 rounding);
``gather_interp`` / ``gather_interp_mm`` 1e-5 of the largest |output| (f32
sums of 32 products in another order); ``gather_interp`` on a bf16 table
bitwise the f32 kernel's result on the same values in f32;
``scatter_cols_accum`` 1e-5 of the largest |output| (f32 sums in sorted
order against a sequential index_add_). ``gather_interp_mm`` runs both
with leading rows staged on chip (``hot_rows``) and without; ids out of
``[0, n_bricks)`` are held against a reference that reads zeros for them
(gather) or drops them (scatter). The scatters' id patterns (runs of equal
ids, ids spanning many lane groups' ranges) are held elementwise within
the f32 summation bound of each brick's terms, and both scatters bitwise
the same over two calls (they add no atomics, and sort their ids with
``sort_ids``, never ``torch.sort``). The fused table adjoint of
``gather_interp``, ``scatter_cols_outer``, forms its rows ``W (x) cot`` in
registers. The position pullback
``gather_cols_dfrac`` elementwise within the f32 summation bound of its
terms (F products a corner, the separable weights' sums), bitwise the same
over two calls and for a descriptor wherever it lies in the call;
``sort_ids`` exactly ``torch.sort(stable=True)`` (keys and positions).
The libraries call the CUDA runtime PyTorch loaded, so the profiler records
each launch inside the range of the call that made it.
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
    """One launch of the scatter after one of its sort."""
    tab, idx, w = _inputs(dev, F)
    rows = torch.randn(idx.shape[0], 32 * F, device=dev)
    want = gc.scatter_cols_accum_plain(rows, idx, tab.shape[0])
    before = (gc.scatter_cols_accum.launches, gc.sort_ids.launches)
    got = gc.scatter_cols_accum(rows, idx, tab.shape[0])
    torch.cuda.synchronize()
    assert (gc.scatter_cols_accum.launches, gc.sort_ids.launches) == (
        before[0] + 1, before[1] + 1)
    _close(got, want)


@pytest.mark.cuda
def test_scatter_cols_accum_level0_contention(dev):
    """The field's level 0: 512 bricks, 196,608 descriptors (~384 a
    brick), F = 8."""
    g = torch.Generator(device=dev)
    g.manual_seed(4)
    idx = torch.randint(0, 512, (196608,), generator=g, device=dev,
                        dtype=torch.int32)
    rows = torch.randn(196608, 256, generator=g, device=dev)
    got = gc.scatter_cols_accum(rows, idx, 512)
    torch.cuda.synchronize()
    _close(got, gc.scatter_cols_accum_plain(rows, idx, 512))


@pytest.mark.cuda
@pytest.mark.parametrize("brick", [5, 700], ids=["hot", "beyond_hot"])
def test_every_id_on_one_brick(dev, brick):
    """4096 descriptors on one brick of a 1024-row table whose first 512
    rows gather_interp_mm stages on chip."""
    g = torch.Generator(device=dev)
    g.manual_seed(5)
    tab = torch.randn(1024, 256, generator=g, device=dev)
    idx = torch.full((4096,), brick, dtype=torch.int32, device=dev)
    w = torch.rand(4096, 32, generator=g, device=dev)
    # positive rows: the f32 rounding of a 4096-term sum in another order
    # stays well inside 1e-5 of the sum
    rows = torch.rand(4096, 256, generator=g, device=dev)
    got = gc.gather_interp_mm(tab, idx, w, 8, hot_rows=512)
    got_s = gc.scatter_cols_accum(rows, idx, 1024)
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
    got_s = gc.scatter_cols_accum(rows, idx, 300)
    torch.cuda.synchronize()
    _close(got, _interp_ref(tab, idx, w, 8))
    assert not got[:3].any()
    _close(got_s, _scatter_ref(rows, idx, 300))


@pytest.mark.cuda
@pytest.mark.parametrize("F", [1, 8])
def test_one_descriptor(dev, F):
    """M = 1, staged (gather_interp_mm) and not."""
    tab, idx, w = _inputs(dev, F)
    idx, w = idx[:1].contiguous(), w[:1].contiguous()
    rows = torch.randn(1, 32 * F, device=dev)
    for hot in (0, 300):
        got = gc.gather_interp_mm(tab, idx, w, F, hot_rows=hot)
        got_s = gc.scatter_cols_accum(rows, idx, 300)
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
    versions on the CPU (rows 2 and 5 as the position pullback and the
    table adjoint with its sort, one launch each, the unfused kernels
    none); then gather_interp_mm with the 512 hot rows and
    scatter_cols_accum alone at F = 2, against plain."""
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
    for name in ("gather_cols_dfrac", "gather_interp", "gather_interp_mm",
                 "scatter_cols_outer", "sort_ids"):
        assert getattr(gc, name).launches == counts[name] + 1, name
    for name in ("gather_cols", "scatter_cols_accum"):
        assert getattr(gc, name).launches == counts[name], name
    tab_d = tab.to(dev)
    n = 2000
    idx, _, _, W, _ = hg._descriptors(x.to(dev), cfg)
    _close(gc.gather_interp_mm(tab_d, idx[:n], W[:n], 2, hot_rows=512),
           gc.gather_interp_mm_plain(tab_d, idx[:n], W[:n], 2))
    rows = torch.randn(idx.shape[0], 64, device=dev)
    _close(gc.scatter_cols_accum(rows, idx, tab_d.shape[0]),
           gc.scatter_cols_accum_plain(rows, idx, tab_d.shape[0]))


# ---------------------------------------------------------------------------
# the scatters (runs of equal ids summed in registers, ranges of the sorted
# order) and the lane-group gather_cols, on the id patterns their designs
# meet
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
    """Each case held within the f32 summation bound of its terms."""
    idx, n_bricks, _ = _scatter_case(dev, case)
    g = torch.Generator(device=dev)
    g.manual_seed(12)
    rows = torch.randn(idx.shape[0], 32 * F, generator=g, device=dev)
    before = gc.scatter_cols_accum.launches
    got = gc.scatter_cols_accum(rows, idx, n_bricks)
    torch.cuda.synchronize()
    assert gc.scatter_cols_accum.launches == before + 1
    _within_sum_bound(got, rows, idx, n_bricks)


@pytest.mark.cuda
@pytest.mark.parametrize("F", [1, 2, 4, 8])
def test_scatter_cols_accum_on_proposal_rays(dev, F):
    """Level-major descriptors of rays (each ray's samples adjacent), the
    order the hash grid hands the scatter, through a 5-level grid."""
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
    got = gc.scatter_cols_accum(rows, idx, nb)
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
# the table adjoint of gather_interp: scatter_cols_outer (row 5 with the
# outer product that fed it)
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


def _outer_rows(W, cot):
    M, F = cot.shape
    return (W[:, :, None] * cot[:, None, :]).reshape(M, 32 * F)


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
@pytest.mark.parametrize("scatter", ["outer", "accum"])
@pytest.mark.parametrize("case", SCATTER_CASES)
@pytest.mark.parametrize("F", [1, 2, 4, 8])
def test_scatter_cols_outer_repeats_bitwise(dev, F, case, scatter):
    """The sorted design adds no atomics: two calls on the same inputs
    give the same bits, ids spanning many lane groups' ranges included;
    scatter_cols_outer, and scatter_cols_accum on rows of its own."""
    idx, n_bricks, _ = _scatter_case(dev, case)
    g = torch.Generator(device=dev)
    g.manual_seed(25)
    W = torch.rand(idx.shape[0], 32, generator=g, device=dev)
    cot = torch.randn(idx.shape[0], F, generator=g, device=dev)
    if scatter == "outer":
        call = lambda: gc.scatter_cols_outer(W, cot, idx, n_bricks)  # noqa
    else:
        rows = torch.randn(idx.shape[0], 32 * F, generator=g, device=dev)
        call = lambda: gc.scatter_cols_accum(rows, idx, n_bricks)  # noqa
    before = gc.sort_ids.launches
    first = call()
    again = call()
    torch.cuda.synchronize()
    assert gc.sort_ids.launches == before + 2
    assert torch.equal(first, again)


@pytest.mark.cuda
@pytest.mark.parametrize("F", [1, 2, 4, 8])
def test_adjoints_on_proposal_rays(dev, F):
    """Level-major descriptors of rays (each ray's samples adjacent) through
    a 5-level grid: the table adjoint as the hash grid's backward calls
    it."""
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
    got = gc.scatter_cols_outer(W, cot, idx, nb)
    torch.cuda.synchronize()
    _within_sum_bound(got, _outer_rows(W, cot), idx, nb)


@pytest.mark.cuda
@pytest.mark.parametrize("F", [1, 2, 4, 8])
def test_adjoints_with_no_descriptors(dev, F):
    """M = 0: an empty dfrac and sort, zero scatters, no launch."""
    tab, idx, W, cot = _adjoint_inputs(dev, F, "random", M=16)
    local, frac = _cells(dev, F, 16)
    counted = (gc.scatter_cols_accum, gc.scatter_cols_outer,
               gc.gather_cols_dfrac, gc.sort_ids)
    before = [k.launches for k in counted]
    acc = gc.scatter_cols_accum(tab[:0], idx[:0], 700)
    grad = gc.scatter_cols_outer(W[:0], cot[:0], idx[:0], 700)
    d = gc.gather_cols_dfrac(tab, idx[:0], cot[:0], local[:0], frac[:0],
                             LEVEL_FIRST, LEVEL_RES)
    keys, perm = gc.sort_ids(idx[:0], 700)
    torch.cuda.synchronize()
    assert d.shape == (0, 3)
    assert keys.shape == (0,) and perm.shape == (0,)
    assert acc.shape == (700, 32 * F) and not acc.any()
    assert grad.shape == (700, 32 * F) and not grad.any()
    assert [k.launches for k in counted] == before


@pytest.mark.cuda
def test_adjoints_reject_bad_inputs(dev):
    tab, idx, W, cot = _adjoint_inputs(dev, 8, "random", M=64)
    local, frac = _cells(dev, 8, 64)
    with pytest.raises(TypeError):
        gc.gather_cols_dfrac(tab, idx, cot, local.int(), frac, LEVEL_FIRST,
                             LEVEL_RES)
    with pytest.raises(ValueError):
        gc.gather_cols_dfrac(tab, idx, cot, local, frac[:10], LEVEL_FIRST,
                             LEVEL_RES)
    with pytest.raises(ValueError):  # levels not ascending
        gc.gather_cols_dfrac(tab, idx, cot, local, frac, [0, 466, 233],
                             LEVEL_RES)
    with pytest.raises(ValueError):  # more levels than the kernel takes
        gc.gather_cols_dfrac(tab, idx, cot, local, frac, list(range(33)),
                             [16.0] * 33)
    with pytest.raises(TypeError):
        gc.sort_ids(idx.long(), 700)
    with pytest.raises(ValueError):
        gc.scatter_cols_outer(W[:, :16].contiguous(), cot, idx, 700)
    with pytest.raises(ValueError):
        gc.scatter_cols_outer(W, cot[:10], idx, 700)
    with pytest.raises(TypeError):
        gc.scatter_cols_outer(W, cot, idx.long(), 700)
    with pytest.raises(ValueError):
        gc.scatter_cols_outer(W, cot.t(), idx, 700)  # not contiguous


# ---------------------------------------------------------------------------
# the position pullback (gather_cols_dfrac) and the sort of the table
# gradient's ids (sort_ids)
# ---------------------------------------------------------------------------

# three levels of a 700-row table: their first ids and resolutions
LEVEL_FIRST, LEVEL_RES = [0, 233, 466], [16.0, 32.0, 64.0]
DFRAC_IDS = ["random", "runs", "one_brick", "out_of_range"]


def _cells(dev, F, M, seed=31):
    """Base corners [M, 3] int64 and offsets [M, 3] f32 of points in and
    around the unit cube (clamped as the hash grid clamps them, so offsets
    at the boundary are 0), as ``hash_grid._descriptors`` makes them."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed + F)
    x = torch.rand(M, 3, generator=g, device=dev) * 1.04 - 0.02
    _, local, frac, _, _ = hg._descriptors(
        x, hg.HashGridConfig(1, F, 14, 16, 16))
    return local.contiguous(), frac.contiguous()


def _dfrac_case(dev, F, ids, M=4099):
    tab, idx, _, cot = _adjoint_inputs(dev, F, "out_of_range"
                                       if ids == "out_of_range" else
                                       "runs" if ids == "runs" else "random",
                                       M=M)
    if ids == "one_brick":
        idx = torch.full_like(idx, 250)
    local, frac = _cells(dev, F, M)
    return tab, idx, cot, local, frac


def _within_dfrac_bound(got, tab, idx, cot, local, frac):
    """Elementwise |got - plain| <= 2 gamma_(k+1) * sum |term|, k = F + 12
    (a corner's F products, then the weights' two-term sums, the difference
    and the resolution's product: at most that many roundings on either
    side), the terms bf16(v) cot w w |w'| res; ids outside [0, n_bricks)
    give zeros."""
    F = cot.shape[1]
    ok = (idx >= 0) & (idx < tab.shape[0])
    safe = torch.where(ok, idx, torch.zeros_like(idx))
    want = gc.gather_cols_dfrac_plain(tab, safe, cot, local, frac,
                                      LEVEL_FIRST, LEVEL_RES) * ok[:, None]
    dW = gc.gather_cols_dot_plain(tab.abs(), safe, cot.abs())[:, :27]
    w = [gc.axis_weights(local[:, a], frac[:, a]) for a in range(3)]
    dw = [gc.axis_dweights(local[:, a]).abs() for a in range(3)]
    d = dW.reshape(-1, 3, 3, 3)
    res = torch.tensor(LEVEL_RES, device=tab.device)[
        gc.id_levels(safe, LEVEL_FIRST)]
    abs_sum = torch.stack([
        torch.einsum("mijk,mi,mj,mk->m", d, dw[0], w[1], w[2]),
        torch.einsum("mijk,mi,mj,mk->m", d, w[0], dw[1], w[2]),
        torch.einsum("mijk,mi,mj,mk->m", d, w[0], w[1], dw[2]),
    ], dim=-1) * res[:, None]
    k = F + 13
    eps = 2.0 ** -24
    bound = 2 * k * eps / (1 - k * eps) * abs_sum
    diff = (got - want).abs()
    assert bool((diff <= bound).all()), diff.max().item()
    assert not got[~ok].any()


@pytest.mark.cuda
@pytest.mark.parametrize("ids", DFRAC_IDS)
@pytest.mark.parametrize("F", [1, 2, 4, 8])
def test_gather_cols_dfrac_matches_plain(dev, F, ids):
    """One launch of the kernel and none of gather_cols; uniform ids, runs
    of ids, one brick, ids out of range (zeros); two calls give the same
    bits."""
    tab, idx, cot, local, frac = _dfrac_case(dev, F, ids)
    before = (gc.gather_cols_dfrac.launches, gc.gather_cols.launches)
    got = gc.gather_cols_dfrac(tab, idx, cot, local, frac, LEVEL_FIRST,
                               LEVEL_RES)
    again = gc.gather_cols_dfrac(tab, idx, cot, local, frac, LEVEL_FIRST,
                                 LEVEL_RES)
    torch.cuda.synchronize()
    assert (gc.gather_cols_dfrac.launches, gc.gather_cols.launches) == (
        before[0] + 2, before[1])
    assert got.shape == (idx.shape[0], 3) and got.dtype == torch.float32
    _within_dfrac_bound(got, tab, idx, cot, local, frac)
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("F", [2, 8])
def test_gather_cols_dfrac_rows_do_not_depend_on_their_place(dev, F):
    """A descriptor's row is the same bits in any call that holds it, as
    the descriptor-sharded route (a rank's descriptors at its owner, local
    ids) needs it to be against the one-rank route: the reversed and
    shifted half of a call, its ids made local to a shard of the table."""
    tab, idx, cot, local, frac = _dfrac_case(dev, F, "random")
    full = gc.gather_cols_dfrac(tab, idx, cot, local, frac, LEVEL_FIRST,
                                LEVEL_RES)
    sel = torch.arange(idx.shape[0] - 1, 0, -2, device=dev)
    base = 100  # a shard holding global rows 100..699
    part = gc.gather_cols_dfrac(
        tab[base:].contiguous(), (idx[sel] - base).contiguous(),
        cot[sel].contiguous(), local[sel].contiguous(),
        frac[sel].contiguous(), [f - base for f in LEVEL_FIRST], LEVEL_RES)
    torch.cuda.synchronize()
    keep = idx[sel] >= base
    assert keep.any() and torch.equal(part[keep], full[sel][keep])


@pytest.mark.cuda
@pytest.mark.parametrize("F", [2, 8])
def test_gather_cols_dfrac_is_hash_encodes_position_pullback(dev, F):
    """The kernel, summed over levels, against the plain chain it replaced
    (``gather_cols_dot_plain``'s dW through ``dfrac``, times the
    resolution) on a
    5-level hash grid's descriptors of rays."""
    cfg = hg.HashGridConfig(5, F, 17, 16, 128)
    g = torch.Generator(device=dev)
    g.manual_seed(32)
    o = torch.rand(512, 1, 3, generator=g, device=dev) * 0.2 + 0.4
    d = torch.randn(512, 1, 3, generator=g, device=dev)
    d = d / d.norm(dim=-1, keepdim=True)
    t = torch.linspace(0.0, 0.7, 48, device=dev)[None, :, None]
    idx, local, frac, _, _ = hg._descriptors(o + t * d, cfg)
    nb = 5 * cfg.bricks_per_level
    tab = torch.randn(nb, 32 * F, generator=g, device=dev)
    cot = torch.randn(idx.shape[0], F, generator=g, device=dev)
    first = [l * cfg.bricks_per_level for l in range(5)]
    got = gc.gather_cols_dfrac(tab, idx, cot, local, frac, first,
                               cfg.resolutions)
    dW = gc.gather_cols_dot_plain(tab, idx, cot)
    chain = gc.dfrac(dW, local, frac) * torch.tensor(
        cfg.resolutions, device=dev).repeat_interleave(
            idx.shape[0] // 5)[:, None]
    torch.cuda.synchronize()
    err = (got - chain).abs().max().item()
    assert err <= 1e-5 * chain.abs().max().item(), err


def _sort_ids_case(dev, case):
    """(ids, n_bricks): ids in runs over a table whose key width is the
    case's bits, the last of the width's range; or a special case."""
    g = torch.Generator().manual_seed(33)
    if case == "all_equal":
        return torch.full((150001,), 1234, dtype=torch.int32,
                          device=dev), 4096
    if case == "one":
        return torch.tensor([7], dtype=torch.int32, device=dev), 49152
    if case == "empty":
        return torch.zeros(0, dtype=torch.int32, device=dev), 49152
    if case == "many_tiles":  # more tiles than blocks resident at once
        return torch.randint(0, 49152, (4_200_001,), generator=g,
                             dtype=torch.int32).to(dev), 49152
    bits = int(case)
    n_bricks = (1 << (bits - 1)) + 3  # keys up to n_bricks need `bits`
    ids = torch.randint(0, n_bricks, (30000,), generator=g)
    lengths = torch.randint(1, 20, (30000,), generator=g)
    return _runs(dev, lengths.tolist(), ids.tolist())[:200003], n_bricks


@pytest.mark.cuda
@pytest.mark.parametrize("case", [str(b) for b in range(9, 20)]
                         + ["all_equal", "one", "empty", "many_tiles"])
def test_sort_ids_equals_torch_sort(dev, case):
    """Keys and positions exactly ``torch.sort(stable=True)``'s, at key
    widths 9-19 bits (two or three 8-bit passes), all ids equal, M = 1,
    M = 0, and more tiles than the grid's blocks; one launch a call."""
    idx, n_bricks = _sort_ids_case(dev, case)
    before = gc.sort_ids.launches
    keys, perm = gc.sort_ids(idx, n_bricks)
    want_k, want_p = torch.sort(idx, stable=True)
    torch.cuda.synchronize()
    assert gc.sort_ids.launches == before + (1 if idx.shape[0] else 0)
    assert keys.dtype == torch.int32 and perm.dtype == torch.int32
    assert torch.equal(keys, want_k)
    assert torch.equal(perm, want_p.to(torch.int32))


@pytest.mark.cuda
def test_sort_ids_puts_ids_out_of_range_last(dev):
    """An id outside [0, n_bricks) sorts as n_bricks: after every id in
    range, in the order of its position, as the plain version orders it."""
    g = torch.Generator().manual_seed(34)
    idx = torch.randint(-50, 5050, (100003,), generator=g,
                        dtype=torch.int32).to(dev)
    idx[:2] = torch.tensor([-2**31, 2**31 - 1], dtype=torch.int32)
    keys, perm = gc.sort_ids(idx, 5000)
    want_k, want_p = gc.sort_ids_plain(idx, 5000)
    torch.cuda.synchronize()
    assert torch.equal(keys, want_k) and torch.equal(perm, want_p)


@pytest.mark.cuda
def test_scatter_cols_outer_never_calls_torch_sort(dev, monkeypatch):
    """The scatter sorts its ids with sort_ids: with torch.sort refused it
    gives the same bits, and sort_ids launches once a call."""
    _, idx, W, cot = _adjoint_inputs(dev, 8, "runs")
    want = gc.scatter_cols_outer(W, cot, idx, 700)
    torch.cuda.synchronize()

    def refuse(*a, **kw):
        raise AssertionError("torch.sort was called")

    monkeypatch.setattr(torch, "sort", refuse)
    monkeypatch.setattr(torch, "argsort", refuse)
    before = gc.sort_ids.launches
    got = gc.scatter_cols_outer(W, cot, idx, 700)
    torch.cuda.synchronize()
    assert gc.sort_ids.launches == before + 1
    assert torch.equal(got, want)


def _cudart_maps():
    with open("/proc/self/maps") as f:
        return {line.split()[-1] for line in f if "libcudart" in line}


@pytest.mark.cuda
def test_launches_are_traced_inside_their_spans(dev):
    """The libraries call the CUDA runtime PyTorch loaded (one libcudart
    in the process), so the profiler records each kernel's launch,
    cooperative launches too, inside the range of the call that made
    it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from nerf_vo_tpu_torch.ops import correlation_cuda

    runtime = _cudart_maps()
    gc._lib()
    correlation_cuda._lib()
    assert len(runtime) == 1 and _cudart_maps() == runtime
    tab, idx, w = _inputs(dev, 2)
    cot = torch.randn(idx.shape[0], 2, device=dev)
    gc.gather_interp(tab, idx, w, 2)  # warm
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("call.gather_interp"):
            gc.gather_interp(tab, idx, w, 2)
        with record_function("call.scatter_cols_outer"):
            gc.scatter_cols_outer(w, cot, idx, tab.shape[0])
        torch.cuda.synchronize()
    events = prof.profiler.kineto_results.events()
    launches = {k.correlation_id(): k.start_ns() for k in events
                if k.device_type() == DeviceType.CPU
                and k.name().startswith("cudaLaunch")}
    for kernel, call in (("gather_interp_kernel<", "gather_interp"),
                         ("sort_ids_kernel", "scatter_cols_outer"),
                         ("scatter_owned_kernel", "scatter_cols_outer")):
        ops = [k for k in events if k.device_type() == DeviceType.CUDA
               and kernel in k.name()]
        spans = [k for k in events if k.device_type() == DeviceType.CPU
                 and k.name() == f"call.{call}"]
        assert len(ops) == 1 and len(spans) == 1, kernel
        t = launches[ops[0].correlation_id()]
        assert spans[0].start_ns() <= t < spans[0].end_ns(), kernel


# ---------------------------------------------------------------------------
# hash_descriptors: every encode's descriptors in one launch
# ---------------------------------------------------------------------------

# the benchmark's grids: nerfacto's field and hash proposals (vo.map), the
# Instant-NGP field (slam.map; nerfacto's field's grid over a box's
# points), and a one-level dense grid (the dense proposals')
DESC_GRIDS = {
    "nerfacto_field": (16, 2, 19, 16, 2048),
    "proposal128": (5, 2, 17, 16, 128),
    "proposal256": (5, 2, 17, 16, 256),
    "ngp_field": (16, 2, 19, 16, 2048),
    "dense128": None,
}


def _desc_grid(case):
    from nerf_vo_tpu_torch.models.nerf_field import dense_grid

    g = DESC_GRIDS[case]
    return dense_grid(128) if g is None else hg.HashGridConfig(*g)


def _desc_points(case, kind, n=3001):
    """Points of one kind for a grid (made on the CPU, so both routes get
    the same bits): uniform in the cube (normalized from the box for the
    NGP field), exactly on the cell faces and corners of every level, at
    0 and 1 and one ulp inside or outside them, outside [0, 1] on every
    side, or none."""
    g = torch.Generator().manual_seed(11)
    if kind == "none":
        return torch.empty(0, 3)
    if kind == "uniform":
        if case == "ngp_field":
            return hg.normalize_to_unit_cube(
                torch.rand(n, 3, generator=g) * 9.0 - 4.5, -4.0, 4.0)
        return torch.rand(n, 3, generator=g)
    if kind == "faces":
        res = torch.tensor(_desc_grid(case).resolutions)
        lvl = torch.randint(0, len(res), (n, 3), generator=g)
        k = (torch.rand(n, 3, generator=g) * (res[lvl] + 1)).floor()
        return (k / res[lvl]).float()
    if kind == "bounds":
        v = torch.tensor([0.0, -0.0, 1.0, 1e-45, 1.0 - 2**-24, 1.0 + 2**-23,
                          -1e-45, 0.5])
        return v[torch.randint(0, len(v), (n, 3), generator=g)]
    # outside: each coordinate below 0, in [0, 1] or above 1
    x = torch.rand(n, 3, generator=g)
    side = torch.randint(0, 3, (n, 3), generator=g)
    return torch.where(side == 0, -x * 3.0, torch.where(side == 2, 1.0 + x,
                                                        x))


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["uniform", "faces", "bounds", "outside",
                                  "none"])
@pytest.mark.parametrize("case", list(DESC_GRIDS))
def test_hash_descriptors_equal_the_plain_chain(dev, case, kind):
    """The kernel's five tensors are the plain chain's on the card bit for
    bit (offsets and weights compared as their bits); one launch, none for
    no points."""
    cfg = _desc_grid(case)
    x = _desc_points(case, kind).to(dev)
    res, nb = cfg.resolutions, cfg.bricks_per_level
    before = gc.hash_descriptors.launches
    got = gc.hash_descriptors(x, res, nb)
    torch.cuda.synchronize()
    assert gc.hash_descriptors.launches == before + (1 if len(x) else 0)
    want = gc.hash_descriptors_plain(x, res, nb)
    for name, a, b in zip(("idx", "local", "frac", "W", "inside"), got,
                          want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.equal(_bits(a), _bits(b)), name
    assert torch.equal(hg._descriptors(x, cfg)[3], got[3])


# the mappers of the benchmark's cells, at their published grid widths and
# samples, over a few rays of a small keyframe buffer
DESC_H, DESC_W, DESC_K, DESC_RAYS = 24, 32, 6, 512
VO_MAP = dict(num_grid_levels=16, grid_features_per_level=2,
              log2_hashmap_size=19, max_res=2048, proposal_type="hash",
              proposal_training="interlevel", grad_normal_mode="samples",
              num_proposal_samples=(256, 96), num_nerf_samples=48)
SLAM_MAP = dict(num_grid_levels=16, grid_features_per_level=2,
                log2_hashmap_size=19, max_res=2048, num_occ_bins=128,
                num_nerf_samples=64, predict_normals=False,
                sampler="occupancy", spacing="linear", use_contraction=False,
                depth_loss_type="l2")


def _desc_step(dev, mapper):
    """One eager step's loss terms and the gradients of every leaf, from a
    trainer and draws made from fixed seeds."""
    import numpy as np

    from nerf_vo_tpu_torch.mapping import keyframe_buffer as kb
    from nerf_vo_tpu_torch.mapping.trainer import (MappingTrainer,
                                                   TrainerConfig)
    from nerf_vo_tpu_torch.models.nerfacto import (NerfactoConfig,
                                                   NerfactoModel)

    H, W, K = DESC_H, DESC_W, DESC_K
    rng = np.random.default_rng(0)
    c2w = np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))
    c2w[:, :3, 3] = rng.normal(0, 0.3, (K, 3))
    yy, xx = np.meshgrid(np.linspace(0, 1, H), np.linspace(0, 1, W),
                         indexing="ij")
    depth = 2.5 + np.cos(3 * xx - yy)[None] * rng.uniform(0.5, 1, (K, 1, 1))
    packet = {
        "intrinsics": torch.tensor([[20.0, 20.0, W / 2, H / 2]]).repeat(K,
                                                                        1),
        "c2w": torch.tensor(c2w),
        "color": torch.tensor(np.clip(
            rng.uniform(0.1, 0.9, (K, 1, 1, 3))
            + 0.3 * np.sin(6 * xx + 4 * yy)[None, ..., None], 0, 1),
            dtype=torch.float32),
        "depth": torch.tensor(depth, dtype=torch.float32)}
    ngp = mapper is SLAM_MAP
    if ngp:
        packet["depth_cov"] = torch.tensor(
            (0.02 * depth) ** 2 * np.exp(rng.normal(size=depth.shape)),
            dtype=torch.float32)
    else:
        nrm = rng.normal(size=(K, H, W, 3)) + [0, 0, 3.0]
        packet["normal"] = torch.tensor(
            nrm / np.linalg.norm(nrm, axis=-1, keepdims=True),
            dtype=torch.float32)
    buf = kb.create(K, H, W, use_normals=not ngp, use_depth_cov=ngp,
                    device=dev)
    kb.insert(buf, list(range(K)), packet)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(3)
        model = NerfactoModel(NerfactoConfig(
            near=0.05, far=20.0, num_images=K, aabb_min=-4.0, aabb_max=4.0,
            **mapper))
    tr = MappingTrainer(model, TrainerConfig(
        rays_per_batch=DESC_RAYS, max_iterations=64, prefetch_batch=False),
        num_keyframes=K, device=dev)
    st = tr.init()
    g = torch.Generator(device=dev)
    g.manual_seed(1000)
    kw = dict(generator=g, device=dev)
    d = {"frame": torch.randint(0, K, (DESC_RAYS,), **kw),
         "py": torch.randint(0, H, (DESC_RAYS,), **kw),
         "px": torch.randint(0, W, (DESC_RAYS,), **kw),
         "uniforms": [torch.rand(s, **kw)
                      for s in tr.model.uniform_shapes(DESC_RAYS)]}
    metrics = tr.gradients(st, buf, d)
    torch.cuda.synchronize()
    return metrics, [p.grad.detach().clone() for p in tr.leaves(st)]


@pytest.mark.cuda
@pytest.mark.parametrize("mapper", ["vo_map", "slam_map"])
def test_eager_step_equals_the_plain_chain_step(dev, mapper, monkeypatch):
    """A mapping step on descriptors from the kernel gives bitwise the loss
    terms and the table, MLP and pose gradients of the same step on the
    plain chain's (installed as ``_descriptors``): nerfacto's mapper of
    vo.map (three encodes a pass, the normals' pullback) and the
    Instant-NGP mapper of slam.map, at their grids' published widths."""
    cfg = {"vo_map": VO_MAP, "slam_map": SLAM_MAP}[mapper]
    before = gc.hash_descriptors.launches
    m_kernel, g_kernel = _desc_step(dev, cfg)
    assert gc.hash_descriptors.launches > before

    def plain(x, config):
        return gc.hash_descriptors_plain(
            x.reshape(-1, 3).float().contiguous(), config.resolutions,
            config.bricks_per_level)

    monkeypatch.setattr(hg, "_descriptors", plain)
    before = gc.hash_descriptors.launches
    m_plain, g_plain = _desc_step(dev, cfg)
    assert gc.hash_descriptors.launches == before
    assert list(m_kernel) == list(m_plain)
    for k in m_plain:
        assert torch.equal(_bits(m_kernel[k]), _bits(m_plain[k])), k
    assert len(g_kernel) == len(g_plain) > 10
    for i, (a, b) in enumerate(zip(g_kernel, g_plain)):
        assert torch.equal(_bits(a), _bits(b)), i
