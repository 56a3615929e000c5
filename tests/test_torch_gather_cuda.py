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
(gather) or drops them (scatter).
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
    versions on the CPU; then gather_interp_mm and scatter_cols_accum
    alone at F = 2 with the 512 hot rows, against plain."""
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
    for name in ("gather_cols", "gather_interp", "gather_interp_mm",
                 "scatter_cols_accum"):
        assert getattr(gc, name).launches == counts[name] + 1, name
    tab_d = tab.to(dev)
    n = 2000
    idx, _, _, W, _ = hg._descriptors(x.to(dev), cfg)
    _close(gc.gather_interp_mm(tab_d, idx[:n], W[:n], 2, hot_rows=512),
           gc.gather_interp_mm_plain(tab_d, idx[:n], W[:n], 2))
    rows = torch.randn(idx.shape[0], 64, device=dev)
    _close(gc.scatter_cols_accum(rows, idx, tab_d.shape[0], hot_rows=512),
           gc.scatter_cols_accum_plain(rows, idx, tab_d.shape[0]))
