"""The CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips without a CUDA device (the kernels have no
CPU mode).  On a machine with the card and nvcc:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

(``--noconftest``: tests/conftest.py configures JAX, which the machine with
the card need not have; this file imports no JAX.)

Tolerance: bit-equal everywhere, NaNs included (the kernels are built
with -fmad=false and compute the same IEEE ops as the plain versions).
"""

import warnings

import numpy as np
import pytest
import torch

import sdf_torch as sp
from sdf_torch.core import compact, engine, eval_classify, hybrid, mc, mc33
from sdf_torch.models import zoo

import torch_helpers as th

pytestmark = pytest.mark.cuda


def _same_bits(a, b):
    """Bitwise equality (NaN payloads included; torch.equal says NaN != NaN)."""
    ints = {torch.float32: torch.int32, torch.float64: torch.int64}
    if a.dtype in ints:
        a, b = a.view(ints[a.dtype]), b.view(ints[b.dtype])
    return torch.equal(a, b)


@pytest.fixture(scope="module")
def cuda():
    """The card, with every kernel these tests launch built up front (one
    nvcc per source, all started together)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from sdf_torch import _build

    exprs = [case[0](sp) for case in th.op_cases().values()]
    exprs += [sp.sphere(0.6).union(sp.box(0.8), k=0.2), _wide_expression()]
    both = [th.form_model(sp, fn) for fn in th.elementwise_forms().values()]
    both += [th.blob(sp, op) for op, _ in C4.values()]
    both += [hybrid.to_kernel_tree(hybrid.route_fields(m())[0])
             for m in (_erf_model, _where_model)]
    f32 = [th.form_model(sp, fn) for fn in th.pow_forms().values()]
    bounds = {eval_classify.kernel_source(f, 0, dtype)
              for dtype in (torch.float32, torch.float64)
              for _, f in _bounds_models(dtype)}
    _build.build_many(
        [("eval_classify", eval_classify.kernel_source(f))
         for f in exprs + both]
        + [("eval_classify", text) for text in sorted(bounds)]
        + [(name, source(f, dtype=torch.float32)) for f in f32
           for name, source in (
               ("eval_classify", eval_classify.kernel_source),
               ("eval_tiles", eval_classify.tile_kernel_source))]
        + [("eval_tiles", eval_classify.tile_kernel_source(f))
           for f in [th.example(sp), zoo.blobby(), _wide_expression()]
           + both]
        + [("ntri", _build.source("ntri.cu")),
           ("compact", _build.source("compact.cu")),
           ("classify_ext", mc33.kernel_source()),
           ("label3d", _build.source("label3d.cu")),
           ("probes", _build.source("probes.cu")),
           ("decode", _build.source("decode.cu"))]
    )
    return torch.device("cuda")


def _wide_expression(scale=1.0):
    """A union of 100 spheres: 400 parameter values, more than travel in
    the kernel arguments, so the kernels read them from device memory."""
    f = sp.sphere(0.1 * scale)
    for i in range(99):
        f = f | sp.sphere((0.05 + 0.001 * i) * scale, center=(
            0.01 * i - 0.5, 0.06 * ((i * 7) % 5) - 0.3, 0.02 * (i % 11) - 0.1))
    assert not eval_classify.params_in_args(f)
    return f


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_eval_classify_kernel(cuda, dtype):
    X = np.linspace(-1.1, 1.1, 37)
    Y = np.linspace(-1.0, 1.2, 41)
    Z = np.linspace(-1.2, 1.0, 70)
    for f in (th.example(sp), sp.sphere(0.6).union(sp.box(0.8), k=0.2)):
        vk, ck = eval_classify.eval_and_classify(f, X, Y, Z, dtype, cuda)
        vp, cp = eval_classify._eval_classify_plain(f, X, Y, Z, dtype, cuda)
        assert _same_bits(vk, vp) and torch.equal(ck, cp)


# Axes of length 2 and prime lengths under the launch plan; then, with the
# slab length forced to lx, nx shorter than one slab and nx - 1 = k * lx - 1,
# k * lx, k * lx + 1 cell planes.
B1_SHAPES = [((2, 2, 2), None), ((2, 37, 3), None), ((3, 2, 41), None),
             ((37, 41, 43), None), ((101, 103, 107), None),
             ((10, 45, 70), 16), ((48, 45, 70), 16), ((49, 45, 70), 16),
             ((50, 45, 70), 16), ((15, 33, 95), 7), ((16, 33, 95), 7)]


@pytest.mark.parametrize("shape, lx", B1_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_eval_classify_kernel_shapes(cuda, dtype, shape, lx):
    """Kernel B1 bit-equal to its plain version on grids whose edges cut the
    patches and slabs of its launch plan everywhere."""
    nx, ny, nz = shape
    X = np.linspace(-1.1, 1.1, nx)
    Y = np.linspace(-1.0, 1.2, ny)
    Z = np.linspace(-1.2, 1.0, nz)
    f = th.example(sp)
    before = eval_classify.eval_and_classify.launches
    if lx is None:
        vk, ck = eval_classify.eval_and_classify(f, X, Y, Z, dtype, cuda)
    else:
        vk, ck = eval_classify._launch(f, X, Y, Z, dtype, cuda, lx)
    assert eval_classify.eval_and_classify.launches == before + 1
    vp, cp = eval_classify._eval_classify_plain(f, X, Y, Z, dtype, cuda)
    assert _same_bits(vk, vp) and torch.equal(ck, cp)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernels_read_wide_parameters_from_memory(cuda, dtype):
    """An expression with more parameter values than the kernel arguments
    hold: kernels B1 and B6 read them from device memory, bit-equal to
    their plain versions; new values reuse the compiled library."""
    f = _wide_expression()
    X = np.linspace(-0.7, 0.7, 45)
    vk, ck = eval_classify.eval_and_classify(f, X, X, X, dtype, cuda)
    vp, cp = eval_classify._eval_classify_plain(f, X, X, X, dtype, cuda)
    assert _same_bits(vk, vp) and torch.equal(ck, cp)
    assert int((ck > 0).sum()) > 0
    tiles = torch.as_tensor(th.grid_tiles((45,) * 3, 8,
                                          np.random.default_rng(2)), device=cuda)
    vk, ck = eval_classify.eval_tiles_and_classify_batched(f, X, X, X, tiles,
                                                           8, dtype)
    vp = eval_classify._eval_tiles(f, X, X, X, tiles, 8, dtype)
    assert _same_bits(vk, vp) and torch.equal(ck, mc._cell_cases(vp))
    g = _wide_expression(1.2)  # other values, the same library
    assert eval_classify.kernel_source(g) == eval_classify.kernel_source(f)
    vk, ck = eval_classify.eval_and_classify(g, X, X, X, dtype, cuda)
    vp, cp = eval_classify._eval_classify_plain(g, X, X, X, dtype, cuda)
    assert _same_bits(vk, vp) and torch.equal(ck, cp)


@pytest.mark.parametrize("name", sorted(th.op_cases()))
def test_eval_classify_kernel_every_op(cuda, name):
    """Every ported op through the generated kernel, bit-equal to the plain
    torch evaluation on the card (float32, the main path's dtype)."""
    f = th.op_cases()[name][0](sp)
    X = np.linspace(-1.2, 1.2, 23)
    vk, ck = eval_classify.eval_and_classify(f, X, X, X, torch.float32, cuda)
    vp, cp = eval_classify._eval_classify_plain(f, X, X, X, torch.float32, cuda)
    assert _same_bits(vk, vp) and torch.equal(ck, cp)


@pytest.mark.parametrize("variant, ncase", [("fast", 256), ("lewiner", 5904)])
def test_ntri_kernel(cuda, variant, ncase):
    rng = np.random.default_rng(0)
    codes = np.concatenate([np.arange(ncase),
                            rng.integers(-5, ncase + 44, 9999)])
    c = torch.as_tensor(codes.astype(np.int32), device=cuda)
    table = mc.get_tables(variant).on(cuda, "ntri")
    assert table.numel() == ncase
    assert torch.equal(mc.ntri_of(c, variant), mc._ntri_plain(c, table))


@pytest.mark.parametrize("off", [0, 1, 2, 3])
@pytest.mark.parametrize("variant", ["fast", "lewiner"])
def test_ntri_kernel_on_views(cuda, variant, off):
    """Kernel B3 on contiguous views at int32 offsets 0-3 from a 16-byte
    boundary, at lengths around its head, vectors and tail and past one
    grid stride, with codes outside the table: equal to plain, one launch
    a call (none for an empty view)."""
    tab = mc.get_tables(variant)
    table = tab.on(cuda, "ntri")
    rng = np.random.default_rng(off)
    base = torch.as_tensor(rng.integers(-7, tab.ncase + 7, 4 * 300000 + 9)
                           .astype(np.int32), device=cuda)
    assert base.data_ptr() % 16 == 0
    for n in (0, 1, 2, 3, 4, 5, 29, 4097, 4 * 270336 + 1, 4 * 300000 + 5):
        view = base[off: off + n]
        before = mc.ntri_of.launches
        got = mc.ntri_of(view, variant)
        assert mc.ntri_of.launches == before + (1 if n else 0)
        assert got.shape == view.shape and got.dtype == torch.int32
        assert torch.equal(got, mc._ntri_plain(view, table))
    grid = base[off: off + 4 * 1000].view(10, 20, 20)
    assert torch.equal(mc.ntri_of(grid, variant), mc._ntri_plain(grid, table))


def test_ext_from_bits_kernel(cuda):
    """The table-only kernel of classify_ext.cu over the full 256 x 64 x 9
    domain, a ragged tail and cases outside the table."""
    extras = np.asarray(
        [fb | (ib << 6) for ib in range(9) for fb in range(64)], np.int32)
    c = np.repeat(np.arange(256), len(extras)).astype(np.int32)
    e = np.tile(extras, 256)
    rng = np.random.default_rng(3)
    c = np.concatenate([c, rng.integers(-3, 260, 20001).astype(np.int32)])
    e = np.concatenate([e, rng.integers(0, 1024, 20001).astype(np.int32)])
    ct, et = torch.as_tensor(c, device=cuda), torch.as_tensor(e, device=cuda)
    before = mc33.ext_from_bits.launches
    got = mc33.ext_from_bits(ct, et)
    assert mc33.ext_from_bits.launches == before + 1
    assert torch.equal(got, mc33._ext_from_bits_plain(ct, et))
    assert torch.equal(got.cpu(), mc33.ext_from_bits(ct.cpu(), et.cpu()))


def _special_volume(dtype):
    """Random normal samples with NaN, +-inf, exact zeros and flat slabs."""
    rng = np.random.default_rng(7)
    vol = rng.standard_normal((33, 41, 70))
    flat = vol.reshape(-1)
    idx = rng.permutation(flat.size)
    flat[idx[:200]] = np.nan
    flat[idx[200:300]] = np.inf
    flat[idx[300:400]] = -np.inf
    flat[idx[400:2000]] = 0.0
    vol[10:13] = 0.25
    return torch.as_tensor(vol, dtype=dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_classify_ext_kernel(cuda, dtype):
    """Kernel B2 (fused) bit-equal to its plain version on the card, and to
    the plain version on the CPU: random, special-valued, batched and
    example-model volumes, with and without base_case, at two levels."""
    rng = np.random.default_rng(11)
    X = np.linspace(-1.1, 1.1, 56)
    vols = [
        torch.as_tensor(rng.standard_normal((12, 11, 13)), dtype=dtype),
        torch.as_tensor(rng.standard_normal((3, 9, 17, 33)), dtype=dtype),
        _special_volume(dtype),
        eval_classify._eval_volume(th.example(sp), X, X, X, dtype, "cpu"),
    ]
    for v in vols:
        vc = v.to(cuda)
        for level in (0.0, 0.125):
            before = mc33.classify_ext.launches
            got = mc33.classify_ext(vc, level)
            assert mc33.classify_ext.launches == before + 1
            assert torch.equal(got, mc33._classify_ext_plain(vc, level))
            assert torch.equal(got.cpu(), mc33.classify_ext(v, level))
        if v.dim() == 3:
            base = mc._cell_cases(vc)
            assert torch.equal(mc33.classify_ext(vc, base_case=base),
                               mc33.classify_ext(vc))
            junk = torch.full_like(base, 37)  # base_case is taken as given
            assert torch.equal(
                mc33.classify_ext(vc, base_case=junk),
                mc33._classify_ext_plain(vc, base_case=junk))


# Kernel B2's awkward shapes (nb, nx, ny, nz): axes of 2, primes, rows of
# 161 and 406 cells, rows of one cell, tile volumes in a batch.
B2_SHAPES = [(1, 2, 2, 2), (13, 2, 2, 2), (1, 2, 37, 3), (1, 3, 2, 41),
             (1, 37, 41, 43), (2, 17, 19, 23), (1, 4, 5, 162),
             (1, 3, 3, 407), (1, 20, 3, 162), (3, 33, 33, 33),
             (2, 5, 300, 2), (1, 2, 2, 1001)]


@pytest.mark.parametrize("shape", B2_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_classify_ext_kernel_shapes(cuda, dtype, shape):
    """Kernel B2 bit-equal to its plain version on shapes whose edges cut
    its row blocks and slabs everywhere, with base_case absent and given,
    and with slab lengths forced around the default; one launch a call."""
    rng = np.random.default_rng(sum(shape))
    v = rng.standard_normal(shape)
    v.reshape(-1)[rng.permutation(v.size)[: v.size // 9]] = 0.0
    vol = torch.as_tensor(v, dtype=dtype, device=cuda)
    if shape[0] == 1:
        vol = vol[0]
    want = mc33._classify_ext_plain(vol, 0.125)
    before = mc33.classify_ext.launches
    assert torch.equal(mc33.classify_ext(vol, 0.125), want)
    assert mc33.classify_ext.launches == before + 1
    base = mc._cell_cases(vol, 0.125)
    assert torch.equal(mc33.classify_ext(vol, 0.125, base), want)
    junk = torch.as_tensor(rng.integers(-3, 260, tuple(base.shape))
                           .astype(np.int32), device=cuda)
    assert torch.equal(mc33.classify_ext(vol, 0.125, junk),
                       mc33._classify_ext_plain(vol, 0.125, junk))
    for lx in (1, 7, 64):
        assert torch.equal(mc33._launch(vol, 0.125, base, lx), want), lx


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_classify_ext_kernel_special_cells(cuda, dtype):
    """Kernel B2 on _special_volume's NaN, inf, zero and flat cells, in
    (33, 33, 33)-sample tile volumes cut from it (a batch) and on the whole
    volume, with base_case absent and given."""
    v = _special_volume(dtype).to(cuda)
    tiles = torch.stack([v[:33, :33, :33], v[:33, 8:41, 37:70]])
    for vol in (v, tiles):
        want = mc33._classify_ext_plain(vol)
        assert torch.equal(mc33.classify_ext(vol), want)
        base = mc._cell_cases(vol)
        assert torch.equal(mc33.classify_ext(vol, base_case=base), want)


@pytest.mark.parametrize("density", [0.0, 1e-3, 0.5, 1.0])
@pytest.mark.parametrize("n", [1, 31, 1025, 100003])
def test_compact_kernels(cuda, n, density):
    m = torch.as_tensor(np.random.default_rng(n).random(n) < density,
                        device=cuda)
    for cap in (int(m.sum()) + 3, max(1, int(m.sum()) // 2)):
        ik, tk = compact.indices_of(m, cap)
        ip, tp = compact._indices_of_plain(m, cap)
        assert torch.equal(ik, ip) and int(tk) == int(tp)
        ik, wk, tk = compact.indices_and_ranktable_of(m, cap)
        ip, wp, tp = compact._ranktable_plain(m, cap)
        assert torch.equal(ik, ip) and torch.equal(wk, wp)
        assert int(tk) == int(tp)


def _b4_masks(n):
    rng = np.random.default_rng(n)
    last = np.zeros(n, bool)
    last[-1] = True
    return {"none": np.zeros(n, bool), "all": np.ones(n, bool),
            "last": last, "1e-3": rng.random(n) < 1e-3,
            "0.5": rng.random(n) < 0.5}


@pytest.mark.parametrize("kind", ["none", "all", "last", "1e-3", "0.5"])
def test_indices_of_over_many_chunks(cuda, kind):
    """Kernel B4 on 2^24 + 13 slots (over a thousand chunks of its
    look-back), with capacity above, at and below the count."""
    m = torch.as_tensor(_b4_masks(2**24 + 13)[kind], device=cuda)
    total = int(m.sum())
    for cap in (total + 4099, total, max(1, total // 3)):
        before = compact.indices_of.launches
        ik, tk = compact.indices_of(m, cap)
        assert compact.indices_of.launches == before + 1
        ip, tp = compact._indices_of_plain(m, cap)
        assert torch.equal(ik, ip) and int(tk) == int(tp) == total


@pytest.mark.parametrize("start", [1, 3, 8, 15])
def test_indices_of_on_a_misaligned_view(cuda, start):
    """A bool view whose first byte is not 16-byte aligned, with a ragged
    end: kernel B4 reads its edges byte by byte and equals plain."""
    base = torch.as_tensor(_b4_masks(70001)["0.5"], device=cuda)
    for end in (base.numel(), base.numel() - 5, start + 40):
        m = base[start:end]
        assert m.data_ptr() % 16 != 0
        cap = int(m.sum()) + 9
        ik, tk = compact.indices_of(m, cap)
        ip, tp = compact._indices_of_plain(m, cap)
        assert torch.equal(ik, ip) and int(tk) == int(tp)


def test_indices_of_back_to_back_on_one_stream(cuda):
    """Eight launches of kernel B4 queued on one stream with no sync between
    them (each scratch is freed to the stream's pool and may be the next
    one's), then one more pair on two other streams; each result equals
    the plain version."""
    rng = np.random.default_rng(8)
    masks = [torch.as_tensor(rng.random(n) < d, device=cuda) for n, d in
             [(2**20 + 3, 0.5), (5, 1.0), (2**22, 1e-3), (16384, 1.0),
              (3 * 16384 + 1, 0.0), (2**21 - 7, 0.9), (100003, 0.01),
              (2**23, 0.5)]]
    caps = [int(m.sum()) + 17 for m in masks]
    torch.cuda.synchronize()
    got = [compact.indices_of(m, c) for m, c in zip(masks, caps)]
    for m, c, (ik, tk) in zip(masks, caps, got):
        ip, tp = compact._indices_of_plain(m, c)
        assert torch.equal(ik, ip) and int(tk) == int(tp)
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    out = []
    for st, m, c in zip(streams, masks[:2], caps[:2]):
        st.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(st):
            out.append(compact.indices_of(m, c))
    torch.cuda.synchronize()
    for m, c, (ik, tk) in zip(masks, caps, out):
        ip, tp = compact._indices_of_plain(m, c)
        assert torch.equal(ik, ip) and int(tk) == int(tp)


def test_ranktable_kernel_over_many_blocks(cuda):
    """Kernel B5 (one pass) on 2^24 + 13 slots: bit-equal to plain."""
    for kind, m in _b4_masks(2**24 + 13).items():
        m = torch.as_tensor(m, device=cuda)
        cap = int(m.sum()) + 3
        got = compact.indices_and_ranktable_of(m, cap)
        want = compact._ranktable_plain(m, cap)
        assert all(torch.equal(g, w) for g, w in zip(got, want)), kind


def test_compact_empty_mask_counts_no_launch(cuda):
    m = torch.zeros(0, dtype=torch.bool, device=cuda)
    wrappers = (compact.indices_of, compact.indices_and_ranktable_of)
    before = [w.launches for w in wrappers]
    for w in wrappers:
        assert int(w(m, 4)[-1]) == 0
    assert [w.launches for w in wrappers] == before


def test_point_call_runs_on_card(cuda):
    pts = np.array([[0.0, 0.0, 0.0], [2.0, 0.0, 0.0]])
    d = sp.sphere(1)(pts)
    assert d.device.type == "cuda"
    np.testing.assert_array_equal(d.cpu().numpy(), [[-1.0], [1.0]])


def _count_syncs(fn):
    """Host waits for the card during ``fn()``, counted by PyTorch's sync
    debug mode."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    # Not the once-per-process notice that the debug mode is a prototype.
    return [str(w.message) for w in caught
            if "called a synchronizing" in str(w.message)]


@pytest.mark.parametrize("variant", ["fast", "lewiner"])
@pytest.mark.parametrize("dtype, syncs", [(torch.float32, 2),
                                          (torch.float64, 2)])
def test_generate_syncs_only_to_fetch(cuda, dtype, syncs, variant):
    """generate() waits for the card only where it fetches: once for every
    count before emit (the lewiner conflicted-cell count rides that fetch)
    and once for the results, whatever their dtypes.  Measured with the
    counts memo emptied, after a warm-up run."""
    kw = dict(samples=2**15, verbose=False, mc_variant=variant, dtype=dtype)
    th.example(sp).generate(**kw)
    engine._COUNTS_MEMO.clear()
    msgs = _count_syncs(lambda: th.example(sp).generate(**kw))
    assert len(msgs) == syncs, msgs


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_memoized_generate_is_one_transfer(cuda, dtype):
    """A repeat call on an unchanged model finds bounds and counts
    memoized: it waits for the card once, for the mesh and the pending
    statistics together, and returns the same soup and stats."""
    kw = dict(samples=2**15, verbose=False, dtype=dtype)
    engine._COUNTS_MEMO.clear()
    first = th.example(sp).generate(**kw)
    stats = dict(engine.LAST_STATS)
    out = []
    msgs = _count_syncs(lambda: out.append(th.example(sp).generate(**kw)))
    assert len(msgs) == 1, msgs
    np.testing.assert_array_equal(out[0], first)
    for key in ("skipped", "empty", "nonempty", "triangles",
                "mc33_conflicted_cells"):
        assert engine.LAST_STATS[key] == stats[key]


@pytest.mark.parametrize("variant", ["fast", "lewiner"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_generate_on_card_equals_cpu(cuda, dtype, variant):
    kw = dict(samples=2**15, verbose=False, mc_variant=variant, dtype=dtype)
    got = th.example(sp).generate(**kw)
    want = th.example(sp).generate(device="cpu", **kw)
    np.testing.assert_array_equal(got, want)
    assert ("mc33_conflicted_cells" in engine.LAST_STATS) == (
        variant == "lewiner")


def test_fingerprint_fetches_card_leaves_in_one_transfer(cuda):
    from sdf_torch.core.node import cast
    from sdf_torch.utils import checkpoint as ckpt

    f = sp.sphere(0.7, center=(0.1, 0, 0)) & sp.box((1, 2, 3))
    X = np.arange(-1.0, 1.0, 0.1)
    on_card = cast(f, torch.float64, cuda)
    out = []
    msgs = _count_syncs(
        lambda: out.append(ckpt.fingerprint(on_card, X, X, X, True)))
    assert len(msgs) == 1, msgs
    assert out[0] == ckpt.fingerprint(f, X, X, X, True)


def test_default_generate_launches_every_kernel(cuda):
    wrappers = [eval_classify.eval_and_classify, mc33.classify_ext,
                mc.ntri_of, compact.indices_of,
                compact.indices_and_ranktable_of]
    before = [w.launches for w in wrappers]
    pts = th.example(sp).generate(samples=2**15, verbose=False)
    assert len(pts) and all(w.launches > b for w, b in zip(wrappers, before))


# --- the tiled sparse path: kernels B6 and B7 ----------------------------------


def _padded(A, tile):
    return np.concatenate([A, np.full(tile, A[-1])])


@pytest.mark.parametrize("tile", [1, 8, 16, 32, 33, 64, 65, 203])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_eval_tiles_kernels(cuda, dtype, tile):
    """Kernel B6 bit-equal to its plain version on a random half of the
    tiles of an odd-sized grid (edge tiles clamp; padded rows repeat tile
    0), with ``live`` (the padded rows copied) and without, and kernel B7
    without fields equal to B6.  Tile 203 takes more than 48 KB of shared
    memory a block."""
    X = np.linspace(-1.1, 1.1, 37)
    Y = np.linspace(-1.0, 1.2, 41)
    Z = np.linspace(-1.2, 1.0, 70)
    t = th.grid_tiles((37, 41, 70), tile, np.random.default_rng(tile))
    nt = len(t)
    t = np.concatenate([t, np.zeros((3, 3), np.int32)])
    tiles = torch.as_tensor(t, device=cuda)
    b6, b7 = (eval_classify.eval_tiles_and_classify_batched,
              eval_classify.eval_tiles_and_classify)
    for f in (th.example(sp), zoo.blobby()):
        vp = eval_classify._eval_tiles(f, X, Y, Z, tiles, tile, dtype)
        cp = mc._cell_cases(vp)
        for live in (None, nt):
            before = b6.launches, b7.launches
            vk, ck = b6(f, X, Y, Z, tiles, tile, dtype, live=live)
            v7, c7 = b7(f, _padded(X, tile), _padded(Y, tile),
                        _padded(Z, tile), tiles, tile, dtype, live=live)
            assert (b6.launches, b7.launches) == (before[0] + 1,
                                                  before[1] + 1)
            assert _same_bits(vk, vp) and torch.equal(ck, cp)
            assert _same_bits(v7, vk) and torch.equal(c7, ck)


@pytest.mark.parametrize("tile, blocks, csize", [
    (8, 4, 1), (8, 3, 3), (7, 2, 1), (16, 6, 3), (32, 16, 8), (32, 8, 2),
    (33, 5, 5), (243, 16, 8)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_eval_tiles_forced_plans(cuda, dtype, tile, blocks, csize):
    """Kernel B6 under cuts of a row the default plan does not take at
    these tiles: clusters of one block (each evaluates its halo), rows of
    several clusters, clusters of 3 and 5; and tile 243's own plan, two
    clusters of 8 with 121 KB of shared memory a block.  Each bit-equal to
    the plain version."""
    X = np.linspace(-1.1, 1.1, 37 if tile < 100 else 300)
    t = th.grid_tiles((len(X),) * 3, tile,
                      np.random.default_rng(tile + blocks))
    tiles = torch.as_tensor(t[:2], device=cuda)
    b6 = eval_classify.eval_tiles_and_classify_batched
    for f in (th.example(sp), zoo.blobby()):
        vk, ck = eval_classify._launch_tiles(f, X, X, X, tiles, tile, dtype,
                                             None, (), b6, blocks, csize)
        vp = eval_classify._eval_tiles(f, X, X, X, tiles, tile, dtype)
        assert _same_bits(vk, vp) and torch.equal(ck, mc._cell_cases(vp))


@pytest.mark.parametrize("name", ["rotated", "circular"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_eval_tiles_kernel_with_fields(cuda, dtype, name):
    """Kernel B7 with recorded fields bit-equal to its plain version, and
    to the expression evaluated whole with torch ops on the card, with
    ``live`` (fields recorded for the evaluated rows only) and without."""
    f = th.gather_models(sp)[name]
    tile = 8
    X = np.linspace(-1.3, 1.3, 45)
    Xp = _padded(X, tile)
    t = th.grid_tiles((45,) * 3, tile, np.random.default_rng(5))
    nt = len(t)
    tiles = torch.as_tensor(np.concatenate([t, np.zeros((4, 3), np.int32)]),
                            device=cuda)
    axes = eval_classify._axes(Xp, Xp, Xp, dtype, cuda)
    fields = hybrid.record_tiles(f, *axes, tiles, tile)
    assert len(fields) == (2 if name == "circular" else 1)
    vp = eval_classify._eval_tiles(hybrid.to_kernel_tree(f), Xp, Xp, Xp, tiles,
                                   tile, dtype, clamp=False, fields=fields)
    whole = eval_classify._eval_tiles(f, Xp, Xp, Xp, tiles, tile, dtype,
                                      clamp=False)
    for live in (None, nt):
        before = eval_classify.eval_tiles_and_classify.launches
        vk, ck = eval_classify.eval_tiles_and_classify(f, Xp, Xp, Xp, tiles,
                                                       tile, dtype, live=live)
        assert eval_classify.eval_tiles_and_classify.launches == before + 1
        assert _same_bits(vk, vp) and _same_bits(vk, whole)
        assert torch.equal(ck, mc._cell_cases(vp))


def test_empty_tile_list_launches_nothing(cuda):
    X = np.linspace(-1, 1, 20)
    tiles = torch.zeros((0, 3), dtype=torch.int32, device=cuda)
    for w in (eval_classify.eval_tiles_and_classify_batched,
              eval_classify.eval_tiles_and_classify):
        before = w.launches
        vols, case = w(sp.sphere(1), X, X, X, tiles, 8, torch.float32)
        assert vols.shape == (0, 9, 9, 9) and case.shape == (0, 8, 8, 8)
        assert w.launches == before


def _clear_memos():
    from sdf_torch.core import sparse

    for memo in (engine._COUNTS_MEMO, engine._SKIP_MEMO, sparse._COUNTS_MEMO):
        memo.clear()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_explicit_tiles_sync_twice_then_once(cuda, dtype):
    """sparse='tiles' waits for the card for the tiles counts and for the
    mesh (the cull mask is a host evaluation); a repeat finds the counts
    memoized and waits once."""
    kw = dict(samples=2**15, batch_size=8, sparse="tiles", verbose=False,
              dtype=dtype)
    first = th.example(sp).generate(**kw)  # warm-up: builds, table uploads
    _clear_memos()
    msgs = _count_syncs(lambda: th.example(sp).generate(**kw))
    assert len(msgs) == 2, msgs
    out = []
    msgs = _count_syncs(lambda: out.append(th.example(sp).generate(**kw)))
    assert len(msgs) == 1, msgs
    np.testing.assert_array_equal(out[0], first)
    np.testing.assert_array_equal(
        first, th.example(sp).generate(device="cpu", **kw))


def test_routed_run_syncs_three_times_then_twice(cuda):
    """A sparse=True run that the cull routes to the tiles: the dense counts
    fetch, the tiles counts fetch, the mesh; on a repeat the tiles counts
    are memoized (the dense counts of a routed run never are)."""
    kw = dict(bounds=((-6,) * 3, (6,) * 3), step=0.12, batch_size=16,
              verbose=False)
    first = sp.sphere(1).generate(**kw)
    assert engine.LAST_STATS["auto_tiles"] >= engine.AUTO_TILES_THRESHOLD
    _clear_memos()
    msgs = _count_syncs(lambda: sp.sphere(1).generate(**kw))
    assert len(msgs) == 3, msgs
    assert not engine._COUNTS_MEMO
    out = []
    msgs = _count_syncs(lambda: out.append(sp.sphere(1).generate(**kw)))
    assert len(msgs) == 2, msgs
    np.testing.assert_array_equal(out[0], first)


def test_tiles_path_launches_its_kernels(cuda):
    b6 = eval_classify.eval_tiles_and_classify_batched
    b7 = eval_classify.eval_tiles_and_classify
    wrappers = [b6, mc33.classify_ext, mc.ntri_of, compact.indices_of,
                compact.indices_and_ranktable_of]
    before = [w.launches for w in wrappers] + [
        b7.launches, eval_classify.eval_and_classify.launches]
    kw = dict(samples=2**15, batch_size=8, sparse="tiles", verbose=False)
    pts = th.example(sp).generate(**kw)
    after = [w.launches for w in wrappers]
    assert len(pts) and all(a > b for a, b in zip(after, before))
    assert [b7.launches, eval_classify.eval_and_classify.launches] == before[5:]
    g = th.gather_models(sp)["rotated"]
    kw["bounds"] = ((-1.3,) * 3, (1.3,) * 3)
    got = g.generate(**kw)
    assert b7.launches == before[5] + 1 and b6.launches == after[0]
    np.testing.assert_array_equal(got, g.generate(device="cpu", **kw))


@pytest.mark.parametrize("tile", [8, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_tile_shapes_through_the_other_kernels(cuda, dtype, tile):
    """Kernels B2 to B5 on what the tiled path gives them: the batched tile
    volumes with kernel B6's case codes as base_case, the tile case grid,
    the tile-cell mask and the per-tile [x|y|z] edge mask; each equal to its
    plain version."""
    from sdf_torch.core import sparse

    f = zoo.blobby()
    (x0, y0, z0), (x1, y1, z1) = engine._estimate_bounds(f, torch.float32)
    X, Y, Z = (np.linspace(a, b, 75) for a, b in ((x0, x1), (y0, y1), (z0, z1)))
    skip = engine._skip_mask(f, X, Y, Z, tile, torch.float32)
    active = np.argwhere(~skip)
    nt, ntc = len(active), mc.round_capacity(len(active))
    t = np.zeros((ntc, 3), np.int32)
    t[:nt] = active
    tiles = torch.as_tensor(t, device=cuda)
    live = torch.arange(ntc, device=cuda) < nt
    vols, case = eval_classify.eval_tiles_and_classify_batched(
        f, X, Y, Z, tiles, tile, dtype)
    ext = mc33.classify_ext(vols, base_case=case)
    assert torch.equal(ext, mc33._classify_ext_plain(vols, base_case=case))
    assert torch.equal(ext, mc33.classify_ext(vols))
    table = mc.get_tables("lewiner").on(cuda, "ntri")
    assert torch.equal(mc.ntri_of(ext, "lewiner"), mc._ntri_plain(ext, table))
    _, _, ncell, _, nedge, emask = sparse._count_tiles(
        vols, tiles, live, (74, 74, 74), tile, ext, "lewiner")
    valid = sparse._cell_valid(tiles, live, (74, 74, 74), tile)
    cells = ((mc.ntri_of(ext, "lewiner") * valid) > 0).reshape(-1)
    assert int(cells.sum()) == int(ncell) > 0 and int(nedge) > 0
    cap = mc.round_capacity(int(ncell))
    ik, nk = compact.indices_of(cells, cap)
    ip, n_p = compact._indices_of_plain(cells, cap)
    assert torch.equal(ik, ip) and int(nk) == int(n_p)
    m = emask.reshape(-1)
    cap = mc.round_capacity(int(nedge))
    got = compact.indices_and_ranktable_of(m, cap)
    want = compact._ranktable_plain(m, cap)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_gather_expression_at_the_defaults_runs_the_per_tile_kernel(cuda):
    """generate() at its defaults on a gather-bearing expression routes by
    the cull alone, as the JAX package does: below AUTO_TILES_THRESHOLD it
    stays dense and kernel B1 reads the fields; with the threshold under
    the cull it goes to the tiles and runs the per-tile kernel B7.  Either
    way the soup equals the device='cpu' run; sparse=False runs B1 with
    fields."""
    b7 = eval_classify.eval_tiles_and_classify
    b1 = eval_classify.eval_and_classify
    # the rotated model: circular_array takes sin and cos on the device,
    # which differ from the CPU's by an ulp and can flip a table index
    g = th.gather_models(sp)["rotated"]
    kw = dict(bounds=((-1.3,) * 3, (1.3,) * 3), samples=2**15, batch_size=8,
              verbose=False)
    before = b7.launches, b1.launches
    got = g.generate(**kw)
    assert "gather_tiles" not in engine.LAST_STATS
    routed = "auto_tiles" in engine.LAST_STATS
    assert (b7.launches, b1.launches) == (before[0] + routed, before[1] + 1)
    np.testing.assert_array_equal(got, g.generate(device="cpu", **kw))
    threshold = engine.AUTO_TILES_THRESHOLD
    engine.AUTO_TILES_THRESHOLD = 0.0
    engine._COUNTS_MEMO.clear()  # the dense run's counts would stop the route
    try:
        before = b7.launches
        got = g.generate(**kw)
        assert "auto_tiles" in engine.LAST_STATS
        assert b7.launches == before + 1
        np.testing.assert_array_equal(got, g.generate(device="cpu", **kw))
    finally:
        engine.AUTO_TILES_THRESHOLD = threshold
        engine._COUNTS_MEMO.clear()
    before = b7.launches, b1.launches
    dense = g.generate(sparse=False, **kw)
    assert (b7.launches, b1.launches) == (before[0], before[1] + 1)
    np.testing.assert_array_equal(dense, g.generate(sparse=False,
                                                    device="cpu", **kw))


# --- kernel B1 with field inputs, kernel B5 in one pass ----------------------


def _field_model(nf):
    """A gather-bearing model that records ``nf`` fields: a 2D
    circular_array of ``nf`` polygons (each a gather occurrence), extruded."""
    poly = sp.polygon(th.polygon_points(3, 7)).scale(0.45).translate((0.5, 0))
    shape = poly.circular_array(nf) if nf > 1 else poly
    return shape.extrude(0.8) | sp.sphere(0.3)


@pytest.mark.parametrize("nf", [1, 2, eval_classify.MAX_FIELDS])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_eval_classify_kernel_with_fields(cuda, dtype, nf):
    """Kernel B1 reading nf recorded fields, bit-equal to its plain version
    on the same fields and to the expression evaluated whole with torch
    ops, on a grid whose edges cut the launch plan."""
    f = _field_model(nf)
    X = np.linspace(-1.1, 1.1, 37)
    Y = np.linspace(-1.0, 1.2, 41)
    Z = np.linspace(-0.6, 0.6, 70)
    fields = eval_classify.record_fields(f, X, Y, Z, dtype, cuda)
    assert len(fields) == nf
    before = eval_classify.eval_and_classify.launches
    vk, ck = eval_classify.eval_and_classify(f, X, Y, Z, dtype, cuda, fields)
    assert eval_classify.eval_and_classify.launches == before + 1
    vp, cp = eval_classify._eval_classify_plain(
        hybrid.to_kernel_tree(f), X, Y, Z, dtype, cuda, fields)
    assert _same_bits(vk, vp) and torch.equal(ck, cp)
    whole, _ = eval_classify._eval_classify_plain(f, X, Y, Z, dtype, cuda)
    assert _same_bits(vk, whole)


def test_eval_classify_kernel_refuses_too_many_fields(cuda):
    f = _field_model(eval_classify.MAX_FIELDS + 1)
    X = np.linspace(-1, 1, 9)
    with pytest.raises(ValueError, match="at most %d field inputs"
                       % eval_classify.MAX_FIELDS):
        eval_classify.eval_and_classify(f, X, X, X, torch.float32, cuda)


@pytest.mark.parametrize("start", [1, 3, 8, 15])
def test_ranktable_on_a_misaligned_view(cuda, start):
    """A bool view whose first byte is not 16-byte aligned, with ragged
    ends (n mod 32 != 0): kernel B5's table and indices equal plain, with
    capacity above and below the count."""
    base = torch.as_tensor(_b4_masks(70001)["0.5"], device=cuda)
    for end in (base.numel(), base.numel() - 5, start + 40, start + 1):
        m = base[start:end]
        assert m.data_ptr() % 16 != 0
        for cap in (int(m.sum()) + 9, int(m.sum()) // 2):
            before = compact.indices_and_ranktable_of.launches
            got = compact.indices_and_ranktable_of(m, cap)
            assert compact.indices_and_ranktable_of.launches == before + 1
            want = compact._ranktable_plain(m, cap)
            assert all(torch.equal(g, w) for g, w in zip(got, want))


def _gather_generate_models(tmp_path):
    pts, tris = th.sphere_mesh_points()
    path = str(tmp_path / "ico.stl")
    sp.stl.write_binary_stl(path, pts[tris].reshape(-1, 3))
    mesh = sp.Mesh.from_file(path).sdf(voxel_size=0.1, half_width=0.2)
    return {
        "polygon": th.polygon_model(sp),
        "mesh": mesh.erode(0.05).shell(0.1) & sp.slab(y0=0),
        "legacy": th.legacy_closure(sp) & sp.box(1.2),
    }


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_sparse_false_on_gather_models_runs_the_dense_kernel(cuda, dtype,
                                                             tmp_path):
    """sparse=False on the polygon, mesh and legacy models launches B1 once
    (with its fields) and B7 not at all, and the soup is bit-equal to the
    device='cpu' run."""
    b7 = eval_classify.eval_tiles_and_classify
    b1 = eval_classify.eval_and_classify
    for name, f in _gather_generate_models(tmp_path).items():
        kw = dict(samples=2**15, verbose=False, sparse=False, dtype=dtype)
        before = b1.launches, b7.launches
        got = f.generate(**kw)
        assert (b1.launches, b7.launches) == (before[0] + 1, before[1]), name
        assert "record_fields" in engine.LAST_STATS, name
        assert len(got), name
        np.testing.assert_array_equal(got, f.generate(device="cpu", **kw),
                                      err_msg=name)


def test_gather_generate_syncs_as_before(cuda):
    """A gather-bearing model (the polygon: torch ops only) waits for the
    card as a gather-free one does: 2 syncs dense, 1 on a memo hit."""
    kw = dict(samples=2**15, verbose=False, sparse=False)
    th.polygon_model(sp).generate(**kw)
    engine._COUNTS_MEMO.clear()
    msgs = _count_syncs(lambda: th.polygon_model(sp).generate(**kw))
    assert len(msgs) == 2, msgs
    msgs = _count_syncs(lambda: th.polygon_model(sp).generate(**kw))
    assert len(msgs) == 1, msgs


# --- the differentiable path -------------------------------------------------


def _mean_vertex_grads(f, variant, device, res=33):
    """diffmesh.extract of ``f`` in float64 and the gradient of a weighted
    sum of its mean vertex with respect to every leaf."""
    from sdf_torch.core import diffmesh
    from sdf_torch.core.node import tree_leaves
    from sdf_torch.models import fit

    node = fit._params(f, torch.float64, device)
    bounds = ((-1.6,) * 3, (1.6,) * 3)
    verts, n, valid = diffmesh.extract(node, bounds, res, None, torch.float64,
                                       variant, device)
    w = valid.to(verts.dtype)[:, None, None]
    mv = (verts * w).sum(dim=(0, 1)) / torch.clamp(3.0 * valid.sum(), min=1.0)
    loss = (mv * torch.arange(1, 4, dtype=torch.float64, device=device)).sum()
    grads = torch.autograd.grad(loss, tree_leaves(node))
    return verts.detach().cpu(), int(n), valid.cpu(), [g.cpu() for g in grads]


@pytest.mark.parametrize("variant", ["lewiner", "fast"])
def test_extract_matches_cpu(cuda, variant):
    """diffmesh.extract on the card launches B2 (lewiner only), B3 twice and
    B4 once; n, valid and the vertices are bit-equal to the device='cpu'
    call, the leaf gradients within rtol 1e-9 (the card sums the gathers'
    gradients in another order)."""
    f = sp.sphere(1.0).union(sp.box(1.5), k=0.2)
    wrappers = (mc33.classify_ext, mc.ntri_of, compact.indices_of)
    before = [w.launches for w in wrappers]
    got = _mean_vertex_grads(f, variant, cuda)
    launched = [w.launches - b for w, b in zip(wrappers, before)]
    assert launched == [int(variant == "lewiner"), 2, 1]
    want = _mean_vertex_grads(f, variant, "cpu")
    assert got[1] == want[1] > 0
    assert torch.equal(got[2], want[2])
    assert _same_bits(got[0], want[0])
    for g, w in zip(got[3], want[3]):
        torch.testing.assert_close(g, w, rtol=1e-9, atol=1e-15)


def test_extract_syncs_once(cuda):
    """The forward waits for the card once (the overflow check reads the
    triangle total); the backward and a fit step not at all."""
    from sdf_torch.core import diffmesh
    from sdf_torch.core.node import tree_leaves
    from sdf_torch.models import fit

    node = fit._params(th.example(sp), torch.float32, cuda)
    bounds = ((-1.6,) * 3, (1.6,) * 3)
    diffmesh.mean_vertex(node, bounds, 24, device=cuda)  # warm the tables
    out = []
    msgs = _count_syncs(lambda: out.append(
        diffmesh.mean_vertex(node, bounds, 24, device=cuda).sum()))
    assert len(msgs) == 1, msgs
    msgs = _count_syncs(lambda: torch.autograd.grad(out[0], tree_leaves(node)))
    assert not msgs, msgs
    p = torch.rand((512, 3), device=cuda) * 2 - 1
    t = th.example(sp)(p)[:, 0]
    fit.fit_step(sp.sphere(0.5), p, t, 0.05)
    msgs = _count_syncs(lambda: fit.fit_step(sp.sphere(0.5), p, t, 0.05))
    assert not msgs, msgs


def test_fit_step_and_slice_match_cpu(cuda):
    """One fit step on the card equals the device='cpu' step in float64
    (rtol 1e-12: reductions in another order); sample_slice's plane is
    bit-equal to the device='cpu' call."""
    from sdf_torch.core.node import tree_leaves
    from sdf_torch.models import fit

    pts = np.random.default_rng(3).uniform(-1.5, 1.5, (2048, 3))
    out = []
    for device in (cuda, "cpu"):
        p = torch.as_tensor(pts, device=device)
        t = th.example(sp)(p)[:, 0]
        node, loss = fit.fit_step(sp.sphere(0.8), p, t, 0.05)
        out.append([loss.cpu()] + [w.detach().cpu() for w in
                                   tree_leaves(node)])
    for a, b in zip(*out):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=0)
    for dtype in (torch.float32, torch.float64):
        a = sp.sample_slice(th.example(sp), 96, 80, y=0.05, dtype=dtype,
                            device=cuda)
        b = sp.sample_slice(th.example(sp), 96, 80, y=0.05, dtype=dtype,
                            device="cpu")
        np.testing.assert_array_equal(a[0], b[0])
        assert a[1:] == b[1:]


def test_two_gloo_ranks_share_the_card(cuda, tmp_path):
    """generate(mesh=) on two gloo ranks of card 0, z slabs and the tile
    list: each rank launches its own kernels (B1, B2, B3, B4, B5 on a
    slab; B6, B2, B3, B4, B5 on its tiles), and the gathered soup equals
    the single-device run on the card as a set of triangles."""
    got = th.spawn_ranks(th.cuda_rank, 2, tmp_path)
    for sparse, launches in ((False, [1, 1, 2, 1, 1, 0]),
                             ("tiles", [0, 1, 2, 1, 1, 1])):
        full, launched, device = got[sparse]
        want = sp.generate(th.example(sp), samples=2**18, verbose=False,
                           sparse=sparse, device=cuda)
        assert device == 0 and len(want) > 0
        assert np.array_equal(th.canon(full), th.canon(want)), sparse
        assert launched == launches, (sparse, launched)


@pytest.mark.parametrize("n, nb", [(2, 3), (8, 9), (33, 5), (64, 9),
                                   (128, 2)])
def test_label_kernel_matches_plain(cuda, n, nb):
    """Kernel L1 against its plain version on the card: the corner class
    bits and canonical labels bit-equal, on realizations of cases with
    ambiguous faces and tunnels; one launch a call."""
    from sdf_torch.core import mc33_build as mb

    rng = np.random.default_rng(n)
    v = np.concatenate([mb.sample_realizations(c, nb, rng)
                        for c in (90, 105, 165, 60)])
    k = torch.from_numpy(mb.trilinear_coeffs(v)).to(cuda)
    t = torch.from_numpy(np.linspace(0.0, 1.0, n)).to(cuda)
    before = mb.label_corners.launches
    got = mb.label_corners(k, t)
    assert mb.label_corners.launches == before + 1
    want = mb._label_corners_plain(k, t)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    cpu = mb.label_corners(k.cpu(), t.cpu())
    assert torch.equal(got[0].cpu(), cpu[0]) and torch.equal(got[1].cpu(),
                                                             cpu[1])


def test_build_tables_on_the_card_equals_cpu(cuda):
    """The builder at (600, 3, 8), which escalates to n=256 and leaves 11
    conflicted buckets: every array equal between the card and the CPU."""
    from sdf_torch.core import mc33_build as mb

    got = mb.build_tables(600, 3, 8, seed=7, device=cuda)
    want = mb.build_tables(600, 3, 8, seed=7, device="cpu")
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key])


# --- elementwise forms and the automatic field route ------------------------


def _wide_axes(dtype):
    """Axes of wide-spread values with the special ones (signed zeros,
    halves, integers; z also infinities and NaN), from a seed."""
    rng = np.random.default_rng(22)
    special = [0.0, -0.0, 0.5, -0.5, 1.0, -1.0, 2.0, -3.0, 0.7, -0.7, 88.0]
    axes = [np.concatenate([special, rng.standard_normal(n) * 10.0
                            ** rng.uniform(-3, 2, n)])[:n]
            for n in (29, 26, 24)]
    axes[2][-3:] = [np.inf, -np.inf, np.nan]
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    return [a.astype(np_dtype).astype(np.float64) for a in axes]


@pytest.mark.parametrize("name", sorted(th.elementwise_forms()))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_elementwise_form_in_b1_and_b6(cuda, dtype, name):
    """Each form the recorder emits, through B1 and B6, bit-equal to its
    plain version on the card (NaN payloads included)."""
    f = th.form_model(sp, th.elementwise_forms()[name])
    X, Y, Z = _wide_axes(dtype)
    vk, ck = eval_classify.eval_and_classify(f, X, Y, Z, dtype, cuda)
    vp, cp = eval_classify._eval_classify_plain(f, X, Y, Z, dtype, cuda)
    assert _same_bits(vk, vp) and torch.equal(ck, cp)
    tiles = torch.as_tensor(np.ascontiguousarray(
        np.argwhere(np.ones((4, 4, 3), bool)), np.int32), device=cuda)
    tk, tck = eval_classify.eval_tiles_and_classify_batched(
        f, X, Y, Z, tiles, 8, dtype)
    tp, tcp = eval_classify._plain_tiles(f, X, Y, Z, tiles, 8, dtype, None)
    assert _same_bits(tk, tp) and torch.equal(tck, tcp)


@pytest.mark.parametrize("name", sorted(th.pow_forms()))
def test_float32_power_in_b1_and_b6(cuda, name):
    """Each general power, which has a form in a float32 body only, through
    B1 and B6 in float32, bit-equal to its plain version on the card."""
    f = th.form_model(sp, th.pow_forms()[name])
    X, Y, Z = _wide_axes(torch.float32)
    vk, ck = eval_classify.eval_and_classify(f, X, Y, Z, torch.float32, cuda)
    vp, cp = eval_classify._eval_classify_plain(f, X, Y, Z, torch.float32,
                                                cuda)
    assert _same_bits(vk, vp) and torch.equal(ck, cp)
    tiles = torch.as_tensor(np.ascontiguousarray(
        np.argwhere(np.ones((4, 4, 3), bool)), np.int32), device=cuda)
    tk, tck = eval_classify.eval_tiles_and_classify_batched(
        f, X, Y, Z, tiles, 8, torch.float32)
    tp, tcp = eval_classify._plain_tiles(f, X, Y, Z, tiles, 8, torch.float32,
                                         None)
    assert _same_bits(tk, tp) and torch.equal(tck, tcp)


class _PlainEval:
    """B1, B6 and B7 replaced by their plain versions on the card."""

    def __init__(self, monkeypatch):
        ec = eval_classify
        monkeypatch.setattr(ec, "_launch", lambda sdf, X, Y, Z, dtype, device,
                            lx=None, fields=(): ec._eval_classify_plain(
                                sdf, X, Y, Z, dtype, device, fields))
        monkeypatch.setattr(
            ec, "_launch_tiles",
            lambda sdf, X, Y, Z, tiles, tile, dtype, live, fields, counter,
            blocks=None, csize=None: ec._plain_tiles(
                sdf, X, Y, Z, tiles, tile, dtype, live, fields=fields,
                clamp=counter is ec.eval_tiles_and_classify_batched))


C4 = {"tanh": (torch.tanh, 1304), "atan": (torch.atan, 1304),
      "exp(-t)": (lambda t: torch.exp(-t), 1640)}
C4_KW = dict(samples=2**15, bounds=((-2.0,) * 3, (2.0,) * 3), verbose=False)


@pytest.mark.parametrize("name", sorted(C4))
def test_c4_models_mesh_on_the_card(cuda, monkeypatch, name):
    """The fault's models at 2**15 on the card: the reference's triangle
    counts, B1 launched, the soup bit-equal to the plain B1's on the card."""
    op, tris = C4[name]
    eval_classify.eval_and_classify.launches = 0
    got = sp.generate(th.blob(sp, op), **C4_KW)
    assert len(got) // 3 == tris
    assert eval_classify.eval_and_classify.launches == 1
    assert "field_route_ops" not in engine.LAST_STATS
    engine._COUNTS_MEMO.clear()
    _PlainEval(monkeypatch)
    np.testing.assert_array_equal(sp.generate(th.blob(sp, op), **C4_KW), got)


def _erf_model():
    return (th.blob(sp, torch.erf).rotate(0.3, sp.X)
            | th.blob(sp, torch.tanh, 0.3).translate((0.8, 0, 0)))


@pytest.mark.parametrize("sparse, kernel", [
    (False, eval_classify.eval_and_classify),
    ("tiles", eval_classify.eval_tiles_and_classify)])
def test_erf_routes_to_a_field_on_the_card(cuda, monkeypatch, sparse,
                                           kernel):
    """An erf node (no form) becomes a field: B1 (dense) or B7 (tiles)
    launches once reading it, LAST_STATS names erf, and the soup is
    bit-equal to the plain versions' on the card."""
    kernel.launches = 0
    got = sp.generate(_erf_model(), sparse=sparse, **C4_KW)
    assert kernel.launches == 1 and len(got) > 0
    assert engine.LAST_STATS["field_route_ops"] == ("erf",)
    engine._COUNTS_MEMO.clear()
    _clear_memos()
    _PlainEval(monkeypatch)
    np.testing.assert_array_equal(
        sp.generate(_erf_model(), sparse=sparse, **C4_KW), got)


def _where_model():
    return (th.blob(sp, lambda t: t.where(t > 1, t * 0.5), 0.3)
            | th.blob(sp, torch.tanh, 0.3).translate((0.8, 0, 0)))


@pytest.mark.parametrize("sparse, kernel", [
    (False, eval_classify.eval_and_classify),
    ("tiles", eval_classify.eval_tiles_and_classify)])
def test_where_method_routes_on_the_card(cuda, monkeypatch, sparse, kernel):
    """``t.where(c, y)`` (``torch.where(c, t, y)``, no form) becomes a
    field: B1 or B7 once, LAST_STATS names where, and the soup is bit-equal
    to the plain versions' on the card."""
    kernel.launches = 0
    got = sp.generate(_where_model(), sparse=sparse, **C4_KW)
    assert kernel.launches == 1 and len(got) > 0
    assert engine.LAST_STATS["field_route_ops"] == ("where",)
    _clear_memos()
    _PlainEval(monkeypatch)
    np.testing.assert_array_equal(
        sp.generate(_where_model(), sparse=sparse, **C4_KW), got)


def test_routed_generate_syncs_twice_then_once(cuda):
    """The route keeps the memo: a rebuilt erf model's second generate()
    waits for the card once."""
    kw = dict(C4_KW, sparse=False)
    first = sp.generate(_erf_model(), **kw)
    engine._COUNTS_MEMO.clear()
    msgs = _count_syncs(lambda: sp.generate(_erf_model(), **kw))
    assert len(msgs) == 2, msgs
    out = []
    msgs = _count_syncs(lambda: out.append(sp.generate(_erf_model(), **kw)))
    assert len(msgs) == 1, msgs
    np.testing.assert_array_equal(out[0], first)


def test_kernel_wrappers_still_raise_on_a_missing_form(cuda):
    """The route is the engine's: B1's wrapper on an unrouted erf model
    raises NoCppForm naming erf, as kernel_source does."""
    X = np.linspace(-2, 2, 9)
    with pytest.raises(eval_classify.NoCppForm, match="erf"):
        eval_classify.eval_and_classify(th.blob(sp, torch.erf), X, X, X,
                                        torch.float32, cuda)


@pytest.mark.parametrize("n", [(7, 6, 5), (162, 162, 162), (407, 407, 407)])
def test_probe_kernels_equal_plain(cuda, n):
    """The session probes' kernels (csrc/probes.cu) bit-equal to their
    plain versions on seeded axes: a tiny grid, the example's 2**22 grid
    and the 2**26 grid of tools/roofline_torch.py, where phase 23 launches
    them; the copy also on a misaligned view (its one-value-a-thread
    path)."""
    from sdf_torch.utils import weather

    rng = np.random.default_rng(sum(n))
    ax = [torch.as_tensor(rng.uniform(-2, 2, k), dtype=torch.float32,
                          device=cuda) for k in n]
    for kern, plain in ((weather.muladd, weather._muladd_plain),
                        (weather.sqrts, weather._sqrts_plain)):
        assert _same_bits(kern(*ax), plain(*ax))
    v = torch.as_tensor(rng.normal(size=4099), dtype=torch.float32,
                        device=cuda)
    for w in (v, v[1:], v[:7]):
        assert _same_bits(weather.copy(w), weather._copy_plain(w))


def test_profile_adds_one_wait_and_changes_no_soup(cuda, monkeypatch):
    """engine.PROFILE fences the dense path once more (an explicit
    torch.cuda.synchronize, which the sync debug mode does not report), and
    the soup stays bit-equal."""
    kw = dict(samples=2**15, verbose=False)
    off = th.example(sp).generate(**kw)
    msgs = _count_syncs(lambda: th.example(sp).generate(**kw))
    fences = []
    real = torch.cuda.synchronize
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a: fences.append(a) or real(*a))
    monkeypatch.setattr(engine, "PROFILE", True)
    out = []
    msgs_on = _count_syncs(lambda: out.append(th.example(sp).generate(**kw)))
    # the fences: _count_syncs' own, then the engine's one
    assert len(msgs_on) == len(msgs) == 1 and len(fences) == 2
    np.testing.assert_array_equal(out[0], off)
    assert engine.LAST_STATS["d2h_bytes"] > 0 and engine.LAST_STATS["device"]


# --- the bounds refinement's rounds on the card ------------------------------


def _bounds_models(dtype):
    """Gather-free expressions with a body in ``dtype``, routed as
    ``generate()`` routes them: the README example, the benchmark's two
    configurations at their scripts' values and 16 factor rows, the zoo's
    models and every primitive and op (the last two: the test models)."""
    models = [("example", th.example(sp))] + th.bench_models(sp)
    models += [("zoo." + name, build())
               for name, (build, _) in zoo.MODELS.items()]
    models += [("op." + name, case[0](sp))
               for name, case in th.op_cases().items()]
    out = []
    for name, f in models:
        f = hybrid.route_fields(f, None, dtype)[0]
        if not hybrid.count_gathers(f):
            try:
                eval_classify.kernel_source(f, 0, dtype)
            except eval_classify.NoCppForm:
                continue
            out.append((name, f))
    return out


def _rounds_on_both(f, dtype, device):
    """Every round of the CPU's refinement of ``f``, evaluated by the
    card's probe too: ``[(X, Y, Z, card values, CPU values)]``."""
    card = engine._card_probe(f, dtype, device)
    assert card is not None
    cpu = engine._cpu_probe(f, dtype)
    seen = []

    def probe(X, Y, Z):
        v = cpu(X, Y, Z)
        seen.append((X, Y, Z, card(X, Y, Z), v))
        return v

    engine._estimate_bounds_host(f, dtype, probe)
    return seen


def bounds_reading(rounds, dtype):
    """The largest |v_card - v_cpu| / (u M) over ``rounds`` (the reading
    behind ``engine.BOUNDS_GUARD``; M per probe, as ``engine._widths``
    takes it), and the probes where one side is finite and the other not,
    or the two are infinities of opposite signs."""
    u = engine._UNIT_ROUNDOFF[dtype]
    worst, odd = 0.0, 0
    for X, Y, Z, card, cpu in rounds:
        d = np.array([X[1] - X[0], Y[1] - Y[0], Z[1] - Z[0]])
        c = np.linalg.norm(d) / 2 * (1 + (0.0 if dtype == torch.float64
                                          else 1e-4))
        m = engine._widths(X, Y, Z, c, dtype) / (engine.BOUNDS_GUARD * u)
        fin = np.isfinite(card) & np.isfinite(cpu)
        odd += int((np.isfinite(card) != np.isfinite(cpu)).sum())
        odd += int((np.isinf(card) & np.isinf(cpu) & (card != cpu)).sum())
        if fin.any():
            worst = max(worst, float(
                (np.abs(card - cpu)[fin] / (u * m[fin])).max()))
    return worst, odd


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_bounds_probe_equals_plain_on_every_round(cuda, dtype):
    """On every round of the refinement of every model, the probe kernel's
    volume equals the plain torch evaluation of the same grid on the card
    (values, NaNs and signed zeros), as kernel B1's does; and it lies
    within the guard of the CPU's: 64 times the reading at most
    ``BOUNDS_GUARD``."""
    readings = {}
    for name, f in _bounds_models(dtype):
        rounds = _rounds_on_both(f, dtype, cuda)
        for X, Y, Z, card, _ in rounds:
            plain = eval_classify._eval_volume(f, X, Y, Z, dtype, cuda)
            plain = plain.to(torch.float64).cpu().numpy()
            assert np.array_equal(card, plain, equal_nan=True), name
            assert np.array_equal(np.signbit(card), np.signbit(plain)), name
        readings[name] = bounds_reading(rounds, dtype)
    worst = max(r for r, _ in readings.values())
    print("bounds reading", dtype, worst, readings)
    assert 64 * worst <= engine.BOUNDS_GUARD, readings
    assert not any(odd for _, odd in readings.values()), readings


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_bounds_on_the_card_equal_the_cpus(cuda, dtype):
    """The refinement with the card's probe returns the CPU refinement's
    bounds bit for bit, on the README example and the benchmark's rows;
    the probe kernel launches once a round and kernel B1 never."""
    from sdf_torch.core import spans

    b1 = eval_classify.eval_and_classify
    models = [("example", th.example(sp))] + th.bench_models(sp)
    total = fallbacks = 0
    for name, f in models:
        want = engine._estimate_bounds_host(f, dtype)
        before = (eval_classify.bounds_probe.launches, b1.launches)
        stats = {}
        with spans.call(stats, False):
            got = engine._estimate_bounds_host(
                f, dtype, engine._card_probe(f, dtype, cuda))
        assert got[2] == want[2], name
        np.testing.assert_array_equal(got[0], want[0], err_msg=name)
        np.testing.assert_array_equal(got[1], want[1], err_msg=name)
        assert (eval_classify.bounds_probe.launches - before[0]
                == stats["bounds_rounds"] > 1), name
        assert b1.launches == before[1], name
        total += stats["bounds_rounds"]
        fallbacks += stats["bounds_fallbacks"]
    print("bounds rounds", dtype, total, "fallbacks", fallbacks)


def test_bounds_cpu_rounds_on_a_card(cuda):
    """On the card the CPU evaluates the bounds rounds of a gather-bearing
    tree (no probe: every round) and of a gather-free one only where a
    near-tie falls back."""
    kw = dict(samples=2**15, verbose=False)
    models = {"knurling": dict(th.bench_models(sp))["knurling"],
              "gather": th.gather_models(sp)["rotated"]}
    for name, f in models.items():
        f.generate(**kw)  # warm-up: builds
        engine._BOUNDS_MEMO.clear()
        f.generate(**kw)
        st = engine.LAST_STATS
        assert st["bounds_rounds"] > 1, name
        want = st["bounds_rounds"] if name == "gather" else st[
            "bounds_fallbacks"]
        assert st["bounds_cpu_rounds"] == want, name
        assert st["recorded_fields"] == (name == "gather"), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("model, kw, waits, sources", [
    ("example", dict(samples=2**15), 2, 1),
    ("example", dict(samples=2**15, batch_size=8, sparse="tiles"), 2, 2),
    ("blobby", dict(samples=2**16, batch_size=8), 3, 2)])
def test_a_bounds_miss_waits_once_a_round(cuda, dtype, model, kw, waits,
                                          sources):
    """On a bounds-memo miss, generate() waits for the card once more for
    each round of the refinement (its values' fetch): 2 + rounds dense, as
    many under sparse='tiles', 3 + rounds when the cull routes (blobby).
    The probe's library serves the dense B1 launch: one source for kernel
    B1's library, one more for B6's on the tiles."""
    build = th.example if model == "example" else lambda m: zoo.blobby()
    kw = dict(verbose=False, dtype=dtype, **kw)
    build(sp).generate(**kw)  # warm-up: builds, table uploads
    _clear_memos()
    engine._BOUNDS_MEMO.clear()
    msgs = _count_syncs(lambda: build(sp).generate(**kw))
    rounds = engine.LAST_STATS["bounds_rounds"]
    assert rounds > 1
    assert len(msgs) == waits + rounds == engine.LAST_STATS["host_waits"]
    assert engine.LAST_STATS["kernel_sources"] == sources
    assert ("auto_tiles" in engine.LAST_STATS) == (model == "blobby")


# --- the mesh decode on the card: kernel D1 -----------------------------------


def _spy_d1(monkeypatch):
    """Record each launch of kernel D1 with the host decode's inputs made
    from the same emit: ``(D1's buffer, epack, fpack, ne, n, grid_shape,
    host tiles, tile)``, the wire format packed as the CPU path packs it
    (21-bit face words below 2^21 vertices, int32 ranks from there)."""
    seen = []
    real = mc.decode_on_card

    def spy(eidx, t, faces, ne, n, grid_shape=None, tiles=None, tile=None):
        out = real(eidx, t, faces, ne, n, grid_shape=grid_shape, tiles=tiles,
                   tile=tile)
        epack = torch.stack([eidx[:ne], t[:ne].view(torch.int32)])
        fpack = mc.pack_faces_words(faces[:, :n],
                                    ne < (1 << mc.FACE_PACK_BITS))
        seen.append((out, epack.cpu().numpy().view(np.uint32),
                     fpack.cpu().numpy().view(np.uint32), ne, n, grid_shape,
                     None if tiles is None else tiles.cpu().numpy(), tile))
        return out

    # The wrapper counts its launches on whatever its module's name holds.
    spy.launches = real.launches
    monkeypatch.setattr(mc, "decode_on_card", spy)
    return seen


def _same_float64_bits(a, b):
    return a.dtype == b.dtype == np.float64 and np.array_equal(
        a.view(np.int64), b.view(np.int64))


@pytest.mark.parametrize("name, samples, tris", [
    ("knurling", 2**18, None), ("example", 2**22, 291_028)])
def test_card_decode_equals_the_host_decode(cuda, monkeypatch, name, samples,
                                            tris):
    """Kernel D1 on the dense path: the vertices and faces it writes are
    bit-equal to ``mc.unpack_indexed`` of the packed emit of the same edge
    ids, interpolants and ranks, and ``card_decodes`` reads 1."""
    f = th.example(sp) if name == "example" else zoo.knurling()
    seen = _spy_d1(monkeypatch)
    before = mc.decode_on_card.launches
    verts, faces = f.generate(samples=samples, verbose=False, output="mesh")
    assert engine.LAST_STATS["card_decodes"] == 1
    assert "auto_tiles" not in engine.LAST_STATS
    ((buf, epack, fpack, ne, n, grid, tiles, _),) = seen
    assert tiles is None and grid is not None
    assert mc.decode_on_card.launches == before + 1
    vh, fh = mc.split_mesh(buf.cpu().numpy(), ne, n)
    want_v, want_f = mc.unpack_indexed(epack, fpack, grid)
    assert _same_float64_bits(vh, want_v)
    assert np.array_equal(fh, want_f) and fh.dtype == np.int32
    assert np.array_equal(faces, fh) and len(verts) == ne
    if tris is not None:
        assert n == tris


@pytest.mark.parametrize("name, samples, kw", [
    ("blobby", 2**20, {"batch_size": 16}),
    ("saddle", 2**24, {"sparse": "tiles"})])
def test_card_decode_equals_the_host_decode_on_tiles(cuda, monkeypatch, name,
                                                     samples, kw):
    """Kernel D1 on the tiles: bit-equal to ``sparse.unpack_tiles_indexed``
    of the packed emit of the same tiles emit, for blobby routed by the
    cull (0.70 of its batches of 16) and for the saddle model's 2^21
    vertices and more (the wide face format on the host's side);
    ``card_decodes`` reads 1."""
    from sdf_torch.core import sparse

    f = zoo.blobby() if name == "blobby" else zoo.saddle(omega=60.0)
    seen = _spy_d1(monkeypatch)
    verts, faces = f.generate(samples=samples, verbose=False, output="mesh",
                              **kw)
    assert engine.LAST_STATS["card_decodes"] == 1
    assert ("auto_tiles" in engine.LAST_STATS) == (name == "blobby")
    ((buf, epack, fpack, ne, n, grid, tiles, tile),) = seen
    assert grid is None and tiles is not None
    assert (ne >= 1 << mc.FACE_PACK_BITS) == (name == "saddle")
    vh, fh = mc.split_mesh(buf.cpu().numpy(), ne, n)
    want_v, want_f = sparse.unpack_tiles_indexed(epack, fpack, tiles, tile)
    assert _same_float64_bits(vh, want_v)
    assert np.array_equal(fh, want_f) and fh.dtype == np.int32
    assert np.array_equal(faces, fh) and len(verts) == ne


@pytest.mark.parametrize("sparse_mode", [False, "tiles"])
def test_float64_keeps_the_host_path(cuda, sparse_mode):
    """A float64 volume on the card launches no D1: ``card_decodes`` 0."""
    before = mc.decode_on_card.launches
    th.example(sp).generate(samples=2**15, sparse=sparse_mode, batch_size=8,
                            verbose=False, dtype=torch.float64)
    assert engine.LAST_STATS["card_decodes"] == 0
    assert mc.decode_on_card.launches == before
    th.example(sp).generate(samples=2**15, sparse=sparse_mode, batch_size=8,
                            verbose=False)
    assert engine.LAST_STATS["card_decodes"] == 1
    assert mc.decode_on_card.launches == before + 1
