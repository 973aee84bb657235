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
from sdf_torch.core import compact, engine, eval_classify, mc, mc33

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
    exprs.append(sp.sphere(0.6).union(sp.box(0.8), k=0.2))
    _build.build_many(
        [("eval_classify", eval_classify.kernel_source(f)) for f in exprs]
        + [("ntri", _build.source("ntri.cu")),
           ("compact", _build.source("compact.cu")),
           ("classify_ext", _build.source("classify_ext.cu"))]
    )
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_eval_classify_kernel(cuda, dtype):
    X = np.linspace(-1.1, 1.1, 37)
    Y = np.linspace(-1.0, 1.2, 41)
    Z = np.linspace(-1.2, 1.0, 70)
    for f in (th.example(sp), sp.sphere(0.6).union(sp.box(0.8), k=0.2)):
        vk, ck = eval_classify.eval_and_classify(f, X, Y, Z, dtype, cuda)
        vp, cp = eval_classify._eval_classify_plain(f, X, Y, Z, dtype, cuda)
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
