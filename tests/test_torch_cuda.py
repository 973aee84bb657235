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
from sdf_torch.core import compact, eval_classify, mc

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
           ("compact", _build.source("compact.cu"))]
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


def test_ntri_kernel(cuda):
    rng = np.random.default_rng(0)
    codes = np.concatenate([np.arange(256), rng.integers(-5, 300, 9999)])
    c = torch.as_tensor(codes.astype(np.int32), device=cuda)
    table = mc.get_tables("fast").on(cuda, "ntri")
    assert torch.equal(mc.ntri_of(c), mc._ntri_plain(c, table))


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


@pytest.mark.parametrize("dtype, syncs", [(torch.float32, 2),
                                          (torch.float64, 3)])
def test_generate_syncs_only_to_fetch(cuda, dtype, syncs):
    """generate() waits for the card only where it fetches: once for every
    count before emit, then for the results (one transfer when float32
    packs them, two for float64's vertices and faces).  Counted by
    PyTorch's sync debug mode, after a warm-up run."""
    kw = dict(samples=2**15, verbose=False, mc_variant="fast", dtype=dtype)
    th.example(sp).generate(**kw)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            th.example(sp).generate(**kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    # Not the once-per-process notice that the debug mode is a prototype.
    msgs = [str(w.message) for w in caught
            if "called a synchronizing" in str(w.message)]
    assert len(msgs) == syncs, msgs


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_generate_on_card_equals_cpu(cuda, dtype):
    kw = dict(samples=2**15, verbose=False, mc_variant="fast", dtype=dtype)
    got = th.example(sp).generate(**kw)
    want = th.example(sp).generate(device="cpu", **kw)
    np.testing.assert_array_equal(got, want)
