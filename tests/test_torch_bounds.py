"""The bounds refinement's one loop (``engine._estimate_bounds_host``) with
an evaluator of its rounds other than the CPU's, on the CPU: the near-tie
guard (``engine._settled``) against the CPU's own refinement, and which
path takes the card's evaluator.

Each evaluator here stands in for the card's probe kernel: it returns the
CPU's values, moved as a test needs.  Every check is exact: the bounds
bit-equal to the CPU refinement's, the counters equal.
"""

import numpy as np
import pytest
import torch

import sdf_torch as sp
from sdf_torch import _build
from sdf_torch.core import engine, eval_classify, node, spans

import torch_helpers as th

DTYPES = [torch.float32, torch.float64]


@pytest.fixture(scope="module")
def models():
    """The README example and the benchmark's two configurations at their
    scripts' values."""
    bench = dict(th.bench_models(sp))
    return {"example": th.example(sp), "knurling": bench["knurling"],
            "blobby": bench["blobby"]}


@pytest.fixture(autouse=True)
def _fresh_memos():
    engine._BOUNDS_MEMO.clear()
    engine._COUNTS_MEMO.clear()


def _refine(f, dtype, probe):
    """The loop with ``probe``: ``(lo, hi, empty)`` and the call's stats."""
    stats = {}
    with spans.call(stats, False):
        out = engine._estimate_bounds_host(f, dtype, probe)
    return out, stats


def _same(got, want):
    return (got[2] == want[2] and np.array_equal(got[0], want[0])
            and np.array_equal(got[1], want[1]))


def _cutoff(X, Y, Z, dtype):
    """A round's cutoff, as the loop takes it, and each probe's width."""
    d = np.array([X[1] - X[0], Y[1] - Y[0], Z[1] - Z[0]])
    c = np.linalg.norm(d) / 2 * (1 + (0.0 if dtype == torch.float64
                                      else 1e-4))
    return c, engine._widths(X, Y, Z, c, dtype)


def _moved(f, dtype, push=None, seed=0):
    """An evaluator returning the CPU's values, each moved by up to a
    quarter of its probe's ``delta``, then changed in place by ``push(v,
    c, delta, round, exact)`` where given, which says whether it changed
    them; ``pushed`` counts the rounds it changed."""
    cpu = engine._cpu_probe(f, dtype)
    rng = np.random.default_rng(seed)

    def probe(X, Y, Z):
        exact = cpu(X, Y, Z)
        c, delta = _cutoff(X, Y, Z, dtype)
        v = exact + delta * rng.uniform(-0.25, 0.25, exact.shape)
        if push is not None and push(v, c, delta, probe.rounds, exact):
            probe.pushed += 1
        probe.rounds += 1
        return v

    probe.rounds = probe.pushed = 0
    return probe


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", ["example", "knurling", "blobby"])
def test_exact_values_settle_every_round(models, name, dtype):
    f = models[name]
    want, want_stats = _refine(f, dtype, None)
    got, stats = _refine(f, dtype, engine._cpu_probe(f, dtype))
    assert _same(got, want)
    assert stats["bounds_fallbacks"] == 0
    assert stats["bounds_rounds"] == want_stats["bounds_rounds"] > 1


def _interior(v, c, delta, rnd, exact):
    """Push one probe strictly inside the sure probes' index range on every
    axis across the cutoff, to within half its delta of it."""
    a = np.abs(v)
    sure = np.argwhere(a <= c - delta)
    if not len(sure):
        return False
    lo, hi = sure.min(axis=0), sure.max(axis=0)
    inner = sure[((sure > lo) & (sure < hi)).all(axis=1)]
    if not len(inner):
        return False
    i = tuple(inner[len(inner) // 2])
    v[i] = np.copysign(c + 0.5 * delta[i], v[i])
    return True


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", ["example", "knurling", "blobby"])
def test_an_interior_tie_settles(models, name, dtype):
    """Values within a quarter of delta of the CPU's, one interior probe
    across the cutoff each round: the same bounds, no fallback."""
    f = models[name]
    want, _ = _refine(f, dtype, None)
    probe = _moved(f, dtype, _interior)
    got, stats = _refine(f, dtype, probe)
    assert probe.pushed > 1
    assert _same(got, want)
    assert stats["bounds_fallbacks"] == 0


def _extreme(scale):
    """Push the CPU's probes on the lowest x index of the set (one extreme)
    out to ``scale`` deltas past the cutoff, every other round."""

    def push(v, c, delta, rnd, exact):
        where = np.argwhere(np.abs(exact) <= c)
        if rnd % 2 or not len(where):
            return False
        at = where[where[:, 0] == where[:, 0].min()]
        idx = tuple(at.T)
        v[idx] = np.copysign(c + scale * delta[idx], v[idx])
        return True

    return push


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", ["example", "knurling", "blobby"])
def test_a_tie_at_an_extreme_falls_back(models, name, dtype):
    """The probes that set an extreme pushed across the cutoff, within
    delta: each such round goes to the CPU, and the bounds are the CPU's."""
    f = models[name]
    want, want_stats = _refine(f, dtype, None)
    probe = _moved(f, dtype, _extreme(0.5))
    got, stats = _refine(f, dtype, probe)
    assert probe.pushed > 1
    assert _same(got, want)
    assert stats["bounds_fallbacks"] == probe.pushed
    assert stats["bounds_rounds"] == want_stats["bounds_rounds"]


@pytest.mark.parametrize("dtype", DTYPES)
def test_an_error_beyond_delta_moves_the_bounds(models, dtype):
    """The same push, twice delta past the cutoff: the guard cannot see it,
    and the bounds differ (so the tests above can fail)."""
    f = models["knurling"]
    want, _ = _refine(f, dtype, None)
    got, _ = _refine(f, dtype, _moved(f, dtype, _extreme(2.0)))
    assert not _same(got, want)


def _not_finite(value, extreme):
    """Set CPU probes with ``|v| <= c`` to ``value`` on the card's side,
    every other round: those on the lowest x index of the set (an extreme)
    or, with ``extreme`` false, one strictly inside the set's index range
    on every axis."""

    def push(v, c, delta, rnd, exact):
        where = np.argwhere(np.abs(exact) <= c)
        if rnd % 2 or not len(where):
            return False
        if extreme:
            at = where[where[:, 0] == where[:, 0].min()]
        else:
            lo, hi = where.min(axis=0), where.max(axis=0)
            at = where[((where > lo) & (where < hi)).all(axis=1)][:1]
            if not len(at):
                return False
        v[tuple(at.T)] = value
        return True

    return push


@pytest.mark.parametrize("value", [np.nan, np.inf, -np.inf])
@pytest.mark.parametrize("dtype", DTYPES)
def test_a_value_not_finite_at_an_extreme_falls_back(models, dtype, value):
    """A card value that is not finite where the CPU's is within the cutoff
    is near whatever its size: at an extreme each such round goes to the
    CPU, and the bounds are the CPU's."""
    f = models["knurling"]
    want, _ = _refine(f, dtype, None)
    probe = _moved(f, dtype, _not_finite(value, True))
    got, stats = _refine(f, dtype, probe)
    assert probe.pushed > 1
    assert _same(got, want)
    assert stats["bounds_fallbacks"] == probe.pushed


@pytest.mark.parametrize("dtype", DTYPES)
def test_a_value_not_finite_inside_settles(models, dtype):
    """A NaN strictly inside the set's index range moves no extreme: the
    same bounds, no fallback."""
    f = models["knurling"]
    want, _ = _refine(f, dtype, None)
    probe = _moved(f, dtype, _not_finite(np.nan, False))
    got, stats = _refine(f, dtype, probe)
    assert probe.pushed > 1
    assert _same(got, want)
    assert stats["bounds_fallbacks"] == 0


def _counting_card(monkeypatch):
    """``engine._card_probe`` replaced by the CPU's evaluator behind a
    ``node.fetch``, as the card's is: its calls are counted."""
    calls = []

    def card(sdf, dtype, device):
        cpu = engine._cpu_probe(sdf, dtype)

        def probe(X, Y, Z):
            calls.append(1)
            return node.fetch([torch.as_tensor(cpu(X, Y, Z))])[0]

        return probe

    monkeypatch.setattr(engine, "_card_probe", card)
    return calls


def test_a_memo_hit_evaluates_nothing(monkeypatch):
    """The bounds memo's bypass: a repeat call on a rebuilt model calls no
    evaluator and counts no round, fallback or extra host wait."""
    calls = _counting_card(monkeypatch)
    kw = dict(samples=2**13, verbose=False, device="cpu")
    th.example(sp).generate(**kw)
    st = engine.LAST_STATS
    rounds = st["bounds_rounds"]
    assert len(calls) == rounds > 1 and st["bounds_fallbacks"] == 0
    assert st["host_waits"] == 2 + rounds
    th.example(sp).generate(**kw)
    st = engine.LAST_STATS
    assert len(calls) == rounds
    assert st["bounds_rounds"] == st["bounds_fallbacks"] == 0
    assert st["host_waits"] == 1  # the counts memo's one fetch, as before


def test_the_cpu_never_takes_the_card_probe(monkeypatch, models):
    def refused(*a, **k):
        raise AssertionError("the card's probe on the CPU")

    monkeypatch.setattr(eval_classify, "bounds_probe", refused)
    f = models["example"]
    assert engine._card_probe(f, torch.float32, "cpu") is None
    want, _ = _refine(f, torch.float32, None)
    assert engine._estimate_bounds(f, torch.float32) == (
        tuple(want[0].tolist()), tuple(want[1].tolist()))
    engine._BOUNDS_MEMO.clear()
    th.example(sp).generate(samples=2**12, verbose=False, device="cpu")
    assert engine.LAST_STATS["bounds_rounds"] > 1
    engine._BOUNDS_MEMO.clear()
    sp.sample_slice(th.example(sp), w=8, h=8, z=0.0, device="cpu")


def test_which_expressions_take_the_card_probe(monkeypatch, models):
    """On a CUDA device: a gather-free expression with a body takes the
    card's probe; a gather-bearing one, or one with an op the body has no
    form for, keeps the CPU's."""
    taken = []
    monkeypatch.setattr(eval_classify, "bounds_probe",
                        lambda sdf, dtype, device: taken.append(sdf) or "card")
    cuda = torch.device("cuda")
    f = models["knurling"]
    assert engine._card_probe(f, torch.float32, cuda) == "card"
    assert taken == [f]
    assert engine._card_probe(th.polygon_model(sp), torch.float32,
                              cuda) is None
    assert len(taken) == 1  # the gather is seen before any source

    def no_form(sdf, dtype, device):
        raise eval_classify.NoCppForm("erf")

    monkeypatch.setattr(eval_classify, "bounds_probe", no_form)
    assert engine._card_probe(f, torch.float32, cuda) is None


class _Stop(Exception):
    pass


class _Lib:
    """A stand-in for kernel B1's library: entries that record their call
    and stop (the CPU cannot launch)."""

    def __init__(self):
        self.called = []
        for name in ("sdf_eval_classify_f32", "sdf_eval_classify_f64",
                     "sdf_bounds_probe_f32", "sdf_bounds_probe_f64"):
            setattr(self, name, self._entry(name))

    def _entry(self, name):
        def entry(*args):
            self.called.append(name)
            raise _Stop

        return entry


def test_the_probe_and_b1_resolve_a_trees_library_once(monkeypatch,
                                                      models):
    """bounds_probe resolves B1's library once for a tree (one
    ``kernel_source`` span, one source), and every B1 launch on that tree
    takes the same entries; another tree of the same structure, or another
    dtype, resolves again, and a tree's entries go with it."""
    import gc
    import weakref

    lib = _Lib()
    loads = []
    monkeypatch.setattr(_build, "load",
                        lambda stem, text: loads.append(stem) or lib)
    monkeypatch.setattr(eval_classify, "_ENTRIES",
                        weakref.WeakKeyDictionary())
    monkeypatch.setattr(_build, "stream_ptr", lambda device: None)
    f = models["example"]
    X = np.linspace(-1.5, 1.5, 9)
    stats = {}
    with spans.call(stats, True):
        eval_classify.bounds_probe(f, torch.float32, "cuda")
        assert loads == ["eval_classify"] and stats["kernel_sources"] == 1
        for _ in range(2):
            with pytest.raises(_Stop):
                eval_classify._launch(f, X, X, X, torch.float32, "cpu")
            assert stats["kernel_sources"] == 1
        assert lib.called == ["sdf_eval_classify_f32"] * 2
        g = th.example(sp)
        for dtype, sources in ((torch.float32, 2), (torch.float64, 3)):
            with pytest.raises(_Stop):
                eval_classify._launch(g, X, X, X, dtype, "cpu")
            assert stats["kernel_sources"] == sources
    assert [e[0] for e in stats["spans"]] == ["generate"] + [
        "kernel_source"] * 3
    assert len(eval_classify._ENTRIES) == 2
    del g
    gc.collect()
    assert list(eval_classify._ENTRIES.keys()) == [f]
    with pytest.raises(ValueError, match="CUDA"):
        eval_classify.bounds_probe(f, torch.float32, "cpu")
    with pytest.raises(ValueError, match="gather"):
        eval_classify.bounds_probe(th.polygon_model(sp), torch.float32,
                                   "cuda")
