"""The span recorder of ``sdf_torch.generate()`` (``core.spans``) on the
CPU, at 2^13-2^15 samples: the keys it writes with ``engine.PROFILE`` off
and on, the nesting of the list of spans, the root's length as ``total``,
the counters ``host_waits``, ``bounds_rounds``, ``bounds_cpu_rounds``,
``recorded_fields`` and ``kernel_sources``, the list's clock against
``torch.profiler``'s ranges, and the ``texture`` span a texture built before
a call hands to that call.

Tolerances: the spans' times against the profiler's ranges of the same
names within 1 ms (the clocks are read a few microseconds apart); every
other check is exact.
"""

import time

import numpy as np
import pytest
import torch

import sdf_torch as sp
from sdf_torch import _build
from sdf_torch.core import engine as tengine
from sdf_torch.core import eval_classify, spans
from sdf_torch.core import sparse as tsparse

import torch_helpers as th

KW = dict(samples=2**13, verbose=False, device="cpu")
# The flat keys of a dense sparse=True call that the benchmark's readers take.
FLAT = ("bounds", "skip_dispatch", "eval_classify", "classify_ext",
        "mc_count", "mc_emit", "d2h", "decode", "total", "batches",
        "samples", "skipped", "empty", "nonempty", "triangles")


@pytest.fixture(autouse=True)
def _fresh_memos():
    for memo in (tengine._BOUNDS_MEMO, tengine._COUNTS_MEMO,
                 tengine._SKIP_MEMO, tsparse._COUNTS_MEMO):
        memo.clear()


def _routed():
    """A call the cull routes to the tiles: a small sphere in a wide box."""
    sp.sphere(0.1).generate(samples=2**15, bounds=((-3.0,) * 3, (3.0,) * 3),
                            batch_size=8, verbose=False, device="cpu")
    assert "auto_tiles" in tengine.LAST_STATS
    return dict(tengine.LAST_STATS)


def test_profile_off_keys():
    sp.generate(th.example(sp), **KW)
    st = tengine.LAST_STATS
    assert "spans" not in st and "wait" not in st
    assert set(FLAT) <= set(st)
    for key in spans.COUNTERS:
        assert type(st[key]) is int
    for key in ("route_fields", "fingerprint", "speculative", "counts",
                "transform"):
        assert st[key] > 0, key
    assert st["kernel_sources"] == 0  # the CPU runs the plain versions


def _check_nesting(entries, total):
    roots = [i for i, e in enumerate(entries) if e[3] is None]
    assert roots == [0] and entries[0][0] == "generate"
    for name, a, b, parent in entries[1:]:
        assert a <= b, name
        _, pa, pb, _ = entries[parent]
        assert pa <= a and b <= pb, (name, entries[parent][0])
    assert (entries[0][2] - entries[0][1]) * 1e-9 == total


def _self_ns(entries):
    a, b = entries[0][1], entries[0][2]
    return (b - a) - sum(e[2] - e[1] for e in entries if e[3] == 0)


@pytest.mark.parametrize("route", ["dense", "routed"])
def test_profile_on_spans_nest(monkeypatch, route):
    monkeypatch.setattr(tengine, "PROFILE", True)
    if route == "dense":
        sp.generate(th.example(sp), **KW)
        st = dict(tengine.LAST_STATS)
    else:
        st = _routed()
    entries = st["spans"]
    _check_nesting(entries, st["total"])
    names = [e[0] for e in entries]
    assert "wait" not in names and "wait" not in st  # no card to wait for
    assert _self_ns(entries) >= 0
    want = {"route_fields", "fingerprint", "skip_dispatch", "speculative",
            "eval_classify", "mc_count", "counts", "transform"}
    want |= ({"sparse_tiles", "tiles_d2h", "tiles_decode"} if route ==
             "routed" else {"bounds", "mc_emit", "d2h", "decode"})
    assert want <= set(names)
    # every key a span writes is its spans' lengths summed
    for name in want - {"tiles_d2h", "tiles_decode"}:
        got = sum(b - a for n, a, b, _ in entries if n == name) * 1e-9
        assert st[name] == pytest.approx(got, rel=1e-12), name
    def parents(name):
        return {entries[p][0] for n, _, _, p in entries if n == name}

    assert parents("eval_classify") == parents("mc_count") == {"speculative"}
    assert parents("counts") == ({"speculative", "sparse_tiles"} if route ==
                                 "routed" else {"speculative"})


def test_a_new_list_each_call(monkeypatch):
    monkeypatch.setattr(tengine, "PROFILE", True)
    sp.generate(th.example(sp), **KW)
    kept = dict(tengine.LAST_STATS)  # the harness's shallow copy
    first = list(kept["spans"])
    sp.generate(th.example(sp), **KW)
    assert tengine.LAST_STATS["spans"] is not kept["spans"]
    assert kept["spans"] == first


def test_host_waits():
    sp.generate(th.example(sp), **KW)
    assert tengine.LAST_STATS["host_waits"] == 2  # counts, then the mesh
    sp.generate(th.example(sp), **KW)
    assert tengine.LAST_STATS["host_waits"] == 1  # the counts memo hit
    assert _routed()["host_waits"] == 3  # dense counts, tiles counts, mesh


def test_bounds_rounds_count_the_probe_grids(monkeypatch):
    grids = []
    real = tengine.cast

    def cast(sdf, dtype, device):
        f = real(sdf, dtype, device)

        def counted(p):
            if tuple(p.c[0].shape) == (16, 1, 1):  # a bounds probe grid
                grids.append(1)
            return f(p)

        return counted

    monkeypatch.setattr(tengine, "cast", cast)
    sp.generate(th.example(sp), **KW)
    assert tengine.LAST_STATS["bounds_rounds"] == len(grids) > 1
    sp.generate(th.example(sp), **KW)
    assert tengine.LAST_STATS["bounds_rounds"] == 0 and len(grids) > 1


class _Stop(Exception):
    pass


def test_kernel_source_span_counts_each_launch(monkeypatch):
    """Kernel B1's launch wrapper generates its source and finds its
    library inside the ``kernel_source`` span, counting one source (the
    library lookup stubbed: the CPU has no nvcc)."""
    seen = []

    def load(stem, text):
        seen.append(stem)
        assert "sdf_point" in text
        raise _Stop

    monkeypatch.setattr(_build, "load", load)
    X = np.linspace(-1.5, 1.5, 9)
    stats = {}
    with pytest.raises(_Stop):
        with spans.call(stats, True):
            eval_classify._launch(th.example(sp), X, X, X, torch.float32,
                                  "cpu")
    assert seen == ["eval_classify"] and stats["kernel_sources"] == 1
    assert [e[0] for e in stats["spans"]] == ["generate", "kernel_source"]
    assert stats["kernel_source"] > 0


def test_spans_share_the_profilers_clock(monkeypatch):
    monkeypatch.setattr(tengine, "PROFILE", True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        sp.generate(th.example(sp), **KW)
    entries = tengine.LAST_STATS["spans"]
    ranges = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("sdf_torch."):
            ranges.setdefault(e.name()[len("sdf_torch."):], []).append(
                (e.start_ns(), e.end_ns()))
    names = {e[0] for e in entries}
    assert names == set(ranges)
    for name in names:
        mine = sorted((a, b) for n, a, b, _ in entries if n == name)
        theirs = sorted(ranges[name])
        assert len(mine) == len(theirs), name
        for (a, b), (ra, rb) in zip(mine, theirs):
            assert abs(a - ra) < 1e6 and abs(b - rb) < 1e6, name


def _plate():
    """A small image plate (the image configuration's lines on a 64 x 48
    disk): a gather-bearing expression whose texture is built here, before
    any call."""
    yy, xx = np.mgrid[:48, :64]
    disk = ((xx - 32) ** 2 + (yy - 24) ** 2 < 15**2).astype(np.uint8) * 255
    f = sp.rounded_box((1.5, 1.1, 0.1), 0.05)
    return f | sp.image(disk).extrude(1) & sp.slab(z0=0, z1=0.075)


def test_a_texture_built_before_a_call_is_that_calls_only():
    spans._take_held()  # nothing left over from an earlier test
    t0 = time.perf_counter()
    plate = _plate()
    built = time.perf_counter() - t0
    sp.generate(plate, **KW)
    assert 0 < tengine.LAST_STATS["texture"] <= built
    sp.generate(plate, **KW)
    assert "texture" not in tengine.LAST_STATS
    _plate()
    sp.generate(th.example(sp), **KW)  # any next call takes it
    assert tengine.LAST_STATS["texture"] > 0
    sp.generate(th.example(sp), **KW)
    assert "texture" not in tengine.LAST_STATS


def test_a_span_outside_a_call_is_held_only_when_asked():
    spans._take_held()
    with spans.span("outside"):
        pass
    with spans.span("texture", hold=True):
        pass
    sp.generate(th.example(sp), **KW)
    st = tengine.LAST_STATS
    assert st["texture"] > 0 and "outside" not in st
    assert spans._take_held() == []


def test_a_held_span_under_profile_has_no_parent(monkeypatch):
    monkeypatch.setattr(tengine, "PROFILE", True)
    spans._take_held()
    plate = _plate()
    sp.generate(plate, **KW)
    st = tengine.LAST_STATS
    entries = st["spans"]
    name, start, end, parent = entries[-1]
    assert name == "texture" and parent is None
    assert [e[0] for e in entries].count("texture") == 1
    assert (end - start) * 1e-9 == pytest.approx(st["texture"], rel=1e-12)
    assert end <= entries[0][1]  # built before the call opened
    # the call's own spans nest under the root as before, none under the
    # texture, and the root's self time (unattributed_ms) is unchanged
    _check_nesting(entries[:-1], st["total"])
    assert all(e[3] != len(entries) - 1 for e in entries)
    assert _self_ns(entries) == _self_ns(entries[:-1])


def test_bounds_cpu_rounds_count_the_rounds_the_cpu_evaluates():
    sp.generate(th.example(sp), **KW)
    st = tengine.LAST_STATS
    assert st["bounds_cpu_rounds"] == st["bounds_rounds"] > 1
    plate = _plate()
    # a gather-bearing tree gets no card probe, whatever the device
    assert tengine._card_probe(plate, torch.float32, "cuda") is None
    sp.generate(plate, **KW)
    st = tengine.LAST_STATS
    assert st["bounds_cpu_rounds"] == st["bounds_rounds"] > 1


@pytest.mark.parametrize("probe", ["exact", "unreadable"])
def test_bounds_cpu_rounds_count_a_probes_fallbacks(probe):
    """With a card's evaluator (stood in for on the CPU) the CPU evaluates
    only the rounds it falls back on: none where the probe's values are the
    CPU's, every one where they are not numbers."""
    f = th.example(sp)
    cpu = tengine._cpu_probe(f, torch.float32)
    stand_in = cpu if probe == "exact" else (
        lambda X, Y, Z: np.full((len(X), len(Y), len(Z)), np.nan))
    stats = {}
    with spans.call(stats, False):
        got = tengine._estimate_bounds_host(f, torch.float32, stand_in)
    want = tengine._estimate_bounds_host(f, torch.float32)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert stats["bounds_rounds"] > 1
    assert stats["bounds_cpu_rounds"] == stats["bounds_fallbacks"]
    assert stats["bounds_fallbacks"] == (0 if probe == "exact"
                                         else stats["bounds_rounds"])


def test_recorded_fields_count_the_pre_passs_fields():
    sp.generate(_plate(), **KW)
    assert tengine.LAST_STATS["recorded_fields"] == 1
    sp.generate(dict(th.bench_models(sp))["knurling"], **KW)
    assert tengine.LAST_STATS["recorded_fields"] == 0
