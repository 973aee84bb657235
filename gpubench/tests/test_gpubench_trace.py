"""The reduction of a profiled stretch (``devtrace.reduce``) and the
per-layer readers, on synthetic events: the card's numbers come only from
a chip run, their arithmetic is held here."""

import pytest

import devtrace
import harness

KERNELS = {"B1": "eval_classify_kernel", "B6": "eval_tiles_kernel"}
MS = 1_000_000  # ns


def _events():
    host = [("gpubench.stretch", False, 0, 100 * MS),
            ("gpubench.generate", False, 1 * MS, 99 * MS),
            ("sdf_torch.bounds", False, 2 * MS, 40 * MS),
            ("sdf_torch.decode", False, 70 * MS, 95 * MS),
            ("aten::add", False, 3 * MS, 4 * MS)]
    dev = [("void (anonymous namespace)::eval_classify_kernel<float>(float)",
            True, 40 * MS, 50 * MS),
           ("Memcpy DtoH (Device -> Pinned)", True, 45 * MS, 60 * MS),
           ("sdf_torch.bounds", True, 0, 100 * MS),  # a mirrored range
           ("eval_tiles_kernel<float>(float)", True, 65 * MS, 70 * MS),
           ("late kernel", True, 150 * MS, 160 * MS)]
    return host + dev


def test_reduce_busy_gaps_and_launches():
    red = devtrace.reduce(_events(), KERNELS)
    assert red["window_s"] == pytest.approx(0.1)
    # union of [40, 60] and [65, 70] ms: the late kernel is outside
    assert red["busy_s"] == pytest.approx(0.025)
    assert red["launches"] == {"B1": 1, "B6": 1}
    assert red["durations"]["B1"] == [pytest.approx(0.01)]
    gaps = dict(red["idle_gaps"])
    assert gaps["outside_ranges"] == pytest.approx(0.002)  # [0, 1], [99, 100]
    assert gaps["sdf_torch.bounds"] == pytest.approx(0.038)  # [2, 40]
    # [1, 2], [60, 65] and [95, 99]
    assert gaps["gpubench.generate"] == pytest.approx(0.010)
    assert gaps["sdf_torch.decode"] == pytest.approx(0.025)  # [70, 95]
    assert sum(gaps.values()) + red["busy_s"] == pytest.approx(0.1)
    names = [n for n, _ in red["device_ops"]]
    assert "eval_classify_kernel<float>" in names
    assert not any(n.startswith("sdf_torch.") for n in names)


def test_reduce_needs_the_stretch():
    with pytest.raises(RuntimeError):
        devtrace.reduce([e for e in _events() if e[0] != "gpubench.stretch"],
                        KERNELS)


def _read(name, ctx):
    return harness._module(harness.HERE / "metrics" / (name + ".py"),
                           "m_" + name.replace(".", "_")).read(ctx)


def test_readers():
    cell = harness.Cell("blobby.edit_2p26")
    peaks = harness.peaks("NVIDIA H100 80GB HBM3")
    w = cell.config["work"]
    work = [{"samples": 1000, "cells": 900, "kept_tiles": 3, "routed": True,
             "tile_samples": 500, "tile_cells": 400}]
    least_b1 = max(w["flops_per_sample"] * 1000 / peaks["f32_flops_per_s"],
                   (4 * 1000 + 4 * 900) / peaks["hbm_bytes_per_s"])
    trace = {"busy_s": 0.02, "window_s": 0.1,
             "durations": {"B1": [4 * least_b1], "B6": [1.0]}}
    stats = [{"bounds": 0.1, "skip_dispatch": 0.01, "decode": 0.2,
              "d2h": 0.03},
             {"bounds": 0.3, "skip_dispatch": 0.03, "tiles_decode": 0.4,
              "decode": 9.0, "tiles_d2h": 0.05, "d2h": 9.0}]
    ctx = {"stats": stats, "trace": trace, "work": work, "peaks": peaks,
           "config": cell.config, "requests": 2}
    assert _read("B1_roofline", ctx) == pytest.approx(25.0)
    least_b6 = max(w["flops_per_sample"] * 500 / peaks["f32_flops_per_s"],
                   (4 * 500 + 4 * 400) / peaks["hbm_bytes_per_s"])
    assert _read("B6_roofline", ctx) == pytest.approx(100 * least_b6)
    assert _read("device_idle_pct", ctx) == pytest.approx(80.0)
    assert _read("device_busy_ms", ctx) == pytest.approx(10.0)
    assert _read("bounds_ms", ctx) == pytest.approx(200.0)
    assert _read("cull_ms", ctx) == pytest.approx(20.0)
    assert _read("decode_ms", ctx) == pytest.approx(300.0)
    assert _read("d2h_ms", ctx) == pytest.approx(40.0)
    # a reader that finds nothing to read returns nothing, never 0
    assert _read("B6_roofline", dict(ctx, work=[])) is None
    assert _read("B1_roofline", dict(ctx, peaks=None)) is None
    assert _read("mesh_mean_ms", dict(ctx, latencies=[0.1, 0.3])) == \
        pytest.approx(200.0)
    assert _read("mesh_mean_ms", dict(ctx, latencies=[])) is None


@pytest.mark.parametrize("name", sorted(
    p.stem for p in (harness.HERE / "metrics").glob("*.interactive.py")))
def test_interactive_readers_read_as_their_base(name):
    base = name[:-len(".interactive")]
    trace = {"busy_s": 0.02, "window_s": 0.1,
             "durations": {"B1": [0.002, 0.003]}}
    ctx = {"stats": [{"bounds": 0.1, "skip_dispatch": 0.01, "decode": 0.2,
                      "d2h": 0.03}], "trace": trace,
           "work": [{"samples": 1000, "cells": 900, "routed": False}] * 2,
           "peaks": harness.peaks("NVIDIA H100 80GB HBM3"),
           "config": harness.Cell("knurling.edit_2p22").config,
           "requests": 2}
    assert _read(name, ctx) == _read(base, ctx) is not None
