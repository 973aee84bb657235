"""The readers of the program's spans and counters (``sdf_torch.core.spans``)
on synthetic ``LAST_STATS`` dicts: sums, means over the calls, the root's
self time, and nothing read where the keys are absent (a program without
the recorder)."""

import pytest

import harness

MS = 1_000_000  # ns
NEW = ("host_wait_ms", "host_waits", "unattributed_ms", "fingerprint_ms",
       "kernel_source_ms", "discarded_ms")


def _read(name, stats):
    return harness.reader(name).read({"stats": stats})


def _call(spans=None, **keys):
    out = dict(keys)
    if spans is not None:
        out["spans"] = spans
    return out


def test_sums_and_means_over_the_calls():
    stats = [_call(wait=0.004, host_waits=2, fingerprint=0.001,
                   kernel_source=0.003),
             _call(wait=0.002, host_waits=3, fingerprint=0.003,
                   kernel_source=0.005)]
    assert _read("host_wait_ms", stats) == pytest.approx(3.0)
    assert _read("host_waits", stats) == pytest.approx(2.5)
    assert _read("fingerprint_ms", stats) == pytest.approx(2.0)
    assert _read("kernel_source_ms", stats) == pytest.approx(4.0)


def test_discarded_reads_routed_calls_only():
    stats = [_call(speculative=0.010),  # dense: its pass is kept
             _call(speculative=0.020, auto_tiles=0.82),
             _call(speculative=0.030, auto_tiles=0.81)]
    assert _read("discarded_ms", stats) == pytest.approx(25.0)
    assert _read("discarded_ms", stats[:1]) is None


def test_root_self_time_with_nested_and_overlapping_children():
    spans = [("generate", 0, 100 * MS, None),
             ("bounds", 10 * MS, 40 * MS, 0),
             ("fingerprint", 12 * MS, 20 * MS, 1),   # nested: not the root's
             ("speculative", 30 * MS, 60 * MS, 0),   # overlaps bounds
             ("decode", 70 * MS, 80 * MS, 0),
             ("transform", 95 * MS, 120 * MS, 0)]    # clipped to the root
    # covered: [10, 60], [70, 80], [95, 100] = 65 ms of 100
    assert _read("unattributed_ms", [_call(spans)]) == pytest.approx(35.0)
    bare = [("generate", 5 * MS, 7 * MS, None)]
    assert _read("unattributed_ms", [_call(spans), _call(bare)]) == \
        pytest.approx(18.5)


def test_self_time_of_a_fully_covered_root_is_zero():
    spans = [("generate", 0, 10 * MS, None), ("bounds", 0, 4 * MS, 0),
             ("decode", 4 * MS, 10 * MS, 0)]
    assert _read("unattributed_ms", [_call(spans)]) == 0.0


@pytest.mark.parametrize("name", NEW)
def test_nothing_to_read_is_none(name):
    # a program without the recorder: phase keys, no spans or counters
    old = [{"bounds": 0.1, "skip_dispatch": 0.01, "d2h": 0.003,
            "decode": 0.2, "total": 0.4, "auto_tiles": 0.82}]
    assert _read(name, old) is None
    assert _read(name, []) is None


def test_manifest_places_the_metrics():
    cells = {w["name"]: harness.Cell(w["name"])
             for w in (harness._json(harness.ROOT / "BENCHMARK.json")
                       ["workloads"])}
    for name, cell in cells.items():
        mine = {m["name"] for m in cell.per_layer}
        reports_mesh_ms = any(m["name"] == "mesh_ms" for m in cell.end_to_end)
        for metric in NEW[:-1]:
            assert (metric in mine) == reports_mesh_ms, (name, metric)
        assert ("discarded_ms" in mine) == (name == "blobby.edit_2p26")
