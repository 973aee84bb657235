"""The readers of the image cell's per-layer metrics (``texture_ms``,
``record_fields_ms``, ``bounds_cpu_rounds``) on synthetic ``LAST_STATS``
dicts: means over the calls, and nothing read where the key is absent (a
program without the ``texture`` span or the counter)."""

import pytest

import harness

NEW = ("texture_ms", "record_fields_ms", "bounds_cpu_rounds")


def _read(name, stats):
    return harness.reader(name).read({"stats": stats})


def test_means_over_the_calls():
    stats = [{"texture": 0.25, "record_fields": 0.010,
              "bounds_cpu_rounds": 32},
             {"texture": 0.35, "record_fields": 0.006,
              "bounds_cpu_rounds": 30}]
    assert _read("texture_ms", stats) == pytest.approx(300.0)
    assert _read("record_fields_ms", stats) == pytest.approx(8.0)
    assert _read("bounds_cpu_rounds", stats) == pytest.approx(31.0)


@pytest.mark.parametrize("name", NEW)
def test_nothing_to_read_is_none(name):
    old = [{"bounds": 0.1, "bounds_rounds": 32, "host_waits": 2,
            "decode": 0.2, "total": 0.4}]
    assert _read(name, old) is None
    assert _read(name, []) is None


def test_manifest_places_the_metrics():
    for w in harness._json(harness.ROOT / "BENCHMARK.json")["workloads"]:
        mine = {m["name"] for m in harness.Cell(w["name"]).per_layer}
        for metric in NEW:
            assert (metric in mine) == (w["name"] == "image.edit_2p22")
