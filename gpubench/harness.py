"""One run of one cell: set-up, the measured window, the traced stretch
and the check.  ``run.py`` is the command; this module holds the work, so
that the tests can drive a run without a card.

Everything that belongs to one configuration, traffic mix, kernel or
per-layer metric is found by name: ``configs/<config>.json`` (and the
expression file it names), ``traffic/<traffic>.json``, ``kernels/<label>.json``
and ``metrics/<metric>.py``, as ``BENCHMARK.json`` lists them.
"""

from __future__ import annotations

import importlib.util
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

import check
import devtrace as trace_mod
from reference import mesh as ref_mesh
from reference import sdf as ref_sdf
from traffic import Sample, Traffic

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
KERNEL_DIR = ROOT / "build" / "gpubench" / "kernels"
UNREADABLE = 1e30


def _json(path):
    with open(path) as fp:
        return json.load(fp)


def _module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """A workload of ``BENCHMARK.json`` with its configuration, expression,
    traffic, limits and metrics."""

    def __init__(self, name, manifest=None):
        manifest = manifest or _json(ROOT / "BENCHMARK.json")
        (self.workload,) = [w for w in manifest["workloads"]
                            if w["name"] == name]
        (self.config_entry,) = [c for c in manifest["configs"]
                                if c["name"] == self.workload["config"]]
        self.config = _json(ROOT / self.config_entry["file"])
        cfg_dir = (ROOT / self.config_entry["file"]).parent
        self.build = _module(cfg_dir / self.config["expression"],
                             "gpubench_config_" + self.config["name"]).build
        self.traffic = _json(HERE / "traffic" /
                             (self.workload["traffic"] + ".json"))
        self.chips = int(self.workload["chips"])

        def mine(m):
            return name in m.get("workloads", [name])

        self.end_to_end = [m for m in manifest["end_to_end"] if mine(m)]
        # A per-layer metric is read only in cells that report the
        # end-to-end metric it moves; with no list of cells, in all of them.
        reported = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in manifest["per_layer"]
                          if mine(m) and m["moves"] in reported]


def reader(name):
    """The per-layer reader ``metrics/<name>.py``."""
    return _module(HERE / "metrics" / (name + ".py"),
                   "gpubench_metric_" + name.replace(".", "_"))


def kernels():
    """``{label: (name fragment, (module, function))}`` of every kernel
    file."""
    out = {}
    for path in sorted((HERE / "kernels").glob("*.json")):
        k = _json(path)
        mod, fn = k["counter"].split(":")
        out[path.stem] = (k["kernel"], (mod, fn))
    return out


def _counter(spec):
    import importlib

    mod, fn = spec
    return getattr(importlib.import_module(mod), fn).launches


def _libraries():
    return sorted(p.name for p in KERNEL_DIR.glob("*.so"))


def power_limit():
    """The card's name and power limit from ``nvidia-smi`` (None where it
    cannot be read)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return None
    return out[0] if out else None


class Program:
    """The system under test: ``sdf_torch``'s ``generate()`` at the
    configuration's settings, on ``device``."""

    def __init__(self, cell, device):
        import sdf_torch
        from sdf_torch.core import engine, sparse

        self.api = sdf_torch
        self.engine = engine
        self.sparse = sparse
        self.cell = cell
        self.device = device
        c = cell.config
        self.kwargs = dict(samples=int(cell.traffic["samples"]),
                           output="mesh", verbose=False, dtype=c["dtype"],
                           sparse=c["sparse"], mc_variant=c["mc_variant"],
                           batch_size=int(c["batch_size"]))
        if device != "cuda":
            self.kwargs["device"] = device
        sdf_torch.enable_compile_cache(KERNEL_DIR)

    def profile(self, on):
        self.engine.PROFILE = on
        self.sparse.PROFILE = on

    def __call__(self, params):
        with torch.profiler.record_function("gpubench.build"):
            f = self.cell.build(self.api, params)
        with torch.profiler.record_function("gpubench.generate"):
            return self.api.generate(f, **self.kwargs)

    def stats(self):
        return dict(self.engine.LAST_STATS)


def _activities(device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def _sync(device):
    if device == "cuda":
        torch.cuda.synchronize()


def window(program, traffic, seconds, sample, device, on_request=None):
    """The closed loop: requests until ``seconds`` have passed since the
    first began.  Returns ``(latencies s, attempted, failed, wall s)``."""
    lat = []
    attempted = failed = 0
    t_start = time.perf_counter()
    deadline = t_start + seconds
    i = 0
    while time.perf_counter() < deadline or (on_request and
                                             on_request.busy()):
        params = traffic.request(i)
        if on_request:
            on_request.before(i)
        attempted += 1
        t0 = time.perf_counter()
        try:
            verts, faces = program(params)
        except Exception as exc:  # a request that raises is counted failed
            failed += 1
            print("request %d failed: %r" % (i, exc), file=sys.stderr,
                  flush=True)
            verts = None
        t1 = time.perf_counter()
        if verts is not None:
            lat.append(t1 - t0)
            sample.offer((i, params, verts, faces))
        if on_request:
            on_request.after(i)
        i += 1
    _sync(device)
    return lat, attempted, failed, time.perf_counter() - t_start


class _Tracer:
    """Around the window of a traced run: ``engine.PROFILE`` on, and
    ``LAST_STATS`` and the latency kept, for every request outside the
    stretch; the stretch (requests ``1 .. trace_requests``) under
    ``torch.profiler`` with PROFILE off, the program's launch counters read
    at its two ends."""

    def __init__(self, program, n, kernels_):
        self.program = program
        self.n = n
        self.kernels = kernels_
        self.stats = []
        self.latencies = []
        self.t0 = None
        self.prof = None
        self.traced = []
        self.counts0 = self.counts1 = None

    def busy(self):
        return self.prof is not None or len(self.traced) < self.n

    def before(self, i):
        if i == 1:
            self.program.profile(False)
            self.counts0 = {k: _counter(v[1]) for k, v in self.kernels.items()}
            _sync(self.program.device)
            self.prof = torch.profiler.profile(
                activities=_activities(self.program.device))
            self.prof.__enter__()
            self.rf = torch.profiler.record_function(trace_mod.STRETCH)
            self.rf.__enter__()
        elif i == 0:
            self.program.profile(True)
        self.t0 = time.perf_counter()

    def after(self, i):
        if self.prof is not None:
            self.traced.append(i)
            if len(self.traced) == self.n:
                _sync(self.program.device)
                self.rf.__exit__(None, None, None)
                self.prof.__exit__(None, None, None)
                self.counts1 = {k: _counter(v[1])
                                for k, v in self.kernels.items()}
                self.done = self.prof
                self.prof = None
                self.program.profile(True)
        else:
            self.latencies.append(time.perf_counter() - self.t0)
            self.stats.append(self.program.stats())


def _quantile95(values):
    if len(values) < 2:
        return values[0]
    return statistics.quantiles(values, n=100, method="inclusive")[94]


def _reference_work(cell, params_list, device):
    """The grid and the cull of each request, worked out by the reference:
    the work the rooflines count."""
    out = []
    dtype = getattr(torch, cell.config["dtype"])
    for params in params_list:
        expr = cell.build(ref_sdf, params)
        X, Y, Z, _ = ref_mesh.grid(expr, int(cell.traffic["samples"]), dtype)
        skip = ref_mesh.cull(expr, X, Y, Z, dtype, device,
                             int(cell.config["batch_size"]))
        out.append({"samples": len(X) * len(Y) * len(Z),
                    "cells": (len(X) - 1) * (len(Y) - 1) * (len(Z) - 1),
                    "kept_tiles": int((~skip).sum()),
                    **ref_mesh.tile_cover(~skip, (len(X), len(Y), len(Z)),
                                          int(cell.config["batch_size"])),
                    "routed": bool(skip.mean()
                                   >= ref_mesh.AUTO_TILES_THRESHOLD)})
    return out


def peaks(kind):
    for entry in _json(HERE / "peaks.json").values():
        if entry["match"] in kind:
            return entry
    return None


def checks(cell, sample, device):
    """Compare each sampled mesh with the reference's; returns
    ``[[name, worst value, limit], ...]`` and whether all passed."""
    limits = cell.config["limits"]
    dtype = getattr(torch, cell.config["dtype"])
    worst = {k: 0.0 for k in limits}
    for _, params, verts, faces in sample.items:
        ref = ref_mesh.mesh(cell.build(ref_sdf, params),
                            int(cell.traffic["samples"]), device, dtype,
                            batch=int(cell.config["batch_size"]))
        got = check.compare(verts, faces, ref)
        del ref
        for k in limits:
            # A reading that is not a finite number counts as far over its
            # limit (and stays a number the result's JSON can hold).
            v = got[k] if math.isfinite(got[k]) else UNREADABLE
            worst[k] = max(worst[k], v)
    rows = [["checked_requests", len(sample.items), "min 1"]]
    rows += [[k, worst[k], limits[k]] for k in limits]
    ok = bool(sample.items) and all(worst[k] <= limits[k] for k in limits)
    return rows, ok


def run(cell, seed, seconds, traced, device="cuda", t_process=None,
        program=None):
    """One run; returns ``(result dict, check rows)``.  ``program``
    replaces the system under test (the tests' faults)."""
    t_process = time.perf_counter() if t_process is None else t_process
    t_import = time.perf_counter()
    program = program or Program(cell, device)
    traffic = Traffic(cell.traffic, cell.config, seed)
    t_warm = []
    for params in traffic.warmup():
        t_warm.append(time.perf_counter())
        program(params)
        _sync(device)
    t_warm.append(time.perf_counter())
    print("set-up: %.2f s to the harness, %.2f s to the program, warm-up "
          "requests %s s" % (t_import - t_process, t_warm[0] - t_import,
                             " ".join("%.2f" % (b - a) for a, b in
                                      zip(t_warm, t_warm[1:]))),
          file=sys.stderr)
    ks = kernels()
    tracer = None
    if traced:
        tracer = _Tracer(program, int(cell.traffic["trace_requests"]), ks)
        # The profiler's own first start (CUPTI) belongs to set-up.
        with torch.profiler.profile(activities=_activities(device)):
            program(traffic.warmup()[0])
            _sync(device)
    libs = _libraries()
    setup_s = time.perf_counter() - t_process

    sample = Sample(cell.traffic["check_requests"], seed)
    lat, attempted, failed, wall = window(program, traffic, seconds, sample,
                                          device, tracer)
    if _libraries() != libs:
        raise RuntimeError("a kernel library was built inside the window")
    if lat:
        half = len(lat) // 2
        q = statistics.quantiles(lat, n=4) if len(lat) > 1 else lat * 3
        print("window: %d requests, latency ms quartiles %.1f %.1f %.1f, "
              "mean of the first and second half %.1f %.1f"
              % (len(lat), 1e3 * q[0], 1e3 * q[1], 1e3 * q[2],
                 1e3 * statistics.fmean(lat[:half] or lat),
                 1e3 * statistics.fmean(lat[half:])), file=sys.stderr)
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    kind = torch.cuda.get_device_name() if device == "cuda" else "cpu"

    result = {"correct": False, "attempted": attempted, "failed": failed}
    metrics = {}
    if not traced:
        values = {"setup_s": setup_s,
                  "mesh_ms": 1e3 * wall / max(len(lat), 1),
                  "mesh_p95_ms": 1e3 * _quantile95(lat) if lat else None}
        for m in cell.end_to_end:
            if values.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
    device_info = {"platform": "gpu" if device == "cuda" else device,
                   "kind": kind, "count": cell.chips,
                   "memory_peak_bytes": int(peak)}
    breakdown = None
    if traced:
        red = trace_mod.reduce(trace_mod.events(tracer.done),
                               {k: v[0] for k, v in ks.items()})
        seen = red["launches"]
        counted = {k: tracer.counts1[k] - tracer.counts0[k] for k in ks}
        if seen != counted:
            raise RuntimeError("the profiler saw launches %s where the "
                               "program counted %s" % (seen, counted))
        work = _reference_work(cell, [traffic.request(i)
                                      for i in tracer.traced], device)
        ctx = {"stats": tracer.stats, "trace": red, "work": work,
               "config": cell.config, "peaks": peaks(kind),
               "requests": len(tracer.traced),
               "latencies": tracer.latencies}
        for m in cell.per_layer:
            value = reader(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device_info["busy_s"] = red["busy_s"]
        device_info["window_s"] = red["window_s"]
        breakdown = {"device_ops": red["device_ops"],
                     "idle_gaps": red["idle_gaps"]}
    result["metrics"] = metrics
    result["device"] = device_info
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["card"] = power_limit() if device == "cuda" else None

    # The check runs once the window is closed and the peak is read, with
    # the program's device state released.
    del program, tracer
    if device == "cuda":
        torch.cuda.empty_cache()
    rows, ok = checks(cell, sample, device)
    result["correct"] = ok and failed == 0
    result["checks"] = {name: {"value": v, "limit": lim}
                        for name, v, lim in rows}
    return result, rows

