#!/usr/bin/env python3
"""Drive the sdf_torch port on one CUDA card and check it.

Run from the root of a checkout, on a machine with an NVIDIA H100 and the
CUDA toolkit:

    python3 chip_smoke.py

Phases, each printing its own lines:
  1. the card (nvidia-smi name and power limit) and the torch/CUDA versions;
  2. build every kernel of the main path from the sources in the checkout,
     one nvcc per source, all started together;
  3. each kernel against its plain PyTorch version on the card, at the
     shapes the main path gives it: kernel time, plain time, the least time
     the card could take (bound), and where one PyTorch call computes the
     same function, that call's time;
  4. generate() of the example model at samples=2**22 in float32 with
     mc_variant="fast": 291,028 triangles, a soup bit-equal to the port's
     own device="cpu" run, every kernel launched, the warm time;
  5. the same at 2**24 in float64: 731,152 triangles and the canonical soup
     sha256 pinned by tests/test_topology_2p24.py.
Then one JSON line with every kernel, the card line again, and last the
result line.  Any failed check raises, and the script exits non-zero
without a result line; so does a machine without a CUDA device.
"""

import hashlib
import json
import statistics
import subprocess
import sys
import time

SOUP_2P24 = "54d4ad9c22a8ce6bb77d8b763e2abb6878eda56ece4a40ea8aa274802b698ca3"
TRIS_2P22 = 291028
TRIS_2P24 = 731152

# NVIDIA H100 SXM data sheet: HBM3 bandwidth and non-tensor-core peaks.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def example(m):
    f = m.sphere(1) & m.box(1.5)
    c = m.cylinder(0.5)
    f -= c.orient(m.X) | c.orient(m.Y) | c.orient(m.Z)
    return f


def soup_hash(pts):
    import numpy as np

    tris = np.asarray(pts, np.float64).round(9).reshape(-1, 9)
    return hashlib.sha256(tris[np.lexsort(tris.T[::-1])].tobytes()).hexdigest()


def _kernel_events(prof, exclude=()):
    import torch

    # Kernels and memsets; not host copies, not the engine's record_function
    # ranges (which the profiler mirrors onto the device), and not the
    # kernels named in ``exclude``.
    cuda = torch.autograd.DeviceType.CUDA
    return [e for e in prof.events()
            if e.device_type == cuda and "Memcpy" not in e.name
            and not e.name.startswith("sdf_torch.") and e.name not in exclude]


def _profiled(fn):
    """Run ``fn`` under torch.profiler; returns the profile and the wall ms
    of the call (to the end of its device work)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    return prof, wall


_FLUSH = {}


def _flush_l2():
    """Rewrite a 256 MiB buffer, five times the H100's 50 MB L2, so the
    next call reads its inputs from HBM as the main path does."""
    import torch

    if "buf" not in _FLUSH:
        _FLUSH["buf"] = torch.zeros(256 << 20, dtype=torch.uint8, device="cuda")
        names = {e.name for e in _kernel_events(_profiled(
            lambda: _FLUSH["buf"].bitwise_not_())[0])}
        if not names:
            raise RuntimeError("torch.profiler recorded no CUDA kernel")
        _FLUSH["names"] = names
    _FLUSH["buf"].bitwise_not_()


def device_ms(fn, reps=20, warm=3):
    """Device time per call of ``fn`` in ms, each call after an L2 flush:
    the summed durations of the kernels (and memsets) it launches, from
    torch.profiler, so host work between launches is not counted.  Raises
    if the profiler saw no kernel of ``fn``."""
    import torch

    _flush_l2()
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(reps):
            _flush_l2()
            fn()

    evs = _kernel_events(_profiled(run)[0], _FLUSH["names"])
    if not evs:
        raise RuntimeError("torch.profiler recorded no CUDA kernel of the "
                           "timed call")
    return sum(e.time_range.elapsed_us() for e in evs) / reps / 1e3


def max_abs_diff(pairs):
    """Largest |got - want| over ``(got, want)`` tensor pairs."""
    return max(float((g.double() - w.double()).abs().max()) if g.numel()
               else 0.0 for g, w in pairs)


def timeline(fn):
    """Profile one call of ``fn``: wall ms, device-busy ms (union of the
    kernel intervals) and the device ms per kernel name."""
    prof, wall = _profiled(fn)
    evs = _kernel_events(prof)
    spans = sorted((e.time_range.start, e.time_range.end) for e in evs)
    busy, end = 0.0, None
    for a, b in spans:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    per = {}
    for e in evs:
        per[e.name] = per.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    return wall, busy / 1e3, per


def bound_ms(nbytes, ops=0, dtype="float32"):
    """The least time for the work: bytes over HBM bandwidth or operations
    over the peak rate, whichever is larger; returns (ms, bound_by)."""
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = ops / PEAK_FLOPS[dtype] * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def body_op_count(src):
    """Statements in a generated eval body: one op each, per point."""
    start = src.index("sdf_point(")
    body = src[start: src.index("\n}", start)]
    return body.count("\n  const ")


def check(cond, what):
    if not cond:
        raise AssertionError(what)
    print("  ok: " + what, flush=True)


def grid_axes(f, samples, dtype):
    """The grid generate() builds (bounds, then np.arange per axis)."""
    import numpy as np

    from sdf_torch.core import engine

    (x0, y0, z0), (x1, y1, z1) = engine._estimate_bounds(f, dtype)
    step = ((x1 - x0) * (y1 - y0) * (z1 - z0) / samples) ** (1 / 3)
    return [np.arange(a, b, step) for a, b in ((x0, x1), (y0, y1), (z0, z1))]


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        import sdf_torch as sp
        from sdf_torch import _build
        from sdf_torch.core import compact, eval_classify, mc
    except ImportError as e:
        print("chip_smoke: the sdf_torch package is missing: %s" % e,
              file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    kernels = {}

    # -- phase 1 ---------------------------------------------------------------
    print("== phase 1: card", flush=True)
    card = card_line()
    print("card: " + card)
    print("torch %s, CUDA %s, python %s" % (
        torch.__version__, torch.version.cuda, sys.version.split()[0]))
    print("device: %s x%d" % (torch.cuda.get_device_name(0),
                              torch.cuda.device_count()))

    # -- phase 2 ---------------------------------------------------------------
    print("== phase 2: build", flush=True)
    f = example(sp)
    t0 = time.time()
    libs = _build.build_many([
        ("eval_classify", eval_classify.kernel_source(f)),
        ("ntri", _build.source("ntri.cu")),
        ("compact", _build.source("compact.cu")),
    ])
    print("built %d libraries in %.1f s: %s" % (
        len(libs), time.time() - t0, ", ".join(p.name for p in libs)))

    # -- phase 3 ---------------------------------------------------------------
    print("== phase 3: kernels against their plain versions", flush=True)
    X, Y, Z = grid_axes(f, 2**22, torch.float32)
    npts = len(X) * len(Y) * len(Z)
    print("grid %d x %d x %d (%d points)" % (len(X), len(Y), len(Z), npts))

    # B1 in both dtypes; the float32 numbers go into the kernels line.
    for dt in (torch.float32, torch.float64):
        name = str(dt).split(".")[1]
        vk, ck = eval_classify.eval_and_classify(f, X, Y, Z, dt, dev)
        vp, cp = eval_classify._eval_classify_plain(f, X, Y, Z, dt, dev)
        err = max_abs_diff([(vk, vp), (ck, cp)])
        ints = torch.int32 if dt == torch.float32 else torch.int64
        check(torch.equal(vk.view(ints), vp.view(ints)) and torch.equal(ck, cp),
              "B1 eval_classify %s: vol and case bit-equal to plain" % name)
        ms = device_ms(lambda: eval_classify.eval_and_classify(
            f, X, Y, Z, dt, dev))
        pms = device_ms(lambda: eval_classify._eval_classify_plain(
            f, X, Y, Z, dt, dev), reps=5, warm=1)
        ops_pt = body_op_count(eval_classify.kernel_source(f))
        ncell = ck.numel()
        nbytes = vk.numel() * vk.element_size() + ncell * 4 + sum(
            len(a) for a in (X, Y, Z)) * vk.element_size()
        b, by = bound_ms(nbytes, ops_pt * npts + 16 * ncell, name)
        print("  B1 %s: kernel_ms %.4f plain_ms %.4f bound_ms %.4f (%s; %d "
              "ops/point) max_abs_err %g" % (name, ms, pms, b, by, ops_pt, err))
        if dt == torch.float32:
            kernels["eval_classify"] = dict(
                name="eval_classify", route="cuda",
                source="sdf_torch/csrc/eval_classify.cu",
                replaces="sdf_tpu/core/pallas_eval.py:53",
                max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=b, bound_by=by,
                library_ms=None,
            )
            case32, vol32 = ck, vk

    # B3: all 256 codes + random codes, then the main path's case grid.
    table = mc.get_tables("fast").on(dev, "ntri")
    rng = np.random.default_rng(0)
    codes = torch.as_tensor(np.concatenate(
        [np.arange(256), rng.integers(0, 256, 100003), [256, -1]]
    ).astype(np.int32), device=dev)
    got, want = mc.ntri_of(codes), mc._ntri_plain(codes, table)
    check(torch.equal(got, want),
          "B3 ntri: 256 codes + random codes equal to plain")
    err = max_abs_diff([(got, want)])
    got, want = mc.ntri_of(case32), mc._ntri_plain(case32, table)
    check(torch.equal(got, want), "B3 ntri: main-path case grid equal to plain")
    err = max(err, max_abs_diff([(got, want)]))
    n = case32.numel()
    ms = device_ms(lambda: mc.ntri_of(case32))
    pms = device_ms(lambda: mc._ntri_plain(case32, table))
    lms = device_ms(lambda: torch.index_select(table, 0, case32.reshape(-1)))
    b, by = bound_ms(8 * n)
    print("  B3 ntri: %d cells kernel_ms %.4f plain_ms %.4f library_ms %.4f "
          "bound_ms %.4f (%s) max_abs_err %g" % (n, ms, pms, lms, b, by, err))
    kernels["ntri"] = dict(
        name="ntri", route="cuda", source="sdf_torch/csrc/ntri.cu",
        replaces="sdf_tpu/core/mc.py:155", max_abs_err=err, ms=ms,
        plain_ms=pms, bound_ms=b, bound_by=by, library_ms=lms,
    )

    # The main path's masks: active cells (B4) and crossing edges (B5).
    cshape = tuple(case32.shape)
    tshape = tuple(-(-c // 32) for c in cshape)
    keep = torch.ones(cshape, dtype=torch.bool, device=dev)
    _, _, _, _, active, emask = mc.count_indexed(vol32, case32, keep, 32,
                                                 tshape)
    aflat = active.reshape(-1).contiguous()
    print("  main-path masks: %d cell slots (%d active), %d edge slots (%d "
          "crossing)" % (aflat.numel(), int(aflat.sum()), emask.numel(),
                         int(emask.sum())))
    for dens in (0.0, 1e-3, 0.5, 1.0):
        for size in (aflat.numel(), emask.numel()):
            m = torch.as_tensor(np.random.default_rng(size).random(size) < dens,
                                device=dev)
            cap = int(m.sum()) + 37
            ik, tk = compact.indices_of(m, cap)
            ip, tp = compact._indices_of_plain(m, cap)
            check(torch.equal(ik, ip) and int(tk) == int(tp),
                  "B4 indices_of: density %g, %d slots" % (dens, size))
            ik, wk, tk = compact.indices_and_ranktable_of(m, cap)
            ip, wp, tp = compact._ranktable_plain(m, cap)
            check(torch.equal(ik, ip) and torch.equal(wk, wp)
                  and int(tk) == int(tp),
                  "B5 indices_and_ranktable_of: density %g, %d slots"
                  % (dens, size))
    for m, key, what in ((aflat, "indices_of", "B4"),
                         (emask, "indices_and_ranktable_of", "B5")):
        cnt = int(m.sum())
        cap = mc.round_capacity(cnt)
        if key == "indices_of":
            run = lambda: compact.indices_of(m, cap)
            plain = lambda: compact._indices_of_plain(m, cap)
            lib = lambda: torch.nonzero(m)
            nbytes = m.numel() + 4 * cap
        else:
            run = lambda: compact.indices_and_ranktable_of(m, cap)
            plain = lambda: compact._ranktable_plain(m, cap)
            lib = None
            nbytes = m.numel() + 4 * cap + 8 * (-(-m.numel() // 32))
        got, want = run(), plain()
        check(all(torch.equal(g, w) for g, w in zip(got, want)),
              "%s %s: main-path mask equal to plain" % (what, key))
        err = max_abs_diff(list(zip(got, want)))
        ms = device_ms(run)
        pms = device_ms(plain, reps=5, warm=1)
        lms = device_ms(lib) if lib else None
        b, by = bound_ms(nbytes)
        print("  %s %s: %d slots (%d set) kernel_ms %.4f plain_ms %.4f "
              "library_ms %s bound_ms %.4f (%s) max_abs_err %g"
              % (what, key, m.numel(), cnt, ms, pms,
                 "%.4f" % lms if lms else "null", b, by, err))
        kernels[key] = dict(
            name=key, route="cuda", source="sdf_torch/csrc/compact.cu",
            replaces=("sdf_tpu/core/compact.py:118" if what == "B4"
                      else "sdf_tpu/core/compact.py:214"),
            max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=b, bound_by=by,
            library_ms=lms,
        )
    del vol32, case32, active, emask, aflat

    wrappers = {
        "eval_classify": eval_classify.eval_and_classify,
        "ntri": mc.ntri_of,
        "indices_of": compact.indices_of,
        "indices_and_ranktable_of": compact.indices_and_ranktable_of,
    }

    def drive(**kw):
        for w in wrappers.values():
            w.launches = 0
        pts = sp.generate(example(sp), verbose=False, mc_variant="fast", **kw)
        torch.cuda.synchronize()
        counts = {k: w.launches for k, w in wrappers.items()}
        return pts, counts

    # -- phase 4 ---------------------------------------------------------------
    print("== phase 4: generate(samples=2**22, float32) on the card",
          flush=True)
    pts, counts = drive(samples=2**22)
    print("  launches: %s" % counts)
    for k, c in counts.items():
        check(c >= 1, "%s launched on the main path (%d)" % (k, c))
        kernels[k]["launches"] = c
    check(len(pts) // 3 == TRIS_2P22,
          "%d triangles (want %d)" % (len(pts) // 3, TRIS_2P22))
    check(bool(np.isfinite(pts).all()) and pts.shape[1] == 3,
          "finite (3T, 3) vertices")
    stats = dict(sp.core.engine.LAST_STATS)
    t0 = time.time()
    cpu = sp.generate(example(sp), samples=2**22, verbose=False,
                      mc_variant="fast", device="cpu")
    print("  device='cpu' run: %.1f s" % (time.time() - t0))
    check(np.array_equal(pts, cpu), "soup bit-equal to the device='cpu' run")
    warm = []
    for _ in range(5):
        t0 = time.perf_counter()
        sp.generate(example(sp), samples=2**22, verbose=False,
                    mc_variant="fast")
        warm.append(time.perf_counter() - t0)
    print("  warm end-to-end s: median %.4f min %.4f (5 runs)" % (
        statistics.median(warm), min(warm)))
    print("  phases of the first run (s): %s" % json.dumps(stats))
    wall, busy, per = timeline(lambda: sp.generate(
        example(sp), samples=2**22, verbose=False, mc_variant="fast"))
    print("  profiled warm run: wall %.2f ms, device busy %.3f ms (%.1f%%), "
          "idle %.1f%%" % (wall, busy, 100 * busy / wall, 100 - 100 * busy / wall))
    print("  phases (s): %s" % json.dumps(dict(sp.core.engine.LAST_STATS)))
    top = sorted(per.items(), key=lambda kv: -kv[1])[:10]
    for k, v in top:
        print("    device %.4f ms  %s" % (v, k[:100]))

    # -- phase 5 ---------------------------------------------------------------
    print("== phase 5: generate(samples=2**24, float64) on the card",
          flush=True)
    t0 = time.perf_counter()
    pts, counts = drive(samples=2**24, dtype=torch.float64)
    print("  %.2f s, launches: %s" % (time.perf_counter() - t0, counts))
    for k, c in counts.items():
        check(c >= 1, "%s launched at 2^24 (%d)" % (k, c))
    check(len(pts) // 3 == TRIS_2P24,
          "%d triangles (want %d)" % (len(pts) // 3, TRIS_2P24))
    h = soup_hash(pts)
    check(h == SOUP_2P24, "soup sha256 %s" % h)

    # -- result ------------------------------------------------------------------
    order = ["eval_classify", "ntri", "indices_of", "indices_and_ranktable_of"]
    keys = ["name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"]
    print(json.dumps({"kernels": [{k: kernels[n][k] for k in keys}
                                  for n in order]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
