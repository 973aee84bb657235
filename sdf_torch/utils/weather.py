"""Session weather probes: what is THIS card and session actually capable of?
(counterpart of ``sdf_tpu.utils.weather``).

Host times of one call move 1.2-1.7x between runs on the card's machine,
and a card may run below its datasheet rates (a lower power limit, a warm
die), so a raw time cannot tell "the code got slower" from "the session
got slower".  These probes measure, in the same session as the work they
normalize:

  * ``dispatch_floor()`` -- the per-launch overhead of an amortized tiny
    copy launched through the port's own ctypes route; every raw phase
    time includes it.
  * ``probe_rates(X, Y, Z)`` -- the achievable mul-add GFLOP/s, sqrt Gop/s
    and device-memory copy GB/s, the first two on the SAME grid shape and
    input structure as the headline eval (three 1-D coordinate arrays
    broadcast in the kernel).

Each probe is one hand-written kernel (``csrc/probes.cu``; the JAX
package's probes are XLA fusions): PyTorch eager would run a 64-step chain
as 128 kernels and measure memory traffic.  The kernels are built with
``-fmad=false``, as every kernel of the port is, so a mul-add step issues
a multiply and an add, and ``muladd_gflops`` (2 flops a step, as the JAX
probe counts) is at most about half of the card's FMA peak.

``device=None`` means ``"cuda"`` and raises without a card; ``device="cpu"``
runs the probes' plain versions (torch ops), which the tests hold against
the JAX formulas and ``chip_smoke.py`` holds the kernels against.  The
wrappers ``muladd``, ``sqrts`` and ``copy`` launch for a CUDA tensor and
raise for any other: they never run the plain version.

Used by ``tools/roofline_torch.py`` (the roofline accounting of kernel B1)
and ``chip_smoke.py`` phase 23.
"""

from __future__ import annotations

import ctypes
import time

import numpy as np
import torch

from .. import _build
from ..core.node import resolve_device, upload
from ..ops.vecmath import sqrt

# flops per point for the canonical example model, counted from
# ops/shapes3.py's formulas (mul/add/sub/cmp = 1; sqrts counted separately
# as transcendentals).  See tools/roofline_torch.py for the per-primitive
# table.
EXAMPLE_FLOPS_PER_POINT = 90
EXAMPLE_SQRTS_PER_POINT = 4

# mul-add chain length / sqrt chain length used by the probes (long enough
# that the broadcast+write cost is a small fraction of the chain); the
# kernels in csrc/probes.cu check that these are theirs.
_CHAIN = 64
_SQ = 32

# The mul-add constant, a float32 value (1.0000001 rounded to float32).
_C = float(np.float32(1.0000001))

# The bandwidth probe's buffer: (1 << 21) x 128 float32, 1 GiB, big enough
# that the dispatch floor is a small fraction of the call.
COPY_SHAPE = (1 << 21, 128)
# The dispatch-floor probe's buffer.
FLOOR_SHAPE = (2048, 128)
# A floor-corrected rate measures the work only where the raw call took at
# least this many dispatch floors; below that the subtraction amplifies the
# floor's noise (``floor_bound``).
FLOOR_MARGIN = 4


def _lib():
    lib = _build.load("probes", _build.source("probes.cu"))
    if not getattr(lib, "_sdf_typed", False):
        vp, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        for fn in (lib.sdf_probe_muladd, lib.sdf_probe_sqrts):
            fn.argtypes = [vp, vp, vp, i, i, i, i, vp, vp]
            fn.restype = ctypes.c_int
        lib.sdf_probe_copy.argtypes = [vp, i64, i64, vp, vp]
        lib.sdf_probe_copy.restype = ctypes.c_int
        lib._sdf_typed = True
    return lib


def _check_axes(x, y, z, what):
    for a in (x, y, z):
        _build.require_cuda(a, what)
        if a.dtype != torch.float32 or a.dim() != 1:
            raise ValueError("%s: the axes must be 1-D float32" % what)


def _chain(entry, x, y, z, chain, what):
    _check_axes(x, y, z, what)
    entry = getattr(_lib(), entry)
    out = torch.empty((len(x), len(y), len(z)), dtype=torch.float32,
                      device=x.device)
    _build.check(
        entry(x.data_ptr(), y.data_ptr(), z.data_ptr(), len(x), len(y),
              len(z), chain, out.data_ptr(), _build.stream_ptr(x.device)),
        what,
    )
    return out


def muladd(x, y, z):
    """The mul-add probe kernel on float32 CUDA axes: ``(nx, ny, nz)``
    float32.  Adds one to ``muladd.launches`` when it launches."""
    out = _chain("sdf_probe_muladd", x, y, z, _CHAIN, "probe muladd")
    muladd.launches += 1
    return out


def sqrts(x, y, z):
    """The sqrt probe kernel on float32 CUDA axes: ``(nx, ny, nz)``
    float32.  Adds one to ``sqrts.launches`` when it launches."""
    out = _chain("sdf_probe_sqrts", x, y, z, _SQ, "probe sqrts")
    sqrts.launches += 1
    return out


def copy(v):
    """The copy probe kernel: ``v + 1`` of a contiguous float32 CUDA
    tensor, in a new tensor: 16-byte vectors when both buffers are
    aligned, then one value a thread.  Adds one to ``copy.launches`` when
    it launches."""
    _build.require_cuda(v, "probe copy")
    if v.dtype != torch.float32 or not v.numel():
        raise ValueError("probe copy: a non-empty float32 tensor")
    lib = _lib()
    out = torch.empty_like(v)
    aligned = v.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    nvec = v.numel() // 4 if aligned else 0
    _build.check(
        lib.sdf_probe_copy(v.data_ptr(), v.numel(), nvec, out.data_ptr(),
                           _build.stream_ptr(v.device)),
        "probe copy",
    )
    copy.launches += 1
    return out


muladd.launches = sqrts.launches = copy.launches = 0


def _muladd_plain(x, y, z):
    """The mul-add probe with torch ops (each op rounded, no FMA)."""
    yb = y[None, :, None]
    acc = x[:, None, None] + yb + z[None, None, :]
    for _ in range(_CHAIN):
        acc = acc * _C + yb
    return acc


def _sqrts_plain(x, y, z):
    """The sqrt probe with torch ops; ``vecmath.sqrt`` is the correctly
    rounded square root on the CPU too."""
    acc = x[:, None, None] + y[None, :, None] + z[None, None, :]
    acc = torch.abs(acc) + 1.0
    for _ in range(_SQ):
        acc = sqrt(acc) + 1.0
    return acc


def _copy_plain(v):
    return v + 1.0


def _probes(device):
    """``(muladd, sqrts, copy)`` for ``device``: the kernels on a card, the
    plain versions on the CPU."""
    if device.type == "cpu":
        return _muladd_plain, _sqrts_plain, _copy_plain
    return muladd, sqrts, copy


def _first_tensor(r):
    if isinstance(r, torch.Tensor):
        return r
    if isinstance(r, (tuple, list)):
        for x in r:
            t = _first_tensor(x)
            if t is not None:
                return t
    return None


def _fence(r):
    """Wait for the device of the result's first tensor (none on the CPU)."""
    t = _first_tensor(r)
    if t is not None and t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


def timed_min(f, *args, K=16, reps=3):
    """Best amortized seconds/call over ``reps`` batches of K back-to-back
    calls, each batch closed by one fence (``torch.cuda.synchronize`` on the
    result's device); the minimum across batches is the least
    weather-contaminated estimate.  Returns ``(seconds, last result)``."""
    r = f(*args)
    _fence(r)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(K):
            r = f(*args)
        _fence(r)
        best = min(best, (time.perf_counter() - t0) / K)
    return best, r


def dispatch_floor(K=32, device=None):
    """Per-launch overhead (seconds) of a tiny copy, amortized: the probe
    copy kernel through the port's ctypes route on a card."""
    device = resolve_device(device)
    tiny = torch.ones(FLOOR_SHAPE, dtype=torch.float32, device=device)
    t, _ = timed_min(_probes(device)[2], tiny, K=K)
    return t


def probe_rates(X, Y, Z, floor=None, device=None):
    """Measure achievable rates on the given grid axes (host arrays).

    Returns a dict with ``muladd_gflops``, ``sqrt_gops``, ``copy_gbs`` and
    ``dispatch_floor_ms`` (measured here when not supplied).  All rates are
    floor-corrected (the amortized per-launch overhead is subtracted before
    dividing), as the JAX package corrects them; ``floor_bound`` names
    those whose call was too short beside the floor to measure the card."""
    device = resolve_device(device)
    if floor is None:
        floor = dispatch_floor(device=device)
    ma, sq, cp = _probes(device)
    n = len(X) * len(Y) * len(Z)
    xt, yt, zt = upload([np.asarray(a, np.float64) for a in (X, Y, Z)],
                        torch.float32, device)

    t_ma, _ = timed_min(ma, xt, yt, zt)
    muladd_gflops = 2.0 * _CHAIN * n / max(t_ma - floor, 1e-9) / 1e9

    t_sq, _ = timed_min(sq, xt, yt, zt)
    sqrt_gops = _SQ * n / max(t_sq - floor, 1e-9) / 1e9

    big = torch.ones(COPY_SHAPE, dtype=torch.float32, device=device)
    t_copy, _ = timed_min(cp, big, K=8)
    copy_gbs = 2 * big.numel() * 4 / max(t_copy - floor, 1e-9) / 1e9
    del big

    return {
        "dispatch_floor_ms": floor * 1e3,
        "muladd_gflops": muladd_gflops,
        "sqrt_gops": sqrt_gops,
        "copy_gbs": copy_gbs,
    }


def floor_bound(rates, n_points, margin=FLOOR_MARGIN):
    """The keys of ``probe_rates``' rates, taken on grid axes of
    ``n_points`` points, whose raw call took under ``margin`` dispatch
    floors: the floor, not the work, sets such a rate, so it is no
    measurement of the card.  The raw time is recovered from the rate
    (work / rate + floor), so a call the correction clamped counts as one
    floor."""
    floor = rates["dispatch_floor_ms"] / 1e3
    work = {"muladd_gflops": 2.0 * _CHAIN * n_points,
            "sqrt_gops": float(_SQ * n_points),
            "copy_gbs": 2.0 * 4 * int(np.prod(COPY_SHAPE))}
    return sorted(k for k, w in work.items()
                  if w / (rates[k] * 1e9) + floor < margin * floor)


def eval_utilization(n_points, t_eval_corrected, rates,
                     flops_per_point=EXAMPLE_FLOPS_PER_POINT,
                     sqrts_per_point=EXAMPLE_SQRTS_PER_POINT):
    """(vpu_utilization, time_model_ratio) for an eval phase.

    ``vpu_utilization``: achieved GFLOP/s over the same-session mul-add
    probe rate.  ``time_model_ratio``: the flops-at-muladd-rate +
    sqrts-at-sqrt-rate + one-f32-write-at-copy-bandwidth decomposition
    over the measured time (~0.9 when those three explain the kernel)."""
    gflops = flops_per_point * n_points / t_eval_corrected / 1e9
    util = gflops / rates["muladd_gflops"]
    t_model = (
        flops_per_point * n_points / (rates["muladd_gflops"] * 1e9)
        + sqrts_per_point * n_points / (rates["sqrt_gops"] * 1e9)
        + 4.0 * n_points / (rates["copy_gbs"] * 1e9 / 2)
    )
    return util, t_model / t_eval_corrected
