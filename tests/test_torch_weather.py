"""The session probes (sdf_torch.utils.weather) against sdf_tpu.utils.weather.

The probes' plain versions run on the CPU here; their kernels
(csrc/probes.cu) need the card (tests/test_torch_cuda.py, chip_smoke.py
phase 23).

Tolerances:
  * the constants and ``eval_utilization``: equal (the same arithmetic on
    the same floats).
  * the plain probes against the JAX formulas of weather.py:96-113 and
    :120-122, run eagerly under ``jax.disable_jit()``: bit-equal float32
    (each op rounded; jitted XLA would contract the mul-add chain into
    FMAs, which neither the port's kernels nor its plain versions do).
"""

import inspect
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdf_tpu.utils import weather as jweather
from sdf_torch.utils import weather


def _axes(seed, n=(7, 6, 5)):
    rng = np.random.default_rng(seed)
    return [rng.uniform(-2.0, 2.0, k) for k in n]


def test_constants_equal():
    for name in ("EXAMPLE_FLOPS_PER_POINT", "EXAMPLE_SQRTS_PER_POINT",
                 "_CHAIN", "_SQ"):
        assert getattr(weather, name) == getattr(jweather, name), name
    src = open(weather.__file__.replace("utils/weather.py",
                                        "csrc/probes.cu")).read()
    assert "constexpr int CHAIN = %d;" % weather._CHAIN in src
    assert "constexpr int SQ = %d;" % weather._SQ in src


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_eval_utilization_equal(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 2**26))
    t = float(rng.uniform(1e-4, 1e-1))
    rates = {"muladd_gflops": float(rng.uniform(1e3, 4e4)),
             "sqrt_gops": float(rng.uniform(1e2, 4e3)),
             "copy_gbs": float(rng.uniform(5e2, 3e3)),
             "dispatch_floor_ms": float(rng.uniform(0.005, 2.0))}
    kw = {}
    if seed == 2:
        kw = dict(flops_per_point=50, sqrts_per_point=3)
    assert weather.eval_utilization(n, t, rates, **kw) == \
        jweather.eval_utilization(n, t, rates, **kw)


def _jax_probes(X, Y, Z):
    """weather.py's jitted probe bodies, op for op, run eagerly."""
    x, y, z = (jnp.asarray(a, jnp.float32) for a in (X, Y, Z))
    with jax.disable_jit():
        acc = x[:, None, None] + y[None, :, None] + z[None, None, :]
        c = jnp.float32(1.0000001)
        for _ in range(jweather._CHAIN):
            acc = acc * c + y[None, :, None]
        ma = np.asarray(acc)
        acc = x[:, None, None] + y[None, :, None] + z[None, None, :]
        acc = jnp.abs(acc) + 1.0
        for _ in range(jweather._SQ):
            acc = jnp.sqrt(acc) + 1.0
        sq = np.asarray(acc)
        cp = np.asarray(jnp.asarray(ma) + 1.0)
    return ma, sq, cp


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_probes_equal_eager_jax(seed):
    X, Y, Z = _axes(seed)
    ma, sq, cp = _jax_probes(X, Y, Z)
    xt, yt, zt = (torch.as_tensor(a, dtype=torch.float32) for a in (X, Y, Z))
    got_ma = weather._muladd_plain(xt, yt, zt)
    assert got_ma.dtype == torch.float32 and got_ma.shape == ma.shape
    np.testing.assert_array_equal(got_ma.numpy().view(np.int32),
                                  ma.view(np.int32))
    got_sq = weather._sqrts_plain(xt, yt, zt)
    np.testing.assert_array_equal(got_sq.numpy().view(np.int32),
                                  sq.view(np.int32))
    got_cp = weather._copy_plain(got_ma)
    np.testing.assert_array_equal(got_cp.numpy().view(np.int32),
                                  cp.view(np.int32))


def _jax_rate_keys():
    src = inspect.getsource(jweather.probe_rates)
    return set(re.findall(r'"(\w+)":', src[src.rindex("return {"):]))


def test_probe_rates_on_cpu(monkeypatch):
    monkeypatch.setattr(weather, "COPY_SHAPE", (64, 128))
    X, Y, Z = _axes(3, (12, 11, 10))
    rates = weather.probe_rates(X, Y, Z, device="cpu")
    assert set(rates) == _jax_rate_keys() == {
        "dispatch_floor_ms", "muladd_gflops", "sqrt_gops", "copy_gbs"}
    assert all(np.isfinite(v) and v > 0 for v in rates.values()), rates
    # a given floor is used, not measured
    rates = weather.probe_rates(X, Y, Z, floor=0.0, device="cpu")
    assert rates["dispatch_floor_ms"] == 0.0


def test_floor_bound_names_rates_the_floor_sets():
    """A rate whose raw call (work / rate + floor) took under FLOOR_MARGIN
    floors is flagged: the 2**22 mul-add and sqrt calls beside a 0.04 ms
    floor, a call the correction clamped, not 2**26's or the 1 GiB copy."""
    r = {"dispatch_floor_ms": 0.04, "muladd_gflops": 51547.0,
         "sqrt_gops": 3971.0, "copy_gbs": 3179.0}
    assert weather.floor_bound(r, 162**3) == ["muladd_gflops", "sqrt_gops"]
    r26 = dict(r, muladd_gflops=21000.0, sqrt_gops=2400.0)
    assert weather.floor_bound(r26, 407**3) == []
    clamped = dict(r26, muladd_gflops=2.0 * weather._CHAIN * 407**3 / 1e-9
                   / 1e9)
    assert weather.floor_bound(clamped, 407**3) == ["muladd_gflops"]
    assert weather.floor_bound(dict(r26, dispatch_floor_ms=0.0), 8) == []


def test_timed_min_and_dispatch_floor_on_cpu():
    calls = []
    t, r = weather.timed_min(lambda a: calls.append(a) or a + 1,
                             torch.zeros(3), K=4, reps=2)
    assert t >= 0 and len(calls) == 1 + 4 * 2
    assert torch.equal(r, torch.ones(3))
    assert weather.dispatch_floor(K=2, device="cpu") > 0


def test_default_device_is_cuda_and_raises_without_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X = np.linspace(-1, 1, 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        weather.dispatch_floor()
    with pytest.raises(RuntimeError, match="CUDA"):
        weather.probe_rates(X, X, X)


def test_probe_wrappers_refuse_cpu_tensors():
    """The wrappers launch or raise: a CPU tensor is refused, not computed
    by the plain version, and counts no launch."""
    before = [w.launches for w in (weather.muladd, weather.sqrts,
                                   weather.copy)]
    x = torch.zeros(4)
    for fn, args in ((weather.muladd, (x, x, x)), (weather.sqrts, (x, x, x)),
                     (weather.copy, (x,))):
        with pytest.raises(ValueError, match="CUDA"):
            fn(*args)
    assert [w.launches for w in (weather.muladd, weather.sqrts,
                                 weather.copy)] == before

