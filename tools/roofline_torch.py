"""Roofline / MFU accounting for kernel B1, the port's eval on the main path
(counterpart of tools/roofline.py, which times the JAX package's XLA
eval).

Method: measure, on the SAME grid shape and dtype as the headline eval
(the example model, float32, ``engine._estimate_bounds``' grid at
``2**samples_log2`` samples),

  * the per-launch overhead floor (``weather.dispatch_floor``: a tiny
    copy kernel, amortized); every time below is reported raw AND
    floor-corrected;
  * the eval: ``eval_classify.eval_and_classify`` (kernel B1 on the card),
    K calls back to back and one fence, so its host work (the kernel
    source looked up, the axes uploaded, the launch) counts where it is
    longer than the kernel;
  * the same-session probe rates (``weather.probe_rates``): mul-add
    GFLOP/s, sqrt Gop/s and copy GB/s, from hand-written kernels built
    with ``-fmad=false`` as B1 is;

then count the example model's flops a point analytically (the table
below, as tools/roofline.py counts them) and report

  eval GFLOP/s          = model_flops * n / t_eval_corrected
  VPU utilization       = eval GFLOP/s / measured mul-add GFLOP/s
  HBM utilization       = bytes B1 writes / t_eval / measured copy GB/s:
                          4 bytes a sample (the float32 volume) plus 4 a
                          cell (B1 writes the 8-bit case as int32)
  time_model            = flops at the mul-add rate + sqrts at the sqrt
                          rate + one volume write at copy bandwidth
                          (ratio ~1 means those three explain the call)

flops per point for the example model, counted from ops/shapes3.py's
formulas (mul/add/sub/cmp = 1, sqrt = 1 flop + counted separately as a
transcendental):
  sphere(1):          x*x+y*y+z*z (5) + sqrt (1) + sub (1)        =  7
  box(1.5):           abs (3) + sub (3) + max-chain inner (2) +
                      per-comp max0 (3) + norm (5+1) + min (1)    = 18
  intersection:       max (1)                                     =  1
  cylinder(0.5):      x*x+y*y (3) + sqrt (1) + sub (1)            =  5
  orient(=rotate):    3x3 matvec (15)                             = 15
  union x2:           min (2)                                     =  2
  difference:         max+neg (2)                                 =  2
  3 cylinders+orients: 3 * (15 + 5)                               = 60
  total = 90 (+ 4 sqrts: sphere + 3 cylinders; box norm ~masked)

Run on a machine with the card, from the root of a checkout:

    python3 tools/roofline_torch.py --samples 26

(``--device cpu`` runs the plain versions: a check of the accounting, not
a measurement of any device).  Prints one JSON line, the keys of
tools/roofline.py's plus ``device``, the card's name.
"""

import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))


def main(samples_log2=26, device=None):
    """Measure and print the accounting; returns the printed dict."""
    import numpy as np
    import torch

    from sdf_torch.core import engine, eval_classify
    from sdf_torch.core.node import resolve_device
    from sdf_torch.models import example
    from sdf_torch.utils import weather

    device = resolve_device(device)
    dtype = torch.float32
    f = example()
    (x0, y0, z0), (x1, y1, z1) = engine._estimate_bounds(f, dtype)
    volume = (x1 - x0) * (y1 - y0) * (z1 - z0)
    step = (volume / 2**samples_log2) ** (1 / 3)
    X = np.arange(x0, x1, step)
    Y = np.arange(y0, y1, step)
    Z = np.arange(z0, z1, step)
    n = len(X) * len(Y) * len(Z)
    ncells = (len(X) - 1) * (len(Y) - 1) * (len(Z) - 1)
    shape = (len(X), len(Y), len(Z))

    # --- the measured kernel + the session probes ---------------------
    t_floor = weather.dispatch_floor(device=device)
    t_eval, out = weather.timed_min(
        eval_classify.eval_and_classify, f, X, Y, Z, dtype, device
    )
    del out
    t_eval_c = max(t_eval - t_floor, 1e-9)
    rates = weather.probe_rates(X, Y, Z, floor=t_floor, device=device)

    # --- accounting (all on floor-corrected times) --------------------
    FL = weather.EXAMPLE_FLOPS_PER_POINT
    SQ = weather.EXAMPLE_SQRTS_PER_POINT
    written = 4.0 * n + 4.0 * ncells
    util, tm_ratio = weather.eval_utilization(n, t_eval_c, rates)
    row = {
        "samples_log2": samples_log2,
        "n_points": n,
        "grid": shape,
        "dispatch_floor_ms": t_floor * 1e3,
        "eval_ms_raw": t_eval * 1e3,
        "eval_ms": t_eval_c * 1e3,
        "eval_pts_per_s": n / t_eval_c,
        "model_flops_per_point": FL,
        "model_sqrts_per_point": SQ,
        "eval_gflops": FL * n / t_eval_c / 1e9,
        "probe_muladd_gflops": rates["muladd_gflops"],
        "probe_sqrt_gops": rates["sqrt_gops"],
        "probe_copy_gbs": rates["copy_gbs"],
        "vpu_utilization": util,
        "hbm_utilization_write": written / t_eval_c / 1e9 / rates["copy_gbs"],
        "time_model_ratio": tm_ratio,
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
    }
    print(json.dumps(row), flush=True)
    return row


if __name__ == "__main__":
    lg = 26
    if "--samples" in sys.argv:
        lg = int(sys.argv[sys.argv.index("--samples") + 1])
    dev = None
    if "--device" in sys.argv:
        dev = sys.argv[sys.argv.index("--device") + 1]
    main(lg, dev)
