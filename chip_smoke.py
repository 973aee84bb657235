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
     own device="cpu" run, every kernel of that path launched, the warm time;
  5. the same at 2**24 in float64: 731,152 triangles and the canonical soup
     sha256 pinned by tests/test_topology_2p24.py;
  6. generate() AT ITS DEFAULTS (mc_variant="lewiner") at 2**22 in float32:
     291,028 triangles, a soup bit-equal to the device="cpu" run, all five
     kernels launched, no conflicted cell, the first call against the
     second (memoized) call, the warm time and the profiled idle share;
  7. the same at 2**24 in float64: 731,152 triangles, the pinned soup, and
     the extended-case grid of kernel B2 bit-equal to its plain version on
     the same volume, its sha256 printed beside the pin of
     tests/test_topology_2p24.py;
  8. the saddle (gyroid) model at 2**22 in float32 under both variants:
     triangle counts and soups differ, and kernel B1 is bit-equal to its
     plain version on this model (sin and cos on the card);
  9. the tiled sparse path at full width: generate(zoo.blobby(),
     samples=2**26) at its defaults.  The cull removes over 0.6 of the
     batches, so the speculative dense result is discarded and the kept
     tiles go through kernels B6, B2, B3, B4 and B5.  The canonical soup
     equals that of the dense pipeline under the same cull mask, triangles
     come in (tile, cell) order, and the warm time, phases and idle share
     are printed;
 10. generate(sparse="tiles") of the example model at 2**22 under both
     variants: 291,028 triangles and the dense run's canonical soup,
     output="mesh" gathering to the soup, and blobby at 2**22 bit-equal to
     the device="cpu" run;
 11. a gather-bearing expression (a table lookup defined here) under
     generate(sparse="tiles"): kernel B7 launched, soup bit-equal to the
     device="cpu" run; and at the defaults, where the cull alone decides
     the route (dense with B1 reading the fields below 0.6 culled);
 12. a polygon model (a gather: B1 reads its recorded field) at 2**22 in
     float32 and float64 with sparse=False (B1 once, B7 never, soup
     bit-equal to the device="cpu" run), at the defaults (the route the cull
     decides) and with sparse="tiles" (the defaults' canonical soup), warm
     times and phases; and once at 2**24 in float32 with sparse=False;
 13. a mesh SDF: an STL of the example model written by the port, read with
     Mesh.from_file, Mesh.sdf on the card (timed), examples/mesh.py's
     cross-hatch remix at 2**22 under the three routes, checked as in 12;
 14. a legacy closure that only numpy runs (the host tier) in an
     expression at 2**20 with sparse=False: B1 reads its field, and the
     soup equals the device="cpu" run;
 15. textures, if this machine has Pillow (and scipy): examples/image.py's
     model at 2**22 under the three routes, checked as in 12; and, if a
     DejaVuSans font is found too, examples/text.py's.  What is not run is
     named on a line of its own.
Phase 3 also holds kernel B1 with field inputs (1, 2 and 4 fields, both
dtypes, on the example's grid) and on a gather-free model of 2D ops, and
kernel B5 at edge shapes (ragged, all set, capacity below the count,
misaligned views).  It also holds kernels B6 and B7 against their plain versions on the
tile lists of phases 9 to 11, and kernels B1 to B5 at the shapes phase 9
gives them: B1 (in both dtypes), B2, B3 on blobby's whole 2**26 grid (the
speculative dense pass), B2 to B5 on the 512 tile volumes, the tile-cell
mask and the per-tile edge mask.  For B1 it prints the launch plan (slab
length, blocks, evaluations a sample); for B2 its plan (row blocks, slabs,
blocks), how many cells of case 0 or 255 still carry interior bits (why
every cell runs B2's body), its time in float64 on blobby's 2**26 grid
and its time on a random-normal volume of the example's shape (what the
example's nearly linear cells cost); for B3 it also checks views at
int32 offsets 1 to 3; for B4 the share of its time that the memset of
its look-back scratch takes.
Then one JSON line with every kernel, the card line again, and last the
result line.  Any failed check raises, and the script exits non-zero
without a result line; so does a machine without a CUDA device.

``python3 chip_smoke.py --ptxas`` instead compiles kernels B1 and B6/B7
of four zoo models, and kernels B2 and B3, with ``-Xptxas -v`` and prints
each entry function's registers, stack and spills in both dtypes; the SASS
instructions per point of the example's and blobby's B1 bodies and per
cell of B2's body (one-point and one-cell probe kernels, counted with
cuobjdump); and, on a machine with a card, the instruction floors: B1's on
the example's and blobby's main-path grids (those instructions times the
samples B1's plan evaluates, over the card's issue rate), and B2's on the
example's 162^3 grid, blobby's 407^3 grid and the routed run's 512 tile
volumes (its instructions times the cells).

``python3 chip_smoke.py --slab-sweep`` times kernel B1 with its slab
length forced to each of a range of values, on the example's 2**22 grid
and blobby's 2**26 grid in both dtypes, and kernel B2 with its slab length
forced, on those grids and on 512 tile volumes; each run is held
bit-equal to the default plan's output.
"""

import cProfile
import hashlib
import importlib.util
import json
import os
import pstats
import re
import statistics
import subprocess
import sys
import time
import types

SOUP_2P24 = "54d4ad9c22a8ce6bb77d8b763e2abb6878eda56ece4a40ea8aa274802b698ca3"
EXT_GRID_2P24 = "3fb04083920066edbaef61d2d80986b926941df188874e34fdda3b447eb73fcc"
TRIS_2P22 = 291028
TRIS_2P24 = 731152

# Operations per cell of the fused classify_ext kernel, counted from its
# body (csrc/classify_ext.cu): 103 before the roots, 213 for each of the two
# roots, 54 for the six face tests, 8 level shifts, 15 for the combine.
CLASSIFY_EXT_OPS_PER_CELL = 103 + 2 * 213 + 54 + 8 + 15

# Degenerate cells of the example model (flat faces: boundary double roots)
# and an exact interior tie at four scales; corner order CORNER_OFFSETS.
SPECIAL_CELLS = [
    [0.3580868897091918, 0.3258959235173755, 0.3113351974228378,
     0.3499999999999992, 0.3499999999999992, 0.30999999999999517,
     0.30999999999999517, 0.3499999999999992],
    [-0.05000000000000071, -0.08309518948453065, -0.04332310828824326,
     -0.04332310828824326, -0.05000000000000071, -0.0803447251418774,
     -0.040370243444249, -0.040370243444249],
    [0.3499999999999992, 0.3499999999999992, 0.3499999999999992,
     0.35572858640658467, 0.30999999999999517, 0.30999999999999517,
     0.30999999999999517, 0.32348026052524403],
    [0.23336936884292925, 0.2300000000000022, 0.2300000000000022,
     0.2300000000000022, 0.27000000000000046, 0.27000000000000046,
     0.27000000000000046, 0.27000000000000046],
    [0.23923190379189396, 0.23923190379189574, 0.23923190379189574,
     0.19933407243254475, 0.2331667187174724, 0.23316671871747374,
     0.23316671871747374, 0.19405882918443362],
    [0.11337325277733967, 0.11767616061182906, 0.08719823399415105,
     0.08277421469112767, 0.10999999999999943, 0.10999999999999943,
     0.0699999999999994, 0.0699999999999994],
    [0.20470353879533149, 0.18999999999999995, 0.16894109285506342,
     0.20470353879533149, 0.22143223445631932, 0.18999999999999995,
     0.183772233983162, 0.22143223445631932],
    [-0.0035871324805683003, -0.043323108288245926, -0.00999999999999801,
     -0.0035871324805683003, -0.009901951359280403, -0.04918120870983955,
     -0.00999999999999801, -0.009901951359280403],
    [0.2729493312775664, 0.30999999999999517, 0.3174217244299484,
     0.28545711713771027, 0.27000000000000046, 0.30999999999999517,
     0.30999999999999517, 0.27000000000000046],
] + [[v * s for v in (1.0, 0.0, -1.0, 0.0, 0.0, -1.0, 2.0, -1.0)]
     for s in (1.0, 0.1, 1 / 3, 0.3141592653589793)]

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


def table_field(table, lo=-1.5, hi=1.5):
    """A gather-marked SDF: the heightfield ``z - table[i(x)]``, the table
    looked up by an index computed from ``x``.  The generated kernel body
    cannot hold the lookup, so its field is computed ahead of kernel B7."""
    import torch

    from sdf_torch.core import hybrid
    from sdf_torch.core.node import SDF3, as_param

    n = len(table)

    @hybrid.mark_gather
    def table_field_fn(q, p):
        x, z = p[0], p[2]
        i = torch.clamp(torch.round((x - lo) * ((n - 1) / (hi - lo))), 0, n - 1)
        return z - q["table"][i.to(torch.int64)]

    return SDF3(table_field_fn, {"table": as_param(table)})


def gather_models(m):
    """The table field under a rotation (recorded at rotated points) and
    under circular_array, whose parent evaluates the child twice (two
    fields, two reads)."""
    import numpy as np

    table = 0.25 * np.cos(np.linspace(0.0, 9.0, 25))
    return {
        "rotated": m.sphere(1.2) & table_field(table).rotate(0.5, m.X),
        "circular": m.sphere(1.2) & table_field(table).translate(
            (0.3, 0.0, 0.0)).circular_array(3, 0.0),
    }


GATHER_BOUNDS = ((-1.3, -1.3, -1.3), (1.3, 1.3, 1.3))


def polygon_points(seed=0, n=9):
    """A star-shaped polygon of ``n`` seed-made vertices (tests/
    torch_helpers.py makes the same ones)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    ang = np.sort(rng.uniform(0.0, 2 * np.pi, n))
    return np.stack([np.cos(ang), np.sin(ang)], 1) * rng.uniform(0.55, 1.0,
                                                                 (n, 1))


def polygon_model(m):
    """A seed-made polygon, extruded, unioned with a rounded box: one
    gather-bearing subtree (the polygon's loop over its edges), one field."""
    return (m.polygon(polygon_points(0)).extrude(0.6)
            | m.rounded_box((0.5, 0.5, 1.0), 0.1))


def polygon4_model(m):
    """A 2D circular_array of four polygons, extruded: four fields."""
    poly = m.polygon(polygon_points(3, 7)).scale(0.45).translate((0.5, 0))
    return poly.circular_array(4).extrude(0.8) | m.sphere(0.3)


def plane_ops_model(m):
    """Gather-free 2D ops lifted to 3D: every op of it records into the
    generated kernel body."""
    return (m.hexagon(0.8).extrude(0.6)
            | m.rounded_x(0.5, 0.1).revolve(0.6)
            | m.equilateral_triangle().scale(0.5).extrude(1.2)
            | m.rounded_rectangle((0.8, 0.5), (0.1, 0.2, 0.05, 0.15))
            .extrude_to(m.circle(0.3), 1.4).translate((0.2, 0.2, 0.1))
            | m.vesica(0.6, 0.2).rotate(0.3).revolve(0.2).translate((0, 0, 0.5)))


def legacy_model(m):
    """A reference-style closure that only numpy runs (the host tier),
    intersected with a box."""
    import numpy as np

    @m.sdf3
    def blob(r=0.8):
        def f(p):
            a = np.asarray(p, dtype=np.float64)
            return np.sqrt(np.sum(a * a, axis=1)) - r

        return f

    return blob() & m.box(1.2)


def hollowed_with_cross_hatch_ribs(m, f, shell_thickness, rib_width,
                                   rib_height, rib_spacing):
    """examples/mesh.py's remix of a mesh SDF, in the package ``m``."""
    import numpy as np

    d = rib_width / 2
    rib = m.slab(z0=-d, z1=d).repeat(rib_spacing)
    rib = rib.rotate(np.pi / 4, m.Y) | rib.rotate(-np.pi / 4, m.Y)
    rib &= f.erode(rib_height / 2).shell(rib_height)
    d = shell_thickness
    return f.erode(d / 2).shell(d) | rib


def image_model(m, path="examples/flower.png"):
    """examples/image.py's model."""
    w, h = m.measure_image(path)
    f = m.rounded_box((w * 1.1, h * 1.1, 0.1), 0.05)
    f |= m.image(path).extrude(1) & m.slab(z0=0, z1=0.075)
    return f


def text_model(m, font):
    """examples/text.py's model, with the font file ``font``."""
    w, h = m.measure_text(font, "Hello, world!")
    f = m.rounded_box((w + 1, h + 1, 0.2), 0.1)
    f -= m.text(font, "Hello, world!").extrude(1)
    return f


def font_file(name="DejaVuSans.ttf"):
    """The path of the font file ``name`` in the directories PIL searches on
    Linux (the XDG data directories' ``fonts``), or None."""
    homes = [os.environ.get("XDG_DATA_HOME")
             or os.path.expanduser("~/.local/share")]
    homes += (os.environ.get("XDG_DATA_DIRS")
              or "/usr/local/share:/usr/share").split(":")
    for home in homes:
        for dirpath, _, files in os.walk(os.path.join(home, "fonts")):
            if name in files:
                return os.path.join(dirpath, name)
    return None


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
        for _ in range(4):  # the profiler may drop a profile's events
            names = {e.name for e in _kernel_events(_profiled(
                lambda: _FLUSH["buf"].bitwise_not_())[0])}
            if names:
                break
        if not names:
            raise RuntimeError("torch.profiler recorded no CUDA kernel")
        _FLUSH["names"] = names
    _FLUSH["buf"].bitwise_not_()


def device_ms(fn, reps=20, warm=3, match=None):
    """Device time per call of ``fn`` in ms, each call after an L2 flush:
    the summed durations of the kernels (and memsets) it launches, from
    torch.profiler, so host work between launches is not counted; with
    ``match``, of those whose name holds it only.  The profiler on the
    card sometimes drops events: a profile with none, or with a kernel
    that is not a whole number of times per call, is taken again (up to
    four profiles, each with a note; the last one that recorded any is
    used).  Raises if none recorded a kernel of ``fn``."""
    import torch

    _flush_l2()
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(reps):
            _flush_l2()
            fn()

    kept = None
    for attempt in range(4):
        evs = [e for e in _kernel_events(_profiled(run)[0], _FLUSH["names"])
               if match is None or match in e.name]
        counts = {}
        for e in evs:
            counts[e.name] = counts.get(e.name, 0) + 1
        kept = evs or kept
        if evs and all(c % reps == 0 for c in counts.values()):
            break
        print("  (profile %d of a timing recorded %s kernels for %d calls; "
              "taken again)" % (attempt + 1, sorted(counts.values()), reps))
    if not kept:
        raise RuntimeError("torch.profiler recorded no CUDA kernel of the "
                           "timed call")
    return sum(e.time_range.elapsed_us() for e in kept) / reps / 1e3


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


def issue_rate():
    """Thread instructions the card can issue per second: per SM, 4
    schedulers of 32 lanes, one warp instruction a clock each, at the SM's
    highest clock (nvidia-smi clocks.max.sm)."""
    import torch

    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * 128 * mhz * 1e6


def instruction_floor_ms(counts, evaluations, rate):
    """The least time for ``evaluations`` points at ``counts`` = (SASS
    instructions, float64 ones) per point: the issue rate, or for float64
    the FP64 pipes, which take a warp instruction every second clock."""
    n, nd = counts
    return max(n, 2 * nd) * evaluations / rate * 1e3


def body_op_count(src):
    """Statements in a generated eval body: one op each, per point."""
    start = src.index("sdf_point(")
    body = src[start: src.index("\n}", start)]
    return body.count("\n  const ")


def check(cond, what):
    if not cond:
        raise AssertionError(what)
    print("  ok: " + what, flush=True)


def special_volumes(dtype, device):
    """SPECIAL_CELLS as a batch of (2, 2, 2) volumes: (N, 2, 2, 2)."""
    import numpy as np
    import torch

    from sdf_torch.core.mc_tables import CORNER_OFFSETS

    vols = np.zeros((len(SPECIAL_CELLS), 2, 2, 2))
    for ci, (ox, oy, oz) in enumerate(CORNER_OFFSETS.tolist()):
        vols[:, ox, oy, oz] = [c[ci] for c in SPECIAL_CELLS]
    return torch.as_tensor(vols, dtype=dtype, device=device)


def grid_axes(f, samples, dtype, bounds=None):
    """The grid generate() builds (bounds, then np.arange per axis)."""
    import numpy as np

    from sdf_torch.core import engine

    (x0, y0, z0), (x1, y1, z1) = bounds or engine._estimate_bounds(f, dtype)
    step = ((x1 - x0) * (y1 - y0) * (z1 - z0) / samples) ** (1 / 3)
    return [np.arange(a, b, step) for a, b in ((x0, x1), (y0, y1), (z0, z1))]


def kept_tiles(f, axes, tile, dtype, device, pad=True):
    """The tile list the tiled path builds: the tiles the host probe cull
    keeps, x-major, padded with tile 0 to round_capacity; returns ``(tiles
    (ntc, 3) int32 tensor, live count)``."""
    import numpy as np
    import torch

    from sdf_torch.core import engine, mc

    active = np.argwhere(~engine._skip_mask(f, *axes, tile, dtype))
    tiles = np.zeros((mc.round_capacity(len(active)) if pad else len(active),
                      3), np.int32)
    tiles[:len(active)] = active
    return torch.as_tensor(tiles, device=device), len(active)


def check_tile_order(verts, faces, axes, tile):
    """Triangles of a tiles run come in (tile, cell) order and no vertex is
    shared between tiles: the tile of each triangle (from its centroid in
    index coordinates) never decreases along the faces, and every vertex
    is used by triangles of one tile only."""
    import numpy as np

    step = np.array([a[1] - a[0] for a in axes])
    origin = np.array([a[0] for a in axes])
    centroid = (verts[faces].mean(axis=1) - origin) / step
    t3 = np.floor(centroid).astype(np.int64) // tile
    nt = [-(-len(a) // tile) for a in axes]
    tid = (t3[:, 0] * nt[1] + t3[:, 1]) * nt[2] + t3[:, 2]
    check(bool(np.all(np.diff(tid) >= 0)),
          "triangle order: the tile index never decreases along %d faces "
          "(%d tiles hold triangles)" % (len(faces), len(np.unique(tid))))
    lo = np.full(len(verts), np.iinfo(np.int64).max)
    hi = np.full(len(verts), -1)
    np.minimum.at(lo, faces.reshape(-1), np.repeat(tid, 3))
    np.maximum.at(hi, faces.reshape(-1), np.repeat(tid, 3))
    check(bool(np.all(lo == hi)) and bool(np.all(np.diff(lo) >= 0)),
          "every vertex belongs to one tile, and vertices are in tile order")


PROBE = r"""
extern "C" __global__ void sdf_probe_f32(
    const float* __restrict__ in, float* __restrict__ out,
    const __grid_constant__ Params<float> P) {
  const Fields<float> none = {};
  out[0] = sdf_point<float>(in[0], in[1], in[2], P, none, 0);
}
extern "C" __global__ void sdf_probe_f64(
    const double* __restrict__ in, double* __restrict__ out,
    const __grid_constant__ Params<double> P) {
  const Fields<double> none = {};
  out[0] = sdf_point<double>(in[0], in[1], in[2], P, none, 0);
}
"""


def _cubin_flags():
    from sdf_torch import _build

    return [f for f in _build.FLAGS if f not in ("-shared", "-Xcompiler",
                                                  "-fPIC")]


def start_probe(f, tmp):
    """Start compiling a one-point probe kernel of ``f``'s per-point body
    (the source of kernel B1 with two entry points appended) to a cubin in
    directory ``tmp``; returns the nvcc process and the cubin's path."""
    from sdf_torch import _build
    from sdf_torch.core import eval_classify

    cu = os.path.join(tmp, "probe.cu")
    with open(cu, "w") as fp:
        fp.write(eval_classify.kernel_source(f) + PROBE)
    cubin = os.path.join(tmp, "probe.cubin")
    proc = subprocess.Popen(
        [_build.nvcc(), *_cubin_flags(), "-cubin", "-o", cubin, cu],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, cubin


def probe_instructions(proc, cubin):
    """SASS instructions per point of a probe from ``start_probe``, per
    dtype, with the float64 arithmetic among them: the probe's instructions
    up to its first unpredicated EXIT.  That is the body's straight-line
    path (the slow paths of IEEE division and sqrt sit after the EXIT and
    run only on special operands) plus the probe's own few loads, store and
    setup."""
    from sdf_torch import _build

    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError("nvcc failed for the probe:\n" + out)
    tool = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", cubin], capture_output=True,
                          text=True, check=True).stdout
    counts = {}
    for part in sass.split("Function : ")[1:]:
        name = part.split()[0]
        n = nd = 0
        for ins in re.findall(r"/\*[0-9a-f]{4,}\*/\s+([^;]*);", part):
            n += 1
            words = ins.split()
            op = words[1] if words[0].startswith("@") else words[0]
            nd += op.startswith(("DADD", "DMUL", "DFMA", "DSETP", "DMNMX"))
            if ins.strip() == "EXIT":
                break
        counts["float32" if name.endswith("f32") else "float64"] = (n, nd)
    return counts


PROBE_B2 = r"""
template <typename T>
__device__ __forceinline__ int32_t probe_cell(const T* in, int32_t cas,
                                              const int32_t* tab) {
  T c[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) c[i] = in[i] - in[8];
  return ext_combine(cas, extra_bits<T>(c), tab);
}
extern "C" __global__ void sdf_cell_probe_f32(
    const float* __restrict__ in, const int32_t* __restrict__ cas,
    const int32_t* __restrict__ tab, int32_t* __restrict__ out) {
  out[0] = probe_cell<float>(in, cas[0], tab);
}
extern "C" __global__ void sdf_cell_probe_f64(
    const double* __restrict__ in, const int32_t* __restrict__ cas,
    const int32_t* __restrict__ tab, int32_t* __restrict__ out) {
  out[0] = probe_cell<double>(in, cas[0], tab);
}
"""


def _entry_label(fn):
    """A readable name for a mangled entry function of B1-B7."""
    for key, label in (("classify_ext_kernelIf", "B2 classify_ext float"),
                       ("classify_ext_kernelId", "B2 classify_ext double"),
                       ("ext_from_bits", "B2 ext_from_bits (int32)"),
                       ("ntri_kernel", "B3 ntri (int32)")):
        if key in fn:
            return label
    dtype = "double" if re.search(r"kernelId", fn) else "float"
    if "eval_tiles" in fn:
        dtype += ", clamp" if "Lb1" in fn else ", fields"
    return dtype


def _print_ptxas(out):
    """Registers, stack and spills of each entry function in an ``nvcc
    -Xptxas -v`` log."""
    for fn, info in re.findall(
            r"Compiling entry function '(\w+)'.*?\n(.*?Used \d+ "
            r"registers[^\n]*)", out, re.S):
        stack = re.search(r"(\d+) bytes stack frame", info).group(1)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes "
                          r"spill loads", info)
        regs = re.search(r"Used (\d+) registers", info).group(1)
        print("  %-26s %s registers, stack %s B, spill stores %s B, "
              "loads %s B" % (_entry_label(fn), regs, stack, spill.group(1),
                              spill.group(2)))


def ptxas_report():
    """Registers, stack and spill bytes of every entry kernel of B1 and of
    B6/B7, for a narrow and three wide expression trees, and of B2 and B3,
    from ``nvcc -Xptxas -v``; the SASS instructions per point of the
    example's and blobby's bodies and per cell of B2's body
    (``probe_instructions``) and, with a card, the instruction floors of B1
    and B2 on their main-path shapes."""
    import tempfile

    import numpy as np
    import torch

    import sdf_torch as sp
    from sdf_torch import _build
    from sdf_torch.core import eval_classify, mc33
    from sdf_torch.models import zoo

    models = {"example": example(sp), "blobby": zoo.blobby(),
              "knurling": zoo.knurling(), "weave": zoo.weave()}
    with tempfile.TemporaryDirectory() as tmp:
        jobs = {}
        for name, f in models.items():
            for kind, src in (("B1", eval_classify.kernel_source(f)),
                              ("B6/B7", eval_classify.tile_kernel_source(f))):
                cu = os.path.join(tmp, "%s_%s.cu" % (name, kind[:2]))
                with open(cu, "w") as fp:
                    fp.write(src)
                jobs[name, kind] = (body_op_count(src), subprocess.Popen(
                    [_build.nvcc(), *_cubin_flags(), "-Xptxas", "-v", "-cubin",
                     "-o", cu + "bin", cu], stdout=subprocess.PIPE,
                    stderr=subprocess.STDOUT, text=True))
        b23 = {}
        for stem, src in (("classify_ext", mc33.kernel_source()),
                          ("ntri", _build.source("ntri.cu"))):
            cu = os.path.join(tmp, stem + ".cu")
            with open(cu, "w") as fp:
                fp.write(src)
            b23[stem] = subprocess.Popen(
                [_build.nvcc(), *_cubin_flags(), "-Xptxas", "-v", "-cubin",
                 "-o", cu + "bin", cu], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)
        probes = {}
        for name in ("example", "blobby"):
            os.mkdir(os.path.join(tmp, name))
            probes[name] = start_probe(models[name], os.path.join(tmp, name))
        cu = os.path.join(tmp, "cell_probe.cu")
        with open(cu, "w") as fp:
            fp.write(_build.source("mc33_cell.cuh") + PROBE_B2)
        b2_probe = (subprocess.Popen(
            [_build.nvcc(), *_cubin_flags(), "-cubin", "-o",
             cu + "bin", cu], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), cu + "bin")
        for (name, kind), (ops, proc) in jobs.items():
            out, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError("nvcc failed:\n" + out)
            print("%s %s (%d ops/point):" % (name, kind, ops))
            _print_ptxas(out)
        for proc in b23.values():
            out, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError("nvcc failed:\n" + out)
            _print_ptxas(out)
        sass = {name: probe_instructions(*job) for name, job in probes.items()}
        sass_b2 = probe_instructions(*b2_probe)
    rate = issue_rate() if torch.cuda.is_available() else None
    if rate:
        print("issue rate %.4g instructions/s" % rate)
    for name, samples in (("example", 2**22), ("blobby", 2**26)):
        print("%s: SASS instructions per point (total, float64 arithmetic) %s"
              % (name, json.dumps(sass[name])))
        shape = [len(a) for a in grid_axes(models[name], samples,
                                           torch.float32)]
        evals = eval_classify.slab_evaluations(*shape)
        for dt, counts in sass[name].items():
            floor = ("%.4f ms" % instruction_floor_ms(counts, evals, rate)
                     if rate else "not measured (no card)")
            print("  B1 %s on the %s grid: %d evaluations (%.4f a sample), "
                  "instruction floor %s" % (dt, "x".join(map(str, shape)),
                                            evals, evals / np.prod(shape),
                                            floor))
    # B2 on the grids of the example (2^22) and blobby (2^26), and on the
    # routed run's 512 tile volumes of 32^3 cells.
    print("B2 classify_ext: SASS instructions per cell (total, float64 "
          "arithmetic) %s" % json.dumps(sass_b2))
    for what, cells in (
            ("the example's %s grid" % "x".join(
                str(len(a)) for a in grid_axes(models["example"], 2**22,
                                               torch.float32)),
             np.prod([len(a) - 1 for a in grid_axes(
                 models["example"], 2**22, torch.float32)])),
            ("blobby's %s grid" % "x".join(
                str(len(a)) for a in grid_axes(models["blobby"], 2**26,
                                               torch.float32)),
             np.prod([len(a) - 1 for a in grid_axes(
                 models["blobby"], 2**26, torch.float32)])),
            ("512 tile volumes of 33^3 samples", 512 * 32**3)):
        for dt, counts in sass_b2.items():
            floor = ("%.4f ms" % instruction_floor_ms(counts, cells, rate)
                     if rate else "not measured (no card)")
            print("  B2 %s on %s: %d cells, instruction floor %s"
                  % (dt, what, cells, floor))
    return 0


def slab_sweep(dev):
    """Kernel B1 with its slab length forced to each of a range of values,
    on the example's 2**22 grid and blobby's 2**26 grid in both dtypes: one
    JSON line each with the device ms, the blocks and the evaluations a
    sample, each output held bit-equal to that of the default plan.  Then
    kernel B2 (``b2_sweep``) on B1's volumes and on blobby's 512 tile
    volumes, in both dtypes."""
    import numpy as np
    import torch

    import sdf_torch as sp
    from sdf_torch import _build
    from sdf_torch.core import eval_classify, mc33
    from sdf_torch.models import zoo

    print(card_line())
    models = {"example": (example(sp), 2**22), "blobby": (zoo.blobby(), 2**26)}
    _build.build_many([("eval_classify", eval_classify.kernel_source(g))
                       for g, _ in models.values()]
                      + [("eval_tiles", eval_classify.tile_kernel_source(
                          models["blobby"][0])),
                         ("classify_ext", mc33.kernel_source())])
    for name, (g, samples) in models.items():
        axes = grid_axes(g, samples, torch.float32)
        shape = tuple(len(a) for a in axes)
        for dt in (torch.float32, torch.float64):
            ints = torch.int32 if dt == torch.float32 else torch.int64
            vol, cas = eval_classify.eval_and_classify(g, *axes, dt, dev)
            for lx in (4, 8, 12, 16, 24, 32, 48, 64, 96, 128):
                run = lambda: eval_classify._launch(g, *axes, dt, dev, lx)
                vk, ck = run()
                if not (torch.equal(vk.view(ints), vol.view(ints))
                        and torch.equal(ck, cas)):
                    raise AssertionError("B1 with slabs of %d planes differs "
                                         "from the default plan" % lx)
                del vk, ck
                print(json.dumps(dict(
                    model=name, shape=shape, dtype=str(dt).split(".")[1],
                    lx=lx, default=lx == eval_classify.SLAB,
                    blocks=int(np.prod(eval_classify.slab_plan(*shape, lx))),
                    evaluations_per_sample=eval_classify.slab_evaluations(
                        *shape, lx) / np.prod(shape),
                    ms=device_ms(run, reps=10, warm=2))), flush=True)
            b2_sweep(name, vol, cas, dev)
            del vol, cas
    # B2 on the routed run's tile volumes (blobby's kept tiles, from B6).
    g = models["blobby"][0]
    axes = grid_axes(g, 2**26, torch.float32)
    tiles, _ = kept_tiles(g, axes, 32, torch.float32, dev)
    for dt in (torch.float32, torch.float64):
        vols, case = eval_classify.eval_tiles_and_classify_batched(
            g, *axes, tiles, 32, dt)
        b2_sweep("blobby tiles", vols, case, dev)
        del vols, case
    return 0


def b2_sweep(name, vol, cas, dev):
    """Kernel B2 on ``vol`` (with ``cas`` as its base cases) under forced
    slab lengths: one JSON line each, every output held bit-equal to the
    default plan's."""
    import torch

    from sdf_torch.core import mc33

    nx, ny, nz = vol.shape[-3:]
    nb = vol.numel() // (nx * ny * nz)
    want = mc33.classify_ext(vol, base_case=cas)
    for lx in (4, 8, 16, 32, 64):
        run = lambda: mc33._launch(vol, 0.0, cas, lx)
        if not torch.equal(run(), want):
            raise AssertionError("B2 with slabs of %d planes differs from "
                                 "the default plan" % lx)
        print(json.dumps(dict(
            kernel="classify_ext", model=name, shape=tuple(vol.shape),
            dtype=str(vol.dtype).split(".")[1], lx=lx,
            blocks=mc33.ext_plan(nb, nx, ny, nz, lx)[4],
            default=lx == mc33.EXT_SLAB,
            ms=device_ms(run, reps=10, warm=2))), flush=True)


def main():
    import numpy as np
    import torch

    if "--ptxas" in sys.argv[1:]:
        return ptxas_report()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        import sdf_torch as sp
        from sdf_torch import _build
        from sdf_torch.core import (compact, engine, eval_classify, hybrid, mc,
                                    mc33, sparse)
        from sdf_torch.models import zoo
    except ImportError as e:
        print("chip_smoke: the sdf_torch package is missing: %s" % e,
              file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    if "--slab-sweep" in sys.argv[1:]:
        return slab_sweep(dev)
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
    blobby = zoo.blobby()
    gathers = gather_models(sp)
    gather_nf = {"rotated": 1, "circular": 2}
    field_models = {"table, rotated": (gathers["rotated"], 1),
                    "table, circular": (gathers["circular"], 2),
                    "polygon": (polygon_model(sp), 1),
                    "polygon x4": (polygon4_model(sp), 4)}
    t0 = time.time()
    libs = _build.build_many([
        ("eval_classify", eval_classify.kernel_source(f)),
        ("eval_classify", eval_classify.kernel_source(zoo.saddle())),
        ("eval_classify", eval_classify.kernel_source(blobby)),
        ("eval_classify", eval_classify.kernel_source(plane_ops_model(sp))),
    ] + [
        ("eval_classify", eval_classify.kernel_source(
            hybrid.to_kernel_tree(g), nf)) for g, nf in field_models.values()
    ] + [
        ("eval_tiles", eval_classify.tile_kernel_source(
            hybrid.to_kernel_tree(polygon_model(sp)), 1)),
        ("eval_tiles", eval_classify.tile_kernel_source(f)),
        ("eval_tiles", eval_classify.tile_kernel_source(blobby)),
    ] + [
        ("eval_tiles", eval_classify.tile_kernel_source(
            hybrid.to_kernel_tree(g), gather_nf[k]))
        for k, g in gathers.items()
    ] + [
        ("ntri", _build.source("ntri.cu")),
        ("compact", _build.source("compact.cu")),
        ("classify_ext", mc33.kernel_source()),
    ])
    print("built %d libraries in %.1f s: %s" % (
        len(libs), time.time() - t0, ", ".join(p.name for p in libs)))

    # -- phase 3 ---------------------------------------------------------------
    print("== phase 3: kernels against their plain versions", flush=True)
    X, Y, Z = grid_axes(f, 2**22, torch.float32)
    npts = len(X) * len(Y) * len(Z)
    print("grid %d x %d x %d (%d points)" % (len(X), len(Y), len(Z), npts))

    def b1_plan(axes):
        """Kernel B1's launch plan on a grid, printed."""
        shape = tuple(len(a) for a in axes)
        grid = eval_classify.slab_plan(*shape)
        print("  B1 plan for %s: slabs of %d cell planes, %d blocks %s, %.4f "
              "evaluations a sample" % (
                  shape, eval_classify.SLAB, int(np.prod(grid)), grid,
                  eval_classify.slab_evaluations(*shape) / np.prod(shape)))

    def b2_plan(vol):
        """Kernel B2's launch plan on a volume, printed."""
        nx, ny, nz = vol.shape[-3:]
        nb = vol.numel() // (nx * ny * nz)
        nrb, nslab, _, _, blocks = mc33.ext_plan(nb, nx, ny, nz)
        print("  B2 plan for %s: %d row blocks of %d cells a plane, slabs of "
              "%d cell planes, %d blocks" % (
                  tuple(vol.shape), nrb, mc33._EXT_THREADS, mc33.EXT_SLAB,
                  blocks))

    def b2_interior_bits(ext, cas, what):
        """Cells of case 0 or 255 (no face ambiguous, all weights 0) whose
        ext carries interior bits: OFFSET[case] + ibits9 with ibits9 != 0.
        Why B2 cannot skip the cells that do not cross the surface."""
        off = mc33._offw(ext.device)[:256]
        flat = (cas == 0) | (cas == 255)
        ib = ext - off[cas.clamp(0, 255).long()]
        print("  B2 on %s: %d of %d cells have case 0 or 255; %d of those "
              "carry interior bits (ibits9 != 0)" % (
                  what, int(flat.sum()), cas.numel(),
                  int((flat & (ib != 0)).sum())))

    # B1 in both dtypes; the float32 numbers go into the kernels line.
    b1_plan((X, Y, Z))
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
              "ops/point) max_abs_err %g" % (name, ms, pms, b, by, ops_pt,
                                             err))
        if dt == torch.float32:
            kernels["eval_classify"] = dict(
                name="eval_classify", route="cuda",
                source="sdf_torch/csrc/eval_classify.cu",
                replaces="sdf_tpu/core/pallas_eval.py:53",
                max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=b, bound_by=by,
                library_ms=None,
            )
            case32, vol32 = ck, vk
        else:
            case64, vol64 = ck, vk

    # B2, the table-only kernel: the full 256 x 64 x 9 domain and a ragged
    # random tail with cases outside the table; then timed on the main
    # path's cell count.
    rng = np.random.default_rng(0)
    extras = np.asarray([fb | (ib << 6) for ib in range(9)
                         for fb in range(64)], np.int32)
    cdom = np.concatenate([np.repeat(np.arange(256), len(extras)),
                           rng.integers(-3, 260, 100003)]).astype(np.int32)
    edom = np.concatenate([np.tile(extras, 256),
                           rng.integers(0, 1024, 100003)]).astype(np.int32)
    cdom, edom = (torch.as_tensor(a, device=dev) for a in (cdom, edom))
    got, want = mc33.ext_from_bits(cdom, edom), mc33._ext_from_bits_plain(cdom, edom)
    check(torch.equal(got, want),
          "B2 ext_from_bits: 256 x 64 x 9 domain + random tail equal to plain")
    n = case32.numel()
    e32 = torch.as_tensor(rng.integers(0, 576, n).astype(np.int32),
                          device=dev).reshape(case32.shape)
    check(torch.equal(mc33.ext_from_bits(case32, e32),
                      mc33._ext_from_bits_plain(case32, e32)),
          "B2 ext_from_bits: main-path case grid equal to plain")
    ms = device_ms(lambda: mc33.ext_from_bits(case32, e32))
    pms = device_ms(lambda: mc33._ext_from_bits_plain(case32, e32), reps=5,
                    warm=1)
    b, by = bound_ms(12 * n)
    print("  B2 ext_from_bits (table only): %d cells kernel_ms %.4f plain_ms "
          "%.4f bound_ms %.4f (%s)" % (n, ms, pms, b, by))
    del cdom, edom, e32

    # B2, the fused kernel, in both dtypes: the main-path volume with kernel
    # B1's case grid, a random-normal volume (cases derived), the degenerate
    # and tie cells as a batch.  The float32 numbers go into the kernels line.
    for dt, vol, cas in ((torch.float32, vol32, case32),
                         (torch.float64, vol64, case64)):
        name = str(dt).split(".")[1]
        ek = mc33.classify_ext(vol, base_case=cas)
        ep = mc33._classify_ext_plain(vol, base_case=cas)
        check(torch.equal(ek, ep),
              "B2 classify_ext %s: main-path volume bit-equal to plain" % name)
        err = max_abs_diff([(ek, ep)])
        if dt == torch.float32:
            b2_plan(vol)
            b2_interior_bits(ek, cas, "the example's grid")
        rnd = torch.as_tensor(
            np.random.default_rng(11).standard_normal(tuple(vol.shape)),
            dtype=dt, device=dev)
        for level in (0.0, 0.125):
            gk, gp = (mc33.classify_ext(rnd, level),
                      mc33._classify_ext_plain(rnd, level))
            check(torch.equal(gk, gp), "B2 classify_ext %s: random-normal "
                  "volume at level %g bit-equal to plain" % (name, level))
            err = max(err, max_abs_diff([(gk, gp)]))
        # The same work on a random-normal volume, whose trilinear
        # coefficients are of order one: beside the example's time, what its
        # nearly linear cells cost (coefficients near zero, where an IEEE
        # division or square root can leave its fast path).
        rc = mc._cell_cases(rnd)
        print("  B2 classify_ext %s on the random-normal volume: kernel_ms "
              "%.4f" % (name, device_ms(lambda: mc33.classify_ext(
                  rnd, base_case=rc))))
        del rnd, gk, gp, rc
        sv = special_volumes(dt, dev)
        gk, gp = mc33.classify_ext(sv), mc33._classify_ext_plain(sv)
        check(torch.equal(gk, gp) and torch.equal(
            gk.cpu(), mc33.classify_ext(sv.cpu())),
            "B2 classify_ext %s: %d degenerate and tie cells bit-equal to "
            "plain, on the card and on the CPU" % (name, len(SPECIAL_CELLS)))
        ms = device_ms(lambda: mc33.classify_ext(vol, base_case=cas))
        pms = device_ms(lambda: mc33._classify_ext_plain(vol, base_case=cas),
                        reps=3, warm=1)
        ncell = cas.numel()
        nbytes = vol.numel() * vol.element_size() + 8 * ncell
        b, by = bound_ms(nbytes, CLASSIFY_EXT_OPS_PER_CELL * ncell, name)
        print("  B2 classify_ext %s: %d cells kernel_ms %.4f plain_ms %.4f "
              "bound_ms %.4f (%s; %d ops/cell) max_abs_err %g"
              % (name, ncell, ms, pms, b, by, CLASSIFY_EXT_OPS_PER_CELL, err))
        if dt == torch.float32:
            kernels["classify_ext"] = dict(
                name="classify_ext", route="cuda",
                source="sdf_torch/csrc/classify_ext.cu",
                replaces="sdf_tpu/core/mc33.py:180", max_abs_err=err, ms=ms,
                plain_ms=pms, bound_ms=b, bound_by=by, library_ms=None,
            )
            ext32 = ek
    del vol64, case64, ek, ep

    # B3 with both tables: all codes + random codes (some outside the
    # table), then the main path's grid: the 8-bit cases for the 256-entry
    # table, kernel B2's extended codes for the 5,904-entry one.
    for variant, grid in (("fast", case32), ("lewiner", ext32)):
        table = mc.get_tables(variant).on(dev, "ntri")
        nt = table.numel()
        codes = torch.as_tensor(np.concatenate(
            [np.arange(nt), rng.integers(0, nt, 100003), [nt, -1]]
        ).astype(np.int32), device=dev)
        got, want = mc.ntri_of(codes, variant), mc._ntri_plain(codes, table)
        check(torch.equal(got, want),
              "B3 ntri (%d entries): all codes + random codes equal to plain"
              % nt)
        err = max_abs_diff([(got, want)])
        got, want = mc.ntri_of(grid, variant), mc._ntri_plain(grid, table)
        check(torch.equal(got, want),
              "B3 ntri (%d entries): main-path grid equal to plain" % nt)
        err = max(err, max_abs_diff([(got, want)]))
        flat = grid.reshape(-1)
        for off in (1, 2, 3):
            view = flat[off:]
            got, want = mc.ntri_of(view, variant), mc._ntri_plain(view, table)
            check(torch.equal(got, want) and torch.equal(
                mc.ntri_of(codes[off:], variant),
                mc._ntri_plain(codes[off:], table)),
                "B3 ntri (%d entries): views at int32 offset %d (address %% "
                "16 = %d) equal to plain" % (nt, off, view.data_ptr() % 16))
            err = max(err, max_abs_diff([(got, want)]))
        n = grid.numel()
        ms = device_ms(lambda: mc.ntri_of(grid, variant))
        pms = device_ms(lambda: mc._ntri_plain(grid, table))
        lms = device_ms(lambda: torch.index_select(table, 0, grid.reshape(-1)))
        b, by = bound_ms(8 * n)
        print("  B3 ntri (%d entries): %d cells kernel_ms %.4f plain_ms %.4f "
              "library_ms %.4f bound_ms %.4f (%s) max_abs_err %g"
              % (nt, n, ms, pms, lms, b, by, err))
        if variant == "lewiner":  # the default path's table
            kernels["ntri"] = dict(
                name="ntri", route="cuda", source="sdf_torch/csrc/ntri.cu",
                replaces="sdf_tpu/core/mc.py:155", max_abs_err=err, ms=ms,
                plain_ms=pms, bound_ms=b, bound_by=by, library_ms=lms,
            )
    del ext32

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
    # B4 on a view of the main-path mask that starts off a 16-byte
    # boundary, with capacity above and below its count.
    view = aflat[5:]
    for cap in (int(view.sum()) + 11, int(view.sum()) // 2):
        ik, tk = compact.indices_of(view, cap)
        ip, tp = compact._indices_of_plain(view, cap)
        check(torch.equal(ik, ip) and int(tk) == int(tp),
              "B4 indices_of on a view at address %% 16 = %d, capacity %d"
              % (view.data_ptr() % 16, cap))
    # B5 (one pass) at the edge shapes: lengths not a multiple of 32, every
    # slot set, capacity below the count, an empty mask, and views of the
    # main-path edge mask off a 16-byte boundary with ragged ends.
    def b5_equal(m, cap):
        got = compact.indices_and_ranktable_of(m, cap)
        want = compact._ranktable_plain(m, cap)
        return all(torch.equal(g, w) for g, w in zip(got, want))

    for n, dens in ((1, 1.0), (31, 0.5), (33, 1.0), (1000, 1.0),
                    (70001, 0.5), (2**20 + 7, 1e-3)):
        m = torch.as_tensor(np.random.default_rng(n).random(n) < dens,
                            device=dev)
        cnt = int(m.sum())
        check(b5_equal(m, cnt + 9) and b5_equal(m, max(1, cnt // 2)),
              "B5 indices_and_ranktable_of: %d slots, density %g, capacity "
              "above and below the count, equal to plain" % (n, dens))
    check(b5_equal(torch.zeros(0, dtype=torch.bool, device=dev), 4),
          "B5 on an empty mask equal to plain")
    eflat = emask.reshape(-1)
    for start, trim in ((1, 0), (5, 7), (15, 31)):
        view = eflat[start: eflat.numel() - trim]
        cnt = int(view.sum())
        check(b5_equal(view, cnt + 3) and b5_equal(view, cnt // 3),
              "B5 on a view of the edge mask at address %% 16 = %d, %d "
              "slots, equal to plain" % (view.data_ptr() % 16, view.numel()))
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
            # the mask, 4 bytes an output slot, 8 a 32-slot group
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
        if what == "B4":
            print("  B4 indices_of: of that, the memset of its look-back "
                  "scratch %.4f ms" % device_ms(run, match="Memset"))
        kernels[key] = dict(
            name=key, route="cuda", source="sdf_torch/csrc/compact.cu",
            replaces=("sdf_tpu/core/compact.py:118" if what == "B4"
                      else "sdf_tpu/core/compact.py:214"),
            max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=b, bound_by=by,
            library_ms=lms,
        )
    del vol32, case32, active, emask, aflat

    # B6 and B7 against their plain version (_eval_tiles + _cell_cases), bit
    # for bit, on the tile lists the tiled path builds.  B7 takes the axes
    # padded by one tile; without fields it must equal B6.
    b6 = eval_classify.eval_tiles_and_classify_batched
    b7 = eval_classify.eval_tiles_and_classify
    padded = lambda axes, tile: [
        np.concatenate([a, np.full(tile, a[-1])]) for a in axes]

    def same_bits(a, b):
        ints = torch.int32 if a.dtype == torch.float32 else torch.int64
        return torch.equal(a.view(ints), b.view(ints))

    def tiles_bound(vols, nf, ops_pt, name):
        ntc, TS = vols.shape[0], vols.shape[1]
        nbytes = vols.numel() * vols.element_size() * (1 + nf) \
            + ntc * (TS - 1) ** 3 * 4 + ntc * 12
        return bound_ms(nbytes, ops_pt * vols.numel()
                        + 16 * ntc * (TS - 1) ** 3, name)

    def hold_tile_shapes(vols, case, tiles, nt, axes, tile, name, keep):
        """Kernels B2 to B5 on what the tiled path gives them for these tile
        volumes (kernel B6's outputs): each against its plain version, with
        its times; the numbers go under ``keep`` into the kernels line."""
        ntc = len(tiles)
        cshape = tuple(len(a) - 1 for a in axes)
        live = torch.arange(ntc, device=dev) < nt
        rows = {}
        ek = mc33.classify_ext(vols, base_case=case)
        ep = mc33._classify_ext_plain(vols, base_case=case)
        check(torch.equal(ek, ep), "B2 classify_ext %s on %s tile volumes "
              "with B6's cases: bit-equal to plain" % (name, tuple(vols.shape)))
        if keep:
            b2_plan(vols)
        ncell = case.numel()
        rows["classify_ext"] = (
            max_abs_diff([(ek, ep)]),
            device_ms(lambda: mc33.classify_ext(vols, base_case=case)),
            device_ms(lambda: mc33._classify_ext_plain(vols, base_case=case),
                      reps=3, warm=1),
            bound_ms(vols.numel() * vols.element_size() + 8 * ncell,
                     CLASSIFY_EXT_OPS_PER_CELL * ncell, name), None, ncell)
        del ep
        table = mc.get_tables("lewiner").on(dev, "ntri")
        got, want = mc.ntri_of(ek, "lewiner"), mc._ntri_plain(ek, table)
        check(torch.equal(got, want), "B3 ntri on the %s tile case grid "
              "equal to plain" % (tuple(ek.shape),))
        rows["ntri"] = (
            max_abs_diff([(got, want)]),
            device_ms(lambda: mc.ntri_of(ek, "lewiner")),
            device_ms(lambda: mc._ntri_plain(ek, table)),
            bound_ms(8 * ncell),
            device_ms(lambda: torch.index_select(table, 0, ek.reshape(-1))),
            ncell)
        _, _, n_cells, _, n_edges, emask = sparse._count_tiles(
            vols, tiles, live, cshape, tile, ek, "lewiner")
        valid = sparse._cell_valid(tiles, live, cshape, tile)
        cells = ((got * valid) > 0).reshape(-1)
        del got, want, valid, ek
        check(int(cells.sum()) == int(n_cells), "the tile-cell mask holds "
              "the %d cells _count_tiles counted" % int(n_cells))
        cap = mc.round_capacity(int(n_cells))
        got, want = (compact.indices_of(cells, cap),
                     compact._indices_of_plain(cells, cap))
        check(all(torch.equal(g, w) for g, w in zip(got, want)),
              "B4 indices_of on the %d tile-cell slots (%d set) equal to "
              "plain" % (cells.numel(), int(n_cells)))
        rows["indices_of"] = (
            max_abs_diff(list(zip(got, want))),
            device_ms(lambda: compact.indices_of(cells, cap)),
            device_ms(lambda: compact._indices_of_plain(cells, cap), reps=5,
                      warm=1),
            bound_ms(cells.numel() + 4 * cap),
            device_ms(lambda: torch.nonzero(cells)), cells.numel())
        print("  B4 on the tiles, %s: the memset of its look-back scratch "
              "%.4f ms" % (name, device_ms(lambda: compact.indices_of(
                  cells, cap), match="Memset")))
        m = emask.reshape(-1)
        ecap = mc.round_capacity(int(n_edges))
        got, want = (compact.indices_and_ranktable_of(m, ecap),
                     compact._ranktable_plain(m, ecap))
        check(all(torch.equal(g, w) for g, w in zip(got, want)),
              "B5 indices_and_ranktable_of on the %d per-tile [x|y|z] edge "
              "slots (%d set) equal to plain" % (m.numel(), int(n_edges)))
        rows["indices_and_ranktable_of"] = (
            max_abs_diff(list(zip(got, want))),
            device_ms(lambda: compact.indices_and_ranktable_of(m, ecap)),
            device_ms(lambda: compact._ranktable_plain(m, ecap), reps=5,
                      warm=1),
            bound_ms(m.numel() + 4 * ecap + 8 * (-(-m.numel() // 32))),
            None, m.numel())
        for k, (err, ms, pms, (b, by), lms, size) in rows.items():
            print("  %s on the tiles, %s: %d slots kernel_ms %.4f plain_ms "
                  "%.4f library_ms %s bound_ms %.4f (%s) max_abs_err %g"
                  % (k, name, size, ms, pms,
                     "%.4f" % lms if lms else "null", b, by, err))
            if keep:
                kernels[k]["tiles_path"] = dict(
                    slots=size, max_abs_err=err, ms=ms, plain_ms=pms,
                    bound_ms=b, bound_by=by, library_ms=lms)

    tile_cases = [
        ("blobby 2^26", blobby, 2**26, 32, None, True),
        ("example 2^22", f, 2**22, 32, None, True),
        ("example 2^22", f, 2**22, 8, None, True),
        ("example 2^22, a list of one", f, 2**22, 32, 1, False),
    ]
    for label, g, samples, tile, first, pad in tile_cases:
        axes = grid_axes(g, samples, torch.float32)
        tiles, nt = kept_tiles(g, axes, tile, torch.float32, dev, pad)
        if first:
            tiles, nt = tiles[nt - first: nt].contiguous(), first
        ops_pt = body_op_count(eval_classify.tile_kernel_source(g))
        for dt in (torch.float32, torch.float64):
            name = str(dt).split(".")[1]
            vk, ck = b6(g, *axes, tiles, tile, dt)
            v7, c7 = b7(g, *padded(axes, tile), tiles, tile, dt)
            vp = eval_classify._eval_tiles(g, *axes, tiles, tile, dt)
            cp = mc._cell_cases(vp)
            check(same_bits(vk, vp) and torch.equal(ck, cp),
                  "B6 %s tile %d %s: %d tiles (%d live) vols and cases "
                  "bit-equal to plain" % (label, tile, name, len(tiles), nt))
            check(same_bits(v7, vk) and torch.equal(c7, ck),
                  "B7 without fields equal to B6 (%s tile %d %s)"
                  % (label, tile, name))
            if label != "blobby 2^26":
                continue
            err = max_abs_diff([(vk, vp), (ck, cp)])
            ms = device_ms(lambda: b6(g, *axes, tiles, tile, dt))
            ms7 = device_ms(lambda: b7(g, *padded(axes, tile), tiles, tile, dt))
            pms = device_ms(lambda: (
                mc._cell_cases(eval_classify._eval_tiles(
                    g, *axes, tiles, tile, dt))), reps=3, warm=1)
            b, by = tiles_bound(vk, 0, ops_pt, name)
            print("  B6 %s %s: %d tiles kernel_ms %.4f (B7 without fields "
                  "%.4f) plain_ms %.4f bound_ms %.4f (%s; %d ops/point) "
                  "max_abs_err %g" % (label, name, len(tiles), ms, ms7, pms,
                                      b, by, ops_pt, err))
            hold_tile_shapes(vk, ck, tiles, nt, axes, tile, name,
                             dt == torch.float32)
            if dt == torch.float32:
                kernels["eval_tiles_batched"] = dict(
                    name="eval_tiles_batched", route="cuda",
                    source="sdf_torch/csrc/eval_tiles.cu",
                    replaces="sdf_tpu/core/pallas_eval.py:262",
                    max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=b,
                    bound_by=by, library_ms=None,
                )
        del vk, ck, v7, c7, vp, cp

    # The routed run's speculative dense pass gives B1, B2 and B3 blobby's
    # whole 2^26 grid, another expression and 16 times the cells of the
    # example's grid above: held against plain there too (float32, the
    # default; B1 in float64 too).
    axes = grid_axes(blobby, 2**26, torch.float32)
    b1_plan(axes)
    vk, ck = eval_classify.eval_and_classify(blobby, *axes, torch.float32, dev)
    vp, cp = eval_classify._eval_classify_plain(blobby, *axes, torch.float32,
                                                dev)
    check(same_bits(vk, vp) and torch.equal(ck, cp),
          "B1 eval_classify on blobby's %s grid: vol and case bit-equal to "
          "plain" % (tuple(vk.shape),))
    err1 = max_abs_diff([(vk, vp), (ck, cp)])
    del vp, cp
    ek = mc33.classify_ext(vk, base_case=ck)
    ep = mc33._classify_ext_plain(vk, base_case=ck)
    check(torch.equal(ek, ep), "B2 classify_ext on that volume bit-equal to "
          "plain")
    err2 = max_abs_diff([(ek, ep)])
    b2_plan(vk)
    b2_interior_bits(ek, ck, "blobby's 2^26 grid")
    del ep
    table = mc.get_tables("lewiner").on(dev, "ntri")
    got, want = mc.ntri_of(ek, "lewiner"), mc._ntri_plain(ek, table)
    check(torch.equal(got, want), "B3 ntri on that case grid equal to plain")
    err3 = max_abs_diff([(got, want)])
    del got, want
    ncell, npts26 = ck.numel(), vk.numel()
    ops_pt = body_op_count(eval_classify.kernel_source(blobby))
    dense_rows = {
        "eval_classify": (
            err1,
            device_ms(lambda: eval_classify.eval_and_classify(
                blobby, *axes, torch.float32, dev), reps=5, warm=1),
            device_ms(lambda: eval_classify._eval_classify_plain(
                blobby, *axes, torch.float32, dev), reps=2, warm=1),
            bound_ms(4 * npts26 + 4 * ncell, ops_pt * npts26 + 16 * ncell),
            None),
        "classify_ext": (
            err2,
            device_ms(lambda: mc33.classify_ext(vk, base_case=ck), reps=5,
                      warm=1),
            device_ms(lambda: mc33._classify_ext_plain(vk, base_case=ck),
                      reps=2, warm=1),
            bound_ms(4 * npts26 + 8 * ncell,
                     CLASSIFY_EXT_OPS_PER_CELL * ncell), None),
        "ntri": (
            err3,
            device_ms(lambda: mc.ntri_of(ek, "lewiner"), reps=5, warm=1),
            device_ms(lambda: mc._ntri_plain(ek, table), reps=5, warm=1),
            bound_ms(8 * ncell),
            device_ms(lambda: torch.index_select(table, 0, ek.reshape(-1)),
                      reps=5, warm=1)),
    }
    for k, (err, ms, pms, (b, by), lms) in dense_rows.items():
        print("  %s on blobby's 2^26 grid (%d cells): kernel_ms %.4f plain_ms "
              "%.4f library_ms %s bound_ms %.4f (%s) max_abs_err %g"
              % (k, ncell, ms, pms, "%.4f" % lms if lms else "null", b, by,
                 err))
        kernels[k]["routed_dense_pass"] = dict(
            slots=ncell, max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=b,
            bound_by=by, library_ms=lms)
    del vk, ck, ek
    vk, ck = eval_classify.eval_and_classify(blobby, *axes, torch.float64, dev)
    vp, cp = eval_classify._eval_classify_plain(blobby, *axes, torch.float64,
                                                dev)
    check(same_bits(vk, vp) and torch.equal(ck, cp),
          "B1 eval_classify float64 on blobby's %s grid: vol and case "
          "bit-equal to plain" % (tuple(vk.shape),))
    err = max_abs_diff([(vk, vp), (ck, cp)])
    del vp, cp
    # B2 in float64 on that volume (the routed run's dense pass is float32;
    # a float64 call at 2^26 gives B2 this shape).
    ek = mc33.classify_ext(vk, base_case=ck)
    check(torch.equal(ek, mc33._classify_ext_plain(vk, base_case=ck)),
          "B2 classify_ext float64 on that volume bit-equal to plain")
    del ek
    b, by = bound_ms(8 * npts26 + 8 * ncell, CLASSIFY_EXT_OPS_PER_CELL * ncell,
                     "float64")
    print("  B2 classify_ext float64 on blobby's 2^26 grid: kernel_ms %.4f "
          "bound_ms %.4f (%s)" % (device_ms(lambda: mc33.classify_ext(
              vk, base_case=ck), reps=5, warm=1), b, by))
    del vk, ck
    ms = device_ms(lambda: eval_classify.eval_and_classify(
        blobby, *axes, torch.float64, dev), reps=5, warm=1)
    pms = device_ms(lambda: eval_classify._eval_classify_plain(
        blobby, *axes, torch.float64, dev), reps=2, warm=1)
    b, by = bound_ms(8 * npts26 + 4 * ncell, ops_pt * npts26 + 16 * ncell,
                     "float64")
    print("  B1 on blobby's 2^26 grid float64: kernel_ms %.4f plain_ms %.4f "
          "bound_ms %.4f (%s) max_abs_err %g" % (ms, pms, b, by, err))

    # B7 with fields: the gather-marked table lookup, recorded at rotated
    # points (one field) and under circular_array (two fields), against the
    # plain version reading the same fields and against the expression
    # evaluated whole with torch ops.
    for gname, g in gathers.items():
        axes = grid_axes(g, 2**22, torch.float32, GATHER_BOUNDS)
        tiles, nt = kept_tiles(g, axes, 32, torch.float32, dev)
        pax = padded(axes, 32)
        tree = hybrid.to_kernel_tree(g)
        nf = gather_nf[gname]
        ops_pt = body_op_count(eval_classify.tile_kernel_source(tree, nf))
        for dt in (torch.float32, torch.float64):
            name = str(dt).split(".")[1]
            vk, ck = b7(g, *pax, tiles, 32, dt)
            fields = hybrid.record_tiles(
                g, *eval_classify._axes(*pax, dt, dev), tiles, 32)
            check(len(fields) == nf, "%s records %d field(s)" % (gname, nf))
            vp = eval_classify._eval_tiles(tree, *pax, tiles, 32, dt,
                                           clamp=False, fields=fields)
            whole = eval_classify._eval_tiles(g, *pax, tiles, 32, dt,
                                              clamp=False)
            cp = mc._cell_cases(vp)
            check(same_bits(vk, vp) and torch.equal(ck, cp)
                  and same_bits(vk, whole),
                  "B7 %s %s: %d tiles (%d live), %d field(s), bit-equal to "
                  "plain and to the whole expression"
                  % (gname, name, len(tiles), nt, nf))
            if gname != "rotated":
                continue
            err = max_abs_diff([(vk, vp), (ck, cp)])
            # ms is the wrapper the path calls: the torch pre-pass that
            # records the fields, then the kernel.  plain_ms is the same
            # function with torch ops only (the whole expression on the
            # tile windows, then the cases).  Beside them the pre-pass and
            # the kernel alone, launched on fields recorded once, with a
            # counter of its own.
            ms = device_ms(lambda: b7(g, *pax, tiles, 32, dt))
            pms = device_ms(lambda: mc._cell_cases(eval_classify._eval_tiles(
                g, *pax, tiles, 32, dt, clamp=False)), reps=3, warm=1)
            bare = types.SimpleNamespace(launches=0)
            kms = device_ms(lambda: eval_classify._launch_tiles(
                tree, *pax, tiles, 32, dt, False, fields, bare))
            rms = device_ms(lambda: hybrid.record_tiles(
                g, *eval_classify._axes(*pax, dt, dev), tiles, 32),
                reps=3, warm=1)
            b, by = tiles_bound(vk, 0, ops_pt, name)
            print("  B7 %s %s: %d tiles wrapper_ms %.4f (pre-pass %.4f + "
                  "kernel %.4f) plain_ms %.4f bound_ms %.4f (%s; %d "
                  "ops/point in the kernel body; the fields are the "
                  "wrapper's own, so the bound counts no field bytes) "
                  "max_abs_err %g" % (gname, name, len(tiles), ms, rms, kms,
                                      pms, b, by, ops_pt, err))
            if dt == torch.float32:
                kernels["eval_tiles"] = dict(
                    name="eval_tiles", route="cuda",
                    source="sdf_torch/csrc/eval_tiles.cu",
                    replaces="sdf_tpu/core/pallas_eval.py:163",
                    max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=b,
                    bound_by=by, library_ms=None, prepass_ms=rms,
                    kernel_only_ms=kms,
                )
        del vk, ck, vp, cp, whole, fields

    # B1 with field inputs on the example's grid: the fields of the
    # gather-bearing subtrees recorded over the whole grid (the pre-pass,
    # torch ops), then the kernel reading them at each sample's index.
    # Held bit-equal to the plain version reading the same fields.  ms is
    # the kernel alone, plain_ms its plain version, prepass_ms the
    # recording; the bound counts the field reads.
    X, Y, Z = grid_axes(f, 2**22, torch.float32)
    npts = len(X) * len(Y) * len(Z)
    for label, (g, nf) in field_models.items():
        tree = hybrid.to_kernel_tree(g)
        ops_pt = body_op_count(eval_classify.kernel_source(tree, nf))
        for dt in (torch.float32, torch.float64):
            name = str(dt).split(".")[1]
            fields = eval_classify.record_fields(g, X, Y, Z, dt, dev)
            check(len(fields) == nf, "%s records %d field(s)" % (label, nf))
            vk, ck = eval_classify.eval_and_classify(g, X, Y, Z, dt, dev,
                                                     fields)
            vp, cp = eval_classify._eval_classify_plain(tree, X, Y, Z, dt,
                                                        dev, fields)
            check(same_bits(vk, vp) and torch.equal(ck, cp),
                  "B1 with %d field(s), %s %s, on the %s grid: vol and case "
                  "bit-equal to plain" % (nf, label, name, tuple(vk.shape)))
            if not label.startswith("polygon"):
                continue
            err = max_abs_diff([(vk, vp), (ck, cp)])
            ms = device_ms(lambda: eval_classify.eval_and_classify(
                g, X, Y, Z, dt, dev, fields))
            pms = device_ms(lambda: eval_classify._eval_classify_plain(
                tree, X, Y, Z, dt, dev, fields), reps=5, warm=1)
            rms = device_ms(lambda: eval_classify.record_fields(
                g, X, Y, Z, dt, dev), reps=5, warm=1)
            ncell = ck.numel()
            nbytes = (1 + nf) * vk.numel() * vk.element_size() + ncell * 4 \
                + sum(len(a) for a in (X, Y, Z)) * vk.element_size()
            b, by = bound_ms(nbytes, ops_pt * npts + 16 * ncell, name)
            print("  B1 with %d field(s), %s %s: kernel_ms %.4f plain_ms %.4f "
                  "prepass_ms %.4f bound_ms %.4f (%s; %d ops/point) "
                  "max_abs_err %g" % (nf, label, name, ms, pms, rms, b, by,
                                      ops_pt, err))
            row = dict(max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=b,
                       bound_by=by, library_ms=None, prepass_ms=rms, nf=nf)
            if label == "polygon" and dt == torch.float32:
                kernels["eval_classify_fields"] = dict(
                    name="eval_classify_fields", route="cuda",
                    source="sdf_torch/csrc/eval_classify.cu",
                    replaces="sdf_tpu/core/pallas_eval.py:53", **row)
            elif dt == torch.float32:
                kernels["eval_classify_fields"]["nf4"] = row
        del vk, ck, vp, cp, fields
    # B1 on a gather-free model of 2D ops: every op of it recorded into the
    # generated body (hexagon, rounded_x, revolve, extrude_to, ...).
    g = plane_ops_model(sp)
    check(hybrid.count_gathers(g) == 0, "the 2D-op model has no gather")
    for dt in (torch.float32, torch.float64):
        vk, ck = eval_classify.eval_and_classify(g, X, Y, Z, dt, dev)
        vp, cp = eval_classify._eval_classify_plain(g, X, Y, Z, dt, dev)
        check(same_bits(vk, vp) and torch.equal(ck, cp),
              "B1 on the 2D-op model %s: vol and case bit-equal to plain"
              % str(dt).split(".")[1])
    del vk, ck, vp, cp

    wrappers = {
        "eval_classify": eval_classify.eval_and_classify,
        "classify_ext": mc33.classify_ext,
        "ntri": mc.ntri_of,
        "indices_of": compact.indices_of,
        "indices_and_ranktable_of": compact.indices_and_ranktable_of,
        "eval_tiles_batched": b6,
        "eval_tiles": b7,
    }
    dense_path = ["eval_classify", "classify_ext", "ntri", "indices_of",
                  "indices_and_ranktable_of"]
    fast_path = [k for k in dense_path if k != "classify_ext"]

    def drive(f=None, **kw):
        """One generate() with every launch count set to 0 just before and
        read just after."""
        f = example(sp) if f is None else f
        for w in wrappers.values():
            w.launches = 0
        pts = sp.generate(f, verbose=False, **kw)
        torch.cuda.synchronize()
        counts = {k: w.launches for k, w in wrappers.items()}
        return pts, counts

    def report_warm(label, make=lambda: example(sp), **kw):
        """Warm end-to-end times and one profiled run of generate(**kw)."""
        warm = []
        for _ in range(5):
            t0 = time.perf_counter()
            sp.generate(make(), verbose=False, **kw)
            warm.append(time.perf_counter() - t0)
        print("  %s warm end-to-end s: median %.4f min %.4f (5 runs)" % (
            label, statistics.median(warm), min(warm)))
        wall, busy, per = timeline(lambda: sp.generate(
            make(), verbose=False, **kw))
        print("  profiled warm run: wall %.2f ms, device busy %.3f ms "
              "(%.1f%%), idle %.1f%%" % (wall, busy, 100 * busy / wall,
                                         100 - 100 * busy / wall))
        print("  phases (s): %s" % json.dumps(dict(engine.LAST_STATS)))
        for k, v in sorted(per.items(), key=lambda kv: -kv[1])[:10]:
            print("    device %.4f ms  %s" % (v, k[:100]))
        # Where the host spends the call: the port's own functions by
        # cumulative time (cProfile slows the call; read the shares).
        prof = cProfile.Profile()
        prof.runcall(sp.generate, make(), verbose=False, **kw)
        rows = [(ct, nc, "%s:%s" % (os.path.basename(fn), name))
                for (fn, _, name), (_, nc, _, ct, _)
                in pstats.Stats(prof).stats.items() if "sdf_torch" in fn]
        for ct, nc, where in sorted(rows, reverse=True)[:14]:
            print("    host %.4f s cumulative, %d calls  %s" % (ct, nc, where))

    # -- phase 4 ---------------------------------------------------------------
    print("== phase 4: generate(samples=2**22, float32, mc_variant='fast') "
          "on the card", flush=True)
    pts, counts = drive(samples=2**22, mc_variant="fast")
    print("  launches: %s" % counts)
    for k in fast_path:
        check(counts[k] >= 1, "%s launched on the fast path (%d)"
              % (k, counts[k]))
    check(counts["classify_ext"] == 0, "classify_ext not on the fast path")
    check(len(pts) // 3 == TRIS_2P22,
          "%d triangles (want %d)" % (len(pts) // 3, TRIS_2P22))
    check(bool(np.isfinite(pts).all()) and pts.shape[1] == 3,
          "finite (3T, 3) vertices")
    check("mc33_conflicted_cells" not in engine.LAST_STATS,
          "no conflicted-cell count under fast")
    print("  phases of the first run (s): %s"
          % json.dumps(dict(engine.LAST_STATS)))
    t0 = time.time()
    cpu = sp.generate(example(sp), samples=2**22, verbose=False,
                      mc_variant="fast", device="cpu")
    print("  device='cpu' run: %.1f s" % (time.time() - t0))
    check(np.array_equal(pts, cpu), "soup bit-equal to the device='cpu' run")
    fast_soup = pts
    report_warm("fast", samples=2**22, mc_variant="fast")

    # -- phase 5 ---------------------------------------------------------------
    print("== phase 5: generate(samples=2**24, float64, mc_variant='fast') "
          "on the card", flush=True)
    t0 = time.perf_counter()
    pts, counts = drive(samples=2**24, dtype=torch.float64, mc_variant="fast")
    print("  %.2f s, launches: %s" % (time.perf_counter() - t0, counts))
    for k in fast_path:
        check(counts[k] >= 1, "%s launched at 2^24 (%d)" % (k, counts[k]))
    check(len(pts) // 3 == TRIS_2P24,
          "%d triangles (want %d)" % (len(pts) // 3, TRIS_2P24))
    h = soup_hash(pts)
    check(h == SOUP_2P24, "soup sha256 %s" % h)

    # -- phase 6 ---------------------------------------------------------------
    print("== phase 6: generate(samples=2**22) at its defaults (lewiner, "
          "float32) on the card", flush=True)
    engine._BOUNDS_MEMO.clear()
    engine._COUNTS_MEMO.clear()
    t0 = time.perf_counter()
    pts, counts = drive(samples=2**22)
    first_s = time.perf_counter() - t0
    first_stats = dict(engine.LAST_STATS)
    print("  launches: %s" % counts)
    for k in dense_path:
        c = counts[k]
        check(c >= 1, "%s launched on the default path (%d)" % (k, c))
        kernels[k]["launches"] = c
    check(len(pts) // 3 == TRIS_2P22,
          "%d triangles (want %d)" % (len(pts) // 3, TRIS_2P22))
    check(bool(np.isfinite(pts).all()) and pts.shape[1] == 3,
          "finite (3T, 3) vertices")
    check(first_stats.get("mc33_conflicted_cells") == 0,
          "mc33_conflicted_cells == 0")
    check(soup_hash(pts) == soup_hash(fast_soup),
          "canonical soup equal to the fast variant's on this model")
    t0 = time.perf_counter()
    again, counts2 = drive(samples=2**22)
    second_s = time.perf_counter() - t0
    check(np.array_equal(again, pts) and counts2 == counts,
          "second (memoized) call: bit-equal soup, same launches")
    print("  first call %.4f s (memos empty), second call %.4f s (bounds and "
          "counts memoized)" % (first_s, second_s))
    print("  phases of the first call (s): %s" % json.dumps(first_stats))
    print("  phases of the second call (s): %s"
          % json.dumps(dict(engine.LAST_STATS)))
    t0 = time.time()
    cpu = sp.generate(example(sp), samples=2**22, verbose=False, device="cpu")
    print("  device='cpu' run: %.1f s" % (time.time() - t0))
    check(np.array_equal(pts, cpu), "soup bit-equal to the device='cpu' run")
    del cpu, again, fast_soup
    report_warm("default (memoized)", samples=2**22)
    cold = []
    for _ in range(5):
        engine._BOUNDS_MEMO.clear()
        engine._COUNTS_MEMO.clear()
        t0 = time.perf_counter()
        sp.generate(example(sp), samples=2**22, verbose=False)
        cold.append(time.perf_counter() - t0)
    print("  default with the memos emptied before each call, s: median %.4f "
          "min %.4f (5 runs)" % (statistics.median(cold), min(cold)))
    print("  phases (s): %s" % json.dumps(dict(engine.LAST_STATS)))

    # -- phase 7 ---------------------------------------------------------------
    print("== phase 7: generate(samples=2**24, float64) at its default "
          "variant on the card", flush=True)
    t0 = time.perf_counter()
    pts, counts = drive(samples=2**24, dtype=torch.float64)
    print("  %.2f s, launches: %s" % (time.perf_counter() - t0, counts))
    for k in dense_path:
        check(counts[k] >= 1, "%s launched at 2^24 (%d)" % (k, counts[k]))
    check(len(pts) // 3 == TRIS_2P24,
          "%d triangles (want %d)" % (len(pts) // 3, TRIS_2P24))
    h = soup_hash(pts)
    check(h == SOUP_2P24, "soup sha256 %s" % h)
    check(engine.LAST_STATS.get("mc33_conflicted_cells") == 0,
          "mc33_conflicted_cells == 0 at 2^24")
    del pts
    X, Y, Z = grid_axes(example(sp), 2**24, torch.float64)
    vol, cas = eval_classify.eval_and_classify(example(sp), X, Y, Z,
                                               torch.float64, dev)
    ek = mc33.classify_ext(vol, base_case=cas)
    ep = mc33._classify_ext_plain(vol, base_case=cas)
    check(torch.equal(ek, ep), "B2 ext grid %s at 2^24 float64 bit-equal to "
          "plain on the same volume" % (tuple(ek.shape),))
    eh = hashlib.sha256(ek.cpu().numpy().tobytes()).hexdigest()
    print("  ext grid sha256 %s\n  pinned          %s (%s)" % (
        eh, EXT_GRID_2P24, "equal" if eh == EXT_GRID_2P24 else
        "DIFFERENT: the pin was taken on a jitted XLA volume, whose FMA "
        "contraction moves samples by an ulp"))
    del vol, cas, ek, ep

    # -- phase 8 ---------------------------------------------------------------
    print("== phase 8: the saddle model at samples=2**22, float32, both "
          "variants", flush=True)
    sad = zoo.saddle()
    X, Y, Z = grid_axes(sad, 2**22, torch.float32)
    vk, ck = eval_classify.eval_and_classify(sad, X, Y, Z, torch.float32, dev)
    vp, cp = eval_classify._eval_classify_plain(sad, X, Y, Z, torch.float32,
                                                dev)
    check(torch.equal(vk.view(torch.int32), vp.view(torch.int32))
          and torch.equal(ck, cp),
          "B1 eval_classify on the saddle model (sin, cos): vol and case "
          "bit-equal to plain")
    check(torch.equal(mc33.classify_ext(vk, base_case=ck),
                      mc33._classify_ext_plain(vk, base_case=ck)),
          "B2 classify_ext on the saddle volume bit-equal to plain")
    del vk, ck, vp, cp
    soups = {}
    for variant in ("lewiner", "fast"):
        t0 = time.perf_counter()
        pts, counts = drive(zoo.saddle(), samples=2**22, mc_variant=variant)
        soups[variant] = (len(pts) // 3, soup_hash(pts))
        print("  %s: %d triangles in %.2f s, soup %s, launches %s, "
              "conflicted %s" % (variant, soups[variant][0],
                                 time.perf_counter() - t0, soups[variant][1],
                                 counts,
                                 engine.LAST_STATS.get("mc33_conflicted_cells")))
        check(bool(np.isfinite(pts).all()), "finite vertices (%s)" % variant)
        del pts
    print("  (the JAX package on its TPU counted 1,899,716 lewiner / "
          "1,899,008 fast; sin and cos differ between the machines, so the "
          "counts are not pinned to those)")
    check(soups["lewiner"][0] != soups["fast"][0],
          "the variants' triangle counts differ (%d vs %d)"
          % (soups["lewiner"][0], soups["fast"][0]))
    check(soups["lewiner"][1] != soups["fast"][1], "the variants' soups differ")


    # -- phase 9 ---------------------------------------------------------------
    print("== phase 9: the tiled path at full width: generate(zoo.blobby(), "
          "samples=2**26) at its defaults", flush=True)

    def clear_memos():
        for memo in (engine._BOUNDS_MEMO, engine._COUNTS_MEMO,
                     engine._SKIP_MEMO, sparse._COUNTS_MEMO):
            memo.clear()

    clear_memos()
    t0 = time.perf_counter()
    pts, counts = drive(zoo.blobby(), samples=2**26)
    first_s = time.perf_counter() - t0
    first_stats = dict(engine.LAST_STATS)
    print("  first call %.3f s, launches: %s" % (first_s, counts))
    print("  phases of the first call (s): %s" % json.dumps(first_stats))
    check(first_stats.get("auto_tiles", 0) >= engine.AUTO_TILES_THRESHOLD,
          "auto_tiles = %s: the cull routed the run to the tiles"
          % first_stats.get("auto_tiles"))
    check("sparse_tiles" in first_stats, "the sparse_tiles phase ran")
    for k in ("eval_tiles_batched", "classify_ext", "ntri", "indices_of",
              "indices_and_ranktable_of"):
        check(counts[k] >= 1, "%s launched on the routed path (%d)"
              % (k, counts[k]))
    check(counts["classify_ext"] == 2 and counts["ntri"] >= 2,
          "classify_ext and ntri ran on the dense grid and again on the tiles")
    check(counts["eval_tiles"] == 0, "the per-tile kernel with fields is not "
          "on a gather-free path")
    kernels["eval_tiles_batched"]["launches"] = counts["eval_tiles_batched"]
    # This run's launches of the earlier kernels, beside the numbers phase 3
    # took at its shapes: B1 once (the dense pass), B2 and B3 on the dense
    # grid and again on the tiles, B4 and B5 on the tiles.
    for k in dense_path:
        kernels[k]["routed_launches"] = counts[k]
    routed_tris = len(pts) // 3
    check(bool(np.isfinite(pts).all()) and pts.shape[1] == 3 and routed_tris,
          "finite (3T, 3) vertices, %d triangles" % routed_tris)
    routed_hash = soup_hash(pts)
    del pts
    # The dense pipeline under the same cull mask: the same call with the
    # routing switched off, so generate() meshes what it had speculated.
    threshold = engine.AUTO_TILES_THRESHOLD
    engine.AUTO_TILES_THRESHOLD = 2.0
    try:
        pts, dcounts = drive(zoo.blobby(), samples=2**26)
    finally:
        engine.AUTO_TILES_THRESHOLD = threshold
    engine._COUNTS_MEMO.clear()  # that run's counts must not stop the routing
    check("auto_tiles" not in engine.LAST_STATS and dcounts["eval_tiles_batched"]
          == 0, "reference run: dense pipeline under the same cull mask "
          "(%d skipped of %d batches)" % (engine.LAST_STATS["skipped"],
                                          engine.LAST_STATS["batches"]))
    check(len(pts) // 3 == routed_tris and soup_hash(pts) == routed_hash,
          "canonical soup of the routed run equal to the dense pipeline's "
          "under the same cull mask (%d triangles)" % routed_tris)
    del pts
    pts, _ = drive(zoo.blobby(), samples=2**26, sparse=False)
    print("  sparse=False (no cull) meshes %d triangles, the routed run %d: %s"
          % (len(pts) // 3, routed_tris,
             "equal" if len(pts) // 3 == routed_tris else
             "the cull removes surface of this inexact SDF"))
    del pts
    verts, faces = sp.generate(zoo.blobby(), samples=2**26, verbose=False,
                               output="mesh")
    check(len(faces) == routed_tris and engine.LAST_STATS.get("auto_tiles"),
          "output='mesh' on the routed path: %d vertices, %d faces"
          % (len(verts), len(faces)))
    check_tile_order(verts, faces, grid_axes(zoo.blobby(), 2**26,
                                             torch.float32), 32)
    del verts, faces
    t0 = time.perf_counter()
    again, counts2 = drive(zoo.blobby(), samples=2**26)
    print("  second call %.3f s (bounds and tiles counts memoized), launches "
          "%s" % (time.perf_counter() - t0, counts2))
    check(soup_hash(again) == routed_hash, "second call: the same soup")
    del again
    sparse.PROFILE = True
    try:
        report_warm("routed blobby 2^26", zoo.blobby, samples=2**26)
    finally:
        sparse.PROFILE = False

    # -- phase 10 --------------------------------------------------------------
    print("== phase 10: generate(sparse='tiles') on the pinned model, and "
          "blobby against the CPU", flush=True)
    for variant in ("lewiner", "fast"):
        dense, _ = drive(samples=2**22, mc_variant=variant)
        pts, counts = drive(samples=2**22, mc_variant=variant, sparse="tiles")
        print("  %s launches: %s" % (variant, counts))
        check(counts["eval_tiles_batched"] == 1 and counts["eval_classify"] == 0,
              "sparse='tiles' evaluates with B6 only (%s)" % variant)
        check(len(pts) // 3 == TRIS_2P22, "%d triangles under %s (want %d)"
              % (len(pts) // 3, variant, TRIS_2P22))
        check(soup_hash(pts) == soup_hash(dense),
              "canonical soup equal to the dense run's (%s)" % variant)
        check(("mc33_conflicted_cells" not in engine.LAST_STATS),
              "no conflicted-cell count on an explicit tiles run")
        verts, faces = sp.generate(example(sp), samples=2**22, verbose=False,
                                   mc_variant=variant, sparse="tiles",
                                   output="mesh")
        check(np.array_equal(verts[faces.reshape(-1)], pts),
              "output='mesh': verts[faces] is the soup (%d vertices)"
              % len(verts))
        check_tile_order(verts, faces, grid_axes(example(sp), 2**22,
                                                 torch.float32), 32)
        del dense, pts, verts, faces
    report_warm("example 2^22 sparse='tiles'", samples=2**22, sparse="tiles")
    pts, counts = drive(zoo.blobby(), samples=2**22, sparse="tiles")
    nskip, nb = engine.LAST_STATS["skipped"], engine.LAST_STATS["batches"]
    t0 = time.time()
    cpu = sp.generate(zoo.blobby(), samples=2**22, verbose=False,
                      sparse="tiles", device="cpu")
    print("  blobby 2^22 sparse='tiles': %d triangles, %d of %d batches kept; "
          "device='cpu' run %.1f s" % (len(pts) // 3, nb - nskip, nb,
                                       time.time() - t0))
    check(np.array_equal(pts, cpu), "blobby 2^22 tiles soup bit-equal to the "
          "device='cpu' run")
    del pts, cpu

    # -- phase 11 --------------------------------------------------------------
    print("== phase 11: a gather-bearing expression under sparse='tiles'",
          flush=True)
    for gname in gathers:
        kw = dict(samples=2**22 if gname == "rotated" else 2**20,
                  bounds=GATHER_BOUNDS, sparse="tiles")
        pts, counts = drive(gather_models(sp)[gname], **kw)
        print("  %s: %d triangles, launches %s" % (gname, len(pts) // 3, counts))
        check(counts["eval_tiles"] == 1 and counts["eval_tiles_batched"] == 0
              and counts["eval_classify"] == 0,
              "kernel B7 evaluates the %s model" % gname)
        if gname == "rotated":
            kernels["eval_tiles"]["launches"] = counts["eval_tiles"]
        check(len(pts) > 0 and bool(np.isfinite(pts).all()),
              "finite vertices (%s)" % gname)
        cpu = sp.generate(gather_models(sp)[gname], verbose=False,
                          device="cpu", **kw)
        check(np.array_equal(pts, cpu),
              "%s soup bit-equal to the device='cpu' run" % gname)
        # At the defaults (sparse=True) the cull alone decides, as in the
        # JAX package: the speculative dense pass runs B1 with the fields,
        # and the run goes to B7 only at AUTO_TILES_THRESHOLD or more.
        del kw["sparse"]
        auto, counts = drive(gather_models(sp)[gname], **kw)
        st = dict(engine.LAST_STATS)
        cull = st["skipped"] / st["batches"]
        routed = cull >= engine.AUTO_TILES_THRESHOLD
        check("gather_tiles" not in st and ("auto_tiles" in st) == routed
              and counts["eval_classify"] == 1
              and counts["eval_tiles"] == int(routed),
              "%s at the defaults: %.4f of the batches culled, %s"
              % (gname, cull, "routed to kernel B7" if routed else
                 "dense, kernel B1 reading the fields"))
        check(soup_hash(auto) == soup_hash(pts),
              "%s at the defaults: the canonical soup of sparse='tiles'"
              % gname)
        del pts, cpu, auto

    def three_routes(label, make, samples, dtype=torch.float32,
                     compare_cpu=True, keep_launches=False):
        """generate() of ``make()`` with sparse=False, at the defaults and
        with sparse="tiles": B1 once with its fields and B7 never under
        sparse=False, the soup bit-equal to the device="cpu" run; the
        defaults on the route the cull decides; the tiles giving the
        defaults' canonical soup.  Returns the sparse=False soup."""
        name = str(dtype).split(".")[1]
        kw = dict(samples=samples, dtype=dtype)
        t0 = time.perf_counter()
        dense, counts = drive(make(), sparse=False, **kw)
        st = dict(engine.LAST_STATS)
        print("  %s %s sparse=False: %d triangles in %.2f s, launches %s"
              % (label, name, len(dense) // 3, time.perf_counter() - t0,
                 counts))
        check(counts["eval_classify"] == 1 and counts["eval_tiles"] == 0
              and counts["eval_tiles_batched"] == 0 and "record_fields" in st,
              "%s %s sparse=False: B1 once with its field(s), B7 never"
              % (label, name))
        if keep_launches:
            kernels["eval_classify_fields"]["launches"] = \
                counts["eval_classify"]
        check(len(dense) > 0 and bool(np.isfinite(dense).all()),
              "%s %s: finite vertices" % (label, name))
        if compare_cpu:
            t0 = time.time()
            cpu = sp.generate(make(), verbose=False, device="cpu",
                              sparse=False, **kw)
            check(np.array_equal(dense, cpu), "%s %s sparse=False: soup "
                  "bit-equal to the device='cpu' run (%.1f s)"
                  % (label, name, time.time() - t0))
            del cpu
        auto, counts = drive(make(), **kw)
        st = dict(engine.LAST_STATS)
        cull = st["skipped"] / st["batches"]
        routed = cull >= engine.AUTO_TILES_THRESHOLD
        check(("auto_tiles" in st) == routed and counts["eval_classify"] == 1
              and counts["eval_tiles"] == int(routed),
              "%s %s at the defaults: %.4f of the batches culled, %s"
              % (label, name, cull, "routed to the tiles" if routed
                 else "dense with B1 reading the field(s)"))
        tiles, counts = drive(make(), sparse="tiles", **kw)
        check(counts["eval_tiles"] == 1 and counts["eval_classify"] == 0,
              "%s %s sparse='tiles': kernel B7" % (label, name))
        check(len(tiles) == len(auto) and soup_hash(tiles) == soup_hash(auto),
              "%s %s: the defaults and sparse='tiles' give one canonical "
              "soup under the same cull (%d triangles)"
              % (label, name, len(tiles) // 3))
        del auto, tiles
        return dense

    # -- phase 12 --------------------------------------------------------------
    print("== phase 12: a polygon model (a gather: B1 reads its field) at "
          "2**22, three routes, both dtypes", flush=True)
    for dt in (torch.float32, torch.float64):
        three_routes("polygon 2^22", lambda: polygon_model(sp), 2**22, dt,
                     keep_launches=dt == torch.float32)
    report_warm("polygon 2^22 sparse=False", lambda: polygon_model(sp),
                samples=2**22, sparse=False)
    report_warm("polygon 2^22 defaults", lambda: polygon_model(sp),
                samples=2**22)
    t0 = time.perf_counter()
    pts, counts = drive(polygon_model(sp), samples=2**24, sparse=False)
    print("  polygon 2^24 float32 sparse=False: %d triangles in %.2f s, "
          "launches %s, phases %s" % (len(pts) // 3,
                                      time.perf_counter() - t0, counts,
                                      json.dumps(dict(engine.LAST_STATS))))
    check(counts["eval_classify"] == 1 and counts["eval_tiles"] == 0
          and len(pts) > 0 and bool(np.isfinite(pts).all()),
          "polygon 2^24 sparse=False: B1 once with a 64 MB field, finite "
          "vertices")
    del pts

    # -- phase 13 --------------------------------------------------------------
    print("== phase 13: a mesh SDF (Mesh.from_file, Mesh.sdf on the card) in "
          "examples/mesh.py's remix at 2**22", flush=True)
    work = os.path.join("build", "chip_smoke")
    os.makedirs(work, exist_ok=True)
    stl_path = os.path.join(work, "example.stl")
    sp.save(stl_path, example(sp), samples=2**15, verbose=False)
    mesh = sp.Mesh.from_file(stl_path)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    msdf = mesh.sdf(voxel_size=0.04, half_width=0.12)
    torch.cuda.synchronize()
    print("  Mesh.sdf: %d triangles, grid %s (%d points), %.2f s on the card"
          % (len(mesh.triangles), msdf.array.shape, msdf.array.size,
             time.perf_counter() - t0))
    check(bool(np.isfinite(msdf.array).all()) and (msdf.array < 0).any()
          and (msdf.array > 0).any(), "the mesh SDF grid is finite, signed")
    remix = lambda: hollowed_with_cross_hatch_ribs(sp, msdf, 0.08, 0.04,
                                                   0.08, 0.25)
    three_routes("mesh remix 2^22", remix, 2**22)

    # -- phase 14 --------------------------------------------------------------
    print("== phase 14: a legacy closure (numpy only: the host tier) at "
          "2**20, sparse=False", flush=True)
    pts, counts = drive(legacy_model(sp), samples=2**20, sparse=False)
    check(counts["eval_classify"] == 1 and counts["eval_tiles"] == 0
          and "record_fields" in engine.LAST_STATS,
          "B1 once, reading the closure's field (%d triangles)"
          % (len(pts) // 3))
    cpu = sp.generate(legacy_model(sp), samples=2**20, sparse=False,
                      verbose=False, device="cpu")
    check(len(pts) > 0 and np.array_equal(pts, cpu),
          "legacy closure: soup bit-equal to the device='cpu' run")
    del pts, cpu

    # -- phase 15 --------------------------------------------------------------
    print("== phase 15: textures", flush=True)
    have_pil = all(importlib.util.find_spec(m) is not None
                   for m in ("PIL", "scipy"))
    font = font_file() if have_pil else None
    if have_pil:
        three_routes("image.py model 2^22", lambda: image_model(sp), 2**22)
        report_warm("image.py model 2^22 defaults", lambda: image_model(sp),
                    samples=2**22)
    if have_pil and font:
        three_routes("text.py model 2^22", lambda: text_model(sp, font),
                     2**22)
    if not (have_pil and font):
        print("  not run: %s (%s)" % (
            "image.py's and text.py's models" if not have_pil
            else "text.py's model",
            "no Pillow or scipy on this machine" if not have_pil
            else "no DejaVuSans.ttf in the XDG font directories"))

    # -- result ------------------------------------------------------------------
    order = dense_path + ["eval_tiles_batched", "eval_tiles",
                          "eval_classify_fields"]
    keys = ["name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"]
    more = ["routed_launches", "routed_dense_pass", "tiles_path", "prepass_ms",
            "kernel_only_ms", "nf", "nf4"]
    print(json.dumps({"kernels": [
        {**{k: kernels[n][k] for k in keys},
         **{k: kernels[n][k] for k in more if k in kernels[n]}}
        for n in order]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
