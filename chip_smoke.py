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
     named on a line of its own;
 16. diffmesh.extract of the example model on generate()'s 2**22 grid
     (162^3), capacity 2**19, float32 and float64, lewiner and fast, with
     the backward of its mean vertex to every leaf: kernels B2 (lewiner),
     B3 (twice) and B4 (once) launched, each launch equal to its plain
     version on its input; n (291,028), valid and the vertices equal to
     the device="cpu" call, leaf gradients within a stated tolerance;
     forward and backward wall times, a profiled breakdown, each kernel's
     time; the default capacity overflows with a warning;
 17. examples/fit_sphere.py's loop through the port: 300 fit_step calls
     fitting sphere(0.5) to the example model on 8,192 seeded points in
     float32; the first step against device="cpu", the loss falling, ms a
     step and the card's idle share;
 18. fit_chamfer of a sphere to a 384-point cloud on radius 1.2
     (resolution 20, 80 steps, float64): the radius within 0.1 of 1.2;
 19. sample_slice of the example model at 1024 x 1024 on the card against
     device="cpu";
 20. four ranks of torch.distributed on the one card (gloo, device="cuda",
     spawned after the parent builds every library they load): the
     certificate of MULTICHIP_r05.json (1,024 triangles, 4 ranks bit-equal
     to 1, sha256 beside the JAX package's); generate(mesh=) of the
     example at 2**22 float32 and 2**24 float64 under both variants (z
     slabs: 291,028 and 731,152 triangles, the 2**24 pin), blobby at 2**26
     and the gather model of phase 11 with sparse="tiles" (the dealt tile
     list, kernels B6 and B7) and that model with sparse=False (B1 with
     fields on each slab), each gathered soup bit-equal as a set to the
     single-device run on the card and every rank's launches counted;
     each kernel launch of rank 0 held against its plain version on its
     own input; extract_sharded at 162^3 in both dtypes (291,028, the
     valid rows equal to extract's, gradients within tolerance, one host
     read besides the collectives); fit(mesh=) on fit_sphere.py's 8,192
     points (the first step equal to the single-device step's, the loss
     falling over 300 steps, the same leaves on every rank) and one
     fit_chamfer(mesh=) step; wall times per rank, which time-share the
     card and are no scaling number.  NCCL does not run: one card.
Phase 3 also holds kernel B1 with field inputs (1, 2 and 4 fields, both
dtypes, on the example's grid) and on a gather-free model of 2D ops, and
kernel B5 at edge shapes (ragged, all set, capacity below the count,
misaligned views).  It also holds kernels B6 and B7 against their plain
versions on the tile lists of phases 9 to 11 and at tiles 1, 33, 64 and
65 on the example's grid, each with ``live`` (the padded rows copied, not
evaluated) and without, in both dtypes, and B7 with one and two fields;
it prints B6/B7's plan at each tile and times B6 on blobby's 512 rows and
B7 on the rotated lookup's tiles with and without ``live``; and kernels
B1 to B5 at the shapes phase 9
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
Then one JSON line with every kernel (B2's, B3's and B4's entries also
carry ``diffmesh_launches``, their launches in phase 16's float32 lewiner
extract; every entry carries ``sharded_launches``, its launches on rank 0
in phase 20's full-width runs), the card line again, and last the result
line.  Any failed check raises, and the script exits non-zero
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
volumes (its instructions times the cells), and B6's on the routed run's
tile rows, the 388 a live call evaluates and all 512 (blobby's
instructions times the samples B6's plan evaluates); and for B6/B7 the
blocks of 256 threads an SM holds at each model's registers.

``python3 chip_smoke.py --tile-sweep`` times kernel B6 on the routed
run's 512 tile rows (388 evaluated) with a row cut into 1 to 16 blocks,
in clusters that share their halos and in clusters of one block that
evaluate them again, in both dtypes, each output held bit-equal to the
default plan's.

``python3 chip_smoke.py --diffmesh`` builds kernels B2, B3 and B4 and runs
phases 16 to 19 alone (a few minutes shorter than the whole script).

``python3 chip_smoke.py --sharded`` builds the libraries phase 20 needs and
runs phase 20 alone.

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
import warnings

SOUP_2P24 = "54d4ad9c22a8ce6bb77d8b763e2abb6878eda56ece4a40ea8aa274802b698ca3"
EXT_GRID_2P24 = "3fb04083920066edbaef61d2d80986b926941df188874e34fdda3b447eb73fcc"
TRIS_2P22 = 291028
TRIS_2P24 = 731152
# Phase 16: diffmesh.extract on generate()'s grid at 2**22 samples (162^3),
# with a triangle buffer the example's surface fits; phase 19's slice side.
DM_SAMPLES = 2**22
DM_CAPACITY = 2**19
SLICE = 1024

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
    used, each kernel's mean time counted as many times a call as it ran
    on average).  Raises if none recorded a kernel of ``fn``."""
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
    # Per kernel name, the mean of the recorded launches times the launches
    # a call makes: the sum over reps when none was dropped, and no
    # undercount when the kept profile lost some.
    per = {}
    for e in kept:
        per.setdefault(e.name, []).append(e.time_range.elapsed_us())
    return sum(statistics.fmean(d) * max(1, round(len(d) / reps))
               for d in per.values()) / 1e3


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
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.split()[0])
    return card_sms() * 128 * mhz * 1e6


def card_sms():
    """The card's SMs, which kernels B3's and B6/B7's plans fill."""
    import torch

    return torch.cuda.get_device_properties(0).multi_processor_count


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


def surface_cells(f, axes, dtype, device):
    """A tile list at tile 1: the cells the surface crosses (case neither 0
    nor 255 on the plain dense grid), x-major, padded with tile 0 to
    round_capacity; returns ``(tiles (ntc, 3) int32 tensor, live count)``.
    The host cull's per-tile Python loop would take minutes at tile 1."""
    import torch

    from sdf_torch.core import eval_classify, mc

    _, cas = eval_classify._eval_classify_plain(f, *axes, dtype, device)
    active = torch.nonzero((cas != 0) & (cas != 255)).to(torch.int32)
    tiles = torch.zeros((mc.round_capacity(len(active)), 3),
                        dtype=torch.int32, device=device)
    tiles[:len(active)] = active
    return tiles, len(active)


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
    return "double" if re.search(r"kernelId", fn) else "float"


def _print_ptxas(out):
    """Registers, stack and spills of each entry function in an ``nvcc
    -Xptxas -v`` log; returns the registers of each."""
    regs_of = []
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
        regs_of.append(int(regs))
    return regs_of


def blocks_by_registers(regs, threads):
    """Blocks of ``threads`` an SM holds at ``regs`` registers a thread:
    65,536 registers, allocated to each warp in units of 256 (8 a thread),
    at most 2,048 threads."""
    per_block = -(-regs // 8) * 8 * threads
    return min(65536 // per_block, 2048 // threads)


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
            regs = _print_ptxas(out)
            if kind == "B6/B7":
                print("  B6/B7 blocks of %d threads an SM by registers: %s"
                      % (eval_classify._TILE_THREADS, ", ".join(
                          str(blocks_by_registers(r, eval_classify.
                                                  _TILE_THREADS))
                          for r in regs)))
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
    # B6 on the routed run's tile list: blobby's kept tiles at 2^26, tile
    # 32, the rows a live call evaluates and every row (the plan needs the
    # card's SMs).
    axes = grid_axes(models["blobby"], 2**26, torch.float32)
    tiles, nt = kept_tiles(models["blobby"], axes, 32, torch.float32, "cpu")
    for rows in (min(nt + 1, len(tiles)), len(tiles)) if rate else ():
        per_row = eval_classify.tile_evaluations(32, rows, card_sms())
        for dt, counts in sass["blobby"].items():
            floor = ("%.4f ms" % instruction_floor_ms(counts, rows * per_row,
                                                      rate)
                     if rate else "not measured (no card)")
            print("  B6 %s on blobby's tiles at 2^26: %d of %d rows (%d "
                  "live), %d blocks of %d threads, %d evaluations (%.4f a "
                  "sample), instruction floor %s" % (
                      dt, rows, len(tiles), nt,
                      rows * eval_classify.tile_plan(32, rows, card_sms())[1],
                      eval_classify._TILE_THREADS, rows * per_row,
                      per_row / 33**3, floor))
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


def tile_sweep(dev):
    """Kernel B6 on the routed run's tile list (blobby's 512 rows at 2**26,
    tile 32, live = the kept count) under forced cuts of a row (blocks a
    row, blocks a cluster; a cluster of one block evaluates its halo
    again), in both dtypes: one JSON line each with the device ms, the
    blocks and the evaluations a sample, each output held bit-equal to the
    default plan's."""
    import torch

    from sdf_torch import _build
    from sdf_torch.core import eval_classify
    from sdf_torch.models import zoo

    print(card_line())
    g = zoo.blobby()
    _build.build_many([("eval_tiles", eval_classify.tile_kernel_source(g))])
    axes = grid_axes(g, 2**26, torch.float32)
    tiles, nt = kept_tiles(g, axes, 32, torch.float32, dev)
    rows = min(nt + 1, len(tiles))
    b6 = eval_classify.eval_tiles_and_classify_batched
    default = eval_classify.tile_plan(32, rows, card_sms())[1:3]
    for dt in (torch.float32, torch.float64):
        ints = torch.int32 if dt == torch.float32 else torch.int64
        vol, cas = b6(g, *axes, tiles, 32, dt, live=nt)
        for blocks, csize in ((1, 1), (2, 2), (4, 4), (8, 8), (16, 8),
                              (4, 1), (8, 1)):
            run = lambda: eval_classify._launch_tiles(
                g, *axes, tiles, 32, dt, nt, (), b6, blocks, csize)
            vk, ck = run()
            if not (torch.equal(vk.view(ints), vol.view(ints))
                    and torch.equal(ck, cas)):
                raise AssertionError("B6 with %d blocks a row in clusters "
                                     "of %d differs from the default plan"
                                     % (blocks, csize))
            del vk, ck
            print(json.dumps(dict(
                kernel="eval_tiles_batched", rows=len(tiles), live=nt,
                dtype=str(dt).split(".")[1], blocks_a_row=blocks,
                cluster=csize, default=(blocks, csize) == default,
                blocks=rows * blocks,
                evaluations_per_sample=eval_classify.tile_evaluations(
                    32, rows, card_sms(), blocks, csize) / 33**3,
                ms=device_ms(run, reps=10, warm=2))), flush=True)
        del vol, cas
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


def diffmesh_phases(dev, kernels):
    """Phases 16-19: the differentiable path and the slice on the card.
    Adds each of B2's, B3's and B4's launches in phase 16's float32
    lewiner extract to ``kernels`` as ``diffmesh_launches``."""
    import numpy as np
    import torch

    import sdf_torch as sp
    from sdf_torch.core import compact, diffmesh, mc, mc33
    from sdf_torch.core.node import tree_leaves
    from sdf_torch.core.node import upload as node_upload
    from sdf_torch.models import fit as fit_mod

    # -- phase 16 -------------------------------------------------------------
    print("== phase 16: diffmesh.extract of the example model at 162^3 "
          "(generate()'s 2**22 grid), capacity 2**19, forward and backward",
          flush=True)
    axes = grid_axes(example(sp), DM_SAMPLES, torch.float32)
    dm_bounds = (tuple(float(a[0]) for a in axes),
                 tuple(float(a[-1]) for a in axes))
    dm_res = tuple(len(a) for a in axes)
    dm_cap = DM_CAPACITY
    dm_wrappers = {"classify_ext": mc33.classify_ext, "ntri": mc.ntri_of,
                   "indices_of": compact.indices_of}

    def mean_vertex_grads(dtype, variant, device, capacity=dm_cap):
        """``diffmesh.extract`` and ``mean_vertex``'s gradient with respect to
        every leaf of the example: ``(verts, n, valid, grads)``.  A weighted
        sum of the mean vertex is the loss."""
        node = fit_mod._params(example(sp), dtype, device)
        leaves = tree_leaves(node)
        verts, n, valid = diffmesh.extract(node, dm_bounds, dm_res, capacity,
                                           dtype, variant, device)
        w = valid.to(verts.dtype)[:, None, None]
        mv = (verts * w).sum(dim=(0, 1)) / torch.clamp(3.0 * valid.sum(),
                                                      min=1.0)
        loss = (mv * torch.arange(1, 4, dtype=dtype, device=device)).sum()
        grads = torch.autograd.grad(loss, leaves)
        return verts.detach(), int(n), valid, grads

    def spied(run):
        """``run()`` with B2's, B3's and B4's wrappers stood in for by spies
        that keep each call's inputs (cloned, to hold each launch against
        its plain version afterwards) and call the wrapper.  A wrapper
        counts its launches on its module's name, which is the spy's while
        the spies stand: each count is set to 0 just before ``run()`` and
        read just after, then put back on the wrapper."""
        seen = []
        mods = {"classify_ext": mc33, "ntri": mc, "indices_of": compact}
        attrs = {"classify_ext": "classify_ext", "ntri": "ntri_of",
                 "indices_of": "indices_of"}
        spies = {}
        for name, fn in dm_wrappers.items():
            def call(*a, _name=name, _fn=fn, **k):
                seen.append((_name, [x.detach().clone() if torch.is_tensor(x)
                                     else x for x in a], k))
                return _fn(*a, **k)

            call.launches = 0
            spies[name] = call
            setattr(mods[name], attrs[name], call)
        try:
            out = run()
            torch.cuda.synchronize()
        finally:
            for name, fn in dm_wrappers.items():
                setattr(mods[name], attrs[name], fn)
                fn.launches = spies[name].launches
        return out, {k: s.launches for k, s in spies.items()}, seen

    def hold_launches(seen, label):
        """Each captured launch's output against its plain version on the
        same input (these launches come after the counts were read)."""
        for name, a, k in seen:
            if name == "classify_ext":
                same = torch.equal(mc33.classify_ext(*a, **k),
                                   mc33._classify_ext_plain(*a, **k))
            elif name == "ntri":
                table = mc.get_tables(*a[1:]).on(a[0].device, "ntri")
                same = torch.equal(mc.ntri_of(*a, **k),
                                   mc._ntri_plain(a[0], table))
            else:
                ik, tk = compact.indices_of(*a, **k)
                ip, tp = compact._indices_of_plain(*a, **k)
                same = torch.equal(ik, ip) and int(tk) == int(tp)
            check(same, "%s: the %s launch equals its plain version on its "
                  "input %s" % (label, name, tuple(a[0].shape)))

    print("  grid %s over %s, capacity %d" % (dm_res, dm_bounds, dm_cap))
    for dt in (torch.float32, torch.float64):
        name = str(dt).split(".")[1]
        eps = torch.finfo(dt).eps
        for variant in ("lewiner", "fast"):
            label = "extract %s %s" % (name, variant)
            (verts, n, valid, grads), counts, seen = spied(
                lambda: mean_vertex_grads(dt, variant, dev))
            want = {"classify_ext": int(variant == "lewiner"), "ntri": 2,
                    "indices_of": 1}
            check(counts == want, "%s: launches %s (B2 once under lewiner, "
                  "B3 twice, B4 once)" % (label, counts))
            hold_launches(seen, label)
            if dt == torch.float32 and variant == "lewiner":
                for k, v in counts.items():
                    kernels[k]["diffmesh_launches"] = v
                # The three kernels' device time on this path's inputs,
                # taken before the profiled runs below (torch.profiler on
                # the card drops events more often after several).
                for kname, a, k in seen:
                    fn = dm_wrappers[kname]
                    ms = device_ms(lambda: fn(*a, **k))
                    print("  %s on %s: kernel_ms %.4f" % (kname,
                                                         tuple(a[0].shape),
                                                         ms))
            print("  %s: %d triangles (generate() at 2**22: %d), %d kept"
                  % (label, n, TRIS_2P22, int(valid.sum())))
            t0 = time.time()
            cv, cn, cvalid, cgrads = mean_vertex_grads(dt, variant, "cpu")
            cpu_s = time.time() - t0
            check(n == cn and torch.equal(valid.cpu(), cvalid),
                  "%s: n and valid equal to the device='cpu' run (%.1f s)"
                  % (label, cpu_s))
            # Tolerances: vertices 8 eps of their scale (the lerp is the same
            # IEEE ops on both sides, so bit-equal is expected and printed);
            # leaf gradients sum millions of contributions in another order
            # on the card (index_put's accumulation, reductions): float64
            # rtol 1e-9, float32 1e-3 of the largest gradient.
            scale = float(cv.abs().max())
            verr = float((verts.cpu() - cv).abs().max())
            check(verr <= 8 * eps * scale,
                  "%s: vertices within 8 eps of the CPU's (max |diff| %g, %s)"
                  % (label, verr, "bit-equal" if verr == 0 else "not "
                     "bit-equal"))
            gmax = max(float(g.abs().max()) for g in cgrads)
            if dt == torch.float64:
                ok = all(torch.allclose(g.cpu(), c, rtol=1e-9,
                                        atol=1e-12 * gmax)
                         for g, c in zip(grads, cgrads))
            else:
                ok = all(float((g.cpu() - c).abs().max()) <= 1e-3 * gmax
                         for g, c in zip(grads, cgrads))
            gerr = max(float((g.cpu() - c).abs().max())
                       for g, c in zip(grads, cgrads))
            check(ok, "%s: the %d leaf gradients match the CPU's (max |diff| "
                  "%g, largest gradient %g)" % (label, len(grads), gerr, gmax))
            # Warm wall times: forward (extract and the probe), backward.
            fw, bw = [], []
            for _ in range(4):
                node = fit_mod._params(example(sp), dt, dev)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                mv = diffmesh.mean_vertex(node, dm_bounds, dm_res, dm_cap, dt,
                                          variant, dev)
                loss = (mv * torch.arange(1, 4, dtype=dt, device=dev)).sum()
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                torch.autograd.grad(loss, tree_leaves(node))
                torch.cuda.synchronize()
                fw.append((t1 - t0) * 1e3)
                bw.append((time.perf_counter() - t1) * 1e3)
            print("  %s: forward %.3f ms, backward %.3f ms (warm medians of "
                  "3)" % (label, statistics.median(fw[1:]),
                          statistics.median(bw[1:])))
            if variant == "lewiner":
                # Where the card's time goes: one profiled forward and
                # backward, the largest kernels by name.
                wall, busy, per = timeline(
                    lambda: mean_vertex_grads(dt, variant, dev))
                print("  %s profiled: wall %.2f ms, card busy %.3f ms, idle "
                      "%.1f%%" % (label, wall, busy,
                                  100 - 100 * busy / wall))
                for k, v in sorted(per.items(), key=lambda kv: -kv[1])[:8]:
                    print("    device %.4f ms  %s" % (v, k[:100]))
            del verts, valid, grads, cv, cvalid, cgrads, seen
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        _, n, valid, _ = mean_vertex_grads(torch.float32, "lewiner", dev,
                                           capacity=None)
    default_cap = 4 * max(dm_res) ** 2
    check(n > default_cap and int(valid.sum()) == default_cap and any(
        "capacity" in str(w.message) for w in caught),
        "the default capacity 4 * r^2 = %d overflows with a warning (n = %d)"
        % (default_cap, n))

    # -- phase 17 -------------------------------------------------------------
    print("== phase 17: examples/fit_sphere.py's loop: 300 fit_step calls, "
          "sphere(0.5) fitted to the example model, 8,192 points, float32",
          flush=True)
    pts = np.random.default_rng(0).uniform(-1.5, 1.5, (8192, 3))

    def fit_setup(device):
        p, lr = node_upload([pts, np.asarray(0.05)], torch.float32, device)
        return p, example(sp)(p)[:, 0].detach(), lr

    p, t, lr = fit_setup(dev)
    cp, ct, clr = fit_setup("cpu")
    node, loss0 = fit_mod.fit_step(sp.sphere(0.5), p, t, lr)
    cnode, closs0 = fit_mod.fit_step(sp.sphere(0.5), cp, ct, clr)
    first = [w.detach().cpu() for w in tree_leaves(node)]
    cfirst = [w.detach() for w in tree_leaves(cnode)]
    check(torch.allclose(loss0.cpu(), closs0, rtol=1e-5) and all(
        torch.allclose(a, b, rtol=1e-5, atol=1e-7)
        for a, b in zip(first, cfirst)),
        "the first step's loss (%.6g) and leaves equal the device='cpu' "
        "step's within rtol 1e-5 (float32 sums in another order)"
        % float(loss0))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(299):
        node, loss = fit_mod.fit_step(node, p, t, lr)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / 299
    radius = float(tree_leaves(node)[-1].detach())
    check(float(loss) < float(loss0), "the loss falls: %.6g after 300 steps "
          "from %.6g; radius %.4f" % (float(loss), float(loss0), radius))

    def twenty_steps():
        nd = node
        for _ in range(20):
            nd, _ = fit_mod.fit_step(nd, p, t, lr)

    wall, busy, _ = timeline(twenty_steps)
    print("  fit_step: %.4f ms a step (299 warm steps); 20 profiled steps "
          "%.2f ms wall, card busy %.3f ms, idle %.1f%%"
          % (step_ms, wall, busy, 100 - 100 * busy / wall))

    # -- phase 18 -------------------------------------------------------------
    print("== phase 18: fit_chamfer: sphere(1.0) to a 384-point cloud on "
          "radius 1.2, resolution 20, 80 steps, float64", flush=True)
    rs = np.random.RandomState(11)
    cloud = rs.normal(size=(384, 3))
    cloud = 1.2 * cloud / np.linalg.norm(cloud, axis=1, keepdims=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    node, closs = fit_mod.fit_chamfer(
        sp.sphere(1.0), cloud, ((-1.6,) * 3, (1.6,) * 3), steps=80, lr=0.05,
        resolution=20, dtype=torch.float64, device=dev)
    chamfer_s = time.perf_counter() - t0
    radius = float(tree_leaves(node)[-1].detach())
    check(abs(radius - 1.2) < 0.1 and closs < 0.25,
          "radius %.4f within 0.1 of 1.2, chamfer %.4g (%.1f ms a step)"
          % (radius, closs, chamfer_s * 1e3 / 80))

    # -- phase 19 -------------------------------------------------------------
    print("== phase 19: sample_slice of the example model at 1024 x 1024",
          flush=True)
    a, extent, sax = sp.sample_slice(example(sp), SLICE, SLICE, z=0.1,
                                     device=dev)
    ca, cextent, csax = sp.sample_slice(example(sp), SLICE, SLICE, z=0.1,
                                        device="cpu")
    serr = float(np.abs(a - ca).max())
    check(a.shape == (SLICE, SLICE) and bool(np.isfinite(a).all())
          and extent == cextent and sax == csax and serr <= 8 * np.finfo(
              np.float32).eps * float(np.abs(ca).max()),
          "a %s, extent %s and axes %r equal to the device='cpu' call; "
          "values within 8 eps32 of its scale (max |diff| %g, %s)"
          % (a.shape, tuple(round(float(e), 4) for e in extent), sax, serr,
             "bit-equal" if serr == 0 else "not bit-equal"))
    ts = []
    for _ in range(5):
        t0 = time.perf_counter()
        sp.sample_slice(example(sp), SLICE, SLICE, z=0.1, device=dev)
        ts.append((time.perf_counter() - t0) * 1e3)
    print("  sample_slice %d x %d float32: %.3f ms (warm median of 4, bounds "
          "memoized)" % (SLICE, SLICE, statistics.median(ts[1:])))


# -- phase 20: several ranks ---------------------------------------------------
#
# Four processes on the one card, each a rank of a gloo process group with
# device="cuda" (NCCL refuses two ranks on one device).  The parent builds
# every kernel library the ranks load, computes the single-device references
# on the card, spawns the ranks, and holds what rank 0 returns against them.

SHARDED_RANKS = 4
SHARDED_TIMEOUT_S = 600
CERT_SOUP = "1cc04bcef3fd2e4e5b66c164d7907a4d2adb086b85b220201e8f37e1b51235f7"
TRIS_CERT = 1024
TRIS_BLOBBY_2P26 = 637600
FIT_POINTS = 8192
CHAMFER_BOUNDS = ((-1.6,) * 3, (1.6,) * 3)
# The kernels of the kernels line, by the wrapper that launches each.
SHARDED_KERNELS = ["eval_classify", "classify_ext", "ntri", "indices_of",
                   "indices_and_ranktable_of", "eval_tiles_batched",
                   "eval_tiles", "eval_classify_fields"]


def raw_hash(pts):
    """sha256 of a triangle soup sorted by triangle, unrounded (the
    certificate's form): equal for soups equal bit for bit in any order."""
    import numpy as np

    tris = np.asarray(pts, np.float64).reshape(-1, 9)
    tris = tris[np.lexsort(tris.T[::-1])]
    return hashlib.sha256(np.ascontiguousarray(tris).tobytes()).hexdigest()


def sharded_runs(sp, zoo):
    """The full-width runs of phase 20: label -> (expression, generate()
    keywords, the launches each rank must make: B1, B2, B3, B4, B5, B6,
    B7, B1 with fields)."""
    import torch

    g = gather_models(sp)["rotated"]
    slab = lambda b2: [1, b2, 2, 1, 1, 0, 0, 0]
    tiles = lambda b6, b7: [0, 1, 2, 1, 1, b6, b7, 0]
    return {
        "example 2^22 f32 lewiner": (example(sp), dict(samples=2**22),
                                     slab(1)),
        "example 2^22 f32 fast": (example(sp), dict(samples=2**22,
                                                    mc_variant="fast"),
                                  slab(0)),
        "example 2^24 f64 lewiner": (example(sp), dict(
            samples=2**24, dtype=torch.float64), slab(1)),
        "example 2^24 f64 fast": (example(sp), dict(
            samples=2**24, dtype=torch.float64, mc_variant="fast"), slab(0)),
        "blobby 2^26 tiles": (zoo.blobby(), dict(samples=2**26,
                                                 sparse="tiles"),
                              tiles(1, 0)),
        "gather 2^22 tiles": (g, dict(samples=2**22, bounds=GATHER_BOUNDS,
                                      sparse="tiles"), tiles(0, 1)),
        "gather 2^22 sparse=False": (g, dict(samples=2**22,
                                             bounds=GATHER_BOUNDS,
                                             sparse=False),
                                     [0, 1, 2, 1, 1, 0, 0, 1]),
    }


def sharded_sources(sp, zoo, _build, eval_classify, hybrid, mc33):
    """Every kernel library the ranks of phase 20 load."""
    g = gather_models(sp)["rotated"]
    return [
        ("eval_classify", eval_classify.kernel_source(example(sp))),
        ("eval_classify", eval_classify.kernel_source(
            hybrid.to_kernel_tree(g), 1)),
        ("eval_tiles", eval_classify.tile_kernel_source(example(sp))),
        ("eval_tiles", eval_classify.tile_kernel_source(zoo.blobby())),
        ("eval_tiles", eval_classify.tile_kernel_source(
            hybrid.to_kernel_tree(g), 1)),
        ("ntri", _build.source("ntri.cu")),
        ("compact", _build.source("compact.cu")),
        ("classify_ext", mc33.kernel_source()),
    ]


def extract_grads(sp, diffmesh, node_mod, dtype, device, bounds, res,
                  mesh=None):
    """extract (or extract_sharded on ``mesh``) of the example, lewiner,
    capacity DM_CAPACITY, and the leaf gradients of its weighted mean
    vertex: ``(hash of the valid rows, n, grads)``."""
    import torch

    node = node_mod.cast(example(sp), dtype, device)
    leaves = [w.requires_grad_(True) for w in node_mod.tree_leaves(node)]
    if mesh is None:
        verts, n, valid = diffmesh.extract(node, bounds, res, DM_CAPACITY,
                                           dtype, device=device)
    else:
        verts, n, valid = diffmesh.extract_sharded(
            node, bounds, res, DM_CAPACITY, dtype, mesh=mesh, device=device)
    w = valid.to(dtype)[:, None, None]
    mv = (verts * w).sum(dim=(0, 1)) / torch.clamp(3.0 * valid.sum(),
                                                    min=1.0)
    loss = (mv * torch.arange(1, 4, dtype=dtype, device=device)).sum()
    grads = torch.autograd.grad(loss, leaves)
    return (raw_hash(verts.detach()[valid].cpu().numpy()), int(n),
            [g.detach().cpu() for g in grads])


def fit_points():
    import numpy as np

    return np.random.default_rng(0).uniform(-1.5, 1.5, (FIT_POINTS, 3))


def chamfer_cloud():
    import numpy as np

    rs = np.random.RandomState(11)
    cloud = rs.normal(size=(384, 3))
    return 1.2 * cloud / np.linalg.norm(cloud, axis=1, keepdims=True)


def sharded_reference(dev):
    """The single-device runs on the card that phase 20's ranks are held
    against."""
    import torch

    import sdf_torch as sp
    from sdf_torch.core import diffmesh
    from sdf_torch.core import node as node_mod
    from sdf_torch.models import fit as fit_mod, zoo

    ref = {}
    for label, (f, kw, _) in sharded_runs(sp, zoo).items():
        pts = sp.generate(f, verbose=False, device=dev, **kw)
        ref[label] = (len(pts) // 3, raw_hash(pts), soup_hash(pts))
        del pts
    for dt in (torch.float32, torch.float64):
        ref[("extract", dt)] = extract_grads(sp, diffmesh, node_mod, dt, dev,
                                             *sharded_dm_grid(sp))
    node, loss = fit_mod.fit(sp.sphere(0.5), example(sp), fit_points(),
                             steps=1, lr=0.05, device=dev)
    ref["fit"] = (loss, [w.detach().cpu() for w in
                         node_mod.tree_leaves(node)])
    node, loss = fit_mod.fit_chamfer(
        sp.sphere(1.0), chamfer_cloud(), CHAMFER_BOUNDS, steps=1, lr=0.05,
        resolution=20, dtype=torch.float64, device=dev)
    ref["chamfer"] = (loss, float(node_mod.tree_leaves(node)[-1].detach()))
    return ref


def sharded_rank(rank, world, work, device_type):
    """One rank of phase 20 on ``device_type``: every sharded run, rank 0
    writing what the parent compares (``work/results.pkl``) and holding
    each kernel launch of its own slab and tiles against the plain
    version."""
    import datetime
    import pickle

    import numpy as np
    import torch
    import torch.distributed as dist

    import sdf_torch as sp
    from sdf_torch import parallel
    from sdf_torch.core import (compact, diffmesh, eval_classify, hybrid, mc,
                                mc33)
    from sdf_torch.core import node as node_mod
    from sdf_torch.models import fit as fit_mod, zoo
    from sdf_torch.parallel import multihost

    torch.set_num_threads(2)
    parallel.initialize(backend="gloo", init_method="file://%s/store" % work,
                        rank=rank, world_size=world,
                        timeout=datetime.timedelta(seconds=SHARDED_TIMEOUT_S))
    dev = torch.device(device_type)
    mesh = parallel.make_mesh(device_type)
    group = mesh.get_group()
    lead = rank == 0
    out = {"walls": {}, "launches": {}}

    def say(msg):
        if lead:
            print("  " + msg, flush=True)

    def timed(label, fn):
        # Every rank starts together (rank 0's checks between the runs
        # would otherwise count as the others' wait in a collective).
        multihost.all_reduce_host(np.zeros(1), "sum", group)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        out["walls"][label] = time.perf_counter() - t0
        return r

    wrappers = [eval_classify.eval_and_classify, mc33.classify_ext,
                mc.ntri_of, compact.indices_of,
                compact.indices_and_ranktable_of,
                eval_classify.eval_tiles_and_classify_batched,
                eval_classify.eval_tiles_and_classify]

    # 1. The certificate: 1 rank vs 4, float32, both variants.
    C = np.arange(-1.2, 1.2, 0.15)
    none = np.zeros((1, 1, 1), bool)
    for variant in ("lewiner", "default"):
        for name, run, tile in (("slabs", parallel.mesh_and_march, 32),
                                ("tiles", parallel.mesh_sparse_tiles_sharded,
                                 16)):
            pts, _ = run(example(sp), C, C, C, none, tile, mesh,
                         torch.float32, dev, variant=variant)
            full = parallel.gather_triangles(pts, mesh)
            if lead:
                one, _ = run(example(sp), C, C, C, none, tile, None,
                             torch.float32, dev, variant=variant)
                out[("cert", name, variant)] = (full, one)
    say("certificate run")

    # 2-3. The full-width runs: each count set to 0 just before and read
    # just after, on every rank.
    for label, (f, kw, want) in sharded_runs(sp, zoo).items():
        for w in wrappers:
            w.launches = 0
        pts = timed(label, lambda: sp.generate(f, verbose=False, mesh=mesh,
                                               **kw))
        got = [w.launches for w in wrappers]
        # B1 reading fields (a gather-bearing expression) has its own entry.
        got = ([0] + got[1:] + [got[0]] if hybrid.count_gathers(f)
               else got + [0])
        every = multihost.all_gather_host(np.asarray(got), group)
        full = parallel.gather_triangles(pts, mesh)
        if lead:
            out[label] = (len(full) // 3, raw_hash(full), soup_hash(full),
                          len(pts) // 3, every, want)
            out["launches"][label] = got
            say("%s: %d triangles (rank 0 holds %d), %.3f s on rank 0, "
                "launches on rank 0 %s" % (label, len(full) // 3,
                                           len(pts) // 3,
                                           out["walls"][label], got))
        del pts, full
    for label in ("example 2^22 f32 lewiner", "blobby 2^26 tiles"):
        f, kw, _ = sharded_runs(sp, zoo)[label]
        timed(label + " warm", lambda: sp.generate(f, verbose=False,
                                                   mesh=mesh, **kw))

    # 6. Each kernel launch of rank 0 against its plain version on that
    # launch's own input: the wrappers stood in for by spies that keep
    # each call's inputs (rank 0 only; the other ranks run as they are).
    seen = []
    spied = [(eval_classify, "eval_and_classify"), (mc33, "classify_ext"),
             (mc, "ntri_of"), (compact, "indices_of"),
             (compact, "indices_and_ranktable_of"),
             (eval_classify, "eval_tiles_and_classify_batched"),
             (eval_classify, "eval_tiles_and_classify")]
    real = {name: getattr(mod, name) for mod, name in spied}
    runs = sharded_runs(sp, zoo)
    for label in ("example 2^22 f32 lewiner", "blobby 2^26 tiles",
                  "gather 2^22 tiles"):
        f, kw, _ = runs[label]
        if lead:
            for mod, name in spied:
                def spy(*a, _name=name, **k):
                    keep = lambda x: (x.detach().clone()
                                      if torch.is_tensor(x) else x)
                    seen.append((label, _name, [keep(x) for x in a],
                                 {n: keep(x) for n, x in k.items()}))
                    return real[_name](*a, **k)

                spy.launches = 0
                setattr(mod, name, spy)
        try:
            sp.generate(f, verbose=False, mesh=mesh, **kw)
            torch.cuda.synchronize()
        finally:
            for mod, name in spied:
                setattr(mod, name, real[name])
    if lead:
        same = lambda a, b: torch.equal(
            a.view(torch.int32 if a.dtype == torch.float32 else torch.int64)
            if a.is_floating_point() else a,
            b.view(torch.int32 if b.dtype == torch.float32 else torch.int64)
            if b.is_floating_point() else b)
        held = []
        for label, name, a, k in seen:
            if name == "eval_and_classify":
                sdf, X, Y, Z, dt, device = a[:6]
                fields = a[6] if len(a) > 6 else k.get("fields")
                fields = tuple(fields or ())
                tree = hybrid.to_kernel_tree(sdf) if fields else sdf
                v, c = real[name](*a, **k)
                pv, pc = eval_classify._eval_classify_plain(
                    tree, X, Y, Z, dt, device, fields)
                ok = same(v, pv) and torch.equal(c, pc)
                what = "B1 (%d fields) on the slab %s" % (len(fields),
                                                          tuple(v.shape))
            elif name == "classify_ext":
                got = real[name](*a, **k)
                ok = torch.equal(got, mc33._classify_ext_plain(*a, **k))
                what = "B2 on %s" % (tuple(a[0].shape),)
            elif name == "ntri_of":
                table = mc.get_tables(*a[1:]).on(a[0].device, "ntri")
                ok = torch.equal(real[name](*a, **k),
                                 mc._ntri_plain(a[0], table))
                what = "B3 on %s" % (tuple(a[0].shape),)
            elif name == "indices_of":
                ik, tk = real[name](*a, **k)
                ip, tp = compact._indices_of_plain(*a, **k)
                ok = torch.equal(ik, ip) and int(tk) == int(tp)
                what = "B4 on %d slots" % a[0].numel()
            elif name == "indices_and_ranktable_of":
                got = real[name](*a, **k)
                want = compact._ranktable_plain(*a, **k)
                ok = all(torch.equal(torch.as_tensor(x), torch.as_tensor(y))
                         for x, y in zip(got, want))
                what = "B5 on %d slots" % a[0].numel()
            else:
                sdf, X, Y, Z, tiles, tile, dt = a[:7]
                live = k.get("live")
                vk, ck = real[name](*a, **k)
                if name == "eval_tiles_and_classify_batched":
                    pv, pc = eval_classify._plain_tiles(sdf, X, Y, Z, tiles,
                                                        tile, dt, live)
                    what = "B6"
                else:
                    rows = eval_classify._rows_evaluated(len(tiles), live)
                    fields = hybrid.record_tiles(
                        sdf, *eval_classify._axes(X, Y, Z, dt, tiles.device),
                        tiles[:rows], tile)
                    pv, pc = eval_classify._plain_tiles(
                        hybrid.to_kernel_tree(sdf), X, Y, Z, tiles, tile, dt,
                        live, clamp=False, fields=fields)
                    what = "B7 (%d fields)" % len(fields)
                ok = same(vk, pv) and torch.equal(ck, pc)
                what += " on %d tile rows, live=%s" % (len(tiles), live)
            held.append((label, what, bool(ok)))
            torch.cuda.synchronize()
        out["held"] = held
        del seen
    say("kernel launches of rank 0 held against their plain versions")

    # 4. extract_sharded at 162^3, both dtypes, lewiner: a first call (it
    # uploads the emit's tables), then one whose forward's host reads are
    # counted with PyTorch's sync check: the warnings raised from the
    # port's own lines (the waits of gloo's collectives happen on its
    # worker threads and raise none here).
    bounds, res = sharded_dm_grid(sp)
    port = os.sep + "sdf_torch" + os.sep
    real_extract = diffmesh.extract_sharded
    for dt in (torch.float32, torch.float64):
        timed("extract_sharded %s first" % dt, lambda: extract_grads(
            sp, diffmesh, node_mod, dt, dev, bounds, res, mesh))
        syncs = []

        def counted(*a, **k):
            torch.cuda.synchronize()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    return real_extract(*a, **k)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
                    syncs.extend("%s:%d" % (w.filename, w.lineno)
                                 for w in caught
                                 if "synchroniz" in str(w.message)
                                 and port in w.filename)

        diffmesh.extract_sharded = counted
        try:
            got = timed("extract_sharded %s" % dt, lambda: extract_grads(
                sp, diffmesh, node_mod, dt, dev, bounds, res, mesh))
        finally:
            diffmesh.extract_sharded = real_extract
        flat = torch.cat([g.reshape(-1) for g in got[2]]).numpy()
        every = multihost.all_gather_host(flat, group)
        if lead:
            out[("extract", dt)] = got + (syncs, bool(
                (every == every[0]).all()))
    say("extract_sharded run")

    # 5. fit(mesh=) on fit_sphere.py's points: the first step, then 300.
    pts = fit_points()
    node, loss0 = fit_mod.fit(sp.sphere(0.5), example(sp), pts, steps=1,
                              lr=0.05, mesh=mesh, device=dev)
    first = [w.detach().cpu() for w in node_mod.tree_leaves(node)]
    node, loss = timed("fit 300 steps", lambda: fit_mod.fit(
        sp.sphere(0.5), example(sp), pts, steps=300, lr=0.05, mesh=mesh,
        device=dev))
    leaves = np.concatenate([w.detach().cpu().numpy().reshape(-1)
                             for w in node_mod.tree_leaves(node)])
    every = multihost.all_gather_host(leaves, group)
    node_c, closs = fit_mod.fit_chamfer(
        sp.sphere(1.0), chamfer_cloud(), CHAMFER_BOUNDS, steps=1, lr=0.05,
        resolution=20, dtype=torch.float64, mesh=mesh, device=dev)
    if lead:
        out["fit"] = (loss0, first, loss, leaves, bool(
            (every == every[0]).all()))
        out["chamfer"] = (closs, float(node_mod.tree_leaves(node_c)[-1].detach()))
    say("fit(mesh=) and fit_chamfer(mesh=) run")

    keys = list(out["walls"])
    walls = multihost.all_gather_host(
        np.asarray([out["walls"][k] for k in keys]), group)
    if lead:
        out["walls"] = (keys, walls)
        with open(os.path.join(work, "results.pkl"), "wb") as fp:
            pickle.dump(out, fp)
    dist.destroy_process_group()


def sharded_dm_grid(sp):
    """Phase 16's grid: generate()'s 2**22 grid of the example (162^3)."""
    import torch

    axes = grid_axes(example(sp), DM_SAMPLES, torch.float32)
    return ((tuple(float(a[0]) for a in axes),
             tuple(float(a[-1]) for a in axes)), tuple(len(a) for a in axes))


def sharded_phase(dev, kernels):
    """Phase 20: four gloo ranks on the one card.  Adds each kernel's
    launches on rank 0 in the full-width runs to ``kernels`` as
    ``sharded_launches``."""
    import pickle
    import shutil

    import numpy as np
    import torch
    import torch.multiprocessing as mp

    import sdf_torch as sp
    from sdf_torch import _build, parallel
    from sdf_torch.core import eval_classify, hybrid, mc33
    from sdf_torch.models import zoo

    print("== phase 20: %d ranks of gloo on the one card (device='cuda'): "
          "the certificate, z slabs and the tile list at full width, "
          "extract_sharded, fit(mesh=)" % SHARDED_RANKS, flush=True)
    print("  NCCL did not run: this machine has one card, and NCCL refuses "
          "two ranks on one device; the collectives are gloo's")
    t0 = time.time()
    libs = _build.build_many(sharded_sources(sp, zoo, _build, eval_classify,
                                             hybrid, mc33))
    print("  %d libraries ready in %.1f s" % (len(set(libs)),
                                             time.time() - t0))
    t0 = time.time()
    ref = sharded_reference(dev)
    print("  single-device references on the card in %.1f s"
          % (time.time() - t0), flush=True)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    work = os.path.abspath(os.path.join("build", "chip_smoke", "sharded"))
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    t0 = time.time()
    ctx = mp.start_processes(sharded_rank,
                             args=(SHARDED_RANKS, work, dev.type),
                             nprocs=SHARDED_RANKS, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + SHARDED_TIMEOUT_S
    while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise RuntimeError("phase 20: the ranks did not finish in %d s"
                               % SHARDED_TIMEOUT_S)
    print("  ranks done in %.1f s (spawn included)" % (time.time() - t0))
    with open(os.path.join(work, "results.pkl"), "rb") as fp:
        got = pickle.load(fp)

    # 1. The certificate.
    for variant in ("lewiner", "default"):
        for name in ("slabs", "tiles"):
            full, one = got[("cert", name, variant)]
            h = raw_hash(full)
            check(len(full) == len(one) == 3 * TRIS_CERT
                  and raw_hash(one) == h,
                  "certificate %s %s: %d triangles, %d ranks bit-equal to "
                  "1; sha256 %s (the JAX package's %s…: %s)"
                  % (name, variant, len(full) // 3, SHARDED_RANKS, h,
                     CERT_SOUP[:8],
                     "equal" if h == CERT_SOUP else "differs"))
            if h != CERT_SOUP:
                cpu, _ = parallel.mesh_and_march(
                    example(sp), *(np.arange(-1.2, 1.2, 0.15),) * 3,
                    np.zeros((1, 1, 1), bool), 32, None, torch.float32,
                    "cpu", variant=variant)
                a = full.reshape(-1, 9)
                b = cpu.reshape(-1, 9)
                d = np.abs(a[np.lexsort(a.T[::-1])]
                           - b[np.lexsort(b.T[::-1])]).max()
                check(d <= 8 * np.finfo(np.float32).eps * np.abs(b).max(),
                      "largest vertex difference from the device='cpu' run "
                      "(whose sha256 is the JAX package's on the CPU): %g"
                      % d)

    # 2-3. The full-width runs against the single-device runs on the card.
    pins = {"example 2^22 f32 lewiner": TRIS_2P22,
            "example 2^22 f32 fast": TRIS_2P22,
            "example 2^24 f64 lewiner": TRIS_2P24,
            "example 2^24 f64 fast": TRIS_2P24,
            "blobby 2^26 tiles": TRIS_BLOBBY_2P26}
    sums = np.zeros(len(SHARDED_KERNELS), np.int64)
    for label, (n, h, rh, local, every, want) in (
            (k, got[k]) for k in sharded_runs(sp, zoo)):
        rn, rraw, rround = ref[label]
        check(n == rn == pins.get(label, rn) and h == rraw,
              "%s: %d triangles over %d ranks, canonical soup bit-equal to "
              "the single-device run on the card (%d)" % (label, n,
                                                          SHARDED_RANKS, rn))
        if "2^24" in label:
            check(rh == SOUP_2P24, "%s: canonical soup sha256 %s… (the pin "
                  "of tests/test_topology_2p24.py)" % (label, rh[:8]))
        check(all(list(r) == want for r in every),
              "%s: every rank launched %s (B1, B2, B3, B4, B5, B6, B7, B1 "
              "with fields)" % (label, want))
        sums += np.asarray(got["launches"][label])
    for k, c in zip(SHARDED_KERNELS, sums):
        check(c > 0, "%s launched on rank 0 in phase 20's full-width runs "
              "(%d)" % (k, c))
        if k in kernels:
            kernels[k]["sharded_launches"] = int(c)
    for label, what, ok in got["held"]:
        check(ok, "%s, rank 0: %s bit-equal to its plain version on the "
              "same input" % (label, what))

    # 4. extract_sharded.
    for dt in (torch.float32, torch.float64):
        h, n, grads, syncs, same = got[("extract", dt)]
        rh, rn, rgrads = ref[("extract", dt)]
        check(n == rn == TRIS_2P22 and h == rh and same,
              "extract_sharded %s at 162^3: %d triangles, valid rows "
              "bit-equal to extract's as a set, the same gradients on every "
              "rank" % (dt, n))
        if dt == torch.float64:
            ok = all(torch.allclose(a, b, rtol=1e-9, atol=1e-15)
                     for a, b in zip(grads, rgrads))
            tol = "rtol 1e-9"
        else:
            top = max(float(b.abs().max()) for b in rgrads)
            ok = all(float((a - b).abs().max()) <= 1e-3 * top
                     for a, b in zip(grads, rgrads))
            tol = "1e-3 of the largest (%.4g)" % top
        err = max(float((a - b).abs().max()) for a, b in zip(grads, rgrads))
        check(ok, "extract_sharded %s: leaf gradients within %s of "
              "extract's (max |diff| %.3g)" % (dt, tol, err))
        check(len(syncs) == 1, "extract_sharded %s: the forward's own code "
              "reads the host %d time(s) (%s)"
              % (dt, len(syncs), ", ".join(syncs)))

    # 5. fit(mesh=) and fit_chamfer(mesh=).
    loss0, first, loss, leaves, same = got["fit"]
    rloss, rleaves = ref["fit"]
    check(np.isclose(loss0, rloss, rtol=1e-5) and all(
        torch.allclose(a, b, rtol=1e-5, atol=1e-7)
        for a, b in zip(first, rleaves)),
        "fit(mesh=) first step: loss %.6g and leaves equal fit_step's "
        "(%.6g) within rtol 1e-5" % (loss0, rloss))
    check(loss < loss0 and same, "fit(mesh=): the loss falls to %.6g in 300 "
          "steps; every rank holds the same leaves" % loss)
    closs, cr = got["chamfer"]
    rcloss, rcr = ref["chamfer"]
    check(np.isclose(closs, rcloss, rtol=1e-9) and np.isclose(cr, rcr,
                                                               rtol=1e-9),
          "fit_chamfer(mesh=) one step at resolution 20: loss %.6g, radius "
          "%.6f equal to the single-device step's within rtol 1e-9"
          % (closs, cr))

    keys, walls = got["walls"]
    print("  wall seconds per rank (%d ranks time-sharing one H100; not a "
          "scaling number):" % SHARDED_RANKS)
    for i, k in enumerate(keys):
        print("    %-28s %s" % (k, " ".join("%.4f" % w for w in walls[:, i])))
    print("  card: %s" % card_line())


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
    if "--tile-sweep" in sys.argv[1:]:
        return tile_sweep(dev)
    if "--sharded" in sys.argv[1:]:
        sharded_phase(dev, {})
        print(card_line())
        return 0
    if "--diffmesh" in sys.argv[1:]:
        _build.build_many([("ntri", _build.source("ntri.cu")),
                           ("compact", _build.source("compact.cu")),
                           ("classify_ext", mc33.kernel_source())])
        diffmesh_phases(dev, {k: {} for k in ("classify_ext", "ntri",
                                              "indices_of")})
        print(card_line())
        return 0
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

    def tiles_bound(vols, nf, ops_pt, name, rows=None):
        """B6/B7's bound: every row's volume and cases written, ``nf``
        fields read, and the samples and cells of ``rows`` rows computed
        once each (default every row; with live, the evaluated ones)."""
        ntc, TS = vols.shape[0], vols.shape[1]
        rows = ntc if rows is None else rows
        nbytes = vols.numel() * vols.element_size() + rows * TS ** 3 * nf \
            * vols.element_size() + ntc * (TS - 1) ** 3 * 4 + ntc * 12
        return bound_ms(nbytes, ops_pt * rows * TS ** 3
                        + 16 * rows * (TS - 1) ** 3, name)

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

    # Each list the path builds, each with live (the count of live rows:
    # the kernel evaluates one padded row and copies it) and without, in
    # both dtypes; then tiles 1 (the surface cells), 33, 64, 65 and 203
    # (more than 48 KB of shared memory a block) on the example's grid.
    tile_cases = [
        ("blobby 2^26", blobby, 2**26, 32, None, True),
        ("example 2^22", f, 2**22, 32, None, True),
        ("example 2^22", f, 2**22, 8, None, True),
        ("example 2^22, a list of one", f, 2**22, 32, 1, False),
    ] + [("example 2^22", f, 2**22, t, None, True)
         for t in (1, 33, 64, 65, 203)]
    for label, g, samples, tile, first, pad in tile_cases:
        axes = grid_axes(g, samples, torch.float32)
        if tile == 1:
            tiles, nt = surface_cells(g, axes, torch.float32, dev)
        else:
            tiles, nt = kept_tiles(g, axes, tile, torch.float32, dev, pad)
        if first:
            tiles, nt = tiles[nt - first: nt].contiguous(), first
        ops_pt = body_op_count(eval_classify.tile_kernel_source(g))
        rows = min(nt + 1, len(tiles))
        S, nblk, csize, smem = eval_classify.tile_plan(tile, rows, card_sms())
        evals = eval_classify.tile_evaluations(tile, rows, card_sms())
        print("  B6/B7 plan at tile %d: %d blocks a row of %d samples, "
              "clusters of %d, %d B of shared memory a block; %.4f "
              "evaluations a sample; %s: %d rows, %d live, %d evaluated, %d "
              "blocks" % (tile, nblk, S, csize, smem,
                          evals / (tile + 1) ** 3, label, len(tiles), nt,
                          rows, rows * nblk))
        for dt in (torch.float32, torch.float64):
            name = str(dt).split(".")[1]
            vp = eval_classify._eval_tiles(g, *axes, tiles, tile, dt)
            cp = mc._cell_cases(vp)
            for live in (None, nt):
                vk, ck = b6(g, *axes, tiles, tile, dt, live=live)
                v7, c7 = b7(g, *padded(axes, tile), tiles, tile, dt, live=live)
                check(same_bits(vk, vp) and torch.equal(ck, cp),
                      "B6 %s tile %d %s live=%s: %d tiles (%d live) vols and "
                      "cases bit-equal to plain" % (label, tile, name, live,
                                                    len(tiles), nt))
                check(same_bits(v7, vk) and torch.equal(c7, ck),
                      "B7 without fields equal to B6 (%s tile %d %s live=%s)"
                      % (label, tile, name, live))
                del v7, c7
            if label != "blobby 2^26":
                del vk, ck, vp, cp
                continue
            err = max_abs_diff([(vk, vp), (ck, cp)])
            # ms: live=nt, what the routed run launches; ms_all_rows: every
            # padded row evaluated, the work of the kernel before live.
            ms = device_ms(lambda: b6(g, *axes, tiles, tile, dt, live=nt))
            kms = device_ms(lambda: b6(g, *axes, tiles, tile, dt, live=nt),
                            match="eval_tiles")
            ms_all = device_ms(lambda: b6(g, *axes, tiles, tile, dt))
            ms7 = device_ms(lambda: b7(g, *padded(axes, tile), tiles, tile, dt,
                                       live=nt))
            pms = device_ms(lambda: (
                mc._cell_cases(eval_classify._eval_tiles(
                    g, *axes, tiles, tile, dt))), reps=3, warm=1)
            b, by = tiles_bound(vk, 0, ops_pt, name, rows)
            b_all, by_all = tiles_bound(vk, 0, ops_pt, name)
            print("  B6 %s %s: %d tiles, %d evaluated: kernel_ms %.4f (the "
                  "kernel %.4f, the padded rows' copies the rest; every row "
                  "%.4f; B7 without fields %.4f) plain_ms %.4f bound_ms %.4f "
                  "(%s; %d ops/point; every row %.4f %s) max_abs_err %g"
                  % (label, name, len(tiles), rows, ms, kms, ms_all, ms7,
                     pms, b, by, ops_pt, b_all, by_all, err))
            hold_tile_shapes(vk, ck, tiles, nt, axes, tile, name,
                             dt == torch.float32)
            if dt == torch.float32:
                kernels["eval_tiles_batched"] = dict(
                    name="eval_tiles_batched", route="cuda",
                    source="sdf_torch/csrc/eval_tiles.cu",
                    replaces="sdf_tpu/core/pallas_eval.py:262",
                    max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=b,
                    bound_by=by, library_ms=None, kernel_only_ms=kms,
                    ms_all_rows=ms_all,
                )
            del vk, ck, vp, cp

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
    # evaluated whole with torch ops; with live (the pre-pass records the
    # evaluated rows only) and without.
    for gname, g in gathers.items():
        axes = grid_axes(g, 2**22, torch.float32, GATHER_BOUNDS)
        tiles, nt = kept_tiles(g, axes, 32, torch.float32, dev)
        rows = min(nt + 1, len(tiles))
        pax = padded(axes, 32)
        tree = hybrid.to_kernel_tree(g)
        nf = gather_nf[gname]
        ops_pt = body_op_count(eval_classify.tile_kernel_source(tree, nf))
        for dt in (torch.float32, torch.float64):
            name = str(dt).split(".")[1]
            fields = hybrid.record_tiles(
                g, *eval_classify._axes(*pax, dt, dev), tiles, 32)
            check(len(fields) == nf, "%s records %d field(s)" % (gname, nf))
            vp = eval_classify._eval_tiles(tree, *pax, tiles, 32, dt,
                                           clamp=False, fields=fields)
            whole = eval_classify._eval_tiles(g, *pax, tiles, 32, dt,
                                              clamp=False)
            cp = mc._cell_cases(vp)
            for live in (None, nt):
                vk, ck = b7(g, *pax, tiles, 32, dt, live=live)
                check(same_bits(vk, vp) and torch.equal(ck, cp)
                      and same_bits(vk, whole),
                      "B7 %s %s live=%s: %d tiles (%d live), %d field(s), "
                      "bit-equal to plain and to the whole expression"
                      % (gname, name, live, len(tiles), nt, nf))
            if gname != "rotated":
                del vk, ck
                continue
            err = max_abs_diff([(vk, vp), (ck, cp)])
            # ms is the wrapper the path calls (live=nt): the torch pre-pass
            # that records the fields of the evaluated rows, then the
            # kernel.  plain_ms is the same function with torch ops only
            # (the whole expression on the tile windows, then the cases).
            # Beside them the pre-pass and the kernel alone, launched on
            # fields recorded once, with and without live.
            ms = device_ms(lambda: b7(g, *pax, tiles, 32, dt, live=nt))
            ms_all = device_ms(lambda: b7(g, *pax, tiles, 32, dt))
            pms = device_ms(lambda: mc._cell_cases(eval_classify._eval_tiles(
                g, *pax, tiles, 32, dt, clamp=False)), reps=3, warm=1)
            live_fields = tuple(fl[:rows] for fl in fields)
            kms = device_ms(lambda: eval_classify._launch_tiles(
                tree, *pax, tiles, 32, dt, nt, live_fields, b7))
            kms_all = device_ms(lambda: eval_classify._launch_tiles(
                tree, *pax, tiles, 32, dt, None, fields, b7))
            rms = device_ms(lambda: hybrid.record_tiles(
                g, *eval_classify._axes(*pax, dt, dev), tiles[:rows], 32),
                reps=3, warm=1)
            rms_all = device_ms(lambda: hybrid.record_tiles(
                g, *eval_classify._axes(*pax, dt, dev), tiles, 32),
                reps=3, warm=1)
            b, by = tiles_bound(vk, 0, ops_pt, name, rows)
            b_all, _ = tiles_bound(vk, 0, ops_pt, name)
            print("  B7 %s %s: %d tiles, %d evaluated: wrapper_ms %.4f "
                  "(pre-pass %.4f + kernel %.4f); every row %.4f (%.4f + "
                  "%.4f) plain_ms %.4f bound_ms %.4f (%s; every row %.4f; %d "
                  "ops/point in the kernel body; the fields are the "
                  "wrapper's own, so the bound counts no field bytes) "
                  "max_abs_err %g" % (gname, name, len(tiles), rows, ms, rms,
                                      kms, ms_all, rms_all, kms_all, pms, b,
                                      by, b_all, ops_pt, err))
            if dt == torch.float32:
                kernels["eval_tiles"] = dict(
                    name="eval_tiles", route="cuda",
                    source="sdf_torch/csrc/eval_tiles.cu",
                    replaces="sdf_tpu/core/pallas_eval.py:163",
                    max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=b,
                    bound_by=by, library_ms=None, prepass_ms=rms,
                    kernel_only_ms=kms, ms_all_rows=ms_all,
                    prepass_ms_all_rows=rms_all,
                    kernel_only_ms_all_rows=kms_all,
                )
            del vk, ck, live_fields
        del vp, cp, whole, fields

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

    diffmesh_phases(dev, kernels)
    sharded_phase(dev, kernels)

    # -- result ------------------------------------------------------------------
    order = dense_path + ["eval_tiles_batched", "eval_tiles",
                          "eval_classify_fields"]
    keys = ["name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"]
    more = ["sharded_launches", "diffmesh_launches", "routed_launches", "routed_dense_pass", "tiles_path", "prepass_ms",
            "kernel_only_ms", "nf", "nf4", "ms_all_rows", "prepass_ms_all_rows",
            "kernel_only_ms_all_rows"]
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
