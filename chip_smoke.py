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
     then the bounds refinement on the card: every round of every zoo
     model's refinement in both dtypes, the probe kernel's volume (P4,
     bounds_probe_kernel in B1's library) bit-equal to the plain torch
     evaluation of the same grid on the card and the bounds bit-equal to
     the CPU refinement's; knurling's and blobby's generate() at 2**22
     with the memos emptied, the probe launched once a round, no B1
     launch and one host wait a round beyond the bounds-memo hit, the
     memoized bounds equal to the CPU's; P4 timed on a knurling round
     with CUDA events;
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
     card and are no scaling number.  NCCL does not run: one card;
 21. the lewiner table builder: kernel L1 (csrc/label3d.cu, batched 3D
     connected-component labelling of a sampled trilinear's two sign
     classes) bit-equal to its plain version and, at the corners, to
     scipy.ndimage.label on the host, at n=64 with B=9 (a bucket), n=128
     with B=9 and n=512 with B=1, with the kernel's, the plain version's
     and scipy's times; the bucket keys of five cases on the card equal to
     the CPU's; then build_tables() at the tool's settings (120,000
     realizations a case, 9 picks a bucket, n=64, seed 7) on the card,
     its seven arrays equal to sdf_torch/core/mc33_tables.npz, with its
     wall, L1's launches and the realizations labelled per n; whether the
     written npz is byte-equal to the shipped file is printed, not
     required; and the build once more under torch.profiler: the card's
     busy time and idle share, L1's share of it.
 22. the elementwise forms of the eval kernels' body: every op, operator
     and method the recorder gives a form beyond the first twelve (tanh,
     exp, log, ..., hypot, remainder, floor_divide, lerp, %, //, 2 ** t,
     the number exponents of ** and torch.pow, t.tanh()) through B1 and
     B6 on a grid of wide-spread and special values, in float32 and
     float64, and the general powers (a form in float32 only), each
     bit-equal to its plain version (volume and case); the library's pow
     against torch.pow on 2**20 seeded inputs, equal in float32, its
     float64 ulp gap printed; C4's models op(x*x+y*y+z*z) - 0.5 in +-2
     for tanh, atan and exp(-t): 1,304 / 1,304 / 1,640 triangles at 2**15
     (the reference's), then 2**22 float32 at the defaults and with
     sparse="tiles" and 2**24 float64, each with counts within a stated
     tolerance of the device="cpu" run and a soup bit-equal to the run
     with B1/B6/B7 replaced by their plain versions on the card; an erf
     model and a t.where(c, y) model (no form: hybrid.route_fields makes
     each a field) with sparse=False (B1 once, one field) and "tiles" (B7
     once), LAST_STATS naming the op, soups bit-equal to the plain
     versions'; an eased in_out_quart model at 2**22, its power in B1's
     body in float32 and a field in float64, timed against B1 with op_pow
     in its float64 body; and enable_compile_cache: B1 built once in a
     temporary directory, then the default restored.
 23. the measurement layer: the probe kernels (csrc/probes.cu: the mul-add
     chain, the sqrt chain, the copy) bit-equal to their plain versions on
     the example's 2**22 axes and, the copy, on a seeded 1 GiB buffer and a
     misaligned view of it; utils.weather.probe_rates on the card beside
     the card line, each rate under 105% of the data sheet's (3.35 TB/s
     for the copy, 67 TFLOP/s for the mul-add); tools/roofline_torch.py
     at 2**26 (its JSON line), beside B1's kernel time on that grid; tools/profile_emit_torch.py at 2**22 (every sub-phase timed, B4
     and B5 launched, a sub-phase that waits for the host named); and
     engine.PROFILE with sparse.PROFILE on the example at 2**22 and on
     knurling at 2**26, both at the defaults: device, d2h, d2h_bytes and
     decode (warm, best of two), the soup bit-equal to the run without
     PROFILE, d2h_bytes the mesh arrays' bytes, and exactly one more host
     wait on the dense path.  Then the mesh decode (kernel D1): knurling
     and blobby at 2**26 at the benchmark's settings, warm, D1 launched
     once a call and its buffer bit-equal to the numpy decode of the
     packed emit, to the plain route on the card and to the returned
     mesh.  Phase 23 times its kernels with CUDA events behind queued L2
     flushes (``event_ms``), not torch.profiler.
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
extract; the entries of B1-B7 carry ``sharded_launches``, their launches
on rank 0 in phase 20's full-width runs; L1's entry, at n=64 and B=9,
carries its other shapes, scipy's host ms in place of a library call, the
build's wall and the realizations labelled per n; the three probes'
entries, at the shapes of phase 23's roofline run, carry that ``shape``,
their launches in that run, and for the copy ``torch.add``'s time as the
library call; the bounds probe's entry, P4, at a float32 16^3 round of
knurling's refinement, carries that ``shape``, its launches in knurling's
cold generate(), and the host's wall for the round on the card and on the
CPU; D1's entry, on knurling's 2**26 emit, carries that ``shape``, blobby's
tiles as ``tiles_*`` and the host's readback of both meshes), the card
line again, and last
the result line.  Any failed check raises, and the script exits non-zero
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

``python3 chip_smoke.py --elementwise`` builds phase 22's libraries and runs
phase 22 alone.

``python3 chip_smoke.py --measure`` builds phase 23's libraries, runs
phase 23 alone and prints the probes' entries of the kernels line.

``python3 chip_smoke.py --decode`` runs phase 23's mesh decode alone and
prints D1's entry of the kernels line.

``python3 chip_smoke.py --bounds`` runs phase 6's bounds refinement alone
(it builds its own libraries) and prints the probe's entry of the kernels
line.

``python3 chip_smoke.py --diffmesh`` builds kernels B2, B3 and B4 and runs
phases 16 to 19 alone (a few minutes shorter than the whole script).

``python3 chip_smoke.py --sharded`` builds the libraries phase 20 needs and
runs phase 20 alone.

``python3 chip_smoke.py --tables`` builds kernel L1 and runs phase 21
alone.

``python3 chip_smoke.py --slab-sweep`` times kernel B1 with its slab
length forced to each of a range of values, on the example's 2**22 grid
and blobby's 2**26 grid in both dtypes, and kernel B2 with its slab length
forced, on those grids and on 512 tile volumes; each run is held
bit-equal to the default plan's output.
"""

import contextlib
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
    ``match``, of those whose name holds it only.  Phases 1-22 time with
    it: their wrappers launch several kernels with host work between them
    (a pre-pass, a memset, a plan), which a span of CUDA events
    (``event_ms``) would count, and ``match`` picks one kernel of a call.
    The profiler on the
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


def event_ms(fn, reps=10, warm=2, lead=16):
    """Device ms per call of ``fn`` by CUDA events, each call after an L2
    flush: ``lead`` flushes queued ahead of the start event keep the card
    busy while the host prepares the call, so the events span the call's
    device work (every kernel, copy and memset of it, and any host gap
    longer than the queued flushes).  Phase 23 times with it: it runs
    last, and there, late in a long process, torch.profiler has dropped
    every event of a timed call in four profiles.  It times the probe
    kernels there (one launch a call), their plain versions and
    ``torch.add`` (device-bound chains of torch ops) and, labelled as a
    call's device span, B1's call; the kernels line marks its entries with
    ``"timing": "events"``."""
    import torch

    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        for _ in range(lead):
            _flush_l2()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.fmean(times)


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


# -- phase 21: the lewiner table builder ---------------------------------------

# The table builder's settings in tools/build_mc33_tables_torch.py.
TABLE_SETTINGS = dict(samples_per_case=120_000, reps_per_bucket=9,
                      oracle_n=64, seed=7)
# Kernel L1's resolutions: the builder's n and each escalation up to the
# ceiling; label_shapes() gives each the batch the build launches there.
LABEL_NS = (64, 128, 256, 512)
# float64 operations a voxel of trilinear_eval's sum that depend on all
# three indices (five sums and the last product; the terms of one axis or
# one plane hoisted out): L1's least arithmetic.
LABEL_OPS_PER_VOXEL = 6
# L1's four kernels (csrc/label3d.cu), as the profiler names them.
LABEL_KERNELS = ("eval_kernel", "init_kernel", "merge_kernel",
                 "compress_kernel")


def label_shapes(mb):
    """(n, B) for each of LABEL_NS: a bucket's picks, cut as
    _corner_labels cuts them into launches of at most LAUNCH_VOXELS."""
    reps = TABLE_SETTINGS["reps_per_bucket"]
    return [(n, min(reps, max(1, mb.LAUNCH_VOXELS // n ** 3)))
            for n in LABEL_NS]


def scipy_corner_labels(mb, v, n):
    """The JAX package's host oracle on realization ``v`` at n (numpy's
    meshgrid and trilinear_eval, scipy.ndimage.label on f < 0 and on
    f >= 0), read at the 8 corners: (class bits, labels of the corner's
    own class, negated for f >= 0).  Returns them and the host ms."""
    import numpy as np
    from scipy import ndimage

    t0 = time.perf_counter()
    k = mb.trilinear_coeffs(v)
    t = np.linspace(0.0, 1.0, n)
    x, y, z = np.meshgrid(t, t, t, indexing="ij")
    f = mb.trilinear_eval(k, x, y, z)
    del x, y, z
    lab_in, _ = ndimage.label(f < 0)
    lab_out, _ = ndimage.label(f >= 0)
    ms = (time.perf_counter() - t0) * 1e3
    at = mb._corner_index(n)
    cls = (f.reshape(-1)[at] < 0).astype(np.uint8)
    lab = np.where(cls == 1, lab_in.reshape(-1)[at],
                   -lab_out.reshape(-1)[at])  # the two numberings apart
    return cls, lab, ms


def same_partition(a, b):
    """True iff labels ``a`` and ``b`` (8 corners) group them alike."""
    return all((a[i] == a[j]) == (b[i] == b[j])
               for i in range(8) for j in range(8))


def table_builder_phase(dev, kernels):
    """Phase 21: kernel L1 against its plain version and scipy, then
    build_tables() at the tool's settings on the card against the shipped
    mc33_tables.npz.  Adds L1's entry to ``kernels``."""
    import tempfile

    import numpy as np
    import torch

    from sdf_torch.core import mc33, mc33_build as mb

    print("== phase 21: the lewiner table builder: kernel L1, then "
          "build_tables%s on the card" % (tuple(TABLE_SETTINGS.values()),),
          flush=True)
    rng = np.random.default_rng(21)
    rows, err = [], 0.0
    for n, nb in label_shapes(mb):
        # realizations of cases with ambiguous faces and tunnels
        v = np.concatenate([mb.sample_realizations(c, nb, rng)
                            for c in (105, 90, 165)])[:nb]
        k = torch.from_numpy(mb.trilinear_coeffs(v)).to(dev)
        t = torch.from_numpy(np.linspace(0.0, 1.0, n)).to(dev)
        got = mb.label_corners(k, t)
        want = mb._label_corners_plain(k, t)
        torch.cuda.synchronize()
        check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
              "L1 at n=%d, B=%d: corner classes and labels bit-equal to "
              "the plain version" % (n, nb))
        err = max(err, max_abs_diff([(got[1], want[1])]))
        host = [scipy_corner_labels(mb, vi, n) for vi in v]
        gc, gl = got[0].cpu().numpy(), got[1].cpu().numpy()
        check(all(np.array_equal(gc[b], host[b][0])
                  and same_partition(gl[b], host[b][1])
                  for b in range(nb)),
              "L1 at n=%d, B=%d: the corners' classes and components those "
              "of scipy.ndimage.label on the host" % (n, nb))
        ms = device_ms(lambda: mb.label_corners(k, t))
        pms = device_ms(lambda: mb._label_corners_plain(k, t), reps=3,
                        warm=1)
        # in: k (B, 8) and t (n,) float64; out: 8 class bytes and 8 int32
        # labels a realization.  The label volume is this design's
        # workspace, not the function's: its traffic is printed apart.
        b, by = bound_ms(64 * nb + 8 * n + 40 * nb,
                         LABEL_OPS_PER_VOXEL * nb * n ** 3, "float64")
        wb = 4 * nb * n ** 3 / HBM_BYTES_PER_S * 1e3
        sms = sum(h[2] for h in host)
        print("  L1 n=%d B=%d: kernel_ms %.4f plain_ms %.4f bound_ms %.6f "
              "(%s) workspace_bound_ms %.4f scipy_host_ms %.1f"
              % (n, nb, ms, pms, b, by, wb, sms), flush=True)
        rows.append(dict(n=n, B=nb, ms=ms, plain_ms=pms, bound_ms=b,
                         bound_by=by, workspace_bound_ms=wb,
                         scipy_host_ms=sms))
        del got, want, k, t
    torch.cuda.empty_cache()

    # Bucket keys of five cases on the card against the CPU path.
    for case in (5, 23, 90, 105, 165):
        v = mb.sample_realizations(case, TABLE_SETTINGS["samples_per_case"],
                                   np.random.default_rng(case))
        keys = [(mb._facebits_of(v, case, device=d) * 9
                 + mb.interior_bits(v, device=d)).cpu().numpy()
                for d in (dev, "cpu")]
        check(np.array_equal(*keys), "case %d: %d bucket keys on the card "
              "equal to the CPU's (%d buckets)"
              % (case, len(v), len(np.unique(keys[0]))))

    # The main path: the whole build, L1's count set to 0 just before.
    mb.label_corners.launches = 0
    mb.label_corners.labelled = {}
    t0 = time.perf_counter()
    tabs = mb.build_tables(device=dev, **TABLE_SETTINGS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = mb.label_corners.launches
    calls = dict(mb.label_corners.labelled)
    print("  build_tables wall %.3f s, L1 launches %d, realizations "
          "labelled per n %s, conflicted buckets %d"
          % (wall, launches, sorted(calls.items()),
             int((tabs["conflict_rate"] > 0).sum())))
    check(launches > 0, "L1 launched in the build (%d launches)" % launches)
    with np.load(mc33._NPZ) as z:
        shipped = dict(z)
    check(sorted(tabs) == sorted(shipped), "the build's seven arrays")
    for key in sorted(shipped):
        a, w = tabs[key], shipped[key]
        check(a.dtype == w.dtype and a.shape == w.shape
              and np.array_equal(a, w),
              "%s %s %s equal to sdf_torch/core/mc33_tables.npz"
              % (key, a.dtype, a.shape))
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "mc33_tables.npz")
        np.savez_compressed(out, **tabs)
        with open(out, "rb") as fp, open(mc33._NPZ, "rb") as ship:
            same = fp.read() == ship.read()
    print("  the written npz is %sbyte-equal to the shipped file (zlib may "
          "differ between machines; not required)" % ("" if same else "NOT "))
    # Where the build's time goes: the same build again under the profiler.
    pwall, busy, per = timeline(
        lambda: mb.build_tables(device=dev, **TABLE_SETTINGS))
    l1 = sum(ms for name, ms in per.items()
             if any(k in name for k in LABEL_KERNELS))
    print("  profiled build: wall %.3f s, card busy %.1f ms (idle %.2f%%), "
          "L1's four kernels %.1f ms, the rest (keys, copies) %.1f ms"
          % (pwall / 1e3, busy, 100 * (1 - busy / pwall), l1, sum(
              per.values()) - l1))
    first = rows[0]
    kernels["label3d"] = dict(
        name="label3d", route="cuda", source="sdf_torch/csrc/label3d.cu",
        replaces="scipy.ndimage.label (host)", launches=launches,
        max_abs_err=err, ms=first["ms"], plain_ms=first["plain_ms"],
        bound_ms=first["bound_ms"], bound_by=first["bound_by"],
        library_ms=None, workspace_bound_ms=first["workspace_bound_ms"],
        scipy_host_ms=first["scipy_host_ms"], shapes=rows, build_wall_s=wall, build_busy_ms=busy,
        oracle_calls={str(n): c for n, c in sorted(calls.items())},
    )


# -- phase 22: every elementwise form of the eval kernels' body ---------------

# Phase 22's grid for the forms: wide-spread axis values with the special
# ones (signed zeros, halves, integers, the divisors' edges, huge, tiny, and
# on z infinities and NaN); the arguments x * y + z and y - z mix them.
ELEMENTWISE_SPECIAL = [0.0, -0.0, 0.5, -0.5, 1.0, -1.0, 2.0, -2.0, 3.0, -3.0,
                       0.7, -0.7, 1e-3, -1e-3, 1e-30, 88.0, -104.0, 1e20]
ELEMENTWISE_TILE = 8
# C4's model: op(x*x + y*y + z*z) - k at k = 0.5, meshed in +-2.
C4_BOUNDS = ((-2.0, -2.0, -2.0), (2.0, 2.0, 2.0))
C4_TRIS_2P15 = {"tanh": 1304, "atan": 1304, "exp(-t)": 1640}
# Card against device="cpu" at full width: transcendentals differ between
# the CPU's SLEEF and the card's library by an ulp now and then, which can
# flip a sign near the surface; tests/test_torch_elementwise.py states the
# same tolerance for the port against the JAX package.
C4_COUNT_RTOL = 1e-3
C4_COUNT_ATOL = 8


def elementwise_axes(dtype_np, n=(40, 36, 33), seed=22):
    """The axes of phase 22's grid, from a seed."""
    import numpy as np

    rng = np.random.default_rng(seed)
    axes = []
    for k, m in enumerate(n):
        rand = rng.standard_normal(m) * 10.0 ** rng.uniform(-3, 2, m)
        a = np.concatenate([np.roll(ELEMENTWISE_SPECIAL, 5 * k), rand])[:m]
        axes.append(a)
    axes[2][-3:] = [np.inf, -np.inf, np.nan]
    return [a.astype(dtype_np).astype(np.float64) for a in axes]


def elementwise_forms():
    """name -> fn(x, y, z) applying one form of the body, for every op,
    operator and method the recorder gives a C++ form beyond the original
    twelve (and the number exponents of ``**``)."""
    import torch

    t = lambda x, y, z: x * y + z
    u = lambda x, y, z: y - z
    forms = {}
    for name in ("tanh", "exp", "expm1", "log", "log1p", "log2", "tan",
                 "atan", "asin", "acos", "sinh", "cosh", "floor", "ceil",
                 "trunc", "square", "rsqrt", "reciprocal", "exp2", "arctan",
                 "arcsin", "arccos"):
        forms[name] = (lambda x, y, z, f=getattr(torch, name):
                       f(t(x, y, z)))
    for name in ("hypot", "remainder", "floor_divide"):
        forms[name] = (lambda x, y, z, f=getattr(torch, name):
                       f(t(x, y, z), u(x, y, z)))
    forms.update({
        "lerp": lambda x, y, z: torch.lerp(x, y, z),
        "lerp(w=0.3)": lambda x, y, z: torch.lerp(x, y, 0.3),
        "lerp(w=0.7)": lambda x, y, z: torch.lerp(x, y, 0.7),
        "t % 0.7": lambda x, y, z: t(x, y, z) % 0.7,
        "t % -3": lambda x, y, z: t(x, y, z) % -3.0,
        "3 % t": lambda x, y, z: 3.0 % t(x, y, z),
        "t // 0.7": lambda x, y, z: t(x, y, z) // 0.7,
        "t // -3": lambda x, y, z: t(x, y, z) // -3.0,
        "t // 0": lambda x, y, z: t(x, y, z) // 0.0,
        "3 // t": lambda x, y, z: 3.0 // t(x, y, z),
        "2 ** t": lambda x, y, z: 2.0 ** t(x, y, z),
        "1 ** t": lambda x, y, z: 1.0 ** t(x, y, z),
        "t.tanh()": lambda x, y, z: t(x, y, z).tanh(),
        "t.remainder(u)": lambda x, y, z: t(x, y, z).remainder(u(x, y, z)),
    })
    for e in (0, 1, 0.5, -0.5, 2, 3, -1, -2):
        forms["t ** %s" % e] = lambda x, y, z, e=e: t(x, y, z) ** e
        forms["pow(t, %s)" % e] = (lambda x, y, z, e=e:
                                   torch.pow(t(x, y, z), e))
    return forms


def form_model(sp, fn):
    """An SDF3 node whose own function is ``fn(x, y, z)``."""
    return sp.SDF3(lambda q, p, fn=fn: fn(*p), {})


def c4_model(sp, op, k=0.5):
    """C4's model: ``op(x*x + y*y + z*z) - k``, an @sdf3 builder's node."""
    import numpy as np

    @sp.sdf3
    def blob(k=k):
        def fn(q, p):
            x, y, z = p
            return op(x * x + y * y + z * z) - q["k"]

        return fn, {"k": np.float64(k)}

    return blob()


def c4_ops():
    import torch

    return {"tanh": torch.tanh, "atan": torch.atan,
            "exp(-t)": lambda t: torch.exp(-t)}


def erf_route_model(sp):
    """Phase 22 (c): an erf blob (no form: a field) under a rotate, in a
    union with a tanh blob (in the body)."""
    import torch

    return (c4_model(sp, torch.erf).rotate(0.3, sp.X)
            | c4_model(sp, torch.tanh, 0.3).translate((0.8, 0, 0)))


def where_route_model(sp):
    """Phase 22 (c): ``t.where(t > 1, 0.5 t)``, which is ``torch.where(t > 1,
    t, 0.5 t)`` (the method has no form: torch.where takes the tensor
    second), in a union with a tanh blob (in the body)."""
    import torch

    return (c4_model(sp, lambda t: t.where(t > 1, t * 0.5), 0.3)
            | c4_model(sp, torch.tanh, 0.3).translate((0.8, 0, 0)))


ROUTE_MODELS = {"erf": erf_route_model, "where": where_route_model}


def eased_model(sp):
    """Phase 22 (e): a box eased into a sphere along z by in_out_quart,
    whose ``t ** 4`` is a general power (op_pow in a float32 body, a field
    in float64)."""
    return sp.box(1.5).transition_linear(sp.sphere(1.0),
                                         e=sp.ease.in_out_quart)


def clear_route_memos():
    """Empty the route's memos and the engine's, so the next generate()
    tries its expression anew."""
    from sdf_torch.core import engine, hybrid, sparse

    for memo in (hybrid._ROUTE_MEMO, hybrid._ROUTED, engine._BOUNDS_MEMO,
                 engine._COUNTS_MEMO, engine._SKIP_MEMO, sparse._COUNTS_MEMO):
        memo.clear()


class body_pow:
    """Context manager: a general power recorded as ``op_pow`` in the eval
    kernels' body in float64 too (where it is not bit-equal to PyTorch's
    pow); the memos emptied on entry and exit."""

    def __enter__(self):
        from sdf_torch.core import eval_classify as ec

        self.saved = ec.Rec._pow
        ec.Rec._pow = lambda rec, a, b: rec._map("op_pow({}, {})", (a, b),
                                                 "f")
        clear_route_memos()
        return self

    def __exit__(self, *exc):
        from sdf_torch.core import eval_classify as ec

        ec.Rec._pow = self.saved
        clear_route_memos()
        return False


def pow_forms():
    """name -> fn(x, y, z): the general powers, which have a form in a
    float32 body only."""
    import torch

    t = lambda x, y, z: x * y + z
    u = lambda x, y, z: y - z
    return {"t ** 1.5": lambda x, y, z: t(x, y, z) ** 1.5,
            "t ** 4": lambda x, y, z: t(x, y, z) ** 4,
            "t ** -3": lambda x, y, z: t(x, y, z) ** -3,
            "pow(t, u)": lambda x, y, z: torch.pow(t(x, y, z), u(x, y, z)),
            "3 ** t": lambda x, y, z: 3.0 ** t(x, y, z),
            "t.pow(0.25)": lambda x, y, z: t(x, y, z).pow(0.25)}


# The library's pow at a few exponents against torch.pow on the card: equal
# in float32 (where the body has the form), and its ulp gap in float64
# (where a general power routes as a field).
POW_PROBE = {"pow(a, b)": "op_pow(a, b)", "pow(a, 1.5)": "op_pow(a, T(1.5))",
             "pow(a, 4)": "op_pow(a, T(4))", "pow(3, a)": "op_pow(T(3), a)"}


def pow_probe_source():
    """A probe library of the body's ``op_pow`` at the exponents of
    POW_PROBE, one entry a dtype each."""
    from sdf_torch import _build

    out = [_build.source("sdf_point.cuh")
           .replace("//@SDF_BODY@", "  return x;")
           .replace("//@SDF_PARAMS@", "#define SDF_NPARAMS 1\n"
                    "#define SDF_PARAMS_IN_ARGS 1\n#define SDF_NFIELDS 0")]
    for i, form in enumerate(POW_PROBE.values()):
        out.append(
            "template <typename T> __global__ void pow%(i)d(const T* A, "
            "const T* B, T* O, long n) {\n"
            "  long i = blockIdx.x * (long)blockDim.x + threadIdx.x;\n"
            "  if (i < n) { T a = A[i], b = B[i]; (void)b; O[i] = %(f)s; }"
            "\n}\n"
            "extern \"C\" int pow%(i)d_f64(const void* a, const void* b, "
            "void* o, long n) {\n"
            "  pow%(i)d<double><<<(n + 255) / 256, 256>>>((const double*)a, "
            "(const double*)b, (double*)o, n);\n"
            "  return (int)cudaGetLastError();\n}\n"
            "extern \"C\" int pow%(i)d_f32(const void* a, const void* b, "
            "void* o, long n) {\n"
            "  pow%(i)d<float><<<(n + 255) / 256, 256>>>((const float*)a, "
            "(const float*)b, (float*)o, n);\n"
            "  return (int)cudaGetLastError();\n}\n" % dict(i=i, f=form))
    return "\n".join(out)


def elementwise_sources(sp, eval_classify, hybrid):
    """Every kernel library phase 22 loads: B1 and B6/B7 for each form, for
    C4's models, for the general powers and the eased model in float32,
    for the routed models and the eased model routed (float64), and the
    pow probe."""
    import torch

    models = [form_model(sp, fn) for fn in elementwise_forms().values()]
    models += [c4_model(sp, op) for op in c4_ops().values()]
    out = []
    for f in models:
        out += [("eval_classify", eval_classify.kernel_source(f)),
                ("eval_tiles", eval_classify.tile_kernel_source(f))]
    f32 = torch.float32
    for f in [form_model(sp, fn) for fn in pow_forms().values()] + [
            eased_model(sp)]:
        out += [("eval_classify", eval_classify.kernel_source(f, dtype=f32)),
                ("eval_tiles", eval_classify.tile_kernel_source(f,
                                                                dtype=f32))]
    for build in list(ROUTE_MODELS.values()) + [eased_model]:
        tree, _ = hybrid.route_fields(build(sp))
        tree = hybrid.to_kernel_tree(tree)
        out += [("eval_classify", eval_classify.kernel_source(tree, 1)),
                ("eval_tiles", eval_classify.tile_kernel_source(tree, 1))]
    return out + [("pow_probe", pow_probe_source())]


class plain_eval_kernels:
    """Context manager: kernels B1, B6 and B7 replaced by their plain
    versions on the card (the wrappers' counts stay untouched)."""

    def __enter__(self):
        from sdf_torch.core import eval_classify as ec

        self.saved = ec._launch, ec._launch_tiles

        def b1(sdf, X, Y, Z, dtype, device, lx=None, fields=()):
            return ec._eval_classify_plain(sdf, X, Y, Z, dtype, device,
                                           fields)

        def tiles(sdf, X, Y, Z, tiles, tile, dtype, live, fields, counter,
                  blocks=None, csize=None):
            # B6 clamps its indices to the grid; B7's axes are padded.
            return ec._plain_tiles(
                sdf, X, Y, Z, tiles, tile, dtype, live, fields=fields,
                clamp=counter is ec.eval_tiles_and_classify_batched)

        ec._launch, ec._launch_tiles = b1, tiles
        return self

    def __exit__(self, *exc):
        from sdf_torch.core import eval_classify as ec

        ec._launch, ec._launch_tiles = self.saved
        return False


def ulp_gap(a, b):
    """Largest distance in ulps between two float32 or float64 tensors
    (NaN against NaN counts 0) and how many elements differ."""
    import torch

    ints = {torch.float32: torch.int32, torch.float64: torch.int64}[a.dtype]
    ia, ib = a.view(ints).long(), b.view(ints).long()
    key = lambda i: torch.where(i < 0, torch.iinfo(ints).min - i, i)
    diff = (ia != ib) & ~(torch.isnan(a) & torch.isnan(b))
    if not bool(diff.any()):
        return 0, 0
    gap = (key(ia)[diff] - key(ib)[diff]).abs()
    return int(gap.max()), int(diff.sum())


def elementwise_phase(dev, kernels):
    """Phase 22: each elementwise form in B1 and B6 against the plain
    version on the card, C4's models at full width, an erf model through
    the automatic field route (B1 and B7 reading its field), the float64
    gap of pow (off the table), and enable_compile_cache."""
    import ctypes
    import shutil
    import tempfile

    import numpy as np
    import torch

    import sdf_torch as sp
    from sdf_torch import _build
    from sdf_torch.core import engine, eval_classify as ec, hybrid

    print("== phase 22: the elementwise forms of the eval kernels, C4's "
          "models, the automatic field route", flush=True)

    def same_bits(a, b):
        ints = {torch.float32: torch.int32, torch.float64: torch.int64}
        if a.dtype in ints:
            a, b = a.view(ints[a.dtype]), b.view(ints[b.dtype])
        return torch.equal(a, b)

    # (a) every form, B1 and B6, both dtypes, bit-equal with NaN payloads;
    # the general powers in float32
    bad = []
    for dt, nd in ((torch.float32, np.float32), (torch.float64, np.float64)):
        forms = dict(elementwise_forms())
        if dt == torch.float32:
            forms.update(pow_forms())
        X, Y, Z = elementwise_axes(nd)
        shape = [-(-(len(a) - 1) // ELEMENTWISE_TILE) for a in (X, Y, Z)]
        tiles = torch.as_tensor(np.ascontiguousarray(
            np.argwhere(np.ones(shape, bool)), np.int32), device=dev)
        for name, fn in forms.items():
            f = form_model(sp, fn)
            vk, ck = ec.eval_and_classify(f, X, Y, Z, dt, dev)
            vp, cp = ec._eval_classify_plain(f, X, Y, Z, dt, dev)
            tk, tck = ec.eval_tiles_and_classify_batched(
                f, X, Y, Z, tiles, ELEMENTWISE_TILE, dt)
            tp, tcp = ec._plain_tiles(f, X, Y, Z, tiles, ELEMENTWISE_TILE,
                                      dt, None)
            torch.cuda.synchronize()
            for kernel, ok in (
                    ("B1", same_bits(vk, vp) and torch.equal(ck, cp)),
                    ("B6", same_bits(tk, tp) and torch.equal(tck, tcp))):
                if not ok:
                    bad.append("%s %s %s" % (kernel, name,
                                             str(dt).split(".")[1]))
        print("  %s: %d forms through B1 (%d points) and B6 (%d tiles of "
              "%d^3)" % (str(dt).split(".")[1], len(forms), vk.numel(),
                         len(tiles), ELEMENTWISE_TILE + 1), flush=True)
    check(not bad, "every form bit-equal to its plain version in B1 and B6, "
          "volumes and cases, float32 and float64, and the general powers "
          "in float32%s" % ("" if not bad else ": not " + ", ".join(bad)))

    # the library's pow against torch.pow: equal in float32, its float64 gap
    lib = ctypes.CDLL(str(_build.build_many([("pow_probe",
                                              pow_probe_source())])[0]))
    rng = np.random.default_rng(221)
    n = 1 << 20
    A64 = torch.as_tensor(np.abs(rng.standard_normal(n))
                          * 10.0 ** rng.uniform(-3, 3, n), device=dev)
    B64 = torch.as_tensor(rng.uniform(-8, 8, n), device=dev)
    for dt, tag in ((torch.float32, "f32"), (torch.float64, "f64")):
        A, B = A64.to(dt), B64.to(dt)
        want = {"pow(a, b)": lambda: torch.pow(A, B),
                "pow(a, 1.5)": lambda: torch.pow(A, 1.5),
                "pow(a, 4)": lambda: torch.pow(A, 4),
                "pow(3, a)": lambda: torch.pow(3.0, B)}
        for i, (name, form) in enumerate(POW_PROBE.items()):
            arg = B if "(3, a)" in name else A
            out = torch.empty_like(A)
            entry = getattr(lib, "pow%d_%s" % (i, tag))
            entry.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_long]
            _build.check(entry(arg.data_ptr(), B.data_ptr(), out.data_ptr(),
                               n), "pow probe")
            gap, count = ulp_gap(out, want[name]())
            what = ("%s %s (%s): %d of %d differ from torch.pow on the "
                    "card, at most %d ulp" % (str(dt).split(".")[1], name,
                                              form, count, n, gap))
            if dt == torch.float32:
                check(count == 0, "in the body, " + what)
            else:
                print("  a field, " + what)

    # (b) C4's models at full width
    wrappers = {"eval_classify": ec.eval_and_classify,
                "eval_tiles_batched": ec.eval_tiles_and_classify_batched,
                "eval_tiles": ec.eval_tiles_and_classify}

    def drive(f, **kw):
        for w in wrappers.values():
            w.launches = 0
        pts = sp.generate(f, verbose=False, bounds=C4_BOUNDS, **kw)
        torch.cuda.synchronize()
        return pts, {k: w.launches for k, w in wrappers.items()}

    def plain(f, **kw):
        with plain_eval_kernels():
            return sp.generate(f, verbose=False, bounds=C4_BOUNDS, **kw)

    for label, op in c4_ops().items():
        pts, counts = drive(c4_model(sp, op), samples=2**15)
        check(len(pts) // 3 == C4_TRIS_2P15[label]
              and np.array_equal(pts, plain(c4_model(sp, op), samples=2**15)),
              "%s at 2^15: %d triangles (the reference's), soup bit-equal "
              "to the plain B1's" % (label, C4_TRIS_2P15[label]))
        runs = [("2^22 float32 defaults", dict(samples=2**22)),
                ("2^22 float32 sparse='tiles'",
                 dict(samples=2**22, sparse="tiles")),
                ("2^24 float64 defaults",
                 dict(samples=2**24, dtype=torch.float64))]
        for run, kw in runs:
            t0 = time.perf_counter()
            pts, counts = drive(c4_model(sp, op), **kw)
            wall = time.perf_counter() - t0
            st = dict(engine.LAST_STATS)
            kernel = ("eval_tiles_batched" if kw.get("sparse") == "tiles"
                      or "auto_tiles" in st else "eval_classify")
            cpu = sp.generate(c4_model(sp, op), verbose=False, device="cpu",
                              bounds=C4_BOUNDS, **kw)
            n, m = len(pts) // 3, len(cpu) // 3
            print("  %s %s: %d triangles in %.2f s (device='cpu' %d), "
                  "launches %s" % (label, run, n, wall, m, counts))
            check(counts[kernel] == 1 and "field_route_ops" not in st
                  and n > 0 and bool(np.isfinite(pts).all())
                  and abs(n - m) <= max(C4_COUNT_ATOL, C4_COUNT_RTOL * m),
                  "%s %s: %s launched, no field route, counts within "
                  "max(%d, %g x) of device='cpu'" % (
                      label, run, kernel, C4_COUNT_ATOL, C4_COUNT_RTOL))
            check(np.array_equal(pts, plain(c4_model(sp, op), **kw)),
                  "%s %s: soup bit-equal to the run with the plain B1/B6 on "
                  "the card" % (label, run))
            del pts, cpu

    # (c) the erf and where models through the automatic field route
    for op, build in ROUTE_MODELS.items():
        for sparse, kernel in ((False, "eval_classify"),
                               ("tiles", "eval_tiles")):
            pts, counts = drive(build(sp), samples=2**22, sparse=sparse)
            st = dict(engine.LAST_STATS)
            print("  %s route sparse=%r: %d triangles, launches %s, route %s"
                  % (op, sparse, len(pts) // 3, counts,
                     st.get("field_route_ops")))
            others = sum(v for k, v in counts.items() if k != kernel)
            check(counts[kernel] == 1 and others == 0
                  and st.get("field_route_ops") == (op,)
                  and st.get("field_route_nodes") == 1 and len(pts) > 0,
                  "%s model sparse=%r: %s once, reading the %s subtree's one "
                  "field, LAST_STATS names %s" % (op, sparse, kernel, op, op))
            check(np.array_equal(pts, plain(build(sp), samples=2**22,
                                            sparse=sparse)),
                  "%s model sparse=%r: soup bit-equal to the plain version's "
                  "on the card" % (op, sparse))

    # (e) a general power: the eased model at 2^22, op_pow in B1's body in
    # float32; in float64 its node a field (the pre-pass of torch ops, then
    # B1 reading it), against B1 with op_pow in its body (not bit-equal to
    # torch in float64).  Card time of the eval (B1 and its pre-pass) and
    # generate()'s wall, warm
    eased = {}
    for label, dt, ctx in (
            ("float32, body", torch.float32, contextlib.nullcontext()),
            ("float64, route", torch.float64, contextlib.nullcontext()),
            ("float64, op_pow in the body", torch.float64, body_pow())):
        clear_route_memos()
        with ctx:
            f = eased_model(sp)
            tree, ops = hybrid.route_fields(f, dtype=dt)
            X, Y, Z = grid_axes(f, 2**22, dt, bounds=C4_BOUNDS)

            def evaluate(tree=tree, X=X, Y=Y, Z=Z, dt=dt):
                fields = ec.record_fields(tree, X, Y, Z, dt, dev)
                return ec.eval_and_classify(tree, X, Y, Z, dt, dev, fields)

            vol, _ = evaluate()
            ms = device_ms(evaluate, reps=10)
            pts, counts = drive(eased_model(sp), samples=2**22, dtype=dt)
            st = dict(engine.LAST_STATS)
            walls = []
            for _ in range(5):
                t0 = time.perf_counter()
                drive(eased_model(sp), samples=2**22, dtype=dt)
                walls.append(time.perf_counter() - t0)
            eased[label] = (vol, pts)
            print("  eased in_out_quart 2^22 %s: route %s, eval card time "
                  "%.4f ms, generate wall %.4f s (median of 5, warm; %s), "
                  "%d triangles, launches %s" % (
                      label, st.get("field_route_ops"), ms,
                      statistics.median(walls),
                      " ".join("%.4f" % w for w in walls), len(pts) // 3,
                      counts))
            if "op_pow" not in label:
                check(st.get("field_route_ops") == (None if dt ==
                                                    torch.float32
                                                    else ("pow",))
                      and len(pts) > 0 and np.array_equal(
                          pts, plain(eased_model(sp), samples=2**22,
                                     dtype=dt)),
                      "eased model %s: %s, soup bit-equal to the plain "
                      "version's on the card" % (
                          label, "no route" if dt == torch.float32
                          else "LAST_STATS names pow"))
    clear_route_memos()
    gap, count = ulp_gap(eased["float64, op_pow in the body"][0],
                         eased["float64, route"][0])
    print("  eased model float64, op_pow in B1 against the routed field: "
          "%d of %d volume values differ, at most %d ulp; soups equal %s"
          % (count, eased["float64, route"][0].numel(), gap, np.array_equal(
              eased["float64, route"][1],
              eased["float64, op_pow in the body"][1])))
    del eased

    # (d) enable_compile_cache: B1 built once in another directory
    tmp = tempfile.mkdtemp(prefix="sdf_torch_cache.")
    try:
        check(sp.enable_compile_cache(tmp) == _build.BUILD
              and str(_build.BUILD) == tmp, "enable_compile_cache moves "
              "the build directory")
        X = np.linspace(-1.2, 1.2, 40)
        vk, _ = ec.eval_and_classify(example(sp), X, X, X, torch.float32,
                                     dev)
        built = sorted(os.listdir(tmp))
        check(len(built) == 1 and built[0].startswith("eval_classify_")
              and built[0].endswith(".so"),
              "B1 built once there: %s" % built)
    finally:
        sp.enable_compile_cache(None)
        shutil.rmtree(tmp, ignore_errors=True)
    vd, _ = ec.eval_and_classify(example(sp), X, X, X, torch.float32, dev)
    check(_build.BUILD == _build.DEFAULT_BUILD and same_bits(vk, vd),
          "enable_compile_cache(None) restores %s; the two libraries agree"
          % _build.DEFAULT_BUILD)


# -- phase 23: the measurement layer -------------------------------------------

# The probes' replaced XLA fusions and the PROFILE cells: the example model
# at 2**22 and knurling at 2**26 (the JAX bench's decomposition cell,
# bench.py:310-345), both at generate()'s defaults.
PROBE_FUSIONS = {
    "probe_muladd": "sdf_tpu/utils/weather.py:96-102 (XLA fusion `muladd`)",
    "probe_sqrts": "sdf_tpu/utils/weather.py:107-113 (XLA fusion `sqrts`)",
    "probe_copy": "sdf_tpu/utils/weather.py:122 (XLA fusion `v + 1.0`)",
}
PROFILE_CELLS = (("example 2^22", 2**22), ("knurling 2^26", 2**26))


def load_tool(name):
    """A module of tools/ of this checkout, by file name."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools",
                        name + ".py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def count_waits(fn):
    """``(fn(), host waits)``: the waits PyTorch's sync debug mode reports
    (transfers) plus the explicit ``torch.cuda.synchronize`` calls it does
    not report."""
    import torch

    torch.cuda.synchronize()
    real = torch.cuda.synchronize
    explicit = []
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")

        def counted(*a, **k):
            n0 = len(caught)
            out = real(*a, **k)
            if not any("called a synchronizing" in str(w.message)
                       for w in caught[n0:]):
                explicit.append(1)
            return out

        torch.cuda.synchronize = counted
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize = real
    waits = sum("called a synchronizing" in str(w.message) for w in caught)
    return out, waits + len(explicit)


def mesh_wire_bytes(verts, faces, dtype):
    """The bytes of the mesh transfer on the card for a mesh of
    ``len(verts)`` unique vertices and ``len(faces)`` triangles: float32
    meshes come decoded by kernel D1 (float64 vertices and int32 faces in
    one buffer padded to 8 bytes, ``mc.mesh_layout``), float64 ones as
    float64 vertices and int32 faces."""
    from sdf_torch.core import mc

    ne, n = len(verts), len(faces)
    if dtype == "float32":
        return mc.mesh_layout(ne, n)[1]
    return 24 * ne + 12 * n


def measure_sources(sp, zoo, _build, eval_classify, mc33):
    """Phase 23's libraries: the probes and every kernel of the example's
    and knurling's default runs."""
    return [("probes", _build.source("probes.cu")),
            ("eval_classify", eval_classify.kernel_source(example(sp))),
            ("eval_classify", eval_classify.kernel_source(zoo.knurling())),
            ("eval_tiles", eval_classify.tile_kernel_source(zoo.knurling())),
            ("ntri", _build.source("ntri.cu")),
            ("compact", _build.source("compact.cu")),
            ("classify_ext", mc33.kernel_source()),
            ("decode", _build.source("decode.cu"))]


def measurement_phase(dev, kernels):
    """Phase 23: the probe kernels against their plain versions, the
    session probe rates, tools/roofline_torch.py at 2**26 and
    tools/profile_emit_torch.py at 2**22 on the card, and engine.PROFILE
    with sparse.PROFILE on the example at 2**22 and knurling at 2**26.
    Adds the probes' entries to ``kernels``."""
    import numpy as np
    import torch

    import sdf_torch as sp
    from sdf_torch.core import compact, engine, eval_classify, node, sparse
    from sdf_torch.models import zoo
    from sdf_torch.utils import weather

    print("== phase 23: measurement: the probe kernels, probe_rates, "
          "roofline_torch at 2**26, profile_emit_torch at 2**22, "
          "engine.PROFILE", flush=True)
    card = card_line()
    f = example(sp)
    f32 = torch.float32

    def same_bits(a, b):
        return torch.equal(a.view(torch.int32), b.view(torch.int32))

    # (a) each probe kernel bit-equal to its plain version on the card, on
    # the example's 2**22 axes (the mul-add and the sqrt again at the
    # roofline run's 2**26 axes, their main path, in (c))
    X, Y, Z = grid_axes(f, 2**22, f32)
    axes = node.upload([X, Y, Z], f32, dev)
    gen = torch.Generator(device=dev).manual_seed(23)
    big = torch.randn(weather.COPY_SHAPE, generator=gen, device=dev)
    pairs = {
        "probe_muladd": [(weather.muladd(*axes),
                          weather._muladd_plain(*axes))],
        "probe_sqrts": [(weather.sqrts(*axes), weather._sqrts_plain(*axes))],
        "probe_copy": [(weather.copy(v), weather._copy_plain(v))
                       for v in (big, big.reshape(-1)[1:],
                                 torch.ones(weather.FLOOR_SHAPE, device=dev))],
    }
    torch.cuda.synchronize()
    err = {}
    for name, got in pairs.items():
        check(all(same_bits(a, b) for a, b in got),
              "%s bit-equal to its plain version on the card (%s)"
              % (name, ", ".join(str(tuple(a.shape)) for a, _ in got)))
        err[name] = max_abs_diff(got)
        print("  %s max_abs_err %g" % (name, err[name]))
    del pairs

    # (b) the session rates on the example's 2**22 axes, each under 105% of
    # what the card can do: the data sheet's 3.35 TB/s for the copy; for
    # the mul-add, built with -fmad=false, the FMUL+FADD issue limit (two
    # instructions and two flops a step, so flops/s = issue_rate(), half
    # the 67 TFLOP/s FMA peak).  A rate whose call took under
    # weather.FLOOR_MARGIN dispatch floors is no measurement: it is
    # printed as such and not held to a limit.
    peak = {"copy_gbs": 1.05 * HBM_BYTES_PER_S / 1e9,
            "muladd_gflops": 1.05 * issue_rate() / 1e9}
    rates = weather.probe_rates(X, Y, Z, device=dev)
    n22 = len(X) * len(Y) * len(Z)
    print("  probe_rates at 2**22 (%s): %s" % (card, json.dumps(rates)),
          flush=True)

    def under_peaks(r, n, where):
        """Holds the measured rates of ``r`` (on ``n`` points) under
        ``peak``; returns the floor-bound ones."""
        fb = weather.floor_bound(r, n)
        for k in fb:
            print("  %s: %s %.1f is no measurement: its call took under %d "
                  "dispatch floors of %.4f ms" % (
                      where, k, r[k], weather.FLOOR_MARGIN,
                      r["dispatch_floor_ms"]))
        held = [k for k in peak if k not in fb]
        check(min(r.values()) > 0 and all(r[k] < peak[k] for k in held),
              "%s: %s under %s (105%% of 3,350 GB/s; of the FMUL+FADD "
              "issue limit)" % (where, ", ".join(
                  "%s %.1f" % (k, r[k]) for k in held) or "no rate",
                                ", ".join("%.1f" % peak[k] for k in held)))
        return fb

    under_peaks(rates, n22, "probe_rates at 2**22")

    # (c) the roofline of B1 at 2**26: the probes' main path, their counts
    # set to 0 just before
    for w in (weather.muladd, weather.sqrts, weather.copy):
        w.launches = 0
    roof = load_tool("roofline_torch").main(26, dev)
    launches = {"probe_muladd": weather.muladd.launches,
                "probe_sqrts": weather.sqrts.launches,
                "probe_copy": weather.copy.launches}
    print("  the roofline run's probe launches: %s" % launches)
    check(all(n > 0 for n in launches.values()),
          "every probe kernel launched in roofline_torch.main(26)")
    fb = under_peaks({"dispatch_floor_ms": roof["dispatch_floor_ms"],
                      "copy_gbs": roof["probe_copy_gbs"],
                      "muladd_gflops": roof["probe_muladd_gflops"],
                      "sqrt_gops": roof["probe_sqrt_gops"]},
                     roof["n_points"], "roofline_torch.main(26)'s probes")
    check(not fb, "roofline_torch.main(26)'s probe calls each took at least "
          "%d dispatch floors" % weather.FLOOR_MARGIN)
    R = grid_axes(f, 2**26, f32)
    n26 = int(np.prod([len(a) for a in R]))
    b1_ms = event_ms(lambda: eval_classify.eval_and_classify(f, *R, f32,
                                                             dev))
    print("  B1 at 2**26 %s: a call's device span %.4f ms (CUDA events: "
          "the axes' upload, the outputs' allocation and the kernel), "
          "%.1f GFLOP/s, %.4f of the session's mul-add rate; the "
          "roofline's call %.4f ms (host wall)"
          % (tuple(len(a) for a in R), b1_ms,
             weather.EXAMPLE_FLOPS_PER_POINT * n26 / b1_ms / 1e6,
             weather.EXAMPLE_FLOPS_PER_POINT * n26 / b1_ms / 1e6
             / roof["probe_muladd_gflops"], roof["eval_ms"]))

    # the mul-add and the sqrt bit-equal to their plain versions at the
    # roofline run's shape, where they launched (the entries' max_abs_err)
    rax = node.upload(R, f32, dev)
    for name, kern, plain in (
            ("probe_muladd", weather.muladd, weather._muladd_plain),
            ("probe_sqrts", weather.sqrts, weather._sqrts_plain)):
        got = [(kern(*rax), plain(*rax))]
        check(same_bits(*got[0]), "%s bit-equal to its plain version on the "
              "card at the roofline run's %s" % (name, tuple(got[0][0].shape)))
        err[name] = max_abs_diff(got)
        print("  %s max_abs_err %g at %s" % (name, err[name],
                                             tuple(got[0][0].shape)))
        del got

    # the probes' entries, at the roofline run's shapes
    bigc = torch.ones(weather.COPY_SHAPE, device=dev)
    nb = bigc.numel()
    timed = {
        "probe_muladd": (lambda: weather.muladd(*rax),
                         lambda: weather._muladd_plain(*rax), None,
                         4 * (sum(len(a) for a in R) + n26), 130 * n26),
        "probe_sqrts": (lambda: weather.sqrts(*rax),
                        lambda: weather._sqrts_plain(*rax), None,
                        4 * (sum(len(a) for a in R) + n26), 68 * n26),
        "probe_copy": (lambda: weather.copy(bigc),
                       lambda: weather._copy_plain(bigc),
                       lambda: torch.add(bigc, 1.0), 8 * nb, nb),
    }
    for name, (kern, plain, lib, nbytes, ops) in timed.items():
        ms = event_ms(kern)
        pms = event_ms(plain, reps=3, warm=1)
        lms = event_ms(lib) if lib else None
        b, by = bound_ms(nbytes, ops)
        print("  %s: ms %.4f plain_ms %.4f bound_ms %.4f (%s)%s" % (
            name, ms, pms, b, by,
            "" if lms is None else " library_ms %.4f (torch.add)" % lms))
        kernels[name] = dict(
            name=name, route="cuda", source="sdf_torch/csrc/probes.cu",
            replaces=PROBE_FUSIONS[name], launches=launches[name],
            max_abs_err=err[name], ms=ms, plain_ms=pms, bound_ms=b,
            bound_by=by, library_ms=lms, timing="events",
            shape=list(bigc.shape) if name == "probe_copy"
            else [len(a) for a in R])
    del bigc, rax, big
    torch.cuda.empty_cache()

    # (d) the emit's sub-phases at 2**22; B4 and B5 counted from 0
    compact.indices_of.launches = 0
    compact.indices_and_ranktable_of.launches = 0
    rows = load_tool("profile_emit_torch").main(22, dev)
    b4, b5 = (compact.indices_of.launches,
              compact.indices_and_ranktable_of.launches)
    check(len(rows) == 11 and all(np.isfinite(r[2]) and r[2] > 0
                                  for r in rows),
          "profile_emit_torch.main(22): all 11 sub-phases timed")
    check(b4 > 0 and b5 > 0, "B4 launched %d times and B5 %d times there"
          % (b4, b5))
    print("  sub-phases that wait for the host: %s" % (
        [r[0] for r in rows if r[3]] or "none"))

    # (e) engine.PROFILE and sparse.PROFILE together, warm, best of two
    tris = {}
    for label, samples in PROFILE_CELLS:
        make = (lambda: example(sp)) if label.startswith("example") \
            else zoo.knurling
        kw = dict(samples=samples, verbose=False)
        sp.generate(make(), **kw)  # cold: bounds, counts, kernels
        off, waits_off = count_waits(lambda: sp.generate(make(), **kw))
        routed = "auto_tiles" in engine.LAST_STATS
        engine.PROFILE = sparse.PROFILE = True
        try:
            best = None
            for _ in range(2):
                (v, fc), waits_on = count_waits(
                    lambda: sp.generate(make(), output="mesh", **kw))
                st = dict(engine.LAST_STATS)
                if best is None or st["total"] < best[0]["total"]:
                    best = (st, v, fc)
        finally:
            engine.PROFILE = sparse.PROFILE = False
        st, v, fc = best
        keys = (("tiles_device", "tiles_d2h", "tiles_d2h_bytes",
                 "tiles_decode") if routed
                else ("device", "d2h", "d2h_bytes", "decode"))
        print("  %s PROFILE (%s, %.4f of the batches culled; warm, best of "
              "two; %s): %s, total %.4f s, %d triangles"
              % (label, "routed" if routed else "dense",
                 st["skipped"] / st["batches"], card,
                 {k: st.get(k) for k in keys}, st["total"], len(fc)),
              flush=True)
        check(np.array_equal(v[fc.reshape(-1)], off),
              "%s: the soup with PROFILE on is bit-equal to the run with it "
              "off" % label)
        want = mesh_wire_bytes(v, fc, "float32")
        check(st.get(keys[2]) == want, "%s: %s %s equals the fetched mesh "
              "arrays' %d bytes" % (label, keys[2], st.get(keys[2]), want))
        check(routed or waits_on == waits_off + 1,
              "%s: the dense path waits %d times with PROFILE on, %d with it "
              "off" % (label, waits_on, waits_off))
        tris[label] = len(fc)
        del off, v, fc

    # The cells' meshes against more than themselves: the example's pinned
    # count; knurling's B1 output bit-equal to its plain version on its
    # 2**26 grid, and its count against device="cpu" there within phase
    # 22's max(8, 1e-3 x) (knurling's twist and circular_array take sin,
    # cos and atan2, which differ between the CPU's SLEEF and the card's
    # library by an ulp now and then).
    check(tris["example 2^22"] == TRIS_2P22, "example 2^22: %d triangles, "
          "the pinned %d" % (tris["example 2^22"], TRIS_2P22))
    kn = zoo.knurling()
    K = grid_axes(kn, 2**26, f32)
    vk, ck = eval_classify.eval_and_classify(kn, *K, f32, dev)
    vp, cp = eval_classify._eval_classify_plain(kn, *K, f32, dev)
    check(same_bits(vk, vp) and torch.equal(ck, cp),
          "B1 on knurling's 2^26 grid %s: vol and case bit-equal to plain"
          % (tuple(vk.shape),))
    del vk, ck, vp, cp
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    m = len(sp.generate(zoo.knurling(), samples=2**26, verbose=False,
                        device="cpu")) // 3
    n = tris["knurling 2^26"]
    check(abs(n - m) <= max(C4_COUNT_ATOL, C4_COUNT_RTOL * m),
          "knurling 2^26: %d triangles on the card, %d with device='cpu' "
          "(%.1f s), within max(%d, %g x)" % (
              n, m, time.perf_counter() - t0, C4_COUNT_ATOL, C4_COUNT_RTOL))


# -- phase 6, bounds: the bounds refinement's probe kernel (P4) ---------------


def bounds_models(sp, zoo, hybrid, eval_classify, dtype):
    """The zoo's models (the README example among them) that take the
    card's bounds rounds in ``dtype``: gather-free once routed as
    generate() routes them, with a body."""
    out = []
    for name, (build, _) in zoo.MODELS.items():
        f = hybrid.route_fields(build(), None, dtype)[0]
        if hybrid.count_gathers(f):
            continue
        try:
            eval_classify.kernel_source(f, 0, dtype)
        except eval_classify.NoCppForm:
            continue
        out.append((name, f))
    return out


def bounds_phase(dev, kernels):
    """Phase 6's bounds refinement on the card.  Every round of every zoo
    model's refinement in both dtypes: the probe kernel's volume bit-equal
    to the plain torch evaluation of the same grid on the card, and the
    card's bounds bit-equal to the CPU refinement's.  generate() of
    knurling and blobby at 2**22 with the memos emptied: the probe launched
    once a round, no B1 launch and one host wait more a round than the
    same call on a bounds-memo hit, the bounds it memoized bit-equal to the
    CPU's.  Adds the probe's entry (P4) to ``kernels``: a float32 round of
    knurling's refinement, the launch alone timed with CUDA events
    (``event_ms``: no profiler session, so the later phases' profiles are
    not crowded out), against its plain version's device span on the card
    and the bound, with the host's wall for the round on the card and on
    the CPU."""
    import numpy as np
    import torch

    import sdf_torch as sp
    from sdf_torch import _build
    from sdf_torch.core import engine, eval_classify, hybrid, sparse, spans
    from sdf_torch.models import zoo

    print("== phase 6, bounds: the bounds refinement's probe kernel (P4) on "
          "the card", flush=True)
    dtypes = (torch.float32, torch.float64)
    models = {dt: bounds_models(sp, zoo, hybrid, eval_classify, dt)
              for dt in dtypes}
    t0 = time.time()
    libs = _build.build_many(sorted({
        ("eval_classify", eval_classify.kernel_source(f, 0, dt))
        for dt in dtypes for _, f in models[dt]}))
    print("  built %d libraries in %.1f s" % (len(set(libs)),
                                              time.time() - t0))
    last = {}
    for dt in dtypes:
        name_dt = str(dt).split(".")[1]
        rounds = fallbacks = 0
        for name, f in models[dt]:
            card = engine._card_probe(f, dt, dev)
            check(card is not None, "%s %s takes the card's rounds"
                  % (name, name_dt))
            seen = []

            def probe(X, Y, Z, card=card, seen=seen):
                v = card(X, Y, Z)
                seen.append((X, Y, Z, v))
                return v

            stats = {}
            with spans.call(stats, False):
                got = engine._estimate_bounds_host(f, dt, probe)
            want = engine._estimate_bounds_host(f, dt)
            same = True
            for X, Y, Z, v in seen:
                plain = eval_classify._eval_volume(f, X, Y, Z, dt, dev)
                plain = plain.to(torch.float64).cpu().numpy()
                same &= bool(np.array_equal(v, plain, equal_nan=True) and
                             np.array_equal(np.signbit(v),
                                            np.signbit(plain)))
            check(same, "%s %s: each of %d rounds' probe volume bit-equal "
                  "to the plain evaluation on the card"
                  % (name, name_dt, len(seen)))
            check(got[2] == want[2] and np.array_equal(got[0], want[0])
                  and np.array_equal(got[1], want[1]),
                  "%s %s: the card's bounds %s %s bit-equal to the CPU "
                  "refinement's (%d rounds, %d settled on the CPU)"
                  % (name, name_dt, got[0].tolist(), got[1].tolist(),
                     stats["bounds_rounds"], stats["bounds_fallbacks"]))
            rounds += stats["bounds_rounds"]
            fallbacks += stats["bounds_fallbacks"]
            if name == "knurling" and dt == torch.float32:
                last = dict(f=f, axes=seen[-1][:3], card=card)
        print("  %s: %d models, %d rounds, %d settled on the CPU"
              % (name_dt, len(models[dt]), rounds, fallbacks))

    launches = {}
    for label, make in (("knurling", zoo.knurling), ("blobby", zoo.blobby)):
        kw = dict(samples=2**22, verbose=False)
        runs = []
        for cold in (True, False):  # bounds memo emptied, then a hit
            for m in (engine._COUNTS_MEMO, engine._SKIP_MEMO,
                      sparse._COUNTS_MEMO):
                m.clear()
            if cold:
                engine._BOUNDS_MEMO.clear()
            eval_classify.bounds_probe.launches = 0
            b1 = eval_classify.eval_and_classify.launches
            t0 = time.perf_counter()
            sp.generate(make(), **kw)
            torch.cuda.synchronize()
            st = dict(engine.LAST_STATS)
            runs.append((st, eval_classify.bounds_probe.launches,
                         eval_classify.eval_and_classify.launches - b1,
                         time.perf_counter() - t0))
            if cold:
                memoized = list(engine._BOUNDS_MEMO.values())
        (st, probes, b1, s), (hit, hit_probes, hit_b1, hit_s) = runs
        rnd = st["bounds_rounds"]
        launches[label] = probes
        check(probes == rnd > 1 and hit_probes == hit["bounds_rounds"] == 0,
              "%s 2^22: the probe launched once a round (%d rounds, %d "
              "settled on the CPU), not on a bounds-memo hit"
              % (label, rnd, st["bounds_fallbacks"]))
        check(b1 == hit_b1 and st["host_waits"] == hit["host_waits"] + rnd,
              "%s 2^22: the refinement launched no B1 (%d a call) and waited "
              "once a round (%d host waits, %d on a bounds-memo hit)"
              % (label, b1, st["host_waits"], hit["host_waits"]))
        engine._BOUNDS_MEMO.clear()
        cpu = engine._estimate_bounds(make(), torch.float32, "cpu")
        check(len(memoized) == 1 and memoized[0] == cpu,
              "%s 2^22: the bounds generate() memoized equal the CPU's %s"
              % (label, cpu))
        print("  %s 2^22 cold %.4f s (bounds %.4f s, kernel_sources %d), "
              "bounds-memo hit %.4f s" % (label, s, st["bounds"],
                                           st["kernel_sources"], hit_s))

    # P4 timed on the last float32 round of knurling's refinement, with CUDA
    # events (the profiler's extra sessions here made it drop every event
    # of a timed call in phase 22): the probe's launch alone, as
    # bounds_probe makes it, and the plain evaluation's device span.
    f, (X, Y, Z), card = last["f"], last["axes"], last["card"]
    got = card(X, Y, Z)
    plain = eval_classify._eval_volume(f, X, Y, Z, torch.float32, dev)
    err = float(np.nanmax(np.abs(got - plain.double().cpu().numpy())))
    _, entry = eval_classify._entries(f, 0, torch.float32)
    P = eval_classify._params_arg(f, torch.float32, dev)
    axes = [np.asarray(a, np.float32) for a in (X, Y, Z)]
    vol = torch.empty(tuple(len(a) for a in axes), device=dev)
    stream = _build.stream_ptr(dev)

    def launch():
        _build.check(entry(*[a.ctypes.data for a in axes],
                           eval_classify._address(P), *vol.shape,
                           vol.data_ptr(), stream), "bounds_probe")

    launch()
    check(np.array_equal(vol.double().cpu().numpy(), got, equal_nan=True),
          "P4's launch alone writes the volume bounds_probe fetched")
    ms = event_ms(launch, reps=50)
    pms = event_ms(lambda: eval_classify._eval_volume(
        f, X, Y, Z, torch.float32, dev), reps=10)
    n = len(X) * len(Y) * len(Z)
    ops_pt = body_op_count(eval_classify.kernel_source(f, 0, torch.float32))
    b, by = bound_ms(4 * (n + len(X) + len(Y) + len(Z)), ops_pt * n)
    walls = []
    for _ in range(200):
        t0 = time.perf_counter()
        card(X, Y, Z)
        walls.append((time.perf_counter() - t0) * 1e3)
    cpu = engine._cpu_probe(f, torch.float32)
    cpu(X, Y, Z)
    cpu_walls = []
    for _ in range(10):
        t0 = time.perf_counter()
        cpu(X, Y, Z)
        cpu_walls.append((time.perf_counter() - t0) * 1e3)
    host, host_cpu = statistics.median(walls), statistics.median(cpu_walls)
    print("  P4 bounds_probe float32 on knurling's %dx%dx%d round: kernel_ms "
          "%.4f plain_ms %.4f bound_ms %.6f (%s; %d ops/point) max_abs_err "
          "%g; host wall a round %.4f ms on the card (launch and fetch), "
          "%.4f ms on the CPU" % (len(X), len(Y), len(Z), ms, pms, b, by,
                                  ops_pt, err, host, host_cpu))
    kernels["bounds_probe"] = dict(
        name="bounds_probe", route="cuda",
        source="sdf_torch/csrc/eval_classify.cu",
        replaces="sdf_tpu/core/engine.py:192 (the rounds, on the host)",
        launches=launches["knurling"], max_abs_err=err, ms=ms, plain_ms=pms,
        bound_ms=b, bound_by=by, library_ms=None,
        shape="%dx%dx%d" % (len(X), len(Y), len(Z)), timing="events",
        host_round_ms=host, cpu_round_ms=host_cpu)


def decode_phase(dev, kernels):
    """Phase 23's mesh decode on the card (kernel D1).  knurling and blobby
    at 2**26 through generate() at the benchmark's settings (float32,
    sparse=True, lewiner, batches of 32: knurling on the dense path,
    blobby routed to the tiles), warm: D1 launched once in the call
    (``decode_on_card.launches`` reset before it, and ``card_decodes``),
    its buffer bit-equal to the host decode (``mc.unpack_indexed``,
    ``sparse.unpack_tiles_indexed``) of the wire format packed from the
    same emit, to the plain route on the card (the emit's ``edge_verts``
    widened to float64 and the ranks transposed, into one buffer), and to
    the mesh generate() returned.  Adds D1's entry (``decode``) to
    ``kernels``: D1 and the plain route timed with CUDA events on
    knurling's emit against the bound (24 + 8 bytes a vertex, 12 + 12 a
    triangle), blobby's as ``tiles_ms``, ``tiles_plain_ms`` and
    ``tiles_bound_ms``, and the host's readback of each mesh: D1's buffer
    fetched and viewed (``host_view_ms``) against the wire format fetched
    and decoded with numpy (``host_unpack_ms``), medians of five."""
    import numpy as np
    import torch

    import sdf_torch as sp
    from sdf_torch.core import engine, mc, node
    from sdf_torch.models import zoo

    print("== phase 23, decode: the mesh decode on the card (D1) at 2**26",
          flush=True)
    kw = dict(samples=2**26, verbose=False, output="mesh", sparse=True,
              mc_variant="lewiner", batch_size=32, dtype=torch.float32)
    out = {}
    for label, make in (("knurling", zoo.knurling), ("blobby", zoo.blobby)):
        seen = []
        real = mc.readback

        def spy(eidx, t, faces, ne, n, plain, unpack, **where):
            got = real(eidx, t, faces, ne, n, plain, unpack, **where)
            seen.append((eidx, t, faces, ne, n, plain, unpack, where,
                         got[0]))
            return got

        mc.readback = spy
        try:
            sp.generate(make(), **kw)
            seen.clear()
            mc.decode_on_card.launches = 0
            verts, faces_h = sp.generate(make(), **kw)
            launches = mc.decode_on_card.launches
        finally:
            mc.readback = real
        st = dict(engine.LAST_STATS)
        ((eidx, t, ranks, ne, n, plain, unpack, where, tensors),) = seen
        tiles = "tiles" in where
        check(launches == 1 and st["card_decodes"] == 1 and len(tensors) == 1
              and ("auto_tiles" in st) == tiles,
              "%s 2^26 (%s): D1 launched once (card_decodes %d), its one "
              "buffer fetched" % (label, "tiles" if tiles else "dense",
                                  st["card_decodes"]))
        (buf,) = tensors
        vbytes, nbytes = mc.mesh_layout(ne, n)
        vh, fh = mc.split_mesh(buf.cpu().numpy(), ne, n)
        wide = ne >= (1 << mc.FACE_PACK_BITS)
        epack = torch.stack([eidx[:ne], t[:ne].view(torch.int32)])
        fpack = mc.pack_faces_words(ranks[:, :n], not wide)
        epack_h = epack.cpu().numpy().view(np.uint32)
        fpack_h = fpack.cpu().numpy().view(np.uint32)
        want_v, want_f = unpack(epack_h, fpack_h)
        check(vh.dtype == want_v.dtype == np.float64
              and np.array_equal(vh.view(np.int64), want_v.view(np.int64))
              and fh.dtype == np.int32 and np.array_equal(fh, want_f),
              "%s 2^26: D1's %d vertices and %d faces bit-equal to the host "
              "decode of the packed emit (%s faces)"
              % (label, ne, n, "int32" if wide else "21-bit"))

        def plain_mesh(plain=plain, ranks=ranks, ne=ne, n=n, nbytes=nbytes):
            v = plain()[:, :ne].to(torch.float64).T.contiguous()
            f = ranks[:, :n].T.contiguous()
            parts = [v.reshape(-1).view(torch.uint8),
                     f.reshape(-1).view(torch.uint8)]
            pad = nbytes - 24 * ne - 12 * n
            return torch.cat(parts + [parts[1].new_zeros(pad)])

        used = vbytes + 12 * n
        check(torch.equal(plain_mesh()[:used], buf[:used]),
              "%s 2^26: D1's buffer bit-equal to the plain route's on the "
              "card" % label)
        check(np.array_equal(faces_h, fh) and len(verts) == ne,
              "%s 2^26: generate() returned D1's faces and %d vertices"
              % (label, ne))

        def d1(eidx=eidx, t=t, ranks=ranks, ne=ne, n=n, where=where):
            return mc.decode_on_card(eidx, t, ranks, ne, n, **where)

        ms = event_ms(d1, reps=20)
        pms = event_ms(plain_mesh, reps=10)
        b, by = bound_ms(32 * ne + 24 * n)
        host = {}
        for what, fn in (
                ("view", lambda: mc.split_mesh(node.fetch([buf])[0], ne, n)),
                ("unpack", lambda: unpack(*(a.view(np.uint32) for a in
                                            node.fetch([epack, fpack]))))):
            walls = []
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                walls.append((time.perf_counter() - t0) * 1e3)
            host[what] = statistics.median(walls)
        out[label] = dict(ms=ms, plain_ms=pms, bound_ms=b, bound_by=by,
                          launches=launches, host=host,
                          shape="ne=%d n=%d" % (ne, n))
        print("  D1 %s 2^26 (ne %d, n %d): kernel_ms %.4f plain_ms %.4f "
              "bound_ms %.4f (%s); host readback %.2f ms fetched and viewed, "
              "%.2f ms packed, fetched and decoded with numpy"
              % (label, ne, n, ms, pms, b, by, host["view"], host["unpack"]),
              flush=True)
        del seen, buf, tensors, epack, fpack
    k, bl = out["knurling"], out["blobby"]
    kernels["decode"] = dict(
        name="decode", route="cuda", source="sdf_torch/csrc/decode.cu",
        replaces="sdf_tpu/core/mc.py:715, sdf_tpu/core/sparse.py:513 (the "
                 "numpy decode, on the host)",
        launches=k["launches"], max_abs_err=0.0, ms=k["ms"],
        plain_ms=k["plain_ms"], bound_ms=k["bound_ms"],
        bound_by=k["bound_by"], library_ms=None, shape=k["shape"],
        timing="events", host_view_ms=k["host"]["view"],
        host_unpack_ms=k["host"]["unpack"], tiles_ms=bl["ms"],
        tiles_plain_ms=bl["plain_ms"], tiles_bound_ms=bl["bound_ms"],
        tiles_shape=bl["shape"], tiles_host_view_ms=bl["host"]["view"],
        tiles_host_unpack_ms=bl["host"]["unpack"])


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
    if "--tables" in sys.argv[1:]:
        _build.build_many([("label3d", _build.source("label3d.cu"))])
        table_builder_phase(dev, {})
        print(card_line())
        return 0
    if "--elementwise" in sys.argv[1:]:
        t0 = time.time()
        libs = _build.build_many(elementwise_sources(sp, eval_classify,
                                                     hybrid))
        print("built %d libraries in %.1f s" % (len(set(libs)),
                                                time.time() - t0))
        elementwise_phase(dev, {})
        print(card_line())
        return 0
    if "--measure" in sys.argv[1:]:
        t0 = time.time()
        libs = _build.build_many(measure_sources(sp, zoo, _build,
                                                 eval_classify, mc33))
        print("built %d libraries in %.1f s" % (len(set(libs)),
                                                time.time() - t0))
        kernels = {}
        measurement_phase(dev, kernels)
        print(json.dumps({"kernels": [kernels[k] for k in PROBE_FUSIONS]}))
        print(card_line())
        return 0
    if "--decode" in sys.argv[1:]:
        _build.build_many([("decode", _build.source("decode.cu"))])
        kernels = {}
        decode_phase(dev, kernels)
        print(json.dumps({"kernels": [kernels["decode"]]}))
        print(card_line())
        return 0
    if "--bounds" in sys.argv[1:]:
        kernels = {}
        bounds_phase(dev, kernels)
        print(json.dumps({"kernels": [kernels["bounds_probe"]]}))
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
        ("label3d", _build.source("label3d.cu")),
        ("decode", _build.source("decode.cu")),
    ] + elementwise_sources(sp, eval_classify, hybrid)
      + measure_sources(sp, zoo, _build, eval_classify, mc33))
    print("built %d libraries in %.1f s: %s" % (
        len(set(libs)), time.time() - t0,
        ", ".join(sorted({p.name for p in libs}))))

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
    bounds_phase(dev, kernels)

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
    table_builder_phase(dev, kernels)
    elementwise_phase(dev, kernels)
    measurement_phase(dev, kernels)
    decode_phase(dev, kernels)

    # -- result ------------------------------------------------------------------
    order = dense_path + ["eval_tiles_batched", "eval_tiles",
                          "eval_classify_fields", "label3d"] + list(
                              PROBE_FUSIONS) + ["bounds_probe", "decode"]
    keys = ["name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"]
    more = ["sharded_launches", "diffmesh_launches", "routed_launches", "routed_dense_pass", "tiles_path", "prepass_ms",
            "kernel_only_ms", "nf", "nf4", "ms_all_rows", "prepass_ms_all_rows",
            "kernel_only_ms_all_rows", "workspace_bound_ms", "scipy_host_ms",
            "shapes",
            "build_wall_s", "build_busy_ms", "oracle_calls", "shape",
            "host_round_ms", "cpu_round_ms", "timing", "host_view_ms",
            "host_unpack_ms", "tiles_ms", "tiles_plain_ms", "tiles_bound_ms",
            "tiles_shape", "tiles_host_view_ms", "tiles_host_unpack_ms"]
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
