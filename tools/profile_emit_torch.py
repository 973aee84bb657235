"""Per-sub-phase profile of mc.gather_emit_indexed (counterpart of
tools/profile_emit.py).

Decomposes the compaction + indexed emit of the example model's dense
pipeline (float32, ``mc_variant="fast"``'s 8-bit cases, every cell kept)
into its sub-phases, in the JAX tool's order and under its names, each
timed with ``weather.timed_min`` (K calls back to back, one fence), so
optimization effort lands where the time goes:

  gather_emit_indexed (whole)        mc.gather_emit_indexed
    compact_cells                    mc.compact_cells (B4, then B3)
    indices_and_ranktable_of         compact.indices_and_ranktable_of (B5)
      pack-only (indices_of)         compact.indices_of (B4)
      rowpack kernel alone           compact._indices_cuda (B4's launch)
      rowpack+ranks+bytes alone      compact._ranktable_cuda (B5's launch;
                                     the JAX tool's direct pallas_call)
    edge decode + gather + t         the decode, mc._take (index_select,
                                     where the JAX tool uses
                                     compact.gather1d) and t
    _resolve_faces                   mc._resolve_faces
      ragged_expand(fill)            compact.ragged_expand(fill=)
      _edge_ids_of                   mc._edge_ids_of
      _edge_gid + rank lookup        mc._edge_gid + compact.rank_lookup

K back-to-back calls and one fence measure a sub-phase only if it never
waits for the host: on the card each sub-phase runs once first under
``torch.cuda.set_sync_debug_mode("error")``, and its line says ``SYNCS``
with PyTorch's message where it does.  On the CPU (``device="cpu"``) the
two "kernel alone" lines time the plain versions of B4 and B5 and say so,
and no line is a device time.

Run on a machine with the card, from the root of a checkout:

    python3 tools/profile_emit_torch.py [log2_samples] [--device cpu]
"""

import os
import sys
from functools import partial

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

# (the JAX tool's label, the port's functions), in the JAX tool's order.
SUB_PHASES = [
    ("gather_emit_indexed (whole)", "mc.gather_emit_indexed"),
    ("compact_cells (4.2M mask pack + gathers)", "mc.compact_cells"),
    ("indices_and_ranktable_of (edge mask)",
     "compact.indices_and_ranktable_of, B5"),
    ("pack-only (indices_of, no ranks)", "compact.indices_of, B4"),
    ("rowpack kernel alone", "compact._indices_cuda, B4's launch"),
    ("rowpack+ranks+bytes kernel alone",
     "compact._ranktable_cuda, B5's launch"),
    ("edge decode + endpoint gather + t", "decode, mc._take, t"),
    ("_resolve_faces (expand+edgeids+rank lookup)", "mc._resolve_faces"),
    ("ragged_expand(fill)", "compact.ragged_expand(fill=)"),
    ("_edge_ids_of (packed 3x4-bit gather)", "mc._edge_ids_of"),
    ("_edge_gid + rank lookup (pair table)",
     "mc._edge_gid + compact.rank_lookup"),
]
_DEPTH = [0, 1, 1, 2, 2, 2, 1, 1, 2, 2, 2]
_PLAIN_ON_CPU = {4: "compact._indices_of_plain, B4's plain version on the "
                    "CPU",
                 5: "compact._ranktable_plain, B5's plain version on the "
                    "CPU"}


def edge_verts(volume, eidx):
    """The edge decode, endpoint gather and ``t`` of
    ``mc._emit_indexed_core``, the gather by ``mc._take``."""
    import torch

    from sdf_torch.core import mc

    nx, ny, nz = volume.shape
    Sx = (nx - 1) * ny * nz
    Sy = nx * (ny - 1) * nz
    e = eidx.to(torch.int64)
    ax = (e >= Sx).to(torch.int64) + (e >= Sx + Sy).to(torch.int64)

    def decode(local, My, Mz):
        z = local % Mz
        rem = local // Mz
        return rem // My, rem % My, z

    d0 = decode(e, ny, nz)
    d1 = decode(e - Sx, ny - 1, nz)
    d2 = decode(e - Sx - Sy, ny, nz - 1)

    def pick(i):
        return torch.where(ax == 0, d0[i], torch.where(ax == 1, d1[i], d2[i]))

    ex, ey, ez = pick(0), pick(1), pick(2)
    lin_a = (ex * ny + ey) * nz + ez
    vstride = torch.where(ax == 0, ny * nz, torch.where(ax == 1, nz, 1))
    vab = mc._take(volume.reshape(-1), 0, torch.cat([lin_a, lin_a + vstride]))
    va = vab[: lin_a.shape[0]]
    vb = vab[lin_a.shape[0]:]
    denom = va - vb
    t = torch.clamp(
        torch.clamp(va / torch.where(denom == 0, 1.0, denom), min=0.0), max=1.0
    )
    return ex, ey, ez, t


def _sync_check(fn, args):
    """None if ``fn(*args)`` never waits for the card, else PyTorch's
    message about the first wait."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn(*args)
    except RuntimeError as e:
        return str(e).splitlines()[0]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return None


def main(p2=22, device=None):
    """Time every sub-phase and print one line each; returns ``[(label,
    port functions, ms, sync message or None), ...]`` in SUB_PHASES'
    order."""
    import numpy as np
    import torch

    from sdf_torch.core import compact, engine, eval_classify, mc, node
    from sdf_torch.models import example
    from sdf_torch.utils import weather

    device = node.resolve_device(device)
    cuda = device.type == "cuda"
    f = example()
    dtype = torch.float32
    (x0, y0, z0), (x1, y1, z1) = engine._estimate_bounds(f, dtype)
    volume = (x1 - x0) * (y1 - y0) * (z1 - z0)
    step = (volume / 2**p2) ** (1 / 3)
    X = np.arange(x0, x1, step)
    Y = np.arange(y0, y1, step)
    Z = np.arange(z0, z1, step)
    s = engine.BATCH_SIZE
    cshape = (len(X) - 1, len(Y) - 1, len(Z) - 1)
    tshape = tuple(-(-c // s) for c in cshape)
    keep = torch.ones(cshape, dtype=torch.bool, device=device)

    vol, case = eval_classify.eval_and_classify(f, X, Y, Z, dtype, device)
    ncells_dev, total, n_edges, _, active, emask = mc.count_indexed(
        vol, case, keep, s, tshape
    )
    n_cells, n, ne = (int(v) for v in node.fetch([ncells_dev, total,
                                                  n_edges]))
    ccap = mc.round_capacity(n_cells)
    cap = mc.round_capacity(n)
    ecap = mc.round_capacity(ne)
    print("grid=%dx%dx%d  cells=%.1fM edges=%.1fM  device=%s"
          % (len(X), len(Y), len(Z), np.prod(cshape) / 1e6,
             emask.shape[0] / 1e6,
             torch.cuda.get_device_name(device) if cuda else "cpu"))
    print("n_cells=%d (ccap %d)  n_tris=%d (cap %d)  n_edges=%d (ecap %d)"
          % (n_cells, ccap, n, cap, ne, ecap))

    nx, ny, nz = vol.shape
    Sx = (nx - 1) * ny * nz
    Sy = nx * (ny - 1) * nz
    packed = True if ne < (1 << mc.FACE_PACK_BITS) else "wide"
    cell_state = mc.compact_cells(case, active, ccap)
    eidx, ranktab, _ = compact.indices_and_ranktable_of(emask, ecap)
    cbits = mc.get_tables().case_bits
    ci, cj, ck, cell_case, cell_ntri = cell_state
    w = ((ci * (ny - 1) + cj) * (nz - 1) + ck) * (1 << cbits) \
        + cell_case.to(torch.int64)
    _, slot, _, wt = compact.ragged_expand(cell_ntri, cap, fill=w)
    case_t = wt & ((1 << cbits) - 1)
    ev = mc._edge_ids_of(case_t, slot)
    lin = wt >> cbits
    ny1, nz1 = ny - 1, nz - 1
    cx = lin // (ny1 * nz1)
    rem = lin % (ny1 * nz1)
    cy = rem // nz1
    cz = rem % nz1

    def gids_rank(ev0, ev1, ev2, cx, cy, cz, tab):
        gids = [mc._edge_gid(e, cx, cy, cz, ny, nz, Sx, Sy)
                for e in (ev0, ev1, ev2)]
        return compact.rank_lookup(tab, torch.cat(gids))

    b4 = compact._indices_cuda if cuda else compact._indices_of_plain
    b5 = compact._ranktable_cuda if cuda else compact._ranktable_plain
    calls = [
        (partial(mc.gather_emit_indexed, packed=packed),
         (vol, case, active, emask, ecap, cap, ccap)),
        (mc.compact_cells, (case, active, ccap)),
        (compact.indices_and_ranktable_of, (emask, ecap)),
        (compact.indices_of, (emask, ecap)),
        (b4, (emask, ecap)),
        (b5, (emask, ecap)),
        (edge_verts, (vol, eidx)),
        (partial(mc._resolve_faces, capacity=cap, cell_capacity=ccap, ny=ny,
                 nz=nz, Sx=Sx, Sy=Sy), (ranktab, cell_state)),
        (partial(compact.ragged_expand, fill=w), (cell_ntri, cap)),
        (mc._edge_ids_of, (case_t, slot)),
        (gids_rank, (ev[0], ev[1], ev[2], cx, cy, cz, ranktab)),
    ]
    rows = []
    for i, ((label, port), (fn, args)) in enumerate(zip(SUB_PHASES, calls)):
        if not cuda and i in _PLAIN_ON_CPU:
            port = _PLAIN_ON_CPU[i]
        synced = _sync_check(fn, args) if cuda else None
        t, _ = weather.timed_min(fn, *args, K=20, reps=3)
        ms = t * 1e3
        print("%s%s [%s]: %9.4f ms%s" % (
            "  " * _DEPTH[i], label, port, ms,
            "  SYNCS: " + synced if synced else ""), flush=True)
        rows.append((label, port, ms, synced))
    return rows


if __name__ == "__main__":
    args = sys.argv[1:]
    dev = None
    if "--device" in args:
        k = args.index("--device")
        dev = args[k + 1]
        del args[k: k + 2]
    main(int(args[0]) if args else 22, dev)
