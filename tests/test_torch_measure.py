"""The port's measurement layer on the CPU: ``engine.PROFILE``, the tools
``tools/roofline_torch.py`` and ``tools/profile_emit_torch.py``, and the
last two public helpers (``node.pointwise``, ``easing._main``), against the
JAX package.

Tolerances:
  * ``engine.PROFILE``: the soups with and without it bit-equal;
    ``d2h_bytes`` equal to sdf_tpu's with its PROFILE on, in float32
    (packed) and float64 (unpacked), whose triangle counts are equal at
    2^15 (tests/test_torch_engine.py holds the counts).
  * the tools: the JAX tools' keys and sub-phases, in their order; the
    numbers are the CPU's and no device metric.
  * ``pointwise``: float64 bit-equal to JAX's on the same seeded inputs.
"""

import ast
import io
import os
import re
import subprocess
import sys
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sdf_tpu as st
import sdf_torch as sp
from sdf_tpu.core import engine as jengine
from sdf_tpu.core import node as jnode
from sdf_tpu.parallel import grid as pgrid
from sdf_torch.core import engine as tengine
from sdf_torch.core import node as tnode

import torch_helpers as th

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROFILE_KEYS = ("device", "d2h_bytes", "spans")


def _tool(name):
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    try:
        return __import__(name)
    finally:
        sys.path.pop(0)


@pytest.fixture(autouse=True)
def _fresh_memos():
    tengine._BOUNDS_MEMO.clear()
    tengine._COUNTS_MEMO.clear()
    tengine._SKIP_MEMO.clear()


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_profile_keys_soup_and_d2h_bytes(monkeypatch, dtype):
    """PROFILE adds exactly its keys, changes no soup, and counts the
    bytes the JAX package counts: the mesh arrays of the one transfer."""
    kw = dict(samples=2**15, verbose=False, dtype=dtype, sparse=False)
    assert tengine.PROFILE is False  # off by default
    off = sp.generate(th.example(sp), device="cpu", **kw)
    assert not set(PROFILE_KEYS) & set(tengine.LAST_STATS)
    keys_off = set(tengine.LAST_STATS)
    monkeypatch.setattr(tengine, "PROFILE", True)
    on = sp.generate(th.example(sp), device="cpu", **kw)
    assert set(tengine.LAST_STATS) == keys_off | set(PROFILE_KEYS)
    np.testing.assert_array_equal(on, off)
    st_on = dict(tengine.LAST_STATS)
    assert 0 < st_on["device"]
    # memoized repeat: the statistics ride the mesh transfer, and the
    # bytes still count the mesh arrays only
    again = sp.generate(th.example(sp), device="cpu", **kw)
    np.testing.assert_array_equal(again, off)
    assert tengine.LAST_STATS["d2h_bytes"] == st_on["d2h_bytes"]

    monkeypatch.setattr(jengine, "PROFILE", True)
    jax_pts = th.example(st).generate(
        verbose=False, mesh=pgrid.make_mesh(jax.devices()[:1]),
        **{k: v for k, v in kw.items() if k != "verbose"})
    assert len(jax_pts) == len(on)
    assert st_on["d2h_bytes"] == jengine.LAST_STATS["d2h_bytes"] > 0
    # and the count is the wire format's: packed float32 (2 words a vertex,
    # 2 face words), float64 vertices and int32 faces
    verts, faces = sp.generate(th.example(sp), device="cpu", output="mesh",
                               **kw)
    per = (8, 8) if dtype == "float32" else (24, 12)
    assert st_on["d2h_bytes"] == per[0] * len(verts) + per[1] * len(faces)


def _jax_roofline_keys():
    tree = ast.parse(open(os.path.join(ROOT, "tools", "roofline.py")).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict) and node.keys and all(
                isinstance(k, ast.Constant) for k in node.keys):
            keys = [k.value for k in node.keys]
            if "vpu_utilization" in keys:
                return keys
    raise AssertionError("no key dict in tools/roofline.py")


def test_roofline_tool_keys_on_cpu(monkeypatch):
    from sdf_torch.utils import weather

    monkeypatch.setattr(weather, "COPY_SHAPE", (256, 128))
    rt = _tool("roofline_torch")
    out = io.StringIO()
    with redirect_stdout(out):
        row = rt.main(12, device="cpu")
    keys = _jax_roofline_keys()
    assert list(row)[: len(keys)] == keys and row["device"] == "cpu"
    assert row["n_points"] == int(np.prod(row["grid"]))
    assert row["model_flops_per_point"] == 90
    assert all(np.isfinite(row[k]) and row[k] > 0
               for k in keys if k != "grid")
    assert out.getvalue().count("\n") == 1
    # the written bytes: a float32 volume and int32 cases
    nx, ny, nz = row["grid"]
    written = 4 * nx * ny * nz + 4 * (nx - 1) * (ny - 1) * (nz - 1)
    assert np.isclose(row["hbm_utilization_write"],
                      written / (row["eval_ms"] / 1e3) / 1e9
                      / row["probe_copy_gbs"])


def _jax_emit_labels():
    """The sub-phase labels tools/profile_emit.py prints, in its order."""
    src = open(os.path.join(ROOT, "tools", "profile_emit.py")).read()
    return [m.strip() for m in re.findall(r'print\(f"([^":{]+?)\s*:\s*\{t',
                                          src)]


def test_profile_emit_tool_sub_phases_on_cpu():
    pe = _tool("profile_emit_torch")
    labels = _jax_emit_labels()
    assert len(labels) == 11 and labels[0] == "gather_emit_indexed (whole)"
    out = io.StringIO()
    with redirect_stdout(out):
        rows = pe.main(15, device="cpu")
    lines = [ln.strip() for ln in out.getvalue().splitlines()]
    timed = [ln for ln in lines if ln.endswith(" ms")]
    assert len(timed) == len(labels) == len(rows)
    for label, line, row in zip(labels, timed, rows):
        assert line.startswith(label + " ["), (label, line)
        assert row[0] == label and row[2] > 0 and row[3] is None
    # on the CPU the two "kernel alone" lines time the plain versions
    alone = [ln for ln in timed if "kernel alone" in ln]
    assert len(alone) == 2 and all("plain version on the CPU" in ln
                                   for ln in alone)


def test_profile_emit_edge_verts_equal_the_emit():
    """The tool's decode + gather + t is the emit's, value for value."""
    from sdf_torch.core import compact, eval_classify, mc

    pe = _tool("profile_emit_torch")
    X = np.linspace(-1.1, 1.1, 23)
    vol, case = eval_classify.eval_and_classify(th.example(sp), X, X, X,
                                                torch.float32, "cpu")
    keep = torch.ones(tuple(case.shape), dtype=torch.bool)
    nc, n, ne, _, active, emask = mc.count_indexed(vol, case, keep, 8,
                                                   (3, 3, 3))
    ecap = mc.round_capacity(int(ne))
    state = mc.compact_cells(case, active, mc.round_capacity(int(nc)))
    eidx, _, _ = compact.indices_and_ranktable_of(emask, ecap)
    ex, ey, ez, t = pe.edge_verts(vol, eidx)
    _, ax, (wx, wy, wz), wt, _, _ = mc._emit_indexed_core(
        vol, emask, state, ecap, mc.round_capacity(int(n)),
        mc.round_capacity(int(nc)))
    for a, b in ((ex, wx), (ey, wy), (ez, wz), (t, wt)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("fn", ["abs", "clip", "square"])
def test_pointwise_equals_jax(fn):
    rng = np.random.default_rng(7)
    xyz = [rng.normal(size=(5, 4)) for _ in range(3)]
    jf, tf, args = {
        "abs": (jnp.abs, torch.abs, ()),
        "clip": (jnp.clip, torch.clamp, (-0.5, 0.5)),
        "square": (jnp.square, torch.square, ()),
    }[fn]
    jp = jnode.pointwise(jf)(jnode.Points(*[jnp.asarray(a) for a in xyz]),
                             *args)
    tp = tnode.pointwise(tf)(tnode.Points(*[torch.as_tensor(a) for a in xyz]),
                             *args)
    assert isinstance(tp, tnode.Points) and tp.dim == 3
    for a, b in zip(tp.c, jp.c):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    bare = tnode.pointwise(tf)(torch.as_tensor(xyz[0]), *args)
    np.testing.assert_array_equal(
        bare.numpy(), np.asarray(jnode.pointwise(jf)(jnp.asarray(xyz[0]),
                                                     *args)))


def test_easing_main_plots_every_curve_and_loads_matplotlib_lazily():
    """``_main`` lists the JAX module's curves; importing the module does
    not import matplotlib (nothing here draws the plot)."""
    from sdf_torch.ops import easing

    def curves(path):
        tree = ast.parse(open(path).read())
        fn = next(n for n in tree.body
                  if isinstance(n, ast.FunctionDef) and n.name == "_main")
        return [n.id for n in ast.walk(fn) if isinstance(n, ast.Name)
                and n.id not in ("plt", "np", "x", "f", "fs")]

    port = curves(easing.__file__)
    assert port == curves(os.path.join(ROOT, "sdf_tpu", "ops", "easing.py"))
    assert len(port) == 34 and all(callable(getattr(easing, n)) for n in port)
    code = ("import sys, sdf_torch.ops.easing\n"
            "sys.exit('matplotlib' in sys.modules)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
