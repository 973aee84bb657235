"""Every example script through the port, with only its import line
changed (``from sdf_tpu ...`` -> ``from sdf_torch ...``), against the same
script on the JAX package.

Each script runs in a temporary directory with ``generate`` clamped to
2^12 samples, as tests/test_examples.py runs them (its font, argv and
asset patches), and for the port on ``device="cpu"``.  ``fit_sphere.py``
calls ``jax.numpy`` itself, so no import swap ports it.

Tolerance: the scripts mesh in float32.  Each generate() call's triangle
count is within 2% (and 8 triangles) of the JAX package's run of the same
script: an ulp of a sample near zero, which the two packages' float32
arithmetic may round differently, flips a cell case.
"""

import os
import shutil

import numpy as np
import pytest

import sdf_torch
import sdf_tpu

ROOT = os.path.join(os.path.dirname(__file__), "..")

EXAMPLES = ["example.py", "blobby.py", "gearlike.py", "knurling.py",
            "pawn.py", "weave.py", "customizable_box.py", "text.py",
            "image.py", "mesh.py"]


def _run(pkg, script, tmp_path, monkeypatch):
    """Run ``script`` against the package ``pkg``; returns the triangle
    count of each generate() call."""
    engine = pkg.core.engine
    real_generate = engine.generate
    counts = []

    def small_generate(sdf, *args, **kwargs):
        kwargs["samples"] = 2**12
        kwargs.pop("step", None)
        kwargs["verbose"] = False
        if pkg is sdf_torch:
            kwargs["device"] = "cpu"
        out = real_generate(sdf, *args, **kwargs)
        counts.append(len(out) // 3)
        return out

    monkeypatch.setattr(engine, "generate", small_generate)
    work = tmp_path / pkg.__name__
    work.mkdir()
    monkeypatch.chdir(work)
    if script == "text.py":
        # the scripts name Arial; the machine has DejaVuSans
        real_measure, real_text = pkg.measure_text, pkg.text
        monkeypatch.setattr(pkg, "measure_text", lambda name, text, **kw:
                            real_measure("DejaVuSans", text, **kw))
        monkeypatch.setattr(pkg, "text", lambda name, *a, **kw:
                            real_text("DejaVuSans", *a, **kw))
    if script == "mesh.py":
        # the input mesh on argv: a small sphere STL made by the JAX package
        from sdf_tpu.io import stl as stl_io

        fixture = tmp_path / "input.stl"
        if not fixture.exists():
            pts = sdf_tpu.core.engine.generate(sdf_tpu.sphere(1),
                                               samples=2**12, verbose=False)
            stl_io.write_binary_stl(str(fixture), np.asarray(pts))
        monkeypatch.setattr("sys.argv", ["mesh.py", str(fixture)])
        if pkg is sdf_torch:
            mesh_cls = sdf_torch.ops.meshsdf.Mesh
            real_sdf = mesh_cls.sdf
            monkeypatch.setattr(mesh_cls, "sdf", lambda self, *a, **kw:
                                real_sdf(self, *a, device="cpu", **kw))
    if script == "image.py":
        os.makedirs(work / "examples", exist_ok=True)
        shutil.copy(os.path.join(ROOT, "examples", "flower.png"),
                    work / "examples" / "flower.png")
    path = os.path.join(ROOT, "examples", script)
    src = open(path).read()
    assert "from sdf_tpu" in src
    if pkg is sdf_torch:  # the import line, and nothing else
        src = src.replace("from sdf_tpu", "from sdf_torch")
    name = pkg.__name__
    if script in ("text.py", "image.py"):
        # the scripts use the star-exported names; rebind the patched ones
        src = src.replace(
            "from %s import *" % name,
            "from %s import *\nimport %s\ntext = %s.text\n"
            "measure_text = %s.measure_text" % (name, name, name, name))
    exec(compile(src, path, "exec"), {"__name__": "__main__",
                                      "__file__": path})
    return counts


@pytest.mark.parametrize("script", EXAMPLES)
def test_example_script_through_the_port(script, tmp_path, monkeypatch):
    got = _run(sdf_torch, script, tmp_path, monkeypatch)
    monkeypatch.undo()
    want = _run(sdf_tpu, script, tmp_path, monkeypatch)
    assert len(got) == len(want) >= 1
    for g, w in zip(got, want):
        assert g > 0 and abs(g - w) <= max(8, 0.02 * w), (got, want)
