"""The port's documentation renderers, ``docs/render_torch.py`` and
``docs/render_showcase_torch.py``, against the JAX package's
``docs/render.py`` and ``docs/render_showcase.py``.

The JAX scripts mesh when they are imported, so their model names are read
from their ``generate(f, "name", ...)`` calls with ``ast``; the port's
scripts mesh only under ``__main__`` and are imported.  A few of the
models mesh through both packages in float64 at 2**13 samples with equal
triangle counts (the soups differ by the reference's FMA contraction, see
tests/test_torch_engine.py).
"""

import ast
import importlib.util
import os

import jax
import numpy as np
import pytest
import torch

import sdf_tpu as st
from sdf_tpu.parallel import grid as pgrid

DOCS = os.path.join(os.path.dirname(__file__), "..", "docs")


def _generate_names(script):
    """The names of the ``generate`` calls of a docs script, in source
    order."""
    with open(os.path.join(DOCS, script)) as fp:
        tree = ast.parse(fp.read())
    calls = [n for n in ast.walk(tree) if isinstance(n, ast.Call)
             and getattr(n.func, "id", None) == "generate"]
    return [c.args[1].value for c in sorted(calls, key=lambda c: c.lineno)]


def _load(script):
    spec = importlib.util.spec_from_file_location(
        script[:-3], os.path.join(DOCS, script))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def render_torch():
    return _load("render_torch.py")


@pytest.fixture(scope="module")
def port_models(render_torch):
    return {name: (f, kw) for name, f, kw in render_torch.models()}


@pytest.mark.parametrize("port, jax_script", [
    ("render_torch.py", "render.py"),
    ("render_showcase_torch.py", "render_showcase.py"),
])
def test_model_names_are_the_jax_renderers(port, jax_script):
    """Each port script lists the models of its JAX script, in its order."""
    names = [name for name, _, _ in _load(port).models()]
    want = _generate_names(jax_script)
    assert len(want) > 5 and names == want


def test_output_directory_is_not_the_docs_images(render_torch):
    out = os.path.normpath(render_torch.OUT)
    assert os.path.basename(out) == "render_torch"
    assert out != os.path.normpath(os.path.join(DOCS, "images"))


# A primitive, a 2D extrude, a warp, an eased transition and a positioning
# op, built in the JAX package as docs/render.py builds them.
REFERENCE = {
    "capped_cone": lambda: st.capped_cone(-st.Z, st.Z, 1, 0.5),
    "extrude": lambda: st.hexagon(1).extrude(1),
    "twist": lambda: st.box().twist(st.pi / 2),
    "transition_linear": lambda: st.box().transition_linear(
        st.sphere(), e=st.ease.in_out_quad),
    "orient": lambda: (lambda c: c.orient(st.X) | c.orient(st.Y)
                       | c.orient(st.Z))(st.capped_cylinder(-st.Z, st.Z,
                                                            0.25)),
}


@pytest.mark.parametrize("name", sorted(REFERENCE))
def test_models_mesh_as_the_reference(port_models, name):
    """The port script's model meshes to the reference's triangle count
    (float64, 2**13 samples, the renderers' kwargs)."""
    f, kw = port_models[name]
    got = f.generate(samples=2**13, verbose=False, dtype=torch.float64,
                     device="cpu", **kw)
    want = np.asarray(REFERENCE[name]().generate(
        samples=2**13, verbose=False, dtype=np.float64,
        mesh=pgrid.make_mesh(jax.devices()[:1]), **kw))
    assert len(got) > 0 and len(got) == len(want)
    assert np.isfinite(got).all()
