"""Text and image SDFs (``sdf_torch.ops.textures``) against
``sdf_tpu.ops.textures``.

Both packages run the same host setup (PIL, scipy's EDT) on the same
inputs: an image file of the repo (examples/flower.png), a seed-made
array, and text in DejaVuSans (the font tests/test_examples.py uses).  The
fields are then evaluated on the same seed-made points, the JAX expression
eagerly.

Tolerances: the measured sizes and the texture leaves are equal; the
fields are bit-equal in float64 (the bilinear fetch is the reference's
op for op) and within 8 eps32 in float32 (values of order one).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sdf_tpu as st
import sdf_torch as sp
from sdf_tpu.core.node import Points as JPoints
from sdf_tpu.core.node import cast as jcast
from sdf_torch.core import hybrid
from sdf_torch.core.node import Points as TPoints
from sdf_torch.core.node import cast as tcast
from sdf_torch.core.node import tree_leaves

FLOWER = os.path.join(os.path.dirname(__file__), "..", "examples",
                      "flower.png")
FONT = "DejaVuSans"


def _seed_image():
    """A seed-made 8-bit grey image with a few blobs."""
    rng = np.random.default_rng(5)
    yy, xx = np.mgrid[0:48, 0:64]
    img = np.zeros((48, 64))
    for cx, cy, r in rng.uniform((10, 10, 4), (54, 38, 12), (4, 3)):
        img = np.maximum(img, (np.hypot(xx - cx, yy - cy) < r) * 255.0)
    return img.astype(np.uint8)


MODELS = {
    "flower": lambda m: m.image(FLOWER, pixels=2**14),
    "array": lambda m: m.image(_seed_image(), width=1.5),
    "text": lambda m: m.text(FONT, "Hi!", height=0.8, pixels=2**14,
                             points=64),
}


def _points(n=4096):
    return np.random.default_rng(1).uniform(-1.0, 1.0, (n, 2))


def _eval(m, f, pts, dtype):
    if m is st:
        fc = jcast(f, getattr(jnp, dtype))
        with jax.disable_jit():
            d = fc(JPoints(*[jnp.asarray(pts[:, i], getattr(jnp, dtype))
                             for i in range(2)]))
        return np.asarray(jnp.broadcast_to(d, (len(pts),)))
    fc = tcast(f, getattr(torch, dtype), "cpu")
    d = fc(TPoints(*[torch.as_tensor(pts[:, i], dtype=getattr(torch, dtype))
                     for i in range(2)]))
    return torch.as_tensor(d).broadcast_to((len(pts),)).numpy()


def test_measure_matches_the_reference():
    assert sp.measure_image(FLOWER) == st.measure_image(FLOWER)
    assert sp.measure_image(FLOWER, width=3) == st.measure_image(FLOWER, width=3)
    assert sp.measure_image(_seed_image()) == st.measure_image(_seed_image())
    assert sp.measure_text(FONT, "Hello, world!") == st.measure_text(
        FONT, "Hello, world!")
    assert sp.measure_text(FONT, "sdf", height=2) == st.measure_text(
        FONT, "sdf", height=2)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_texture_leaves_equal(name):
    """The texture and the fallback rectangle are the same leaves, and the
    eval function is gather-marked."""
    ft, fj = MODELS[name](sp), MODELS[name](st)
    got = tree_leaves(ft)
    want = jax.tree_util.tree_leaves(fj)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    assert hybrid.count_gathers(ft) == 1


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_texture_field_matches_jax(name, dtype):
    pts = _points()
    a = _eval(st, MODELS[name](st), pts, dtype)
    b = _eval(sp, MODELS[name](sp), pts, dtype)
    assert (a < 0).any() and (a > 0).any()
    if dtype == "float64":
        np.testing.assert_array_equal(b, a)
    else:
        np.testing.assert_allclose(b, a, rtol=0,
                                   atol=8 * np.finfo(np.float32).eps)


def test_texture_extruded_on_a_grid():
    """The image model of examples/image.py, cut down, on a 3D grid: the
    port's dense volume (the texture's field recorded, then read) equals
    the whole expression evaluated with torch ops."""
    from sdf_torch.core import eval_classify as ec

    w, h = sp.measure_image(FLOWER)
    f = sp.rounded_box((w * 1.1, h * 1.1, 0.1), 0.05)
    f |= sp.image(FLOWER, pixels=2**14).extrude(1) & sp.slab(z0=0, z1=0.075)
    X = np.linspace(-0.7 * w, 0.7 * w, 15)
    Y = np.linspace(-0.7 * h, 0.7 * h, 13)
    Z = np.linspace(-0.1, 0.1, 9)
    vol, _ = ec.eval_and_classify(f, X, Y, Z, torch.float64, "cpu")
    whole = ec._eval_volume(f, X, Y, Z, torch.float64, "cpu")
    np.testing.assert_array_equal(vol.numpy(), whole.numpy())
