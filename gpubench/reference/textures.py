"""A frozen, plain copy of what fogleman/sdf ``examples/image.py`` uses
beyond ``sdf.py``: ``measure_image``, ``image`` (an image embossed as a 2D
signed distance texture), the 2D node with ``extrude``, ``rectangle``,
``rounded_box``, ``slab`` and intersection, with the public names of
fogleman/sdf.  A configuration's ``build`` reaches this module when its
``api`` is the reference (``sdf.py``), which holds the rest (``union``,
the points, ``field``).

The texture is made as the upstream library makes it: the image loaded
with PIL and converted to one bit a pixel (``convert("1")``, PIL's own
dither), capped at ``pixels`` pixels, then signed distances in pixels,
negative inside, from an exact Euclidean distance transform of each side
(``edt``), scaled to world units.  The transform is this module's own: the
squared distance to the nearest feature pixel along each column, then
``min_k (g[k]^2 + (j - k)^2)`` along each row by brute force in blocks of
rows, all in integers, and a correctly rounded float64 square root at the
end.  It runs on the card where there is one and on the CPU otherwise.

Every formula keeps the operation order of the program's ops term for term
(``sdf.py``'s rules): the lookup's true divisions by Python floats
(``x / full_like(x, c)``), its clamps, its two nested lerps, its fallback
rectangle.  This module imports nothing of the program, nor scipy.
"""

from __future__ import annotations

import functools
from pathlib import Path

import numpy as np
import torch

from . import sdf
from .sdf import Points, SDF3, _length, _mdot, _min, _param, _pmax, clip

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

PIXELS = 2**22
X = sdf.X
Y = sdf.Y
Z = sdf.Z
_ROW_BLOCK = 2**24  # int32 entries of a block of the row pass


def _device():
    return "cuda" if torch.cuda.is_available() else "cpu"


# --- nodes -------------------------------------------------------------------


class Node3(SDF3):
    """A 3D node with intersection (``&``), which ``sdf.SDF3`` lacks."""

    def __and__(self, other):
        return intersection(self, other)


class Node2(SDF3):
    """A 2D node: its ``fn`` takes 2D points (``p[:, :2]`` of the 3D
    ones).  ``sdf.cast`` copies it as an ``SDF3``, which evaluates alike."""

    def extrude(self, h):
        return extrude(self, h)


def intersection(a, *bs):
    def fn(q, p):
        d1 = q["a"](p)
        for b in q["bs"]:
            d1 = torch.maximum(d1, b(p))
        return d1

    return Node3(fn, {"a": a, "bs": list(bs), "k": None})


def plane(normal, point):
    normal = np.asarray(normal, dtype=np.float64)

    def fn(q, p):
        return _mdot(q["point"] - p, q["normal"])

    return Node3(fn, {"normal": _param(normal / np.linalg.norm(normal)),
                      "point": _param(point)})


def slab(x0=None, y0=None, z0=None, x1=None, y1=None, z1=None):
    fs = []
    if x0 is not None:
        fs.append(plane(X, (x0, 0, 0)))
    if x1 is not None:
        fs.append(plane(-X, (x1, 0, 0)))
    if y0 is not None:
        fs.append(plane(Y, (0, y0, 0)))
    if y1 is not None:
        fs.append(plane(-Y, (0, y1, 0)))
    if z0 is not None:
        fs.append(plane(Z, (0, 0, z0)))
    if z1 is not None:
        fs.append(plane(-Z, (0, 0, z1)))
    return intersection(*fs)


def rounded_box(size, radius):
    def fn(q, p):
        d = abs(p) - q["size"] / 2 + q["radius"]
        return _length(_pmax(d, 0)) + _min(d.hmax(), 0) - q["radius"]

    return Node3(fn, {"size": _param(size), "radius": _param(radius)})


def rectangle(size, center=(0, 0)):
    def fn(q, p):
        d = abs(p - q["center"]) - q["size"] / 2
        return _length(_pmax(d, 0)) + _min(d.hmax(), 0)

    return Node2(fn, {"size": _param(size), "center": _param(center)})


def extrude(other, h):
    def fn(q, p):
        d = q["other"](p[:, :2])
        w = Points(d, torch.abs(p.c[2]) - q["h"] / 2)
        return _min(torch.maximum(w.c[0], w.c[1]), 0) + _length(_pmax(w, 0))

    return Node3(fn, {"other": other, "h": _param(h)})


# --- the texture -------------------------------------------------------------


def edt(mask, device=None):
    """Exact Euclidean distance, float64 numpy, from each True pixel of the
    2D bool ``mask`` to the nearest False one (0 on False pixels): the
    column pass gives each pixel's distance ``g`` to the nearest False
    pixel of its column, the row pass ``min_k g[i, k]^2 + (j - k)^2``."""
    device = device or _device()
    m = torch.as_tensor(np.asarray(mask, dtype=bool), device=device)
    h, w = m.shape
    far = h + w  # beyond every distance the image holds
    rows = torch.arange(h, device=device, dtype=torch.int32)[:, None]
    feat = ~m
    above = torch.where(feat, rows, -far).cummax(dim=0).values
    below = torch.where(feat, rows, 2 * far).flip(0).cummin(dim=0).values
    g = torch.minimum(rows - above, below.flip(0) - rows).clamp(max=far)
    g2 = g * g
    cols = torch.arange(w, device=device, dtype=torch.int32)
    sq = (cols[:, None] - cols[None, :]) ** 2  # (j, k)
    out = torch.empty((h, w), dtype=torch.int32, device=device)
    block = max(1, _ROW_BLOCK // (w * w))
    for i in range(0, h, block):
        out[i: i + block] = (g2[i: i + block, None, :] + sq[None]).amin(
            dim=2)
    return sdf.sqrt(out.to(torch.float64)).cpu().numpy()


def _fit_aspect(aspect, width, height):
    if width is not None and height is not None:
        return (width, height)
    if width is not None:
        return (width, width / aspect)
    height = 1 if height is None else height
    return (height * aspect, height)


def measure_image(path, width=None, height=None):
    from PIL import Image

    w, h = Image.open(path).size
    return _fit_aspect(w / h, width, height)


def _mask(path, pixels):
    """The image's one-bit mask (True where lit), capped at ``pixels``."""
    from PIL import Image

    im = Image.open(path).convert("L")
    tw, th = im.size
    factor = (pixels / (tw * th)) ** 0.5
    if factor < 1:
        im = im.resize((int(round(tw * factor)), int(round(th * factor))))
    return np.array(im.convert("1"))


@functools.lru_cache(maxsize=4)
def _signed(path, pixels):
    """The signed texture in pixels, negative inside (read-only)."""
    a = _mask(path, pixels)
    out = np.where(a, -edt(a), edt(~a))
    out.flags.writeable = False
    return out


def image(path, width=None, height=None, pixels=PIXELS):
    """fogleman/sdf's ``image(path)``: the image's signed texture as a 2D
    node filling ``width x height`` about the origin (the height 1 unless
    given): the bilinear lookup, and outside the texture a rectangle of
    half the size."""
    texture = _signed(str(Path(path).resolve()), pixels)
    th, tw = texture.shape
    width, height = _fit_aspect(tw / th, width, height)
    x0, y0, x1, y1 = -width / 2, -height / 2, width / 2, height / 2

    def fn(q, p):
        x, y = p.c
        u = (x - x0) / torch.full_like(x, x1 - x0)
        v = 1 - (y - y0) / torch.full_like(y, y1 - y0)
        i = u * tw + 0
        j = v * th + 0
        d = bilinear(q["texture"], i, j)
        fallback = q["rectangle"](p)
        outside = (i < 0) | (i >= tw - 1) | (j < 0) | (j >= th - 1)
        return torch.where(outside, fallback, d)

    return Node2(fn, {"texture": texture * (width / tw),
                      "rectangle": rectangle((width / 2, height / 2))})


def bilinear(a, x, y):
    """The texture ``a`` at fractional texel ``(x, y)``: coordinates
    clamped to the texel grid, four neighbours by flat index, two nested
    lerps."""
    h, w = a.shape
    flat = a.reshape(-1)
    cx = clip(x, 0.0, w - 1.0)
    cy = clip(y, 0.0, h - 1.0)
    ix = torch.clamp(torch.floor(cx).to(torch.int64), max=w - 2)
    iy = torch.clamp(torch.floor(cy).to(torch.int64), max=h - 2)
    fx = cx - ix.to(cx.dtype)
    fy = cy - iy.to(cy.dtype)

    def lerp(p, q, t):
        return p + t * (q - p)

    base = iy * w + ix
    top = lerp(flat[base], flat[base + 1], fx)
    bot = lerp(flat[base + w], flat[base + w + 1], fx)
    return lerp(top, bot, fy)


def recorded(node):
    """``node`` as kernel B1 evaluates it: every texture node read as a
    recorded field, with no operation of its own (the pre-pass computes
    it).  For counting B1's operations (``work.flops_per_sample``)."""
    if isinstance(node, SDF3):
        if isinstance(node.params, dict) and "texture" in node.params:
            return Node2(lambda q, p: p.c[0], {})
        out = object.__new__(type(node))
        out.fn, out.params, out._k = node.fn, recorded(node.params), node._k
        return out
    if isinstance(node, dict):
        return {k: recorded(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(recorded(v) for v in node)
    return node
