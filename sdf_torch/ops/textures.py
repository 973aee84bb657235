"""Text and image SDFs (counterpart of ``sdf_tpu.ops.textures``).

The setup runs once on the host, as in the JAX package: PIL rasterizes the
glyphs or loads the image, scipy's exact Euclidean distance transform makes
a signed texture (negative inside), all under the span ``texture``
(``core.spans``: held for the next ``generate()`` where the texture is
built before it).  The texture becomes a parameter leaf, sampled
bilinearly by tensor indexing on the caller's device.  Points outside the
texture fall back to a half-size rectangle SDF, as in the reference.  PIL
and scipy are imported inside the functions that use them.

The lookup has no statement form in the generated kernel body, so the
eval function is gather-marked (``core.hybrid``): its field is recorded
ahead with torch ops and read by the kernels.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import hybrid, spans
from ..core.node import as_param
from . import shapes2 as d2
from .vecmath import _div_const, clip

PIXELS = 2**22


def _load_image(thing):
    from PIL import Image

    if isinstance(thing, str):
        return Image.open(thing)
    elif isinstance(thing, (np.ndarray, np.generic)):
        return Image.fromarray(thing)
    return Image.fromarray(np.array(thing))


def _fit_aspect(aspect, width, height):
    """(width, height) from an aspect ratio and at most one given extent;
    with neither given, the height is 1."""
    if width is not None and height is not None:
        return (width, height)
    if width is not None:
        return (width, width / aspect)
    height = 1 if height is None else height
    return (height * aspect, height)


def measure_text(name, text, width=None, height=None):
    from PIL import ImageFont

    x0, y0, x1, y1 = ImageFont.truetype(name, 96).getbbox(text)
    return _fit_aspect((x1 - x0) / (y1 - y0), width, height)


def measure_image(thing, width=None, height=None):
    w, h = _load_image(thing).size
    return _fit_aspect(w / h, width, height)


@d2.sdf2
def text(font_name, text, width=None, height=None, pixels=PIXELS, points=512):
    with spans.span("texture", hold=True):
        from PIL import Image, ImageDraw, ImageFont

        font = ImageFont.truetype(font_name, points)

        # Texture bounds: 20% padding around the glyphs' bounding box.
        p = 0.2
        x0, y0, x1, y1 = font.getbbox(text)
        px = int((x1 - x0) * p)
        py = int((y1 - y0) * p)
        tw = x1 - x0 + 1 + px * 2
        th = y1 - y0 + 1 + py * 2

        im = Image.new("L", (tw, th))
        draw = ImageDraw.Draw(im)
        draw.text((px - x0, py - y0), text, font=font, fill=255)

        return _texture_sdf(width, height, pixels, px, py, im)


@d2.sdf2
def image(thing, width=None, height=None, pixels=PIXELS):
    with spans.span("texture", hold=True):
        im = _load_image(thing).convert("L")
        return _texture_sdf(width, height, pixels, 0, 0, im)


def _texture_sdf(width, height, pixels, px, py, im):
    import scipy.ndimage as nd

    tw, th = im.size

    # Cap the texture size.
    factor = (pixels / (tw * th)) ** 0.5
    if factor < 1:
        tw, th = int(round(tw * factor)), int(round(th * factor))
        px, py = int(round(px * factor)), int(round(py * factor))
        im = im.resize((tw, th))

    # Two-sided exact EDT -> signed texture: - inside, + outside.
    im = im.convert("1")
    a = np.array(im)
    inside = -nd.distance_transform_edt(a)
    outside = nd.distance_transform_edt(~a)
    texture = np.zeros(a.shape)
    texture[a] = inside[a]
    texture[~a] = outside[~a]

    # World bounds from the padded texture extent.
    pw = tw - px * 2
    ph = th - py * 2
    width, height = _fit_aspect(pw / ph, width, height)
    x0 = -width / 2
    y0 = -height / 2
    x1 = width / 2
    y1 = height / 2

    texture = texture * (width / tw)

    rectangle = d2.rectangle((width / 2, height / 2))

    params = {"texture": as_param(texture), "rectangle": rectangle}
    extent = (x0, y0, x1, y1)

    @hybrid.mark_gather
    def fn(q, p):
        tex = q["texture"]
        x, y = p.c
        # Divisions by a Python float are true divisions on every device
        # (vecmath._div_const), as in the JAX package.
        u = _div_const(x - extent[0], extent[2] - extent[0])
        v = 1 - _div_const(y - extent[1], extent[3] - extent[1])
        i = u * pw + px
        j = v * ph + py
        d = _bilinear_interpolate(tex, i, j)
        fallback = q["rectangle"](p)
        outside_tex = (i < 0) | (i >= tw - 1) | (j < 0) | (j >= th - 1)
        return torch.where(outside_tex, fallback, d)

    return fn, params


def _bilinear_interpolate(a, x, y):
    """Bilinear texture fetch at fractional texel ``(x, y)``: the four
    neighbours of one flattened texture by linear index, blended as two
    nested lerps (the JAX package's formulation, op for op).  Coordinates
    clamp to the texel grid; the caller replaces out-of-texture points."""
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
