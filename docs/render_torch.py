"""Mesh and render the models of ``docs/render.py`` through ``sdf_torch``.

The same models as ``render.py`` (the README's pictures of every API entry),
meshed by the PyTorch/CUDA port on the card (``--device cpu`` runs the
kernels' plain versions) and drawn by the same native ``tools/render``
(``make -C tools``; built here when it is missing).  Output goes to
``docs/render_torch/`` (``models/*.stl``, ``images/*.png``), never to
``docs/images/``; a model whose PNG exists is skipped, as in ``render.py``.
A text model whose font is missing (the reference names Georgia and Arial;
DejaVuSans stands in, as in ``render.py``) is skipped with a line that says
so.  The last line sums up the wall time, the nvcc builds and the skips.

Run from the repository root:

    python docs/render_torch.py [--samples LOG2] [--device cpu]
"""

import os
import subprocess
import sys
import time

ROOT = os.path.normpath(
    os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
sys.path.insert(0, ROOT)

from sdf_torch import *  # noqa: E402,F401,F403

OUT = os.path.join(ROOT, "docs", "render_torch")
RENDER = os.path.join(ROOT, "tools", "render")


def font(name):
    """``name`` if Pillow can load it, else DejaVuSans if it can, else
    None."""
    from PIL import ImageFont

    for candidate in (name, "DejaVuSans"):
        try:
            ImageFont.truetype(candidate, 12)
            return candidate
        except OSError:
            pass
    return None


def models():
    """``(name, f, kwargs)`` for each picture of ``docs/render.py``, in its
    order; ``f`` is None for a text model without a font."""
    # example
    f = sphere(1) & box(1.5)
    c = cylinder(0.5)
    f -= c.orient(X) | c.orient(Y) | c.orient(Z)
    example = f
    yield "example", f, {}

    # 3D primitives
    yield "sphere", sphere(1), {}
    yield "box", box(1), {}
    yield "box2", box((1, 2, 3)), {}
    yield "rounded_box", rounded_box((1, 2, 3), 0.25), {}
    yield "wireframe_box", wireframe_box((1, 2, 3), 0.05), {}
    yield "torus", torus(1, 0.25), {}
    yield "capsule", capsule(-Z, Z, 0.5), {}
    yield "capped_cylinder", capped_cylinder(-Z, Z, 0.5), {}
    yield "rounded_cylinder", rounded_cylinder(0.5, 0.1, 2), {}
    yield "capped_cone", capped_cone(-Z, Z, 1, 0.5), {}
    yield "rounded_cone", rounded_cone(0.75, 0.25, 2), {}
    yield "ellipsoid", ellipsoid((1, 2, 3)), {}
    yield "pyramid", pyramid(1), {}
    yield "tetrahedron", tetrahedron(1), {}
    yield "octahedron", octahedron(1), {}
    yield "dodecahedron", dodecahedron(1), {}
    yield "icosahedron", icosahedron(1), {}

    # infinite primitives, clipped for display
    yield "plane", sphere() & plane(), {}
    yield "slab", sphere() & slab(z0=-0.5, z1=0.5, x0=0), {}
    yield "cylinder", sphere() - cylinder(0.5), {}

    # positioning
    yield "translate", sphere().translate((0, 0, 2)), {}
    yield "scale", sphere().scale((1, 2, 3)), {}
    yield "rotate", capped_cylinder(-Z, Z, 0.5).rotate(pi / 4, X), {}
    c = capped_cylinder(-Z, Z, 0.25)
    yield "orient", c.orient(X) | c.orient(Y) | c.orient(Z), {}

    # boolean operations
    a = box((3, 3, 0.5))
    b = sphere()
    yield "union", a | b, {}
    yield "difference", a - b, {}
    yield "intersection", a & b, {}
    yield "smooth_union", a | b.k(0.25), {}
    yield "smooth_difference", a - b.k(0.25), {}
    yield "smooth_intersection", a & b.k(0.25), {}

    # alterations & repetition
    yield "repeat", sphere().repeat(3, (1, 1, 0)), {}
    yield ("circular_array", capped_cylinder(-Z, Z, 0.5).circular_array(8, 4),
           {})
    yield "blend", sphere().blend(box()), {}
    yield "dilate", example.dilate(0.1), {}
    yield "erode", example.erode(0.1), {}
    yield "shell", sphere().shell(0.05) & plane(-Z), {}
    yield "elongate", example.elongate((0.25, 0.5, 0.75)), {}
    yield "twist", box().twist(pi / 2), {}
    yield "bend", box().bend(1), {}
    yield ("bend_linear", capsule(-Z * 2, Z * 2, 0.25).bend_linear(
        -Z, Z, X, ease.in_out_quad), {})
    yield ("bend_radial",
           box((5, 5, 0.25)).bend_radial(1, 2, -1, ease.in_out_quad),
           {"sparse": False})
    yield ("transition_linear",
           box().transition_linear(sphere(), e=ease.in_out_quad), {})
    yield ("transition_radial",
           box().transition_radial(sphere(), e=ease.in_out_quad), {})

    # 2D -> 3D
    yield "extrude", hexagon(1).extrude(1), {}
    yield ("extrude_to",
           rectangle(2).extrude_to(circle(1), 2, ease.in_out_quad), {})
    yield "revolve", hexagon(1).revolve(3), {}
    yield ("slice", example.translate((0, 0, 0.55)).slice().extrude(0.1), {})

    # text
    name = font("Georgia")
    f = None
    if name:
        f = rounded_box((7, 2, 0.2), 0.1)
        f -= text(name, "Hello, World!").extrude(0.2).rotate(pi).translate(
            0.1 * Z)
    yield "text", f, {}

    name = font("Arial")
    f = None
    if name:
        words = " wrap_around " * 3
        w, h = measure_text(name, words)
        f = text(name, words).extrude(0.1).orient(Y).wrap_around(-w / 2, w / 2)
    yield "wrap_around", f, {}

    # hero (the reference README's gearlike walkthrough model)
    f = sphere(2) & slab(z0=-0.5, z1=0.5).k(0.1)
    f -= cylinder(1).k(0.1)
    f -= cylinder(0.25).circular_array(16, 2).k(0.1)
    yield "gearlike_hero", f, {}


def renderer():
    """``tools/render``, built with make when it is missing; None when it
    cannot be built (no compiler or no zlib)."""
    if not os.path.exists(RENDER):
        built = subprocess.run(["make", "-C", os.path.dirname(RENDER),
                                "render"], capture_output=True, text=True)
        if built.returncode != 0:
            print("tools/render could not be built:\n" + built.stdout
                  + built.stderr)
    return RENDER if os.path.exists(RENDER) else None


def options(argv):
    """``(samples, device)`` from ``--samples LOG2`` (default 26, as
    ``render.py``) and ``--device`` (default the card)."""
    samples, device = 2**26, None
    if "--samples" in argv:
        samples = 2 ** int(argv[argv.index("--samples") + 1])
    if "--device" in argv:
        device = argv[argv.index("--device") + 1]
    return samples, device


def prebuild(fs):
    """Build the dense and per-tile eval kernels of every expression in
    ``fs`` at once, one nvcc each (generate() would build them one at a
    time), with the fixed kernels."""
    import torch

    from sdf_torch import _build
    from sdf_torch.core import eval_classify, hybrid, mc33

    items = [("ntri", _build.source("ntri.cu")),
             ("compact", _build.source("compact.cu")),
             ("classify_ext", mc33.kernel_source())]
    for f in fs:  # generate()'s default dtype
        tree, _ = hybrid.route_fields(f, dtype=torch.float32)
        items += [("eval_classify", eval_classify.kernel_source(
                      tree, dtype=torch.float32)),
                  ("eval_tiles", eval_classify.tile_kernel_source(
                      tree, dtype=torch.float32))]
    _build.build_many(items)


def render_all(entries, samples, device, out=OUT):
    """Mesh each ``(name, f, kwargs)`` to ``out/models/<name>.stl`` and draw
    it to ``out/images/<name>.png`` (``kwargs`` may set ``samples``, and
    ``jpg=True`` adds a JPEG copy).  Prints a line per model and a summary;
    returns the names skipped."""
    from sdf_torch import _build

    os.makedirs(os.path.join(out, "models"), exist_ok=True)
    os.makedirs(os.path.join(out, "images"), exist_ok=True)
    draw = renderer()
    before = set(_build.BUILD.glob("*.so")) if _build.BUILD.exists() else set()
    t0 = time.time()
    entries = list(entries)
    if device != "cpu":
        prebuild([f for name, f, _ in entries if f is not None and not
                  os.path.exists(os.path.join(out, "images", name + ".png"))])
    skipped = []
    for name, f, kwargs in entries:
        kwargs = dict(kwargs)
        jpg = kwargs.pop("jpg", False)
        stl_path = os.path.join(out, "models", name + ".stl")
        png_path = os.path.join(out, "images", name + ".png")
        if f is None and not os.path.exists(png_path):
            skipped.append(name)
            print("%-22s skipped: no font (Georgia, Arial or DejaVuSans)"
                  % name, flush=True)
            continue
        if not os.path.exists(png_path):
            kwargs.setdefault("samples", samples)
            t1 = time.time()
            points = f.save(stl_path, verbose=False, device=device, **kwargs)
            print("%-22s %9d triangles %8.2f s" % (
                name, len(points) // 3, time.time() - t1), flush=True)
            if draw:
                subprocess.run([draw, stl_path, png_path], check=True)
        if jpg and os.path.exists(png_path):
            from PIL import Image

            Image.open(png_path).convert("RGB").save(
                png_path[:-4] + ".jpg", quality=92)
    after = set(_build.BUILD.glob("*.so")) if _build.BUILD.exists() else set()
    print("wall %.1f s, %d nvcc builds, skipped: %s%s" % (
        time.time() - t0, len(after - before), ", ".join(skipped) or "none",
        "" if draw else "; no images (tools/render missing)"))
    return skipped


if __name__ == "__main__":
    render_all(models(), *options(sys.argv))
