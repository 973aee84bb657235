"""Mesh and render the showcase models of ``docs/render_showcase.py``
through ``sdf_torch``.

The same models as ``render_showcase.py`` (the workload heroes with their
JPEG copies, the customizable-box pair, the large text plate, the
butterfly image mask and the mesh preview; the text plate is skipped
without a font) and the same ``show_slice`` capture (with matplotlib),
meshed by the PyTorch/CUDA port and drawn by ``tools/render`` into
``docs/render_torch/``, as ``render_torch.py`` does.

Run from the repository root:

    python docs/render_showcase_torch.py [--samples LOG2] [--device cpu]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from render_torch import OUT, ROOT, font, options, render_all  # noqa: E402

from sdf_torch import *  # noqa: E402,F401,F403
from sdf_torch.models import zoo  # noqa: E402

IMAGE = os.path.join(ROOT, "examples", "butterfly.png")


def models():
    """``(name, f, kwargs)`` for each ``generate`` of
    ``docs/render_showcase.py``, in its order; ``f`` is None for the text
    plate without a font."""
    # workload heroes (the JPEG copies stand in for the prints' photos)
    yield "example", zoo.example(), {"jpg": True}
    yield "blobby", zoo.blobby(), {"jpg": True}
    yield "gearlike", zoo.gearlike(), {"jpg": True}
    yield "knurling", zoo.knurling(), {"jpg": True}
    yield "weave", zoo.weave(), {"jpg": True}

    # parametric CAD pair (examples/customizable_box.py)
    yield "customizable_box", zoo.customizable_box_body(), {"samples": 2**24}
    yield "customizable_lid", zoo.customizable_box_lid(), {"samples": 2**24}

    # large text plate
    name = font("Arial")
    f = None
    if name:
        words = "Hello, world!"
        w, h = measure_text(name, words)
        f = rounded_box((w + 1, h + 1, 0.2), 0.1)
        f -= text(name, words).extrude(1)
    yield "text-large", f, {}

    # image mask (the procedural butterfly asset)
    w, h = measure_image(IMAGE)
    f = rounded_box((w * 1.1, h * 1.1, 0.1), 0.05)
    f |= image(IMAGE).extrude(1) & slab(z0=0, z1=0.075)
    yield "butterfly", f, {}

    # mesh preview (a render in place of the reference's viewer screenshot)
    yield "meshview", zoo.pawn(), {}


def slice_capture(device, out=OUT):
    """The ``show_slice`` picture of the example model at z = 0, or a line
    saying why it was skipped."""
    path = os.path.join(out, "images", "show_slice.png")
    if os.path.exists(path):
        return
    try:
        import matplotlib
    except ImportError:
        print("show_slice              skipped: no matplotlib")
        return
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import numpy as np

    from sdf_torch.core import engine

    a, extent, axes = engine.sample_slice(zoo.example(), z=0, device=device)
    im = plt.imshow(np.abs(a), extent=extent, origin="lower", cmap="viridis")
    plt.colorbar(im)
    plt.xlabel(axes[0].upper())
    plt.ylabel(axes[1].upper())
    plt.savefig(path, dpi=150, bbox_inches="tight")
    plt.close()
    print("show_slice              written")


if __name__ == "__main__":
    samples, device = options(sys.argv)
    render_all(models(), samples, device)
    slice_capture(device)
