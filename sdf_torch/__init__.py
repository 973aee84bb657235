"""sdf-torch: the PyTorch/CUDA port of sdf-tpu.

The same SDF modelling API (``from sdf_torch import *``), evaluated with
torch on an explicit device and meshed by hand-written CUDA kernels for
Hopper (``sdf_torch/csrc``).  Entry points run on the card by default
(``device=None`` means ``"cuda"`` and raises without one); pass
``device="cpu"`` to run the kernels' plain PyTorch versions.

Ported: the single-device ``generate()``, ``generate_mesh()`` and
``save()`` with every ``sparse=`` setting (the dense grid, the tiled sparse
path and the auto-route between them) and both marching-cubes variants
("lewiner", the default, and "fast"); the memos and ``checkpoint=``;
STL/OBJ/PLY output; the model zoo; the whole 3D and 2D DSL with
``extrude``/``revolve``, text and image textures, mesh SDFs (``Mesh``) and
reference-style custom closures.  Expressions that need a gather (a
texture or mesh-grid lookup, a polygon, a closure) run on the card too:
their fields are recorded ahead and read by the eval kernels.  The
differentiable path: ``core.diffmesh.extract``/``mean_vertex``,
``models.fit`` (``fit_step``, ``fit``, ``fit_chamfer``) and
``SDF3.gradient``/``normal``, with torch autograd and JAX's gradients;
and the debug slice, ``sample_slice``/``show_slice``.  Tests run them with
``device="cpu"``; ``chip_smoke.py`` phases 16-19 run them on the card.
Several GPUs (``sdf_torch.parallel``, one process and one device a rank
on ``torch.distributed``): ``generate(mesh=)`` and ``save(mesh=)`` over z
slabs or the dealt tile list, ``diffmesh.extract_sharded``,
``models.fit.make_sharded_fit_step`` and ``mesh=`` on the fitting helpers;
``parallel.initialize()`` joins a torchrun world (``chip_smoke.py --sharded``
runs four ranks on one card).

Still to come (ROADMAP.md): the generation of the MC33 tables (A17).
"""

import numpy as np  # the reference's star-export leaks np; scripts rely on it

from .utils.util import pi, degrees, radians

from .ops import easing as ease
from .ops import shapes2 as d2
from .ops import shapes3 as d3

from .ops.shapes3 import (
    ORIGIN,
    UP,
    X,
    Y,
    Z,
    SDF3,
    sphere,
    plane,
    slab,
    box,
    rounded_box,
    wireframe_box,
    torus,
    capsule,
    cylinder,
    capped_cylinder,
    rounded_cylinder,
    capped_cone,
    rounded_cone,
    ellipsoid,
    pyramid,
    tetrahedron,
    octahedron,
    dodecahedron,
    icosahedron,
    translate,
    scale,
    rotate,
    rotate_to,
    orient,
    circular_array,
    elongate,
    twist,
    bend,
    bend_linear,
    bend_radial,
    transition_linear,
    transition_radial,
    wrap_around,
    slice,
    union,
    difference,
    intersection,
    blend,
    negate,
    dilate,
    erode,
    shell,
    repeat,
)

from .ops.shapes2 import (
    SDF2,
    circle,
    line,
    rectangle,
    rounded_rectangle,
    equilateral_triangle,
    hexagon,
    rounded_x,
    polygon,
    vesica,
    extrude,
    extrude_to,
    revolve,
)

from .ops.meshsdf import Mesh

from .core.node import sdf2, sdf3, op2, op3, op23, op32
from .ops import csg as dn
from .ops import meshsdf as mesh
from .io import stl
from .utils import progress, util
from . import models

from .ops.textures import (
    measure_image,
    measure_text,
    image,
    text,
)

from .core.engine import (generate, generate_mesh, save, sample_slice,
                          show_slice)

from .io.stl import write_binary_stl
