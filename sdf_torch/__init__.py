"""sdf-torch: the PyTorch/CUDA port of sdf-tpu.

The same SDF modelling API (``from sdf_torch import *``), evaluated with
torch on an explicit device and meshed by hand-written CUDA kernels for
Hopper (``sdf_torch/csrc``).  Entry points run on the card by default
(``device=None`` means ``"cuda"`` and raises without one); pass
``device="cpu"`` to run the kernels' plain PyTorch versions.

Ported so far: the single-device dense ``generate()`` with both
marching-cubes variants ("lewiner", the default, and "fast"), its memos and
``checkpoint=``, STL/OBJ/PLY output and the model zoo; see ROADMAP.md for
what is still to come (the tiled sparse path, 2D ops, multi-GPU).
"""

import numpy as np  # the reference's star-export leaks np; scripts rely on it

from .utils.util import pi, degrees, radians

from .ops import easing as ease
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

from .core.node import sdf2, sdf3, op2, op3, op23, op32
from .ops import csg as dn
from .io import stl
from .utils import progress, util
from . import models

from .core.engine import generate, generate_mesh, save

from .io.stl import write_binary_stl
